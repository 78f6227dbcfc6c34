"""FrontDoor: spread tenants across fabric worker processes.

A thin routing front with no query smarts of its own: it picks a worker
per tenant with **rendezvous (highest-random-weight) hashing** — stable
under worker join/leave (only the departed worker's tenants move), no
shared state, no coordinator — forwards the query text plus tenant id and
deadline, and aggregates the workers' ``/metrics`` into one exposition
(worker series stay distinguishable by their per-process ``server="qsN"``
labels, which is why ``QueryServer`` accepts an explicit ``name``).

Workers come in two flavors, freely mixed:

- an in-process :class:`~hyperspace_tpu_torch.serving.server.QueryServer`
  (tests, single-process topologies);
- a base URL of a :class:`WorkerEndpoint` — the stdlib-HTTP shim that
  exposes one QueryServer to other processes (``GET/POST /query``,
  ``/metrics``, ``/statusz``, ``/healthz``). Results travel as JSON
  columns and come back as numpy arrays, same shape ``collect()`` returns.

Crash tolerance (``hyperspace.fabric.health.*``, default off — at
defaults routing is the original single-candidate raise-on-failure):

- **typed errors over the wire**: a worker failure is classified through
  ``reliability.errors.classify`` *on the worker*, serialized in the JSON
  body (``errorType``/``kind``/``retryable``), and rehydrated here as
  :class:`WorkerUnavailable` (retry elsewhere may help) or
  :class:`WorkerError` (the query itself is bad — retrying rereads the
  same wrong bytes), so retry/no-retry decisions survive the process hop.
- **health-aware membership**: a :class:`~hyperspace_tpu_torch.fabric.health.HealthTracker`
  ejects workers on consecutive failures, missed sidecar heartbeats
  (:meth:`FrontDoor.check_beats`), or ``/healthz`` commit-seq staleness
  (:meth:`FrontDoor.probe`); tenants re-hash to the survivors and the
  ejected worker returns via a half-open probe.
- **deadline-aware failover**: ``query`` walks the tenant's rendezvous
  preference order, retrying a :class:`WorkerUnavailable` on the next
  candidate while the caller's deadline allows
  (``hs_frontdoor_failover_retries_total``).
- **hedged reads**: with ``hedgeMs`` set, a primary silent past the hedge
  delay gets its (idempotent) query mirrored to the next candidate;
  first answer wins (``hs_frontdoor_failover_hedges_total``).

Distributed observability (``hyperspace.obs.fabric.*``, see
docs/observability.md "Distributed tracing"): with tracing on, every routed
request roots a ``frontdoor-request`` trace whose ``route`` children record
each attempt (worker, outcome, hedge/retry siblings); propagation stamps a
W3C ``traceparent`` header (plus the ``x-hs-stitch`` byte budget when
stitching is on) so the worker's tree carries the router's trace id, and
stitching grafts the worker's returned span tree under the attempt span —
``last_query_profile()`` and the Chrome export then show ONE end-to-end
trace with per-process attribution. ``/profilez``/``/statusz`` federation
merges the workers' profile histories and SLO burn views.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence

from hyperspace_tpu_torch.obs import spans

__all__ = [
    "FrontDoor",
    "WorkerEndpoint",
    "WorkerError",
    "WorkerUnavailable",
    "rendezvous_pick",
    "rendezvous_order",
    "merge_prometheus_texts",
]


def _rendezvous_weight(key: str, node: str) -> bytes:
    return hashlib.sha256(f"{key}|{node}".encode("utf-8")).digest()


def rendezvous_pick(key: str, nodes: Sequence[str]) -> str:
    """The highest-random-weight node for ``key``: every participant
    computes the same winner from the membership list alone."""
    if not nodes:
        raise ValueError("rendezvous_pick needs at least one node")
    return max(nodes, key=lambda n: _rendezvous_weight(key, n))


def rendezvous_order(key: str, nodes: Sequence[str]) -> List[str]:
    """All nodes in descending rendezvous weight — the key's full failover
    preference order. ``rendezvous_order(k, ns)[0] == rendezvous_pick(k, ns)``,
    and removing the winner promotes exactly the next entry, so failover
    lands where the tenant would re-hash anyway."""
    if not nodes:
        raise ValueError("rendezvous_order needs at least one node")
    return sorted(nodes, key=lambda n: _rendezvous_weight(key, n), reverse=True)


def merge_prometheus_texts(texts: Sequence[str]) -> str:
    """Merge several Prometheus 0.0.4 expositions into one: each family's
    ``# HELP``/``# TYPE`` header appears once, with every worker's samples
    (already disjoint by their ``server`` labels) concatenated under it."""
    headers: Dict[str, List[str]] = {}
    samples: Dict[str, List[str]] = {}
    order: List[str] = []
    for text in texts:
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                parts = line.split(None, 3)
                family = parts[2] if len(parts) >= 3 else ""
            else:
                family = line.split("{", 1)[0].split(None, 1)[0]
            if family not in headers:
                headers[family] = []
                samples[family] = []
                order.append(family)
            if line.startswith("#"):
                if line not in headers[family]:
                    headers[family].append(line)
            elif line not in samples[family]:
                samples[family].append(line)
    out: List[str] = []
    for family in order:
        out.extend(headers[family])
        out.extend(samples[family])
    return "\n".join(out) + ("\n" if out else "")


class WorkerUnavailable(RuntimeError):
    """The worker could not answer (transport failure, injected/classified
    transient, admission shed): the *same* query on another worker may
    succeed, so this is the failover-retryable wire error."""

    def __init__(self, message: str, error_type: str = "", kind: str = "transient"):
        super().__init__(message)
        self.error_type = error_type
        self.kind = kind


class WorkerError(RuntimeError):
    """The worker answered with a non-retryable typed error (bad SQL,
    corrupt data): every worker would fail identically, so the error goes
    straight to the caller instead of burning failover attempts."""

    def __init__(self, message: str, error_type: str = "", kind: str = "error"):
        super().__init__(message)
        self.error_type = error_type
        self.kind = kind


def _registry():
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    return REGISTRY


def _count_route(worker: str) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_fabric_frontdoor_requests_total",
        "requests routed through the FrontDoor, by worker",
        worker=worker,
    ).inc()


def _count_failover_retry(worker: str) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_frontdoor_failover_retries_total",
        "failed attempts rerouted to the next rendezvous candidate, by "
        "the worker that failed",
        worker=worker,
    ).inc()


def _count_failover_exhausted() -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_frontdoor_failover_exhausted_total",
        "requests that failed every eligible candidate (or ran out of "
        "deadline) and surfaced a typed error",
    ).inc()


def _count_hedge() -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_frontdoor_failover_hedges_total",
        "hedged requests fired to a backup worker after the primary "
        "stayed silent past the hedge delay",
    ).inc()


def _retryable(exc: BaseException, worker: Any) -> bool:
    """May the same query succeed on another worker? Wire errors carry the
    answer; in-process exceptions are classified locally with the same
    ``reliability.errors`` taxonomy the worker side uses."""
    if isinstance(exc, WorkerError):
        return False
    if isinstance(exc, WorkerUnavailable):
        return True
    if isinstance(worker, str):
        return False  # HTTP path always raises the two typed errors above
    from hyperspace_tpu_torch.reliability import errors as rel_errors

    return not rel_errors.is_corrupt(exc)


class FrontDoor:
    """Tenant-affine router over a fixed worker set (see module docstring).

    ``health``/``failover``/``hedge_ms`` default to the PR-13 behavior
    (single candidate, raise on failure). Pass ``conf`` (a session conf
    with ``hyperspace.fabric.health.enabled``) or explicit kwargs to turn
    the crash-tolerance machinery on.
    """

    def __init__(
        self,
        workers: Sequence[Any],
        *,
        health: Optional[Any] = None,
        failover: bool = False,
        hedge_ms: float = 0.0,
        system_path: Optional[str] = None,
        clock=time.monotonic,
        conf: Optional[Any] = None,
    ):
        if not workers:
            raise ValueError("FrontDoor needs at least one worker")
        self._workers: Dict[str, Any] = {}
        for i, w in enumerate(workers):
            if isinstance(w, str):
                self._workers[f"w{i}:{w}"] = w.rstrip("/")
            else:
                self._workers[getattr(w, "server_name", f"w{i}")] = w
        self._ids = sorted(self._workers)
        self._clock = clock
        if conf is not None and conf.fabric_health_enabled and health is None:
            from hyperspace_tpu_torch.fabric.health import HealthTracker

            health = HealthTracker(
                failure_threshold=conf.fabric_health_failure_threshold,
                probe_interval_s=conf.fabric_health_probe_interval_seconds,
                heartbeat_interval_s=conf.fabric_health_heartbeat_interval_seconds,
                missed_beats=conf.fabric_health_missed_beats,
                max_commit_lag=conf.fabric_health_max_commit_lag,
            )
            failover = True
            hedge_ms = conf.fabric_health_hedge_ms
            system_path = system_path or conf.system_path
        self._health = health
        self._failover = bool(failover) or health is not None
        self._hedge_s = float(hedge_ms) / 1000.0
        self._system_path = system_path
        #: worker id -> fabric node id, learned from /healthz bodies; maps
        #: sidecar heartbeat ledgers back onto rendezvous members
        self._nodes: Dict[str, str] = {}
        # distributed observability (hyperspace.obs.fabric.*): without a
        # conf the router stays untraced with propagation semantics at their
        # defaults (headers on when a trace exists, stitching off)
        self._tracing = bool(conf.obs_tracing_enabled) if conf is not None else False
        self._trace_max_spans = conf.obs_trace_max_spans if conf is not None else 100_000
        self._propagate = bool(conf.obs_fabric_propagate) if conf is not None else True
        self._stitch = bool(conf.obs_fabric_stitch_enabled) if conf is not None else False
        self._stitch_max_spans = conf.obs_fabric_stitch_max_spans if conf is not None else 512
        self._stitch_max_bytes = conf.obs_fabric_stitch_max_bytes if conf is not None else 262_144
        self._fed_timeout = (
            conf.obs_fabric_federation_timeout_seconds if conf is not None else 30.0
        )
        self._profiles: "deque" = deque(
            maxlen=max(1, conf.obs_profile_history) if conf is not None else 16
        )
        self.flight = None
        self._slow_s = None
        if conf is not None and conf.obs_slow_query_ms > 0:
            from hyperspace_tpu_torch.obs.history import FlightRecorder

            self._slow_s = conf.obs_slow_query_ms / 1000.0
            self.flight = FlightRecorder(
                max_entries=conf.obs_slow_query_max_entries,
                directory=conf.obs_slow_query_dir or None,
                registry=_registry(),
                server="frontdoor",
            )

    @property
    def worker_ids(self) -> List[str]:
        return list(self._ids)

    @property
    def health(self) -> Optional[Any]:
        return self._health

    def pick(self, tenant: str) -> str:
        return rendezvous_pick(str(tenant), self._ids)

    def _candidates(self, tenant: str) -> List[str]:
        """The tenant's failover preference order over the currently-live
        membership. Without failover this is the single PR-13 pick."""
        ids = self._ids
        if self._health is not None:
            ids = self._health.live(ids)
        order = rendezvous_order(str(tenant), ids)
        return order if self._failover else order[:1]

    # -- queries -------------------------------------------------------------
    def query(
        self,
        sql: str,
        tenant: str = "default",
        timeout: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Route one SQL query to the tenant's worker and return the
        collected batch (dict of numpy arrays, like ``collect()``). With
        failover on, a retryable failure moves to the next rendezvous
        candidate while the deadline allows; a non-retryable one raises
        immediately. With tracing on, the request roots a
        ``frontdoor-request`` trace carrying every attempt (and, when
        stitching is on, the workers' grafted span trees)."""
        if not self._tracing and self.flight is None:
            return self._route(sql, tenant, timeout, None)
        root = None
        ctx = None
        if self._tracing:
            ctx = spans.TraceContext.new()
            root = spans.start_trace(
                "frontdoor-request",
                cat="fabric",
                max_spans=self._trace_max_spans,
                query=sql,
                tenant=tenant,
            )
            root.attrs["trace_id"] = ctx.trace_id
        info: Dict[str, Any] = {"retries": 0, "hedged": False, "worker": None}
        t0 = time.monotonic()
        error: Optional[str] = None
        try:
            with spans.attach(root), spans.bind_context(ctx):
                return self._route(sql, tenant, timeout, info)
        except Exception as exc:
            error = type(exc).__name__
            raise
        finally:
            self._seal_route(root, sql, tenant, time.monotonic() - t0, error, info)

    def _route(
        self,
        sql: str,
        tenant: str,
        timeout: Optional[float],
        info: Optional[Dict[str, Any]],
    ) -> Dict[str, Any]:
        candidates = self._candidates(tenant)
        if self._hedge_s > 0 and len(candidates) > 1:
            return self._hedged_query(candidates, sql, tenant, timeout, info)
        deadline = None if timeout is None else self._clock() + timeout
        last_exc: Optional[BaseException] = None
        for i, wid in enumerate(candidates):
            remaining = timeout
            if deadline is not None:
                remaining = deadline - self._clock()
                if i > 0 and remaining <= 0:
                    break  # deadline spent: don't start an attempt that can't finish
            _count_route(wid)
            worker = self._workers[wid]
            try:
                out = self._attempt(wid, worker, sql, tenant, remaining)
            except Exception as exc:
                if not self._failover or not _retryable(exc, worker):
                    if self._health is not None and _retryable(exc, worker):
                        self._health.note_failure(wid)
                    raise
                if self._health is not None:
                    self._health.note_failure(wid)
                _count_failover_retry(wid)
                if info is not None:
                    info["retries"] += 1
                last_exc = exc
                continue
            if self._health is not None:
                self._health.note_ok(wid)
            if info is not None:
                info["worker"] = wid
            return out
        _count_failover_exhausted()
        if last_exc is not None:
            raise last_exc
        raise WorkerUnavailable(
            f"no candidate answered for tenant {tenant!r} within the deadline"
        )

    def _attempt(
        self, wid: str, worker: Any, sql: str, tenant: str, timeout: Optional[float]
    ) -> Dict[str, Any]:
        """One dispatch wrapped in a ``route`` span — the per-attempt node
        that failover retries and hedges appear as siblings of. The hop gets
        a child TraceContext so the worker's tree records WHICH attempt
        parented it (``span_id`` here == the worker root's
        ``parent_span_id``)."""
        ctx = spans.current_context()
        hop = ctx.child() if ctx is not None else None
        with spans.span("route", cat="fabric", worker=wid) as att:
            if hop is not None:
                att.set(span_id=hop.span_id)
            with spans.bind_context(hop):
                try:
                    out = self._dispatch(worker, sql, tenant, timeout)
                except Exception as exc:
                    att.set(outcome="error", error=type(exc).__name__)
                    raise
                att.set(outcome="ok")
                return out

    def _dispatch(
        self, worker: Any, sql: str, tenant: str, timeout: Optional[float]
    ) -> Dict[str, Any]:
        if isinstance(worker, str):
            return self._http_query(worker, sql, tenant, timeout)
        cur = spans.current_span()
        if cur is None:
            return worker.query(sql, timeout=timeout, tenant=tenant)
        # traced in-process dispatch: go through submit() so the worker's
        # span tree (fut.request_root) is graftable; same-process trees share
        # a perf_counter domain, so anchoring at the worker root's own t0
        # keeps the stitched alignment exact
        fut = worker.submit(sql, timeout=timeout, tenant=tenant)
        t = worker.admission.default_timeout if timeout is None else timeout
        try:
            return fut.result(timeout=None if t is None else t + 5.0)
        finally:
            wroot = getattr(fut, "request_root", None)
            if wroot is not None:
                wire = spans.to_wire(
                    wroot, self._stitch_max_spans, self._stitch_max_bytes
                )
                spans.graft_remote(cur, wire, anchor_t0=wroot.t0)

    def _hedged_query(
        self,
        candidates: List[str],
        sql: str,
        tenant: str,
        timeout: Optional[float],
        info: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Primary + (on silence or failure) one backup, first answer wins.
        Safe because FrontDoor queries are idempotent reads — both answers
        are correct, we just keep whichever lands first. Each runner carries
        the caller's span context across its thread (``spans.attach``), so
        primary and hedge show as sibling ``route`` spans on one tree."""
        results: "queue.Queue" = queue.Queue()
        parent = spans.current_span()
        ctx = spans.current_context()

        def run(wid: str, hedge: bool) -> None:
            _count_route(wid)
            hop = ctx.child() if ctx is not None else None
            with spans.attach(parent), spans.span(
                "route", cat="fabric", worker=wid, hedge=hedge
            ) as att:
                if hop is not None:
                    att.set(span_id=hop.span_id)
                try:
                    with spans.bind_context(hop):
                        out = self._dispatch(self._workers[wid], sql, tenant, timeout)
                except Exception as exc:  # delivered to the caller via the queue
                    att.set(outcome="error", error=type(exc).__name__)
                    results.put((wid, exc, None))
                else:
                    att.set(outcome="ok")
                    results.put((wid, None, out))

        def spawn(wid: str, hedge: bool = False) -> None:
            threading.Thread(target=run, args=(wid, hedge), daemon=True).start()

        spawn(candidates[0])
        outstanding, hedged = 1, False
        first_exc: Optional[BaseException] = None
        while outstanding:
            try:
                wid, exc, out = results.get(timeout=None if hedged else self._hedge_s)
            except queue.Empty:
                hedged = True
                outstanding += 1
                _count_hedge()
                if info is not None:
                    info["hedged"] = True
                spawn(candidates[1], hedge=True)
                continue
            outstanding -= 1
            if exc is None:
                if self._health is not None:
                    self._health.note_ok(wid)
                if info is not None:
                    info["worker"] = wid
                return out
            if self._health is not None and _retryable(exc, self._workers[wid]):
                self._health.note_failure(wid)
            if first_exc is None or not isinstance(exc, WorkerUnavailable):
                first_exc = exc
            if not hedged:
                # the primary failed outright before the hedge delay: the
                # backup is now a failover attempt, not a hedge
                hedged = True
                outstanding += 1
                _count_failover_retry(wid)
                if info is not None:
                    info["retries"] += 1
                spawn(candidates[1])
        _count_failover_exhausted()
        assert first_exc is not None
        raise first_exc

    def _trace_headers(self) -> Dict[str, str]:
        """Propagation headers for one worker hop: the current context's
        ``traceparent`` plus the stitch byte budget when stitched-tree
        shipping is on. Empty (no extra request bytes at all) when no trace
        is active or propagation is conf'd off."""
        headers: Dict[str, str] = {}
        ctx = spans.current_context()
        if self._propagate and ctx is not None:
            headers["traceparent"] = ctx.to_traceparent()
            if self._stitch:
                headers["x-hs-stitch"] = str(self._stitch_max_bytes)
        return headers

    def _http_query(
        self, base: str, sql: str, tenant: str, timeout: Optional[float]
    ) -> Dict[str, Any]:
        import numpy as np

        from hyperspace_tpu_torch.reliability.faults import FAULTS

        params = {"sql": sql, "tenant": tenant}
        if timeout is not None:
            params["timeoutMs"] = str(int(timeout * 1000))
        url = f"{base}/query?{urllib.parse.urlencode(params)}"
        http_timeout = 300.0 if timeout is None else timeout + 5.0
        try:
            # the seam lives inside the handler so an injected transient
            # (an OSError subclass) surfaces as WorkerUnavailable, exactly
            # like the real connection failure it stands in for
            if FAULTS.active:
                FAULTS.check("fabric.http", f"{base}/query")
            request = urllib.request.Request(url, headers=self._trace_headers())
            with urllib.request.urlopen(request, timeout=http_timeout) as resp:
                body = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as exc:
            # the endpoint replies with a typed JSON error body on 4xx/5xx;
            # surface it instead of the bare transport error
            try:
                body = json.loads(exc.read().decode("utf-8"))
            except Exception:
                raise WorkerUnavailable(
                    f"worker {base} failed: HTTP {exc.code}",
                    error_type="HTTPError",
                ) from exc
        except (urllib.error.URLError, OSError, TimeoutError) as exc:
            # connection refused / reset / timed out: the process is gone or
            # unreachable — exactly what failover exists for
            raise WorkerUnavailable(
                f"worker {base} unreachable: {exc}", error_type=type(exc).__name__
            ) from exc
        remote_trace = body.get("trace")
        if remote_trace:
            # stitch the worker's serialized tree under the live attempt
            # span; anchoring at the attempt's start folds the network hop
            # into the alignment error (documented in observability.md)
            cur = spans.current_span()
            if cur is not None:
                spans.graft_remote(
                    cur, remote_trace,
                    pid=remote_trace.get("pid"), anchor_t0=cur.t0,
                )
        if "error" in body:
            message = f"worker {base} failed: {body['error']}"
            error_type = str(body.get("errorType", ""))
            kind = str(body.get("kind", ""))
            # re-classification point (reliability.errors taxonomy, serialized
            # by WorkerEndpoint._query): transient → retry elsewhere may help;
            # corrupt/error → every worker fails identically, don't retry
            if body.get("retryable", kind == "transient"):
                raise WorkerUnavailable(message, error_type=error_type,
                                        kind=kind or "transient")
            raise WorkerError(message, error_type=error_type, kind=kind or "error")
        return {k: np.asarray(v) for k, v in body["columns"].items()}

    def _seal_route(
        self,
        root: Optional[Any],
        sql: str,
        tenant: str,
        latency_s: float,
        error: Optional[str],
        info: Dict[str, Any],
    ) -> None:
        """Routing completion hook (mirrors ``QueryServer._seal``): finish
        the router-side tree, publish the end-to-end profile, and
        flight-record slow/errored routed requests with their failover and
        hedge outcomes."""
        profile = None
        if root is not None:
            root.attrs.update(
                retries=info["retries"], hedged=info["hedged"],
                worker=info["worker"],
            )
            from hyperspace_tpu_torch.obs.profile import build_profile

            profile = build_profile(root, query=sql, error=error)
            self._profiles.append(profile)
        if self.flight is not None and (
            error is not None
            or (self._slow_s is not None and latency_s >= self._slow_s)
        ):
            self.flight.record(
                "error" if error is not None else "slow",
                latency_s,
                query=sql,
                tenant=tenant,
                profile=profile,
                route=dict(info),
            )

    # -- routed-request observability ----------------------------------------
    def last_profiles(self) -> List[Any]:
        """Most recent routed-request profiles (end-to-end stitched trees
        when stitching is on), oldest first; empty without tracing."""
        return list(self._profiles)

    def last_query_profile(self) -> Optional[Any]:
        """The most recent routed request's :class:`QueryProfile` — the ONE
        stitched router+worker tree when stitching is on."""
        return self._profiles[-1] if self._profiles else None

    def last_slow_queries(self) -> List[Any]:
        """Routed flight-recorder entries (slow/errored), oldest first."""
        return [] if self.flight is None else self.flight.last_slow_queries()

    # -- federation ----------------------------------------------------------
    def profilez(self) -> Dict[str, Any]:
        """Federated ``/profilez``: every worker's ProfileHistory snapshot
        merged into one fleet view (``obs.history.merge_history_snapshots``
        — P² sketches combine via n-weighted quantile averaging; see the
        documented error model). Per-worker reachability rides along under
        ``workers``."""
        from hyperspace_tpu_torch.obs.history import merge_history_snapshots

        snaps: Dict[str, Optional[Dict[str, Any]]] = {}
        for wid, worker in self._workers.items():
            try:
                if isinstance(worker, str):
                    with urllib.request.urlopen(
                        f"{worker}/profilez", timeout=self._fed_timeout
                    ) as resp:
                        snaps[wid] = json.loads(resp.read().decode("utf-8"))
                else:
                    history = getattr(worker, "history", None)
                    snaps[wid] = None if history is None else history.snapshot()
            except Exception:
                if self._health is None:
                    raise
                self._health.note_failure(wid)
                snaps[wid] = None
        merged = merge_history_snapshots([s for s in snaps.values() if s])
        merged["workers"] = {
            wid: None if s is None else {
                "fingerprints": int(s.get("fingerprints", 0) or 0),
                "evicted": int(s.get("evicted", 0) or 0),
            }
            for wid, s in snaps.items()
        }
        return merged

    def federated_statusz(self) -> Dict[str, Any]:
        """Fleet ``/statusz``: the per-worker bodies (:meth:`statusz`,
        shape unchanged) plus a merged per-tenant SLO view — summed
        good/bad, fleet compliance, and the WORST per-window burn rate
        across workers (the alerting-relevant aggregate: one burning worker
        must not be averaged away by idle peers)."""
        per = self.statusz()
        tenants: Dict[str, Dict[str, Any]] = {}
        for wid, body in per.items():
            if not isinstance(body, dict):
                continue
            slo = body.get("slo") or {}
            for tenant, st in (slo.get("tenants") or {}).items():
                cur = tenants.setdefault(
                    tenant, {"good": 0, "bad": 0, "burnRates": {}}
                )
                cur["good"] += int(st.get("good", 0) or 0)
                cur["bad"] += int(st.get("bad", 0) or 0)
                for window, rate in (st.get("burnRates") or {}).items():
                    prev = cur["burnRates"].get(window)
                    rate = float(rate)
                    if prev is None or rate > prev:
                        cur["burnRates"][window] = rate
        for cur in tenants.values():
            total = cur["good"] + cur["bad"]
            cur["compliance"] = (cur["good"] / total) if total else None
        return {"workers": per, "slo": {"tenants": tenants}}

    # -- health observation --------------------------------------------------
    def probe(self, timeout: float = 5.0) -> Dict[str, Optional[dict]]:
        """One ``/healthz`` sweep over every worker: successes feed
        ``note_ok`` (which is also how an ejected worker's half-open probe
        passes), failures feed ``note_failure``, and the reported
        last-applied ``commitSeq`` values are compared across the fleet to
        eject wedged-but-alive workers (``note_stale``). Returns the
        healthz bodies by worker id (None for unreachable)."""
        out: Dict[str, Optional[dict]] = {}
        seqs: Dict[str, int] = {}
        for wid, worker in self._workers.items():
            if isinstance(worker, str):
                try:
                    with urllib.request.urlopen(
                        f"{worker}/healthz", timeout=timeout
                    ) as resp:
                        body = json.loads(resp.read().decode("utf-8"))
                except Exception:
                    out[wid] = None
                    if self._health is not None:
                        self._health.note_failure(wid)
                    continue
            else:
                body = _local_healthz(worker)
            out[wid] = body
            node = body.get("node")
            if node:
                self._nodes[wid] = str(node)
            if self._health is not None and body.get("ok"):
                self._health.note_ok(wid)
            if "commitSeq" in body:
                seqs[wid] = int(body["commitSeq"])
        if self._health is not None and len(seqs) > 1:
            fleet_max = max(seqs.values())
            for wid, seq in seqs.items():
                self._health.note_stale(wid, fleet_max - seq)
        return out

    def check_beats(self) -> Dict[str, float]:
        """Judge sidecar-heartbeat ages: each worker whose fabric node id
        is known (learned via :meth:`probe`) is checked against its
        ``_fabric/nodes/<node>.json`` ledger's ``updatedAt``. Needs
        ``system_path``; returns observed ages by worker id."""
        ages: Dict[str, float] = {}
        if self._health is None or not self._system_path:
            return ages
        from hyperspace_tpu_torch.fabric import records

        ledgers = records.read_peer_node_files(self._system_path, "")
        now = time.time()
        for wid, node in self._nodes.items():
            state = ledgers.get(node)
            if state is None:
                continue
            age = max(0.0, now - float(state.get("updatedAt", 0.0)))
            ages[wid] = age
            self._health.note_beat(wid, age)
        return ages

    # -- aggregation ---------------------------------------------------------
    def metrics_text(self) -> str:
        """One merged Prometheus exposition over every worker. With health
        tracking on, an unreachable worker is skipped (and noted) instead
        of failing the whole merge."""
        texts = []
        for wid, worker in self._workers.items():
            try:
                if isinstance(worker, str):
                    with urllib.request.urlopen(f"{worker}/metrics", timeout=30) as resp:
                        texts.append(resp.read().decode("utf-8"))
                else:
                    texts.append(worker.prometheus_text())
            except Exception:
                if self._health is None:
                    raise
                self._health.note_failure(wid)
        return merge_prometheus_texts(texts)

    def statusz(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for wid, worker in self._workers.items():
            try:
                if isinstance(worker, str):
                    with urllib.request.urlopen(f"{worker}/statusz", timeout=30) as resp:
                        out[wid] = json.loads(resp.read().decode("utf-8"))
                else:
                    out[wid] = worker.statusz()
            except Exception:
                if self._health is None:
                    raise
                self._health.note_failure(wid)
                out[wid] = None
        return out


def _local_healthz(server, started_at: Optional[float] = None) -> Dict[str, Any]:
    """The /healthz body for one QueryServer — shared by WorkerEndpoint and
    the FrontDoor's in-process probe so both paths report identically:
    admission queue depth (shed pressure), last-applied commit_seq (watcher
    wedge detection), uptime, and the fabric node id (heartbeat mapping)."""
    session = getattr(server, "session", None)
    fabric = getattr(session, "_fabric", None) if session is not None else None
    bus = getattr(session, "lifecycle_bus", None) if session is not None else None
    admission = getattr(server, "admission", None)
    body: Dict[str, Any] = {
        "ok": True,
        "server": getattr(server, "server_name", "?"),
        "queueDepth": int(getattr(admission, "queued", 0) or 0),
        "commitSeq": int(getattr(bus, "commit_seq", 0) or 0),
    }
    if fabric is not None:
        body["node"] = fabric.node_id
    if started_at is not None:
        body["uptimeSeconds"] = max(0.0, time.time() - started_at)
    return body


class WorkerEndpoint:
    """Expose one QueryServer to FrontDoors in other processes over stdlib
    HTTP. Read-mostly by design: ``/query`` executes through the server's
    normal admission path (deadline and tenant forwarded), everything else
    is a snapshot. ``port=0`` binds an ephemeral port (read ``.port``)."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0):
        self.server = server
        self._started_at = time.time()
        endpoint = self

        class _Handler(BaseHTTPRequestHandler):
            daemon_threads = True

            def log_message(self, fmt, *args):  # no stderr chatter per request
                pass

            def do_GET(self):
                try:
                    endpoint._handle(self)
                except BrokenPipeError:
                    pass
                except Exception as exc:  # defensive: never kill the accept loop
                    try:
                        self.send_error(500, explain=str(exc))
                    except Exception:
                        pass

            do_POST = do_GET

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host = self._httpd.server_address[0]
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "WorkerEndpoint":
        if self._thread is None:
            self._started_at = time.time()
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name=f"hs-fabric-worker-{self.port}",
                daemon=True,
            )
            self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "WorkerEndpoint":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request handling ----------------------------------------------------
    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        parsed = urllib.parse.urlparse(req.path)
        path = parsed.path.rstrip("/") or "/"
        if path == "/query":
            self._query(req, urllib.parse.parse_qs(parsed.query))
        elif path == "/metrics":
            body = self.server.prometheus_text().encode("utf-8")
            self._reply(req, 200, "text/plain; version=0.0.4; charset=utf-8", body)
        elif path == "/statusz":
            self._reply_json(req, 200, self.server.statusz())
        elif path == "/profilez":
            history = getattr(self.server, "history", None)
            if history is None:
                self._reply_json(req, 404, {"error": "profile history disabled"})
            else:
                self._reply_json(req, 200, history.snapshot())
        elif path == "/healthz":
            self._reply_json(
                req, 200, _local_healthz(self.server, started_at=self._started_at)
            )
        else:
            self._reply_json(
                req, 404,
                {"error": "not found",
                 "endpoints": ["/query", "/metrics", "/statusz", "/profilez",
                               "/healthz"]},
            )

    def _stitch_payload(self, fut, stitch_budget: Optional[str]) -> Optional[Dict[str, Any]]:
        """The bounded span-tree payload for a ``/query`` response, or None
        when the router did not ask (no ``x-hs-stitch`` header), the budget
        is malformed, or this worker produced no tree (tracing off).
        Responses without the header stay byte-identical to a build without
        stitching."""
        if not stitch_budget or fut is None:
            return None
        root = getattr(fut, "request_root", None)
        if root is None:
            return None
        try:
            budget = int(stitch_budget)
        except ValueError:
            return None
        conf = self.server.session.conf
        wire = spans.to_wire(
            root,
            max_spans=conf.obs_fabric_stitch_max_spans,
            max_bytes=max(1, min(budget, conf.obs_fabric_stitch_max_bytes)),
        )
        wire["pid"] = os.getpid()
        wire["server"] = self.server.server_name
        return wire

    def _query(self, req: BaseHTTPRequestHandler, query: Dict[str, list]) -> None:
        sql = (query.get("sql") or [None])[0]
        if not sql:
            self._reply_json(
                req, 400,
                {"error": "missing sql parameter", "errorType": "ValueError",
                 "kind": "error", "retryable": False},
            )
            return
        tenant = (query.get("tenant") or ["default"])[0]
        timeout_ms = (query.get("timeoutMs") or [None])[0]
        timeout = None if timeout_ms is None else float(timeout_ms) / 1000.0
        # inbound trace identity: a router's traceparent parents this
        # worker's span tree; malformed headers degrade to untraced
        ctx = spans.parse_traceparent(req.headers.get("traceparent"))
        stitch_budget = req.headers.get("x-hs-stitch")
        fut = None
        try:
            fut = self.server.submit(
                sql, timeout=timeout, tenant=tenant, trace_context=ctx
            )
            t = self.server.admission.default_timeout if timeout is None else timeout
            batch = fut.result(timeout=None if t is None else t + 5.0)
        except Exception as exc:
            # serialize the reliability classification so the FrontDoor can
            # rebuild the retry/no-retry decision on its side of the wire
            from hyperspace_tpu_torch.reliability import errors as rel_errors

            retryable = not rel_errors.is_corrupt(exc)
            body: Dict[str, Any] = {
                "error": f"{type(exc).__name__}: {exc}",
                "errorType": type(exc).__name__,
                "kind": "transient" if retryable else "corrupt",
                "retryable": retryable,
            }
            trace = self._stitch_payload(fut, stitch_budget)
            if trace is not None:
                body["trace"] = trace
            self._reply_json(req, 503 if retryable else 400, body)
            return
        body = {"columns": {k: v.tolist() for k, v in batch.items()}}
        trace = self._stitch_payload(fut, stitch_budget)
        if trace is not None:
            body["trace"] = trace
        self._reply_json(req, 200, body)

    @staticmethod
    def _reply(req: BaseHTTPRequestHandler, code: int, ctype: str, body: bytes) -> None:
        req.send_response(code)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    @classmethod
    def _reply_json(cls, req: BaseHTTPRequestHandler, code: int, obj: Any) -> None:
        cls._reply(req, code, "application/json; charset=utf-8",
                   json.dumps(obj, default=str).encode("utf-8"))
