"""QueryServer: the concurrent serving front-end over one Session.

Request life cycle::

    submit(sql or DataFrame)          caller thread
      parse (text-memoized) -> fingerprint -> admission (bounded queue,
      reject on overflow) -> prefetch hint for a known template's buckets
    worker thread
      drain a micro-batch -> plan-cache lookup (exact / parameterized bind)
      or compile+insert -> execute (shared-scan batch when compatible)
      -> relabel to the request's aliases -> resolve the Future

Results are identical to ``session.sql(q).collect()`` — the cache and the
batcher are throughput optimizations, never semantic changes. Each request
captures the session's hyperspace flag at submit time and workers pin it via
``session.hyperspace_scope`` so a toggle racing the queue can't leak into
requests admitted before it.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

from hyperspace_tpu_torch.obs import metrics as obs_metrics
from hyperspace_tpu_torch.obs import spans, stages
from hyperspace_tpu_torch.obs.profile import build_profile
from hyperspace_tpu_torch.serving.admission import (
    AdmissionController,
    AdmissionRejected,
    RequestTimeout,
    ServerClosed,
)
from hyperspace_tpu_torch.serving.batcher import execute_shared_scan, shared_scan_ops
from hyperspace_tpu_torch.serving.bucket_cache import BucketCache
from hyperspace_tpu_torch.serving.fingerprint import Fingerprint, plan_fingerprint
from hyperspace_tpu_torch.serving.metrics import ServingMetrics
from hyperspace_tpu_torch.serving.plan_cache import CompiledPlan, PlanCache, session_token
from hyperspace_tpu_torch.serving.result_cache import ResultCache, version_brand
from hyperspace_tpu_torch.serving.scheduler import CostAwareScheduler, classify_cost

from hyperspace_tpu_torch.check.locks import named_lock
from hyperspace_tpu_torch.lifecycle.snapshot import SnapshotHandle, snapshot_scope

__all__ = ["QueryServer", "AdmissionRejected", "RequestTimeout", "ServerClosed"]

# distinguishes concurrent QueryServers' series in the process-wide registry;
# intentionally process-local — cross-process label uniqueness comes from the
# explicit ``name`` option (fabric workers pass one)
_server_seq = itertools.count()  # hscheck: disable=process-local-state


class _Request:
    __slots__ = (
        "plan", "fp", "token", "enabled", "future", "deadline", "submitted_at",
        "root", "tenant", "query_text", "cost_class", "brand", "dequeued_at",
        "sched_charge", "snapshot", "clock",
    )

    def __init__(self, plan, fp: Fingerprint, token, enabled: bool, deadline, root=None,
                 tenant: str = "default", query_text: str = "",
                 cost_class: str = "unknown", brand: Optional[str] = None,
                 snapshot=None, clock: Optional[stages.RequestClock] = None):
        self.plan = plan
        self.fp = fp
        self.token = token
        self.enabled = enabled
        self.future: "Future" = Future()
        self.deadline = deadline
        # the moment the request enters the admission queue, on the stage
        # clock's timeline (time.perf_counter)
        self.submitted_at = time.perf_counter()
        # per-request span-tree root (None when obs tracing is off); workers
        # attach() it so each request's spans land in its own disjoint tree
        self.root = root
        self.tenant = tenant
        self.query_text = query_text
        # scheduling/caching context: predicted cost class for priority and
        # wait-time labels, the submit-time data-version brand for the result
        # cache, and the dispatch bookkeeping the fair scheduler corrects
        # against at completion
        self.cost_class = cost_class
        self.brand = brand
        self.dequeued_at: Optional[float] = None
        self.sched_charge = 0.0
        # admission-time SnapshotHandle (None when pinning is off): workers
        # enter snapshot_scope(self.snapshot) so every log-version resolution
        # sees the roster this request was admitted against
        self.snapshot = snapshot
        # the request's stage clock (obs/stages.py), started on entry to
        # submit; workers bind it wherever they attach the span root
        self.clock = clock if clock is not None else stages.RequestClock(root)

    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline

    @property
    def group_key(self):
        return (self.token, self.fp.structure)


class QueryServer:
    """Concurrent query-serving runtime over a :class:`Session`.

    Constructor keyword overrides (each defaulting to its
    ``hyperspace.serving.*`` conf key): ``queue_depth``, ``workers``,
    ``default_timeout``, ``plan_cache_enabled``, ``plan_cache_max_entries``,
    ``micro_batch_enabled``, ``micro_batch_max_requests``,
    ``micro_batch_max_wait_ms``, ``bucket_cache_bytes``,
    ``prefetch_enabled``, ``prefetch_workers``, ``sched_enabled``,
    ``sched_interactive_ms``, ``sched_heavy_ms``, ``sched_min_confidence``,
    ``sched_max_queued_seconds``, ``sched_tenant_weights``,
    ``sched_tenant_rate``, ``sched_tenant_burst``, ``sched_burn_threshold``,
    ``sched_burn_factor``, ``result_cache_enabled``, ``result_cache_bytes``,
    ``result_cache_max_entry_bytes``, ``result_cache_subsumption``; plus
    ``name`` (explicit metrics ``server=`` label, defaulting to the
    process-sequential ``qsN``).
    """

    def __init__(self, session, **overrides):
        conf = session.conf
        self.session = session

        def opt(name, conf_value):
            v = overrides.pop(name, None)
            return conf_value if v is None else v

        self.workers_n = int(opt("workers", conf.serving_workers))
        self.plan_cache_enabled = bool(opt("plan_cache_enabled", conf.serving_plan_cache_enabled))
        self.micro_batch_enabled = bool(opt("micro_batch_enabled", conf.serving_micro_batch_enabled))
        self.micro_batch_max = int(opt("micro_batch_max_requests", conf.serving_micro_batch_max_requests))
        self.micro_batch_wait_s = float(opt("micro_batch_max_wait_ms", conf.serving_micro_batch_max_wait_ms)) / 1000.0
        self.prefetch_enabled = bool(opt("prefetch_enabled", conf.serving_prefetch_enabled))

        depth = int(opt("queue_depth", conf.serving_queue_depth))
        default_timeout = opt("default_timeout", conf.serving_default_timeout_seconds)
        self.sched_enabled = bool(opt("sched_enabled", conf.serving_sched_enabled))
        self._interactive_s = float(opt("sched_interactive_ms", conf.serving_sched_interactive_ms)) / 1000.0
        self._heavy_s = float(opt("sched_heavy_ms", conf.serving_sched_heavy_ms)) / 1000.0
        self._min_confidence = float(opt("sched_min_confidence", conf.serving_sched_min_confidence))
        sched_max_queued_s = float(opt("sched_max_queued_seconds", conf.serving_sched_max_queued_seconds))
        sched_weights = opt("sched_tenant_weights", conf.serving_sched_tenant_weights)
        sched_rate = float(opt("sched_tenant_rate", conf.serving_sched_tenant_rate))
        sched_burst = float(opt("sched_tenant_burst", conf.serving_sched_tenant_burst))
        sched_burn_threshold = float(opt("sched_burn_threshold", conf.serving_sched_burn_threshold))
        sched_burn_factor = float(opt("sched_burn_factor", conf.serving_sched_burn_factor))
        if self.sched_enabled:
            self.admission: AdmissionController = CostAwareScheduler(
                depth=depth,
                default_timeout=default_timeout,
                interactive_s=self._interactive_s,
                heavy_s=self._heavy_s,
                min_confidence=self._min_confidence,
                max_queued_seconds=sched_max_queued_s,
                tenant_weights=sched_weights,
                tenant_rate=sched_rate,
                tenant_burst=sched_burst,
                burn_threshold=sched_burn_threshold,
                burn_factor=sched_burn_factor,
                cost_fn=self._sched_cost,
                burn_rate_fn=self._sched_burn,
            )
        else:
            self.admission = AdmissionController(depth=depth, default_timeout=default_timeout)
        # eagerly-expired queued requests still get their telemetry sealed
        self.admission.on_expired = self._expire_seal
        self.result_cache = None
        rc_enabled = bool(opt("result_cache_enabled", conf.serving_result_cache_enabled))
        rc_bytes = int(opt("result_cache_bytes", conf.serving_result_cache_bytes))
        rc_entry_bytes = int(opt("result_cache_max_entry_bytes", conf.serving_result_cache_max_entry_bytes))
        rc_subsumption = bool(opt("result_cache_subsumption", conf.serving_result_cache_subsumption))
        if rc_enabled:
            self.result_cache = ResultCache(
                max_bytes=rc_bytes,
                max_entry_bytes=rc_entry_bytes,
                subsumption=rc_subsumption,
            )
        self.plan_cache = PlanCache(int(opt("plan_cache_max_entries", conf.serving_plan_cache_max_entries)))
        self.bucket_cache = BucketCache(
            int(opt("bucket_cache_bytes", conf.serving_bucket_cache_bytes)),
            prefetch_workers=int(opt("prefetch_workers", conf.serving_prefetch_workers)),
        )
        # shared broadcast-join build sides (exec/join_stream.py consults
        # session.join_build_cache while this server is attached)
        from hyperspace_tpu_torch.serving.build_cache import JoinBuildCache

        self.join_build_cache = JoinBuildCache(
            int(opt("join_build_cache_bytes", conf.join_build_cache_max_bytes))
        )
        # every server labels its series in the process-wide registry (a
        # private registry when metrics are conf'd off, so accounting still
        # works but nothing is published); an explicit name keeps labels
        # distinct ACROSS processes too (every process counts from qs0), so
        # a fabric FrontDoor can aggregate /metrics without collisions
        self.server_name = str(opt("name", "") or "") or f"qs{next(_server_seq)}"
        self.registry = (
            obs_metrics.REGISTRY if conf.obs_metrics_enabled else obs_metrics.MetricsRegistry()
        )
        self.metrics = ServingMetrics(registry=self.registry, server=self.server_name)
        self.admission.bind_registry(self.registry, server=self.server_name)
        self.plan_cache.bind_registry(self.registry, server=self.server_name)
        self.bucket_cache.bind_registry(self.registry, server=self.server_name)
        self.join_build_cache.bind_registry(self.registry, server=self.server_name)
        if self.result_cache is not None:
            self.result_cache.bind_registry(self.registry, server=self.server_name)
        self.tracing_enabled = bool(conf.obs_tracing_enabled)
        self._trace_max_spans = conf.obs_trace_max_spans
        self._profiles: "deque" = deque(maxlen=max(1, conf.obs_profile_history))
        # identity facts every exposition should carry: the always-1 build
        # gauge makes merged/federated scrapes attributable to a version and
        # fabric node, and the commit-seq gauge puts each process's applied
        # log position beside its serving series
        from hyperspace_tpu_torch.fabric.records import local_node_id
        from hyperspace_tpu_torch.version import __version__

        self.node_id = local_node_id(conf)
        self.registry.gauge(
            "hs_build_info",
            "always 1; the labels carry the build version, fabric node, and "
            "server identity of this exposition",
            version=__version__, node=self.node_id, server=self.server_name,
        ).set(1.0)
        if conf.fabric_enabled:
            # fabric-off keeps the exposition free of hs_fabric_* families
            # (the default-off byte-identity contract in docs/scale-out.md)
            bus_ref = self.session.lifecycle_bus
            self.registry.gauge(
                "hs_fabric_commit_seq",
                "last-applied commit sequence of this process's invalidation bus",
                fn=lambda: float(getattr(bus_ref, "commit_seq", 0) or 0),
                server=self.server_name, node=self.node_id,
            )

        # query intelligence: fingerprint history, SLO tracking, slow-query
        # flight recorder, optional HTTP telemetry endpoint (obs/history.py,
        # obs/slo.py, obs/export.py) — each behind its own conf key
        self.history = None
        if conf.obs_history_enabled:
            from hyperspace_tpu_torch.obs.history import ProfileHistory

            self.history = ProfileHistory(
                max_fingerprints=conf.obs_history_max_fingerprints,
                persist_path=self._telemetry_path("profile_history.jsonl")
                if conf.obs_history_persist else None,
                registry=self.registry,
                server=self.server_name,
            )
        self.slo = None
        if conf.obs_slo_target_ms > 0:
            from hyperspace_tpu_torch.obs.slo import SloTracker

            self.slo = SloTracker(
                target_ms=conf.obs_slo_target_ms,
                objective=conf.obs_slo_objective,
                windows_s=conf.obs_slo_windows_seconds,
                registry=self.registry,
                server=self.server_name,
            )
        self.flight = None
        self._slow_s = None
        if conf.obs_slow_query_ms > 0:
            from hyperspace_tpu_torch.obs.history import FlightRecorder

            self._slow_s = conf.obs_slow_query_ms / 1000.0
            slow_dir = conf.obs_slow_query_dir
            if slow_dir is None:
                slow_dir = self._telemetry_path("slow")
            self.flight = FlightRecorder(
                max_entries=conf.obs_slow_query_max_entries,
                directory=slow_dir or None,
                registry=self.registry,
                server=self.server_name,
            )
        self.telemetry = None
        self._telemetry_port = conf.obs_http_port
        self._telemetry_host = conf.obs_http_host
        if overrides:
            raise TypeError(f"Unknown QueryServer options: {sorted(overrides)}")

        self._sql_memo_lock = named_lock("serving.sqlMemo")
        self._sql_memo: Dict[str, tuple] = {}
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._started = False
        self._closed = False
        self._prev_bucket_cache = None
        self._prev_join_build_cache = None

    def _telemetry_path(self, *parts) -> Optional[str]:
        """A path under ``<system.path>/_telemetry`` (the index log
        directory's sibling telemetry area), or None without a system path."""
        import os

        base = self.session.conf.system_path
        if not base:
            return None
        return os.path.join(base, "_telemetry", *parts)

    # -- scheduler wiring ----------------------------------------------------
    def _sched_cost(self, item):
        """Scheduler cost hook: the fingerprint history's learned estimate
        for the request's structure (None without history / unseen shape)."""
        if self.history is None:
            return None
        return self.history.estimate_cost(item.fp.structure)

    def _sched_burn(self, tenant: str) -> float:
        """Scheduler burn hook: the tenant's SLO burn rate over the shortest
        configured window (the fastest-reacting signal)."""
        if self.slo is None:
            return 0.0
        return self.slo.burn_rate(min(self.slo.windows_s), tenant)

    def _expire_seal(self, r: "_Request") -> None:
        with stages.bind(r.clock), stages.stage(self.session, "finish"):
            self._seal(r, error="RequestTimeout")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "QueryServer":
        if self._started:
            return self
        self._started = True
        if self._telemetry_port is not None and self.telemetry is None:
            self.serve_telemetry(port=self._telemetry_port, host=self._telemetry_host)
        # the process-global dispatch recorder cannot disambiguate concurrent
        # requests — exec.trace.recording() refuses to start while we serve
        from hyperspace_tpu_torch.exec import trace as exec_trace

        exec_trace.server_started()
        # executor-side scans consult session.bucket_cache when present
        self._prev_bucket_cache = getattr(self.session, "bucket_cache", None)
        self.session.bucket_cache = self.bucket_cache
        self._prev_join_build_cache = getattr(self.session, "join_build_cache", None)
        self.session.join_build_cache = self.join_build_cache
        # fabric coherence: the sidecar publishes/merges this server's SLO
        # and token-bucket accounting while it serves
        fabric = getattr(self.session, "_fabric", None)
        if fabric is not None:
            fabric.attach_server(self)
        # any commit (local, or a remote one replayed by the fabric watcher)
        # drops the SQL-text memo: its entries embed each scan's source
        # listing, so a memoized plan would keep serving the pre-commit file
        # set. Commits are rare; re-parsing after one is cheap.
        self.session.lifecycle_bus.subscribe(self._on_commit_event)
        for i in range(self.workers_n):
            t = threading.Thread(target=self._worker, name=f"hs-serve-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def shutdown(self, wait: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if wait:
            for t in self._threads:
                t.join(timeout=10)
        # drain anything still queued so no future is left dangling
        while True:
            req = self.admission.take_nowait()
            if req is None:
                break
            if not req.future.done():
                req.future.set_exception(ServerClosed("server shut down"))
        self.bucket_cache.shutdown()
        self.session.bucket_cache = self._prev_bucket_cache
        self.session.join_build_cache = self._prev_join_build_cache
        fabric = getattr(self.session, "_fabric", None)
        if fabric is not None:
            fabric.detach_server(self)
        self.session.lifecycle_bus.unsubscribe(self._on_commit_event)
        if self.telemetry is not None:
            self.telemetry.close()
            self.telemetry = None
        if self.history is not None:
            self.history.close()  # flush/close the JSONL workload log
        if self._started:
            from hyperspace_tpu_torch.exec import trace as exec_trace

            exec_trace.server_stopped()

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- submission ----------------------------------------------------------
    def submit(
        self,
        query: Any,
        timeout: Optional[float] = None,
        tenant: str = "default",
        trace_context: Optional[spans.TraceContext] = None,
    ) -> "Future":
        """Admit a query (SQL text or DataFrame) and return a Future yielding
        the collected batch (dict of numpy arrays, like ``collect()``).
        Raises :class:`AdmissionRejected` immediately when the queue is full
        and :class:`ServerClosed` after shutdown. ``tenant`` labels the
        request's SLO accounting and per-tenant completion counters.
        ``trace_context`` (or the ambient :func:`spans.current_context`)
        parents this request's span tree under a routing caller's trace."""
        clock = stages.RequestClock()
        if self._closed or not self._started:
            raise ServerClosed("server is not running (call start() or use as a context manager)")
        enabled = bool(self.session.hyperspace_enabled)
        query_text = query if isinstance(query, str) else type(query).__name__
        ctx = trace_context if trace_context is not None else spans.current_context()
        root = None
        if self.tracing_enabled and (ctx is None or ctx.sampled):
            root = spans.start_trace(
                "request",
                max_spans=self._trace_max_spans,
                server=self.server_name,
                query=query_text,
            )
            if ctx is not None:
                # cross-process parentage: the router's trace id + the span
                # that issued this hop, checkable after stitching
                root.attrs["trace_id"] = ctx.trace_id
                root.attrs["parent_span_id"] = ctx.span_id
        clock.root = root
        with stages.bind(clock), stages.stage(self.session, "parse"):
            plan, fp = self._parse(query)
        # pin the data version at admission: the token, the brand, and every
        # later resolution in the worker read through this snapshot, so a
        # refresh committing mid-flight never changes this request's answer
        snapshot = None
        if self.session.conf.lifecycle_snapshot_enabled:
            with stages.bind(clock), stages.stage(self.session, "admit"):
                snapshot = SnapshotHandle.capture(self.session)
            # seqlock validation of the capture: the handle records the bus
            # sequence BEFORE reading the roster, so a commit landing during
            # the read (a local refresh, or a fabric watcher replaying a
            # remote one) leaves commit_seq ahead of the handle — the pin
            # may hold a torn half-old/half-new roster. Re-capture until the
            # sequence is stable across the whole read (bounded: under a
            # commit storm the freshest capture wins and is still a valid
            # roster at SOME commit point).
            bus = self.session.lifecycle_bus
            for _ in range(3):
                if bus.commit_seq == snapshot.commit_seq:
                    break
                self.registry.counter(
                    "hs_fabric_snapshot_retries_total",
                    "snapshot re-captures after a commit raced the roster read",
                    server=self.server_name,
                ).inc()
                with stages.bind(clock), stages.stage(self.session, "admit"):
                    snapshot = SnapshotHandle.capture(self.session)
        with snapshot_scope(snapshot), stages.bind(clock), stages.stage(self.session, "admit"):
            token = session_token(self.session, enabled)
            cost_class = "unknown"
            if self.history is not None:
                cost_class = classify_cost(
                    self.history.estimate_cost(fp.structure),
                    self._interactive_s, self._heavy_s, self._min_confidence,
                )
            brand = None
            if self.result_cache is not None:
                # submit-time data-version brand: index-log roster + source
                # snapshots; None (unsignable) bypasses the cache entirely
                brand = version_brand(self.session, plan, enabled)
        req = _Request(
            plan, fp, token, enabled, self.admission.deadline_for(timeout),
            root=root, tenant=tenant, query_text=query_text,
            cost_class=cost_class, brand=brand, snapshot=snapshot, clock=clock,
        )
        if brand is not None:
            hit = self.result_cache.get(fp, brand, plan=plan)
            if hit is not None:
                # serve from cache without entering the queue: counts toward
                # serving metrics and the SLO but NOT the profile history —
                # cache hits would corrupt the cost model's latency estimates
                req.future.set_result(hit)
                req.future.request_root = root
                req.future.request_clock = clock
                latency = time.perf_counter() - req.submitted_at
                stages.seal(self.session, clock, None, None)
                self.metrics.observe(latency, tenant=tenant)
                if self.slo is not None:
                    self.slo.record(latency, error=False, tenant=tenant)
                return req.future
        try:
            self.admission.submit(req)  # raises AdmissionRejected on overflow
        except AdmissionRejected:
            from hyperspace_tpu_torch.telemetry.events import ServingRejectionEvent, emit_event

            emit_event(
                self.session,
                ServingRejectionEvent(
                    queue_depth=self.admission.depth, queued=self.admission.queued
                ),
            )
            # a rejection is an SLO bad event and a flight-recorder capture:
            # load shedding must show up in the telemetry it will one day
            # be driven by
            if self.slo is not None:
                self.slo.record(0.0, error=True, tenant=tenant)
            if self.history is not None:
                self.history.record(fp.structure, 0.0, error=True, query=query_text)
            if self.flight is not None:
                self.flight.record(
                    "rejected", 0.0, fingerprint=fp.structure, query=query_text,
                    tenant=tenant, conf_deltas=self.session.conf.deltas(),
                )
            raise
        req.future.request_root = root  # span tree visible to the caller
        req.future.request_clock = clock  # the request's stage clock, sealed with it
        if self.prefetch_enabled:
            self._prefetch_hint(token, fp)
        return req.future

    def query(self, query: Any, timeout: Optional[float] = None, tenant: str = "default") -> Dict[str, Any]:
        """Blocking convenience wrapper around :meth:`submit`."""
        fut = self.submit(query, timeout=timeout, tenant=tenant)
        t = self.admission.default_timeout if timeout is None else timeout
        # Future.result timeout is a backstop; the worker resolves the future
        # with RequestTimeout at the deadline itself
        return fut.result(timeout=None if t is None else t + 5.0)

    def _on_commit_event(self, event) -> None:
        """Bus subscriber (see start): invalidate the SQL-text memo on any
        commit so repeated query text re-resolves against the post-commit
        source listing."""
        with self._sql_memo_lock:
            self._sql_memo.clear()

    def _parse(self, query: Any):
        if isinstance(query, str):
            with self._sql_memo_lock:
                hit = self._sql_memo.get(query)
            if hit is not None:
                return hit
            df = self.session.sql(query)
            plan = df.plan
            fp = plan_fingerprint(plan)
            with self._sql_memo_lock:
                if len(self._sql_memo) >= 1024:  # text memo is a bounded side-table
                    self._sql_memo.clear()
                self._sql_memo[query] = (plan, fp)
            return plan, fp
        plan = getattr(query, "plan", query)
        return plan, plan_fingerprint(plan)

    def _prefetch_hint(self, token, fp: Fingerprint) -> None:
        entry = self.plan_cache_entry(token, fp)
        if entry is None:
            return
        from hyperspace_tpu_torch.plan import logical as L

        for leaf in L.collect(
            entry.template, lambda p: isinstance(p, (L.IndexScan, L.FileScan))
        ):
            if leaf.files:
                cols = (
                    leaf.file_columns
                    if getattr(leaf, "file_columns", None) is not None
                    else list(leaf.columns)
                )
                self.bucket_cache.prefetch(list(leaf.files), list(cols))

    def plan_cache_entry(self, token, fp: Fingerprint) -> Optional[CompiledPlan]:
        """Peek (no hit/miss accounting) at the template a request would use."""
        with self.plan_cache._lock:
            got = self.plan_cache._entries.get(("exact", token, fp.exact))
            if got is None:
                got = self.plan_cache._entries.get(("param", token, fp.structure))
        return got

    # -- worker loop ---------------------------------------------------------
    def _worker(self) -> None:
        while not self._stop.is_set():
            first = self.admission.take(timeout=0.05)
            if first is None:
                continue
            group = [first]
            if self.micro_batch_enabled and self.micro_batch_max > 1:
                waited = 0.0
                while len(group) < self.micro_batch_max:
                    nxt = self.admission.take_nowait()
                    if nxt is None:
                        if waited >= self.micro_batch_wait_s or self.admission.queued == 0:
                            break
                        time.sleep(min(0.001, self.micro_batch_wait_s - waited))
                        waited += 0.001
                        continue
                    group.append(nxt)
            self._process_group(group)

    def _process_group(self, group: List[_Request]) -> None:
        now = time.perf_counter()
        for r in group:
            r.dequeued_at = now
            self.registry.histogram(
                "hs_admission_wait_seconds",
                "seconds a request waited in the admission queue before dispatch",
                tenant=r.tenant, cost_class=r.cost_class, server=self.server_name,
            ).observe(now - r.submitted_at)
        # coalesce by (token, structure); order within a key is preserved
        by_key: Dict[tuple, List[_Request]] = {}
        for r in group:
            by_key.setdefault(r.group_key, []).append(r)
        for reqs in by_key.values():
            self._process_same_key(reqs)

    def _process_same_key(self, reqs: List[_Request]) -> None:
        live = []
        for r in reqs:
            if r.expired():
                self.admission.expire(r)  # exactly-once timeout + seal
            else:
                live.append(r)
        if not live:
            return
        try:
            self._execute_requests(live)
        except Exception as exc:  # defensive: never kill a worker thread
            for r in live:
                self._fail(r, exc)

    def _execute_requests(self, reqs: List[_Request]) -> None:
        from hyperspace_tpu_torch.exec.executor import Executor
        from hyperspace_tpu_torch.reliability.retry import deadline_scope

        resolved = []  # (req, bound_plan, entry or None)
        for r in reqs:
            try:
                with stages.bind(r.clock), stages.stage(self.session, "resolve"):
                    with snapshot_scope(r.snapshot), deadline_scope(r.deadline):
                        resolved.append((r, *self._resolve(r)))
            except Exception as exc:
                self._fail(r, exc)

        # shared-scan micro-batch: >1 request on the same parameterized
        # template whose shape is a filter chain over one scan
        if len(resolved) > 1:
            entry = resolved[0][2]
            if (
                entry is not None
                and entry.parameterizable
                and all(e is entry for _, _, e in resolved)
            ):
                ops_leaf = shared_scan_ops(entry.template)
                if ops_leaf is not None:
                    ops, leaf = ops_leaf
                    t0 = time.perf_counter()
                    # same group key => same session token => same pinned
                    # roster, so the first request's snapshot covers all
                    # retry budget for the whole shared scan: the earliest
                    # deadline in the batch (conservative — a retry that
                    # would expire ANY member gives up instead)
                    group_deadlines = [r.deadline for r, _, _ in resolved if r.deadline is not None]
                    with self.session.hyperspace_scope(resolved[0][0].enabled), \
                            snapshot_scope(resolved[0][0].snapshot), \
                            deadline_scope(min(group_deadlines) if group_deadlines else None), \
                            stages.bind(*(r.clock for r, _, _ in resolved)):
                        batches = execute_shared_scan(
                            self.session, ops, leaf, [b for _, b, _ in resolved]
                        )
                    t1 = time.perf_counter()
                    self.metrics.observe_batch(len(resolved))
                    for (r, _, e), batch in zip(resolved, batches):
                        # the scan ran ONCE for the whole group; each tree
                        # records its share as a pre-timed child
                        if r.root is not None:
                            spans.add_manual(
                                r.root, "execute-shared-scan", "serving", t0, t1,
                                batch_size=len(resolved),
                            )
                        self._finish(r, batch, e)
                    return

        for r, bound, entry in resolved:
            if r.expired():
                self.admission.expire(r)  # exactly-once timeout + seal
                continue
            try:
                with stages.bind(r.clock), spans.span("execute", cat="serving"):
                    with self.session.hyperspace_scope(r.enabled), snapshot_scope(r.snapshot), \
                            deadline_scope(r.deadline):
                        out_cols = list(entry.output_columns) if entry is not None else list(bound.output_columns)
                        batch = Executor(self.session).execute(
                            bound, required_columns=out_cols, prepruned=entry is not None
                        )
                self._finish(r, batch, entry)
            except Exception as exc:
                self._fail(r, exc)

    def _resolve(self, r: _Request):
        """(bound plan, cache entry or None). A None entry means the plan was
        compiled ad hoc (cache disabled) and carries the request's own
        literals and aliases."""
        if not self.plan_cache_enabled:
            return self._compile(r), None
        hit = self.plan_cache.lookup(r.token, r.fp)
        if hit is not None:
            return hit[0], hit[1]
        template = self._compile(r)
        entry = self.plan_cache.insert(r.token, r.fp, template)
        return template, entry

    def _compile(self, r: _Request):
        """Optimize + prune once — the expensive work the cache amortizes."""
        from hyperspace_tpu_torch.rules.apply import optimize_plan
        from hyperspace_tpu_torch.rules.utils import prune_columns

        with self.session.hyperspace_scope(r.enabled):
            plan = optimize_plan(r.plan, self.session, enabled=r.enabled)
        try:
            return prune_columns(plan)
        except Exception:
            return plan

    def _finish(self, r: _Request, batch, entry: Optional[CompiledPlan]) -> None:
        with stages.bind(r.clock), stages.stage(self.session, "finish"):
            self._finish_request(r, batch, entry)

    def _finish_request(self, r: _Request, batch, entry: Optional[CompiledPlan]) -> None:
        if entry is not None and tuple(entry.output_columns) != tuple(r.fp.output_columns):
            # template carries the FIRST request's aliases; relabel
            # positionally to this request's output names
            batch = {
                want: batch[have]
                for want, have in zip(r.fp.output_columns, entry.output_columns)
            }
        else:
            batch = {c: batch[c] for c in r.fp.output_columns}
        if not r.future.done():
            if self.result_cache is not None and r.brand is not None:
                # store under the request's submit-time brand; arrays are
                # frozen by the cache, so the live result is read-only too —
                # a caller mutating served bytes now raises instead of
                # silently corrupting future hits
                self.result_cache.put(r.fp, r.brand, batch, plan=r.plan)
            rows = 0
            if batch:
                rows = int(len(next(iter(batch.values()))))
            # account BEFORE resolving the future: once query() returns, every
            # registry series for this request is already published, so a
            # caller may scrape /metrics immediately and see consistent state
            try:
                self.metrics.observe(time.perf_counter() - r.submitted_at, tenant=r.tenant)
                self._seal(r, rows=rows)
            finally:
                r.future.set_result(batch)

    def _fail(self, r: _Request, exc: BaseException) -> None:
        with stages.bind(r.clock), stages.stage(self.session, "finish"):
            self._fail_request(r, exc)

    def _fail_request(self, r: _Request, exc: BaseException) -> None:
        if not r.future.done():
            try:
                self.metrics.observe(time.perf_counter() - r.submitted_at, error=True, tenant=r.tenant)
                self._seal(r, error=type(exc).__name__)
            finally:
                r.future.set_exception(exc)

    def _seal(self, r: _Request, error: Optional[str] = None, rows: Optional[int] = None) -> None:
        """:meth:`_seal_request`, then stop the request's stage clock: its
        ``request``, ``unattributed`` and ``host_wait`` seconds go to the
        session's ``query_stage_seconds`` before the future resolves."""
        try:
            self._seal_request(r, error=error, rows=rows)
        finally:
            stages.seal(self.session, r.clock, r.submitted_at, r.dequeued_at)

    def _seal_request(self, r: _Request, error: Optional[str] = None, rows: Optional[int] = None) -> None:
        """Completion hook: finish the request's span tree, publish its
        QueryProfile (on the future as ``.profile`` and in the bounded server
        history), fold it into the fingerprint-keyed ProfileHistory, account
        the SLO event, and flight-record slow/errored requests. Runs for
        every sealed request, traced or not — the intelligence layer does not
        require span tracing."""
        latency = time.perf_counter() - r.submitted_at
        if self.sched_enabled and r.dequeued_at is not None:
            # replace the predicted charge taken at dispatch with the actual
            # service seconds so fair-share accounting self-corrects
            self.admission.observe_completion(
                r.tenant, time.perf_counter() - r.dequeued_at, charged_s=r.sched_charge
            )
        profile = None
        if r.root is not None:
            profile = build_profile(
                r.root, query=str(r.root.attrs.get("query", "")), error=error
            )
            r.future.profile = profile
            self._profiles.append(profile)
        if self.history is not None:
            self.history.record(
                r.fp.structure,
                latency,
                rows=rows,
                bytes=(profile.total("bytes") or None) if profile is not None else None,
                error=error is not None,
                query=r.query_text,
            )
        if self.slo is not None:
            self.slo.record(latency, error=error is not None, tenant=r.tenant)
        if self.flight is not None and (
            error is not None or (self._slow_s is not None and latency >= self._slow_s)
        ):
            self.flight.record(
                "error" if error is not None else "slow",
                latency,
                fingerprint=r.fp.structure,
                query=r.query_text,
                tenant=r.tenant,
                profile=profile,
                conf_deltas=self.session.conf.deltas(),
            )

    # -- observability -------------------------------------------------------
    def last_profiles(self) -> List:
        """Most recent per-request ``QueryProfile``s (bounded by
        ``hyperspace.obs.profile.history``), oldest first."""
        return list(self._profiles)

    def last_slow_queries(self) -> List:
        """Flight-recorder entries (slow/errored/rejected requests), oldest
        first; empty when ``hyperspace.obs.slowQueryMs`` is 0."""
        return [] if self.flight is None else self.flight.last_slow_queries()

    def estimate_cost(self, query: Any):
        """Learned cost estimate for a query, SQL text, DataFrame, or
        fingerprint-structure hash: ``CostEstimate(latency_s, confidence,
        samples)`` from the fingerprint history, or None when the history is
        disabled or has never seen the fingerprint."""
        if self.history is None:
            return None
        if isinstance(query, str) and len(query) == 40 and all(
            c in "0123456789abcdef" for c in query
        ):
            return self.history.estimate_cost(query)  # already a structure hash
        _, fp = self._parse(query)
        return self.history.estimate_cost(fp.structure)

    def serve_telemetry(self, port: int = 0, host: str = "127.0.0.1"):
        """Start (or return) the HTTP telemetry endpoint for this server:
        ``/metrics`` (Prometheus 0.0.4), ``/statusz`` (JSON), ``/profilez``
        (fingerprint drill-down). ``port=0`` binds an ephemeral port —
        read ``server.telemetry.port``."""
        if self.telemetry is None:
            from hyperspace_tpu_torch.obs.export import TelemetryEndpoint

            self.telemetry = TelemetryEndpoint(
                self.registry,
                host=host,
                port=port,
                status_fn=self.statusz,
                history=self.history,
                flight=self.flight,
            ).start()
        return self.telemetry

    def statusz(self) -> dict:
        """The ``/statusz`` body: serving stats + cache hit rates + SLO state
        + intelligence-layer summaries, one JSON-able dict."""
        out = {"server": self.server_name, "serving": self.stats()}
        if self.slo is not None:
            out["slo"] = self.slo.state()
        if self.history is not None:
            out["profileHistory"] = {
                "fingerprints": len(self.history),
                "evicted": self.history.evicted,
            }
        if self.flight is not None:
            out["slowQueries"] = self.flight.snapshot()
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition of this server's registry (the process-wide
        one unless metrics were conf'd off)."""
        return self.registry.prometheus_text()

    def stats(self, emit: bool = False) -> dict:
        snap = self.metrics.snapshot(
            admission=self.admission,
            plan_cache=self.plan_cache if self.plan_cache_enabled else None,
            bucket_cache=self.bucket_cache,
        )
        if self.result_cache is not None:
            snap["resultCache"] = self.result_cache.stats()
        if emit:
            from hyperspace_tpu_torch.telemetry.events import ServingStatsEvent, emit_event

            emit_event(
                self.session,
                ServingStatsEvent(
                    queue_depth=snap["queue"]["queued"],
                    rejected=snap["queue"]["rejected"],
                    plan_cache_hit_rate=snap.get("planCache", {}).get("hitRate", 0.0),
                    bucket_cache_hit_rate=snap["bucketCache"]["hitRate"],
                    latency_p50=snap["latencySeconds"]["p50"],
                    latency_p95=snap["latencySeconds"]["p95"],
                    latency_p99=snap["latencySeconds"]["p99"],
                    completed=snap["completed"],
                )
            )
        return snap
