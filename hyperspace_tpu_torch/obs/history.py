"""Fingerprint-keyed query intelligence: profile history + slow-query capture.

Two stores, both bounded, both thread-safe, both fed by completion hooks
(``QueryServer._seal``, ``DataFrame.collect``'s traced path):

- :class:`ProfileHistory` folds every completed query into **streaming
  per-fingerprint statistics** — count, error count, EMA, and P² quantile
  sketches for latency / rows / bytes / compiles. Memory is O(fingerprints
  retained), never O(queries served): a fold updates a handful of floats.
  :meth:`ProfileHistory.estimate_cost` is the learned per-fingerprint cost
  model ROADMAP item 4's SLO-aware scheduler consumes (predicted latency,
  confidence, sample count). Optional JSONL persistence appends one compact
  line per query so a restarted process (or the index advisor's what-if
  replay) can rebuild the history with :func:`load_history`.

- :class:`FlightRecorder` captures *outlier* queries whole: anything slower
  than ``hyperspace.obs.slowQueryMs`` (or ending in error/rejection) keeps
  its full span tree, profile, plan text, dispatch summary, and the conf
  deltas active at capture time, in a bounded in-memory ring mirrored to a
  bounded on-disk ring. Each entry exports its own Chrome trace for Perfetto
  triage.

The P² sketch (Jain & Chlamtac 1985) estimates a quantile online with five
markers — no sample buffer, so a million-query fingerprint costs the same 40
floats as a twenty-query one.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from hyperspace_tpu_torch.check.locks import named_lock

__all__ = [
    "P2Quantile",
    "StreamStat",
    "CostEstimate",
    "ProfileHistory",
    "FlightEntry",
    "FlightRecorder",
    "load_history",
    "merge_history_snapshots",
]


class P2Quantile:
    """Streaming quantile estimate via the P² algorithm (five markers).

    Exact for the first five observations (it sorts them); afterwards the
    marker heights converge to the requested quantile without retaining
    samples. Not locked — callers hold the owning entry's lock.
    """

    __slots__ = ("p", "_n", "_q", "_pos", "_want")

    def __init__(self, p: float):
        self.p = float(p)
        self._n = 0
        self._q: List[float] = []  # marker heights
        self._pos: List[float] = []  # marker positions (1-based)
        self._want: List[float] = []  # desired positions

    def add(self, x: float) -> None:
        x = float(x)
        if self._n < 5:
            self._q.append(x)
            self._n += 1
            if self._n == 5:
                self._q.sort()
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                p = self.p
                self._want = [1.0, 1 + 2 * p, 1 + 4 * p, 3 + 2 * p, 5.0]
            return
        q, pos = self._q, self._pos
        # locate the cell and stretch the extreme markers
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= q[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        self._n += 1
        p = self.p
        self._want = [1.0, 1 + 2 * p * (self._n - 1) / 4.0, 1 + p * (self._n - 1),
                      1 + (1 + p) * (self._n - 1) / 2.0, float(self._n)]
        # adjust interior markers toward their desired positions
        for i in range(1, 4):
            d = self._want[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                d = 1.0 if d > 0 else -1.0
                qp = self._parabolic(i, d)
                if q[i - 1] < qp < q[i + 1]:
                    q[i] = qp
                else:  # parabolic estimate escaped the bracket: linear
                    q[i] = q[i] + d * (q[i + int(d)] - q[i]) / (pos[i + int(d)] - pos[i])
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        q, n = self._q, self._pos
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    @property
    def value(self) -> Optional[float]:
        if self._n == 0:
            return None
        if self._n < 5:
            vals = sorted(self._q)
            idx = min(len(vals) - 1, max(0, int(round(self.p * (len(vals) - 1)))))
            return vals[idx]
        return self._q[2]


class StreamStat:
    """Bounded-memory summary of one metric stream: count, mean, EMA,
    min/max, and P² sketches for the median and tail."""

    __slots__ = ("n", "mean", "ema", "alpha", "min", "max", "_p50", "_p95")

    def __init__(self, alpha: float = 0.2):
        self.n = 0
        self.mean = 0.0
        self.ema: Optional[float] = None
        self.alpha = float(alpha)
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._p50 = P2Quantile(0.5)
        self._p95 = P2Quantile(0.95)

    def add(self, x: float) -> None:
        x = float(x)
        self.n += 1
        self.mean += (x - self.mean) / self.n
        self.ema = x if self.ema is None else self.alpha * x + (1 - self.alpha) * self.ema
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)
        self._p50.add(x)
        self._p95.add(x)

    @property
    def p50(self) -> Optional[float]:
        return self._p50.value

    @property
    def p95(self) -> Optional[float]:
        return self._p95.value

    def to_json(self) -> Dict[str, Any]:
        return {
            "n": self.n,
            "mean": self.mean,
            "ema": self.ema,
            "min": self.min,
            "max": self.max,
            "p50": self.p50,
            "p95": self.p95,
        }


@dataclass
class CostEstimate:
    """``ProfileHistory.estimate_cost`` result: the scheduler contract.

    ``latency_s`` is the predicted wall time for the next query with this
    fingerprint; ``confidence`` in [0, 1] grows with sample count and falls
    with observed dispersion (a fingerprint whose latencies span 100x gets a
    low-confidence median, and a cost-based scheduler should treat it as
    "unknown, assume heavy")."""

    latency_s: float
    confidence: float
    samples: int

    def to_json(self) -> Dict[str, Any]:
        return {"latencySeconds": self.latency_s, "confidence": self.confidence, "samples": self.samples}


class _FingerprintStats:
    __slots__ = ("fingerprint", "query", "first_seen", "last_seen", "count",
                 "errors", "latency", "rows", "bytes", "compiles", "lock")

    def __init__(self, fingerprint: str, alpha: float):
        self.fingerprint = fingerprint
        self.query = ""
        self.first_seen = time.time()
        self.last_seen = self.first_seen
        self.count = 0
        self.errors = 0
        self.latency = StreamStat(alpha)
        self.rows = StreamStat(alpha)
        self.bytes = StreamStat(alpha)
        self.compiles = StreamStat(alpha)
        self.lock = named_lock("obs.profileHistory.entry")

    def to_json(self) -> Dict[str, Any]:
        with self.lock:
            return {
                "fingerprint": self.fingerprint,
                "query": self.query,
                "firstSeen": self.first_seen,
                "lastSeen": self.last_seen,
                "count": self.count,
                "errors": self.errors,
                "latencySeconds": self.latency.to_json(),
                "rows": self.rows.to_json(),
                "bytes": self.bytes.to_json(),
                "compiles": self.compiles.to_json(),
            }


class ProfileHistory:
    """Thread-safe, LRU-bounded map: fingerprint -> streaming statistics.

    ``registry=`` publishes a callback gauge (``hs_profile_history_fingerprints``)
    plus a fold counter; ``persist_path=`` appends one JSON line per recorded
    query (the workload log the index advisor replays).
    """

    def __init__(
        self,
        max_fingerprints: int = 512,
        ema_alpha: float = 0.2,
        persist_path: Optional[str] = None,
        registry=None,
        server: str = "",
    ):
        self._lock = named_lock("obs.profileHistory")
        self._entries: "OrderedDict[str, _FingerprintStats]" = OrderedDict()
        self.max_fingerprints = max(1, int(max_fingerprints))
        self.ema_alpha = float(ema_alpha)
        self.evicted = 0
        self._persist_path = persist_path
        self._persist_lock = named_lock("obs.profileHistory.persist")
        self._persist_f = None
        self._recorded = None
        if persist_path:
            os.makedirs(os.path.dirname(persist_path) or ".", exist_ok=True)
            self._persist_f = open(persist_path, "a", buffering=1)  # line-buffered
        if registry is not None:
            labels = {"server": server} if server else {}
            registry.gauge(
                "hs_profile_history_fingerprints",
                "distinct query fingerprints with streaming statistics",
                fn=lambda: len(self._entries),
                **labels,
            )
            self._recorded = registry.counter(
                "hs_profile_history_folds_total",
                "completed queries folded into the profile history",
                **labels,
            )

    def __len__(self) -> int:
        return len(self._entries)

    def _entry(self, fingerprint: str) -> _FingerprintStats:
        with self._lock:
            e = self._entries.get(fingerprint)
            if e is None:
                e = _FingerprintStats(fingerprint, self.ema_alpha)
                self._entries[fingerprint] = e
                while len(self._entries) > self.max_fingerprints:
                    self._entries.popitem(last=False)
                    self.evicted += 1
            else:
                self._entries.move_to_end(fingerprint)
            return e

    def record(
        self,
        fingerprint: str,
        latency_s: float,
        rows: Optional[int] = None,
        bytes: Optional[int] = None,
        compiles: Optional[int] = None,
        error: bool = False,
        query: str = "",
    ) -> None:
        """Fold one completed query. O(1); errors contribute to the error
        count but NOT the latency sketch (a fast failure must not teach the
        cost model that the fingerprint is cheap)."""
        e = self._entry(fingerprint)
        with e.lock:
            e.count += 1
            e.last_seen = time.time()
            if query and not e.query:
                e.query = query[:200]
            if error:
                e.errors += 1
            else:
                e.latency.add(latency_s)
                if rows is not None:
                    e.rows.add(rows)
                if bytes is not None:
                    e.bytes.add(bytes)
                if compiles is not None:
                    e.compiles.add(compiles)
        if self._recorded is not None:
            self._recorded.inc()
        if self._persist_f is not None:
            line = json.dumps(
                {
                    "ts": round(time.time(), 3),
                    "fp": fingerprint,
                    "latencySeconds": round(float(latency_s), 6),
                    "rows": rows,
                    "bytes": bytes,
                    "compiles": compiles,
                    "error": bool(error),
                    **({"query": query[:200]} if query and e.count == 1 else {}),
                }
            )
            with self._persist_lock:
                if self._persist_f is not None:
                    self._persist_f.write(line + "\n")

    def record_profile(self, fingerprint: str, profile, latency_s: Optional[float] = None) -> None:
        """Fold a finished :class:`~hyperspace_tpu_torch.obs.profile.QueryProfile`."""
        self.record(
            fingerprint,
            profile.duration_s if latency_s is None else latency_s,
            rows=profile.total("rows") or None,
            bytes=profile.total("bytes") or None,
            error=bool(profile.error),
            query=profile.query,
        )

    # -- the cost model ------------------------------------------------------
    def estimate_cost(self, fingerprint: str) -> Optional[CostEstimate]:
        """Predicted latency for the next query with this fingerprint.

        Prediction blends the P² median (stable under outliers) with the EMA
        (tracks drift: a fingerprint whose data doubled gets costlier);
        confidence = saturation(n/20) shrunk by relative dispersion
        (p95/p50). Returns None for an unseen fingerprint — "unknown" is the
        honest answer, not 0.0s.
        """
        with self._lock:
            e = self._entries.get(fingerprint)
        if e is None:
            return None
        with e.lock:
            n = e.latency.n
            if n == 0:
                return CostEstimate(0.0, 0.0, 0)
            p50 = e.latency.p50 or 0.0
            ema = e.latency.ema if e.latency.ema is not None else p50
            p95 = e.latency.p95 or p50
        predicted = 0.5 * p50 + 0.5 * ema
        saturation = min(1.0, n / 20.0)
        spread = (p95 / p50) if p50 > 0 else 1.0
        confidence = saturation / max(1.0, spread ** 0.5)
        return CostEstimate(predicted, min(1.0, confidence), n)

    # -- views ---------------------------------------------------------------
    def fingerprints(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def get(self, fingerprint: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            e = self._entries.get(fingerprint)
        return None if e is None else e.to_json()

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able overview, most-recently-used last (the /profilez body)."""
        with self._lock:
            entries = list(self._entries.values())
        out = []
        for e in entries:
            j = e.to_json()
            est = self.estimate_cost(e.fingerprint)
            j["estimate"] = est.to_json() if est else None
            out.append(j)
        return {"fingerprints": len(out), "evicted": self.evicted, "entries": out}

    def close(self) -> None:
        with self._persist_lock:
            if self._persist_f is not None:
                try:
                    self._persist_f.close()
                finally:
                    self._persist_f = None


def load_history(path: str, **kwargs) -> ProfileHistory:
    """Rebuild a :class:`ProfileHistory` from a persisted JSONL workload log.
    Unparseable lines are skipped (a crash mid-write leaves at most one)."""
    h = ProfileHistory(**kwargs)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                h.record(
                    rec["fp"],
                    float(rec.get("latencySeconds", 0.0)),
                    rows=rec.get("rows"),
                    bytes=rec.get("bytes"),
                    compiles=rec.get("compiles"),
                    error=bool(rec.get("error")),
                    query=rec.get("query", ""),
                )
            except (ValueError, KeyError, TypeError):
                continue
    return h


# --------------------------------------------------------------------------
# Federation: approximate cross-process snapshot merging
# --------------------------------------------------------------------------

#: the StreamStat streams a snapshot entry carries, in to_json key form
_STREAM_KEYS = ("latencySeconds", "rows", "bytes", "compiles")


def _merge_stream(acc: Optional[Dict[str, Any]], add: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Combine two ``StreamStat.to_json`` dicts.

    Exact for ``n``/``min``/``max``; ``mean`` is the exact n-weighted
    combination. ``ema``/``p50``/``p95`` CANNOT be merged exactly from
    summaries (the samples are gone), so they combine as n-weighted
    averages of the per-node values — see ``merge_history_snapshots`` for
    the error model.
    """
    if not acc:
        return dict(add) if add else None
    if not add:
        return acc
    na, nb = int(acc.get("n", 0) or 0), int(add.get("n", 0) or 0)
    n = na + nb
    out: Dict[str, Any] = {"n": n}

    def _pick(key: str, fn):
        va, vb = acc.get(key), add.get(key)
        if va is None:
            return vb
        if vb is None:
            return va
        return fn(va, vb)

    def _weighted(va: float, vb: float) -> float:
        if n == 0:
            return 0.0
        return (float(va) * na + float(vb) * nb) / n

    out["mean"] = _pick("mean", _weighted)
    out["ema"] = _pick("ema", _weighted)
    out["min"] = _pick("min", min)
    out["max"] = _pick("max", max)
    out["p50"] = _pick("p50", _weighted)
    out["p95"] = _pick("p95", _weighted)
    return out


def merge_history_snapshots(snapshots: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge several ``ProfileHistory.snapshot()`` bodies into one fleet
    view keyed by fingerprint — the FrontDoor's federated ``/profilez``.

    Error model (documented contract, tested): counts, error counts,
    first/last-seen, min/max are EXACT sums/extrema. Means are exact
    n-weighted combinations. Quantiles (p50/p95) and EMAs are
    **approximate**: each node contributes a P² estimate (itself an
    approximation that converges with samples), and the merge n-weights
    those point estimates. The combined quantile is exact when every node
    saw the same latency distribution; otherwise it lies within
    ``[min(node quantiles), max(node quantiles)]`` — the error is bounded
    by the cross-node spread, NOT by the true distribution's tails. Skewed
    fleets (one slow node) therefore show a merged p95 *below* the true
    fleet p95; per-worker drill-down (``/profilez`` on the worker) stays
    the exact source. Derived estimates are recomputed from the merged
    stats with the same blend ``estimate_cost`` uses.
    """
    by_fp: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
    evicted = 0
    for snap in snapshots:
        if not snap:
            continue
        evicted += int(snap.get("evicted", 0) or 0)
        for entry in snap.get("entries") or []:
            fp = entry.get("fingerprint")
            if not fp:
                continue
            cur = by_fp.get(fp)
            if cur is None:
                cur = {
                    "fingerprint": fp,
                    "query": entry.get("query", ""),
                    "firstSeen": entry.get("firstSeen"),
                    "lastSeen": entry.get("lastSeen"),
                    "count": 0,
                    "errors": 0,
                }
                for key in _STREAM_KEYS:
                    cur[key] = None
                by_fp[fp] = cur
            if not cur["query"] and entry.get("query"):
                cur["query"] = entry["query"]
            fs, ls = entry.get("firstSeen"), entry.get("lastSeen")
            if fs is not None and (cur["firstSeen"] is None or fs < cur["firstSeen"]):
                cur["firstSeen"] = fs
            if ls is not None and (cur["lastSeen"] is None or ls > cur["lastSeen"]):
                cur["lastSeen"] = ls
            cur["count"] += int(entry.get("count", 0) or 0)
            cur["errors"] += int(entry.get("errors", 0) or 0)
            for key in _STREAM_KEYS:
                cur[key] = _merge_stream(cur[key], entry.get(key))
    entries = []
    for cur in by_fp.values():
        lat = cur.get("latencySeconds") or {}
        n = int(lat.get("n", 0) or 0)
        estimate = None
        if n > 0:
            p50 = float(lat.get("p50") or 0.0)
            ema = float(lat.get("ema") if lat.get("ema") is not None else p50)
            p95 = float(lat.get("p95") or p50)
            predicted = 0.5 * p50 + 0.5 * ema
            saturation = min(1.0, n / 20.0)
            spread = (p95 / p50) if p50 > 0 else 1.0
            estimate = {
                "latencySeconds": predicted,
                "confidence": min(1.0, saturation / max(1.0, spread ** 0.5)),
                "samples": n,
            }
        cur["estimate"] = estimate
        entries.append(cur)
    return {
        "fingerprints": len(entries),
        "evicted": evicted,
        "entries": entries,
        "federated": True,
    }


# --------------------------------------------------------------------------
# Slow-query flight recorder
# --------------------------------------------------------------------------


class FlightEntry:
    """One captured outlier query: profile + plan facts + environment."""

    __slots__ = ("ts", "reason", "latency_s", "fingerprint", "query", "tenant",
                 "profile", "plan_summary", "dispatch", "conf_deltas", "route",
                 "path")

    def __init__(self, reason: str, latency_s: float, fingerprint: str = "",
                 query: str = "", tenant: str = "", profile=None,
                 plan_summary: str = "", dispatch: str = "",
                 conf_deltas: Optional[Dict[str, Any]] = None,
                 route: Optional[Dict[str, Any]] = None):
        self.ts = time.time()
        self.reason = reason  # "slow" | "error" | "rejected"
        self.latency_s = float(latency_s)
        self.fingerprint = fingerprint
        self.query = query
        self.tenant = tenant
        self.profile = profile
        self.plan_summary = plan_summary
        self.dispatch = dispatch
        self.conf_deltas = dict(conf_deltas or {})
        # routed-request outcome (FrontDoor captures): failover retries,
        # whether a hedge fired, and the worker that answered
        self.route = dict(route) if route else None
        self.path: Optional[str] = None  # on-disk mirror, when enabled

    def chrome_trace(self) -> Optional[Dict[str, Any]]:
        return None if self.profile is None else self.profile.chrome_trace()

    def save_chrome_trace(self, path: str) -> Optional[str]:
        ct = self.chrome_trace()
        if ct is None:
            return None
        with open(path, "w") as f:
            json.dump(ct, f)
        return path

    def to_json(self) -> Dict[str, Any]:
        return {
            "ts": self.ts,
            "reason": self.reason,
            "latencySeconds": self.latency_s,
            "fingerprint": self.fingerprint,
            "query": self.query[:500],
            "tenant": self.tenant,
            "planSummary": self.plan_summary,
            "dispatch": self.dispatch,
            "confDeltas": {k: str(v) for k, v in self.conf_deltas.items()},
            "route": self.route,
            "profile": None if self.profile is None else self.profile.to_json(),
        }

    def __repr__(self) -> str:
        return f"FlightEntry({self.reason}, {self.latency_s * 1e3:.1f} ms, fp={self.fingerprint[:12]})"


class FlightRecorder:
    """Bounded ring of captured outlier queries, optionally mirrored to disk.

    The in-memory ring keeps live :class:`FlightEntry` objects (span trees
    included — triage without re-running). The on-disk ring, when a
    directory is configured, writes one self-contained JSON per entry
    (summary + full Chrome trace) and deletes the oldest beyond
    ``max_entries`` — a crashed process leaves its last outliers behind for
    the post-mortem.
    """

    def __init__(self, max_entries: int = 32, directory: Optional[str] = None,
                 registry=None, server: str = ""):
        self.max_entries = max(1, int(max_entries))
        self.directory = directory
        self._lock = named_lock("obs.flightRecorder")
        self._ring: "deque[FlightEntry]" = deque(maxlen=self.max_entries)
        self._seq = 0
        self._counter = None
        self._labels = {"server": server} if server else {}
        self._registry = registry
        if directory:
            os.makedirs(directory, exist_ok=True)

    def record(self, reason: str, latency_s: float, fingerprint: str = "",
               query: str = "", tenant: str = "", profile=None,
               conf_deltas: Optional[Dict[str, Any]] = None,
               route: Optional[Dict[str, Any]] = None) -> FlightEntry:
        plan_summary = ""
        dispatch = ""
        if profile is not None:
            plan_summary = profile.plan_summary
            from hyperspace_tpu_torch.exec import trace as exec_trace

            dispatch = exec_trace.summarize_span_events(profile.root)
        entry = FlightEntry(
            reason, latency_s, fingerprint=fingerprint, query=query,
            tenant=tenant, profile=profile, plan_summary=plan_summary,
            dispatch=dispatch, conf_deltas=conf_deltas, route=route,
        )
        if self._registry is not None:
            self._registry.counter(
                "hs_slow_queries_total",
                "queries captured by the flight recorder, by reason",
                reason=reason, **self._labels,
            ).inc()
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._ring.append(entry)
        if self.directory:
            self._write_disk(entry, seq)
        return entry

    def _write_disk(self, entry: FlightEntry, seq: int) -> None:
        try:
            body = entry.to_json()
            ct = entry.chrome_trace()
            if ct is not None:
                body["chromeTrace"] = ct
            path = os.path.join(self.directory, f"slow-{seq:08d}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(body, f)
            os.replace(tmp, path)
            entry.path = path
            # prune the on-disk ring beyond max_entries
            names = sorted(
                n for n in os.listdir(self.directory)
                if n.startswith("slow-") and n.endswith(".json")
            )
            for n in names[: max(0, len(names) - self.max_entries)]:
                try:
                    os.remove(os.path.join(self.directory, n))
                except OSError:
                    pass
        except OSError:
            pass  # disk mirror is best-effort; the in-memory ring is primary

    def last_slow_queries(self) -> List[FlightEntry]:
        """Captured entries, oldest first."""
        with self._lock:
            return list(self._ring)

    def snapshot(self) -> List[Dict[str, Any]]:
        return [e.to_json() for e in self.last_slow_queries()]
