"""Process-wide metrics registry: counters, gauges, histograms.

One registry instance (module-level :data:`REGISTRY`) is the process-wide
default every subsystem publishes into — the serving runtime's completion/
latency/cache/rejection accounting, telemetry event counts, and anything a
future PR wants attributed. Instruments are *labeled* (Prometheus-style), so
several ``QueryServer``s in one process publish the same metric names under
distinct ``server=...`` labels instead of clobbering each other.

Overhead discipline: an increment is one small per-instrument lock acquire
(~no contention: each instrument has its own lock) — there is no exporter
thread, no background work; exposition (:meth:`MetricsRegistry.prometheus_text`
/ :meth:`MetricsRegistry.snapshot`) does all formatting at read time, so a
process that never exports pays only the counter bumps.

Tests that need isolation construct a private ``MetricsRegistry()``; the
serving classes all accept a ``registry=`` override for exactly that.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from hyperspace_tpu_torch.check.locks import named_lock

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "default_registry",
]

#: seconds-oriented default histogram bounds (query latencies): 100 µs .. 60 s
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    """Monotonic counter."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """Last-write-wins instantaneous value; ``fn`` makes it a read-time
    callback gauge (queue depth, cache bytes) instead of a stored value."""

    __slots__ = ("_lock", "_v", "fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._lock = threading.Lock()
        self._v = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                return float("nan")
        return self._v


class Histogram:
    """Cumulative-bucket histogram + bounded recent-value reservoir.

    Buckets give the Prometheus exposition; the reservoir (most recent
    ``window`` observations) gives *current* percentiles for stats snapshots
    — the same bounded-memory stance ``ServingMetrics`` took before it moved
    here.
    """

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count", "_window")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS, window: int = 4096):
        self._lock = threading.Lock()
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +inf tail
        self._sum = 0.0
        self._count = 0
        self._window = deque(maxlen=int(window))

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = 0
            for b in self.buckets:
                if v <= b:
                    break
                i += 1
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._window.append(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentiles(self, qs: Tuple[float, ...] = (50.0, 95.0, 99.0)) -> Dict[str, Optional[float]]:
        """Percentiles over the recent window (``{"p50": ..., ...}``); None
        values when nothing was observed yet."""
        with self._lock:
            vals = sorted(self._window)
        out: Dict[str, Optional[float]] = {}
        for q in qs:
            key = f"p{q:g}"
            if not vals:
                out[key] = None
                continue
            # nearest-rank on the sorted window (matches np.percentile's
            # 'lower' flavor closely enough for tail reporting)
            idx = min(len(vals) - 1, max(0, int(round((q / 100.0) * (len(vals) - 1)))))
            out[key] = float(vals[idx])
        return out

    def snapshot_buckets(self) -> List[Tuple[str, int]]:
        """Cumulative (le, count) pairs, Prometheus-style, ending at +Inf."""
        with self._lock:
            counts = list(self._counts)
        cum, out = 0, []
        for b, c in zip(self.buckets, counts[:-1]):
            cum += c
            out.append((f"{b:g}", cum))
        out.append(("+Inf", cum + counts[-1]))
        return out


def _escape_label_value(v: str) -> str:
    """Escape a label value per the Prometheus text exposition format 0.0.4:
    backslash, double-quote, and line feed must be escaped (in this order —
    escaping the backslash first keeps the other escapes unambiguous)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP lines escape backslash and line feed (quotes are legal there)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: Tuple[Tuple[str, str], ...], extra: Optional[Tuple[Tuple[str, str], ...]] = None) -> str:
    items = list(labels) + list(extra or ())
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(str(v))}"' for k, v in items)
    return "{" + body + "}"


class MetricsRegistry:
    """Name+labels -> instrument, with get-or-create semantics.

    ``counter``/``gauge``/``histogram`` return the existing instrument when
    the (name, labels) pair is already registered; asking for the same name
    with a different instrument kind raises (one name, one type — the
    Prometheus data model).
    """

    def __init__(self):
        # registry-level lock only: per-instrument value locks stay plain —
        # they are leaf locks on the inc() hot path and never nest
        self._lock = named_lock("obs.metricsRegistry")
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}
        self._kinds: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self._created = time.time()

    # -- instrument factories ------------------------------------------------
    def _get_or_create(self, kind: str, name: str, help_: str, labels: dict, make):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            prev_kind = self._kinds.get(name)
            if prev_kind is not None and prev_kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {prev_kind}, not {kind}"
                )
            got = self._metrics.get(key)
            if got is None:
                got = make()
                self._metrics[key] = got
                self._kinds[name] = kind
                if help_:
                    self._help[name] = help_
            return got

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get_or_create("counter", name, help, labels, Counter)

    def gauge(self, name: str, help: str = "", fn: Optional[Callable[[], float]] = None, **labels) -> Gauge:
        g = self._get_or_create("gauge", name, help, labels, lambda: Gauge(fn))
        if fn is not None and g.fn is not fn:
            g.fn = fn  # re-bind (a restarted server re-registers its source)
        return g

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Optional[Tuple[float, ...]] = None,
        window: int = 4096,
        **labels,
    ) -> Histogram:
        return self._get_or_create(
            "histogram", name, help, labels,
            lambda: Histogram(buckets or DEFAULT_BUCKETS, window=window),
        )

    def remove(self, name: str, **labels) -> None:
        """Drop one instrument (a shut-down server's callback gauge must not
        outlive its data source)."""
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            self._metrics.pop(key, None)

    # -- exposition ----------------------------------------------------------
    def _items(self):
        with self._lock:
            return sorted(self._metrics.items()), dict(self._kinds), dict(self._help)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view: ``{name: {kind, help, series: [{labels, ...}]}}``."""
        items, kinds, helps = self._items()
        out: Dict[str, Any] = {}
        for (name, labels), m in items:
            entry = out.setdefault(
                name, {"kind": kinds.get(name, ""), "help": helps.get(name, ""), "series": []}
            )
            lab = dict(labels)
            if isinstance(m, Counter) or isinstance(m, Gauge):
                entry["series"].append({"labels": lab, "value": m.value})
            else:
                entry["series"].append(
                    {
                        "labels": lab,
                        "count": m.count,
                        "sum": m.sum,
                        "percentiles": m.percentiles(),
                    }
                )
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        items, kinds, helps = self._items()
        by_name: Dict[str, List] = {}
        for (name, labels), m in items:
            by_name.setdefault(name, []).append((labels, m))
        lines: List[str] = []
        for name in sorted(by_name):
            kind = kinds.get(name, "untyped")
            h = helps.get(name, "")
            if h:
                lines.append(f"# HELP {name} {_escape_help(h)}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, m in by_name[name]:
                if isinstance(m, (Counter, Gauge)):
                    v = m.value
                    sv = f"{v:g}" if v == v else "NaN"
                    lines.append(f"{name}{_fmt_labels(labels)} {sv}")
                else:
                    for le, c in m.snapshot_buckets():
                        lines.append(f"{name}_bucket{_fmt_labels(labels, (('le', le),))} {c}")
                    lines.append(f"{name}_sum{_fmt_labels(labels)} {m.sum:g}")
                    lines.append(f"{name}_count{_fmt_labels(labels)} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


#: the process-wide default registry
REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return REGISTRY
