"""Unified query observability: spans, metrics, profiles.

Three layers on one substrate (see docs/observability.md):

- :mod:`hyperspace_tpu_torch.obs.spans` — context-propagated hierarchical span
  traces per query, with Chrome trace-event export (Perfetto);
- :mod:`hyperspace_tpu_torch.obs.metrics` — a process-wide, labeled metrics
  registry (counters/gauges/histograms) with Prometheus text exposition;
- :mod:`hyperspace_tpu_torch.obs.profile` — the per-query ``QueryProfile``
  joining span timings with plan facts (indexes applied, rows/bytes,
  why-not reasons);
- :mod:`hyperspace_tpu_torch.obs.history` — fingerprint-keyed streaming profile
  statistics + cost estimates (``ProfileHistory``) and the slow-query
  flight recorder (``FlightRecorder``);
- :mod:`hyperspace_tpu_torch.obs.slo` — per-tenant latency-SLO accounting with
  multi-window burn-rate gauges;
- :mod:`hyperspace_tpu_torch.obs.export` — the stdlib HTTP telemetry endpoint
  (``/metrics``, ``/statusz``, ``/profilez``).

Import of this package is stdlib-only: no jax, no numpy (the library's
import-side-effect contract, tests/test_import_side_effects.py).
"""

from hyperspace_tpu_torch.obs.metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from hyperspace_tpu_torch.obs.export import TelemetryEndpoint
from hyperspace_tpu_torch.obs.history import (
    CostEstimate,
    FlightEntry,
    FlightRecorder,
    ProfileHistory,
    load_history,
    merge_history_snapshots,
)
from hyperspace_tpu_torch.obs.profile import QueryProfile, build_profile
from hyperspace_tpu_torch.obs.slo import SloTracker
from hyperspace_tpu_torch.obs.spans import (
    NULL_SPAN,
    Span,
    Trace,
    TraceContext,
    add_manual,
    attach,
    bind_context,
    current_context,
    current_span,
    from_wire,
    graft_remote,
    parse_traceparent,
    span,
    start_trace,
    to_chrome_trace,
    to_wire,
    trace,
    wrap,
)

__all__ = [
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "QueryProfile",
    "build_profile",
    "CostEstimate",
    "FlightEntry",
    "FlightRecorder",
    "ProfileHistory",
    "load_history",
    "merge_history_snapshots",
    "SloTracker",
    "TelemetryEndpoint",
    "NULL_SPAN",
    "Span",
    "Trace",
    "TraceContext",
    "add_manual",
    "attach",
    "bind_context",
    "current_context",
    "current_span",
    "from_wire",
    "graft_remote",
    "parse_traceparent",
    "span",
    "start_trace",
    "to_chrome_trace",
    "to_wire",
    "trace",
    "wrap",
]
