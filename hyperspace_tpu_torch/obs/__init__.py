"""Query observability: spans, metrics, profiles.

Verbatim copies of the JAX package's modules:

- :mod:`hyperspace_tpu_torch.obs.spans`: context-propagated hierarchical
  span traces per query, with Chrome trace-event export;
- :mod:`hyperspace_tpu_torch.obs.metrics`: the process-wide labeled metrics
  registry with Prometheus text and a JSON snapshot;
- :mod:`hyperspace_tpu_torch.obs.profile`: the per-query ``QueryProfile``;
- :mod:`hyperspace_tpu_torch.obs.history`: fingerprint-keyed profile
  statistics with cost estimates (``ProfileHistory``) and the slow-query
  flight recorder (``FlightRecorder``);
- :mod:`hyperspace_tpu_torch.obs.slo`: per-tenant latency-SLO accounting.

The HTTP telemetry endpoint (the JAX package's ``obs/export.py``) is not in
the port yet (ROADMAP A9). Importing this package loads the standard library
only.
"""

from hyperspace_tpu_torch.obs.metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
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
