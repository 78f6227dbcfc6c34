"""Query observability: the span tracer (``obs/spans.py``) and the
process-wide metrics registry (``obs/metrics.py``: labeled counters, gauges
and histograms with Prometheus text and a JSON snapshot), both verbatim
copies of the JAX package's. Query profiles, the profile history, SLO
tracking and the telemetry endpoint wait for ROADMAP A9. Importing this
package loads the standard library only."""

from hyperspace_tpu_torch.obs.metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)

__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry"]
