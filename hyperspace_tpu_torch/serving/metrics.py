"""Serving metrics, backed by the process-wide observability registry.

``ServingMetrics`` keeps its original surface (``observe`` /
``observe_batch`` / ``latency_percentiles`` / ``snapshot`` with the same key
schema) but stores everything in :mod:`hyperspace_tpu_torch.obs.metrics`
instruments: completion/error/batch counters and one latency histogram,
labeled per server. ``snapshot`` therefore *reads the registry* — its fields
and a Prometheus scrape of the same process cannot disagree, because they are
the same store (tests/test_obs_serving.py pins this).

A ``registry=None`` default gives each instance a private registry, so
constructing a bare ``ServingMetrics`` (tests, tools) never pollutes the
global one; ``QueryServer`` passes the global registry plus its server label.
"""

from __future__ import annotations

from typing import Dict, Optional

from hyperspace_tpu_torch.obs.metrics import MetricsRegistry


class ServingMetrics:
    def __init__(
        self,
        latency_window: int = 4096,
        registry: Optional[MetricsRegistry] = None,
        server: str = "",
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        labels = {"server": server} if server else {}
        self._completed = self.registry.counter(
            "hs_serving_completed_total", "requests completed", **labels
        )
        self._errors = self.registry.counter(
            "hs_serving_errors_total", "requests failed", **labels
        )
        self._batches = self.registry.counter(
            "hs_serving_batches_total", "shared-scan micro-batches executed", **labels
        )
        self._batched = self.registry.counter(
            "hs_serving_batched_requests_total", "requests served via micro-batches", **labels
        )
        self._latency = self.registry.histogram(
            "hs_serving_latency_seconds",
            "submit-to-result latency",
            window=int(latency_window),
            **labels,
        )
        self._labels = labels

    # original counter surface, preserved for existing callers/tests
    @property
    def completed(self) -> int:
        return int(self._completed.value)

    @property
    def errors(self) -> int:
        return int(self._errors.value)

    @property
    def batches(self) -> int:
        return int(self._batches.value)

    @property
    def batched_requests(self) -> int:
        return int(self._batched.value)

    def observe(self, latency_s: float, error: bool = False, tenant: Optional[str] = None) -> None:
        self._latency.observe(float(latency_s))
        (self._errors if error else self._completed).inc()
        if tenant:
            # per-tenant attribution rides separate label series so the
            # unlabeled totals above stay cheap and cardinality-stable
            self.registry.counter(
                "hs_serving_tenant_requests_total",
                "requests completed, by tenant and outcome",
                tenant=tenant,
                outcome="error" if error else "ok",
                **self._labels,
            ).inc()

    def observe_batch(self, n_requests: int) -> None:
        self._batches.inc()
        self._batched.inc(int(n_requests))

    def latency_percentiles(self) -> Dict[str, Optional[float]]:
        return self._latency.percentiles()

    def snapshot(self, admission=None, plan_cache=None, bucket_cache=None) -> dict:
        out = {
            "completed": self.completed,
            "errors": self.errors,
            "batches": self.batches,
            "batchedRequests": self.batched_requests,
        }
        out["latencySeconds"] = self.latency_percentiles()
        if admission is not None:
            out["queue"] = admission.stats()
        if plan_cache is not None:
            out["planCache"] = plan_cache.stats()
        if bucket_cache is not None:
            out["bucketCache"] = bucket_cache.stats()
        return out
