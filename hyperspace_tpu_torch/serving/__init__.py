"""Query-serving runtime: concurrent request admission, compiled-plan
caching, micro-batched execution, and hot-bucket prefetch over one Session.

Entry point::

    from hyperspace_tpu_torch.serving import QueryServer

    with QueryServer(session) as server:
        fut = server.submit("SELECT name FROM t WHERE price > 5")
        rows = fut.result()
        print(server.stats())

See docs/serving.md for the architecture and ``hyperspace.serving.*``
configuration keys.
"""

from hyperspace_tpu_torch.serving.admission import (
    AdmissionController,
    AdmissionRejected,
    RequestTimeout,
    ServerClosed,
)
from hyperspace_tpu_torch.serving.bucket_cache import BucketCache
from hyperspace_tpu_torch.serving.fingerprint import (
    Fingerprint,
    Unparameterizable,
    bind_literals,
    canonical_form,
    plan_fingerprint,
)
from hyperspace_tpu_torch.serving.metrics import ServingMetrics
from hyperspace_tpu_torch.serving.plan_cache import CompiledPlan, PlanCache, session_token
from hyperspace_tpu_torch.serving.result_cache import ResultCache, version_brand
from hyperspace_tpu_torch.serving.scheduler import (
    COST_CLASSES,
    CostAwareScheduler,
    TokenBucket,
    classify_cost,
)
from hyperspace_tpu_torch.serving.server import QueryServer

__all__ = [
    "QueryServer",
    "AdmissionController",
    "AdmissionRejected",
    "RequestTimeout",
    "ServerClosed",
    "BucketCache",
    "PlanCache",
    "CompiledPlan",
    "ServingMetrics",
    "Fingerprint",
    "plan_fingerprint",
    "canonical_form",
    "bind_literals",
    "Unparameterizable",
    "session_token",
    "CostAwareScheduler",
    "TokenBucket",
    "classify_cost",
    "COST_CLASSES",
    "ResultCache",
    "version_brand",
]
