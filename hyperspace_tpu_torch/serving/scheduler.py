"""Cost-aware, tenant-fair admission scheduling.

``CostAwareScheduler`` replaces the FIFO ``AdmissionController`` (same
surface — ``submit``/``take``/``take_nowait``/``stats``/``bind_registry`` —
so the worker loop is unchanged) with deficit-weighted fair queueing:

- **per-tenant sub-queues**, each a heap ordered by (predicted-cost class,
  deadline slack, arrival): cheap/interactive queries dispatch ahead of heavy
  scans *within* a tenant's share, and among equally-classed requests the
  tightest deadline goes first;
- **dispatch-time tenant selection**: the tenant with the smallest
  consumed-work / effective-weight ratio dequeues next, so a flooding heavy
  tenant cannot starve a light one — each tenant's share of worker seconds
  converges to its weight. A tenant waking from idle is normalized against
  the busiest floor so it cannot burst unboundedly to "catch up";
- **predicted-work load shedding**: admission sheds when the *confident*
  predicted seconds of queued work exceed ``sched.maxQueuedSeconds``
  (falling back to queue depth when the cost model has no confident answer),
  plus per-tenant **token buckets** bounding any one tenant's admission rate;
- **SLO-burn-driven priority**: a tenant whose own burn rate crossed
  ``burnBoostThreshold`` gets its weight multiplied by ``burnBoostFactor``
  (it needs worker seconds to recover); a tenant hogging the most work while
  *another* tenant burns gets divided by it (it is spending others' budget).

Every completion feeds actual service seconds back through
:meth:`observe_completion` (wired from ``QueryServer._seal``), so consumed
work — and with it the fair-share ordering — self-corrects as the cost
model's predictions meet reality.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Dict, Optional

from hyperspace_tpu_torch.serving.admission import AdmissionController, AdmissionRejected

from hyperspace_tpu_torch.check.locks import named_lock

__all__ = ["CostAwareScheduler", "TokenBucket", "classify_cost", "COST_CLASSES"]

#: dispatch order within a tenant: interactive first, heavy last; "unknown"
#: (no confident estimate) sits between standard and heavy — an unseen shape
#: must neither jump the line nor starve
COST_CLASSES = ("interactive", "standard", "unknown", "heavy")
# derived lookup table, written once at import — process-local by design
_CLASS_RANK = {c: i for i, c in enumerate(COST_CLASSES)}  # hscheck: disable=process-local-state


def classify_cost(
    estimate,
    interactive_s: float,
    heavy_s: float,
    min_confidence: float,
) -> str:
    """Map a ``CostEstimate`` (or None) to a cost class name."""
    if estimate is None or estimate.confidence < min_confidence:
        return "unknown"
    if estimate.latency_s <= interactive_s:
        return "interactive"
    if estimate.latency_s >= heavy_s:
        return "heavy"
    return "standard"


class TokenBucket:
    """Classic token bucket with an injectable clock (deterministic tests)."""

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        # cumulative tokens ever acquired — the ledger the fabric sidecar
        # publishes so peer processes can debit their own buckets
        self.drained_total = 0.0
        self._clock = clock
        self._last = clock()
        self._lock = named_lock("serving.sched.tokenBucket")

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self.tokens = min(self.burst, self.tokens + (now - self._last) * self.rate)
            self._last = now
            if self.tokens >= n:
                self.tokens -= n
                self.drained_total += n
                return True
            return False

    def drain(self, n: float) -> None:
        """Debit tokens acquired *elsewhere* (a fabric peer's admissions)
        without counting them as our own: a per-tenant rate limit then holds
        globally instead of per process. Floors at empty — remote traffic
        can exhaust the bucket but never drive it into debt."""
        with self._lock:
            self.tokens = max(0.0, self.tokens - max(0.0, float(n)))


class _TenantState:
    __slots__ = ("name", "weight", "bucket", "heap", "consumed")

    def __init__(self, name: str, weight: float, bucket: Optional[TokenBucket]):
        self.name = name
        self.weight = max(1e-9, float(weight))
        self.bucket = bucket
        self.heap: list = []  # (class rank, deadline slack, seq, predicted_s, item)
        self.consumed = 0.0  # worker seconds charged to this tenant


class CostAwareScheduler(AdmissionController):
    """Drop-in ``AdmissionController`` with cost classes, weighted fair
    dispatch, predicted-work shedding, token buckets, and burn-rate priority.

    ``cost_fn(item) -> CostEstimate | None`` and
    ``burn_rate_fn(tenant) -> float`` are injected (the server wires them to
    ``ProfileHistory.estimate_cost`` and ``SloTracker.burn_rate``) so the
    scheduler itself is a pure, clock-injectable policy object.
    """

    def __init__(
        self,
        depth: int,
        default_timeout: Optional[float],
        interactive_s: float = 0.05,
        heavy_s: float = 0.5,
        min_confidence: float = 0.3,
        max_queued_seconds: float = 0.0,
        tenant_weights: Optional[Dict[str, float]] = None,
        tenant_rate: float = 0.0,
        tenant_burst: float = 32.0,
        burn_threshold: float = 2.0,
        burn_factor: float = 2.0,
        cost_fn: Optional[Callable] = None,
        burn_rate_fn: Optional[Callable[[str], float]] = None,
        clock=time.monotonic,
    ):
        super().__init__(depth=depth, default_timeout=default_timeout)
        self.interactive_s = float(interactive_s)
        self.heavy_s = float(heavy_s)
        self.min_confidence = float(min_confidence)
        self.max_queued_seconds = float(max_queued_seconds)
        self.tenant_weights = dict(tenant_weights or {})
        self.tenant_rate = float(tenant_rate)
        self.tenant_burst = float(tenant_burst)
        self.burn_threshold = float(burn_threshold)
        self.burn_factor = max(1.0, float(burn_factor))
        self.cost_fn = cost_fn
        self.burn_rate_fn = burn_rate_fn
        self._clock = clock
        self._cv = threading.Condition(threading.RLock())
        self._tenants: Dict[str, _TenantState] = {}
        self._seq = itertools.count()
        self._queued_n = 0
        self._queued_work = 0.0  # confident predicted seconds sitting queued
        self.shed: Dict[str, int] = {}
        self._registry = None
        self._labels: Dict[str, str] = {}

    # -- classification ------------------------------------------------------
    def classify(self, item) -> str:
        est = self.cost_fn(item) if self.cost_fn is not None else None
        return classify_cost(est, self.interactive_s, self.heavy_s, self.min_confidence)

    def _predicted(self, item) -> float:
        """Confident predicted seconds for the item; 0.0 when the model has
        no confident answer (it then contributes nothing to work-based
        shedding, which degrades toward the depth bound)."""
        est = self.cost_fn(item) if self.cost_fn is not None else None
        if est is None or est.confidence < self.min_confidence:
            return 0.0
        return max(0.0, float(est.latency_s))

    # -- submission ----------------------------------------------------------
    def submit(self, item) -> None:
        tenant = getattr(item, "tenant", "default")
        cls = getattr(item, "cost_class", None) or self.classify(item)
        predicted = self._predicted(item)
        with self._cv:
            self._sweep_expired_locked()
            if self._queued_n >= self.depth:
                self._shed("depth", f"serving queue full (depth={self.depth})")
            if (
                self.max_queued_seconds > 0
                and self._queued_work + predicted > self.max_queued_seconds
                and self._queued_n > 0
            ):
                self._shed(
                    "predicted-work",
                    f"predicted queued work {self._queued_work:.2f}s exceeds "
                    f"{self.max_queued_seconds:.2f}s",
                )
            st = self._tenant(tenant)
            if st.bucket is not None and not st.bucket.try_acquire():
                self._shed("rate", f"tenant {tenant!r} admission rate exceeded")
            if not st.heap:
                # waking from idle: never owed an unbounded catch-up burst
                st.consumed = max(st.consumed, self._min_consumed_locked())
            deadline = getattr(item, "deadline", None)
            slack = float("inf") if deadline is None else deadline
            heapq.heappush(
                st.heap, (_CLASS_RANK.get(cls, 2), slack, next(self._seq), predicted, item)
            )
            self._queued_n += 1
            self._queued_work += predicted
            with self._lock:
                self.submitted += 1
            self._cv.notify()

    def _shed(self, reason: str, msg: str) -> None:
        self.shed[reason] = self.shed.get(reason, 0) + 1
        with self._lock:
            self.rejected += 1
        if self._registry is not None:
            self._registry.counter(
                "hs_sched_shed_total",
                "requests shed at admission, by reason (depth, predicted-work, rate)",
                reason=reason,
                **self._labels,
            ).inc()
        raise AdmissionRejected(msg + "; retry later")

    # -- dispatch ------------------------------------------------------------
    def take(self, timeout: float = 0.1):
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                item = self._pop_locked()
                if item is not None:
                    return item
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)

    def take_nowait(self):
        with self._cv:
            return self._pop_locked()

    def _pop_locked(self):
        while True:
            best = None
            best_key = None
            for st in self._tenants.values():
                if not st.heap:
                    continue
                key = (st.consumed / self._effective_weight(st), st.name)
                if best_key is None or key < best_key:
                    best, best_key = st, key
            if best is None:
                return None
            _, _, _, predicted, item = heapq.heappop(best.heap)
            self._queued_n -= 1
            self._queued_work = max(0.0, self._queued_work - predicted)
            check = getattr(item, "expired", None)
            if callable(check) and check():
                self.expire(item)
                continue
            # charge predicted cost at dispatch so fairness reacts
            # immediately; observe_completion corrects it with actual seconds
            best.consumed += predicted
            if hasattr(item, "sched_charge"):
                item.sched_charge = predicted
            return item

    def observe_completion(self, tenant: str, actual_s: float, charged_s: float = 0.0) -> None:
        """Fold a completion's actual service seconds into the tenant's
        consumed work (replacing the predicted charge taken at dispatch)."""
        with self._cv:
            st = self._tenants.get(tenant)
            if st is not None:
                st.consumed = max(0.0, st.consumed + max(0.0, actual_s) - charged_s)

    # -- fabric coherence (hyperspace_tpu_torch/fabric/coherence.py) ---------------
    def drained_tokens(self) -> Dict[str, float]:
        """Cumulative tokens each tenant's bucket has granted locally — the
        sidecar publishes this ledger so peers can :meth:`external_drain`."""
        with self._cv:
            return {
                name: st.bucket.drained_total
                for name, st in self._tenants.items()
                if st.bucket is not None
            }

    def external_drain(self, tenant: str, tokens: float) -> None:
        """Debit a peer process's admissions from the tenant's local bucket
        (no-op for tenants without rate limiting)."""
        with self._cv:
            st = self._tenant(tenant)
        if st.bucket is not None:
            st.bucket.drain(tokens)

    # -- fairness internals --------------------------------------------------
    def _tenant(self, name: str) -> _TenantState:
        st = self._tenants.get(name)
        if st is None:
            bucket = None
            if self.tenant_rate > 0:
                bucket = TokenBucket(self.tenant_rate, self.tenant_burst, clock=self._clock)
            st = _TenantState(name, self.tenant_weights.get(name, 1.0), bucket)
            self._tenants[name] = st
        return st

    def _min_consumed_locked(self) -> float:
        active = [s.consumed for s in self._tenants.values() if s.heap]
        return min(active) if active else 0.0

    def _effective_weight(self, st: _TenantState) -> float:
        w = st.weight
        if self.burn_rate_fn is None:
            return w
        try:
            own = float(self.burn_rate_fn(st.name))
        except Exception:
            return w
        if own >= self.burn_threshold:
            return w * self.burn_factor  # burning its own budget: help it recover
        others_burning = any(
            o is not st and self._other_burn(o) >= self.burn_threshold
            for o in self._tenants.values()
        )
        if others_burning and st.consumed >= max(
            (o.consumed for o in self._tenants.values()), default=0.0
        ):
            return w / self.burn_factor  # hogging work while others burn
        return w

    def _other_burn(self, st: _TenantState) -> float:
        try:
            return float(self.burn_rate_fn(st.name))
        except Exception:
            return 0.0

    # -- expiry --------------------------------------------------------------
    def _sweep_expired_locked(self) -> int:
        dead = []
        for st in self._tenants.values():
            if not st.heap:
                continue
            live = []
            for entry in st.heap:
                item = entry[4]
                check = getattr(item, "expired", None)
                if callable(check) and getattr(item, "future", None) is not None and check():
                    dead.append(item)
                    self._queued_n -= 1
                    self._queued_work = max(0.0, self._queued_work - entry[3])
                else:
                    live.append(entry)
            if dead and len(live) != len(st.heap):
                heapq.heapify(live)
                st.heap = live
        for item in dead:
            self.expire(item)
        return len(dead)

    # -- observability -------------------------------------------------------
    @property
    def queued(self) -> int:
        return self._queued_n

    @property
    def queued_work_seconds(self) -> float:
        return self._queued_work

    def bind_registry(self, registry, **labels) -> None:
        super().bind_registry(registry, **labels)
        self._registry = registry
        self._labels = dict(labels)
        registry.gauge(
            "hs_sched_queued_work_seconds",
            "confident predicted seconds of queued work",
            fn=lambda: self._queued_work, **labels,
        )

    def stats(self) -> dict:
        out = super().stats()
        with self._cv:
            out["shed"] = dict(self.shed)
            out["queuedWorkSeconds"] = round(self._queued_work, 6)
            out["tenants"] = {
                name: {
                    "queued": len(st.heap),
                    "consumedSeconds": round(st.consumed, 6),
                    "weight": st.weight,
                }
                for name, st in self._tenants.items()
            }
        return out
