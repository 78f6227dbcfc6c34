"""Deadline-aware retry with decorrelated-jitter backoff.

Policy shape (the AWS architecture-blog "decorrelated jitter" variant):
``sleep_k = min(cap, uniform(base, 3 * sleep_{k-1}))`` — retries spread out
instead of thundering in lockstep, and the cap bounds tail latency. Clock,
sleep, and RNG are injectable so tests run the full policy in zero wall
time and byte-deterministically.

Deadline discipline: a serving worker enters :func:`deadline_scope` with the
request's admission deadline (``serving/server.py`` tracks it from submit).
:meth:`RetryPolicy.call` never sleeps past :func:`current_deadline` — a
retry that cannot complete in budget gives up immediately with the original
typed error (``hs_io_giveups_total{op,reason="deadline"}``), and the request
sheds through the server's existing timeout/shed accounting rather than
burning worker seconds on a doomed read.

Only :class:`TransientIOError` retries. :class:`CorruptDataError` re-reads
the same wrong bytes — it fails fast into degrade.py's quarantine path.

Default-off: ``hyperspace.reliability.retry.enabled`` gates whether
Session-configured call sites wrap reads at all; the disabled path never
constructs a policy.
"""

from __future__ import annotations

import contextvars
import random
import time
from typing import Callable, Optional, TypeVar

from hyperspace_tpu_torch.reliability.errors import (  # noqa: F401  (re-exported: the taxonomy lives with retry)
    CorruptDataError,
    FaultInjected,
    ReliabilityError,
    TransientIOError,
    classify,
)

T = TypeVar("T")

#: the active request's absolute monotonic deadline (None = no deadline)
_DEADLINE: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "hs_reliability_deadline", default=None
)


class deadline_scope:
    """Pin the current request's monotonic deadline for this thread/context.
    Serving workers enter it around plan resolution + execution; nested
    scopes restore the outer deadline on exit."""

    def __init__(self, deadline: Optional[float]):
        self._deadline = deadline

    def __enter__(self):
        self._token = _DEADLINE.set(self._deadline)
        return self

    def __exit__(self, *exc) -> None:
        _DEADLINE.reset(self._token)


def current_deadline() -> Optional[float]:
    return _DEADLINE.get()


def _retry_counter(op: str, reason: str):
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    return REGISTRY.counter(
        "hs_io_retries_total",
        "transient lake-IO failures retried by the reliability retry policy",
        op=op,
        reason=reason,
    )


def _giveup_counter(op: str, reason: str):
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    return REGISTRY.counter(
        "hs_io_giveups_total",
        "retry sequences abandoned (attempts exhausted, or the request "
        "deadline left no budget for another attempt)",
        op=op,
        reason=reason,
    )


class RetryPolicy:
    """Decorrelated-jitter exponential backoff over a callable.

    ``clock``/``sleep``/``rng`` default to the real ones; tests inject a
    fake clock and a seeded RNG for wall-time-free determinism.
    """

    def __init__(
        self,
        max_attempts: int = 4,
        base_s: float = 0.005,
        cap_s: float = 0.1,
        *,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
    ):
        self.max_attempts = max(1, int(max_attempts))
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self._clock = clock
        self._sleep = sleep
        self._rng = rng or random.Random()

    def call(self, fn: Callable[[], T], *, op: str) -> T:
        """Run ``fn``, retrying transient failures within the deadline.
        Corrupt-data errors and non-IO exceptions propagate immediately."""
        prev_sleep = self.base_s
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except CorruptDataError:
                raise
            except FileNotFoundError:
                raise  # ENOENT is deterministic: re-reading cannot help
            except OSError as exc:
                # includes TransientIOError (subclass) and raw transients
                if attempt >= self.max_attempts:
                    _giveup_counter(op, "attempts").inc()
                    raise
                delay = min(self.cap_s, self._rng.uniform(self.base_s, prev_sleep * 3))
                prev_sleep = max(delay, self.base_s)
                deadline = current_deadline()
                if deadline is not None and self._clock() + delay > deadline:
                    _giveup_counter(op, "deadline").inc()
                    raise
                reason = "injected" if isinstance(exc, FaultInjected) else "oserror"
                _retry_counter(op, reason).inc()
                self._sleep(delay)


#: process-global policy serving/session call sites use when retry is
#: enabled; None while disabled (the default) so the gated path costs one
#: "is None" check.
_POLICY: Optional[RetryPolicy] = None


def configure(conf) -> None:
    """Build (or drop) the process-global policy from a session's
    ``hyperspace.reliability.retry.*`` conf. Most recent session wins."""
    global _POLICY
    if not conf.reliability_retry_enabled:
        _POLICY = None
        return
    _POLICY = RetryPolicy(
        max_attempts=conf.reliability_retry_max_attempts,
        base_s=conf.reliability_retry_base_ms / 1000.0,
        cap_s=conf.reliability_retry_cap_ms / 1000.0,
    )


def active_policy() -> Optional[RetryPolicy]:
    return _POLICY


def with_retry(fn: Callable[[], T], *, op: str) -> T:
    """Run ``fn`` under the configured policy, or directly when retry is
    off — the one-liner IO seams call."""
    policy = _POLICY
    if policy is None:
        return fn()
    return policy.call(fn, op=op)
