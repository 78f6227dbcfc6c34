"""Reliability subsystem: fault injection, deadline-aware retries, and
index quarantine with fallback-to-source (docs/reliability.md).

Three layers, all default-off behind ``hyperspace.reliability.*``:

- :mod:`hyperspace_tpu_torch.reliability.faults` — seeded deterministic fault
  injection at the lake IO seams (the chaos harness);
- :mod:`hyperspace_tpu_torch.reliability.retry` — decorrelated-jitter backoff for
  transient IO errors, bounded by the serving request's admission deadline;
- :mod:`hyperspace_tpu_torch.reliability.degrade` — a per-index circuit breaker
  that quarantines an index after repeated corrupt reads, re-planning its
  queries against source until a half-open probe reads clean.

The typed error taxonomy (:class:`TransientIOError` /
:class:`CorruptDataError` / :class:`FaultInjected`) classifies every
lake-IO failure path; its classification counters are always-on (a counter
bump per *error*, nothing on the success path).

:func:`configure` applies a session's conf to the process-global registries
(most recent session wins — the same stance as the decode pool and the HLO
verifier) and is called from ``Session.__init__``.
"""

from __future__ import annotations

from hyperspace_tpu_torch.reliability.errors import (
    CorruptDataError,
    FaultInjected,
    ReliabilityError,
    TransientIOError,
    classify,
    count_io_error,
)
from hyperspace_tpu_torch.reliability.faults import FAULTS, FaultRule, fault_scope
from hyperspace_tpu_torch.reliability.retry import (
    RetryPolicy,
    current_deadline,
    deadline_scope,
    with_retry,
)
from hyperspace_tpu_torch.reliability.degrade import QUARANTINE

__all__ = [
    "CorruptDataError",
    "FAULTS",
    "FaultInjected",
    "FaultRule",
    "QUARANTINE",
    "ReliabilityError",
    "RetryPolicy",
    "TransientIOError",
    "classify",
    "configure",
    "count_io_error",
    "current_deadline",
    "deadline_scope",
    "fault_scope",
    "with_retry",
]


def configure(session) -> None:
    """Apply ``hyperspace.reliability.*`` conf to the process-global fault,
    retry, and quarantine registries."""
    from hyperspace_tpu_torch.reliability import degrade as _degrade
    from hyperspace_tpu_torch.reliability import faults as _faults
    from hyperspace_tpu_torch.reliability import retry as _retry

    _faults.configure(session.conf)
    _retry.configure(session.conf)
    _degrade.configure(session)
