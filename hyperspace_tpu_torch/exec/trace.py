"""Execution-dispatch trace: which physical path each operator actually took.

The reference approves a *simplified executedPlan* tree per query
(ref: goldstandard/PlanStabilitySuite.scala:83-290); this framework decides
its physical dispatch at run time (device vs host by row-count gates,
``DeviceUnsupported`` fallbacks), so the equivalent pin is a recorded trace:
decision points call :func:`record`, and tests compare the counted summary.

Recording is off by default (one ``is None`` check per event) and
process-global, NOT thread-local: the parquet decode pool's worker threads
must land their events in the caller's recording. One recording at a time;
list.append is atomic under the GIL. Enable with::

    with trace.recording() as events:
        q.collect()
    print(trace.summarize(events))
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Iterator, List, Optional

_events: Optional[List] = None

#: device-path fallbacks to the host, by (operator, reason), since the
#: process started (the JAX package counts these in its metrics registry)
fallbacks: Counter = Counter()


def record(kind: str, detail: str) -> None:
    """Append a dispatch event (e.g. ``record("filter", "device")``) to the
    active recorder, if any."""
    events = _events
    if events is not None:
        events.append((kind, detail))


def fallback(op: str, reason: str) -> None:
    """Count a device-path fallback: a recording names every fallback, and
    this counter shows them without one."""
    fallbacks[(op, reason)] += 1


@contextlib.contextmanager
def recording() -> Iterator[List]:
    """Collect dispatch events for the duration of the block."""
    global _events
    prev = _events
    _events = []
    try:
        yield _events
    finally:
        _events = prev


def summarize(events: List) -> str:
    """Stable text form: one ``kind: detail xN`` line per distinct event,
    sorted."""
    counts = Counter(events)
    lines = [f"{kind}: {detail} x{n}" for (kind, detail), n in sorted(counts.items())]
    return "\n".join(lines) if lines else "(no dispatch events)"
