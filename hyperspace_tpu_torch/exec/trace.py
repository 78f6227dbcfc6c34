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

Under a running ``QueryServer`` a process-global recording would interleave
unrelated requests, so :func:`recording` refuses; every event also lands on
the context's current obs span, and :func:`summarize_span_events` reads a
request's dispatch trace from its span tree.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Iterator, List, Optional

from hyperspace_tpu_torch.obs import spans as _spans

_events: Optional[List] = None

#: device-path fallbacks to the host, by (operator, reason), since the
#: process started; the metrics registry counts the same events as
#: ``hs_device_fallback_total{op, reason}``
fallbacks: Counter = Counter()

# QueryServers running in this process (recording() refuses while any runs)
_servers_running = 0
_servers_lock = threading.Lock()


def server_started() -> None:
    global _servers_running
    with _servers_lock:
        _servers_running += 1


def server_stopped() -> None:
    global _servers_running
    with _servers_lock:
        _servers_running = max(0, _servers_running - 1)


def record(kind: str, detail: str) -> None:
    """Append a dispatch event (e.g. ``record("filter", "device")``) to the
    active recorder, if any, and annotate the context's current obs span,
    so dispatch decisions land inside the per-request span tree too."""
    events = _events
    if events is not None:
        events.append((kind, detail))
    sp = _spans.current_span()
    if sp is not None:
        sp.event(kind, detail)


def fallback(op: str, reason: str) -> None:
    """Count a device-path fallback: a recording names every fallback, and
    these counters show them without one."""
    fallbacks[(op, reason)] += 1
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_device_fallback_total",
        "Device-path fallbacks to host execution, by operator and reason",
        op=op,
        reason=reason,
    ).inc()


def active() -> bool:
    return _events is not None


@contextlib.contextmanager
def recording() -> Iterator[List]:
    """Collect dispatch events for the duration of the block.

    Raises ``RuntimeError`` while a ``QueryServer`` is running: the recorder
    is process-global and would interleave every concurrent request's
    events. Use span traces (``hyperspace.obs.tracing.enabled`` and the
    per-request profiles) under serving instead."""
    global _events
    with _servers_lock:
        if _servers_running:
            raise RuntimeError(
                "exec.trace.recording() is process-global and cannot run while "
                f"{_servers_running} QueryServer(s) are serving concurrent "
                "requests; use obs span tracing (hyperspace.obs.tracing.enabled) "
                "for per-request dispatch visibility"
            )
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


def summarize_span_events(root) -> str:
    """Dispatch summary of one finished span tree: :func:`summarize`'s form,
    sourced from the events :func:`record` annotated onto obs spans (how a
    served request's dispatch trace is read without a recording)."""
    events: List = []
    for sp in root.walk():
        events.extend(sp.events)
    return summarize(events)
