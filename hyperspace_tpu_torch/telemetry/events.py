"""Telemetry: structured event taxonomy + pluggable sink.

Events are emitted around every lifecycle action and on index usage
(ref: HS/telemetry/HyperspaceEvent.scala:28-156); the sink class is named
by conf ``hyperspace.eventLoggerClass`` with a NoOp default
(ref: HS/telemetry/HyperspaceEventLogging.scala:30-68) and resolves through
a static table of the port's sinks (``logger_class``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class HyperspaceEvent:
    app_info: Dict[str, str] = field(default_factory=dict)
    message: str = ""
    timestamp: float = field(default_factory=time.time)

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclass
class ActionEvent(HyperspaceEvent):
    index_name: str = ""
    state: str = ""  # "Started" / "Success" / "Failure"


@dataclass
class CreateActionEvent(ActionEvent):
    pass


@dataclass
class DeleteActionEvent(ActionEvent):
    pass


@dataclass
class RestoreActionEvent(ActionEvent):
    pass


@dataclass
class VacuumActionEvent(ActionEvent):
    pass


@dataclass
class RefreshActionEvent(ActionEvent):
    pass


@dataclass
class RefreshIncrementalActionEvent(ActionEvent):
    pass


@dataclass
class RefreshQuickActionEvent(ActionEvent):
    pass


@dataclass
class OptimizeActionEvent(ActionEvent):
    pass


@dataclass
class CancelActionEvent(ActionEvent):
    pass


@dataclass
class HyperspaceIndexUsageEvent(HyperspaceEvent):
    """Emitted when the optimizer applies indexes to a query
    (ref: HS/telemetry/HyperspaceEvent.scala HyperspaceIndexUsageEvent)."""

    index_names: List[str] = field(default_factory=list)
    plan_summary: str = ""


@dataclass
class ServingStatsEvent(HyperspaceEvent):
    """Periodic serving-runtime snapshot (``QueryServer.stats(emit=True)``):
    queue pressure, cache effectiveness, and latency tail."""

    queue_depth: int = 0
    rejected: int = 0
    plan_cache_hit_rate: float = 0.0
    bucket_cache_hit_rate: float = 0.0
    latency_p50: Optional[float] = None
    latency_p95: Optional[float] = None
    latency_p99: Optional[float] = None
    completed: int = 0


@dataclass
class ServingRejectionEvent(HyperspaceEvent):
    """A request was rejected at admission (queue full, backpressure)."""

    queue_depth: int = 0
    queued: int = 0


class EventLogger:
    def log_event(self, event: HyperspaceEvent) -> None:
        raise NotImplementedError


class NoOpEventLogger(EventLogger):
    def log_event(self, event: HyperspaceEvent) -> None:
        pass


class CollectingEventLogger(EventLogger):
    """In-memory sink for tests (ref: MockEventLogger in TestUtils.scala:93-121).

    Thread-safe: the serving runtime logs from worker threads concurrently,
    and a bare ``list.append`` raced with ``reset``/snapshot reads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.events: List[HyperspaceEvent] = []

    def log_event(self, event: HyperspaceEvent) -> None:
        with self._lock:
            self.events.append(event)

    def snapshot(self) -> List[HyperspaceEvent]:
        """Consistent copy for readers racing concurrent log_event calls."""
        with self._lock:
            return list(self.events)

    def reset(self) -> None:
        with self._lock:
            self.events = []


_cache_lock = threading.Lock()


#: event-logger class name, below the package name -> the port's class
_LOGGERS = {
    "telemetry.events.NoOpEventLogger": NoOpEventLogger,
    "telemetry.events.CollectingEventLogger": CollectingEventLogger,
}

#: package names whose logger class names the table resolves
_PACKAGES = ("hyperspace_tpu_torch", "hyperspace_tpu")


def logger_class(dotted: str):
    """The port's event-logger class for a conf class name. A name resolves
    through a static table of the port's own sinks, never by importing it:
    a conf shared with the JAX package names that package's classes, which
    load the same sinks here under the package prefix ``hyperspace_tpu`` as
    under ``hyperspace_tpu_torch``."""
    package, _, name = dotted.strip().partition(".")
    cls = _LOGGERS.get(name) if package in _PACKAGES else None
    if cls is None:
        raise ValueError(f"Unknown event logger class {dotted!r}; known: {sorted(_LOGGERS)}")
    return cls


def get_event_logger(session) -> EventLogger:
    """Resolve the session's event sink from conf ``hyperspace.eventLoggerClass``.

    Logger instances are cached *per session*, keyed by the configured class
    name — NOT in a module-level dict keyed by class name alone, which made
    two sessions configured with the same class silently share one sink and
    ignored mid-session conf changes. Repeated calls with an unchanged conf
    return the same instance (tests rely on that identity); changing the conf
    key resolves a fresh logger on the next call.
    """
    cls_name: Optional[str] = session.conf.get("hyperspace.eventLoggerClass")
    key = cls_name or "__noop__"
    with _cache_lock:
        cache: Dict[str, EventLogger] = getattr(session, "_event_logger_cache", None)
        if cache is None:
            cache = {}
            session._event_logger_cache = cache
        got = cache.get(key)
        if got is None:
            got = NoOpEventLogger() if not cls_name else logger_class(cls_name)()
            cache[key] = got
        return got


def emit_event(session, event: HyperspaceEvent) -> None:
    """Log ``event`` on the session's sink AND count it in the process-wide
    metrics registry (``hs_events_total{event=...}``) — telemetry events are
    just another metric emitter on the shared observability substrate."""
    if session.conf.obs_metrics_enabled:
        from hyperspace_tpu_torch.obs.metrics import REGISTRY

        REGISTRY.counter(
            "hs_events_total", "telemetry events emitted", event=event.name
        ).inc()
    get_event_logger(session).log_event(event)
