"""Telemetry: structured event taxonomy.

Events are emitted around every lifecycle action
(ref: HS/telemetry/HyperspaceEvent.scala:28-156) to the NoOp sink, the
reference's default (ref: HS/telemetry/HyperspaceEventLogging.scala:30-68).
A sink chosen by conf comes with the first slice that reads events.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict


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


class EventLogger:
    def log_event(self, event: HyperspaceEvent) -> None:
        raise NotImplementedError


class NoOpEventLogger(EventLogger):
    def log_event(self, event: HyperspaceEvent) -> None:
        pass


_SINK: EventLogger = NoOpEventLogger()


def emit_event(session, event: HyperspaceEvent) -> None:
    """Log ``event`` on the sink."""
    _SINK.log_event(event)
