"""Maintenance actions: Delete, Restore, Vacuum, Cancel
(ref: HS/actions/DeleteAction.scala:24-48, RestoreAction.scala:24-48,
VacuumAction.scala:24-57, CancelAction.scala:35-67).
"""

from __future__ import annotations

from hyperspace_tpu_torch.actions.base import Action, HyperspaceActionException
from hyperspace_tpu_torch.models import states
from hyperspace_tpu_torch.models.log_entry import IndexLogEntry
from hyperspace_tpu_torch.telemetry.events import (
    CancelActionEvent,
    DeleteActionEvent,
    RestoreActionEvent,
    VacuumActionEvent,
)


class _StableTransitionAction(Action):
    """Shared: validate the latest stable state, carry the entry through."""

    expected_states = frozenset()

    def __init__(self, session, name: str, log_manager, data_manager=None):
        super().__init__(session, log_manager, data_manager)
        self._name = name
        self._entry: IndexLogEntry = None  # type: ignore[assignment]

    @property
    def index_name(self) -> str:
        return self._name

    def validate(self) -> None:
        entry = self.log_manager.get_latest_stable_log()
        if entry is None or entry.state == states.DOESNOTEXIST:
            raise HyperspaceActionException(f"Index {self._name!r} does not exist.")
        if entry.state not in self.expected_states:
            raise HyperspaceActionException(
                f"{type(self).__name__} is not supported in state {entry.state} "
                f"(expected one of {sorted(self.expected_states)})."
            )
        self._entry = entry

    def transient_log_entry(self) -> IndexLogEntry:
        entry = IndexLogEntry.from_dict(self._entry.to_dict())
        entry.state = self.transient_state
        return entry

    def op(self) -> None:
        pass

    def log_entry(self) -> IndexLogEntry:
        return IndexLogEntry.from_dict(self._entry.to_dict())


class DeleteAction(_StableTransitionAction):
    """Soft delete — log state only (ref: DeleteAction.scala:24-48)."""

    transient_state = states.DELETING
    final_state = states.DELETED
    event_class = DeleteActionEvent
    expected_states = frozenset({states.ACTIVE})


class RestoreAction(_StableTransitionAction):
    """Un-delete (ref: RestoreAction.scala:24-48)."""

    transient_state = states.RESTORING
    final_state = states.ACTIVE
    event_class = RestoreActionEvent
    expected_states = frozenset({states.DELETED})


class VacuumAction(_StableTransitionAction):
    """Hard delete of index data (ref: VacuumAction.scala:24-57)."""

    transient_state = states.VACUUMING
    final_state = states.DOESNOTEXIST
    event_class = VacuumActionEvent
    expected_states = frozenset({states.DELETED})

    def op(self) -> None:
        assert self.data_manager is not None
        for version in self.data_manager.get_all_versions():
            self.data_manager.delete_version(version)


class CancelAction(_StableTransitionAction):
    """Recover a stuck index from a transient state back to its last stable
    state (ref: CancelAction.scala:35-67)."""

    transient_state = states.CANCELLING
    event_class = CancelActionEvent
    # final_state is dynamic: the last stable state
    expected_states = frozenset({states.ACTIVE, states.DELETED})

    def validate(self) -> None:
        if self.log_manager.get_latest_id() is None:
            raise HyperspaceActionException(f"Index {self._name!r} does not exist.")
        latest = self.log_manager.get_latest_log()
        if latest is not None and latest.state in states.STABLE_STATES:
            raise HyperspaceActionException(
                f"Cancel is not supported in state {latest.state} — nothing in progress."
            )
        entry = self.log_manager.get_latest_stable_log()
        if entry is None:
            raise HyperspaceActionException(
                f"Index {self._name!r} has no stable state to recover to; vacuum it instead."
            )
        self._entry = entry
        self.final_state = entry.state
