"""Snapshot pinning: freeze the data version a request resolves against.

A ``SnapshotHandle`` is an immutable capture of the stable index-log roster
(every index's latest stable ``IndexLogEntry``) plus the lifecycle commit
sequence observed at capture time. The serving front-end captures one per
request at admission and enters :func:`snapshot_scope` around resolution and
execution; ``IndexCollectionManager.get_indexes``/``get_index`` consult
:func:`current_snapshot` first, so *every* log-version resolution downstream
of a pinned request — ``session_token``, ``version_brand``,
``ApplyHyperspace`` candidate collection, hybrid-scan appended/deleted
diffs — reads the pinned roster, never the live log.

The invariant this buys (docs/lifecycle.md): a refresh committing version
N+1 while a request is in flight cannot change that request's answer — the
request was admitted against version N and serves exactly version N's rows.
Conversely a request admitted *after* commit k captures a roster with the
new entry, giving linearizable version visibility.

The pin is a ``contextvars.ContextVar``, so concurrent worker threads (and
micro-batched groups) each carry their own pin without cross-talk — the same
mechanism ``Session.hyperspace_scope`` uses for the enabled flag.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator, List, Optional, Tuple

_pin: contextvars.ContextVar = contextvars.ContextVar("hs_snapshot_pin", default=None)


def current_snapshot() -> Optional["SnapshotHandle"]:
    """The SnapshotHandle pinned on this thread/context, or None."""
    return _pin.get()


@contextlib.contextmanager
def snapshot_scope(handle: Optional["SnapshotHandle"]) -> Iterator[Optional["SnapshotHandle"]]:
    """Pin ``handle`` for the dynamic extent of the block (no-op for None,
    so call sites don't need to branch on whether pinning is enabled)."""
    if handle is None:
        yield None
        return
    token = _pin.set(handle)
    try:
        yield handle
    finally:
        _pin.reset(token)


def _count_pin() -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_snapshot_pins_total",
        "SnapshotHandles captured (one per admitted request when pinning is on)",
    ).inc()


class SnapshotHandle:
    """Immutable capture of the stable log version of every index at one
    instant, plus the commit sequence number it was taken at.

    ``entries`` holds the latest stable ``IndexLogEntry`` per index (all
    stable states, matching what the caching manager caches); ``roster`` is
    the sorted ``(name, log id)`` tuple — the part of the identity that
    folds into session tokens and version brands.
    """

    __slots__ = ("entries", "roster", "commit_seq", "created_at")

    def __init__(self, entries, commit_seq: int = 0, created_at: Optional[float] = None):
        self.entries: Tuple = tuple(entries)
        self.roster: Tuple = tuple(sorted((e.name, e.id) for e in self.entries))
        self.commit_seq = int(commit_seq)
        self.created_at = time.monotonic() if created_at is None else created_at

    @classmethod
    def capture(cls, session) -> "SnapshotHandle":
        """Capture the current stable roster through the session's (caching)
        index manager. Under an existing pin this returns the *pinned* roster
        — capture is idempotent, a nested capture can't time-travel forward.

        The commit sequence is read BEFORE the roster: if a commit lands
        between the two reads, the handle under-reports its sequence, which
        is the safe direction (a request claiming seq k must see >= k).

        An unreadable roster (no ``hyperspace.system.path`` configured, log
        directory gone) pins an *empty* snapshot instead of failing the
        request: queries then resolve no indexes and fall back to plain
        scans — correct answers, minus the speedup.
        """
        from hyperspace_tpu_torch.models import states

        bus = session.lifecycle_bus
        seq = bus.commit_seq
        try:
            entries = session.index_manager.get_indexes(list(states.STABLE_STATES))
        except Exception:
            entries = ()
        _count_pin()
        return cls(entries, commit_seq=seq)

    def get_indexes(self, accepted_states: Optional[List[str]] = None) -> List:
        from hyperspace_tpu_torch.models import states

        accepted = set(accepted_states or states.STABLE_STATES)
        return [e for e in self.entries if e.state in accepted]

    def get_index(self, name: str):
        for e in self.entries:
            if e.name == name:
                return e
        return None

    def index_version(self, name: str) -> Optional[int]:
        """The pinned log id of ``name``, or None when the index is not in
        the snapshot."""
        e = self.get_index(name)
        return None if e is None else e.id

    def __repr__(self) -> str:
        return f"SnapshotHandle(seq={self.commit_seq}, roster={self.roster!r})"
