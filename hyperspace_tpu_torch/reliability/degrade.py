"""Graceful degradation: per-index quarantine circuit breaker.

The paper's core contract is that an index is always *optional* — source
data stays the ground truth. This module enforces that operationally:
repeated :class:`CorruptDataError`\\ s on one index's files trip a breaker
that **quarantines the index**:

- a ``CommitEvent(kind="quarantine")`` publishes on the session's lifecycle
  invalidation bus, so the roster TTL cache and the bucket/IO/device byte
  caches purge any derivative of the bad files;
- the candidate collector stops proposing the index (why-not reason
  ``INDEX_QUARANTINED``), so queries transparently re-plan against source —
  correct answers, just slower;
- after ``cooldownSeconds`` the breaker goes **half-open**: the next
  eligibility check admits the index once as a probe. A clean read of its
  files closes the breaker (un-quarantines); another corrupt read re-trips
  it for a fresh cooldown.

Corruption on *source* files never quarantines anything — there is no
fallback below the ground truth — the query fails with the typed error,
surfaced through ``QueryServer._seal`` into SLO/error metrics.

Default-off: ``hyperspace.reliability.quarantine.enabled`` gates the whole
registry; disabled, every hook is one attribute read.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Dict, List, Optional

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half-open"


def _count_quarantine(index: str) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_index_quarantined_total",
        "circuit-breaker trips quarantining an index after repeated "
        "corrupt-data errors on its files",
        index=index,
    ).inc()


class _Breaker:
    __slots__ = ("state", "strikes", "tripped_at")

    def __init__(self):
        self.state = _CLOSED
        self.strikes = 0
        self.tripped_at = 0.0


class QuarantineRegistry:
    """Process-global breaker map, configured per session (most recent
    session wins, like the decode pool); holds only a weakref to the
    session so a dropped session never leaks through reliability state."""

    def __init__(self):
        self._lock = threading.Lock()
        self._breakers: Dict[str, _Breaker] = {}
        # strikes merged from fabric peers (coherence sidecar); they count
        # toward the local threshold but are never re-published
        self._remote_strikes: Dict[str, int] = {}
        self._indexes_root: Optional[str] = None
        self._session_ref = lambda: None
        self._threshold = 3
        self._cooldown_s = 30.0
        self._clock = time.monotonic
        self.enabled = False

    def configure(
        self,
        session,
        *,
        enabled: bool,
        threshold: int,
        cooldown_s: float,
        clock=time.monotonic,
    ) -> None:
        with self._lock:
            self.enabled = bool(enabled)
            self._threshold = max(1, int(threshold))
            self._cooldown_s = float(cooldown_s)
            self._clock = clock
            self._session_ref = weakref.ref(session)
            # index layout: <system.path>/<indexName>/... (models/path_resolver.py)
            sys_path = session.conf.system_path
            self._indexes_root = os.path.abspath(str(sys_path)) if sys_path else None
            self._breakers = {}
            self._remote_strikes = {}

    # -- path → index attribution -------------------------------------------
    def index_of_path(self, path: Optional[str]) -> Optional[str]:
        """The index name owning ``path``, or None for source/other files."""
        root = self._indexes_root
        if root is None or not path:
            return None
        p = os.path.abspath(str(path))
        if not p.startswith(root + os.sep):
            return None
        rest = p[len(root) + 1 :]
        name = rest.split(os.sep, 1)[0]
        return name or None

    def _index_files(self, name: str) -> List[str]:
        root = self._indexes_root
        if root is None:
            return []
        out: List[str] = []
        for dirpath, _dirs, files in os.walk(os.path.join(root, name)):
            out.extend(os.path.join(dirpath, f) for f in files)
        return out

    # -- the hooks -----------------------------------------------------------
    def note_corrupt(self, path: Optional[str]) -> Optional[str]:
        """Record a corrupt read of ``path``. Returns the index name if this
        strike tripped (or re-tripped) its quarantine, else None."""
        if not self.enabled:
            return None
        name = self.index_of_path(path)
        if name is None:
            return None
        tripped = False
        with self._lock:
            b = self._breakers.setdefault(name, _Breaker())
            if b.state == _HALF_OPEN:
                # the probe read was corrupt too: straight back to open
                b.state = _OPEN
                b.tripped_at = self._clock()
                tripped = True
            else:
                b.strikes += 1
                effective = b.strikes + self._remote_strikes.get(name, 0)
                if b.state == _CLOSED and effective >= self._threshold:
                    b.state = _OPEN
                    b.tripped_at = self._clock()
                    tripped = True
        if tripped:
            _count_quarantine(name)
            self._publish_quarantine(name)
        return name if tripped else None

    def note_ok(self, path: Optional[str]) -> None:
        """A clean read of ``path``: closes a half-open breaker (the probe
        succeeded) and clears accumulated strikes on a closed one."""
        if not self.enabled:
            return
        name = self.index_of_path(path)
        if name is None:
            return
        with self._lock:
            b = self._breakers.get(name)
            if b is None:
                return
            if b.state == _HALF_OPEN:
                b.state = _CLOSED
                b.strikes = 0
            elif b.state == _CLOSED:
                b.strikes = 0

    def is_quarantined(self, name: str) -> bool:
        """Planner eligibility check. An open breaker past its cooldown
        flips to half-open and admits the index once as a probe."""
        if not self.enabled:
            return False
        with self._lock:
            b = self._breakers.get(str(name))
            if b is None or b.state == _CLOSED:
                return False
            if b.state == _HALF_OPEN:
                # one probe is already in flight; stay out of new plans
                return True
            if self._clock() - b.tripped_at >= self._cooldown_s:
                b.state = _HALF_OPEN
                return False
            return True

    def state_of(self, name: str) -> str:
        with self._lock:
            b = self._breakers.get(str(name))
            return b.state if b is not None else _CLOSED

    # -- fabric coherence (hyperspace_tpu_torch/fabric/coherence.py) ---------------
    def local_strikes(self) -> Dict[str, int]:
        """This process's own accumulated strikes per index — what the
        coherence sidecar publishes (remote strikes are excluded so peers
        never echo each other's counts back and forth)."""
        with self._lock:
            return {n: b.strikes for n, b in self._breakers.items() if b.strikes}

    def merge_remote_strikes(self, strikes: Dict[str, int]) -> List[str]:
        """Replace the remote-strike view with the peers' current totals and
        trip any closed breaker whose local+remote count now crosses the
        threshold. Returns the names tripped by this merge. Merged trips are
        deliberately NOT re-published on the bus — the originating process
        already persisted the strikes, and an echo would ping-pong."""
        if not self.enabled:
            return []
        tripped: List[str] = []
        with self._lock:
            self._remote_strikes = {str(k): int(v) for k, v in strikes.items() if int(v) > 0}
            for name, remote in self._remote_strikes.items():
                b = self._breakers.setdefault(name, _Breaker())
                if b.state == _CLOSED and b.strikes + remote >= self._threshold:
                    b.state = _OPEN
                    b.tripped_at = self._clock()
                    tripped.append(name)
        for name in tripped:
            _count_quarantine(name)
        return tripped

    def merge_remote_trip(self, name: str) -> bool:
        """A peer's breaker tripped (its quarantine commit record replayed
        here): open ours too so this process stops planning the index
        immediately. Returns False when it was already open."""
        if not self.enabled:
            return False
        with self._lock:
            b = self._breakers.setdefault(str(name), _Breaker())
            if b.state == _OPEN:
                return False
            b.state = _OPEN
            b.tripped_at = self._clock()
        _count_quarantine(str(name))
        return True

    # -- bus publication -----------------------------------------------------
    def _publish_quarantine(self, name: str) -> None:
        session = self._session_ref()
        if session is None:
            return
        from hyperspace_tpu_torch.lifecycle.invalidation import CommitEvent

        try:
            session.lifecycle_bus.publish(
                CommitEvent(name, None, "quarantine", self._index_files(name))
            )
        except Exception:  # pragma: no cover — a broken bus must not mask the read error
            pass


#: the process-global registry (one-attr fast path while disabled); its
#: strikes/trips are shared across fabric processes by the coherence sidecar
QUARANTINE = QuarantineRegistry()

#: module-level registries whose state the fabric publishes to peers — the
#: process-local-state lint rule exempts these by name
__fabric_published__ = ("QUARANTINE",)


def configure(session) -> None:
    conf = session.conf
    QUARANTINE.configure(
        session,
        enabled=conf.reliability_quarantine_enabled,
        threshold=conf.reliability_quarantine_threshold,
        cooldown_s=conf.reliability_quarantine_cooldown_seconds,
    )
