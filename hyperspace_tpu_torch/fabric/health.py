"""Node liveness for the FrontDoor: ejection, half-open probes, heartbeats.

The FrontDoor's rendezvous set was static — a dead worker kept receiving
its tenants' requests forever. :class:`HealthTracker` makes membership
react to observed health, mirroring the quarantine breaker's
closed → open → half-open shape (``reliability/degrade.py``):

- **live**: requests flow; every success resets the failure streak.
- **ejected**: ``failure_threshold`` consecutive transport/transient
  failures — or a heartbeat older than ``missed_beats`` sidecar publish
  intervals, or a ``/healthz`` commit-seq lag past ``max_commit_lag``
  (a *wedged* watcher looks alive but serves stale) — removes the worker
  from the rendezvous set; its tenants re-hash to survivors.
- **half-open**: after ``probe_interval_s`` one request is allowed
  through as a probe; success re-admits (``hs_fabric_node_readmissions_total``),
  failure re-ejects and restarts the cooldown.

Heartbeats ride the coherence sidecar: every fabric node's ledger file
carries ``updatedAt`` (and now a ``heartbeat`` payload); the FrontDoor
maps workers to node ids via ``/healthz`` and treats ledger age as beat
age, so a SIGKILLed process is detected without any new write path.

Fail-open by design: if *every* worker is ejected the tracker returns the
full set — routing to a probably-dead worker beats routing to nobody.
Clock injected for deterministic tests.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["HealthTracker"]

STATE_LIVE = "live"
STATE_EJECTED = "ejected"
STATE_HALF_OPEN = "half-open"


def _count_ejection(worker: str, reason: str) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_fabric_node_ejections_total",
        "workers ejected from the FrontDoor rendezvous set, by reason "
        "(errors | missed-beats | stale | probe-failed)",
        worker=worker,
        reason=reason,
    ).inc()


def _count_readmission(worker: str) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_fabric_node_readmissions_total",
        "ejected workers re-admitted after a successful half-open probe",
        worker=worker,
    ).inc()


def _gauge_live(n: int) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.gauge(
        "hs_fabric_node_live",
        "workers currently in the FrontDoor's live rendezvous set",
    ).set(float(n))


class _Node:
    __slots__ = ("state", "failures", "ejected_at", "last_beat", "probing")

    def __init__(self):
        self.state = STATE_LIVE
        self.failures = 0
        self.ejected_at = 0.0
        self.last_beat: Optional[float] = None
        self.probing = False


class HealthTracker:
    """Per-worker breaker state for FrontDoor membership (module docstring)."""

    def __init__(
        self,
        *,
        failure_threshold: int = 3,
        probe_interval_s: float = 5.0,
        heartbeat_interval_s: float = 1.0,
        missed_beats: int = 3,
        max_commit_lag: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.probe_interval_s = float(probe_interval_s)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.missed_beats = max(1, int(missed_beats))
        self.max_commit_lag = int(max_commit_lag)  # 0 disables stale ejection
        self._clock = clock
        self._lock = threading.Lock()
        self._nodes: Dict[str, _Node] = {}

    def _node(self, worker: str) -> _Node:
        node = self._nodes.get(worker)
        if node is None:
            node = self._nodes[worker] = _Node()
        return node

    # -- observations --------------------------------------------------------
    def note_ok(self, worker: str) -> None:
        with self._lock:
            node = self._node(worker)
            was = node.state
            node.failures = 0
            node.probing = False
            node.state = STATE_LIVE
        if was != STATE_LIVE:
            _count_readmission(worker)

    def note_failure(self, worker: str, reason: str = "errors") -> None:
        eject, why = False, reason
        with self._lock:
            node = self._node(worker)
            node.failures += 1
            if node.state == STATE_HALF_OPEN or node.probing:
                # the probe itself failed: back to ejected, cooldown restarts
                eject, why = True, "probe-failed"
            elif node.state == STATE_LIVE and node.failures >= self.failure_threshold:
                eject = True
            if eject:
                node.state = STATE_EJECTED
                node.probing = False
                node.ejected_at = self._clock()
        if eject:
            _count_ejection(worker, why)

    def note_beat(self, worker: str, age_s: float) -> None:
        """Observe a sidecar-heartbeat age (seconds since the node's ledger
        was written). A fresh beat re-admits a beats-ejected worker
        directly — the process provably lives — while an overdue one ejects."""
        overdue = age_s > self.heartbeat_interval_s * self.missed_beats
        with self._lock:
            node = self._node(worker)
            node.last_beat = self._clock() - age_s
            if overdue and node.state == STATE_LIVE:
                node.state = STATE_EJECTED
                node.ejected_at = self._clock()
                eject = True
                readmit = False
            elif not overdue and node.state != STATE_LIVE and not node.probing:
                node.state = STATE_LIVE
                node.failures = 0
                eject = False
                readmit = True
            else:
                eject = readmit = False
        if eject:
            _count_ejection(worker, "missed-beats")
        if readmit:
            _count_readmission(worker)

    def note_stale(self, worker: str, lag: int) -> None:
        """Observe a worker's last-applied commit_seq lag behind the fleet
        max. Past ``max_commit_lag`` the worker is serving stale answers —
        alive but wedged — and is ejected like a dead one."""
        if self.max_commit_lag <= 0 or lag <= self.max_commit_lag:
            return
        with self._lock:
            node = self._node(worker)
            if node.state != STATE_LIVE:
                return
            node.state = STATE_EJECTED
            node.ejected_at = self._clock()
        _count_ejection(worker, "stale")

    # -- membership ----------------------------------------------------------
    def state_of(self, worker: str) -> str:
        with self._lock:
            node = self._nodes.get(worker)
            return node.state if node else STATE_LIVE

    def live(self, workers: Sequence[str]) -> List[str]:
        """The rendezvous-eligible subset: live workers plus ejected ones
        whose probe cooldown elapsed (admitted half-open, one at a time).
        Empty never happens: with everyone ejected, everyone is returned
        (fail open) — a guess beats a guaranteed refusal."""
        now = self._clock()
        out: List[str] = []
        with self._lock:
            for w in workers:
                node = self._nodes.get(w)
                if node is None or node.state == STATE_LIVE:
                    out.append(w)
                elif now - node.ejected_at >= self.probe_interval_s:
                    node.state = STATE_HALF_OPEN
                    node.probing = True
                    out.append(w)
        if not out:
            out = list(workers)
        _gauge_live(len(out))
        return out
