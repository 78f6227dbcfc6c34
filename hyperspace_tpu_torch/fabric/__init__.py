"""Scale-out serving fabric: multi-process serving over one lake.

The operation log is the coherence transport (docs/scale-out.md):

- every committed mutation persists a **commit record** beside the log
  entry it describes (``lifecycle/invalidation.py`` writes it inside
  ``publish``), stamped with the publisher's node id and Lamport commit
  sequence;
- a :class:`CommitWatcher` in every process tails those records and
  replays remote commits onto the local invalidation bus — brand rotation,
  roster-TTL clears, and targeted byte-cache purges fire everywhere within
  one poll interval;
- a :class:`CoherenceSidecar` shares the state invalidation can't carry:
  quarantine strikes and per-tenant SLO / token-bucket accounting;
- a :class:`FrontDoor` spreads tenants across worker processes with
  rendezvous hashing and aggregates their ``/metrics``.

Everything is behind ``hyperspace.fabric.*``, all default-off: at defaults
``configure`` returns None without touching the lake, and single-process
behavior is byte-identical to a build without this package.
"""

from __future__ import annotations

import threading
import weakref
from typing import Optional

from hyperspace_tpu_torch.fabric.coherence import CoherenceSidecar
from hyperspace_tpu_torch.fabric.frontdoor import (
    FrontDoor,
    WorkerEndpoint,
    WorkerError,
    WorkerUnavailable,
    merge_prometheus_texts,
    rendezvous_order,
    rendezvous_pick,
)
from hyperspace_tpu_torch.fabric.health import HealthTracker
from hyperspace_tpu_torch.fabric.lease import Lease, LeaseLostError, fence_scope
from hyperspace_tpu_torch.fabric.lease import acquire as acquire_lease
from hyperspace_tpu_torch.fabric.records import local_node_id
from hyperspace_tpu_torch.fabric.watcher import CommitWatcher

__all__ = [
    "CommitWatcher",
    "CoherenceSidecar",
    "FabricRuntime",
    "FrontDoor",
    "HealthTracker",
    "Lease",
    "LeaseLostError",
    "WorkerEndpoint",
    "WorkerError",
    "WorkerUnavailable",
    "acquire_lease",
    "configure",
    "fence_scope",
    "local_node_id",
    "merge_prometheus_texts",
    "rendezvous_order",
    "rendezvous_pick",
]


class FabricRuntime:
    """One session's fabric wiring: node identity + watcher + sidecar.

    Constructed (and its threads started) by :func:`configure` when
    ``hyperspace.fabric.enabled`` is on. ``attach_server``/``detach_server``
    are called from ``QueryServer.start``/``shutdown`` so the sidecar always
    accounts against the live serving stack, and a bus subscription merges
    remote quarantine *trips* the instant their commit records replay —
    strike-level sharing rides the slower sidecar loop.
    """

    def __init__(self, session, autostart: bool = True):
        conf = session.conf
        self._session_ref = weakref.ref(session)
        self.node_id = local_node_id(conf)
        self.watcher = CommitWatcher(session, node_id=self.node_id)
        self.sidecar = CoherenceSidecar(session, node_id=self.node_id)
        self.share_quarantine = bool(conf.fabric_quarantine_shared)
        self._fsck_thread: Optional[threading.Thread] = None
        self._fsck_stop = threading.Event()
        session.lifecycle_bus.subscribe(self._on_commit)
        if autostart:
            if conf.fabric_watcher_enabled:
                self.watcher.start()
            # health-aware FrontDoors read the node files' updatedAt as the
            # fleet heartbeat, so the sidecar also runs for health alone
            if (
                self.share_quarantine
                or conf.fabric_slo_shared
                or conf.fabric_health_enabled
            ):
                self.sidecar.start()
            if conf.fabric_fsck_enabled and conf.system_path:
                self.fsck_once()
                self._start_fsck_loop(conf.fabric_fsck_interval_seconds)

    # -- lake garbage collection ---------------------------------------------
    def fsck_once(self) -> Optional[dict]:
        """One fsck pass over this session's lake (fabric/fsck.py); a
        failing pass is swallowed — GC must never take down serving."""
        session = self._session_ref()
        if session is None:
            return None
        conf = session.conf
        from hyperspace_tpu_torch.fabric.fsck import fsck

        try:
            return fsck(
                conf.system_path,
                retention_s=conf.fabric_fsck_retention_seconds,
                dead_node_s=conf.fabric_fsck_dead_node_seconds,
            )
        except Exception:
            return None

    def _start_fsck_loop(self, interval_s: float) -> None:
        if self._fsck_thread is not None:
            return
        self._fsck_stop.clear()

        def _run() -> None:
            while not self._fsck_stop.wait(interval_s):
                if self._session_ref() is None:
                    return
                self.fsck_once()

        self._fsck_thread = threading.Thread(
            target=_run, name="hs-fabric-fsck", daemon=True
        )
        self._fsck_thread.start()

    # -- serving attachment --------------------------------------------------
    def attach_server(self, server) -> None:
        self.sidecar.attach_server(server)

    def detach_server(self, server) -> None:
        self.sidecar.detach_server(server)

    # -- remote trip propagation ---------------------------------------------
    def _on_commit(self, event) -> None:
        if not self.share_quarantine or event.kind != "quarantine":
            return
        origin = getattr(event, "origin", None)
        if origin is None or origin == self.node_id:
            return  # local trip: the registry already opened the breaker
        from hyperspace_tpu_torch.reliability.degrade import QUARANTINE

        if QUARANTINE.merge_remote_trip(event.index_name):
            from hyperspace_tpu_torch.obs.metrics import REGISTRY

            REGISTRY.counter(
                "hs_fabric_quarantine_merged_total",
                "quarantine trips caused or propagated by remote strikes",
                index=event.index_name,
            ).inc()

    def stop(self) -> None:
        self.watcher.stop()
        self.sidecar.stop()
        self._fsck_stop.set()
        if self._fsck_thread is not None:
            self._fsck_thread.join(timeout=5)
            self._fsck_thread = None
        session = self._session_ref()
        if session is not None:
            session.lifecycle_bus.unsubscribe(self._on_commit)


def configure(session) -> Optional[FabricRuntime]:
    """Session wiring hook (mirrors ``reliability.configure``): a no-op
    returning None while ``hyperspace.fabric.enabled`` is off."""
    if not session.conf.fabric_enabled:
        return None
    return FabricRuntime(session)
