"""Coherence sidecar: share quarantine strikes and SLO accounting via the lake.

Each fabric node periodically overwrites one sidecar file
(``<system.path>/_fabric/nodes/<node>.json``) with its **cumulative**
coherence ledger:

- per-index quarantine strike counts (``reliability/degrade.py`` breakers),
- per-tenant SLO good/bad event counts (``obs/slo.py``),
- per-tenant token-bucket drain totals (``serving/scheduler.py``),

and merges every peer's ledger back in. Merging is delta-based: the sidecar
remembers the last cumulative value it folded in per (peer, key) and applies
only the increase, so re-reading an unchanged file is a no-op and a
restarted peer (counters reset to zero) simply contributes nothing until it
grows again. The effect:

- remote strikes count toward the local quarantine threshold, so one
  process's corrupt reads protect the others *before* they trip locally
  (trip events themselves also propagate instantly via commit records);
- remote good/bad events fold into local burn-rate windows, so the
  scheduler's burn-boost reacts to the *global* SLO, not one process's
  slice of it;
- remote bucket drains debit local token buckets, so a per-tenant rate
  limit of R holds at ~R across the fleet instead of R × processes.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional

from hyperspace_tpu_torch.fabric import records

__all__ = ["CoherenceSidecar"]


def _registry():
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    return REGISTRY


class CoherenceSidecar:
    """One publish/merge loop per fabric node (see module docstring).

    ``run_once`` (publish then merge) is the deterministic unit tests call
    directly; ``start`` runs it on a daemon thread every ``interval``
    seconds. QueryServers attach themselves while serving (their scheduler
    and SLO tracker are the accounting sources and merge sinks).
    """

    def __init__(
        self,
        session,
        node_id: Optional[str] = None,
        interval: Optional[float] = None,
    ):
        import time as _time

        conf = session.conf
        self._session_ref = weakref.ref(session)
        self._started_at = _time.time()
        self.node_id = node_id or records.local_node_id(conf)
        self.interval = float(
            conf.fabric_slo_publish_interval_seconds if interval is None else interval
        )
        self.share_quarantine = bool(conf.fabric_quarantine_shared)
        self.share_slo = bool(conf.fabric_slo_shared)
        self._lock = threading.Lock()
        self._servers: "weakref.WeakSet" = weakref.WeakSet()
        # last cumulative value folded in, per peer: {"slo": {(origin, tenant):
        # (good, bad)}, "drained": {(origin, tenant): tokens}}
        self._merged_slo: Dict[tuple, tuple] = {}
        self._merged_drained: Dict[tuple, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- server attachment ---------------------------------------------------
    def attach_server(self, server) -> None:
        with self._lock:
            self._servers.add(server)

    def detach_server(self, server) -> None:
        with self._lock:
            self._servers.discard(server)

    def _live_servers(self):
        with self._lock:
            return list(self._servers)

    # -- publish -------------------------------------------------------------
    def publish_once(self) -> bool:
        session = self._session_ref()
        if session is None:
            return False
        import time as _time

        # the node file's updatedAt is the fleet heartbeat; this payload
        # adds what liveness checks want alongside it (FrontDoor.check_beats
        # reads updatedAt age, /healthz consumers read commitSeq lag)
        state: dict = {
            "heartbeat": {
                "commitSeq": int(getattr(session.lifecycle_bus, "commit_seq", 0)),
                "uptimeSeconds": max(0.0, _time.time() - self._started_at),
            }
        }
        if self.share_quarantine:
            from hyperspace_tpu_torch.reliability.degrade import QUARANTINE

            state["strikes"] = QUARANTINE.local_strikes()
        if self.share_slo:
            slo: Dict[str, Dict[str, int]] = {}
            drained: Dict[str, float] = {}
            for server in self._live_servers():
                tracker = getattr(server, "slo", None)
                if tracker is not None:
                    for tenant, (good, bad) in tracker.counts().items():
                        cur = slo.setdefault(tenant, {"good": 0, "bad": 0})
                        cur["good"] += good
                        cur["bad"] += bad
                sched = getattr(server, "admission", None)
                if hasattr(sched, "drained_tokens"):
                    for tenant, tokens in sched.drained_tokens().items():
                        drained[tenant] = drained.get(tenant, 0.0) + tokens
            state["slo"] = slo
            state["drained"] = drained
        ok = records.write_node_file(
            session.conf.system_path, self.node_id, state
        )
        if ok:
            reg = _registry()
            reg.counter(
                "hs_fabric_sidecar_publishes_total",
                "sidecar node-file publishes",
            ).inc()
        return ok

    # -- merge ---------------------------------------------------------------
    def merge_once(self) -> int:
        """Fold every peer's ledger deltas into local state; returns the
        number of peers merged."""
        session = self._session_ref()
        if session is None:
            return 0
        peers = records.read_peer_node_files(session.conf.system_path, self.node_id)
        if not peers:
            return 0
        if self.share_quarantine:
            self._merge_strikes(peers)
        if self.share_slo:
            self._merge_slo(peers)
        reg = _registry()
        reg.counter(
            "hs_fabric_sidecar_merges_total",
            "sidecar merge rounds that observed at least one peer",
        ).inc()
        return len(peers)

    def _merge_strikes(self, peers: Dict[str, dict]) -> None:
        totals: Dict[str, int] = {}
        for state in peers.values():
            for index, n in (state.get("strikes") or {}).items():
                totals[index] = totals.get(index, 0) + int(n)
        from hyperspace_tpu_torch.reliability.degrade import QUARANTINE

        reg = _registry()
        for index in QUARANTINE.merge_remote_strikes(totals):
            reg.counter(
                "hs_fabric_quarantine_merged_total",
                "quarantine trips caused or propagated by remote strikes",
                index=index,
            ).inc()

    def _merge_slo(self, peers: Dict[str, dict]) -> None:
        servers = self._live_servers()
        for origin, state in peers.items():
            for tenant, counts in (state.get("slo") or {}).items():
                good = int(counts.get("good", 0))
                bad = int(counts.get("bad", 0))
                pg, pb = self._merged_slo.get((origin, tenant), (0, 0))
                dg, db = max(0, good - pg), max(0, bad - pb)
                self._merged_slo[(origin, tenant)] = (good, bad)
                if dg or db:
                    for server in servers:
                        tracker = getattr(server, "slo", None)
                        if tracker is not None:
                            tracker.note_remote(tenant, good=dg, bad=db)
            for tenant, tokens in (state.get("drained") or {}).items():
                tokens = float(tokens)
                prev = self._merged_drained.get((origin, tenant), 0.0)
                delta = max(0.0, tokens - prev)
                self._merged_drained[(origin, tenant)] = tokens
                if delta > 0:
                    for server in servers:
                        sched = getattr(server, "admission", None)
                        if hasattr(sched, "external_drain"):
                            sched.external_drain(tenant, delta)

    def run_once(self) -> int:
        self.publish_once()
        return self.merge_once()

    # -- thread lifecycle ----------------------------------------------------
    def start(self) -> "CoherenceSidecar":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="hs-fabric-sidecar", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            if self._session_ref() is None:
                return
            try:
                self.run_once()
            except Exception:  # pragma: no cover — a bad round must not kill the loop
                pass
