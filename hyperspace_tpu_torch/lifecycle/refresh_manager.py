"""Background refresh controller: keep indexes fresh while serving.

``RefreshManager`` watches every ACTIVE index's appended/deleted drift — the
same ``FileInfo`` set-diff and byte ratios the candidate gate uses
(``rules/candidate._signature_filter``) — and schedules an
incremental/quick refresh when drift crosses the hybrid-scan thresholds:

- hybrid scan absorbs *small* drift at query time for free, so below the
  thresholds the manager commits a **quick** (metadata-only) refresh that
  records appended/deleted in the log entry;
- past either threshold the candidate gate would start rejecting the index,
  so the manager runs an **incremental** refresh that folds the drift into
  the index data proper.

Concurrency stance:

- the build runs on the manager's own thread, never under any serving lock —
  serving keeps resolving the prior stable version throughout;
- **single-writer per index**: a non-blocking per-index mutex makes a second
  scheduler (or an operator-issued manual refresh racing the manager) skip
  rather than double-build; with ``hyperspace.fabric.lease.enabled`` the
  same guarantee extends across *processes* via a lake-persisted lease with
  heartbeat renewal and a fencing token verified at the commit point
  (``fabric/lease.py``) — a holder killed mid-refresh is taken over by a
  peer after lease expiry, and its late commit is fenced off;
- **crash-safe / retry-idempotent** by construction: refresh goes through
  the Action FSM (CREATING->ACTIVE via the log manager), so a failure at any
  point leaves the prior ACTIVE entry untouched and a retry re-runs the same
  diff; once a refresh commits, the retry sees no drift and raises
  ``NoChangesException`` — surfaced here as the ``no-changes`` outcome;
- commits publish on the session's :class:`InvalidationBus` (via the caching
  manager), which is what makes the new version visible to serving.

Every attempt lands in ``hs_lifecycle_refresh_total{mode,outcome}``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from hyperspace_tpu_torch.check.locks import named_lock


class DriftStats:
    """Appended/deleted drift of one index vs its current source files."""

    __slots__ = (
        "index_name",
        "appended_files",
        "deleted_files",
        "appended_bytes",
        "deleted_bytes",
        "appended_ratio",
        "deleted_ratio",
    )

    def __init__(self, index_name, appended_files, deleted_files,
                 appended_bytes, deleted_bytes, appended_ratio, deleted_ratio):
        self.index_name = index_name
        self.appended_files = appended_files
        self.deleted_files = deleted_files
        self.appended_bytes = appended_bytes
        self.deleted_bytes = deleted_bytes
        self.appended_ratio = appended_ratio
        self.deleted_ratio = deleted_ratio

    @property
    def has_drift(self) -> bool:
        return bool(self.appended_files or self.deleted_files)

    def __repr__(self) -> str:
        return (
            f"DriftStats({self.index_name!r}, +{self.appended_files}f/"
            f"{self.appended_bytes}B ({self.appended_ratio:.3f}), "
            f"-{self.deleted_files}f/{self.deleted_bytes}B ({self.deleted_ratio:.3f}))"
        )


def _count_refresh(mode: str, outcome: str) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_lifecycle_refresh_total",
        "refresh attempts by the lifecycle refresh manager",
        mode=mode,
        outcome=outcome,
    ).inc()


class RefreshManager:
    """Poll-loop controller; ``poll_once()`` is the deterministic unit tests
    drive directly, ``start()``/``stop()`` wrap it in a daemon thread."""

    def __init__(self, session, interval_seconds: Optional[float] = None):
        self._session = session
        self._interval = interval_seconds
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._index_locks: Dict[str, threading.Lock] = {}
        self._guard = named_lock("lifecycle.refreshManager")

    # -- lifecycle -----------------------------------------------------------
    @property
    def interval_seconds(self) -> float:
        if self._interval is not None:
            return float(self._interval)
        return self._session.conf.lifecycle_refresh_interval_seconds

    def start(self) -> None:
        with self._guard:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop_event.clear()
            self._thread = threading.Thread(
                target=self._run, name="hs-refresh-manager", daemon=True
            )
            self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        with self._guard:
            thread = self._thread
            self._thread = None
        self._stop_event.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout)

    def _run(self) -> None:
        while not self._stop_event.is_set():
            try:
                self.poll_once()
            except Exception:  # pragma: no cover - the loop must survive
                pass
            self._stop_event.wait(self.interval_seconds)

    # -- drift + decision ----------------------------------------------------
    def drift(self, entry) -> Optional[DriftStats]:
        """Re-list the index's source and diff against what it indexed —
        the refresh-action preamble, run read-only. None when the source
        cannot be re-listed (dropped table, unreadable path)."""
        try:
            metadata = self._session.provider_manager.create_relation_metadata(entry.relation)
            relation = metadata.to_relation_object()
            current = {fi.key: fi for fi in relation.all_file_infos()}
        except Exception:
            return None
        indexed = {fi.key: fi for fi in entry.source_file_infos()}
        appended = [current[k] for k in current.keys() - indexed.keys()]
        deleted = [indexed[k] for k in indexed.keys() - current.keys()]
        appended_bytes = sum(fi.size for fi in appended)
        deleted_bytes = sum(fi.size for fi in deleted)
        # ratio denominators match rules/candidate._signature_filter so the
        # manager's incremental trigger fires exactly when the candidate gate
        # would start rejecting hybrid scan
        total_bytes = sum(fi.size for fi in current.values())
        return DriftStats(
            index_name=entry.name,
            appended_files=len(appended),
            deleted_files=len(deleted),
            appended_bytes=appended_bytes,
            deleted_bytes=deleted_bytes,
            appended_ratio=appended_bytes / max(1, total_bytes),
            deleted_ratio=deleted_bytes / max(1, entry.source_files_size()),
        )

    def decide(self, drift: Optional[DriftStats]) -> Optional[str]:
        """Refresh mode for this drift, or None for no action.

        ``hyperspace.lifecycle.refresh.mode`` pins the mode; the default
        ``auto`` picks incremental when drift exceeds either hybrid-scan
        threshold (the candidate gate is about to reject the index) and a
        metadata-only quick refresh otherwise.
        """
        from hyperspace_tpu_torch import config as C

        if drift is None or not drift.has_drift:
            return None
        conf = self._session.conf
        mode = conf.lifecycle_refresh_mode
        if mode != "auto":
            return mode if mode in C.REFRESH_MODES else None
        over = (
            drift.appended_ratio > conf.hybrid_scan_appended_ratio_threshold
            or drift.deleted_ratio > conf.hybrid_scan_deleted_ratio_threshold
        )
        return C.REFRESH_MODE_INCREMENTAL if over else C.REFRESH_MODE_QUICK

    # -- execution -----------------------------------------------------------
    def _lock_for(self, name: str) -> threading.Lock:
        with self._guard:
            lock = self._index_locks.get(name)
            if lock is None:
                lock = self._index_locks[name] = threading.Lock()
            return lock

    def _acquire_lake_lease(self, name: str):
        """The cross-process half of single-writer: a lake-persisted lease
        per index (``fabric/lease.py``) when the fabric + lease conf is on.
        Returns ``(lease, acquired)`` — ``(None, True)`` means leases are
        off and the in-process lock alone governs, as before."""
        conf = self._session.conf
        if not (conf.fabric_enabled and conf.fabric_lease_enabled and conf.system_path):
            return None, True
        from hyperspace_tpu_torch.fabric import lease as lease_mod
        from hyperspace_tpu_torch.fabric.records import local_node_id

        lease = lease_mod.acquire(
            conf.system_path,
            f"refresh/{name}",
            holder=local_node_id(conf),
            ttl_s=conf.fabric_lease_ttl_seconds,
        )
        if lease is None:
            return None, False
        lease.start_heartbeat(conf.fabric_lease_renew_interval_seconds)
        return lease, True

    def refresh_index(self, name: str, mode: str) -> str:
        """Run one refresh under the per-index single-writer lock (plus the
        lake lease when ``hyperspace.fabric.lease.enabled``); returns the
        outcome: committed | no-changes | busy | fenced | error."""
        from hyperspace_tpu_torch.actions.base import NoChangesException

        lock = self._lock_for(name)
        if not lock.acquire(blocking=False):
            _count_refresh(mode, "busy")
            return "busy"
        lease = None
        try:
            lease, acquired = self._acquire_lake_lease(name)
            if not acquired:
                # a peer process holds the lease: same convergence story as
                # the in-process lock — skip, the next poll re-checks drift
                outcome = "busy"
            else:
                try:
                    if lease is not None:
                        from hyperspace_tpu_torch.fabric.lease import fence_scope

                        with fence_scope(lease):
                            self._session.index_manager.refresh(name, mode)
                    else:
                        self._session.index_manager.refresh(name, mode)
                    outcome = "committed"
                except NoChangesException:
                    # the drift we saw was committed by someone else (or a
                    # retried refresh already landed) — converged
                    outcome = "no-changes"
                except Exception as exc:
                    from hyperspace_tpu_torch.fabric.lease import LeaseLostError

                    # the Action FSM guarantees the prior ACTIVE entry still
                    # serves; the next poll retries the same diff. A fenced
                    # commit means a peer took over — also converged, but
                    # surfaced distinctly (the zombie-writer signature).
                    outcome = "fenced" if isinstance(exc, LeaseLostError) else "error"
        finally:
            if lease is not None:
                lease.release()
            lock.release()
        _count_refresh(mode, outcome)
        return outcome

    def poll_once(self) -> List[dict]:
        """One scheduling pass over every ACTIVE index; returns what was
        decided/done per index (tests assert on this)."""
        from hyperspace_tpu_torch.models import states

        results: List[dict] = []
        try:
            entries = self._session.index_manager.get_indexes([states.ACTIVE])
        except Exception:
            return results
        for entry in entries:
            drift = self.drift(entry)
            mode = self.decide(drift)
            if mode is None:
                results.append({"index": entry.name, "mode": None, "outcome": "fresh"})
                continue
            outcome = self.refresh_index(entry.name, mode)
            results.append({"index": entry.name, "mode": mode, "outcome": outcome})
        return results
