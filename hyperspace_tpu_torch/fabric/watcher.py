"""CommitWatcher: tail peer commit records and replay them locally.

The watcher is the read half of log-driven coherence: every poll it sweeps
``<system.path>/<index>/_hyperspace_log/_commits/`` for records it has not
replayed, skips its own (``origin`` == local node id — a process must not
re-purge for its own publish), and replays the rest onto the session's
:class:`InvalidationBus`. Replay runs the exact invalidation path a local
commit runs — roster TTL clear, targeted bucket/IO/device byte-cache
purges, subscriber fan-out — and advances the local commit sequence to the
record's persisted sequence, so brand rotation and session tokens change in
this process within one poll interval of the remote commit.

Cost model: the steady-state poll is one ``stat`` per index commit
directory (the mtime fast-path); records are listed and read only when a
directory actually changed. A directory whose mtime is within
``_MTIME_SETTLE_S`` of now is always re-listed — directory mtime
granularity is coarse enough that two records landing in one tick around a
poll could otherwise leave the second invisible until the next commit.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Dict, Optional

from hyperspace_tpu_torch.fabric import records
from hyperspace_tpu_torch.lifecycle.invalidation import CommitEvent

__all__ = ["CommitWatcher"]

#: re-list a commit dir whose mtime is this recent even if unchanged
_MTIME_SETTLE_S = 2.0


def _registry():
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    return REGISTRY


class CommitWatcher:
    """Poll-driven replay of peer commit records (one per session).

    ``poll_once`` is the deterministic unit tests drive directly; ``start``
    runs it on a daemon thread every ``interval`` seconds. The watcher holds
    only a weakref to its session: a dropped session ends the thread on its
    next wakeup instead of leaking through the poll loop.
    """

    def __init__(
        self,
        session,
        node_id: Optional[str] = None,
        interval: Optional[float] = None,
    ):
        self._session_ref = weakref.ref(session)
        self.node_id = node_id or records.local_node_id(session.conf)
        self.interval = float(
            session.conf.fabric_poll_interval_seconds if interval is None else interval
        )
        self._cursors: Dict[str, int] = {}  # index name -> last replayed record id
        self._mtimes: Dict[str, int] = {}  # commits dir -> st_mtime_ns at last list
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # per-node staleness observability (docs/scale-out.md): how long ago
        # this node's watcher finished a sweep, and how far behind the log it
        # was when it did — together they bound observable staleness against
        # the configured poll interval. -1 = never polled.
        self._last_poll_at: Optional[float] = None
        reg = _registry()
        # a stable unixtime, NOT a live age: re-rendering the exposition
        # must be byte-identical between sweeps (the /metrics endpoint
        # contract); scrapers compute age as time() - value
        reg.gauge(
            "hs_fabric_watcher_last_poll_seconds",
            "unixtime at which this node's commit watcher completed its "
            "latest poll sweep (-1 before the first sweep)",
            fn=lambda: (
                -1.0 if self._last_poll_at is None else self._last_poll_at
            ),
            server=self.node_id,
        )

    # -- polling -------------------------------------------------------------
    def poll_once(self) -> int:
        """One sweep over every index's commit directory; returns the number
        of remote records replayed."""
        session = self._session_ref()
        if session is None:
            return 0
        root = session.conf.system_path
        if not root or not os.path.isdir(root):
            return 0
        reg = _registry()
        reg.counter("hs_fabric_polls_total", "commit-watcher poll sweeps").inc()
        replayed = 0
        newest_ts: Optional[float] = None
        for name in sorted(os.listdir(root)):
            if name.startswith((".", "_")):
                continue
            cdir = records.commits_dir(root, name)
            try:
                st = os.stat(cdir)
            except OSError:
                continue  # index without commit records (or gone)
            settled = (time.time() - st.st_mtime) > _MTIME_SETTLE_S
            if self._mtimes.get(cdir) == st.st_mtime_ns and settled:
                reg.counter(
                    "hs_fabric_poll_skips_total",
                    "commit directories skipped by the mtime fast-path",
                ).inc()
                continue
            self._mtimes[cdir] = st.st_mtime_ns
            cursor = self._cursors.get(name, -1)
            for rid, rec in records.read_commit_records(cdir, after_id=cursor):
                self._cursors[name] = rid
                if rec.get("origin") == self.node_id:
                    # our own publish already purged these caches
                    reg.counter(
                        "hs_fabric_self_skips_total",
                        "own commit records skipped by the watcher (dedupe)",
                    ).inc()
                    continue
                event = CommitEvent(
                    rec.get("index", name),
                    rec.get("logId"),
                    rec.get("kind", "remote"),
                    rec.get("affectedFiles") or (),
                    origin=rec.get("origin"),
                )
                session.lifecycle_bus.replay(event, seq=rec.get("seq"))
                ts = rec.get("ts")
                if ts is not None:
                    reg.gauge(
                        "hs_fabric_replay_lag_seconds",
                        "commit-to-replay lag of the most recent replayed record",
                    ).set(max(0.0, time.time() - float(ts)))
                    if newest_ts is None or float(ts) > newest_ts:
                        newest_ts = float(ts)
                replayed += 1
        # per-node commit lag: distance between remote publish and this
        # sweep's replay. A sweep that found nothing to replay means this
        # node is caught up with every record it can see — lag 0, which is
        # what makes the gauge a staleness BOUND rather than a last-event
        # memory (docs/scale-out.md).
        reg.gauge(
            "hs_fabric_commit_lag_seconds",
            "publish-to-replay lag of this node against the commit log "
            "(0 when the last sweep found nothing left to replay)",
            server=self.node_id,
        ).set(
            max(0.0, time.time() - newest_ts) if newest_ts is not None else 0.0
        )
        self._last_poll_at = time.time()
        return replayed

    # -- thread lifecycle ----------------------------------------------------
    def start(self) -> "CommitWatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="hs-fabric-watcher", daemon=True
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
                self.poll_once()
            except Exception:  # pragma: no cover — a bad poll must not kill the loop
                pass
