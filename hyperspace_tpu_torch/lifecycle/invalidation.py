"""Commit/invalidation bus: one place where freshness propagates.

Every successful index mutation (refresh, optimize, create, delete, restore,
vacuum) publishes exactly one :class:`CommitEvent` to the session's
:class:`InvalidationBus`. The bus then does the freshness work that PRs 1-9
left to ad-hoc per-cache discipline:

- bumps the monotonic **commit sequence** — the number snapshot pins record
  so the soak test can assert linearizable visibility (a request admitted
  after commit k pins seq >= k);
- clears the **roster TTL cache** (``CachingIndexCollectionManager``) so the
  next admitted request pins the new log version immediately instead of up
  to ``cache_expiry_seconds`` later;
- **targeted-purges** the bucket-prefetch, IO batch, and device column
  caches for the files the commit touched (old index data files + deleted
  source files), counted per cache in
  ``hs_lifecycle_invalidations_total{cache=...}``;
- notifies subscribers (the refresh manager, tests).

The result cache and join-build cache are *brand-rotated* rather than
purged here: their keys fold in ``data_version_brand`` / the roster brand,
which changes as soon as the roster cache is cleared, and both caches purge
stale brands on first observation of a new one (counted in their own
``hs_*_cache_invalidations_total`` counters). The bus's job for those two is
simply making the new brand visible immediately.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from hyperspace_tpu_torch.check.locks import named_lock


class CommitEvent:
    """One committed index mutation.

    ``affected_files`` carries every file path whose cached derivatives are
    stale after this commit: the *previous* entry's index data files (their
    content was rewritten or superseded) plus any source files the commit
    deleted from coverage.

    ``origin`` is the fabric node id of the publishing process (None for a
    plain single-process publish): the commit record persists it so a
    CommitWatcher in the publishing process can recognize — and skip — its
    own commits instead of re-purging caches it already purged.
    """

    __slots__ = ("index_name", "log_id", "kind", "affected_files", "origin")

    def __init__(
        self,
        index_name: str,
        log_id: Optional[int],
        kind: str,
        affected_files: Sequence[str] = (),
        origin: Optional[str] = None,
    ):
        self.index_name = str(index_name)
        self.log_id = log_id
        self.kind = str(kind)  # refresh-incremental | refresh-quick | create | ...
        self.affected_files: Tuple[str, ...] = tuple(affected_files)
        self.origin = origin

    def __repr__(self) -> str:
        return (
            f"CommitEvent({self.index_name!r}, id={self.log_id}, kind={self.kind!r}, "
            f"files={len(self.affected_files)})"
        )


def _count_commit() -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_lifecycle_commits_total",
        "index mutations published on the lifecycle commit bus",
    ).inc()


def _count_replay(kind: str) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_fabric_records_replayed_total",
        "remote commit records replayed onto the local invalidation bus",
        kind=kind,
    ).inc()


def _count_invalidations(cache: str, n: int) -> None:
    if n <= 0:
        return
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_lifecycle_invalidations_total",
        "cache entries purged by commit-driven invalidation",
        cache=cache,
    ).inc(n)


class InvalidationBus:
    """Session-scoped commit fan-out (see module docstring).

    ``publish`` is safe to call with serving traffic in flight: in-flight
    requests hold a snapshot pin and keep resolving the old version; the
    purges only remove *cached bytes*, never data, so a pinned request that
    raced a purge simply re-reads from disk.
    """

    def __init__(self, session):
        self._session = session
        self._lock = named_lock("lifecycle.invalidationBus")
        self._seq = 0
        self._subscribers: List[Callable[[CommitEvent], None]] = []

    @property
    def commit_seq(self) -> int:
        """Monotonic count of commits published on this bus."""
        with self._lock:
            return self._seq

    # -- subscriptions -------------------------------------------------------
    def subscribe(self, fn: Callable[[CommitEvent], None]) -> None:
        with self._lock:
            if fn not in self._subscribers:
                self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[CommitEvent], None]) -> None:
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)

    # -- publication ---------------------------------------------------------
    def publish(self, event: CommitEvent) -> dict:
        """Publish one commit; returns per-cache purge counts (observability
        and test assertions — the same numbers land in
        ``hs_lifecycle_invalidations_total{cache}``).

        With the fabric on, the commit is also persisted as a numbered
        record under the index's log directory, stamped with this process's
        node id and the post-bump commit sequence, so peer processes replay
        it (see :meth:`replay` and ``hyperspace_tpu_torch/fabric/watcher.py``).
        """
        with self._lock:
            self._seq += 1
            seq = self._seq
            subscribers = list(self._subscribers)
        _count_commit()
        self._persist_record(event, seq)
        return self._apply(event, subscribers)

    def replay(self, event: CommitEvent, seq: Optional[int] = None) -> dict:
        """Apply a commit observed in the lake (published by *another*
        process) to this process's caches. Advances the local commit
        sequence to at least the record's persisted sequence — a Lamport
        merge, so all processes agree that event ordering never runs
        backwards — and never re-persists a record (no echo)."""
        with self._lock:
            if seq is not None and int(seq) > self._seq:
                self._seq = int(seq)
            else:
                # a record without a sequence still invalidates pins/tokens
                self._seq += 1
            subscribers = list(self._subscribers)
        _count_replay(event.kind)
        return self._apply(event, subscribers)

    def _persist_record(self, event: CommitEvent, seq: int) -> None:
        conf = getattr(self._session, "conf", None)
        if conf is None or not conf.fabric_enabled:
            return
        from hyperspace_tpu_torch.fabric import records

        if event.origin is None:
            event.origin = records.local_node_id(conf)
        records.append_commit_record(conf.system_path, event, seq)

    def _apply(self, event: CommitEvent, subscribers) -> dict:
        counts = {"roster": 0, "bucket": 0, "io": 0, "device": 0}

        # 1) roster freshness: without this, a post-commit request would pin
        #    a TTL-stale roster for up to cache_expiry_seconds — breaking the
        #    "admitted after commit k sees >= k" invariant outright.
        mgr = getattr(self._session, "_index_manager", None)
        if mgr is not None and hasattr(mgr, "clear_cache"):
            mgr.clear_cache()
            counts["roster"] = 1
        _count_invalidations("roster", counts["roster"])

        # 2) targeted purges of byte caches keyed (partly) by file path
        files = event.affected_files
        if files:
            bucket = getattr(self._session, "bucket_cache", None)
            if bucket is not None and hasattr(bucket, "purge_files"):
                counts["bucket"] = bucket.purge_files(files)
            _count_invalidations("bucket", counts["bucket"])

            from hyperspace_tpu_torch.exec.io import purge_io_cache

            counts["io"] = purge_io_cache(files)
            _count_invalidations("io", counts["io"])

            from hyperspace_tpu_torch.exec.device import purge_device_cache_files

            counts["device"] = purge_device_cache_files(files)
            _count_invalidations("device", counts["device"])

        # 3) fan out; a broken subscriber must not block the commit path
        for fn in subscribers:
            try:
                fn(event)
            except Exception:  # pragma: no cover - defensive
                pass
        return counts
