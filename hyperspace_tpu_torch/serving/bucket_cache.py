"""Hot-bucket cache with asynchronous prefetch.

Covering-index buckets are immutable parquet files; under serving traffic the
same hot buckets are read by many requests. This cache keeps *decoded*
batches (file group + column set -> columnar batch) in a byte-budgeted LRU,
and prefetches groups it has just been told about on a small background pool
so the decode cost lands off the request path.

It layers above ``exec/io.py``'s per-file cache: the arrays stored here are
the same objects the io cache holds, so the marginal memory of an entry is
mostly the concat result, not a second copy of every column.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

from hyperspace_tpu_torch.utils.lru import BytesLRU

from hyperspace_tpu_torch.check.locks import named_lock


def _key(files: List[str], columns: Optional[List[str]]) -> Tuple:
    return (tuple(files), tuple(columns) if columns is not None else None)


class BucketCache:
    """Byte-capped LRU of decoded bucket batches + async prefetch."""

    def __init__(self, cap_bytes: int, prefetch_workers: int = 2):
        self._lru = BytesLRU(int(cap_bytes))
        self._prefetch_workers = int(prefetch_workers)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = named_lock("serving.bucketCache.pool")
        self._inflight = set()
        self._inflight_lock = named_lock("serving.bucketCache.inflight")
        self.prefetch_issued = 0
        self.prefetch_completed = 0

    # -- synchronous read path ----------------------------------------------
    def read(self, files: List[str], columns: Optional[List[str]]):
        """Decoded batch for ``files``/``columns`` — cached, or decoded now
        and cached. Returns a fresh dict; the arrays inside are shared and
        frozen (same contract as the io cache)."""
        from hyperspace_tpu_torch.exec.io import _batch_nbytes, read_parquet_batch

        k = _key(files, columns)
        got = self._lru.get(k)
        if got is not None:
            return dict(got)
        batch = read_parquet_batch(list(files), list(columns) if columns is not None else None)
        for a in batch.values():
            a.setflags(write=False)
        self._lru.put(k, dict(batch), _batch_nbytes(batch))
        return dict(batch)

    # -- async prefetch ------------------------------------------------------
    def prefetch(self, files: List[str], columns: Optional[List[str]]) -> bool:
        """Schedule a background decode if the group is neither cached nor
        already being fetched. Returns True when a fetch was issued."""
        k = _key(files, columns)
        if k in self._lru.keys():  # containment probe — keep hit/miss stats honest
            return False
        with self._inflight_lock:
            if k in self._inflight:
                return False
            self._inflight.add(k)

        def work():
            try:
                self.read(files, columns)
                self.prefetch_completed += 1
            except Exception:
                pass  # the request path will surface the real error
            finally:
                with self._inflight_lock:
                    self._inflight.discard(k)

        self.prefetch_issued += 1
        self._ensure_pool().submit(work)
        return True

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._prefetch_workers, thread_name_prefix="hs-prefetch"
                )
            return self._pool

    # -- lifecycle / stats ---------------------------------------------------
    def shutdown(self) -> None:
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None

    def clear(self) -> None:
        self._lru.clear()

    def purge_files(self, paths) -> int:
        """Drop every cached bucket group containing any of ``paths``
        (data-version commit invalidation); returns entries removed."""
        wanted = set(paths)
        if not wanted:
            return 0
        removed = 0
        for key in self._lru.keys():
            files = key[0]
            if any(f in wanted for f in files) and self._lru.discard(key):
                removed += 1
        return removed

    def bind_registry(self, registry, **labels) -> None:
        """Publish cache accounting as callback gauges (see
        ``AdmissionController.bind_registry`` for the equality rationale)."""
        registry.gauge("hs_bucket_cache_bytes", "decoded bytes resident", fn=lambda: self._lru.total_bytes, **labels)
        registry.gauge("hs_bucket_cache_hits", "bucket-cache hits", fn=lambda: self._lru.hits, **labels)
        registry.gauge("hs_bucket_cache_misses", "bucket-cache misses", fn=lambda: self._lru.misses, **labels)
        registry.gauge(
            "hs_bucket_cache_hit_rate", "hits / lookups",
            fn=lambda: self.stats()["hitRate"], **labels,
        )
        registry.gauge(
            "hs_bucket_cache_prefetch_issued", "prefetch tasks issued",
            fn=lambda: self.prefetch_issued, **labels,
        )
        registry.gauge(
            "hs_bucket_cache_prefetch_completed", "prefetch tasks completed",
            fn=lambda: self.prefetch_completed, **labels,
        )

    def stats(self) -> dict:
        total = self._lru.hits + self._lru.misses
        return {
            "bytes": self._lru.total_bytes,
            "capBytes": self._lru.cap,
            "hits": self._lru.hits,
            "misses": self._lru.misses,
            "evictions": self._lru.evictions,
            "hitRate": (self._lru.hits / total) if total else 0.0,
            "prefetchIssued": self.prefetch_issued,
            "prefetchCompleted": self.prefetch_completed,
        }
