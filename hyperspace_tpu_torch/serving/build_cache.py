"""Shared join build sides: version-branded hash tables under serving.

Micro-batched requests joining against the same dimension table should pay
ONE device hash-table build, not one per request. This cache keys built
broadcast sides (``exec/join_stream.BuildSide``) by (build-plan identity,
data-version brand) in a byte-budgeted LRU next to ``bucket_cache.py``.

Staleness follows ``result_cache.py``'s discipline exactly: the brand is
:func:`~hyperspace_tpu_torch.serving.result_cache.version_brand` over the build
plan, computed by the caller per lookup, and the first observation of a new
brand for a structure purges the structure's stale-version entries wholesale
(counted in ``hs_join_build_cache_invalidations_total``). An unsignable
build plan gets no brand and bypasses the cache — a stale build side is
never an option.

The builder runs OUTSIDE the cache lock: a build executes a whole plan
(scan locks, device compiles), and holding ``serving.joinBuildCache``
across that would pin a broad lock order. Two racing requests may both
build; the second put wins harmlessly — the same tolerance the bucket
cache extends to racing prefetches.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Tuple

from hyperspace_tpu_torch.check.locks import named_lock


# metric names are literal at each call site so the hscheck metric-families
# drift rule can match them against docs/observability.md


def _count_hit() -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_join_build_cache_hits_total",
        "broadcast-join build sides served from the shared cache",
    ).inc()


def _count_miss() -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_join_build_cache_misses_total",
        "broadcast-join build sides built because the shared cache missed",
    ).inc()


def _count_invalidations(n: int) -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_join_build_cache_invalidations_total",
        "build sides purged because a new data-version brand was observed",
    ).inc(n)


class _Entry:
    __slots__ = ("value", "nbytes", "structure", "brand")

    def __init__(self, value, nbytes: int, structure, brand: str):
        self.value = value
        self.nbytes = int(nbytes)
        self.structure = structure
        self.brand = brand


class JoinBuildCache:
    """Byte-budgeted LRU of built join build sides with brand invalidation."""

    def __init__(self, max_bytes: int = 256 * 1024 * 1024):
        self.max_bytes = int(max_bytes)
        self._lock = named_lock("serving.joinBuildCache")
        self._entries: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        # structure -> {brand -> [keys]}: a new brand purges the structure's
        # entries under every other (stale) brand
        self._by_struct: Dict[object, Dict[str, List[Tuple]]] = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0

    def get_or_build(
        self,
        structure,
        brand: str,
        builder: Callable[[], object],
        weigh: Callable[[object], int],
    ):
        """The cached build side for (structure, brand), or ``builder()``'s
        result, cached. ``weigh`` prices a freshly built value in bytes."""
        key = (structure, brand)
        with self._lock:
            self._note_brand_locked(structure, brand)
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        if entry is not None:
            _count_hit()
            return entry.value
        _count_miss()
        value = builder()
        nbytes = int(weigh(value))
        if nbytes > self.max_bytes:
            return value  # over budget: serve it, don't cache it
        entry = _Entry(value, nbytes, structure, brand)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old.nbytes
            self._entries[key] = entry
            self.bytes += nbytes
            keys = self._by_struct.setdefault(structure, {}).setdefault(brand, [])
            if key not in keys:
                keys.append(key)
            while self.bytes > self.max_bytes and self._entries:
                k, e = self._entries.popitem(last=False)
                self.bytes -= e.nbytes
                self.evictions += 1
                self._unindex_locked(k, e)
        return value

    # -- invalidation --------------------------------------------------------
    def _note_brand_locked(self, structure, brand: str) -> None:
        brands = self._by_struct.get(structure)
        if not brands:
            return
        stale = [b for b in brands if b != brand]
        purged = 0
        for b in stale:
            for k in brands.pop(b):
                e = self._entries.pop(k, None)
                if e is not None:
                    self.bytes -= e.nbytes
                    purged += 1
        if purged:
            self.invalidations += purged
            _count_invalidations(purged)

    def _unindex_locked(self, key: Tuple, entry: _Entry) -> None:
        brands = self._by_struct.get(entry.structure)
        if brands is not None:
            keys = brands.get(entry.brand)
            if keys is not None and key in keys:
                keys.remove(key)

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._by_struct.clear()
            self.bytes = 0
            return n

    # -- observability -------------------------------------------------------
    def bind_registry(self, registry, **labels) -> None:
        registry.gauge(
            "hs_join_build_cache_bytes", "bytes resident in the join build cache",
            fn=lambda: self.bytes, **labels,
        )
        registry.gauge(
            "hs_join_build_cache_entries", "build sides resident in the join build cache",
            fn=self.__len__, **labels,
        )

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "capBytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
                "hitRate": (self.hits / total) if total else 0.0,
            }
