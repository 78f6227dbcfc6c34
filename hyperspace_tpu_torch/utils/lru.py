"""Byte-capped LRU used by the scan/device caches.

One policy implementation shared by the host batch cache (exec/io.py) and the
HBM column cache (exec/device.py): get() refreshes recency, put() overwrites
existing keys (adjusting the byte count) and evicts least-recently-used
entries until the total fits the cap.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable, Optional


class BytesLRU:
    """Thread-safe: readers decode files concurrently (exec/io.py)."""

    def __init__(self, cap_bytes: int):
        self.cap = cap_bytes
        self._entries: "OrderedDict[Hashable, tuple]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        # observability for >cap working sets (benchmarks record these to
        # show byte-capped eviction actually engaging at scale)
        self.evictions = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def total_bytes(self) -> int:
        return self._bytes

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            got = self._entries.get(key)
            if got is None:
                self.misses += 1
                return None
            self.hits += 1
            self._entries.move_to_end(key)
            return got[0]

    def put(self, key: Hashable, value: Any, nbytes: int) -> None:
        if self.cap <= 0 or nbytes > self.cap:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            while self._bytes > self.cap and self._entries:
                _, (_, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
                self.evictions += 1

    def keys(self):
        with self._lock:
            return list(self._entries.keys())

    def discard(self, key: Hashable) -> bool:
        """Drop one entry if present (targeted invalidation on data-version
        commits); returns whether anything was removed."""
        with self._lock:
            got = self._entries.pop(key, None)
            if got is None:
                return False
            self._bytes -= got[1]
            return True

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
