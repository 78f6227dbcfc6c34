"""Byte-capped LRU used by the scan and device caches.

One policy implementation shared by the host batch cache (exec/io.py) and the
device column cache (exec/device.py): get() refreshes recency, put() overwrites
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

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            got = self._entries.get(key)
            if got is None:
                return None
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

    def keys(self):
        with self._lock:
            return list(self._entries.keys())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
