"""Small caching helpers.

``TTLCache`` backs the caching index collection manager (ref: HS/index/CachingIndexCollectionManager.scala:127-173).
"""

from __future__ import annotations

import time
from typing import Generic, Optional, Tuple, TypeVar

T = TypeVar("T")


class TTLCache(Generic[T]):
    """Single-entry cache with creation-time-based expiry."""

    def __init__(self, expiry_seconds: float):
        self._expiry_seconds = expiry_seconds
        self._entry: Optional[Tuple[float, T]] = None

    def get(self) -> Optional[T]:
        if self._entry is None:
            return None
        created, value = self._entry
        if time.time() - created > self._expiry_seconds:
            self._entry = None
            return None
        return value

    def set(self, value: T) -> None:
        self._entry = (time.time(), value)

    def clear(self) -> None:
        self._entry = None
