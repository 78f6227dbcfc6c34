"""Small caching helpers.

``TTLCache`` backs the caching index collection manager (ref: HS/index/CachingIndexCollectionManager.scala:127-173).
"""

from __future__ import annotations

import time
from typing import Callable, Generic, Optional, Tuple, TypeVar

T = TypeVar("T")


class TTLCache(Generic[T]):
    """Single-entry cache with creation-time-based expiry; the lifetime is
    read on every lookup."""

    def __init__(self, expiry_seconds_fn: Callable[[], float]):
        self._expiry_seconds_fn = expiry_seconds_fn
        self._entry: Optional[Tuple[float, T]] = None

    def get(self) -> Optional[T]:
        if self._entry is None:
            return None
        created, value = self._entry
        if time.time() - created > self._expiry_seconds_fn():
            self._entry = None
            return None
        return value

    def set(self, value: T) -> None:
        self._entry = (time.time(), value)

    def clear(self) -> None:
        self._entry = None
