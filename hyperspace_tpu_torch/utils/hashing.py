"""Hashing helpers (ref: HS/util/HashingUtils.scala:24-34 — md5Hex)."""

from __future__ import annotations

import hashlib
from typing import Any


def md5_hex(text: Any) -> str:
    return hashlib.md5(str(text).encode("utf-8")).hexdigest()
