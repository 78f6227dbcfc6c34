"""Host-side column encoding for device consumption.

The device takes no variable-length types, so every key column is encoded to
dense numerics before it is uploaded:

  - ``hash_input``  — uint32 per row, feeds bucket hashing (ops/hashing.py)
  - ``sort_key``    — int64 per row whose ordering equals the column's natural
                      ordering (strings -> dictionary rank; floats -> an
                      order-preserving bit transform; ints/dates -> identity)
  - ``order_plane`` — signed int64 per row for one ORDER BY key of the
                      streaming top-k (NULLS LAST in both directions)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from hyperspace_tpu_torch.ops import hashing


def factorize_strings(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Null-aware string factorization — THE one implementation shared by
    build-time sort keys, bucket hashing, and query-time device encoding (so
    the three encodings can never diverge).

    Returns ``(codes, uniques, null_mask)``: ``codes`` is int64 ranks into the
    sorted ``uniques`` with -1 for nulls.
    """
    obj = arr.astype(object)
    null_mask = np.array([x is None for x in obj], dtype=bool)
    filled = np.where(null_mask, "", obj).astype(str)
    uniques, inverse = np.unique(filled, return_inverse=True)
    codes = inverse.astype(np.int64)
    codes[null_mask] = -1
    return codes, uniques, null_mask


def sort_key_int64(arr: np.ndarray) -> np.ndarray:
    """Order-preserving int64 key for any supported column dtype."""
    kind = arr.dtype.kind
    if kind in ("i", "u", "b"):
        return arr.astype(np.int64)
    if kind == "M":  # datetime64
        return arr.view("int64").astype(np.int64)
    if kind == "f":
        bits = arr.astype(np.float64).view(np.int64)
        # IEEE-754 total order: flip sign bit for positives, all bits for negatives
        return np.where(bits >= 0, bits ^ np.int64(-0x8000000000000000), ~bits)
    if kind in ("U", "S", "O"):
        codes, _, _ = factorize_strings(arr)  # nulls (-1) sort first
        return codes
    raise TypeError(f"Unsupported column dtype for sorting: {arr.dtype}")


_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min

#: rid/plane sentinel for padding rows in the top-k programs — sorts after
#: every real row (real planes are clipped below it, real rids are counts)
ORDER_PLANE_SENTINEL = _I64_MAX


def order_plane(arr: np.ndarray, asc: bool = True) -> np.ndarray:
    """Signed-comparison int64 order plane for ONE sort key column, matching
    the host ``Sort`` semantics (executor._key_codes): missing values
    (NaN/NaT/None) sort LAST in both directions, ``-0.0 == +0.0``, and the
    DESC plane is the negated ASC plane.

    This is deliberately NOT ``sort_key_int64``: that transform is
    order-preserving only under *unsigned* int64 comparison (its float branch
    maps positive floats below negative ones when compared signed), which is
    fine for the internally-consistent bucket layouts it feeds but wrong for
    ``lax.sort``'s signed total order. Here floats get the signed-safe
    transform (flip the magnitude bits of negatives), and every plane is
    clipped to ``[INT64_MIN+2, INT64_MAX-2]`` so DESC negation cannot
    overflow and ``INT64_MAX`` stays reserved for missing/padding. String
    planes are dense ranks over THIS array only — callers merging candidate
    sets across chunks must re-encode over the combined values
    (TopKStream handles this like GroupedAggStream._remap_string_key).
    """
    kind = arr.dtype.kind
    n = arr.shape[0]
    if kind in ("i", "b"):
        v = arr.astype(np.int64)
        missing = np.zeros(n, dtype=bool)
    elif kind == "u":
        v = np.minimum(arr, np.uint64(_I64_MAX - 2)).astype(np.int64)
        missing = np.zeros(n, dtype=bool)
    elif kind == "M":
        missing = np.isnat(arr)
        v = arr.view("int64").astype(np.int64)
    elif kind == "f":
        f = arr.astype(np.float64)
        missing = np.isnan(f)
        # collapse -0.0/+0.0 (np.unique ranks them equal) and park NaNs on a
        # fixed value before the bit transform (masked to MAX below anyway)
        f = np.where(missing | (f == 0.0), np.float64(0.0), f)
        bits = f.view(np.int64)
        v = np.where(bits >= 0, bits, bits ^ np.int64(_I64_MAX))
    elif kind in ("U", "S", "O"):
        obj = arr.astype(object)
        # same missing definition as the host sort path (None or float NaN)
        missing = np.array(
            [x is None or (isinstance(x, float) and x != x) for x in obj], dtype=bool
        )
        filled = np.where(missing, "", obj).astype(str)
        _, inverse = np.unique(filled, return_inverse=True)
        v = inverse.astype(np.int64)
    else:
        raise TypeError(f"Unsupported column dtype for ordering: {arr.dtype}")
    v = np.clip(v, _I64_MIN + 2, _I64_MAX - 2)
    if not asc:
        v = -v
    v[missing] = _I64_MAX
    return v


def hash_input_uint32(arr: np.ndarray) -> np.ndarray:
    """uint32 bucket-hash input for any supported column dtype."""
    if arr.dtype.kind in ("U", "S", "O"):
        return hashing.string_hash32_array(arr)
    return hashing.numeric_hash32(arr)


def encode_sort_columns(columns):
    """Per-column encoding for the fused build program (ops/sort.bucket_sort_build).

    Returns ``(keys, kinds, host_hashes)``:
      - ``keys``: one 1-D order key per column; int/date/bool columns whose
        values fit int32 are downcast (half the bytes to upload and sort) —
        safe because the device widens back to the exact int64 value before
        hashing; string codes are always int32.
      - ``kinds``: dtype kind per column (``'s'`` for strings).
      - ``host_hashes``: uint32 hash planes for the string columns only —
        every other kind's hash input is reconstructed on device.
    """
    keys, kinds, host_hashes = [], [], []
    for c in columns:
        kind = c.dtype.kind
        if kind in ("U", "S", "O"):
            codes, _, _ = factorize_strings(c)
            keys.append(codes.astype(np.int32))
            kinds.append("s")
            host_hashes.append(hash_input_uint32(c))
            continue
        k = sort_key_int64(c)
        if kind != "f" and k.size and -(2**31) <= int(k.min()) and int(k.max()) < 2**31:
            k = k.astype(np.int32)
        keys.append(k)
        kinds.append(kind if kind in "iubMf" else "i")
    return keys, tuple(kinds), host_hashes
