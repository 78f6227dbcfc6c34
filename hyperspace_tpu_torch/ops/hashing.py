"""Bucket hashing — identical on host (numpy) and device (torch).

The bucket assignment ``bucket = mix(key columns) % num_buckets`` must agree
between index build, query-time bucket pruning (hash the filter literal), and
hybrid-scan re-bucketing of appended rows — these are three call sites of one
function, so both backends share the same 32-bit finalizer arithmetic.

Plays the role of Spark's ``HashPartitioning`` over bucket columns
(ref: HS/index/covering/CoveringIndex.scala:54-69 repartition;
HS/index/covering/CoveringIndexRuleUtils.scala:357-417 on-the-fly re-bucketing).
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np
import torch

_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_SEED = np.uint32(0x9747B28C)


def _mix32_np(h):
    h = h ^ (h >> np.uint32(16))
    h = h * _C1
    h = h ^ (h >> np.uint32(13))
    h = h * _C2
    h = h ^ (h >> np.uint32(16))
    return h


def combine_hashes_np(cols: Sequence[np.ndarray]) -> np.ndarray:
    """Combine per-column uint32 hash inputs into one row hash."""
    with np.errstate(over="ignore"):
        h = np.full(cols[0].shape, _SEED, dtype=np.uint32)
        for i, c in enumerate(cols):
            h = _mix32_np(h ^ _mix32_np(c.astype(np.uint32) + np.uint32((i * 0x9E3779B9) & 0xFFFFFFFF)))
        return h


def bucket_ids_np(hash_inputs: Sequence[np.ndarray], num_buckets: int) -> np.ndarray:
    return (combine_hashes_np(hash_inputs) % np.uint32(num_buckets)).astype(np.int32)


# Device half. Torch has no full uint32 op set, so the 32-bit lanes live in
# int64 tensors holding values in [0, 2**32): products are formed from 16-bit
# halves of the constant so no intermediate leaves int64 range, and every
# result is masked back to 32 bits. Bit-exact against the numpy half.
_M32 = 0xFFFFFFFF


def _mul32_torch(h, c: int):
    """``(h * c) mod 2**32`` for int64 ``h`` in [0, 2**32) and a 32-bit
    constant ``c``; each partial product stays below 2**49."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32_torch(h):
    h = h ^ (h >> 16)
    h = _mul32_torch(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32_torch(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def combine_hashes_torch(cols):
    """Device twin of ``combine_hashes_np``: ``cols`` are int tensors whose
    low 32 bits are the uint32 hash inputs; returns int64 in [0, 2**32)."""
    h = torch.full(cols[0].shape, 0x9747B28C, dtype=torch.int64, device=cols[0].device)
    for i, c in enumerate(cols):
        c = (c.to(torch.int64) + ((i * 0x9E3779B9) & _M32)) & _M32
        h = _mix32_torch(h ^ _mix32_torch(c))
    return h


def bucket_ids_torch(hash_inputs, num_buckets: int):
    return (combine_hashes_torch(hash_inputs) % num_buckets).to(torch.int32)


def string_hash32(value: str) -> np.uint32:
    """Stable 32-bit hash input for a string value (md5-derived; the per-row
    hash then mixes it like any numeric input)."""
    digest = hashlib.md5(str(value).encode("utf-8")).digest()
    return np.uint32(int.from_bytes(digest[:4], "little"))


_NULL_STRING_SENTINEL = "\x00__hs_null__"


def string_hash32_array(values: np.ndarray) -> np.ndarray:
    """Vectorized over uniques: factorize, hash each unique once, gather.
    Nulls hash via a fixed sentinel so build-time and query-time bucket
    assignment agree."""
    from hyperspace_tpu_torch.ops.encode import factorize_strings

    codes, uniques, null_mask = factorize_strings(values)
    table = np.array([string_hash32(u) for u in uniques], dtype=np.uint32)
    out = np.where(null_mask, string_hash32(_NULL_STRING_SENTINEL), table[np.clip(codes, 0, None)])
    return out.astype(np.uint32)


def numeric_hash32(arr: np.ndarray) -> np.ndarray:
    """uint32 hash input for numeric/datetime columns: fold the int64 bit
    pattern to 32 bits.

    VALUE-consistent across integer and float representations: a float that
    holds an integral value hashes as that int64 (3.0 hashes like 3), -0.0
    normalizes to +0.0, and NaN hashes via the canonical NaN pattern. This
    matters because a nullable int64 parquet column decodes as float64 —
    without normalization the SAME key value lands in different buckets on
    the two sides of a join (or between an int literal and the stored
    column), silently dropping matches. Mirrored bit-exactly on device in
    ops/sort._device_hash32."""
    if arr.dtype.kind == "f":
        with np.errstate(invalid="ignore"):
            v = arr.astype(np.float64) + 0.0  # -0.0 -> +0.0
            # < 2^63 strictly: every such integral float casts to int64
            # exactly (float64 granularity near 2^63 is 1024). Above 2^53
            # the FLOAT side has already rounded the value at decode, so
            # cross-representation consistency is inherently bounded by
            # float64 exactness — the guarantee here covers every integral
            # value float64 can represent.
            isint = np.isfinite(v) & (np.abs(v) < 2.0**63) & (v == np.floor(v))
            int_bits = np.where(isint, v, 0).astype(np.int64).view(np.uint64)
            f_norm = np.where(np.isnan(v), np.float64("nan"), v)
            bits = np.where(isint, int_bits, f_norm.view(np.uint64))
    elif arr.dtype.kind == "M":
        bits = arr.view("int64").astype(np.uint64)
    elif arr.dtype.kind == "b":
        bits = arr.astype(np.uint64)
    else:
        bits = arr.astype(np.int64).view(np.uint64)
    return ((bits ^ (bits >> np.uint64(32))) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def literal_hash32(value) -> np.uint32:
    """Hash input of a scalar literal — used for query-time bucket pruning
    (ref: FilterIndexRule useBucketSpec, HS/index/covering/FilterIndexRule.scala:162-167)."""
    if isinstance(value, str):
        return string_hash32(value)
    arr = np.asarray([value])
    return numeric_hash32(arr)[0]


def bucket_of_literals(values: List, num_buckets: int) -> int:
    """Bucket id for one composite key tuple (one value per bucket column)."""
    inputs = [np.asarray([literal_hash32(v)], dtype=np.uint32) for v in values]
    return int(bucket_ids_np(inputs, num_buckets)[0])
