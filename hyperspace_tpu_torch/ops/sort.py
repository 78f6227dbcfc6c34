"""On-device bucketed sort — the index-build hot path.

Replaces the shuffle + per-partition sort of Spark's bucketed write
(``repartition(numBuckets, cols).sortWithinPartitions``;
ref: HS/index/covering/CoveringIndex.scala:54-69,
HS/index/DataFrameWriterExtensions.scala:50-68) with one device pass per
chunk:

  device hash -> bucket ids -> lexicographic sort over (bucket, key...,
  row index) -> permutation + per-bucket counts (the hand-written histogram
  kernel, ops/kernels.bucket_histogram)

Design notes:
  - torch has no multi-operand sort, so the order is a chain of stable
    sorts from the least significant key up; the row index is the implicit
    last key (stable sorts keep it), so the order is total and the
    permutation equals the JAX package's ``lax.sort`` one exactly;
  - keys compare SIGNED, as ``lax.sort`` compares them: the float key of
    ops/encode.sort_key_int64 is order-preserving only unsigned, so within a
    bucket positive floats come before negative ones, exactly as in the JAX
    build (both packages change together or not at all);
  - hash inputs for numeric/date columns are reconstructed ON DEVICE from
    the order keys (bit-exact vs the host ``numeric_hash32``), so only the
    key planes ride host->device; strings ship a host hash plane.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from hyperspace_tpu_torch.ops.hashing import bucket_ids_torch
from hyperspace_tpu_torch.ops.kernels import bucket_histogram

_I64_SIGN = -0x8000000000000000


def lex_argsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Argsort by ``keys[0]`` then ``keys[1]`` ... (most-significant first),
    ties broken by row index: stable sorts from the last key to the first."""
    perm = None
    for key in reversed(list(keys)):
        k = key if perm is None else key[perm]
        order = torch.sort(k, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def _device_hash32(kind: str, key: torch.Tensor) -> torch.Tensor:
    """Reconstruct the column's uint32 hash input (in an int64 tensor) from
    its order key — bit-exact vs the host ``hashing.numeric_hash32`` on the
    original values, INCLUDING its int/float value normalization (an
    integral float hashes as its int64 value; -0.0 as +0.0; NaN
    canonically)."""
    v64 = key.to(torch.int64)
    if kind == "f":
        # invert the order-preserving transform back to the raw f64 bits
        raw = torch.where(v64 < 0, v64 ^ _I64_SIGN, ~v64)
        f = raw.view(torch.float64) + 0.0  # -0.0 -> +0.0
        isint = torch.isfinite(f) & (f.abs() < 2.0**63) & (f == torch.floor(f))
        int_bits = torch.where(isint, f, 0.0).to(torch.int64)
        f_norm = torch.where(torch.isnan(f), float("nan"), f)
        bits = torch.where(isint, int_bits, f_norm.view(torch.int64))
    else:  # i / u / b / M — the key IS the value (or its int64 view)
        bits = v64
    # low 32 bits of bits ^ (bits >>> 32): the arithmetic shift leaves the
    # same low 32 bits as the logical one
    return (bits ^ (bits >> 32)) & 0xFFFFFFFF


def bucket_sort_build(
    keys: Sequence[torch.Tensor],
    host_hashes: Sequence[torch.Tensor],
    kinds: Tuple[str, ...],
    num_buckets: int,
    n_valid: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device pass of an index build.

    Args:
      keys: per-key-column 1-D device tensors (int32 or int64 order keys),
        all the same length.
      host_hashes: hash-input planes (int32 views of uint32) for the
        ``kinds == 's'`` columns, in order of appearance.
      kinds: per-column dtype kind characters (``i u b M f s``).
      num_buckets: bucket count.
      n_valid: rows past ``n_valid`` are padding: they take the sentinel
        bucket ``num_buckets``, sort after every real row and count nowhere.

    Returns:
      (perm, counts) device tensors: int32 permutation (valid rows occupy
      positions [0, n_valid)) and int32 rows-per-bucket.
    """
    hash_cols = []
    hidx = 0
    for kind, key in zip(kinds, keys):
        if kind == "s":
            hash_cols.append(host_hashes[hidx])
            hidx += 1
        else:
            hash_cols.append(_device_hash32(kind, key))
    buckets = bucket_ids_torch(hash_cols, num_buckets)
    n = buckets.shape[0]
    if n_valid < n:
        pad = torch.arange(n, device=buckets.device) >= n_valid
        buckets = buckets.masked_fill(pad, num_buckets)
    perm = lex_argsort([buckets, *keys])
    counts = bucket_histogram(buckets[perm], num_buckets)
    return perm.to(torch.int32), counts


def padded_size(n: int) -> int:
    """Power-of-two size class for ``n`` rows (min 8): the size the JAX
    package's device programs pad to, which its cost estimates use."""
    return max(8, 1 << (max(n - 1, 1)).bit_length())
