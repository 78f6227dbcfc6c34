"""On-device sorts: the index build's bucketed sort and the top-k's select
and merge.

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

from hyperspace_tpu_torch.check import program_lint as _program_lint
from hyperspace_tpu_torch.ops.encode import ORDER_PLANE_SENTINEL
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


def bucket_sort_perm(hash_inputs: Sequence[torch.Tensor], sort_keys: Sequence[torch.Tensor], num_buckets: int):
    """Assign buckets and produce the permutation that clusters rows by
    bucket and sorts by the indexed columns within each bucket, without the
    per-bucket counts.

    Args:
      hash_inputs: per-column hash inputs of the bucket keys (uint32 values
        in int32 or int64 tensors).
      sort_keys: order-preserving keys of the sort columns.
      num_buckets: bucket count.

    Returns:
      (perm, sorted_buckets): ``perm`` the int32 row permutation (ties by
      row index); ``sorted_buckets`` the bucket id of each permuted row
      (non-decreasing)."""
    buckets = bucket_ids_torch(list(hash_inputs), num_buckets)
    perm = lex_argsort([buckets, *sort_keys])
    return perm.to(torch.int32), buckets[perm]


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


# --------------------------------------------------------------------------
# streaming top-k (ORDER BY ... LIMIT k without materialization)
#
# Both programs take a (num_keys + 1, P) int64 "plane matrix": one signed
# NULLS-LAST order plane per ORDER BY key (ops/encode.order_plane) and a
# last plane of global row ids, which makes the order total: equal keys
# resolve by ascending row id, the host stable sort's tie order. So the
# chain of stable sorts of ``lex_argsort`` gives exactly the order of the
# JAX package's unstable multi-operand ``lax.sort``. Padding columns carry
# ORDER_PLANE_SENTINEL in every plane (the row id too): they sort after
# every real row, and the host trims them by ``rid < sentinel``.
# --------------------------------------------------------------------------

_TOPK_SENTINEL = int(ORDER_PLANE_SENTINEL)

# --- declared program contracts (check/program_lint.py), stated next to the
# program builders like exec/device.py's families ---------------------------
_program_lint.register_contract(
    "topk-chunk",
    collectives={"all-gather": (0, None)},
    description=(
        "chunk select-top-k: one multi-operand sort over key planes; may "
        "gather fixed-size planes, never payload rows"
    ),
)
_program_lint.register_contract(
    "topk-merge",
    collectives={},
    description="pairwise top-k candidate merge: 2*cap fixed-size inputs, device-local, collective-free",
)
_program_lint.register_contract(
    "sharded-topk",
    collectives={"all-gather": (1, 1)},
    description=(
        "sharded top-k chunk: per-shard select + EXACTLY one fixed-size "
        "all-gather of candidate planes (never rows), replicated final merge"
    ),
)
_program_lint.register_contract(
    "fused-stage-topk",
    collectives={"all-gather": (0, None)},
    description=(
        "whole-stage chunk select + state merge with an in-place candidate "
        "buffer: one dispatch per chunk"
    ),
    single_fusion=True,
)
_program_lint.register_contract(
    "fused-stage-topk-sharded",
    collectives={"all-gather": (1, 1)},
    description=(
        "sharded whole-stage top-k fold: per-shard select, one fixed-size "
        "candidate all-gather, replicated merge with the running state"
    ),
    single_fusion=True,
)


def _take_cap(mat: torch.Tensor, cap: int, sentinel: int) -> torch.Tensor:
    """The first ``cap`` columns of ``mat``, sentinel-extended when it has
    fewer."""
    p = mat.shape[1]
    if p >= cap:
        return mat[:, :cap]
    pad = torch.full((mat.shape[0], cap - p), sentinel, dtype=mat.dtype, device=mat.device)
    return torch.cat([mat, pad], dim=1)


def _sorted_columns(mat: torch.Tensor) -> torch.Tensor:
    """``mat``'s columns in lexicographic order of its rows' values."""
    return mat[:, lex_argsort(list(mat.unbind(0)))]


def topk_chunk_fn(num_keys: int, cap: int):
    """Builder for the per-chunk select: the plane matrix's columns in
    order, then the first ``cap``. Returns a (num_keys + 1, cap) candidate
    matrix."""

    def run(planes: torch.Tensor) -> torch.Tensor:
        return _take_cap(_sorted_columns(planes), cap, _TOPK_SENTINEL)

    return run


def topk_merge_fn(num_keys: int, cap: int):
    """Builder for the pairwise candidate merge: concatenate two (num_keys +
    1, cap) candidate matrices, order them, keep the first ``cap``: the
    fold step of exec/topk.TopKStream."""

    def run(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _sorted_columns(torch.cat([a, b], dim=1))[:, :cap]

    return run


def fused_topk_fn(num_keys: int, cap: int, donate: bool = False):
    """Builder for the whole-stage fold (``hyperspace.exec.fusion.enabled``,
    "fused-stage-topk"): the chunk's select (``topk_chunk_fn``) AND the merge
    with the running candidate state (``topk_merge_fn``), state first, as
    ONE program, so a streamed chunk costs one dispatch. With ``donate``
    the merged candidates are written into the ``(num_keys + 1, cap)``
    state (``copy_``; its storage stays), else they come back fresh.

    Returns ``(merged, cand)``: the new state and the chunk's own candidate
    matrix, whose row-id plane tells the host which chunk rows to pool. The
    same bodies as the per-family pair, so the result is bit-identical."""
    select = topk_chunk_fn(num_keys, cap)
    merge = topk_merge_fn(num_keys, cap)

    def run(state: torch.Tensor, planes: torch.Tensor):
        cand = select(planes)
        merged = merge(state, cand)
        if donate:
            state.copy_(merged)
            merged = state
        return merged, cand

    return run
