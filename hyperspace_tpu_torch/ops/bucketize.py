"""Distributed re-bucketing: the exchange that replaces Spark's shuffle.

The port of ``hyperspace_tpu/ops/bucketize.py``. ``rebucket`` moves each row
to the shard that owns its bucket (``shard = bucket % n_shards``) with ONE
all-to-all (parallel/mesh.py), replacing the hash shuffle behind
``repartition(numBuckets, cols)`` (ref: HS/index/covering/CoveringIndex.scala:54-69)
and the re-bucketing of appended data in hybrid scan
(ref: HS/index/covering/CoveringIndexRuleUtils.scala:357-417).

Rows are exchanged in fixed-capacity slots: each shard reserves
``capacity`` rows for every destination, and a validity mask marks the real
rows. Rows beyond a destination's capacity are counted in ``overflow`` and
returned, never dropped silently: callers check it and retry with a larger
capacity (the skew strategy, SURVEY.md §7).

Where torch differs from JAX:

- an out-of-range scatter index raises on the CPU and is a device assert
  on CUDA (JAX drops it), so rows that have no slot (overflow, padding)
  write into one scratch slot past the ``n_shards * capacity`` grid, which
  is sliced off afterwards;
- JAX's fixed-length count of each destination becomes a ``searchsorted``
  of the destinations into the sorted ones (torch's own count sizes its
  output by its input's maximum, a read on the host);
- the multi-operand sort is ``ops/sort.lex_argsort``, a chain of stable
  sorts, and uint32 hash inputs ride in int64 with 32-bit masks
  (ops/hashing.py);
- every staged column is split into bit-exact int32 planes so one
  exchange moves all of them: one copy per pair of distinct devices in a
  process, one ``all_to_all_single`` across processes.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

import torch

from hyperspace_tpu_torch.check import program_lint as _program_lint
from hyperspace_tpu_torch.parallel.mesh import Mesh, ShardedTensor, all_to_all

#: rows an exchange could not place, summed over every call (the build's
#: capacity retries read the per-call count; this is the running total)
overflow_rows: collections.Counter = collections.Counter()


def _stage_for_exchange(values, dest: torch.Tensor, n_dev: int, capacity: int, fill=0, valid=None):
    """Scatter one shard's rows into an ``(n_dev, capacity)`` grid per value
    keyed by destination; rows beyond capacity have no slot (and are
    counted). ``valid`` (a bool mask) keeps padding rows out of the
    exchange. Returns (staged grids, slot mask, per-destination counts)."""
    n_loc = dest.shape[0]
    dest = dest.to(torch.int64)
    if valid is not None:
        dest = torch.where(valid, dest, torch.full_like(dest, n_dev))  # invalid rows -> scratch bin
    order = torch.sort(dest, stable=True).indices
    dest_sorted = dest[order]
    # each destination's first sorted row: a fixed-length search, which
    # reads nothing on the host
    bounds = torch.searchsorted(dest_sorted, torch.arange(n_dev + 2, device=dest.device))
    offsets = bounds[:-1]
    counts = (bounds[1:] - offsets)[:n_dev]
    rank = torch.arange(n_loc, device=dest.device) - offsets[dest_sorted]
    in_slot = (dest_sorted < n_dev) & (rank < capacity)
    slot = dest_sorted.clamp(max=n_dev - 1) * capacity + rank.clamp(0, capacity - 1)
    slot = torch.where(in_slot, slot, torch.full_like(slot, n_dev * capacity))  # no slot -> scratch
    staged = []
    for v in values:
        buf = torch.full((n_dev * capacity + 1,), fill, dtype=v.dtype, device=v.device)
        buf[slot] = v[order]
        staged.append(buf[:-1].reshape(n_dev, capacity))
    mask = torch.zeros(n_dev * capacity + 1, dtype=torch.bool, device=dest.device)
    mask[slot] = in_slot
    return staged, mask[:-1].reshape(n_dev, capacity), counts


_BIT_VIEWS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_M32 = 0xFFFFFFFF


def _as_int32_bits(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as the int32 with the same 32 bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _to_planes(v: torch.Tensor) -> List[torch.Tensor]:
    """Bit-exact int32 planes of ``v`` (one for types of up to 32 bits, high
    and low words for 64-bit ones), so a whole exchange rides one
    all-to-all whatever the column types. Sub-32-bit values travel as their
    bit patterns, zero-extended: never value casts, so float16 and bfloat16
    survive exactly."""
    if v.dtype == torch.bool:
        return [v.to(torch.int32)]
    size = v.element_size()
    bits = v.view(_BIT_VIEWS[size])
    if size == 8:
        return [_as_int32_bits((bits >> 32) & _M32), _as_int32_bits(bits & _M32)]
    if size == 4:
        return [bits]
    if size == 2:
        return [bits.to(torch.int32) & 0xFFFF]
    return [bits.to(torch.int32)]


def _from_planes(planes: Sequence[torch.Tensor], dt: torch.dtype) -> torch.Tensor:
    """The inverse of ``_to_planes``."""
    if dt == torch.bool:
        return planes[0] != 0
    size = torch.empty((), dtype=dt).element_size()
    if size == 8:
        hi = planes[0].to(torch.int64)
        lo = planes[1].to(torch.int64) & _M32
        return ((hi << 32) | lo).view(dt)
    if size == 4:
        return planes[0].view(dt)
    if size == 2:
        p = planes[0].to(torch.int64)
        return torch.where(p >= 1 << 15, p - (1 << 16), p).to(torch.int16).view(dt)
    return planes[0].to(torch.uint8).view(dt)


def _plane_count(dt: torch.dtype) -> int:
    return 2 if dt != torch.bool and torch.empty((), dtype=dt).element_size() == 8 else 1


def _exchange_packed(mesh: Mesh, axis: str, staged: Dict[int, list], masks: Dict[int, torch.Tensor]):
    """The one-collective exchange: each shard's staged ``(n_axis,
    capacity)`` grids and its slot mask split into int32 planes, stacked
    into one ``(n_axis, capacity, planes)`` tensor, exchanged with ONE
    all-to-all over ``axis``, and unpacked to the original dtypes. Returns
    (per shard: the received columns, the received mask)."""
    packed = {}
    dts = None
    for g, vals in staged.items():
        dts = [v.dtype for v in vals]
        planes = []
        for v in vals:
            planes.extend(_to_planes(v))
        planes.extend(_to_planes(masks[g]))
        packed[g] = torch.stack(planes, dim=-1)
    got = all_to_all(mesh, axis, packed)
    cols, out_masks = {}, {}
    for g, out in got.items():
        res, i = [], 0
        for dt in dts:
            k = _plane_count(dt)
            res.append(_from_planes([out[:, i + j] for j in range(k)], dt))
            i += k
        cols[g] = res
        out_masks[g] = out[:, i] != 0
    return cols, out_masks


def _shards(x) -> Dict[int, torch.Tensor]:
    """A ShardedTensor's (or a list of per-shard tensors') local shards by
    global shard index."""
    if isinstance(x, ShardedTensor):
        return dict(zip(x.mesh.local_shards(), x.shards))
    return dict(enumerate(x))


def _wrap(mesh: Mesh, by_shard: Dict[int, torch.Tensor]) -> ShardedTensor:
    return ShardedTensor([by_shard[g] for g in mesh.local_shards()], mesh)


def _exchange_phase(mesh: Mesh, axis: str, n_axis: int, values_by_shard, dest_by_shard, capacity: int,
                    valid_by_shard=None):
    """Stage every local shard's values by destination along ``axis`` and
    exchange them. Returns (per shard: received columns, received mask),
    and per shard the rows that had no slot."""
    staged, masks, overflow = {}, {}, {}
    for g, vals in values_by_shard.items():
        valid = valid_by_shard[g] if valid_by_shard is not None else None
        st, mask, counts = _stage_for_exchange(vals, dest_by_shard[g], n_axis, capacity, valid=valid)
        staged[g], masks[g] = st, mask
        overflow[g] = (counts - counts.clamp(max=capacity)).sum()
    cols, out_masks = _exchange_packed(mesh, axis, staged, masks)
    return cols, out_masks, overflow


def rebucket(mesh: Mesh, arrays: Dict[str, ShardedTensor], bucket_ids: ShardedTensor, capacity: int):
    """Exchange rows so shard ``d`` ends up holding exactly the rows with
    ``bucket % n_shards == d``.

    Args:
      mesh: 1-D mesh; the inputs are row-sharded over it.
      arrays: name -> row-aligned sharded columns.
      bucket_ids: the bucket of each row (int32).
      capacity: row slots per source shard and destination.

    Returns:
      (out_arrays, out_buckets, valid_mask, overflow): each output holds
      ``n_shards * capacity`` rows per shard, ``valid_mask`` marking the
      real ones; ``overflow`` is each shard's count of rows that had no
      slot (callers must check it is all zero and retry with a larger
      capacity otherwise).
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.size
    names = list(arrays)
    cols = {n: _shards(arrays[n]) for n in names}
    buckets = _shards(bucket_ids)
    values = {g: [cols[n][g] for n in names] + [b] for g, b in buckets.items()}
    dest = {g: (b.to(torch.int64) % n_dev) for g, b in buckets.items()}
    # the overflow counts are read after the program's window: the exchange
    # itself never waits on the host
    with _program_lint.maybe_verify(None, "index-rebucket", lambda: f"index-rebucket/c{capacity}|n{n_dev}",
                                    (values, dest)):
        out, out_mask, overflow = _exchange_phase(mesh, axis, n_dev, values, dest, capacity)
    for v in overflow.values():
        overflow_rows["rebucket"] += int(v)
    out_arrays = {n: _wrap(mesh, {g: out[g][i] for g in out}) for i, n in enumerate(names)}
    return (out_arrays, _wrap(mesh, {g: out[g][-1] for g in out}), _wrap(mesh, out_mask),
            _wrap(mesh, {g: v.reshape(1) for g, v in overflow.items()}))


def rebucket_and_sort(mesh: Mesh, arrays: Dict[str, ShardedTensor], hash_inputs: List[ShardedTensor],
                      sort_keys: List[ShardedTensor], num_buckets: int, capacity: int):
    """The distributed build step over sharded columns: hash, one
    all-to-all, then each shard's stable sort by (valid first, bucket, sort
    keys, arrival). Padding rows sort to the end of each shard."""
    from hyperspace_tpu_torch.ops.hashing import bucket_ids_torch
    from hyperspace_tpu_torch.ops.sort import lex_argsort

    hashed = [_shards(h) for h in hash_inputs]
    buckets = _wrap(mesh, {g: bucket_ids_torch([h[g] for h in hashed], num_buckets) for g in hashed[0]})
    key_names = [f"__sk{i}" for i in range(len(sort_keys))]
    all_arrays = {**arrays, **dict(zip(key_names, sort_keys))}
    out, out_buckets, valid, overflow = rebucket(mesh, all_arrays, buckets, capacity)
    ob, ov = _shards(out_buckets), _shards(valid)
    sorted_b, sorted_v, sorted_cols = {}, {}, {n: {} for n in arrays}
    for g in ob:
        order = lex_argsort([(~ov[g]).to(torch.int32), ob[g]] + [_shards(out[k])[g] for k in key_names])
        sorted_b[g], sorted_v[g] = ob[g][order], ov[g][order]
        for n in arrays:
            sorted_cols[n][g] = _shards(out[n])[g][order]
    return ({n: _wrap(mesh, sorted_cols[n]) for n in arrays}, _wrap(mesh, sorted_b), _wrap(mesh, sorted_v),
            overflow)


def _next_pow2(x: int) -> int:
    return max(8, 1 << (max(int(x) - 1, 1)).bit_length())


# Declared program contracts for the build/exchange programs (build =
# exactly ONE all-to-all; hierarchical re-bucketing = one per phase). The
# single-phase contracts also apply to ``rebucket``.
_program_lint.register_contract(
    "index-build-exchange",
    collectives={"all-to-all": (1, 1)},
    description="distributed index build: rows cross devices in exactly one plane-packed all-to-all",
)
_program_lint.register_contract(
    "index-rebucket",
    collectives={"all-to-all": (1, 1)},
    description="incremental re-bucketing: one plane-packed all-to-all",
)
_program_lint.register_contract(
    "hierarchical-exchange",
    collectives={"all-to-all": (2, 2)},
    description="2-D (dcn, ici) re-bucketing: one all-to-all per phase, rows cross DCN once",
)


def _build_exchange_program(mesh: Mesh, kinds: Tuple[str, ...], num_buckets: int, capacity: int):
    """The distributed index-build step for one (mesh, key kinds,
    num_buckets, capacity) class, as a function of per-shard inputs:

      per-shard hash (reconstructed on the device for numeric kinds, the
      host plane for strings; bit-exact against the single-device build,
      ops/sort.bucket_sort_build) -> bucket ids -> ONE all-to-all routing
      each row to its owner shard (bucket % n_shards) -> each shard's sort
      by (valid first, bucket, keys..., global row index).

    The exchange carries the global row index instead of the payload
    columns, so it stays narrow: the host takes the payload rows by index
    afterwards, as the single-device build does with its permutation.

    ``run(keys, host_hashes, row_idx, n_valid)`` takes, per key, per hash
    plane and for the row index, one tensor per local shard, and returns
    per shard ``(sorted buckets, sorted row index, valid, overflow)``."""
    from hyperspace_tpu_torch.ops.hashing import bucket_ids_torch
    from hyperspace_tpu_torch.ops.sort import _device_hash32, lex_argsort

    axis = mesh.axis_names[0]
    n_dev = mesh.size

    def run(keys, host_hashes, row_idx, n_valid: int):
        shard_ids = mesh.local_shards()
        values, dest, valid = {}, {}, {}
        for i, g in enumerate(shard_ids):
            ks = [k[i] for k in keys]
            hh = [h[i] for h in host_hashes]
            hash_cols, hidx = [], 0
            for kind, key in zip(kinds, ks):
                if kind == "s":
                    hash_cols.append(hh[hidx])
                    hidx += 1
                else:
                    hash_cols.append(_device_hash32(kind, key))
            buckets = bucket_ids_torch(hash_cols, num_buckets)
            values[g] = [*ks, row_idx[i], buckets]
            dest[g] = buckets.to(torch.int64) % n_dev
            valid[g] = row_idx[i] < n_valid
        outs, out_masks, overflow = _exchange_phase(mesh, axis, n_dev, values, dest, capacity, valid)
        result = {}
        for g in shard_ids:
            *out_keys, out_ridx, out_buckets = outs[g]
            mask = out_masks[g]
            order = lex_argsort([(~mask).to(torch.int32), out_buckets, *out_keys, out_ridx])
            result[g] = (out_buckets[order], out_ridx[order], mask[order], overflow[g].reshape(1))
        return result

    return run


def distributed_bucket_sort_build(mesh: Mesh, keys, host_hashes, kinds: Tuple[str, ...], row_idx,
                                  n_valid: int, num_buckets: int, capacity: int):
    """Run the distributed build step; see ``_build_exchange_program``.

    ``keys``, ``host_hashes`` and ``row_idx`` hold one tensor per local
    shard (or a ``ShardedTensor``), all padded to one length per shard;
    ``row_idx`` is the global row index, padding rows at or past
    ``n_valid``. Returns per shard ``(sorted_buckets, sorted_row_idx,
    valid, overflow)``, each of ``n_shards * capacity`` rows. Callers must
    check that the overflow sums to zero and retry with doubled capacity
    otherwise (the skew strategy, SURVEY.md §7)."""
    as_list = lambda x: x.shards if isinstance(x, ShardedTensor) else list(x)  # noqa: E731
    fn = _build_exchange_program(mesh, tuple(kinds), int(num_buckets), int(capacity))
    args = ([as_list(k) for k in keys], [as_list(h) for h in host_hashes], as_list(row_idx), int(n_valid))
    # no session conf reaches this layer: maybe_verify(None, ...) consults
    # the module default the last Session set
    key = f"index-build-exchange/{','.join(kinds)}|b{int(num_buckets)}|c{int(capacity)}|n{mesh.size}"
    with _program_lint.maybe_verify(None, "index-build-exchange", key, args):
        out = fn(*args)
    for v in out.values():
        overflow_rows["build"] += int(v[3])
    return out


def rebucket_hierarchical(mesh: Mesh, arrays: Dict[str, ShardedTensor], bucket_ids: ShardedTensor,
                          capacity_ici: int, capacity_dcn: int):
    """Two-phase re-bucketing over a 2-D ``(dcn, ici)`` mesh: rows first hop
    to their owner's local position within their own slice (the ``ici``
    exchange, inside a process), then once across slices (the ``dcn``
    exchange, the only one that crosses a process boundary), so each row
    crosses the slow link at most once (SURVEY.md §5.8).

    Owner of bucket b on an (S, L) mesh: global shard g = b % (S*L), slice
    s = g // L, local position l = g % L.

    Returns (out_arrays, out_buckets, valid_mask, overflow) per shard, like
    ``rebucket``; ``overflow`` sums the rows without a slot in both
    phases."""
    dcn_axis, ici_axis = mesh.axis_names
    n_s, n_l = mesh.shape[dcn_axis], mesh.shape[ici_axis]
    n_dev = n_s * n_l
    names = list(arrays)
    cols = {n: _shards(arrays[n]) for n in names}
    buckets = _shards(bucket_ids)

    values = {g: [cols[n][g] for n in names] + [b] for g, b in buckets.items()}
    key = lambda: f"hierarchical-exchange/c{capacity_ici},{capacity_dcn}|n{n_s}x{n_l}"  # noqa: E731
    with _program_lint.maybe_verify(None, "hierarchical-exchange", key, (values,)):
        # -- phase 1 (ici): to the owner's local position in this slice
        dest = {g: (b.to(torch.int64) % n_dev) % n_l for g, b in buckets.items()}
        mid, mid_mask, of1 = _exchange_phase(mesh, ici_axis, n_l, values, dest, capacity_ici)

        # -- phase 2 (dcn): to the owner slice; the local position is kept
        dest2 = {g: (v[-1].to(torch.int64) % n_dev) // n_l for g, v in mid.items()}
        out, out_mask, of2 = _exchange_phase(mesh, dcn_axis, n_s, mid, dest2, capacity_dcn, mid_mask)
        overflow = {g: of1[g] + of2[g] for g in of1}
    for v in overflow.values():
        overflow_rows["hierarchical"] += int(v)
    out_arrays = {n: _wrap(mesh, {g: out[g][i] for g in out}) for i, n in enumerate(names)}
    return (out_arrays, _wrap(mesh, {g: out[g][-1] for g in out}), _wrap(mesh, out_mask),
            _wrap(mesh, {g: v.reshape(1) for g, v in overflow.items()}))
