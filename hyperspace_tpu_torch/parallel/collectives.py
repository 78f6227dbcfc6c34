"""The sharded programs of the mesh-sharded execution path.

The port of ``hyperspace_tpu/parallel/collectives.py``. There a
``shard_map`` over the 1-D bucket axis runs the single-device program's
body on each device's block of rows, then merges the per-device partial
tables on the device with one ``all_gather`` and a replicated merge. Here
each program runs the port's single-device program on each shard's row
block (on the shard's device), gathers only the per-shard fixed-size
tables (``n_shards * cap`` entries per table, never rows) onto the mesh's
first device, and merges them there once: every replica of the JAX
package's replicated merge computes the same bytes, and the host reads one.

Each function returns a program with the call convention of its
single-device twin, so ``GroupedAggStream``, ``TopKStream`` and the device
filter swap them in with no other change. The row blocks are contiguous
and in shard order, so concatenated partial tables are in ascending order
of their global rows, and a group's first-seen row (its representative
key) and the top-k's row-id tie-break are those of the single-device run:
the results are byte-identical, but for float sums, which add per shard
first.
"""

from __future__ import annotations

from typing import List

import torch

from hyperspace_tpu_torch.parallel.mesh import Mesh, all_gather, row_blocks


def _to(lits, device: torch.device):
    return tuple(v.to(device, non_blocking=True) for v in lits)


def _blocks(mesh: Mesh, cols: dict, n: int):
    """(shard, lo, hi, shard's columns) of each shard's row block of the
    first ``n`` rows of ``cols``: views on the shard's device when it is
    the columns' own, else one copy each."""
    out = []
    for d, (lo, hi) in enumerate(row_blocks(n, mesh.size)):
        dev = mesh.device_of(d)
        out.append((d, lo, hi, {c: v[lo:hi].to(dev, non_blocking=True) for c, v in cols.items()}))
    return out


def sharded_elementwise(mesh: Mesh, axis: str, fn):
    """An elementwise program (the predicate mask) per shard: each shard
    evaluates its own row block, and the blocks' outputs concatenate back
    in global row order. No collective."""

    def mapped(cols, lits):
        n = next(iter(cols.values())).shape[0]
        home = mesh.device_of(0)
        parts = []
        for d, lo, hi, cols_d in _blocks(mesh, cols, n):
            out = fn(cols_d, _to(lits, mesh.device_of(d)))
            if out.dim() == 0:  # a predicate over literals only
                out = out.expand(hi - lo)
            parts.append(out.to(home, non_blocking=True))
        return torch.cat(parts)

    return mapped


def _plane_blocks(mesh: Mesh, planes: torch.Tensor) -> List[torch.Tensor]:
    return [planes[:, lo:hi].to(mesh.device_of(d), non_blocking=True)
            for d, (lo, hi) in enumerate(row_blocks(planes.shape[1], mesh.size))]


def sharded_topk_chunk_program(mesh: Mesh, axis: str, num_keys: int, cap: int):
    """Sharded twin of ``ops.sort.topk_chunk_fn``: the same signature (a
    ``(num_keys + 1, P)`` plane matrix in, a ``(num_keys + 1, cap)``
    candidate matrix out). Per shard, the single-device select over the
    shard's columns; then one gather of the per-shard candidate matrices
    (``n_shards * cap`` candidates, never rows) and the select over them.
    The row-id plane makes the order total, so the result equals the
    single-device program's on the same matrix."""
    from hyperspace_tpu_torch.ops.sort import _TOPK_SENTINEL, _sorted_columns, _take_cap, topk_chunk_fn

    select = topk_chunk_fn(num_keys, cap)

    def program(planes: torch.Tensor) -> torch.Tensor:
        mine = [select(p) for p in _plane_blocks(mesh, planes)]
        home = mesh.device_of(0)
        gathered = all_gather([m.t() for m in mine], home, axis).t()  # (K+1, n_shards * cap)
        return _take_cap(_sorted_columns(gathered), cap, _TOPK_SENTINEL)

    return program


def sharded_fused_topk_program(mesh: Mesh, axis: str, num_keys: int, cap: int):
    """Sharded twin of ``ops.sort.fused_topk_fn``: the sharded select and
    the merge with the running candidate state as one program. Same
    signature, ``program(state, planes) -> (merged, cand)``. It never writes
    the state in place: as in the JAX package, the sharded fold does not
    donate."""
    from hyperspace_tpu_torch.ops.sort import topk_merge_fn

    select = sharded_topk_chunk_program(mesh, axis, num_keys, cap)
    merge = topk_merge_fn(num_keys, cap)

    def program(state: torch.Tensor, planes: torch.Tensor):
        cand = select(planes)
        return merge(state, cand), cand

    return program


def _empty_part(cols, key_specs, slot_specs, cap: int, device: torch.device):
    """A shard's table when its row block is empty (known from the shapes):
    no group, each column of its program's dtype."""
    from hyperspace_tpu_torch.exec.aggregate import _FS_SENTINEL, _fused_state_dtypes

    _, slot_dts = _fused_state_dtypes(key_specs, slot_specs)
    fs = torch.full((cap,), _FS_SENTINEL, dtype=torch.int64, device=device)
    keys = tuple(torch.zeros(cap, dtype=cols[name].dtype, device=device) for name, _ in key_specs)
    slots = tuple(torch.zeros(cap, dtype=dt, device=device) for dt in slot_dts)
    return torch.zeros((), dtype=torch.int64, device=device), fs, keys, slots


def sharded_grouped_chunk_program(mesh: Mesh, axis: str, pred_fn, key_specs, slot_specs, cap: int):
    """Sharded twin of ``aggregate.grouped_chunk_program``: the same
    signature ``program(cols, lits, n, row_base)`` and outputs ``(n_groups,
    first-seen, key reps, state slots)``, the count a 0-d tensor.

    Per shard: the fused predicate and the segment reduction over the
    shard's row block, its first-seen rows global (the block's first row
    plus ``row_base``). Then one gather per table of the per-shard counts
    and tables (``n_shards * cap`` entries: group cardinality, not row
    count) and one merge (``_merge_concat_parts``) of the rows that hold a
    group (``part_mask``), in shard order.

    Overflow: a shard over ``cap`` groups keeps only its first ``cap`` in
    its table, which can leave the merged count at or below ``cap``; the
    returned count is maxed with every shard's on the device, as in the JAX
    package, so the caller re-runs at a larger capacity."""
    from hyperspace_tpu_torch.exec.aggregate import _merge_concat_parts, grouped_chunk_program

    chunk = grouped_chunk_program(pred_fn, key_specs, slot_specs, cap)

    def program(cols, lits, n: int, row_base: int):
        parts = []
        for d, lo, hi, cols_d in _blocks(mesh, cols, n):
            dev = mesh.device_of(d)
            if hi > lo:
                parts.append(chunk(cols_d, _to(lits, dev), hi - lo, row_base + lo))
            else:
                parts.append(_empty_part(cols, key_specs, slot_specs, cap, dev))
        home = mesh.device_of(0)
        ng_all = all_gather([p[0].reshape(1) for p in parts], home, axis)
        fs_all = all_gather([p[1] for p in parts], home, axis)
        keys_all = tuple(all_gather([p[2][i] for p in parts], home, axis) for i in range(len(key_specs)))
        slots_all = tuple(all_gather([p[3][i] for p in parts], home, axis) for i in range(len(slot_specs)))
        part_mask = (torch.arange(cap, device=home)[None, :] < ng_all[:, None]).reshape(-1)
        n_g, fs, key_out, slot_out = _merge_concat_parts(
            key_specs, slot_specs, cap, keys_all, slots_all, fs_all, part_mask)
        return torch.maximum(n_g, ng_all.amax()), fs, key_out, slot_out

    return program


def sharded_fused_grouped_program(mesh: Mesh, axis: str, pred_fn, key_specs, slot_specs, cap: int):
    """Sharded twin of ``aggregate.fused_grouped_update_program``: the
    sharded chunk program and the merge into the running partial as one
    program. Same signature, ``program(state_keys, state_slots, state_fs,
    state_n, cols, lits, n, row_base) -> (n_b, n_m, n_out, fs, keys,
    slots)``, and the same overflow contract, decided on the device: above
    ``cap`` groups in the chunk (any shard's or the merged count) or in the
    merge, every output holds the state's values and the caller redoes the
    chunk per-family. The state is never written in place (the sharded
    fold does not donate)."""
    from hyperspace_tpu_torch.exec.aggregate import fold_into_state

    chunk = sharded_grouped_chunk_program(mesh, axis, pred_fn, key_specs, slot_specs, cap)

    def program(state_keys, state_slots, state_fs, state_n, cols, lits, n: int, row_base: int):
        n_b, fs_b, key_b, slot_b = chunk(cols, lits, n, row_base)
        n_m, n_out, fs_out, keys_out, slots_out = fold_into_state(
            key_specs, slot_specs, cap, False, state_keys, state_slots, state_fs, state_n,
            key_b, slot_b, fs_b, n_b,
        )
        return n_b, n_m, n_out, fs_out, keys_out, slots_out

    return program
