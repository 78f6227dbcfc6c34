"""The device aggregates: global and grouped aggregates over a (filtered)
index scan, evaluated on the session's device.

The port of the JAX package's two aggregate programs, which are XLA programs
there (``hyperspace_tpu/exec/device.py``) and torch programs here, over the
device column cache the filter fills (exec/device.py):

  ``device_filtered_aggregate``  device.py:947-1088  ``fused-agg``: predicate,
                                 masked count/sum/min/max/avg and the
                                 non-null counts in one program; only the
                                 scalars come back, in one copy
  ``group_capacity``             device.py:1112      geometric capacity buckets
  ``_grouped_slots``             device.py:1126-1167 mergeable state slots
  ``_key_code``                  device.py:1170-1180 int64 grouping codes
  ``_segment_ids``               device.py:1183-1202 sort + rank compression
  ``_segment_reduce_slots``      device.py:1205-1238 per-slot reductions
  ``grouped_chunk_program``      device.py:1241-1269 ``grouped-agg-chunk``:
                                 filter, group and reduce; only the
                                 per-group table comes back
  ``_merge_concat_parts``        device.py:1272-1313 re-rank and reduce
                                 concatenated partial tables
  ``grouped_merge_program``      device.py:1316-1331 ``grouped-merge``: fold
                                 a chunk's table into the running one
  ``_dev_pad``                   device.py:1334-1341
  ``GroupedAggStream``           device.py:1397-1921 capacity re-runs,
                                 ``maxGroups``, string-key remap, the
                                 chunk merge, finalize, the spill's
                                 partial frame
  ``device_grouped_aggregate``   device.py:1926-1953

Where torch and JAX differ, the programs here do what JAX does:

- ``jnp.lexsort`` becomes a chain of stable ``torch.sort`` from the last key
  to the first over the matched rows (found with ``nonzero``, so they keep
  their row order); the first row of each segment is then the group's
  smallest row, which JAX takes with ``segment_min``.
- JAX's segment reductions drop the masked rows' out-of-range id; torch
  raises on the CPU and asserts on CUDA, so the masked rows never reach a
  reduction here: only the matched rows are sorted and reduced. Slots past
  ``n_groups`` hold each reduction's identity, as in JAX.
- Float keys are canonicalised (-0.0 to +0.0, one NaN) before the bitcast.
- Fill values are tensors of the slot's dtype, never Python floats; int
  sums stay int64 and exact, and avg of an int column has its own float64
  sum slot.
- A float ``scatter_reduce_`` min or max keeps the first of two equal zeros
  (on CUDA the first atomic); XLA orders -0.0 below +0.0 and propagates a
  NaN. Float min and max fold on order-preserving int64 keys instead
  (``_seg_fold_float``), exact and order-free.
- Eager torch compiles nothing, so columns are not padded to shape buckets;
  the capacity geometry, ``maxGroups`` and the capacity hint memo are kept
  so spill decisions, fallback reasons and dispatch counts equal JAX's.

Float sums on CUDA (``index_add_``) add in an order that varies from run to
run; counts, int sums, min, max, keys and the group order are exact.

Raises ``DeviceUnsupported`` (before any upload) outside the device language
and ``GroupCapacityExceeded`` above ``maxGroups``; the executor then runs the
host pandas aggregate. Errors of the device itself propagate.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.exec import batch as B
from hyperspace_tpu_torch.exec.device import (
    ColumnCodec,
    DeviceUnsupported,
    _cached_column,
    _device_cache,
    _dry_codecs,
    _pack_literals,
    _put_encoded,
    compile_predicate,
    dispatches,
    upload_literals,
)
from hyperspace_tpu_torch.plan.expr import Expr

I64_MAX = int(np.iinfo(np.int64).max)
I64_MIN = int(np.iinfo(np.int64).min)
_FS_SENTINEL = I64_MAX


class GroupCapacityExceeded(DeviceUnsupported):
    """The observed group cardinality exceeds ``hyperspace.exec.agg.maxGroups``:
    the executor spills to the host aggregate. ``folded`` says whether the
    chunk that crossed the limit is already in the stream's running partial
    (a merge crossed it) or not (the chunk's own program did)."""

    folded = False


def _device_columns(session, batch: B.Batch, names, scan_key, n: int, reject_strings: bool = False):
    """(device tensors, codecs) of ``names``: from the device cache when the
    scan's columns are resident, else encoded and uploaded (encode and
    upload time go to the ``agg_upload`` layer). With ``reject_strings`` a
    string column that is not resident raises DeviceUnsupported before its
    upload, as the JAX package's global aggregate does."""
    device = session.device
    dev_cols: Dict[str, torch.Tensor] = {}
    codecs: Dict[str, ColumnCodec] = {}
    t = time.perf_counter()
    uploaded = False
    for r in names:
        ckey = (scan_key, r, str(device)) if scan_key is not None else None
        cached = _cached_column(ckey, n)
        if cached is not None:
            dev_cols[r], codecs[r] = cached
            continue
        if reject_strings and batch[r].dtype.kind in ("U", "S", "O"):
            raise DeviceUnsupported("string aggregate/predicate columns stay host-side here")
        dev, codec, nbytes = _put_encoded(batch[r], device)
        dev_cols[r], codecs[r] = dev, codec
        uploaded = True
        if ckey is not None:
            _device_cache.put(ckey, (dev, codec, n, None), nbytes)
    if uploaded:
        session.query_stage_seconds["agg_upload"] += time.perf_counter() - t
    return dev_cols, codecs


def _full_mask(pred_fn, cols, lits, n: int, device) -> torch.Tensor:
    if pred_fn is None:
        return torch.ones(n, dtype=torch.bool, device=device)
    mask = pred_fn(cols, lits)
    return mask.expand(n) if mask.dim() == 0 else mask  # a predicate over literals only


# --------------------------------------------------------------------------
# fused filter + global aggregate (only scalars leave the device)
# --------------------------------------------------------------------------

_AGG_FNS = ("count", "sum", "min", "max", "avg")


def fused_agg_program(pred_fn, agg_spec):
    """The ``fused-agg`` program: ``program(cols, lits, n) -> (outs, valids)``,
    per aggregate its 0-d result and its count of non-null matched rows."""

    def program(cols, lits, n: int):
        device = next(iter(cols.values())).device
        mask = _full_mask(pred_fn, cols, lits, n, device)
        cnt = mask.sum()
        outs, valids = [], []
        for fn, c in agg_spec:
            if fn == "count":
                if c is None or not cols[c].is_floating_point():
                    outs.append(cnt)
                else:
                    # count(col) skips nulls (NaN), like the host path
                    outs.append((mask & ~torch.isnan(cols[c])).sum())
                valids.append(cnt)
                continue
            x = cols[c]
            is_int = not x.is_floating_point()
            # pandas semantics: NaNs are skipped, not propagated
            m = mask if is_int else (mask & ~torch.isnan(x))
            valids.append(m.sum())
            if fn == "sum":
                # integer sums stay int64 (exact); encoded columns are
                # already int64 or float64
                outs.append(torch.where(m, x, x.new_zeros(())).sum())
            elif fn == "avg":
                xf = x.to(torch.float64)
                outs.append(torch.where(m, xf, xf.new_zeros(())).sum() / torch.clamp(m.sum(), min=1))
            elif fn == "min":
                fill = x.new_full((), I64_MAX if is_int else float("inf"))
                outs.append(torch.where(m, x, fill).min())
            else:  # max
                fill = x.new_full((), I64_MIN if is_int else float("-inf"))
                outs.append(torch.where(m, x, fill).max())
        return tuple(outs), tuple(valids)

    return program


def _read_scalars(outs, valids) -> Tuple[list, List[int]]:
    """Every scalar in one device-to-host copy: float64 results travel as
    their int64 bit patterns."""
    packed = torch.stack(
        [o.view(torch.int64) if o.is_floating_point() else o.to(torch.int64) for o in outs]
        + [v.to(torch.int64) for v in valids]
    ).cpu().numpy()
    vals = [
        packed[i].view(np.float64) if o.is_floating_point() else packed[i]
        for i, o in enumerate(outs)
    ]
    return vals, [int(v) for v in packed[len(outs):]]


def device_filtered_aggregate(
    session,
    batch: B.Batch,
    condition: Optional[Expr],
    aggs: List[Tuple[str, str, Optional[str]]],
    scan_key=None,
) -> Optional[Dict[str, np.ndarray]]:
    """Global aggregates over (optionally filtered) device-resident columns
    in ONE program: predicate mask and reductions run on the device; only
    the per-aggregate scalars come back. ``aggs`` as in plan.Aggregate
    ((out name, fn, input col)). Returns None for an empty batch (empty-input
    semantics stay host-side).

    Raises DeviceUnsupported outside the device language (string aggregate
    inputs, unsupported predicate shapes, ...)."""
    n = B.num_rows(batch)
    if n == 0:
        return None  # empty-input semantics (NaN mins etc.) stay host-side

    agg_inputs = sorted({c for _, fn, c in aggs if c is not None})
    for _, fn, c in aggs:
        if fn not in _AGG_FNS:
            raise DeviceUnsupported(f"unsupported aggregate fn {fn!r}")
        # datetimes stay host-side: float64 reduction would lose ns precision
        if c is not None and batch[c].dtype.kind not in ("i", "u", "f", "b"):
            raise DeviceUnsupported(f"aggregate over non-numeric column {c!r}")
    refs = sorted(condition.references()) if condition is not None else []
    if not refs and not agg_inputs:
        # count(*) with no predicate: nothing to put on the device
        raise DeviceUnsupported("no device-resident columns involved")
    for r in refs + agg_inputs:
        if r not in batch:
            raise DeviceUnsupported(f"column {r!r} missing from batch")

    # dry-check the predicate before any upload
    if condition is not None:
        _pack_literals(compile_predicate(condition, _dry_codecs(batch, refs))[1])

    dev_cols, codecs = _device_columns(session, batch, sorted(set(refs) | set(agg_inputs)), scan_key, n,
                                       reject_strings=True)

    t = time.perf_counter()
    if condition is not None:
        pred_fn, lit_values = compile_predicate(condition, codecs)
    else:
        pred_fn, lit_values = None, ()
    program = fused_agg_program(pred_fn, tuple((fn, c) for _, fn, c in aggs))
    outs, valids = program(dev_cols, upload_literals(lit_values, session.device), n)
    dispatches["fused-agg"] += 1
    outs, valids = _read_scalars(outs, valids)
    t = _add(session, "agg_program", t)

    result: Dict[str, np.ndarray] = {}
    for (name, fn, c), val, n_valid in zip(aggs, outs, valids):
        if fn == "count":
            result[name] = np.asarray([int(val)])
        elif fn in ("sum", "min", "max", "avg") and n_valid == 0:
            # no non-null matches: SQL yields NULL (SUM over zero rows too)
            result[name] = np.asarray([np.nan])
        else:
            src = batch[c]
            if fn in ("sum", "min", "max") and src.dtype.kind in ("i", "u", "b"):
                result[name] = np.asarray([int(val)])
            else:
                result[name] = np.asarray([float(val)])
    _add(session, "agg_finalize", t)
    return result


def _add(session, stage: str, t0: float) -> float:
    now = time.perf_counter()
    session.query_stage_seconds[stage] += now - t0
    return now


# --------------------------------------------------------------------------
# fused filter + grouped aggregate: sort-based segment reduction
# --------------------------------------------------------------------------

_GROUPED_AGG_FNS = ("count", "sum", "min", "max", "avg", "stddev_samp")

_SQRT2 = 1.4142135623730951


def group_capacity(n: int, floor: int) -> int:
    """Smallest geometric capacity bucket (powers of sqrt(2) over ``floor``)
    holding ``n`` groups."""
    cap, n = max(1, int(floor)), max(1, int(n))
    while cap < n:
        cap = int(cap * _SQRT2) + 1
    return cap


def _grouped_slots(aggs, is_int: Dict[str, bool]):
    """Decompose ``aggs`` into deduplicated mergeable state slots.

    Returns (slots, refs): ``slots`` is a list of (kind, col, int-valued)
    with kind in cntm/cnt/sum/sumsq/min/max (cntm = matched-row count for
    count(*)); ``refs[i]`` maps aggregate i to its slot indices."""
    slots: List[Tuple[str, Optional[str], bool]] = []
    index: Dict[Tuple[str, Optional[str], bool], int] = {}

    def slot(kind, col, isint):
        key = (kind, col, isint)
        got = index.get(key)
        if got is None:
            got = index[key] = len(slots)
            slots.append(key)
        return got

    refs: List[List[int]] = []
    for _, fn, c in aggs:
        if fn not in _GROUPED_AGG_FNS:
            raise DeviceUnsupported(f"unsupported grouped aggregate fn {fn!r}")
        if fn == "count" and c is None:
            refs.append([slot("cntm", None, True)])
            continue
        if c is None:
            raise DeviceUnsupported(f"aggregate {fn!r} without an input column")
        ii = bool(is_int[c])
        if fn == "count":
            refs.append([slot("cnt", c, ii)])
        elif fn == "sum":
            refs.append([slot("sum", c, ii), slot("cnt", c, ii)])
        elif fn == "min":
            refs.append([slot("min", c, ii), slot("cnt", c, ii)])
        elif fn == "max":
            refs.append([slot("max", c, ii), slot("cnt", c, ii)])
        elif fn == "avg":
            # float64 sum even for int inputs; exact below 2^53
            refs.append([slot("sum", c, False), slot("cnt", c, ii)])
        else:  # stddev_samp
            refs.append([slot("cnt", c, ii), slot("sum", c, False), slot("sumsq", c, False)])
    return slots, refs


def _key_code(k: torch.Tensor, tag: str) -> torch.Tensor:
    """int64 grouping code of an encoded key column: equality of codes ==
    group identity. Floats canonicalise (-0.0 -> +0.0, NaN -> one NaN, so NaN
    keys form ONE group like pandas dropna=False), then bitcast."""
    if tag == "f":
        kf = k.to(torch.float64)
        kf = torch.where(torch.isnan(kf), kf.new_full((), float("nan")), kf + 0.0)
        return kf.view(torch.int64)
    return k.to(torch.int64)


def _segment_ids(codes: List[torch.Tensor], mask: torch.Tensor):
    """The matched rows sorted so equal key tuples are adjacent, then
    rank-compressed. Returns (order: matched rows in sorted order, seg: their
    segment ids, starts: each segment's first position); ``starts.numel()``
    is the group count (read by the ``nonzero``, which waits)."""
    order = torch.nonzero(mask).squeeze(1)
    # least significant key first; stable sorts keep equal tuples in row order
    for c in reversed(codes):
        order = order[torch.sort(c[order], stable=True).indices]
    m = order.numel()
    change = torch.zeros(m, dtype=torch.bool, device=mask.device)
    if m:
        change[0] = True
        for c in codes:
            cs = c[order]
            change[1:] |= cs[1:] != cs[:-1]
    seg = torch.cumsum(change, 0) - 1
    starts = torch.nonzero(change).squeeze(1)
    return order, seg, starts


def _float_order_key(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 key ordered as the floats are, with -0.0 below +0.0
    (IEEE's total order); the map is its own inverse on int64 bit patterns
    (``_float_order_key(key).view(torch.float64)`` gives the float back)."""
    bits = x.view(torch.int64) if x.is_floating_point() else x
    return torch.where(bits < 0, bits ^ I64_MAX, bits)


def _seg_fold_float(v: torch.Tensor, seg: torch.Tensor, cap: int, how: str) -> torch.Tensor:
    """Segment min (``how="amin"``) or max of float64 values into ``cap``
    slots, as XLA's segment_min/max give them: -0.0 below +0.0 whatever the
    order of arrival (a float ``scatter_reduce_`` keeps the first of two
    equal zeros, and on CUDA the first is the first atomic), a NaN
    propagates, and an empty slot holds +inf (min) or -inf (max). The fold
    runs on order-preserving int64 keys, so it is exact on CUDA too."""
    fill = float("inf") if how == "amin" else float("-inf")
    init = _float_order_key(torch.full((cap,), fill, dtype=torch.float64, device=v.device))
    out = init.scatter_reduce_(0, seg, _float_order_key(v.to(torch.float64)), how, include_self=True)
    out = _float_order_key(out).view(torch.float64)
    seen = torch.zeros(cap, dtype=torch.int64, device=v.device).index_add_(0, seg, torch.isnan(v).to(torch.int64))
    return torch.where(seen > 0, out.new_full((), float("nan")), out)


def _segment_reduce_slots(cols_sorted, seg, starts, cap: int, slot_specs):
    """Per-slot segment reductions over the sorted matched rows into
    ``cap``-row tables; rows past the group count hold each reduction's
    identity. ``cols_sorted`` maps input column -> sorted values."""
    device = seg.device
    n_groups = starts.numel()
    ends = torch.cat([starts[1:], starts.new_full((1,), seg.numel())]) if n_groups else starts

    def seg_sum(v: torch.Tensor) -> torch.Tensor:
        return torch.zeros(cap, dtype=v.dtype, device=device).index_add_(0, seg, v)

    def seg_fold(v: torch.Tensor, how: str, fill) -> torch.Tensor:
        out = torch.full((cap,), fill, dtype=v.dtype, device=device)
        return out.scatter_reduce_(0, seg, v, how, include_self=True)

    out = []
    for kind, col, isint in slot_specs:
        if kind == "cntm":
            counts = torch.zeros(cap, dtype=torch.int64, device=device)
            counts[:n_groups] = ends - starts
            out.append(counts)
            continue
        x = cols_sorted[col]
        nn = None if isint else ~torch.isnan(x)
        if kind == "cnt":
            if nn is None:
                counts = torch.zeros(cap, dtype=torch.int64, device=device)
                counts[:n_groups] = ends - starts
                out.append(counts)
            else:
                out.append(seg_sum(nn.to(torch.int64)))
        elif kind == "sum":
            z = x.to(torch.int64) if isint else x.to(torch.float64)
            out.append(seg_sum(z if nn is None else torch.where(nn, z, z.new_zeros(()))))
        elif kind == "sumsq":
            xf = x.to(torch.float64)
            out.append(seg_sum(xf * xf if nn is None else torch.where(nn, xf * xf, xf.new_zeros(()))))
        elif kind == "min":
            if isint:
                out.append(seg_fold(x.to(torch.int64), "amin", I64_MAX))
            else:
                xf = x.to(torch.float64)
                out.append(_seg_fold_float(torch.where(nn, xf, xf.new_full((), float("inf"))), seg, cap, "amin"))
        else:  # max
            if isint:
                out.append(seg_fold(x.to(torch.int64), "amax", I64_MIN))
            else:
                xf = x.to(torch.float64)
                out.append(_seg_fold_float(torch.where(nn, xf, xf.new_full((), float("-inf"))), seg, cap, "amax"))
    return tuple(out)


def grouped_chunk_program(pred_fn, key_specs, slot_specs, cap: int):
    """The ``grouped-agg-chunk`` program: filter -> group-by -> segment
    reduce. ``program(cols, lits, n, row_base)`` returns (n_groups, fs,
    key_out, slot_out): the group count (a host int), per group its first
    matched row plus ``row_base`` (appearance order), its key values
    gathered from that row (so -0.0/NaN payloads follow appearance order
    like pandas) and its state slots, each ``cap`` rows. Above ``cap``
    groups only the count is returned, and the caller re-runs at a larger
    capacity, as the JAX package does."""

    def program(cols, lits, n: int, row_base: int):
        device = next(iter(cols.values())).device
        mask = _full_mask(pred_fn, cols, lits, n, device)
        codes = [_key_code(cols[name], tag) for name, tag in key_specs]
        order, seg, starts = _segment_ids(codes, mask)
        n_groups = starts.numel()
        if n_groups > cap:
            return n_groups, None, None, None
        # the first sorted row of a segment is its smallest matched row
        rep = torch.full((cap,), I64_MAX, dtype=torch.int64, device=device)
        rep[:n_groups] = order[starts]
        fs = torch.where(rep < n, rep + row_base, rep.new_full((), _FS_SENTINEL))
        repc = torch.clamp(rep, 0, n - 1)
        key_out = tuple(cols[name][repc] for name, _ in key_specs)
        cols_sorted = {c: cols[c][order] for _, c, _ in slot_specs if c is not None}
        slot_out = _segment_reduce_slots(cols_sorted, seg, starts, cap, slot_specs)
        return n_groups, fs, key_out, slot_out

    return program


def _merge_concat_parts(key_specs, slot_specs, cap_out: int, kcat, slots_cat, fs_cat):
    """Merge CONCATENATED partial-aggregate tables (only their groups' rows)
    into one of ``cap_out`` rows: re-rank the keys and segment-reduce each
    slot with its merge operation (cnt/sum/sumsq add, min/max fold).
    Returns (n_groups, fs, key_out, slot_out) as ``grouped_chunk_program``
    does.

    Contract (the JAX package's): the parts are concatenated in ascending
    order of their rows' global range, so a group's smallest concat
    position is a row of the part where it first appeared, and the key
    gathered from it is the one a single pass would have kept."""
    device = fs_cat.device
    m = fs_cat.shape[0]
    codes = [_key_code(k, tag) for k, (_, tag) in zip(kcat, key_specs)]
    order, seg, starts = _segment_ids(codes, torch.ones(m, dtype=torch.bool, device=device))
    n_groups = starts.numel()
    rep = order[starts]  # the stable sorts put each group's first concat row first
    key_out = []
    for k in kcat:
        out = torch.full((cap_out,), float("nan") if k.is_floating_point() else 0, dtype=k.dtype, device=device)
        out[:n_groups] = k[rep]
        key_out.append(out)
    # values reduced per segment follow the SORTED row order ``seg`` is over
    fs = torch.full((cap_out,), _FS_SENTINEL, dtype=torch.int64, device=device)
    fs = fs.scatter_reduce_(0, seg, fs_cat[order], "amin", include_self=True)
    slot_out = []
    for (kind, _, _), v in zip(slot_specs, slots_cat):
        v = v[order]
        if kind in ("cntm", "cnt", "sum", "sumsq"):
            slot_out.append(torch.zeros(cap_out, dtype=v.dtype, device=device).index_add_(0, seg, v))
        elif v.is_floating_point():
            slot_out.append(_seg_fold_float(v, seg, cap_out, "amin" if kind == "min" else "amax"))
        else:
            fill = I64_MAX if kind == "min" else I64_MIN
            slot_out.append(torch.full((cap_out,), fill, dtype=v.dtype, device=device)
                            .scatter_reduce_(0, seg, v, "amin" if kind == "min" else "amax", include_self=True))
    return n_groups, fs, tuple(key_out), tuple(slot_out)


def grouped_merge_program(key_specs, slot_specs, cap_in: int, cap_out: int):
    """The ``grouped-merge`` program: merge two partial-aggregate tables,
    each padded to ``cap_in`` rows, into one of ``cap_out``.
    ``program(keys_a, keys_b, slots_a, slots_b, fs_a, fs_b, n_a, n_b)``
    takes each table's first ``n`` rows; the running partial is table a,
    and its groups were first seen no later than the incoming chunk's (the
    row bases ascend), which is ``_merge_concat_parts``'s ordering
    contract."""

    def program(keys_a, keys_b, slots_a, slots_b, fs_a, fs_b, n_a: int, n_b: int):
        assert max(n_a, n_b) <= cap_in
        kcat = tuple(torch.cat([a[:n_a], b[:n_b]]) for a, b in zip(keys_a, keys_b))
        slots_cat = tuple(torch.cat([va[:n_a], vb[:n_b]]) for va, vb in zip(slots_a, slots_b))
        fs_cat = torch.cat([fs_a[:n_a], fs_b[:n_b]])
        return _merge_concat_parts(key_specs, slot_specs, cap_out, kcat, slots_cat, fs_cat)

    return program


def _dev_pad(arr: torch.Tensor, target: int, fill) -> torch.Tensor:
    """Pad a (small, per-group) device tensor up to ``target`` rows."""
    n = arr.shape[0]
    if n == target:
        return arr
    return torch.cat([arr, arr.new_full((target - n,), fill)])


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class GroupedAggStream:
    """Grouped aggregation with a device-resident per-group table.

    ``update(batch, condition)`` fuses the scan predicate with the grouped
    segment reduction over the batch; ``finalize()`` pulls only the
    per-group table back and reconstructs exact host-path semantics (NULL
    sums, NaN-skipping counts, dtype-preserving min/max, appearance-ordered
    rows).

    ``update`` of a further chunk merges its table into the running one
    (``grouped-merge``, ``_merge``): the streamed aggregate's device path.

    String group keys are grouped per chunk in the chunk's dictionary
    codes, then the per-group codes map into one growing stream-global
    dictionary on the host, between the chunk and the merge — O(groups)
    host traffic, never O(rows).

    The JAX package also folds whole stages (fusion, donated state); that
    raises here: it is not yet in the port.

    Raises DeviceUnsupported whenever the shape, a dtype, or the observed
    group cardinality (> ``max_groups``) leaves the device language; callers
    fall back (or spill) to the host path.
    """

    def __init__(self, session, group_keys, aggs, *, max_groups: int, cap_floor: int, hint_key=None):
        if not group_keys:
            raise DeviceUnsupported("global aggregates take the fused-scalar path")
        self.session = session
        self.group_keys = list(group_keys)
        self.aggs = [(name, fn, c) for name, fn, c in aggs]
        self.max_groups = int(max_groups)
        self.cap_floor = max(1, int(cap_floor))
        self._schema = None  # per-key (tag, dtype, unit) + per-input dtype
        self._slots = None
        self._refs = None
        self._partial = None  # dict(cap, n, fs, keys, slots)
        self._row_base = 0  # rows of the chunks before this one
        # seed capacity from the last observed cardinality of the same query
        # shape over the same scan: a fresh stream otherwise starts at the
        # floor and pays a right-sizing re-run on EVERY repeated (warm) query
        self._hint_key = (
            (hint_key, tuple(self.group_keys), tuple((fn, c) for _, fn, c in self.aggs))
            if hint_key is not None
            else None
        )
        self._cap_hint = _CAP_HINT_MEMO.get(self._hint_key, 1)
        self._strmaps: Dict[str, Dict[str, int]] = {}
        self._struniq: Dict[str, List] = {}

    # -- schema ---------------------------------------------------------------

    def _key_tag(self, arr: np.ndarray) -> str:
        kind = arr.dtype.kind
        if kind in ("i", "u", "b"):
            return "i"
        if kind == "f":
            return "f"
        if kind == "M":
            return "d"
        if kind in ("U", "S", "O"):
            return "s"
        raise DeviceUnsupported(f"unsupported group-key dtype {arr.dtype}")

    def _check_schema(self, batch: B.Batch):
        keys_schema = []
        for k in self.group_keys:
            arr = batch[k]
            tag = self._key_tag(arr)
            unit = np.datetime_data(arr.dtype)[0] if tag == "d" else None
            keys_schema.append((tag, arr.dtype, unit))
        inputs = {}
        for _, fn, c in self.aggs:
            if c is None:
                continue
            kind = batch[c].dtype.kind
            if kind not in ("i", "u", "b", "f"):
                raise DeviceUnsupported(f"grouped aggregate over non-numeric column {c!r}")
            inputs[c] = batch[c].dtype
        if self._schema is None:
            self._schema = (keys_schema, inputs)
            self._slots, self._refs = _grouped_slots(
                self.aggs, {c: dt.kind in ("i", "u", "b") for c, dt in inputs.items()}
            )
            return
        prev_keys, prev_inputs = self._schema
        if [k[:1] + (k[2],) for k in prev_keys] != [k[:1] + (k[2],) for k in keys_schema] or {
            c: dt.kind in ("i", "u", "b") for c, dt in prev_inputs.items()
        } != {c: dt.kind in ("i", "u", "b") for c, dt in inputs.items()}:
            raise DeviceUnsupported("chunk schema drift under grouped aggregate")

    @property
    def has_data(self) -> bool:
        return self._partial is not None

    # -- update ---------------------------------------------------------------

    def update(self, batch: B.Batch, condition: Optional[Expr] = None, scan_key=None) -> None:
        n = B.num_rows(batch)
        if n == 0:
            return
        refs = sorted(condition.references()) if condition is not None else []
        agg_inputs = sorted({c for _, _, c in self.aggs if c is not None})
        for col in refs + agg_inputs + self.group_keys:
            if col not in batch:
                raise DeviceUnsupported(f"column {col!r} missing from batch")
        self._check_schema(batch)
        keys_schema, _ = self._schema
        if condition is not None:
            _pack_literals(compile_predicate(condition, _dry_codecs(batch, refs))[1])
        if self.session.conf.fusion_enabled and not any(tag == "s" for tag, _, _ in keys_schema):
            raise NotImplementedError(
                "the whole-stage fused grouped aggregate (hyperspace.exec.fusion.enabled) is not yet in the port"
            )

        dev_cols, codecs = _device_columns(
            self.session, batch, sorted(set(refs) | set(agg_inputs) | set(self.group_keys)), scan_key, n
        )
        for col in agg_inputs:
            if codecs[col].kind == "string":
                raise DeviceUnsupported("string aggregate inputs stay host-side")

        t = time.perf_counter()
        if condition is not None:
            pred_fn, lit_values = compile_predicate(condition, codecs)
        else:
            pred_fn, lit_values = None, ()
        lits = upload_literals(lit_values, self.session.device)
        key_specs = tuple(
            (name, "f" if tag == "f" else "i") for name, (tag, _, _) in zip(self.group_keys, keys_schema)
        )
        cap = group_capacity(max(self._cap_hint, 1), self.cap_floor)
        while True:
            program = grouped_chunk_program(pred_fn, key_specs, self._slots, cap)
            n_g, fs, key_out, slot_out = program(dev_cols, lits, n, self._row_base)
            dispatches["grouped-agg-chunk"] += 1
            if n_g > self.max_groups:
                t = _add(self.session, "agg_program", t)
                # this chunk is NOT in the running partial (folded is False)
                raise GroupCapacityExceeded(f"group cardinality {n_g} exceeds maxGroups {self.max_groups}")
            if n_g <= cap:
                break
            cap = group_capacity(n_g, self.cap_floor)  # one re-run, right-sized
        self._cap_hint = max(self._cap_hint, n_g)

        key_out = list(key_out)
        for i, (name, (tag, _, _)) in enumerate(zip(self.group_keys, keys_schema)):
            if tag == "s":
                key_out[i] = torch.from_numpy(
                    self._remap_string_key(name, key_out[i], codecs[name], n_g, cap)
                ).to(self.session.device)
        new = {"cap": cap, "n": n_g, "fs": fs, "keys": key_out, "slots": list(slot_out)}
        self._row_base += n
        _add(self.session, "agg_program", t)
        if self._partial is None:
            self._partial = new
        else:
            self._merge(new)

    def _remap_string_key(self, name, dev_codes, codec: ColumnCodec, n_g: int, cap: int) -> np.ndarray:
        """Dictionary codes -> stream-global int64 codes (a host remap of
        only the per-group representatives; -1 null stays -1)."""
        local = _np(dev_codes)[:n_g]
        mapping = self._strmaps.setdefault(name, {})
        uniq = self._struniq.setdefault(name, [])
        out = np.full(cap, -1, dtype=np.int64)
        for j, code in enumerate(local):
            if code < 0:
                continue
            val = codec.uniques[int(code)]
            got = mapping.get(val)
            if got is None:
                got = mapping[val] = len(uniq)
                uniq.append(val)
            out[j] = got
        return out

    def _merge(self, new) -> None:
        """Fold a chunk's table into the running partial on the device
        (``grouped-merge``). Raises GroupCapacityExceeded with ``folded``
        set when the merged table holds more than ``maxGroups`` groups: the
        merged partial is still valid, and the caller hands it to the host
        before spilling."""
        t = time.perf_counter()
        a, b = self._partial, new
        keys_schema, _ = self._schema
        key_specs = tuple(
            (name, "f" if tag == "f" else "i") for name, (tag, _, _) in zip(self.group_keys, keys_schema)
        )
        cap_in = max(a["cap"], b["cap"])
        for part in (a, b):
            if part["cap"] != cap_in:
                part["fs"] = _dev_pad(part["fs"], cap_in, _FS_SENTINEL)
                part["keys"] = [_dev_pad(k, cap_in, float("nan") if k.is_floating_point() else 0)
                                for k in part["keys"]]
                part["slots"] = [_dev_pad(v, cap_in, 0) for v in part["slots"]]
        cap_out = group_capacity(a["n"] + b["n"], self.cap_floor)
        program = grouped_merge_program(key_specs, self._slots, cap_in, cap_out)
        n_g, fs, key_out, slot_out = program(
            tuple(a["keys"]), tuple(b["keys"]), tuple(a["slots"]), tuple(b["slots"]),
            a["fs"], b["fs"], a["n"], b["n"],
        )
        dispatches["grouped-merge"] += 1
        self._partial = {"cap": cap_out, "n": n_g, "fs": fs, "keys": list(key_out), "slots": list(slot_out)}
        self._cap_hint = max(self._cap_hint, n_g)
        _add(self.session, "agg_merge", t)
        if n_g > self.max_groups:
            exc = GroupCapacityExceeded(f"group cardinality {n_g} exceeds maxGroups {self.max_groups}")
            exc.folded = True  # the chunk that crossed the limit IS in the partial
            raise exc

    # -- finalization ---------------------------------------------------------

    def _host_table(self):
        """Pull the per-group table to the host, appearance-ordered: decoded
        key arrays + raw slot arrays."""
        p = self._partial
        if p is None:
            raise DeviceUnsupported("no device partial to finalize")
        n = p["n"]
        keys_schema, _ = self._schema
        fs = _np(p["fs"])[:n]
        order = np.argsort(fs, kind="stable")
        key_cols = {}
        for name, (tag, dtype, unit), dev in zip(self.group_keys, keys_schema, p["keys"]):
            vals = _np(dev)[:n][order]
            if tag == "s":
                uniq = self._struniq.get(name, [])
                out = np.full(n, np.nan, dtype=object)
                pos = vals >= 0
                if pos.any():
                    lut = np.asarray(uniq, dtype=object)
                    out[pos] = lut[vals[pos].astype(np.int64)]
                key_cols[name] = out
            elif tag == "d":
                key_cols[name] = vals.astype(np.int64).view(f"M8[{unit}]")
            else:
                key_cols[name] = vals.astype(dtype)
        slot_cols = [_np(s)[:n][order] for s in p["slots"]]
        return n, key_cols, slot_cols

    def finalize(self) -> B.Batch:
        """Per-group final values with host-path semantics: count -> int64,
        int sum -> int64 (exact), float sum/min/max -> NULL (NaN) when every
        matched row was NULL, int min/max keep the input dtype, avg/stddev
        from the decomposed states. Rows in first-appearance order, exactly
        like pandas groupby(sort=False)."""
        if self._hint_key is not None:
            if len(_CAP_HINT_MEMO) >= 4096:  # bound pathological key churn
                _CAP_HINT_MEMO.clear()
            _CAP_HINT_MEMO[self._hint_key] = self._cap_hint
        t = time.perf_counter()
        n, key_cols, slot_cols = self._host_table()
        t = _add(self.session, "agg_program", t)
        _, input_dtypes = self._schema
        out: B.Batch = dict(key_cols)
        for (name, fn, c), ref in zip(self.aggs, self._refs):
            if fn == "count":
                out[name] = slot_cols[ref[0]].astype(np.int64)
                continue
            dt = input_dtypes[c]
            is_int = dt.kind in ("i", "u", "b")
            if fn == "sum":
                s, cnt = slot_cols[ref[0]], slot_cols[ref[1]]
                if is_int:
                    out[name] = s.astype(np.int64)  # int inputs have no NULLs
                else:
                    out[name] = np.where(cnt > 0, s.astype(np.float64), np.nan)
            elif fn in ("min", "max"):
                v, cnt = slot_cols[ref[0]], slot_cols[ref[1]]
                if is_int:
                    out[name] = v.astype(dt if dt.kind != "u" else np.int64)
                else:
                    out[name] = np.where(cnt > 0, v.astype(np.float64), np.nan)
            elif fn == "avg":
                s, cnt = slot_cols[ref[0]], slot_cols[ref[1]]
                with np.errstate(invalid="ignore", divide="ignore"):
                    out[name] = np.where(cnt > 0, s / np.maximum(cnt, 1), np.nan)
            else:  # stddev_samp
                cnt, s, ss = (slot_cols[r] for r in ref)
                with np.errstate(invalid="ignore", divide="ignore"):
                    m = cnt > 1
                    var = np.where(
                        m,
                        (ss - (s * s) / np.maximum(cnt, 1)) / np.maximum(cnt - 1, 1),
                        np.nan,
                    )
                    out[name] = np.sqrt(np.clip(var, 0.0, None))
        _add(self.session, "agg_finalize", t)
        return out


    def to_partial_frame(self, plain):
        """The running device partial as ONE host partial frame in the
        streamed aggregate's merge format (``__p{i}`` columns per aggregate
        index ``i``): the spill path hands the accumulated device state to
        the host combine without recomputing any chunk."""
        import pandas as pd

        t = time.perf_counter()
        n, key_cols, slot_cols = self._host_table()
        _add(self.session, "agg_program", t)
        _, input_dtypes = self._schema
        frame = dict(key_cols)
        refs_by_name = {name: ref for (name, _, _), ref in zip(self.aggs, self._refs)}
        for i, name, fn, c in plain:
            ref = refs_by_name[name]
            p = f"__p{i}"
            if fn == "count":
                frame[p] = slot_cols[ref[0]].astype(np.int64)
            elif fn in ("sum", "min", "max"):
                v, cnt = slot_cols[ref[0]], slot_cols[ref[1]]
                dt = input_dtypes[c]
                if dt.kind in ("i", "u", "b"):
                    if fn == "sum":
                        frame[p] = v.astype(np.int64)
                    else:
                        frame[p] = v.astype(dt if dt.kind != "u" else np.int64)
                else:
                    frame[p] = np.where(cnt > 0, v.astype(np.float64), np.nan)
            elif fn == "avg":
                s, cnt = slot_cols[ref[0]], slot_cols[ref[1]]
                frame[p + "_s"] = np.where(cnt > 0, s.astype(np.float64), np.nan)
                frame[p + "_c"] = cnt.astype(np.int64)
            else:  # stddev_samp
                cnt, s, ss = (slot_cols[r] for r in ref)
                frame[p + "_n"] = cnt.astype(np.int64)
                frame[p + "_s"] = np.where(cnt > 0, s.astype(np.float64), np.nan)
                frame[p + "_ss"] = ss.astype(np.float64)
        return pd.DataFrame(frame)


_CAP_HINT_MEMO: Dict[tuple, int] = {}


def device_grouped_aggregate(
    session,
    batch: B.Batch,
    condition: Optional[Expr],
    group_keys,
    aggs,
    scan_key=None,
    *,
    max_groups: int,
    cap_floor: int,
) -> B.Batch:
    """One-shot fused filter -> grouped aggregate over a materialized scan
    batch. Raises DeviceUnsupported outside the device language or beyond
    ``max_groups`` cardinality."""
    if B.num_rows(batch) == 0:
        raise DeviceUnsupported("empty input stays host-side")
    stream = GroupedAggStream(
        session, group_keys, aggs, max_groups=max_groups, cap_floor=cap_floor, hint_key=scan_key
    )
    stream.update(batch, condition, scan_key=scan_key)
    return stream.finalize()
