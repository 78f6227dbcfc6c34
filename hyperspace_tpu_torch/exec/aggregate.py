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
  ``fused_grouped_update_program`` device.py:1344-1377 ``fused-stage-agg``:
                                 the chunk program and the merge into the
                                 running table in one program
                                 (``hyperspace.exec.fusion.enabled``)
  ``_fused_state_dtypes``        device.py:1380-1394
  ``GroupedAggStream``           device.py:1397-1921 capacity re-runs,
                                 ``maxGroups``, string-key remap, the
                                 chunk merge, finalize, the spill's
                                 partial frame
  ``device_grouped_aggregate``   device.py:1926-1953

Under ``hyperspace.parallel.enabled`` (a ``ShardedExecutor`` as
``parallel``) the stream runs the sharded twins of the chunk and fused
programs (parallel/collectives.py: ``sharded-grouped``,
``fused-stage-agg-sharded``), which merge the shards' tables on the device;
the merge between chunks stays ``grouped-merge``.

Where torch and JAX differ, the programs here do what JAX does:

- The grouped programs are fixed-shape, as JAX's are: every row of the
  chunk is sorted, ``jnp.lexsort`` becoming a chain of stable ``torch.sort``
  from the last key to the first, then the inverted mask, so the matched
  rows come first and keep their row order; the group count is a 0-d
  tensor, and every capacity overflow is decided on the device
  (``torch.where`` against the state). The caller reads the counts after
  the program, in one device-to-host copy.
- JAX's segment reductions drop the masked rows' out-of-range id; torch
  raises on the CPU and asserts on CUDA. Here a masked row (or a group
  past ``cap``) scatters into a scratch band of ``_SCRATCH_BAND`` slots
  past the table's ``cap`` (slot ``cap + position % band``), sliced off
  afterwards: no single address takes every masked row's atomic. Slots
  past ``n_groups`` hold each reduction's identity, as in JAX.
- A group's representative row, the segment min of the sorted row
  positions in JAX, is the row at its segment's head (the stable sorts
  keep a segment's rows in row order): one write a group, no atomic.
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

from hyperspace_tpu_torch.check import program_lint as _program_lint
from hyperspace_tpu_torch.exec import batch as B
from hyperspace_tpu_torch.exec import stage_ir, trace
from hyperspace_tpu_torch.exec.device import (
    ColumnCodec,
    DeviceUnsupported,
    _cached_column,
    _device_cache,
    _dry_codecs,
    _observe_program,
    program_clock,
    _pack_literals,
    _put_encoded,
    compile_predicate,
    count_dispatch,
    predicate_skeleton,
    program_key,
    upload_literals,
)
from hyperspace_tpu_torch.obs import spans as obs_spans
from hyperspace_tpu_torch.obs.metrics import REGISTRY
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
    agg_spec = tuple((fn, c) for _, fn, c in aggs)
    program = fused_agg_program(pred_fn, agg_spec)
    t0 = program_clock(session.device)
    lits = upload_literals(lit_values, session.device)
    with _program_lint.maybe_verify(session.conf, "fused-agg", lambda: program_key(
            "fused-agg", f"{_pred_skeleton(condition, codecs)}|a:{agg_spec}"), (dev_cols, lits)):
        outs, valids = program(dev_cols, lits, n)
    count_dispatch("fused-agg")
    outs, valids = _read_scalars(outs, valids)
    _observe_program("fused-agg", t0)
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


def _pred_skeleton(condition: Optional[Expr], codecs) -> str:
    return predicate_skeleton(condition, codecs) if condition is not None else "<none>"


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


#: width of the scratch band past a segment table's ``cap`` slots: a masked
#: row, or a row of a group past ``cap``, scatters into slot ``cap +
#: position % band`` (sliced off afterwards), so the rows a predicate drops
#: spread their atomics over the band instead of queueing on one address
_SCRATCH_BAND = 1024


def _segment_ids(codes: List[torch.Tensor], mask: torch.Tensor, cap: int):
    """Every row sorted so equal key tuples are adjacent, masked rows last
    (the inverted mask is the most significant key), then rank-compressed.
    Returns (order, the sorted mask, n_groups as a 0-d tensor, scatter ids):
    a matched row's id is its segment when that is below ``cap``, every
    other row's a slot of the scratch band. Needs at least one row."""
    order = None
    # least significant key first; stable sorts keep equal tuples in row order
    for c in reversed(codes):
        idx = torch.sort(c if order is None else c[order], stable=True).indices
        order = idx if order is None else order[idx]
    order = order[torch.sort((~mask).to(torch.uint8)[order], stable=True).indices]
    ms = mask[order]
    change = ms[1:] != ms[:-1]
    for c in codes:
        cs = c[order]
        change = change | (cs[1:] != cs[:-1])
    seg = torch.cat([torch.zeros(1, dtype=torch.int64, device=mask.device), torch.cumsum(change, 0)])
    n_groups = torch.where(ms, seg, -1).amax() + 1
    pos = torch.arange(seg.numel(), device=mask.device)
    ids = torch.where(ms & (seg < cap), seg, cap + pos % _SCRATCH_BAND)
    return order, ms, n_groups, ids


def _segment_rep(order: torch.Tensor, ids: torch.Tensor, cap: int) -> torch.Tensor:
    """Per segment below ``cap`` its smallest row (JAX's segment min of the
    sorted row positions), I64_MAX for an empty one. The stable sorts keep a
    segment's rows in row order, so the smallest is the row at the
    segment's head: one write a segment, and no atomic."""
    pos = torch.arange(ids.numel(), device=ids.device)
    head = torch.cat([ids.new_ones(1, dtype=torch.bool), ids[1:] != ids[:-1]]) & (ids < cap)
    dst = torch.where(head, ids, cap + pos % _SCRATCH_BAND)
    out = torch.full((cap + _SCRATCH_BAND,), I64_MAX, dtype=torch.int64, device=ids.device)
    return out.scatter_(0, dst, order)[:cap]


def _float_order_key(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 key ordered as the floats are, with -0.0 below +0.0
    (IEEE's total order); the map is its own inverse on int64 bit patterns
    (``_float_order_key(key).view(torch.float64)`` gives the float back)."""
    bits = x.view(torch.int64) if x.is_floating_point() else x
    return torch.where(bits < 0, bits ^ I64_MAX, bits)


def _seg_fold_float(v: torch.Tensor, seg: torch.Tensor, cap: int, how: str) -> torch.Tensor:
    """Segment min (``how="amin"``) or max of float64 values into ``cap``
    slots (ids of the scratch band past them are dropped), as XLA's
    segment_min/max give them: -0.0 below +0.0 whatever the order of
    arrival (a float ``scatter_reduce_`` keeps the first of two equal
    zeros, and on CUDA the first is the first atomic), a NaN propagates,
    and an empty slot holds +inf (min) or -inf (max). The fold runs on
    order-preserving int64 keys, so it is exact on CUDA too."""
    width = cap + _SCRATCH_BAND
    fill = float("inf") if how == "amin" else float("-inf")
    init = _float_order_key(torch.full((width,), fill, dtype=torch.float64, device=v.device))
    out = init.scatter_reduce_(0, seg, _float_order_key(v.to(torch.float64)), how, include_self=True)[:cap]
    out = _float_order_key(out).view(torch.float64)
    seen = torch.zeros(width, dtype=torch.int64, device=v.device).index_add_(0, seg, torch.isnan(v).to(torch.int64))
    return torch.where(seen[:cap] > 0, out.new_full((), float("nan")), out)


def _seg_sum(v: torch.Tensor, ids: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.zeros(cap + _SCRATCH_BAND, dtype=v.dtype, device=v.device).index_add_(0, ids, v)[:cap]


def _seg_fold_int(v: torch.Tensor, ids: torch.Tensor, cap: int, how: str) -> torch.Tensor:
    fill = I64_MAX if how == "amin" else I64_MIN
    out = torch.full((cap + _SCRATCH_BAND,), fill, dtype=v.dtype, device=v.device)
    return out.scatter_reduce_(0, ids, v, how, include_self=True)[:cap]


def _segment_reduce_slots(cols_sorted, ms, ids, cap: int, slot_specs):
    """Per-slot segment reductions over the sorted rows into ``cap``-row
    tables; a masked row adds nothing to its group (its id is in the
    scratch band), and rows past the group count hold each reduction's
    identity. ``cols_sorted`` maps input column -> sorted values."""
    matched = None  # the segment sum of the mask: count(*) and every int count

    out = []
    for kind, col, isint in slot_specs:
        if kind == "cntm" or (kind == "cnt" and isint):
            if matched is None:
                matched = _seg_sum(ms.to(torch.int64), ids, cap)
            out.append(matched)
            continue
        x = cols_sorted[col]
        nn = None if isint else ~torch.isnan(x)
        if kind == "cnt":
            out.append(_seg_sum(nn.to(torch.int64), ids, cap))
        elif kind == "sum":
            z = x.to(torch.int64) if isint else x.to(torch.float64)
            out.append(_seg_sum(z if nn is None else torch.where(nn, z, z.new_zeros(())), ids, cap))
        elif kind == "sumsq":
            xf = x.to(torch.float64)
            out.append(_seg_sum(xf * xf if nn is None else torch.where(nn, xf * xf, xf.new_zeros(())), ids, cap))
        elif isint:
            out.append(_seg_fold_int(x.to(torch.int64), ids, cap, "amin" if kind == "min" else "amax"))
        else:
            xf = x.to(torch.float64)
            fill = xf.new_full((), float("inf") if kind == "min" else float("-inf"))
            out.append(_seg_fold_float(torch.where(nn, xf, fill), ids, cap, "amin" if kind == "min" else "amax"))
    return tuple(out)


def grouped_body(cols, mask: torch.Tensor, key_specs, slot_specs, cap: int):
    """Group the rows of ``cols`` that ``mask`` keeps and reduce each slot:
    (n_groups as a 0-d tensor, each group's smallest row or I64_MAX, its
    key values gathered from that row, its state slots), each ``cap`` rows.
    Above ``cap`` groups the tables hold the first ``cap`` and the count is
    still exact."""
    total = mask.shape[0]
    codes = [_key_code(cols[name], tag) for name, tag in key_specs]
    order, ms, n_groups, ids = _segment_ids(codes, mask, cap)
    rep = _segment_rep(order, ids, cap)
    repc = torch.clamp(rep, 0, total - 1)
    key_out = tuple(cols[name][repc] for name, _ in key_specs)
    cols_sorted = {c: cols[c][order] for _, c, _ in slot_specs if c is not None}
    return n_groups, rep, key_out, _segment_reduce_slots(cols_sorted, ms, ids, cap, slot_specs)


def grouped_chunk_program(pred_fn, key_specs, slot_specs, cap: int):
    """The ``grouped-agg-chunk`` program: filter -> group-by -> segment
    reduce. ``program(cols, lits, n, row_base)`` returns (n_groups, fs,
    key_out, slot_out): the group count (a 0-d tensor), per group its first
    matched row plus ``row_base`` (appearance order), its key values
    gathered from that row (so -0.0/NaN payloads follow appearance order
    like pandas) and its state slots, each ``cap`` rows. Above ``cap``
    groups the count is exact and the tables hold the first ``cap``
    groups; the caller re-runs at a larger capacity, as the JAX package
    does."""

    def program(cols, lits, n: int, row_base: int):
        device = next(iter(cols.values())).device
        mask = _full_mask(pred_fn, cols, lits, n, device)
        n_groups, rep, key_out, slot_out = grouped_body(cols, mask, key_specs, slot_specs, cap)
        fs = torch.where(rep < n, rep + row_base, rep.new_full((), _FS_SENTINEL))
        return n_groups, fs, key_out, slot_out

    return program


def _merge_concat_parts(key_specs, slot_specs, cap_out: int, kcat, slots_cat, fs_cat, mask):
    """Merge CONCATENATED partial-aggregate tables (the rows ``mask`` keeps)
    into one of ``cap_out`` rows: re-rank the keys and segment-reduce each
    slot with its merge operation (cnt/sum/sumsq add, min/max fold).
    Returns (n_groups, fs, key_out, slot_out) as ``grouped_chunk_program``
    does.

    Contract (the JAX package's): the parts are concatenated in ascending
    order of their rows' global range, so a group's smallest concat
    position is a row of the part where it first appeared, and the key
    gathered from it is the one a single pass would have kept."""
    total = mask.shape[0]
    codes = [_key_code(k, tag) for k, (_, tag) in zip(kcat, key_specs)]
    order, _, n_groups, ids = _segment_ids(codes, mask, cap_out)
    repc = torch.clamp(_segment_rep(order, ids, cap_out), 0, total - 1)
    key_out = tuple(k[repc] for k in kcat)
    # values reduced per segment follow the SORTED row order ``ids`` is over
    fs = _seg_fold_int(fs_cat[order], ids, cap_out, "amin")
    slot_out = []
    for (kind, _, _), v in zip(slot_specs, slots_cat):
        v = v[order]
        if kind in ("cntm", "cnt", "sum", "sumsq"):
            slot_out.append(_seg_sum(v, ids, cap_out))
        elif v.is_floating_point():
            slot_out.append(_seg_fold_float(v, ids, cap_out, "amin" if kind == "min" else "amax"))
        else:
            slot_out.append(_seg_fold_int(v, ids, cap_out, "amin" if kind == "min" else "amax"))
    return n_groups, fs, key_out, tuple(slot_out)


def _concat_mask(cap_a: int, n_a, cap_b: int, n_b, device) -> torch.Tensor:
    """The rows of two concatenated tables that hold a group: the first
    ``n_a`` of ``cap_a`` and the first ``n_b`` of ``cap_b`` (host ints or
    0-d tensors)."""
    return torch.cat([torch.arange(cap_a, device=device) < n_a, torch.arange(cap_b, device=device) < n_b])


def grouped_merge_program(key_specs, slot_specs, cap_in: int, cap_out: int):
    """The ``grouped-merge`` program: merge two partial-aggregate tables,
    each padded to ``cap_in`` rows, into one of ``cap_out``.
    ``program(keys_a, keys_b, slots_a, slots_b, fs_a, fs_b, n_a, n_b)``
    masks each table to its first ``n`` rows; the running partial is table
    a, and its groups were first seen no later than the incoming chunk's
    (the row bases ascend), which is ``_merge_concat_parts``'s ordering
    contract."""

    def program(keys_a, keys_b, slots_a, slots_b, fs_a, fs_b, n_a, n_b):
        mask = _concat_mask(cap_in, n_a, cap_in, n_b, fs_a.device)
        kcat = tuple(torch.cat([a, b]) for a, b in zip(keys_a, keys_b))
        slots_cat = tuple(torch.cat([va, vb]) for va, vb in zip(slots_a, slots_b))
        return _merge_concat_parts(key_specs, slot_specs, cap_out, kcat, slots_cat, torch.cat([fs_a, fs_b]), mask)

    return program


def _dev_pad(arr: torch.Tensor, target: int, fill) -> torch.Tensor:
    """Pad a (small, per-group) device tensor up to ``target`` rows."""
    n = arr.shape[0]
    if n == target:
        return arr
    return torch.cat([arr, arr.new_full((target - n,), fill)])


def _fused_state_dtypes(key_specs, slot_specs):
    """(dtype per group key, dtype per state slot) of the fused fold state:
    exactly those of the chunk and merge programs' outputs, so the merged
    table copies into the state without a cast."""
    key_dts = tuple(torch.float64 if tag == "f" else torch.int64 for _, tag in key_specs)
    slot_dts = tuple(
        torch.int64 if (kind in ("cntm", "cnt") or (isint and kind in ("sum", "min", "max"))) else torch.float64
        for kind, _, isint in slot_specs
    )
    return key_dts, slot_dts


def fold_into_state(key_specs, slot_specs, cap: int, donate: bool,
                    state_keys, state_slots, state_fs, state_n, key_b, slot_b, fs_b, n_b, ok=None):
    """Merge a chunk's ``cap``-row per-group table (its first ``n_b`` rows)
    into the running ``cap``-row state (its first ``state_n`` rows), state
    first: ``_merge_concat_parts``'s first-seen contract, the
    ``grouped-merge`` body. Returns ``(n_merged, n_out, fs, keys, slots)``.
    The fold takes when ``(n_b <= cap) & (n_merged <= cap)`` (and ``ok``, a
    0-d bool, where given), decided on the device: else ``n_out`` is
    ``state_n`` and every output holds the state's values. With ``donate``
    the selected table is written into the state tensors (``copy_``; their
    storage stays, and on an overflow they take their own values back),
    else the outputs are fresh tensors."""
    mask = _concat_mask(cap, state_n, cap, n_b, state_fs.device)
    kcat = tuple(torch.cat([a, b]) for a, b in zip(state_keys, key_b))
    scat = tuple(torch.cat([a, b]) for a, b in zip(state_slots, slot_b))
    n_m, fs_m, key_m, slot_m = _merge_concat_parts(
        key_specs, slot_specs, cap, kcat, scat, torch.cat([state_fs, fs_b]), mask)
    fits = (n_b <= cap) & (n_m <= cap)
    if ok is not None:
        fits = fits & ok
    state = (state_fs, *state_keys, *state_slots)
    out = [torch.where(fits, m, s) for m, s in zip((fs_m, *key_m, *slot_m), state)]
    if donate:
        for dst, src in zip(state, out):
            dst.copy_(src)
        out = state
    n_k = len(state_keys)
    return n_m, torch.where(fits, n_m, state_n), out[0], tuple(out[1:1 + n_k]), tuple(out[1 + n_k:])


def fused_grouped_update_program(pred_fn, key_specs, slot_specs, cap: int, donate: bool):
    """The ``fused-stage-agg`` program (``hyperspace.exec.fusion.enabled``):
    the chunk's filter, group and segment reduction (``grouped_chunk_program``)
    AND the merge into the running partial (``fold_into_state``) as one
    program, so a streamed chunk costs one dispatch and, with ``donate``,
    the state keeps its storage.

    ``program(state_keys, state_slots, state_fs, state_n, cols, lits, n,
    row_base)`` returns ``(n_b, n_m, n_out, fs, keys, slots)``, the counts
    as 0-d tensors. Overflow contract: the counts are exact above ``cap``;
    above ``cap`` groups in the chunk (``n_b``) or in the merge (``n_m``)
    every state output holds the state's values, ``n_out`` is
    ``state_n``, and the caller redoes the chunk per-family."""
    chunk = grouped_chunk_program(pred_fn, key_specs, slot_specs, cap)

    def program(state_keys, state_slots, state_fs, state_n, cols, lits, n: int, row_base: int):
        n_b, fs_b, key_b, slot_b = chunk(cols, lits, n, row_base)
        n_m, n_out, fs_out, keys_out, slots_out = fold_into_state(
            key_specs, slot_specs, cap, donate, state_keys, state_slots, state_fs, state_n,
            key_b, slot_b, fs_b, n_b,
        )
        return n_b, n_m, n_out, fs_out, keys_out, slots_out

    return program


def read_counts(*counts) -> List[int]:
    """A program's 0-d counts as host ints, in one device-to-host copy: the
    one read of a grouped program's window, made after it."""
    return [int(v) for v in torch.stack([c.to(torch.int64) for c in counts]).cpu().tolist()]


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

    Under ``hyperspace.exec.fusion.enabled`` a chunk with no string group
    key folds with ONE program instead (``fused-stage-agg``,
    ``_update_fused``), its state updated in place with
    ``hyperspace.exec.fusion.donation``; a capacity overflow redoes the
    chunk per-family, counted in ``trace.fallbacks[("fusion",
    "grouped-overflow")]``.

    Raises DeviceUnsupported whenever the shape, a dtype, or the observed
    group cardinality (> ``max_groups``) leaves the device language; callers
    fall back (or spill) to the host path.
    """

    def __init__(self, session, group_keys, aggs, *, max_groups: int, cap_floor: int, hint_key=None,
                 parallel=None):
        if not group_keys:
            raise DeviceUnsupported("global aggregates take the fused-scalar path")
        self.session = session
        # a ShardedExecutor (parallel/executor.py) switches the chunk
        # programs to their sharded twins (parallel/collectives.py), whose
        # per-shard tables merge on the device
        self._parallel = parallel
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
        if stage_ir.fusion_wanted(self.session.conf) and not any(tag == "s" for tag, _, _ in keys_schema):
            # whole-stage fold: the chunk program and the merge in ONE
            # dispatch. String group keys stay per-family: their chunk ->
            # global dictionary remap is a host step between the two
            skeleton = (
                f"{_pred_skeleton(condition, codecs)}"
                f"|k:{','.join(f'{n_}:{t_}' for n_, t_ in key_specs)}"
                f"|s:{','.join(f'{k_}:{c_}:{int(i_)}' for k_, c_, i_ in self._slots)}"
            )
            folded = self._update_fused(dev_cols, lits, pred_fn, key_specs, skeleton, n)
            _add(self.session, "agg_program", t)
            if folded:
                return
            trace.fallback("fusion", "grouped-overflow")
            t = time.perf_counter()
        cap = group_capacity(max(self._cap_hint, 1), self.cap_floor)
        px = self._parallel
        family = "sharded-grouped" if px is not None else "grouped-agg-chunk"
        while True:
            t0 = program_clock(self.session.device)
            window = _program_lint.maybe_verify(
                self.session.conf, family,
                lambda: program_key(family, f"gagg[{cap}]:{_pred_skeleton(condition, codecs)}|k:{key_specs}"
                                            f"|s:{self._slots}", px), (dev_cols, lits))
            if px is not None:
                from hyperspace_tpu_torch.parallel import collectives as C

                program = C.sharded_grouped_chunk_program(px.mesh, px.axis, pred_fn, key_specs, self._slots, cap)
                with window:
                    n_g, fs, key_out, slot_out = px.timed_call(
                        "grouped-agg", program, dev_cols, lits, n, self._row_base)
            else:
                program = grouped_chunk_program(pred_fn, key_specs, self._slots, cap)
                with window:
                    n_g, fs, key_out, slot_out = program(dev_cols, lits, n, self._row_base)
            count_dispatch(family)
            (n_g,) = read_counts(n_g)
            _observe_program(family, t0)
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
        p = self._partial
        stage_ir.note_peak_bytes([p["fs"], *p["keys"], *p["slots"]])

    def _ensure_fused_state(self, key_specs, cap: int):
        """The running partial as (keys, slots, fs, n) tensors of ``cap``
        rows: zero-filled when the stream is fresh (``state_n == 0`` leaves
        them out of the merge), padded to new storage when ``cap`` grew
        (the one reallocation of an in-place state)."""
        p = self._partial
        if p is None:
            device = self.session.device
            key_dts, slot_dts = _fused_state_dtypes(key_specs, self._slots)
            keys = tuple(torch.zeros(cap, dtype=dt, device=device) for dt in key_dts)
            slots = tuple(torch.zeros(cap, dtype=dt, device=device) for dt in slot_dts)
            fs = torch.full((cap,), _FS_SENTINEL, dtype=torch.int64, device=device)
            return keys, slots, fs, 0
        if p["cap"] < cap:
            p["fs"] = _dev_pad(p["fs"], cap, _FS_SENTINEL)
            p["keys"] = [_dev_pad(k, cap, float("nan") if k.is_floating_point() else 0) for k in p["keys"]]
            p["slots"] = [_dev_pad(v, cap, 0) for v in p["slots"]]
            p["cap"] = cap
        return tuple(p["keys"]), tuple(p["slots"]), p["fs"], int(p["n"])

    def _update_fused(self, dev_cols, lits, pred_fn, key_specs, base_sk: str, n: int) -> bool:
        """One-dispatch fold of this chunk (``fused-stage-agg``). Returns
        False on a capacity overflow: the state is as it was, and the caller
        redoes the chunk per-family."""
        cap = group_capacity(max(self._cap_hint, 1), self.cap_floor)
        if self._partial is not None:
            cap = max(cap, self._partial["cap"])
        state_keys, state_slots, state_fs, state_n = self._ensure_fused_state(key_specs, cap)
        px = self._parallel
        # the sharded fold never writes its state in place, as in the JAX
        # package
        donate = stage_ir.donation_wanted(self.session.conf) and px is None
        if px is not None:
            from hyperspace_tpu_torch.parallel import collectives as C
            from hyperspace_tpu_torch.parallel.mesh import mesh_fingerprint

            family = "fused-stage-agg-sharded"
            skeleton = f"gaggfused[{cap}]:{base_sk}@{mesh_fingerprint(px.mesh)}/shmap"
            fn = C.sharded_fused_grouped_program(px.mesh, px.axis, pred_fn, key_specs, self._slots, cap)
        else:
            family = "fused-stage-agg"
            skeleton = f"gaggfused[{cap}{'+d' if donate else ''}]:{base_sk}"
            fn = fused_grouped_update_program(pred_fn, key_specs, self._slots, cap, donate)
        program = stage_ir.compile_stage(skeleton, fn, donate_argnums=(0, 1, 2) if donate else ())
        args = (state_keys, state_slots, state_fs, state_n, dev_cols, lits, n, self._row_base)
        stage_ir.fold_peak_start(self.session.device)
        t0 = program_clock(self.session.device)
        with _program_lint.maybe_verify(self.session.conf, family, f"{family}/{skeleton}", args):
            if px is not None:
                n_b, n_m, n_out, fs_out, keys_out, slots_out = px.timed_call("grouped-agg", program, *args)
            else:
                n_b, n_m, n_out, fs_out, keys_out, slots_out = program(*args)
        stage_ir.count_dispatch(family)
        n_b, n_m, n_out = read_counts(n_b, n_m, n_out)
        _observe_program(family, t0)
        self._partial = {"cap": cap, "n": n_out, "fs": fs_out, "keys": list(keys_out), "slots": list(slots_out)}
        stage_ir.note_peak_bytes([fs_out, *keys_out, *slots_out])
        if n_b > cap or n_m > cap:
            self._cap_hint = max(self._cap_hint, n_b, n_m)
            if state_n == 0:
                self._partial = None  # nothing folded yet; the redo starts fresh
            return False
        self._row_base += n
        self._cap_hint = max(self._cap_hint, n_m)
        if n_m > self.max_groups:
            exc = GroupCapacityExceeded(f"group cardinality {n_m} exceeds maxGroups {self.max_groups}")
            exc.folded = True  # the chunk IS in the stored partial
            raise exc
        return True

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
        args = (tuple(a["keys"]), tuple(b["keys"]), tuple(a["slots"]), tuple(b["slots"]),
                a["fs"], b["fs"], a["n"], b["n"])
        t0 = program_clock(self.session.device)
        with obs_spans.span("agg-merge", cat="groupagg", groups_in=a["n"] + b["n"]):
            with _program_lint.maybe_verify(
                    self.session.conf, "grouped-merge",
                    lambda: f"grouped-merge/gmerge[{cap_in}->{cap_out}]|k:{key_specs}|s:{self._slots}", args):
                n_g, fs, key_out, slot_out = program(*args)
            count_dispatch("grouped-merge")
            (n_g,) = read_counts(n_g)
        _observe_program("grouped-merge", t0)
        REGISTRY.counter(
            "hs_agg_merge_seconds_total",
            "Cumulative device partial-aggregate merge time (seconds)",
        ).inc(time.perf_counter() - t0.t0)
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
        REGISTRY.counter("hs_agg_groups_total", "Groups produced by device grouped aggregation").inc(n)
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
    parallel=None,
) -> B.Batch:
    """One-shot fused filter -> grouped aggregate over a materialized scan
    batch. Raises DeviceUnsupported outside the device language or beyond
    ``max_groups`` cardinality. ``parallel`` (a ``ShardedExecutor``) runs
    the sharded chunk program."""
    if B.num_rows(batch) == 0:
        raise DeviceUnsupported("empty input stays host-side")
    stream = GroupedAggStream(
        session, group_keys, aggs, max_groups=max_groups, cap_floor=cap_floor, hint_key=scan_key,
        parallel=parallel,
    )
    stream.update(batch, condition, scan_key=scan_key)
    return stream.finalize()
