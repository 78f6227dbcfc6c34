"""Broadcast hash join: build once on the device, stream the probe side.

The port of the JAX package's ``hyperspace_tpu/exec/join_stream.py``. The
bucketed sort-merge join (exec/join.py) needs both sides to be equally
bucketed index scans; this tier covers the asymmetric case that dominates
star schemas: one side small enough to *broadcast* (conf
``hyperspace.exec.join.broadcastMaxBytes``, estimated from leaf file sizes).

The small side builds ONE sorted hash table on the device: per-column
uint32 hash planes (``ops/encode.hash_input_uint32``, value-consistent
across int/float/NaN representations) combined by ``combine_hashes_torch``
(uint32 arithmetic emulated in int64) and ordered by one stable sort, the
"hash-build" program. The probe side streams chunk by chunk through the
executor's ``execute_stream``; each chunk runs the "hash-probe" program
(combine, then two ``searchsorted`` walks into the table), and 32-bit hash
collisions are removed by an exact host verification over the candidate
pairs. Because the probe side is any streamable plan, including another
join's streamed output, q3/q10-shaped chains stream end to end.

A Filter directly above the join fuses into the chunk walk: matched pairs
evaluate the predicate BEFORE payload columns gather, on the device as the
"fused-postjoin" gather-and-predicate program when every referenced column
is device-encodable, else on the host over the slim referenced columns.

The JAX package pads every program input to a geometric shape bucket to
bound XLA recompiles; torch compiles nothing, so the port does not pad, and
the order over the real rows is the same. Two guards keep CUDA gathers in
range: the device post-join program runs only when every pair index is
non-negative (null-extended pairs carry -1), and the host gathers clip.

Under serving, built sides are shared through a byte-budgeted cache
(``serving/build_cache.py``, attached as ``session.join_build_cache`` while
a ``QueryServer`` runs), keyed by the build plan's identity and its
data-version brand; outside serving every join builds privately. The
server's worker threads launch on the same (default) stream, so a cached
table filled by one request's build is ordered before any other request's
probe of it on the device.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.check import program_lint as _program_lint
from hyperspace_tpu_torch.exec import batch as B
from hyperspace_tpu_torch.exec import trace
from hyperspace_tpu_torch.exec.device import (
    DeviceUnsupported,
    _host_tensor,
    compile_predicate,
    count_dispatch,
    encode_column,
    predicate_skeleton,
    upload_literals,
)
from hyperspace_tpu_torch.exec.join import _count_join_stream_chunk, _join_column_source, _null_value
from hyperspace_tpu_torch.obs import stages
from hyperspace_tpu_torch.ops.encode import hash_input_uint32
from hyperspace_tpu_torch.ops.hashing import combine_hashes_torch
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.plan.expr import as_bool_mask, extract_equi_join_keys


def _count_broadcast() -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_join_broadcast_total",
        "Joins executed by the broadcast-hash streaming path",
    ).inc()


# --------------------------------------------------------------------------
# applicability
# --------------------------------------------------------------------------


class BroadcastSpec:
    __slots__ = ("build_is_left", "lkeys", "rkeys")

    def __init__(self, build_is_left: bool, lkeys: List[str], rkeys: List[str]):
        self.build_is_left = build_is_left
        self.lkeys = lkeys
        self.rkeys = rkeys


def _plan_leaf_bytes(plan: L.LogicalPlan) -> Optional[int]:
    """Estimated input bytes of ``plan`` from its leaf files; None when a
    leaf is not file-backed or a file cannot be stat'ed (no estimate, no
    broadcast decision)."""
    leaves = L.collect(plan, lambda p: isinstance(p, (L.Scan, L.FileScan, L.IndexScan)))
    if not leaves:
        return None
    total = 0
    for leaf in leaves:
        try:
            if isinstance(leaf, L.Scan):
                total += sum(int(fi.size) for fi in leaf.relation.all_file_infos())
            else:
                if not leaf.files:
                    return None
                total += sum(os.stat(f).st_size for f in leaf.files)
        except Exception as exc:
            # no estimate, no broadcast decision; counted, so a flaky mount
            # that sends every join to the merge shows in the metrics
            from hyperspace_tpu_torch.reliability.errors import count_io_error

            count_io_error("join.stat", exc, swallowed=True)
            return None
    return total


def broadcast_spec(session, plan: L.Join) -> Optional[BroadcastSpec]:
    """Which side (if any) broadcasts: the smaller side whose estimated leaf
    bytes fit under ``hyperspace.exec.join.broadcastMaxBytes``."""
    if not isinstance(plan, L.Join) or plan.residual is not None:
        return None
    if plan.how not in ("inner", "left", "right", "outer"):
        return None
    max_bytes = session.conf.join_broadcast_max_bytes
    if max_bytes <= 0:
        return None
    pairs = extract_equi_join_keys(plan.condition)
    if not pairs:
        return None
    lcols = set(plan.left.output_columns)
    rcols = set(plan.right.output_columns)
    lkeys: List[str] = []
    rkeys: List[str] = []
    for a, b in pairs:
        if a in lcols and b in rcols:
            lkeys.append(a)
            rkeys.append(b)
        elif b in lcols and a in rcols:
            lkeys.append(b)
            rkeys.append(a)
        else:
            return None
    with stages.stage(session, "broadcast_gate"):
        lb = _plan_leaf_bytes(plan.left)
        rb = _plan_leaf_bytes(plan.right)
    cands = []
    if lb is not None and lb <= max_bytes:
        cands.append((lb, True))
    if rb is not None and rb <= max_bytes:
        cands.append((rb, False))
    if not cands:
        return None
    # both fit: broadcast the smaller, probe the larger
    _, build_is_left = min(cands, key=lambda t: t[0])
    return BroadcastSpec(build_is_left, lkeys, rkeys)


# --------------------------------------------------------------------------
# device programs
# --------------------------------------------------------------------------


# --- declared program contracts (see exec/device.py's block): the broadcast
# join's three program families are single-device and shuffle-free by
# construction — a collective in any of them means the build side leaked
# onto the mesh path.
_program_lint.register_contract(
    "hash-build",
    collectives={},
    description="broadcast build: combine key hash planes + stable argsort, device-local",
)
_program_lint.register_contract(
    "hash-probe",
    collectives={},
    description="broadcast probe: combine + two searchsorted walks into the sorted table, device-local",
)
_program_lint.register_contract(
    "fused-postjoin",
    collectives={},
    description="post-join filter fused over pair-gathered columns, device-local",
)


def hash_build_program(planes: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """"hash-build": combine the key hash planes (int tensors whose low 32
    bits are the uint32 hash inputs), then one stable sort. Returns the
    sorted int64 hashes and the order (table slot -> build row)."""
    h = combine_hashes_torch(planes)
    table, order = torch.sort(h, stable=True)
    return table, order


def hash_probe_program(table: torch.Tensor, n_build: int,
                       planes: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """"hash-probe": combine the chunk's hash planes, then each probe row's
    [lo, hi) candidate span in the sorted table by two ``searchsorted``
    walks, clamped to the table's live length."""
    h = combine_hashes_torch(planes)
    lo = torch.searchsorted(table, h, side="left")
    hi = torch.searchsorted(table, h, side="right")
    return lo.clamp_max(n_build), hi.clamp_max(n_build)


def _upload_hash_planes(arrays: List[np.ndarray], device: torch.device) -> List[torch.Tensor]:
    """uint32 hash planes on ``device`` as int32 views (half the bytes of
    int64); ``combine_hashes_torch`` reads their low 32 bits."""
    return [_host_tensor(a.view(np.int32)).to(device) for a in arrays]


def _copy_back(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host: on CUDA into pinned memory, with one event."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host.numpy()


class BuildSide:
    """Sorted hash table on the device and host payload of the broadcast
    side. ``order`` maps sorted-table slot -> build row; ``enc`` caches
    device encodings of payload columns for the fused post-join program."""

    __slots__ = ("batch", "n", "table", "order", "key_dtypes", "nbytes", "enc")

    def __init__(self, batch: B.Batch, n: int, table: torch.Tensor, order: np.ndarray,
                 key_dtypes: Dict[str, np.dtype], nbytes: int):
        self.batch = batch
        self.n = n
        self.table = table
        self.order = order
        self.key_dtypes = key_dtypes
        self.nbytes = nbytes
        self.enc: Dict[str, tuple] = {}


def build_hash_side(session, build_plan: L.LogicalPlan, build_cols: List[str],
                    bkeys: List[str]) -> BuildSide:
    """Materialize the broadcast side and build its hash table on the
    session's device."""
    from hyperspace_tpu_torch.exec.executor import Executor

    batch = Executor(session).execute(build_plan, required_columns=build_cols)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    with stages.stage(session, "join_build"):
        n = B.num_rows(batch)
        hashes = [hash_input_uint32(batch[k]) for k in bkeys]
        planes = _upload_hash_planes(hashes, session.device)
        with _program_lint.maybe_verify(session.conf, "hash-build", f"hash-build/{len(planes)}", (planes,)):
            table, order = hash_build_program(planes)
        count_dispatch("hash-build")
        order_host = _copy_back(order)
        nbytes = sum(int(a.nbytes) for a in batch.values()) + int(table.nbytes) + int(order_host.nbytes)
        return BuildSide(batch, n, table, order_host, {k: batch[k].dtype for k in bkeys}, nbytes)


# --------------------------------------------------------------------------
# null-aware key verification (pandas-merge semantics: NaN matches NaN,
# NaT matches NaT, None matches None)
# --------------------------------------------------------------------------


def _null_mask_obj(arr: np.ndarray) -> np.ndarray:
    return np.array(
        [v is None or (isinstance(v, float) and v != v) for v in arr], dtype=bool
    )


def _pairs_equal(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ka, kb = a.dtype.kind, b.dtype.kind
    if ka in "OUS" or kb in "OUS":
        if not (ka in "OUS" and kb in "OUS"):
            return np.zeros(a.shape[0], dtype=bool)  # object vs numeric never matches
        ao, bo = a.astype(object), b.astype(object)
        an, bn = _null_mask_obj(ao), _null_mask_obj(bo)
        eq = np.asarray(ao == bo, dtype=bool)
        return (eq & ~an & ~bn) | (an & bn)
    if ka == "M" or kb == "M":
        if ka != kb:
            return np.zeros(a.shape[0], dtype=bool)
        dt = np.promote_types(a.dtype, b.dtype)
        return a.astype(dt).view("int64") == b.astype(dt).view("int64")  # NaT==NaT
    if ka in "iub" and kb in "iub":
        return a == b
    af, bf = a.astype(np.float64), b.astype(np.float64)
    return (af == bf) | (np.isnan(af) & np.isnan(bf))


def _probe_chunk(session, build: BuildSide, chunk: B.Batch,
                 pkeys: List[str], bkeys: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(probe row, build row) matched pairs of one probe chunk: candidate
    spans by hash on the device, exact host verification over the
    candidates."""
    with stages.stage(session, "join_probe") as st:
        n = B.num_rows(chunk)
        hashes = []
        for pk, bk in zip(pkeys, bkeys):
            arr = np.asarray(chunk[pk])
            bdt = build.key_dtypes[bk]
            if arr.dtype.kind == "M" and bdt.kind == "M" and arr.dtype != bdt:
                # hash in the build side's epoch unit (a pure function of the
                # value, so equal keys still collide); verification below
                # compares at the finest common unit
                arr = arr.astype(bdt)
            hashes.append(hash_input_uint32(arr))
        planes = _upload_hash_planes(hashes, build.table.device)
        with _program_lint.maybe_verify(session.conf, "hash-probe", f"hash-probe/{len(planes)}",
                                        (build.table, planes)):
            lo_d, hi_d = hash_probe_program(build.table, build.n, planes)
        count_dispatch("hash-probe")
        lo, hi = _copy_back(torch.stack([lo_d, hi_d]))
        st.next("join_verify")
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
        cand_p = np.repeat(np.arange(n, dtype=np.int64), counts)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(total, dtype=np.int64) - np.repeat(offsets, counts) + np.repeat(lo, counts)
        cand_b = build.order[slot]
        keep = np.ones(total, dtype=bool)
        for pk, bk in zip(pkeys, bkeys):
            keep &= _pairs_equal(np.asarray(chunk[pk])[cand_p], build.batch[bk][cand_b])
        return cand_p[keep], cand_b[keep]


# --------------------------------------------------------------------------
# pair gather (single-pair-space sibling of join._expand_join_pairs: same
# null promotion, same USING coalesce)
# --------------------------------------------------------------------------


def _out_dtype(base: np.dtype, nullable: bool) -> np.dtype:
    if nullable and base.kind == "b":
        return np.dtype(object)  # pandas merge: bool + NULL -> object
    if nullable and base.kind in ("i", "u"):
        return np.dtype(np.float64)  # pandas-merge null promotion
    return base


def _gather_pairs(
    out_names: List[str],
    sources: Dict[str, Tuple[bool, str]],
    lbatch: Optional[B.Batch],
    rbatch: Optional[B.Batch],
    lidx: np.ndarray,
    ridx: np.ndarray,
    coalesce_from: Dict[str, str],
    fallback_dtypes: Dict[str, np.dtype],
) -> B.Batch:
    nrows = int(lidx.shape[0])
    out: B.Batch = {}
    for name in out_names:
        is_left, col = sources[name]
        src = lbatch if is_left else rbatch
        idx = lidx if is_left else ridx
        arr = None
        if src is not None and col in src:
            arr = np.asarray(src[col])
        if arr is None or arr.shape[0] == 0:
            base = arr.dtype if arr is not None else fallback_dtypes.get(name)
            if base is None:
                raise DeviceUnsupported(f"no dtype for empty join column {name!r}")
            dt = _out_dtype(base, True)
            vals = np.full(nrows, _null_value(dt), dtype=dt)
            nulls = np.ones(nrows, dtype=bool)
        else:
            nulls = idx < 0
            dt = _out_dtype(arr.dtype, bool(nulls.any()))
            if nulls.any():
                vals = np.empty(nrows, dtype=dt)
                vals[:] = arr[np.clip(idx, 0, arr.shape[0] - 1)].astype(dt, copy=False)
                vals[nulls] = _null_value(dt)
            else:
                vals = arr[idx]
                if vals.dtype != dt:
                    vals = vals.astype(dt)
        alt = coalesce_from.get(name) if is_left else None
        if alt is not None and nulls.any() and rbatch is not None and alt in rbatch:
            # left-null rows from right-unmatched emissions: the USING key
            # shows the RIGHT side's value (Spark coalesce semantics)
            ralt = np.asarray(rbatch[alt])
            fill = np.asarray(ridx)[nulls]
            ok = fill >= 0
            if ralt.shape[0] and ok.any():
                sel = np.nonzero(nulls)[0][ok]
                vals[sel] = ralt[fill[ok]].astype(vals.dtype, copy=False)
        out[name] = vals
    return out


# --------------------------------------------------------------------------
# fused post-join filter
# --------------------------------------------------------------------------

_POSTJOIN_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_POSTJOIN_CACHE_MAX = 64


def _postjoin_program(cache_key, refs: List[str], ref_on_probe: Dict[str, bool], fn):
    """"fused-postjoin": gather each referenced column by its pair indices,
    then the compiled predicate; one per (skeleton, sides), as the JAX
    package caches its jitted program."""
    prog = _POSTJOIN_CACHE.get(cache_key)
    if prog is None:
        while len(_POSTJOIN_CACHE) >= _POSTJOIN_CACHE_MAX:
            _POSTJOIN_CACHE.popitem(last=False)

        def prog(pcols, bcols, pidx, bidx, lits):
            cols = {}
            for name in refs:
                if ref_on_probe[name]:
                    cols[name] = pcols[name][pidx]
                else:
                    cols[name] = bcols[name][bidx]
            return fn(cols, lits)

        _POSTJOIN_CACHE[cache_key] = prog
    else:
        _POSTJOIN_CACHE.move_to_end(cache_key)
    return prog


def _device_postjoin_mask(session, condition, pbatch: B.Batch, build: BuildSide,
                          pidx: np.ndarray, bidx: np.ndarray,
                          refs: List[str], sources, probe_is_left: bool) -> np.ndarray:
    """Predicate over matched pairs as ONE device program: gather each
    referenced column by its pair indices, then the compiled predicate;
    payload never round-trips through host numpy for the filtered-out rows.
    Every index must be non-negative (the caller checks). Raises
    DeviceUnsupported outside the device expression language."""
    device = build.table.device
    codecs = {}
    pcols: Dict[str, torch.Tensor] = {}
    bcols: Dict[str, torch.Tensor] = {}
    ref_on_probe: Dict[str, bool] = {}
    for name in refs:
        is_left, col = sources[name]
        on_probe = is_left == probe_is_left
        ref_on_probe[name] = on_probe
        if on_probe:
            enc, codec = encode_column(np.asarray(pbatch[col]))
            pcols[name] = _host_tensor(enc).to(device)
        else:
            got = build.enc.get(col)
            if got is None:
                enc, codec = encode_column(build.batch[col])
                got = build.enc[col] = (_host_tensor(enc).to(device), codec)
            bcols[name], codec = got
        codecs[name] = codec
    fn, lits = compile_predicate(condition, codecs)
    skeleton = predicate_skeleton(condition, codecs)
    sides = tuple(sorted(ref_on_probe.items()))
    n = int(pidx.shape[0])
    prog = _postjoin_program((skeleton, sides), list(refs), ref_on_probe, fn)
    args = (pcols, bcols, _host_tensor(pidx).to(device), _host_tensor(bidx).to(device),
            upload_literals(lits, device))
    with _program_lint.maybe_verify(session.conf, "fused-postjoin", f"fused-postjoin/{skeleton}|{sides}", args):
        mask = prog(*args)
    count_dispatch("fused-postjoin")
    if mask.dim() == 0:  # a predicate over literals only
        mask = mask.expand(n)
    return _copy_back(mask)


# --------------------------------------------------------------------------
# the stream
# --------------------------------------------------------------------------


def stream_broadcast_join(executor, plan: L.Join, spec: Optional[BroadcastSpec] = None,
                          post_filter=None, project: Optional[List[str]] = None):
    """Yield the broadcast hash join's output one probe chunk at a time.

    ``post_filter`` (a Filter condition directly above the join) fuses into
    the chunk walk; ``project`` restricts the gathered output columns. Both
    together make Filter->Project over a Join a streaming, fused shape.
    Raises DeviceUnsupported BEFORE the first yield when the join can't take
    this path (callers then fall back with nothing consumed).
    """
    session = executor.session
    if spec is None:
        spec = broadcast_spec(session, plan)
    if spec is None:
        raise DeviceUnsupported("join has no broadcastable side")

    build_plan = plan.left if spec.build_is_left else plan.right
    probe_plan = plan.right if spec.build_is_left else plan.left
    bkeys = spec.lkeys if spec.build_is_left else spec.rkeys
    pkeys = spec.rkeys if spec.build_is_left else spec.lkeys
    probe_is_left = not spec.build_is_left
    how = plan.how
    keep_probe = how in (("left", "outer") if probe_is_left else ("right", "outer"))
    keep_build = how in (("left", "outer") if spec.build_is_left else ("right", "outer"))

    out_names = list(project) if project is not None else list(plan.output_columns)
    lout = plan.left.output_columns
    rout = plan.right.output_columns
    refs = sorted(post_filter.references()) if post_filter is not None else []
    sources = {
        name: _join_column_source(name, lout, rout)
        for name in dict.fromkeys(out_names + refs)
    }
    coalesce_from: Dict[str, str] = {}
    if how in ("right", "outer") and plan.using_pairs:
        for lk, rk in plan.using_pairs:
            if lk in out_names and rk in rout:
                coalesce_from[lk] = rk

    bset = set(plan.left.output_columns if spec.build_is_left else plan.right.output_columns)
    pset = set(probe_plan.output_columns)
    need_b = {c for (il, c) in sources.values() if il == spec.build_is_left and c in bset}
    need_p = {c for (il, c) in sources.values() if il == probe_is_left and c in pset}
    build_cols = [c for c in (plan.left if spec.build_is_left else plan.right).output_columns
                  if c in need_b or c in bkeys]
    probe_cols = [c for c in probe_plan.output_columns if c in need_p or c in pkeys]

    build = _shared_build_side(session, build_plan, build_cols, bkeys)
    _count_broadcast()
    trace.record("join", "broadcast-hash-stream")

    probe_exec = probe_plan
    if set(probe_cols) != set(probe_plan.output_columns):
        probe_exec = L.Project(probe_cols, probe_plan)

    from hyperspace_tpu_torch.exec.executor import Executor

    matched_build = np.zeros(build.n, dtype=bool) if keep_build else None
    probe_dtypes: Dict[str, np.dtype] = {}
    empty64 = np.empty(0, dtype=np.int64)

    def orient(p_i, b_i):
        return (p_i, b_i) if probe_is_left else (b_i, p_i)

    def pair_fallback_dtypes(pbatch: Optional[B.Batch]) -> Dict[str, np.dtype]:
        fb: Dict[str, np.dtype] = {}
        for name, (is_left, col) in sources.items():
            if is_left == probe_is_left and pbatch is None and col in probe_dtypes:
                fb[name] = probe_dtypes[col]
        return fb

    def filter_pairs(pbatch: Optional[B.Batch], p_i: np.ndarray, b_i: np.ndarray):
        if post_filter is None or p_i.shape[0] == 0:
            return p_i, b_i
        with stages.stage(session, "join_postjoin"):
            mask = None
            if (
                session.conf.device_execution_enabled
                and pbatch is not None
                and bool((p_i >= 0).all())
                and bool((b_i >= 0).all())
            ):
                try:
                    mask = _device_postjoin_mask(
                        session, post_filter, pbatch, build, p_i, b_i,
                        refs, sources, probe_is_left,
                    )
                except DeviceUnsupported:
                    trace.fallback("join", "postjoin_device")
                    mask = None
            if mask is None:
                lidx, ridx = orient(p_i, b_i)
                lb, rb = (pbatch, build.batch) if probe_is_left else (build.batch, pbatch)
                refbatch = _gather_pairs(
                    refs, sources, lb, rb, lidx, ridx, {}, pair_fallback_dtypes(pbatch)
                )
                raw = as_bool_mask(post_filter.eval(refbatch))
                mask = np.broadcast_to(np.asarray(raw, dtype=bool), (p_i.shape[0],))
        return p_i[mask], b_i[mask]

    def assemble(pbatch: Optional[B.Batch], p_i: np.ndarray, b_i: np.ndarray) -> B.Batch:
        with stages.stage(session, "join_gather"):
            lidx, ridx = orient(p_i, b_i)
            lb, rb = (pbatch, build.batch) if probe_is_left else (build.batch, pbatch)
            out = _gather_pairs(
                out_names, sources, lb, rb, lidx, ridx, coalesce_from,
                pair_fallback_dtypes(pbatch),
            )
            return out

    yielded = False
    probe_iter = Executor(session).execute_stream(probe_exec)
    try:
        for chunk in probe_iter:
            chunk = {k: np.asarray(v) for k, v in chunk.items()}
            for c, a in chunk.items():
                probe_dtypes.setdefault(c, a.dtype)
            n = B.num_rows(chunk)
            if n == 0:
                continue
            p_i, b_i = _probe_chunk(session, build, chunk, pkeys, bkeys)
            if matched_build is not None and b_i.size:
                matched_build[b_i] = True
            if keep_probe:
                hit = np.zeros(n, dtype=bool)
                hit[p_i] = True
                miss = np.nonzero(~hit)[0]
                if miss.size:
                    p_i = np.concatenate([p_i, miss])
                    b_i = np.concatenate([b_i, np.full(miss.size, -1, dtype=np.int64)])
            p_i, b_i = filter_pairs(chunk, p_i, b_i)
            if p_i.shape[0] == 0:
                continue
            out = assemble(chunk, p_i, b_i)
            _count_join_stream_chunk()
            yielded = True
            yield out
    finally:
        probe_iter.close()

    if matched_build is not None:
        miss_b = np.nonzero(~matched_build)[0]
        if miss_b.size:
            if not probe_dtypes and any(
                il == probe_is_left for il, _ in sources.values()
            ):
                if yielded:  # can't abandon a started stream
                    raise RuntimeError("broadcast join lost probe dtypes mid-stream")
                raise DeviceUnsupported("probe side yielded no chunks to type NULL columns")
            p_i = np.full(miss_b.size, -1, dtype=np.int64)
            p_i, b_i = filter_pairs(None, p_i, miss_b.astype(np.int64))
            if p_i.shape[0]:
                out = assemble(None, p_i, b_i)
                _count_join_stream_chunk()
                yielded = True
                yield out

    if not yielded:
        # type an EMPTY result from the observed dtypes so callers never
        # fall back to a materialize-both-sides path for a no-match join
        if not probe_dtypes and any(il == probe_is_left for il, _ in sources.values()):
            raise DeviceUnsupported("probe side yielded no chunks to type an empty result")
        pb = {c: np.empty(0, dtype=dt) for c, dt in probe_dtypes.items()}
        yield assemble(pb, empty64, empty64)


def _build_identity(build_plan: L.LogicalPlan, build_cols: List[str], bkeys: List[str]):
    """Cache identity of a built hash table: the plan text (filters included)
    + every leaf file's (path, mtime, size) + columns + keys. None (= don't
    cache) when a leaf can't be stat'ed."""
    files = []
    for leaf in L.collect(
        build_plan, lambda p: isinstance(p, (L.Scan, L.FileScan, L.IndexScan))
    ):
        names = (
            [fi.name for fi in leaf.relation.all_file_infos()]
            if isinstance(leaf, L.Scan)
            else list(leaf.files)
        )
        for f in names:
            try:
                st = os.stat(f)
            except OSError:
                return None
            files.append((f, st.st_mtime_ns, st.st_size))
    return (build_plan.pretty(), tuple(files), tuple(build_cols), tuple(bkeys))


def _shared_build_side(session, build_plan, build_cols: List[str], bkeys: List[str]) -> BuildSide:
    """Build via the session's shared build cache when one is attached
    (QueryServer start()); outside serving every join builds privately. An
    entry is keyed by the build's identity and its data-version brand; a
    build whose files cannot be stat'ed or whose sources cannot be signed
    is never cached."""
    cache = getattr(session, "join_build_cache", None)
    if cache is None:
        return build_hash_side(session, build_plan, build_cols, bkeys)
    with stages.stage(session, "build_identity"):
        key = _build_identity(build_plan, build_cols, bkeys)
        brand = None
        if key is not None:
            try:
                from hyperspace_tpu_torch.serving.result_cache import version_brand

                brand = version_brand(session, build_plan, enabled=True)
            except Exception:
                brand = None
    if key is None or brand is None:
        return build_hash_side(session, build_plan, build_cols, bkeys)
    return cache.get_or_build(
        key, brand,
        lambda: build_hash_side(session, build_plan, build_cols, bkeys),
        lambda b: b.nbytes,
    )


def dispatch_broadcast_join(executor, plan: L.Join) -> B.Batch:
    """Materialized entry point (executor._exec_join's middle tier, between
    the bucketed join and the generic merge): fold the stream
    incrementally, closing the generator on any exit."""
    spec = broadcast_spec(executor.session, plan)
    if spec is None:
        raise DeviceUnsupported("join has no broadcastable side")
    gen = stream_broadcast_join(executor, plan, spec)
    merged = None
    merged_bytes = 0
    pending: List[B.Batch] = []
    pending_bytes = 0

    def nbytes(batch: B.Batch) -> int:
        return sum(int(np.asarray(a).nbytes) for a in batch.values())

    try:
        for chunk in gen:
            pending.append(chunk)
            pending_bytes += nbytes(chunk)
            if merged is None or pending_bytes >= merged_bytes:
                batches = ([merged] if merged is not None else []) + pending
                merged = batches[0] if len(batches) == 1 else B.concat(batches)
                merged_bytes = nbytes(merged)
                pending, pending_bytes = [], 0
    finally:
        gen.close()
    if pending:
        batches = ([merged] if merged is not None else []) + pending
        merged = batches[0] if len(batches) == 1 else B.concat(batches)
    if merged is None:  # the stream always yields >= 1 (possibly empty) chunk
        raise DeviceUnsupported("broadcast join produced no chunks")
    return merged
