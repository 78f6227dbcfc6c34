"""Whole-stage fusion: stage-IR nodes, the program cache, and the fused
join -> aggregate stage.

The port of the JAX package's ``hyperspace_tpu/exec/stage_ir.py``. The
per-family device programs (exec/aggregate.py, exec/join_stream.py,
ops/sort.py) stitch a streamed chunk's Filter -> Join-probe -> Agg/TopK chain
together with host Python: every seam pays a dispatch, a round trip and
fresh tensors for the fold state. Under ``hyperspace.exec.fusion.enabled``
one program per chunk does the whole stage instead:

  ``fused-stage-agg``       exec/aggregate.fused_grouped_update_program:
                            filter, group, segment-reduce and the merge
                            into the running per-group table
  ``fused-stage-topk``      ops/sort.fused_topk_fn: the chunk's select and
                            the merge into the candidate matrix
  ``fused-stage-join-agg``  :func:`fused_join_agg_program`: hash probe,
                            bounded pair expansion, exact key check,
                            post-join filter and the grouped fold

Each is built from the port's per-family bodies, so it is bit-identical to
the per-family sequence by construction, and each counts as ONE dispatch
per chunk under its family name (``exec/device.dispatches``).

Where torch and JAX differ:

- **Donation becomes in-place state.** JAX donates the fold state
  (``donate_argnums``) so XLA may alias it to the outputs. Torch has no
  donation; with ``hyperspace.exec.fusion.donation`` on, the programs write
  the new state into the old tensors with ``copy_`` (their ``data_ptr``
  stays the same across folds at a fixed capacity); with it off, the state
  is rebound to fresh tensors. The results are byte-identical either way.
- **Overflow leaves the state intact.** JAX computes every output and then
  selects the old state with ``jnp.where``. Here the group counts (and the
  pair total) are read first, and the state is written only when all of
  them fit; the caller then redoes the chunk per-family, counted in
  ``trace.fallbacks[("fusion", ...)]``.
- **Program cache.** :func:`compile_stage` compiles nothing (eager torch):
  it is an LRU of 256 programs keyed by (skeleton, donation), the identity
  ``jax.jit`` gets in the JAX package; ``stage_compiles`` counts its
  fills. A hit runs the caller's freshly built closure under the cached
  identity: a closure over an older chunk's predicate never runs.

Everything here is gated behind ``hyperspace.exec.fusion.enabled``
(default off); the per-family path stays the default and the fallback.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.check import program_lint as _program_lint
from hyperspace_tpu_torch.exec import device as _device
from hyperspace_tpu_torch.obs import stages

# --------------------------------------------------------------------------
# conf gates
# --------------------------------------------------------------------------


def fusion_wanted(conf) -> bool:
    """Whole-stage fusion master switch (``hyperspace.exec.fusion.enabled``)."""
    try:
        return bool(conf.fusion_enabled)
    except Exception:
        return False


def donation_wanted(conf) -> bool:
    """In-place fold state, consulted only when fusion is on."""
    try:
        return bool(conf.fusion_enabled) and bool(conf.fusion_donation)
    except Exception:
        return False


# --------------------------------------------------------------------------
# observability: dispatch counts and the fold state's high-water mark
# --------------------------------------------------------------------------


def count_dispatch(program: str) -> None:
    """Count one device-program dispatch under its family name
    (``exec/device.count_dispatch``)."""
    _device.count_dispatch(program)


_peak_bytes = 0


def note_peak_bytes(tensors=()) -> int:
    """Fold the bytes of the live fold-state ``tensors`` into the high-water
    mark and the ``hs_device_peak_bytes`` gauge. Called after each fold
    step, when the old and the new state could coexist (the allocation
    in-place state avoids). It reads the fold's own tensors, on every
    device: the allocator's process-wide peak belongs to whoever reads
    ``torch.cuda.max_memory_allocated`` and is never reset here."""
    global _peak_bytes
    total = sum(int(t.nelement() * t.element_size()) for t in tensors if isinstance(t, torch.Tensor))
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    g = REGISTRY.gauge(
        "hs_device_peak_bytes",
        "High-water bytes of a streamed fold step's state on the device",
    )
    if total > _peak_bytes:
        _peak_bytes = total
    if total > g.value:
        g.set(total)
    return total


def peak_bytes() -> int:
    """The high-water mark of :func:`note_peak_bytes` since the process
    started (the JAX package's ``hs_device_peak_bytes`` gauge)."""
    return _peak_bytes


# --------------------------------------------------------------------------
# stage IR
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class FilterOp:
    """Fused predicate over the chunk (skeleton = structure + column kinds,
    literal-free, as ``predicate_skeleton``)."""

    skeleton: str

    def token(self) -> str:
        return f"F({self.skeleton})"


@dataclass(frozen=True)
class ProjectOp:
    columns: Tuple[str, ...]

    def token(self) -> str:
        return f"P({','.join(self.columns)})"


@dataclass(frozen=True)
class JoinProbeOp:
    """Broadcast hash probe against a resident build table: span walk,
    bounded pair expansion and exact key verification, ``pair_cap`` pairs."""

    n_keys: int
    pair_cap: int

    def token(self) -> str:
        return f"J(k{self.n_keys}:p{self.pair_cap})"


@dataclass(frozen=True)
class GroupAggOp:
    """Grouped segment reduction folded into the running partial."""

    key_specs: Tuple[Tuple[str, str], ...]  # (column, 'i'|'f')
    slot_specs: Tuple[Tuple[str, Optional[str], bool], ...]
    cap: int

    def token(self) -> str:
        k = ",".join(f"{n}:{t}" for n, t in self.key_specs)
        s = ",".join(f"{kind}:{c}:{int(i)}" for kind, c, i in self.slot_specs)
        return f"G[{self.cap}](k:{k}|s:{s})"


@dataclass(frozen=True)
class TopKOp:
    """Chunk top-k select merged into the candidate matrix."""

    num_keys: int
    cap: int

    def token(self) -> str:
        return f"T(k{self.num_keys}:c{self.cap})"


@dataclass(frozen=True)
class StagePlan:
    """One streamed pipeline stage: the ordered op chain a chunk flows
    through. ``skeleton()`` is the whole-stage program identity."""

    ops: Tuple[object, ...]

    def skeleton(self) -> str:
        return "fuse[" + ">".join(op.token() for op in self.ops) + "]"


# --------------------------------------------------------------------------
# program cache
# --------------------------------------------------------------------------

_STAGE_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_STAGE_CACHE_MAX = 256

#: programs built by :func:`compile_stage` (cache fills) since the process
#: started: the JAX package's compile count for its fused programs
stage_compiles = 0


class _StageProgram:
    """A cached stage program: ``fn`` under its (skeleton, donation)
    identity."""

    __slots__ = ("skeleton", "donate_argnums", "fn")

    def __init__(self, skeleton: str, donate_argnums: Tuple[int, ...], fn):
        self.skeleton = skeleton
        self.donate_argnums = donate_argnums
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


def compile_stage(skeleton: str, fn, *, donate_argnums: Tuple[int, ...] = ()):
    """One stage program per (skeleton, donate_argnums), least recently used
    out past 256; a hit rebinds it to ``fn`` (the caller's closure over this
    chunk's predicate). The donation vector is part of the identity, as in
    the JAX package; the in-place writes themselves are the program's (its
    builder takes the donation flag), so callers rebind their state to the
    returned tensors either way."""
    global stage_compiles
    donate = tuple(int(i) for i in donate_argnums)
    key = (skeleton, donate)
    prog = _STAGE_CACHE.get(key)
    if prog is None:
        while len(_STAGE_CACHE) >= _STAGE_CACHE_MAX:
            _STAGE_CACHE.popitem(last=False)
        prog = _STAGE_CACHE[key] = _StageProgram(skeleton, donate, fn)
        stage_compiles += 1
    else:
        prog.fn = fn
        _STAGE_CACHE.move_to_end(key)
    return prog


def clear_stage_cache() -> None:
    _STAGE_CACHE.clear()


# --------------------------------------------------------------------------
# fused join -> grouped-aggregate stage (the q3 shape)
# --------------------------------------------------------------------------

# Declared program contract: the fused stage is one dispatch (single_fusion),
# host-wait-free and collective-free — any collective means the broadcast
# build side leaked onto the mesh path.
_program_lint.register_contract(
    "fused-stage-join-agg",
    collectives={},
    description=(
        "whole-stage probe+verify+filter+group+merge program: one dispatch, "
        "device-local, in-place fold state"
    ),
    single_fusion=True,
)


def fused_join_agg_program(
    vmodes: Tuple[str, ...],
    pred_fn,
    needed: Tuple[str, ...],
    on_probe: Dict[str, bool],
    gkey_specs: Tuple[Tuple[str, str], ...],
    slot_specs,
    cap: int,
    pair_cap: int,
    donate: bool,
):
    """The whole fused stage: the hash probe's span walk -> pair expansion
    to ``pair_cap`` pairs -> exact key verification (``vmodes[i]``: 'i'
    exact int64, 'f' float64 with NaN matching NaN, as
    ``join_stream._pairs_equal``) -> the post-join predicate -> the grouped
    body over every pair, the kept ones its mask -> the merge into the
    running partial. Fixed-shape, as the JAX package's program is: no
    count is read on the host inside it.

    ``program(state_keys, state_slots, state_fs, state_n, table, border,
    n_build, bkenc, pplanes, pkenc, pcols, bcols, lits, row_base)`` returns
    ``(total, n_chunk, n_merged, n_kept, n_out, fs, keys, slots)``, the
    counts as 0-d tensors. The kept pairs are numbered in pair order from
    ``row_base``: exactly the rows the per-family path assembles. The fold
    takes when ``total <= pair_cap`` and the chunk and the merge hold at
    most ``cap`` groups, decided on the device; else every state output
    holds the state's values, ``n_out`` is ``state_n``, and the caller
    redoes the chunk per-family."""
    from hyperspace_tpu_torch.exec.aggregate import _FS_SENTINEL, fold_into_state, grouped_body
    from hyperspace_tpu_torch.exec.join_stream import hash_probe_program

    def program(state_keys, state_slots, state_fs, state_n,
                table, border, n_build, bkenc, pplanes, pkenc, pcols, bcols, lits, row_base):
        n_probe = pplanes[0].shape[0]
        t_len = table.shape[0]
        b_len = bkenc[0].shape[0]
        device = table.device
        if n_probe == 0:  # known from the shapes: no pair, the state as it is
            zero = torch.zeros((), dtype=torch.int64, device=device)
            n_state = torch.full((), int(state_n), dtype=torch.int64, device=device)
            return (zero, zero, n_state, zero, n_state, state_fs, tuple(state_keys), tuple(state_slots))
        # 1. probe spans (the hash-probe family's body)
        lo, hi = hash_probe_program(table, n_build, list(pplanes))
        counts = hi - lo
        cum = torch.cumsum(counts, 0)
        total = cum[-1]
        # 2. pair expansion: pair j belongs to the first probe row whose
        # cumulative count exceeds j; every gather index is clamped
        j = torch.arange(pair_cap, dtype=torch.int64, device=device)
        pvalid = j < torch.clamp(total, max=pair_cap)
        cand_p = torch.clamp(torch.searchsorted(cum, j, right=True), 0, n_probe - 1)
        start = cum[cand_p] - counts[cand_p]
        slot = torch.clamp(j - start + lo[cand_p], 0, max(t_len - 1, 0))
        cand_b = torch.clamp(border[slot], 0, max(b_len - 1, 0))
        # 3. exact key verification (32-bit hash collisions removed)
        keep = pvalid
        for pe, be, mode in zip(pkenc, bkenc, vmodes):
            a, b = pe[cand_p], be[cand_b]
            if mode == "i":
                keep = keep & (a == b)
            else:
                af, bf = a.to(torch.float64), b.to(torch.float64)
                keep = keep & ((af == bf) | (torch.isnan(af) & torch.isnan(bf)))
        # 4. pair-space column gather (the fused-postjoin family's gather)
        # and the post-join predicate
        cols = {name: (pcols[name][cand_p] if on_probe[name] else bcols[name][cand_b]) for name in needed}
        if pred_fn is not None:
            mask = pred_fn(cols, lits)
            keep = keep & (mask.expand(pair_cap) if mask.dim() == 0 else mask)
        rank = torch.cumsum(keep, 0) - 1  # a kept pair's position among the kept
        n_kept = keep.sum()
        # 5. the grouped-agg-chunk body over the pairs, the kept ones its
        # mask; a group's first row is its first kept pair, numbered from
        # row_base
        n_chunk, rep, key_b, slot_b = grouped_body(cols, keep, gkey_specs, slot_specs, cap)
        repc = torch.clamp(rep, 0, pair_cap - 1)
        fs_b = torch.where(rep < pair_cap, rank[repc] + row_base, rep.new_full((), _FS_SENTINEL))
        # 6. the merge into the running partial (the grouped-merge body),
        # guarded by every capacity at once
        n_m, n_out, fs_out, keys_out, slots_out = fold_into_state(
            gkey_specs, slot_specs, cap, donate,
            state_keys, state_slots, state_fs, state_n, key_b, slot_b, fs_b, n_chunk, ok=total <= pair_cap,
        )
        return total, n_chunk, n_m, n_kept, n_out, fs_out, keys_out, slots_out

    return program


def _verify_modes(probe_dtypes, build_dtypes) -> Tuple[str, ...]:
    """Per-key device verification mode, or DeviceUnsupported when the exact
    host semantics (``_pairs_equal``) don't map onto encoded columns:
    strings and objects need the host loop, unsigned ints promote oddly,
    and mixed-unit datetimes compare at the finest common unit host-side."""
    from hyperspace_tpu_torch.exec.device import DeviceUnsupported

    modes: List[str] = []
    for pd_, bd in zip(probe_dtypes, build_dtypes):
        pk, bk = pd_.kind, bd.kind
        if pk in "OUS" or bk in "OUS":
            raise DeviceUnsupported("string join keys verify host-side")
        if pk == "u" or bk == "u":
            raise DeviceUnsupported("unsigned join keys verify host-side")
        if pk == "M" or bk == "M":
            if pk != bk or pd_ != bd:
                raise DeviceUnsupported("mixed datetime join keys verify host-side")
            modes.append("i")
        elif pk in "ib" and bk in "ib":
            modes.append("i")
        else:
            modes.append("f")
    return tuple(modes)


class _JoinAggState:
    """Host-side state of one fused join -> aggregate stream."""

    __slots__ = ("pair_cap", "bdev")

    def __init__(self):
        self.pair_cap = 0
        self.bdev = None


def stream_join_aggregate(executor, join_plan, spec, post_filter, group_keys, aggs):
    """Fused execution of a q3-shaped chain, an Aggregate over (a Filter
    over) an inner broadcast Join: ONE program folds each probe chunk
    straight into the device-resident grouped partial.

    The per-family equivalent of one chunk: hash-probe + host verify +
    fused-postjoin + grouped-agg-chunk + grouped-merge. The output is the
    per-family path's, byte for byte on the CPU (tests/test_torch_fusion.py).

    Raises DeviceUnsupported before any fold when the shape does not fuse;
    a capacity overflow mid-stream redoes that chunk per-family
    (``trace.fallbacks[("fusion", "join-agg-overflow")]``)."""
    from hyperspace_tpu_torch.exec import aggregate as A
    from hyperspace_tpu_torch.exec import batch as B
    from hyperspace_tpu_torch.exec import join_stream as J
    from hyperspace_tpu_torch.exec import trace
    from hyperspace_tpu_torch.exec.device import DeviceUnsupported
    from hyperspace_tpu_torch.exec.join import _join_column_source
    from hyperspace_tpu_torch.plan import logical as L
    from hyperspace_tpu_torch.plan.expr import as_bool_mask

    session = executor.session
    conf = session.conf
    if join_plan.how != "inner":
        raise DeviceUnsupported("fused join-agg stage covers inner joins")

    build_plan = join_plan.left if spec.build_is_left else join_plan.right
    probe_plan = join_plan.right if spec.build_is_left else join_plan.left
    bkeys = spec.lkeys if spec.build_is_left else spec.rkeys
    pkeys = spec.rkeys if spec.build_is_left else spec.lkeys
    probe_is_left = not spec.build_is_left
    lout = join_plan.left.output_columns
    rout = join_plan.right.output_columns

    refs = sorted(post_filter.references()) if post_filter is not None else []
    agg_inputs = sorted({c for _, _, c in aggs if c is not None})
    needed = tuple(dict.fromkeys(refs + list(group_keys) + agg_inputs))
    sources = {name: _join_column_source(name, lout, rout) for name in needed}
    on_probe = {name: (is_left == probe_is_left) for name, (is_left, _) in sources.items()}

    bset = set(build_plan.output_columns)
    pset = set(probe_plan.output_columns)
    need_b = {c for (il, c) in sources.values() if il == spec.build_is_left and c in bset}
    need_p = {c for (il, c) in sources.values() if il == probe_is_left and c in pset}
    build_cols = [c for c in build_plan.output_columns if c in need_b or c in bkeys]
    probe_cols = [c for c in probe_plan.output_columns if c in need_p or c in pkeys]

    build = J._shared_build_side(session, build_plan, build_cols, bkeys)
    J._count_broadcast()
    trace.record("join", "broadcast-hash-stream")

    # the grouped fold state and its finalization live in GroupedAggStream;
    # this stage drives its device partial directly. The capacity hint keys
    # on the probe leaf files, so repeat runs over the same lake start at
    # the settled capacity
    from hyperspace_tpu_torch.exec.executor import Executor, _chain_to_scan, _leaf_files

    _, probe_leaf = _chain_to_scan(probe_plan)
    hint_key = ("fused-join-agg",) + tuple(_leaf_files(probe_leaf)) if probe_leaf is not None else None
    gs = A.GroupedAggStream(
        session, list(group_keys), list(aggs),
        max_groups=conf.agg_max_groups, cap_floor=conf.agg_capacity_floor, hint_key=hint_key,
    )
    build_dtype = {name: build.batch[col].dtype for name, (il, col) in sources.items() if il == spec.build_is_left}

    def orient(p_i, b_i):
        return (p_i, b_i) if probe_is_left else (b_i, p_i)

    def classic_chunk(chunk: B.Batch) -> None:
        """Per-family fold of one probe chunk (the overflow redo)."""
        p_i, b_i = J._probe_chunk(session, build, chunk, pkeys, bkeys)
        if post_filter is not None and p_i.shape[0]:
            mask = None
            if conf.device_execution_enabled:
                try:
                    mask = J._device_postjoin_mask(
                        session, post_filter, chunk, build, p_i, b_i, refs, sources, probe_is_left,
                    )
                except DeviceUnsupported:
                    trace.fallback("join", "postjoin_device")
            if mask is None:
                lidx, ridx = orient(p_i, b_i)
                lb, rb = (chunk, build.batch) if probe_is_left else (build.batch, chunk)
                refbatch = J._gather_pairs(refs, sources, lb, rb, lidx, ridx, {}, {})
                raw = as_bool_mask(post_filter.eval(refbatch))
                mask = np.broadcast_to(np.asarray(raw, dtype=bool), (p_i.shape[0],))
            p_i, b_i = p_i[mask], b_i[mask]
        if p_i.shape[0] == 0:
            return
        lidx, ridx = orient(p_i, b_i)
        lb, rb = (chunk, build.batch) if probe_is_left else (build.batch, chunk)
        joined = J._gather_pairs(list(needed), sources, lb, rb, lidx, ridx, {}, {})
        gs.update(joined, None)

    probe_exec = probe_plan
    if set(probe_cols) != set(probe_plan.output_columns):
        probe_exec = L.Project(probe_cols, probe_plan)

    state = _JoinAggState()
    chunks = 0
    probe_iter = Executor(session).execute_stream(probe_exec)
    try:
        for chunk in probe_iter:
            chunk = {k: np.asarray(v) for k, v in chunk.items()}
            n = B.num_rows(chunk)
            if n == 0:
                continue
            if chunks == 0:
                # the fusability gates raise DeviceUnsupported here, before
                # any fold: the caller answers on the per-family tiers
                sample = {
                    name: np.empty(0, dtype=(
                        build_dtype[name] if not on_probe[name] else chunk[sources[name][1]].dtype))
                    for name in needed
                }
                gs._check_schema(sample)
                keys_schema, _ = gs._schema
                if any(tag == "s" for tag, _, _ in keys_schema):
                    raise DeviceUnsupported("string group keys stay per-family")
                _verify_modes([np.asarray(chunk[pk]).dtype for pk in pkeys],
                              [build.key_dtypes[bk] for bk in bkeys])
            chunks += 1
            try:
                folded = _fused_fold_chunk(session, gs, build, chunk, pkeys, bkeys, post_filter,
                                           needed, on_probe, sources, state)
            except DeviceUnsupported:
                folded = False
            if not folded:
                # a capacity overflow (or a chunk dtype that does not fuse):
                # the state is as it was; redo this one chunk per-family
                trace.fallback("fusion", "join-agg-overflow")
                classic_chunk(chunk)
            p = gs._partial
            if p is not None and int(p["n"]) > gs.max_groups:
                raise DeviceUnsupported(f"group cardinality {int(p['n'])} exceeds maxGroups {gs.max_groups}")
    finally:
        probe_iter.close()
    if not gs.has_data:
        # nothing folded (no probe chunks, or every chunk redone per-family
        # with no kept pair): the per-family tiers type the empty result
        raise DeviceUnsupported("fused join-agg stream folded no groups")
    trace.record("agg", "fused-join-agg-stream")
    return gs.finalize()


def _fused_fold_chunk(session, gs, build, chunk, pkeys, bkeys, post_filter,
                      needed, on_probe, sources, state) -> bool:
    """Fold one probe chunk with the fused program. Returns False on a
    capacity overflow (the state as it was; the caller redoes the chunk
    per-family); raises DeviceUnsupported when this chunk's dtypes do not
    fuse."""
    from hyperspace_tpu_torch.exec import aggregate as A
    from hyperspace_tpu_torch.exec import batch as B
    from hyperspace_tpu_torch.exec.device import (
        DeviceUnsupported,
        _host_tensor,
        bucket_rows,
        compile_predicate,
        encode_column,
        predicate_skeleton,
        upload_literals,
    )
    from hyperspace_tpu_torch.exec.join_stream import _upload_hash_planes
    from hyperspace_tpu_torch.ops.encode import hash_input_uint32

    conf = session.conf
    device = build.table.device
    n = B.num_rows(chunk)
    vmodes = _verify_modes([np.asarray(chunk[pk]).dtype for pk in pkeys],
                           [build.key_dtypes[bk] for bk in bkeys])
    agg_inputs = {c for _, _, c in gs.aggs if c}

    def build_column(col):
        # the build side's device encodings, cached on the BuildSide across
        # chunks (and shared with the fused-postjoin program)
        got = build.enc.get(col)
        if got is None:
            enc, codec = encode_column(build.batch[col])
            got = build.enc[col] = (_host_tensor(enc).to(device), codec)
        return got

    if state.bdev is None:
        bkenc = tuple(build_column(bk)[0] for bk in bkeys)
        bcols, bcodecs = {}, {}
        for name in needed:
            if on_probe[name]:
                continue
            dev, codec = build_column(sources[name][1])
            if codec.kind == "string" and name in agg_inputs:
                raise DeviceUnsupported("string aggregate inputs stay host-side")
            bcols[name], bcodecs[name] = dev, codec
        border = np.zeros(int(build.table.shape[0]), dtype=np.int64)
        border[: build.n] = build.order
        state.bdev = (bkenc, bcols, bcodecs, _host_tensor(border).to(device))
    bkenc, bcols, bcodecs, border = state.bdev

    with stages.stage(session, "agg_upload") as st:
        hashes = []
        for pk, bk in zip(pkeys, bkeys):
            arr = np.asarray(chunk[pk])
            bdt = build.key_dtypes[bk]
            if arr.dtype.kind == "M" and bdt.kind == "M" and arr.dtype != bdt:
                arr = arr.astype(bdt)
            hashes.append(hash_input_uint32(arr))
        pplanes = tuple(_upload_hash_planes(hashes, device))
        pkenc = tuple(_host_tensor(encode_column(np.asarray(chunk[pk]))[0]).to(device) for pk in pkeys)
        pcols, codecs = {}, dict(bcodecs)
        for name in needed:
            if not on_probe[name]:
                continue
            enc, codec = encode_column(np.asarray(chunk[sources[name][1]]))
            if codec.kind == "string" and name in agg_inputs:
                raise DeviceUnsupported("string aggregate inputs stay host-side")
            pcols[name] = _host_tensor(enc).to(device)
            codecs[name] = codec
        if post_filter is not None:
            pred_fn, lits = compile_predicate(post_filter, codecs)
            pred_sk = predicate_skeleton(post_filter, codecs)
        else:
            pred_fn, lits, pred_sk = None, (), "<none>"
        st.next("agg_program")

        keys_schema, _ = gs._schema
        gkey_specs = tuple((name, "f" if tag == "f" else "i") for name, (tag, _, _) in zip(gs.group_keys, keys_schema))
        # capacities: pairs start at one match per probe row, groups at the hint
        if state.pair_cap <= 0:
            state.pair_cap = bucket_rows(n)
        pair_cap = state.pair_cap
        p = gs._partial
        cap = A.group_capacity(max(gs._cap_hint, 1), gs.cap_floor)
        if p is not None:
            cap = max(cap, p["cap"])
        state_keys, state_slots, state_fs, state_n = gs._ensure_fused_state(gkey_specs, cap)

        plan = StagePlan((FilterOp(pred_sk), JoinProbeOp(len(pkeys), pair_cap),
                          GroupAggOp(gkey_specs, tuple(gs._slots), cap)))
        donate = donation_wanted(conf)
        sides = ",".join(f"{name}:{'p' if on_probe[name] else 'b'}" for name in needed)
        skeleton = plan.skeleton() + f"|v:{','.join(vmodes)}|c:{sides}" + ("|don" if donate else "")
        program = compile_stage(
            skeleton,
            fused_join_agg_program(vmodes, pred_fn, needed, on_probe, gkey_specs, tuple(gs._slots),
                                   cap, pair_cap, donate),
            donate_argnums=(0, 1, 2) if donate else (),
        )
        t0 = _device.program_clock(device)
        args = (state_keys, state_slots, state_fs, state_n,
                build.table, border, build.n, bkenc, pplanes, pkenc, pcols, bcols,
                upload_literals(lits, device), gs._row_base)
        with _program_lint.maybe_verify(conf, "fused-stage-join-agg", f"fused-stage-join-agg/{skeleton}", args):
            total, n_chunk, n_m, n_kept, n_out, fs_out, keys_out, slots_out = program(*args)
        count_dispatch("fused-stage-join-agg")
        total, n_chunk, n_m, n_kept, n_out = A.read_counts(total, n_chunk, n_m, n_kept, n_out)
        _device._observe_program("fused-stage-join-agg", t0)
    gs._partial = {"cap": cap, "n": n_out, "fs": fs_out, "keys": list(keys_out), "slots": list(slots_out)}
    note_peak_bytes([fs_out, *keys_out, *slots_out])
    if total > pair_cap or n_chunk > cap or n_m > cap:
        state.pair_cap = bucket_rows(max(total, 1))
        gs._cap_hint = max(gs._cap_hint, n_chunk, n_m)
        return False
    gs._cap_hint = max(gs._cap_hint, n_m)
    gs._row_base += n_kept
    return True
