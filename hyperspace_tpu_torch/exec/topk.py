"""Streaming top-k on the device: ORDER BY ... LIMIT k without
materialization.

The port of the JAX package's ``hyperspace_tpu/exec/topk.py``
(single-device, unfused). The executor folds one executed chain batch per
file group into a candidate buffer kept on the device, so an ``ORDER BY ...
LIMIT k`` over a multi-chunk scan never holds more than one chunk plus
``O(cap)`` candidate rows on the host.

Per chunk the stream

  1. encodes every ORDER BY key into a signed int64 order plane
     (ops/encode.order_plane: NULLS LAST, the host Sort's tie semantics)
     plus a plane of global row ids, the stable tie-break,
  2. runs the select program (ops/sort.topk_chunk_fn, "topk-chunk") over
     the plane matrix,
  3. merges the chunk's candidates into the running buffer
     (ops/sort.topk_merge_fn, "topk-merge"), and
  4. keeps only the candidate *rows* on the host, pruned to the buffer
     after every merge.

String planes are chunk-local dense ranks, so when a string key is present
the merge re-encodes both candidate sets over their combined raw values on
the host: ``O(cap)`` work, never ``O(rows)``.

The running k-th candidate's primary-key value is exposed as a
conservative ``threshold_condition()`` (``col <= v`` ascending, ``>=``
descending), which the executor pushes into row-group min/max pruning of
chunks not yet decoded.

Under ``hyperspace.exec.fusion.enabled`` every chunk after the first runs
the select and the merge as one program instead (ops/sort.fused_topk_fn,
"fused-stage-topk"), the candidate matrix updated in place with
``hyperspace.exec.fusion.donation``; string keys stay per-family (their
merge needs the host re-encode between select and merge).

Under ``hyperspace.parallel.enabled`` (a ``ShardedExecutor`` as
``parallel``) the select runs per shard of the mesh, and one gather of the
per-shard candidate matrices (``n_shards * cap`` candidates, never rows)
feeds a final select ("sharded-topk", parallel/collectives.py); the fused
fold's twin is "fused-stage-topk-sharded", which never writes its state in
place, as in the JAX package. The merge stays the single-device program.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.check import program_lint as _program_lint
from hyperspace_tpu_torch.exec import batch as B
from hyperspace_tpu_torch.exec import device as D
from hyperspace_tpu_torch.obs.metrics import REGISTRY
from hyperspace_tpu_torch.ops.encode import ORDER_PLANE_SENTINEL, order_plane

_SENT = np.int64(ORDER_PLANE_SENTINEL)

_STRING_KINDS = ("U", "S", "O")


def _chunks_total():
    return REGISTRY.counter(
        "hs_topk_chunks_total",
        "Chunks folded into streaming device top-k candidate buffers",
    )


def _merges_total():
    return REGISTRY.counter(
        "hs_topk_merges_total",
        "Pairwise candidate-buffer merges run by streaming device top-k",
    )


def _threshold_updates_total():
    return REGISTRY.counter(
        "hs_topk_threshold_updates_total",
        "Dynamic k-th-value threshold updates fed back into row-group pruning",
    )


def _merge_seconds_total():
    return REGISTRY.counter(
        "hs_topk_merge_seconds_total",
        "Wall seconds spent in top-k candidate encode/select/merge steps",
    )


def _is_missing_scalar(v) -> bool:
    if v is None:
        return True
    try:
        if isinstance(v, float) and v != v:
            return True
        if isinstance(v, np.floating) and np.isnan(v):
            return True
        if isinstance(v, np.datetime64) and np.isnat(v):
            return True
    except (TypeError, ValueError):
        return False
    return False


class TopKStream:
    """Streaming top-k fold over executed chunk batches.

    The candidate buffer is a ``(num_keys + 1, cap)`` int64 matrix on the
    session's device (one order plane per key, then the row-id plane); the
    matching raw rows live on the host in ``_pool``, stored best-first, so
    the k-th candidate (the threshold row) is ``_pool[...][k - 1]``.
    """

    def __init__(self, session, keys: Sequence[Tuple[str, bool]], k: int, parallel=None):
        self.session = session
        self.keys: List[Tuple[str, bool]] = [(str(c), bool(a)) for c, a in keys]
        self.k = int(k)
        self.cap = D.topk_capacity(self.k)
        self.parallel = parallel
        self.rows_seen = 0          # global row-id base for the next chunk
        self.chunks = 0
        self._state: Optional[torch.Tensor] = None  # (K+1, cap) device candidates
        self._order: Optional[np.ndarray] = None  # candidate rids, best-first
        self._pool: Optional[B.Batch] = None      # candidate rows, best-first
        self._string_keys: Optional[List[bool]] = None
        self._threshold = None      # raw primary-key value of the k-th candidate

    # -- public state ---------------------------------------------------------

    @property
    def has_data(self) -> bool:
        return self._pool is not None and self._order is not None and self._order.size > 0

    def threshold_condition(self):
        """Conservative ``primary_key <= v`` (ascending; ``>=`` descending)
        predicate over the current k-th candidate, or None before the buffer
        holds k definite candidates. Safe as a row-group pruning filter for
        chunks not yet folded: rows it rejects cannot enter the final top-k."""
        if self._threshold is None:
            return None
        from hyperspace_tpu_torch.plan.expr import BinaryOp, Col, Lit

        name, asc = self.keys[0]
        return BinaryOp("<=" if asc else ">=", Col(name), Lit(self._threshold))

    def pool_rows_with_rid(self, rid_column: str) -> B.Batch:
        """Current candidate rows plus their global row ids, for the host
        fallback path: the pool is a superset of the top-k of every row the
        stream has folded, so (pool + remaining chunks) re-sorted on host is
        byte-identical to sorting the full input."""
        out = {c: np.asarray(v) for c, v in (self._pool or {}).items()}
        out[rid_column] = np.asarray(self._order, dtype=np.int64)
        return out

    # -- fold -----------------------------------------------------------------

    def update(self, batch: B.Batch) -> None:
        """Fold one executed chunk batch into the candidate buffer.

        Raises DeviceUnsupported (key column missing / unsupported dtype);
        the caller switches to the host candidate fallback mid-stream."""
        n = B.num_rows(batch)
        if n == 0:
            return
        t0 = time.perf_counter()
        from hyperspace_tpu_torch.plan.expr import get_column

        key_arrays = []
        for c, _ in self.keys:
            arr = get_column(batch, c)
            if arr is None:
                raise D.DeviceUnsupported(f"sort key {c!r} missing from chunk batch")
            key_arrays.append(np.asarray(arr))
        try:
            planes = [order_plane(a, asc) for a, (_, asc) in zip(key_arrays, self.keys)]
        except TypeError as e:
            raise D.DeviceUnsupported(str(e))
        if self._string_keys is None:
            self._string_keys = [a.dtype.kind in _STRING_KINDS for a in key_arrays]

        base = self.rows_seen
        self.rows_seen += n
        rid = base + np.arange(n, dtype=np.int64)

        from hyperspace_tpu_torch.exec import stage_ir

        # whole-stage fold: the chunk's select and the merge in one
        # dispatch. String keys stay per-family (their merge needs the host
        # re-encode between select and merge)
        use_fused = (
            self._state is not None
            and not any(self._string_keys)
            and stage_ir.fusion_wanted(self.session.conf)
        )
        if use_fused:
            merged, cand = self._run_fused(planes + [rid])
        else:
            cand = self._run_chunk(planes + [rid])
        crid = cand[-1].cpu().numpy()
        valid = crid < _SENT
        add_rid = crid[valid]
        local = (add_rid - base).astype(np.int64)
        add_pool: B.Batch = {c: np.asarray(v)[local] for c, v in batch.items()}

        if use_fused:
            pool_all = B.concat([self._pool, add_pool]) if self._pool else add_pool
            rid_all = np.concatenate([self._order, add_rid]) if self._order is not None else add_rid
            self._state = merged
            _merges_total().inc()
            mrid = merged[-1].cpu().numpy()
            merged_rid = mrid[mrid < _SENT]
        elif self._state is None:
            self._state = cand
            merged_rid = add_rid
            pool_all, rid_all = add_pool, add_rid
        else:
            merged_rid, pool_all, rid_all = self._merge(cand, add_pool, add_rid)
        # prune the host pool to the merged candidates, stored best-first
        srt = np.argsort(rid_all, kind="stable")
        pos = srt[np.searchsorted(rid_all[srt], merged_rid)]
        self._order = merged_rid
        self._pool = {c: np.asarray(v)[pos] for c, v in pool_all.items()}

        self.chunks += 1
        _chunks_total().inc()
        self._update_threshold()
        _merge_seconds_total().inc(time.perf_counter() - t0)

    def _upload(self, mat: np.ndarray) -> torch.Tensor:
        return D._host_tensor(mat).to(self.session.device)

    def _run_chunk(self, mat_rows: List[np.ndarray]) -> torch.Tensor:
        from hyperspace_tpu_torch.ops import sort as S

        nk = len(self.keys)
        px = self.parallel
        planes = self._upload(np.stack(mat_rows))
        family = "sharded-topk" if px is not None else "topk-chunk"
        window = _program_lint.maybe_verify(
            self.session.conf, family, lambda: D.program_key(family, f"topk[{nk},{self.cap}]", px), (planes,))
        if px is not None:
            from hyperspace_tpu_torch.parallel import collectives as C

            program = C.sharded_topk_chunk_program(px.mesh, px.axis, nk, self.cap)
            with window:
                out = px.timed_call("topk", program, planes)
        else:
            with window:
                out = S.topk_chunk_fn(nk, self.cap)(planes)
        D.count_dispatch(family)
        return out

    def _run_fused(self, mat_rows: List[np.ndarray]):
        """One-dispatch fold: the chunk's select-top-k and the merge with the
        running candidate state as one program, the state written in place
        with ``hyperspace.exec.fusion.donation``. Returns ``(merged, cand)``;
        the caller rebinds ``self._state`` to ``merged``."""
        from hyperspace_tpu_torch.exec import stage_ir
        from hyperspace_tpu_torch.ops import sort as S

        nk = len(self.keys)
        px = self.parallel
        # the sharded fold never writes its state in place, as in the JAX
        # package
        donate = stage_ir.donation_wanted(self.session.conf) and px is None
        plan = stage_ir.StagePlan((stage_ir.TopKOp(nk, self.cap),))
        if px is not None:
            from hyperspace_tpu_torch.parallel import collectives as C
            from hyperspace_tpu_torch.parallel.mesh import mesh_fingerprint

            family = "fused-stage-topk-sharded"
            skeleton = f"{plan.skeleton()}@{mesh_fingerprint(px.mesh)}/shmap"
            fn = C.sharded_fused_topk_program(px.mesh, px.axis, nk, self.cap)
        else:
            family = "fused-stage-topk"
            skeleton = f"{plan.skeleton()}{'+d' if donate else ''}"
            fn = S.fused_topk_fn(nk, self.cap, donate)
        program = stage_ir.compile_stage(skeleton, fn, donate_argnums=(0,) if donate else ())
        planes = self._upload(np.stack(mat_rows))
        with _program_lint.maybe_verify(self.session.conf, family, f"{family}/{skeleton}", (self._state, planes)):
            if px is not None:
                merged, cand = px.timed_call("topk", program, self._state, planes)
            else:
                merged, cand = program(self._state, planes)
        stage_ir.count_dispatch(family)
        stage_ir.note_peak_bytes([merged])
        return merged, cand

    def _merge(self, cand: torch.Tensor, add_pool: B.Batch, add_rid: np.ndarray):
        """Merge the chunk's candidate matrix into the running buffer.

        Returns ``(merged_rid, pool_all, rid_all)`` where ``pool_all`` /
        ``rid_all`` concatenate the old pool with the chunk additions (the
        superset the merged rids index into)."""
        from hyperspace_tpu_torch.ops import sort as S

        a, b = self._state, cand
        pool_all = B.concat([self._pool, add_pool]) if self._pool else add_pool
        rid_all = (
            np.concatenate([self._order, add_rid]) if self._order is not None else add_rid
        )
        if any(self._string_keys):
            # chunk-local string ranks are not comparable across chunks:
            # rebuild BOTH candidate matrices from raw pooled values over one
            # combined encoding (O(cap) host work) before the device merge
            a, b = (self._upload(m) for m in self._rebuild_matrices(add_pool, add_rid))
        with _program_lint.maybe_verify(self.session.conf, "topk-merge",
                                        f"topk-merge/topk[{len(self.keys)},{self.cap}]", (a, b)):
            merged = S.topk_merge_fn(len(self.keys), self.cap)(a, b)
        D.count_dispatch("topk-merge")
        self._state = merged
        _merges_total().inc()
        mrid = merged[-1].cpu().numpy()
        return mrid[mrid < _SENT], pool_all, rid_all

    def _rebuild_matrices(self, add_pool: B.Batch, add_rid: np.ndarray):
        """Host-rebuilt (K+1, cap) plane matrices for both merge sides, with
        every key plane re-encoded over the combined raw values so string
        ranks (and every other plane, trivially) are mutually comparable."""
        n_a = int(self._order.size)
        mats = []
        sides = [
            ({c: np.asarray(v) for c, v in self._pool.items()}, self._order),
            (add_pool, add_rid),
        ]
        planes_ab: List[List[np.ndarray]] = [[], []]
        for c, asc in self.keys:
            both = np.concatenate(
                [np.asarray(sides[0][0][c]), np.asarray(sides[1][0][c])]
            )
            pl = order_plane(both, asc)
            planes_ab[0].append(pl[:n_a])
            planes_ab[1].append(pl[n_a:])
        for (pool, rid), planes in zip(sides, planes_ab):
            rows = [
                np.concatenate([p, np.full(self.cap - p.shape[0], _SENT, dtype=np.int64)])
                if p.shape[0] < self.cap
                else p[: self.cap]
                for p in planes + [np.asarray(rid, dtype=np.int64)]
            ]
            mats.append(np.stack(rows))
        return mats[0], mats[1]

    def _update_threshold(self) -> None:
        if self._order is None or self._order.size < self.k:
            return
        name, _asc = self.keys[0]
        col = self._pool.get(name)
        if col is None:
            return
        v = np.asarray(col)[self.k - 1]
        if _is_missing_scalar(v):
            return
        if isinstance(v, np.generic) and v.dtype.kind not in ("M", "m"):
            v = v.item()
        if self._threshold is None or v != self._threshold:
            self._threshold = v
            _threshold_updates_total().inc()

    # -- result ---------------------------------------------------------------

    def finalize(self) -> Optional[B.Batch]:
        """The top-k rows, best-first: byte-identical to the host stable
        sort and slice (ties resolved by the row-id plane, the input
        order)."""
        if not self.has_data:
            return None
        return {c: np.asarray(v)[: self.k] for c, v in self._pool.items()}
