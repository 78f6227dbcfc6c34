"""The shuffle-free bucketed sort-merge join over two covering indexes.

When JoinIndexRule has rewritten both sides of an equi-join to index scans
bucketed on the join keys with equal bucket counts, bucket i of the left
joins bucket i of the right alone, and both are sorted on the keys: no
exchange, no hash table (ref: HS/index/covering/JoinIndexRule.scala:604-705).
This is the port of the JAX package's bucketed join
(``hyperspace_tpu/exec/device.py``), with its decisions, caches and trace:

  1. both sides decode per bucket, each bucket sorted on the keys (a bucket
     of several runs is re-sorted; a side's Filter applies per bucket; a
     hybrid-scan side's appended rows are re-bucketed on the host with the
     build's hash and concatenated with the index's bucket);
  2. the keys encode to one int64 per row, order-preserving and comparable
     across sides: identity for one int or date key, dense ranks shared by
     both sides for composite and string keys;
  3. per bucket, every left row's span ``[lo, hi)`` of equal right keys:
     on the device (``bucketed-smj-span``) above ``deviceMinRows`` input
     rows, else on the host (the native merge walk ``native.merge_spans``,
     or ``np.searchsorted`` without the library);
  4. the pairs expand and the output columns gather: for an inner join on
     the device (``join-expand-gather``; string columns gather on the host
     from the downloaded row indexes), otherwise on the host (the native
     ``native.expand_pairs``, numpy past int32 range), where outer joins
     null-extend their unmatched rows.

The device programs are torch programs on the session's device, like the
filter's predicate program; the JAX package's are XLA programs. Only
``DeviceUnsupported`` — a shape the bucketed join does not cover, raised
before any upload — sends the executor to its generic merge.

Above ``hyperspace.exec.stream.joinMinBytes`` of index files the join
streams (``stream_bucketed_join``): one bucket pair decodes at a time, on
the scan pipeline ahead of the consumer, and its pairs expand on the host;
``dispatch_bucketed_join`` folds the chunks into one batch.

An aggregate over such a join never expands the pairs
(``aggregate_over_bucketed_join``): the host spans give each left row's
multiplicity, so sums are span-weighted and right-side sums prefix-sum
differences, per bucket, with int64 overflow guards; grouped aggregates
reduce sub-segments of each bucket's sorted run and merge them once.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch import native
from hyperspace_tpu_torch.check import program_lint as _program_lint
from hyperspace_tpu_torch.exec import batch as B
from hyperspace_tpu_torch.exec import trace
from hyperspace_tpu_torch.exec.aggregate import _AGG_FNS
from hyperspace_tpu_torch.exec.device import (
    DeviceUnsupported,
    _device_cache,
    _observe_program,
    count_dispatch,
    program_clock,
)
from hyperspace_tpu_torch.ops.encode import sort_key_int64
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.plan.expr import (
    as_bool_mask,
    contains_input_file_name,
    extract_equi_join_keys,
    strip_nested_prefix,
)
from hyperspace_tpu_torch.reliability.faults import FAULTS
from hyperspace_tpu_torch.utils.lru import BytesLRU

#: key of the padding slots of the key rectangles: above every real key
SENTINEL = 2**62


# --------------------------------------------------------------------------
# compatibility and per-bucket decode
# --------------------------------------------------------------------------


def _strip_projects(plan: L.LogicalPlan) -> L.LogicalPlan:
    while isinstance(plan, L.Project):
        plan = plan.child
    return plan


def _side_bucket_spec(node: L.LogicalPlan) -> Optional[L.BucketSpec]:
    """The bucket layout a join side arrives in, looking through the
    layout-preserving wrappers (Project/Filter). Covers plain IndexScans AND
    hybrid-scan sides (BucketUnion of index minus deletes + re-bucketed
    appends — ref: CoveringIndexRuleUtils.scala:146-288)."""
    spec = getattr(node, "bucket_spec", None)
    if spec is not None:
        return spec
    if isinstance(node, (L.Project, L.Filter)):
        return _side_bucket_spec(node.child)
    return None


def join_sides_compatible(plan: L.Join) -> Optional[Tuple[L.LogicalPlan, L.LogicalPlan, List[str], List[str]]]:
    """If both join children arrive bucketed on exactly the join keys with
    equal bucket counts — index scans or hybrid-scan BucketUnions — return
    (left_side, right_side, lkeys, rkeys); else None (ref: JoinIndexRanker's
    equal-bucket preference, HS/index/covering/JoinIndexRanker.scala:52-92)."""
    if plan.residual is not None:
        return None  # non-equi ON residuals run on the host join path
    pairs = extract_equi_join_keys(plan.condition)
    if not pairs:
        return None
    lspec = _side_bucket_spec(plan.left)
    rspec = _side_bucket_spec(plan.right)
    if lspec is None or rspec is None or lspec.num_buckets != rspec.num_buckets:
        return None
    lcols = set(plan.left.output_columns)
    rcols = set(plan.right.output_columns)
    lkeys, rkeys = [], []
    for a, b in pairs:
        if a in lcols and b in rcols:
            lkeys.append(a)
            rkeys.append(b)
        elif b in lcols and a in rcols:
            lkeys.append(b)
            rkeys.append(a)
        else:
            return None

    def norm(cols):
        return [strip_nested_prefix(c).lower() for c in cols]

    if norm(lspec.bucket_columns) != norm(lkeys) or norm(rspec.bucket_columns) != norm(rkeys):
        return None
    return plan.left, plan.right, lkeys, rkeys


def _bucket_readers(scan: L.IndexScan, columns: List[str], sort_keys: List[str]):
    """{bucket id -> thunk} decoding one bucket of an IndexScan (the file
    name carries the bucket), only ``columns``. A bucket of several files
    (one sorted run per build chunk) is re-sorted on ``sort_keys``:
    concatenated runs are only piecewise sorted."""
    from hyperspace_tpu_torch.exec.io import read_parquet_batch
    from hyperspace_tpu_torch.indexes.covering import bucket_of_file

    per_bucket: Dict[int, List[str]] = {}
    for f in scan.files:
        b = bucket_of_file(f)
        if b is None:
            raise DeviceUnsupported(f"index file {f!r} has no bucket id")
        per_bucket.setdefault(b, []).append(f)
    file_cols = list(columns)
    if scan.file_columns is not None:
        stored = dict(zip(scan.columns, scan.file_columns))
        file_cols = [stored.get(c, c) for c in columns]
    rename = file_cols != list(columns)

    def make(files):
        def read() -> B.Batch:
            batch = read_parquet_batch(files, file_cols)
            if rename:
                batch = {o: batch[fc] for o, fc in zip(columns, file_cols)}
            if sort_keys and len(files) > 1:
                batch = _sort_bucket(batch, sort_keys)
            return batch

        return read

    return {b: make(files) for b, files in per_bucket.items()}


def _sort_bucket(batch: B.Batch, sort_keys: List[str]) -> B.Batch:
    """``batch`` sorted on ``sort_keys`` under the build's order encoding
    (ops/encode.sort_key_int64: null-safe, NaN-safe), stably."""
    cols = [sort_key_int64(batch[k]) for k in sort_keys]
    if not cols or cols[0].size <= 1:
        return batch
    if len(cols) == 1:
        k = cols[0]
        if np.any(k[1:] < k[:-1]):
            return B.take(batch, np.argsort(k, kind="stable"))
        return batch
    return B.take(batch, np.lexsort(cols[::-1]))  # first key primary


def _composite_ranks(l_arrs: List[np.ndarray], r_arrs: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Order-preserving dense int64 ranks of the composite key tuples, shared
    across both sides: equal tuples (across sides) get equal ranks, and rank
    order is the lexicographic tuple order. Lets multi-column and string join
    keys reuse the single-int64 span machinery unchanged."""
    n = l_arrs[0].shape[0]
    cols = [sort_key_int64(np.concatenate([la, ra])) for la, ra in zip(l_arrs, r_arrs)]
    order = np.lexsort(cols[::-1])
    change = np.zeros(order.shape[0], dtype=bool)
    for c in cols:
        cs = c[order]
        if cs.shape[0] > 1:
            change[1:] |= cs[1:] != cs[:-1]
    ranks_sorted = np.cumsum(change.astype(np.int64))
    ranks = np.empty(order.shape[0], dtype=np.int64)
    ranks[order] = ranks_sorted
    return ranks[:n], ranks[n:]


def _side_bucket_readers(session, node: L.LogicalPlan, columns: List[str], sort_keys: List[str]):
    """Lazy per-bucket readers of one join side: ``{bucket -> thunk}``,
    each thunk decoding (and sorting and filtering) only its bucket, or
    giving None for a bucket the side has no rows in. The shapes: an
    IndexScan leaf; a Filter, evaluated per bucket (masking keeps the
    order; hybrid scan's lineage NOT IN is one); a Repartition of appended
    files, re-bucketed on the host with the build's hash (``_rebucket``);
    and a BucketUnion, concatenated per bucket and re-sorted once. Every
    other shape raises DeviceUnsupported. The streamed join walks buckets
    one at a time through these, so peak memory is one bucket pair, not
    both whole sides (``_side_buckets`` decodes everything, fine below the
    streaming threshold)."""
    node = _strip_projects(node)
    if isinstance(node, L.IndexScan):
        return _bucket_readers(node, columns, sort_keys)
    if isinstance(node, L.Filter):
        if contains_input_file_name(node.condition):
            raise DeviceUnsupported("input_file_name() predicate on a join side")
        inner_cols = list(dict.fromkeys(list(columns) + list(node.condition.references())))
        child = _side_bucket_readers(session, node.child, inner_cols, sort_keys)

        def wrap(thunk):
            def read() -> Optional[B.Batch]:
                batch = thunk()
                if batch is None:  # an empty bucket of a Repartition or BucketUnion
                    return None
                kept = B.mask_rows(batch, as_bool_mask(node.condition.eval(batch)))  # stays sorted
                return {c: kept[c] for c in columns}

            return read

        return {b: wrap(t) for b, t in child.items()}
    if isinstance(node, L.Repartition):
        # the appended-files side: small by hybridscan.maxAppendedRatio, so
        # it re-buckets whole, once, on the first bucket's read (the lock
        # keeps the pipeline's concurrent bucket reads from each doing it)
        cell: Dict[str, Dict[int, B.Batch]] = {}
        lock = threading.Lock()

        def load() -> Dict[int, B.Batch]:
            with lock:
                if "b" not in cell:
                    cell["b"] = _rebucket(session, node, columns, sort_keys)
            return cell["b"]

        def make_r(b):
            return lambda: load().get(b)

        return {b: make_r(b) for b in range(node.bucket_spec.num_buckets)}
    if isinstance(node, L.BucketUnion):
        parts = [_side_bucket_readers(session, c, columns, sort_keys) for c in node.children()]
        keys = set()
        for p in parts:
            keys |= set(p)

        def make_u(b):
            def read() -> Optional[B.Batch]:
                got = [t() for t in (p.get(b) for p in parts) if t is not None]
                got = [g for g in got if g is not None]
                batches = [g for g in got if B.num_rows(g)]
                if not batches:
                    return got[0] if got else None  # a bucket of no rows stays one
                if len(batches) == 1:
                    return batches[0]
                return _sort_bucket(B.concat(batches), sort_keys)

            return read

        return {b: make_u(b) for b in keys}
    raise DeviceUnsupported(f"join side {type(node).__name__} is not a bucketed shape")


#: re-bucketed hybrid-scan appends, keyed on the appended files' identity
_REBUCKET_CACHE = BytesLRU(1 << 28)


def _rebucket(session, node: L.Repartition, columns: List[str], sort_keys: List[str]) -> Dict[int, B.Batch]:
    """The appended rows of a hybrid-scan side, per bucket, each sorted on
    ``sort_keys``: the same hash as the index build places each row in its
    index bucket. Hybrid scan re-buckets the SAME appended files on every
    query against the index (ref: CoveringIndexRuleUtils.scala:357-417), so
    the result is cached on the files' (path, mtime, size) and the plan
    text; a new append misses."""
    from hyperspace_tpu_torch.exec.executor import Executor
    from hyperspace_tpu_torch.ops.encode import hash_input_uint32
    from hyperspace_tpu_torch.ops.hashing import bucket_ids_np

    spec = node.bucket_spec
    cache_key = None
    files = []
    for p in L.collect(node.child, lambda x: isinstance(x, (L.FileScan, L.Scan))):
        files.extend([fi.name for fi in p.relation.all_file_infos()] if isinstance(p, L.Scan) else p.files)
    if files:
        try:
            ident = tuple((f, os.stat(f).st_mtime_ns, os.stat(f).st_size) for f in files)
            cache_key = (
                "rebucket", ident, spec.num_buckets, tuple(spec.bucket_columns), tuple(columns),
                tuple(sort_keys), node.child.pretty(),
            )
        except OSError:
            cache_key = None
    if cache_key is not None:
        hit = _REBUCKET_CACHE.get(cache_key)
        if hit is not None:
            trace.record("rebucket", "cached")
            return {b: dict(v) for b, v in hit.items()}
    batch = Executor(session).execute(node.child, required_columns=list(columns))
    try:
        key_cols = [batch[c] for c in spec.bucket_columns]
    except KeyError as e:
        raise DeviceUnsupported(f"bucket column missing from appended side: {e}")
    nb = spec.num_buckets
    ids = bucket_ids_np([hash_input_uint32(c) for c in key_cols], nb)
    order = np.argsort(ids, kind="stable")
    bounds = np.searchsorted(ids[order], np.arange(nb + 1))
    out: Dict[int, B.Batch] = {}
    for b in range(nb):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        if hi > lo:
            idx = order[lo:hi]
            out[b] = _sort_bucket({c: batch[c][idx] for c in columns}, sort_keys)
    if cache_key is not None:
        nbytes = sum(a.nbytes for v in out.values() for a in v.values() if hasattr(a, "nbytes"))
        # keep copies of the per-bucket dicts: a caller may add keys to what
        # it is handed, on a hit or a miss alike
        _REBUCKET_CACHE.put(cache_key, {b: dict(v) for b, v in out.items()}, nbytes)
        trace.record("rebucket", "computed")
    return out


def _side_buckets(session, node: L.LogicalPlan, columns: List[str], sort_keys: List[str]) -> Dict[int, B.Batch]:
    """Every bucket of one join side that holds rows, decoded, each sorted
    on ``sort_keys`` (``_side_bucket_readers``)."""
    readers = _side_bucket_readers(session, node, columns, sort_keys)
    trace.record("scan", "index-bucketed")
    out = {}
    for b, read in readers.items():
        got = read()
        if got is not None:
            out[b] = got
    return out


def _join_key_of(batch: B.Batch, key: str) -> np.ndarray:
    """Encode a join-key column; only identity-ordered encodings are
    cross-side comparable."""
    arr = batch[key]
    if arr.dtype.kind in ("i", "u", "b"):
        return arr.astype(np.int64)
    if arr.dtype.kind == "M":
        return arr.view("int64").astype(np.int64)
    raise DeviceUnsupported(f"device join requires integer/datetime keys; got {arr.dtype}")


_FOOTER_ROWS_CACHE: Dict[Tuple[str, int, int], int] = {}


def _file_num_rows(path: str) -> int:
    """Row count from the parquet footer, memoized on (path, mtime, size)."""
    import pyarrow.parquet as pq

    st = os.stat(path)
    key = (path, st.st_mtime_ns, st.st_size)
    got = _FOOTER_ROWS_CACHE.get(key)
    if got is None:
        if len(_FOOTER_ROWS_CACHE) > 65536:
            _FOOTER_ROWS_CACHE.clear()
        got = pq.read_metadata(path).num_rows
        _FOOTER_ROWS_CACHE[key] = got
    return got


def _side_files(node: L.LogicalPlan) -> List[str]:
    files: List[str] = []
    for p in L.collect(node, lambda x: isinstance(x, (L.IndexScan, L.FileScan))):
        files.extend(p.files)
    return files


#: composite-key rank encodings keyed on both sides' full identity
_RANK_CACHE = BytesLRU(1 << 29)


def clear_rank_cache() -> None:
    """Drop the composite-key encodings and the re-bucketed appends."""
    _RANK_CACHE.clear()
    _REBUCKET_CACHE.clear()


def _rank_cache_key(lside, rside, lkeys: List[str], rkeys: List[str]):
    """Identity of a key encoding: both sides' (file, mtime, size) sets, the
    key names, AND the sides' plan text — ranks are computed over rows that
    survive the sides' Filters, so a changed filter over identical files
    must miss. None (= don't cache) when any file can't be stat'ed."""
    parts = [tuple(lkeys), tuple(rkeys), lside.pretty(), rside.pretty()]
    for side in (lside, rside):
        files = []
        for f in _side_files(side):
            try:
                st = os.stat(f)
            except OSError:
                return None
            files.append((f, st.st_mtime_ns, st.st_size))
        parts.append(tuple(files))
    return tuple(parts)


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------


def dispatch_bucketed_join(session, plan: L.Join) -> B.Batch:
    """The bucketed join's entry point: one compatibility analysis, then
    device or host spans by the input-rows threshold and the span round
    trip's byte budget. Raises DeviceUnsupported when the join isn't a
    compatible bucketed pair (the executor then runs its generic merge)."""
    stages = session.query_stage_seconds
    t = time.perf_counter()
    compat = join_sides_compatible(plan)
    if compat is None:
        raise DeviceUnsupported("join sides are not compatible bucketed index scans")
    lside, rside, _lkeys, _rkeys = compat
    files = [f for side in (lside, rside) for f in _side_files(side)]
    try:
        total = sum(_file_num_rows(f) for f in files)
    except OSError:
        total = 0  # unreadable footer -> stay on host
    stream_min = session.conf.stream_join_min_bytes
    if stream_min and stream_min > 0:
        try:
            input_bytes = sum(os.stat(f).st_size for f in files)
        except OSError:
            input_bytes = 0
        if input_bytes >= stream_min:
            # out of core: walk the buckets one at a time instead of
            # decoding both whole sides
            stages["join_plan"] += time.perf_counter() - t
            return _fold_streamed_join(session, plan, compat)
    stages["join_plan"] += time.perf_counter() - t
    setup = _bucketed_join_setup(session, plan, compat)
    # the span program's round trip is known here: keys go up as rectangles
    # of nb x (widest bucket) int64, and [lo, hi) comes down (16 B per left
    # slot) unless the device materialization consumes it on the device.
    # Above the budget the host span walk (no transfer) wins
    lbuckets, rbuckets, _lk, _rk, nb, _lc, _rc = setup
    wl = max((B.num_rows(b) for b in lbuckets.values()), default=1)
    wr = max((B.num_rows(b) for b in rbuckets.values()), default=1)
    span_bytes = nb * (wl + wr) * 8
    if plan.how != "inner" or not session.conf.join_device_materialize:
        span_bytes += nb * wl * 16
    if total >= session.conf.device_exec_min_rows and span_bytes <= session.conf.join_device_span_max_bytes:
        try:
            out = device_bucketed_join(session, plan, compat, setup)
            trace.record("join", "device-smj")
            return out
        except DeviceUnsupported:
            # a decoded shape the device path does not cover; the host span
            # path takes it, as in the JAX package
            trace.fallback("join", "unsupported")
    out = host_bucketed_join(session, plan, compat, setup)
    trace.record("join", "host-span-smj")
    return out


def _fold_streamed_join(session, plan: L.Join, compat) -> B.Batch:
    """The streamed join's chunks folded into one batch. The fold is
    geometric: the pending chunks are concatenated onto the merged result
    once they reach its size, so the copy work stays O(result) and at most
    one merged copy and one run are alive; the generator is closed on any
    exit, so both sides' readers stop mid-stream. An empty stream is typed
    from the index footers: falling back to the generic merge would
    materialize both sides, which this path exists to avoid."""
    stages = session.query_stage_seconds
    gen = stream_bucketed_join(session, plan, _compat=compat)
    merged = None
    merged_bytes = 0
    pending: List[B.Batch] = []
    pending_bytes = 0
    try:
        for chunk in gen:
            t = time.perf_counter()
            pending.append(chunk)
            pending_bytes += _chunk_nbytes(chunk)
            if merged is None or pending_bytes >= merged_bytes:
                batches = ([merged] if merged is not None else []) + pending
                merged = batches[0] if len(batches) == 1 else B.concat(batches)
                merged_bytes = _chunk_nbytes(merged)
                pending, pending_bytes = [], 0
            _add(stages, "join_fold", t)
    finally:
        gen.close()
    t = time.perf_counter()
    if pending:
        batches = ([merged] if merged is not None else []) + pending
        merged = batches[0] if len(batches) == 1 else B.concat(batches)
    _add(stages, "join_fold", t)
    if merged is None:
        lside, rside, lkeys, rkeys = compat
        lc, rc = _stream_needed_columns(plan, lside, rside, lkeys, rkeys)
        hints = _stream_join_dtype_hints(plan, lside, rside, lc, rc)
        if all(n in hints for n in plan.output_columns):
            trace.record("join", "host-span-smj-stream")
            return {n: np.empty(0, dtype=hints[n]) for n in plan.output_columns}
        raise DeviceUnsupported("streamed join produced no rows")
    trace.record("join", "host-span-smj-stream")
    return merged


def _stream_needed_columns(plan: L.Join, lside, rside, lkeys, rkeys):
    """(left, right) columns the streamed join decodes: its output's
    sources and the keys."""
    needed = set(plan.output_columns) | {n[:-2] for n in plan.output_columns if n.endswith("#r")}
    lc = [c for c in lside.output_columns if c in needed or c in lkeys]
    rc = [c for c in rside.output_columns if c in needed or c in rkeys]
    return lc, rc


def _stream_join_dtype_hints(plan: L.Join, lside, rside, lcols_needed, rcols_needed) -> Dict[str, np.dtype]:
    """Footer-derived dtypes of the join's output columns: a bucket where
    one side is absent still needs that side's columns typed (the
    whole-side path reads them from other buckets; per-bucket streaming
    cannot), and an EMPTY streamed result is built entirely from these."""
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.sources.schema import arrow_to_numpy_dtype

    def side_dtypes(side, cols) -> Dict[str, np.dtype]:
        scans = L.collect(side, lambda x: isinstance(x, L.IndexScan))
        if not scans or not scans[0].files:
            return {}
        scan = scans[0]
        try:
            sch = pq.read_schema(scan.files[0])
        except OSError:
            return {}
        stored = dict(zip(scan.columns, scan.file_columns or scan.columns))
        out: Dict[str, np.dtype] = {}
        for c in cols:
            fc = stored.get(c, c)
            if fc in sch.names:
                out[c] = arrow_to_numpy_dtype(sch.field(fc).type)
        return out

    lmap = side_dtypes(lside, lcols_needed)
    rmap = side_dtypes(rside, rcols_needed)
    hints: Dict[str, np.dtype] = {}
    for name in plan.output_columns:
        try:
            is_left, col = _join_column_source(name, lcols_needed, rcols_needed)
        except DeviceUnsupported:
            # no resolvable side: the column keeps no hint, and its dtype
            # then depends on which buckets hold rows
            trace.fallback("join", "dtype_hint")
            trace.record("join", f"dtype-hint-dropped({name})")
            continue
        dt = (lmap if is_left else rmap).get(col)
        if dt is not None:
            hints[name] = dt
    return hints


def _chunk_nbytes(batch: B.Batch) -> int:
    return sum(int(np.asarray(a).nbytes) for a in batch.values())


def stream_bucketed_join(session, plan: L.Join, _compat=None):
    """Yield the bucketed join's output ONE BUCKET AT A TIME: per bucket,
    both sides decode, the keys encode, the spans come from the native
    merge walk (``np.searchsorted`` without it), the pairs expand, and the chunk is yielded before
    the next bucket's expansion. No state spans buckets, so memory stays
    O(bucket pair + one output chunk) at any scale (ref:
    HS/index/covering/JoinIndexRule.scala:604-705).

    With ``hyperspace.exec.join.pipeline.enabled`` (and the pipeline's own
    switch) on, bucket b+1's two side decodes and its key encoding run on
    the prefetch pipeline (exec/pipeline.py) while bucket b's pairs expand
    on the consumer thread, under the pipeline's depth and byte budgets and
    cancel-safe on generator close. Off, the serial loop gives the same
    chunks.

    This is host work, as in the JAX package. Each bucket's decode passes
    the ``join.task`` fault seam first. Used above ``hyperspace.exec.stream.joinMinBytes`` by
    ``dispatch_bucketed_join`` and by ``DataFrame.to_local_iterator``.
    Chunk dtypes may differ across buckets (a nullable int column is
    float64 only in chunks holding nulls); ``B.concat`` promotes."""
    from hyperspace_tpu_torch.exec.pipeline import ScanPipeline, on_producer_thread

    compat = _compat if _compat is not None else join_sides_compatible(plan)
    if compat is None:
        raise DeviceUnsupported("join sides are not compatible bucketed index scans")
    lside, rside, lkeys, rkeys = compat
    if plan.how not in ("inner", "left", "right", "outer"):
        raise DeviceUnsupported(f"unsupported join type {plan.how!r}")
    lcols_needed, rcols_needed = _stream_needed_columns(plan, lside, rside, lkeys, rkeys)
    lread = _side_bucket_readers(session, lside, lcols_needed, lkeys)
    rread = _side_bucket_readers(session, rside, rcols_needed, rkeys)
    nb = _side_bucket_spec(lside).num_buckets
    keep_left = plan.how in ("left", "outer")
    keep_right = plan.how in ("right", "outer")
    stages = session.query_stage_seconds

    hints = _stream_join_dtype_hints(plan, lside, rside, lcols_needed, rcols_needed)
    parts = [b for b in range(nb) if b in lread or b in rread]

    def decode_pair(b):
        """The producer half: both sides' decodes and the span keys' encoding
        (after the decode, the bucket's largest host cost)."""
        if FAULTS.active:
            FAULTS.check("join.task")
        t = time.perf_counter()
        lt, rt = lread.get(b), rread.get(b)
        lb = lt() if lt is not None else None
        rb = rt() if rt is not None else None
        if lb is not None and B.num_rows(lb) == 0:
            lb = None
        if rb is not None and B.num_rows(rb) == 0:
            rb = None
        lk = rk = None
        if lb is not None and rb is not None:
            if len(lkeys) == 1:
                try:
                    lk = _join_key_of(lb, lkeys[0])
                    rk = _join_key_of(rb, rkeys[0])
                except DeviceUnsupported:
                    lk = rk = None
            if lk is None:
                lk, rk = _composite_ranks([lb[k] for k in lkeys], [rb[k] for k in rkeys])
        _add(stages, "prefetch_join_decode" if on_producer_thread() else "join_decode", t)
        return lb, rb, lk, rk

    def expand(lb, rb, lk, rk):
        """The consumer half: the spans and the pair expansion; None when
        the bucket gives no output rows."""
        if lb is None and rb is None:
            return None
        if lb is None and not keep_right:
            return None
        if rb is None and not keep_left:
            return None
        t = time.perf_counter()
        span_of = None
        if lb is not None and rb is not None:

            def span_of(_b, lk=lk, rk=rk):
                try:
                    return native.merge_spans(lk, rk)
                except native.NativeUnsupported:
                    return np.searchsorted(rk, lk, side="left"), np.searchsorted(rk, lk, side="right")

        chunk = _expand_join_pairs(
            plan,
            {0: lb} if lb is not None else {},
            {0: rb} if rb is not None else {},
            1,
            lcols_needed,
            rcols_needed,
            span_of,
            dtype_fallback=hints,
        )
        _add(stages, "join_host_expand", t)
        return chunk if B.num_rows(chunk) else None

    conf = session.conf
    if conf.join_pipeline_enabled and conf.pipeline_enabled and len(parts) > 1:

        def weigh(res):
            lb, rb, _lk, _rk = res
            return sum(_chunk_nbytes(x) for x in (lb, rb) if x is not None)

        pipe = ScanPipeline(
            [lambda b=b: decode_pair(b) for b in parts],
            depth=conf.pipeline_depth,
            max_buffered_bytes=conf.pipeline_max_buffered_bytes,
            weigh=weigh,
        )
        try:
            t = time.perf_counter()
            for lb, rb, lk, rk in pipe:
                _add(stages, "stream_wait", t)
                chunk = expand(lb, rb, lk, rk)
                if chunk is not None:
                    _count_join_stream_chunk()
                    yield chunk
                t = time.perf_counter()
        finally:
            # a generator closed mid-stream lands here: queued bucket
            # decodes are cancelled and the ones in flight waited for, so
            # neither side's readers outlive the stream
            pipe.close()
        return

    for b in parts:
        chunk = expand(*decode_pair(b))
        if chunk is not None:
            _count_join_stream_chunk()
            yield chunk


def _count_join_stream_chunk() -> None:
    from hyperspace_tpu_torch.obs.metrics import REGISTRY

    REGISTRY.counter(
        "hs_join_stream_chunks_total",
        "Chunks yielded by the streaming join paths (bucketed SMJ buckets + broadcast probe chunks)",
    ).inc()


def _bucketed_join_setup(session, plan: L.Join, compat=None, needed_override=None):
    """Validation and the per-bucket decode of both sides. Returns
    (lbuckets, rbuckets, lkeys, rkeys, nb, lcols_needed, rcols_needed).
    ``needed_override`` = (left cols, right cols) replaces the columns the
    join emits (the fused aggregate reads only its inputs)."""
    if compat is None:
        compat = join_sides_compatible(plan)
    if compat is None:
        raise DeviceUnsupported("join sides are not compatible bucketed index scans")
    lside, rside, lkeys, rkeys = compat
    if plan.how not in ("inner", "left", "right", "outer"):
        raise DeviceUnsupported(f"unsupported join type {plan.how!r}")
    t = time.perf_counter()
    # decode only the columns the consumer needs (plus keys)
    if needed_override is not None:
        need_l, need_r = set(needed_override[0]), set(needed_override[1])
    else:
        need_l = need_r = set(plan.output_columns) | {n[:-2] for n in plan.output_columns if n.endswith("#r")}
    lcols_needed = [c for c in lside.output_columns if c in need_l or c in lkeys]
    rcols_needed = [c for c in rside.output_columns if c in need_r or c in rkeys]
    lbuckets = _side_buckets(session, lside, lcols_needed, lkeys)
    rbuckets = _side_buckets(session, rside, rcols_needed, rkeys)
    nb = _side_bucket_spec(lside).num_buckets
    session.query_stage_seconds["join_decode"] += time.perf_counter() - t
    return lbuckets, rbuckets, lkeys, rkeys, nb, lcols_needed, rcols_needed


def _encoded_join_keys(setup, compat, pair_key=None) -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray]]:
    """Per-bucket int64 key arrays for both sides, order-preserving and
    cross-side comparable. One int or date key passes through; composite and
    string keys encode per bucket into shared dense ranks, cached across
    queries on the sides' files and plan text (``pair_key``, computed here
    when the caller has not already). The same arrays feed the host span
    walk and the device span program."""
    lbuckets, rbuckets, lkeys, rkeys, _nb, _lc, _rc = setup
    if len(lkeys) == 1:
        try:
            return (
                {b: _join_key_of(batch, lkeys[0]) for b, batch in lbuckets.items()},
                {b: _join_key_of(batch, rkeys[0]) for b, batch in rbuckets.items()},
            )
        except DeviceUnsupported:
            pass  # a string key: ranks below
    if pair_key is None:
        pair_key = _rank_cache_key(*compat)
    cached = _RANK_CACHE.get(pair_key) if pair_key is not None else None
    if cached is not None:
        return cached
    lkeys_by_bucket: Dict[int, np.ndarray] = {}
    rkeys_by_bucket: Dict[int, np.ndarray] = {}
    for b in set(lbuckets) & set(rbuckets):
        lkeys_by_bucket[b], rkeys_by_bucket[b] = _composite_ranks(
            [lbuckets[b][k] for k in lkeys], [rbuckets[b][k] for k in rkeys]
        )
    if pair_key is not None:
        nbytes = sum(a.nbytes for d in (lkeys_by_bucket, rkeys_by_bucket) for a in d.values())
        _RANK_CACHE.put(pair_key, (lkeys_by_bucket, rkeys_by_bucket), nbytes)
    return lkeys_by_bucket, rkeys_by_bucket


def _join_column_source(name: str, lout, rout) -> Tuple[bool, str]:
    """(is_left, source column name) for one join output column; the join's
    '#r'-suffixed duplicates resolve to the right side (the single naming
    convention of plan/logical.join_output_names)."""
    if name in lout:
        return True, name
    if name.endswith("#r") and name[:-2] in rout:
        return False, name[:-2]
    if name in rout:
        return False, name
    raise DeviceUnsupported(f"join output column {name!r} not found on either side")


def _join_column_dtype(name: str, source, lbuckets, rbuckets, participating, fallback=None) -> np.dtype:
    """Column dtype promoted across the participating buckets (a nullable int
    column decodes as float64 only in buckets whose files hold nulls).
    ``fallback`` maps output name -> dtype for a column with no decoded data
    in scope: the streamed join types a bucket's absent side from the index
    footers (the whole-side path always has other buckets)."""
    is_left, col = source
    src = lbuckets if is_left else rbuckets
    dtypes = [src[b][col].dtype for b in participating if col in src.get(b, {})]
    if not dtypes:
        if fallback is not None and name in fallback:
            return fallback[name]
        raise DeviceUnsupported(f"cannot determine dtype of empty join column {col!r}")
    if any(dt == object for dt in dtypes):
        return np.dtype(object)
    return np.result_type(*dtypes)


# --------------------------------------------------------------------------
# host pair expansion (every join type)
# --------------------------------------------------------------------------


def _expand_inner(lo_b: np.ndarray, counts: np.ndarray, chunk_total: int) -> Tuple[np.ndarray, np.ndarray]:
    """(left row, right row) index arrays of the pairs of one bucket: the
    native pair expansion (int32), or numpy's (int64) past int32 range or
    without the library."""
    try:
        return native.expand_pairs(lo_b, np.asarray(lo_b, dtype=np.int64) + counts, chunk_total)
    except native.NativeUnsupported:
        pass
    lidx = np.repeat(np.arange(counts.shape[0]), counts)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ridx = np.arange(chunk_total) - np.repeat(offsets, counts) + np.repeat(lo_b, counts)
    return lidx, ridx


def _null_value(dt: np.dtype):
    if dt.kind == "M":
        return np.datetime64("NaT")
    if dt.kind == "m":
        return np.timedelta64("NaT")
    return np.nan  # float holes; pandas merge also fills object with NaN


def _expand_join_pairs(plan: L.Join, lbuckets, rbuckets, nb: int, lout: List[str], rout: List[str],
                       span_of, dtype_fallback=None) -> B.Batch:
    """Pair expansion and column gather on the host, for the host span path
    and for what the device materialization does not cover. ``span_of(b)``
    returns (lo, hi) arrays of length len(left bucket b) — the matching
    right-row span per left row.

    Two passes: spans and counts first, then gathers straight into
    preallocated output columns, expanding one bucket's index arrays at a
    time. Outer joins emit unmatched rows with the opposite side's columns
    null (index -1; ints promote to float64 NaN, bools to object, as a
    pandas merge does)."""
    keep_left = plan.how in ("left", "outer")
    keep_right = plan.how in ("right", "outer")
    out_cols = plan.output_columns

    def matched_maker(lo_b, counts, keep_left_):
        def make():
            if keep_left_:
                # an unmatched left row expands as one (i, lo[i]) pair, then
                # gets its right index nulled
                counts_eff = np.maximum(counts, 1)
                lidx, ridx = _expand_inner(np.asarray(lo_b), counts_eff, int(counts_eff.sum()))
                null_rows = np.repeat(counts == 0, counts_eff)
                if null_rows.any():
                    ridx = np.asarray(ridx, dtype=np.int64)
                    ridx[null_rows] = -1
                return lidx, ridx
            return _expand_inner(np.asarray(lo_b), counts, int(counts.sum()))

        return make

    pieces = []  # (bucket, row count, maker() -> (lidx, ridx))
    total = 0
    has_null_left = has_null_right = False
    for b in range(nb):
        lb = lbuckets.get(b)
        rb = rbuckets.get(b)
        ll = B.num_rows(lb) if lb is not None else 0
        rr = B.num_rows(rb) if rb is not None else 0
        if ll and rr:
            lo_b, hi_b = span_of(b)
            counts = (hi_b - lo_b).astype(np.int64)
            if keep_left:
                ct = int(np.maximum(counts, 1).sum())
                if (counts == 0).any():
                    has_null_right = True
                pieces.append((b, ct, matched_maker(lo_b, counts, True)))
                total += ct
            else:
                ct = int(counts.sum())
                if ct:
                    pieces.append((b, ct, matched_maker(lo_b, counts, False)))
                    total += ct
            if keep_right:
                # right rows covered by no span are unmatched
                cover = np.zeros(rr + 1, dtype=np.int64)
                sel = counts > 0
                np.add.at(cover, np.asarray(lo_b)[sel], 1)
                np.add.at(cover, np.asarray(hi_b)[sel], -1)
                unmatched = np.nonzero(np.cumsum(cover[:-1]) == 0)[0]
                if unmatched.size:
                    pieces.append((b, unmatched.size, lambda u=unmatched: (np.full(u.size, -1, dtype=np.int64), u)))
                    total += unmatched.size
                    has_null_left = True
        elif ll and keep_left:
            pieces.append((b, ll, lambda n_=ll: (np.arange(n_), np.full(n_, -1, dtype=np.int64))))
            total += ll
            has_null_right = True
        elif rr and keep_right:
            pieces.append((b, rr, lambda n_=rr: (np.full(n_, -1, dtype=np.int64), np.arange(n_))))
            total += rr
            has_null_left = True

    sources = {name: _join_column_source(name, lout, rout) for name in out_cols}
    participating = sorted({p[0] for p in pieces})
    # USING-style joins coalesce the key: a right/outer join's unmatched rows
    # show the RIGHT side's key under the left name instead of NULL
    coalesce_from = {}
    if keep_right and plan.using_pairs:
        for lk, rk in plan.using_pairs:
            if lk in out_cols and rk in rout:
                coalesce_from[lk] = rk

    def out_dtype(name: str) -> np.dtype:
        is_left = sources[name][0]
        part = participating or sorted(lbuckets if is_left else rbuckets)
        dt = _join_column_dtype(name, sources[name], lbuckets, rbuckets, part, fallback=dtype_fallback)
        nullable = (is_left and has_null_left) or (not is_left and has_null_right)
        if nullable and dt.kind == "b":
            return np.dtype(object)  # pandas merge: bool + NaN -> object
        if nullable and dt.kind in ("i", "u"):
            return np.dtype(np.float64)  # pandas-merge null promotion
        return dt

    out = {name: np.empty(total, dtype=out_dtype(name)) for name in out_cols}
    if total == 0:
        return out

    off = 0
    for b, ct, make in pieces:
        lidx, ridx = make()
        for name in out_cols:
            is_left, col = sources[name]
            src = lbuckets if is_left else rbuckets
            idx = lidx if is_left else ridx
            arr = src.get(b, {}).get(col)
            if arr is None or arr.shape[0] == 0:
                # side absent for this bucket: every index here is -1
                out[name][off: off + ct] = _null_value(out[name].dtype)
                nulls = np.ones(ct, dtype=bool)
            else:
                nulls = np.asarray(idx) < 0
                if nulls.any():
                    vals = out[name][off: off + ct]
                    vals[:] = arr[np.clip(idx, 0, arr.shape[0] - 1)].astype(out[name].dtype, copy=False)
                    vals[nulls] = _null_value(out[name].dtype)
                else:
                    out[name][off: off + ct] = arr[idx]
            alt = coalesce_from.get(name) if is_left else None
            if alt is not None and nulls.any():
                # left-null rows came from right-unmatched emissions: their
                # ridx is valid, so the USING key takes the right side's value
                ralt = rbuckets.get(b, {}).get(alt)
                fill = np.asarray(ridx)[nulls]
                ok = fill >= 0
                if ralt is not None and ralt.shape[0] and ok.any():
                    vals = out[name][off: off + ct]
                    sel = np.nonzero(nulls)[0][ok]
                    vals[sel] = ralt[fill[ok]].astype(out[name].dtype, copy=False)
        off += ct
    return out


def _make_host_span_of(session, setup, compat):
    """``span_of(b) -> (lo, hi)`` over the pre-sorted per-bucket runs, using
    the shared per-bucket key encodings (whose time goes to ``join_keys``)."""
    t = time.perf_counter()
    lkeys_by_bucket, rkeys_by_bucket = _encoded_join_keys(setup, compat)
    _add(session.query_stage_seconds, "join_keys", t)

    def span_of(b: int):
        lk, rk = lkeys_by_bucket[b], rkeys_by_bucket[b]
        try:
            # one O(n+m) merge walk in C over the pre-sorted runs
            spans = native.merge_spans(lk, rk)
            trace.record("spans", "native")
            return spans
        except native.NativeUnsupported:
            trace.record("spans", "searchsorted")
            return np.searchsorted(rk, lk, side="left"), np.searchsorted(rk, lk, side="right")

    return span_of


def host_bucketed_join(session, plan: L.Join, compat=None, setup=None) -> B.Batch:
    """The bucketed join with spans computed on the host (the native merge
    walk, or ``np.searchsorted``, over each bucket's sorted keys): below the device-dispatch row threshold
    and above the span byte budget. Called alone (no ``compat`` or
    ``setup``), it analyses and decodes the sides itself."""
    if setup is None:
        compat = compat if compat is not None else join_sides_compatible(plan)
        setup = _bucketed_join_setup(session, plan, compat)
    lbuckets, rbuckets, lkeys, rkeys, nb, lcols_needed, rcols_needed = setup
    span_of = _make_host_span_of(session, setup, compat)
    t = time.perf_counter()
    out = _expand_join_pairs(plan, lbuckets, rbuckets, nb, lcols_needed, rcols_needed, span_of)
    _add(session.query_stage_seconds, "join_host_expand", t)
    return out


def _add(stages, key: str, t0: float) -> float:
    """Add the time since ``t0`` to ``stages[key]``; returns now."""
    now = time.perf_counter()
    stages[key] += now - t0
    return now


# --------------------------------------------------------------------------
# the device programs
# --------------------------------------------------------------------------


def bucketed_span(lmat: torch.Tensor, rmat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per bucket (row), the ``[lo, hi)`` span of each left key in the
    bucket's sorted right keys: one batched ``searchsorted`` each way over
    (nb, Wl) and (nb, Wr) int64 rectangles padded with SENTINEL (the JAX
    package's ``bucketed-smj-span``, a vmapped ``jnp.searchsorted``)."""
    return torch.searchsorted(rmat, lmat), torch.searchsorted(rmat, lmat, right=True)


def bucket_pair_totals(lo, hi, llens, rlens) -> torch.Tensor:
    """Matched pairs per bucket: spans clamped to the right side's real rows
    (a left-only bucket's SENTINEL keys would otherwise match the right
    rectangle's SENTINEL padding), summed over the left side's real rows."""
    real = torch.arange(lo.shape[1], device=lo.device)[None, :] < llens[:, None]
    rl = rlens[:, None]
    return torch.where(real, torch.minimum(hi, rl) - torch.minimum(lo, rl), 0).sum(dim=1)


def expand_gather(lo, hi, llens, rlens, lmats, rmats, total: int):
    """The inner join's pairs, expanded and gathered on the device: output
    slot ``t`` maps to its (bucket, left row, right row) through ONE global
    ``searchsorted`` of ``t`` in the flattened inclusive cumsum of the pair
    counts, then every payload rectangle is gathered at those rows. Returns
    (left columns, right columns, b, i, j), each of ``total`` rows.

    Every gather index is clamped into its tensor first, as the JAX program
    clips: an out-of-range index on CUDA is a device assert, not a value."""
    nb, wl = lo.shape
    rl = rlens[:, None]
    lo = torch.minimum(lo, rl)
    hi = torch.minimum(hi, rl)
    real = torch.arange(wl, device=lo.device)[None, :] < llens[:, None]
    flat_counts = torch.where(real, hi - lo, 0).reshape(-1)
    g_incl = torch.cumsum(flat_counts, 0)
    g_excl = g_incl - flat_counts
    t = torch.arange(total, device=lo.device, dtype=g_incl.dtype)
    f = torch.searchsorted(g_incl, t, right=True).clamp_(0, flat_counts.shape[0] - 1)
    b = torch.div(f, wl, rounding_mode="floor")
    i = f - b * wl
    j = (lo.reshape(-1)[f] + (t - g_excl[f])).clamp_(min=0)
    louts = [m.reshape(-1)[f] for m in lmats]
    routs = [m[b, j.clamp(max=m.shape[1] - 1)] for m in rmats]
    return louts, routs, b, i, j


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def device_bucketed_join(session, plan: L.Join, compat=None, setup=None) -> B.Batch:
    """A compatible bucketed equi-join with its spans on the device.

    Per-bucket sorted key runs of both sides are padded into (nb, width)
    rectangles, and the span program gives every left row the ``[lo, hi)``
    of its matching right rows — no exchange (the reference's no-shuffle
    SMJ, HS/index/covering/JoinIndexRule.scala:604-618). An inner join then
    expands and gathers on the device; other joins expand on the host.
    Called alone (no ``compat`` or ``setup``), it analyses and decodes the
    sides itself."""
    if setup is None:
        compat = compat if compat is not None else join_sides_compatible(plan)
        setup = _bucketed_join_setup(session, plan, compat)
    lbuckets, rbuckets, lkeys, rkeys, nb, lcols_needed, rcols_needed = setup
    device = session.device
    stages = session.query_stage_seconds
    t = time.perf_counter()
    # index bucket files are immutable (versioned v__=N dirs), so the key
    # rectangles stay resident on the device across queries; only the first
    # execution of a (sides, keys) pair pays the encoding and the upload
    pair_key = _rank_cache_key(compat[0], compat[1], lkeys, rkeys)
    dev_key = ("join-keymats", pair_key, str(device)) if pair_key is not None else None
    cached = _device_cache.get(dev_key) if dev_key is not None else None
    if cached is not None:
        lmat_dev, rmat_dev, llens, rlens = cached
        t = _add(stages, "join_keys", t)
    else:
        lkeys_by_bucket, rkeys_by_bucket = _encoded_join_keys(setup, compat, pair_key)

        def stack_side(buckets: Dict[int, B.Batch], keymap: Dict[int, np.ndarray]):
            lens = [B.num_rows(buckets[b]) if b in buckets else 0 for b in range(nb)]
            keys_mat = np.full((nb, max(max(lens), 1)), SENTINEL, dtype=np.int64)
            for b in range(nb):
                enc = keymap.get(b)
                if enc is not None and enc.shape[0]:
                    keys_mat[b, : enc.shape[0]] = enc
            return keys_mat, np.asarray(lens, dtype=np.int64)

        lmat, llens_np = stack_side(lbuckets, lkeys_by_bucket)
        rmat, rlens_np = stack_side(rbuckets, rkeys_by_bucket)
        t = _add(stages, "join_keys", t)
        lmat_dev, rmat_dev = _upload(lmat, device), _upload(rmat, device)
        llens, rlens = _upload(llens_np, device), _upload(rlens_np, device)
        if dev_key is not None:
            _device_cache.put(dev_key, (lmat_dev, rmat_dev, llens, rlens), lmat.nbytes + rmat.nbytes)
        t = _add(stages, "join_upload", t)

    t0 = program_clock(device)
    with _program_lint.maybe_verify(session.conf, "bucketed-smj-span", "bucketed-smj-span/join-span",
                                    (lmat_dev, rmat_dev)):
        lo, hi = bucketed_span(lmat_dev, rmat_dev)
    count_dispatch("bucketed-smj-span")
    _observe_program("bucketed-smj-span", t0)
    t = _add(stages, "join_span", t)

    if plan.how == "inner" and session.conf.join_device_materialize:
        try:
            return _device_materialize_inner(
                session, plan, lbuckets, rbuckets, lcols_needed, rcols_needed, lo, hi, llens, rlens,
                ident=(pair_key, str(device)) if pair_key is not None else None,
            )
        except DeviceUnsupported:
            pass  # e.g. no overlapping buckets or the output above its budget -> host gather
        t = time.perf_counter()

    lo_np, hi_np = lo.cpu().numpy(), hi.cpu().numpy()
    llens_np = llens.cpu().numpy()

    def span_of(b: int):
        ll = int(llens_np[b])
        return lo_np[b, :ll], hi_np[b, :ll]

    out = _expand_join_pairs(plan, lbuckets, rbuckets, nb, lcols_needed, rcols_needed, span_of)
    _add(stages, "join_host_expand", t)
    return out


def _device_materialize_inner(session, plan: L.Join, lbuckets, rbuckets, lcols_needed, rcols_needed,
                              lo, hi, llens, rlens, ident=None) -> B.Batch:
    """Device-side materialization of a compatible bucketed INNER join: pair
    expansion and numeric column gathers run on the device; only string
    columns gather on the host, by the downloaded row indexes."""
    from hyperspace_tpu_torch.ops.sort import padded_size

    device = session.device
    stages = session.query_stage_seconds
    t = time.perf_counter()
    out_cols = plan.output_columns
    participating = sorted(set(lbuckets) & set(rbuckets))
    if not participating:
        # no overlapping buckets: the host path builds the typed empty columns
        raise DeviceUnsupported("no overlapping buckets")
    sources = {name: _join_column_source(name, lcols_needed, rcols_needed) for name in out_cols}
    dtypes = {name: _join_column_dtype(name, sources[name], lbuckets, rbuckets, participating) for name in out_cols}
    device_cols = [n for n in out_cols if dtypes[n].kind in ("i", "u", "f", "b", "M", "m")]
    host_cols = [n for n in out_cols if n not in device_cols]

    # the pair totals size the output: one small copy back (nb ints), which
    # also waits for the span program
    bucket_totals = bucket_pair_totals(lo, hi, llens, rlens).cpu().numpy()
    total = int(bucket_totals.sum())
    if total == 0:
        _add(stages, "join_materialize", t)
        return {name: np.empty(0, dtype=dtypes[name]) for name in out_cols}
    # cost-based placement: a device-materialized join copies its WHOLE
    # output back, so above the byte budget the host expansion runs. The
    # estimate is the JAX package's, at the padded size it downloads (the
    # port sizes its buffers at the exact total), plus the b/i/j index
    # arrays a string gather downloads, so both take the same decision
    n_pad = padded_size(total)
    est_bytes = n_pad * max(1, len(device_cols)) * 8
    if host_cols:
        est_bytes += 3 * n_pad * 8
    if est_bytes > session.conf.join_device_materialize_max_bytes:
        _add(stages, "join_materialize", t)
        raise DeviceUnsupported(
            f"materialized output ~{est_bytes >> 20} MiB exceeds joinDeviceMaterializeMaxBytes -> host expansion"
        )
    t = _add(stages, "join_materialize", t)

    def rectangles(side_buckets, cols, width: int):
        """(nb, width) rectangle per column: int64 views of dates, int64
        for bools, the promoted dtype otherwise."""
        mats = []
        for name in cols:
            col = sources[name][1]
            dt = dtypes[name]
            view_int = dt.kind in ("M", "m")
            base = np.dtype(np.int64) if view_int or dt.kind == "b" else dt
            mat = np.zeros((lo.shape[0], max(width, 1)), dtype=base)
            for b in participating:
                arr = side_buckets[b].get(col)
                if arr is None:
                    raise DeviceUnsupported(f"column {col!r} absent in bucket {b}")
                v = arr.view("int64") if view_int else arr
                mat[b, : v.shape[0]] = v.astype(base, copy=False)
            mats.append(mat)
        return mats

    l_device = [n for n in device_cols if sources[n][0]]
    r_device = [n for n in device_cols if not sources[n][0]]
    # the payload rectangles are pure functions of the sides' immutable
    # decoded buckets, so they stay resident like the key rectangles
    mats_key = ("join-paymats", ident, tuple(l_device), tuple(r_device)) if ident is not None else None
    cached = _device_cache.get(mats_key) if mats_key is not None else None
    if cached is not None:
        lmats_dev, rmats_dev = cached
    else:
        wr = max(B.num_rows(rbuckets[b]) for b in participating)
        lmats = rectangles(lbuckets, l_device, lo.shape[1])
        rmats = rectangles(rbuckets, r_device, wr)
        lmats_dev = tuple(_upload(m, device) for m in lmats)
        rmats_dev = tuple(_upload(m, device) for m in rmats)
        if mats_key is not None:
            _device_cache.put(mats_key, (lmats_dev, rmats_dev), sum(m.nbytes for m in (*lmats, *rmats)))
        t = _add(stages, "join_upload", t)

    louts, routs, b_idx, i_idx, j_idx = expand_gather(lo, hi, llens, rlens, lmats_dev, rmats_dev, total)
    count_dispatch("join-expand-gather")
    out: B.Batch = {}
    for name, arr in (*zip(l_device, louts), *zip(r_device, routs)):
        v = arr.cpu().numpy()
        dt = dtypes[name]
        out[name] = v.view(dt) if dt.kind in ("M", "m") else v.astype(dt, copy=False)
    if host_cols:
        # string columns: download the (bucket-ordered) row indexes once and
        # gather on the host, bucket by bucket
        i_np = i_idx.cpu().numpy()
        j_np = j_idx.cpu().numpy()
        offsets = np.concatenate([[0], np.cumsum(bucket_totals)])
        for name in host_cols:
            is_left, col = sources[name]
            src = lbuckets if is_left else rbuckets
            idx = i_np if is_left else j_np
            res = np.empty(total, dtype=object)
            for b in participating:
                s, e = int(offsets[b]), int(offsets[b + 1])
                if e > s:
                    res[s:e] = src[b][col][idx[s:e]]
            out[name] = res
    _add(stages, "join_materialize", t)
    return {name: out[name] for name in out_cols}


# --------------------------------------------------------------------------
# aggregates over the bucketed join (no pair expansion)
# --------------------------------------------------------------------------

#: an int sum whose magnitude bound reaches this may overflow int64
INT_GUARD = 2**62


def _agg_side_of(lcols, rcols, col_name: str):
    """Which join side an aggregate input column comes from (and its source
    name there); '#r'-suffixed duplicates resolve to the right side."""
    if col_name.endswith("#r") and col_name[:-2] in rcols:
        return "right", col_name[:-2]
    if col_name in lcols:
        return "left", col_name
    if col_name in rcols:
        return "right", col_name
    raise DeviceUnsupported(f"aggregate input {col_name!r} not on either join side")


def _agg_column_stats(arr: np.ndarray):
    """(values as int64/float64, non-null mask or None, is_int) for a fused
    aggregate input; rejects dtypes the exact paths can't represent."""
    if arr.dtype.kind == "u" and arr.dtype.itemsize == 8:
        # uint64 >= 2^63 would wrap negative under int64 — materialize
        raise DeviceUnsupported("uint64 aggregate input -> materialize")
    if arr.dtype.kind in ("i", "u", "b"):
        return arr.astype(np.int64, copy=False), None, True
    if arr.dtype.kind == "f":
        return arr, ~np.isnan(arr), False
    raise DeviceUnsupported(f"non-numeric aggregate input dtype {arr.dtype}")


def _int_magnitude(vals: np.ndarray) -> int:
    """Largest |value| as a Python int (np.abs(int64.min) wraps negative)."""
    return max(abs(int(vals.max())), abs(int(vals.min())))


def _check_agg_input_dtypes(lside, rside, need_l, need_r) -> None:
    """Footer-only eligibility check for fused-aggregate inputs: numeric or
    boolean parquet types only (and not uint64), before any decode."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    for side, cols in ((lside, need_l), (rside, need_r)):
        scans = L.collect(side, lambda x: isinstance(x, L.IndexScan))
        scan = scans[0] if scans else None
        if scan is None or not scan.files:
            continue
        try:
            schema = pq.read_schema(scan.files[0])
        except OSError:
            continue
        stored = dict(zip(scan.columns, scan.file_columns or scan.columns))
        for c in cols:
            if c not in scan.columns or stored[c] not in schema.names:
                continue
            t = schema.field(stored[c]).type
            if pa.types.is_uint64(t) or not (
                pa.types.is_integer(t) or pa.types.is_floating(t) or pa.types.is_boolean(t)
            ):
                raise DeviceUnsupported(f"aggregate input {c!r} type {t} -> materialize")


def _computed_map(computes, lcols, rcols):
    """name -> (side, expr) for Compute nodes between Aggregate and Join:
    an expression whose references live wholly on one side evaluates per
    bucket on that side's decoded batch (anything cross-side
    materializes)."""
    out = {}
    for name, expr in computes or ():
        refs = set(expr.references())
        if not refs:
            out[name] = ("left", expr)  # constant: broadcasts on either side
        elif refs <= lcols:
            out[name] = ("left", expr)
        elif refs <= rcols:
            out[name] = ("right", expr)
        else:
            raise DeviceUnsupported(f"computed aggregate input {name!r} references both sides -> materialize")
    return out


def _side_values(batch: B.Batch, src: str, expr) -> np.ndarray:
    """A side's column, or a computed column evaluated over the side's
    decoded bucket (a constant broadcasts to every row)."""
    if expr is None:
        return batch[src]
    arr = np.asarray(expr.eval(batch))
    return np.broadcast_to(arr, (B.num_rows(batch),)) if arr.ndim == 0 else arr


def aggregate_over_bucketed_join(session, agg: L.Aggregate, join: L.Join, computes=()) -> B.Batch:
    """Global aggregates over a compatible bucketed inner join WITHOUT
    materializing the pair expansion: per bucket, the [lo, hi) match spans
    give each left row's multiplicity, so sums become weighted sums and
    right-side sums prefix-sum differences — O(n+m) per bucket instead of
    O(pairs). Integer sums stay exact (per-bucket int64 dot products with
    overflow guards, accumulated in Python ints). GROUP BY fuses too
    (``_grouped_aggregate_over_join``). Host numpy over the spans, as in the
    JAX package. Raises DeviceUnsupported for shapes it can't fuse (outer
    joins, min/max of right-side columns, non-numeric inputs, overflow-risk
    int sums, an input computed from both sides); the executor then
    materializes the join. ``computes`` are the ``(name, expr)`` pairs of
    the Compute nodes between the aggregate and the join."""
    stages = session.query_stage_seconds
    t = time.perf_counter()
    if join.how != "inner":
        raise DeviceUnsupported("fused join-aggregate covers inner joins")
    compat = join_sides_compatible(join)
    if compat is None:
        raise DeviceUnsupported("join sides are not compatible bucketed scans")
    lside, rside, lkeys, rkeys = compat
    if agg.keys:
        return _grouped_aggregate_over_join(session, agg, join, compat, computes=computes)

    lcols = set(lside.output_columns)
    rcols = set(rside.output_columns)
    computed = _computed_map(computes, lcols, rcols)
    plans = []  # (name, fn, side, src, expr|None)
    need_l, need_r = set(), set()
    for name, fn, col_name in agg.aggs:
        if fn not in _AGG_FNS:
            raise DeviceUnsupported(f"unsupported aggregate fn {fn!r} -> materialize")
        if fn == "count" and col_name is None:
            plans.append((name, "count*", None, None, None))
            continue
        if col_name in computed:
            side, expr = computed[col_name]
            src, refs = col_name, set(expr.references())
        else:
            side, src = _agg_side_of(lcols, rcols, col_name)
            expr, refs = None, {src}
        if fn in ("min", "max") and side == "right":
            raise DeviceUnsupported("min/max of a right-side column -> materialize")
        plans.append((name, fn, side, src, expr))
        (need_l if side == "left" else need_r).update(refs)

    # footer-level dtype check BEFORE any decode (the overflow guards still
    # bail late: they need values)
    _check_agg_input_dtypes(lside, rside, need_l, need_r)
    _add(stages, "join_plan", t)

    setup = _bucketed_join_setup(session, join, compat, needed_override=(sorted(need_l), sorted(need_r)))
    lbuckets, rbuckets, _lk, _rk, nb, _lc, _rc = setup
    span_of = _make_host_span_of(session, setup, compat)
    t = time.perf_counter()

    def declared_is_int(side: str, src: str, expr) -> bool:
        # dtype from ANY decoded bucket, so the output dtype is right even
        # when no bucket has matches
        for batch in (lbuckets if side == "left" else rbuckets).values():
            if expr is not None:
                return _agg_column_stats(np.asarray(expr.eval(batch)))[2]
            if src in batch:
                return _agg_column_stats(batch[src])[2]
        raise DeviceUnsupported(f"aggregate input {src!r} has no decoded bucket")

    total_pairs = 0
    acc = {name: {"sum": 0, "cnt": 0, "min": None, "max": None} for name, *_ in plans}
    is_int_out = {
        name: (declared_is_int(side, src, expr) if side is not None else True)
        for name, fn, side, src, expr in plans
    }
    for b in range(nb):
        lb, rb = lbuckets.get(b), rbuckets.get(b)
        if lb is None or rb is None:
            continue
        if B.num_rows(lb) == 0 or B.num_rows(rb) == 0:
            continue
        lo, hi = span_of(b)
        lo_i = np.asarray(lo, dtype=np.int64)
        hi_i = np.asarray(hi, dtype=np.int64)
        counts = hi_i - lo_i
        bucket_pairs = int(counts.sum())
        total_pairs += bucket_pairs
        if bucket_pairs == 0:
            continue

        # per-(side, column) encodings + prefix sums, shared by every
        # aggregate reading that column in this bucket
        col_cache: Dict[Tuple[str, str], tuple] = {}

        def col_info(side: str, src: str, expr):
            got = col_cache.get((side, src))
            if got is not None:
                return got
            vals, ok, is_int = _agg_column_stats(_side_values(lb if side == "left" else rb, src, expr))
            pref = prefn = None
            if side == "right":
                if is_int:
                    if vals.size and _int_magnitude(vals) * vals.size >= INT_GUARD:
                        raise DeviceUnsupported("int sum overflow risk -> materialize")
                    pref = np.concatenate([[0], np.cumsum(vals)])
                else:
                    pref = np.concatenate([[0.0], np.cumsum(np.where(ok, vals, 0.0))])
                nn = np.ones(vals.shape[0], dtype=np.int64) if ok is None else ok.astype(np.int64)
                prefn = np.concatenate([[0], np.cumsum(nn)])
            got = (vals, ok, is_int, pref, prefn)
            col_cache[(side, src)] = got
            return got

        for name, fn, side, src, expr in plans:
            a = acc[name]
            if fn == "count*":
                continue
            vals, ok, is_int, pref, prefn = col_info(side, src, expr)
            if side == "left":
                w = counts if ok is None else counts * ok
                if fn in ("sum", "avg"):
                    if is_int:
                        if vals.size and _int_magnitude(vals) * bucket_pairs >= INT_GUARD:
                            raise DeviceUnsupported("int sum overflow risk -> materialize")
                        a["sum"] += int(np.dot(vals, counts))
                    else:
                        a["sum"] += float(np.dot(np.where(ok, vals, 0.0), counts))
                    a["cnt"] += int(w.sum())
                elif fn == "count":
                    a["cnt"] += int(w.sum())
                else:  # min/max over rows that matched at least once
                    sel = (counts > 0) if ok is None else (ok & (counts > 0))
                    if sel.any():
                        mn, mx = vals[sel].min(), vals[sel].max()
                        a["min"] = mn if a["min"] is None else min(a["min"], mn)
                        a["max"] = mx if a["max"] is None else max(a["max"], mx)
            else:
                if fn in ("sum", "avg"):
                    span_sum = (pref[hi_i] - pref[lo_i]).sum()
                    a["sum"] += int(span_sum) if is_int else float(span_sum)
                    a["cnt"] += int((prefn[hi_i] - prefn[lo_i]).sum())
                elif fn == "count":
                    a["cnt"] += int((prefn[hi_i] - prefn[lo_i]).sum())

    out: B.Batch = {}
    for name, fn, side, src, expr in plans:
        a = acc[name]
        if fn == "count*":
            out[name] = np.asarray([total_pairs])
        elif fn == "count":
            out[name] = np.asarray([a["cnt"]])
        elif fn == "sum" and a["cnt"] == 0:
            # SQL: SUM over zero (non-null) rows is NULL, not 0
            out[name] = np.asarray([np.nan])
        elif fn == "sum":
            # int inputs stay int (exact)
            if is_int_out[name] and abs(a["sum"]) >= 2**63:
                # the exact total exceeds int64 across buckets: the
                # materialized path defines the (wrapping/float) behaviour
                raise DeviceUnsupported("int sum exceeds int64 -> materialize")
            out[name] = np.asarray([a["sum"]], dtype=np.int64 if is_int_out[name] else np.float64)
        elif fn == "avg":
            out[name] = np.asarray([a["sum"] / a["cnt"] if a["cnt"] else np.nan])
        elif fn == "min":
            v = a["min"]
            out[name] = np.asarray([np.nan if v is None else v])
        else:
            v = a["max"]
            out[name] = np.asarray([np.nan if v is None else v])
    _add(stages, "agg_join", t)
    return out


def _grouped_aggregate_over_join(session, agg: L.Aggregate, join: L.Join, compat, computes=()) -> B.Batch:
    """Grouped aggregates over a compatible bucketed inner join WITHOUT
    materializing the pair expansion.

    Groups are discovered as SUB-SEGMENTS of each bucket's sorted left run:
    boundaries fall wherever any join key, any left-side group key, or any
    (per-left-row gathered) right-side group key changes. Per-segment pair
    totals are reduceat sums of span counts; sums reduce count-weighted
    left values or span prefix-sum differences (right). Equal group tuples
    can recur non-contiguously, so per-segment partials FINAL-MERGE through
    one output-sized pandas groupby.

    Right-side group keys additionally require the right side to be UNIQUE
    per join key in every bucket (spans of width <= 1, checked per bucket):
    that makes the gathered per-left-row value well defined — the TPC-H q3
    class (GROUP BY l_orderkey, o_orderdate over lineitem JOIN orders).

    Raises DeviceUnsupported for shapes it can't fuse (min/max, inputs
    computed from both sides, non-unique right side under right-side group
    keys); the executor then materializes."""
    stages = session.query_stage_seconds
    t = time.perf_counter()
    lside, rside, lkeys, rkeys = compat
    lcols = set(lside.output_columns)
    rcols = set(rside.output_columns)
    computed = _computed_map(computes, lcols, rcols)

    def resolve(col):
        if col in computed:
            side, expr = computed[col]
            return side, col, expr, set(expr.references())
        side, src = _agg_side_of(lcols, rcols, col)
        return side, src, None, {src}

    for _, fn, _c in agg.aggs:
        if fn not in _AGG_FNS:
            raise DeviceUnsupported(f"unsupported aggregate fn {fn!r} -> materialize")

    # group-key plan: join keys canonicalize to the LEFT key column
    # (matched rows carry equal values); anything else is an "extra"
    key_plan = []  # (out_name, kind, src, expr) kind in jk/lx/rx
    need_l, need_r = set(lkeys), set(rkeys)
    has_right_extra = False
    for k in agg.keys:
        side, src, expr, refs = resolve(k)
        if expr is None and side == "left" and src in lkeys:
            key_plan.append((k, "jk", src, None))
        elif expr is None and side == "right" and src in rkeys:
            key_plan.append((k, "jk", lkeys[rkeys.index(src)], None))
        elif side == "left":
            key_plan.append((k, "lx", src, expr))
            need_l |= refs
        else:
            key_plan.append((k, "rx", src, expr))
            need_r |= refs
            has_right_extra = True

    plans = []  # (name, fn, side, src, expr)
    for name, fn, col_name in agg.aggs:
        if fn == "count" and col_name is None:
            plans.append((name, "count*", None, None, None))
            continue
        side, src, expr, refs = resolve(col_name)
        if fn in ("min", "max"):
            raise DeviceUnsupported("grouped min/max -> materialize")
        plans.append((name, fn, side, src, expr))
        (need_l if side == "left" else need_r).update(refs)

    # the footer pre-check covers computed inputs through their references,
    # so a string-referencing expression bails before decoding both sides
    check_l = {s for _, fn, sd, s, e in plans if sd == "left" and e is None}
    check_r = {s for _, fn, sd, s, e in plans if sd == "right" and e is None}
    for _, fn, sd, _s, e in plans:
        if e is not None:
            (check_l if sd == "left" else check_r).update(e.references())
    _check_agg_input_dtypes(lside, rside, check_l, check_r)
    _add(stages, "join_plan", t)
    setup = _bucketed_join_setup(session, join, compat, needed_override=(sorted(need_l), sorted(need_r)))
    lbuckets, rbuckets, _lk, _rk, nb, _lc, _rc = setup
    span_of = _make_host_span_of(session, setup, compat)
    t = time.perf_counter()

    key_parts: Dict[str, List[np.ndarray]] = {k: [] for k, *_ in key_plan}
    # per-aggregate partial columns: sum+cnt for sum/avg, cnt for counts
    sum_parts: Dict[str, List[np.ndarray]] = {name: [] for name, *_ in plans}
    cnt_parts: Dict[str, List[np.ndarray]] = {name: [] for name, *_ in plans}
    int_sum = {name: True for name, *_ in plans}

    for b in range(nb):
        lb, rb = lbuckets.get(b), rbuckets.get(b)
        if lb is None or rb is None:
            continue
        ll, rr = B.num_rows(lb), B.num_rows(rb)
        if ll == 0 or rr == 0:
            continue
        lo, hi = span_of(b)
        lo_i = np.asarray(lo, dtype=np.int64)
        hi_i = np.asarray(hi, dtype=np.int64)
        counts = hi_i - lo_i
        if has_right_extra and counts.size and int(counts.max()) > 1:
            raise DeviceUnsupported("right-side group key over a non-unique join side -> materialize")

        def right_gathered(src, expr):
            # valid where counts == 1; count-0 rows carry a neighbour's
            # value, which either forms an empty segment (dropped) or
            # harmlessly extends an equal-valued one
            return _side_values(rb, src, expr)[np.clip(lo_i, 0, rr - 1)]

        # sub-segment boundaries: a change in ANY join key or group extra
        key_arrays = {}  # out_name -> per-left-row values for output
        change = np.zeros(ll, dtype=bool)
        change[0] = True
        for kc in lkeys:
            kv = sort_key_int64(lb[kc])
            change[1:] |= kv[1:] != kv[:-1]
        for k, kind, src, expr in key_plan:
            if kind == "jk":
                key_arrays[k] = lb[src]
                continue
            arr = _side_values(lb, src, expr) if kind == "lx" else right_gathered(src, expr)
            key_arrays[k] = arr
            kv = sort_key_int64(arr)
            change[1:] |= kv[1:] != kv[:-1]
        starts = np.flatnonzero(change)
        run_pairs = np.add.reduceat(counts, starts)
        keep = run_pairs > 0  # inner join: unmatched segments drop out
        if not keep.any():
            continue

        for k, kind, src, expr in key_plan:
            key_parts[k].append(key_arrays[k][starts][keep])

        col_cache: Dict[Tuple[str, str], tuple] = {}

        def col_info(side, src, expr):
            got = col_cache.get((side, src))
            if got is not None:
                return got
            vals, ok, is_int = _agg_column_stats(_side_values(lb if side == "left" else rb, src, expr))
            if is_int and vals.size and _int_magnitude(vals) * max(int(counts.sum()), 1) >= INT_GUARD:
                raise DeviceUnsupported("int sum overflow risk -> materialize")
            pref = prefn = None
            if side == "right":
                if ok is None:
                    pref = np.concatenate([[0], np.cumsum(vals)])
                    nn = np.ones(vals.shape[0], dtype=np.int64)
                else:
                    pref = np.concatenate([[0.0], np.cumsum(np.where(ok, vals, 0.0))])
                    nn = ok.astype(np.int64)
                prefn = np.concatenate([[0], np.cumsum(nn)])
            got = (vals, ok, is_int, pref, prefn)
            col_cache[(side, src)] = got
            return got

        for name, fn, side, src, expr in plans:
            if fn == "count*":
                cnt_parts[name].append(run_pairs[keep])
                continue
            vals, ok, is_int, pref, prefn = col_info(side, src, expr)
            if not is_int:
                int_sum[name] = False
            if side == "left":
                w = counts if ok is None else counts * ok
                cnt_parts[name].append(np.add.reduceat(w, starts)[keep])
                if fn in ("sum", "avg"):
                    contrib = vals * counts if ok is None else np.where(ok, vals, 0) * counts
                    sum_parts[name].append(np.add.reduceat(contrib, starts)[keep])
            else:
                row_cnts = prefn[hi_i] - prefn[lo_i]
                cnt_parts[name].append(np.add.reduceat(row_cnts, starts)[keep])
                if fn in ("sum", "avg"):
                    row_sums = pref[hi_i] - pref[lo_i]
                    sum_parts[name].append(np.add.reduceat(row_sums, starts)[keep])

    def declared_dtype(side, src, expr) -> np.dtype:
        # a computed column's dtype comes from evaluating it over any
        # decoded bucket (empty-result outputs type like the materialized
        # path's)
        for batch in (lbuckets if side == "left" else rbuckets).values():
            if expr is not None:
                return np.asarray(expr.eval(batch)).dtype
            if src in batch:
                return batch[src].dtype
        if expr is not None:
            return np.dtype(np.float64)
        raise DeviceUnsupported(f"aggregate input {src!r} has no decoded bucket")

    out: B.Batch = {}
    if not any(key_parts[k] for k, *_ in key_plan):
        for k, kind, src, expr in key_plan:
            out[k] = np.empty(0, dtype=declared_dtype("left" if kind != "rx" else "right", src, expr))
        for name, fn, side, src, expr in plans:
            if fn in ("count", "count*"):
                dt = np.dtype(np.int64)
            elif fn == "sum":
                is_int = _agg_column_stats(np.empty(0, dtype=declared_dtype(side, src, expr)))[2]
                dt = np.dtype(np.int64) if is_int else np.dtype(np.float64)
            else:
                dt = np.dtype(np.float64)
            out[name] = np.empty(0, dtype=dt)
        _add(stages, "agg_join", t)
        return out

    # FINAL MERGE: equal group tuples recur across segments (and, when the
    # group keys don't pin the join key, across buckets) — one
    # segment-count-sized pandas groupby folds the partials. Keys enter as
    # null-safe int64 ORDER CODES; a representative row index maps each
    # group back to its exact original values and dtypes.
    import pandas as pd

    key_arrays_out = {k: np.concatenate(key_parts[k]) for k, *_ in key_plan}
    frame = {f"__k{i}": sort_key_int64(key_arrays_out[k]) for i, (k, *_rest) in enumerate(key_plan)}
    gcols = list(frame)
    n_seg = len(next(iter(key_arrays_out.values())))
    frame["__pos"] = np.arange(n_seg, dtype=np.int64)
    for name, fn, side, src, expr in plans:
        frame[f"__c_{name}"] = np.concatenate(cnt_parts[name])
        if sum_parts[name]:
            s_part = np.concatenate(sum_parts[name])
            if int_sum[name] and s_part.dtype.kind != "f":
                # pandas sums int64 with wrapping arithmetic; cross-bucket
                # merges could exceed int64 even when every per-bucket
                # partial passed its own guard
                if float(np.abs(s_part.astype(np.float64)).sum()) >= float(INT_GUARD):
                    raise DeviceUnsupported("int sum overflow risk at merge -> materialize")
            frame[f"__s_{name}"] = s_part
    df = pd.DataFrame(frame)
    gb = df.groupby(gcols, dropna=False, sort=False)
    agg_spec = {c: "sum" for c in df.columns if c not in gcols and c != "__pos"}
    agg_spec["__pos"] = "first"
    res = gb.agg(agg_spec).reset_index()

    rep = res["__pos"].to_numpy()
    for k, *_rest in key_plan:
        out[k] = key_arrays_out[k][rep]
    for name, fn, side, src, expr in plans:
        c = res[f"__c_{name}"].to_numpy()
        if fn in ("count", "count*"):
            out[name] = c.astype(np.int64)
            continue
        s = res[f"__s_{name}"].to_numpy()
        if fn == "avg":
            out[name] = np.divide(s.astype(np.float64), c, out=np.full(s.shape, np.nan), where=c > 0)
            continue
        # sum: SQL NULL (NaN) for all-null groups; int sums stay int when
        # no group needs a NULL hole
        if (c > 0).all():
            out[name] = s.astype(np.int64) if int_sum[name] and s.dtype.kind != "f" else s
        else:
            sf = s.astype(np.float64)
            sf[c == 0] = np.nan
            out[name] = sf
    _add(stages, "agg_join", t)
    return out
