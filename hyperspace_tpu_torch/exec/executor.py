"""Physical executor of the filter query, the equi-join and aggregation.

Executes a (possibly index-rewritten) logical plan over pyarrow + numpy on
the host, with the filter over an index scan evaluated on the session's
device (exec/device.py), a join over two compatible bucketed index scans
run as the shuffle-free sort-merge join (exec/join.py), and an aggregate
over a (filtered) index scan run as one device program
(exec/aggregate.py). The host path is the correctness baseline and the
non-indexed fallback.

Out of core: above ``hyperspace.exec.stream.joinMinBytes`` the bucketed
join streams bucket by bucket (exec/join.py), above
``exec.stream.aggMinBytes`` an aggregate over a scan chain runs in file
chunks and merges partial states (``_streaming_aggregate``), and above
``exec.join.spillMinRows`` the generic merge runs in hash partitions
(``_partitioned_merge``). ``execute_stream`` yields a result chunk by chunk
(``DataFrame.to_local_iterator``). Chunks decode ahead of their consumer on
the scan pipeline (exec/pipeline.py).

The port's executor runs ``Scan``, ``FileScan``, ``IndexScan``,
``Filter``, ``Project``, ``Join``, ``Aggregate`` and hybrid scan's
``Union``, ``BucketUnion`` and ``Repartition``; every other node raises
until its slice lands. A Filter over a source scan reads only the files
its partition-column conjuncts keep, and pushes its predicate into the
parquet read, which prunes row groups by their footer statistics.
The reference delegates all of this to Spark's physical planner/executors;
here the framework owns it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from hyperspace_tpu_torch.exec import batch as B
from hyperspace_tpu_torch.exec import trace
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.plan.expr import (
    INPUT_FILE_NAME,
    BinaryOp,
    Expr,
    InputFileName,
    as_bool_mask,
    extract_equi_join_keys,
    get_column,
)


def _scan_identity(scan):
    """Stable identity of a scan's file set for device-side caching: any
    rewrite of a file (new index version, compaction) changes mtime/size and
    naturally invalidates. Returns None (= don't cache) when any file can't
    be stat'ed — a path-only key could serve stale device columns after an
    in-place rewrite."""
    import os

    parts = []
    for f in scan.files:
        try:
            st = os.stat(f)
        except OSError:
            return None
        parts.append((f, st.st_mtime_ns, st.st_size))
    return tuple(parts)


def _plan_needs_file_names(plan: L.LogicalPlan) -> bool:
    def expr_has(e: Expr) -> bool:
        if isinstance(e, InputFileName):
            return True
        return any(expr_has(c) for c in e.children())

    if isinstance(plan, L.Filter) and expr_has(plan.condition):
        return True
    return any(_plan_needs_file_names(c) for c in plan.children())


def _read_files(
    files: List[str],
    file_format: str,
    columns: Optional[List[str]],
    with_file_names: bool,
    partition_values: Optional[dict] = None,
    partition_dtypes: Optional[dict] = None,
    format_options: Optional[dict] = None,
    predicate=None,
) -> B.Batch:
    """Read ``files`` into one batch. ``partition_values`` ({file -> {col ->
    typed value}}) attaches hive-partition columns — constant per file,
    absent from the file bytes — to each file's rows. ``predicate`` (the
    scan's pushed-down filter, re-applied by the Filter above) enables
    parquet row-group min/max pruning in the reader."""
    from hyperspace_tpu_torch.exec.io import _decode_pool, read_parquet_batch
    from hyperspace_tpu_torch.sources import formats as F

    if not files:
        # every file pruned (a data-skipping index removed all of them): an
        # empty batch with the requested columns; dtype-less object arrays
        # compare fine against any literal on zero rows
        cols = list(columns or [])
        if with_file_names:
            cols.append(INPUT_FILE_NAME)
        return {c: np.empty(0, dtype=object) for c in cols}

    part_cols = set()
    if partition_values:
        for v in partition_values.values():
            part_cols.update(v)

    file_columns = columns
    attach: Optional[List[str]] = None
    if part_cols:
        if columns is None:
            attach = sorted(part_cols)
        else:
            attach = [c for c in columns if c in part_cols]
            file_columns = [c for c in columns if c not in part_cols]

    def read_one(f: str) -> B.Batch:
        if file_columns is not None and not file_columns:
            # every requested column is a partition column: the file is never
            # decoded, but its row count still shapes the output
            b: B.Batch = {}
            n = F.count_rows(f, file_format, format_options)
        elif file_format == "parquet":
            b = read_parquet_batch([f], file_columns, predicate=predicate)
            n = B.num_rows(b)
        else:
            b = B.table_to_batch(F.read_table(f, file_format, file_columns, format_options))
            n = B.num_rows(b)
        if attach:
            from hyperspace_tpu_torch.sources import partitions as P

            values = partition_values.get(f, {})
            for c in attach:
                dt = (partition_dtypes or {}).get(c, np.dtype(object))
                b[c] = P.column_array(values.get(c), dt, n)
        if with_file_names:
            b[INPUT_FILE_NAME] = np.full(B.num_rows(b), f, dtype=object)
        return b

    if with_file_names or attach:
        if len(files) > 1:
            return B.concat(list(_decode_pool().map(read_one, files)))
        return B.concat([read_one(f) for f in files])
    if file_format == "parquet":
        return read_parquet_batch(list(files), columns, predicate=predicate)
    return B.table_to_batch(F.open_dataset(list(files), file_format, format_options).to_table(columns=columns))


def _prune_partitions(scan: L.Scan, condition) -> Optional[List[str]]:
    """Files of ``scan`` surviving the partition-column conjuncts of
    ``condition`` (None = no partitioning / nothing prunable)."""
    from hyperspace_tpu_torch.plan.expr import split_conjunctive
    from hyperspace_tpu_torch.sources import partitions as P

    rel = scan.relation
    part_cols = set(getattr(rel, "partition_columns", []) or [])
    if not part_cols:
        return None
    terms = [t for t in split_conjunctive(condition) if set(t.references()) and set(t.references()) <= part_cols]
    if not terms:
        return None
    files = [fi.name for fi in rel.all_file_infos()]
    # vectorized: one "row" per file holding its partition values
    dtypes = getattr(rel, "partition_dtypes", {}) or {}
    pvs = [rel.partition_values_for(f) for f in files]
    file_batch = {}
    for c in sorted(part_cols):
        dt = dtypes.get(c, np.dtype(object))
        vals = [pv.get(c) for pv in pvs]
        if dt == np.dtype(object):
            arr = np.empty(len(vals), dtype=object)
            arr[:] = vals
        else:
            arr = np.array([P.typed_value(None, dt) if v is None else v for v in vals], dtype=dt)
        file_batch[c] = arr
    mask = np.ones(len(files), dtype=bool)
    for t in terms:
        mask &= as_bool_mask(t.eval(file_batch))
    return [f for f, keep in zip(files, mask) if keep]


def _gather_spec(idx: np.ndarray):
    """Precompute the per-side gather inputs ONCE per join (the NaN mask and
    int cast are O(rows)): (direct_idx, None, None) for an all-matched int
    index, (None, valid, ii) for a float index with NaN unmatched marks."""
    idx = np.asarray(idx)
    if idx.dtype.kind != "f":
        return (idx.astype(np.int64, copy=False), None, None)
    valid = ~np.isnan(idx)
    return (None, valid, idx[valid].astype(np.int64))


def _gather_with_missing(arr: np.ndarray, spec) -> np.ndarray:
    """Gather ``arr`` rows by a ``_gather_spec``; unmatched rows (pandas'
    outer merge marks them NaN) null-extend with the same dtype promotion
    pandas itself applies — ints to float64 NaN, bools to object, datetimes
    keep their unit with NaT."""
    direct, valid, ii = spec
    if direct is not None:
        return arr[direct]
    kind = arr.dtype.kind
    if kind in ("i", "u"):
        res = np.full(valid.shape, np.nan, dtype=np.float64)
        res[valid] = arr[ii].astype(np.float64)
    elif kind == "f":
        res = np.full(valid.shape, np.nan, dtype=arr.dtype)
        res[valid] = arr[ii]
    elif kind == "M":
        res = np.full(valid.shape, np.datetime64("NaT"), dtype=arr.dtype)
        res[valid] = arr[ii]
    elif kind == "m":
        res = np.full(valid.shape, np.timedelta64("NaT"), dtype=arr.dtype)
        res[valid] = arr[ii]
    else:  # strings/objects/bools null-extend as object NaN, like pandas
        res = np.full(valid.shape, np.nan, dtype=object)
        res[valid] = arr[ii]
    return res


def _chain_to_scan(plan: L.LogicalPlan):
    """(wrappers, leaf) when ``plan`` is a chain of row-wise nodes
    (Project/Filter) over a single Scan/FileScan/IndexScan leaf — the shape
    the streaming executor can partition by files; (None, None) otherwise."""
    chain = []
    node = plan
    while isinstance(node, (L.Project, L.Filter)):
        chain.append(node)
        node = node.child
    if isinstance(node, (L.Scan, L.FileScan, L.IndexScan)):
        return chain, node
    return None, None


def _chain_needed_columns(chain, aggs=None, keys=None):
    """Source columns a scan chain references, for pruning the per-chunk
    scan."""
    needed = set()
    for node in chain:
        if isinstance(node, L.Project):
            needed |= set(node.columns)
        elif isinstance(node, L.Filter):
            needed |= set(node.condition.references())
    if aggs:
        needed |= {c for _, _, c in aggs if c is not None}
    if keys:
        needed |= set(keys)
    return needed


def _chain_pushdown_condition(chain):
    """AND of the chain's Filter conditions that sit over only Projects,
    still in source-column terms: the predicate the grouped device stream
    fuses into its program, and the one a chunk's leaf carries for
    row-group pruning."""
    cond = None
    for node in reversed(chain):  # leaf-most wrapper first
        if isinstance(node, L.Project):
            continue
        if isinstance(node, L.Filter):
            cond = node.condition if cond is None else BinaryOp("AND", cond, node.condition)
            continue
        break
    return cond


def _pruned_scan_key(key, pruned_by):
    """Brand a device-cache scan key with the predicate attached to the
    scan for row-group pruning, as the JAX package does: two predicates can
    prune the same files to equal row counts but different rows."""
    if key is None or pruned_by is None:
        return key
    return key + (("rg-pred", str(pruned_by)),)


def _rebuild_chain(chain, leaf: L.LogicalPlan) -> L.LogicalPlan:
    """Clone the row-wise wrappers over a replacement leaf (bottom-up)."""
    node = leaf
    for wrapper in reversed(chain):
        node = wrapper.with_children([node])
    return node


def _leaf_files(leaf: L.LogicalPlan) -> List[str]:
    if isinstance(leaf, L.Scan):
        return [fi.name for fi in leaf.relation.all_file_infos()]
    return list(leaf.files)


def _leaf_subset(leaf: L.LogicalPlan, files: List[str], needed=None) -> L.LogicalPlan:
    """A scan leaf over only ``files``; a relation-backed Scan becomes a
    FileScan carrying the relation's partition metadata, pruned to the
    ``needed`` columns (a chunked decode pays per chunk for every column it
    decodes)."""
    import copy

    if isinstance(leaf, (L.FileScan, L.IndexScan)):
        clone = copy.copy(leaf)
        clone.files = list(files)
        return clone
    rel = leaf.relation
    cols = list(leaf.output_columns)
    if needed is not None:
        lowered = {n.lower() for n in needed}
        cols = [c for c in cols if c.lower() in lowered] or cols
    pv = pd_ = None
    if rel.partition_columns:
        pv = {f: rel.partition_values_for(f) for f in files}
        pd_ = dict(rel.partition_dtypes) or None
    return L.FileScan(
        files,
        rel.physical_format,
        cols,
        partition_values=pv,
        partition_dtypes=pd_,
        format_options=getattr(rel, "options", None) or None,
    )


def _chunk_files_by_bytes(files: List[str], target_bytes: int) -> List[List[str]]:
    """Greedy size-bounded file groups (a single file above the target forms
    its own group)."""
    import os

    groups: List[List[str]] = []
    cur: List[str] = []
    cur_bytes = 0
    for f in files:
        try:
            sz = os.stat(f).st_size
        except OSError:
            sz = target_bytes  # unknown -> isolate conservatively
        if cur and cur_bytes + sz > target_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(f)
        cur_bytes += sz
    if cur:
        groups.append(cur)
    return groups


#: aggregate functions with a decomposable partial state (Spark's
#: partial/final split); distinct forms accumulate uniques
_STREAMABLE_AGGS = {
    "count", "sum", "min", "max", "avg", "stddev_samp",
    "count_distinct", "sum_distinct", "avg_distinct",
}


def host_aggregate(batch: B.Batch, keys: List[str], aggs) -> B.Batch:
    """The host pandas aggregate over an in-memory batch — the semantic
    reference every device aggregate path must reproduce (NULL sums via
    min_count=1, dropna=False grouping, appearance-ordered groups via
    sort=False)."""
    import pandas as pd

    batch = {k: v for k, v in batch.items() if k != INPUT_FILE_NAME}
    n = B.num_rows(batch)

    def series(col_name: str) -> np.ndarray:
        got = batch.get(col_name)
        if got is None:
            got = get_column(batch, col_name)
        if got is None:
            raise KeyError(f"Aggregate input column {col_name!r} not found")
        return got

    _PD_FN = {"avg": "mean", "sum": "sum", "min": "min", "max": "max"}

    def _global_agg(fn: str, col_name: Optional[str]):
        if fn == "count":
            return n if col_name is None else int(pd.Series(series(col_name)).count())
        s = pd.Series(series(col_name))
        if fn == "count_distinct":
            return int(s.nunique(dropna=True))
        if fn in ("sum_distinct", "avg_distinct"):
            d = s.dropna().drop_duplicates()
            return d.sum(min_count=1) if fn == "sum_distinct" else d.mean()
        if fn == "stddev_samp":
            return s.std(ddof=1)
        if fn == "sum":
            # SQL: SUM over zero rows (or all NULLs) is NULL, not 0 —
            # pandas' min_count=0 default returns 0
            return s.sum(min_count=1)
        return getattr(s, _PD_FN[fn])()

    if not keys:
        out: B.Batch = {}
        for name, fn, col_name in aggs:
            out[name] = np.asarray([_global_agg(fn, col_name)])
        return out

    # object/string group keys factorize to int codes BEFORE entering the
    # frame (pandas' string column construction is slow, and the groupby
    # only needs key IDENTITY — real values map back at the end);
    # use_na_sentinel=False gives NaN its own code, matching dropna=False
    key_uniques = {}
    frame_cols = {}
    agg_inputs = {c for _, _, c in aggs if c is not None}
    for k in keys:
        arr = series(k)
        # a key that also feeds an aggregate (min(x) ... GROUP BY x)
        # must keep its real values — codes order by appearance
        if arr.dtype.kind in ("O", "U", "S") and k not in agg_inputs:
            codes, uniques = pd.factorize(arr, use_na_sentinel=False)
            frame_cols[k] = codes
            key_uniques[k] = uniques
        else:
            frame_cols[k] = arr
    for name, fn, col_name in aggs:
        if col_name is not None and col_name not in frame_cols:
            frame_cols[col_name] = series(col_name)
    df = pd.DataFrame(frame_cols)
    grouped = df.groupby(keys, dropna=False, sort=False)
    out = {}
    pieces = {}
    for name, fn, col_name in aggs:
        if fn == "count" and col_name is None:
            pieces[name] = grouped.size()
        elif fn == "count":
            pieces[name] = grouped[col_name].count()
        elif fn == "count_distinct":
            pieces[name] = grouped[col_name].nunique(dropna=True)
        elif fn == "sum_distinct":
            pieces[name] = grouped[col_name].agg(lambda s: s.dropna().drop_duplicates().sum(min_count=1))
        elif fn == "avg_distinct":
            pieces[name] = grouped[col_name].agg(lambda s: s.dropna().drop_duplicates().mean())
        elif fn == "stddev_samp":
            pieces[name] = grouped[col_name].std(ddof=1)
        elif fn == "sum":
            # an all-NULL group must sum to NULL (SQL), not pandas' 0
            pieces[name] = grouped[col_name].sum(min_count=1)
        else:
            pieces[name] = getattr(grouped[col_name], _PD_FN[fn])()
    result = pd.DataFrame(pieces).reset_index()
    for k in keys:
        vals = result[k].to_numpy()
        uniq = key_uniques.get(k)
        out[k] = uniq[vals] if uniq is not None else vals
    for name, _, _ in aggs:
        out[name] = result[name].to_numpy()
    return out


class Executor:
    def __init__(self, session):
        self.session = session
        # ids of the plan's shared sub-plans and their batches, keyed by
        # (id, with_file_names); set per execute()
        self._shared: set = set()
        self._memo: Dict[Tuple[int, bool], B.Batch] = {}
        # (chunk leaf, its prefetched batch) while a pipelined stream runs
        # the chunk's chain over it (_stream_chunks)
        self._leaf_override: Optional[Tuple[L.LogicalPlan, B.Batch]] = None

    def _add_stage(self, stage: str, t0: float) -> float:
        """Add the time since ``t0`` to the session's
        ``query_stage_seconds[stage]`` (``prefetch_<stage>`` on a scan
        pipeline's thread, where it overlaps the consumer's layers); returns
        now."""
        from hyperspace_tpu_torch.exec.pipeline import on_producer_thread

        now = time.perf_counter()
        key = f"prefetch_{stage}" if on_producer_thread() else stage
        self.session.query_stage_seconds[key] += now - t0
        return now

    def execute(self, plan: L.LogicalPlan, required_columns: Optional[List[str]] = None) -> B.Batch:
        # execution-time column pruning for EVERY plan (Catalyst runs
        # ColumnPruning unconditionally; ApplyHyperspace only prunes plans
        # it rewrites, and hyperspace-off queries never saw it at all);
        # the fallback keeps the never-break-a-query contract
        try:
            from hyperspace_tpu_torch.rules.utils import prune_columns

            plan = prune_columns(plan)
        except Exception:  # pruning must never kill a query
            trace.record("prune", "fallback-unpruned")
        # sub-plans referenced more than once (both sides of a self-join over
        # one DataFrame) execute once per collect; only those roots memoize
        from hyperspace_tpu_torch.rules.utils import shared_subplan_ids

        self._shared = shared_subplan_ids(plan)
        try:
            batch = self._exec(plan, _plan_needs_file_names(plan))
        finally:
            self._memo = {}
            self._shared = set()
        if required_columns is not None:
            batch = B.select(batch, required_columns)
        elif INPUT_FILE_NAME in batch:
            batch = {k: v for k, v in batch.items() if k != INPUT_FILE_NAME}
        return batch

    def execute_stream(self, plan: L.LogicalPlan):
        """Yield result batches incrementally (DataFrame.to_local_iterator).

        Streamed shapes: a (Project over a Filter over a) compatible
        bucketed Join yields per-bucket chunks through the streamed join; a
        row-wise chain over one scan yields per-file-group chunks.
        Everything else yields the one materialized batch: streaming is an
        execution strategy, never an API restriction (Spark's
        toLocalIterator contract).

        The JAX package streams a join it would broadcast (one side under
        ``hyperspace.exec.join.broadcastMaxBytes``) through its broadcast
        probe, chunk by chunk; that tier is not in the port, which yields
        the one batch ``collect()`` gives, the same rows."""
        from hyperspace_tpu_torch.rules.utils import prune_columns, shared_subplan_ids

        try:
            plan = prune_columns(plan)
        except Exception:  # pruning must never kill a query
            trace.record("prune", "fallback-unpruned")
        self._shared = shared_subplan_ids(plan)
        self._memo = {}
        try:
            if _plan_needs_file_names(plan):
                batch = self._exec(plan, True)
                yield {k: v for k, v in batch.items() if k != INPUT_FILE_NAME}
                return
            node = plan
            proj = None
            if isinstance(node, L.Project):
                proj, node = list(node.columns), node.child
            # a Filter directly above a Join applies per streamed chunk
            post_filter = None
            if isinstance(node, L.Filter) and isinstance(node.child, L.Join):
                post_filter, node = node.condition, node.child
            if isinstance(node, L.Join) and self.session.conf.device_execution_enabled:
                from hyperspace_tpu_torch.exec import device as D
                from hyperspace_tpu_torch.exec import join as J

                if J.join_sides_compatible(node) is not None:
                    gen = J.stream_bucketed_join(self.session, node)
                    try:
                        try:
                            first = next(gen)
                        except StopIteration:
                            return
                        except D.DeviceUnsupported:
                            # only the first bucket's refusal falls back, as
                            # in the JAX package
                            gen = None
                        if gen is not None:

                            def shape(chunk):
                                if post_filter is not None:
                                    chunk = B.mask_rows(chunk, as_bool_mask(post_filter.eval(chunk)))
                                return B.select(chunk, proj) if proj else chunk

                            trace.record("join", "host-span-smj-stream")
                            yield shape(first)
                            for chunk in gen:
                                yield shape(chunk)
                            return
                    finally:
                        if gen is not None:
                            gen.close()  # an abandoned stream stops its bucket decodes
            chain, leaf = _chain_to_scan(plan)
            if leaf is not None:
                files = _leaf_files(leaf)
                groups = _chunk_files_by_bytes(files, max(1, self.session.conf.stream_chunk_bytes))
                if len(groups) > 1:
                    needed = _chain_needed_columns(chain) | set(plan.output_columns)
                    yield from self._stream_chunks(chain, leaf, groups, needed)
                    return
            batch = self._exec(plan, False)
            yield {k: v for k, v in batch.items() if k != INPUT_FILE_NAME}
        finally:
            self._memo = {}
            self._shared = set()

    def _stream_chunks(self, chain, leaf, groups, needed, leaf_only=False, stage_extra=None):
        """Yield one executed chain batch per file group, overlapping chunk
        k+1's decode and device staging with chunk k's execution through
        ScanPipeline. The serial path (pipeline off, or a chain that needs
        file names) executes the same leaf clones, so streamed results are
        identical either way.

        ``leaf_only=True`` yields ``(leaf clone, chain plan, leaf batch)``
        instead of executed batches: the grouped device stream consumes raw
        leaf chunks (the predicate fuses into its program) but must still be
        able to run the chain over the same prefetched batch when it falls
        back mid-stream. ``stage_extra`` names further columns (group keys,
        aggregate inputs) the staging hook copies alongside the predicate
        columns.

        With ``hyperspace.exec.io.rowGroupPruning`` on, each leaf clone
        carries the chain's pushed-down predicate: the parquet read prunes
        row groups with it, and it brands the chunk's device-cache key."""
        conf = self.session.conf
        pushed = _chain_pushdown_condition(chain) if conf.rowgroup_pruning_enabled else None
        leaves, subs = [], []
        for g in groups:
            lf = _leaf_subset(leaf, g, needed)
            if pushed is not None and isinstance(lf, (L.FileScan, L.IndexScan)):
                lf.pushdown_predicate = pushed
            leaves.append(lf)
            subs.append(_rebuild_chain(chain, lf))
        wfns = [_plan_needs_file_names(s) for s in subs]

        if not conf.pipeline_enabled or len(groups) < 2 or any(wfns):
            # a prefetched leaf batch cannot carry file-name columns; such
            # chains (InputFileName in a filter) stay serial
            for i, (sub, wfn) in enumerate(zip(subs, wfns)):
                if leaf_only:
                    yield leaves[i], sub, self._exec(leaves[i], False)
                else:
                    yield self._exec(sub, wfn)
            return

        from hyperspace_tpu_torch.exec import device as D
        from hyperspace_tpu_torch.exec.pipeline import ScanPipeline

        # staging applies when the chunk takes the device filter (a Filter
        # directly over the scan leaf) or the grouped device stream
        dev_cond = None
        if conf.device_execution_enabled and chain and isinstance(chain[-1], L.Filter):
            dev_cond = chain[-1].condition
        staging = dev_cond is not None or bool(stage_extra)
        device = D.resolved_device(self.session) if staging else None

        def stage(i, batch):
            if B.num_rows(batch) < conf.device_exec_min_rows:
                return
            key = _pruned_scan_key(_scan_identity(leaves[i]), pushed)
            D.stage_filter_columns(self.session, batch, dev_cond, key, extra_columns=stage_extra, device=device)

        def weigh(batch):
            return sum(int(getattr(a, "nbytes", 0)) for a in batch.values())

        pipe = ScanPipeline(
            [(lambda i=i: self._exec(leaves[i], False)) for i in range(len(leaves))],
            depth=max(1, conf.pipeline_depth),
            max_buffered_bytes=conf.pipeline_max_buffered_bytes,
            weigh=weigh,
            stage=stage if staging else None,
        )
        try:
            t = time.perf_counter()
            for i, leaf_batch in enumerate(pipe):
                self._add_stage("stream_wait", t)
                if leaf_only:
                    yield leaves[i], subs[i], leaf_batch
                else:
                    prev = self._leaf_override
                    self._leaf_override = (leaves[i], leaf_batch)
                    try:
                        out = self._exec(subs[i], False)
                    finally:
                        self._leaf_override = prev
                    yield out
                t = time.perf_counter()
        finally:
            pipe.close()

    def _exec(self, plan: L.LogicalPlan, with_file_names: bool) -> B.Batch:
        # hits hand out shallow copies so callers may add derived keys
        # without cross-talk (arrays themselves are never mutated)
        if id(plan) in self._shared:
            key = (id(plan), with_file_names)
            hit = self._memo.get(key)
            if hit is not None:
                return dict(hit)
            batch = self._exec_node(plan, with_file_names)
            self._memo[key] = batch
            return dict(batch)
        return self._exec_node(plan, with_file_names)

    def _exec_node(self, plan: L.LogicalPlan, with_file_names: bool) -> B.Batch:
        # a pipelined stream hands the current chunk's prefetched leaf batch
        # to the chain's execution (identity match: each chunk's leaf clone
        # is its own)
        ov = self._leaf_override
        if ov is not None and plan is ov[0]:
            return dict(ov[1])

        if isinstance(plan, L.Scan):
            return self._exec_scan(plan, with_file_names)

        if isinstance(plan, L.FileScan):
            t = time.perf_counter()
            batch = _read_files(
                list(plan.files),
                plan.file_format,
                list(plan.columns),
                with_file_names,
                partition_values=plan.partition_values,
                partition_dtypes=plan.partition_dtypes,
                format_options=plan.format_options,
                predicate=getattr(plan, "pushdown_predicate", None),
            )
            self._add_stage("decode", t)
            return batch

        if isinstance(plan, L.IndexScan):
            if plan.pruned_buckets is not None:
                trace.record("scan", f"index-bucket-pruned({len(plan.pruned_buckets)} buckets)")
            else:
                trace.record("scan", "index")
            fcols = plan.file_columns if plan.file_columns is not None else list(plan.columns)
            if not plan.files:
                # every bucket pruned away: empty columns; dtype-less object
                # arrays compare fine against any literal on zero rows
                cols = list(fcols) + ([INPUT_FILE_NAME] if with_file_names else [])
                batch = {c: np.empty(0, dtype=object) for c in cols}
            else:
                t = time.perf_counter()
                batch = _read_files(
                    list(plan.files),
                    "parquet",
                    list(fcols),
                    with_file_names,
                    predicate=getattr(plan, "pushdown_predicate", None),
                )
                self._add_stage("decode", t)
            if plan.file_columns is not None:
                # present index columns under the output names
                renamed: B.Batch = {out: batch[fc] for out, fc in zip(plan.columns, fcols)}
                if INPUT_FILE_NAME in batch:
                    renamed[INPUT_FILE_NAME] = batch[INPUT_FILE_NAME]
                return renamed
            return batch

        if isinstance(plan, L.Filter):
            rg_ok = self.session.conf.rowgroup_pruning_enabled
            pushed = None
            if isinstance(plan.child, L.Scan):
                # partition pruning: conjuncts over partition columns decide
                # per file, from path-derived values, which files to read
                files = _prune_partitions(plan.child, plan.condition)
                if rg_ok:
                    pushed = plan.condition
                child = self._exec_scan(plan.child, with_file_names, files=files, predicate=pushed)
            else:
                existing = getattr(plan.child, "pushdown_predicate", None)
                if existing is not None:
                    # a streamed leaf subset arrives with its pushdown already
                    # attached (_stream_chunks)
                    pushed = existing
                    child = self._exec(plan.child, with_file_names)
                elif (
                    rg_ok
                    and isinstance(plan.child, (L.FileScan, L.IndexScan))
                    and id(plan.child) not in self._shared
                ):
                    # push the predicate down for row-group pruning on a
                    # CLONE: the original node may be shared, and keeps
                    # full-read semantics
                    import copy

                    clone = copy.copy(plan.child)
                    clone.pushdown_predicate = plan.condition
                    pushed = plan.condition
                    child = self._exec(clone, with_file_names)
                else:
                    child = self._exec(plan.child, with_file_names)
            mask = self._filter_mask(plan, child, pruned_by=pushed)
            t = time.perf_counter()
            out = B.mask_rows(child, mask)
            self._add_stage("mask_rows", t)
            return out

        if isinstance(plan, L.Project):
            # projection pushdown into a directly-scanned source: decode ONLY
            # the projected columns; shared scans are pruned to one shared
            # Project, so the _exec memo above still deduplicates
            if (
                isinstance(plan.child, L.Scan)
                and id(plan.child) not in self._shared
                and set(plan.columns) <= set(plan.child.output_columns)
            ):
                got = self._exec_scan(plan.child, with_file_names, columns=list(plan.columns))
                if with_file_names and INPUT_FILE_NAME in got:
                    return got
                return B.select(got, list(plan.columns))
            child = self._exec(plan.child, with_file_names)
            cols = list(plan.columns)
            if with_file_names and INPUT_FILE_NAME in child:
                cols = cols + [INPUT_FILE_NAME]
            return B.select(child, cols)

        if isinstance(plan, L.Join):
            return self._exec_join(plan, with_file_names)

        if isinstance(plan, L.Aggregate):
            return self._exec_aggregate(plan, with_file_names)

        if isinstance(plan, (L.Union, L.BucketUnion)):
            return B.concat([self._exec(c, with_file_names) for c in plan.children()])

        if isinstance(plan, L.Repartition):
            # host path: an in-memory batch has no physical bucketing, so the
            # rows pass through (the bucketed join re-buckets them itself)
            return self._exec(plan.child, with_file_names)

        raise NotImplementedError(f"executing {type(plan).__name__} is not yet in the port")

    def _exec_join(self, plan: L.Join, with_file_names: bool) -> B.Batch:
        """The bucketed sort-merge join when both sides are compatible
        bucketed index scans (exec/join.py), else the generic equi-join: a
        pandas hash merge over slim key frames.

        The JAX package tries a broadcast hash join between the two; that
        tier is not in the port, and the generic merge gives the same rows
        (in the merge's order)."""
        import pandas as pd

        if not with_file_names and self.session.conf.device_execution_enabled:
            # deviceExecution=False is the kill switch back to the generic
            # merge: it routes around the whole bucketed-join stack
            from hyperspace_tpu_torch.exec import device as D
            from hyperspace_tpu_torch.exec import join as J

            try:
                return J.dispatch_bucketed_join(self.session, plan)
            except D.DeviceUnsupported:
                trace.fallback("join", "unsupported")
        trace.record("join", "generic-merge")

        pairs = extract_equi_join_keys(plan.condition)
        if pairs is None:
            raise NotImplementedError("Only conjunctive equi-joins are supported")
        left = self._exec(plan.left, with_file_names)
        right = self._exec(plan.right, with_file_names)
        t = time.perf_counter()
        left = {k: v for k, v in left.items() if k != INPUT_FILE_NAME}
        right = {k: v for k, v in right.items() if k != INPUT_FILE_NAME}

        def materialize_key(batch: B.Batch, name: str) -> bool:
            """Ensure ``name`` is a column of ``batch``, resolving its case
            like the analyzer (case-insensitive)."""
            if name in batch:
                return True
            got = get_column(batch, name)
            if got is not None:
                batch[name] = got
                return True
            return False

        # validate key sides (columns may arrive swapped from the user)
        lkeys, rkeys = [], []
        for a, b in pairs:
            if materialize_key(left, a) and materialize_key(right, b):
                lkeys.append(a)
                rkeys.append(b)
            elif materialize_key(left, b) and materialize_key(right, a):
                lkeys.append(b)
                rkeys.append(a)
            else:
                raise ValueError(f"Join keys ({a}, {b}) not found in the two sides")

        # rename duplicated right-side columns up front so every output column
        # resolves to one unambiguous source (the plan's join_output_names).
        # Only the KEY columns enter pandas: every payload column is gathered
        # from the original numpy arrays by matched row id afterwards.
        _, rename = L.join_output_names(list(left), list(right))
        right_named = {rename.get(k, k): v for k, v in right.items()}
        rkeys_renamed = [rename.get(k, k) for k in rkeys]
        ldf = pd.DataFrame({**{k: left[k] for k in lkeys}, "__lrow": np.arange(B.num_rows(left))})
        rdf = pd.DataFrame({**{k: right_named[k] for k in rkeys_renamed}, "__rrow": np.arange(B.num_rows(right))})
        spill = self.session.conf.join_spill_min_rows
        if spill and spill > 0 and max(len(ldf), len(rdf)) > spill:
            merged = self._partitioned_merge(ldf, rdf, lkeys, rkeys_renamed, plan.how, spill)
        else:
            merged = ldf.merge(rdf, left_on=lkeys, right_on=rkeys_renamed, how=plan.how)
        lspec = _gather_spec(merged["__lrow"].to_numpy())
        rspec = _gather_spec(merged["__rrow"].to_numpy())
        out: B.Batch = {}
        for name in plan.output_columns:
            if name in merged.columns:  # key columns, incl. renamed right keys
                out[name] = merged[name].to_numpy()
            elif name in left:
                out[name] = _gather_with_missing(left[name], lspec)
            elif name in right_named:
                out[name] = _gather_with_missing(right_named[name], rspec)
            else:
                raise KeyError(f"Join output column {name!r} missing")
        # USING-style joins coalesce the key across sides: a right/outer
        # join's unmatched rows show the RIGHT side's key, not NULL
        if plan.how in ("right", "outer") and plan.using_pairs:
            for lk, rk in plan.using_pairs:
                rkr = rename.get(rk, rk)
                if lk in out and rkr in merged.columns:
                    lv = out[lk]
                    mask = pd.isna(lv)
                    if mask.any():
                        out[lk] = np.where(mask, merged[rkr].to_numpy(), lv)
        self._add_stage("join_merge", t)
        return out

    @staticmethod
    def _partitioned_merge(ldf, rdf, lkeys, rkeys, how: str, spill_rows: int):
        """Grace-style partitioned hash merge: both slim key frames split by
        a shared key hash and each partition merges alone, bounding the
        merge's intermediate (hash table and indexers) to about 1/P of the
        unpartitioned one. Correct for every join type because hash
        partitions are disjoint by key: each row joins (or null-extends)
        entirely within its partition. Equal values hash equally across the
        two sides' dtypes (numeric keys take a common type before hashing),
        and NaN keys hash alike, so pandas' NaN-matches-NaN merge holds
        within each partition. The rows come partition by partition, so
        their order differs from the unpartitioned merge's (as in the JAX
        package; ROADMAP C)."""
        import pandas as pd

        from hyperspace_tpu_torch.ops.encode import hash_input_uint32
        from hyperspace_tpu_torch.ops.hashing import bucket_ids_np

        n_parts = max(2, -(-max(len(ldf), len(rdf)) // spill_rows))

        # partitioning is only sound when keys equal under pandas hash
        # equally on both sides: numeric pairs take a common dtype and -0.0
        # becomes +0.0 (pandas merges them equal; their bit patterns hash
        # apart); any other mismatch (object vs numeric, datetime units)
        # takes the single merge rather than drop matches
        def keyed(df, keys, other_df, other_keys):
            planes = []
            for k, ok in zip(keys, other_keys):
                a = df[k].to_numpy()
                b = other_df[ok].to_numpy()
                if a.dtype != b.dtype:
                    if a.dtype.kind in "iuf" and b.dtype.kind in "iuf":
                        a = a.astype(np.result_type(a.dtype, b.dtype), copy=False)
                    else:
                        return None
                if a.dtype.kind == "f":
                    a = a + 0.0  # -0.0 -> +0.0; NaN unchanged
                planes.append(hash_input_uint32(a))
            return bucket_ids_np(planes, n_parts)

        lids = keyed(ldf, lkeys, rdf, rkeys)
        rids = keyed(rdf, rkeys, ldf, lkeys)
        if lids is None or rids is None:
            return ldf.merge(rdf, left_on=lkeys, right_on=rkeys, how=how)
        trace.record("join", f"generic-merge-partitioned({n_parts})")
        parts = []
        for p in range(n_parts):
            lp = ldf[lids == p]
            rp = rdf[rids == p]
            if len(lp) == 0 and len(rp) == 0:
                continue
            if how == "inner" and (len(lp) == 0 or len(rp) == 0):
                continue
            if how == "left" and len(lp) == 0:
                continue
            if how == "right" and len(rp) == 0:
                continue
            parts.append(lp.merge(rp, left_on=lkeys, right_on=rkeys, how=how))
        if not parts:
            return ldf.iloc[:0].merge(rdf.iloc[:0], left_on=lkeys, right_on=rkeys, how=how)
        return pd.concat(parts, ignore_index=True, sort=False)

    def _exec_aggregate(self, plan: L.Aggregate, with_file_names: bool) -> B.Batch:
        """The JAX package's tiers, in its order: the fused aggregate over a
        compatible bucketed inner join (host spans, no pair expansion), the
        streamed aggregate over a large scan chain, the device aggregate
        over a (filtered) index scan, the host pandas aggregate."""
        conf = self.session.conf
        child = None
        if not with_file_names and conf.device_execution_enabled:
            join_node = plan.child
            while isinstance(join_node, L.Project):
                join_node = join_node.child
            if isinstance(join_node, L.Join):
                from hyperspace_tpu_torch.exec import device as D
                from hyperspace_tpu_torch.exec import join as J

                try:
                    got = J.aggregate_over_bucketed_join(self.session, plan, join_node)
                    trace.record("agg", "fused-bucketed-join")
                    return got
                except D.DeviceUnsupported:
                    trace.fallback("agg", "join-unsupported")
        # the streamed tier comes before the device-scan gate, which would
        # materialize the whole scan: the out-of-core path exists to avoid it
        if not with_file_names:
            self._check_fused_join_aggregate(plan)
            got = self._try_streaming_aggregate(plan)
            if got is not None:
                trace.record("agg", "streamed-partial")
                return got
        if not with_file_names and conf.device_execution_enabled:
            got, scan_batch, filter_node = self._try_device_aggregate(plan)
            if got is not None:
                trace.record("agg", "device-grouped-scan" if plan.keys else "device-fused-scan")
                return got
            if scan_batch is not None:
                # the device gate already materialized the scan: reuse it
                if filter_node is not None:
                    mask = self._filter_mask(filter_node, scan_batch)
                    t = time.perf_counter()
                    child = B.mask_rows(scan_batch, mask)
                    self._add_stage("mask_rows", t)
                else:
                    child = scan_batch

        if child is None:
            child = self._exec(plan.child, with_file_names)
        t = time.perf_counter()
        out = host_aggregate(child, list(plan.keys), list(plan.aggs))
        self._add_stage("agg_host", t)
        return out

    def _check_fused_join_aggregate(self, plan: L.Aggregate) -> None:
        """The JAX package compiles a grouped aggregate over (a Filter over)
        an inner join into one fused stage program per chunk when
        ``hyperspace.exec.fusion.enabled`` is set and ``broadcast_spec``
        finds a side to broadcast; otherwise it falls through to the
        streamed, device and host tiers. The fused program is not in the
        port, so only a query the JAX package would fuse raises."""
        conf = self.session.conf
        if not (conf.fusion_enabled and conf.device_execution_enabled and conf.agg_device_grouped_enabled):
            return
        if not plan.keys or any(fn not in _STREAMABLE_AGGS or fn.endswith("_distinct") for _, fn, _ in plan.aggs):
            return
        node = plan.child
        if isinstance(node, L.Filter) and isinstance(node.child, L.Join):
            node = node.child
        if not isinstance(node, L.Join):
            return
        from hyperspace_tpu_torch.exec.join_stream import broadcast_spec

        if broadcast_spec(self.session, node) is not None:
            raise NotImplementedError(
                "the fused join aggregate (hyperspace.exec.fusion.enabled) is not yet in the port"
            )

    def _try_streaming_aggregate(self, plan: L.Aggregate) -> Optional[B.Batch]:
        """Out-of-core aggregate: when the child is a scan chain over more
        source bytes than ``hyperspace.exec.stream.aggMinBytes``, execute it
        in file chunks and merge decomposable partial states (Spark's
        partial/final split). Returns None (the caller materializes) when
        the shape, size or aggregate set does not stream, and when the
        streamed path meets what the JAX package falls back from: a shape
        or dtype outside the device language (``DeviceUnsupported``), or a
        host-side shape or dtype error. An error of the device itself
        propagates."""
        conf = self.session.conf
        min_bytes = conf.stream_agg_min_bytes
        if not min_bytes or min_bytes <= 0:
            return None
        if any(fn not in _STREAMABLE_AGGS for _, fn, _ in plan.aggs):
            return None
        chain, leaf = _chain_to_scan(plan.child)
        if leaf is None:
            return None
        files = _leaf_files(leaf)
        if len(files) < 2:
            return None
        import os

        try:
            total_bytes = sum(os.stat(f).st_size for f in files)
        except OSError:
            return None
        if total_bytes < min_bytes:
            return None
        groups = _chunk_files_by_bytes(files, max(1, conf.stream_chunk_bytes))
        if len(groups) < 2:
            return None
        from hyperspace_tpu_torch.exec.device import DeviceUnsupported

        needed = _chain_needed_columns(chain, plan.aggs, plan.keys)
        try:
            return self._streaming_aggregate(plan, chain, leaf, groups, needed)
        except (DeviceUnsupported, KeyError, TypeError, ValueError):
            # the streamed path must never break a query the materialized
            # path can answer; visible in dispatch traces
            trace.record("agg", "stream-fallback")
            return None

    def _streaming_aggregate(self, plan, chain, leaf, groups, needed) -> B.Batch:
        import pandas as pd

        conf = self.session.conf
        grouped = bool(plan.keys)
        # distinct-form aggregates accumulate (group keys +) unique values;
        # everything else carries closed-form partial states
        plain = [(i, n, fn, c) for i, (n, fn, c) in enumerate(plan.aggs) if not fn.endswith("_distinct")]
        distinct = [(i, n, fn, c) for i, (n, fn, c) in enumerate(plan.aggs) if fn.endswith("_distinct")]

        partial_frames: List = []  # grouped plain partials
        distinct_frames = {i: [] for i, *_ in distinct}  # per-aggregate pair frames
        g_state: Dict[int, object] = {}  # global plain partials

        def fold_chunk(batch):
            t = time.perf_counter()
            batch = {k: v for k, v in batch.items() if k != INPUT_FILE_NAME}
            n = B.num_rows(batch)

            def series(col):
                got = batch.get(col)
                if got is None:
                    got = get_column(batch, col)
                if got is None:
                    raise KeyError(f"Aggregate input column {col!r} not found")
                return got

            if grouped:
                frame_cols = {k: series(k) for k in plan.keys}
                for _i, _n, _fn, c in plain:
                    if c is not None and c not in frame_cols:
                        frame_cols[c] = series(c)
                df = pd.DataFrame(frame_cols)
                gb = df.groupby(list(plan.keys), dropna=False, sort=False)
                pieces = {}
                for i, name, fn, c in plain:
                    p = f"__p{i}"
                    if fn == "count":
                        pieces[p] = gb.size() if c is None else gb[c].count()
                    elif fn == "sum":
                        pieces[p] = gb[c].sum(min_count=1)
                    elif fn == "min":
                        pieces[p] = gb[c].min()
                    elif fn == "max":
                        pieces[p] = gb[c].max()
                    elif fn == "avg":
                        pieces[p + "_s"] = gb[c].sum(min_count=1)
                        pieces[p + "_c"] = gb[c].count()
                    elif fn == "stddev_samp":
                        # the raw (n, sum, sum of squares) partials, as the
                        # JAX package merges them: they cancel when the mean
                        # is much larger than the spread (ROADMAP C)
                        pieces[p + "_n"] = gb[c].count()
                        pieces[p + "_s"] = gb[c].sum(min_count=1)
                        # float64 before squaring: int64 values near 2^32
                        # would wrap the sum of squares negative
                        pieces[p + "_ss"] = gb[c].apply(lambda s: float((s.dropna().astype(np.float64) ** 2).sum()))
                if pieces:
                    partial_frames.append(pd.DataFrame(pieces).reset_index())
                elif distinct:
                    # a keys-only partial, so groups with only distinct
                    # aggregates still materialize every group
                    partial_frames.append(pd.DataFrame({k: frame_cols[k] for k in plan.keys}).drop_duplicates())
                for i, name, fn, c in distinct:
                    pair = pd.DataFrame({**{k: series(k) for k in plan.keys}, "__v": series(c)}).drop_duplicates()
                    distinct_frames[i].append(pair)
            else:
                for i, name, fn, c in plain:
                    s = pd.Series(series(c)) if c is not None else None
                    st = g_state.get(i)
                    if fn == "count":
                        v = n if c is None else int(s.count())
                        g_state[i] = (st or 0) + v
                    elif fn in ("sum", "min", "max"):
                        part = getattr(s, fn)(**({"min_count": 1} if fn == "sum" else {}))
                        g_state.setdefault(i, []).append(part)
                    elif fn == "avg":
                        sc = g_state.setdefault(i, [0.0, 0])
                        cnt = int(s.count())
                        if cnt:
                            sc[0] += float(s.sum())
                            sc[1] += cnt
                    elif fn == "stddev_samp":
                        sc = g_state.setdefault(i, [0, 0.0, 0.0])
                        d = s.dropna().astype(np.float64)
                        sc[0] += int(d.shape[0])
                        sc[1] += float(d.sum())
                        sc[2] += float((d**2).sum())
                for i, name, fn, c in distinct:
                    u = pd.Series(series(c)).dropna().drop_duplicates()
                    distinct_frames[i].append(u.to_frame("__v"))
            self._add_stage("agg_host", t)

        # the grouped device stream: the chain's predicate fuses into the
        # grouped program over each raw leaf chunk, and the running partial
        # table stays on the device, merged chunk to chunk. A mid-stream
        # fallback (a cardinality spill, a dtype drift) turns the device
        # partial into ONE host partial frame and goes on with the pandas
        # fold above.
        stream = None
        fuse_cond = None
        stage_extra = None
        if (
            grouped
            and not distinct
            and conf.device_execution_enabled
            and conf.agg_device_grouped_enabled
            # the chunk leaves are always FileScan/IndexScan (_leaf_subset
            # turns a relation Scan into a FileScan), so any chain of
            # Filters and Projects fuses
            and all(isinstance(nd, (L.Filter, L.Project)) for nd in chain)
        ):
            from hyperspace_tpu_torch.exec import aggregate as A
            from hyperspace_tpu_torch.exec import device as D

            if conf.parallel_enabled:
                raise NotImplementedError("the sharded (hyperspace.parallel.enabled) aggregate is not yet in the port")
            fuse_cond = _chain_pushdown_condition(chain)
            stage_extra = sorted(set(plan.keys) | {c for _, _, _, c in plain if c is not None})
            stream = A.GroupedAggStream(
                self.session,
                list(plan.keys),
                list(plan.aggs),
                max_groups=conf.agg_max_groups,
                cap_floor=conf.agg_capacity_floor,
                # a capacity hint shared by repeated runs of the same query
                # shape over the same file set
                hint_key=("stream",) + tuple(_leaf_files(leaf)),
            )

        # chunks arrive through the prefetch pipeline: chunk k+1 decodes
        # (and stages) while this loop folds chunk k's partials
        if stream is None:
            for batch in self._stream_chunks(chain, leaf, groups, needed):
                fold_chunk(batch)
        else:
            device_ok = True
            for lf, sub, leaf_batch in self._stream_chunks(
                chain, leaf, groups, needed, leaf_only=True, stage_extra=stage_extra
            ):
                if device_ok:
                    nb = B.num_rows(leaf_batch)
                    if nb and nb < conf.device_exec_min_rows:
                        trace.fallback("agg", "min-rows")
                        device_ok = False
                    else:
                        key = _pruned_scan_key(_scan_identity(lf), getattr(lf, "pushdown_predicate", None))
                        try:
                            stream.update(leaf_batch, fuse_cond, scan_key=key)
                            continue
                        except A.GroupCapacityExceeded as e:
                            trace.fallback("agg", "spill")
                            device_ok = False
                            if stream.has_data:
                                partial_frames.append(stream.to_partial_frame(plain))
                            if e.folded:
                                continue  # the chunk is already in that partial
                        except D.DeviceUnsupported:
                            trace.fallback("agg", "unsupported")
                            device_ok = False
                            if stream.has_data:
                                partial_frames.append(stream.to_partial_frame(plain))
                # the host fold of this (and every later) chunk runs the
                # chain over the SAME prefetched leaf batch
                prev = self._leaf_override
                self._leaf_override = (lf, leaf_batch)
                try:
                    batch = self._exec(sub, False)
                finally:
                    self._leaf_override = prev
                fold_chunk(batch)
            if device_ok and stream.has_data:
                trace.record("agg", "device-grouped-stream")
                return stream.finalize()

        t = time.perf_counter()
        out = self._combine_partials(plan, plain, distinct, partial_frames, distinct_frames, g_state)
        self._add_stage("agg_finalize", t)
        return out

    @staticmethod
    def _combine_partials(plan, plain, distinct, partial_frames, distinct_frames, g_state) -> B.Batch:
        """The final aggregate from the streamed partial states, as the JAX
        package combines them."""
        import pandas as pd

        if plan.keys:
            merged = pd.concat(partial_frames, ignore_index=True)
            gb = merged.groupby(list(plan.keys), dropna=False, sort=False)
            final = {}
            for i, name, fn, c in plain:
                p = f"__p{i}"
                if fn == "count":
                    final[name] = gb[p].sum().astype(np.int64)
                elif fn == "sum":
                    final[name] = gb[p].sum(min_count=1)
                elif fn == "min":
                    final[name] = gb[p].min()
                elif fn == "max":
                    final[name] = gb[p].max()
                elif fn == "avg":
                    s_, c_ = gb[p + "_s"].sum(min_count=1), gb[p + "_c"].sum()
                    final[name] = s_ / c_.where(c_ > 0)
                elif fn == "stddev_samp":
                    n_ = gb[p + "_n"].sum()
                    s_ = gb[p + "_s"].sum(min_count=1)
                    ss_ = gb[p + "_ss"].sum()
                    var = (ss_ - (s_**2) / n_.where(n_ > 0)) / (n_ - 1).where(n_ > 1)
                    final[name] = np.sqrt(var.clip(lower=0))
            result = pd.DataFrame(final).reset_index() if final else (
                merged[list(plan.keys)].drop_duplicates().reset_index(drop=True)
            )
            for i, name, fn, c in distinct:
                pairs = pd.concat(distinct_frames[i], ignore_index=True).drop_duplicates()
                pairs = pairs[pairs["__v"].notna()]
                pgb = pairs.groupby(list(plan.keys), dropna=False, sort=False)["__v"]
                if fn == "count_distinct":
                    dser = pgb.nunique(dropna=True)
                elif fn == "sum_distinct":
                    dser = pgb.sum(min_count=1)
                else:  # avg_distinct
                    dser = pgb.mean()
                dser.name = name
                result = result.merge(dser.reset_index(), on=list(plan.keys), how="left")
                if fn == "count_distinct":
                    result[name] = result[name].fillna(0).astype(np.int64)
            out: B.Batch = {}
            for k in plan.keys:
                out[k] = result[k].to_numpy()
            for name, _, _ in plan.aggs:
                out[name] = result[name].to_numpy()
            return out

        out = {}
        for i, name, fn, c in plain:
            st = g_state.get(i)
            if fn == "count":
                out[name] = np.asarray([st or 0])
            elif fn in ("sum", "min", "max"):
                s = pd.Series(st or [])
                out[name] = np.asarray([getattr(s, fn)(**({"min_count": 1} if fn == "sum" else {}))])
            elif fn == "avg":
                s_, c_ = st or (0.0, 0)
                out[name] = np.asarray([s_ / c_ if c_ else np.nan])
            elif fn == "stddev_samp":
                n_, s_, ss_ = st or (0, 0.0, 0.0)
                if n_ > 1:
                    var = max(0.0, (ss_ - s_ * s_ / n_) / (n_ - 1))
                    out[name] = np.asarray([np.sqrt(var)])
                else:
                    out[name] = np.asarray([np.nan])
        for i, name, fn, c in distinct:
            u = pd.concat(distinct_frames[i], ignore_index=True)["__v"].drop_duplicates()
            u = u[u.notna()]
            if fn == "count_distinct":
                out[name] = np.asarray([int(u.shape[0])])
            elif fn == "sum_distinct":
                out[name] = np.asarray([u.sum(min_count=1) if len(u) else np.nan])
            else:
                out[name] = np.asarray([u.mean() if len(u) else np.nan])
        return {name: out[name] for name, _, _ in plan.aggs}

    def _try_device_aggregate(self, plan: L.Aggregate):
        """Returns (result, scan_batch, filter_node): result=None means the
        caller runs the host path — reusing scan_batch (the materialized
        scan, pre-filter) when it was already read for the gate. Only
        ``DeviceUnsupported`` (raised before any upload) and
        ``GroupCapacityExceeded`` come back as None; device errors
        propagate."""
        conf = self.session.conf
        node = plan.child
        filter_node = None
        if isinstance(node, L.Filter):
            filter_node = node
            node = node.child
        if not isinstance(node, L.IndexScan):
            return None, None, None
        if plan.keys and not conf.agg_device_grouped_enabled:
            return None, None, None
        from hyperspace_tpu_torch.exec import aggregate as A
        from hyperspace_tpu_torch.exec import device as D

        batch = self._exec(node, with_file_names=False)
        if B.num_rows(batch) < conf.device_exec_min_rows:
            trace.fallback("agg", "min-rows")
            return None, batch, filter_node
        if conf.parallel_enabled:
            raise NotImplementedError("the sharded (hyperspace.parallel.enabled) aggregate is not yet in the port")
        condition = filter_node.condition if filter_node is not None else None
        t = time.perf_counter()
        scan_key = _scan_identity(node)
        self._add_stage("scan_identity", t)
        try:
            if plan.keys:
                got = A.device_grouped_aggregate(
                    self.session,
                    batch,
                    condition,
                    list(plan.keys),
                    list(plan.aggs),
                    scan_key=scan_key,
                    max_groups=conf.agg_max_groups,
                    cap_floor=conf.agg_capacity_floor,
                )
            else:
                got = A.device_filtered_aggregate(self.session, batch, condition, plan.aggs, scan_key=scan_key)
            return got, batch, filter_node
        except A.GroupCapacityExceeded:
            trace.fallback("agg", "spill")
            return None, batch, filter_node
        except D.DeviceUnsupported:
            trace.fallback("agg", "unsupported")
            return None, batch, filter_node

    def _exec_scan(
        self,
        plan: L.Scan,
        with_file_names: bool,
        files: Optional[List[str]] = None,
        columns: Optional[List[str]] = None,
        predicate=None,
    ) -> B.Batch:
        rel = plan.relation
        if files is None:
            files = [fi.name for fi in rel.all_file_infos()]
        if not files:
            # empty after pruning: typed empty columns from the schema
            from hyperspace_tpu_torch.sources import schema as schema_codec

            batch: B.Batch = {
                f.name: np.empty(0, dtype=schema_codec.arrow_to_numpy_dtype(f.type))
                for f in rel.schema
                if columns is None or f.name in columns
            }
            if with_file_names:
                batch[INPUT_FILE_NAME] = np.empty(0, dtype=object)
            return batch
        pv = pd = None
        if rel.partition_columns:
            pv = {f: rel.partition_values_for(f) for f in files}
            pd = dict(rel.partition_dtypes) or None
        t = time.perf_counter()
        batch = _read_files(
            files,
            rel.physical_format,
            columns,
            with_file_names,
            pv,
            pd,
            format_options=getattr(rel, "options", None) or None,
            predicate=predicate,
        )
        self._add_stage("decode", t)
        return batch

    def _filter_mask(self, plan: L.Filter, child: B.Batch, pruned_by=None) -> np.ndarray:
        """Predicate evaluation: the device program over index and file
        scans, host numpy otherwise. Only a predicate the device program
        cannot express (``DeviceUnsupported``, raised before any upload)
        falls back to the host; errors of the device itself propagate.
        ``pruned_by`` is the predicate whose row-group pruning produced
        ``child``; it brands the scan's device-cache key. Hybrid scan's
        lineage ``NOT IN`` runs as the lineage-antijoin program."""
        conf = self.session.conf
        if conf.device_execution_enabled and isinstance(plan.child, (L.IndexScan, L.FileScan)):
            # hybrid scan's lineage delete filter: the lineage-antijoin
            # program instead of the general predicate program (which has no
            # IN) or the host set operation
            lineage = self._lineage_not_in(plan.condition)
            if lineage is not None and conf.lifecycle_device_lineage_enabled:
                if B.num_rows(child) >= conf.lifecycle_device_lineage_min_rows:
                    if conf.parallel_enabled:
                        raise NotImplementedError(
                            "the sharded (hyperspace.parallel.enabled) lineage filter is not yet in the port"
                        )
                    from hyperspace_tpu_torch.exec import device as D
                    from hyperspace_tpu_torch.exec.lineage import lineage_delete_mask

                    t = time.perf_counter()
                    scan_key = _pruned_scan_key(_scan_identity(plan.child), pruned_by)
                    self._add_stage("scan_identity", t)
                    col, ids = lineage
                    try:
                        t = time.perf_counter()
                        mask = lineage_delete_mask(self.session, child, col, ids, scan_key=scan_key)
                        self._add_stage("lineage", t)
                        trace.record("filter", "device-lineage")
                        return mask
                    except D.DeviceUnsupported:
                        trace.record("filter", "host-fallback")
                        trace.fallback("lineage", "unsupported")
                        return self._host_mask(plan, child)
                trace.fallback("lineage", "min-rows")
                trace.record("filter", "host")
                return self._host_mask(plan, child)
            if B.num_rows(child) >= conf.device_exec_min_rows:
                if conf.parallel_enabled:
                    raise NotImplementedError("the sharded (hyperspace.parallel.enabled) filter is not yet in the port")
                from hyperspace_tpu_torch.exec import device as D

                t = time.perf_counter()
                scan_key = _pruned_scan_key(_scan_identity(plan.child), pruned_by)
                self._add_stage("scan_identity", t)
                try:
                    mask = D.device_filter_mask(self.session, child, plan.condition, scan_key=scan_key)
                    trace.record("filter", "device")
                    return mask
                except D.DeviceUnsupported:
                    trace.record("filter", "host-fallback")
                    trace.fallback("filter", "unsupported")
                    return self._host_mask(plan, child)
            trace.fallback("filter", "min-rows")
        trace.record("filter", "host")
        return self._host_mask(plan, child)

    @staticmethod
    def _lineage_not_in(condition) -> Optional[Tuple[str, list]]:
        """Match the hybrid-scan delete filter ``NOT (col IN int-literals)``
        (rules/utils._hybrid_scan_plan); returns (column, ids) or None."""
        from hyperspace_tpu_torch.plan.expr import Col, In, Lit, Not

        if not (isinstance(condition, Not) and isinstance(condition.child, In)):
            return None
        inner = condition.child
        if not isinstance(inner.child, Col):
            return None
        ids = []
        for lit in inner.values:
            if not (isinstance(lit, Lit) and isinstance(lit.value, (int, np.integer))):
                return None
            ids.append(int(lit.value))
        return inner.child.name, ids

    def _host_mask(self, plan: L.Filter, child: B.Batch) -> np.ndarray:
        t = time.perf_counter()
        mask = as_bool_mask(plan.condition.eval(child))
        self._add_stage("host_predicate", t)
        return mask
