"""Physical executor of the filter query, the equi-join and aggregation.

Executes a (possibly index-rewritten) logical plan over pyarrow + numpy on
the host, with the filter over an index scan evaluated on the session's
device (exec/device.py), a join over two compatible bucketed index scans
run as the shuffle-free sort-merge join (exec/join.py), a join with a
small side as the broadcast hash join (exec/join_stream.py), an aggregate
over a (filtered) index scan run as one device program
(exec/aggregate.py), and ``ORDER BY ... LIMIT k`` over a multi-chunk scan
as the streaming device top-k (exec/topk.py) unless the index's sorted runs
already give the order (``_merge_sorted_runs``). The host path is the
correctness baseline and the non-indexed fallback.

Out of core: above ``hyperspace.exec.stream.joinMinBytes`` the bucketed
join streams bucket by bucket (exec/join.py), above
``exec.stream.aggMinBytes`` an aggregate over a scan chain runs in file
chunks and merges partial states (``_streaming_aggregate``), and above
``exec.join.spillMinRows`` the generic merge runs in hash partitions
(``_partitioned_merge``). ``execute_stream`` yields a result chunk by chunk
(``DataFrame.to_local_iterator``). Chunks decode ahead of their consumer on
the scan pipeline (exec/pipeline.py).

The executor runs every node of the logical plan: the scans, ``Filter``,
``Project``, ``Compute``, ``Join`` (with a residual ON predicate on the
host merge), ``Aggregate``, ``Sort``, ``Limit``, ``Window``, ``Rename``,
``SetOp`` and hybrid scan's ``Union``, ``BucketUnion`` and
``Repartition``. Subquery expressions run once per
``execute`` (``plan/expr.py::subquery_scope``). A Filter over a source
scan reads only the files its partition-column conjuncts keep, and pushes
its predicate into the parquet read, which prunes row groups by their
footer statistics.
The reference delegates all of this to Spark's physical planner/executors;
here the framework owns it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from hyperspace_tpu_torch.exec import batch as B
from hyperspace_tpu_torch.exec import trace
from hyperspace_tpu_torch.obs import spans, stages
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.plan.expr import (
    EMPTY_SCALAR,
    INPUT_FILE_NAME,
    BinaryOp,
    Expr,
    InputFileName,
    NullableBool,
    _to_value_array,
    as_bool_mask,
    extract_equi_join_keys,
    get_column,
    subquery_scope,
)

#: the global row-id column of the top-k's host fallback (pool + chunks)
_TOPK_RID = "__hs_topk_rid__"


def _scan_identity(scan):
    """Stable identity of a scan's file set for device-side caching: the
    (path, mtime, size) of each file, so a rewrite of a file (new index
    version, compaction) changes the key. An index scan's files are
    immutable per path, and their facts are committed in its log entry, so
    they come from the entry; source files, and files the entry does not
    record, are stat'ed (``leaf_file_facts``). Returns None (= don't cache)
    when any file can't be stat'ed — a path-only key could serve stale
    device columns after an in-place rewrite."""
    try:
        return tuple(leaf_file_facts(scan))
    except OSError:
        return None


def _maybe_parallel(session, n_rows: Optional[int] = None):
    """The session's ``ShardedExecutor`` when ``hyperspace.parallel.enabled``
    is on (and, when a row count is known, the chunk clears
    ``hyperspace.parallel.minRows``; a streamed path has none); None routes
    to the single-device path."""
    if not session.conf.parallel_enabled:
        return None
    from hyperspace_tpu_torch.parallel.executor import ShardedExecutor

    px = ShardedExecutor.maybe(session)
    if px is not None and n_rows is not None and not px.rows_ok(n_rows):
        return None
    return px


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


def _key_codes(arr: np.ndarray, asc: bool) -> np.ndarray:
    """Per-row int64 sort codes for one key column: rank by value (negated
    for descending), missing values (NaN/NaT/None) last in BOTH directions.
    The single ordering definition shared by the Sort node, windows and
    set operations."""
    n = arr.shape[0]
    if arr.dtype == object:
        missing = np.array([v is None or (isinstance(v, float) and v != v) for v in arr], dtype=bool)
        conv = np.where(missing, "", arr.astype(str))
    elif arr.dtype.kind == "f":
        missing = np.isnan(arr)
        conv = np.where(missing, 0.0, arr)
    elif arr.dtype.kind == "M":
        missing = np.isnat(arr)
        fill = arr[~missing][0] if (~missing).any() else arr
        conv = np.where(missing, fill, arr)
    else:
        missing = np.zeros(n, dtype=bool)
        conv = arr
    _, codes = np.unique(conv, return_inverse=True)
    keyvals = (codes if asc else -codes).astype(np.int64)
    keyvals[missing] = np.iinfo(np.int64).max
    return keyvals


def _composite_codes(per_key: List[np.ndarray]) -> np.ndarray:
    """Collapse per-key int64 codes into one composite code per row (equal
    tuples share a code, ordering lexicographic)."""
    n = per_key[0].shape[0] if per_key else 0
    sort_order = np.lexsort(per_key[::-1])
    changed = np.zeros(n, dtype=bool)
    if n:
        for kv in per_key:
            s = kv[sort_order]
            changed[1:] |= s[1:] != s[:-1]
    composite = np.cumsum(changed)
    out = np.empty(n, dtype=np.int64)
    out[sort_order] = composite
    return out


def _order_codes(child: B.Batch, keys) -> np.ndarray:
    """One int64 composite code per row whose ordering equals the
    lexicographic (column, ascending) ordering — equal tuples share a code."""
    return _composite_codes([_key_codes(child[name], asc) for name, asc in keys])


def _window_column(child: B.Batch, spec, caches) -> np.ndarray:
    """Evaluate one window spec over the batch (pandas per-partition ops).
    ``caches`` memoizes partition ngroups and order codes across the sibling
    specs of one Window node."""
    import pandas as pd

    part_cache, codes_cache = caches
    out_name, fn, arg, pcols, orders, cumulative = spec
    n = B.num_rows(child)
    # one int per row identifying its partition
    part = part_cache.get(tuple(pcols))
    if part is None:
        if pcols:
            part = (
                pd.DataFrame({c: child[c] for c in pcols})
                .groupby(list(pcols), dropna=False, sort=False)
                .ngroup()
                .to_numpy()
            )
        else:
            part = np.zeros(n, dtype=np.int64)
        part_cache[tuple(pcols)] = part

    def order_codes():
        key = tuple(orders)
        got = codes_cache.get(key)
        if got is None:
            got = codes_cache[key] = _order_codes(child, orders)
        return got

    if fn in ("rank", "dense_rank", "row_number"):
        method = {"rank": "min", "dense_rank": "dense", "row_number": "first"}[fn]
        return pd.Series(order_codes()).groupby(part).rank(method=method).astype(np.int64).to_numpy()

    pd_fn = {"sum": "sum", "min": "min", "max": "max", "avg": "mean", "count": "count"}[fn]
    vals = pd.Series(child[arg]) if arg is not None else pd.Series(np.ones(n, dtype=np.int64))
    if cumulative and orders:
        # explicit ROWS UNBOUNDED PRECEDING .. CURRENT ROW
        codes = order_codes()
        pos = np.lexsort((np.arange(n), part, codes))
        inv = np.empty(n, dtype=np.int64)
        inv[pos] = np.arange(n)
        sv = vals.iloc[pos].reset_index(drop=True)
        sp = part[pos]
        if fn == "count":
            cum = sv.notna().groupby(sp).cumsum()
        elif fn == "sum":
            # running sum skips NULLs (cumsum would leave NaN holes)
            cum = sv.fillna(0).groupby(sp).cumsum()
            all_null = (~sv.notna()).groupby(sp).cummin()  # NULL until a value
            cum[all_null.astype(bool)] = np.nan
        else:
            # expanding() emits rows grouped by partition: drop the group
            # level and sort back to sv's positional order before inverting
            cum = sv.groupby(sp).expanding().agg(pd_fn).reset_index(level=0, drop=True).sort_index()
        return np.asarray(cum)[inv]
    if fn == "count" and arg is None:
        return pd.Series(np.ones(n, dtype=np.int64)).groupby(part).transform("size").to_numpy()
    return vals.groupby(part).transform(pd_fn).to_numpy()


def _chain_to_scan(plan: L.LogicalPlan):
    """(wrappers, leaf) when ``plan`` is a chain of row-wise nodes
    (Project/Compute/Filter/Rename) over a single Scan/FileScan/IndexScan
    leaf — the shape the streaming executor can partition by files; (None,
    None) otherwise."""
    chain = []
    node = plan
    while isinstance(node, (L.Project, L.Compute, L.Filter, L.Rename)):
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
        elif isinstance(node, L.Compute):
            for _, e in node.exprs:
                needed |= set(e.references())
        elif isinstance(node, L.Filter):
            needed |= set(node.condition.references())
        elif isinstance(node, L.Rename):
            needed |= set(node.mapping.keys())
    if aggs:
        needed |= {c for _, _, c in aggs if c is not None}
    if keys:
        needed |= set(keys)
    return needed


def _chain_pushdown_condition(chain):
    """AND of the chain's Filter conditions that sit over only Projects,
    still in source-column terms: the predicate the grouped device stream
    fuses into its program, and the one a chunk's leaf carries for
    row-group pruning. Compute and Rename rebind the namespace, so
    conditions above them don't push."""
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


def leaf_file_facts(leaf: L.LogicalPlan, files: Optional[List[str]] = None, partial: bool = False) -> list:
    """``[(path, mtime_ns, size), ...]`` of ``files`` (default: every file
    the scan leaf reads). Index data is written once, under a fresh path,
    and each commit records the facts of every file it adds
    (``Content.from_directory`` stats them), so an ``IndexScan``'s files
    come from its entry's ``FileInfo``s. Source files can change in place
    and are stat'ed, as is any file the entry does not record. Raises the
    ``OSError`` of a file that cannot be stat'ed; with ``partial`` that file
    gets ``(path, None, None)``."""
    import os

    if files is None:
        files = _leaf_files(leaf)
    recorded = leaf.entry.content.file_info_map() if isinstance(leaf, L.IndexScan) else {}
    facts = []
    for f in files:
        fi = recorded.get(f)
        if fi is not None:
            facts.append((f, fi.modified_time, fi.size))
            continue
        try:
            st = os.stat(f)
        except OSError:
            if not partial:
                raise
            facts.append((f, None, None))
            continue
        facts.append((f, st.st_mtime_ns, st.st_size))
    return facts


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


def _chunk_files_by_bytes(facts, target_bytes: int) -> List[List[str]]:
    """Greedy size-bounded file groups over ``(path, mtime, size)`` facts
    (a single file above the target forms its own group, as does one of
    unknown size)."""
    groups: List[List[str]] = []
    cur: List[str] = []
    cur_bytes = 0
    for f, _, sz in facts:
        if sz is None:
            sz = target_bytes  # unknown -> isolate conservatively
        if cur and cur_bytes + sz > target_bytes:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(f)
        cur_bytes += sz
    if cur:
        groups.append(cur)
    return groups


def _leaf_chunks(leaf, chunk_bytes: int, files: Optional[List[str]] = None) -> List[List[str]]:
    """``_chunk_files_by_bytes`` over the file facts of a scan leaf's
    ``files`` (default: all it reads)."""
    return _chunk_files_by_bytes(leaf_file_facts(leaf, files, partial=True), max(1, chunk_bytes))


def _streaming_groups(leaf, min_bytes: int, chunk_bytes: int) -> Optional[List[List[str]]]:
    """The streamed aggregate's gate: the file groups of a scan leaf over at
    least two files and ``min_bytes`` of them that makes two groups or more,
    else None (a file that cannot be stat'ed: None too)."""
    files = _leaf_files(leaf)
    if len(files) < 2:
        return None
    try:
        facts = leaf_file_facts(leaf, files)
    except OSError:
        return None
    if sum(sz for _, _, sz in facts) < min_bytes:
        return None
    groups = _chunk_files_by_bytes(facts, max(1, chunk_bytes))
    return groups if len(groups) >= 2 else None


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


def aggregate_batch(session, keys, aggs, batch: B.Batch) -> B.Batch:
    """Aggregate an already-materialized batch: the serving micro-batch
    path's last step. Grouped shapes try the device grouped aggregate
    (``scan_key=None``: the batch is transient, nothing to keep resident);
    everything else, and every fallback, runs the host pandas path."""
    conf = session.conf
    keys = list(keys)
    aggs = list(aggs)
    if (
        keys
        and conf.device_execution_enabled
        and conf.agg_device_grouped_enabled
        and B.num_rows(batch) >= conf.device_exec_min_rows
    ):
        from hyperspace_tpu_torch.exec import aggregate as A
        from hyperspace_tpu_torch.exec import device as D

        try:
            got = A.device_grouped_aggregate(
                session,
                batch,
                None,
                keys,
                aggs,
                scan_key=None,
                max_groups=conf.agg_max_groups,
                cap_floor=conf.agg_capacity_floor,
                parallel=_maybe_parallel(session, B.num_rows(batch)),
            )
            trace.record("agg", "device-grouped-batch")
            return got
        except A.GroupCapacityExceeded:
            trace.fallback("agg", "spill")
        except D.DeviceUnsupported:
            trace.fallback("agg", "unsupported")
    return host_aggregate(batch, keys, aggs)


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

    def execute(
        self,
        plan: L.LogicalPlan,
        required_columns: Optional[List[str]] = None,
        prepruned: bool = False,
    ) -> B.Batch:
        # execution-time column pruning for EVERY plan (Catalyst runs
        # ColumnPruning unconditionally; ApplyHyperspace only prunes plans
        # it rewrites, and hyperspace-off queries never saw it at all);
        # the fallback keeps the never-break-a-query contract. ``prepruned``
        # lets the serving plan cache skip this walk for templates pruned
        # once at compile
        if not prepruned:
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
            with subquery_scope():  # each subquery runs once per execute
                batch = self._exec(plan, _plan_needs_file_names(plan))
        finally:
            self._memo = {}
            self._shared = set()
            # the query's device programs have ended (its results are on
            # the host): read their CUDA-event times without waiting
            from hyperspace_tpu_torch.exec import device as D

            D.resolve_program_timings()
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

        A join with a side under ``hyperspace.exec.join.broadcastMaxBytes``
        streams through the broadcast hash join's probe, chunk by chunk
        (exec/join_stream.py), with a Filter and a Project above it fused
        into the chunk walk. A root Limit over a Sort yields the sorted-run
        merge's or the device top-k's one batch; a bare root Limit stops
        the scan pipeline once it has its rows."""
        from hyperspace_tpu_torch.rules.utils import prune_columns, shared_subplan_ids

        try:
            plan = prune_columns(plan)
        except Exception:  # pruning must never kill a query
            trace.record("prune", "fallback-unpruned")
        self._shared = shared_subplan_ids(plan)
        self._memo = {}
        try:
            with subquery_scope():
                if _plan_needs_file_names(plan):
                    batch = self._exec(plan, True)
                    yield {k: v for k, v in batch.items() if k != INPUT_FILE_NAME}
                    return
                node = plan
                if isinstance(node, L.Limit):
                    gen = self._stream_limit_node(node)
                    if gen is not None:
                        yield from gen
                        return
                proj = None
                if isinstance(node, L.Project):
                    proj, node = list(node.columns), node.child
                # a Filter directly above a Join applies per streamed chunk
                # (a mask per bucket of the bucketed join; the post-join
                # program of the broadcast probe)
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
                    from hyperspace_tpu_torch.exec import join_stream as JS

                    if JS.broadcast_spec(self.session, node) is not None:
                        gen = JS.stream_broadcast_join(self, node, post_filter=post_filter, project=proj)
                        try:
                            try:
                                first = next(gen)
                            except StopIteration:
                                return
                            except D.DeviceUnsupported:
                                gen = None
                            if gen is not None:
                                yield first
                                yield from gen
                                return
                        finally:
                            if gen is not None:
                                gen.close()  # an abandoned stream stops its probe decodes
                chain, leaf = _chain_to_scan(plan)
                if leaf is not None:
                    with stages.stage(self.session, "stream_gate"):
                        groups = _leaf_chunks(leaf, self.session.conf.stream_chunk_bytes)
                    if len(groups) > 1:
                        needed = _chain_needed_columns(chain) | set(plan.output_columns)
                        yield from self._stream_chunks(chain, leaf, groups, needed)
                        return
                batch = self._exec(plan, False)
                yield {k: v for k, v in batch.items() if k != INPUT_FILE_NAME}
        finally:
            self._memo = {}
            self._shared = set()

    def _stream_chunks(self, chain, leaf, groups, needed, leaf_only=False, stage_extra=None,
                       dynamic_pushdown=None):
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
        row groups with it, and it brands the chunk's device-cache key.

        ``dynamic_pushdown`` is a zero-argument callable returning a
        currently valid extra pruning predicate (or None): the top-k
        stream's running k-th-value threshold. It is read inside each
        chunk's decode, so a prefetched chunk takes whatever threshold the
        fold has reached when its decode starts (a stale one only prunes
        less). Staging is off with a dynamic predicate: the branded scan
        key changes with the threshold, so staged columns would never be
        looked up."""
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

        def apply_dynamic(i):
            # refresh the chunk leaf's pruning predicate at decode time (the
            # top-k threshold tightens as earlier chunks fold)
            if dynamic_pushdown is None or not isinstance(leaves[i], (L.FileScan, L.IndexScan)):
                return
            dp = dynamic_pushdown()
            if dp is None:
                return
            leaves[i].pushdown_predicate = dp if pushed is None else BinaryOp("AND", pushed, dp)

        if not conf.pipeline_enabled or len(groups) < 2 or any(wfns):
            # a prefetched leaf batch cannot carry file-name columns; such
            # chains (InputFileName in a filter) stay serial
            for i, (sub, wfn) in enumerate(zip(subs, wfns)):
                apply_dynamic(i)
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
        staging = (dev_cond is not None or bool(stage_extra)) and dynamic_pushdown is None
        device = D.resolved_device(self.session) if staging else None

        def stage(i, batch):
            if B.num_rows(batch) < conf.device_exec_min_rows:
                return
            key = _pruned_scan_key(_scan_identity(leaves[i]), pushed)
            D.stage_filter_columns(self.session, batch, dev_cond, key, extra_columns=stage_extra, device=device)

        def weigh(batch):
            return sum(int(getattr(a, "nbytes", 0)) for a in batch.values())

        def decode(i):
            apply_dynamic(i)
            return self._exec(leaves[i], False)

        pipe = ScanPipeline(
            [(lambda i=i: decode(i)) for i in range(len(leaves))],
            depth=max(1, conf.pipeline_depth),
            max_buffered_bytes=conf.pipeline_max_buffered_bytes,
            weigh=weigh,
            stage=stage if staging else None,
        )
        try:
            for i, leaf_batch in enumerate(stages.timed(self.session, "stream_wait", pipe)):
                if leaf_only:
                    yield leaves[i], subs[i], leaf_batch
                else:
                    prev = self._leaf_override
                    self._leaf_override = (leaves[i], leaf_batch)
                    try:
                        with spans.span("execute", cat="pipeline", chunk=i):
                            out = self._exec(subs[i], False)
                    finally:
                        self._leaf_override = prev
                    yield out
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
            batch = self._exec_inner(plan, with_file_names)
            self._memo[key] = batch
            return dict(batch)
        return self._exec_inner(plan, with_file_names)

    def _exec_inner(self, plan: L.LogicalPlan, with_file_names: bool) -> B.Batch:
        # per-operator span: node-type name and result rows/bytes. One
        # contextvar read on the disabled path (spans.span returns the shared
        # null context manager)
        cm = spans.span(type(plan).__name__, cat="exec")
        if cm is spans._NULL_CM:
            return self._exec_node(plan, with_file_names)
        with cm as sp:
            batch = self._exec_node(plan, with_file_names)
            try:
                sp.set(
                    rows=B.num_rows(batch),
                    bytes=int(sum(getattr(a, "nbytes", 0) for a in batch.values())),
                )
            except Exception:
                pass
            return batch

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
            bucket_cache = getattr(self.session, "bucket_cache", None)
            if (
                bucket_cache is not None
                and not with_file_names
                and plan.files
                and plan.file_format == "parquet"
                and not plan.partition_values
                and not plan.format_options
            ):
                trace.record("scan", "bucket-cache-filescan")
                with stages.stage(self.session, "bucket_read"):
                    return bucket_cache.read(list(plan.files), list(plan.columns))
            with stages.stage(self.session, "decode"):
                return _read_files(
                    list(plan.files),
                    plan.file_format,
                    list(plan.columns),
                    with_file_names,
                    partition_values=plan.partition_values,
                    partition_dtypes=plan.partition_dtypes,
                    format_options=plan.format_options,
                    predicate=getattr(plan, "pushdown_predicate", None),
                )

        if isinstance(plan, L.IndexScan):
            if plan.pruned_buckets is not None:
                trace.record("scan", f"index-bucket-pruned({len(plan.pruned_buckets)} buckets)")
            else:
                trace.record("scan", "index")
            fcols = plan.file_columns if plan.file_columns is not None else list(plan.columns)
            bucket_cache = getattr(self.session, "bucket_cache", None)
            if not plan.files:
                # every bucket pruned away: empty columns; dtype-less object
                # arrays compare fine against any literal on zero rows
                cols = list(fcols) + ([INPUT_FILE_NAME] if with_file_names else [])
                batch = {c: np.empty(0, dtype=object) for c in cols}
            elif bucket_cache is not None and not with_file_names:
                with stages.stage(self.session, "bucket_read"):
                    batch = bucket_cache.read(list(plan.files), list(fcols))
            else:
                with stages.stage(self.session, "decode"):
                    batch = _read_files(
                        list(plan.files),
                        "parquet",
                        list(fcols),
                        with_file_names,
                        predicate=getattr(plan, "pushdown_predicate", None),
                    )
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
            with stages.stage(self.session, "mask_rows"):
                return B.mask_rows(child, mask)

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

        if isinstance(plan, L.Compute):
            child = self._exec(plan.child, with_file_names)
            out = dict(child)
            n = B.num_rows(child)
            for name, expr in plan.exprs:
                v = expr.eval(child)
                if v is EMPTY_SCALAR:  # NULL scalar subquery -> NULL column
                    v = np.full(n, np.nan)
                elif isinstance(v, NullableBool):
                    # a three-valued boolean projected as a SELECT item keeps
                    # its NULLs (Spark yields NULL, not false)
                    v = _to_value_array(v)
                v = np.asarray(v)
                if v.ndim == 0:
                    v = np.broadcast_to(v, (n,)).copy()
                out[name] = v
            return out

        if isinstance(plan, L.Join):
            return self._exec_join(plan, with_file_names)

        if isinstance(plan, L.Aggregate):
            return self._exec_aggregate(plan, with_file_names)

        if isinstance(plan, L.Sort):
            if not with_file_names:
                got = self._try_sorted_run_merge(plan)
                if got is not None:
                    return got
            child = self._exec(plan.child, with_file_names)
            order = np.arange(B.num_rows(child))
            # least-significant key first: stable argsorts compose into the
            # lexicographic order over all keys. Keys sort by rank (np.unique
            # codes): negation-safe for every dtype, and missing values
            # (NaN/None) rank last in BOTH directions like pandas.
            for name, asc in reversed(plan.keys):
                arr = get_column(child, name)
                if arr is None:
                    raise KeyError(f"Sort key {name!r} not found")
                keyvals = _key_codes(arr[order], asc)
                order = order[np.argsort(keyvals, kind="stable")]
            return {k: v[order] for k, v in child.items()}

        if isinstance(plan, L.Limit):
            if isinstance(plan.child, L.Sort) and not with_file_names:
                # ORDER BY ... LIMIT k: index-order merge first (no sort at
                # all), then the streaming device top-k; both are
                # byte-identical to host-sort-then-slice
                got = self._try_sorted_run_merge(plan.child, limit=plan.n)
                if got is None:
                    got = self._try_streaming_topk(plan.child, plan.n)
                if got is not None:
                    return got
            child = self._exec(plan.child, with_file_names)
            return {k: v[: plan.n] for k, v in child.items()}

        if isinstance(plan, L.Window):
            child = self._exec(plan.child, with_file_names)
            out = dict(child)
            caches = ({}, {})  # partition ngroups / order codes, shared by specs
            for spec in plan.specs:
                out[spec[0]] = _window_column(child, spec, caches)
            return out

        if isinstance(plan, L.Rename):
            child = self._exec(plan.child, with_file_names)
            return {plan.mapping.get(k, k): v for k, v in child.items()}

        if isinstance(plan, (L.Union, L.BucketUnion)):
            return B.concat([self._exec(c, with_file_names) for c in plan.children()])

        if isinstance(plan, L.SetOp):
            left = self._exec(plan.left, with_file_names)
            right = self._exec(plan.right, with_file_names)
            lcols = plan.left.output_columns
            rcols = plan.right.output_columns
            n_l = B.num_rows(left)
            # code rows over the CONCATENATION of both sides so equal values
            # of different dtypes (int64 vs float64 from a CAST or nullable
            # column) share a code; NULLs (NaN/NaT/None) compare equal via
            # the shared _key_codes missing handling
            per_key = []
            for lc, rc in zip(lcols, rcols):
                a, b = left[lc], right[rc]
                try:
                    both = np.concatenate([a, b])
                except (TypeError, ValueError):
                    both = np.concatenate([a.astype(object), b.astype(object)])
                per_key.append(_key_codes(both, True))
            comp = _composite_codes(per_key) if per_key else np.zeros(0, dtype=np.int64)
            l_codes, r_codes = comp[:n_l], comp[n_l:]
            rset = np.zeros(int(comp.max()) + 1 if comp.size else 1, dtype=bool)
            rset[r_codes] = True
            hit = rset[l_codes]
            first = np.zeros(n_l, dtype=bool)
            if n_l:
                _, first_idx = np.unique(l_codes, return_index=True)
                first[first_idx] = True  # distinct semantics
            keep = first & (hit if plan.kind == "intersect" else ~hit)
            take = np.nonzero(keep)[0]
            return {c: left[c][take] for c in lcols}

        if isinstance(plan, L.Repartition):
            # host path: an in-memory batch has no physical bucketing, so the
            # rows pass through (the bucketed join re-buckets them itself)
            return self._exec(plan.child, with_file_names)

        raise NotImplementedError(f"Cannot execute {type(plan).__name__}")

    def _exec_join(self, plan: L.Join, with_file_names: bool) -> B.Batch:
        """The bucketed sort-merge join when both sides are compatible
        bucketed index scans (exec/join.py), else the generic equi-join: a
        pandas hash merge over slim key frames (a residual ON predicate
        filters its matched pairs, ``_residual_join``).

        Between the two sits the broadcast hash join
        (exec/join_stream.py): a join with a side under
        ``hyperspace.exec.join.broadcastMaxBytes``."""
        import pandas as pd

        if not with_file_names and self.session.conf.device_execution_enabled:
            # deviceExecution=False is the kill switch back to the generic
            # merge: it routes around the whole bucketed-join stack
            from hyperspace_tpu_torch.exec import device as D
            from hyperspace_tpu_torch.exec import join as J

            from hyperspace_tpu_torch.exec import join_stream as JS

            try:
                return J.dispatch_bucketed_join(self.session, plan)
            except D.DeviceUnsupported:
                pass  # next tier: the broadcast hash join
            try:
                return JS.dispatch_broadcast_join(self, plan)
            except D.DeviceUnsupported:
                trace.fallback("join", "unsupported")
        trace.record("join", "generic-merge")

        pairs = extract_equi_join_keys(plan.condition)
        if pairs is None:
            raise NotImplementedError("Only conjunctive equi-joins are supported")
        left = self._exec(plan.left, with_file_names)
        right = self._exec(plan.right, with_file_names)
        with stages.stage(self.session, "join_merge"):
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
                lowered = {k.lower(): k for k in batch}
                actual = lowered.get(name.lower())
                if actual is not None:
                    batch[name] = batch[actual]
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
            if plan.residual is None:
                spill = self.session.conf.join_spill_min_rows
                if spill and spill > 0 and max(len(ldf), len(rdf)) > spill:
                    merged = self._partitioned_merge(ldf, rdf, lkeys, rkeys_renamed, plan.how, spill)
                else:
                    merged = ldf.merge(rdf, left_on=lkeys, right_on=rkeys_renamed, how=plan.how)
            else:
                merged = self._residual_join(plan, ldf, rdf, lkeys, rkeys_renamed, left, right_named)
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

    @staticmethod
    def _residual_join(plan: L.Join, ldf, rdf, lkeys, rkeys, left, right_named):
        """Join with a non-equi ON residual: equi-match pairs, keep only
        pairs satisfying the residual, then null-extend the unmatched side
        rows for outer joins — ON-clause semantics, which a post-join filter
        cannot express for left/right/full joins (a failing pair must
        null-extend, not disappear). Residual references use post-join
        (renamed) column names; NULL residual results drop the pair
        (three-valued, like any SQL predicate). ``ldf``/``rdf`` are the slim
        key+row-id frames; residual inputs gather from the original arrays."""
        import pandas as pd

        pairs = ldf.merge(rdf, left_on=lkeys, right_on=rkeys, how="inner")
        if len(pairs):
            # only the referenced columns feed the predicate (the planner
            # resolved them to exact post-join names)
            li = pairs["__lrow"].to_numpy()
            ri = pairs["__rrow"].to_numpy()
            batch = {}
            for c in plan.residual.references():
                if c in pairs.columns:
                    batch[c] = pairs[c].to_numpy()
                elif c in left:
                    batch[c] = left[c][li]
                elif c in right_named:
                    batch[c] = right_named[c][ri]
            keep = as_bool_mask(plan.residual.eval(batch))
            # a constant residual (ON ... AND 1 = 0) evaluates 0-d: broadcast
            keep = np.broadcast_to(np.asarray(keep, dtype=bool), (len(pairs),))
            surviving = pairs[keep]
        else:
            surviving = pairs
        parts = [surviving]
        if plan.how in ("left", "outer"):
            lost = ldf[~np.isin(np.arange(len(ldf)), surviving["__lrow"].to_numpy())]
            parts.append(lost)  # right columns null-extend via concat
        if plan.how in ("right", "outer"):
            lost_r = rdf[~np.isin(np.arange(len(rdf)), surviving["__rrow"].to_numpy())]
            parts.append(lost_r)  # left columns null-extend
        return pd.concat(parts, ignore_index=True, sort=False) if len(parts) > 1 else surviving

    def _exec_aggregate(self, plan: L.Aggregate, with_file_names: bool) -> B.Batch:
        """The JAX package's tiers, in its order: the fused aggregate over a
        compatible bucketed inner join (host spans, no pair expansion), the
        whole-stage fused aggregate over a broadcast join (under
        ``hyperspace.exec.fusion.enabled``), the streamed aggregate over a
        large scan chain, the device aggregate over a (filtered) index scan,
        the host pandas aggregate."""
        conf = self.session.conf
        child = None
        if not with_file_names and conf.device_execution_enabled:
            join_node = plan.child
            computes = []
            while isinstance(join_node, (L.Project, L.Compute)):
                if isinstance(join_node, L.Compute):
                    # computed aggregate inputs and group keys (q3's
                    # sum(l_extendedprice * (1 - l_discount))): single-side
                    # expressions evaluate per bucket inside the fusion
                    computes.extend(join_node.exprs)
                join_node = join_node.child
            if isinstance(join_node, L.Join):
                from hyperspace_tpu_torch.exec import device as D
                from hyperspace_tpu_torch.exec import join as J

                try:
                    got = J.aggregate_over_bucketed_join(self.session, plan, join_node, computes=computes)
                    trace.record("agg", "fused-bucketed-join")
                    return got
                except D.DeviceUnsupported:
                    trace.fallback("agg", "join-unsupported")
        # the streamed tier comes before the device-scan gate, which would
        # materialize the whole scan: the out-of-core path exists to avoid it
        if not with_file_names:
            got = self._try_fused_join_aggregate(plan)
            if got is not None:
                return got
            got = self._try_streaming_aggregate(plan)
            if got is not None:
                trace.record("agg", "streamed-partial")
                return got
        if not with_file_names and conf.device_execution_enabled:
            got, scan_batch, filter_node, pruned = self._try_device_aggregate(plan)
            if got is not None:
                trace.record("agg", "device-grouped-scan" if plan.keys else "device-fused-scan")
                return got
            if scan_batch is not None:
                # the device gate already materialized the scan: reuse it
                if filter_node is not None:
                    mask = self._filter_mask(filter_node, scan_batch, pruned_by=pruned)
                    with stages.stage(self.session, "mask_rows"):
                        child = B.mask_rows(scan_batch, mask)
                else:
                    child = scan_batch

        if child is None:
            child = self._exec(plan.child, with_file_names)
        with stages.stage(self.session, "agg_host"):
            return host_aggregate(child, list(plan.keys), list(plan.aggs))

    # -- ORDER BY ... LIMIT and the bare LIMIT, streamed ---------------------

    def _stream_limit_node(self, plan: L.Limit):
        """Streamed execution of a root Limit: ORDER BY ... LIMIT goes to the
        sorted-run merge or the device top-k (one result batch), a bare
        Limit stops the scan pipeline early. Returns a generator, or None to
        fall back to the materialized path."""
        if isinstance(plan.child, L.Sort):
            got = self._try_sorted_run_merge(plan.child, limit=plan.n)
            if got is None:
                got = self._try_streaming_topk(plan.child, plan.n)
            if got is None:
                return None

            def one():
                yield got

            return one()
        return self._stream_limit(plan)

    def _stream_limit(self, plan: L.Limit):
        """Early-terminating bare Limit: stop pulling source chunks once n
        rows are collected. Closing the chunk generator propagates into
        ScanPipeline.close(), which cancels every queued decode."""
        if plan.n <= 0:
            return None
        conf = self.session.conf
        chain, leaf = _chain_to_scan(plan.child)
        if leaf is None:
            return None
        with stages.stage(self.session, "stream_gate"):
            groups = _leaf_chunks(leaf, conf.stream_chunk_bytes)
        if len(groups) < 2:
            return None
        needed = _chain_needed_columns(chain) | set(plan.output_columns)

        def gen():
            remaining = int(plan.n)
            chunks = self._stream_chunks(chain, leaf, groups, needed)
            try:
                for batch in chunks:
                    batch = {c: v for c, v in batch.items() if c != INPUT_FILE_NAME}
                    rows = B.num_rows(batch)
                    if rows >= remaining:
                        trace.record("limit", "early-stop-stream")
                        yield {c: np.asarray(v)[:remaining] for c, v in batch.items()}
                        return
                    if rows:
                        remaining -= rows
                        yield batch
            finally:
                # cancel queued decodes even when our own consumer abandons
                # the stream mid-iteration
                chunks.close()

        return gen()

    def _try_streaming_topk(self, sort_plan: L.Sort, k: int) -> Optional[B.Batch]:
        """ORDER BY ... LIMIT k over a multi-chunk scan chain as a streaming
        device top-k fold (exec/topk.TopKStream): no full materialization,
        byte-identical to host-sort-then-slice. Returns None (the caller
        materializes) when the shape or configuration does not stream, and
        when the streamed path fails (``topk: stream-fallback``). The
        sharded fold is not in the port: where the JAX package would take
        it, this raises."""
        conf = self.session.conf
        if not (conf.topk_enabled and conf.device_execution_enabled):
            return None
        if not sort_plan.keys or k <= 0 or k > conf.topk_max_k:
            return None
        chain, leaf = _chain_to_scan(sort_plan.child)
        if leaf is None:
            return None
        with stages.stage(self.session, "stream_gate"):
            files = _leaf_files(leaf)
            groups = _leaf_chunks(leaf, conf.stream_chunk_bytes, files) if len(files) >= 2 else []
        if len(groups) < 2:
            return None
        try:
            return self._streaming_topk(sort_plan, k, chain, leaf, groups)
        except NotImplementedError:
            raise
        except Exception:
            # the streamed path must never break a query the materialized
            # path can answer; visible in dispatch traces
            trace.record("topk", "stream-fallback")
            return None

    def _streaming_topk(self, sort_plan, k, chain, leaf, groups) -> Optional[B.Batch]:
        from hyperspace_tpu_torch.exec import device as D
        from hyperspace_tpu_torch.exec.topk import TopKStream

        conf = self.session.conf
        needed = _chain_needed_columns(chain) | set(sort_plan.output_columns)
        needed |= {c for c, _ in sort_plan.keys}
        stream = TopKStream(self.session, sort_plan.keys, k, parallel=_maybe_parallel(self.session))
        # the running k-th-value threshold prunes row groups of chunks not
        # yet decoded; only sound when pruning is on and the chain cannot
        # rebind the primary key column
        dynamic = None
        if (
            conf.topk_threshold_pushdown
            and conf.rowgroup_pruning_enabled
            and all(isinstance(nd, (L.Filter, L.Project)) for nd in chain)
        ):
            dynamic = stream.threshold_condition
        host_parts: Optional[List[B.Batch]] = None
        host_rid = 0
        for batch in self._stream_chunks(chain, leaf, groups, needed, dynamic_pushdown=dynamic):
            batch = {c: v for c, v in batch.items() if c != INPUT_FILE_NAME}
            if host_parts is None:
                try:
                    with stages.stage(self.session, "topk_fold"):
                        stream.update(batch)
                    continue
                except D.DeviceUnsupported as e:
                    # mid-stream fallback: the pool is a superset of the
                    # top-k of every folded row, so (pool + this and later
                    # chunks) re-sorted on host stays byte-identical
                    trace.fallback("topk", str(e) or type(e).__name__)
                    host_parts = [stream.pool_rows_with_rid(_TOPK_RID)] if stream.has_data else []
                    host_rid = stream.rows_seen
            n = B.num_rows(batch)
            part = dict(batch)
            part[_TOPK_RID] = host_rid + np.arange(n, dtype=np.int64)
            host_rid += n
            host_parts.append(part)
        if host_parts is None:
            if not stream.has_data:
                return None  # every chunk came back empty: materialize
            trace.record("topk", "device-topk-stream-sharded" if stream.parallel is not None else "device-topk-stream")
            return stream.finalize()
        parts = [p for p in host_parts if B.num_rows(p)]
        if not parts:
            return None
        merged = B.concat(parts)
        # stable composite sort with the global row id as the base order:
        # exactly the host Sort's tie semantics
        order = np.argsort(np.asarray(merged[_TOPK_RID]), kind="stable")
        for name, asc in reversed(sort_plan.keys):
            arr = get_column(merged, name)
            if arr is None:
                raise KeyError(f"Sort key {name!r} not found")
            codes = _key_codes(np.asarray(arr)[order], asc)
            order = order[np.argsort(codes, kind="stable")]
        take = order[:k]
        trace.record("topk", "host-candidate-fallback")
        return {c: np.asarray(v)[take] for c, v in merged.items() if c != _TOPK_RID}

    # -- sort elimination: a merge of the index's sorted runs ----------------

    def _try_sorted_run_merge(self, sort_plan: L.Sort, limit=None) -> Optional[B.Batch]:
        """Replace a Sort whose order the covering index already provides
        (within-bucket sort order, plan/ordering.sort_run_eligibility) with a
        k-way merge of per-file runs. The reason it cannot fire lands in the
        dispatch trace (``sort: merge-why-not: ...``)."""
        from hyperspace_tpu_torch.plan import ordering as ORD

        leaf, chain, reason = ORD.sort_run_eligibility(sort_plan)
        if leaf is None:
            # record once per query: the bare-Sort call (the Limit wrapper
            # retries through the Sort branch anyway)
            if reason is not None and limit is None:
                trace.record("sort", f"merge-why-not: {reason}")
            return None
        try:
            return self._merge_sorted_runs(sort_plan, chain, leaf, limit)
        except Exception:
            trace.record("sort", "merge-fallback")
            return None

    def _merge_sorted_runs(self, sort_plan, chain, leaf, limit) -> Optional[B.Batch]:
        import heapq

        files = _leaf_files(leaf)
        if len(files) < 2:
            return None  # a single run needs no merge; the host path is fine
        needed = _chain_needed_columns(chain) | set(sort_plan.output_columns)
        needed |= {c for c, _ in sort_plan.keys}
        runs = []
        for f in files:
            sub = _rebuild_chain(chain, _leaf_subset(leaf, [f], needed))
            runs.append(self._exec(sub, False))
        lens = [B.num_rows(r) for r in runs]
        total = B.concat(runs)
        n = B.num_rows(total)
        bounds = np.cumsum([0] + lens)
        # rank codes over the concatenation: one consistent code space for
        # all runs, the host Sort's NULLS LAST / DESC semantics
        codes = []
        for name, asc in sort_plan.keys:
            arr = get_column(total, name)
            if arr is None:
                raise KeyError(f"Sort key {name!r} not found")
            codes.append(_key_codes(np.asarray(arr), asc))

        def run_monotone(s: int, e: int) -> bool:
            if e - s < 2:
                return True
            lt = np.zeros(e - s - 1, dtype=bool)
            eq = np.ones(e - s - 1, dtype=bool)
            for c in codes:
                seg = c[s:e]
                lt |= eq & (seg[1:] < seg[:-1])
                eq &= seg[1:] == seg[:-1]
            return not lt.any()

        run_orders = []
        repaired = 0
        for i in range(len(runs)):
            s, e = int(bounds[i]), int(bounds[i + 1])
            if run_monotone(s, e):
                run_orders.append(np.arange(s, e, dtype=np.int64))
            else:
                # physical order disagrees with the requested order (NULL
                # placement, float total-order rotation, stale layout):
                # stable-repair the run; the merge stays byte-identical
                repaired += 1
                sl = np.lexsort(tuple(c[s:e] for c in reversed(codes)))
                run_orders.append(s + sl.astype(np.int64))
        # k-way heap merge; ties across runs resolve by global position, the
        # host stable sort's tie order (within a run the repair is stable,
        # so sequential emission preserves it too)
        take_n = n if limit is None else min(int(limit), n)
        heap = []
        for ro in run_orders:
            if ro.size:
                i0 = int(ro[0])
                heapq.heappush(heap, (tuple(c[i0] for c in codes), i0, ro, 1))
        out_idx = np.empty(take_n, dtype=np.int64)
        taken = 0
        while heap and taken < take_n:
            _, idx, ro, nxt = heapq.heappop(heap)
            out_idx[taken] = idx
            taken += 1
            if nxt < ro.size:
                i0 = int(ro[nxt])
                heapq.heappush(heap, (tuple(c[i0] for c in codes), i0, ro, nxt + 1))
        trace.record(
            "sort",
            "index-order-merge"
            + ("-limit" if limit is not None else "")
            + (f"-repaired:{repaired}" if repaired else ""),
        )
        return {c: np.asarray(v)[out_idx] for c, v in total.items()}

    def _try_fused_join_aggregate(self, plan: L.Aggregate) -> Optional[B.Batch]:
        """A grouped aggregate over (a Filter over) an inner broadcast Join
        runs as ONE fused program per probe chunk
        (exec/stage_ir.stream_join_aggregate) instead of the per-family
        probe, verify, post-join, fold and merge sequence. Returns None (the
        caller goes on to the streamed, device and host tiers) unless
        ``hyperspace.exec.fusion.enabled`` is set and the shape fuses; a
        shape that does not is counted in ``trace.fallbacks[("fusion",
        "join-agg-unsupported")]``. As on the streamed aggregate, a host-side
        shape or dtype error gives ``agg: stream-fallback``; an error of the
        device itself propagates."""
        conf = self.session.conf
        from hyperspace_tpu_torch.exec import stage_ir

        if not (conf.device_execution_enabled and conf.agg_device_grouped_enabled and stage_ir.fusion_wanted(conf)):
            return None
        if not plan.keys:
            return None
        if any(fn not in _STREAMABLE_AGGS or fn.endswith("_distinct") for _, fn, _ in plan.aggs):
            return None
        node = plan.child
        post_filter = None
        if isinstance(node, L.Filter) and isinstance(node.child, L.Join):
            post_filter, node = node.condition, node.child
        if not isinstance(node, L.Join):
            return None
        from hyperspace_tpu_torch.exec.device import DeviceUnsupported
        from hyperspace_tpu_torch.exec.join_stream import broadcast_spec

        spec = broadcast_spec(self.session, node)
        if spec is None:
            return None
        try:
            return stage_ir.stream_join_aggregate(self, node, spec, post_filter, list(plan.keys), list(plan.aggs))
        except DeviceUnsupported:
            trace.fallback("fusion", "join-agg-unsupported")
            return None
        except (KeyError, TypeError, ValueError):
            trace.record("agg", "stream-fallback")
            return None

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
        with stages.stage(self.session, "stream_gate"):
            groups = _streaming_groups(leaf, min_bytes, conf.stream_chunk_bytes)
        if groups is None:
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
            with stages.stage(self.session, "agg_host"):
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
                # decided per stream (chunk sizes are not known yet):
                # minRows gates the one-shot programs, not stream chunks
                parallel=_maybe_parallel(self.session),
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
                trace.record(
                    "agg",
                    "device-grouped-stream-sharded" if stream._parallel is not None else "device-grouped-stream",
                )
                return stream.finalize()

        with stages.stage(self.session, "agg_finalize"):
            return self._combine_partials(plan, plain, distinct, partial_frames, distinct_frames, g_state)

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
        """Returns (result, scan_batch, filter_node, pruned_by): result=None
        means the caller runs the host path — reusing scan_batch (the
        materialized scan, pre-filter) when it was already read for the
        gate. ``pruned_by`` is the scan's attached row-group-pruning
        predicate; it brands the device-cache key here, and the caller must
        thread it into any further device-cache use of scan_batch, or a
        pruned batch gets branded with an unpruned key. Only
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
            return None, None, None, None
        if plan.keys and not conf.agg_device_grouped_enabled:
            return None, None, None, None
        from hyperspace_tpu_torch.exec import aggregate as A
        from hyperspace_tpu_torch.exec import device as D

        pruned = getattr(node, "pushdown_predicate", None)
        batch = self._exec(node, with_file_names=False)
        if B.num_rows(batch) < conf.device_exec_min_rows:
            trace.fallback("agg", "min-rows")
            return None, batch, filter_node, pruned
        condition = filter_node.condition if filter_node is not None else None
        with stages.stage(self.session, "scan_identity"):
            scan_key = _pruned_scan_key(_scan_identity(node), pruned)
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
                    parallel=_maybe_parallel(self.session, B.num_rows(batch)),
                )
            else:
                got = A.device_filtered_aggregate(self.session, batch, condition, plan.aggs, scan_key=scan_key)
            return got, batch, filter_node, pruned
        except A.GroupCapacityExceeded:
            trace.fallback("agg", "spill")
            return None, batch, filter_node, pruned
        except D.DeviceUnsupported:
            trace.fallback("agg", "unsupported")
            return None, batch, filter_node, pruned

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
        with stages.stage(self.session, "decode"):
            return _read_files(
                files,
                rel.physical_format,
                columns,
                with_file_names,
                pv,
                pd,
                format_options=getattr(rel, "options", None) or None,
                predicate=predicate,
            )

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
                    from hyperspace_tpu_torch.exec import device as D
                    from hyperspace_tpu_torch.exec.lineage import lineage_delete_mask

                    with stages.stage(self.session, "scan_identity"):
                        scan_key = _pruned_scan_key(_scan_identity(plan.child), pruned_by)
                    col, ids = lineage
                    try:
                        with stages.stage(self.session, "lineage"):
                            mask = lineage_delete_mask(self.session, child, col, ids, scan_key=scan_key,
                                                       parallel=_maybe_parallel(self.session, B.num_rows(child)))
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
                from hyperspace_tpu_torch.exec import device as D

                with stages.stage(self.session, "scan_identity"):
                    scan_key = _pruned_scan_key(_scan_identity(plan.child), pruned_by)
                try:
                    px = _maybe_parallel(self.session, B.num_rows(child))
                    mask = D.device_filter_mask(self.session, child, plan.condition, scan_key=scan_key, parallel=px)
                    trace.record("filter", "device-sharded" if px is not None else "device")
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
        with stages.stage(self.session, "host_predicate"):
            # a struct leaf the predicate names more than once is extracted from
            # its root column once, not per reference
            dotted = [r for r in plan.condition.references() if "." in r and r not in child]
            if dotted:
                child = dict(child)
                for r in dotted:
                    got = get_column(child, r)
                    if got is not None:
                        child[r] = got
            mask = as_bool_mask(plan.condition.eval(child))
        return mask
