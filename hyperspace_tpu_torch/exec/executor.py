"""Physical executor of the filter query, the equi-join and aggregation.

Executes a (possibly index-rewritten) logical plan over pyarrow + numpy on
the host, with the filter over an index scan evaluated on the session's
device (exec/device.py), a join over two compatible bucketed index scans
run as the shuffle-free sort-merge join (exec/join.py), and an aggregate
over a (filtered) index scan run as one device program
(exec/aggregate.py). The host path is the correctness baseline and the
non-indexed fallback.

The port's executor runs ``Scan``, ``IndexScan``, ``Filter``, ``Project``,
``Join`` and ``Aggregate``; every other node raises until its slice lands.
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
    columns: Optional[List[str]],
    with_file_names: bool,
    partition_values: Optional[dict] = None,
    partition_dtypes: Optional[dict] = None,
) -> B.Batch:
    """Read parquet ``files`` into one batch. ``partition_values`` ({file ->
    {col -> typed value}}) attaches hive-partition columns — constant per
    file, absent from the file bytes — to each file's rows."""
    from hyperspace_tpu_torch.exec.io import _decode_pool, read_parquet_batch

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
            import pyarrow.parquet as pq

            b: B.Batch = {}
            n = pq.ParquetFile(f).metadata.num_rows
        else:
            b = read_parquet_batch([f], file_columns)
            n = B.num_rows(b)
        if attach:
            from hyperspace_tpu_torch.sources import partitions as P

            values = partition_values.get(f, {})
            for c in attach:
                dt = (partition_dtypes or {}).get(c, np.dtype(object))
                b[c] = P.column_array(values.get(c), dt, n)
        if with_file_names:
            b[INPUT_FILE_NAME] = np.full(n, f, dtype=object)
        return b

    if with_file_names or attach:
        if len(files) > 1:
            return B.concat(list(_decode_pool().map(read_one, files)))
        return B.concat([read_one(f) for f in files])
    return read_parquet_batch(list(files), columns)


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
    (Project/Filter) over a single Scan/IndexScan leaf — the shape the
    streaming executor can partition by files; (None, None) otherwise."""
    chain = []
    node = plan
    while isinstance(node, (L.Project, L.Filter)):
        chain.append(node)
        node = node.child
    if isinstance(node, (L.Scan, L.IndexScan)):
        return chain, node
    return None, None


def _leaf_files(leaf: L.LogicalPlan) -> List[str]:
    if isinstance(leaf, L.Scan):
        return [fi.name for fi in leaf.relation.all_file_infos()]
    return list(leaf.files)


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

    def _add_stage(self, stage: str, t0: float) -> float:
        """Add the time since ``t0`` to the session's
        ``query_stage_seconds[stage]``; returns now."""
        now = time.perf_counter()
        self.session.query_stage_seconds[stage] += now - t0
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
        if isinstance(plan, L.Scan):
            return self._exec_scan(plan, with_file_names)

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
                batch = _read_files(list(plan.files), list(fcols), with_file_names)
                self._add_stage("decode", t)
            if plan.file_columns is not None:
                # present index columns under the output names
                renamed: B.Batch = {out: batch[fc] for out, fc in zip(plan.columns, fcols)}
                if INPUT_FILE_NAME in batch:
                    renamed[INPUT_FILE_NAME] = batch[INPUT_FILE_NAME]
                return renamed
            return batch

        if isinstance(plan, L.Filter):
            child = self._exec(plan.child, with_file_names)
            mask = self._filter_mask(plan, child)
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
            raise NotImplementedError(
                "the partitioned merge (a join side above hyperspace.exec.join.spillMinRows) is not yet in the port"
            )
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

    def _exec_aggregate(self, plan: L.Aggregate, with_file_names: bool) -> B.Batch:
        """The JAX package's tiers, in its order: the fused aggregate over a
        compatible bucketed inner join (host spans, no pair expansion), the
        device aggregate over a (filtered) index scan, the host pandas
        aggregate."""
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
        if not with_file_names:
            self._check_fused_join_aggregate(plan)
            self._check_streaming_aggregate(plan)
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
        ``hyperspace.exec.fusion.enabled`` is set; that is not in the port,
        so such a query raises."""
        conf = self.session.conf
        if not (conf.fusion_enabled and conf.device_execution_enabled and conf.agg_device_grouped_enabled):
            return
        if not plan.keys or any(fn not in _STREAMABLE_AGGS or fn.endswith("_distinct") for _, fn, _ in plan.aggs):
            return
        node = plan.child
        if isinstance(node, L.Filter):
            node = node.child
        if isinstance(node, L.Join):
            raise NotImplementedError(
                "the fused join aggregate (hyperspace.exec.fusion.enabled) is not yet in the port"
            )

    def _check_streaming_aggregate(self, plan: L.Aggregate) -> None:
        """The JAX package aggregates a scan chain over more source bytes
        than ``hyperspace.exec.stream.aggMinBytes`` in file chunks, merging
        partial states; that is not in the port, so an aggregate it would
        stream raises (at least two files in at least two chunks)."""
        conf = self.session.conf
        min_bytes = conf.stream_agg_min_bytes
        if not min_bytes or min_bytes <= 0:
            return
        if any(fn not in _STREAMABLE_AGGS for _, fn, _ in plan.aggs):
            return
        _chain, leaf = _chain_to_scan(plan.child)
        if leaf is None:
            return
        files = _leaf_files(leaf)
        if len(files) < 2:
            return
        import os

        try:
            total_bytes = sum(os.stat(f).st_size for f in files)
        except OSError:
            return
        if total_bytes < min_bytes:
            return
        if len(_chunk_files_by_bytes(files, max(1, conf.stream_chunk_bytes))) < 2:
            return
        raise NotImplementedError(
            "the streamed aggregate (inputs above hyperspace.exec.stream.aggMinBytes) is not yet in the port"
        )

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
        columns: Optional[List[str]] = None,
    ) -> B.Batch:
        rel = plan.relation
        files = [fi.name for fi in rel.all_file_infos()]
        if not files:
            # an empty source: typed empty columns from the schema
            batch = B.table_to_batch(rel.schema.empty_table())
            if columns is not None:
                batch = {c: v for c, v in batch.items() if c in columns}
            if with_file_names:
                batch[INPUT_FILE_NAME] = np.empty(0, dtype=object)
            return batch
        pv = pd = None
        if rel.partition_columns:
            pv = {f: rel.partition_values_for(f) for f in files}
            pd = dict(rel.partition_dtypes) or None
        t = time.perf_counter()
        batch = _read_files(files, columns, with_file_names, pv, pd)
        self._add_stage("decode", t)
        return batch

    def _filter_mask(self, plan: L.Filter, child: B.Batch) -> np.ndarray:
        """Predicate evaluation: the device program over index scans, host
        numpy otherwise. Only a predicate the device program cannot express
        (``DeviceUnsupported``, raised before any upload) falls back to the
        host; errors of the device itself propagate."""
        conf = self.session.conf
        if conf.device_execution_enabled and isinstance(plan.child, L.IndexScan):
            if B.num_rows(child) >= conf.device_exec_min_rows:
                if conf.parallel_enabled:
                    raise NotImplementedError("the sharded (hyperspace.parallel.enabled) filter is not yet in the port")
                from hyperspace_tpu_torch.exec import device as D

                t = time.perf_counter()
                scan_key = _scan_identity(plan.child)
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

    def _host_mask(self, plan: L.Filter, child: B.Batch) -> np.ndarray:
        t = time.perf_counter()
        mask = as_bool_mask(plan.condition.eval(child))
        self._add_stage("host_predicate", t)
        return mask
