"""Physical executor of the filter query and the equi-join.

Executes a (possibly index-rewritten) logical plan over pyarrow + numpy on
the host, with the filter over an index scan evaluated on the session's
device (exec/device.py) and a join over two compatible bucketed index scans
run as the shuffle-free sort-merge join (exec/join.py). The host path is the
correctness baseline and the non-indexed fallback.

The port's executor runs ``Scan``, ``IndexScan``, ``Filter``, ``Project``
and ``Join``; every other node raises until its slice lands. The reference
delegates all of this to Spark's physical planner/executors; here the
framework owns it.
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
