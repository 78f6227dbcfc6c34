"""Physical executor of the filter query.

Executes a (possibly index-rewritten) logical plan over pyarrow + numpy on
the host, with the filter over an index scan evaluated on the session's
device (exec/device.py). The host path is the correctness baseline and the
non-indexed fallback.

The port's executor runs the nodes of the filter query — ``Scan``,
``IndexScan``, ``Filter`` and ``Project``; every other node raises until its
slice lands. The reference delegates all of this to Spark's physical
planner/executors; here the framework owns it.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from hyperspace_tpu_torch.exec import batch as B
from hyperspace_tpu_torch.exec import trace
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.plan.expr import INPUT_FILE_NAME, Expr, InputFileName, as_bool_mask


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


class Executor:
    def __init__(self, session):
        self.session = session

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
        batch = self._exec(plan, _plan_needs_file_names(plan))
        if required_columns is not None:
            batch = B.select(batch, required_columns)
        elif INPUT_FILE_NAME in batch:
            batch = {k: v for k, v in batch.items() if k != INPUT_FILE_NAME}
        return batch

    def _exec(self, plan: L.LogicalPlan, with_file_names: bool) -> B.Batch:
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
            # the projected columns (the column-pruned plan shape is
            # Project-over-Scan)
            if isinstance(plan.child, L.Scan) and set(plan.columns) <= set(plan.child.output_columns):
                got = self._exec_scan(plan.child, with_file_names, columns=list(plan.columns))
                if with_file_names and INPUT_FILE_NAME in got:
                    return got
                return B.select(got, list(plan.columns))
            child = self._exec(plan.child, with_file_names)
            cols = list(plan.columns)
            if with_file_names and INPUT_FILE_NAME in child:
                cols = cols + [INPUT_FILE_NAME]
            return B.select(child, cols)

        raise NotImplementedError(f"executing {type(plan).__name__} is not yet in the port")

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
