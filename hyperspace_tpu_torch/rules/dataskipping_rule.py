"""DataSkippingIndexRule: prune source files using per-file sketches.

The reference snapshot ships data-skipping index build/refresh/optimize but
never registered a query-side rule (its optimizer rule list is Filter/Join/
NoOp only — ref: HS/index/rules/ScoreBasedIndexPlanOptimizer.scala:30; the
predicate-translation groundwork lives in
HS/index/dataskipping/util/extractors.scala:42-199). This module implements
that missing rule: a ``Filter→Scan`` (optionally under ``Project``) keeps its
shape, but the Scan is replaced by a ``FileScan`` over only the source files
whose sketches say they *might* contain matching rows.

Sketch semantics are three-valued: for every (file, conjunct) the evaluator
answers "maybe contains matches" (keep) or "definitely not" (prune);
anything it cannot reason about keeps the file — pruning must never change
query results.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from hyperspace_tpu_torch.analysis import reasons as R
from hyperspace_tpu_torch.indexes.dataskipping import (
    BloomFilterSketch,
    DataSkippingIndex,
    MinMaxSketch,
    PartitionSketch,
    Sketch,
    ValueListSketch,
)
from hyperspace_tpu_torch.models.log_entry import IndexLogEntry
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.plan.expr import BinaryOp, Col, Expr, In, Lit, Not
from hyperspace_tpu_torch.rules.context import RuleContext
from hyperspace_tpu_torch.rules.utils import destructure_linear

RULE_NAME = "DataSkippingIndexRule"
# ceiling of max(1, int(40 x pruned)) + 1 below (see score.py short-circuit)
MAX_SCORE = 41

_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}


def _null_mask(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == object:
        return np.array([x is None for x in arr], dtype=bool)
    if arr.dtype.kind == "f":
        return np.isnan(arr)
    if arr.dtype.kind == "M":
        return np.isnat(arr)
    return np.zeros(arr.shape, dtype=bool)


def _cmp(arr: np.ndarray, op: str, lit) -> np.ndarray:
    """Elementwise compare treating nulls as False (caller decides whether a
    null aggregate keeps the file)."""
    nulls = _null_mask(arr)
    if arr.dtype == object:
        safe = np.where(nulls, lit, arr)
    else:
        safe = arr
    with np.errstate(invalid="ignore"):
        if op == "=":
            res = safe == lit
        elif op == "!=":
            res = safe != lit
        elif op == "<":
            res = safe < lit
        elif op == "<=":
            res = safe <= lit
        elif op == ">":
            res = safe > lit
        else:
            res = safe >= lit
    return np.asarray(res, dtype=bool) & ~nulls


class _SketchEvaluator:
    """Evaluates a predicate tree to a per-file keep mask over the sketch
    table. Returns None wherever pruning is impossible (keep everything)."""

    def __init__(self, sketches: List[Sketch], table_cols: Dict[str, np.ndarray], n_rows: int):
        self.by_col: Dict[str, List[Sketch]] = {}
        for s in sketches:
            self.by_col.setdefault(s.expr.lower(), []).append(s)
        self.cols = table_cols
        self.n = n_rows

    # -- per-sketch primitives ---------------------------------------------
    def _minmax(self, s: MinMaxSketch, op: str, lit) -> Optional[np.ndarray]:
        mn_name, mx_name = s.output_names()
        mn, mx = self.cols[mn_name], self.cols[mx_name]
        all_null = _null_mask(mn) | _null_mask(mx)
        if op == "=":
            keep = _cmp(mn, "<=", lit) & _cmp(mx, ">=", lit)
        elif op == "<":
            keep = _cmp(mn, "<", lit)
        elif op == "<=":
            keep = _cmp(mn, "<=", lit)
        elif op == ">":
            keep = _cmp(mx, ">", lit)
        elif op == ">=":
            keep = _cmp(mx, ">=", lit)
        elif op == "!=":
            # prune only files where every row equals lit (min == max == lit)
            keep = ~(_cmp(mn, "=", lit) & _cmp(mx, "=", lit))
        else:
            return None
        return keep | all_null  # a file with a null aggregate is kept

    def _valuelist(self, s: ValueListSketch, op: str, lit) -> Optional[np.ndarray]:
        (vname,) = s.output_names()
        values = self.cols[vname]
        if op != "=":
            return None
        out = np.ones(self.n, dtype=bool)
        for i, vals in enumerate(values):
            if vals is None:
                continue  # overflowed list: keep
            out[i] = bool(_cmp(np.asarray(vals), "=", lit).any())
        return out

    def _bloom(self, s: BloomFilterSketch, op: str, lit) -> Optional[np.ndarray]:
        if op != "=":
            return None
        (bname,) = s.output_names()
        bits = self.cols[bname]
        out = np.ones(self.n, dtype=bool)
        for i, words in enumerate(bits):
            if words is None:
                continue
            out[i] = s.might_contain(words, lit)
        return out

    def _partition(self, s: PartitionSketch, op: str, lit) -> Optional[np.ndarray]:
        (pname,) = s.output_names()
        vals = self.cols[pname]
        nulls = _null_mask(vals)
        if op not in _FLIP:
            return None
        return _cmp(vals, op, lit) | nulls  # mixed-partition file (null) kept

    def _col_op_lit(self, col_name: str, op: str, lit) -> Optional[np.ndarray]:
        masks = []
        for s in self.by_col.get(col_name.lower(), []):
            # incomparable literal/column dtypes (e.g. float column vs string
            # literal) must mean "unprunable", never an exception escaping to
            # ApplyHyperspace and cancelling unrelated rewrites
            try:
                if isinstance(s, MinMaxSketch):
                    m = self._minmax(s, op, lit)
                elif isinstance(s, ValueListSketch):
                    m = self._valuelist(s, op, lit)
                elif isinstance(s, BloomFilterSketch):
                    m = self._bloom(s, op, lit)
                elif isinstance(s, PartitionSketch):
                    m = self._partition(s, op, lit)
                else:
                    m = None
            except Exception:
                m = None
            if m is not None:
                masks.append(m)
        if not masks:
            return None
        out = masks[0]
        for m in masks[1:]:
            out = out & m  # every sketch must say "maybe"
        return out

    # -- tree walk ----------------------------------------------------------
    def eval(self, e: Expr) -> Optional[np.ndarray]:
        if isinstance(e, BinaryOp) and e.op == "AND":
            l, r = self.eval(e.left), self.eval(e.right)
            if l is None:
                return r
            if r is None:
                return l
            return l & r
        if isinstance(e, BinaryOp) and e.op == "OR":
            l, r = self.eval(e.left), self.eval(e.right)
            if l is None or r is None:
                return None  # one side unprunable -> whole OR unprunable
            return l | r
        if isinstance(e, BinaryOp) and e.op in _FLIP:
            left, right, op = e.left, e.right, e.op
            if isinstance(right, Col) and isinstance(left, Lit):
                left, right, op = right, left, _FLIP[op]
            if isinstance(left, Col) and isinstance(right, Lit):
                return self._col_op_lit(left.name, op, right.value)
            return None
        if isinstance(e, In) and isinstance(e.child, Col):
            masks = [self._col_op_lit(e.child.name, "=", v.value) for v in e.values]
            if any(m is None for m in masks) or not masks:
                return None
            out = masks[0]
            for m in masks[1:]:
                out = out | m
            return out
        if isinstance(e, Not):
            inner = e.child
            # push negation through the comparisons we understand
            if isinstance(inner, BinaryOp) and inner.op in ("=", "!=", "<", "<=", ">", ">="):
                neg = {"=": "!=", "!=": "=", "<": ">=", "<=": ">", ">": "<=", ">=": "<"}
                return self.eval(BinaryOp(neg[inner.op], inner.left, inner.right))
            return None
        return None


def prune_files(
    entry: IndexLogEntry, condition: Expr, current_files
) -> Optional[Tuple[List[str], int, int]]:
    """Evaluate ``condition`` against ``entry``'s sketch table.

    Returns (surviving file names, surviving bytes, total bytes), or None when
    no pruning is possible. Files unknown to the sketch table (hybrid-scan
    appends) are always kept.
    """
    index = DataSkippingIndex.from_derived_dataset(entry.derived_dataset)
    # cheap pre-check before any I/O: some sketched column must appear in the
    # predicate at all
    pred_cols = {c.lower() for c in condition.references()}
    if not any(s.expr.lower() in pred_cols for s in index.sketches):
        return None
    table = index.read_sketch_table(entry)
    if table.num_rows == 0:
        return None
    cols: Dict[str, np.ndarray] = {}
    for name in table.column_names:
        col = table.column(name)
        try:
            cols[name] = col.to_numpy(zero_copy_only=False)
        except Exception:
            cols[name] = np.asarray(col.to_pylist(), dtype=object)

    ev = _SketchEvaluator(index.sketches, cols, table.num_rows)
    mask = ev.eval(condition)
    if mask is None:
        return None

    import hyperspace_tpu_torch.config as C

    fids = cols[C.DATA_FILE_NAME_ID].astype(np.int64)
    surviving_ids = set(fids[mask].tolist())
    indexed_by_key = {fi.key: fi.file_id for fi in entry.source_file_infos()}

    surviving: List[str] = []
    surviving_bytes = 0
    total_bytes = 0
    for fi in current_files:
        total_bytes += fi.size
        fid = indexed_by_key.get(fi.key)
        if fid is None or fid in surviving_ids:  # unknown (appended) -> keep
            surviving.append(fi.name)
            surviving_bytes += fi.size
    return surviving, surviving_bytes, total_bytes


def apply_data_skipping_rule(
    ctx: RuleContext,
    plan: L.LogicalPlan,
    candidates: Dict[int, Tuple[L.Scan, List[IndexLogEntry]]],
) -> Tuple[L.LogicalPlan, int]:
    """Try to prune the file set of a Filter→Scan sub-plan; returns
    (possibly-rewritten plan, score). Score = 40 x fraction of bytes pruned,
    deliberately below FilterIndexRule's 50 so a covering index wins when
    both apply (ref scoring scheme: HS/index/covering/FilterIndexRule.scala:170-193)."""
    parts = destructure_linear(plan)
    if parts is None:
        return plan, 0
    project_cols, condition, scan = parts
    if condition is None:
        return plan, 0
    key = L.plan_key(scan)
    if key not in candidates:
        return plan, 0
    _, entries = candidates[key]
    ds_entries = [e for e in entries if e.kind == DataSkippingIndex.kind]
    if not ds_entries:
        return plan, 0

    best: Optional[Tuple[IndexLogEntry, List[str], int, int]] = None
    for entry in ds_entries:
        # the optimizer visits both the Project and the Filter node of the
        # same sub-plan; cache per (scan, predicate, entry) so the sketch
        # table is read once per query
        cache_key = (key, id(condition), entry.name)
        if cache_key in ctx.scratch:
            pruned = ctx.scratch[cache_key]
        else:
            # missing/corrupt sketch data means "this entry can't prune" —
            # never an exception reaching ApplyHyperspace, which would cancel
            # unrelated rewrites for the whole query
            try:
                pruned = prune_files(entry, condition, scan.relation.all_file_infos())
            except Exception:
                pruned = None
            ctx.scratch[cache_key] = pruned
        if pruned is None:
            ctx.tag_reason_if_failed(
                False, entry, scan, lambda: R.index_not_eligible("predicate not prunable by sketches")
            )
            continue
        surviving, surviving_bytes, total_bytes = pruned
        if surviving_bytes >= total_bytes:
            ctx.tag_reason_if_failed(
                False, entry, scan, lambda: R.index_not_eligible("sketches pruned no files")
            )
            continue
        if best is None or surviving_bytes < best[2]:
            best = (entry, surviving, surviving_bytes, total_bytes)

    if best is None:
        return plan, 0
    entry, surviving, surviving_bytes, total_bytes = best
    ctx.tag_applicable_rule(entry, scan, RULE_NAME)

    required_out = project_cols if project_cols is not None else scan.output_columns
    needed = list(dict.fromkeys(list(required_out) + list(condition.references())))
    # resolve required names against the relation schema (case-insensitive)
    schema_names = {c.lower(): c for c in scan.output_columns}
    needed = [schema_names.get(c.lower(), c) for c in needed]

    rel = scan.relation
    pv = pd = None
    if getattr(rel, "partition_columns", None):
        pv = {f: rel.partition_values_for(f) for f in surviving}
        pd_ = getattr(rel, "partition_dtypes", None)
        pd = dict(pd_) if pd_ else None
    new_scan: L.LogicalPlan = L.FileScan(
        surviving,
        rel.physical_format,
        needed,
        via_index=entry.name,
        partition_values=pv,
        partition_dtypes=pd,
        format_options=getattr(rel, "options", None),
    )
    new_plan: L.LogicalPlan = L.Filter(condition, new_scan)
    if project_cols is not None:
        new_plan = L.Project(project_cols, new_plan)

    fraction_pruned = 1.0 - surviving_bytes / max(1, total_bytes)
    score = max(1, int(40 * fraction_pruned))
    # the optimizer keeps the NoOp-children path on score ties; the Project-
    # node rewrite must strictly beat the Filter-node rewrite it contains so
    # its column narrowing (read only predicate+projection columns) wins
    if project_cols is not None and len(needed) < len(scan.output_columns):
        score += 1
    return new_plan, score
