"""FilterIndexRule.

Replace Project→Filter→Scan (or Filter→Scan) over source files with a scan of
a covering index, when:
  - the first indexed column appears in the filter predicate, and
  - the index covers every column the sub-plan needs
(ref: HS/index/covering/FilterIndexRule.scala:34-194 — FilterPlanNodeFilter,
FilterColumnFilter, FilterRankFilter; score :170-193).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.models.log_entry import IndexLogEntry
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.analysis import reasons as R
from hyperspace_tpu_torch.plan.expr import contains_input_file_name, strip_nested_prefix
from hyperspace_tpu_torch.rules.context import RuleContext
from hyperspace_tpu_torch.rules.utils import (
    destructure_linear,
    hybrid_coverage_fraction,
    hybrid_thresholds_ok,
    transform_plan_to_use_index,
)

RULE_NAME = "FilterIndexRule"
# ceiling of the 50 x coverage score below (score.py's short-circuit)
MAX_SCORE = 50


def _filter_column_filter(
    ctx: RuleContext, scan: L.Scan, condition, required: List[str], candidates: List[IndexLogEntry]
) -> List[IndexLogEntry]:
    """(ref: FilterColumnFilter — first indexed col must appear in the
    predicate; index covers filter+project columns; under hybrid scan the
    drift thresholds hold at rule time too)."""
    out = []
    pred_cols = {strip_nested_prefix(c).lower() for c in condition.references()}
    for entry in candidates:
        if entry.kind != "CoveringIndex":
            continue
        props = entry.derived_dataset.properties
        indexed = [str(c) for c in props.get("indexedColumns", [])]
        included = [str(c) for c in props.get("includedColumns", [])]
        first_ok = bool(indexed) and strip_nested_prefix(indexed[0]).lower() in pred_cols
        if not ctx.tag_reason_if_failed(
            first_ok, entry, scan, lambda: R.no_first_indexed_col_cond(indexed[0] if indexed else "", pred_cols)
        ):
            continue
        covered = {strip_nested_prefix(c).lower() for c in indexed + included}
        covers = all(strip_nested_prefix(c).lower() in covered for c in required)
        if not ctx.tag_reason_if_failed(
            covers, entry, scan, lambda: R.missing_required_col(required, indexed + included)
        ):
            continue
        if hybrid_thresholds_ok(ctx, entry, scan):
            out.append(entry)
    return out


def _order_covers(entry: IndexLogEntry, required) -> bool:
    """Does the entry's within-bucket sort order (= its indexed columns)
    satisfy the query's ORDER BY requirement? Only all-ascending key lists
    that prefix the indexed columns qualify (plan/ordering's eligibility)."""
    if not required:
        return False
    if any(not asc for _, asc in required):
        return False
    props = entry.derived_dataset.properties
    indexed = [str(c).lower() for c in props.get("indexedColumns", [])]
    want = [str(c).lower() for c, _ in required]
    return indexed[: len(want)] == want


def _rank(ctx: RuleContext, scan: L.Scan, candidates: List[IndexLogEntry]) -> Optional[IndexLogEntry]:
    """FilterRankFilter: the smallest index; under hybrid scan, the most
    common bytes, ties broken toward the smaller index (ref:
    HS/index/covering/FilterIndexRanker.scala:43-63). Equal-size candidates
    tie-break toward one whose sort order covers the query's ORDER BY
    (stashed by ApplyHyperspace), then by name; order-awareness never
    overrides the size rank."""
    if not candidates:
        return None
    if ctx.session.conf.hybrid_scan_enabled:
        best = max(candidates, key=lambda e: (ctx.common_bytes(e, scan), -e.content.total_size))
    else:
        required = ctx.scratch.get("required_ordering")
        best = min(candidates, key=lambda e: (e.content.total_size, not _order_covers(e, required), e.name))
    if ctx.analysis_enabled:
        for e in candidates:
            if e is not best:
                ctx.tag_reason_if_failed(False, e, scan, lambda: R.another_index_applied(best.name))
    return best


def apply_filter_index_rule(
    ctx: RuleContext,
    plan: L.LogicalPlan,
    candidates: Dict[int, Tuple[L.Scan, List[IndexLogEntry]]],
) -> Tuple[L.LogicalPlan, int]:
    """Try to apply at ``plan``; returns (possibly-rewritten plan, score)."""
    parts = destructure_linear(plan)
    if parts is None:
        return plan, 0
    project_cols, condition, scan = parts
    if condition is None:
        return plan, 0  # FilterIndexRule requires a Filter node
    if contains_input_file_name(condition):
        return plan, 0  # rewrite would change input_file_name() semantics
    key = L.plan_key(scan)
    if key not in candidates:
        return plan, 0
    _, entries = candidates[key]
    required_out = project_cols if project_cols is not None else scan.output_columns
    required = list(dict.fromkeys(list(required_out) + list(condition.references())))

    best = _rank(ctx, scan, _filter_column_filter(ctx, scan, condition, required, entries))
    if best is None:
        return plan, 0
    ctx.tag_applicable_rule(best, scan, RULE_NAME)
    new_plan = transform_plan_to_use_index(ctx, best, plan, ctx.session.conf.use_bucket_spec)
    return new_plan, max(int(MAX_SCORE * hybrid_coverage_fraction(ctx, best, scan)), 1)
