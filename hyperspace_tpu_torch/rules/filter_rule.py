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
from hyperspace_tpu_torch.plan.expr import contains_input_file_name, strip_nested_prefix
from hyperspace_tpu_torch.rules.context import RuleContext
from hyperspace_tpu_torch.rules.utils import (
    destructure_linear,
    hybrid_coverage_fraction,
    hybrid_thresholds_ok,
    transform_plan_to_use_index,
)

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
        if not indexed or strip_nested_prefix(indexed[0]).lower() not in pred_cols:
            continue
        covered = {strip_nested_prefix(c).lower() for c in indexed + included}
        if not all(strip_nested_prefix(c).lower() in covered for c in required):
            continue
        if hybrid_thresholds_ok(ctx, entry, scan):
            out.append(entry)
    return out


def _rank(ctx: RuleContext, scan: L.Scan, candidates: List[IndexLogEntry]) -> Optional[IndexLogEntry]:
    """FilterRankFilter: the smallest index, ties broken by name; under
    hybrid scan, the most common bytes, ties broken toward the smaller
    index (ref: HS/index/covering/FilterIndexRanker.scala:43-63). The JAX
    package's ORDER BY tie-break waits for the Sort node."""
    if not candidates:
        return None
    if ctx.session.conf.hybrid_scan_enabled:
        return max(candidates, key=lambda e: (ctx.common_bytes(e, scan), -e.content.total_size))
    return min(candidates, key=lambda e: (e.content.total_size, e.name))


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
    new_plan = transform_plan_to_use_index(ctx, best, plan, ctx.session.conf.use_bucket_spec)
    return new_plan, max(int(MAX_SCORE * hybrid_coverage_fraction(ctx, best, scan)), 1)
