"""JoinIndexRule.

Replace both sides of an equi-join with compatible covering indexes so the
join executes with NO shuffle: both sides are pre-bucketed and pre-sorted on
the join keys, bucket i of the left lives with bucket i of the right
(ref: HS/index/covering/JoinIndexRule.scala:45-705).

Eligibility pipeline (mirrors the reference's filter chain):
  JoinPlanNodeFilter   — equi-join, CNF of col=col, linear children (:135-155)
  JoinAttributeFilter  — one-to-one left/right attribute mapping (:247-286)
  JoinColumnFilter     — per side: indexed cols == join cols, index covers all
                         required cols (:419-448)
  JoinRankFilter       — compatible (same key order) pairs; prefer equal
                         bucket counts, then more buckets (:554-601;
                         JoinIndexRanker.scala:52-92)

Score: 70 per side, scaled by hybrid coverage (:674-704).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.models.log_entry import IndexLogEntry
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.analysis import reasons as R
from hyperspace_tpu_torch.plan.expr import (
    column_root_member,
    contains_input_file_name,
    extract_equi_join_keys,
    strip_nested_prefix,
)
from hyperspace_tpu_torch.rules.context import RuleContext
from hyperspace_tpu_torch.rules.utils import (
    destructure_linear,
    hybrid_coverage_fraction,
    hybrid_thresholds_ok,
    transform_plan_to_use_index,
)

RULE_NAME = "JoinIndexRule"
# ceiling of the 70+70 coverage score below — the optimizer short-circuits
# rules that cannot beat the current best, keyed on this constant
MAX_SCORE = 140


def _attribute_mapping(
    pairs: List[Tuple[str, str]], left_cols: List[str], right_cols: List[str]
) -> Optional[Dict[str, str]]:
    """One-to-one mapping of left join cols -> right join cols
    (ref: JoinAttributeFilter :247-286). A dotted nested key belongs to the
    side whose output has its root struct column."""
    mapping: Dict[str, str] = {}
    reverse: Dict[str, str] = {}
    for a, b in pairs:
        al, br = column_root_member(a, left_cols), column_root_member(b, right_cols)
        if al is not None and br is not None:
            l, r = al, br
        else:
            bl, ar = column_root_member(b, left_cols), column_root_member(a, right_cols)
            if bl is None or ar is None:
                return None
            l, r = bl, ar
        if mapping.get(l, r) != r or reverse.get(r, l) != l:
            return None  # not one-to-one
        mapping[l] = r
        reverse[r] = l
    return mapping


def _side_candidates(
    ctx: RuleContext,
    side: str,
    scan: L.Scan,
    join_cols: List[str],
    required: List[str],
    entries: List[IndexLogEntry],
) -> List[IndexLogEntry]:
    """JoinColumnFilter (ref: :419-448): the indexed columns are exactly the
    join columns, the index covers every column the side needs, and under
    hybrid scan the drift thresholds hold at rule time too."""
    out = []
    join_set = {strip_nested_prefix(c).lower() for c in join_cols}
    for entry in entries:
        if entry.kind != "CoveringIndex":
            continue
        props = entry.derived_dataset.properties
        indexed = [str(c) for c in props.get("indexedColumns", [])]
        included = [str(c) for c in props.get("includedColumns", [])]
        exact = {strip_nested_prefix(c).lower() for c in indexed} == join_set
        if not ctx.tag_reason_if_failed(
            exact, entry, scan, lambda: R.not_all_join_cols_indexed(side, join_cols, indexed)
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


def _compatible(l_entry: IndexLogEntry, r_entry: IndexLogEntry, mapping: Dict[str, str]) -> bool:
    """Same column order under the attribute mapping (ref: :554-601)."""
    l_indexed = [str(c) for c in l_entry.derived_dataset.properties.get("indexedColumns", [])]
    r_indexed = [str(c) for c in r_entry.derived_dataset.properties.get("indexedColumns", [])]
    if len(l_indexed) != len(r_indexed):
        return False
    lowered = {k.lower(): v.lower() for k, v in mapping.items()}
    return all(
        lowered.get(strip_nested_prefix(lc).lower()) == strip_nested_prefix(rc).lower()
        for lc, rc in zip(l_indexed, r_indexed)
    )


def _rank_pairs(
    ctx: RuleContext,
    pairs: List[Tuple[IndexLogEntry, IndexLogEntry]],
    l_scan: L.Scan,
    r_scan: L.Scan,
) -> Optional[Tuple[IndexLogEntry, IndexLogEntry]]:
    """JoinIndexRanker: equal bucket counts first, then common bytes under
    hybrid scan, then more buckets (ref: JoinIndexRanker.scala:52-92)."""
    if not pairs:
        return None

    def nb(e: IndexLogEntry) -> int:
        return int(e.derived_dataset.properties.get("numBuckets", 0))

    hybrid = ctx.session.conf.hybrid_scan_enabled

    def sort_key(p):
        l, r = p
        common = ctx.common_bytes(l, l_scan) + ctx.common_bytes(r, r_scan) if hybrid else 0
        return (nb(l) == nb(r), common, nb(l) + nb(r))

    return max(pairs, key=sort_key)


def apply_join_index_rule(
    ctx: RuleContext,
    plan: L.LogicalPlan,
    candidates: Dict[int, Tuple[L.Scan, List[IndexLogEntry]]],
) -> Tuple[L.LogicalPlan, int]:
    # any equi-join type qualifies — index substitution on the scan sides is
    # join-type-agnostic (ref: JoinPlanNodeFilter matches JoinWithoutHint with
    # a wildcard joinType, JoinIndexRule.scala:52-54)
    if not isinstance(plan, L.Join) or plan.how not in ("inner", "left", "right", "outer"):
        return plan, 0
    if plan.residual is not None:
        # non-equi ON residual: outside the rule's equi-CNF scope
        # (ref: JoinPlanNodeFilter, JoinIndexRule.scala:149-155)
        return plan, 0
    pairs = extract_equi_join_keys(plan.condition)
    if not pairs:
        return plan, 0
    l_parts = destructure_linear(plan.left)
    r_parts = destructure_linear(plan.right)
    if l_parts is None or r_parts is None:
        return plan, 0
    l_proj, l_cond, l_scan = l_parts
    r_proj, r_cond, r_scan = r_parts
    if (l_cond is not None and contains_input_file_name(l_cond)) or (
        r_cond is not None and contains_input_file_name(r_cond)
    ):
        return plan, 0  # rewrite would change input_file_name() semantics
    lk, rk = L.plan_key(l_scan), L.plan_key(r_scan)
    if lk not in candidates or rk not in candidates:
        return plan, 0

    mapping = _attribute_mapping(pairs, l_scan.output_columns, r_scan.output_columns)
    if mapping is None:
        return plan, 0

    def required_cols(proj, cond, scan, join_cols):
        req = list(proj) if proj is not None else list(scan.output_columns)
        if cond is not None:
            req += list(cond.references())
        req += join_cols
        return list(dict.fromkeys(req))

    l_join_cols = list(mapping.keys())
    r_join_cols = list(mapping.values())
    l_required = required_cols(l_proj, l_cond, l_scan, l_join_cols)
    r_required = required_cols(r_proj, r_cond, r_scan, r_join_cols)
    l_entries = _side_candidates(ctx, "left", l_scan, l_join_cols, l_required, candidates[lk][1])
    r_entries = _side_candidates(ctx, "right", r_scan, r_join_cols, r_required, candidates[rk][1])

    # candidate lists are per-scan (signature-matched), so an entry appearing
    # on both sides implies a self-join — no extra identity check needed
    compatible = [(le, re) for le in l_entries for re in r_entries if _compatible(le, re, mapping)]
    best = _rank_pairs(ctx, compatible, l_scan, r_scan)
    if best is None:
        for e in l_entries:
            ctx.tag_reason_if_failed(False, e, l_scan, lambda: R.no_avail_join_index_pair("left"))
        for e in r_entries:
            ctx.tag_reason_if_failed(False, e, r_scan, lambda: R.no_avail_join_index_pair("right"))
        return plan, 0
    l_best, r_best = best
    ctx.tag_applicable_rule(l_best, l_scan, RULE_NAME)
    ctx.tag_applicable_rule(r_best, r_scan, RULE_NAME)
    new_left = transform_plan_to_use_index(ctx, l_best, plan.left, use_bucket_spec=True)
    new_right = transform_plan_to_use_index(ctx, r_best, plan.right, use_bucket_spec=True)
    new_plan = L.Join(new_left, new_right, plan.condition, plan.how, plan.residual, plan.using_pairs)
    score = int(70 * hybrid_coverage_fraction(ctx, l_best, l_scan) + 70 * hybrid_coverage_fraction(ctx, r_best, r_scan))
    return new_plan, max(score, 1)
