"""ApplyHyperspace — the optimizer entry point.

Fetch ACTIVE indexes, collect per-scan candidates, run the score-based
rewrite; swallow all exceptions so index application can never break a query
(ref: HS/index/rules/ApplyHyperspace.scala:31-66) — except
``NotImplementedError``: a feature that is not in the port yet raises instead
of quietly planning the query another way. Recurses into uncorrelated
subquery expressions so indexes apply inside subqueries too (the reference
gets this for free from Catalyst walking the whole tree; explain golden
src/test/resources/expected/spark-2.4/subquery.txt).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from hyperspace_tpu_torch.models import states
from hyperspace_tpu_torch.obs import spans
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.plan.expr import BinaryOp, Expr, IsNull, Not, SubqueryExpr
from hyperspace_tpu_torch.plan.ordering import required_ordering
from hyperspace_tpu_torch.rules.candidate import collect_candidates
from hyperspace_tpu_torch.rules.context import RuleContext
from hyperspace_tpu_torch.rules.score import ScoreBasedIndexPlanOptimizer
from hyperspace_tpu_torch.rules.utils import prune_columns_duplicating
from hyperspace_tpu_torch.telemetry.events import HyperspaceIndexUsageEvent, emit_event

logger = logging.getLogger(__name__)


def iter_subquery_plans(plan: L.LogicalPlan):
    """Yield the inner plan of every subquery expression in ``plan``
    (recursively, including subqueries nested in subqueries)."""
    for node in L.collect(plan, lambda p: isinstance(p, L.Filter)):
        for sub in _collect_subqueries(node.condition):
            yield sub.plan
            yield from iter_subquery_plans(sub.plan)


def plans_including_subqueries(plan: L.LogicalPlan) -> List[L.LogicalPlan]:
    """``plan`` plus every subquery inner plan it carries — the single
    traversal helper every analysis over "the whole query" must use."""
    return [plan, *iter_subquery_plans(plan)]


def used_index_names(plan: L.LogicalPlan) -> List[str]:
    """Names of every index an (optimized) plan uses: covering-index scans
    plus data-skipping rewrites (FileScans tagged via_index), across the main
    plan and all subquery plans. Shared by explain and whyNot so the two
    reports can never disagree."""
    used = set()
    for p in plans_including_subqueries(plan):
        used |= {s.entry.name for s in L.collect(p, lambda x: isinstance(x, L.IndexScan))}
        used |= {s.via_index for s in L.collect(p, lambda x: isinstance(x, L.FileScan)) if s.via_index}
    return sorted(used)


def _collect_subqueries(e: Expr) -> List[SubqueryExpr]:
    out: List[SubqueryExpr] = []
    if isinstance(e, SubqueryExpr):
        out.append(e)
    for c in e.children():
        out.extend(_collect_subqueries(c))
    return out


def optimize_plan(plan: L.LogicalPlan, session, enabled: Optional[bool] = None) -> L.LogicalPlan:
    """The one optimizer entry point shared by ad-hoc execution
    (``DataFrame.optimized_plan``) and the serving plan cache: apply the
    hyperspace rewrite when the toggle (or the explicit ``enabled`` override
    captured at request-submit time) says so, else hand the plan back."""
    if enabled is None:
        enabled = session.hyperspace_enabled
    if not enabled:
        return plan
    with spans.span("optimize", cat="plan"):
        return ApplyHyperspace(session).apply(plan)


class ApplyHyperspace:
    def __init__(self, session, analysis_enabled: bool = False):
        self.session = session
        self.ctx = RuleContext(session, analysis_enabled)

    def apply(self, plan: L.LogicalPlan) -> L.LogicalPlan:
        try:
            new_plan, _score = self.apply_with_score(plan)
            return new_plan
        except NotImplementedError:
            raise
        except Exception:  # never break a query (ref: ApplyHyperspace.scala:59-63)
            logger.warning("Hyperspace rule application failed; falling back", exc_info=True)
            return plan

    def apply_with_score(self, plan: L.LogicalPlan):
        """The rewrite and its score; a rewrite that applies an index
        annotates the current span and emits one index-usage event."""
        new_plan, score = self._rewrite(plan)
        if score == 0:
            return plan, 0
        names = used_index_names(new_plan)
        summary = new_plan.describe()
        sp = spans.current_span()
        if sp is not None:
            sp.set(indexes=names, plan=summary, score=score)
        emit_event(
            self.session,
            HyperspaceIndexUsageEvent(index_names=names, plan_summary=summary),
        )
        return new_plan, score

    def _rewrite(self, plan: L.LogicalPlan) -> Tuple[L.LogicalPlan, int]:
        original = plan
        indexes = self.session.index_manager.get_indexes([states.ACTIVE])
        if not indexes:
            return original, 0
        # stash the query's outermost ORDER BY requirement for the rankers:
        # equal-size candidates tie-break toward an index whose sort order
        # covers it (plan/ordering.py)
        self.ctx.scratch["required_ordering"] = required_ordering(plan)
        plan, sub_score = self._rewrite_subqueries(plan)
        # normalize: push required columns down to the scans (Catalyst runs
        # ColumnPruning before the reference's rules; this IR does it here),
        # duplicating shared sub-plans: each join side must be an independent
        # linear sub-plan for the rules to match (a self-join's two sides
        # are one object before this)
        pruned = prune_columns_duplicating(plan)
        with spans.span("collect-candidates", cat="plan") as csp:
            candidates = collect_candidates(self.ctx, pruned, indexes)
            csp.set(candidates=sum(len(ents) for _, ents in candidates.values()))
        if candidates:
            with spans.span("rewrite", cat="plan"):
                new_plan, score = ScoreBasedIndexPlanOptimizer(self.ctx).apply(pruned, candidates)
        else:
            new_plan, score = plan, 0
        if score == 0 and sub_score == 0:
            # nothing rewritten: hand back the untouched user plan so explain
            # shows no spurious diff and execution shape is unchanged
            return original, 0
        return (new_plan if score > 0 else plan), score + sub_score

    # --- subquery recursion ------------------------------------------------
    def _rewrite_subqueries(self, plan: L.LogicalPlan) -> Tuple[L.LogicalPlan, int]:
        """Rebuild Filter conditions whose subquery expressions gain index
        rewrites. Expression and plan nodes are only copied along changed
        paths; untouched subtrees keep their identity."""
        total = 0

        def rewrite_expr(e: Expr) -> Expr:
            nonlocal total
            if isinstance(e, SubqueryExpr):
                new_inner_plan, score = self._rewrite(e.plan)
                new_e = e
                if score > 0:
                    total += score
                    new_e = e.with_plan(new_inner_plan)
                if hasattr(e, "child"):
                    new_child = rewrite_expr(e.child)
                    if new_child is not e.child:
                        if new_e is e:
                            new_e = e.with_plan(e.plan)
                        new_e.child = new_child
                return new_e
            if isinstance(e, BinaryOp):
                nl, nr = rewrite_expr(e.left), rewrite_expr(e.right)
                if nl is not e.left or nr is not e.right:
                    return BinaryOp(e.op, nl, nr)
                return e
            if isinstance(e, Not):
                nc = rewrite_expr(e.child)
                return Not(nc) if nc is not e.child else e
            if isinstance(e, IsNull):
                nc = rewrite_expr(e.child)
                return IsNull(nc) if nc is not e.child else e
            return e

        def walk(p: L.LogicalPlan) -> L.LogicalPlan:
            children = list(p.children())
            new_children = [walk(c) for c in children]
            q = p
            if any(nc is not c for nc, c in zip(new_children, children)):
                q = p.with_children(new_children)
            if isinstance(q, L.Filter):
                new_cond = rewrite_expr(q.condition)
                if new_cond is not q.condition:
                    q = L.Filter(new_cond, q.child)
            return q

        return walk(plan), total
