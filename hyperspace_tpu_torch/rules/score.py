"""Score-based plan optimizer.

Memoized recursion: at each node, the best of (a) applying a rule to the whole
sub-tree rooted here, (b) keeping the node and optimizing children
independently (the NoOpRule path)
(ref: HS/index/rules/ScoreBasedIndexPlanOptimizer.scala:29-78; rules list =
FilterIndexRule :: JoinIndexRule :: NoOpRule, plus the data-skipping rule,
which the reference never registered).
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

from hyperspace_tpu_torch.obs import spans
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.rules import dataskipping_rule as _ds
from hyperspace_tpu_torch.rules import filter_rule as _fr
from hyperspace_tpu_torch.rules import join_rule as _jr
from hyperspace_tpu_torch.rules.context import RuleContext
from hyperspace_tpu_torch.rules.dataskipping_rule import apply_data_skipping_rule
from hyperspace_tpu_torch.rules.filter_rule import apply_filter_index_rule
from hyperspace_tpu_torch.rules.join_rule import apply_join_index_rule
from hyperspace_tpu_torch.rules.utils import destructure_linear

# (rule, its maximum possible score) — tried highest-max first so the
# beaten-rule short-circuit bites as early as possible
RULES = (
    (apply_join_index_rule, _jr.MAX_SCORE),
    (apply_filter_index_rule, _fr.MAX_SCORE),
    (apply_data_skipping_rule, _ds.MAX_SCORE),
)

# linear-chain nodes: when the chain TOP destructures, a rule applied there
# requires a subset of the columns any lower application would (and sees a
# superset of the filter conjuncts), so it succeeds whenever a lower one
# does — re-evaluating rules below such a top is pure overhead. When the top
# does NOT destructure (e.g. a filter over a computed column pins the
# chain), interior nodes stay eligible.
_CHAIN_NODES = (L.Project, L.Filter, L.Compute)


class ScoreBasedIndexPlanOptimizer:
    def __init__(self, ctx: RuleContext):
        self.ctx = ctx
        self._memo: Dict[int, Tuple[L.LogicalPlan, int]] = {}
        self._multi_parent: set = set()
        # accumulated wall seconds per rule across the whole recursion (a
        # span per rule per node would explode the trace, so the tracer gets
        # one aggregate attribute, QueryProfile.rule_timings)
        self._rule_seconds: Dict[str, float] = {}

    def apply(self, plan: L.LogicalPlan, candidates) -> Tuple[L.LogicalPlan, int]:
        counts: Dict[int, int] = {}

        def walk(p: L.LogicalPlan) -> None:
            c = counts.get(id(p), 0) + 1
            counts[id(p)] = c
            if c == 1:
                for ch in p.children():
                    walk(ch)

        walk(plan)
        # a sub-plan with several parents (a CTE referenced N times) always
        # gets the full rule set and ONE memo entry, so the rewritten tree
        # keeps sharing a single object (the executor's shared-subplan memo
        # depends on that identity)
        self._multi_parent = {pid for pid, c in counts.items() if c > 1}
        result = self._rec(plan, candidates)
        sp = spans.current_span()
        if sp is not None and self._rule_seconds:
            sp.set(rule_timings=dict(self._rule_seconds))
        return result

    def _rec(
        self, plan: L.LogicalPlan, candidates, in_chain: bool = False
    ) -> Tuple[L.LogicalPlan, int]:
        if id(plan) in self._multi_parent:
            in_chain = False
        key = id(plan)
        if key in self._memo:
            return self._memo[key]

        # exhaustive mode for whyNot: every rule must run at every node so
        # the per-index disqualification reasons get collected
        analysis = self.ctx.analysis_enabled
        chain_top = isinstance(plan, _CHAIN_NODES) and destructure_linear(plan) is not None

        # NoOp path: optimize children independently (score = sum)
        children = list(plan.children())
        best_plan, best_score = plan, 0
        if children:
            child_in_chain = chain_top and len(children) == 1
            new_children = []
            child_score = 0
            for c in children:
                nc, s = self._rec(c, candidates, in_chain=child_in_chain)
                new_children.append(nc)
                child_score += s
            if child_score > 0:
                best_plan, best_score = plan.with_children(new_children), child_score

        if analysis or not in_chain:
            timing = spans.current_span() is not None
            for rule, max_score in RULES:
                if max_score <= best_score and not analysis:
                    continue  # cannot beat the current best (ties keep it)
                if timing:
                    t0 = time.perf_counter()
                    transformed, score = rule(self.ctx, plan, candidates)
                    name = rule.__name__
                    self._rule_seconds[name] = self._rule_seconds.get(name, 0.0) + (time.perf_counter() - t0)
                else:
                    transformed, score = rule(self.ctx, plan, candidates)
                if score > best_score:
                    best_plan, best_score = transformed, score

        self._memo[key] = (best_plan, best_score)
        return best_plan, best_score
