"""Score-based plan optimizer.

Memoized recursion: at each node, the best of (a) applying a rule to the whole
sub-tree rooted here, (b) keeping the node and optimizing children
independently (the NoOpRule path)
(ref: HS/index/rules/ScoreBasedIndexPlanOptimizer.scala:29-78; rules list =
FilterIndexRule :: JoinIndexRule :: NoOpRule, plus the data-skipping rule,
which the reference never registered).
"""

from __future__ import annotations

from typing import Dict, Tuple

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
# does — re-evaluating rules below such a top is pure overhead
_CHAIN_NODES = (L.Project, L.Filter)


class ScoreBasedIndexPlanOptimizer:
    def __init__(self, ctx: RuleContext):
        self.ctx = ctx
        self._memo: Dict[int, Tuple[L.LogicalPlan, int]] = {}

    def apply(self, plan: L.LogicalPlan, candidates) -> Tuple[L.LogicalPlan, int]:
        return self._rec(plan, candidates)

    def _rec(
        self, plan: L.LogicalPlan, candidates, in_chain: bool = False
    ) -> Tuple[L.LogicalPlan, int]:
        key = id(plan)
        if key in self._memo:
            return self._memo[key]

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

        if not in_chain:
            for rule, max_score in RULES:
                if max_score <= best_score:
                    continue  # cannot beat the current best (ties keep it)
                transformed, score = rule(self.ctx, plan, candidates)
                if score > best_score:
                    best_plan, best_score = transformed, score

        self._memo[key] = (best_plan, best_score)
        return best_plan, best_score
