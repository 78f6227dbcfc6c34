"""ApplyHyperspace — the optimizer entry point.

Fetch ACTIVE indexes, collect per-scan candidates, run the score-based
rewrite; swallow all exceptions so index application can never break a query
(ref: HS/index/rules/ApplyHyperspace.scala:31-66) — except
``NotImplementedError``: a feature that is not in the port yet raises instead
of quietly planning the query another way.
"""

from __future__ import annotations

import logging
from typing import Tuple

from hyperspace_tpu_torch.models import states
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.rules.candidate import collect_candidates
from hyperspace_tpu_torch.rules.context import RuleContext
from hyperspace_tpu_torch.rules.score import ScoreBasedIndexPlanOptimizer
from hyperspace_tpu_torch.rules.utils import prune_columns_duplicating

logger = logging.getLogger(__name__)


def optimize_plan(plan: L.LogicalPlan, session) -> L.LogicalPlan:
    """Apply the hyperspace rewrite when the session's toggle says so, else
    hand the plan back."""
    if not session.hyperspace_enabled:
        return plan
    return ApplyHyperspace(session).apply(plan)


class ApplyHyperspace:
    def __init__(self, session):
        self.session = session
        self.ctx = RuleContext(session)

    def apply(self, plan: L.LogicalPlan) -> L.LogicalPlan:
        try:
            new_plan, _score = self._rewrite(plan)
            return new_plan
        except NotImplementedError:
            raise
        except Exception:  # never break a query (ref: ApplyHyperspace.scala:59-63)
            logger.warning("Hyperspace rule application failed; falling back", exc_info=True)
            return plan

    def _rewrite(self, plan: L.LogicalPlan) -> Tuple[L.LogicalPlan, int]:
        indexes = self.session.index_manager.get_indexes([states.ACTIVE])
        if not indexes:
            return plan, 0
        # normalize: push required columns down to the scans (Catalyst runs
        # ColumnPruning before the reference's rules; this IR does it here),
        # duplicating shared sub-plans: each join side must be an independent
        # linear sub-plan for the rules to match (a self-join's two sides
        # are one object before this)
        pruned = prune_columns_duplicating(plan)
        candidates = collect_candidates(self.ctx, pruned, indexes)
        if not candidates:
            return plan, 0
        new_plan, score = ScoreBasedIndexPlanOptimizer(self.ctx).apply(pruned, candidates)
        # nothing rewritten: hand back the untouched user plan so explain
        # shows no spurious diff and execution shape is unchanged
        return (new_plan, score) if score > 0 else (plan, 0)
