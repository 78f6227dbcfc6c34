"""Per-optimization rule context: the session the rules read their conf from,
the analysis mode with its reason tagging (ref:
HS/index/rules/IndexFilter.scala:25-110, JoinIndexRule.scala:632-636), and
what candidate collection learned about each (index, scan) pair under hybrid
scan.

The reference tags index log entries with the hybrid facts; the port keeps
them here instead, made fresh for each optimization, because the index
manager caches entries across queries and a fact about one query's scan must
not outlive it. The whyNot analysis's reason tags go on the entries, as in
the JAX package: ``analysis/why_not.py`` wipes them before and after each
run, and only an analysis run (``analysis_enabled``) writes them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.analysis import reasons as R
from hyperspace_tpu_torch.plan.logical import LogicalPlan, plan_key


@dataclass
class HybridFacts:
    """How an index's recorded source files compare with a scan's current
    files: ``required`` when they differ (hybrid scan serves the index);
    ``appended`` and ``deleted`` file names; ``common_bytes`` the indexed
    bytes still present (all of them on an exact signature match)."""

    required: bool
    common_bytes: int
    appended: List[str] = field(default_factory=list)
    deleted: List[str] = field(default_factory=list)


class RuleContext:
    def __init__(self, session, analysis_enabled: bool = False):
        self.session = session
        self.analysis_enabled = analysis_enabled
        # per-optimization memo space for rules (e.g. the data-skipping
        # rule's pruned file lists, keyed per scan, predicate and index)
        self.scratch: dict = {}
        # (index name, log id, plan key of the scan) -> HybridFacts
        self._hybrid: Dict[Tuple[str, int, int], HybridFacts] = {}

    @staticmethod
    def _key(entry, scan) -> Tuple[str, int, int]:
        return (str(entry.name), int(entry.id), plan_key(scan))

    def set_hybrid_facts(self, entry, scan, facts: HybridFacts) -> None:
        self._hybrid[self._key(entry, scan)] = facts

    def hybrid_facts(self, entry, scan) -> Optional[HybridFacts]:
        return self._hybrid.get(self._key(entry, scan))

    def hybrid_required(self, entry, scan) -> bool:
        facts = self.hybrid_facts(entry, scan)
        return facts is not None and facts.required

    def common_bytes(self, entry, scan) -> int:
        facts = self.hybrid_facts(entry, scan)
        return facts.common_bytes if facts is not None else 0

    def tag_reason_if_failed(self, passed: bool, entry, plan: LogicalPlan, reason_fn) -> bool:
        """``withFilterReasonTag`` (ref: IndexFilter.scala:36-109): when
        analysis is on and the check failed, append the reason to the entry's
        FILTER_REASONS tag for this (sub)plan."""
        if not passed and self.analysis_enabled:
            key = plan_key(plan)
            existing = entry.get_tag(key, R.FILTER_REASONS) or []
            existing.append(reason_fn())
            entry.set_tag(key, R.FILTER_REASONS, existing)
        return passed

    def tag_applicable_rule(self, entry, plan: LogicalPlan, rule_name: str) -> None:
        if self.analysis_enabled:
            key = plan_key(plan)
            existing = entry.get_tag(key, R.APPLICABLE_INDEX_RULES) or []
            if rule_name not in existing:
                existing.append(rule_name)
            entry.set_tag(key, R.APPLICABLE_INDEX_RULES, existing)
