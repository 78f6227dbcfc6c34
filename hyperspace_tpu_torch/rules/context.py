"""Per-optimization rule context: the session the rules read their conf from
(ref: HS/index/rules/IndexFilter.scala:25-110), and what candidate
collection learned about each (index, scan) pair under hybrid scan.

The reference tags index log entries with those facts; the port keeps them
here instead, made fresh for each optimization, because the index manager
caches entries across queries and a fact about one query's scan must not
outlive it. The whyNot analysis's reason tags wait for the port's whyNot.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.plan.logical import plan_key


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
    def __init__(self, session):
        self.session = session
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
