"""Per-optimization rule context: the session the rules read their conf from
(ref: HS/index/rules/IndexFilter.scala:25-110). The reference's whyNot
analysis also tags each index with the reasons it was passed over; that
mode and its tags wait for the port's whyNot.
"""

from __future__ import annotations


class RuleContext:
    def __init__(self, session):
        self.session = session
        # per-optimization memo space for rules (e.g. the data-skipping
        # rule's pruned file lists, keyed per scan, predicate and index)
        self.scratch: dict = {}
