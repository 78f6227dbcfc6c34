"""Order-propagation analysis: when does stored sortedness satisfy a Sort?

Covering indexes are written bucketed AND sorted by the indexed columns
within each bucket (plan/logical.BucketSpec.sort_columns, the layout the
fused build program in ops/sort.py produces) — order the executor used to
recompute from scratch with a full host sort. This module is the planner
half of sort elimination: decide whether a ``Sort``'s requirement is
satisfied by the within-bucket order of the ``IndexScan`` underneath it, so
the executor can replace the O(n log n) sort with a streamed k-way merge of
already-sorted per-file runs (exec/executor._merge_sorted_runs).

Eligibility is deliberately strict; every rejection returns a *reason*
string that flows into dispatch traces and the QueryProfile why-not report
(analysis/why_not.py), mirroring the index-selection reason machinery.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from hyperspace_tpu_torch.plan import logical as L

#: chain nodes that neither reorder rows nor rebind the sort-key columns
_ORDER_PRESERVING = (L.Filter, L.Project)


def _order_chain(plan: L.LogicalPlan):
    """Walk Filter/Project/Compute/Rename down to the scan (the ordering
    analog of executor._chain_to_scan; Compute/Rename are collected so the
    eligibility check can *name* them in its reason instead of silently
    missing the scan)."""
    chain: List[L.LogicalPlan] = []
    node = plan
    while isinstance(node, (L.Filter, L.Project, L.Compute, L.Rename)):
        chain.append(node)
        node = node.child
    return chain, node


def index_sort_order(leaf: L.LogicalPlan) -> List[Tuple[str, bool]]:
    """The within-bucket physical ordering an IndexScan's files carry:
    ascending over ``bucket_spec.sort_columns``, or [] when unknown.

    A plan-level ``bucket_spec`` is only attached under ``useBucketSpec``
    (it gates bucket *pruning*), but the data files are written sorted either
    way — so fall back to the log entry's own spec. Sortedness is advisory
    here regardless: the executor verifies every run and stable-repairs
    disagreement, so a wrong answer is impossible, only a slower merge."""
    if not isinstance(leaf, L.IndexScan):
        return []
    spec = getattr(leaf, "bucket_spec", None)
    if spec is None and getattr(leaf, "entry", None) is not None:
        try:
            from hyperspace_tpu_torch.indexes.covering import CoveringIndex

            spec = CoveringIndex.from_derived_dataset(leaf.entry.derived_dataset).bucket_spec()
        except Exception:
            spec = None
    if spec is not None and spec.sort_columns:
        return [(str(c), True) for c in spec.sort_columns]
    return []


def required_ordering(plan: L.LogicalPlan) -> Optional[List[Tuple[str, bool]]]:
    """The outermost Sort requirement visible through Limit/Project wrappers
    — what the index ranker (rules/filter_rule._rank) can use as a
    tie-break toward order-covering candidates."""
    node = plan
    while isinstance(node, (L.Limit, L.Project)):
        node = node.child
    if isinstance(node, L.Sort) and node.keys:
        return [(str(c), bool(a)) for c, a in node.keys]
    return None


def sort_run_eligibility(sort_plan: L.Sort):
    """Can ``sort_plan`` be satisfied by merging the index's sorted runs?

    Returns ``(leaf, chain, None)`` on success, ``(None, None, reason)``
    when an index-backed chain exists but its order doesn't cover the sort,
    and ``(None, None, None)`` when the child isn't index-backed at all
    (nothing to explain — raw file scans carry no order)."""
    chain, leaf = _order_chain(sort_plan.child)
    if not isinstance(leaf, L.IndexScan):
        return None, None, None
    order = index_sort_order(leaf)
    if not order:
        return None, None, "index scan carries no within-bucket sort order"
    offenders = [type(nd).__name__ for nd in chain if not isinstance(nd, _ORDER_PRESERVING)]
    if offenders:
        return None, None, (
            f"{'/'.join(sorted(set(offenders)))} between Sort and the scan may rebind the key columns"
        )
    keys = [(str(c), bool(a)) for c, a in sort_plan.keys]
    if not keys:
        return None, None, "Sort has no keys"
    desc = [c for c, a in keys if not a]
    if desc:
        return None, None, (
            f"descending key(s) {desc} cannot ride the ascending index order"
        )
    want = [c.lower() for c, _ in keys]
    have = [c.lower() for c, _ in order]
    if want != have[: len(want)]:
        return None, None, (
            f"sort keys {want} are not a prefix of the index sort order {have}"
        )
    return leaf, chain, None
