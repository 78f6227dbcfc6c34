"""Micro-batching: coalesce compatible filter-scan requests into one scan.

Requests sharing a parameterized template whose shape is a linear
Project/Filter chain over one scan leaf (Scan / FileScan / IndexScan — the
canonical index-filter-scan shape) execute as ONE batch: the leaf is decoded
once, then each request applies its own bound predicates as masks over the
shared in-memory batch. N concurrent point-lookups against the same covering
index cost one bucket decode instead of N.

Requests that don't fit the shape (joins, aggregates, subqueries,
``input_file_name()`` predicates) simply execute individually — batching is
an optimization, never a semantic gate.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from hyperspace_tpu_torch.exec import batch as B
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.plan.expr import as_bool_mask


def shared_scan_ops(template: L.LogicalPlan) -> Optional[Tuple[List[tuple], L.LogicalPlan]]:
    """Decompose ``template`` into (root->leaf op list, scan leaf) when it is
    a batchable linear chain with at least one Filter; None otherwise.

    One ``Aggregate`` may cap the chain (only Projects above it): grouped
    dashboard queries against the same covering index then share the scan
    decode and aggregate their own masked rows afterwards — via the device
    grouped-aggregation engine when it applies. A Filter above the Aggregate
    (HAVING) would mask aggregated rows with conditions the per-chunk walk
    below the aggregate cannot evaluate, so that shape stays unbatched."""
    ops: List[tuple] = []
    p = template
    n_filters = 0
    seen_agg = False
    # a root ORDER BY ... LIMIT cap batches too: the shared scan decodes
    # once, each request top-k's its own masked rows afterwards
    if isinstance(p, L.Limit) and isinstance(p.child, L.Sort) and p.child.keys:
        ops.append(("topk", (int(p.n), [(str(c), bool(a)) for c, a in p.child.keys])))
        p = p.child.child
    while True:
        if isinstance(p, (L.Scan, L.FileScan, L.IndexScan)):
            if n_filters == 0:
                return None  # nothing literal-varying to share
            return ops, p
        if isinstance(p, L.Project):
            ops.append(("project", list(p.columns)))
            p = p.child
        elif isinstance(p, L.Filter):
            ops.append(("filter", None))
            n_filters += 1
            p = p.child
        elif isinstance(p, L.Aggregate) and not seen_agg and n_filters == 0:
            ops.append(("aggregate", (list(p.keys), list(p.aggs))))
            seen_agg = True
            p = p.child
        else:
            return None


def _bound_conditions(bound_plan: L.LogicalPlan) -> List:
    """Filter conditions of a bound chain, root->leaf order (mirrors the op
    list from ``shared_scan_ops``)."""
    out = []
    p = bound_plan
    while not isinstance(p, (L.Scan, L.FileScan, L.IndexScan)):
        if isinstance(p, L.Filter):
            out.append(p.condition)
        p = p.child
    return out


def execute_shared_scan(
    session,
    ops: List[tuple],
    leaf: L.LogicalPlan,
    bound_plans: List[L.LogicalPlan],
) -> List[B.Batch]:
    """One streamed leaf decode, then per-request mask/project over each
    shared chunk. Returns one result batch per bound plan, in order.

    The leaf streams through ``execute_stream`` (so multi-chunk leaves ride
    the prefetch pipeline: chunk k+1 decodes while chunk k's request masks
    evaluate); every op below an Aggregate is row-wise, so per-chunk
    application followed by concatenation is exactly the materialized
    result. An Aggregate op (and any Projects above it) applies once per
    request over its concatenated masked rows, dispatching through
    ``aggregate_batch`` so grouped shapes hit the device segment-reduction
    engine."""
    from hyperspace_tpu_torch.exec.executor import Executor, aggregate_batch

    topk = None
    if ops and ops[0][0] == "topk":
        topk, ops = ops[0][1], ops[1:]
    split = next((i for i, (kind, _) in enumerate(ops) if kind == "aggregate"), None)
    above = ops[:split] if split is not None else []
    agg = ops[split][1] if split is not None else None
    below = ops[split + 1:] if split is not None else ops

    per_request_conds = [_bound_conditions(bound) for bound in bound_plans]
    pieces: List[List[B.Batch]] = [[] for _ in bound_plans]
    for base in Executor(session).execute_stream(leaf):
        for r, conds in enumerate(per_request_conds):
            ci = len(conds)
            batch = base
            for kind, payload in reversed(below):  # leaf -> root
                if kind == "filter":
                    ci -= 1
                    batch = B.mask_rows(batch, as_bool_mask(conds[ci].eval(batch)))
                else:
                    batch = B.select(batch, payload)
            pieces[r].append(batch)
    results = [ps[0] if len(ps) == 1 else B.concat(ps) for ps in pieces]
    if agg is not None:
        keys, aggs = agg
        out = []
        for batch in results:
            batch = aggregate_batch(session, keys, aggs, batch)
            for kind, payload in reversed(above):  # projects over the result
                batch = B.select(batch, payload)
            out.append(batch)
        results = out
    if topk is not None:
        n, keys = topk
        results = [_topk_batch(b, keys, n) for b in results]
    return results


def _topk_batch(batch: B.Batch, keys: List[tuple], n: int) -> B.Batch:
    """Host ORDER BY + LIMIT over one request's (already masked, in-memory)
    batch — the same stable composite order as the executor's Sort node."""
    import numpy as np

    from hyperspace_tpu_torch.exec.executor import _key_codes
    from hyperspace_tpu_torch.plan.expr import get_column

    order = np.arange(B.num_rows(batch))
    for name, asc in reversed(keys):
        arr = get_column(batch, name)
        if arr is None:
            raise KeyError(f"Sort key {name!r} not found")
        codes = _key_codes(np.asarray(arr)[order], asc)
        order = order[np.argsort(codes, kind="stable")]
    take = order[:n]
    return {c: np.asarray(v)[take] for c, v in batch.items()}
