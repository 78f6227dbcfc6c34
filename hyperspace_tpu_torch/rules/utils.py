"""Plan-transformation utilities of the covering-index rules
(ref: HS/index/covering/CoveringIndexRuleUtils.scala:55-288).

Two rewrite shapes:

  1. index-only scan — swap the source Scan for an IndexScan over the
     index's bucket files, optionally bucket-pruned (ref: :98-130);
  2. hybrid scan — index data + appended source files re-bucketed on the
     fly, merged with BucketUnion; rows from deleted source files are
     filtered out through the lineage column (ref: :146-288).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from hyperspace_tpu_torch import config as C
from hyperspace_tpu_torch.indexes.covering import BUCKET_HASH_VERSION, CoveringIndex, bucket_of_file
from hyperspace_tpu_torch.models.log_entry import IndexLogEntry
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.plan.expr import (
    Col,
    Expr,
    In,
    Lit,
    Not,
    column_root_member,
    extract_eq_literal,
    split_conjunctive,
    strip_nested_prefix,
)
from hyperspace_tpu_torch.rules.context import RuleContext


def destructure_linear(plan: L.LogicalPlan) -> Optional[Tuple[Optional[List[str]], Optional[Expr], L.Scan]]:
    """Match any interleaving of Project / Filter nodes over a Scan; return
    (project_cols, condition, scan) — project_cols is the *outermost*
    projection (the sub-plan's output), condition the AND of all filters
    (the only sub-plan shape the rules accept;
    ref: FilterPlanNodeFilter / JoinPlanNodeFilter linearity checks; column
    pruning may stack an extra Project directly above the Scan)."""
    project_cols = None
    condition = None
    node = plan
    while True:
        if isinstance(node, L.Project):
            if project_cols is None:
                project_cols = list(node.columns)
            node = node.child
        elif isinstance(node, L.Filter):
            condition = node.condition if condition is None else condition & node.condition
            node = node.child
        elif isinstance(node, L.Scan):
            return project_cols, condition, node
        else:
            return None


def hybrid_thresholds_ok(ctx: RuleContext, entry: IndexLogEntry, scan: L.Scan) -> bool:
    """Rule-time re-check of the hybrid-scan drift thresholds
    (``hyperspace.index.hybridscan.maxDeletedRatio`` / ``maxAppendedRatio``)
    against the current file diff and the current conf, with the same
    denominators as candidate collection (``candidate._signature_filter``)."""
    conf = ctx.session.conf
    if not ctx.hybrid_required(entry, scan):
        return True  # exact signature match: no drift to gate
    current = {fi.key: fi for fi in scan.relation.all_file_infos()}
    indexed = {fi.key: fi for fi in entry.source_file_infos()}
    appended_bytes = sum(current[k].size for k in current.keys() - indexed.keys())
    deleted_bytes = sum(indexed[k].size for k in indexed.keys() - current.keys())
    if deleted_bytes:
        deleted_ratio = deleted_bytes / max(1, entry.source_files_size())
        if deleted_ratio > conf.hybrid_scan_deleted_ratio_threshold:
            return False
    if appended_bytes:
        total_bytes = sum(fi.size for fi in current.values())
        if appended_bytes / max(1, total_bytes) > conf.hybrid_scan_appended_ratio_threshold:
            return False
    return True


def pruned_buckets_for_predicate(
    condition: Optional[Expr], bucket_columns: Tuple[str, ...], num_buckets: int
) -> Optional[List[int]]:
    """Bucket pruning: an equality (or IN) conjunct on the single bucket
    column narrows the scan to specific buckets
    (ref: FilterIndexRule useBucketSpec, HS/index/covering/FilterIndexRule.scala:162-167)."""
    from hyperspace_tpu_torch.ops.hashing import bucket_of_literals

    if condition is None or len(bucket_columns) != 1:
        return None
    key = strip_nested_prefix(bucket_columns[0]).lower()
    for term in split_conjunctive(condition):
        eq = extract_eq_literal(term)
        if eq is not None and strip_nested_prefix(eq[0]).lower() == key:
            return [bucket_of_literals([eq[1]], num_buckets)]
        if (
            isinstance(term, In)
            and isinstance(term.child, Col)
            and strip_nested_prefix(term.child.name).lower() == key
        ):
            return sorted({bucket_of_literals([v.value], num_buckets) for v in term.values})
    return None


def index_file_columns(entry: IndexLogEntry, output_cols: List[str]) -> Optional[List[str]]:
    """Map required output names onto the column names stored in the index
    files (their stored spelling). None when every name maps to itself."""
    props = entry.derived_dataset.properties
    stored = [str(c) for c in props.get("indexedColumns", [])] + [
        str(c) for c in props.get("includedColumns", [])
    ]
    lookup = {strip_nested_prefix(s).lower(): s for s in stored}
    mapped = [lookup.get(strip_nested_prefix(c).lower(), c) for c in output_cols]
    return mapped if mapped != list(output_cols) else None


def index_files_for_buckets(entry: IndexLogEntry, buckets: Optional[List[int]]) -> List[str]:
    files = entry.content.files
    if buckets is None:
        return files
    # bucket ids are parsed from file names once per Content (immutable after
    # load); re-running the regex per query dominated bucket-pruned rewrites
    pairs = entry.content.__dict__.get("_file_buckets")
    if pairs is None or len(pairs) != len(files):
        pairs = entry.content.__dict__["_file_buckets"] = [(f, bucket_of_file(f)) for f in files]
    allowed = set(buckets)
    return [f for f, b in pairs if b in allowed]


def transform_plan_to_use_index(
    ctx: RuleContext,
    entry: IndexLogEntry,
    sub_plan: L.LogicalPlan,
    use_bucket_spec: bool,
) -> L.LogicalPlan:
    """Rewrite a linear sub-plan to scan the covering index instead of the
    source (ref: transformPlanToUseIndex, CoveringIndexRuleUtils.scala:55-83)."""
    parts = destructure_linear(sub_plan)
    assert parts is not None
    project_cols, condition, scan = parts
    required = project_cols if project_cols is not None else scan.output_columns
    if condition is not None:
        cond_refs = [c for c in condition.references()]
        required_all = list(dict.fromkeys(list(required) + cond_refs))
    else:
        required_all = list(required)

    index = CoveringIndex.from_derived_dataset(entry.derived_dataset)
    bucket_spec = index.bucket_spec()
    # an index whose data files were bucketed under an OLDER hash function
    # still serves correct index-only scans, but its bucket PLACEMENT can't
    # be trusted: no bucket pruning, no shuffle-free join layout
    trusted_layout = index.bucket_hash_version == BUCKET_HASH_VERSION
    use_bucket_spec = use_bucket_spec and trusted_layout
    if not ctx.hybrid_required(entry, scan):
        buckets = (
            pruned_buckets_for_predicate(condition, bucket_spec.bucket_columns, bucket_spec.num_buckets)
            if use_bucket_spec
            else None
        )
        out: L.LogicalPlan = L.IndexScan(
            entry,
            columns=required_all,
            bucket_spec=bucket_spec if use_bucket_spec else None,
            files=index_files_for_buckets(entry, buckets),
            pruned_buckets=buckets,
            file_columns=index_file_columns(entry, required_all),
        )
    else:
        out = _hybrid_scan_plan(ctx, entry, scan, required_all, bucket_spec, trusted_layout=trusted_layout)

    # canonical rebuild: every Filter sinks DIRECTLY above the scan (the
    # executor's device filter matches that shape); Projects re-apply above
    # in their original relative order, narrowed to the columns actually
    # available, with no-op Projects elided
    projects = []  # top-down
    node = sub_plan
    while not isinstance(node, L.Scan):
        if isinstance(node, L.Project):
            projects.append(list(node.columns))
        (node,) = node.children()

    if condition is not None:
        out = L.Filter(condition, out)
    for payload in reversed(projects):  # innermost first
        avail = set(out.output_columns)
        cols = [c for c in payload if c in avail]
        if cols != list(out.output_columns):  # elide no-op projections
            out = L.Project(cols, out)
    if set(out.output_columns) != set(sub_plan.output_columns):
        out = L.Project(list(sub_plan.output_columns), out)
    return out


def _hybrid_scan_plan(
    ctx: RuleContext,
    entry: IndexLogEntry,
    scan: L.Scan,
    required: List[str],
    bucket_spec: L.BucketSpec,
    trusted_layout: bool = True,
) -> L.LogicalPlan:
    """Hybrid scan: BucketUnion(index minus deleted, re-bucketed appended)
    (ref: CoveringIndexRuleUtils.scala:146-288)."""
    facts = ctx.hybrid_facts(entry, scan)
    appended, deleted = facts.appended, facts.deleted

    index_cols = list(required)
    if deleted and C.DATA_FILE_NAME_ID not in index_cols:
        index_cols = index_cols + [C.DATA_FILE_NAME_ID]

    index_side: L.LogicalPlan = L.IndexScan(
        entry,
        columns=index_cols,
        bucket_spec=bucket_spec if trusted_layout else None,
        file_columns=index_file_columns(entry, index_cols),
    )
    if deleted:
        tracker = entry.file_id_tracker()
        deleted_infos = {fi.name: fi for fi in entry.source_file_infos()}
        ids = []
        for name in deleted:
            fi = deleted_infos.get(name)
            if fi is not None and fi.file_id != C.UNKNOWN_FILE_ID:
                ids.append(fi.file_id)
            else:
                fid = next((v for k, v in tracker.file_to_id_map().items() if k[0] == name), None)
                if fid is not None:
                    ids.append(fid)
        # Not(In(_data_file_id, deletedIds)) (ref: :244-253)
        index_side = L.Filter(Not(In(Col(C.DATA_FILE_NAME_ID), [Lit(i) for i in ids])), index_side)
        index_side = L.Project(list(required), index_side)

    if not appended:
        return index_side

    rel = scan.relation
    pv = pd = None
    if getattr(rel, "partition_columns", None):
        pv = {f: rel.partition_values_for(f) for f in appended}
        pd_ = getattr(rel, "partition_dtypes", None)
        pd = dict(pd_) if pd_ else None
    appended_scan = L.FileScan(
        appended, rel.physical_format, list(required), partition_values=pv,
        partition_dtypes=pd, format_options=getattr(rel, "options", None),
    )
    if not trusted_layout:
        # stale bucket-hash version: the files still hold the right rows,
        # but their bucket placement predates the current hash function, so
        # the plan must not advertise a bucketed layout — a plain Union
        return L.Union([index_side, appended_scan])
    return L.BucketUnion([index_side, L.Repartition(bucket_spec, appended_scan)], bucket_spec)


def hybrid_coverage_fraction(ctx: RuleContext, entry: IndexLogEntry, scan: L.Scan) -> float:
    """commonBytes / currentTotalBytes — scales rule scores under hybrid scan
    (ref: FilterIndexRule score :170-193, JoinIndexRule score :674-704)."""
    if not ctx.hybrid_required(entry, scan):
        return 1.0
    total = sum(fi.size for fi in scan.relation.all_file_infos())
    return ctx.common_bytes(entry, scan) / max(1, total)


def prune_columns(plan: L.LogicalPlan, needed=None) -> L.LogicalPlan:
    """Column pruning: push the set of columns the parent actually needs down
    to the scans, materialized as a Project directly above each Scan.

    The reference relies on Catalyst's ColumnPruning running *before* its
    rules (ref: JoinIndexRule.scala:419-448 allRequiredCols over pruned
    plans); this IR has no separate optimizer, so the executor normalizes
    first. ``needed=None`` means "all columns".

    Sharing-preserving: a sub-plan referenced more than once (both sides of
    a self-join over one DataFrame) must remain ONE object after pruning, or
    the executor's shared-subtree memo stops deduplicating and the sub-plan
    executes once per reference. Shared roots act as barriers in a first
    pass that accumulates the UNION of columns every reference needs; each
    is then pruned once and swapped back in by identity.
    """
    shared = shared_subplan_ids(plan)
    if not shared:
        return _prune(plan, needed, None)
    return _prune_shared(plan, needed, shared)


def shared_subplan_ids(plan: L.LogicalPlan) -> set:
    """ids of sub-plans referenced more than once — the single definition
    of "shared" used by both pruning here and the executor's shared-subtree
    memo."""
    counts: dict = {}

    def walk(p):
        c = counts.get(id(p), 0) + 1
        counts[id(p)] = c
        if c == 1:
            for ch in p.children():
                walk(ch)

    walk(plan)
    return {pid for pid, c in counts.items() if c > 1}


def prune_columns_duplicating(plan: L.LogicalPlan, needed=None) -> L.LogicalPlan:
    """Per-reference pruning: shared sub-plans (self-join sides) are rebuilt
    independently per use with each use's own needed-set. This is what the
    INDEX RULES want — each join side must be an independent linear
    sub-plan to match and rewrite — at the cost of the executor's
    shared-subtree dedup. ApplyHyperspace uses this before rule matching;
    the executor's own pass uses the sharing-preserving prune_columns."""
    return _prune(plan, needed, None)


def _prune_shared(plan: L.LogicalPlan, needed, shared) -> L.LogicalPlan:
    acc: dict = {}  # id(shared node) -> union of needed sets (None = all)

    def note(p, need):
        if id(p) in acc:
            prev = acc[id(p)]
            acc[id(p)] = None if (need is None or prev is None) else prev | set(need)
        else:
            acc[id(p)] = None if need is None else set(need)

    top = _prune(plan, needed, (shared, note))
    if not acc:
        return top
    # prune each shared root with its accumulated union, to a FIXPOINT:
    # pruning one shared node can record new needs for another, so keep
    # re-pruning any node whose union grew since it was last pruned. Unions
    # only grow and are bounded by the column sets, so this terminates.
    preorder: list = []
    seen: set = set()

    def pre(p):
        if id(p) in seen:
            return
        seen.add(id(p))
        preorder.append(p)
        for ch in p.children():
            pre(ch)

    pre(plan)

    def frozen(s):
        return None if s is None else frozenset(s)

    replaced: dict = {}
    pruned_with: dict = {}
    while True:
        stale = [n for n in preorder if id(n) in acc and pruned_with.get(id(n), ()) != frozen(acc[id(n)])]
        if not stale:
            break
        for node in stale:
            replaced[id(node)] = _prune(node, acc[id(node)], (shared, note), skip_self=True)
            pruned_with[id(node)] = frozen(acc[id(node)])
    # swap pruned shared roots back in, preserving identity (memo by id).
    # A pruned shared node often CONTAINS its original (a barrier'd Scan
    # prunes to Project(cols, scan)); the in_progress guard keeps that
    # self-reference pointing at the original instead of recursing forever.
    memo: dict = {}
    in_progress: set = set()

    def swap(p):
        got = memo.get(id(p))
        if got is not None:
            return got
        if id(p) in in_progress:
            return p
        res = replaced.get(id(p), p)
        if res is p:
            new_children = [swap(ch) for ch in p.children()]
            if any(n is not o for n, o in zip(new_children, p.children())):
                res = p.with_children(new_children)
        else:
            in_progress.add(id(p))
            try:
                inner_children = [swap(ch) for ch in res.children()]
                if any(n is not o for n, o in zip(inner_children, res.children())):
                    res = res.with_children(inner_children)
            finally:
                in_progress.discard(id(p))
        memo[id(p)] = res
        return res

    return swap(top)


def _prune_join(plan: L.Join, needed, barrier) -> L.Join:
    left_cols = set(plan.left.output_columns)
    right_cols = set(plan.right.output_columns)
    if needed is None:
        l_needed = r_needed = None
    else:

        def keep_renamed(c, l_needed, r_needed):
            # join_output_names repeats the '#r' suffix until unique, so a
            # doubly-renamed 'x#r#r' needs iterative stripping to find the
            # right-side source column. The rename is positional: it only
            # reproduces at execution if the LEFT side still emits every
            # shorter name in the chain ('x', 'x#r', ...), so keep those too.
            base, chain = c, []
            while base.endswith("#r"):
                chain.append(base[:-2])
                base = base[:-2]
                if base in right_cols:
                    r_needed.add(base)
                    l_needed.update(x for x in chain if x in left_cols)
                    return True
            return False

        l_needed, r_needed = set(), set()
        for c in needed:
            # LEFT membership first: join_output_names passes left names
            # through verbatim, so an 'x#r' that exists on the left IS a left
            # column (a lower join's rename product) — the right side's
            # colliding 'x' renames PAST it to 'x#r#r'
            lr = column_root_member(c, left_cols)
            if lr is not None:
                l_needed.add(lr)
                continue
            if keep_renamed(c, l_needed, r_needed):
                continue
            rr = column_root_member(c, right_cols)
            if rr is not None:
                r_needed.add(rr)
        for c in plan.condition.references():
            lr = column_root_member(c, left_cols)
            if lr is not None:
                l_needed.add(lr)
            rr = column_root_member(c, right_cols)
            if rr is not None:
                r_needed.add(rr)
    return L.Join(
        _prune(plan.left, l_needed, barrier),
        _prune(plan.right, r_needed, barrier),
        plan.condition,
        plan.how,
        plan.residual,
        plan.using_pairs,
    )


def _prune(plan: L.LogicalPlan, needed, barrier, skip_self: bool = False) -> L.LogicalPlan:
    if barrier is not None and not skip_self and id(plan) in barrier[0]:
        barrier[1](plan, needed)
        return plan  # shared root: record needs, prune later, keep identity
    if isinstance(plan, L.Project):
        return L.Project(plan.columns, _prune(plan.child, set(plan.columns), barrier))
    if isinstance(plan, L.Filter):
        child_needed = None if needed is None else set(needed) | set(plan.condition.references())
        return plan.with_children([_prune(plan.child, child_needed, barrier)])
    if isinstance(plan, L.Join):
        return _prune_join(plan, needed, barrier)
    if isinstance(plan, L.Scan):
        out = plan.output_columns
        if needed is None:
            return plan
        flat = {c for c in needed if c in set(out)}
        if not flat:
            # a count-only consumer needs the ROW COUNT: a zero-column scan
            # would report zero rows, so keep the narrowest thing we have
            flat = {out[0]} if out else set()
        if flat < set(out):
            return L.Project([c for c in out if c in flat], plan)
        return plan
    if isinstance(plan, L.Union):
        return plan.with_children([_prune(c, needed, barrier) for c in plan.children()])
    if isinstance(plan, L.Aggregate):
        child_needed = set(plan.keys) | {c for _, _, c in plan.aggs if c is not None}
        (child,) = plan.children()
        return plan.with_children([_prune(child, child_needed, barrier)])
    # any other node (an IndexScan; Repartition and BucketUnion pass rows
    # through) keeps all its columns, but still recurse: shared sub-plans
    # MUST be noted here or the sharing swap would substitute replacements
    # pruned for other (narrower) uses
    new_children = [_prune(c, None, barrier) for c in plan.children()]
    if any(n is not o for n, o in zip(new_children, plan.children())):
        return plan.with_children(new_children)
    return plan
