"""Logical plan IR.

A minimal relational algebra — Scan / Filter / Project / Join / Union plus the
index-specific nodes the optimizer rewrites plans into: ``IndexScan`` (replaces
a source scan; ref: IndexHadoopFsRelation, HS/index/plans/logical/IndexHadoopFsRelation.scala:29-50),
``Repartition`` (on-the-fly re-bucketing of appended data; ref:
HS/index/covering/CoveringIndexRuleUtils.scala:357-417) and ``BucketUnion``
(partition-preserving union; ref: HS/index/plans/logical/BucketUnion.scala:31-68).

Scope is intentionally the slice of Catalyst the reference's rules accept:
linear plans of Project→Filter→Scan and equi-joins of such
(ref: HS/index/covering/JoinIndexRule.scala:135-155).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from hyperspace_tpu_torch.plan.expr import Expr


@dataclass(frozen=True)
class BucketSpec:
    """Hash-bucket layout of stored data: ``num_buckets`` buckets over
    ``bucket_columns``, rows sorted by ``sort_columns`` within each bucket
    (ref: Spark BucketSpec as used at HS/index/covering/CoveringIndex.scala:173-177)."""

    num_buckets: int
    bucket_columns: Tuple[str, ...]
    sort_columns: Tuple[str, ...]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "numBuckets": self.num_buckets,
            "bucketColumns": list(self.bucket_columns),
            "sortColumns": list(self.sort_columns),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BucketSpec":
        return cls(d["numBuckets"], tuple(d["bucketColumns"]), tuple(d["sortColumns"]))


class LogicalPlan:
    """Base plan node. Nodes are immutable-by-convention; rewrites build new trees."""

    def children(self) -> Sequence["LogicalPlan"]:
        return ()

    @property
    def output_columns(self) -> List[str]:
        raise NotImplementedError

    def with_children(self, children: Sequence["LogicalPlan"]) -> "LogicalPlan":
        raise NotImplementedError

    def pretty(self, indent: int = 0) -> str:
        line = "  " * indent + self.describe()
        return "\n".join([line] + [c.pretty(indent + 1) for c in self.children()])

    def describe(self) -> str:
        return type(self).__name__

    def __repr__(self) -> str:
        return self.pretty()


class Scan(LogicalPlan):
    """Scan over a source relation (ref: Spark LogicalRelation over
    HadoopFsRelation; SPI: HS/index/sources/interfaces.scala:43-158)."""

    def __init__(self, relation: "FileBasedRelation"):  # noqa: F821
        self.relation = relation

    @property
    def output_columns(self) -> List[str]:
        return [f.name for f in self.relation.schema]

    def with_children(self, children: Sequence[LogicalPlan]) -> "Scan":
        assert not children
        return self

    def describe(self) -> str:
        return f"Scan({self.relation.name}, format={self.relation.file_format})"


class Filter(LogicalPlan):
    def __init__(self, condition: Expr, child: LogicalPlan):
        self.condition = condition
        self.child = child

    def children(self) -> Sequence[LogicalPlan]:
        return (self.child,)

    @property
    def output_columns(self) -> List[str]:
        return self.child.output_columns

    def with_children(self, children: Sequence[LogicalPlan]) -> "Filter":
        (child,) = children
        return Filter(self.condition, child)

    def describe(self) -> str:
        return f"Filter({self.condition!r})"


class Project(LogicalPlan):
    def __init__(self, columns: List[str], child: LogicalPlan):
        self.columns = list(columns)
        self.child = child

    def children(self) -> Sequence[LogicalPlan]:
        return (self.child,)

    @property
    def output_columns(self) -> List[str]:
        return list(self.columns)

    def with_children(self, children: Sequence[LogicalPlan]) -> "Project":
        (child,) = children
        return Project(self.columns, child)

    def describe(self) -> str:
        return f"Project({self.columns})"


class Compute(LogicalPlan):
    """Computed columns: appends ``name = expr`` outputs to the child's
    columns (SQL expressions in the SELECT list, aggregate-input expressions,
    post-aggregate arithmetic). The reference delegates expression projection
    to Spark's Project; index rewrite rules recurse through this node
    untouched, exactly as they do through Project."""

    def __init__(self, exprs: List[Tuple[str, "Expr"]], child: LogicalPlan):
        taken = set(child.output_columns)
        names = [n for n, _ in exprs]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate computed column names: {names}")
        clash = [n for n in names if n in taken]
        if clash:
            raise ValueError(f"Computed columns {clash} collide with child outputs")
        self.exprs = [(n, e) for n, e in exprs]
        self.child = child

    def children(self) -> Sequence[LogicalPlan]:
        return (self.child,)

    @property
    def output_columns(self) -> List[str]:
        return self.child.output_columns + [n for n, _ in self.exprs]

    def with_children(self, children: Sequence[LogicalPlan]) -> "Compute":
        (child,) = children
        return Compute(self.exprs, child)

    def describe(self) -> str:
        parts = [f"{n}={e!r}" for n, e in self.exprs]
        return f"Compute({', '.join(parts)})"


def join_output_names(left_cols: List[str], right_cols: List[str]) -> Tuple[List[str], Dict[str, str]]:
    """Join output naming: right-side duplicates get a '#r' suffix, repeated
    until unique (a second join whose right side collides with an existing
    'x#r' yields 'x#r#r'). Returns (output names, right-col rename map) —
    the single source of truth for planning AND execution."""
    out = list(left_cols)
    taken = set(left_cols)
    rename: Dict[str, str] = {}
    for c in right_cols:
        name = c
        while name in taken:
            name = f"{name}#r"
        if name != c:
            rename[c] = name
        taken.add(name)
        out.append(name)
    return out, rename


class Join(LogicalPlan):
    """Equi-join. ``condition`` must be a conjunction of col = col terms
    (the only shape the reference's JoinIndexRule accepts,
    ref: HS/index/covering/JoinIndexRule.scala:149-155).

    ``residual`` carries any extra non-equi ON-clause predicate (TPC-H q13's
    ``LEFT JOIN orders ON c_custkey = o_custkey AND o_comment NOT LIKE ...``):
    it is evaluated over the matched pairs DURING the join — for outer joins
    a pair failing the residual null-extends instead of matching, which a
    post-join filter cannot express. References use post-join (renamed)
    column names. Index rules ignore joins with a residual (the reference's
    rules are equi-CNF-only too)."""

    def __init__(
        self,
        left: LogicalPlan,
        right: LogicalPlan,
        condition: Expr,
        how: str = "inner",
        residual: Optional[Expr] = None,
        using_pairs: Optional[List[Tuple[str, str]]] = None,
    ):
        self.left = left
        self.right = right
        self.condition = condition
        self.how = how
        self.residual = residual
        # (left key, right key) name pairs when the join came from a
        # USING-style dataframe ``on="k"``: Spark coalesces the key column
        # across sides, so a right/outer join's unmatched rows must show the
        # RIGHT side's key under the left name, not NULL. Execution paths
        # honor this; ON-condition joins leave it None (both keys retained
        # verbatim, qualified access).
        self.using_pairs = using_pairs

    def children(self) -> Sequence[LogicalPlan]:
        return (self.left, self.right)

    @property
    def output_columns(self) -> List[str]:
        out, _ = join_output_names(self.left.output_columns, self.right.output_columns)
        return out

    def with_children(self, children: Sequence[LogicalPlan]) -> "Join":
        left, right = children
        return Join(
            left, right, self.condition, self.how, self.residual, self.using_pairs
        )

    def describe(self) -> str:
        if self.residual is not None:
            return f"Join({self.condition!r}, how={self.how}, residual={self.residual!r})"
        return f"Join({self.condition!r}, how={self.how})"


class Union(LogicalPlan):
    def __init__(self, children_: List[LogicalPlan]):
        self._children = list(children_)

    def children(self) -> Sequence[LogicalPlan]:
        return tuple(self._children)

    @property
    def output_columns(self) -> List[str]:
        return self._children[0].output_columns

    def with_children(self, children: Sequence[LogicalPlan]) -> "Union":
        return Union(list(children))


class SetOp(LogicalPlan):
    """INTERSECT / EXCEPT set operations (distinct semantics, NULLs compare
    equal — SQL set-operation rules). Children align positionally; output
    schema is the left child's."""

    def __init__(self, kind: str, left: LogicalPlan, right: LogicalPlan):
        if kind not in ("intersect", "except"):
            raise ValueError(f"Unknown set operation {kind!r}")
        if len(left.output_columns) != len(right.output_columns):
            raise ValueError(
                f"{kind.upper()} inputs have {len(left.output_columns)} vs "
                f"{len(right.output_columns)} columns"
            )
        self.kind = kind
        self.left = left
        self.right = right

    def children(self) -> Sequence[LogicalPlan]:
        return (self.left, self.right)

    @property
    def output_columns(self) -> List[str]:
        return self.left.output_columns

    def with_children(self, children: Sequence[LogicalPlan]) -> "SetOp":
        left, right = children
        return SetOp(self.kind, left, right)

    def describe(self) -> str:
        return f"SetOp({self.kind})"


# --- index-side nodes (appear only in rewritten plans) ----------------------


class FileScan(LogicalPlan):
    """Scan of an explicit file list (used for the appended-files side of
    hybrid scan; ref: CoveringIndexRuleUtils' appended-data scan,
    HS/index/covering/CoveringIndexRuleUtils.scala:206-243)."""

    def __init__(
        self,
        files: List[str],
        file_format: str,
        columns: List[str],
        via_index: Optional[str] = None,
        partition_values: Optional[dict] = None,
        partition_dtypes: Optional[dict] = None,
        format_options: Optional[dict] = None,
    ):
        self.files = list(files)
        self.file_format = file_format
        self.columns = list(columns)
        # reader options of the source relation (e.g. csv delimiter/header)
        self.format_options = dict(format_options) if format_options else None
        # name of the index whose rewrite produced this scan (e.g. a
        # data-skipping prune), for explain/whyNot reporting
        self.via_index = via_index
        # hive-partition values per file ({file -> {col -> typed value}}) for
        # partition columns the requested ``columns`` include but the file
        # bytes do not carry
        self.partition_values = partition_values
        self.partition_dtypes = partition_dtypes

    @property
    def output_columns(self) -> List[str]:
        return list(self.columns)

    def with_children(self, children: Sequence[LogicalPlan]) -> "FileScan":
        assert not children
        return self

    def describe(self) -> str:
        via = f", Hyperspace(Type: DS, Name: {self.via_index})" if self.via_index else ""
        return f"FileScan({len(self.files)} files, format={self.file_format}{via})"


class IndexScan(LogicalPlan):
    """Scan of covering-index data files instead of source files.

    ``pruned_buckets`` — when bucket pruning applies (selective equality
    predicate on the first indexed column), only those buckets' files are read
    (ref: FilterIndexRule's useBucketSpec path,
    HS/index/covering/FilterIndexRule.scala:162-167).
    """

    def __init__(
        self,
        entry: "IndexLogEntry",  # noqa: F821
        columns: List[str],
        bucket_spec: Optional[BucketSpec],
        files: Optional[List[str]] = None,
        pruned_buckets: Optional[List[int]] = None,
        file_columns: Optional[List[str]] = None,
    ):
        self.entry = entry
        self.columns = list(columns)
        self.bucket_spec = bucket_spec
        self.files = files if files is not None else entry.content.files
        self.pruned_buckets = pruned_buckets
        # parallel to ``columns``: the flat column names inside the index
        # parquet files when they differ from the output names (nested fields
        # are stored under their __hs_nested.-prefixed flat name)
        self.file_columns = list(file_columns) if file_columns is not None else None

    @property
    def output_columns(self) -> List[str]:
        return list(self.columns)

    def file_column_of(self, output_col: str) -> str:
        if self.file_columns is None:
            return output_col
        try:
            return self.file_columns[self.columns.index(output_col)]
        except ValueError:
            return output_col

    def with_children(self, children: Sequence[LogicalPlan]) -> "IndexScan":
        assert not children
        return self

    def describe(self) -> str:
        extra = f", prunedBuckets={self.pruned_buckets}" if self.pruned_buckets is not None else ""
        n = self.bucket_spec.num_buckets if self.bucket_spec else None
        return (
            f"IndexScan(Hyperspace(Type: CI, Name: {self.entry.name}, "
            f"LogVersion: {self.entry.id}), buckets={n}{extra})"
        )


class Aggregate(LogicalPlan):
    """Hash aggregation: ``keys`` group-by columns (empty = global) and
    ``aggs`` as (output name, fn, input column) with fn in
    count/sum/min/max/avg — the slice of aggregation the dataframe facade
    offers around indexed scans (the reference delegates aggregation to
    Spark; index rewrites apply beneath this node untouched)."""

    FNS = (
        "count", "sum", "min", "max", "avg",
        "count_distinct", "sum_distinct", "avg_distinct", "stddev_samp",
    )

    def __init__(self, keys: List[str], aggs: List[tuple], child: LogicalPlan):
        self.keys = list(keys)
        self.aggs = [tuple(a) for a in aggs]
        for _, fn, _ in self.aggs:
            if fn not in self.FNS:
                raise ValueError(f"Unsupported aggregate fn {fn!r}; one of {self.FNS}")
        seen = set(self.keys)
        for name, _, _ in self.aggs:
            if name in seen:
                raise ValueError(f"Duplicate aggregate output name {name!r} (collides with a key or another aggregate)")
            seen.add(name)
        self.child = child

    def children(self) -> Sequence[LogicalPlan]:
        return (self.child,)

    @property
    def output_columns(self) -> List[str]:
        return self.keys + [name for name, _, _ in self.aggs]

    def with_children(self, children: Sequence[LogicalPlan]) -> "Aggregate":
        (child,) = children
        return Aggregate(self.keys, self.aggs, child)

    def describe(self) -> str:
        parts = [f"{name}={fn}({col_ or '*'})" for name, fn, col_ in self.aggs]
        return f"Aggregate(keys={self.keys}, [{', '.join(parts)}])"


class Window(LogicalPlan):
    """Window functions: appends one column per spec, preserving row count
    and order. Each spec is (out_name, fn, arg_col_or_None, partition_cols,
    order_keys, cumulative) with fn in rank/dense_rank/row_number/
    count/sum/min/max/avg; ``order_keys`` are (column, ascending) pairs;
    ``cumulative`` marks an explicit ROWS UNBOUNDED PRECEDING..CURRENT ROW
    frame for aggregate fns. (The reference delegates windows to Spark; the
    TPC-DS q12/q47/q51/q53-family shapes drive this surface.)"""

    FNS = ("rank", "dense_rank", "row_number", "count", "sum", "min", "max", "avg")

    def __init__(self, specs: List[tuple], child: LogicalPlan):
        taken = set(child.output_columns)
        for spec in specs:
            out, fn, arg, parts, orders, cumulative = spec
            if fn not in self.FNS:
                raise ValueError(f"Unsupported window fn {fn!r}; one of {self.FNS}")
            if out in taken:
                raise ValueError(f"Window output {out!r} collides with an existing column")
            taken.add(out)
        self.specs = [tuple(s) for s in specs]
        self.child = child

    def children(self) -> Sequence[LogicalPlan]:
        return (self.child,)

    @property
    def output_columns(self) -> List[str]:
        return self.child.output_columns + [s[0] for s in self.specs]

    def with_children(self, children: Sequence[LogicalPlan]) -> "Window":
        (child,) = children
        return Window(self.specs, child)

    def describe(self) -> str:
        parts = []
        for out, fn, arg, pcols, orders, cumulative in self.specs:
            over = []
            if pcols:
                over.append(f"partition by {list(pcols)}")
            if orders:
                over.append(f"order by {list(orders)}")
            if cumulative:
                over.append("rows unbounded preceding")
            parts.append(f"{out}={fn}({arg or ''}) over ({', '.join(over)})")
        return f"Window({'; '.join(parts)})"


class Rename(LogicalPlan):
    """Column renaming (SQL ``AS`` aliases). Purely cosmetic at the top of a
    plan: data and row order pass through, only names change (the reference
    delegates aliasing to Spark's analyzer)."""

    def __init__(self, mapping: dict, child: LogicalPlan):
        out = child.output_columns
        unknown = [k for k in mapping if k not in out]
        if unknown:
            raise ValueError(f"Cannot rename unknown columns {unknown} among {out}")
        renamed = [mapping.get(c, c) for c in out]
        if len(set(renamed)) != len(renamed):
            raise ValueError(f"Rename produces duplicate output names: {renamed}")
        self.mapping = dict(mapping)
        self.child = child

    def children(self) -> Sequence[LogicalPlan]:
        return (self.child,)

    @property
    def output_columns(self) -> List[str]:
        return [self.mapping.get(c, c) for c in self.child.output_columns]

    def with_children(self, children: Sequence[LogicalPlan]) -> "Rename":
        (child,) = children
        return Rename(self.mapping, child)

    def describe(self) -> str:
        return f"Rename({self.mapping})"


class Sort(LogicalPlan):
    """Order-by over (column, ascending) keys; host-side stable lexsort."""

    def __init__(self, keys: List[tuple], child: LogicalPlan):
        self.keys = [tuple(k) for k in keys]  # (column, ascending)
        self.child = child

    def children(self) -> Sequence[LogicalPlan]:
        return (self.child,)

    @property
    def output_columns(self) -> List[str]:
        return self.child.output_columns

    def with_children(self, children: Sequence[LogicalPlan]) -> "Sort":
        (child,) = children
        return Sort(self.keys, child)

    def describe(self) -> str:
        parts = [f"{c} {'ASC' if asc else 'DESC'}" for c, asc in self.keys]
        return f"Sort({', '.join(parts)})"


class Limit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan):
        if n < 0:
            raise ValueError("limit must be non-negative")
        self.n = int(n)
        self.child = child

    def children(self) -> Sequence[LogicalPlan]:
        return (self.child,)

    @property
    def output_columns(self) -> List[str]:
        return self.child.output_columns

    def with_children(self, children: Sequence[LogicalPlan]) -> "Limit":
        (child,) = children
        return Limit(self.n, child)

    def describe(self) -> str:
        return f"Limit({self.n})"


class Repartition(LogicalPlan):
    """Hash-repartition child rows into ``bucket_spec`` buckets — injected on
    top of appended-data scans so hybrid scan can merge with index buckets.
    On TPU this lowers to on-device hashing + all-to-all over ICI
    (ref: RepartitionByExpression injection,
    HS/index/covering/CoveringIndexRuleUtils.scala:357-417)."""

    def __init__(self, bucket_spec: BucketSpec, child: LogicalPlan):
        self.bucket_spec = bucket_spec
        self.child = child

    def children(self) -> Sequence[LogicalPlan]:
        return (self.child,)

    @property
    def output_columns(self) -> List[str]:
        return self.child.output_columns

    def with_children(self, children: Sequence[LogicalPlan]) -> "Repartition":
        (child,) = children
        return Repartition(self.bucket_spec, child)

    def describe(self) -> str:
        return f"Repartition(n={self.bucket_spec.num_buckets}, cols={list(self.bucket_spec.bucket_columns)})"


class BucketUnion(LogicalPlan):
    """Union preserving bucket layout: all children share the same
    ``bucket_spec``; the i-th bucket of the output is the concatenation of the
    i-th buckets of the children — no reshuffle
    (ref: HS/index/plans/logical/BucketUnion.scala:31-68,
    HS/index/execution/BucketUnionExec.scala:52-121)."""

    def __init__(self, children_: List[LogicalPlan], bucket_spec: BucketSpec):
        self._children = list(children_)
        self.bucket_spec = bucket_spec

    def children(self) -> Sequence[LogicalPlan]:
        return tuple(self._children)

    @property
    def output_columns(self) -> List[str]:
        return self._children[0].output_columns

    def with_children(self, children: Sequence[LogicalPlan]) -> "BucketUnion":
        return BucketUnion(list(children), self.bucket_spec)

    def describe(self) -> str:
        return f"BucketUnion(n={self.bucket_spec.num_buckets})"


# --- traversal helpers ------------------------------------------------------

def collect(plan: LogicalPlan, predicate) -> List[LogicalPlan]:
    out = []
    if predicate(plan):
        out.append(plan)
    for c in plan.children():
        out.extend(collect(c, predicate))
    return out


def transform_up(plan: LogicalPlan, fn) -> LogicalPlan:
    new_children = [transform_up(c, fn) for c in plan.children()]
    if list(new_children) != list(plan.children()):
        plan = plan.with_children(new_children)
    return fn(plan)


def plan_key(plan: LogicalPlan) -> int:
    """Stable per-process identity used for tagging (the reference tags plan
    objects directly; ref: HS/index/IndexLogEntry.scala:519-571)."""
    return id(plan)
