"""Logical plan IR — the nodes of the index build, the filter query, the
equi-join and aggregation.

``Scan`` over a source relation, ``Filter``, ``Project``, ``Join``,
``Aggregate`` and ``Union`` over it, and the nodes the optimizer rewrites a
scan into: ``IndexScan`` (replaces a source scan; ref:
IndexHadoopFsRelation, HS/index/plans/logical/IndexHadoopFsRelation.scala:29-50),
with the ``BucketSpec`` a covering index records, and hybrid scan's
``FileScan`` of appended files, ``Repartition`` and ``BucketUnion``.
``describe()`` strings are the JAX package's. Sorting, limits and the rest
of the relational algebra are not in the port yet.
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


class FileScan(LogicalPlan):
    """Scan of an explicit file list: the per-chunk leaf of a streamed scan
    over a source relation (``exec/executor.py::_leaf_subset``), the files a
    data-skipping index keeps (``rules/dataskipping_rule.py``), and hybrid
    scan's appended files (ref: CoveringIndexRuleUtils' appended-data scan,
    HS/index/covering/CoveringIndexRuleUtils.scala:206-243).
    ``partition_values`` ({file -> {col -> typed value}}) carries the
    hive-partition columns the requested ``columns`` include but the file
    bytes do not; ``format_options`` the source's reader options (a csv
    delimiter or header); ``via_index`` names the index whose rewrite
    produced the scan."""

    def __init__(
        self,
        files: List[str],
        file_format: str,
        columns: List[str],
        partition_values: Optional[dict] = None,
        partition_dtypes: Optional[dict] = None,
        via_index: Optional[str] = None,
        format_options: Optional[dict] = None,
    ):
        self.files = list(files)
        self.file_format = file_format
        self.columns = list(columns)
        self.partition_values = partition_values
        self.partition_dtypes = partition_dtypes
        self.via_index = via_index
        self.format_options = dict(format_options) if format_options else None

    @property
    def output_columns(self) -> List[str]:
        return list(self.columns)

    def with_children(self, children: Sequence[LogicalPlan]) -> "FileScan":
        assert not children
        return self

    def describe(self) -> str:
        via = f", Hyperspace(Type: DS, Name: {self.via_index})" if self.via_index else ""
        return f"FileScan({len(self.files)} files, format={self.file_format}{via})"


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

    ``residual`` carries an extra non-equi ON-clause predicate, evaluated
    over the matched pairs during the join; index rules ignore joins with a
    residual, and executing one is not in the port yet."""

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
        # RIGHT side's key under the left name, not NULL. ON-condition joins
        # leave it None (both keys retained verbatim).
        self.using_pairs = using_pairs

    def children(self) -> Sequence[LogicalPlan]:
        return (self.left, self.right)

    @property
    def output_columns(self) -> List[str]:
        out, _ = join_output_names(self.left.output_columns, self.right.output_columns)
        return out

    def with_children(self, children: Sequence[LogicalPlan]) -> "Join":
        left, right = children
        return Join(left, right, self.condition, self.how, self.residual, self.using_pairs)

    def describe(self) -> str:
        if self.residual is not None:
            return f"Join({self.condition!r}, how={self.how}, residual={self.residual!r})"
        return f"Join({self.condition!r}, how={self.how})"


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


class Union(LogicalPlan):
    """Rows of every child, in child order (hybrid scan's plain union of an
    index and appended files whose bucket layout cannot be trusted)."""

    def __init__(self, children_: List[LogicalPlan]):
        self._children = list(children_)

    def children(self) -> Sequence[LogicalPlan]:
        return tuple(self._children)

    @property
    def output_columns(self) -> List[str]:
        return self._children[0].output_columns

    def with_children(self, children: Sequence[LogicalPlan]) -> "Union":
        return Union(list(children))


# --- index-side nodes (appear only in rewritten plans) ----------------------


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
        # parquet files when they differ from the output names
        self.file_columns = list(file_columns) if file_columns is not None else None

    @property
    def output_columns(self) -> List[str]:
        return list(self.columns)

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


class Repartition(LogicalPlan):
    """Hash-repartition child rows into ``bucket_spec`` buckets — injected on
    top of appended-data scans so hybrid scan can merge with index buckets
    (ref: RepartitionByExpression injection,
    HS/index/covering/CoveringIndexRuleUtils.scala:357-417). The bucketed
    join re-buckets the rows on the host with the build's hash; any other
    consumer takes them as they are."""

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
    """Stable per-process identity of a plan node: the key under which the
    optimizer files a scan's candidate indexes."""
    return id(plan)
