"""Logical plan IR — the nodes the index-build path needs.

``Scan`` over a source relation and the ``BucketSpec`` a covering index
records; the rest of the relational algebra arrives with the query path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple


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

    def describe(self) -> str:
        return f"Scan({self.relation.name}, format={self.relation.file_format})"


def collect(plan: LogicalPlan, predicate) -> List[LogicalPlan]:
    out = []
    if predicate(plan):
        out.append(plan)
    for c in plan.children():
        out.extend(collect(c, predicate))
    return out
