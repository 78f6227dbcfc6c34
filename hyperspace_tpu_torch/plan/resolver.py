"""Column resolution.

Case-insensitive resolution of user column names against a plan's output,
including nested struct fields normalized with the ``__hs_nested.`` prefix
(ref: HS/util/ResolverUtils.scala:33-233 — ``ResolvedColumn`` normalization
:44-105, struct traversal :160-181, array/map rejection :185-195).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import pyarrow as pa

from hyperspace_tpu_torch.plan.expr import NESTED_PREFIX, Col, Expr, rewrite_columns


@dataclass(frozen=True)
class ResolvedColumn:
    """A resolved column; nested fields carry the normalization prefix in
    ``normalized_name`` (e.g. ``a.b`` -> ``__hs_nested.a.b``)."""

    name: str
    is_nested: bool = False

    @property
    def normalized_name(self) -> str:
        return (NESTED_PREFIX + self.name) if self.is_nested else self.name

    @classmethod
    def from_normalized(cls, normalized: str) -> "ResolvedColumn":
        if normalized.startswith(NESTED_PREFIX):
            return cls(normalized[len(NESTED_PREFIX):], True)
        return cls(normalized, False)


def _resolve_against_schema(name: str, schema: pa.Schema) -> Optional[ResolvedColumn]:
    for f in schema:
        if f.name.lower() == name.lower():
            return ResolvedColumn(f.name, False)
    # nested struct path a.b.c
    parts = name.split(".")
    if len(parts) > 1:
        field = None
        resolved_parts: List[str] = []
        fields = list(schema)
        for i, part in enumerate(parts):
            match = next((f for f in fields if f.name.lower() == part.lower()), None)
            if match is None:
                return None
            if pa.types.is_list(match.type) or pa.types.is_map(match.type):
                raise ValueError(f"Array/map field {match.name!r} cannot be indexed (ref: ResolverUtils.scala:185-195)")
            resolved_parts.append(match.name)
            field = match
            if i < len(parts) - 1:
                if not pa.types.is_struct(field.type):
                    return None
                fields = [field.type.field(j) for j in range(field.type.num_fields)]
        return ResolvedColumn(".".join(resolved_parts), True)
    return None


def resolve_column(name: str, available: Sequence[str]) -> Optional[str]:
    """Resolve ``name`` case-insensitively against flat column names; a
    dotted nested path resolves when its root column does (the remaining
    segments resolve at execution against the struct values)."""
    for a in available:
        if a.lower() == name.lower():
            return a
    if "." in name:
        root, _, rest = name.partition(".")
        for a in available:
            if a.lower() == root.lower():
                return f"{a}.{rest}"
    return None


def resolve_columns_against_schema(names: Sequence[str], schema: pa.Schema) -> List[ResolvedColumn]:
    out = []
    for n in names:
        r = _resolve_against_schema(n, schema)
        if r is None:
            raise ValueError(f"Column {n!r} could not be resolved against schema {schema.names}")
        out.append(r)
    return out


def resolve_expr(e: Expr, available: Sequence[str]) -> Expr:
    """Rewrite column refs in ``e`` to their resolved (exact-case) names."""
    mapping = {}
    for ref in e.references():
        resolved = resolve_column(ref, available)
        if resolved is None:
            raise ValueError(f"Column {ref!r} could not be resolved among {list(available)}")
        if resolved != ref:
            mapping[ref] = resolved
    return rewrite_columns(e, mapping) if mapping else e
