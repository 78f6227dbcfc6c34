"""Column resolution.

Case-insensitive resolution of user column names against a schema
(ref: HS/util/ResolverUtils.scala:33-233). Nested struct fields are not in
the port yet: a dotted name that reaches into a struct raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import pyarrow as pa

from hyperspace_tpu_torch.plan.expr import Expr, rewrite_columns


def resolve_columns_against_schema(names: Sequence[str], schema: pa.Schema) -> List[str]:
    """The schema's own spelling of each name in ``names``."""
    by_lower = {}
    for f in schema:
        by_lower.setdefault(f.name.lower(), f)
    out = []
    for n in names:
        f = by_lower.get(n.lower())
        if f is None:
            head = by_lower.get(n.split(".")[0].lower())
            if "." in n and head is not None and pa.types.is_struct(head.type):
                raise NotImplementedError(f"nested column {n!r}: nested columns are not yet in the port")
            raise ValueError(f"Column {n!r} could not be resolved against schema {schema.names}")
        out.append(f.name)
    return out


def resolve_column(name: str, available: Sequence[str]) -> Optional[str]:
    """Resolve ``name`` case-insensitively against flat column names."""
    for a in available:
        if a.lower() == name.lower():
            return a
    root = name.split(".")[0].lower()
    if "." in name and any(a.lower() == root for a in available):
        raise NotImplementedError(f"nested column {name!r}: nested columns are not yet in the port")
    return None


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
