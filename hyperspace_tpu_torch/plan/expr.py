"""Expression tree — the part the index-build path needs.

Column references. The predicate language (literals, comparisons,
connectives, subqueries) arrives with the query path.
"""

from __future__ import annotations

from typing import Dict, Sequence, Set


class Expr:
    """Base expression node."""

    def references(self) -> Set[str]:
        out: Set[str] = set()
        self._collect_refs(out)
        return out

    def _collect_refs(self, out: Set[str]) -> None:
        for c in self.children():
            c._collect_refs(out)

    def children(self) -> Sequence["Expr"]:
        return ()


class Col(Expr):
    def __init__(self, name: str):
        self.name = name

    def _collect_refs(self, out: Set[str]) -> None:
        out.add(self.name)

    def __repr__(self) -> str:
        return f"col({self.name!r})"


def col(name: str) -> Col:
    return Col(name)


def rewrite_columns(e: Expr, mapping: Dict[str, str]) -> Expr:
    """Return a copy of ``e`` with column names rewritten via ``mapping``."""
    if isinstance(e, Col):
        return Col(mapping.get(e.name, e.name))
    return e
