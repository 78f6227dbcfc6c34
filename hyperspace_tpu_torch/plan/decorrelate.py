"""Subquery decorrelation: correlated scalar subqueries and EXISTS.

The reference inherits decorrelation from Spark Catalyst
(RewriteCorrelatedScalarSubquery / RewritePredicateSubquery rewrite them to
aggregated-join / semi-join plans before Hyperspace's rules ever run); this
framework owns its query surface, so the same rewrites live here:

- ``EXISTS (SELECT ... WHERE outer.a = inner.b AND <inner preds> [AND
  residual])`` becomes an ``ExistsSubquery`` mark: the inner query is planned
  *uncorrelated* (correlation conjuncts removed, needed columns projected,
  DISTINCT), and eval semi-joins the outer rows against it on the equi pairs,
  applying any non-equi residual per matched pair (TPC-DS q10/q16/q35/q69/q94).
- ``(SELECT agg(...) FROM ... WHERE outer.k = inner.k AND <inner preds>)``
  becomes a ``CorrelatedScalarSubquery``: the inner query is re-planned as
  GROUP BY the correlation keys with the scalar item as the value column;
  eval maps each outer key tuple to its group value, the count-bug handled by
  a 0 default for bare COUNTs (TPC-DS q1/q6/q30/q32/q41/q81/q92).

Correlation detection is scope-based: a reference is *inner* when it resolves
against the subquery's own FROM tables (qualified by an inner alias, or
unqualified and found in an inner table's columns — inner shadows outer, SQL
name resolution); anything else is an outer reference.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.plan.expr import (
    BinaryOp,
    Col,
    CorrelatedInSubquery,
    CorrelatedScalarSubquery,
    ExistsSubquery,
    Expr,
    split_conjunctive,
)


class _Unsupported(Exception):
    """Raised when a correlated shape falls outside the supported rewrites;
    surfaced to the user as SqlError by the caller."""


def _inner_scope(iq, views) -> Dict[str, Dict[str, str]]:
    """alias(lower) -> {column(lower) -> actual name} for every table in the
    inner query's FROM (including JOIN ... ON refs and derived tables)."""
    from hyperspace_tpu_torch.plan.sql import SqlError, plan_query

    scope: Dict[str, Dict[str, str]] = {}
    for elem in iq.from_elements:
        for tref in [elem.table_ref] + [j.table_ref for j in elem.joins]:
            if isinstance(tref.source, str):
                if tref.source not in views:
                    raise SqlError(f"Unknown table/view {tref.source!r} in subquery")
                cols = views[tref.source].plan.output_columns
            else:
                cols = plan_query(tref.source, views).plan.output_columns
            scope[tref.alias.lower()] = {c.lower(): c for c in cols}
    return scope


def _classify_ref(name: str, scope) -> Tuple[str, str]:
    """('inner', actual) | ('outer', name). Inner shadows outer for
    unqualified names (SQL scoping); a qualifier naming an inner alias must
    resolve inside it."""
    if "." in name:
        qual, rest = name.split(".", 1)
        m = scope.get(qual.lower())
        if m is not None:
            got = m.get(rest.lower())
            if got is None:
                raise _Unsupported(f"column {name!r} not found in subquery alias {qual!r}")
            return ("inner", got)
        return ("outer", name)
    ln = name.lower()
    for m in scope.values():
        got = m.get(ln)
        if got is not None:
            return ("inner", got)
    return ("outer", name)


def _split_correlation(iq, views):
    """Split the inner WHERE into (inner-pure conjuncts, correlated
    conjuncts) after OR-factoring (q41 repeats its correlation conjunct in
    both OR branches; factoring lifts it to the top level)."""
    from hyperspace_tpu_torch.plan.sql import _factor_or_common

    scope = _inner_scope(iq, views)
    inner_preds: List[Expr] = []
    correlated: List[Expr] = []
    if iq.where is not None:
        for term in split_conjunctive(_factor_or_common(iq.where)):
            sides = {_classify_ref(r, scope)[0] for r in term.references()}
            (correlated if "outer" in sides else inner_preds).append(term)
    return scope, inner_preds, correlated


def _side_of(e: Expr, scope) -> Optional[str]:
    """'inner' / 'outer' when every reference classifies the same way."""
    refs = e.references()
    if not refs:
        return None
    sides = {_classify_ref(r, scope)[0] for r in refs}
    return sides.pop() if len(sides) == 1 else None


def is_correlated(iq, views) -> bool:
    """True when any WHERE conjunct of ``iq`` references the outer scope."""
    try:
        _, _, correlated = _split_correlation(iq, views)
    except _Unsupported:
        return False
    return bool(correlated)


def _rewrite_names(e: Expr, mapping: Dict[str, str]) -> Expr:
    from hyperspace_tpu_torch.plan.sql import _rewrite

    return _rewrite(e, mapping) if mapping else e


def _equi_pairs_and_residual(correlated, scope):
    """Partition correlated conjuncts into equi pairs
    [(outer Expr, inner Col name)] and residual conjuncts (kept whole)."""
    pairs: List[Tuple[Expr, str]] = []
    residual: List[Expr] = []
    for term in correlated:
        if isinstance(term, BinaryOp) and term.op == "=":
            ls, rs = _side_of(term.left, scope), _side_of(term.right, scope)
            if {ls, rs} == {"inner", "outer"}:
                outer_e = term.left if ls == "outer" else term.right
                inner_e = term.right if ls == "outer" else term.left
                if isinstance(inner_e, Col):
                    pairs.append((outer_e, _classify_ref(inner_e.name, scope)[1]))
                    continue
        residual.append(term)
    return pairs, residual


def decorrelate_exists(iq, views, session, outer_resolve) -> ExistsSubquery:
    """Build the ExistsSubquery mark for a (possibly correlated) EXISTS."""
    from hyperspace_tpu_torch.plan.sql import (
        SelectItem,
        SqlError,
        _resolve_expr_refs,
        plan_query,
    )

    if iq.unions or iq.group_by or iq.having is not None:
        raise SqlError("EXISTS subqueries with set operations or GROUP BY are not supported")
    try:
        scope, inner_preds, correlated = _split_correlation(iq, views)
        pairs, residual_terms = _equi_pairs_and_residual(correlated, scope)
    except _Unsupported as e:
        raise SqlError(f"Unsupported EXISTS subquery: {e}")
    if not pairs and residual_terms:
        raise SqlError(
            "Correlated EXISTS needs at least one equality correlation "
            "(outer.col = inner.col) alongside non-equi predicates"
        )

    key_cols = [f"__k{i}" for i in range(len(pairs))]
    items = [
        SelectItem(Col(inner_name), kc, inner_name)
        for kc, (_, inner_name) in zip(key_cols, pairs)
    ]
    # residual conjuncts reference inner columns (projected as __v{i}) and
    # outer values (placeholder columns __exo{i} evaluated over the outer
    # batch at eval time)
    residual_outer: List[Tuple[str, Expr]] = []
    residual_expr: Optional[Expr] = None
    if residual_terms:
        mapping: Dict[str, str] = {}
        v_seen: Dict[str, str] = {}
        o_seen: Dict[str, str] = {}
        for term in residual_terms:
            for r in sorted(term.references()):
                side, actual = _classify_ref(r, scope)
                if side == "inner":
                    if actual not in v_seen:
                        v_seen[actual] = f"__v{len(v_seen)}"
                        items.append(SelectItem(Col(actual), v_seen[actual], actual))
                    mapping[r] = v_seen[actual]
                else:
                    if r not in o_seen:
                        o_seen[r] = f"__exo{len(o_seen)}"
                        residual_outer.append(
                            (o_seen[r], _resolve_expr_refs(Col(r), outer_resolve))
                        )
                    mapping[r] = o_seen[r]
        rewritten = [_rewrite_names(t, mapping) for t in residual_terms]
        for t in rewritten:
            residual_expr = t if residual_expr is None else (residual_expr & t)

    dq = copy.copy(iq)
    dq.ctes = []  # outer plan_query already folded CTEs into ``views``
    dq.items = items if items else None  # uncorrelated EXISTS: any row at all
    # EXISTS only needs distinct tuples of (keys + residual columns): dedup
    # bounds the eval-time merge at one row per combination
    dq.distinct = bool(items)
    dq.where = None
    w: Optional[Expr] = None
    for t in inner_preds:
        w = t if w is None else (w & t)
    dq.where = w
    dq.order_by, dq.limit = [], None
    inner_df = plan_query(dq, views)
    if not items:
        # uncorrelated EXISTS — mark is row-count > 0, keyless
        return ExistsSubquery([], inner_df.limit(1).plan, [], None, [], session)

    outer_keys = [_resolve_expr_refs(oe, outer_resolve) for oe, _ in pairs]
    return ExistsSubquery(
        outer_keys, inner_df.plan, key_cols, residual_expr, residual_outer, session
    )


def decorrelate_in(child: Expr, iq, views, session, outer_resolve) -> CorrelatedInSubquery:
    """Rewrite ``x IN (SELECT v FROM ... WHERE outer.k = inner.k ...)`` to a
    CorrelatedInSubquery (group membership with three-valued semantics; the
    reference inherits Spark's null-aware semi/anti join for this)."""
    from hyperspace_tpu_torch.plan.sql import SelectItem, SqlError, _resolve_expr_refs, plan_query

    if iq.unions or iq.group_by or iq.having is not None or iq.items is None:
        raise SqlError(
            "Correlated IN subqueries with set operations, GROUP BY, or "
            "SELECT * are not supported"
        )
    if len(iq.items) != 1:
        raise SqlError("An IN subquery must select exactly one column")
    if iq.limit is not None:
        # unlike EXISTS (any row at all), LIMIT changes the membership set;
        # dropping it silently would change results
        raise SqlError("Correlated IN subqueries with LIMIT are not supported")
    from hyperspace_tpu_torch.plan.sql import _contains_agg

    if _contains_agg(iq.items[0].expr):
        raise SqlError("Aggregates in correlated IN subqueries are not supported")
    try:
        scope, inner_preds, correlated = _split_correlation(iq, views)
        pairs, residual_terms = _equi_pairs_and_residual(correlated, scope)
    except _Unsupported as e:
        raise SqlError(f"Unsupported correlated IN subquery: {e}")
    if residual_terms or not pairs:
        raise SqlError(
            "Correlated IN subqueries support only equality correlation "
            "(outer.col = inner.col)"
        )
    key_cols = [f"__k{i}" for i in range(len(pairs))]
    dq = copy.copy(iq)
    dq.ctes = []
    dq.items = [
        SelectItem(Col(inner_name), kc, inner_name)
        for kc, (_, inner_name) in zip(key_cols, pairs)
    ] + [SelectItem(iq.items[0].expr, "__inval", iq.items[0].text)]
    dq.distinct = True  # membership: one row per distinct (keys, value) tuple
    w: Optional[Expr] = None
    for t in inner_preds:
        w = t if w is None else (w & t)
    dq.where = w
    dq.order_by, dq.limit = [], None
    inner_df = plan_query(dq, views)
    outer_keys = [_resolve_expr_refs(oe, outer_resolve) for oe, _ in pairs]
    return CorrelatedInSubquery(child, outer_keys, inner_df.plan, key_cols, "__inval", session)


def _empty_group_default(expr: Expr):
    """The scalar value the subquery's select expression takes over a
    zero-row group: COUNT aggregates are 0, every other aggregate is NULL,
    and the surrounding expression is folded over those (count(*)*2 -> 0,
    avg(x)+1 -> NULL, coalesce(count(x), 5) -> 0). None means SQL NULL."""
    import numpy as np

    from hyperspace_tpu_torch.plan.expr import Lit
    from hyperspace_tpu_torch.plan.sql import _AggCall, _map_expr

    def leaf(x):
        if isinstance(x, _AggCall):
            return Lit(0) if x.fn.startswith("count") else Lit(np.nan)
        return None

    probe = _map_expr(expr, leaf)
    try:
        v = np.asarray(probe.eval({}))
        if v.ndim != 0:
            return None
        item = v.item()
        if item is None or (isinstance(item, float) and item != item):
            return None
        return item
    except Exception:
        return None


def decorrelate_scalar(iq, views, session, outer_resolve) -> CorrelatedScalarSubquery:
    """Rewrite a correlated scalar subquery to GROUP BY its correlation keys."""
    from hyperspace_tpu_torch.plan.sql import (
        SelectItem,
        SqlError,
        _AggCall,
        _contains_agg,
        _resolve_expr_refs,
        plan_query,
    )

    if iq.unions or iq.group_by or iq.having is not None or iq.items is None:
        raise SqlError(
            "Correlated scalar subqueries with set operations, GROUP BY, or "
            "SELECT * are not supported"
        )
    if len(iq.items) != 1:
        raise SqlError("A scalar subquery must select exactly one item")
    try:
        scope, inner_preds, correlated = _split_correlation(iq, views)
        pairs, residual_terms = _equi_pairs_and_residual(correlated, scope)
    except _Unsupported as e:
        raise SqlError(f"Unsupported correlated scalar subquery: {e}")
    if residual_terms:
        raise SqlError(
            "Correlated scalar subqueries support only equality correlation "
            "(outer.col = inner.col)"
        )
    item = iq.items[0]
    if not _contains_agg(item.expr):
        raise SqlError(
            "A correlated scalar subquery must aggregate (a bare correlated "
            "lookup can return multiple rows per outer row)"
        )

    key_cols = [f"__ck{i}" for i in range(len(pairs))]
    inner_names = [inner_name for _, inner_name in pairs]
    dq = copy.copy(iq)
    dq.ctes = []
    dq.items = [
        SelectItem(Col(n), kc, n) for kc, n in zip(key_cols, inner_names)
    ] + [SelectItem(item.expr, "__scalar", item.text)]
    dq.distinct = False
    w: Optional[Expr] = None
    for t in inner_preds:
        w = t if w is None else (w & t)
    dq.where = w
    dq.group_by = list(inner_names)
    dq.order_by, dq.limit = [], None
    inner_df = plan_query(dq, views)

    # the count-bug: COUNT over an empty group is 0, not NULL — and the whole
    # select expression may wrap it (count(*)*2, coalesce(count(x), 0)), so
    # the default is the expression evaluated over a zero-row group
    default = _empty_group_default(item.expr)
    outer_keys = [_resolve_expr_refs(oe, outer_resolve) for oe, _ in pairs]
    return CorrelatedScalarSubquery(
        outer_keys, inner_df.plan, key_cols, "__scalar", default, session
    )
