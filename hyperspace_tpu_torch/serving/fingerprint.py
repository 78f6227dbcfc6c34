"""Canonical plan fingerprints for the serving runtime.

A fingerprint is a stable hash of a logical plan's *semantics*:

- **alias-invariant** — output/intermediate column aliases are canonicalized
  to the expression that defines them, so ``SELECT price AS p ... WHERE p > 5``
  and ``SELECT price AS q ... WHERE q > 5`` share a fingerprint;
- **literal-parameterized** — comparison/IN literals in filter and join
  conditions become positional slots (``?0``, ``?1``, ...), so ``price > 5``
  and ``price > 9`` share a *structure* fingerprint and differ only in the
  bound literal vector. The plan cache compiles the structure once and binds
  literals per request (prepared-statement semantics).

Expression forms whose value changes plan *shape* rather than a runtime
argument (LIKE patterns, CAST targets, function names, subquery plans, LIMIT
counts) embed their values verbatim: differing values mean a different
structure hash, never a wrong cache share. The same conservatism applies to
any expression type this module does not explicitly canonicalize — its
``repr`` (which includes its values) is embedded, making sharing exact-only.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.plan.expr import (
    BinaryOp,
    Col,
    Expr,
    In,
    InputFileName,
    IsNull,
    Lit,
    Not,
    SubqueryExpr,
)


class Unparameterizable(Exception):
    """Raised by literal binding when a template cannot accept new literals."""


def _lit_token(v: Any) -> str:
    """Stable, value-faithful token for a literal (numpy scalars, datetimes,
    strings, numbers). Used for exact-keying and slot matching."""
    import numpy as np

    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, np.datetime64):
        return f"dt64:{v!s}"
    return f"{type(v).__name__}:{v!r}"


@dataclass
class _Canon:
    """Mutable state threaded through one canonicalization walk."""

    lits: List[Any] = field(default_factory=list)
    sigs: List[str] = field(default_factory=list)  # per-slot context signature
    has_subquery: bool = False


# --- expressions ------------------------------------------------------------


def _canon_expr(e: Expr, env: Dict[str, str], st: _Canon, exact: bool, path: str) -> str:
    """Canonical string for ``e``. ``env`` maps in-scope column names to their
    canonical tokens; ``exact`` embeds literal values instead of slots;
    ``path`` is the root-to-node trail inside this expression, recorded as the
    slot's context signature so binding can align template slots with request
    slots unambiguously."""
    if isinstance(e, Col):
        return env.get(e.name, f"ext:{e.name}")
    if isinstance(e, Lit):
        if exact:
            return f"lit[{_lit_token(e.value)}]"
        st.sigs.append(path)
        st.lits.append(e.value)
        return f"?{len(st.lits) - 1}"
    if isinstance(e, BinaryOp):
        # the opposite operand's canonical form joins the path so `a > ?` and
        # `b > ?` slots never share a signature
        l_anchor = _canon_expr(e.left, env, st, True, path) if isinstance(e.left, Col) else ""
        r_anchor = _canon_expr(e.right, env, st, True, path) if isinstance(e.right, Col) else ""
        lc = _canon_expr(e.left, env, st, exact, f"{path}/b:{e.op}:L:{r_anchor}")
        rc = _canon_expr(e.right, env, st, exact, f"{path}/b:{e.op}:R:{l_anchor}")
        return f"({lc} {e.op} {rc})"
    if isinstance(e, Not):
        return f"not({_canon_expr(e.child, env, st, exact, path + '/not')})"
    if isinstance(e, IsNull):
        return f"isnull({_canon_expr(e.child, env, st, exact, path + '/isnull')})"
    if isinstance(e, In):
        # child is exact-only (bind never rewrites it); values are slotted
        c = _canon_expr(e.child, env, st, True, path)
        vals = [
            _canon_expr(v, env, st, exact, f"{path}/in:{c}:{i}") for i, v in enumerate(e.values)
        ]
        return f"in({c};{','.join(vals)})"
    if isinstance(e, SubqueryExpr):
        # subquery literals are structural: the inner plan's rewrite (and its
        # result) depends on them, so sharing across differing values is wrong
        st.has_subquery = True
        inner, _env = _canon_plan(e.plan, st, exact=True)
        parts = [type(e).__name__, inner]
        for c in e.children():
            parts.append(_canon_expr(c, env, st, True, path + "/subq-child"))
        return f"subq[{';'.join(parts)}]"
    if isinstance(e, InputFileName):
        return "input_file_name()"
    # Case / Like / Cast / Func / correlated forms: canonicalize any column
    # references through children() for alias-invariance where possible, but
    # embed values exactly — no literal slots inside these subtrees.
    kids = list(e.children())
    if kids:
        inner = ",".join(_canon_expr(c, env, st, True, path + "/opq") for c in kids)
        extra = _expr_attrs(e)
        return f"{type(e).__name__}[{inner};{extra}]"
    return f"{type(e).__name__}[{e!r}]"


def _expr_attrs(e: Expr) -> str:
    """Value-bearing attributes of known opaque expression types (children
    are canonicalized separately)."""
    from hyperspace_tpu_torch.plan.expr import Case, Cast, Func, Like

    if isinstance(e, Like):
        return f"pat={e.pattern!r}"
    if isinstance(e, Cast):
        return f"as={e.type_name}"
    if isinstance(e, Func):
        return f"fn={e.name}" if hasattr(e, "name") else "fn=?"
    if isinstance(e, Case):
        return f"branches={len(e.branches)},else={e.otherwise is not None}"
    return ""


# --- plans ------------------------------------------------------------------


def _listing_token(rel) -> str:
    """A source relation's file listing (path, size, mtime) as a token, so a
    scan over a new listing binds a new template (ROADMAP C8). A listing
    that cannot be read gives its error's name; the query raises when it
    runs."""
    try:
        return rel.signature()
    except OSError as e:
        return type(e).__name__


def _canon_plan(plan: L.LogicalPlan, st: _Canon, exact: bool = False) -> Tuple[str, Dict[str, str]]:
    """Canonical string + alias environment (output name -> canonical token)
    for ``plan``. Children canonicalize first (post-order), then the node's
    own expressions — literal-binding walks in the same order."""
    if isinstance(plan, L.Scan):
        rel = plan.relation
        env = {c: c for c in plan.output_columns}
        return f"Scan[{rel.name};{rel.file_format};{','.join(plan.output_columns)};{_listing_token(rel)}]", env

    if isinstance(plan, L.IndexScan):
        env = {c: c for c in plan.output_columns}
        pb = "" if plan.pruned_buckets is None else f";pb={sorted(plan.pruned_buckets)}"
        return (
            f"IndexScan[{plan.entry.name}#{plan.entry.id};{','.join(plan.columns)};"
            f"nfiles={len(plan.files)}{pb}]",
            env,
        )

    if isinstance(plan, L.FileScan):
        env = {c: c for c in plan.output_columns}
        h = hashlib.sha1("\x00".join(plan.files).encode()).hexdigest()[:12]
        return (
            f"FileScan[{h};{plan.file_format};{','.join(plan.columns)};via={plan.via_index}]",
            env,
        )

    if isinstance(plan, L.Filter):
        child, env = _canon_plan(plan.child, st, exact)
        cond = _canon_expr(plan.condition, env, st, exact, "F")
        return f"Filter[{cond}]({child})", env

    if isinstance(plan, L.Project):
        child, env = _canon_plan(plan.child, st, exact)
        cols = [env.get(c, f"ext:{c}") for c in plan.columns]
        out_env = {c: env.get(c, f"ext:{c}") for c in plan.columns}
        return f"Project[{','.join(cols)}]({child})", out_env

    if isinstance(plan, L.Compute):
        child, env = _canon_plan(plan.child, st, exact)
        out_env = dict(env)
        parts = []
        for n, e in plan.exprs:
            ce = _canon_expr(e, env, st, exact, f"C:{len(parts)}")
            out_env[n] = f"<{ce}>"
            parts.append(ce)
        return f"Compute[{';'.join(parts)}]({child})", out_env

    if isinstance(plan, L.Rename):
        child, env = _canon_plan(plan.child, st, exact)
        # pure aliasing: canonical form is the child's; only the env remaps
        out_env = {plan.mapping.get(c, c): env.get(c, f"ext:{c}") for c in plan.child.output_columns}
        return child, out_env

    if isinstance(plan, L.Join):
        lc, lenv = _canon_plan(plan.left, st, exact)
        rc, renv = _canon_plan(plan.right, st, exact)
        combined: Dict[str, str] = {}
        for k, v in lenv.items():
            combined[k] = f"L:{v}"
        for k, v in renv.items():
            combined[k] = f"B:{combined[k]}|R:{v}" if k in combined else f"R:{v}"
        cond = _canon_expr(plan.condition, combined, st, exact, "J")
        resid = (
            _canon_expr(plan.residual, _join_out_env(plan, lenv, renv), st, True, "Jr")
            if plan.residual is not None
            else ""
        )
        up = ""
        if plan.using_pairs:
            up = ";".join(f"{combined.get(a, a)}~{combined.get(b, b)}" for a, b in plan.using_pairs)
        out_env = _join_out_env(plan, lenv, renv)
        return f"Join[{plan.how};{cond};resid={resid};using={up}]({lc})({rc})", out_env

    if isinstance(plan, (L.Union, L.BucketUnion)):
        parts, env0 = [], None
        for c in plan.children():
            cc, cenv = _canon_plan(c, st, exact)
            parts.append(cc)
            if env0 is None:
                env0 = cenv
        tag = type(plan).__name__
        return f"{tag}[{';'.join(parts)}]", env0 or {}

    if isinstance(plan, L.SetOp):
        lc, lenv = _canon_plan(plan.left, st, exact)
        rc, _renv = _canon_plan(plan.right, st, exact)
        return f"SetOp[{plan.kind}]({lc})({rc})", lenv

    if isinstance(plan, L.Aggregate):
        child, env = _canon_plan(plan.child, st, exact)
        keys = [env.get(k, f"ext:{k}") for k in plan.keys]
        out_env = {k: env.get(k, f"ext:{k}") for k in plan.keys}
        parts = []
        for name, fn, col_ in plan.aggs:
            tok = f"{fn}({env.get(col_, col_) if col_ is not None else '*'})"
            out_env[name] = f"<{tok}#{len(parts)}>"
            parts.append(tok)
        return f"Aggregate[{','.join(keys)};{';'.join(parts)}]({child})", out_env

    if isinstance(plan, L.Window):
        child, env = _canon_plan(plan.child, st, exact)
        out_env = dict(env)
        parts = []
        for out, fn, arg, pcols, orders, cumulative in plan.specs:
            tok = (
                f"{fn}({env.get(arg, arg) if arg else ''})"
                f"p={[env.get(c, c) for c in (pcols or [])]}"
                f"o={[(env.get(c, c), a) for c, a in (orders or [])]}cum={bool(cumulative)}"
            )
            out_env[out] = f"<{tok}#{len(parts)}>"
            parts.append(tok)
        return f"Window[{';'.join(parts)}]({child})", out_env

    if isinstance(plan, L.Sort):
        child, env = _canon_plan(plan.child, st, exact)
        keys = [(env.get(c, f"ext:{c}"), bool(a)) for c, a in plan.keys]
        return f"Sort[{keys}]({child})", env

    if isinstance(plan, L.Limit):
        child, env = _canon_plan(plan.child, st, exact)
        # LIMIT count is structural: it changes result cardinality, and
        # nothing downstream re-binds it at run time
        return f"Limit[{plan.n}]({child})", env

    if isinstance(plan, L.Repartition):
        child, env = _canon_plan(plan.child, st, exact)
        bs = plan.bucket_spec
        return (
            f"Repartition[{bs.num_buckets};{list(bs.bucket_columns)};{list(bs.sort_columns)}]({child})",
            env,
        )

    # unknown node: positional fallback on describe() + children (exact-only
    # sharing — describe embeds the node's values)
    parts = []
    env_last: Dict[str, str] = {}
    for c in plan.children():
        cc, env_last = _canon_plan(c, st, exact)
        parts.append(cc)
    return f"{type(plan).__name__}[{plan.describe()}]({';'.join(parts)})", env_last


def _join_out_env(plan: L.Join, lenv: Dict[str, str], renv: Dict[str, str]) -> Dict[str, str]:
    out_names, rename = L.join_output_names(plan.left.output_columns, plan.right.output_columns)
    env: Dict[str, str] = {}
    for c in plan.left.output_columns:
        env[c] = f"L:{lenv.get(c, c)}"
    for c in plan.right.output_columns:
        env[rename.get(c, c)] = f"R:{renv.get(c, c)}"
    return env


# --- public surface ---------------------------------------------------------


@dataclass(frozen=True)
class Fingerprint:
    """Canonical identity of one query plan.

    ``structure`` hashes the literal-parameterized canonical form; plans that
    differ only in bound literals (or in column aliases) share it.
    ``literals`` is the slot-ordered literal vector; ``slot_sigs`` are the
    per-slot context signatures used to align template slots at bind time.
    """

    structure: str
    literals: Tuple[Any, ...]
    slot_sigs: Tuple[str, ...]
    output_columns: Tuple[str, ...]
    has_subquery: bool

    @property
    def exact(self) -> str:
        h = hashlib.sha1(self.structure.encode())
        for v in self.literals:
            h.update(b"\x00")
            h.update(_lit_token(v).encode())
        return h.hexdigest()


def plan_fingerprint(plan: L.LogicalPlan) -> Fingerprint:
    """Fingerprint ``plan``. Deterministic within a process for a fixed set of
    source relations (relation identity is path-based)."""
    st = _Canon()
    canon, _env = _canon_plan(plan, st)
    return Fingerprint(
        structure=hashlib.sha1(canon.encode()).hexdigest(),
        literals=tuple(st.lits),
        slot_sigs=tuple(st.sigs),
        output_columns=tuple(plan.output_columns),
        has_subquery=st.has_subquery,
    )


def canonical_form(plan: L.LogicalPlan) -> str:
    """The raw canonical string (debugging / tests)."""
    return _canon_plan(plan, _Canon())[0]


# --- literal binding --------------------------------------------------------


def slot_mapping(template_fp: Fingerprint, request_fp: Fingerprint) -> List[int]:
    """Map each *template* slot to the *request* slot it must be bound from.

    Matches by context signature alone (the request's literal VALUES differ
    from the template's by design — that's the point of parameterization).
    Strictness guards correctness: signatures must be unique on both sides
    and must cover each other exactly — any ambiguity (two slots in the same
    context) or a dropped/synthesized literal raises ``Unparameterizable``
    and the cache falls back to exact keying.
    """
    req: Dict[str, int] = {}
    for j, sig in enumerate(request_fp.slot_sigs):
        if sig in req:
            raise Unparameterizable(f"ambiguous request literal slot {sig!r}")
        req[sig] = j
    seen = set()
    mapping = []
    for sig in template_fp.slot_sigs:
        if sig in seen:
            raise Unparameterizable(f"ambiguous template literal slot {sig!r}")
        seen.add(sig)
        j = req.get(sig)
        if j is None:
            raise Unparameterizable(f"template literal {sig!r} not present in request")
        mapping.append(j)
    if len(seen) != len(req):
        # a request literal the template never consumes: the optimized plan
        # may have encoded it some other way — do not share
        raise Unparameterizable("request literal unused by template")
    return mapping


def _bind_expr(e: Expr, values: List[Any], pos: List[int]) -> Expr:
    """Rebuild ``e`` with slot-eligible literals replaced positionally from
    ``values``. Walk order MUST mirror ``_canon_expr``'s slot collection; the
    same node types participate, all others pass through untouched."""
    if isinstance(e, Lit):
        i = pos[0]
        pos[0] += 1
        return Lit(values[i])
    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, _bind_expr(e.left, values, pos), _bind_expr(e.right, values, pos))
    if isinstance(e, Not):
        return Not(_bind_expr(e.child, values, pos))
    if isinstance(e, IsNull):
        return IsNull(_bind_expr(e.child, values, pos))
    if isinstance(e, In):
        return In(e.child, [_bind_expr(v, values, pos) for v in e.values])
    return e


def count_slots(e: Expr) -> int:
    """Number of slot-eligible literals ``_canon_expr``/``_bind_expr`` see in
    ``e`` (binding sanity check)."""
    if isinstance(e, Lit):
        return 1
    if isinstance(e, BinaryOp):
        return count_slots(e.left) + count_slots(e.right)
    if isinstance(e, (Not, IsNull)):
        return count_slots(e.child)
    if isinstance(e, In):
        return sum(count_slots(v) for v in e.values)
    return 0


def bind_literals(plan: L.LogicalPlan, slot_values: List[Any]) -> L.LogicalPlan:
    """Rebuild ``plan`` with its i-th literal slot bound to ``slot_values[i]``
    (template-slot order). Untouched subtrees keep identity, so cached scan
    nodes (and their tags) are shared across bound instances."""
    pos = [0]

    def walk(p: L.LogicalPlan) -> L.LogicalPlan:
        children = list(p.children())
        new_children = [walk(c) for c in children]
        q = p
        if any(nc is not c for nc, c in zip(new_children, children)):
            q = p.with_children(new_children)
        if isinstance(q, L.Filter):
            new_cond = _bind_expr(q.condition, slot_values, pos)
            q = L.Filter(new_cond, q.child)
        elif isinstance(q, L.Join):
            new_cond = _bind_expr(q.condition, slot_values, pos)
            q = L.Join(q.left, q.right, new_cond, q.how, q.residual, q.using_pairs)
        elif isinstance(q, L.Compute):
            new_exprs = [(n, _bind_expr(e, slot_values, pos)) for n, e in q.exprs]
            q = L.Compute(new_exprs, q.child)
        return q

    out = walk(plan)
    if pos[0] != len(slot_values):
        raise Unparameterizable(
            f"bound {pos[0]} slots but template has {len(slot_values)} literals"
        )
    return out
