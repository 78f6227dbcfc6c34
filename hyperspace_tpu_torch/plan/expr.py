"""Expression tree.

A deliberately small expression language — exactly what the optimizer rules
need: column refs, literals, comparisons, boolean connectives, arithmetic,
``isin``/``is_null``, and ``input_file_name()`` (used for lineage, ref:
HS/index/covering/CoveringIndex.scala:239-273). This replaces the slice of
Spark Catalyst expressions the reference operates on; scope intentionally kept
to what ``JoinPlanNodeFilter`` accepts (ref: HS/index/covering/JoinIndexRule.scala:135-155).

Expressions evaluate over a column batch: a dict ``name -> numpy array``.
Device-side evaluation compiles the same tree to jnp ops (see exec/device.py).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np

INPUT_FILE_NAME = "__input_file_name"

# Nested-field normalization prefix (ref: util/ResolverUtils.scala:44-105).
NESTED_PREFIX = "__hs_nested."


def strip_nested_prefix(name: str) -> str:
    """``__hs_nested.a.b`` -> ``a.b`` (identity for flat names)."""
    return name[len(NESTED_PREFIX):] if name.startswith(NESTED_PREFIX) else name


def get_column(batch: Dict[str, np.ndarray], name: str) -> Optional[np.ndarray]:
    """Canonical possibly-nested batch lookup used by eval, select, and join
    key materialization: exact key, case-insensitive key, the flat
    ``__hs_nested.``-prefixed copy an index scan carries, then struct
    extraction for dotted paths. None when nothing resolves."""
    if name in batch:
        return batch[name]
    lowered = name.lower()
    for k, v in batch.items():
        if k.lower() == lowered:
            return v
    if "." in name:
        stripped = strip_nested_prefix(name)
        if not name.startswith(NESTED_PREFIX):
            pref = (NESTED_PREFIX + name).lower()
            for k, v in batch.items():
                if k.lower() == pref:
                    return v
        return extract_nested_from_batch(batch, stripped)
    return None


def column_root_member(name: str, available) -> Optional[str]:
    """Case-insensitive membership of a (possibly dotted) column name in a
    set of flat names: a dotted name belongs where its root struct column is.
    Returns the resolved name (root exact-cased) or None."""
    lowered = {a.lower(): a for a in available}
    hit = lowered.get(name.lower())
    if hit is not None:
        return hit
    if "." in name:
        root, _, rest = name.partition(".")
        base = lowered.get(root.lower())
        if base is not None:
            return f"{base}.{rest}"
    return None


def extract_nested_from_batch(batch: Dict[str, np.ndarray], dotted: str) -> Optional[np.ndarray]:
    """Materialize a nested struct field (``a.b.c``) from a batch whose root
    column holds per-row dicts (how arrow struct columns decode host-side).
    Case-insensitive per path segment. None when the path doesn't resolve."""
    parts = dotted.split(".")
    root = None
    for k in batch:
        if k.lower() == parts[0].lower():
            root = batch[k]
            break
    if root is None or root.dtype != object:
        return None

    _MISSING = object()

    def dig(value, segs):
        for s in segs:
            if value is None:
                return None  # null struct row: field value is null
            if not isinstance(value, dict):
                return _MISSING  # path goes through a non-struct: unresolvable
            hit = next((kk for kk in value if kk.lower() == s.lower()), None)
            if hit is None:
                return _MISSING
            value = value[hit]
        return value

    vals = [dig(v, parts[1:]) for v in root]
    if any(v is _MISSING for v in vals):
        return None
    arr = np.asarray(vals)
    if arr.dtype == object:
        try:
            arr = np.asarray(vals, dtype=np.float64)
        except (TypeError, ValueError):
            pass
    return arr


class Expr:
    """Base expression node. Python comparison operators build trees, so
    identity-based hashing is retained explicitly."""

    def references(self) -> Set[str]:
        out: Set[str] = set()
        self._collect_refs(out)
        return out

    def _collect_refs(self, out: Set[str]) -> None:
        for c in self.children():
            c._collect_refs(out)

    def children(self) -> Sequence["Expr"]:
        return ()

    def eval(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        raise NotImplementedError

    # -- operator sugar ----------------------------------------------------
    def __eq__(self, other: Any) -> "Expr":  # type: ignore[override]
        return BinaryOp("=", self, _wrap(other))

    def __ne__(self, other: Any) -> "Expr":  # type: ignore[override]
        return BinaryOp("!=", self, _wrap(other))

    def __lt__(self, other: Any) -> "Expr":
        return BinaryOp("<", self, _wrap(other))

    def __le__(self, other: Any) -> "Expr":
        return BinaryOp("<=", self, _wrap(other))

    def __gt__(self, other: Any) -> "Expr":
        return BinaryOp(">", self, _wrap(other))

    def __ge__(self, other: Any) -> "Expr":
        return BinaryOp(">=", self, _wrap(other))

    def __and__(self, other: Any) -> "Expr":
        return BinaryOp("AND", self, _wrap(other))

    def __or__(self, other: Any) -> "Expr":
        return BinaryOp("OR", self, _wrap(other))

    def __invert__(self) -> "Expr":
        return Not(self)

    def __add__(self, other: Any) -> "Expr":
        return BinaryOp("+", self, _wrap(other))

    def __sub__(self, other: Any) -> "Expr":
        return BinaryOp("-", self, _wrap(other))

    def __mul__(self, other: Any) -> "Expr":
        return BinaryOp("*", self, _wrap(other))

    def __truediv__(self, other: Any) -> "Expr":
        return BinaryOp("/", self, _wrap(other))

    def __mod__(self, other: Any) -> "Expr":
        return BinaryOp("%", self, _wrap(other))

    def isin(self, *values: Any) -> "Expr":
        if len(values) == 1 and hasattr(values[0], "plan") and hasattr(values[0], "session"):
            # col.isin(df): uncorrelated IN-subquery over a one-column frame
            return InSubquery(self, values[0].plan, values[0].session)
        if len(values) == 1 and isinstance(values[0], (list, tuple, set)):
            values = tuple(values[0])
        return In(self, [(_wrap(v)) for v in values])

    def is_null(self) -> "Expr":
        return IsNull(self)

    def is_not_null(self) -> "Expr":
        return Not(IsNull(self))

    def __hash__(self) -> int:
        return id(self)

    def __bool__(self) -> bool:
        raise TypeError(
            "Cannot convert Expr to bool; use & | ~ for boolean connectives."
        )


class Col(Expr):
    def __init__(self, name: str):
        self.name = name

    def _collect_refs(self, out: Set[str]) -> None:
        out.add(self.name)

    def eval(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        got = get_column(batch, self.name)
        if got is None:
            raise KeyError(f"Column {self.name!r} not found in batch with columns {list(batch)}")
        return got

    def __repr__(self) -> str:
        return f"col({self.name!r})"


class Lit(Expr):
    def __init__(self, value: Any):
        self.value = value

    def eval(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        return np.asarray(self.value)

    def __repr__(self) -> str:
        return f"lit({self.value!r})"


class InputFileName(Expr):
    """Evaluates to the source file path of each row
    (ref: Spark's input_file_name(), used at HS/index/covering/CoveringIndex.scala:250)."""

    def eval(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        if INPUT_FILE_NAME not in batch:
            raise KeyError("input_file_name() requires a scan that tracks source files")
        return batch[INPUT_FILE_NAME]

    def __repr__(self) -> str:
        return "input_file_name()"


_COMPARES = {"=", "!=", "<", "<=", ">", ">="}
_ARITH = {"+", "-", "*", "/", "%"}


def _coerce_compare(l, r):
    """SQL-style implicit casts for comparisons: a string literal against a
    date column becomes a date (``d_date <= '2000-03-11'``), and an object
    array holding SQL NULLs (None) compared with numbers becomes float with
    NaN (NaN comparisons are False, matching NULL-is-unknown filtering)."""
    l_, r_ = np.asarray(l), np.asarray(r)
    lk, rk = l_.dtype, r_.dtype
    if lk.kind == "M" and rk.kind in ("U", "S", "O"):
        return l, r_.astype(l_.dtype)
    if rk.kind == "M" and lk.kind in ("U", "S", "O"):
        return l_.astype(r_.dtype), r
    if lk == object and rk.kind in ("i", "u", "f"):
        return _object_nums_to_float(l_), r
    if rk == object and lk.kind in ("i", "u", "f"):
        return l, _object_nums_to_float(r_)
    return l, r


def _maybe_add_months(l, r, op: str):
    """Calendar month/year intervals: ``date '1993-10-01' + interval '3'
    month`` (TPC-H predicates). numpy cannot add a month timedelta to a
    day-unit datetime, so months are applied on the month view with the
    day-of-month preserved (clamped to the target month's length, SQL
    semantics). Returns None when neither operand is a month interval."""
    l_, r_ = np.asarray(l), np.asarray(r)

    def is_month_td(a):
        return a.dtype.kind == "m" and np.datetime_data(a.dtype)[0] == "M"

    if l_.dtype.kind == "M" and is_month_td(r_):
        date, months = l_, r_.astype(np.int64)
    elif r_.dtype.kind == "M" and is_month_td(l_) and op == "+":
        date, months = r_, l_.astype(np.int64)
    else:
        return None
    if op == "-":
        months = -months
    d = date.astype("datetime64[D]")
    m = d.astype("datetime64[M]")
    day_off = (d - m.astype("datetime64[D]")).astype(np.int64)
    nm = m + months.astype("timedelta64[M]")
    month_len = (
        (nm + np.timedelta64(1, "M")).astype("datetime64[D]") - nm.astype("datetime64[D]")
    ).astype(np.int64)
    day_off = np.minimum(day_off, month_len - 1)
    shifted = nm.astype("datetime64[D]") + day_off.astype("timedelta64[D]")
    if np.datetime_data(date.dtype)[0] in ("D", "M", "Y", "W"):
        return shifted
    # timestamp columns: preserve the time-of-day remainder and the dtype
    tod = date - d.astype(date.dtype)
    return shifted.astype(date.dtype) + tod


def _missing_mask(v) -> np.ndarray:
    """Missing-value mask under the framework convention: NaN for floats,
    NaT for datetimes, None for object arrays; all-False otherwise."""
    a = np.asarray(v)
    if a.dtype.kind == "f":
        return np.isnan(a)
    if a.dtype.kind == "M":
        return np.isnat(a)
    if a.dtype == object:
        try:
            import pandas as pd

            # C-speed elementwise missing check (None/NaN/NaT/pd.NA — a
            # compatible superset of the framework convention); the Python
            # loop was a per-row hotspot on string-heavy predicates
            return np.asarray(pd.isna(a.ravel()), dtype=bool).reshape(a.shape)
        except (TypeError, ValueError):  # exotic elements (nested arrays)
            return np.array(
                [x is None or (isinstance(x, float) and x != x) for x in a.ravel()],
                dtype=bool,
            ).reshape(a.shape)
    return np.zeros(a.shape, dtype=bool)


def _object_fill(type_name: str):
    """Neutral stand-in for NULL slots while converting an object array (the
    real NULLs are re-applied after the conversion; see Cast.eval)."""
    if type_name == "date":
        return "1970-01-01"
    if type_name in ("string", "char", "varchar", "text") or type_name.startswith(("char", "varchar")):
        return ""
    return 0


def _object_nums_to_float(arr: np.ndarray):
    """None -> NaN for numeric object arrays; non-numeric arrays unchanged."""
    try:
        return np.array(
            [np.nan if v is None else float(v) for v in arr.ravel()], dtype=np.float64
        ).reshape(arr.shape)
    except (TypeError, ValueError):
        return arr


class BinaryOp(Expr):
    def __init__(self, op: str, left: Expr, right: Expr):
        self.op = op
        self.left = left
        self.right = right

    def children(self) -> Sequence[Expr]:
        return (self.left, self.right)

    def eval(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        op = self.op
        if l is EMPTY_SCALAR or r is EMPTY_SCALAR:
            # a zero-row scalar subquery is SQL NULL: comparisons yield NULL
            # (three-valued), arithmetic propagates as NaN; a boolean NULL in
            # AND/OR still Kleene-combines with the other side below
            other = r if l is EMPTY_SCALAR else l
            shape = () if other is EMPTY_SCALAR else np.shape(other)
            null = NullableBool.all_null(shape)
            if op in ("AND", "OR"):
                l = null if l is EMPTY_SCALAR else l
                r = null if r is EMPTY_SCALAR else r
            elif op in ("=", "!=", "<", "<=", ">", ">="):
                return null
            else:
                # arithmetic on SQL NULL stays NULL: keep the sentinel so a
                # downstream comparison yields three-valued NULL, not False
                return EMPTY_SCALAR
        if op == "AND":
            return _kleene_and(l, r)
        if op == "OR":
            return _kleene_or(l, r)
        if isinstance(l, NullableBool) or isinstance(r, NullableBool):
            # boolean-typed NULL compared with = / != : stay null-aware
            lv, lu = _parts(l)
            rv, ru = _parts(r)
            if op == "=":
                return NullableBool(lv == rv, lu | ru)
            if op == "!=":
                return NullableBool(lv != rv, lu | ru)
            raise ValueError(f"Operator {op!r} undefined for boolean NULL operands")
        if op in _COMPARES:
            l, r = _coerce_compare(l, r)
            res = {
                "=": lambda: np.asarray(l == r),
                "!=": lambda: np.asarray(l != r),
                "<": lambda: np.asarray(l < r),
                "<=": lambda: np.asarray(l <= r),
                ">": lambda: np.asarray(l > r),
                ">=": lambda: np.asarray(l >= r),
            }[op]()
            # SQL NULL-is-unknown: a comparison touching NULL (NaN/NaT under
            # the framework's missing-value convention) is three-valued, not
            # definite — in particular NULL != x must not come out True
            unknown = _missing_mask(l) | _missing_mask(r)
            if np.any(unknown):
                return NullableBool(res & ~unknown, unknown)
            return res
        if op in ("+", "-"):
            mres = _maybe_add_months(l, r, op)
            if mres is not None:
                return mres
        # NULL semantics make 0/0 and NULL-operand arithmetic legitimate
        # (the NaN result IS the SQL NULL); numpy's RuntimeWarnings for them
        # are noise at this boundary, not a signal
        with np.errstate(divide="ignore", invalid="ignore"):
            if op == "+":
                return l + r
            if op == "-":
                return l - r
            if op == "*":
                return l * r
            if op == "/":
                return l / r
            if op == "%":
                return l % r
        raise ValueError(f"Unknown op {op!r}")

    def __repr__(self) -> str:
        return f"({self.left!r} {self.op} {self.right!r})"


class Not(Expr):
    def __init__(self, child: Expr):
        self.child = child

    def children(self) -> Sequence[Expr]:
        return (self.child,)

    def eval(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        return _kleene_not(self.child.eval(batch))

    def __repr__(self) -> str:
        return f"(NOT {self.child!r})"


class IsNull(Expr):
    def __init__(self, child: Expr):
        self.child = child

    def children(self) -> Sequence[Expr]:
        return (self.child,)

    def eval(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        v = self.child.eval(batch)
        if v is EMPTY_SCALAR:
            # IS NULL on a zero-row scalar subquery: true for every batch row
            n = next((c.shape[0] for c in batch.values() if getattr(c, "ndim", 0)), None)
            return np.ones((), dtype=bool) if n is None else np.ones(n, dtype=bool)
        if isinstance(v, NullableBool):
            return np.array(v.unknown)  # IS NULL of a three-valued boolean
        # one definition of "missing" everywhere: NaN, NaT, or None
        return _missing_mask(v)

    def __repr__(self) -> str:
        return f"({self.child!r} IS NULL)"


class In(Expr):
    def __init__(self, child: Expr, values: List[Lit]):
        self.child = child
        self.values = values

    def children(self) -> Sequence[Expr]:
        return (self.child, *self.values)

    def eval(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        v = self.child.eval(batch)
        vals = [x.value for x in self.values]
        return _in_semantics(v, vals)

    def __repr__(self) -> str:
        return f"({self.child!r} IN {[v.value for v in self.values]!r})"


def _in_semantics(v, vals):
    """SQL three-valued IN: TRUE on a non-NULL match; UNKNOWN when the child
    is NULL or any list value is NULL and nothing matched; FALSE otherwise.
    Shared by ``In`` (literal list) and ``InSubquery`` so host semantics match
    the device predicate compiler's Kleene pairs (exec/device.py)."""
    vals = np.asarray(vals) if not isinstance(vals, np.ndarray) else vals
    if vals.dtype == object or vals.dtype.kind in ("f", "M"):
        val_missing = _missing_mask(vals)
        has_null_value = bool(val_missing.any())
        non_null = vals[~val_missing]
    else:
        has_null_value = False
        non_null = vals
    res = np.isin(v, non_null)
    unknown = (_missing_mask(v) | has_null_value) & ~res
    if np.any(unknown):
        return NullableBool(res & ~unknown, unknown)
    return res


#: sentinel returned by a scalar subquery with zero rows (SQL NULL)
EMPTY_SCALAR = object()

# Per-execution subquery memoization: one outer collect() may evaluate the
# same condition more than once (partition pruning, then the row filter);
# the scope caches each subquery's result for the duration of the OUTERMOST
# execute so the inner plan runs once per query, never across queries (data
# may change between collects).
_subquery_scope = threading.local()


@contextlib.contextmanager
def subquery_scope():
    depth = getattr(_subquery_scope, "depth", 0)
    if depth == 0:
        _subquery_scope.cache = {}
    _subquery_scope.depth = depth + 1
    try:
        yield
    finally:
        _subquery_scope.depth -= 1
        if _subquery_scope.depth == 0:
            _subquery_scope.cache = None


class NullableBool:
    """Three-valued boolean result (Kleene logic): ``value`` where known,
    ``unknown`` marking SQL-NULL positions. Produced by comparisons against a
    zero-row scalar subquery; collapses to plain False at filter time
    (``as_bool_mask``), so NOT/AND/OR over NULL behave as SQL requires
    (NOT NULL = NULL, NULL OR TRUE = TRUE, NULL AND FALSE = FALSE)."""

    def __init__(self, value: np.ndarray, unknown: np.ndarray):
        self.value = np.asarray(value, dtype=bool)
        self.unknown = np.asarray(unknown, dtype=bool)

    @classmethod
    def all_null(cls, shape) -> "NullableBool":
        return cls(np.zeros(shape, dtype=bool), np.ones(shape, dtype=bool))


def as_bool_mask(x) -> np.ndarray:
    """Collapse an eval result to a definite boolean mask (NULL -> False)."""
    if isinstance(x, NullableBool):
        return x.value & ~x.unknown
    return np.asarray(x, dtype=bool)


def split_conjuncts(e: "Expr") -> List["Expr"]:
    """Flatten a tree of AND nodes into its conjunct list (a non-AND
    expression is its own single conjunct)."""
    if isinstance(e, BinaryOp) and e.op == "AND":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


#: comparison operators a predicate atom may carry (plus "in" for IN-lists)
_ATOM_OPS = {"=", "!=", "<", "<=", ">", ">="}

_FLIP_OP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "!=": "!="}


def comparison_atom(e: "Expr"):
    """``(column, op, value)`` for a simple comparison conjunct — a
    column-vs-literal comparison (normalized to column-on-the-left) or an
    IN-list over literals, which yields ``(column, "in", frozenset)``.
    None for anything else: the caller must treat the conjunct as opaque.
    Used by the serving result cache to decide predicate subsumption."""
    if isinstance(e, BinaryOp) and e.op in _ATOM_OPS:
        if isinstance(e.left, Col) and isinstance(e.right, Lit):
            return (e.left.name, e.op, _atom_value(e.right.value))
        if isinstance(e.left, Lit) and isinstance(e.right, Col):
            return (e.right.name, _FLIP_OP[e.op], _atom_value(e.left.value))
        return None
    if isinstance(e, In) and isinstance(e.child, Col) and all(
        isinstance(v, Lit) for v in e.values
    ):
        try:
            return (e.child.name, "in", frozenset(_atom_value(v.value) for v in e.values))
        except TypeError:
            return None  # unhashable literal: opaque
    return None


def _atom_value(v):
    """Unwrap numpy scalars so atom values compare with plain Python
    semantics."""
    return v.item() if isinstance(v, np.generic) else v


def _kleene_not(x):
    if isinstance(x, NullableBool):
        return NullableBool(~x.value, x.unknown)
    return np.logical_not(x)


def _parts(x):
    if isinstance(x, NullableBool):
        return x.value, x.unknown
    v = np.asarray(x, dtype=bool)
    return v, np.zeros(v.shape, dtype=bool)


def _kleene_and(l, r):
    if not isinstance(l, NullableBool) and not isinstance(r, NullableBool):
        return np.logical_and(l, r)
    lv, lu = _parts(l)
    rv, ru = _parts(r)
    known_false = (~lu & ~lv) | (~ru & ~rv)
    unknown = (lu | ru) & ~known_false
    return NullableBool(lv & rv & ~unknown, unknown)


def _kleene_or(l, r):
    if not isinstance(l, NullableBool) and not isinstance(r, NullableBool):
        return np.logical_or(l, r)
    lv, lu = _parts(l)
    rv, ru = _parts(r)
    known_true = (~lu & lv) | (~ru & rv)
    unknown = (lu | ru) & ~known_true
    return NullableBool(known_true, unknown)


def _to_value_array(v):
    """Collapse a three-valued boolean into a value array (NULL -> None) so
    non-boolean consumers (CAST, scalar functions, CASE values) see the same
    NULL-carrying column a projection would produce."""
    if isinstance(v, NullableBool):
        if np.any(v.unknown):
            out = v.value.astype(object)
            out[np.broadcast_to(v.unknown, v.value.shape)] = None
            return out
        return v.value
    return v


def _broadcast_rows(v, n: int) -> np.ndarray:
    v = np.asarray(_to_value_array(v))
    return np.broadcast_to(v, (n,)) if v.ndim == 0 else v


def _batch_rows(batch: Dict[str, np.ndarray]) -> int:
    for c in batch.values():
        if getattr(c, "ndim", 0):
            return c.shape[0]
    return 1


class Case(Expr):
    """SQL CASE WHEN ... THEN ... [ELSE ...] END; the unmatched default is
    SQL NULL (NaN for numeric results, None for strings)."""

    def __init__(self, branches, otherwise: Optional[Expr]):
        self.branches = [(c, v) for c, v in branches]
        self.otherwise = otherwise

    def children(self) -> Sequence[Expr]:
        out = []
        for c, v in self.branches:
            out.extend((c, v))
        if self.otherwise is not None:
            out.append(self.otherwise)
        return tuple(out)

    def eval(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        n = _batch_rows(batch)
        conds = [np.broadcast_to(as_bool_mask(c.eval(batch)), (n,)) for c, _ in self.branches]
        vals = [_broadcast_rows(v.eval(batch), n) for _, v in self.branches]
        otherwise = self.otherwise
        if isinstance(otherwise, Lit) and otherwise.value is None:
            otherwise = None  # ELSE NULL == no ELSE; keeps numeric dtype (NaN)
        if otherwise is not None:
            default = _broadcast_rows(otherwise.eval(batch), n)
        elif any(v.dtype.kind in ("U", "S", "O") for v in vals):
            default = np.full(n, None, dtype=object)
        else:
            default = np.full(n, np.nan)
        return np.select(conds, vals, default=default)

    def __repr__(self) -> str:
        parts = [f"WHEN {c!r} THEN {v!r}" for c, v in self.branches]
        if self.otherwise is not None:
            parts.append(f"ELSE {self.otherwise!r}")
        return f"CASE {' '.join(parts)} END"


class Like(Expr):
    """SQL LIKE with % (any run) and _ (any one char) wildcards."""

    def __init__(self, child: Expr, pattern: str):
        import re as _re

        self.child = child
        self.pattern = pattern
        rx = "^" + _re.escape(pattern).replace("%", ".*").replace("_", ".") + "$"
        self._rx = _re.compile(rx)

    def children(self) -> Sequence[Expr]:
        return (self.child,)

    def eval(self, batch: Dict[str, np.ndarray]):
        v = np.asarray(self.child.eval(batch))
        value = np.array(
            [x is not None and self._rx.match(str(x)) is not None for x in v.ravel()],
            dtype=bool,
        )
        unknown = _missing_mask(v).ravel()
        if unknown.any():  # NULL LIKE p is unknown (so NOT LIKE excludes it too)
            return NullableBool(value, unknown)
        return value

    def __repr__(self) -> str:
        return f"({self.child!r} LIKE {self.pattern!r})"


class Cast(Expr):
    """SQL CAST(expr AS type); types: int/bigint, double/float/decimal,
    date, string/char/varchar."""

    def __init__(self, child: Expr, type_name: str):
        self.child = child
        self.type_name = type_name.lower()

    def children(self) -> Sequence[Expr]:
        return (self.child,)

    def eval(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        v = np.asarray(_to_value_array(self.child.eval(batch)))
        t = self.type_name
        missing = _missing_mask(v)
        has_missing = bool(np.any(missing))
        if v.dtype == object and has_missing:
            # NULL-free view for the conversion; NULLs re-applied after
            v = np.where(missing, _object_fill(t), v)
        if t in ("int", "integer", "bigint", "smallint", "tinyint"):
            if has_missing:  # CAST(NULL AS int) is NULL: int64 can't hold it
                out = np.trunc(v.astype(np.float64))  # int cast truncates
                out[missing] = np.nan
                return out
            return v.astype(np.int64)
        if t in ("double", "float", "real") or t.startswith("decimal") or t.startswith("numeric"):
            out = v.astype(np.float64)
            if has_missing:
                out[missing] = np.nan
            return out
        if t == "date":
            out = v.astype("datetime64[D]")
            if has_missing:
                out[missing] = np.datetime64("NaT")
            return out
        if t in ("string", "char", "varchar", "text") or t.startswith(("char", "varchar")):
            out = v.astype(object)
            out = np.array([None if m else str(x) for x, m in zip(out.ravel(), missing.ravel())], dtype=object)
            return out.reshape(v.shape)
        raise ValueError(f"Unsupported CAST target type {self.type_name!r}")

    def __repr__(self) -> str:
        return f"CAST({self.child!r} AS {self.type_name})"


class Func(Expr):
    """Scalar SQL function call with a numpy evaluation per function."""

    SUPPORTED = (
        "substr", "substring", "coalesce", "nullif", "abs", "round", "floor",
        "ceil", "ceiling", "upper", "lower", "trim", "length", "concat",
        # date parts and arithmetic (Spark SQL functions lake queries lean on)
        "year", "month", "day", "dayofmonth", "quarter", "date_add", "date_sub",
        "datediff", "last_day", "trunc",
        # conditional / string utilities
        "if", "replace", "lpad", "rpad", "instr", "ltrim", "rtrim",
        "greatest", "least", "sign", "sqrt", "exp", "ln", "log", "power", "pow", "mod",
    )

    def __init__(self, name: str, args: Sequence[Expr]):
        self.name = name.lower()
        if self.name not in self.SUPPORTED:
            raise ValueError(f"Unsupported function {name!r}")
        self.args = list(args)
        if self.name == "trunc" and (len(self.args) < 2 or not isinstance(self.args[1], Lit)):
            # validated at construction so the SQL front-end surfaces a clean
            # SqlError instead of an eval-time failure
            raise ValueError("trunc(date, unit) requires a literal unit string")

    def children(self) -> Sequence[Expr]:
        return tuple(self.args)

    def eval(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        n = _batch_rows(batch)
        vals = [_broadcast_rows(a.eval(batch), n) for a in self.args]
        f = self.name
        if f in ("substr", "substring"):
            # SQL/Spark semantics: position 1-based, 0 treated like 1,
            # negative positions count from the end, and length applies from
            # the (possibly out-of-range) start position before clamping —
            # substring('abcde', -8, 3) is '' (not 'abc')
            s, start = vals[0], vals[1]
            ln = vals[2] if len(vals) > 2 else None
            out = []
            for i, x in enumerate(s):
                if x is None:
                    out.append(None)
                    continue
                text = str(x)
                pos = int(start[i]) if start.ndim else int(start)
                st = (pos - 1) if pos > 0 else (len(text) + pos if pos < 0 else 0)
                if ln is None:
                    en = len(text)
                else:
                    ll = int(ln[i]) if getattr(ln, "ndim", 0) else int(ln)
                    en = st + ll
                st_c = max(st, 0)
                out.append(text[st_c : max(en, st_c)])
            return np.array(out, dtype=object)
        if f == "coalesce":
            out = vals[0].astype(object, copy=True) if vals[0].dtype == object else vals[0].copy()
            for v in vals[1:]:
                if out.dtype.kind not in ("O", "f", "M"):
                    break
                miss = _missing_mask(out)
                if not miss.any():
                    break
                out = np.where(miss, v, out)
            return out
        if f == "nullif":
            a, b = vals
            eq = a == b
            if a.dtype.kind == "f":
                return np.where(eq, np.nan, a)
            out = a.astype(object)
            out[eq] = None
            return out
        if f == "abs":
            return np.abs(vals[0])
        if f == "round":
            d = 0
            if len(self.args) > 1:
                a1 = self.args[1]
                if isinstance(a1, Lit):
                    d = int(a1.value)
                elif getattr(vals[1], "size", 0):
                    d = int(np.asarray(vals[1]).ravel()[0])
            # SQL ROUND is HALF_UP (away from zero): round(2.5) = 3, while
            # np.round is banker's half-to-even (np.round(2.5) = 2)
            src = np.asarray(vals[0])
            v = src.astype(np.float64)
            scale = 10.0 ** d
            out = np.sign(v) * np.floor(np.abs(v) * scale + 0.5) / scale
            if src.dtype.kind in ("i", "u"):  # int in -> int out (Spark)
                return out.astype(src.dtype)
            return out
        if f == "floor":
            return np.floor(vals[0])
        if f in ("ceil", "ceiling"):
            return np.ceil(vals[0])
        if f == "upper":
            return np.array([None if x is None else str(x).upper() for x in vals[0]], dtype=object)
        if f == "lower":
            return np.array([None if x is None else str(x).lower() for x in vals[0]], dtype=object)
        if f == "trim":
            return np.array([None if x is None else str(x).strip() for x in vals[0]], dtype=object)
        if f == "length":
            # NULL in -> NULL out (NaN under the missing-value convention)
            return np.array(
                [np.nan if x is None else float(len(str(x))) for x in vals[0]], dtype=np.float64
            )
        if f == "concat":
            # SQL concat: any NULL operand -> NULL result
            missing = _missing_mask(vals[0])
            out = np.where(missing, "", vals[0].astype(str)).astype(object)
            for v in vals[1:]:
                m = _missing_mask(v)
                missing = missing | m
                out = np.char.add(out.astype(str), np.where(m, "", v.astype(str))).astype(object)
            if missing.any():
                out[missing] = None
            return out
        if f in ("year", "month", "day", "dayofmonth", "quarter"):
            d = np.asarray(vals[0]).astype("datetime64[D]")
            nat = np.isnat(d)
            y = d.astype("datetime64[Y]").astype(np.int64) + 1970
            if f == "year":
                out = y.astype(np.float64)
            else:
                mo = (d.astype("datetime64[M]").astype(np.int64) % 12) + 1
                if f == "month":
                    out = mo.astype(np.float64)
                elif f == "quarter":
                    out = ((mo - 1) // 3 + 1).astype(np.float64)
                else:  # day / dayofmonth
                    out = (d - d.astype("datetime64[M]").astype("datetime64[D]")).astype(
                        np.int64
                    ).astype(np.float64) + 1
            if nat.any():
                out[nat] = np.nan
            return out
        if f in ("date_add", "date_sub"):
            d = np.asarray(vals[0]).astype("datetime64[D]")
            nd = np.asarray(vals[1])
            delta = np.where(np.isnan(nd.astype(np.float64)), 0, nd).astype(np.int64)
            sign = 1 if f == "date_add" else -1
            out = d + (sign * delta).astype("timedelta64[D]")
            bad = np.isnat(d) | _missing_mask(nd)
            if bad.any():
                out[bad] = np.datetime64("NaT")
            return out
        if f == "datediff":
            a = np.asarray(vals[0]).astype("datetime64[D]")
            b = np.asarray(vals[1]).astype("datetime64[D]")
            out = (a - b).astype(np.int64).astype(np.float64)
            bad = np.isnat(a) | np.isnat(b)
            if bad.any():
                out[bad] = np.nan
            return out
        if f == "last_day":
            d = np.asarray(vals[0]).astype("datetime64[D]")
            m = d.astype("datetime64[M]")
            out = (m + np.timedelta64(1, "M")).astype("datetime64[D]") - np.timedelta64(1, "D")
            nat = np.isnat(d)
            if nat.any():
                out[nat] = np.datetime64("NaT")
            return out
        if f == "trunc":
            if len(self.args) < 2 or not isinstance(self.args[1], Lit):
                raise ValueError("trunc(date, unit) requires a literal unit string")
            d = np.asarray(vals[0]).astype("datetime64[D]")
            unit = str(self.args[1].value).lower()
            if unit in ("year", "yyyy", "yy"):
                out = d.astype("datetime64[Y]").astype("datetime64[D]")
            elif unit in ("month", "mon", "mm"):
                out = d.astype("datetime64[M]").astype("datetime64[D]")
            else:
                raise ValueError(f"trunc: unsupported unit {unit!r}")
            nat = np.isnat(d)
            if nat.any():
                out[nat] = np.datetime64("NaT")
            return out
        if f == "if":
            # vals[0] already holds the evaluated condition (NULL -> None
            # via _to_value_array); NULL conditions take the else arm
            c0 = vals[0]
            if c0.dtype == object:
                cond = np.array([v is not None and bool(v) for v in c0], dtype=bool)
            elif c0.dtype.kind == "f":
                cond = ~np.isnan(c0) & (c0 != 0)
            else:
                cond = c0.astype(bool)
            return np.where(cond, vals[1], vals[2])
        if f == "replace":
            # all arguments are per-row (columns or broadcast literals)
            repl = vals[2] if len(vals) > 2 else np.full(n, "", dtype=object)
            return np.array(
                [
                    None if (x is None or sr is None or rp is None)
                    else str(x).replace(str(sr), str(rp))
                    for x, sr, rp in zip(vals[0], vals[1], repl)
                ],
                dtype=object,
            )
        if f in ("lpad", "rpad"):
            pads = vals[2] if len(vals) > 2 else np.full(n, " ", dtype=object)
            widths = vals[1]
            out = []
            for x, w, p in zip(vals[0], widths, pads):
                if x is None or p is None or (isinstance(w, float) and w != w):
                    out.append(None)
                    continue
                s, width, pad = str(x), int(w), str(p)
                if len(s) >= width:
                    out.append(s[:width])
                else:
                    fill = (pad * width)[: width - len(s)] if pad else ""
                    out.append(fill + s if f == "lpad" else s + fill)
            return np.array(out, dtype=object)
        if f == "instr":
            return np.array(
                [
                    np.nan if (x is None or sr is None) else float(str(x).find(str(sr)) + 1)
                    for x, sr in zip(vals[0], vals[1])
                ],
                dtype=np.float64,
            )
        if f in ("ltrim", "rtrim"):
            strip = (lambda s: s.lstrip()) if f == "ltrim" else (lambda s: s.rstrip())
            return np.array(
                [None if x is None else strip(str(x)) for x in vals[0]], dtype=object
            )
        if f in ("greatest", "least"):
            pick = np.fmax if f == "greatest" else np.fmin
            out = np.asarray(vals[0], dtype=np.float64)
            for v in vals[1:]:
                out = pick(out, np.asarray(v, dtype=np.float64))
            return out
        if f == "sign":
            return np.sign(np.asarray(vals[0], dtype=np.float64))
        if f == "sqrt":
            # sqrt(negative) / log(0) / 0^-1 produce NaN/inf under SQL NULL
            # semantics on purpose; keep numpy's RuntimeWarnings out of user
            # output at this evaluation boundary
            with np.errstate(invalid="ignore"):
                return np.sqrt(np.asarray(vals[0], dtype=np.float64))
        if f == "exp":
            return np.exp(np.asarray(vals[0], dtype=np.float64))
        if f in ("ln", "log"):
            with np.errstate(divide="ignore", invalid="ignore"):
                if f == "log" and len(vals) > 1:  # log(base, expr), Spark-style
                    return np.log(np.asarray(vals[1], dtype=np.float64)) / np.log(
                        np.asarray(vals[0], dtype=np.float64)
                    )
                return np.log(np.asarray(vals[0], dtype=np.float64))
        if f in ("power", "pow"):
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.power(np.asarray(vals[0], dtype=np.float64), vals[1])
        if f == "mod":
            # same boundary stance as the % operator above: MOD(x, 0) is
            # SQL NULL (NaN), not a numpy RuntimeWarning
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.mod(vals[0], vals[1])
        raise ValueError(f"Unsupported function {self.name!r}")

    def __repr__(self) -> str:
        return f"{self.name}({', '.join(repr(a) for a in self.args)})"


class SubqueryExpr(Expr):
    """Uncorrelated subquery carrying an inner relational plan.

    The reference delegates subquery planning to Spark and its rules rewrite
    the *inner* scans transparently (explain golden
    src/test/resources/expected/spark-2.4/subquery.txt); here the IR carries
    the inner plan itself and ``ApplyHyperspace`` recurses into it, so index
    rewrites apply inside subqueries exactly as they do at top level.
    Correlated subqueries are out of scope (as are they for the reference's
    rules, which never see the correlation)."""

    def __init__(self, plan, session):
        self.plan = plan
        self.session = session

    def with_plan(self, plan) -> "SubqueryExpr":
        return type(self)(plan, self.session)

    def _values(self) -> np.ndarray:
        from hyperspace_tpu_torch.exec.executor import Executor

        cache = getattr(_subquery_scope, "cache", None)
        if cache is not None and id(self) in cache:
            return cache[id(self)]
        out_cols = list(self.plan.output_columns)
        if len(out_cols) != 1:
            raise ValueError(f"subquery must return exactly one column, got {out_cols!r}")
        vals = Executor(self.session).execute(self.plan, required_columns=out_cols)[out_cols[0]]
        if cache is not None:
            cache[id(self)] = vals
        return vals

    def plan_summary(self) -> str:
        nodes: List[str] = []

        def walk(p) -> None:
            nodes.append(p.describe())
            for c in p.children():
                walk(c)

        walk(self.plan)
        return " / ".join(nodes)


class ScalarSubquery(SubqueryExpr):
    """Single-value subquery usable as a comparison operand
    (``col("a") == df2.filter(...).select("b").as_scalar()``)."""

    def eval(self, batch: Dict[str, np.ndarray]):
        v = self._values()
        if len(v) > 1:
            raise ValueError(f"scalar subquery returned {len(v)} rows, expected at most 1")
        if len(v) == 0:
            return EMPTY_SCALAR
        return np.asarray(v[0])

    def __repr__(self) -> str:
        return f"scalar-subquery[{self.plan_summary()}]"


class InSubquery(SubqueryExpr):
    """Semi-join membership test (``col("a").isin(df2.select("b"))``)."""

    def __init__(self, child: Expr, plan, session):
        super().__init__(plan, session)
        self.child = child

    def children(self) -> Sequence[Expr]:
        return (self.child,)

    def with_plan(self, plan) -> "InSubquery":
        return InSubquery(self.child, plan, self.session)

    def eval(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        return _in_semantics(self.child.eval(batch), np.asarray(self._values()))

    def __repr__(self) -> str:
        return f"({self.child!r} IN subquery[{self.plan_summary()}])"


class CorrelatedScalarSubquery(SubqueryExpr):
    """Decorrelated correlated scalar subquery (the reference gets these from
    Spark's RewriteCorrelatedScalarSubquery; TPC-DS q1/q6/q30/q32/q41/q81/q92).

    The inner plan is the subquery grouped by its correlation keys
    (``key_cols``) with the scalar item as ``value_col``; eval maps each
    outer row's correlation-key tuple to the group's value. A missing group
    (or a NULL outer key — equality with NULL never matches) yields
    ``default``: SQL NULL normally, 0 for a bare COUNT (the classic
    count-bug: COUNT over zero rows is 0, not NULL)."""

    def __init__(self, outer_keys, plan, key_cols, value_col: str, default, session):
        super().__init__(plan, session)
        self.outer_keys = list(outer_keys)
        self.key_cols = list(key_cols)
        self.value_col = value_col
        self.default = default  # None => SQL NULL

    def children(self) -> Sequence[Expr]:
        return tuple(self.outer_keys)

    def with_plan(self, plan) -> "CorrelatedScalarSubquery":
        return CorrelatedScalarSubquery(
            self.outer_keys, plan, self.key_cols, self.value_col, self.default, self.session
        )

    def _exec_inner(self):
        from hyperspace_tpu_torch.exec.executor import Executor

        cache = getattr(_subquery_scope, "cache", None)
        if cache is not None and id(self) in cache:
            return cache[id(self)]
        cols = [*self.key_cols, self.value_col]
        got = Executor(self.session).execute(self.plan, required_columns=cols)
        if cache is not None:
            cache[id(self)] = got
        return got

    def eval(self, batch: Dict[str, np.ndarray]):
        import pandas as pd

        inner = self._exec_inner()
        n = _batch_rows(batch)
        knames = [f"__k{i}" for i in range(len(self.key_cols))]
        okeys = [_broadcast_rows(k.eval(batch), n) for k in self.outer_keys]
        left = pd.DataFrame({kn: k for kn, k in zip(knames, okeys)})
        left["__row"] = np.arange(n)
        right = pd.DataFrame({kn: np.asarray(inner[kc]) for kn, kc in zip(knames, self.key_cols)})
        right["__v"] = np.asarray(inner[self.value_col])
        # NULL correlation keys never match (pandas merge would match NaN=NaN)
        omiss = np.zeros(n, dtype=bool)
        for k in okeys:
            omiss |= _missing_mask(k)
        imiss = np.zeros(len(right), dtype=bool)
        for kc in self.key_cols:
            imiss |= _missing_mask(np.asarray(inner[kc]))
        if imiss.any():
            right = right[~imiss]
        merged = left.merge(right, on=knames, how="left", indicator=True)
        if len(merged) != n:
            raise ValueError(
                "correlated scalar subquery returned more than one row per correlation key"
            )
        merged = merged.sort_values("__row", kind="stable")
        vals = merged["__v"].to_numpy()
        missing = (merged["_merge"].to_numpy() == "left_only") | omiss
        if missing.any():
            fill = np.nan if self.default is None else self.default
            if vals.dtype == object:
                vals = vals.copy()
                vals[missing] = None if self.default is None else self.default
            elif np.issubdtype(vals.dtype, np.datetime64):
                # keep the datetime dtype — casting to float64 would leak raw
                # epoch numbers into downstream date comparisons
                vals = vals.copy()
                vals[missing] = (
                    np.datetime64("NaT") if self.default is None else self.default
                )
            else:
                vals = vals.astype(np.float64, copy=True)
                vals[missing] = fill
        return vals

    def __repr__(self) -> str:
        return f"correlated-scalar-subquery[keys={self.key_cols}; {self.plan_summary()}]"


def _correlation_frames(outer_keys, key_cols, inner, batch):
    """Shared scaffolding for the correlated subquery marks: broadcast and
    evaluate the outer correlation keys, build the outer (left) frame with a
    ``__row`` id, the inner (right) frame keyed by ``key_cols``, and the
    NULL-key masks (a NULL correlation key never matches on either side).
    Returns (n, left_df, right_df, outer_null_mask, inner_null_mask); right
    rows with NULL keys are already dropped, and ``inner_null_mask`` (over
    the UNFILTERED inner rows) lets callers align extra inner columns with
    the filtered right frame."""
    import pandas as pd

    n = _batch_rows(batch)
    okeys = [_broadcast_rows(k.eval(batch), n) for k in outer_keys]
    omiss = np.zeros(n, dtype=bool)
    for k in okeys:
        omiss |= _missing_mask(k)
    left = pd.DataFrame({kc: k for kc, k in zip(key_cols, okeys)})
    left["__row"] = np.arange(n)
    right = pd.DataFrame({kc: np.asarray(inner[kc]) for kc in key_cols})
    imiss = np.zeros(len(right), dtype=bool)
    for kc in key_cols:
        imiss |= _missing_mask(np.asarray(inner[kc]))
    if imiss.any():
        right = right[~imiss]
    return n, left, right, omiss, imiss


class ExistsSubquery(SubqueryExpr):
    """Decorrelated EXISTS mark (semi-join membership; the reference gets
    these from Spark's RewritePredicateSubquery as left-semi/anti joins;
    TPC-DS q10/q16/q35/q69/q94).

    ``outer_keys[i] = inner key_cols[i]`` are the equi-correlation pairs.
    ``residual`` (optional) is a predicate over the matched pair, referencing
    inner columns by their projected names and outer values through the
    ``residual_outer`` placeholder columns (q16/q94's
    ``cs1.cs_warehouse_sk <> cs2.cs_warehouse_sk``). EXISTS is two-valued —
    TRUE/FALSE, never unknown — so NOT EXISTS is the plain Not wrapper."""

    def __init__(self, outer_keys, plan, key_cols, residual, residual_outer, session):
        super().__init__(plan, session)
        self.outer_keys = list(outer_keys)
        self.key_cols = list(key_cols)
        self.residual = residual
        self.residual_outer = list(residual_outer)  # [(placeholder, outer Expr)]

    def children(self) -> Sequence[Expr]:
        return tuple(self.outer_keys) + tuple(e for _, e in self.residual_outer)

    def with_plan(self, plan) -> "ExistsSubquery":
        return ExistsSubquery(
            self.outer_keys, plan, self.key_cols, self.residual, self.residual_outer, self.session
        )

    def _exec_inner(self):
        from hyperspace_tpu_torch.exec.executor import Executor

        cache = getattr(_subquery_scope, "cache", None)
        if cache is not None and id(self) in cache:
            return cache[id(self)]
        got = Executor(self.session).execute(
            self.plan, required_columns=list(self.plan.output_columns)
        )
        if cache is not None:
            cache[id(self)] = got
        return got

    def eval(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        inner = self._exec_inner()
        if not self.key_cols:
            # uncorrelated EXISTS: a constant row-existence mark
            any_row = any(getattr(c, "shape", (0,))[0] for c in inner.values())
            return np.full(_batch_rows(batch), bool(any_row))
        n, left, right, omiss, imiss = _correlation_frames(
            self.outer_keys, self.key_cols, inner, batch
        )
        for ph, e in self.residual_outer:
            left[ph] = _broadcast_rows(e.eval(batch), n)
        for c in inner:  # residual inner columns ride along
            if c not in self.key_cols and not c.startswith("__input"):
                col_ = np.asarray(inner[c])
                right[c] = col_[~imiss] if imiss.any() else col_
        merged = left.merge(right, on=self.key_cols, how="inner")
        mask = np.zeros(n, dtype=bool)
        if len(merged):
            if self.residual is not None:
                mbatch = {c: merged[c].to_numpy() for c in merged.columns}
                keep = as_bool_mask(self.residual.eval(mbatch))
                rows = merged["__row"].to_numpy()[keep]
            else:
                rows = merged["__row"].to_numpy()
            mask[np.unique(rows)] = True
        mask &= ~omiss  # a NULL correlation key can never match
        return mask

    def __repr__(self) -> str:
        res = f", residual={self.residual!r}" if self.residual is not None else ""
        return f"exists-subquery[keys={self.key_cols}{res}; {self.plan_summary()}]"


class CorrelatedInSubquery(SubqueryExpr):
    """Decorrelated correlated IN: ``x IN (SELECT v FROM ... WHERE
    outer.k = inner.k AND ...)`` with full three-valued SQL semantics per
    outer row over its correlation group S = {v of matching inner rows}:
    TRUE on a non-NULL match; UNKNOWN when nothing matched but S contains
    NULL, or x is NULL and S is non-empty; FALSE otherwise (including empty
    S, even for NULL x). NOT IN composes through Kleene Not (the reference
    gets this from Spark's null-aware anti join)."""

    def __init__(self, child: Expr, outer_keys, plan, key_cols, value_col: str, session):
        super().__init__(plan, session)
        self.child = child
        self.outer_keys = list(outer_keys)
        self.key_cols = list(key_cols)
        self.value_col = value_col

    def children(self) -> Sequence[Expr]:
        return (self.child, *self.outer_keys)

    def with_plan(self, plan) -> "CorrelatedInSubquery":
        return CorrelatedInSubquery(
            self.child, self.outer_keys, plan, self.key_cols, self.value_col, self.session
        )

    def _exec_inner(self):
        from hyperspace_tpu_torch.exec.executor import Executor

        cache = getattr(_subquery_scope, "cache", None)
        if cache is not None and id(self) in cache:
            return cache[id(self)]
        cols = [*self.key_cols, self.value_col]
        got = Executor(self.session).execute(self.plan, required_columns=cols)
        if cache is not None:
            cache[id(self)] = got
        return got

    def eval(self, batch: Dict[str, np.ndarray]):
        inner = self._exec_inner()
        n, left, right, omiss, imiss = _correlation_frames(
            self.outer_keys, self.key_cols, inner, batch
        )
        x = _broadcast_rows(self.child.eval(batch), n)
        x_null = _missing_mask(x)
        left["__x"] = x
        vals = np.asarray(inner[self.value_col])
        vnull_all = _missing_mask(vals)
        if imiss.any():
            vals, vnull_all = vals[~imiss], vnull_all[~imiss]
        right["__v"] = vals
        right["__vnull"] = vnull_all
        value = np.zeros(n, dtype=bool)
        unknown = np.zeros(n, dtype=bool)
        if len(right):
            merged = left.merge(right, on=self.key_cols)
            if len(merged):
                mx = merged["__x"].to_numpy()
                mv = merged["__v"].to_numpy()
                vnull = merged["__vnull"].to_numpy(dtype=bool)
                both = ~(_missing_mask(mx) | vnull)
                pair_match = np.zeros(len(merged), dtype=bool)
                pair_match[both] = mx[both] == mv[both]
                rows = merged["__row"].to_numpy()
                np.logical_or.at(value, rows, pair_match)
                has_null_in_group = np.zeros(n, dtype=bool)
                np.logical_or.at(has_null_in_group, rows, vnull)
                nonempty = np.zeros(n, dtype=bool)
                nonempty[np.unique(rows)] = True
                unknown = ~value & (has_null_in_group | (x_null & nonempty))
        # NULL outer correlation key: the correlation equality is never true,
        # so S is empty -> definite FALSE
        value &= ~omiss
        unknown &= ~omiss
        if unknown.any():
            return NullableBool(value, unknown)
        return value

    def __repr__(self) -> str:
        return f"({self.child!r} IN correlated-subquery[keys={self.key_cols}; {self.plan_summary()}])"


def _wrap(x: Any) -> Expr:
    return x if isinstance(x, Expr) else Lit(x)


def col(name: str) -> Col:
    return Col(name)


def lit(value: Any) -> Lit:
    return Lit(value)


def input_file_name() -> InputFileName:
    return InputFileName()


# --- analysis helpers used by optimizer rules ------------------------------

def contains_input_file_name(e: Expr) -> bool:
    """True if the expression references input_file_name(). Index rewrites
    must bail out on such predicates: after the rewrite the function would
    evaluate to *index* file paths, silently changing results."""
    if isinstance(e, InputFileName):
        return True
    return any(contains_input_file_name(c) for c in e.children())


def split_conjunctive(e: Expr) -> List[Expr]:
    """Split a predicate on top-level ANDs (CNF split used by
    FilterIndexRule/JoinIndexRule; ref: HS/index/covering/JoinIndexRule.scala:149-155)."""
    if isinstance(e, BinaryOp) and e.op == "AND":
        return split_conjunctive(e.left) + split_conjunctive(e.right)
    return [e]


def extract_equi_join_keys(e: Expr) -> Optional[List[tuple]]:
    """If ``e`` is a conjunction of ``col = col`` terms, return the (left, right)
    column-name pairs; else None (ref: JoinPlanNodeFilter's equi-join CNF check,
    HS/index/covering/JoinIndexRule.scala:135-155)."""
    pairs = []
    for term in split_conjunctive(e):
        if isinstance(term, BinaryOp) and term.op == "=" and isinstance(term.left, Col) and isinstance(term.right, Col):
            pairs.append((term.left.name, term.right.name))
        else:
            return None
    return pairs


def extract_eq_literal(e: Expr) -> Optional[tuple]:
    """If ``e`` is ``col = lit`` or ``lit = col``, return (col_name, value)."""
    if isinstance(e, BinaryOp) and e.op == "=":
        if isinstance(e.left, Col) and isinstance(e.right, Lit):
            return (e.left.name, e.right.value)
        if isinstance(e.right, Col) and isinstance(e.left, Lit):
            return (e.right.name, e.left.value)
    return None


def rewrite_columns(e: Expr, mapping: Dict[str, str]) -> Expr:
    """Return a copy of ``e`` with column names rewritten via ``mapping``."""
    if isinstance(e, Col):
        return Col(mapping.get(e.name, e.name))
    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, rewrite_columns(e.left, mapping), rewrite_columns(e.right, mapping))
    if isinstance(e, Not):
        return Not(rewrite_columns(e.child, mapping))
    if isinstance(e, IsNull):
        return IsNull(rewrite_columns(e.child, mapping))
    if isinstance(e, In):
        return In(rewrite_columns(e.child, mapping), list(e.values))
    if isinstance(e, InSubquery):
        return InSubquery(rewrite_columns(e.child, mapping), e.plan, e.session)
    if isinstance(e, CorrelatedScalarSubquery):
        return CorrelatedScalarSubquery(
            [rewrite_columns(k, mapping) for k in e.outer_keys],
            e.plan, e.key_cols, e.value_col, e.default, e.session,
        )
    if isinstance(e, ExistsSubquery):
        return ExistsSubquery(
            [rewrite_columns(k, mapping) for k in e.outer_keys],
            e.plan, e.key_cols, e.residual,
            [(ph, rewrite_columns(x, mapping)) for ph, x in e.residual_outer],
            e.session,
        )
    if isinstance(e, CorrelatedInSubquery):
        return CorrelatedInSubquery(
            rewrite_columns(e.child, mapping),
            [rewrite_columns(k, mapping) for k in e.outer_keys],
            e.plan, e.key_cols, e.value_col, e.session,
        )
    if isinstance(e, Case):
        return Case(
            [(rewrite_columns(c, mapping), rewrite_columns(v, mapping)) for c, v in e.branches],
            rewrite_columns(e.otherwise, mapping) if e.otherwise is not None else None,
        )
    if isinstance(e, Like):
        return Like(rewrite_columns(e.child, mapping), e.pattern)
    if isinstance(e, Cast):
        return Cast(rewrite_columns(e.child, mapping), e.type_name)
    if isinstance(e, Func):
        return Func(e.name, [rewrite_columns(a, mapping) for a in e.args])
    return e
