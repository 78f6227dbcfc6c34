"""Expression tree.

The predicate language of the filter query and the join condition: column
refs, literals, comparisons, boolean connectives, arithmetic,
``isin``/``is_null``, and ``input_file_name()`` (ref: HS/index/covering/CoveringIndex.scala:239-273),
with the JAX package's names and semantics (``hyperspace_tpu/plan/expr.py``).
``CASE``, ``LIKE``, ``CAST``, scalar functions and subqueries are not in the
port yet.

Expressions evaluate over a column batch: a dict ``name -> numpy array``.
Device-side evaluation compiles the same tree to a torch program (see
exec/device.py). NULL is three-valued (Kleene): a comparison touching a
missing value (NaN, NaT, None) is unknown, and the filter keeps definite-TRUE
rows only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np

INPUT_FILE_NAME = "__input_file_name"

# Nested-field normalization prefix (ref: util/ResolverUtils.scala:44-105).
NESTED_PREFIX = "__hs_nested."


def strip_nested_prefix(name: str) -> str:
    """``__hs_nested.a.b`` -> ``a.b`` (identity for flat names)."""
    return name[len(NESTED_PREFIX):] if name.startswith(NESTED_PREFIX) else name


def get_column(batch: Dict[str, np.ndarray], name: str) -> Optional[np.ndarray]:
    """Batch lookup used by eval and select: exact key, then
    case-insensitive key. None when nothing resolves (nested struct fields
    are not in the port yet)."""
    if name in batch:
        return batch[name]
    lowered = name.lower()
    for k, v in batch.items():
        if k.lower() == lowered:
            return v
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
            raise NotImplementedError("IN-subqueries (col.isin(df)) are not yet in the port")
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
            # compatible superset of the framework convention)
            return np.asarray(pd.isna(a.ravel()), dtype=bool).reshape(a.shape)
        except (TypeError, ValueError):  # exotic elements (nested arrays)
            return np.array(
                [x is None or (isinstance(x, float) and x != x) for x in a.ravel()],
                dtype=bool,
            ).reshape(a.shape)
    return np.zeros(a.shape, dtype=bool)


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
    Host semantics match the device predicate compiler's Kleene pairs
    (exec/device.py)."""
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


class NullableBool:
    """Three-valued boolean result (Kleene logic): ``value`` where known,
    ``unknown`` marking SQL-NULL positions. Collapses to plain False at
    filter time (``as_bool_mask``), so NOT/AND/OR over NULL behave as SQL
    requires (NOT NULL = NULL, NULL OR TRUE = TRUE, NULL AND FALSE = FALSE)."""

    def __init__(self, value: np.ndarray, unknown: np.ndarray):
        self.value = np.asarray(value, dtype=bool)
        self.unknown = np.asarray(unknown, dtype=bool)


def as_bool_mask(x) -> np.ndarray:
    """Collapse an eval result to a definite boolean mask (NULL -> False)."""
    if isinstance(x, NullableBool):
        return x.value & ~x.unknown
    return np.asarray(x, dtype=bool)


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
    return e
