"""SQL front-end over the relational IR.

The reference's users drive Hyperspace through Spark SQL; this module gives
the same entry point without Spark: ``session.sql("SELECT ...")`` parses a
dialect covering the plan shapes the optimizer rules accept — linear scans,
CNF equi-joins, filters/projects/aggregates (ref: JoinPlanNodeFilter's own
restrictions, HS/index/covering/JoinIndexRule.scala:135-155) — and plans it
onto DataFrame operations, so every index rewrite, explain, and whyNot
surface applies to SQL queries unchanged.

Supported grammar (case-insensitive keywords) — the dialect covers the full
TPC-H 22 and TPC-DS 103 texts (tests/test_tpch_oracles.py,
tests/test_tpcds_oracles.py run them against pandas ground truth):

    [WITH name AS ( query ) [, name AS ( query )]*]
    SELECT [DISTINCT] <*| item [, item ...]>
    FROM <view | ( query )> [AS] [alias] [, <view> [alias]]*
    [ [INNER|LEFT|RIGHT|FULL] [OUTER] JOIN <view|(query)> [alias]
      ON <predicate, incl. non-equi residuals> ]*
    [WHERE <predicate>]
    [GROUP BY expr [, ...] | ROLLUP(...) | CUBE(...) | GROUPING SETS(...)]
    [HAVING <predicate, incl. subqueries>]
    [ORDER BY expr [ASC|DESC] [, ...]]      -- may reference non-projected cols
    [LIMIT n]
    query UNION [ALL] | INTERSECT | EXCEPT query   -- INTERSECT binds tighter

    item := expr [AS name]
    expr := comparisons (=, !=, <>, <, <=, >, >=), IN (...) / NOT IN,
            IN ( SELECT ... ) (null-aware), EXISTS ( SELECT ... ),
            ( SELECT ... ) scalar subqueries — correlated or not,
            IS [NOT] NULL, [NOT] BETWEEN x AND y, [NOT] LIKE 'pat%',
            NOT/AND/OR, arithmetic (+ - * / %), CASE WHEN ... END,
            CAST(expr AS type), EXTRACT(field FROM expr), grouping(col),
            SUM|MIN|MAX|AVG|COUNT([DISTINCT] expr | *), STDDEV[_SAMP],
            window functions: agg(expr) OVER (PARTITION BY ... ORDER BY ...
              [ROWS UNBOUNDED PRECEDING .. CURRENT ROW]),
              RANK() / DENSE_RANK() / ROW_NUMBER() OVER (...),
            literals: 123, 1.5, 'text', DATE '2024-01-31',
              INTERVAL 'n' DAY|MONTH|YEAR

Correlated subqueries (scalar, IN, EXISTS) are decorrelated into joins /
semi-join marks (plan/decorrelate.py) — the reference's golden scenario
(src/test/resources/expected/spark-3.1/subquery.txt) only exercises the
uncorrelated forms, but TPC-DS needs the general case (q1, q6, q30, q32,
q41, q81, q92 correlated-scalar; q16, q94 null-aware NOT EXISTS). Everything
plans onto the same ScalarSubquery/InSubquery/Join IR the dataframe API
builds, so every index rewrite, explain, and whyNot surface applies inside
subqueries unchanged (rules/apply.py recursion).
"""

from __future__ import annotations

import itertools
import re
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from hyperspace_tpu_torch.plan.expr import (
    BinaryOp,
    Col,
    Expr,
    In,
    IsNull,
    Lit,
    Not,
    col,
    lit,
)


class SqlError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
    \s*(
        (?P<string>'(?:[^']|'')*')
      | (?P<number>\d+\.\d+|\.\d+|\d+)
      | (?P<bq>`[^`]*`)
      | (?P<ident>[A-Za-z_][A-Za-z0-9_]*(?:\.[A-Za-z_][A-Za-z0-9_]*)*)
      | (?P<op><=|>=|<>|!=|=|<|>|\(|\)|,|\*|\+|-|/|%|\|\|)
    )""",
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having", "order", "limit", "join", "on",
    "inner", "left", "right", "full", "outer", "and", "or", "not", "in", "is",
    "null", "between", "as", "asc", "desc", "date", "count", "sum", "min",
    "max", "avg", "with", "case", "when", "then", "else", "end", "like",
    "union", "all", "exists", "interval", "cast", "over", "rollup",
    "intersect", "except",
}

#: OVER-clause words matched contextually (NOT reserved: a column named
#: "partition" or "row" stays a valid identifier everywhere else)
_OVER_WORDS = {"partition", "rows", "unbounded", "preceding", "current", "row"}

#: window-only function names (tokenize as plain identifiers)
_WINDOW_FNS = {"rank", "dense_rank", "row_number"}

# aggregate functions that tokenize as plain identifiers (not keywords)
_IDENT_AGGS = {"stddev_samp": "stddev_samp", "stddev": "stddev_samp"}

_AGG_FNS = ("count", "sum", "min", "max", "avg")


def _tokenize(text: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        if text[pos].isspace():
            pos += 1
            continue
        m = _TOKEN_RE.match(text, pos)
        if not m or m.start(1) != pos:
            raise SqlError(f"Cannot tokenize SQL at: {text[pos:pos+30]!r}")
        pos = m.end(1)
        if m.group("ident") is not None:
            word = m.group("ident")
            if "." not in word and word.lower() in _KEYWORDS:
                out.append(("kw", word.lower()))
            else:
                out.append(("ident", word))
        elif m.group("bq") is not None:
            out.append(("ident", m.group("bq")[1:-1]))
        elif m.group("string") is not None:
            out.append(("string", m.group("string")[1:-1].replace("''", "'")))
        elif m.group("number") is not None:
            out.append(("number", m.group("number")))
        else:
            out.append(("op", m.group("op")))
    return out


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self, k: int = 0) -> Optional[Tuple[str, str]]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> Tuple[str, str]:
        if self.i >= len(self.toks):
            raise SqlError("Unexpected end of SQL")
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_kw(self, *words: str) -> Optional[str]:
        t = self.peek()
        if t is not None and t[0] == "kw" and t[1] in words:
            self.i += 1
            return t[1]
        return None

    def expect_kw(self, word: str) -> None:
        if self.accept_kw(word) is None:
            raise SqlError(f"Expected {word.upper()} at {self._where()}")

    def accept_op(self, *ops: str) -> Optional[str]:
        t = self.peek()
        if t is not None and t[0] == "op" and t[1] in ops:
            self.i += 1
            return t[1]
        return None

    def expect_op(self, op: str) -> None:
        if self.accept_op(op) is None:
            raise SqlError(f"Expected {op!r} at {self._where()}")

    def expect_ident(self) -> str:
        t = self.next()
        if t[0] != "ident":
            raise SqlError(f"Expected identifier, got {t[1]!r}")
        return t[1]

    def _where(self) -> str:
        return " ".join(t[1] for t in self.toks[self.i : self.i + 4]) or "<end>"

    def at_end(self) -> bool:
        return self.i >= len(self.toks)

    def text_since(self, start: int) -> str:
        parts = []
        for kind, val in self.toks[start : self.i]:
            parts.append(f"'{val}'" if kind == "string" else val)
        return " ".join(parts)


# --- AST ------------------------------------------------------------------


class _AggCall(Expr):
    """Parse-time aggregate call marker (``SUM(expr)`` / ``COUNT(*)``);
    plan_query replaces it with a reference to an Aggregate output. Never
    evaluated."""

    def __init__(self, fn: str, arg: Optional[Expr], text: str):
        self.fn = fn
        self.arg = arg
        self.text = text  # source text of the argument, for default naming

    def children(self) -> Sequence[Expr]:
        return (self.arg,) if self.arg is not None else ()

    def eval(self, batch):
        raise SqlError(f"Aggregate {self.fn.upper()}() outside of an aggregation context")

    def __repr__(self) -> str:
        return f"{self.fn}({self.text})"


class _WindowCall(Expr):
    """Parse-time window-function marker (``fn(arg) OVER (...)``);
    plan_query replaces it with a reference to a Window node output."""

    def __init__(self, fn: str, arg: Optional[Expr], partition, orders, cumulative: bool, text: str):
        self.fn = fn
        self.arg = arg
        self.partition = list(partition)  # List[Expr]
        self.orders = list(orders)  # List[(Expr, asc)]
        self.cumulative = cumulative
        self.text = text

    def children(self) -> Sequence[Expr]:
        out = list(self.partition) + [e for e, _ in self.orders]
        if self.arg is not None:
            out.append(self.arg)
        return tuple(out)

    def eval(self, batch):
        raise SqlError(f"Unplanned window function {self.fn}()")

    def __repr__(self) -> str:
        return f"{self.fn}({self.text}) over (...)"


class _GroupingCall(Expr):
    """Parse-time ``grouping(col)`` marker (ROLLUP indicator: 1 when the
    column is rolled up in this output row, else 0)."""

    def __init__(self, arg: Expr, text: str):
        self.arg = arg
        self.text = text

    def children(self) -> Sequence[Expr]:
        return (self.arg,)

    def eval(self, batch):
        raise SqlError("grouping() outside of a ROLLUP context")

    def __repr__(self) -> str:
        return f"grouping({self.text})"


class _SubquerySelect(Expr):
    """Parse-time scalar-subquery marker (``( SELECT ... )``); plan_query
    plans the inner query and replaces this with a ScalarSubquery."""

    def __init__(self, query: "Query"):
        self.query = query

    def eval(self, batch):
        raise SqlError("Unplanned scalar subquery")

    def __repr__(self) -> str:
        return "(<subquery>)"


class _InQuery(Expr):
    """Parse-time ``expr IN ( SELECT ... )`` marker; plan_query plans the
    inner query and replaces this with an InSubquery."""

    def __init__(self, child: Expr, query: "Query"):
        self.child = child
        self.query = query

    def children(self) -> Sequence[Expr]:
        return (self.child,)

    def eval(self, batch):
        raise SqlError("Unplanned IN subquery")

    def __repr__(self) -> str:
        return f"({self.child!r} IN <subquery>)"


class _ExistsQuery(Expr):
    """Parse-time ``EXISTS ( SELECT ... )`` marker; binding decorrelates the
    inner query into an ExistsSubquery semi-join mark (NOT EXISTS rides the
    ordinary Not wrapper — EXISTS is two-valued, never unknown)."""

    def __init__(self, query: "Query"):
        self.query = query

    def eval(self, batch):
        raise SqlError("Unplanned EXISTS subquery")

    def __repr__(self) -> str:
        return "EXISTS(<subquery>)"


class SelectItem:
    def __init__(self, expr: Expr, alias: Optional[str], text: str):
        self.expr = expr
        self.alias = alias
        self.text = text  # source text, the default output name for expressions

    # -- parse-level introspection kept for compatibility ------------------
    @property
    def name(self) -> Optional[str]:
        """Column name when the item is a bare (possibly qualified) column."""
        return self.expr.name if isinstance(self.expr, Col) else None

    @property
    def agg(self) -> Optional[Tuple[str, Optional[str]]]:
        """(fn, column-or-None) when the item is a bare aggregate of a bare
        column (or COUNT(*))."""
        if isinstance(self.expr, _AggCall):
            a = self.expr.arg
            if a is None:
                return (self.expr.fn, None)
            if isinstance(a, Col):
                return (self.expr.fn, a.name)
        return None


class JoinClause:
    def __init__(self, table_ref: "TableRef", how: str, on: Expr):
        self.table_ref = table_ref
        self.how = how
        self.on = on  # full ON-clause expression (equi links extracted at plan time)

    @property
    def view(self):
        return self.table_ref.source

    @property
    def alias(self) -> str:
        return self.table_ref.alias


class TableRef:
    """A FROM-clause entry: a named view or a derived table (sub-select)."""

    def __init__(self, source, alias: str):
        self.source = source  # str view name | Query (derived table)
        self.alias = alias


class FromElement:
    """One comma-separated FROM element: a table ref plus any JOIN ... ON
    clauses chained directly onto it (TPC-DS mixes both styles:
    ``FROM a LEFT JOIN b ON (...), c, d``)."""

    def __init__(self, table_ref: TableRef, joins: List["JoinClause"]):
        self.table_ref = table_ref
        self.joins = joins


class Query:
    def __init__(self):
        self.ctes: List[Tuple[str, "Query"]] = []
        self.items: Optional[List[SelectItem]] = None  # None = SELECT *
        self.distinct = False
        self.from_elements: List[FromElement] = []
        self.where: Optional[Expr] = None
        self.group_by: List[str] = []
        self.group_sets: Optional[List[Tuple[int, ...]]] = None  # ROLLUP/CUBE/GROUPING SETS
        self.having: Optional[Expr] = None
        self.order_by: List[Tuple[Any, bool]] = []  # (column name | Expr, asc)
        self.limit: Optional[int] = None
        # set-operation chain: ("union", all?, rhs) | ("intersect"/"except", False, rhs)
        self.unions: List[Tuple[str, bool, "Query"]] = []

    # -- compatibility accessors (single-table queries) --------------------
    @property
    def table(self):
        return self.from_elements[0].table_ref.source if self.from_elements else ""

    @property
    def alias(self) -> str:
        return self.from_elements[0].table_ref.alias if self.from_elements else ""

    @property
    def joins(self) -> List["JoinClause"]:
        return [j for e in self.from_elements for j in e.joins]


def parse(text: str) -> Query:
    p = _Parser(_tokenize(text))
    ctes: List[Tuple[str, Query]] = []
    if p.accept_kw("with"):
        while True:
            name = p.expect_ident()
            p.expect_kw("as")
            p.expect_op("(")
            ctes.append((name, _parse_query(p)))
            p.expect_op(")")
            if not p.accept_op(","):
                break
    q = _parse_query(p)
    q.ctes = ctes
    if not p.at_end():
        raise SqlError(f"Unexpected trailing SQL: {p._where()}")
    return q


def _parse_query(p: _Parser) -> Query:
    # UNION and EXCEPT associate left at equal precedence; INTERSECT binds
    # tighter (handled inside the operand)
    q = _parse_union_operand(p)
    while True:
        if p.accept_kw("union"):
            all_ = p.accept_kw("all") is not None
            q.unions.append(("union", all_, _parse_union_operand(p)))
        elif p.accept_kw("except"):
            q.unions.append(("except", False, _parse_union_operand(p)))
        else:
            break
    if p.accept_kw("order"):
        p.expect_kw("by")
        q.order_by = [_parse_order_item(p)]
        while p.accept_op(","):
            q.order_by.append(_parse_order_item(p))
    if p.accept_kw("limit"):
        t = p.next()
        if t[0] != "number":
            raise SqlError("LIMIT expects a number")
        q.limit = int(t[1])
    return q


def _parse_union_operand(p: _Parser) -> Query:
    """A set-operation operand: a SELECT core (with INTERSECT chains, which
    bind tighter than UNION/EXCEPT) or a parenthesized (sub-)query."""
    q = _parse_intersect_operand(p)
    while p.accept_kw("intersect"):
        q.unions.append(("intersect", False, _parse_intersect_operand(p)))
    return q


def _parse_intersect_operand(p: _Parser) -> Query:
    if p.peek() == ("op", "(") and p.peek(1) == ("kw", "select"):
        p.i += 1
        q = _parse_query(p)
        p.expect_op(")")
        if q.order_by or q.limit is not None:
            # keep the inner ORDER BY/LIMIT scoped to the branch: wrap it as
            # a derived table so outer set-operation clauses attach outside
            outer = Query()
            outer.from_elements = [FromElement(TableRef(q, "__union_operand"), [])]
            return outer
        return q
    return _parse_select_core(p)


def _parse_select_core(p: _Parser) -> Query:
    q = Query()
    p.expect_kw("select")
    q.distinct = p.accept_kw("distinct") is not None
    if p.accept_op("*"):
        q.items = None
    else:
        q.items = [_parse_item(p)]
        while p.accept_op(","):
            q.items.append(_parse_item(p))
    p.expect_kw("from")
    q.from_elements = [_parse_from_element(p)]
    while p.accept_op(","):
        q.from_elements.append(_parse_from_element(p))
    if p.accept_kw("where"):
        q.where = _parse_or(p)
    if p.accept_kw("group"):
        p.expect_kw("by")
        nxt = p.peek()
        word = nxt[1].lower() if nxt is not None and nxt[0] in ("ident", "kw") else ""
        # cube/grouping are CONTEXTUAL words: only their full syntactic forms
        # (a following paren / SETS() list) commit, so columns with these
        # names stay valid GROUP BY keys
        if p.accept_kw("rollup"):
            p.expect_op("(")
            q.group_by = _parse_group_list(p)
            p.expect_op(")")
            k = len(q.group_by)
            q.group_sets = [tuple(range(j)) for j in range(k, -1, -1)]
        elif word == "cube" and p.peek(1) == ("op", "("):
            p.i += 1
            p.expect_op("(")
            q.group_by = _parse_group_list(p)
            p.expect_op(")")
            k = len(q.group_by)
            q.group_sets = [
                s
                for size in range(k, -1, -1)
                for s in itertools.combinations(range(k), size)
            ]
        elif (
            word == "grouping"
            and p.peek(1) is not None
            and p.peek(1)[1].lower() == "sets"
            and p.peek(2) == ("op", "(")
        ):
            p.i += 2
            p.expect_op("(")
            keys: List[Any] = []
            sets: List[Tuple[int, ...]] = []
            while True:
                names: List[Any] = []
                if p.accept_op("("):
                    if p.peek() != ("op", ")"):
                        names = _parse_group_list(p)
                    p.expect_op(")")
                else:  # a bare column is a one-element set (standard SQL)
                    names.append(_parse_group_item(p))
                idxs = []
                for nm in names:
                    if not isinstance(nm, str):
                        raise SqlError("GROUPING SETS keys must be plain columns")
                    if nm not in keys:
                        keys.append(nm)
                    idxs.append(keys.index(nm))
                sets.append(tuple(idxs))
                if not p.accept_op(","):
                    break
            p.expect_op(")")
            q.group_by = keys
            q.group_sets = sets
        else:
            q.group_by = _parse_group_list(p)
    if p.accept_kw("having"):
        q.having = _parse_or(p)
    return q


def _parse_group_list(p: _Parser) -> List[Any]:
    out = [_parse_group_item(p)]
    while p.accept_op(","):
        out.append(_parse_group_item(p))
    return out


def _parse_from_element(p: _Parser) -> FromElement:
    tref = _parse_table_ref(p)
    joins: List[JoinClause] = []
    while True:
        how = _parse_join_type(p)
        if how is None:
            break
        jref = _parse_table_ref(p)
        p.expect_kw("on")
        joins.append(JoinClause(jref, how, _parse_or(p)))
    return FromElement(tref, joins)


def _parse_table_ref(p: _Parser) -> TableRef:
    if p.accept_op("("):
        sub = _parse_query(p)
        p.expect_op(")")
        alias = _maybe_alias(p)
        if alias is None:
            raise SqlError("A derived table (sub-select in FROM) needs an alias")
        return TableRef(sub, alias)
    name = p.expect_ident()
    return TableRef(name, _maybe_alias(p) or name)


def _maybe_alias(p: _Parser) -> Optional[str]:
    p.accept_kw("as")
    t = p.peek()
    if t is not None and t[0] == "ident" and "." not in t[1]:
        p.i += 1
        return t[1]
    return None


def _parse_join_type(p: _Parser) -> Optional[str]:
    if p.accept_kw("join"):
        return "inner"
    for word, how in (("inner", "inner"), ("left", "left"), ("right", "right"), ("full", "outer")):
        if p.accept_kw(word):
            p.accept_kw("outer")
            p.expect_kw("join")
            return how
    return None


def _parse_item(p: _Parser) -> SelectItem:
    start = p.i
    e = _parse_or(p)
    text = p.text_since(start)
    alias = _maybe_alias(p)
    return SelectItem(e, alias, text)


def _parse_group_item(p: _Parser) -> Any:
    """A GROUP BY key: a (possibly qualified) column name, or an expression
    (e.g. ``substr(w_warehouse_name, 1, 20)``) keyed by its source text."""
    start = p.i
    e = _parse_or(p)
    if isinstance(e, Col):
        return e.name
    e._sql_text = p.text_since(start)
    return e


def _parse_order_item(p: _Parser) -> Tuple[Any, bool]:
    start = p.i
    e = _parse_or(p)
    key: Any
    if isinstance(e, Col):
        key = e.name
    elif isinstance(e, Lit) and isinstance(e.value, int):
        key = int(e.value)  # ordinal: ORDER BY 1 sorts by the first item
    else:
        key = e
        key._sql_text = p.text_since(start)  # for matching against item texts
    if p.accept_kw("desc"):
        return key, False
    p.accept_kw("asc")
    return key, True


def _strip_qualifier(name: str) -> str:
    return name.split(".", 1)[1] if "." in name else name


# --- predicate parsing (precedence: OR < AND < NOT < cmp < +- < */%) ------


def _parse_or(p: _Parser) -> Expr:
    e = _parse_and(p)
    while p.accept_kw("or"):
        e = e | _parse_and(p)
    return e


def _parse_and(p: _Parser) -> Expr:
    e = _parse_not(p)
    while p.accept_kw("and"):
        e = e & _parse_not(p)
    return e


def _parse_not(p: _Parser) -> Expr:
    if p.accept_kw("not"):
        return ~_parse_not(p)
    return _parse_cmp(p)


def _parse_cmp(p: _Parser) -> Expr:
    left = _parse_sum(p)
    if p.accept_kw("is"):
        negate = p.accept_kw("not") is not None
        p.expect_kw("null")
        e = left.is_null()
        return ~e if negate else e
    if p.accept_kw("between"):
        lo = _parse_sum(p)
        p.expect_kw("and")
        hi = _parse_sum(p)
        return (left >= lo) & (left <= hi)
    negate = False
    if p.accept_kw("not"):
        negate = True
    if p.accept_kw("like"):
        from hyperspace_tpu_torch.plan.expr import Like

        t = p.next()
        if t[0] != "string":
            raise SqlError("LIKE expects a quoted pattern")
        e = Like(left, t[1])
        return ~e if negate else e
    if p.accept_kw("in"):
        p.expect_op("(")
        if p.peek() == ("kw", "select"):
            e: Expr = _InQuery(left, _parse_query(p))
            p.expect_op(")")
        else:
            elems = [_parse_or(p)]
            while p.accept_op(","):
                elems.append(_parse_or(p))
            p.expect_op(")")
            folded = [_const_fold(x) for x in elems]
            if all(isinstance(x, Lit) for x in folded):
                e = left.isin([x.value for x in folded])
            else:
                # non-constant elements: expand to an OR of equalities
                e = None
                for x in folded:
                    term = left == x
                    e = term if e is None else (e | term)
        return ~e if negate else e
    if negate:
        raise SqlError("NOT must be followed by IN here")
    op = p.accept_op("=", "!=", "<>", "<=", ">=", "<", ">")
    if op is None:
        return left  # bare boolean expression
    right = _parse_sum(p)
    if op == "=":
        return left == right
    if op in ("!=", "<>"):
        return left != right
    return {"<": left < right, "<=": left <= right, ">": left > right, ">=": left >= right}[op]


def _parse_sum(p: _Parser) -> Expr:
    from hyperspace_tpu_torch.plan.expr import Func

    e = _parse_term(p)
    while True:
        op = p.accept_op("+", "-", "||")
        if op is None:
            return e
        rhs = _parse_term(p)
        if op == "||":
            e = Func("concat", [e, rhs])
        else:
            e = e + rhs if op == "+" else e - rhs


def _parse_term(p: _Parser) -> Expr:
    e = _parse_factor(p)
    while True:
        op = p.accept_op("*", "/", "%")
        if op is None:
            return e
        rhs = _parse_factor(p)
        e = {"*": e * rhs, "/": e / rhs, "%": e % rhs}[op]


def _accept_word(p: _Parser, word: str) -> bool:
    """Accept a contextual (non-reserved) word, whatever its token kind."""
    t = p.peek()
    if t is not None and t[0] in ("ident", "kw") and t[1].lower() == word:
        p.i += 1
        return True
    return False


def _expect_word(p: _Parser, word: str) -> None:
    if not _accept_word(p, word):
        raise SqlError(f"Expected {word.upper()} at {p._where()}")


def _parse_over(p: _Parser):
    """The OVER clause: ([PARTITION BY ...] [ORDER BY ...] [ROWS BETWEEN
    UNBOUNDED PRECEDING AND CURRENT ROW]). Any other frame spec errors."""
    p.expect_kw("over")
    p.expect_op("(")
    partition, orders, cumulative = [], [], False
    if _accept_word(p, "partition"):
        p.expect_kw("by")
        partition.append(_parse_sum(p))
        while p.accept_op(","):
            partition.append(_parse_sum(p))
    if p.accept_kw("order"):
        p.expect_kw("by")

        def item():
            e = _parse_sum(p)
            if p.accept_kw("desc"):
                return (e, False)
            p.accept_kw("asc")
            return (e, True)

        orders.append(item())
        while p.accept_op(","):
            orders.append(item())
    if _accept_word(p, "rows"):
        p.expect_kw("between")
        _expect_word(p, "unbounded")
        _expect_word(p, "preceding")
        p.expect_kw("and")
        _expect_word(p, "current")
        _expect_word(p, "row")
        if not orders:
            raise SqlError("A ROWS frame requires ORDER BY in the OVER clause")
        cumulative = True
    p.expect_op(")")
    return partition, orders, cumulative


def _maybe_window(p: _Parser, fn: str, arg: Optional[Expr], text: str) -> Expr:
    """An aggregate call becomes a window function when OVER follows."""
    if p.peek() == ("kw", "over"):
        partition, orders, cumulative = _parse_over(p)
        return _WindowCall(fn, arg, partition, orders, cumulative, text)
    return _AggCall(fn, arg, text)


def _parse_factor(p: _Parser) -> Expr:
    from hyperspace_tpu_torch.plan.expr import Cast, Func

    if p.accept_op("("):
        if p.peek() == ("kw", "select"):
            sub = _SubquerySelect(_parse_query(p))
            p.expect_op(")")
            return sub
        e = _parse_or(p)
        p.expect_op(")")
        return e
    if p.accept_op("-"):
        return Lit(0) - _parse_factor(p)
    t = p.peek()
    if t is None:
        raise SqlError("Unexpected end of expression")
    if t[0] == "kw" and t[1] in _AGG_FNS and p.peek(1) == ("op", "("):
        fn = p.next()[1]
        p.expect_op("(")
        if p.accept_kw("distinct"):
            if fn not in ("count", "sum", "avg"):
                raise SqlError(f"{fn.upper()}(DISTINCT ...) is not supported")
            fn = f"{fn}_distinct"
        if p.accept_op("*"):
            if fn != "count":
                raise SqlError(f"{fn.upper()}(*) is not valid")
            p.expect_op(")")
            return _maybe_window(p, fn, None, "*")
        start = p.i
        arg = _parse_sum(p)
        text = p.text_since(start)
        p.expect_op(")")
        return _maybe_window(p, fn, arg, text)
    if t == ("kw", "case"):
        p.i += 1
        return _parse_case(p)
    if t == ("kw", "cast"):
        p.i += 1
        p.expect_op("(")
        e = _parse_or(p)
        p.expect_kw("as")
        tt = p.next()
        if tt[0] not in ("ident", "kw"):
            raise SqlError(f"Expected a type name after CAST(... AS, got {tt[1]!r}")
        type_name = tt[1]
        if p.accept_op("("):  # type parameters, e.g. decimal(7,2)
            while p.accept_op(")") is None:
                p.next()
        p.expect_op(")")
        return Cast(e, type_name)
    if t == ("kw", "interval"):
        p.i += 1
        num = p.next()
        if num[0] == "string" and num[1].lstrip("-").isdigit():
            pass  # TPC-H style: interval '3' month
        elif num[0] != "number":
            raise SqlError("INTERVAL expects a number")
        unit = p.next()[1].lower()
        if unit in ("day", "days"):
            return Lit(np.timedelta64(int(num[1]), "D"))
        if unit in ("month", "months", "mon"):
            return Lit(np.timedelta64(int(num[1]), "M"))
        if unit in ("year", "years"):
            return Lit(np.timedelta64(12 * int(num[1]), "M"))
        raise SqlError(f"INTERVAL unit {unit!r} is not supported (day/month/year)")
    if t == ("kw", "exists"):
        p.i += 1
        p.expect_op("(")
        if p.peek() != ("kw", "select"):
            raise SqlError("EXISTS expects a (SELECT ...) subquery")
        sub = _ExistsQuery(_parse_query(p))
        p.expect_op(")")
        return sub
    if t[0] in ("ident", "kw") and t[1].lower() == "extract" and p.peek(1) == ("op", "("):
        # EXTRACT(YEAR FROM expr) -> the equivalent date-part function
        p.i += 1
        p.expect_op("(")
        unit = p.next()[1].lower()
        _expect_word(p, "from")
        e = _parse_or(p)
        p.expect_op(")")
        if unit not in ("year", "month", "day", "quarter"):
            raise SqlError(f"EXTRACT unit {unit!r} is not supported")
        return Func(unit, [e])
    if t[0] == "ident" and "." not in t[1] and p.peek(1) == ("op", "("):
        name = p.next()[1]
        p.expect_op("(")
        if name.lower() in _WINDOW_FNS:
            p.expect_op(")")
            if p.peek() != ("kw", "over"):
                raise SqlError(f"{name}() requires an OVER clause")
            partition, orders, cumulative = _parse_over(p)
            if not orders:
                raise SqlError(f"{name}() requires ORDER BY in its OVER clause")
            return _WindowCall(name.lower(), None, partition, orders, cumulative, "")
        if name.lower() == "grouping":
            start = p.i
            arg = _parse_sum(p)
            text = p.text_since(start)
            p.expect_op(")")
            return _GroupingCall(arg, text)
        agg = _IDENT_AGGS.get(name.lower())
        if agg is not None:
            start = p.i
            arg = _parse_sum(p)
            text = p.text_since(start)
            p.expect_op(")")
            if p.peek() == ("kw", "over"):
                raise SqlError(f"{name}() window form is not supported")
            return _AggCall(agg, arg, text)
        args: List[Expr] = []
        if p.accept_op(")") is None:
            args.append(_parse_or(p))
            while p.accept_op(","):
                args.append(_parse_or(p))
            p.expect_op(")")
        if p.peek() == ("kw", "over"):
            raise SqlError(f"Window function {name}() is not supported")
        try:
            return Func(name, args)
        except ValueError as e:
            raise SqlError(str(e))
    if t[0] == "ident":
        p.i += 1
        return col(t[1])  # qualifiers resolve at plan time (alias map needed)
    return lit(_parse_literal_value(p))


def _parse_case(p: _Parser) -> Expr:
    from hyperspace_tpu_torch.plan.expr import Case

    subject = None
    if p.peek() != ("kw", "when"):
        subject = _parse_or(p)
    branches = []
    while p.accept_kw("when"):
        c = _parse_or(p)
        if subject is not None:
            c = subject == c
        p.expect_kw("then")
        branches.append((c, _parse_or(p)))
    otherwise = None
    if p.accept_kw("else"):
        otherwise = _parse_or(p)
    p.expect_kw("end")
    if not branches:
        raise SqlError("CASE requires at least one WHEN branch")
    return Case(branches, otherwise)


def _const_fold(e: Expr) -> Expr:
    """Fold a reference-free expression (e.g. ``1999 + 1`` in an IN list)
    down to a literal; expressions with column references pass through."""
    if isinstance(e, Lit) or e.references():
        return e
    try:
        v = e.eval({})
    except Exception:
        return e
    return Lit(v.item() if hasattr(v, "item") else v)


def _parse_literal_value(p: _Parser) -> Any:
    t = p.next()
    if t[0] == "number":
        return float(t[1]) if "." in t[1] else int(t[1])
    if t[0] == "string":
        return t[1]
    if t == ("kw", "date"):
        s = p.next()
        if s[0] != "string":
            raise SqlError("DATE expects a quoted literal")
        return np.datetime64(s[1])
    if t == ("kw", "null"):
        return None
    if t[0] == "op" and t[1] == "-":
        v = _parse_literal_value(p)
        return -v
    raise SqlError(f"Expected a literal, got {t[1]!r}")


# --- expression utilities --------------------------------------------------


def _walk(e: Expr):
    yield e
    for c in e.children():
        yield from _walk(c)


def _map_expr(e: Expr, fn) -> Expr:
    """Top-down structural transform: ``fn(node)`` returning non-None
    replaces the node (no further descent); otherwise the node is rebuilt
    with transformed children. THE one rebuild-arm list — every marker
    substitution goes through here so no node shape gets missed."""
    out = fn(e)
    if out is not None:
        return out

    def rec(x):
        return _map_expr(x, fn)

    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, rec(e.left), rec(e.right))
    if isinstance(e, Not):
        return Not(rec(e.child))
    if isinstance(e, IsNull):
        return IsNull(rec(e.child))
    if isinstance(e, In):
        return In(rec(e.child), list(e.values))
    if isinstance(e, _AggCall):
        return _AggCall(e.fn, rec(e.arg) if e.arg is not None else None, e.text)
    if isinstance(e, _WindowCall):
        return _WindowCall(
            e.fn,
            rec(e.arg) if e.arg is not None else None,
            [rec(x) for x in e.partition],
            [(rec(x), asc) for x, asc in e.orders],
            e.cumulative,
            e.text,
        )
    if isinstance(e, _GroupingCall):
        return _GroupingCall(rec(e.arg), e.text)
    if isinstance(e, _InQuery):
        return _InQuery(rec(e.child), e.query)
    from hyperspace_tpu_torch.plan.expr import Case, Cast, Func, InSubquery, Like

    if isinstance(e, Case):
        return Case(
            [(rec(c), rec(v)) for c, v in e.branches],
            rec(e.otherwise) if e.otherwise is not None else None,
        )
    if isinstance(e, Cast):
        return Cast(rec(e.child), e.type_name)
    if isinstance(e, Func):
        return Func(e.name, [rec(a) for a in e.args])
    if isinstance(e, Like):
        return Like(rec(e.child), e.pattern)
    if isinstance(e, InSubquery):
        return InSubquery(rec(e.child), e.plan, e.session)
    from hyperspace_tpu_torch.plan.expr import (
        CorrelatedInSubquery,
        CorrelatedScalarSubquery,
        ExistsSubquery,
    )

    if isinstance(e, CorrelatedScalarSubquery):
        return CorrelatedScalarSubquery(
            [rec(k) for k in e.outer_keys], e.plan, e.key_cols, e.value_col, e.default, e.session
        )
    if isinstance(e, ExistsSubquery):
        return ExistsSubquery(
            [rec(k) for k in e.outer_keys],
            e.plan,
            e.key_cols,
            e.residual,
            [(ph, rec(x)) for ph, x in e.residual_outer],
            e.session,
        )
    if isinstance(e, CorrelatedInSubquery):
        return CorrelatedInSubquery(
            rec(e.child), [rec(k) for k in e.outer_keys], e.plan, e.key_cols, e.value_col, e.session
        )
    return e


def _contains_agg(e: Expr) -> bool:
    return any(isinstance(x, _AggCall) for x in _walk(e))


def _rewrite(e: Expr, mapping: Dict[str, str]) -> Expr:
    """Column-reference rewrite across every node shape (incl. the
    parse-time markers) via the one generic transformer."""

    def leaf(x):
        if isinstance(x, Col):
            return Col(mapping.get(x.name, x.name))
        return None

    return _map_expr(e, leaf)


def _resolve_expr_refs(e: Expr, resolve) -> Expr:
    mapping = {}
    for ref in e.references():
        resolved = resolve(ref)
        if resolved != ref:
            mapping[ref] = resolved
    return _rewrite(e, mapping) if mapping else e


def _bind_subqueries(e: Expr, views, session, outer_resolve=None) -> Expr:
    """Replace parse-time subquery markers with planned subquery expressions
    over the same view namespace (CTEs included). Correlated scalar and
    EXISTS subqueries decorrelate (plan/decorrelate.py); ``outer_resolve``
    maps their outer references to actual outer-frame columns."""
    from hyperspace_tpu_torch.plan.decorrelate import (
        decorrelate_exists,
        decorrelate_in,
        decorrelate_scalar,
        is_correlated,
    )
    from hyperspace_tpu_torch.plan.expr import InSubquery, ScalarSubquery

    identity = outer_resolve if outer_resolve is not None else (lambda name: name)

    def leaf(x):
        if isinstance(x, _SubquerySelect):
            if is_correlated(x.query, views):
                return decorrelate_scalar(x.query, views, session, identity)
            return ScalarSubquery(plan_query(x.query, views).plan, session)
        if isinstance(x, _ExistsQuery):
            return decorrelate_exists(x.query, views, session, identity)
        if isinstance(x, _InQuery):
            child = _bind_subqueries(x.child, views, session, outer_resolve)
            if is_correlated(x.query, views):
                return decorrelate_in(child, x.query, views, session, identity)
            inner = plan_query(x.query, views)
            return InSubquery(child, inner.plan, session)
        return None

    return _map_expr(e, leaf)


def _case_map(e: Expr, available: List[str]) -> Tuple[Expr, List[str]]:
    """Resolve ``e``'s column references case-insensitively against the
    available columns; returns (rewritten expr, still-unknown refs)."""
    colset = set(available)
    lowered = {c.lower(): c for c in available}
    mapping: Dict[str, str] = {}
    unknown: List[str] = []
    for ref in e.references():
        if ref in colset:
            continue
        m = lowered.get(ref.lower())
        if m is not None:
            mapping[ref] = m
        else:
            unknown.append(ref)
    return (_rewrite(e, mapping) if mapping else e), sorted(unknown)


def _canonical_agg_name(fn: str, arg: Optional[Expr], text: str) -> str:
    if arg is None:
        return "count"
    if isinstance(arg, Col):
        return f"{fn}({_strip_qualifier(arg.name)})"
    return f"{fn}({text})"


# --- planning -------------------------------------------------------------


def plan_query(q: Query, views: Dict[str, "DataFrame"]) -> "DataFrame":  # noqa: F821
    if q.ctes:
        views = dict(views)
        for name, cq in q.ctes:
            views[name] = plan_query(cq, views)
    if q.unions:
        return _plan_union(q, views)
    return _plan_single(q, views)


def _plan_union(q: Query, views) -> "DataFrame":  # noqa: F821
    """UNION [ALL] chain: branches align by position (Spark semantics), a
    bare UNION deduplicates, and ORDER BY/LIMIT apply to the combined rows."""
    import copy

    from hyperspace_tpu_torch.plan.dataframe import DataFrame
    from hyperspace_tpu_torch.plan.logical import Rename, Union

    head = copy.copy(q)
    head.unions, head.order_by, head.limit = [], [], None
    df = _plan_single(head, views)
    base_cols = df.plan.output_columns
    for kind, all_, rhs in q.unions:
        # an operand may itself be a parenthesized query with nested chains
        f = plan_query(rhs, views)
        cols = f.plan.output_columns
        if len(cols) != len(base_cols):
            raise SqlError(
                f"{kind.upper()} inputs have {len(base_cols)} vs {len(cols)} output columns"
            )
        if cols != base_cols and kind == "union":
            mapping = {a: b for a, b in zip(cols, base_cols) if a != b}
            try:
                f = DataFrame(Rename(mapping, f.plan), f.session)
            except ValueError as e:
                raise SqlError(f"UNION column alignment failed: {e}")
        if kind == "union":
            df = DataFrame(Union([df.plan, f.plan]), df.session)
            if not all_:
                # left-associative: a bare UNION dedups the chain SO FAR
                # only; a later UNION ALL keeps its duplicates
                df = df.distinct()
        else:  # intersect / except align positionally inside the SetOp
            from hyperspace_tpu_torch.plan.logical import SetOp

            df = DataFrame(SetOp(kind, df.plan, f.plan), df.session)
    if q.order_by:
        keys, asc = [], []
        out = set(base_cols)
        for k, a in q.order_by:
            if isinstance(k, int):
                if not (1 <= k <= len(base_cols)):
                    raise SqlError(f"ORDER BY position {k} is out of range")
                name = base_cols[k - 1]
            else:
                name = _strip_qualifier(k) if isinstance(k, str) else None
            if name is None or name not in out:
                raise SqlError("ORDER BY over a UNION must reference output columns")
            keys.append(name)
            asc.append(a)
        df = df.order_by(*keys, ascending=asc)
    if q.limit is not None:
        df = df.limit(q.limit)
    return df


def _plan_single(q: Query, views: Dict[str, "DataFrame"]) -> "DataFrame":  # noqa: F821
    from hyperspace_tpu_torch.plan.dataframe import DataFrame
    from hyperspace_tpu_torch.plan.logical import Compute, Rename

    df, alias_cols, session, where_rem = _plan_from(q, views)

    resolve_ref = _make_ref_resolver(df, alias_cols)

    def prep(e: Expr) -> Expr:
        return _bind_subqueries(_resolve_expr_refs(e, resolve_ref), views, session, resolve_ref)

    if where_rem is not None:
        where = prep(where_rem)
        for x in _walk(where):
            if isinstance(x, _AggCall):
                raise SqlError(
                    f"Aggregate {x.fn.upper()}() is not allowed in WHERE; use HAVING"
                )
            if isinstance(x, _WindowCall):
                raise SqlError("Window functions are not allowed in WHERE")
        df = df.filter(where)

    if q.items is None and any(
        c.startswith(("__cross", "__jk")) for c in df.plan.output_columns
    ):
        # SELECT * must not expose internal cross-join / computed join-key columns
        df = df.select(
            *[c for c in df.plan.output_columns if not c.startswith(("__cross", "__jk"))]
        )

    prepared = (
        [(it, prep(it.expr)) for it in q.items] if q.items is not None else None
    )
    having_e = prep(q.having) if q.having is not None else None
    if having_e is not None and any(isinstance(x, _WindowCall) for x in _walk(having_e)):
        raise SqlError("Window functions are not allowed in HAVING")

    is_agg = bool(q.group_by) or (
        prepared is not None and any(_contains_agg(e) for _, e in prepared)
    )
    if having_e is not None and not is_agg:
        raise SqlError("HAVING requires GROUP BY or aggregates in SELECT")

    renames: Dict[str, str] = {}
    names: List[str] = []  # projection, pre-rename

    canonical_out: Dict[str, str] = {}
    if is_agg:
        if prepared is None:
            raise SqlError("SELECT * cannot be combined with GROUP BY/aggregates")
        if q.group_sets is not None:
            df, names, canonical_out = _plan_rollup(
                q, df, prepared, having_e, resolve_ref, renames, session
            )
        else:
            df, names, canonical_out = _plan_aggregate(
                q, df, prepared, having_e, resolve_ref, renames, session
            )
    elif prepared is not None:
        exprs = [e for _, e in prepared]
        df, exprs = _plan_windows(df, exprs, session)
        prepared = [(it, e2) for (it, _), e2 in zip(prepared, exprs)]
        computes: List[Tuple[str, Expr]] = []
        for i, (it, e) in enumerate(prepared):
            if isinstance(e, Col):
                src = it.expr.name if isinstance(it.expr, Col) else e.name
                name = _resolve_select_name(src, df, alias_cols)
                names.append(name)
                if it.alias:
                    renames[name] = it.alias
                elif name.startswith("__win"):  # window item: name by text
                    renames[name] = it.text
            else:
                e, unknown = _case_map(e, df.plan.output_columns)
                if unknown:
                    raise SqlError(f"Unknown columns {unknown} in expression {it.text!r}")
                internal = f"__expr{i}"
                computes.append((internal, e))
                names.append(internal)
                renames[internal] = it.alias or it.text
        _surface_plain_names(q.items, names, renames)
        if computes:
            df = DataFrame(Compute(computes, df.plan), session)

    if q.distinct:
        if is_agg:
            raise SqlError("SELECT DISTINCT cannot be combined with GROUP BY/aggregates")
        if prepared is not None:
            df = df.select(*names)
            names = []
        df = df.distinct()

    # ORDER BY keys may reference output aliases, projected columns, or
    # non-projected columns (the latter sort before the projection drops
    # them, Spark-style)
    sort_specs: List[Tuple[str, bool]] = []
    extra_sort_cols: List[str] = []
    sort_exprs: List[Tuple[str, Expr]] = []
    if q.order_by:
        pre_cols = set(df.plan.output_columns)
        final_by_src = {n: renames.get(n, n) for n in names}
        aliases_set = set(renames.values())
        item_by_text: Dict[str, str] = {}
        if q.items is not None:
            for it_, nm_ in zip(q.items, names):
                item_by_text.setdefault(it_.text, renames.get(nm_, nm_))
        for name, asc in q.order_by:
            if isinstance(name, int):  # ordinal: 1-based SELECT item position
                positional = names if names else df.plan.output_columns  # SELECT *
                if not (1 <= name <= len(positional)):
                    raise SqlError(f"ORDER BY position {name} is out of range")
                nm = positional[name - 1]
                sort_specs.append((renames.get(nm, nm), asc))
                continue
            if not isinstance(name, str):
                # expression key: an aggregate call maps to its output
                # column; any other expression must repeat a SELECT item
                resolved_k = _resolve_expr_refs(name, resolve_ref)
                if isinstance(resolved_k, _AggCall):
                    canon = _canonical_agg_name(resolved_k.fn, resolved_k.arg, resolved_k.text)
                    n = canonical_out.get(canon, canon)
                else:
                    txt = getattr(name, "_sql_text", repr(name))
                    target = item_by_text.get(txt)
                    if target is not None:
                        sort_specs.append((target, asc))
                        continue
                    if any(isinstance(x, _WindowCall) for x in _walk(resolved_k)):
                        raise SqlError(
                            "Window functions in ORDER BY must appear as (or "
                            "alias) a SELECT item"
                        )
                    # general expression key: computed above the renamed
                    # frame (its references must name output columns) and
                    # projected away after the sort
                    internal = f"__sort{len(sort_exprs)}"
                    sort_exprs.append((internal, resolved_k))
                    sort_specs.append((internal, asc))
                    continue
            else:
                n = resolve_ref(name)
            if names and n in final_by_src:
                sort_specs.append((final_by_src[n], asc))
            elif n in aliases_set:
                sort_specs.append((n, asc))
            elif not names and n in pre_cols:  # SELECT * (or post-DISTINCT)
                # the Rename applies before the sort, so map aliased names
                sort_specs.append((renames.get(n, n), asc))
            elif names and n in pre_cols:
                extra_sort_cols.append(n)
                sort_specs.append((n, asc))
            else:
                raise SqlError(
                    f"ORDER BY column {name!r} is neither an output column "
                    f"nor available before the projection ({sorted(pre_cols)})"
                )

    if names:
        df = df.select(*names + [c for c in extra_sort_cols if c not in names])
    if renames:
        try:
            df = DataFrame(Rename(renames, df.plan), df.session)
        except ValueError as e:  # e.g. alias collides with another column
            raise SqlError(f"Invalid AS aliases: {e}")
    if sort_exprs:
        final_cols = set(df.plan.output_columns)
        for i_, (n_, e_) in enumerate(sort_exprs):
            e2, unknown = _case_map(e_, df.plan.output_columns)
            if unknown:
                raise SqlError(
                    f"ORDER BY expression references unknown columns {unknown} "
                    f"among {sorted(final_cols)}"
                )
            sort_exprs[i_] = (n_, e2)
        df = DataFrame(Compute(sort_exprs, df.plan), df.session)
    if sort_specs:
        df = df.order_by(*[n for n, _ in sort_specs], ascending=[a for _, a in sort_specs])
    if extra_sort_cols or sort_exprs:
        if names:
            final = [renames.get(n, n) for n in names]
            df = df.select(*final)
        else:
            df = df.select(*[c for c in df.plan.output_columns if not c.startswith("__sort")])
    if q.limit is not None:
        df = df.limit(q.limit)
    return df


def _plan_from(q: Query, views):
    """Plan the FROM clause: named views and derived tables, comma-separated
    entries joined by the equality predicates WHERE provides (the classic
    TPC-DS style ``FROM a, b WHERE a.k = b.k``), then explicit JOIN ... ON
    clauses. Returns (df, alias_cols, session, remaining WHERE predicate).

    alias_cols maps alias -> {lowercased source column -> its actual name in
    the joined frame}: join dedup renames right-side duplicates ('x' ->
    'x#r', 'x#r#r', ...; plan/logical.py join_output_names is the single
    source of truth), and the map keeps qualified references correct through
    any number of joins."""
    from hyperspace_tpu_torch.plan.expr import split_conjunctive
    from hyperspace_tpu_torch.plan.logical import join_output_names

    if not q.from_elements:
        raise SqlError("FROM clause is empty")

    def frame_of(tref: TableRef):
        if isinstance(tref.source, str):
            if tref.source not in views:
                raise SqlError(
                    f"Unknown table/view {tref.source!r}; register with create_or_replace_temp_view"
                )
            return views[tref.source]
        return plan_query(tref.source, views)

    jk = [0]  # unique suffixes for computed join-key columns

    def build_element(elem: FromElement):
        """One comma element: its table plus chained JOIN ... ON clauses.
        The ON expression is split into equality links (possibly expression
        keys, computed below the join) and a non-equi residual evaluated
        DURING the join (ON-clause semantics: for outer joins a failing
        pair null-extends — TPC-H q13's ``LEFT JOIN orders ON c_custkey =
        o_custkey AND o_comment NOT LIKE ...``). Returns (frame, local
        alias map)."""
        from hyperspace_tpu_torch.plan.dataframe import DataFrame
        from hyperspace_tpu_torch.plan.logical import Compute

        df_e = frame_of(elem.table_ref)
        amap: Dict[str, Dict[str, str]] = {
            elem.table_ref.alias.lower(): {c.lower(): c for c in df_e.plan.output_columns}
        }
        for j in elem.joins:
            right = frame_of(j.table_ref)
            ramap = {j.alias.lower(): {c.lower(): c for c in right.plan.output_columns}}
            links, residual_terms = [], []
            for term in split_conjunctive(_factor_or_common(j.on)):
                pair = None if _contains_marker(term) else _equi_link(
                    term, amap, df_e, right, ramap
                )
                if pair is not None:
                    links.append(pair)
                else:
                    residual_terms.append(term)
            if not links:
                raise SqlError(
                    f"JOIN ... ON for {j.alias!r} needs at least one equality "
                    "predicate linking the two sides"
                )
            condition: Optional[Expr] = None
            for ln, rn in links:
                if not isinstance(ln, str):
                    name = f"__jk{jk[0]}"
                    jk[0] += 1
                    df_e = DataFrame(Compute([(name, ln)], df_e.plan), df_e.session)
                    ln = name
                if not isinstance(rn, str):
                    name = f"__jk{jk[0]}"
                    jk[0] += 1
                    right = DataFrame(Compute([(name, rn)], right.plan), right.session)
                    rn = name
                term = col(ln) == col(rn)
                condition = term if condition is None else (condition & term)
            _, rename = join_output_names(df_e.plan.output_columns, right.plan.output_columns)
            residual: Optional[Expr] = None
            if residual_terms:
                if any(_contains_marker(t) for t in residual_terms):
                    raise SqlError("Subqueries/aggregates are not supported in JOIN ... ON")
                mapping: Dict[str, str] = {}
                left_lower = {c.lower(): c for c in df_e.plan.output_columns}
                right_lower = {c.lower(): c for c in right.plan.output_columns}
                for t in residual_terms:
                    for r in t.references():
                        got = _classify_two_sided(r, amap, ramap, left_lower, right_lower)
                        if got is None:
                            raise SqlError(f"Unknown column {r!r} in ON clause")
                        side, actual = got
                        if side == "ambiguous":
                            raise SqlError(f"Ambiguous column {r!r} in ON clause; qualify it")
                        # residual refs use POST-JOIN names: right side renamed
                        mapping[r] = rename.get(actual, actual) if side == "right" else actual
                for t in residual_terms:
                    t2 = _rewrite(t, mapping)
                    residual = t2 if residual is None else (residual & t2)
            if j.how == "inner" and residual is not None:
                # for inner joins the residual is equivalent to a post-join
                # filter — planning it that way keeps the join pure-equi, so
                # the bucketed/device join stack and JoinIndexRule still apply
                df_e = df_e.join(right, on=condition, how=j.how).filter(residual)
                residual = None
            else:
                df_e = df_e.join(right, on=condition, how=j.how, residual=residual)
            amap[j.alias.lower()] = {
                c.lower(): rename.get(c, c) for c in right.plan.output_columns
            }
        return df_e, amap

    built = [build_element(e) for e in q.from_elements]
    df, alias_cols = built[0]
    session = df.session

    conjuncts: Optional[List[Expr]] = None
    used: Set[int] = set()
    if len(built) > 1:
        where_n = _factor_or_common(q.where) if q.where is not None else None
        conjuncts = split_conjunctive(where_n) if where_n is not None else []
        _push_single_frame_conjuncts(built, conjuncts, used)
        _push_implied_disjunctions(built, conjuncts, used)
        df, alias_cols = built[0]
        pending = built[1:]
        while pending:
            progress = False
            for idx, (frame, amap_r) in enumerate(pending):
                links = []
                for ci, term in enumerate(conjuncts):
                    if ci in used:
                        continue
                    pair = _equi_link(term, alias_cols, df, frame, amap_r)
                    if pair is not None:
                        links.append((ci, pair))
                if not links:
                    continue
                from hyperspace_tpu_torch.plan.dataframe import DataFrame
                from hyperspace_tpu_torch.plan.logical import Compute

                condition: Optional[Expr] = None
                for ci, (ln, rn) in links:
                    used.add(ci)
                    # an expression key is computed as a hidden join-key
                    # column on its frame (Spark projects the expression
                    # below the SortMergeJoin the same way)
                    if not isinstance(ln, str):
                        name = f"__jk{jk[0]}"
                        jk[0] += 1
                        df = DataFrame(Compute([(name, ln)], df.plan), session)
                        ln = name
                    if not isinstance(rn, str):
                        name = f"__jk{jk[0]}"
                        jk[0] += 1
                        frame = DataFrame(Compute([(name, rn)], frame.plan), session)
                        rn = name
                    term = col(ln) == col(rn)
                    condition = term if condition is None else (condition & term)
                _, rename = join_output_names(df.plan.output_columns, frame.plan.output_columns)
                df = df.join(frame, on=condition, how="inner")
                for al, m in amap_r.items():
                    alias_cols[al] = {cl: rename.get(n, n) for cl, n in m.items()}
                pending.pop(idx)
                progress = True
                break
            if not progress:
                # a frame guaranteed to hold one row (global aggregate /
                # LIMIT 1 derived table, e.g. TPC-DS q28/q61/q88/q90) may
                # cross-join via a constant key without row explosion
                idx = next(
                    (i for i, (fr, _) in enumerate(pending) if _is_single_row(fr.plan)),
                    None,
                )
                if idx is None and _is_single_row(df.plan):
                    idx = 0
                if idx is not None:
                    frame, amap_r = pending.pop(idx)
                    df, rename = _cross_join(df, frame, session)
                    for al, m in amap_r.items():
                        alias_cols[al] = {cl: rename.get(n, n) for cl, n in m.items()}
                    progress = True
                    continue
                left_aliases = sorted(
                    al for _, m in pending for al in m
                )
                raise SqlError(
                    f"Cannot join {left_aliases}: no equality predicate in "
                    "WHERE links them to the other FROM tables (cartesian products "
                    "are not supported)"
                )

    if q.where is None:
        where_rem = None
    elif conjuncts is None:
        where_rem = q.where
    else:
        rest = [t for i, t in enumerate(conjuncts) if i not in used]
        where_rem = None
        for t in rest:
            where_rem = t if where_rem is None else (where_rem & t)
    return df, alias_cols, session, where_rem


def _is_single_row(plan) -> bool:
    """True when the plan provably yields at most one row (global aggregate
    or LIMIT 1, under any stack of projections)."""
    from hyperspace_tpu_torch.plan import logical as L

    node = plan
    # Filter included: a filtered single-row frame is still <= 1 row (the
    # pushdown pass may wrap a global-aggregate derived table in a Filter)
    while isinstance(node, (L.Project, L.Rename, L.Compute, L.Sort, L.Filter)):
        (node,) = node.children()
    if isinstance(node, L.Limit):
        return node.n <= 1
    return isinstance(node, L.Aggregate) and not node.keys


def _cross_join(df, frame, session):
    """Cross join via a constant '__cross' key on both sides (the IR only
    has equi-joins); callers guarantee one side is single-row."""
    from hyperspace_tpu_torch.plan.dataframe import DataFrame
    from hyperspace_tpu_torch.plan.logical import Compute, join_output_names

    def with_key(f):
        if "__cross" in f.plan.output_columns:
            return f
        return DataFrame(Compute([("__cross", Lit(1))], f.plan), session)

    left, right = with_key(df), with_key(frame)
    _, rename = join_output_names(left.plan.output_columns, right.plan.output_columns)
    out = left.join(right, on=col("__cross") == col("__cross"), how="inner")
    return out, rename


def _split_disjunctive(e: Expr) -> List[Expr]:
    if isinstance(e, BinaryOp) and e.op == "OR":
        return _split_disjunctive(e.left) + _split_disjunctive(e.right)
    return [e]


def _and_all(terms: List[Expr]) -> Optional[Expr]:
    out: Optional[Expr] = None
    for t in terms:
        out = t if out is None else (out & t)
    return out


def _or_all(terms: List[Expr]) -> Optional[Expr]:
    out: Optional[Expr] = None
    for t in terms:
        out = t if out is None else (out | t)
    return out


def _contains_marker(e: Expr) -> bool:
    """True when the tree holds a parse-time marker (subquery, aggregate,
    window, grouping) that only ``prep()`` can bind later. Markers repr
    non-structurally (every subquery is ``<subquery>``) and carry no child
    references, so factoring and join-key extraction must leave them alone."""
    return any(
        isinstance(
            x, (_SubquerySelect, _InQuery, _ExistsQuery, _AggCall, _WindowCall, _GroupingCall)
        )
        for x in _walk(e)
    )


def _factor_or_common(e: Expr) -> Expr:
    """Pull conjuncts common to every OR branch above the OR:
    ``(c AND r1) OR (c AND r2) -> c AND (r1 OR r2)`` (Kleene-distributive, so
    three-valued semantics are preserved). TPC-DS q13/q48-style predicates
    repeat the equi-join conjuncts inside each OR block; factoring exposes
    them to the comma-FROM join linker, leaving the residual OR as a plain
    filter. Structural equality is by repr — conjuncts holding parse-time
    markers are never factored (their reprs are non-structural)."""
    from hyperspace_tpu_torch.plan.expr import split_conjunctive

    if isinstance(e, BinaryOp) and e.op == "AND":
        return _factor_or_common(e.left) & _factor_or_common(e.right)
    if not (isinstance(e, BinaryOp) and e.op == "OR"):
        return e
    branches = [_factor_or_common(b) for b in _split_disjunctive(e)]
    conj_lists = [split_conjunctive(b) for b in branches]
    first = {repr(t): t for t in conj_lists[0] if not _contains_marker(t)}
    common_keys = set(first)
    for cl in conj_lists[1:]:
        common_keys &= {repr(t) for t in cl}
    if not common_keys:
        return _or_all(branches)
    common = [t for k, t in first.items() if k in common_keys]
    residuals: List[Optional[Expr]] = []
    for cl in conj_lists:
        taken: Set[str] = set()
        rest: List[Expr] = []
        for t in cl:
            k = repr(t)
            if k in common_keys and k not in taken:
                taken.add(k)  # remove one instance per common conjunct
                continue
            rest.append(t)
        residuals.append(_and_all(rest))
    if any(r is None for r in residuals):
        # a branch reduced to exactly the common part: the OR is implied
        return _and_all(common)
    return _and_all(common) & _or_all([r for r in residuals if r is not None])


def _frame_owner_fn(built):
    """Resolver shared by the pre-join pushdown passes: name -> (frame
    index, actual column) when the reference resolves into exactly one
    frame; None otherwise (unknown alias, or bare name in several)."""
    frame_lowers = [{c.lower(): c for c in fr.plan.output_columns} for fr, _ in built]

    def owner(name: str):
        if "." in name:
            qual, rest = name.split(".", 1)
            ql, rl = qual.lower(), rest.lower()
            hits = [
                (i, amap[ql][rl])
                for i, (_, amap) in enumerate(built)
                if ql in amap and rl in amap[ql]
            ]
            return hits[0] if len(hits) == 1 else None
        ln = name.lower()
        hits = [(i, low[ln]) for i, low in enumerate(frame_lowers) if ln in low]
        return hits[0] if len(hits) == 1 else None

    return owner


def _owned_rewrite(owner, sub):
    """(frame index, rewritten term) when every reference of ``sub`` resolves
    into ONE frame; None otherwise (or for marker terms / no references)."""
    if _contains_marker(sub):
        return None
    refs = sorted(sub.references())
    if not refs:
        return None
    target, mapping = None, {}
    for r in refs:
        got = owner(r)
        if got is None:
            return None
        i, cn = got
        if target is None:
            target = i
        elif target != i:
            return None
        mapping[r] = cn
    return target, _rewrite(sub, mapping)


def _push_single_frame_conjuncts(built, conjuncts, used) -> None:
    """Filter each FROM frame by the WHERE conjuncts that reference only that
    frame, BEFORE any join is built (Catalyst's PushDownPredicates role). An
    upper filter over an N-way self-join (TPC-DS q4/q11/q31: 4 references to
    one year_total CTE, distinguished only by per-reference year/channel
    predicates) otherwise materializes the unfiltered cross-growth first —
    quadratic-to-quartic row explosion that the filter then throws away."""
    owner = _frame_owner_fn(built)

    for ci, term in enumerate(conjuncts):
        if ci in used:
            continue
        got = _owned_rewrite(owner, term)
        if got is not None:
            target, rewritten = got
            fr, amap_r = built[target]
            built[target] = (fr.filter(rewritten), amap_r)
            used.add(ci)


def _push_implied_disjunctions(built, conjuncts, used) -> None:
    """Derive per-frame prefilters implied by a multi-frame disjunction
    (Catalyst's constraint-inference role for the CNF-conversion class of
    predicates): for ``(a1 AND ...) OR (a2 AND ...)``, when EVERY branch
    carries sub-terms referencing only frame F, the whole disjunction
    implies ``OR(branch F-parts)`` — under Kleene semantics a row whose
    every branch F-part is FALSE/UNKNOWN cannot make any branch TRUE, so
    filtering on the implied OR (which keeps only TRUE) drops no surviving
    row. The implied filter pushes BELOW the joins as a REDUNDANT
    prefilter; the original predicate still applies after them. TPC-DS/
    TPC-H q13/q19/q48-style demographic and address OR-blocks shrink
    their inputs ~10x this way."""
    from hyperspace_tpu_torch.plan.expr import split_conjunctive

    owner = _frame_owner_fn(built)
    for ci, term in enumerate(conjuncts):
        if ci in used:
            continue
        branches = _split_disjunctive(term)
        if len(branches) < 2:
            continue
        branch_parts = []  # per branch: {frame index -> [rewritten terms]}
        eligible = None
        for b in branches:
            parts: Dict[int, List[Expr]] = {}
            for sub in split_conjunctive(b):
                got = _owned_rewrite(owner, sub)
                if got is not None:
                    parts.setdefault(got[0], []).append(got[1])
            branch_parts.append(parts)
            eligible = set(parts) if eligible is None else (eligible & set(parts))
            if not eligible:
                break
        if not eligible:
            continue
        for f in sorted(eligible):
            constraint = _or_all([_and_all(bp[f]) for bp in branch_parts])
            fr, amap_r = built[f]
            built[f] = (fr.filter(constraint), amap_r)


def _classify_two_sided(name: str, left_aliases, right_aliases, left_lower, right_lower):
    """Resolve an ON-clause / comma-FROM reference against the two join
    sides: ('left'|'right', actual column) on a unique resolution,
    ('ambiguous', None) for an unqualified name present on both sides, None
    when nothing resolves. The one resolver shared by equi-link extraction
    and residual reference rewriting (so the two can never drift)."""
    if "." in name:
        qual, rest = name.split(".", 1)
        ql = qual.lower()
        if ql in right_aliases:
            got = right_aliases[ql].get(rest.lower())
            return ("right", got) if got is not None else None
        if ql in left_aliases:
            got = left_aliases[ql].get(rest.lower())
            return ("left", got) if got is not None else None
        return None
    ln = name.lower()
    in_left, in_right = ln in left_lower, ln in right_lower
    if in_left and in_right:
        return ("ambiguous", None)
    if in_left:
        return ("left", left_lower[ln])
    if in_right:
        return ("right", right_lower[ln])
    return None


def _equi_link(term: Expr, alias_cols, left_df, right_frame, right_aliases):
    """If ``term`` is ``expr = expr`` with one side's references resolving
    entirely into the joined composite and the other's entirely into the
    candidate right frame (any of its aliases), return the
    (left key, right key) pair — each a column name (str) for bare columns,
    or the side's Expr rewritten to actual frame columns (the caller computes
    it as a join-key column, Spark-style projection under the join); else
    None. Covers TPC-DS q2 (``d_week_seq1 = d_week_seq2 - 53``) and q8
    (``substr(s_zip,1,2) = substr(ca_zip,1,2)``)."""
    if not (isinstance(term, BinaryOp) and term.op == "="):
        return None
    left_lower = {c.lower(): c for c in left_df.plan.output_columns}
    right_lower = {c.lower(): c for c in right_frame.plan.output_columns}

    def classify(name: str):
        got = _classify_two_sided(name, alias_cols, right_aliases, left_lower, right_lower)
        if got is None or got[0] == "ambiguous":
            return None  # absent or ambiguous: not a usable link side
        return got

    def classify_side(e: Expr):
        """(side, key) where key is a str column or a rewritten Expr; None
        when refs are absent, mixed-side, constant, or the side holds a
        parse-time marker (subquery/aggregate/window — bound later by prep,
        so the whole term must stay a WHERE filter, not become a join key)."""
        if isinstance(e, Col):
            got = classify(e.name)
            return got
        if _contains_marker(e):
            return None
        refs = sorted(e.references())
        if not refs:
            return None
        got = [classify(r) for r in refs]
        if any(g is None for g in got):
            return None
        sides = {g[0] for g in got}
        if len(sides) != 1:
            return None
        side = sides.pop()
        mapping = {r: g[1] for r, g in zip(refs, got)}
        return (side, _rewrite(e, mapping))

    a, b = classify_side(term.left), classify_side(term.right)
    if a is not None and b is not None and {a[0], b[0]} == {"left", "right"}:
        left = a if a[0] == "left" else b
        right = a if a[0] == "right" else b
        return left[1], right[1]
    return None


def _plan_windows(df, item_exprs, session):
    """Collect _WindowCall nodes from the item expressions, append ONE Window
    node computing them over ``df``, and return (df, substituted exprs).
    Window operands (argument, partition, order keys) must resolve to columns
    of ``df`` — expressions are pre-reduced by the caller (aggregate calls
    already replaced by their output columns)."""
    from hyperspace_tpu_torch.plan.dataframe import DataFrame
    from hyperspace_tpu_torch.plan.logical import Window

    cols_ = df.plan.output_columns
    lowered = {c.lower(): c for c in cols_}
    pre: List[Tuple[str, Expr]] = []

    def operand(e, what):
        if isinstance(e, Col):
            got = e.name if e.name in cols_ else lowered.get(e.name.lower())
            if got is not None:
                return got
        # expression operand (e.g. grouping-indicator arithmetic, CASE over
        # keys): computed below the Window node
        e2, unknown = _case_map(e, cols_)
        if unknown:
            raise SqlError(
                f"Window {what} references unknown columns {unknown} among {sorted(cols_)}"
            )
        name = f"__winop{len(pre)}"
        pre.append((name, e2))
        return name

    specs, mapping = [], {}
    for e in item_exprs:
        for node in _walk(e):
            if isinstance(node, _WindowCall) and id(node) not in mapping:
                out = f"__win{len(specs)}"
                arg = operand(node.arg, "argument") if node.arg is not None else None
                parts = tuple(operand(x, "PARTITION BY key") for x in node.partition)
                orders = tuple((operand(x, "ORDER BY key"), asc) for x, asc in node.orders)
                if node.fn in ("count", "sum", "min", "max", "avg") and orders and not node.cumulative:
                    raise SqlError(
                        f"{node.fn}() OVER (ORDER BY ...) needs an explicit "
                        "ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW frame"
                    )
                specs.append((out, node.fn, arg, parts, orders, node.cumulative))
                mapping[id(node)] = Col(out)
    if not specs:
        return df, item_exprs
    if pre:
        from hyperspace_tpu_torch.plan.logical import Compute

        df = DataFrame(Compute(pre, df.plan), session)
    df = DataFrame(Window(specs, df.plan), session)
    return df, [_substitute_windows(e, mapping) for e in item_exprs]


def _substitute_windows(e: Expr, mapping) -> Expr:
    return _map_expr(e, lambda x: mapping.get(id(x)))


def _plan_rollup(q, df, prepared, having_e, resolve_ref, renames, session):
    """GROUP BY ROLLUP / CUBE / GROUPING SETS: the union of one Aggregate
    per grouping set (ROLLUP = key prefixes, CUBE = all subsets, GROUPING
    SETS = the explicit list), absent keys NULL, with __grp{i} indicator
    columns feeding
    grouping() (ref: Spark's Rollup/grouping semantics, used by TPC-DS
    q5/q18/q22/q27/q36/q67/q70/q77/q80/q86). Windows and grouping()
    arithmetic apply over the UNION (cross-set partitions), matching Spark.
    Returns (df, projection names, canonical_out)."""
    from hyperspace_tpu_torch.plan.dataframe import DataFrame
    from hyperspace_tpu_torch.plan.logical import Aggregate, Compute, Union

    group_keys: List[str] = []
    parse_to_dedup: List[int] = []  # parse-time key position -> deduped index
    for g in q.group_by:
        if not isinstance(g, str):
            raise SqlError("ROLLUP/CUBE/GROUPING SETS keys must be plain columns")
        r = resolve_ref(g)
        lowered = [k.lower() for k in group_keys]
        if r.lower() not in lowered:
            parse_to_dedup.append(len(group_keys))
            group_keys.append(r)
        else:  # GROUP BY ROLLUP(a, A): both positions map to one key
            parse_to_dedup.append(lowered.index(r.lower()))
    group_sets = [
        tuple(sorted({parse_to_dedup[i] for i in s})) for s in q.group_sets
    ]
    k = len(group_keys)
    key_index = {g.lower(): i for i, g in enumerate(group_keys)}

    pre_computes: List[Tuple[str, Expr]] = []
    aggs: List[Tuple[str, str, Optional[str]]] = []
    agg_out_by_key: Dict[Tuple[str, str], str] = {}
    canonical_out: Dict[str, str] = {}

    def register(ac: _AggCall) -> str:
        key = (ac.fn, ac.text if ac.arg is not None else "*")
        got = agg_out_by_key.get(key)
        if got is not None:
            return got
        canonical = _canonical_agg_name(ac.fn, ac.arg, ac.text)
        if ac.arg is None:
            in_col = None
        elif isinstance(ac.arg, Col):
            in_col = ac.arg.name
        else:
            in_col = f"__aggin{len(pre_computes)}"
            a2, unknown = _case_map(ac.arg, df.plan.output_columns)
            if unknown:
                raise SqlError(f"Unknown columns {unknown} in aggregate {ac.text!r}")
            pre_computes.append((in_col, a2))
        aggs.append((canonical, ac.fn, in_col))
        agg_out_by_key[key] = canonical
        canonical_out[canonical] = canonical
        return canonical

    # sibling-item aliases of bare aggregates (a window may ORDER BY them)
    alias_to_expr = {
        it.alias.lower(): e for (it, e) in prepared if it.alias and isinstance(e, _AggCall)
    }

    def subst(e: Expr) -> Expr:
        def leaf(x):
            if isinstance(x, _AggCall):
                return Col(register(x))
            if isinstance(x, _GroupingCall):
                a = x.arg
                gi = key_index.get(a.name.lower()) if isinstance(a, Col) else None
                if gi is None:
                    raise SqlError(f"grouping() argument must be a ROLLUP key; got {x.text!r}")
                return Col(f"__grp{gi}")
            if isinstance(x, Col):
                ref = alias_to_expr.get(x.name.lower())
                if ref is not None:
                    return Col(register(ref))
            return None

        return _map_expr(e, leaf)

    item_exprs = [subst(e) for _, e in prepared]
    having2 = subst(having_e) if having_e is not None else None
    if not aggs:
        raise SqlError(
            "GROUP BY ROLLUP/CUBE/GROUPING SETS requires at least one aggregate in SELECT"
        )

    base = df
    if pre_computes:
        base = DataFrame(Compute(pre_computes, base.plan), session)

    # one frame per grouping set (longest prefix first), all with identical
    # output schemas: keys (NULL when rolled up) + aggregates + indicators
    out_order = group_keys + [out for out, _, _ in aggs] + [f"__grp{i}" for i in range(k)]
    frames = []
    for s in group_sets:
        in_set = set(s)
        skeys = [group_keys[i] for i in sorted(in_set)]
        f = DataFrame(Aggregate(skeys, aggs, base.plan), session)
        fills: List[Tuple[str, Expr]] = [
            (gk, Lit(None)) for i, gk in enumerate(group_keys) if i not in in_set
        ]
        fills += [(f"__grp{i}", Lit(0 if i in in_set else 1)) for i in range(k)]
        f = DataFrame(Compute(fills, f.plan), session)
        frames.append(f.select(*out_order).plan)
    df = DataFrame(Union(frames), session)

    if having2 is not None:
        h2, unknown = _case_map(having2, df.plan.output_columns)
        if unknown:
            raise SqlError(f"HAVING references unknown columns {unknown}")
        df = df.filter(h2)

    df, item_exprs = _plan_windows(df, item_exprs, session)

    names: List[str] = []
    computes: List[Tuple[str, Expr]] = []
    lowered = {c.lower(): c for c in df.plan.output_columns}
    for i, ((it, _), e) in enumerate(zip(prepared, item_exprs)):
        if isinstance(e, Col):
            n = e.name if e.name in df.plan.output_columns else lowered.get(e.name.lower())
            if n is None:
                raise SqlError(f"Column {e.name!r} must appear in ROLLUP keys or an aggregate")
            names.append(n)
            if it.alias and it.alias != n:
                renames[n] = it.alias
            elif n.startswith(("__grp", "__win")):
                renames[n] = it.alias or it.text
        else:
            e2, unknown = _case_map(e, df.plan.output_columns)
            if unknown:
                raise SqlError(f"Unknown columns {unknown} in expression {it.text!r}")
            internal = f"__expr{i}"
            computes.append((internal, e2))
            names.append(internal)
            renames[internal] = it.alias or it.text
    if computes:
        df = DataFrame(Compute(computes, df.plan), session)
    return df, names, canonical_out


def _plan_aggregate(q, df, prepared, having_e, resolve_ref, renames, session):
    """Plan the aggregate branch: pre-aggregate computes for expression
    arguments, the Aggregate node, HAVING, and post-aggregate computes for
    expressions over aggregate outputs. Returns (df, projection names)."""
    from hyperspace_tpu_torch.plan.dataframe import DataFrame
    from hyperspace_tpu_torch.plan.logical import Aggregate, Compute

    group_keys: List[str] = []
    group_computes: List[Tuple[str, Expr]] = []
    group_text_to_key: Dict[str, str] = {}
    for gi, g in enumerate(q.group_by):
        if isinstance(g, str):
            r = resolve_ref(g)
            if r.lower() not in {k.lower() for k in group_keys}:  # GROUP BY a, a
                group_keys.append(r)
            continue
        # expression group key (e.g. substr(col, 1, 20)): computed before the
        # aggregate; SELECT items with the same source text reuse it
        ge, unknown = _case_map(_resolve_expr_refs(g, resolve_ref), df.plan.output_columns)
        if unknown:
            raise SqlError(f"Unknown columns {unknown} in GROUP BY expression")
        name = f"__gk{gi}"
        group_computes.append((name, ge))
        group_keys.append(name)
        group_text_to_key[getattr(g, "_sql_text", "")] = name
    group_lower = {g.lower() for g in group_keys}

    pre_computes: List[Tuple[str, Expr]] = []
    aggs: List[Tuple[str, str, Optional[str]]] = []  # (out, fn, input col)
    agg_out_by_key: Dict[Tuple[str, str], str] = {}
    canonical_out: Dict[str, str] = {}
    taken_out: Set[str] = set(group_keys)

    def register(ac: _AggCall, preferred: Optional[str] = None) -> str:
        canonical = _canonical_agg_name(ac.fn, ac.arg, ac.text)
        key = (ac.fn, ac.text if ac.arg is not None else "*")
        if preferred is None and key in agg_out_by_key:
            return agg_out_by_key[key]
        if ac.arg is None:
            in_col = None
        elif isinstance(ac.arg, Col):
            in_col = ac.arg.name
        else:
            in_col = f"__aggin{len(pre_computes)}"
            arg, unknown = _case_map(ac.arg, df.plan.output_columns)
            if unknown:
                raise SqlError(f"Unknown columns {unknown} in aggregate {ac.text!r}")
            pre_computes.append((in_col, arg))
        out = preferred or canonical
        if out in taken_out:
            if preferred is None:
                return agg_out_by_key.get(key, canonical)
            raise SqlError(f"Duplicate output name {out!r}")
        taken_out.add(out)
        aggs.append((out, ac.fn, in_col))
        agg_out_by_key.setdefault(key, out)
        canonical_out.setdefault(canonical, out)
        return out

    def replace_aggs(e: Expr, preferred: Optional[str] = None) -> Expr:
        if isinstance(e, _AggCall):  # bare call: may claim the item alias
            return Col(register(e, preferred))

        def leaf(x):
            return Col(register(x)) if isinstance(x, _AggCall) else None

        return _map_expr(e, leaf)

    # first pass: items matching a GROUP BY expression's text reuse its
    # computed key; items that ARE bare aggregate calls claim their alias as
    # the aggregate's output name (matches the reference's Spark naming)
    item_exprs: List[Optional[Expr]] = [None] * len(prepared)
    for idx, (it, e) in enumerate(prepared):
        if not isinstance(e, Col) and it.text in group_text_to_key:
            item_exprs[idx] = Col(group_text_to_key[it.text])
        elif isinstance(e, _AggCall):
            item_exprs[idx] = Col(register(e, preferred=it.alias))
    for idx, (it, e) in enumerate(prepared):
        if item_exprs[idx] is None:
            item_exprs[idx] = replace_aggs(e)

    if having_e is not None:
        # HAVING may aggregate without SELECT doing so (keys-only GROUP BY,
        # TPC-H q18's inner ``SELECT l_orderkey ... GROUP BY l_orderkey
        # HAVING sum(l_quantity) > 300``): register its aggregates so the
        # Aggregate node computes them; the projection drops them after
        replace_aggs(having_e)
    if not aggs:
        if having_e is not None:
            raise SqlError("HAVING must reference at least one aggregate")
        # aggregate-less GROUP BY is DISTINCT over the group keys (a common
        # TPC-DS idiom, e.g. q82)
        if group_computes:
            df = DataFrame(Compute(group_computes, df.plan), session)
        names = []
        for (it, _), e in zip(prepared, item_exprs):
            if not isinstance(e, Col) or (
                e.name.lower() not in group_lower and e.name not in group_keys
            ):
                raise SqlError("Column must appear in GROUP BY or an aggregate")
            n = e.name if e.name in group_keys else next(
                g for g in group_keys if g.lower() == e.name.lower()
            )
            names.append(n)
            if it.alias and it.alias != n:
                renames[n] = it.alias
            elif n.startswith("__gk"):
                renames[n] = it.alias or it.text
        df = df.select(*names).distinct()
        return df, names, canonical_out

    if group_computes or pre_computes:
        df = DataFrame(Compute(group_computes + pre_computes, df.plan), session)
    df = DataFrame(Aggregate(group_keys, aggs, df.plan), session)

    if having_e is not None:

        def resolve_having(name: str) -> str:
            return canonical_out.get(name, name)

        having = _resolve_expr_refs(replace_aggs(having_e), resolve_having)
        unknown = sorted(set(having.references()) - set(df.plan.output_columns))
        if unknown:
            raise SqlError(
                f"HAVING references {unknown}, which are not among the "
                f"aggregate outputs {df.plan.output_columns}; add the "
                "aggregate to SELECT or alias it"
            )
        df = df.filter(having)

    df, item_exprs = _plan_windows(df, item_exprs, session)

    names: List[str] = []
    post_computes: List[Tuple[str, Expr]] = []
    for i, ((it, _), e) in enumerate(zip(prepared, item_exprs)):
        if isinstance(e, Col):
            n = e.name
            if n not in df.plan.output_columns:
                if n.lower() in group_lower:
                    n = next(g for g in group_keys if g.lower() == n.lower())
                else:
                    raise SqlError(
                        f"Column {n!r} must appear in GROUP BY or an aggregate"
                    )
            names.append(n)
            if it.alias and it.alias != n:
                renames[n] = it.alias
            elif n.startswith(("__gk", "__win")):  # internal name: use text
                renames[n] = it.alias or it.text
        else:
            e, unknown = _case_map(e, df.plan.output_columns)
            if unknown:
                raise SqlError(
                    f"Columns {unknown} in {it.text!r} must appear in GROUP BY or an aggregate"
                )
            internal = f"__aggexpr{i}"
            post_computes.append((internal, e))
            names.append(internal)
            renames[internal] = it.alias or it.text
    if post_computes:
        df = DataFrame(Compute(post_computes, df.plan), session)
    _surface_plain_names([it for it, _ in prepared], names, renames)
    return df, names, canonical_out


def _make_ref_resolver(df, alias_cols):
    """Resolve a possibly table-qualified name against the planned frame:
    ``alias.col`` maps through the alias's column map (which tracks join
    dedup renames); unqualified (or nested-path) names pass through."""

    def resolve(name: str) -> str:
        if "." in name:
            qual, rest = name.split(".", 1)
            mapping = alias_cols.get(qual.lower())
            if mapping is not None:
                return _map_qualified(mapping, qual, rest)
        return name

    return resolve


def _map_qualified(mapping: Dict[str, str], qual: str, rest: str) -> str:
    """Map an alias-qualified column through the alias's column map; a dotted
    remainder falls back to mapping the path root so nested-struct references
    (``t.addr.city``) keep working."""
    got = mapping.get(rest.lower())
    if got is not None:
        return got
    if "." in rest:
        root, path = rest.split(".", 1)
        mapped = mapping.get(root.lower())
        if mapped is not None:
            return f"{mapped}.{path}"
    raise SqlError(
        f"Column {rest!r} not found in table/alias {qual!r} "
        f"(has {sorted(mapping.values())})"
    )


def _surface_plain_names(items: List[SelectItem], names: List[str], renames: Dict[str, str]) -> None:
    """A qualified right-side duplicate resolves to its internal '#r' column;
    when the plain name is free in the final projection (after AS renames
    apply), surface it under the plain name the way Spark does
    (SELECT t3.x -> column "x"). Mutates ``renames`` in place."""
    for it, name in zip(items, names):
        if it.alias or it.agg is not None or "#r" not in name:
            continue
        plain = name.split("#r", 1)[0]
        taken = {renames.get(n, n) for n in names if n != name}
        if plain not in taken:
            renames[name] = plain


def _resolve_select_name(name: str, df, alias_cols) -> str:
    plain = _strip_qualifier(name)
    cols_ = df.plan.output_columns
    if "." in name:
        qual, rest = name.split(".", 1)
        mapping = alias_cols.get(qual.lower())
        if mapping is not None:
            return _map_qualified(mapping, qual, rest)
    if plain in cols_:
        return plain
    lowered = {c.lower(): c for c in cols_}
    if plain.lower() in lowered:
        return lowered[plain.lower()]
    raise SqlError(f"Unknown column {name!r} among {cols_}")


def run_sql(text: str, session) -> "DataFrame":  # noqa: F821
    from hyperspace_tpu_torch.obs import spans

    with spans.span("parse", cat="plan"):
        q = parse(text)
    with spans.span("resolve", cat="plan"):
        return plan_query(q, session._temp_views)
