"""User-facing DataFrame facade.

A thin, lazy wrapper over the logical plan so that
``hs.create_index(df, CoveringIndexConfig(...))``, filter queries, joins,
aggregates and ``Session.sql`` have something to operate on. ``collect()`` runs the optimizer rewrite (when
Hyperspace is enabled on the session) then the executor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union as TUnion

import numpy as np

from hyperspace_tpu_torch.obs import stages
from hyperspace_tpu_torch.plan import logical as L
from hyperspace_tpu_torch.plan.expr import Col, Expr, col
from hyperspace_tpu_torch.plan.resolver import resolve_column, resolve_expr


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session):
        self.plan = plan
        self.session = session

    # --- transformations ---------------------------------------------------
    def filter(self, condition: Expr) -> "DataFrame":
        resolved = resolve_expr(condition, self.plan.output_columns)
        return DataFrame(L.Filter(resolved, self.plan), self.session)

    where = filter

    def select(self, *columns: TUnion[str, Col]) -> "DataFrame":
        names = []
        for c in columns:
            name = c.name if isinstance(c, Col) else str(c)
            resolved = resolve_column(name, self.plan.output_columns)
            if resolved is None:
                raise ValueError(f"Column {name!r} not found among {self.plan.output_columns}")
            names.append(resolved)
        return DataFrame(L.Project(names, self.plan), self.session)

    def join(
        self,
        other: "DataFrame",
        on: TUnion[str, List[str], Expr],
        how: str = "inner",
        residual: Optional[Expr] = None,
    ) -> "DataFrame":
        """Equi-join on an expression (``col("a") == col("b")``, ANDed for
        several keys) or on key names present on both sides (USING-style:
        the key is coalesced across sides in right and outer joins).
        ``residual`` carries a non-equi ON-clause predicate evaluated during
        the join (post-join column names): for outer joins a failing pair
        null-extends instead of matching."""
        using_pairs = None
        if isinstance(on, Expr):
            condition = on
        else:
            keys = [on] if isinstance(on, str) else list(on)
            terms: Optional[Expr] = None
            using_pairs = []
            for k in keys:
                lk = resolve_column(k, self.plan.output_columns)
                rk = resolve_column(k, other.plan.output_columns)
                if lk is None or rk is None:
                    raise ValueError(f"Join key {k!r} must exist on both sides")
                term = col(lk) == col(rk)
                terms = term if terms is None else (terms & term)
                using_pairs.append((lk, rk))
            assert terms is not None
            condition = terms
        return DataFrame(L.Join(self.plan, other.plan, condition, how, residual, using_pairs), self.session)

    def group_by(self, *keys: TUnion[str, Col]) -> "GroupedData":
        resolved = []
        for k in keys:
            name = k.name if isinstance(k, Col) else str(k)
            r = resolve_column(name, self.plan.output_columns)
            if r is None:
                raise ValueError(f"Column {name!r} not found among {self.plan.output_columns}")
            resolved.append(r)
        return GroupedData(self, resolved)

    groupBy = group_by

    def agg(self, **aggs) -> "DataFrame":
        """Global aggregates: ``df.agg(total=("v", "sum"), n=("*", "count"))``."""
        return GroupedData(self, []).agg(**aggs)

    def order_by(self, *keys: TUnion[str, Col], ascending: TUnion[bool, List[bool]] = True) -> "DataFrame":
        names = []
        for k in keys:
            name = k.name if isinstance(k, Col) else str(k)
            r = resolve_column(name, self.plan.output_columns)
            if r is None:
                raise ValueError(f"Column {name!r} not found among {self.plan.output_columns}")
            names.append(r)
        asc = [ascending] * len(names) if isinstance(ascending, bool) else list(ascending)
        if len(asc) != len(names):
            raise ValueError("ascending must be a bool or match the number of sort keys")
        return DataFrame(L.Sort(list(zip(names, asc)), self.plan), self.session)

    orderBy = sort = order_by

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(L.Limit(n, self.plan), self.session)

    def distinct(self) -> "DataFrame":
        """Distinct rows over all output columns (grouped aggregation with
        the helper count projected away)."""
        cols = list(self.plan.output_columns)
        agg = L.Aggregate(cols, [("__distinct_count", "count", None)], self.plan)
        return DataFrame(L.Project(cols, agg), self.session)

    dropDuplicates = drop_duplicates = distinct

    def as_scalar(self) -> Expr:
        """This one-column frame as a scalar-subquery expression, usable as a
        comparison operand: ``df.filter(col("a") == other.select("b").as_scalar())``.
        Index rewrites apply inside the subquery."""
        from hyperspace_tpu_torch.plan.expr import ScalarSubquery

        return ScalarSubquery(self.plan, self.session)

    asScalar = as_scalar

    def create_or_replace_temp_view(self, name: str) -> None:
        """Register this frame for ``session.sql()`` (Spark's temp-view role)."""
        self.session.register_view(name, self)

    createOrReplaceTempView = create_or_replace_temp_view

    # --- actions -----------------------------------------------------------
    def optimized_plan(self) -> L.LogicalPlan:
        from hyperspace_tpu_torch.rules.apply import optimize_plan

        return optimize_plan(self.plan, self.session)

    def collect(self) -> Dict[str, np.ndarray]:
        """Execute and return columns as numpy arrays.

        Arrays may be read-only views of the scan cache (plans that pass
        rows through share decoded buffers across queries); ``np.copy`` one
        before mutating it in place.

        With ``hyperspace.obs.tracing.enabled`` and no trace already active
        in this context, the whole call is traced and the resulting
        ``QueryProfile`` is retrievable via ``session.last_query_profile()``.
        A trace already active (a QueryServer request, an outer traced block)
        just gains child spans instead of rooting a second tree.
        """
        from hyperspace_tpu_torch.exec.executor import Executor
        from hyperspace_tpu_torch.obs import spans

        conf = self.session.conf
        if not conf.obs_tracing_enabled or spans.current_span() is not None:
            plan = self._timed_optimized_plan()
            return Executor(self.session).execute(plan, required_columns=plan.output_columns)

        from hyperspace_tpu_torch.obs.profile import build_profile

        error = None
        with spans.trace("query", max_spans=conf.obs_trace_max_spans) as root:
            try:
                plan = self._timed_optimized_plan()
                with spans.span("execute", cat="exec"):
                    return Executor(self.session).execute(plan, required_columns=plan.output_columns)
            except BaseException as e:
                error = type(e).__name__
                raise
            finally:
                profile = build_profile(root, query=self.plan.describe(), error=error)
                if conf.obs_profile_why_not:
                    try:
                        from hyperspace_tpu_torch.analysis.why_not import why_not_string

                        profile.why_not = why_not_string(self, self.session)
                    except Exception:
                        pass
                self.session._last_profile = profile
                history = self.session.profile_history
                if history is not None:
                    try:
                        from hyperspace_tpu_torch.serving.fingerprint import plan_fingerprint

                        history.record_profile(plan_fingerprint(self.plan).structure, profile)
                    except Exception:
                        pass  # the cost model must never fail a query

    def _timed_optimized_plan(self) -> L.LogicalPlan:
        """``optimized_plan()``, timed as the ``rewrite`` stage."""
        with stages.stage(self.session, "rewrite"):
            return self.optimized_plan()

    def to_local_iterator(self):
        """Yield the result as a stream of column batches (dicts of numpy
        arrays) without materializing the whole result: Spark's
        ``Dataset.toLocalIterator``. A compatible bucketed join streams
        bucket by bucket, a scan chain file group by file group, anything
        else yields one batch. Chunk dtypes may vary (a nullable int column
        is float64 only in chunks holding nulls)."""
        from hyperspace_tpu_torch.exec import batch as B
        from hyperspace_tpu_torch.exec.executor import Executor

        plan = self._timed_optimized_plan()
        cols = plan.output_columns
        stream = Executor(self.session).execute_stream(plan)
        try:
            for chunk in stream:
                yield B.select(chunk, cols)
        finally:
            # closed here, not when the last reference goes: some CPython
            # 3.12 releases close a generator suspended outside a try block
            # without releasing its loop's iterator, which would keep the
            # stream, and its prefetched decodes, running
            stream.close()

    toLocalIterator = to_local_iterator

    def to_arrow(self):
        from hyperspace_tpu_torch.exec.batch import batch_to_table

        return batch_to_table(self.collect(), self.plan.output_columns)

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def count(self) -> int:
        from hyperspace_tpu_torch.exec.batch import num_rows

        return num_rows(self.collect())

    @property
    def columns(self) -> List[str]:
        return self.plan.output_columns

    def explain(self) -> str:
        return self.plan.pretty()

    def __repr__(self) -> str:
        return f"DataFrame[{', '.join(self.plan.output_columns)}]"


class GroupedData:
    """``df.group_by(...)`` handle — terminal calls build an Aggregate node.

    ``agg`` takes ``out_name=(input_column, fn)`` pairs with fn one of
    ``Aggregate.FNS``; ``("*", "count")`` counts rows.
    """

    def __init__(self, df: DataFrame, keys: List[str]):
        self._df = df
        self._keys = keys

    def agg(self, **aggs) -> DataFrame:
        if not aggs:
            raise ValueError("agg() needs at least one aggregate")
        resolved_aggs = []
        available = self._df.plan.output_columns
        for out_name, (col_name, fn) in aggs.items():
            if col_name in ("*", None):
                if str(fn) != "count":
                    raise ValueError(f"('*', {fn!r}) is invalid — only ('*', 'count') counts rows")
                resolved_aggs.append((out_name, str(fn), None))
                continue
            r = resolve_column(str(col_name), available)
            if r is None:
                raise ValueError(f"Column {col_name!r} not found among {available}")
            resolved_aggs.append((out_name, str(fn), r))
        return DataFrame(L.Aggregate(self._keys, resolved_aggs, self._df.plan), self._df.session)

    def count(self) -> DataFrame:
        return self.agg(count=("*", "count"))

    def sum(self, column: str) -> DataFrame:
        return self.agg(**{f"sum({column})": (column, "sum")})

    def min(self, column: str) -> DataFrame:
        return self.agg(**{f"min({column})": (column, "min")})

    def max(self, column: str) -> DataFrame:
        return self.agg(**{f"max({column})": (column, "max")})

    def avg(self, column: str) -> DataFrame:
        return self.agg(**{f"avg({column})": (column, "avg")})

    mean = avg
