"""User-facing DataFrame facade.

A thin, lazy wrapper over the logical plan so that
``hs.create_index(df, CoveringIndexConfig(...))``, filter queries, joins and
aggregates have something to operate on. ``collect()`` runs the optimizer rewrite (when
Hyperspace is enabled on the session) then the executor.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Union as TUnion

import numpy as np

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
        the key is coalesced across sides in right and outer joins)."""
        if residual is not None:
            raise NotImplementedError("joins with a residual ON predicate are not yet in the port")
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
        return DataFrame(L.Join(self.plan, other.plan, condition, how, None, using_pairs), self.session)

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

    def distinct(self) -> "DataFrame":
        """Distinct rows over all output columns (grouped aggregation with
        the helper count projected away)."""
        cols = list(self.plan.output_columns)
        agg = L.Aggregate(cols, [("__distinct_count", "count", None)], self.plan)
        return DataFrame(L.Project(cols, agg), self.session)

    dropDuplicates = drop_duplicates = distinct

    # --- actions -----------------------------------------------------------
    def optimized_plan(self) -> L.LogicalPlan:
        from hyperspace_tpu_torch.rules.apply import optimize_plan

        return optimize_plan(self.plan, self.session)

    def collect(self) -> Dict[str, np.ndarray]:
        """Execute and return columns as numpy arrays.

        Arrays may be read-only views of the scan cache (plans that pass
        rows through share decoded buffers across queries); ``np.copy`` one
        before mutating it in place.
        """
        from hyperspace_tpu_torch.exec.executor import Executor

        t = time.perf_counter()
        plan = self.optimized_plan()
        self.session.query_stage_seconds["rewrite"] += time.perf_counter() - t
        return Executor(self.session).execute(plan, required_columns=plan.output_columns)

    def to_local_iterator(self):
        """Yield the result as a stream of column batches (dicts of numpy
        arrays) without materializing the whole result: Spark's
        ``Dataset.toLocalIterator``. A compatible bucketed join streams
        bucket by bucket, a scan chain file group by file group, anything
        else yields one batch. Chunk dtypes may vary (a nullable int column
        is float64 only in chunks holding nulls)."""
        from hyperspace_tpu_torch.exec import batch as B
        from hyperspace_tpu_torch.exec.executor import Executor

        t = time.perf_counter()
        plan = self.optimized_plan()
        self.session.query_stage_seconds["rewrite"] += time.perf_counter() - t
        cols = plan.output_columns
        for chunk in Executor(self.session).execute_stream(plan):
            yield B.select(chunk, cols)

    toLocalIterator = to_local_iterator

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
