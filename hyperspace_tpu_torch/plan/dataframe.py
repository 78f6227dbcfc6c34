"""User-facing DataFrame facade.

A lazy wrapper over the logical plan so that
``hs.create_index(df, CoveringIndexConfig(...))`` has something to operate
on. Transformations and ``collect()`` arrive with the query path.
"""

from __future__ import annotations

from hyperspace_tpu_torch.plan import logical as L


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session):
        self.plan = plan
        self.session = session

    @property
    def columns(self):
        return self.plan.output_columns

    def __repr__(self) -> str:
        return f"DataFrame[\n{self.plan.pretty(1)}\n]"
