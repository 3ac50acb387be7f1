"""BodoDataFrame: a lazy dataframe holding a logical plan.

Counterpart of the part of bodo_tpu/pandas_api/frame.py that a SQL
result needs: the plan, its column names, its row count and its
materialization. Nothing runs until `to_pandas()` or `len()`; each
optimizes and executes the plan (plan/physical.py). The rest of the
lazy pandas API (selection, assignment, groupby, merge, the index) is
not ported yet.
"""

from __future__ import annotations

from bodo_tpu_torch.plan import logical as L


class BodoDataFrame:
    def __init__(self, plan: L.Node):
        self._plan = plan

    @property
    def columns(self):
        import pandas as pd
        return pd.Index(list(self._plan.schema))

    def _execute(self):
        from bodo_tpu_torch.plan.physical import execute
        return execute(self._plan)

    def to_pandas(self):
        return self._execute().to_pandas()

    def __len__(self) -> int:
        return self._execute().nrows
