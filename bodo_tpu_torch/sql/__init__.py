"""SQL surface: BodoSQLContext.

Counterpart of bodo_tpu/sql/__init__.py. Register tables (pandas frames,
lazy frames, parquet paths, plan nodes or port Tables) and run SQL
against them: a query is parsed (sql/parser.py), planned
(sql/planner.py) onto the logical plan nodes, and returns a lazy
BodoDataFrame, whose to_pandas() optimizes and executes the plan
(plan/physical.py).

A context runs on one device: `device=None` means CUDA, and without
CUDA the constructor raises; pass device="cpu" to run on the CPU.
Frames registered with it become Tables on that device. DDL statements
(CREATE TABLE/VIEW AS, DROP, DESCRIBE, SHOW TABLES) raise
NotImplementedError.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

from bodo_tpu_torch.config import resolve_device
from bodo_tpu_torch.plan import logical as L
from bodo_tpu_torch.sql.parser import parse_sql
from bodo_tpu_torch.sql.planner import Planner

__all__ = ["BodoSQLContext"]

_DDL = re.compile(r"\s*(CREATE|DROP|DESCRIBE|DESC|SHOW)\b", re.IGNORECASE)


class BodoSQLContext:
    def __init__(self, tables: Optional[Dict] = None, device=None):
        self.device = resolve_device(device)
        self._tables: Dict[str, L.Node] = {}
        for name, t in (tables or {}).items():
            self.add_table(name, t)

    def add_table(self, name: str, table) -> None:
        import pandas as pd

        from bodo_tpu_torch.pandas_api.frame import BodoDataFrame
        from bodo_tpu_torch.table.table import Table
        if isinstance(table, BodoDataFrame):
            self._tables[name] = table._plan
        elif isinstance(table, (pd.DataFrame, Table)):
            self._tables[name] = L.FromPandas(table, device=self.device)
        elif isinstance(table, str):
            self._tables[name] = L.ReadParquet(table, device=self.device)
        elif isinstance(table, L.Node):
            self._tables[name] = table
        else:
            raise TypeError(f"cannot register table {name}: {type(table)}")

    def _schema_sig(self) -> str:
        return repr(sorted((n, tuple(p.schema)) for n, p in
                           self._tables.items()))

    def sql(self, query: str):
        """Plan a query; returns a lazy BodoDataFrame."""
        self._try_ddl(query)
        from bodo_tpu_torch.pandas_api.frame import BodoDataFrame
        from bodo_tpu_torch.sql import plan_cache
        sig = self._schema_sig()
        ast = plan_cache.get(query, sig)
        if ast is None:
            ast = parse_sql(query)
            # pickled BEFORE planning: the planner rewrites AST nodes in
            # place, so only cache-served objects need copying
            plan_cache.put(query, sig, ast)
        else:
            import copy
            ast = copy.deepcopy(ast)
        plan, _ = Planner(self._tables).plan(ast)
        return BodoDataFrame(plan)

    def _try_ddl(self, query: str) -> None:
        if _DDL.match(query):
            raise NotImplementedError(
                "DDL statements (BodoSQLContext._try_ddl: CREATE TABLE/VIEW "
                "AS, DROP, DESCRIBE, SHOW TABLES, with runtime/views) are "
                "not ported yet")

    def generate_plan(self, query: str):
        """The optimized logical plan of a query (EXPLAIN)."""
        from bodo_tpu_torch.plan.optimizer import optimize
        ast = parse_sql(query)
        plan, _ = Planner(self._tables).plan(ast)
        return optimize(plan)
