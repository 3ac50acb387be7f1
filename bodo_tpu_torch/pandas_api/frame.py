"""BodoDataFrame: the lazy dataframe.

Counterpart of bodo_tpu/pandas_api/frame.py. Every method builds a plan
node (plan/logical.py); nothing runs until a materialization point
(`to_pandas()`, `len()`, a reduction), which optimizes and executes the
plan (plan/physical.py). The index is an ordinary column threaded
through the plan and becomes a pandas index only in `to_pandas()`.

An API the frame does not run lazily falls back to pandas with a warning
(utils/logging.warn_fallback; `__getattr__` materializes and delegates,
re-wrapping frame results lazily). The fallback is chosen by the API
and its arguments before anything executes; nothing that raises while
executing is handed to pandas. `apply(axis=1)` is the compiled-UDF route
(RowUDF), which raises NotImplementedError; so do `to_parquet`,
`to_iceberg`, `explode` and `explain_analyze`, naming the module they
need.

A frame's plan reads from one device (its sources'); frames on two
devices do not combine (ValueError), and a pandas frame merged or
concatenated into a lazy one goes to the lazy frame's device. pandas is
imported inside the methods that need it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from bodo_tpu_torch.pandas_api.series import BodoSeries
from bodo_tpu_torch.plan import logical as L
from bodo_tpu_torch.plan.expr import ColRef, Expr, Lit
from bodo_tpu_torch.table import dtypes as dt
from bodo_tpu_torch.utils.logging import warn_fallback


def _leaf_devices(node: L.Node, out: set) -> set:
    if isinstance(node, L.FromPandas):
        out.add(node.table.device)
    elif isinstance(node, (L.ReadParquet, L.ReadCsv)):
        out.add(node.device)
    for c in node.children:
        _leaf_devices(c, out)
    return out


def plan_device(*plans: L.Node):
    """The one device the sources of `plans` live on; ValueError if they
    name two."""
    devs = set()
    for p in plans:
        _leaf_devices(p, devs)
    if len(devs) > 1:
        raise ValueError(f"frames on different devices do not combine: "
                         f"{sorted(str(d) for d in devs)}")
    return next(iter(devs)) if devs else None


class BodoDataFrame:
    def __init__(self, plan: L.Node, index=None):
        object.__setattr__(self, "_plan", plan)
        # index: [(plan_column, display_name)]: the index is a device
        # column threaded through the plan; only to_pandas() turns it
        # into a pandas index, so no kernel special-cases it
        object.__setattr__(self, "_index", list(index) if index else [])
        # plans this frame has pointed at (mutated by __setitem__), with
        # the columns overwritten since: a Series captured from an older
        # plan stays usable as long as none of its columns changed
        object.__setattr__(self, "_history", {id(plan): set()})

    def _index_cols(self) -> List[str]:
        return [c for c, _ in self._index]

    def _data_cols(self) -> List[str]:
        idx = set(self._index_cols())
        return [n for n in self._plan.schema if n not in idx]

    def _from_pandas(self, pdf) -> "BodoDataFrame":
        """A pandas frame as a lazy frame on this frame's device."""
        return BodoDataFrame(L.FromPandas(pdf,
                                          device=plan_device(self._plan)))

    # ---- schema ----------------------------------------------------------
    @property
    def columns(self):
        import pandas as pd
        return pd.Index(self._data_cols())

    @property
    def dtypes(self):
        import pandas as pd
        out = {}
        for n in self._data_cols():
            t = self._plan.schema[n]
            out[n] = np.dtype("O") if t is dt.STRING else np.dtype(t.np_dtype)
        return pd.Series(out)

    @property
    def shape(self):
        return (len(self), len(self._data_cols()))

    # ---- selection -------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, str):
            if key not in self._plan.schema or \
                    key in set(self._index_cols()):
                raise KeyError(key)
            return BodoSeries(self._plan, ColRef(key), key,
                              index=self._index)
        if isinstance(key, list):
            exprs = [(n, ColRef(n)) for n in key]
            exprs += [(c, ColRef(c)) for c in self._index_cols()
                      if c not in key]
            return BodoDataFrame(L.Projection(self._plan, exprs),
                                 index=self._index)
        if isinstance(key, BodoSeries):
            try:
                e = self._expr_of(key)
            except ValueError:
                raise ValueError("boolean mask must come from this frame")
            return BodoDataFrame(L.Filter(self._plan, e),
                                 index=self._index)
        raise TypeError(f"unsupported key: {key!r}")

    def __setitem__(self, name: str, value):
        import pandas as pd
        if name in set(self._index_cols()):
            # pandas creates a data column distinct from the index; move
            # the index to a reserved backing column first so the assign
            # cannot overwrite it
            exprs = []
            new_index = []
            for c, disp in self._index:
                if c == name:
                    exprs.append((f"__idx_{c}", ColRef(c)))
                    new_index.append((f"__idx_{c}", disp))
                else:
                    exprs.append((c, ColRef(c)))
                    new_index.append((c, disp))
            exprs += [(n, ColRef(n)) for n in self._data_cols()]
            object.__setattr__(self, "_plan",
                               L.Projection(self._plan, exprs))
            object.__setattr__(self, "_index", new_index)
            hist = object.__getattribute__(self, "_history")
            hist[id(self._plan)] = set()
        if isinstance(value, (list, np.ndarray, pd.Series)):
            # positional data needs host alignment: fallback semantics
            warn_fallback("DataFrame.__setitem__", "raw array value")
            pdf = self._execute().to_pandas()  # raw columns, index too
            pdf[name] = np.asarray(value)
            plan = L.FromPandas(pdf, device=plan_device(self._plan))
        else:
            plan = None
            if isinstance(value, BodoSeries):
                plan = self._try_absorb_window(name, value)
            if plan is None:
                plan = self._assign_plan({name: value})
        hist = object.__getattribute__(self, "_history")
        for dirty in hist.values():
            dirty.add(name)
        hist[id(plan)] = set()
        object.__setattr__(self, "_plan", plan)

    def __getattr__(self, name):
        plan = object.__getattribute__(self, "_plan")
        index = object.__getattribute__(self, "_index")
        if name in plan.schema and \
                name not in {c for c, _ in index}:
            return BodoSeries(plan, ColRef(name), name, index=index)
        import pandas as pd
        if not name.startswith("_") and hasattr(pd.DataFrame, name):
            warn_fallback(f"DataFrame.{name}", "not yet lazy")
            attr = getattr(self.to_pandas(), name)
            if callable(attr):
                def wrapped(*a, **k):
                    res = attr(*a, **k)
                    if isinstance(res, pd.DataFrame) and isinstance(
                            res.index, pd.RangeIndex):
                        # re-wrap lazily; frames with meaningful indexes
                        # (describe etc.) stay plain pandas
                        return self._from_pandas(res)
                    return res
                return wrapped
            return attr
        raise AttributeError(name)

    def _try_absorb_window(self, name: str, s) -> "L.Node | None":
        """df[name] = df[col].cumsum()/shift(...): the series' plan is a
        Window over (a projection of) this frame's plan, a row-aligned
        derivation, so it is rebuilt on the whole frame instead of being
        refused as foreign (pandas aligns by index; here rows align
        through row-preserving nodes)."""
        vp = s._plan
        if not isinstance(vp, L.Window) or len(vp.specs) != 1:
            return None
        wcol, op, param, out = vp.specs[0]
        if not (isinstance(s._expr, ColRef) and s._expr.name == out):
            return None
        child = vp.child
        if child is self._plan:
            inner = ColRef(wcol)
        elif isinstance(child, L.Projection) and child.child is self._plan:
            inner = dict(child.exprs).get(wcol)
            if inner is None:
                return None
        else:
            return None
        tmp = f"__win_in_{name}"
        keep = [(n, ColRef(n)) for n in self._plan.schema]
        p2 = L.Projection(self._plan, keep + [(tmp, inner)])
        wout = f"__w_{tmp}"
        w2 = L.Window(p2, [(tmp, op, param, wout)])
        exprs = [(n, ColRef(wout) if n == name else ColRef(n))
                 for n in self._plan.schema]
        if name not in self._plan.schema:
            exprs.append((name, ColRef(wout)))
        return L.Projection(w2, exprs)

    def _expr_of(self, value) -> Expr:
        if isinstance(value, BodoSeries):
            hist = object.__getattribute__(self, "_history")
            if value._plan is self._plan:
                return value._expr
            dirty = hist.get(id(value._plan))
            if dirty is not None:
                from bodo_tpu_torch.plan.expr import expr_columns
                stale = expr_columns(value._expr) & dirty
                if stale:
                    raise ValueError(
                        f"Series references columns overwritten since it was "
                        f"captured: {sorted(stale)}")
                return value._expr
            raise ValueError("column must come from this frame")
        return Lit(value)

    def _assign_plan(self, new: Dict[str, object]) -> L.Node:
        exprs = [(n, ColRef(n)) for n in self._plan.schema]
        names = {n for n, _ in exprs}
        for n, v in new.items():
            e = self._expr_of(v)
            if n in names:
                exprs = [(nn, e if nn == n else ee) for nn, ee in exprs]
            else:
                exprs.append((n, e))
        return L.Projection(self._plan, exprs)

    def assign(self, **kwargs) -> "BodoDataFrame":
        """Add columns. Series values may come from this frame (evaluated
        over the projection chain built so far: every original column
        passes through by name); callables receive the frame built so
        far."""
        plan = self._plan
        allowed = {id(self._plan)}
        for n, v in kwargs.items():
            if callable(v):
                v = v(BodoDataFrame(plan))
            if isinstance(v, BodoSeries):
                if id(v._plan) not in allowed:
                    raise ValueError("column must come from this frame")
                e = v._expr
            else:
                e = Lit(v)
            exprs = [(nn, ColRef(nn)) for nn in plan.schema if nn != n]
            exprs.append((n, e))
            plan = L.Projection(plan, exprs)
            allowed.add(id(plan))
        return BodoDataFrame(plan, index=self._index)

    def melt(self, id_vars=None, value_vars=None, var_name="variable",
             value_name="value") -> "BodoDataFrame":
        """Unpivot columns to rows: one constant-dictionary `variable`
        column per source column, concatenated on the device
        (relational.concat_tables)."""
        import torch

        from bodo_tpu_torch import relational as R
        from bodo_tpu_torch.table.table import Column, Table
        id_vars = [id_vars] if isinstance(id_vars, str) else \
            list(id_vars or [])
        schema = self._plan.schema
        value_vars = [value_vars] if isinstance(value_vars, str) else \
            list(value_vars or [c for c in schema if c not in id_vars])
        t = self._execute()
        pieces = []
        for v in value_vars:
            cols = {c: t.columns[c] for c in id_vars}
            cols[var_name] = Column(
                torch.zeros((t.capacity,), dtype=torch.int32,
                            device=t.device), None, dt.STRING,
                np.array([v], dtype=str))
            cols[value_name] = t.columns[v]
            pieces.append(Table(cols, t.nrows, t.distribution, t.counts))
        return BodoDataFrame(L.FromPandas(R.concat_tables(pieces)))

    def pivot_table(self, values=None, index=None, columns=None,
                    aggfunc="mean"):
        """Groupby on (index, columns) on the device, the (small)
        aggregated result reshaped on the host: returns plain pandas (a
        pivoted frame's index is meaningful, which tables do not
        model)."""
        if index is None or columns is None or not isinstance(values, str):
            raise NotImplementedError(
                "pivot_table needs explicit string/list index and columns "
                "and a single string values column")
        idx = [index] if isinstance(index, str) else list(index)
        col = [columns] if isinstance(columns, str) else list(columns)
        node = L.Aggregate(self._plan, idx + col,
                           [(values, aggfunc, "__v")])
        pdf = BodoDataFrame(node).to_pandas()
        return pdf.pivot(index=idx, columns=col, values="__v") \
            .rename_axis(columns=None if len(col) == 1 else col)

    def to_parquet(self, path: str, index: bool = False) -> None:
        raise NotImplementedError(
            "DataFrame.to_parquet (io/parquet.write_parquet and the "
            "streaming writer of plan/streaming.py) is not ported yet")

    def to_iceberg(self, table_path: str, mode: str = "append") -> int:
        raise NotImplementedError(
            "DataFrame.to_iceberg (io/iceberg.write_iceberg) is not ported "
            "yet")

    def explode(self, column: str) -> "BodoDataFrame":
        raise NotImplementedError(
            "DataFrame.explode (table/nested.py explode_table) is not "
            "ported yet")

    def drop(self, columns=None, **kw) -> "BodoDataFrame":
        if columns is None:
            warn_fallback("DataFrame.drop", "only columns= supported")
            return self._from_pandas(self.to_pandas().drop(**kw))
        cols = [columns] if isinstance(columns, str) else list(columns)
        keep = [n for n in self._plan.schema if n not in cols]
        return self[keep]

    def rename(self, columns: Optional[Dict[str, str]] = None, copy=None,
               **kw) -> "BodoDataFrame":
        if columns is None:
            warn_fallback("DataFrame.rename", "only columns= supported")
            return self._from_pandas(self.to_pandas().rename(**kw))
        exprs = [(columns.get(n, n), ColRef(n)) for n in self._plan.schema]
        return BodoDataFrame(L.Projection(self._plan, exprs))

    def apply(self, func, axis=0, raw=False, args=(), **kwargs):
        """axis=1 row UDFs are the compiled-UDF route (RowUDF, which
        raises NotImplementedError); anything else falls back to
        pandas."""
        if axis == 1 and not args and not kwargs:
            from bodo_tpu_torch.pandas_api.series import validate_expr_trace
            from bodo_tpu_torch.plan.expr import RowUDF
            traced = validate_expr_trace(RowUDF(func, None),
                                         self._plan.schema)
            return BodoSeries(self._plan,
                              RowUDF(func, dt.from_numpy(traced)), None)
        warn_fallback("DataFrame.apply", "uncompilable UDF or axis=0")
        return self.to_pandas().apply(func, axis=axis, raw=raw, args=args,
                                      **kwargs)

    # ---- relational ops ----------------------------------------------------
    def merge(self, right, on=None, left_on=None, right_on=None,
              how: str = "inner", suffixes=("_x", "_y")) -> "BodoDataFrame":
        if not isinstance(right, BodoDataFrame):
            right = self._from_pandas(right)
        plan_device(self._plan, right._plan)
        if how == "cross":
            if on is not None or left_on is not None or right_on is not None:
                raise ValueError("cross merge takes no join keys")
            left_on = right_on = []
        else:
            if on is not None:
                left_on = right_on = [on] if isinstance(on, str) \
                    else list(on)
            if left_on is None or right_on is None:
                raise ValueError("merge requires on= or left_on=/right_on=")
            left_on = [left_on] if isinstance(left_on, str) \
                else list(left_on)
            right_on = [right_on] if isinstance(right_on, str) \
                else list(right_on)
        return BodoDataFrame(L.Join(self._plan, right._plan, left_on,
                                    right_on, how, suffixes))

    def groupby(self, by, as_index: bool = True, dropna: bool = True,
                sort: bool = True):
        from bodo_tpu_torch.pandas_api.groupby import BodoGroupBy
        keys = [by] if isinstance(by, str) else list(by)
        return BodoGroupBy(self, keys, as_index=as_index)

    def sort_values(self, by, ascending=True, na_position: str = "last",
                    kind=None, ignore_index: bool = True) -> "BodoDataFrame":
        by = [by] if isinstance(by, str) else list(by)
        asc = [ascending] * len(by) if isinstance(ascending, bool) \
            else list(ascending)
        return BodoDataFrame(L.Sort(self._plan, by, asc,
                                    na_last=(na_position == "last")),
                             index=self._index)

    def drop_duplicates(self, subset=None) -> "BodoDataFrame":
        subset = [subset] if isinstance(subset, str) else \
            (list(subset) if subset else None)
        return BodoDataFrame(L.Distinct(self._plan, subset),
                             index=self._index)

    def head(self, n: int = 5) -> "BodoDataFrame":
        return BodoDataFrame(L.Limit(self._plan, n), index=self._index)

    # ---- index -------------------------------------------------------------
    def set_index(self, keys, drop: bool = True,
                  append: bool = False) -> "BodoDataFrame":
        """Designate column(s) as the index. The data stays a device
        column in the plan; nothing materializes."""
        keys = [keys] if isinstance(keys, str) else list(keys)
        for k in keys:
            if k not in self._plan.schema or k in set(self._index_cols()):
                raise KeyError(k)
        if not drop:
            # keep the column as data too: alias a copy for the index
            exprs = [(n, ColRef(n)) for n in self._plan.schema]
            exprs += [(f"__idx_{k}", ColRef(k)) for k in keys]
            index = (self._index if append else []) + \
                [(f"__idx_{k}", k) for k in keys]
            return BodoDataFrame(L.Projection(self._plan, exprs),
                                 index=index)
        if self._index and not append:
            # pandas drops the previous index entirely: project it away so
            # it does not resurface as a data column
            exprs = [(n, ColRef(n)) for n in self._data_cols()]
            return BodoDataFrame(L.Projection(self._plan, exprs),
                                 index=[(k, k) for k in keys])
        index = (self._index if append else []) + [(k, k) for k in keys]
        return BodoDataFrame(self._plan, index=index)

    def reset_index(self, drop: bool = False) -> "BodoDataFrame":
        if not self._index:
            return BodoDataFrame(self._plan)
        if drop:
            exprs = [(n, ColRef(n)) for n in self._data_cols()]
            return BodoDataFrame(L.Projection(self._plan, exprs))
        exprs = []
        for i, (c, disp) in enumerate(self._index):
            name = disp if disp is not None else (
                "index" if len(self._index) == 1 else f"level_{i}")
            exprs.append((name, ColRef(c)))
        exprs += [(n, ColRef(n)) for n in self._data_cols()]
        return BodoDataFrame(L.Projection(self._plan, exprs))

    def sort_index(self, ascending: bool = True) -> "BodoDataFrame":
        if not self._index:
            return self
        by = self._index_cols()
        return BodoDataFrame(
            L.Sort(self._plan, by, [ascending] * len(by)),
            index=self._index)

    @property
    def index(self):
        return self.to_pandas().index

    # ---- materialization ---------------------------------------------------
    def _execute(self):
        from bodo_tpu_torch.plan.physical import execute
        return execute(self._plan)

    def explain_analyze(self) -> str:
        raise NotImplementedError(
            "DataFrame.explain_analyze (plan/explain.py over the tracing "
            "layer's query spans) is not ported yet")

    def to_pandas(self):
        pdf = self._execute().to_pandas()
        if not self._index:
            return pdf
        icols = self._index_cols()
        pdf = pdf.set_index(icols)[self._data_cols()]
        pdf.index.names = [d for _, d in self._index]
        return pdf

    def __len__(self) -> int:
        return self._execute().nrows

    def __repr__(self) -> str:  # pragma: no cover
        head = self.head(10).to_pandas()
        n = len(self)
        return repr(head) + f"\n[{n} rows x {len(self._data_cols())} columns]"

    def __setattr__(self, name, value):  # guard accidental attr writes
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self[name] = value
