"""BodoGroupBy: the lazy groupby of a BodoDataFrame.

Counterpart of bodo_tpu/pandas_api/groupby.py. Aggregations build an
Aggregate node (relational.groupby_agg: sum ... kurt, the holistic
nunique, median and quantiles); the row-aligned group operations
(rank, cumcount, ntile, transform, shift) build RankWindow and
AggWindow nodes (relational.rank_window, agg_window). `apply` runs a
Python function on pandas group frames: on a 1D table after one hash
shuffle that puts every group on one shard (relational.shuffle_by_key,
shard_frames), each row keeping its global row id as its label.

Specs the groupby does not run lazily fall back to pandas with a
warning, chosen by the call before anything executes.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from bodo_tpu_torch.plan import logical as L
from bodo_tpu_torch.plan.expr import ColRef
from bodo_tpu_torch.utils.logging import warn_fallback


class BodoGroupBy:
    def __init__(self, df, keys: List[str], as_index: bool = True,
                 selection: Optional[List[str]] = None):
        self._df = df
        self._keys = keys
        self._as_index = as_index
        self._selection = selection
        self._single = False

    def __getitem__(self, key):
        sel = [key] if isinstance(key, str) else list(key)
        g = BodoGroupBy(self._df, self._keys, self._as_index, sel)
        g._single = isinstance(key, str)
        return g

    def _pandas_groupby(self, **kw):
        """The same groupby on the materialized pandas frame (fallback)."""
        gb = self._df.to_pandas().groupby(self._keys, **kw)
        if self._selection:
            gb = gb[self._selection[0] if len(self._selection) == 1
                    else self._selection]
        return gb

    # ---- agg spec normalization -------------------------------------------
    def _value_cols(self) -> List[str]:
        if self._selection is not None:
            return self._selection
        return [n for n in self._df._plan.schema if n not in self._keys]

    def agg(self, arg=None, **named):
        aggs: List[Tuple[str, str, str]] = []
        if arg is None and named:
            # named aggregation: out=("col", "op")
            for out, (col, op) in named.items():
                aggs.append((col, op, out))
        elif isinstance(arg, dict):
            for col, ops in arg.items():
                if isinstance(ops, str):
                    aggs.append((col, ops, col))
                else:
                    for op in ops:
                        aggs.append((col, op, f"{col}_{op}"))
        elif isinstance(arg, str):
            for col in self._value_cols():
                aggs.append((col, arg, col))
        elif isinstance(arg, (list, tuple)):
            for col in self._value_cols():
                for op in arg:
                    aggs.append((col, op, f"{col}_{op}"))
        else:
            warn_fallback("groupby.agg", f"unsupported spec {type(arg)}")
            gb = self._df.to_pandas().groupby(self._keys,
                                              as_index=self._as_index)
            if self._selection:
                gb = gb[self._selection]
            return gb.agg(arg, **named)
        return self._run(aggs)

    aggregate = agg

    def _run(self, aggs):
        from bodo_tpu_torch.pandas_api.frame import BodoDataFrame
        from bodo_tpu_torch.pandas_api.series import BodoSeries
        node = L.Aggregate(self._df._plan, self._keys, aggs)
        single = aggs[0][2] if (self._single and len(aggs) == 1) else None
        if self._as_index:
            # the keys become the result's index: still device columns in
            # the plan, converted only at to_pandas()
            index = [(k, k) for k in self._keys]
            if single is not None:
                return BodoSeries(node, ColRef(single), single, index=index)
            return BodoDataFrame(node, index=index)
        return BodoDataFrame(node)

    def _simple(self, op):
        if op == "size":
            aggs = [(self._keys[0], "size", "size")]
        else:
            aggs = [(c, op, c) for c in self._value_cols()
                    if op in ("count", "nunique", "first", "last", "mode")
                    or _numericish(self._df._plan.schema[c])]
        return self._run(aggs)

    def sum(self): return self._simple("sum")
    def mean(self): return self._simple("mean")
    def count(self): return self._simple("count")
    def min(self): return self._simple("min")
    def max(self): return self._simple("max")

    def var(self, ddof=1):
        from bodo_tpu_torch.pandas_api.series import _ddof_op
        return self._simple(_ddof_op("var", ddof))

    def std(self, ddof=1):
        from bodo_tpu_torch.pandas_api.series import _ddof_op
        return self._simple(_ddof_op("std", ddof))

    def first(self): return self._simple("first")
    def last(self): return self._simple("last")
    def nunique(self): return self._simple("nunique")
    def prod(self): return self._simple("prod")
    def median(self): return self._simple("median")
    def skew(self): return self._simple("skew")
    def kurt(self): return self._simple("kurt")
    kurtosis = kurt

    def quantile(self, q=0.5):
        if not isinstance(q, (int, float)):
            warn_fallback("groupby.quantile", "list of quantiles")
            return self._pandas_groupby(as_index=self._as_index).quantile(q)
        return self._simple(f"quantile_{float(q)}")

    # ---- transform-shaped (row-aligned) window functions ------------------
    _RANK_METHODS = {"first": "row_number", "min": "rank",
                     "dense": "dense_rank"}

    def rank(self, method: str = "min", ascending: bool = True):
        """Within-group rank of the selected column (SQL semantics for
        nulls: they rank together rather than producing NaN)."""
        if method not in self._RANK_METHODS or not self._single:
            warn_fallback("groupby.rank", f"method={method!r} or "
                          "multi-column selection")
            return self._pandas_groupby().rank(method=method,
                                               ascending=ascending)
        col = self._selection[0]
        return self._rank_window(self._RANK_METHODS[method], 0, [col],
                                 ascending)

    def cumcount(self):
        return self._rank_window("cumcount", 0, [], True)

    def ntile(self, n: int):
        """SQL NTILE(n) over the group in original row order."""
        return self._rank_window("ntile", int(n), [], True)

    def _rank_window(self, op: str, param: int, order_by, ascending: bool):
        from bodo_tpu_torch.pandas_api.series import BodoSeries
        out = f"__{op}"
        node = L.RankWindow(self._df._plan, self._keys, order_by,
                            [ascending] * len(order_by),
                            [(op, param, out)])
        return BodoSeries(node, ColRef(out), op)

    # pandas transform('first'/'last') skips nulls (unlike SQL
    # FIRST_VALUE), so only the null-agnostic aggregations map onto
    # AggWindow; sum0 is pandas' sum (an all-null group sums to 0)
    _TRANSFORM_OPS = {"sum": "sum0", "mean": "mean", "count": "count",
                      "min": "min", "max": "max"}

    def transform(self, op):
        """Row-aligned per-group aggregate (groupby.transform('sum') etc.)
        through AggWindow's whole-partition frame, the kernel of SQL
        SUM(...) OVER (PARTITION BY ...)."""
        if not isinstance(op, str) or op not in self._TRANSFORM_OPS:
            warn_fallback("groupby.transform", f"op {op!r}")
            return self._pandas_groupby().transform(op)
        return self._agg_window(
            lambda c, tmp: (self._TRANSFORM_OPS[op], c, ("all",), 0, tmp),
            "__tf", op)

    def shift(self, periods: int = 1):
        """Within-group shift (LEAD/LAG) in original row order."""
        op = "lag" if periods >= 0 else "lead"
        off = abs(int(periods))
        return self._agg_window(
            lambda c, tmp: (op, c, ("all",), off, tmp), "__sh", "shift")

    def _agg_window(self, spec_of, prefix: str, label: str):
        """The AggWindow tail of the row-aligned group ops: one spec per
        value column, then a Series (single selection) or a renamed
        frame."""
        cols = self._value_cols()
        specs = [spec_of(c, f"{prefix}_{c}") for c in cols]
        node = L.AggWindow(self._df._plan, self._keys, [], [], specs)
        if self._single:
            from bodo_tpu_torch.pandas_api.series import BodoSeries
            return BodoSeries(node, ColRef(f"{prefix}_{cols[0]}"), label)
        from bodo_tpu_torch.pandas_api.frame import BodoDataFrame
        out = BodoDataFrame(node)
        return out[[f"{prefix}_{c}" for c in cols]].rename(
            columns={f"{prefix}_{c}": c for c in cols})

    def apply(self, func, *args, **kwargs):
        """Per-group Python function. On a 1D table one hash shuffle puts
        every group on one shard (relational.shuffle_by_key), and the
        function runs on each shard's pandas frame (shard_frames), the
        shuffle-then-local model of the reference's groupby.apply under
        JIT. Results concatenate and sort to pandas' group order."""
        import pandas as pd

        from bodo_tpu_torch import relational as R
        t = self._df._execute()
        if t.distribution != "REP" and t.num_shards > 1:
            # carry the global row id through the shuffle so each shard's
            # frame keeps the original row labels: a same-length result
            # (transform-like) then reassembles in pandas' row order
            t2 = R.window_table(t, [(t.names[0], "rowid", None, "__rid")])
            t2 = R.shuffle_by_key(t2, self._keys)
            frames = [f.set_index("__rid").rename_axis(None)
                      for f in R.shard_frames(t2)]
        else:
            frames = [t.to_pandas()]
        sel = None
        if self._selection is not None:
            sel = self._selection[0] if self._single else self._selection
        parts = []
        for f in frames:
            if not len(f):
                continue
            gb = f.groupby(self._keys, as_index=True)
            if sel is not None:
                gb = gb[sel]
            parts.append(gb.apply(func, *args, **kwargs))
        if not parts:
            gb = pd.DataFrame(columns=list(self._df._plan.schema)
                              ).groupby(self._keys)
            if sel is not None:
                gb = gb[sel]
            return gb.apply(func, *args, **kwargs)
        res = pd.concat(parts)
        res = res.sort_index(level=list(range(len(self._keys)))
                             if res.index.nlevels > 1 else None,
                             kind="stable")
        if not self._as_index:
            res = res.reset_index()
        return res

    def size(self):
        from bodo_tpu_torch.pandas_api.series import BodoSeries
        res = self._run([(self._keys[0], "size", "size")])
        if self._as_index:
            # pandas: SeriesGroupBy.size keeps the column name,
            # DataFrameGroupBy.size is unnamed
            name = self._selection[0] if self._single else None
            if not isinstance(res, BodoSeries):
                res = BodoSeries(res._plan, ColRef("size"), "size",
                                 index=res._index)
            return res.to_pandas().rename(name)
        return res

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._df._plan.schema:
            return self[name]
        warn_fallback(f"groupby.{name}", "not yet lazy")
        return getattr(self._pandas_groupby(as_index=self._as_index), name)


def _numericish(t) -> bool:
    return t.kind in ("i", "u", "f", "b")
