"""BodoSeries: a lazy column expression bound to a plan.

Counterpart of bodo_tpu/pandas_api/series.py, with the str, dt and cat
accessors. A Series is (plan, expr): arithmetic composes expressions
without execution; reductions execute a Reduce node; comparisons against
strings become dictionary-code predicates (StrPredicate), since raw
strings never reach the device.

The pandas fallback (warn_fallback, then the same call on the
materialized pandas Series) is chosen by the API and its arguments
before anything executes, as in the JAX package; nothing that raises
while executing is handed to pandas. Routes the port has not ported
raise NotImplementedError naming them: `map(callable)` (RowUDF, the
compiled UDF), `.str.len`, `.str.find`, `.str.count`, `.str.cat` with
others and `.cat.codes` (StrLen, StrHostFn, StrConcat, StrCodes of
plan/expr.py, when the result executes), `.list`, `.struct` and
`.str.split(expand=False)` (table/nested.py), `.ai` (ai/series.py).
pandas is imported inside the methods that need it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from bodo_tpu_torch.plan import logical as L
from bodo_tpu_torch.plan.expr import (BinOp, Cast, ColRef, DtField, Expr,
                                      IsIn, Lit, StrPredicate, UnOp, Where,
                                      infer_dtype)
from bodo_tpu_torch.table import dtypes as dt
from bodo_tpu_torch.utils.logging import warn_fallback


def validate_expr_trace(expr: Expr, schema):
    """Evaluate an expression (a UDF) on a 4-row zero table of `schema` on
    the CPU; returns its output numpy dtype. What the evaluator does not
    take raises (RowUDF: NotImplementedError naming it), where the JAX
    package returns None and falls back to pandas."""
    import torch

    from bodo_tpu_torch.plan.expr import eval_expr
    tree = {n: (torch.zeros(4, dtype=t.torch), None)
            for n, t in schema.items()}
    dicts = {n: np.array(["a"], dtype=str) for n, t in schema.items()
             if t is dt.STRING}
    out, _ = eval_expr(expr, tree, dicts, schema)
    return out.numpy().dtype


def _ddof_op(op: str, ddof: int) -> str:
    """var/std with ddof 0/1 map to dedicated ops; others are unsupported."""
    if ddof == 1:
        return op
    if ddof == 0:
        return op + "0"
    raise NotImplementedError(f"{op} with ddof={ddof} (only 0 and 1)")


def _unported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


class BodoSeries:
    def __init__(self, plan: L.Node, expr: Expr, name: str = None,
                 index=None):
        self._plan = plan
        self._expr = expr
        # [(plan_column, display_name)]: the index threaded as columns,
        # as in BodoDataFrame (set by indexed frames, groupby as_index)
        self._index = list(index) if index else []
        self._name = name if name is not None else (
            expr.name if isinstance(expr, ColRef) else None)
        self._categorical = False  # astype('category') materialization flag

    # ---- dtype ------------------------------------------------------------
    @property
    def _dtype(self) -> dt.DType:
        return infer_dtype(self._expr, self._plan.schema)

    @property
    def dtype(self):
        d = self._dtype
        return np.dtype(d.np_dtype) if d is not dt.STRING else np.dtype("O")

    @property
    def name(self):
        return self._name

    # ---- expression building ----------------------------------------------
    def _wrap(self, expr: Expr, name=None) -> "BodoSeries":
        return BodoSeries(self._plan, expr, name or self._name,
                          index=self._index)

    def _coerce(self, other):
        """Other operand -> Expr (string literals become predicates at the
        comparison level, in _cmp)."""
        if isinstance(other, BodoSeries):
            if other._plan is not self._plan:
                raise ValueError(
                    "cannot combine Series from different frames lazily; "
                    "merge the frames first")
            return other._expr
        import pandas as pd
        if isinstance(other, pd.Timestamp):
            return Lit(np.datetime64(other.to_datetime64()))
        return Lit(other)

    def _bin(self, op, other, reverse=False):
        o = self._coerce(other)
        e = BinOp(op, o, self._expr) if reverse else BinOp(op, self._expr, o)
        return self._wrap(e, None)

    def _cmp(self, op, other):
        # string comparison -> dictionary predicate
        if isinstance(other, str) and self._dtype is dt.STRING:
            if op == "==":
                return self._wrap(StrPredicate("eq_any", (other,), self._expr))
            if op == "!=":
                return self._wrap(UnOp("~", StrPredicate(
                    "eq_any", (other,), self._expr)))
            raise TypeError(f"string ordering comparison {op} unsupported")
        return self._bin(op, other)

    def __add__(self, o): return self._bin("+", o)
    def __radd__(self, o): return self._bin("+", o, True)
    def __sub__(self, o): return self._bin("-", o)
    def __rsub__(self, o): return self._bin("-", o, True)
    def __mul__(self, o): return self._bin("*", o)
    def __rmul__(self, o): return self._bin("*", o, True)
    def __truediv__(self, o): return self._bin("/", o)
    def __rtruediv__(self, o): return self._bin("/", o, True)
    def __floordiv__(self, o): return self._bin("//", o)
    def __mod__(self, o): return self._bin("%", o)
    def __pow__(self, o): return self._bin("**", o)
    def __eq__(self, o): return self._cmp("==", o)  # type: ignore[override]
    def __ne__(self, o): return self._cmp("!=", o)  # type: ignore[override]
    def __lt__(self, o): return self._cmp("<", o)
    def __le__(self, o): return self._cmp("<=", o)
    def __gt__(self, o): return self._cmp(">", o)
    def __ge__(self, o): return self._cmp(">=", o)
    def __and__(self, o): return self._bin("&", o)
    def __or__(self, o): return self._bin("|", o)
    def __invert__(self): return self._wrap(UnOp("~", self._expr))
    def __neg__(self): return self._wrap(UnOp("neg", self._expr))
    def __abs__(self): return self._wrap(UnOp("abs", self._expr))
    def abs(self): return self._wrap(UnOp("abs", self._expr))
    __hash__ = None  # type: ignore[assignment]

    def isin(self, values):
        vals = tuple(values)
        if self._dtype is dt.STRING:
            return self._wrap(StrPredicate("eq_any", vals, self._expr))
        return self._wrap(IsIn(self._expr, vals))

    def isna(self): return self._wrap(UnOp("isna", self._expr))
    def notna(self): return self._wrap(UnOp("notna", self._expr))
    def fillna(self, v): return self._wrap(
        Where(UnOp("isna", self._expr), Lit(v), self._expr))

    def astype(self, dtype) -> "BodoSeries":
        import pandas as pd
        if (isinstance(dtype, str) and dtype in ("category", "Category")) \
                or isinstance(dtype, pd.CategoricalDtype):
            if self._dtype is not dt.STRING:
                warn_fallback("Series.astype", "category of non-string")
                return self.to_pandas().astype("category")
            # strings are dictionary-encoded already: categorical is a
            # materialization flag, not a representation change
            out = self._wrap(self._expr)
            out._categorical = True
            return out
        return self._wrap(Cast(self._expr, dt.from_numpy(np.dtype(dtype))))

    def where(self, cond, other) -> "BodoSeries":
        c = cond._expr if isinstance(cond, BodoSeries) else Lit(cond)
        o = other._expr if isinstance(other, BodoSeries) else Lit(other)
        return self._wrap(Where(c, self._expr, o))

    # ---- window / cumulative --------------------------------------------
    def _window(self, op: str, param=None):
        if self._dtype.kind not in ("i", "u", "f", "b"):
            # temporal/string physical values would round-trip through
            # float64 (lossy above 2^53 ns): use pandas
            warn_fallback(f"Series.{op}", f"{self._dtype.name} dtype")
            pds = self.to_pandas()
            if op.startswith("rolling_"):
                return getattr(pds.rolling(param), op[len("rolling_"):])()
            if op in ("shift", "diff"):
                return getattr(pds, op)(param)
            return getattr(pds, op)()
        name = self._name or "_val"
        base = self._as_projection(name)
        out = f"__w_{name}"
        node = L.Window(base, [(name, op, param, out)])
        return BodoSeries(node, ColRef(out), self._name)

    def cumsum(self): return self._window("cumsum")
    def cumprod(self): return self._window("cumprod")
    def cummax(self): return self._window("cummax")
    def cummin(self): return self._window("cummin")

    def shift(self, periods: int = 1):
        if periods < 1:
            warn_fallback("Series.shift", "non-positive periods")
            return self.to_pandas().shift(periods)
        return self._window("shift", periods)

    def diff(self, periods: int = 1):
        if periods < 1:
            warn_fallback("Series.diff", "non-positive periods")
            return self.to_pandas().diff(periods)
        return self._window("diff", periods)

    def rolling(self, window: int, min_periods=None):
        if min_periods is not None and min_periods != window:
            warn_fallback("Series.rolling", "min_periods != window")
            return self.to_pandas().rolling(window, min_periods=min_periods)
        return _Rolling(self, window)

    # ---- accessors ----------------------------------------------------------
    @property
    def dt(self):
        return _DtAccessor(self)

    @property
    def ai(self):
        _unported("Series.ai (ai/series.py AiAccessor)")

    @property
    def str(self):
        return _StrAccessor(self)

    @property
    def cat(self):
        return _CatAccessor(self)

    @property
    def list(self):
        _unported("Series.list (table/nested.py list columns)")

    @property
    def struct(self):
        _unported("Series.struct (table/nested.py struct columns)")

    # ---- reductions ---------------------------------------------------------
    def _reduce(self, op):
        from bodo_tpu_torch.plan.physical import execute
        name = self._name or "_val"
        node = L.Reduce(self._as_projection(name), [(name, op, name)])
        return execute(node).to_pandas()[name].iloc[0]

    def sum(self): return self._reduce("sum")
    def mean(self): return self._reduce("mean")
    def min(self): return self._reduce("min")
    def max(self): return self._reduce("max")
    def count(self): return self._reduce("count")
    def prod(self): return self._reduce("prod")

    def var(self, ddof: int = 1):
        return self._reduce(_ddof_op("var", ddof))

    def std(self, ddof: int = 1):
        return self._reduce(_ddof_op("std", ddof))

    def median(self):
        return self._reduce("median")

    def quantile(self, q=0.5):
        if not isinstance(q, (int, float)):
            warn_fallback("Series.quantile", "list of quantiles")
            return self.to_pandas().quantile(q)
        return self._reduce(f"quantile_{float(q)}")

    def sort_values(self, ascending: bool = True) -> "BodoSeries":
        name = self._name or "_val"
        node = L.Sort(self._as_projection(name), [name], [bool(ascending)])
        return BodoSeries(node, ColRef(name), self._name)

    def nlargest(self, n: int = 5):
        return self.sort_values(ascending=False).head(n)

    def nsmallest(self, n: int = 5):
        return self.sort_values(ascending=True).head(n)

    def nunique(self):
        from bodo_tpu_torch.plan.physical import execute
        name = self._name or "_val"
        return execute(L.Aggregate(self._as_projection(name), [name],
                                   [])).nrows

    def unique(self):
        from bodo_tpu_torch.plan.physical import execute
        name = self._name or "_val"
        node = L.Aggregate(self._as_projection(name), [name], [])
        return execute(node).to_pandas()[name].to_numpy()

    def value_counts(self, ascending: bool = False):
        import pandas as pd

        from bodo_tpu_torch.plan.physical import execute
        name = self._name or "_val"
        agg = L.Aggregate(self._as_projection(name), [name],
                          [(name, "size", "count")])
        pdf = execute(L.Sort(agg, ["count"], [ascending])).to_pandas()
        return pd.Series(pdf["count"].to_numpy(),
                         index=pd.Index(pdf[name], name=name), name="count")

    # ---- materialization ------------------------------------------------
    def _as_projection(self, name: Optional[str] = None) -> L.Node:
        name = name or self._name or "_val"
        exprs = [(name, self._expr)]
        exprs += [(c, ColRef(c)) for c, _ in self._index if c != name]
        return L.Projection(self._plan, exprs)

    def _finish(self, t, name: str):
        pdf = t.to_pandas()
        if self._index:
            icols = [c for c, _ in self._index if c != name]
            if icols:
                pdf = pdf.set_index(icols)
                pdf.index.names = [d for (c, d) in self._index if c != name]
        out = pdf[name].rename(self._name)
        if self._categorical:
            out = out.astype("category")
        return out

    def to_pandas(self):
        from bodo_tpu_torch.plan.physical import execute
        name = self._name or "_val"
        return self._finish(execute(self._as_projection(name)), name)

    def head(self, n: int = 5):
        from bodo_tpu_torch.plan.physical import execute
        name = self._name or "_val"
        return self._finish(execute(L.Limit(self._as_projection(name), n)),
                            name)

    def reset_index(self, drop: bool = False):
        if drop or not self._index:
            return BodoSeries(self._plan, self._expr, self._name)
        from bodo_tpu_torch.pandas_api.frame import BodoDataFrame
        name = self._name or "_val"
        exprs = []
        for i, (c, disp) in enumerate(self._index):
            out = disp if disp is not None else (
                "index" if len(self._index) == 1 else f"level_{i}")
            exprs.append((out, ColRef(c)))
        exprs.append((name, self._expr))
        return BodoDataFrame(L.Projection(self._plan, exprs))

    def sort_index(self, ascending: bool = True) -> "BodoSeries":
        if not self._index:
            return self
        by = [c for c, _ in self._index]
        node = L.Sort(self._plan, by, [ascending] * len(by))
        return BodoSeries(node, self._expr, self._name, index=self._index)

    @property
    def index(self):
        return self.to_pandas().index

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.to_pandas(), dtype=dtype)

    def __len__(self):
        from bodo_tpu_torch.plan.physical import execute
        return execute(self._plan).nrows

    def __repr__(self):  # pragma: no cover
        return f"BodoSeries(name={self._name}, dtype={self._dtype.name})\n" \
            + repr(self.head(10))

    def map(self, arg):
        """A dict of at most 64 entries over a non-string series becomes a
        Where chain on the device; a callable over a numeric series is
        the compiled-UDF route (RowUDF), which raises here; anything else
        falls back to pandas."""
        if isinstance(arg, dict) and len(arg) <= 64 and \
                self._dtype is not dt.STRING:
            expr: Expr = Lit(np.nan)
            for k, v in reversed(list(arg.items())):
                expr = Where(BinOp("==", self._expr, Lit(k)), Lit(v), expr)
            return self._wrap(expr)
        if callable(arg) and self._dtype.kind in ("i", "u", "f", "b"):
            from bodo_tpu_torch.plan.expr import RowUDF
            e = RowUDF(arg, None, self._expr)
            traced = validate_expr_trace(e, self._plan.schema)
            return self._wrap(RowUDF(arg, dt.from_numpy(traced), self._expr))
        warn_fallback("Series.map", "uncompilable or string mapper")
        return self.to_pandas().map(arg)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        import pandas as pd
        if hasattr(pd.Series, name):
            warn_fallback(f"Series.{name}", "not yet lazy")
            return getattr(self.to_pandas(), name)
        raise AttributeError(name)


class _Rolling:
    """Series.rolling(w): fixed windows (halos across shards)."""

    def __init__(self, s: BodoSeries, window: int):
        self._s = s
        self._w = window

    def _agg(self, op):
        return self._s._window(f"rolling_{op}", self._w)

    def sum(self): return self._agg("sum")
    def mean(self): return self._agg("mean")
    def min(self): return self._agg("min")
    def max(self): return self._agg("max")
    def count(self): return self._agg("count")


class _CatAccessor:
    """Series.cat over the dictionary encoding: strings carry a sorted
    dictionary, which is the category array. As in the JAX package the
    dictionary persists through filters, so `.cat.categories` keeps a
    category whose rows were all filtered away, where pandas'
    astype('category') keeps only the values left."""

    def __init__(self, s: BodoSeries):
        if s._dtype is not dt.STRING:
            raise AttributeError(".cat requires a string/categorical series")
        self._s = s

    @property
    def codes(self) -> BodoSeries:
        from bodo_tpu_torch.plan.expr import StrCodes
        return self._s._wrap(StrCodes(self._s._expr))

    @property
    def categories(self):
        import pandas as pd

        from bodo_tpu_torch.plan.physical import execute
        name = self._s._name or "_val"
        d = execute(self._s._as_projection(name)).column(name).dictionary
        return pd.Index(d if d is not None else [], dtype=object)

    def as_ordered(self):  # dictionary order is sorted already
        return self._s


class _DtAccessor:
    """Series.dt: datetime fields (ops/datetime.FIELDS on the device)."""

    def __init__(self, s: BodoSeries):
        self._s = s

    def __getattr__(self, field):
        from bodo_tpu_torch.ops.datetime import FIELDS
        if field in FIELDS:
            return self._s._wrap(DtField(field, self._s._expr))
        raise AttributeError(f"dt.{field} not supported")


class _StrAccessor:
    """Series.str: predicates and transforms on the host dictionary, the
    device remapping codes (StrPredicate, DictMap)."""

    def __init__(self, s: BodoSeries):
        self._s = s

    def contains(self, pat, regex: bool = False):
        kind = "match" if regex else "contains"
        pat_ = (".*" + pat,) if regex else (pat,)
        return self._s._wrap(StrPredicate(kind, pat_, self._s._expr))

    def startswith(self, pat):
        pats = (pat,) if isinstance(pat, str) else tuple(pat)
        return self._s._wrap(StrPredicate("startswith", pats, self._s._expr))

    def endswith(self, pat):
        pats = (pat,) if isinstance(pat, str) else tuple(pat)
        return self._s._wrap(StrPredicate("endswith", pats, self._s._expr))

    def match(self, pat):
        return self._s._wrap(StrPredicate("match", (pat,), self._s._expr))

    # ---- dictionary transforms (host LUT, device code remap) -------------
    def _map(self, kind, *params):
        from bodo_tpu_torch.plan.expr import DictMap
        return self._s._wrap(DictMap(kind, tuple(params), self._s._expr))

    def upper(self): return self._map("upper")
    def lower(self): return self._map("lower")
    def title(self): return self._map("title")
    def capitalize(self): return self._map("capitalize")

    def strip(self, to_strip=None):
        return self._map("strip", *(() if to_strip is None else (to_strip,)))

    def lstrip(self, to_strip=None):
        return self._map("lstrip",
                         *(() if to_strip is None else (to_strip,)))

    def rstrip(self, to_strip=None):
        return self._map("rstrip",
                         *(() if to_strip is None else (to_strip,)))

    def replace(self, old, new, regex: bool = False):
        if regex:
            warn_fallback("Series.str.replace", "regex=True")
            return self._s.to_pandas().str.replace(old, new, regex=True)
        return self._map("replace", old, new)

    def slice(self, start=None, stop=None):
        return self._map("slice", start, stop)

    def zfill(self, width: int): return self._map("zfill", width)

    def len(self):
        from bodo_tpu_torch.plan.expr import StrLen
        return self._s._wrap(StrLen(self._s._expr))

    def fullmatch(self, pat):
        return self._s._wrap(StrPredicate("fullmatch", (pat,),
                                          self._s._expr))

    def isin(self, values):
        return self._s._wrap(StrPredicate("eq_any", tuple(values),
                                          self._s._expr))

    def pad(self, width: int, side: str = "left", fillchar: str = " "):
        kind = {"left": "rjust", "right": "ljust", "both": "center"}[side]
        return self._map(kind, width, fillchar)

    def ljust(self, width: int, fillchar: str = " "):
        return self._map("ljust", width, fillchar)

    def rjust(self, width: int, fillchar: str = " "):
        return self._map("rjust", width, fillchar)

    def center(self, width: int, fillchar: str = " "):
        return self._map("center", width, fillchar)

    def repeat(self, repeats: int):
        return self._map("repeat", int(repeats))

    def get(self, i: int):
        return self._map("get", int(i))

    def find(self, sub: str):
        from bodo_tpu_torch.plan.expr import StrHostFn
        # pandas find is 0-based with -1 absent; position is 1-based/0
        return self._s._wrap(BinOp(
            "-", StrHostFn("position", (sub,), self._s._expr), Lit(1)))

    def count(self, pat: str):
        from bodo_tpu_torch.plan.expr import StrHostFn
        return self._s._wrap(StrHostFn("regexp_count", (pat,),
                                       self._s._expr))

    def cat(self, others=None, sep: str = ""):
        from bodo_tpu_torch.plan.expr import StrConcat
        if others is None:
            warn_fallback("Series.str.cat", "reduction form")
            return self._s.to_pandas().str.cat(sep=sep)
        parts = [self._s._expr]
        olist = others if isinstance(others, (list, tuple)) else [others]
        for o in olist:
            if sep:
                parts.append(sep)
            parts.append(o._expr if isinstance(o, BodoSeries) else str(o))
        return self._s._wrap(StrConcat(tuple(parts)))

    def split(self, pat=None, n: int = -1, expand: bool = False):
        """Split on the host dictionary: each output part is a new
        dictionary-encoded column over the original codes. expand=False
        (a list<string> column) needs table/nested.py."""
        if not expand:
            _unported("Series.str.split(expand=False) (table/nested.py "
                      "list columns)")
        import torch

        from bodo_tpu_torch.pandas_api.frame import BodoDataFrame
        from bodo_tpu_torch.plan.physical import execute
        from bodo_tpu_torch.table.table import Column, Table
        name = self._s._name or "_val"
        t = execute(self._s._as_projection(name))
        src = t.column(name)
        dic = src.dictionary if src.dictionary is not None else \
            np.array([], dtype=str)
        parts = [s.split(pat) if n <= 0 else s.split(pat, n) for s in dic]
        width = max((len(p) for p in parts), default=0)
        codes = torch.clamp(src.data.to(torch.int64), 0,
                            max(len(dic) - 1, 0))
        cols = {}
        for i in range(width):
            vals = np.array([p[i] if i < len(p) else "" for p in parts],
                            dtype=str)
            uniq, inv = np.unique(vals, return_inverse=True)
            lut = torch.from_numpy(inv.astype(np.int32)).to(t.device)
            has = torch.from_numpy(np.array([i < len(p) for p in parts],
                                            dtype=bool)).to(t.device)
            valid = has[codes]
            if src.valid is not None:
                valid = valid & src.valid
            cols[str(i)] = Column(lut[codes], valid, src.dtype, uniq)
        out = Table(cols, t.nrows, t.distribution, t.counts)
        return BodoDataFrame(L.FromPandas(out))

    def __getattr__(self, name):
        import pandas as pd
        if hasattr(pd.Series.str, name):
            warn_fallback(f"Series.str.{name}", "not yet lazy")
            return getattr(self._s.to_pandas().str, name)
        raise AttributeError(name)
