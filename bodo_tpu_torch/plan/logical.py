"""Logical plan nodes (lazy query DAG).

Counterpart of bodo_tpu/plan/logical.py: the same node classes, with the
same output schemas and structural `key()`s. Each node carries its
output schema (host-side dtype dict), computed at construction. Nodes
memoize their executed Table (`_cached`, plan/physical.py).

The sources name the device their table lives on: FromPandas builds
its Table there at construction, ReadParquet and ReadCsv read onto it
when they execute (CUDA unless the caller names another device). The
device is not part of a node's key.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from bodo_tpu_torch.ops.groupby import agg_dtype
from bodo_tpu_torch.plan.expr import Expr, infer_dtype
from bodo_tpu_torch.table import dtypes as dt

Schema = Dict[str, dt.DType]


class Node:
    schema: Schema
    children: List["Node"]
    _cached = None  # executed Table

    def key(self) -> Tuple:
        raise NotImplementedError

    def __repr__(self):  # pragma: no cover
        name = type(self).__name__
        return f"{name}({', '.join(self.schema)})[{len(self.children)} ch]"


class ReadParquet(Node):
    """Parquet scan. `path` may be a directory/glob/file or a
    pre-resolved TUPLE of data files (the Iceberg snapshot path — keeps
    the scan lazy so pruning/pushdown reach it)."""

    def __init__(self, path, columns: Optional[Sequence[str]] = None,
                 device=None):
        import pyarrow.parquet as pq

        from bodo_tpu_torch.io.parquet import _dataset_files
        if isinstance(path, (list, tuple)):
            raise NotImplementedError(
                "a pre-resolved list of parquet files (the Iceberg "
                "snapshot scan) is not ported yet")
        self.path = path
        self.device = device
        self.children = []
        arrow_schema = pq.read_schema(_dataset_files(self.path)[0])
        names = list(columns) if columns else arrow_schema.names
        self.columns = names
        self.schema = {}
        for n in names:
            self.schema[n] = _arrow_field_dtype(arrow_schema.field(n).type)

    def key(self):
        return ("read_parquet", self.path, tuple(self.columns))


class ViewScan(Node):
    """Scan of a named materialized view (runtime/views.py). A leaf: the
    view's current materialization is served from the result cache at
    execution time, so downstream plans compose over views exactly like
    over base tables. key() carries only the NAME: a consumer plan keeps
    a stable fingerprint across view refreshes, and the result cache
    signs it with the view's BASE source signatures — so a refresh
    supersedes (and drops) the consumer's old entry instead of orphaning
    it. `version` is the view's maintenance generation at construction
    (introspection only)."""

    def __init__(self, name: str, schema: Schema, version: int = 0):
        self.name = name
        self.children = []
        self.schema = dict(schema)
        self.version = int(version)

    def key(self):
        return ("view_scan", self.name)


class ReadCsv(Node):
    def __init__(self, path: str, columns=None, parse_dates=None,
                 schema: Optional[Schema] = None, device=None):
        self.path = path
        self.device = device
        self.columns = columns
        self.parse_dates = tuple(parse_dates) if parse_dates else ()
        self.children = []
        if schema is None:
            import pyarrow.csv as pacsv
            # infer from the first block only — never parse the whole file
            # at plan-construction time
            with pacsv.open_csv(path, read_options=pacsv.ReadOptions(
                    block_size=1 << 20)) as reader:
                head = reader.read_next_batch()
            schema = {}
            for f_ in head.schema:
                if f_.name in self.parse_dates:
                    schema[f_.name] = dt.DATETIME
                else:
                    schema[f_.name] = _arrow_field_dtype(f_.type)
            if columns:
                schema = {n: schema[n] for n in columns}
        self.schema = schema

    def key(self):
        return ("read_csv", self.path, tuple(self.columns or ()),
                self.parse_dates)


class FromPandas(Node):
    """In-memory source: a pandas frame becomes a Table on `device` (a
    port Table is taken as it is)."""
    _counter = [0]

    def __init__(self, df, device=None):
        from bodo_tpu_torch.table.table import Table
        self.children = []
        if isinstance(df, Table):
            self.table = df
        else:
            self.table = Table.from_pandas(df, device=device)
        self.schema = {n: c.dtype for n, c in self.table.columns.items()}
        FromPandas._counter[0] += 1
        self._id = FromPandas._counter[0]

    def key(self):
        return ("from_pandas", self._id)


class Explode(Node):
    """LATERAL FLATTEN over a list column: one output row per element,
    adding `value_name` (element) + `index_name` (0-based position)
    while keeping every child column; empty/null arrays drop unless
    `outer` (reference: BodoSQL lateral FLATTEN,
    BodoSQL/bodosql/kernels/lateral.py, bodo/libs/_lateral.cpp)."""

    def __init__(self, child: Node, column: str, value_name: str,
                 index_name: str, outer: bool = False):
        self.children = [child]
        self.column = column
        self.value_name = value_name
        self.index_name = index_name
        self.outer = outer
        cdt = child.schema[column]
        if cdt.kind != "list":
            raise TypeError(f"FLATTEN input {column!r} is not an array "
                            f"column ({cdt.name})")
        sch = dict(child.schema)
        sch[value_name] = cdt.elem
        sch[index_name] = dt.INT64
        self.schema = sch

    @property
    def child(self):
        return self.children[0]

    def key(self):
        return ("explode", self.child.key(), self.column,
                self.value_name, self.index_name, self.outer)


class Projection(Node):
    def __init__(self, child: Node, exprs: Sequence[Tuple[str, Expr]]):
        self.children = [child]
        self.exprs = list(exprs)
        self.schema = {n: infer_dtype(e, child.schema) for n, e in self.exprs}

    @property
    def child(self):
        return self.children[0]

    def key(self):
        return ("project", self.child.key(),
                tuple((n, e.key()) for n, e in self.exprs))


class Filter(Node):
    def __init__(self, child: Node, predicate: Expr):
        self.children = [child]
        self.predicate = predicate
        self.schema = dict(child.schema)

    @property
    def child(self):
        return self.children[0]

    def key(self):
        return ("filter", self.child.key(), self.predicate.key())


class Aggregate(Node):
    def __init__(self, child: Node, keys: Sequence[str],
                 aggs: Sequence[Tuple[str, str, str]]):
        self.children = [child]
        self.keys = list(keys)
        self.aggs = list(aggs)
        sch: Schema = {k: child.schema[k] for k in self.keys}
        for col, op, out in self.aggs:
            sch[out] = agg_dtype(op, child.schema[col])
        self.schema = sch

    @property
    def child(self):
        return self.children[0]

    def key(self):
        return ("agg", self.child.key(), tuple(self.keys),
                tuple(self.aggs))


class Reduce(Node):
    """Whole-column reductions (Series.sum() etc.) — 1-row output."""

    def __init__(self, child: Node, aggs: Sequence[Tuple[str, str, str]]):
        self.children = [child]
        self.aggs = list(aggs)
        sch: Schema = {}
        for col, op, out in self.aggs:
            sch[out] = agg_dtype(op, child.schema[col])
        self.schema = sch

    @property
    def child(self):
        return self.children[0]

    def key(self):
        return ("reduce", self.child.key(), tuple(self.aggs))


class Union(Node):
    """UNION ALL / concat of schema-compatible inputs (reference:
    LogicalSetOperation plan.py, streaming union op)."""

    def __init__(self, children):
        assert len(children) >= 2
        self.children = list(children)
        first = children[0].schema
        for c in children[1:]:
            if list(c.schema) != list(first):
                raise ValueError(
                    f"union schema mismatch: {list(first)} vs "
                    f"{list(c.schema)}")
            for name in first:
                a, b = first[name], c.schema[name]
                if a is b:
                    continue
                if dt.is_numeric(a) and dt.is_numeric(b):
                    continue  # concat_tables promotes
                if dt.is_decimal(a) or dt.is_decimal(b):
                    # concat_tables handles every decimal mix: same-scale
                    # decimals keep the type, otherwise float64 descale
                    if (dt.is_decimal(a) or dt.is_numeric(a)) and \
                            (dt.is_decimal(b) or dt.is_numeric(b)):
                        continue
                raise ValueError(
                    f"union dtype mismatch on {name}: {a.name} vs {b.name}")
        self.schema = dict(first)
        # decimal result type mirrors concat_tables' promotion: all same
        # scale → widest precision; mixed scale / decimal+float → float64
        for name, a in first.items():
            kinds = [c.schema[name] for c in self.children]
            if any(dt.is_decimal(k) for k in kinds):
                scales = {k.scale for k in kinds if dt.is_decimal(k)}
                if len(scales) == 1 and all(dt.is_decimal(k)
                                            for k in kinds):
                    self.schema[name] = dt.decimal(
                        scales.pop(),
                        precision=max(k.precision for k in kinds))
                else:
                    self.schema[name] = dt.FLOAT64

    def key(self):
        return ("union", tuple(c.key() for c in self.children))


class Window(Node):
    """Row-aligned window transforms (cumsum/rolling/shift/diff) —
    specs = [(col, op, param, outname)]."""

    def __init__(self, child: Node, specs):
        self.children = [child]
        self.specs = [tuple(s) for s in specs]
        sch = dict(child.schema)
        for col, op, param, out in self.specs:
            sch[out] = dt.INT64 if op == "rowid" else dt.FLOAT64
        self.schema = sch

    @property
    def child(self):
        return self.children[0]

    def key(self):
        return ("window", self.child.key(), tuple(self.specs))


class RankWindow(Node):
    """Partitioned ranking windows: specs = [(op, param, out)] with op in
    row_number/rank/dense_rank/ntile/cumcount (SQL OVER(PARTITION BY ...
    ORDER BY ...); pandas groupby.rank/cumcount)."""

    def __init__(self, child: Node, partition_by, order_by, ascending,
                 specs):
        self.children = [child]
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.ascending = list(ascending)
        self.specs = [tuple(s) for s in specs]
        sch = dict(child.schema)
        for op, param, out in self.specs:
            sch[out] = dt.INT64
        self.schema = sch

    @property
    def child(self):
        return self.children[0]

    def key(self):
        return ("rankwin", self.child.key(), tuple(self.partition_by),
                tuple(self.order_by), tuple(self.ascending),
                tuple(self.specs))


class AggWindow(Node):
    """Aggregate/navigation windows: specs = [(op, col, frame, param,
    out)] with op in sum/mean/count/min/max/lead/lag/first_value/
    last_value; frame = ("all",) | ("cumrange",) | ("rows", lo, hi)
    (SQL OVER(... ROWS BETWEEN ...); pandas groupby.transform /
    groupby.shift)."""

    def __init__(self, child: Node, partition_by, order_by, ascending,
                 specs):
        self.children = [child]
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.ascending = list(ascending)
        self.specs = [(op, col, tuple(frame), param, out)
                      for op, col, frame, param, out in specs]
        sch = dict(child.schema)
        for op, col, frame, param, out in self.specs:
            src = sch[col]
            if op in ("lead", "lag", "first_value", "last_value"):
                sch[out] = src
            elif op == "count":
                sch[out] = dt.INT64
            else:
                sch[out] = agg_dtype("sum" if op == "sum0" else op, src)
        self.schema = sch

    @property
    def child(self):
        return self.children[0]

    def key(self):
        return ("aggwin", self.child.key(), tuple(self.partition_by),
                tuple(self.order_by), tuple(self.ascending),
                tuple(self.specs))


class Join(Node):
    def __init__(self, left: Node, right: Node, left_on, right_on,
                 how: str = "inner", suffixes=("_x", "_y"),
                 null_equal: bool = True):
        self.children = [left, right]
        self.left_on = list(left_on)
        self.right_on = list(right_on)
        self.how = how
        self.suffixes = tuple(suffixes)
        # pandas merge matches NaN keys to each other; SQL joins don't
        self.null_equal = null_equal
        overlap = (set(left.schema) & set(right.schema)) - \
            (set(self.left_on) & set(self.right_on))
        sch: Schema = {}
        for n, t in left.schema.items():
            sch[n + suffixes[0] if n in overlap else n] = t
        for i, (n, t) in enumerate(right.schema.items()):
            if n in self.right_on and \
                    self.left_on[self.right_on.index(n)] == n:
                continue
            sch[n + suffixes[1] if n in overlap else n] = t
        self.schema = sch

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def key(self):
        return ("join", self.left.key(), self.right.key(),
                tuple(self.left_on), tuple(self.right_on), self.how,
                self.suffixes, self.null_equal)


class NonEquiJoin(Node):
    """Join under an arbitrary predicate with no equality conjunct
    (tiled nested-loop / interval join; reference:
    bodo/libs/_nested_loop_join_impl.cpp, _interval_join.cpp). Column
    names must already be disjoint (the SQL planner's qualified names
    are); the predicate references the combined schema."""

    def __init__(self, left: Node, right: Node, pred, how: str = "inner"):
        assert how in ("inner", "left"), how
        self.children = [left, right]
        self.pred = pred
        self.how = how
        overlap = set(left.schema) & set(right.schema)
        assert not overlap, f"NonEquiJoin needs disjoint names: {overlap}"
        sch: Schema = dict(left.schema)
        sch.update(right.schema)
        self.schema = sch

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def key(self):
        return ("nejoin", self.left.key(), self.right.key(),
                self.pred.key(), self.how)


class Sort(Node):
    def __init__(self, child: Node, by, ascending, na_last: bool = True):
        self.children = [child]
        self.by = list(by)
        self.ascending = list(ascending)
        self.na_last = na_last
        self.schema = dict(child.schema)

    @property
    def child(self):
        return self.children[0]

    def key(self):
        return ("sort", self.child.key(), tuple(self.by),
                tuple(self.ascending), self.na_last)


class Limit(Node):
    def __init__(self, child: Node, n: int):
        self.children = [child]
        self.n = n
        self.schema = dict(child.schema)

    @property
    def child(self):
        return self.children[0]

    def key(self):
        return ("limit", self.child.key(), self.n)


class Distinct(Node):
    def __init__(self, child: Node, subset: Optional[Sequence[str]] = None):
        self.children = [child]
        self.subset = list(subset) if subset else list(child.schema)
        self.schema = dict(child.schema)

    @property
    def child(self):
        return self.children[0]

    def key(self):
        return ("distinct", self.child.key(), tuple(self.subset))


def _arrow_field_dtype(typ) -> dt.DType:
    import pyarrow as pa
    if pa.types.is_dictionary(typ) or pa.types.is_string(typ) or \
            pa.types.is_large_string(typ):
        return dt.STRING
    if pa.types.is_timestamp(typ):
        return dt.DATETIME
    if pa.types.is_date(typ):
        return dt.DATE
    if pa.types.is_duration(typ):
        return dt.TIMEDELTA
    if pa.types.is_struct(typ) or pa.types.is_map(typ) or \
            pa.types.is_list(typ) or pa.types.is_large_list(typ):
        raise NotImplementedError(
            f"nested Arrow type {typ} (table/nested.py) is not ported yet")
    return dt.from_numpy(np.dtype(typ.to_pandas_dtype()))
