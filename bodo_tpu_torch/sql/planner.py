"""SQL AST → logical plan.

The port's copy of bodo_tpu/sql/planner.py: a direct lowering onto the
logical plan nodes (plan/logical.py), which builds the same plan, with
the same key(), as the JAX package's planner. Uncorrelated scalar
subqueries run through plan/physical.execute while the query is planned,
and their value becomes a literal.

Name resolution uses globally unique flat column names per table
reference (t<N>__col), so joins never collide and suffix logic is
unnecessary. Subqueries lower to joins: IN/EXISTS → semi join (inner join
against a Distinct subplan), NOT IN/NOT EXISTS → anti join (left join +
IS NULL filter), correlated predicates decorrelate through equality
conjuncts, and correlated scalar aggregate subqueries become grouped
aggregates joined on the correlation keys (the standard Kim/Dayal
unnesting the reference gets from Calcite rules).
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np

from bodo_tpu_torch.plan import logical as L
from bodo_tpu_torch.plan.expr import (BinOp, Cast, ColRef, DictMap, DtField,
                                      Expr, IsIn, Lit, StrHostFn,
                                      StrPredicate, UnOp, Where, infer_dtype)
from bodo_tpu_torch.sql import parser as P
from bodo_tpu_torch.table import dtypes as dt

_AGG_MAP = {"sum": "sumnull", "avg": "mean", "min": "min", "max": "max",
            "count": "count", "stddev": "std", "variance": "var",
            "var_samp": "var", "stddev_samp": "std",
            "var_pop": "var0", "stddev_pop": "std0",
            "median": "median", "mode": "mode",
            "skew": "skew", "kurtosis": "kurt"}


class Scope:
    """Column name resolution: (qualifier, col) → flat plan column."""

    def __init__(self):
        self.by_qual: Dict[Tuple[str, str], str] = {}
        self.by_col: Dict[str, List[str]] = {}

    def add(self, qual: str, col: str, flat: str):
        self.by_qual[(qual.lower(), col.lower())] = flat
        self.by_col.setdefault(col.lower(), []).append(flat)

    def resolve(self, col: str, qual: Optional[str]) -> Optional[str]:
        if qual is not None:
            return self.by_qual.get((qual.lower(), col.lower()))
        hits = list(dict.fromkeys(self.by_col.get(col.lower(), [])))
        if len(hits) > 1:
            raise ValueError(f"ambiguous column {col}")
        return hits[0] if hits else None

    def merged(self, other: "Scope") -> "Scope":
        s = Scope()
        s.by_qual = {**self.by_qual, **other.by_qual}
        for k, v in self.by_col.items():
            s.by_col.setdefault(k, []).extend(v)
        for k, v in other.by_col.items():
            s.by_col.setdefault(k, []).extend(v)
        return s


class Planner:
    def __init__(self, catalog: Dict[str, L.Node]):
        self.catalog = {k.lower(): v for k, v in catalog.items()}
        self.counter = [0]

    def _fresh(self, base: str = "t") -> str:
        self.counter[0] += 1
        return f"{base}{self.counter[0]}"

    # ------------------------------------------------------------------
    def plan(self, sel) -> Tuple[L.Node, List[str]]:
        """Returns (plan, output column names)."""
        if isinstance(sel, P.UnionSel):
            return self._plan_union(sel)
        catalog = dict(self.catalog)
        for name, cte in sel.ctes:
            node, names = self.plan(cte)
            catalog[name.lower()] = L.Projection(
                node, [(n, ColRef(n)) for n in names])
        saved = self.catalog
        self.catalog = catalog
        try:
            return self._plan_core(sel, outer=None)
        finally:
            self.catalog = saved

    def _plan_union(self, u: "P.UnionSel") -> Tuple[L.Node, List[str]]:
        parts = [self.plan(s) for s in u.selects]
        names = parts[0][1]
        aligned = []
        for node, nm in parts:
            if len(nm) != len(names):
                raise ValueError("UNION arms have different column counts")
            aligned.append(L.Projection(
                node, [(names[i], ColRef(nm[i])) for i in range(len(names))]))
        # left-associative fold so mixed UNION / UNION ALL dedups correctly
        out: L.Node = aligned[0]
        for is_all, arm in zip(u.alls, aligned[1:]):
            out = L.Union([out, arm])
            if not is_all:
                out = L.Distinct(out, names)
        # trailing ORDER BY / LIMIT apply to the whole union; keys resolve
        # against the output columns (names or 1-based positions)
        if u.order_by:
            keys, asc = [], []
            for e, a in u.order_by:
                if isinstance(e, P.Num) and isinstance(e.value, int):
                    keys.append(names[e.value - 1])
                elif isinstance(e, P.Col) and e.qualifier is None and \
                        e.name in names:
                    keys.append(e.name)
                else:
                    raise NotImplementedError(
                        "UNION ORDER BY must reference output columns")
                asc.append(a)
            out = L.Sort(out, keys, asc)
        if u.limit is not None:
            out = L.Limit(out, u.limit)
        return out, names

    # ------------------------------------------------------------------
    def _from(self, item, outer: Optional[Scope]) -> Tuple[L.Node, Scope]:
        if isinstance(item, P.TableRef):
            base = self.catalog.get(item.name.lower())
            if base is None:
                raise ValueError(f"unknown table {item.name}")
            alias = (item.alias or item.name)
            tag = self._fresh()
            exprs = [(f"{tag}__{c}", ColRef(c)) for c in base.schema]
            plan = L.Projection(base, exprs)
            scope = Scope()
            for c in base.schema:
                scope.add(alias, c, f"{tag}__{c}")
            return plan, scope
        if isinstance(item, P.SubSelect):
            # plan() also routes UNION subselects
            node, names = self.plan(item.select)
            tag = self._fresh()
            exprs = [(f"{tag}__{c}", ColRef(c)) for c in names]
            plan = L.Projection(node, exprs)
            scope = Scope()
            for c in names:
                scope.add(item.alias, c, f"{tag}__{c}")
            return plan, scope
        if isinstance(item, P.JoinItem):
            lp, ls = self._from(item.left, outer)
            rp, rs = self._from(item.right, outer)
            scope = ls.merged(rs)
            if item.kind == "cross":
                return self._cross_join(lp, rp), scope
            if item.using is not None:
                # JOIN ... USING (a, b): equi keys by shared name; the
                # unqualified name resolves to the left side afterwards
                # (coalescing for FULL JOIN is not modeled — reject it)
                if item.kind == "outer":
                    raise NotImplementedError(
                        "FULL JOIN ... USING (coalesced key) — use ON")
                eq_l, eq_r, residual = [], [], None
                for c in item.using:
                    lc, rc = ls.resolve(c, None), rs.resolve(c, None)
                    if lc is None or rc is None:
                        raise ValueError(f"USING column {c} not on both "
                                         f"sides")
                    eq_l.append(lc)
                    eq_r.append(rc)
                    # the USING column coalesces; binding it to the
                    # preserved side's key is exact for inner/left/right
                    # (matched rows agree, unmatched preserved rows only
                    # have their own side's value)
                    scope.by_col[c.lower()] = \
                        [rc if item.kind == "right" else lc]
            else:
                eq_l, eq_r, residual = self._split_join_condition(
                    item.on, ls, rs, scope)
            how = item.kind
            if residual is not None and how == "outer":
                raise NotImplementedError(
                    "FULL JOIN with a non-equality ON condition")
            if residual is not None and how in ("left", "right"):
                # outer-join ON residuals restrict the null-padded side
                # BEFORE the join (a post-filter would turn preserved rows
                # into dropped ones — the Q13 pattern); residuals touching
                # BOTH sides fall through to the nested-loop join below
                from bodo_tpu_torch.plan.expr import expr_columns
                cols = expr_columns(residual)
                inner_side = set(rs.by_qual.values()) if how == "left" \
                    else set(ls.by_qual.values())
                if cols <= inner_side:
                    if how == "left":
                        rp = L.Filter(rp, residual)
                    else:
                        lp = L.Filter(lp, residual)
                    residual = None
                elif eq_l:
                    raise NotImplementedError(
                        "outer-join ON mixing equality keys with a "
                        "residual touching the preserved side")
            if not eq_l:
                if residual is None:
                    raise NotImplementedError(
                        f"{how} join with no usable ON condition")
                # pure non-equi condition → tiled nested-loop /
                # interval join (reference:
                # bodo/libs/_nested_loop_join_impl.cpp, _interval_join)
                if how == "inner":
                    plan = L.NonEquiJoin(lp, rp, residual, "inner")
                elif how == "left":
                    plan = L.NonEquiJoin(lp, rp, residual, "left")
                elif how == "right":
                    plan = L.NonEquiJoin(rp, lp, residual, "left")
                else:
                    raise NotImplementedError(
                        "FULL JOIN with a pure non-equi condition")
                residual = None
            else:
                if how == "right":
                    plan = L.Join(rp, lp, eq_r, eq_l, "left", null_equal=False)
                else:
                    plan = L.Join(lp, rp, eq_l, eq_r, how, null_equal=False)
            if residual is not None:
                plan = L.Filter(plan, residual)
            return plan, scope
        raise TypeError(f"bad FROM item {item}")

    def _cross_join(self, lp: L.Node, rp: L.Node) -> L.Node:
        # constant-key join (small sides only — TPC-H cross joins are tiny)
        k = self._fresh("__cross")
        lp2 = L.Projection(lp, [(c, ColRef(c)) for c in lp.schema]
                           + [(k, Lit(1))])
        rp2 = L.Projection(rp, [(c, ColRef(c)) for c in rp.schema]
                           + [(k + "_r", Lit(1))])
        j = L.Join(lp2, rp2, [k], [k + "_r"], "inner", null_equal=False)
        keep = [c for c in j.schema if not c.startswith("__cross")]
        return L.Projection(j, [(c, ColRef(c)) for c in keep])

    def _split_join_condition(self, on, ls: Scope, rs: Scope, scope: Scope):
        """Equi-conjuncts spanning both sides become join keys; the rest
        becomes a post-join filter."""
        eq_l, eq_r, residual = [], [], []

        def visit(e):
            if isinstance(e, P.BinA) and e.op == "&":
                visit(e.left)
                visit(e.right)
                return
            if isinstance(e, P.BinA) and e.op == "==" and \
                    isinstance(e.left, P.Col) and isinstance(e.right, P.Col):
                lf = self._try_col(e.left, ls)
                rf = self._try_col(e.right, rs)
                if lf and rf:
                    eq_l.append(lf)
                    eq_r.append(rf)
                    return
                lf2 = self._try_col(e.right, ls)
                rf2 = self._try_col(e.left, rs)
                if lf2 and rf2:
                    eq_l.append(lf2)
                    eq_r.append(rf2)
                    return
            residual.append(e)

        visit(on)
        res_expr = None
        for r in residual:
            c = self._expr(r, scope, None, None)
            res_expr = c if res_expr is None else BinOp("&", res_expr, c)
        return eq_l, eq_r, res_expr

    def _try_col(self, c: P.Col, scope: Scope) -> Optional[str]:
        try:
            return scope.resolve(c.name, c.qualifier)
        except ValueError:
            return None

    # ------------------------------------------------------------------
    def _plan_core(self, sel: P.Select, outer: Optional[Scope]
                   ) -> Tuple[L.Node, List[str]]:
        for name, cte in sel.ctes:
            node, names = self.plan(cte)
            self.catalog[name.lower()] = L.Projection(
                node, [(n, ColRef(n)) for n in names])
        if sel.from_item is None:
            raise NotImplementedError("SELECT without FROM")
        plan, scope = self._plan_from_where(sel.from_item, sel.where, outer)
        # schema in scope for dtype-sensitive lowering (CAST to varchar)
        prev_schema = getattr(self, "_cur_schema", None)
        self._cur_schema = plan.schema

        # window-function extraction: each OVER (...) item is replaced by
        # a placeholder column now and planned as a RankWindow/AggWindow
        # node AFTER any GROUP BY aggregation (SQL evaluates window
        # functions over the grouped rows)
        windows = self._extract_windows(sel)

        # aggregate extraction
        aggs: List[Tuple[Expr, str, str]] = []   # (arg expr, op, temp name)

        def lower_aggs(e):
            """Replace agg Func nodes with placeholder Cols __agg<N>."""
            if isinstance(e, P.Func) and (e.star or e.name in _AGG_MAP or
                                          e.name in ("count", "listagg",
                                                     "string_agg")):
                if e.star:
                    op, arg = "size", None
                elif e.name == "count" and e.distinct:
                    op, arg = "nunique", e.args[0]
                elif e.name == "count":
                    op, arg = "count", e.args[0]
                elif e.name in ("listagg", "string_agg"):
                    sep = ","
                    if len(e.args) == 2:
                        if not isinstance(e.args[1], P.Str):
                            raise NotImplementedError(
                                "LISTAGG separator must be a string "
                                "literal")
                        sep = e.args[1].value
                    kind = "listaggd" if e.distinct else "listagg"
                    op, arg = f"{kind}:{sep}", e.args[0]
                else:
                    op, arg = _AGG_MAP[e.name], e.args[0]
                tmp = f"__agg{len(aggs)}"
                arg_expr = Lit(1) if arg is None else \
                    self._expr(arg, scope, None, None)
                aggs.append((arg_expr, op, tmp))
                return P.Col(tmp, qualifier="__agg")
            for f in getattr(e, "__dataclass_fields__", {}):
                v = getattr(e, f)
                if isinstance(v, tuple(_AST_TYPES)):
                    setattr(e, f, lower_aggs(v))
                elif isinstance(v, list):
                    setattr(e, f, [lower_aggs(x)
                                   if isinstance(x, tuple(_AST_TYPES)) else x
                                   for x in v])
                elif isinstance(v, tuple):
                    setattr(e, f, tuple(
                        lower_aggs(x) if isinstance(x, tuple(_AST_TYPES))
                        else x for x in v))
            return e

        has_aggs = sel.group_by or _contains_agg(sel.projections) or \
            (sel.having is not None)
        group_flat: List[str] = []
        if has_aggs:
            # SELECT/HAVING/ORDER exprs structurally equal to a GROUP BY
            # expr resolve to that key column (standard SQL matching)
            gb_markers = [(g, P.Col(f"__gbm{i}", qualifier="__agg"))
                          for i, g in enumerate(sel.group_by)
                          if not isinstance(g, P.Col)]

            def sub_group(e):
                for g, marker in gb_markers:
                    if e == g:
                        return marker
                for f in getattr(e, "__dataclass_fields__", {}):
                    v = getattr(e, f)
                    if isinstance(v, tuple(_AST_TYPES)):
                        setattr(e, f, sub_group(v))
                    elif isinstance(v, list):
                        setattr(e, f, [sub_group(x)
                                       if isinstance(x, tuple(_AST_TYPES))
                                       else x for x in v])
                return e

            if gb_markers:
                sel.projections = [(sub_group(e), a)
                                   for e, a in sel.projections]
                if sel.having is not None:
                    sel.having = sub_group(sel.having)
                sel.order_by = [(sub_group(e), a) for e, a in sel.order_by]
            projections = [(lower_aggs(e), a) for e, a in sel.projections]
            having = lower_aggs(sel.having) if sel.having is not None else None
            order_by = [(lower_aggs(e), asc) for e, asc in sel.order_by]
            # window specs evaluate over the grouped rows: their member
            # exprs go through the same GROUP-BY matching + agg lowering
            for w, _ in windows:
                if gb_markers:
                    w.partition_by = [sub_group(x) for x in w.partition_by]
                    w.order_by = [(sub_group(x), a) for x, a in w.order_by]
                    w.func.args = [sub_group(x) for x in w.func.args]
                w.partition_by = [lower_aggs(x) for x in w.partition_by]
                w.order_by = [(lower_aggs(x), a) for x, a in w.order_by]
                w.func.args = [lower_aggs(x) for x in w.func.args]

            # group keys: pre-project complex exprs to temp columns
            pre_cols: List[Tuple[str, Expr]] = \
                [(c, ColRef(c)) for c in plan.schema]
            for i, g in enumerate(sel.group_by):
                ge = self._expr(g, scope, None, None)
                if isinstance(ge, ColRef):
                    group_flat.append(ge.name)
                else:
                    tmp = f"__key{i}"
                    pre_cols.append((tmp, ge))
                    group_flat.append(tmp)
                    # let bare SELECT references to this expr resolve too
            agg_specs = []
            for i, (arg_expr, op, tmp) in enumerate(aggs):
                acol = f"__aval{i}"
                pre_cols.append((acol, arg_expr))
                agg_specs.append((acol, op, tmp))
            plan = L.Projection(plan, pre_cols)
            if group_flat:
                plan = L.Aggregate(plan, group_flat, agg_specs)
            else:
                plan = L.Reduce(plan, agg_specs)
            # post-agg scope: group keys + agg temps
            post_scope = Scope()
            marker_i = 0
            for g, gast in zip(group_flat, sel.group_by):
                if isinstance(gast, P.Col):
                    post_scope.add(gast.qualifier or "", gast.name, g)
                else:
                    post_scope.add("__agg", f"__gbm{marker_i}", g)
                    marker_i += 1
            for _, _, tmp in agg_specs:
                post_scope.add("__agg", tmp, tmp)
            # keep original scope for group-key column references
            scope = _restrict_scope(scope, group_flat).merged(post_scope)
            if having is not None:
                plan = L.Filter(plan, self._expr(having, scope, None, None))
            sel = P.Select(projections=projections, order_by=order_by,
                           limit=sel.limit, distinct=sel.distinct)

        if windows:
            plan, scope = self._plan_windows(plan, scope, windows)

        # SELECT list
        out_exprs: List[Tuple[str, Expr]] = []
        out_names: List[str] = []
        for e, alias in sel.projections:
            if isinstance(e, P.StarA):
                names = [
                    f for f in (plan.schema if not group_flat else group_flat)]
                for f in names:
                    nm = f.split("__", 1)[-1]
                    out_exprs.append((nm, ColRef(f)))
                    out_names.append(nm)
                continue
            ex = self._expr(e, scope, None, None)
            name = alias or _default_name(e)
            out_exprs.append((name, ex))
            out_names.append(name)

        # ORDER BY before the final projection rename: resolve against both
        sort_keys: List[Tuple[str, bool]] = []
        extra_sort_cols: List[Tuple[str, Expr]] = []
        for e, asc in sel.order_by:
            if isinstance(e, P.Num) and isinstance(e.value, int):
                sort_keys.append((out_names[e.value - 1], asc))
                continue
            if isinstance(e, P.Col) and e.qualifier is None and \
                    e.name in out_names:
                sort_keys.append((e.name, asc))
                continue
            ex = self._expr(e, scope, None, None)
            tmp = f"__sort{len(extra_sort_cols)}"
            extra_sort_cols.append((tmp, ex))
            sort_keys.append((tmp, asc))

        plan = L.Projection(plan, out_exprs + extra_sort_cols)
        if sel.distinct:
            plan = L.Distinct(plan, out_names)
        if sort_keys:
            plan = L.Sort(plan, [k for k, _ in sort_keys],
                          [a for _, a in sort_keys])
        if extra_sort_cols:
            plan = L.Projection(plan, [(n, ColRef(n)) for n in out_names])
        if sel.limit is not None:
            plan = L.Limit(plan, sel.limit)
        self._cur_schema = prev_schema
        return plan, out_names

    _WINDOW_FUNCS = {"row_number": "row_number", "rank": "rank",
                     "dense_rank": "dense_rank", "ntile": "ntile"}
    # aggregate/navigation window functions → AggWindow ops
    _WINDOW_AGG_FUNCS = {"sum": "sum", "avg": "mean", "min": "min",
                         "max": "max", "count": "count", "lead": "lead",
                         "lag": "lag", "first_value": "first_value",
                         "last_value": "last_value"}

    def _extract_windows(self, sel):
        """Replace WindowA select items with placeholder columns; the
        collected windows are planned AFTER any GROUP BY aggregation
        (SQL evaluates window functions over the grouped rows)."""
        found: List[Tuple[P.WindowA, str]] = []

        def walk_replace(e):
            if isinstance(e, P.WindowA):
                name = e.func.name
                if e.func.star:
                    if name != "count":
                        raise NotImplementedError(
                            f"window function {name}(*) — only COUNT(*)")
                elif name not in self._WINDOW_FUNCS and \
                        name not in self._WINDOW_AGG_FUNCS:
                    raise NotImplementedError(
                        f"window function {name}() — supported: "
                        f"{sorted(self._WINDOW_FUNCS)} + "
                        f"{sorted(self._WINDOW_AGG_FUNCS)}")
                tmp = f"__win{len(found)}"
                found.append((e, tmp))
                return P.Col(tmp, qualifier="__agg")
            for f in getattr(e, "__dataclass_fields__", {}):
                v = getattr(e, f)
                if isinstance(v, tuple(_AST_TYPES)):
                    setattr(e, f, walk_replace(v))
                elif isinstance(v, list):
                    setattr(e, f, [walk_replace(x)
                                   if isinstance(x, tuple(_AST_TYPES))
                                   else x for x in v])
            return e

        sel.projections = [(walk_replace(e), a) for e, a in sel.projections]
        sel.order_by = [(walk_replace(e), a) for e, a in sel.order_by]
        return found

    def _plan_windows(self, plan, scope, found):
        """Plan collected WindowA items as RankWindow/AggWindow nodes."""
        for w, tmp in found:
            pre: List[Tuple[str, Expr]] = [(c, ColRef(c))
                                           for c in plan.schema]
            pkeys: List[str] = []
            for i, pe in enumerate(w.partition_by):
                ex = self._expr(pe, scope, None, None)
                if isinstance(ex, ColRef):
                    pkeys.append(ex.name)
                else:
                    pre.append((f"{tmp}_p{i}", ex))
                    pkeys.append(f"{tmp}_p{i}")
            okeys: List[str] = []
            asc: List[bool] = []
            for i, (oe, a) in enumerate(w.order_by):
                ex = self._expr(oe, scope, None, None)
                if isinstance(ex, ColRef):
                    okeys.append(ex.name)
                else:
                    pre.append((f"{tmp}_o{i}", ex))
                    okeys.append(f"{tmp}_o{i}")
                asc.append(a)
            name = w.func.name
            if name in self._WINDOW_FUNCS and not w.func.star:
                if len(pre) > len(plan.schema):
                    plan = L.Projection(plan, pre)
                op = self._WINDOW_FUNCS[name]
                param = 0
                if op == "ntile":
                    if not (w.func.args and
                            isinstance(w.func.args[0], P.Num)):
                        raise NotImplementedError("NTILE needs a constant")
                    param = int(w.func.args[0].value)
                plan = L.RankWindow(plan, pkeys, okeys, asc,
                                    [(op, param, tmp)])
            else:
                op = "count" if w.func.star else \
                    self._WINDOW_AGG_FUNCS[name]
                param = 0
                if op in ("lead", "lag"):
                    if not okeys:
                        raise NotImplementedError(f"{name} needs ORDER BY")
                    if len(w.func.args) > 2:
                        raise NotImplementedError(
                            f"{name} with an explicit default value")
                    param = 1
                    if len(w.func.args) == 2:
                        if not isinstance(w.func.args[1], P.Num):
                            raise NotImplementedError(
                                f"{name} offset must be a constant")
                        param = int(w.func.args[1].value)
                # value column: pre-project non-trivial args
                if w.func.star:
                    pre.append((f"{tmp}_v", Lit(1)))
                    vcol = f"{tmp}_v"
                else:
                    if not w.func.args:
                        raise SyntaxError(
                            f"window function {name.upper()}() needs an "
                            f"argument (or use COUNT(*))")
                    vex = self._expr(w.func.args[0], scope, None, None)
                    if isinstance(vex, ColRef):
                        vcol = vex.name
                    else:
                        pre.append((f"{tmp}_v", vex))
                        vcol = f"{tmp}_v"
                if len(pre) > len(plan.schema):
                    plan = L.Projection(plan, pre)
                if w.frame is not None:
                    frame = tuple(w.frame)
                elif okeys:
                    frame = ("cumrange",)
                else:
                    frame = ("all",)
                if op in ("lead", "lag"):
                    frame = ("all",)  # navigation ops ignore the frame
                plan = L.AggWindow(plan, pkeys, okeys, asc,
                                   [(op, vcol, frame, param, tmp)])
            scope.add("__agg", tmp, tmp)
        return plan, scope

    # ------------------------------------------------------------------
    # FROM + WHERE: join-graph construction
    # ------------------------------------------------------------------
    def _plan_from_where(self, from_item, where, outer):
        """Plan the FROM list with WHERE-derived equi-joins.

        Comma-joined relations (`from a, b, c where a.x = b.y ...`) are
        the TPC-H idiom; planning them as literal cross products explodes.
        Equality conjuncts between two relations become join keys and the
        join order follows the connectivity graph greedily (the minimal
        version of the join-ordering the reference gets from DuckDB /
        Calcite optimizers)."""
        rels: List = []

        def flatten(item):
            if isinstance(item, P.JoinItem) and item.kind == "cross" and \
                    item.on is None:
                flatten(item.left)
                flatten(item.right)
            else:
                rels.append(item)
        flatten(from_item)

        # LATERAL FLATTEN items apply to the plan built from the other
        # relations (correlated table function): plan the rest first,
        # then explode; WHERE runs after the explode so predicates can
        # reference the flatten output (f.value / f.index)
        flats = [r for r in rels if isinstance(r, P.FlattenItem)]
        if flats:
            rest = [r for r in rels if not isinstance(r, P.FlattenItem)]
            if not rest:
                raise NotImplementedError(
                    "LATERAL FLATTEN requires a base relation")
            item = rest[0]
            for r in rest[1:]:
                item = P.JoinItem(item, r, "cross")
            # conjuncts that touch a flatten alias (f.value / f.index)
            # must run AFTER the explode; everything else goes into the
            # base planning so WHERE-derived equi-joins still form (no
            # accidental cross products)
            fl_aliases = {f.alias.lower() for f in flats}
            fl_cols = {"value", "index"}
            pre: List = []
            post: List = []

            def _touches_flatten(e) -> bool:
                if isinstance(e, P.Col):
                    return ((e.qualifier or "").lower() in fl_aliases
                            or (e.qualifier is None
                                and e.name.lower() in fl_cols))
                import dataclasses
                if not dataclasses.is_dataclass(e):
                    return False
                return any(
                    _touches_flatten(x)
                    for f_ in dataclasses.fields(e)
                    for v_ in [getattr(e, f_.name)]
                    for x in (v_ if isinstance(v_, (list, tuple))
                              else (v_,)))

            def _split_w(e):
                if isinstance(e, P.BinA) and e.op == "&":
                    _split_w(e.left)
                    _split_w(e.right)
                elif _touches_flatten(e):
                    post.append(e)
                else:
                    pre.append(e)
            if where is not None:
                _split_w(where)
            pre_where = None
            for cnj in pre:
                pre_where = cnj if pre_where is None else \
                    P.BinA("&", pre_where, cnj)
            plan, scope = self._plan_from_where(item, pre_where, outer)
            for fl in flats:
                plan, scope = self._plan_flatten(plan, scope, fl)
            for cnj in post:
                plan = self._plan_where(plan, scope, cnj)
            return plan, scope

        planned = [self._from(r, outer) for r in rels]
        if len(planned) == 1:
            plan, scope = planned[0]
            if where is not None:
                plan = self._plan_where(plan, scope, where)
            return plan, scope

        conjuncts: List = []

        def split(e):
            if isinstance(e, P.BinA) and e.op == "&":
                split(e.left)
                split(e.right)
            else:
                conjuncts.append(e)
        if where is not None:
            split(where)

        # classify: cross-relation equality conjuncts become join edges
        def rel_of(col: P.Col) -> Optional[int]:
            hits = []
            for i, (_, s) in enumerate(planned):
                f = self._try_col(col, s)
                if f:
                    hits.append(i)
            return hits[0] if len(hits) == 1 else None

        edges = []   # (rel_i, rel_j, flat_i, flat_j)
        others = []
        single_rel: List[List] = [[] for _ in planned]
        for c in conjuncts:
            if isinstance(c, P.BinA) and c.op == "==" and \
                    isinstance(c.left, P.Col) and isinstance(c.right, P.Col):
                ri, rj = rel_of(c.left), rel_of(c.right)
                if ri is not None and rj is not None and ri != rj:
                    fi = self._try_col(c.left, planned[ri][1])
                    fj = self._try_col(c.right, planned[rj][1])
                    edges.append((ri, rj, fi, fj))
                    continue
            # single-relation plain predicate → filter the relation before
            # joining (shrinks join inputs AND sharpens the cardinality
            # estimates the greedy ordering runs on)
            ri = self._sole_rel(c, planned)
            if ri is not None:
                single_rel[ri].append(c)
            else:
                others.append(c)

        for i, cs in enumerate(single_rel):
            if not cs:
                continue
            p_i, s_i = planned[i]
            prev_schema = getattr(self, "_cur_schema", None)
            self._cur_schema = p_i.schema
            try:
                pred = None
                for c in cs:
                    e = self._expr(c, s_i, None, None)
                    pred = e if pred is None else BinOp("&", pred, e)
            finally:
                self._cur_schema = prev_schema
            planned[i] = (L.Filter(p_i, pred), s_i)

        # greedy cost-based join order (replaces the reference's vendored
        # DuckDB join-order optimizer, bodo/pandas/plan.py
        # get_plan_cardinality): start from the smallest-estimate relation
        # with edges, then repeatedly join the connected relation whose
        # estimated output is smallest
        from bodo_tpu_torch.plan.stats import estimate, join_estimate
        ests = [estimate(p) for p, _ in planned]
        has_edge = {r for e in edges for r in (e[0], e[1])}
        start = min(range(len(planned)),
                    key=lambda i: (i not in has_edge, ests[i][0]))
        used = {start}
        plan, scope = planned[start]
        cur_est, cur_raw = ests[start]
        consumed: set = set()
        while len(used) < len(planned):
            best = None
            for i in range(len(planned)):
                if i in used:
                    continue
                keys_l, keys_r, ids = [], [], []
                for eid, (ri, rj, fi, fj) in enumerate(edges):
                    if eid in consumed:
                        continue
                    if ri in used and rj == i:
                        keys_l.append(fi)
                        keys_r.append(fj)
                        ids.append(eid)
                    elif rj in used and ri == i:
                        keys_l.append(fj)
                        keys_r.append(fi)
                        ids.append(eid)
                if keys_l:
                    out = join_estimate(cur_est, cur_raw, *ests[i])
                    if best is None or out < best[0]:
                        best = (out, i, keys_l, keys_r, ids)
            if best is None:
                # disconnected — cross join with the smallest remainder
                i = min((j for j in range(len(planned)) if j not in used),
                        key=lambda j: ests[j][0])
                plan = self._cross_join(plan, planned[i][0])
                scope = scope.merged(planned[i][1])
                cur_est *= max(ests[i][0], 1.0)
                cur_raw = max(cur_raw, ests[i][1])
                used.add(i)
                continue
            out, i, keys_l, keys_r, ids = best
            plan = L.Join(plan, planned[i][0], keys_l, keys_r, "inner",
                          null_equal=False)
            scope = scope.merged(planned[i][1])
            cur_est, cur_raw = out, max(cur_raw, ests[i][1])
            used.add(i)
            consumed.update(ids)
        # restore FROM-list column order (SELECT * and positional
        # consumers must not see the cost-based join order)
        from_order = [c for p, _ in planned for c in p.schema]
        if list(plan.schema) != from_order:
            plan = L.Projection(plan, [(n, ColRef(n)) for n in from_order
                                       if n in plan.schema])
        # cycle edges not consumed as join keys → equality filters on the
        # joined table (flat names are globally unique, reference directly)
        residual_eq: Optional[Expr] = None
        for eid, (ri, rj, fi, fj) in enumerate(edges):
            if eid in consumed:
                continue
            eq = BinOp("==", ColRef(fi), ColRef(fj))
            residual_eq = eq if residual_eq is None else \
                BinOp("&", residual_eq, eq)
        if residual_eq is not None:
            plan = L.Filter(plan, residual_eq)
        # WHERE residue (subqueries + plain predicates)
        w = None
        for c in others:
            w = c if w is None else P.BinA("&", w, c)
        if w is not None:
            plan = self._plan_where(plan, scope, w)
        return plan, scope

    def _sole_rel(self, c, planned):
        """Index of the single relation that resolves every column in a
        plain conjunct, or None (multi-relation / subquery / ambiguous)."""
        has_sub = [False]

        def look(x):
            if isinstance(x, (P.InSelect, P.Exists, P.ScalarSubquery)):
                has_sub[0] = True
            return x
        self._walk_ast(c, look)
        if has_sub[0]:
            return None
        cols = self._collect_cols(c)
        if not cols:
            return None
        rels = set()
        for col in cols:
            hits = [i for i, (_, s) in enumerate(planned)
                    if self._try_col(col, s)]
            if len(hits) != 1:
                return None
            rels.add(hits[0])
        return rels.pop() if len(rels) == 1 else None

    # ------------------------------------------------------------------
    # WHERE with subquery lowering
    # ------------------------------------------------------------------
    def _plan_flatten(self, plan: L.Node, scope: Scope,
                      fl) -> Tuple[L.Node, Scope]:
        """Apply one LATERAL FLATTEN: explode the input array column and
        expose <alias>.value / <alias>.index in scope (reference:
        BodoSQL/bodosql/kernels/lateral.py lateral_flatten)."""
        if not isinstance(fl.input, P.Col):
            raise NotImplementedError(
                "FLATTEN input must be a column reference")
        flat = self._try_col(fl.input, scope)
        if flat is None:
            raise ValueError(f"unknown FLATTEN input {fl.input.name}")
        tag = self._fresh("fl")
        vname, iname = f"{tag}__value", f"{tag}__index"
        plan = L.Explode(plan, flat, vname, iname, fl.outer)
        scope = scope.merged(Scope())
        scope.add(fl.alias, "value", vname)
        scope.add(fl.alias, "index", iname)
        return plan, scope

    def _plan_where(self, plan: L.Node, scope: Scope, where) -> L.Node:
        conjuncts: List = []

        def split(e):
            if isinstance(e, P.BinA) and e.op == "&":
                split(e.left)
                split(e.right)
            else:
                conjuncts.append(e)
        split(where)

        # dtype-sensitive lowering (CAST of string columns etc.) needs
        # the current plan schema — WHERE runs before _plan_core sets it
        prev_schema = getattr(self, "_cur_schema", None)
        self._cur_schema = plan.schema
        try:
            plain: Optional[Expr] = None
            for c in conjuncts:
                handled, plan = self._try_subquery_conjunct(plan, scope, c)
                if handled:
                    continue
                ex = self._expr(c, scope, None, None)
                plain = ex if plain is None else BinOp("&", plain, ex)
            if plain is not None:
                plan = L.Filter(plan, plain)
            return plan
        finally:
            self._cur_schema = prev_schema

    def _try_subquery_conjunct(self, plan, scope, c):
        """Lower IN/EXISTS/scalar-subquery conjuncts to joins.
        Returns (handled, new_plan)."""
        if isinstance(c, P.InSelect):
            lhs = self._expr(c.operand, scope, None, None)
            return True, self._semi_anti(plan, scope, lhs, c.select,
                                         anti=c.negated)
        if isinstance(c, P.Exists) or (
                isinstance(c, P.UnA) and c.op == "not"
                and isinstance(c.operand, P.Exists)):
            neg = isinstance(c, P.UnA)
            ex = c.operand if neg else c
            anti = ex.negated ^ neg
            return True, self._exists(plan, scope, ex.select, anti=anti)
        # comparison against a scalar subquery (possibly correlated)
        if isinstance(c, P.BinA) and c.op in ("==", "<", "<=", ">", ">=",
                                              "!="):
            for side, other in ((c.left, c.right), (c.right, c.left)):
                if isinstance(side, P.ScalarSubquery):
                    val, plan2, colname = self._scalar_subquery(
                        plan, scope, side.select)
                    other_e = self._expr(other, scope, None, None)
                    sub_e = Lit(val) if colname is None else ColRef(colname)
                    le, re_ = (sub_e, other_e) if side is c.left \
                        else (other_e, sub_e)
                    return True, L.Filter(plan2, BinOp(c.op, le, re_))
        return False, plan

    def _materialize_expr(self, plan: L.Node, e: Expr):
        """Ensure `e` is available as a named column of `plan`."""
        if isinstance(e, ColRef):
            return e.name, plan
        tmp = self._fresh("__mat")
        plan = L.Projection(plan, [(c, ColRef(c)) for c in plan.schema]
                            + [(tmp, e)])
        return tmp, plan

    def _semi_anti(self, plan, scope, lhs: Expr, sub: P.Select, anti: bool):
        node, names = self._plan_core(sub, outer=scope)
        assert len(names) == 1, "IN subquery must select one column"
        tmp = self._fresh("__in")
        node = L.Projection(node, [(tmp, ColRef(names[0]))])
        node = L.Distinct(node, [tmp])
        lcol, plan = self._materialize_expr(plan, lhs)
        if anti:
            j = L.Join(plan, node, [lcol], [tmp], "left", null_equal=False)
            probe = L.Filter(j, UnOp("isna", ColRef(tmp)))
        else:
            probe = L.Join(plan, node, [lcol], [tmp], "inner",
                           null_equal=False)
        keep = [c for c in plan.schema if not c.startswith("__mat")]
        return L.Projection(probe, [(c, ColRef(c)) for c in keep])

    def _exists(self, plan, scope, sub: P.Select, anti: bool):
        """EXISTS with equality correlation → semi/anti join on the
        correlated columns. Non-equality outer references become
        post-join residual filters over a row-id semi join (the general
        unnesting — covers TPC-H Q21)."""
        sub2, corr, residuals, inner_scope = self._decorrelate(sub, scope)
        if not corr:
            raise NotImplementedError(
                "EXISTS without an equality correlation conjunct "
                + ("(only non-equality outer references found)"
                   if residuals else "(uncorrelated)"))
        inner_cols = [ic for _, ic in corr]
        if not residuals:
            sub2.projections = [(c, f"__ex{i}")
                                for i, c in enumerate(inner_cols)]
            node, names = self._plan_core(sub2, outer=None)
            node = L.Distinct(node, names)
            outer_cols = [oc for oc, _ in corr]
            how = "left" if anti else "inner"
            j = L.Join(plan, node, outer_cols, names, how, null_equal=False)
            if anti:
                j = L.Filter(j, UnOp("isna", ColRef(names[0])))
            keep = [c for c in plan.schema]
            return L.Projection(j, [(c, ColRef(c)) for c in keep])

        # general path: tag outer rows with a row id, join on equality
        # correlations keeping multiplicity, filter residuals, then
        # semi/anti on the surviving row ids
        rid = self._fresh("__rid")
        first_col = next(iter(plan.schema))
        plan_rid = L.Window(plan, [(first_col, "rowid", None, rid)])
        # project every residual-referenced inner column with a fresh name
        inner_needed = []
        for e in residuals:
            for c in self._collect_cols(e):
                try:
                    if inner_scope.resolve(c.name, c.qualifier) is not None:
                        inner_needed.append((c.qualifier, c.name))
                except ValueError:
                    inner_needed.append((c.qualifier, c.name))
        inner_needed = list(dict.fromkeys(inner_needed))
        proj = [(c, f"__ex{i}") for i, c in enumerate(inner_cols)]
        inner_name_map = {}
        for i, (q, n) in enumerate(inner_needed):
            nm = f"__er{self._fresh('')}_{i}"
            proj.append((P.Col(n, qualifier=q), nm))
            inner_name_map[(q.lower() if q else None, n.lower())] = nm
        sub2.projections = proj
        node, names = self._plan_core(sub2, outer=None)
        key_names = names[:len(inner_cols)]
        outer_cols = [oc for oc, _ in corr]
        j = L.Join(plan_rid, node, outer_cols, key_names, "inner",
                   null_equal=False)
        # residual conversion: outer cols resolve via the original scope,
        # inner cols via the fresh projected names
        res_scope = Scope()
        res_scope.by_qual = dict(scope.by_qual)
        for k, v in scope.by_col.items():
            res_scope.by_col[k] = list(v)
        for (q, n), nm in inner_name_map.items():
            res_scope.add(q or "", n, nm)
            res_scope.add("", nm, nm)  # rewritten refs resolve directly
        pred = None
        for e in residuals:
            ex = self._expr(self._prefer_inner(e, inner_name_map), res_scope)
            pred = ex if pred is None else BinOp("&", pred, ex)
        f = L.Filter(j, pred)
        matched = L.Distinct(
            L.Projection(f, [(rid + "_m", ColRef(rid))]), [rid + "_m"])
        if anti:
            j2 = L.Join(plan_rid, matched, [rid], [rid + "_m"], "left",
                        null_equal=False)
            out = L.Filter(j2, UnOp("isna", ColRef(rid + "_m")))
        else:
            out = L.Join(plan_rid, matched, [rid], [rid + "_m"], "inner",
                         null_equal=False)
        keep = [c for c in plan.schema]
        return L.Projection(out, [(c, ColRef(c)) for c in keep])

    @staticmethod
    def _walk_ast(e, visit):
        """Shared traversal: call visit(node) on every AST node, covering
        scalar fields AND elements of list/tuple fields (the walker all
        AST passes in this class must use — divergent copies are how
        list-field bugs creep in)."""
        visit(e)
        for f in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f)
            if isinstance(v, tuple(_AST_TYPES)):
                Planner._walk_ast(v, visit)
            elif isinstance(v, (list, tuple)):
                for y in v:
                    if isinstance(y, tuple(_AST_TYPES)):
                        Planner._walk_ast(y, visit)
                    elif isinstance(y, tuple):
                        for z in y:
                            if isinstance(z, tuple(_AST_TYPES)):
                                Planner._walk_ast(z, visit)

    @staticmethod
    def _collect_cols(e) -> List[P.Col]:
        acc: List[P.Col] = []
        Planner._walk_ast(
            e, lambda x: acc.append(x) if isinstance(x, P.Col) else None)
        return acc

    def _prefer_inner(self, e, inner_name_map):
        """Rewrite inner-column refs in a residual AST to their projected
        fresh names (outer refs keep their original qualifier). Rewrites
        Cols in scalar fields and inside list fields (Func.args, IN
        lists, CASE arms)."""
        import copy
        e = copy.deepcopy(e)

        def sub(col: P.Col):
            nm = inner_name_map.get(
                (col.qualifier.lower() if col.qualifier else None,
                 col.name.lower()))
            return P.Col(nm, qualifier=None) if nm is not None else col

        def rewrite(x):
            for f in getattr(x, "__dataclass_fields__", {}):
                v = getattr(x, f)
                if isinstance(v, P.Col):
                    setattr(x, f, sub(v))
                elif isinstance(v, list):
                    setattr(x, f, [sub(y) if isinstance(y, P.Col) else y
                                   for y in v])

        root = P.UnA("not", e)  # wrapper so a top-level Col also rewrites
        Planner._walk_ast(root, rewrite)
        return root.operand

    def _decorrelate(self, sub: P.Select, outer_scope: Scope):
        """Split the subquery WHERE into: equality correlations (pulled
        out as join keys), mixed-reference residual conjuncts (returned
        as ASTs for post-join filtering), and purely-inner conjuncts
        (kept in the subquery). Returns (sub', corr, residuals) where
        corr = [(outer_flat, inner Col AST)]."""
        import copy
        sub = copy.deepcopy(sub)
        # inner scope: plan the FROM cheaply to learn inner names
        probe_planner = Planner({**self.catalog})
        probe_planner.counter = self.counter
        _, inner_scope = probe_planner._from(sub.from_item, None)

        def side_of(col: P.Col):
            try:
                if inner_scope.resolve(col.name, col.qualifier) is not None:
                    return "inner"
            except ValueError:
                return "inner"  # ambiguous within inner → inner
            try:
                if outer_scope.resolve(col.name, col.qualifier) is not None:
                    return "outer"
            except ValueError:
                return "outer"
            return None

        corr: List[Tuple[str, P.Col]] = []
        kept: List = []
        residuals: List = []

        def refs(e, acc):
            if isinstance(e, P.Col):
                acc.append(e)
            for f in getattr(e, "__dataclass_fields__", {}):
                v = getattr(e, f)
                if isinstance(v, tuple(_AST_TYPES)):
                    refs(v, acc)
                elif isinstance(v, (list, tuple)):
                    for x in v:
                        if isinstance(x, tuple(_AST_TYPES)):
                            refs(x, acc)
            return acc

        def split(e):
            if isinstance(e, P.BinA) and e.op == "&":
                split(e.left)
                split(e.right)
                return
            if isinstance(e, P.BinA) and e.op == "==" and \
                    isinstance(e.left, P.Col) and isinstance(e.right, P.Col):
                for a, b in ((e.left, e.right), (e.right, e.left)):
                    if side_of(a) == "inner" and side_of(b) == "outer":
                        corr.append(
                            (outer_scope.resolve(b.name, b.qualifier), a))
                        return
            sides = {side_of(c) for c in refs(e, [])}
            if "outer" in sides:
                residuals.append(e)
            else:
                kept.append(e)

        if sub.where is not None:
            split(sub.where)
            w = None
            for k in kept:
                w = k if w is None else P.BinA("&", w, k)
            sub.where = w
        return sub, corr, residuals, inner_scope

    def _scalar_subquery(self, plan, scope, sub: P.Select):
        """Uncorrelated → execute now, return a literal. Correlated with a
        single aggregate → grouped aggregate joined on correlation keys;
        returns (None, new_plan, value_column)."""
        sub2, corr, residuals, _ = self._decorrelate(sub, scope)
        if residuals:
            raise NotImplementedError(
                "non-equality correlated scalar subquery")
        if not corr:
            node, names = self._plan_core(sub2, outer=None)
            from bodo_tpu_torch.plan.physical import execute
            t = execute(node)
            df = t.to_pandas()
            assert len(names) == 1 and len(df) == 1, \
                "scalar subquery must yield one value"
            return df[names[0]].iloc[0], plan, None
        # correlated aggregate: SELECT agg(e) ... WHERE inner.k = outer.k
        assert len(sub2.projections) == 1, "correlated scalar: one column"
        proj_expr, _ = sub2.projections[0]
        inner_keys = [ic for _, ic in corr]
        outer_keys = [oc for oc, _ in corr]
        val = self._fresh("__sval")
        sub2.projections = [(ic, f"__sk{i}")
                            for i, ic in enumerate(inner_keys)] + \
            [(proj_expr, val)]
        sub2.group_by = list(inner_keys)
        node, names = self._plan_core(sub2, outer=None)
        j = L.Join(plan, node, outer_keys, names[:-1], "inner",
                   null_equal=False)
        return None, j, names[-1]

    # ------------------------------------------------------------------
    # scalar expression conversion
    # ------------------------------------------------------------------
    def _expr(self, e, scope: Scope, _a=None, _b=None) -> Expr:
        if isinstance(e, P.Col):
            flat = scope.resolve(e.name, e.qualifier)
            if flat is None:
                raise ValueError(f"unknown column "
                                 f"{e.qualifier + '.' if e.qualifier else ''}"
                                 f"{e.name}")
            return ColRef(flat)
        if isinstance(e, P.Num):
            return Lit(e.value)
        if isinstance(e, P.Str):
            return Lit(e.value)
        if isinstance(e, P.DateLit):
            return Lit(np.datetime64(e.value))
        if isinstance(e, P.IntervalLit):
            raise NotImplementedError(
                "INTERVAL outside date-literal arithmetic")
        if isinstance(e, P.BinA):
            # constant-fold date ± interval
            folded = _fold_date_arith(e)
            if folded is not None:
                return folded
            left = self._expr(e.left, scope)
            right = self._expr(e.right, scope)
            return self._binop_coerced(e.op, left, right, e)
        if isinstance(e, P.UnA):
            if e.op == "not":
                return UnOp("~", self._expr(e.operand, scope))
            if e.op in ("isnull", "notnull"):
                return UnOp("isna" if e.op == "isnull" else "notna",
                            self._expr(e.operand, scope))
            return UnOp("neg", self._expr(e.operand, scope))
        if isinstance(e, P.Between):
            x = self._expr(e.operand, scope)
            lo = self._binop_coerced(">=", x, self._expr(e.lo, scope), e)
            hi = self._binop_coerced("<=", x, self._expr(e.hi, scope), e)
            both = BinOp("&", lo, hi)
            return UnOp("~", both) if e.negated else both
        if isinstance(e, P.InList):
            x = self._expr(e.operand, scope)
            vals = tuple(v.value for v in e.values
                         if isinstance(v, (P.Num, P.Str)))
            if len(vals) != len(e.values):
                raise NotImplementedError("non-literal IN list")
            if all(isinstance(v, str) for v in vals):
                r = StrPredicate("eq_any", vals, x)
            else:
                r = IsIn(x, vals)
            return UnOp("~", r) if e.negated else r
        if isinstance(e, P.Like):
            x = self._expr(e.operand, scope)
            r = _like_predicate(x, e.pattern)
            return UnOp("~", r) if e.negated else r
        if isinstance(e, P.Case):
            out = self._expr(e.else_, scope) if e.else_ is not None \
                else Lit(np.nan)
            for cond, then in reversed(e.whens):
                out = Where(self._expr(cond, scope),
                            self._expr(then, scope), out)
            return out
        if isinstance(e, P.CastA):
            x = self._expr(e.operand, scope)
            ty = {"integer": dt.INT64, "int": dt.INT64, "bigint": dt.INT64,
                  "smallint": dt.INT32, "double": dt.FLOAT64,
                  "float": dt.FLOAT64, "real": dt.FLOAT32,
                  "decimal": dt.FLOAT64, "numeric": dt.FLOAT64,
                  "varchar": dt.STRING, "text": dt.STRING,
                  "string": dt.STRING, "date": dt.DATE}.get(e.to)
            if ty is None:
                raise NotImplementedError(f"CAST to {e.to}")
            sch = getattr(self, "_cur_schema", None)
            src_t = None
            if sch is not None:
                try:
                    src_t = infer_dtype(x, sch)
                except Exception:
                    src_t = None
            if ty is dt.STRING:
                # string operands pass through; other types format on
                # host via ToChar (bodosql casting_array_kernels to_char)
                if src_t is dt.STRING:
                    return x
                from bodo_tpu_torch.plan.expr import (CodeLUT as _CL,
                                                StrConcat as _SC,
                                                ToChar as _TC)
                if isinstance(x, (DictMap, _CL, _SC)) or \
                        (isinstance(x, Lit) and isinstance(x.value, str)):
                    return x
                return _TC(None, x)
            if src_t is dt.STRING:
                # string → number/date goes through the host parse LUT;
                # TRY_CAST semantics (null on failure) come for free,
                # and plain CAST shares them (no SQL error channel in a
                # traced kernel — the reference's try-variant behavior)
                if ty is dt.DATE:
                    return StrHostFn("to_date", (), x)
                if ty in (dt.FLOAT64, dt.FLOAT32):
                    return StrHostFn("to_number", (), x)
                if ty in (dt.INT64, dt.INT32):
                    # Snowflake rounds half away from zero on
                    # string->integer casts ('99.9' -> 100, not 99)
                    from bodo_tpu_torch.plan.expr import MathFn
                    return Cast(MathFn("round", (0,),
                                       StrHostFn("to_number", (), x)), ty)
            return Cast(x, ty)
        if isinstance(e, P.Extract):
            return DtField(e.field, self._expr(e.operand, scope))
        if isinstance(e, P.Func):
            if e.name in ("year", "month", "day", "hour", "minute", "second",
                          "quarter", "dayofweek", "dayofyear", "week",
                          "weekofyear"):
                return DtField(e.name, self._expr(e.args[0], scope))
            if e.name in ("upper", "lower"):
                return DictMap(e.name, (), self._expr(e.args[0], scope))
            if e.name == "coalesce":
                out = self._expr(e.args[-1], scope)
                for a in reversed(e.args[:-1]):
                    x = self._expr(a, scope)
                    out = Where(UnOp("notna", x), x, out)
                return out
            if e.name == "abs":
                x = self._expr(e.args[0], scope)
                return Where(BinOp("<", x, Lit(0)), UnOp("neg", x), x)
            from bodo_tpu_torch.sql import kernels as K
            return K.lower_func(e.name, [self._expr(a, scope)
                                         for a in e.args])
        if isinstance(e, P.SubstringA):
            return DictMap("substring", (e.start, e.length),
                           self._expr(e.operand, scope))
        if isinstance(e, P.ScalarSubquery):
            node, names = self._plan_core(e.select, outer=None)
            from bodo_tpu_torch.plan.physical import execute
            df = execute(node).to_pandas()
            assert len(df) == 1
            return Lit(df[names[0]].iloc[0])
        raise NotImplementedError(f"expression {e}")

    def _binop_coerced(self, op: str, left: Expr, right: Expr, ast) -> Expr:
        """String-literal comparisons become dictionary predicates;
        DATE/DATETIME physical coercion happens schema-aware in eval_expr."""
        # comparisons of string columns with literals → dict predicates
        if op in ("==", "!=") and isinstance(right, Lit) and \
                isinstance(right.value, str):
            p = StrPredicate("eq_any", (right.value,), left)
            return p if op == "==" else UnOp("~", p)
        if op in ("==", "!=") and isinstance(left, Lit) and \
                isinstance(left.value, str):
            p = StrPredicate("eq_any", (left.value,), right)
            return p if op == "==" else UnOp("~", p)
        return BinOp(op, left, right)


_AST_TYPES = (P.BinA, P.UnA, P.Func, P.Case, P.CastA, P.InList, P.Between,
              P.Like, P.Extract, P.Col, P.Num, P.Str, P.DateLit,
              P.IntervalLit, P.SubstringA, P.ScalarSubquery, P.InSelect,
              P.Exists, P.WindowA)


def _contains_agg(projections) -> bool:
    def walk(e) -> bool:
        if isinstance(e, P.Func) and (e.star or e.name in _AGG_MAP or
                                      e.name == "count"):
            return True
        for f in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f)
            if isinstance(v, tuple(_AST_TYPES)) and walk(v):
                return True
            if isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, tuple(_AST_TYPES)) and walk(x):
                        return True
                    if isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, tuple(_AST_TYPES)) and walk(y):
                                return True
        return False
    return any(walk(e) for e, _ in projections)


def _restrict_scope(scope: Scope, cols: List[str]) -> Scope:
    s = Scope()
    keep = set(cols)
    for (q, c), f in scope.by_qual.items():
        if f in keep:
            s.by_qual[(q, c)] = f
    for c, fs in scope.by_col.items():
        kept = [f for f in fs if f in keep]
        if kept:
            s.by_col[c] = kept
    return s


def _default_name(e) -> str:
    if isinstance(e, P.Col):
        return e.name
    if isinstance(e, P.Func):
        return e.name
    return "expr"


def _fold_date_arith(e: P.BinA) -> Optional[Expr]:
    """DATE 'x' ± INTERVAL 'n' unit → folded datetime literal."""
    def as_date(x):
        if isinstance(x, P.DateLit):
            return np.datetime64(x.value)
        if isinstance(x, P.BinA):
            f = _fold_date_arith(x)
            if isinstance(f, Lit) and isinstance(f.value, np.datetime64):
                return f.value
        return None

    if e.op not in ("+", "-"):
        return None
    d = as_date(e.left)
    iv = e.right if isinstance(e.right, P.IntervalLit) else None
    if d is None or iv is None:
        return None
    sign = 1 if e.op == "+" else -1
    if iv.unit in ("year", "month"):
        months = iv.value * (12 if iv.unit == "year" else 1) * sign
        val = (d.astype("datetime64[M]") + months).astype("datetime64[ns]")
    else:
        mult = {"day": 24 * 3600, "hour": 3600, "minute": 60,
                "second": 1}[iv.unit]
        val = d.astype("datetime64[s]") + sign * iv.value * mult
        val = val.astype("datetime64[ns]")
    return Lit(val)


def _like_predicate(x: Expr, pattern: str) -> Expr:
    if "%" not in pattern and "_" not in pattern:
        return StrPredicate("eq_any", (pattern,), x)
    body = pattern.strip("%")
    if "%" not in body and "_" not in body:
        if pattern.startswith("%") and pattern.endswith("%"):
            return StrPredicate("contains", (body,), x)
        if pattern.endswith("%"):
            return StrPredicate("startswith", (body,), x)
        if pattern.startswith("%"):
            return StrPredicate("endswith", (body,), x)
    import re as _re
    rx = "^" + _re.escape(pattern).replace("%", ".*").replace("_", ".") + "$"
    return StrPredicate("match", (rx,), x)
