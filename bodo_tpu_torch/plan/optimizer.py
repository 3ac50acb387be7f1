"""Logical plan optimizer.

Counterpart of bodo_tpu/plan/optimizer.py, with the same rules, so an
optimized plan has the same key() in both packages. Rules:

  1. column pruning / projection pushdown — scans read only the columns
     any ancestor needs (the reference gets this from DuckDB + its
     TableColumnDelPass; here it lands directly in ReadParquet.columns).
  2. filter pushdown — filters slide below projections (with expression
     inlining) and joins (to the side that owns the columns), and merge
     with adjacent filters.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Set

from bodo_tpu_torch.plan import logical as L
from bodo_tpu_torch.plan.expr import (BinOp, Cast, ColRef, DictMap, DtField,
                                      Expr, IsIn, Lit, RowUDF, StrLen,
                                      StrPredicate, UnOp, Where,
                                      expr_columns)


def optimize(node: L.Node) -> L.Node:
    node = push_filters(node)
    node = reorder_joins(node)
    node = prune_columns(node, None)
    return node


# ---------------------------------------------------------------------------
# join reordering (frame-path merge chains)
# ---------------------------------------------------------------------------

def reorder_joins(node: L.Node) -> L.Node:
    """Greedy stats-driven reordering of left-deep INNER equi-join
    chains — the frame-path analogue of the SQL planner's join-graph
    ordering (reference: the vendored DuckDB join-order optimizer the
    frame path gets via bodo/pandas/plan.py get_plan_cardinality).
    pandas `merge` chains run in user order otherwise.

    Conservative: only chains of >= 3 relations, all inner, same
    null_equal, where every cross-relation shared column name is a
    consumed equal-name join key (so suffix logic can never fire
    differently under a new order). A final projection restores the
    original column order.

    The MAXIMAL chain is collected top-down BEFORE recursing, so a
    4-relation merge chain reorders as one unit (recursing first would
    reorder the inner 3-chain, wrap it in an order-restoring projection,
    and hide it from the outer pass)."""
    if not (isinstance(node, L.Join) and node.how == "inner"):
        return _rebuild(node, [reorder_joins(c) for c in node.children])

    rels: list = []
    edges: list = []  # (ri, rj, key_i, key_j)
    null_eq = node.null_equal
    orig_schema = list(node.schema)

    def bail():
        # not reorderable as a unit: recurse into children normally
        # (sub-chains may still reorder on their own)
        return _rebuild(node, [reorder_joins(c) for c in node.children])

    if not _collect_chain(node, node, rels, edges) or len(rels) < 3:
        return bail()

    # suffix-safety: a name shared by two relations must be an
    # equal-name join key on an edge between exactly those relations
    key_names = {(e[0], e[1], e[2]) for e in edges if e[2] == e[3]}
    for i in range(len(rels)):
        for j in range(i + 1, len(rels)):
            shared = set(rels[i].schema) & set(rels[j].schema)
            for name in shared:
                if (i, j, name) not in key_names and \
                        (j, i, name) not in key_names:
                    return bail()

    # recurse into the chain LEAVES only (they are not part of the chain)
    rels = [reorder_joins(r) for r in rels]

    from bodo_tpu_torch.plan.stats import estimate, join_estimate
    ests = [estimate(r) for r in rels]
    start = min(range(len(rels)), key=lambda i: ests[i][0])
    used = {start}
    plan = rels[start]
    cur_est, cur_raw = ests[start]
    consumed: set = set()
    while len(used) < len(rels):
        best = None
        for i in range(len(rels)):
            if i in used:
                continue
            kl, kr, ids = [], [], []
            for eid, (ri, rj, fi, fj) in enumerate(edges):
                if eid in consumed:
                    continue
                if ri in used and rj == i:
                    kl.append(fi)
                    kr.append(fj)
                    ids.append(eid)
                elif rj in used and ri == i:
                    kl.append(fj)
                    kr.append(fi)
                    ids.append(eid)
            if kl:
                out = join_estimate(cur_est, cur_raw, *ests[i])
                if best is None or out < best[0]:
                    best = (out, i, kl, kr, ids)
        if best is None:
            return bail()  # disconnected chain: keep user order
        out, i, kl, kr, ids = best
        plan = L.Join(plan, rels[i], kl, kr, "inner",
                      suffixes=node.suffixes, null_equal=null_eq)
        cur_est, cur_raw = out, max(cur_raw, ests[i][1])
        used.add(i)
        consumed.update(ids)

    if set(plan.schema) != set(orig_schema):
        return bail()  # suffix/drop divergence — bail to user order
    if list(plan.schema) != orig_schema:
        plan = L.Projection(plan, [(c, ColRef(c)) for c in orig_schema])
    return plan


def _collect_chain(n, top, rels: list, edges: list) -> bool:
    """Flatten the inner-join chain under `top` into its relations and
    key edges (ri, rj, key_i, key_j); False where it is not reorderable.
    A module-level function, not a closure: a recursive closure is a
    reference cycle, which would keep the executed leaves' tables alive
    until the garbage collector runs."""
    if isinstance(n, L.Join) and n.how == "inner" and \
            n.null_equal == top.null_equal and n.suffixes == top.suffixes:
        if not _collect_chain(n.left, top, rels, edges):
            return False
        ridx = len(rels)
        rels.append(n.right)
        for lk, rk in zip(n.left_on, n.right_on):
            # attribute the left key to its single owning relation in the
            # left subtree (suffixed/ambiguous names bail)
            cand = [i for i in range(ridx) if lk in rels[i].schema]
            if len(cand) != 1:
                return False
            edges.append((cand[0], ridx, lk, rk))
        return True
    rels.append(n)
    return True


# ---------------------------------------------------------------------------
# filter pushdown
# ---------------------------------------------------------------------------

def _substitute(e: Expr, mapping: Dict[str, Expr]) -> Expr:
    if isinstance(e, ColRef):
        return mapping.get(e.name, e)
    if isinstance(e, Lit):
        return e
    if isinstance(e, BinOp):
        return BinOp(e.op, _substitute(e.left, mapping),
                     _substitute(e.right, mapping))
    if isinstance(e, UnOp):
        return UnOp(e.op, _substitute(e.operand, mapping))
    if isinstance(e, Cast):
        return Cast(_substitute(e.operand, mapping), e.to)
    if isinstance(e, DtField):
        return DtField(e.field, _substitute(e.operand, mapping))
    if isinstance(e, IsIn):
        return IsIn(_substitute(e.operand, mapping), e.values)
    if isinstance(e, StrPredicate):
        return StrPredicate(e.kind, e.pattern, _substitute(e.operand, mapping))
    if isinstance(e, RowUDF):
        if e.operand is None:
            raise TypeError("row-mode UDF cannot be substituted")
        return RowUDF(e.func, e.out_dtype, _substitute(e.operand, mapping))
    if isinstance(e, DictMap):
        return DictMap(e.kind, e.params, _substitute(e.operand, mapping))
    if isinstance(e, StrLen):
        return StrLen(_substitute(e.operand, mapping))
    if isinstance(e, Where):
        return Where(_substitute(e.cond, mapping),
                     _substitute(e.iftrue, mapping),
                     _substitute(e.iffalse, mapping))
    # generic frozen-dataclass walk for the remaining node kinds (SQL
    # kernel-library exprs: MathFn/CodeLUT/StrConcat/DateAdd/...)
    import dataclasses
    if dataclasses.is_dataclass(e):
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, Expr):
                changes[f.name] = _substitute(v, mapping)
            elif isinstance(v, tuple) and any(isinstance(x, Expr)
                                              for x in v):
                changes[f.name] = tuple(
                    _substitute(x, mapping) if isinstance(x, Expr) else x
                    for x in v)
        return dataclasses.replace(e, **changes) if changes else e
    raise TypeError(f"substitute: {e}")


def push_filters(node: L.Node) -> L.Node:
    if isinstance(node, L.Filter):
        child = node.child
        pred = node.predicate
        if isinstance(child, L.Filter):
            # merge adjacent filters, keep pushing
            return push_filters(L.Filter(child.child,
                                         BinOp("&", child.predicate, pred)))
        if isinstance(child, L.Projection) and "*" not in expr_columns(pred):
            mapping = {n: e for n, e in child.exprs}
            pushed = L.Filter(push_filters(child.child),
                              _substitute(pred, mapping))
            return L.Projection(push_filters(pushed), child.exprs)
        if isinstance(child, L.Join):
            cols = expr_columns(pred)
            lcols = set(child.left.schema)
            rcols = set(child.right.schema)
            # only push when the names are unambiguous pass-throughs, and
            # only INTO a side the join preserves 1:1 (pushing into the
            # null-padded side of an outer/right join changes results)
            if cols <= lcols and not (cols & rcols) and \
                    child.how in ("inner", "left", "cross"):
                nl = push_filters(L.Filter(child.left, pred))
                return L.Join(nl, push_filters(child.right), child.left_on,
                              child.right_on, child.how, child.suffixes,
                              child.null_equal)
            if cols <= rcols and not (cols & lcols) and \
                    child.how in ("inner", "right", "cross"):
                nr = push_filters(L.Filter(child.right, pred))
                return L.Join(push_filters(child.left), nr, child.left_on,
                              child.right_on, child.how, child.suffixes,
                              child.null_equal)
        if isinstance(child, L.NonEquiJoin):
            # names are disjoint by construction; push into a preserved
            # side (inner: both; left: probe side only)
            cols = expr_columns(pred)
            if cols <= set(child.left.schema):
                nl = push_filters(L.Filter(child.left, pred))
                return L.NonEquiJoin(nl, push_filters(child.right),
                                     child.pred, child.how)
            if cols <= set(child.right.schema) and child.how == "inner":
                nr = push_filters(L.Filter(child.right, pred))
                return L.NonEquiJoin(push_filters(child.left), nr,
                                     child.pred, child.how)
        return L.Filter(push_filters(child), pred)
    # recurse
    return _rebuild(node, [push_filters(c) for c in node.children])


# ---------------------------------------------------------------------------
# column pruning
# ---------------------------------------------------------------------------

def prune_columns(node: L.Node, required: Optional[Set[str]]) -> L.Node:
    """required=None means 'all output columns are needed'."""
    if isinstance(node, (L.ReadParquet, L.ReadCsv)):
        if required is not None and set(node.schema) - required:
            cols = [n for n in node.schema if n in required]
            if not cols:  # keep one column — row counts need a spine
                cols = [next(iter(node.schema))]
            if isinstance(node, L.ReadParquet):
                return L.ReadParquet(node.path, cols, device=node.device)
            return L.ReadCsv(node.path, cols, node.parse_dates,
                             schema={n: node.schema[n] for n in cols},
                             device=node.device)
        return node
    if isinstance(node, L.FromPandas):
        if required is not None and set(node.schema) - required:
            cols = [n for n in node.schema if n in required]
            if not cols:
                cols = [next(iter(node.schema))]
            pruned = L.FromPandas(node.table.select(cols))
            return pruned
        return node
    if isinstance(node, L.Projection):
        exprs = node.exprs if required is None else \
            [(n, e) for n, e in node.exprs if n in required]
        if not exprs:  # keep a spine column for row counts
            exprs = node.exprs[:1]
        need = set()
        for _, e in exprs:
            need |= expr_columns(e)
        if "*" in need:  # a RowUDF may read any column
            need = None
        return L.Projection(prune_columns(node.child, need), exprs)
    if isinstance(node, L.Filter):
        pcols = expr_columns(node.predicate)
        need = None if (required is None or "*" in pcols) else \
            (set(required) | pcols)
        return L.Filter(prune_columns(node.child, need), node.predicate)
    if isinstance(node, L.Aggregate):
        aggs = node.aggs if required is None else \
            [a for a in node.aggs if a[2] in required or a[2] in node.keys]
        need = set(node.keys) | {c for c, _, _ in aggs}
        return L.Aggregate(prune_columns(node.child, need), node.keys, aggs)
    if isinstance(node, L.Reduce):
        need = {c for c, _, _ in node.aggs}
        return L.Reduce(prune_columns(node.child, need), node.aggs)
    if isinstance(node, L.Join):
        lneed = rneed = None
        if required is not None:
            # un-suffix required names back to source columns
            overlap = (set(node.left.schema) & set(node.right.schema)) - \
                (set(node.left_on) & set(node.right_on))
            lneed, rneed = set(node.left_on), set(node.right_on)
            for n in node.left.schema:
                out = n + node.suffixes[0] if n in overlap else n
                if out in required:
                    lneed.add(n)
            for n in node.right.schema:
                out = n + node.suffixes[1] if n in overlap else n
                if out in required:
                    rneed.add(n)
        return L.Join(prune_columns(node.left, lneed),
                      prune_columns(node.right, rneed),
                      node.left_on, node.right_on, node.how, node.suffixes,
                      node.null_equal)
    if isinstance(node, L.NonEquiJoin):
        lneed = rneed = None
        if required is not None:
            need = set(required) | expr_columns(node.pred)
            lneed = {n for n in node.left.schema if n in need}
            rneed = {n for n in node.right.schema if n in need}
        return L.NonEquiJoin(prune_columns(node.left, lneed),
                             prune_columns(node.right, rneed),
                             node.pred, node.how)
    if isinstance(node, L.Sort):
        need = None if required is None else \
            (set(required) | set(node.by))
        return L.Sort(prune_columns(node.child, need), node.by,
                      node.ascending, node.na_last)
    if isinstance(node, L.Distinct):
        need = None if required is None else \
            (set(required) | set(node.subset))
        return L.Distinct(prune_columns(node.child, need), node.subset)
    if isinstance(node, L.Limit):
        return L.Limit(prune_columns(node.child, required), node.n)
    if isinstance(node, L.Union):
        # same required set on every arm keeps schemas aligned
        return L.Union([prune_columns(c, required) for c in node.children])
    return _rebuild(node, [prune_columns(c, None) for c in node.children])


def _rebuild(node: L.Node, children) -> L.Node:
    if children == node.children:
        return node
    import copy
    new = copy.copy(node)
    new.children = children
    return new
