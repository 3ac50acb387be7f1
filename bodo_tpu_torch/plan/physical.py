"""Plan executor: logical plan -> relational-layer calls -> Table.

Counterpart of bodo_tpu/plan/physical.py: `execute` optimizes the plan
(plan/optimizer.py) and walks it post-order; each node's result memoizes
on the node (`_cached`), so a subplan shared by two parents, or a join
chain's leaves executed ahead of a re-optimization, run once. Every
executed stage reports its row count to plan/adaptive.py, whose
observations steer the join order of what is planned afterwards.

The port runs one device's plans (a source is sharded only when a mesh
of more than one shard is active). It takes another route than the JAX
package's defaults in four places, none of which changes a result:
there is no whole-stage fusion nor fused join (its config.fusion and
fusion_join), no semantic result cache (config.result_cache), no
elastic stage registry (config.elastic) and no plan validation
(config.plan_validate). Its OOM retry and replicated degradation need
the memory governor's admission control and the resilience layer, which
the port has not. One route is the port's own: a filter over the SQL
planner's cross join whose predicate requires a left and a right
column equal in every disjunct joins on them when the product has
more than PRODUCT_MAX_ROWS rows (`_filtered_product`). Window,
RankWindow and AggWindow run through relational.window_table,
rank_window and agg_window (SQL OVER clauses). NonEquiJoin, Explode and
ViewScan raise NotImplementedError naming the route they need.
"""

from __future__ import annotations

from bodo_tpu_torch import relational as R
from bodo_tpu_torch.parallel import mesh as mesh_mod
from bodo_tpu_torch.plan import adaptive
from bodo_tpu_torch.plan import logical as L
from bodo_tpu_torch.plan.optimizer import optimize
from bodo_tpu_torch.table.table import ONED, Table


def execute(node: L.Node, optimize_first: bool = True) -> Table:
    if optimize_first:
        node = optimize(node)
    return _exec(node)


def _maybe_shard(t: Table) -> Table:
    """Scan distribution policy: shard large sources over the active mesh;
    keep small ones replicated so joins against them broadcast. Without
    an active mesh there is one shard (the default mesh's count)."""
    from bodo_tpu_torch.config import config
    if t.distribution == ONED:
        return t
    m = mesh_mod._active_mesh
    if m is not None and m.n_shards > 1 and t.nrows >= config.shard_min_rows:
        return t.shard(m)
    return t


def _exec(node: L.Node) -> Table:
    if node._cached is not None:
        return node._cached
    t = _exec_inner(node)
    node._cached = t
    adaptive.observe_stage(node, t)
    return t


def apply_projection(t: Table, exprs) -> Table:
    """Evaluate a Projection node's exprs on a table."""
    from bodo_tpu_torch.plan.expr import ColRef
    new = {}
    names = []
    for n, e in exprs:
        names.append(n)
        if not (isinstance(e, ColRef) and e.name == n):
            new[n] = e
    t = R.assign_columns(t, new) if new else t
    return t.select(names)


def _conjuncts(e, op: str):
    from bodo_tpu_torch.plan.expr import BinOp
    if isinstance(e, BinOp) and e.op == op:
        return _conjuncts(e.left, op) + _conjuncts(e.right, op)
    return [e]


def _implied_keys(pred, join: L.Join):
    """(left, right) column pairs that every disjunct of `pred` requires
    equal (an equality conjunct between a left and a right column of
    one dtype), other than the join's own keys."""
    from bodo_tpu_torch.plan.expr import BinOp, ColRef
    lsch, rsch = join.left.schema, join.right.schema
    common = None
    for d in _conjuncts(pred, "|"):
        pairs = set()
        for c in _conjuncts(d, "&"):
            if not (isinstance(c, BinOp) and c.op == "==" and
                    isinstance(c.left, ColRef) and
                    isinstance(c.right, ColRef)):
                continue
            for a, b in ((c.left.name, c.right.name),
                         (c.right.name, c.left.name)):
                if a in lsch and b in rsch and b not in lsch and \
                        a not in rsch and lsch[a] is rsch[b]:
                    pairs.add((a, b))
        common = pairs if common is None else common & pairs
    known = set(zip(join.left_on, join.right_on))
    return sorted((common or set()) - known)


def _constant(side: L.Node, name: str):
    """The literal a Projection sets column `name` to, or None."""
    from bodo_tpu_torch.plan.expr import Lit
    if isinstance(side, L.Projection):
        for n, e in side.exprs:
            if n == name and isinstance(e, Lit):
                return e.value
    return None


# the most rows of a cross join that a filter over it with implied keys
# builds (the JAX package's route) before it joins on the keys instead
PRODUCT_MAX_ROWS = 1 << 28


def _filtered_product(join: L.Join, pred):
    """A filter over an inner join whose keys are literals projected on
    both sides (the SQL planner's cross join: every row of one side meets
    every row of the other) and whose predicate requires a left and a
    right column equal in every disjunct (TPC-H Q19's OR of join
    conditions): when the product has more than PRODUCT_MAX_ROWS rows,
    the join takes those columns as keys too and the whole predicate
    filters its result, the same rows without the product. The JAX
    package's executor builds the product (at TPC-H scale factor 1,
    lineitem x part: 1.8e12 rows); up to PRODUCT_MAX_ROWS the port does
    too. The keyed join is a plan node of its own, memoized and observed
    like any other. Returns None where this does not apply."""
    if join.how != "inner" or join._cached is not None:
        return None
    for a, b in zip(join.left_on, join.right_on):
        ca, cb = _constant(join.left, a), _constant(join.right, b)
        if ca is None or cb is None or ca != cb:
            return None
    pairs = _implied_keys(pred, join)
    if not pairs:
        return None
    left, right = _exec(join.left), _exec(join.right)
    if left.nrows * right.nrows <= PRODUCT_MAX_ROWS:
        return None
    keyed = L.Join(join.left, join.right,
                   join.left_on + [a for a, _ in pairs],
                   join.right_on + [b for _, b in pairs], "inner",
                   join.suffixes, null_equal=join.null_equal)
    keyed._aqe_reopt = True  # the join order stays the planner's
    return R.filter_table(_exec(keyed), pred)


def _unported(route: str):
    raise NotImplementedError(f"{route} is not ported yet")


def _exec_inner(node: L.Node) -> Table:
    if isinstance(node, L.ReadParquet):
        from bodo_tpu_torch.io import read_parquet
        return _maybe_shard(read_parquet(node.path, columns=node.columns,
                                         device=node.device))
    if isinstance(node, L.ReadCsv):
        from bodo_tpu_torch.io import read_csv
        t = read_csv(node.path, parse_dates=list(node.parse_dates) or None,
                     device=node.device)
        if node.columns:
            t = t.select(list(node.columns))
        return _maybe_shard(t)
    if isinstance(node, L.FromPandas):
        return _maybe_shard(node.table)
    if isinstance(node, L.ViewScan):
        _unported("ViewScan (runtime/views.py materialized views)")
    if isinstance(node, L.Projection):
        return apply_projection(_exec(node.child), node.exprs)
    if isinstance(node, L.Filter):
        if isinstance(node.child, L.Join):
            out = _filtered_product(node.child, node.predicate)
            if out is not None:
                return out
        return R.filter_table(_exec(node.child), node.predicate)
    if isinstance(node, L.Aggregate):
        return R.groupby_agg(_exec(node.child), node.keys, node.aggs)
    if isinstance(node, L.Reduce):
        child = _exec(node.child)
        scalars = R.reduce_table(child, node.aggs)
        import pandas as pd
        df = pd.DataFrame({k: [v] for k, v in scalars.items()})
        return Table.from_pandas(df, device=child.device)
    if isinstance(node, L.Join):
        repl = adaptive.maybe_reoptimize_join(node, _exec)
        if repl is not None:
            # observed leaf cardinalities changed the join order: run the
            # re-planned subtree (the leaves are memoized, so only the
            # joins themselves run)
            return _exec(repl)
        left = _exec(node.left)
        right = _exec(node.right)
        return R.join_tables(left, right, node.left_on, node.right_on,
                             node.how, node.suffixes,
                             null_equal=node.null_equal)
    if isinstance(node, L.NonEquiJoin):
        _unported("NonEquiJoin (ops/nonequi.py nl_join_rep, "
                  "nl_join_interval)")
    if isinstance(node, L.Explode):
        _unported("Explode (table/nested.py flatten_table)")
    if isinstance(node, L.Union):
        return _maybe_shard(R.concat_tables(
            [_exec(c) for c in node.children]))
    if isinstance(node, L.Window):
        return R.window_table(_exec(node.child), node.specs)
    if isinstance(node, L.RankWindow):
        return R.rank_window(_exec(node.child), node.partition_by,
                             node.order_by, node.specs, node.ascending)
    if isinstance(node, L.AggWindow):
        return R.agg_window(_exec(node.child), node.partition_by,
                            node.order_by, node.specs, node.ascending)
    if isinstance(node, L.Sort):
        return R.sort_table(_exec(node.child), node.by, node.ascending,
                            node.na_last)
    if isinstance(node, L.Limit):
        return R.head_table(_exec(node.child), node.n)
    if isinstance(node, L.Distinct):
        child = _exec(node.child)
        others = [n for n in child.names if n not in node.subset]
        aggs = [(n, "first", n) for n in others]
        out = R.groupby_agg(child, node.subset, aggs)
        return out.select(child.names)
    raise TypeError(f"cannot execute {node!r}")
