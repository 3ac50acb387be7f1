"""Table-level relational operators.

Counterpart of bodo_tpu/relational.py: projection (`assign_columns`),
`filter_table`, the equi-join family, groupby and `sort_table`, over
replicated (REP) tables and over row-sharded (1D) tables on a mesh of S
shards (parallel/mesh.py).

REP routes: the dense-LUT join, the hash join, the sort join `_join_rep`
by hash or sort gids (inner, left, right and outer); the cross join; the
dense / packed / hashed / sort groupby routes; the local sort;
`concat_tables` (UNION ALL). 1D routes: the broadcast join
(`_join_broadcast`, a replicated build side) and the shuffle join
(`_join_sharded` after `shuffle_by_key`), each a per-shard join_local,
with plan/adaptive.py's broadcast decision and skew split; the cross
join against a replicated side; the two-phase groupby
(parallel/shuffle.groupby_sharded) and, for aggregations that do not
decompose, the colocated groupby (`_groupby_agg_colocated`: one hash
shuffle, then the sort groupby on each shard); the sample sort
(ops/sort.sort_sharded). Elementwise stages (projection, the filter's
predicate) run on the whole global array; compaction and everything
else runs per shard. The gates are the JAX package's, checked in the
same order, so both packages take the same route on the same data.

`groupby_agg` takes the decomposable aggregations (ops/groupby.py) on
every route, the holistic ones (nunique, mode, median and quantile_<q>)
on the routes the JAX package takes for them (REP: packed, then the
sort groupby; 1D: colocated), and LISTAGG (`listagg[:<sep>]`,
`listaggd[:<sep>]`) as native aggregations finished on the host
(`_groupby_agg_with_listagg`). `reduce_table` reduces whole columns to
host scalars (REP and 1D; quantiles through `_reduce_quantile`). The
windows (ops/window.py) are `window_table` (cumulative, rolling, shift,
diff and rowid), `rank_window` and `agg_window` (SQL OVER), REP and 1D.
`shard_frames` decodes each shard of a 1D table to pandas (the pandas
frontend's groupby.apply). The plan executor (plan/physical.py) also
calls `head_table` (LIMIT), `select_columns` and `assign_columns`' host
pass for a top-level DictMap (SQL SUBSTRING, UPPER: the new dictionary
is built on the host, the codes remapped on the device).

Where the JAX package would go on to a route the port has not ported
(the projections of StrConcat, ToChar, StrToList and NestedFn;
aggregation over decimals, in the groupby, `reduce_table` and the
aggregate windows) the port raises NotImplementedError naming it. A
join without keys other than the cross join raises ValueError, where
the JAX package fails inside its sort join.

`route_counts` counts the routes taken, so tests and the chip smoke can
show which one ran.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bodo_tpu_torch.config import config
from bodo_tpu_torch.ops import cuda_kernels as CK
from bodo_tpu_torch.ops import hashtable as HT
from bodo_tpu_torch.ops import kernels as K
from bodo_tpu_torch.ops.groupby import (DECOMPOSE, HASH_OPS, SortedSegments,
                                        _accumulated, _from_bits,
                                        _min_max_ident, _np_dtype, _ordered,
                                        _segment_agg, _widened, agg_dtype,
                                        result_dtype, groupby_local,
                                        groupby_local_hashed, segment_sum)
from bodo_tpu_torch.ops.hashing import dest_shard, hash_columns
from bodo_tpu_torch.ops.join import cross_local, join_count, join_local
from bodo_tpu_torch.ops.sort import sort_local, sort_sharded
from bodo_tpu_torch.parallel import collectives as C
from bodo_tpu_torch.parallel import mesh as mesh_mod
from bodo_tpu_torch.parallel.shuffle import (_concat_pairs,
                                             _flatten_with_valids,
                                             _rebuild_from_flat,
                                             _shard_arrays, groupby_sharded,
                                             shuffle_rows)
from bodo_tpu_torch.plan.expr import (ColRef, Expr, eval_expr, expr_range,
                                      infer_dtype)
from bodo_tpu_torch.table import dtypes as dt
from bodo_tpu_torch.table.dict_utils import unify_dictionaries
from bodo_tpu_torch.table.table import (ONED, REP, Column, Table,
                                        round_capacity)

# shrink a table's capacity when occupancy falls below this (the JAX
# package's default config.rebucket_threshold)
REBUCKET_THRESHOLD = 0.45

# route name -> times taken since the last reset_route_counts()
route_counts: Dict[str, int] = {
    "join_dense": 0, "join_hash": 0, "join_rep_hash": 0, "join_rep_sort": 0,
    "groupby_dense": 0, "groupby_packed": 0, "groupby_hashed": 0,
    "groupby_sort": 0, "sort_local": 0,
    "join_broadcast": 0, "join_shuffle": 0, "groupby_sharded_hash": 0,
    "groupby_sharded_sort": 0, "sort_sharded": 0,
    "join_cross": 0, "join_skew_split": 0, "append_sharded": 0,
    "concat_tables": 0, "groupby_colocated": 0,
    "rank_window_local": 0, "rank_window_shuffle": 0,
    "rank_window_global": 0, "agg_window_local": 0,
    "agg_window_shuffle": 0, "agg_window_broadcast": 0,
    "agg_window_gather": 0,
}


def reset_route_counts() -> None:
    for k in route_counts:
        route_counts[k] = 0


def _schema(t: Table) -> Dict[str, dt.DType]:
    return {n: c.dtype for n, c in t.columns.items()}


def _as_local(t: Table) -> Optional[Table]:
    """A 1-shard 1D table is a local table: its REP view, so one-shard
    runs skip the shuffle and combine stages."""
    if t.distribution == ONED and t.num_shards == 1:
        return Table(dict(t.columns), t.nrows, REP, None)
    return None


def _padmask(t: Table) -> torch.Tensor:
    """Real-row mask of a table (per shard for a 1D table)."""
    if t.distribution == ONED:
        return K.shard_row_mask(t.counts, t.shard_capacity, t.device)
    return K.row_mask(t.nrows, t.capacity, t.device)


def _dicts(t: Table) -> Dict[str, np.ndarray]:
    return {n: c.dictionary for n, c in t.columns.items()
            if c.dictionary is not None}


def _tree(t: Table) -> Dict[str, Tuple]:
    return {n: (c.data, c.valid) for n, c in t.columns.items()}


def _keep_vranges(res: Table, src: Table) -> Table:
    """Row-preserving ops (filter/sort/slice) keep host value bounds."""
    for n, c in res.columns.items():
        s = src.columns.get(n)
        if c.vrange is None and s is not None and s.dtype is c.dtype:
            c.vrange = s.vrange
    return res


def shrink_to_fit(t: Table) -> Table:
    """Shrink the capacity to fit the rows (rows are compacted to the
    front; of each shard, for a 1D table, which shrinks every shard to
    fit the fullest). The slices are copied so the old buffers are
    freed."""
    if t.distribution == ONED:
        s, old = t.num_shards, t.shard_capacity
        new = round_capacity(int(t.counts.max()) if len(t.counts) else 1)
        if new >= old:
            return t

        def cut(a):
            return None if a is None else \
                a.reshape(s, old)[:, :new].reshape(s * new)
        tree = {n: (cut(c.data), cut(c.valid))
                for n, c in t.columns.items()}
        return t.with_arrays(tree, nrows=t.nrows, counts=t.counts)
    new = round_capacity(max(t.nrows, 1))
    if new >= t.capacity:
        return t
    tree = {n: (c.data[:new].clone(),
                None if c.valid is None else c.valid[:new].clone())
            for n, c in t.columns.items()}
    return t.with_arrays(tree, nrows=t.nrows)


def rebucket(t: Table) -> Table:
    """Shrink the capacity when occupancy drops below the threshold (a 1D
    table's occupancy is its fullest shard's, times the shards)."""
    occupancy_cap = (max(t.counts.max(), 1) * t.num_shards
                     if t.distribution == ONED and len(t.counts)
                     else max(t.nrows, 1))
    if occupancy_cap / t.capacity >= REBUCKET_THRESHOLD:
        return t
    return shrink_to_fit(t)


# ---------------------------------------------------------------------------
# projection / assignment / filter
# ---------------------------------------------------------------------------

def assign_columns(t: Table, new: Dict[str, Expr]) -> Table:
    """Add/replace columns computed from expressions (df.assign); every
    expression sees the input table.

    A top-level DictMap (a string->string transform, SQL SUBSTRING or
    UPPER) runs on the host dictionary: the mapped strings are
    deduplicated into the new sorted dictionary, and the device only
    remaps the codes through that table."""
    from bodo_tpu_torch.plan.expr import (DictMap, NestedFn, StrConcat,
                                          StrToList, ToChar)
    for e in new.values():
        if isinstance(e, (StrConcat, StrToList, NestedFn, ToChar)):
            raise NotImplementedError(
                f"the {type(e).__name__} projection of assign_columns "
                f"(bodo_tpu/relational.py) is not ported yet")
    dictmaps = {n: e for n, e in new.items() if isinstance(e, DictMap)}
    new = {n: e for n, e in new.items() if n not in dictmaps}
    schema = _schema(t)
    dicts = _dicts(t)
    tree = _tree(t)
    cols = dict(t.columns)  # untouched columns: same tensors
    for name, e in new.items():
        d, v = eval_expr(e, tree, dicts, schema)
        if d.dim() == 0:  # literal projection -> broadcast
            d = d.expand(t.capacity).contiguous()
        dtype = infer_dtype(e, schema)
        if dtype is dt.STRING:
            # renames keep the source dictionary
            cols[name] = Column(d, v, dtype,
                                t.columns[e.name].dictionary
                                if isinstance(e, ColRef) else None)
        else:
            cols[name] = Column(d, v, dtype, None,
                                expr_range(e, t.columns))
    for name, e in dictmaps.items():
        cols[name] = _dictmap_column(t, e)
    return Table(cols, t.nrows, t.distribution, t.counts)


def _dictmap_column(t: Table, e: Expr) -> Column:
    """A DictMap chain over a string column as a new dictionary column."""
    from bodo_tpu_torch.plan.expr import DictMap
    chain = []
    base = e
    while isinstance(base, DictMap):
        chain.append(base)
        base = base.operand
    if not isinstance(base, ColRef):
        raise NotImplementedError(
            f"a string transform over {type(base).__name__} is not ported "
            f"yet (the DictMap operand must be a column)")
    src = t.columns[base.name]
    if src.dtype is not dt.STRING:
        raise NotImplementedError(
            f"string function over non-string column {base.name!r} "
            f"({src.dtype.name}): cast to varchar is not supported")
    vals = list(src.dictionary if src.dictionary is not None else [])
    for tr in reversed(chain):
        vals = [tr.apply_host(s) for s in vals]
    mapped = np.array(vals, dtype=str)
    nd, remap = (np.unique(mapped, return_inverse=True)
                 if len(mapped) else (mapped, np.zeros(0, np.int64)))
    mp = torch.from_numpy(remap.astype(np.int32) if len(remap)
                          else np.zeros(1, np.int32)).to(src.data.device)
    codes = mp[torch.clamp(src.data.to(torch.int64), 0,
                           max(len(vals) - 1, 0))]
    return Column(codes, src.valid, dt.STRING, nd)


def select_columns(t: Table, names: Sequence[str]) -> Table:
    return t.select(list(names))


def head_table(t: Table, n: int) -> Table:
    """The first `n` rows (LIMIT) as a replicated table; a 1D table is
    gathered first, so its rows come in shard order."""
    g = t.gather() if t.distribution == ONED else t
    n = min(n, g.nrows)
    return Table(dict(g.columns), n, REP, None)


def window_table(t: Table, specs: Sequence[Tuple[str, str, Optional[int],
                                                 str]]) -> Table:
    """Row-aligned window transforms: specs = [(col, op, param, outname)].
    ops: cumsum/cumprod/cummax/cummin, rolling_{sum,mean,min,max,count}
    (param = window), shift/diff (param = periods), and rowid, the global
    row position (shard i's rows after the rows of shards 0..i-1, -1 on
    padding), which the SQL planner's EXISTS decorrelation and the 1D
    windows tag rows with.

    A 1D table runs shard by shard: each shard's cumulative carry is
    the exclusive scan of the shards before it (W.cum_carry_exscan), and
    each rolling or shift halo the last rows of as many predecessor
    shards as the window needs (W.multi_hop_halo), short and empty
    shards included."""
    from bodo_tpu_torch.ops import window as W
    sharded = t.distribution == ONED
    s = t.num_shards
    counts = [int(c) for c in t.counts] if sharded else [t.nrows]
    goffs = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    res = t.with_columns(t.columns)
    for col, op, param, oname in specs:
        if op == "rowid":
            per = t.shard_capacity
            local = torch.arange(per, dtype=torch.int64, device=t.device)
            rid = torch.cat([local + int(off) for off in goffs])
            rid = torch.where(_padmask(t), rid, torch.full(
                (), -1, dtype=torch.int64, device=t.device))
            res.columns[oname] = Column(rid, None, dt.INT64, None)
            continue
        c = t.column(col)
        xs, vs = C.shard_views(c.data, s), C.shard_views(c.valid, s)
        if op.startswith("cum"):
            parts = [W.cum_local(op, xs[i], vs[i], counts[i])
                     for i in range(s)]
            carries = torch.stack([carry for _, carry in parts])
            out = []
            for i, (loc, _) in enumerate(parts):
                if sharded:
                    loc = W.cum_combine(op, loc,
                                        W.cum_carry_exscan(op, carries, i))
                out.append(W.cum_finalize(op, loc, xs[i], vs[i], counts[i]))
        elif op.startswith("rolling_"):
            w = int(param)
            tails = W.halo_tails(xs, vs, counts, w - 1) \
                if sharded and w > 1 else None
            out = []
            for i in range(s):
                if tails is not None:
                    hx, hok = W.multi_hop_halo(tails, i, w - 1)
                else:  # single block: no predecessor
                    hx, hok = _empty_halo(max(w - 1, 0), t.device)
                out.append(W.rolling_local(op[len("rolling_"):], w, xs[i],
                                           vs[i], counts[i], hx, hok,
                                           int(goffs[i])))
        elif op in ("shift", "diff"):
            n = int(param)
            tails = W.halo_tails(xs, vs, counts, n) if sharded else None
            out = []
            for i in range(s):
                hx, hok = W.multi_hop_halo(tails, i, n) if sharded \
                    else _empty_halo(n, t.device)
                sh, sok = W.shift_local(xs[i], vs[i], counts[i], hx, hok, n)
                if op == "diff":
                    padmask = K.row_mask(counts[i], xs[i].shape[0],
                                         t.device)
                    ok = K.value_ok(xs[i], vs[i], padmask) & sok
                    sh = torch.where(ok, xs[i].to(torch.float64) - sh,
                                     float("nan"))
                out.append(sh)
        else:
            raise ValueError(f"unknown window op {op}")
        res.columns[oname] = Column(C.concat_shards(out), None, dt.FLOAT64,
                                    None)
    return res


def _empty_halo(k: int, device):
    return (torch.zeros(k, dtype=torch.float64, device=device),
            torch.zeros(k, dtype=torch.bool, device=device))


# ---------------------------------------------------------------------------
# ranking and aggregate windows (SQL OVER)
# ---------------------------------------------------------------------------

def _window_ascending(order_by, ascending) -> List[bool]:
    if ascending is None:
        return [True] * len(order_by)
    if isinstance(ascending, bool):
        return [ascending] * len(order_by)
    return list(ascending)


def rank_window(t: Table, partition_by: Sequence[str],
                order_by: Sequence[str],
                specs: Sequence[Tuple[str, int, str]],
                ascending=None, na_last: bool = True) -> Table:
    """Partitioned ranking windows: specs = [(op, param, outname)] with op
    in row_number/rank/dense_rank/ntile/cumcount.

    REP: one sorted pass (`_rank_window_exec`). 1D with partition keys:
    tag the rows with their global position (`rowid`), hash-shuffle them
    so each partition is wholly on one shard (`shuffle_by_key`), rank
    each shard, then restore the original row order by a sample sort on
    the position. 1D without partition keys: `_global_rank_sharded`."""
    partition_by = list(partition_by)
    order_by = list(order_by)
    ascending = _window_ascending(order_by, ascending)
    local = _as_local(t)
    if local is not None:
        t = local
    if t.distribution == ONED:
        if not partition_by:
            return _global_rank_sharded(t, order_by, specs,
                                        tuple(ascending), na_last)
        keep = t.names
        t2 = window_table(t, [(t.names[0], "rowid", None, "__rid")])
        t2 = shuffle_by_key(t2, partition_by)
        out = _rank_window_exec(t2, partition_by, order_by, specs,
                                tuple(ascending), na_last)
        out = sort_table(out, ["__rid"])
        return out.select(keep + [o for _, _, o in specs])
    return _rank_window_exec(t, partition_by, order_by, specs,
                             tuple(ascending), na_last)


def _global_rank_sharded(t: Table, order_by, specs, ascending,
                         na_last: bool) -> Table:
    """No-partition ranking over the whole 1D table without a gather:
    sort by the order keys (the sample sort), then on each shard the
    ranks from the global row index (the exscan of the shard counts), a
    run head wherever a row differs from the row before it in any order
    column (typed compares; a shard's first row against the last row of
    the nearest non-empty shard before it, W.prev_last_value; nulls tie
    with nulls), and the exscans of the shards' last run heads and run
    counts; the original row order comes back by a sample sort on the
    carried position. The JAX package carries the run heads through
    float64 with a -inf identity clamped to -1; here they are int64 with
    -1 as the identity, the same values."""
    from bodo_tpu_torch.ops import window as W
    route_counts["rank_window_global"] += 1
    keep = t.names
    t2 = window_table(t, [(t.names[0], "rowid", None, "__rid")])
    if order_by:
        t2 = sort_table(t2, list(order_by), list(ascending), na_last)
    # else: the original row order is the total order already
    s = t2.num_shards
    counts = [int(c) for c in t2.counts]
    total = sum(counts)
    goffs = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    cap = t2.shard_capacity
    dev = t2.device
    kspecs = [(op, int(p or 0), o) for op, p, o in specs]
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    padmasks = [K.row_mask(c, cap, dev) for c in counts]
    gidxs = [int(goffs[i]) + pos for i in range(s)]
    if order_by:
        news = [torch.zeros(cap, dtype=torch.bool, device=dev)
                for _ in range(s)]
        for name in order_by:
            c = t2.column(name)
            xs, vs = C.shard_views(c.data, s), C.shard_views(c.valid, s)
            lasts = W.last_rows(xs, vs, counts)
            for i in range(s):
                pv, pok, pexists = W.prev_last_value(lasts, i)
                x = xs[i]
                ok = K.value_ok(x, vs[i], padmasks[i])
                prev_x = torch.cat([pv[None], x[:-1]])
                prev_ok = torch.cat([pok[None], ok[:-1]])
                if x.dtype == torch.uint64:  # equality of the same bits
                    x, prev_x = x.view(torch.int64), prev_x.view(torch.int64)
                # nulls tie with nulls: the values compare only when both
                # are real; a validity transition breaks a run
                diff = (ok & prev_ok & (prev_x != x)) | (prev_ok != ok)
                no_pred = (pos == 0) & ~pexists
                news[i] = news[i] | diff | no_pred | (gidxs[i] == 0)
    else:
        # no ORDER BY: every row is a peer — one global run
        news = [g == 0 for g in gidxs]
    heads = [torch.where(news[i] & padmasks[i], gidxs[i], -1)
             for i in range(s)]
    head_carries = torch.stack([h.max() for h in heads])
    flags = [(news[i] & padmasks[i]).to(torch.int64) for i in range(s)]
    dense_carries = torch.stack([f.sum() for f in flags])
    outs = [[] for _ in kspecs]
    for i in range(s):
        prefix = torch.cat([head_carries.new_full((1,), -1),
                            head_carries[:i]]).max()
        run_head = torch.maximum(W.prefix_scan(heads[i], "max"), prefix)
        dense = torch.cumsum(flags[i], 0) + dense_carries[:i].sum()
        gidx = gidxs[i]
        for j, (op, param, _) in enumerate(kspecs):
            if op == "row_number":
                r = gidx + 1
            elif op == "cumcount":
                r = gidx
            elif op == "rank":
                r = run_head + 1
            elif op == "dense_rank":
                r = dense
            elif op == "ntile":
                n = param
                small = total // n
                rem = total - small * n
                # first `rem` buckets get (small+1) rows
                cut = rem * (small + 1)
                r = torch.where(gidx < cut, gidx // max(small + 1, 1),
                                rem + (gidx - cut) // max(small, 1)) + 1
            else:
                raise ValueError(f"unknown rank op {op}")
            outs[j].append(torch.where(padmasks[i], r, 0))
    res = t2.with_columns(t2.columns)
    for (op, p, oname), parts in zip(kspecs, outs):
        res.columns[oname] = Column(C.concat_shards(parts), None, dt.INT64,
                                    None)
    res = sort_table(res, ["__rid"])
    return res.select(keep + [o for _, _, o in specs])


def _per_block(t: Table, fn):
    """Run `fn(block index, block arrays getter, count)` on each shard of
    a 1D table (once on a REP table); returns the list of results."""
    s = t.num_shards
    counts = [int(c) for c in t.counts] if t.distribution == ONED \
        else [t.nrows]
    views = {n: (C.shard_views(c.data, s), C.shard_views(c.valid, s))
             for n, c in t.columns.items()}

    def arrays(i, names):
        return tuple((views[n][0][i], views[n][1][i]) for n in names)
    return [fn(i, arrays, counts[i]) for i in range(s)]


def _rank_window_exec(t: Table, partition_by, order_by, specs,
                      ascending: Tuple[bool, ...], na_last: bool) -> Table:
    """The sorted pass (W.rank_window_local) on a REP table, or on each
    shard of a 1D table whose partitions are colocated."""
    from bodo_tpu_torch.ops.window import rank_window_local
    route_counts["rank_window_shuffle" if t.distribution == ONED
                 else "rank_window_local"] += 1
    kspecs = tuple((op, int(param or 0)) for op, param, _ in specs)
    parts = _per_block(t, lambda i, arrays, count: rank_window_local(
        arrays(i, partition_by), arrays(i, order_by), count, kspecs,
        ascending, na_last))
    res = t.with_columns(t.columns)
    for j, (op, param, oname) in enumerate(specs):
        res.columns[oname] = Column(C.concat_shards([p[j] for p in parts]),
                                    None, dt.INT64, None)
    return res


# the aggregate windows that reduce to one value per decimal column:
# they wait for decimal aggregation (ops/groupby.agg_dtype)
_DECIMAL_REFUSED = ("sum", "sum0", "mean", "min", "max")


def agg_window(t: Table, partition_by: Sequence[str],
               order_by: Sequence[str],
               specs: Sequence[Tuple[str, str, tuple, int, str]],
               ascending=None, na_last: bool = True) -> Table:
    """Aggregate/navigation windows: specs = [(op, col, frame, param,
    outname)] with op in sum/sum0/mean/count/min/max/lead/lag/
    first_value/last_value and frame in ("all",) / ("cumrange",) /
    ("rows", lo, hi).

    REP: one sorted pass (`_agg_window_exec`). 1D with partition keys:
    `rowid`, `shuffle_by_key`, the sorted pass on each shard, then a
    sample sort on the position restores the row order; with no ORDER
    BY, the order-sensitive specs follow the original row order (the
    shuffle interleaves source shards, so their sort is pinned to the
    position). 1D `OVER ()` over sum, sum0, mean, min, max and count:
    one distributed reduction (`reduce_table`) broadcast to every row
    (`_broadcast_scalar_column`). 1D with an ordered frame and no
    partition key gathers the table to REP, runs the sorted pass and
    shards the result again: the JAX package's route, kept as it is.

    sum, sum0, mean, min and max over a decimal column raise
    NotImplementedError (decimal aggregation is not ported); count and
    the gather ops carry the source dtype and work."""
    for op, col, *_ in specs:
        if op in _DECIMAL_REFUSED and dt.is_decimal(t.column(col).dtype):
            raise NotImplementedError(
                f"window {op} over the decimal column {col!r} is not "
                f"ported yet (decimal aggregation)")
    partition_by = list(partition_by)
    order_by = list(order_by)
    ascending = _window_ascending(order_by, ascending)
    local = _as_local(t)
    if local is not None:
        t = local
    if t.distribution == ONED:
        if not partition_by:
            whole = (not order_by) and all(
                tuple(frame) == ("all",) and
                op in ("sum", "sum0", "mean", "min", "max", "count")
                for op, _, frame, *_ in specs)
            if whole:
                # SUM(x) OVER () etc.: one distributed reduction,
                # broadcast back — no gather
                rmap = {"sum": "sumnull", "sum0": "sum"}
                vals = reduce_table(
                    t, [(c, rmap.get(op, op), o)
                        for op, c, frame, p, o in specs])
                res = t.with_columns(dict(t.columns))
                for op, c, frame, p, o in specs:
                    res.columns[o] = _broadcast_scalar_column(
                        t, vals[o], count_like=(op == "count"))
                return res
            # ordered global frames (running totals over a total order)
            # gather, as in the JAX package
            route_counts["agg_window_gather"] += 1
            return agg_window(t.gather(), partition_by, order_by, specs,
                              ascending, na_last).shard()
        keep = t.names
        t2 = window_table(t, [(t.names[0], "rowid", None, "__rid")])
        t2 = shuffle_by_key(t2, partition_by)
        exec_order, exec_asc = list(order_by), list(ascending)
        if not exec_order and any(
                op in ("lead", "lag", "first_value", "last_value")
                or frame[0] != "all"
                for op, _, frame, *_ in specs):
            exec_order, exec_asc = ["__rid"], [True]
        out = _agg_window_exec(t2, partition_by, exec_order, specs,
                               tuple(exec_asc), na_last)
        out = sort_table(out, ["__rid"])
        return out.select(keep + [o for *_, o in specs])
    return _agg_window_exec(t, partition_by, order_by, specs,
                            tuple(ascending), na_last)


def _broadcast_scalar_column(t: Table, v, count_like: bool) -> Column:
    """A whole-table scalar broadcast to every row of a (possibly
    sharded) table — the OVER () window result column, filled on the
    table's device."""
    import datetime as _dtmod

    import pandas as pd
    route_counts["agg_window_broadcast"] += 1
    invalid = False
    if count_like:
        fill, dtype = 0 if v is None else int(v), dt.INT64
    elif v is None or (isinstance(v, float) and np.isnan(v)) or v is pd.NaT:
        fill, dtype, invalid = 0.0, dt.FLOAT64, True
    elif isinstance(v, pd.Timestamp):
        fill, dtype = v.value, dt.DATETIME
    elif isinstance(v, (pd.Timedelta, np.timedelta64)):
        fill, dtype = pd.Timedelta(v).value, dt.TIMEDELTA
    elif isinstance(v, (_dtmod.date, np.datetime64)) and \
            not isinstance(v, _dtmod.datetime):
        fill = int((np.datetime64(v, "D") - np.datetime64(0, "D"))
                   .astype(int))
        dtype = dt.DATE
    elif isinstance(v, (bool, np.bool_)):
        fill, dtype = bool(v), dt.BOOL
    elif isinstance(v, (int, np.integer)):
        fill, dtype = int(v), dt.INT64
    else:
        fill, dtype = float(v), dt.FLOAT64
    data = torch.full((t.capacity,), fill, dtype=dtype.torch,
                      device=t.device)
    valid = torch.zeros(t.capacity, dtype=torch.bool, device=t.device) \
        if invalid else None
    return Column(data, valid, dtype, None)


def _agg_window_exec(t: Table, partition_by, order_by, specs,
                     ascending: Tuple[bool, ...], na_last: bool) -> Table:
    """The sorted pass (W.agg_window_local) on a REP table, or on each
    shard of a 1D table whose partitions are colocated. The gather ops
    keep the source column's dtype and dictionary; the others take the
    groupby aggregations' output dtypes (`_agg_out_col`; sum0 as sum)."""
    from bodo_tpu_torch.ops.window import agg_window_local
    route_counts["agg_window_shuffle" if t.distribution == ONED
                 else "agg_window_local"] += 1
    val_cols = list(dict.fromkeys(c for _, c, *_ in specs))
    vidx = {c: i for i, c in enumerate(val_cols)}
    kspecs = tuple((op, vidx[c], tuple(frame), int(param or 0))
                   for op, c, frame, param, _ in specs)
    parts = _per_block(t, lambda i, arrays, count: agg_window_local(
        arrays(i, partition_by), arrays(i, order_by), arrays(i, val_cols),
        count, kspecs, ascending, na_last))
    res = t.with_columns(t.columns)
    for j, (op, col, frame, param, oname) in enumerate(specs):
        d = C.concat_shards([p[j][0] for p in parts])
        v = C.concat_shards([p[j][1] for p in parts])
        src = t.column(col)
        if op in ("lead", "lag", "first_value", "last_value"):
            res.columns[oname] = Column(d, v, src.dtype, src.dictionary,
                                        src.vrange)
        else:
            res.columns[oname] = _agg_out_col(
                src, "sum" if op == "sum0" else op, d, v)
    return res


def assign_categorical(t: Table, name: str, code_expr: Expr,
                       categories: Sequence[str]) -> Table:
    """Add a string column from an integer code expression + category list
    (`code_expr` gives indices into `sorted(categories)`)."""
    cats = np.asarray(sorted(categories), dtype=str)
    res = assign_columns(t, {name: code_expr})
    c = res.columns[name]
    res.columns[name] = Column(c.data.to(torch.int32), c.valid, dt.STRING,
                               cats)
    return res


def category_code(categories: Sequence[str], value: str) -> int:
    """Code of `value` in the sorted-category dictionary."""
    return int(np.searchsorted(np.asarray(sorted(categories)), value))


def filter_table(t: Table, predicate: Expr) -> Table:
    """Filter rows; a null predicate counts as False (SQL semantics). A
    1D table's rows are compacted within each shard."""
    mask, mv = eval_expr(predicate, _tree(t), _dicts(t), _schema(t))
    if mv is not None:
        mask = mask & mv
    mask = mask & _padmask(t)
    names = t.names
    flat = []
    for n in names:
        flat.extend((t.columns[n].data, t.columns[n].valid))
    if t.distribution == ONED:
        s = t.num_shards
        masks = C.shard_views(mask, s)
        views = [C.shard_views(a, s) for a in flat]
        parts, counts = [], []
        for i in range(s):
            out_i, cnt_i = K.compact(masks[i], tuple(v[i] for v in views))
            parts.append(out_i)
            counts.append(cnt_i)
        out = [C.concat_shards([p[j] for p in parts])
               for j in range(len(flat))]
        tree = {n: (out[2 * i], out[2 * i + 1]) for i, n in enumerate(names)}
        counts = np.array(counts, dtype=np.int64)
        return _keep_vranges(rebucket(t.with_arrays(
            tree, nrows=int(counts.sum()), counts=counts)), t)
    out, cnt = K.compact(mask, tuple(flat))
    tree = {n: (out[2 * i], out[2 * i + 1]) for i, n in enumerate(names)}
    return _keep_vranges(rebucket(t.with_arrays(tree, nrows=cnt)), t)


# ---------------------------------------------------------------------------
# key ranges and key packing (multi-key -> one int64 when ranges fit)
# ---------------------------------------------------------------------------

def _min_max(t: Table, names: Sequence[str]) -> Dict[str, Optional[tuple]]:
    """Exact (min, max) of each named integer/date column over its valid
    rows, None for a column without one (reduce_table's min and max
    partials, restricted to what the planners ask)."""
    if t.nrows == 0:
        return {k: (0, 0) for k in names}
    padmask = _padmask(t)
    s = t.num_shards
    out = {}
    for k in names:
        c = t.column(k)
        if not int(_reduce_partial("count", c.data, c.valid, padmask,
                                   s).sum()):
            out[k] = None
            continue
        # a shard without a valid row gives the identity, which loses
        lo = C.dist_min(_reduce_partial("min", c.data, c.valid, padmask, s))
        hi = C.dist_max(_reduce_partial("max", c.data, c.valid, padmask, s))
        lo, hi = torch.stack([lo, hi]).tolist()
        out[k] = (int(lo), int(hi))
    return out


def _key_ranges(t: Table, keys: Sequence[str], use_bounds: bool = True):
    """Host-known (lo, hi) range per key column, or None when unpackable.
    Strings use the dictionary size; bools are 0/1; ints/dates use the
    column's host bound (`Column.vrange`) when present, else an exact
    device min/max. Returns (ranges, inexact): `inexact` holds the
    positions served from loose bounds, which `_refine_ranges` may
    replace with exact spans when a gate fails on them."""
    ranges = []
    inexact = set()
    need_reduce = []
    for i, k in enumerate(keys):
        c = t.column(k)
        if c.dtype is dt.STRING:
            ranges.append((0, max(len(c.dictionary) - 1, 0))
                          if c.dictionary is not None else None)
        elif c.dtype.kind == "b":
            ranges.append((0, 1))
        elif c.dtype.kind in ("i", "u") or c.dtype is dt.DATE:
            if use_bounds and c.vrange is not None:
                ranges.append((int(c.vrange[0]), int(c.vrange[1])))
                if not (len(c.vrange) > 2 and c.vrange[2]):
                    inexact.add(i)
            else:
                ranges.append("reduce")
                need_reduce.append(k)
        else:  # floats/datetimes: don't pack
            ranges.append(None)
    if need_reduce:
        stats = _min_max(t, need_reduce)
        it = iter(need_reduce)
        for i, r in enumerate(ranges):
            if r == "reduce":
                ranges[i] = stats[next(it)]
    return ranges, inexact


def _refine_ranges(t: Table, keys: Sequence[str], ranges, inexact):
    """Replace bound-derived entries with exact device-reduced spans."""
    if not inexact:
        return ranges, set()
    exact, _ = _key_ranges(t, [keys[i] for i in sorted(inexact)],
                           use_bounds=False)
    out = list(ranges)
    for i, r in zip(sorted(inexact), exact):
        out[i] = r
    return out, set()


def _pack_plan(t: Table, keys: Sequence[str], max_bits: int = 62,
               ranges=None):
    """Packing layout [(name, lo, bits, shift)] or None. One extra code
    per field is reserved for null keys."""
    if not config.pack_keys or len(keys) < 2:
        return None
    inexact = set()
    if ranges is None:
        ranges, inexact = _key_ranges(t, keys)

    def layout(rs):
        fields = []
        total = 0
        for k, r in zip(keys, rs):
            if r is None:
                return None
            lo, hi = r
            span = hi - lo + 2  # +1 for the null/sentinel code
            bits = max(1, int(span - 1).bit_length())
            fields.append((k, lo, bits))
            total += bits
            if total > max_bits:
                return None
        return fields, total

    got = layout(ranges)
    if got is None and inexact and not any(r is None for r in ranges):
        # loose bounds overflowed the bit budget: retry with exact spans
        ranges, inexact = _refine_ranges(t, keys, ranges, inexact)
        got = layout(ranges)
    if got is None:
        return None
    fields, total = got
    # first key in the TOP bits so packed ascending == lexicographic order
    plan = []
    shift = total
    for k, lo, bits in fields:
        shift -= bits
        plan.append((k, lo, bits, shift))
    return plan


def _pack_keys(t: Table, pack):
    """Packed int64 key + validity (False where any key is null)."""
    packed = torch.zeros(t.capacity, dtype=torch.int64, device=t.device)
    valid = torch.ones(t.capacity, dtype=torch.bool, device=t.device)
    for name, lo, bits, shift in pack:
        c = t.column(name)
        ok = valid.new_ones(t.capacity) if c.valid is None else c.valid
        if c.data.is_floating_point():
            ok = ok & ~torch.isnan(c.data)
        code = (c.data.to(torch.int64) - lo).clamp(0, (1 << bits) - 2)
        packed = packed | (torch.where(ok, code, (1 << bits) - 1) << shift)
        valid = valid & ok
    return packed, valid


def _packed_key_table(t: Table, pack, with_valid: bool = True) -> Table:
    """Add the packed int64 key column '__packed' to `t`. with_valid=True
    attaches the any-key-null mask (groupby dropna); False leaves nulls
    as per-field sentinel codes (na_last order for sorting)."""
    packed, valid = _pack_keys(t, pack)
    cols = dict(t.columns)
    cols["__packed"] = Column(packed, valid if with_valid else None,
                              dt.INT64)
    return Table(cols, t.nrows, t.distribution, t.counts)


# ---------------------------------------------------------------------------
# groupby aggregate
# ---------------------------------------------------------------------------

def _agg_out_col(src: Column, op: str, vd, vv) -> Column:
    rdt = agg_dtype(op, src.dtype)
    if vd.dtype != rdt.torch:
        vd = vd.to(rdt.torch)
    return Column(vd, vv, rdt, src.dictionary if rdt is dt.STRING else None)


def _key_out(src: Column, kd) -> Column:
    """A key column rebuilt from int64 slot/packed codes."""
    if kd.dtype != src.dtype.torch:
        kd = kd.to(src.dtype.torch)
    return Column(kd, None, src.dtype, src.dictionary, src.vrange)


def groupby_agg(t: Table, keys: Sequence[str],
                aggs: Sequence[Tuple[str, str, str]]) -> Table:
    """Group by `keys`; aggs = [(value_col, op, out_name)]. Output sorted
    by keys ascending (pandas sort=True).

    Routes, in the JAX package's order: LISTAGG's host finish; the
    colocated groupby (1D, an aggregation that does not decompose); dense
    slots when every key has a small known range (REP); packed keys when
    they fit 62 bits; the scatter-claim hash groupby (REP); the two-phase
    sharded groupby (1D); the full sort (REP)."""
    keys = list(keys)
    aggs = [(c, _norm_agg(op), o) for c, op, o in aggs]
    if any(op.startswith("listagg") for _, op, _ in aggs):
        return _groupby_agg_with_listagg(t, keys, aggs)
    local = _as_local(t)
    if local is not None:
        return groupby_agg(local, keys, aggs)
    if t.distribution == ONED and any(op not in DECOMPOSE
                                      for _, op, _ in aggs):
        return _groupby_agg_colocated(t, keys, aggs)
    dense_ok = (t.distribution == REP and config.dense_groupby_max_slots > 0
                and not any(op in ("nunique", "mode") or op.startswith("q:")
                            for _, op, _ in aggs))
    want_ranges = bool(keys) and (
        dense_ok or (config.pack_keys and len(keys) >= 2))
    ranges, inexact = _key_ranges(t, keys) if want_ranges else (None, set())

    def _dense_slot_count(rs) -> int:
        n = 1
        for lo, hi in rs:
            n *= int(hi) - int(lo) + 1
            if n > config.dense_groupby_max_slots:
                break
        return n

    def _gate(n_slots) -> bool:
        # dense pays a fixed O(n_slots) cost: only worth it while the
        # slot space is not much larger than the input
        return (0 < n_slots <= config.dense_groupby_max_slots
                and n_slots <= 2 * max(t.nrows, 1))

    if dense_ok and ranges is not None and \
            all(r is not None for r in ranges):
        gate = _gate(_dense_slot_count(ranges))
        if not gate and inexact:
            ranges, inexact = _refine_ranges(t, keys, ranges, inexact)
            gate = _gate(_dense_slot_count(ranges))
        if gate:
            return _groupby_agg_dense(t, keys, list(aggs), ranges)

    pack = _pack_plan(t, keys, 62, ranges=None if inexact else ranges)
    if pack is not None:
        return _groupby_agg_packed(t, keys, list(aggs), pack)
    specs = tuple(op for _, op, _ in aggs)
    arrays = t.arrays(keys) + t.arrays([c for c, _, _ in aggs])
    if t.distribution == ONED:
        return _groupby_agg_sharded(t, keys, aggs, specs)
    if keys and config.hash_groupby and all(op in HASH_OPS for op in specs):
        out_keys, out_vals, ng, unresolved = groupby_local_hashed(
            arrays, t.nrows, specs, t.capacity, len(keys))
        if not unresolved:
            route_counts["groupby_hashed"] += 1
            return _groupby_result(t, keys, aggs, out_keys, out_vals, ng)
    out_keys, out_vals, ng = groupby_local(arrays, t.nrows, specs,
                                           t.capacity, len(keys))
    route_counts["groupby_sort"] += 1
    return _groupby_result(t, keys, aggs, out_keys, out_vals, ng)


def _norm_agg(op: str) -> str:
    """An aggregation's alias as the kernel's op: median and
    quantile_<q> are "q:<q>"."""
    if op == "median":
        return "q:0.5"
    if op.startswith("quantile_"):
        return f"q:{float(op[len('quantile_'):])}"
    return op


def _groupby_agg_with_listagg(t: Table, keys, aggs) -> Table:
    """A groupby with LISTAGG ("listagg[:<sep>]", "listaggd[:<sep>]" for
    DISTINCT; the separator "," by default): the native aggregations run
    first (a `size` placeholder keeps the groups when there is none),
    then each group's strings are joined on the host, where the strings
    live (in their dictionaries), in the rows' order within the group
    (LISTAGG without WITHIN GROUP), nulls skipped, and aligned to the
    native result's groups. A 1D table is gathered; the result is REP."""
    la = [(c, op, o) for c, op, o in aggs if op.startswith("listagg")]
    rest = [(c, op, o) for c, op, o in aggs if not op.startswith("listagg")]
    out = groupby_agg(t, keys, rest or [(keys[0], "size", "__la_size")])
    gout = out.gather() if out.distribution == ONED else out
    okeys = gout.to_pandas()[list(keys)]
    src = t.gather() if t.distribution == ONED else t
    need = list(dict.fromkeys(list(keys) + [c for c, _, _ in la]))
    pdf = src.select(need).to_pandas()
    cols: Dict[str, Column] = dict(gout.columns)
    for c, op, o in la:
        sep = op.split(":", 1)[1] if ":" in op else ","
        dedup = op.startswith("listaggd")

        def _cat(v, s=sep, d=dedup):
            return s.join(str(x) for x in (dict.fromkeys(v) if d else v))
        ser = pdf.dropna(subset=[c]).groupby(keys, sort=False)[c].agg(_cat)
        aligned = okeys.merge(ser.rename(o), left_on=keys,
                              right_index=True, how="left")[o]
        cols[o] = Column.from_numpy(aligned.to_numpy(dtype=object),
                                    capacity=gout.capacity,
                                    device=gout.device)
    ordered = {o: cols[o] for o in list(keys) + [o for _, _, o in aggs]}
    return Table(ordered, gout.nrows, REP, None)


def _groupby_agg_colocated(t: Table, keys, aggs) -> Table:
    """The 1D groupby of aggregations that do not decompose (nunique,
    mode, the quantiles): one hash shuffle by the keys (`shuffle_by_key`,
    the partition_rank kernel) puts each group's rows on one shard, then
    each shard runs the sort groupby over its rows, its groups counted a
    shard. Only the keys and the aggregated columns move, each row once;
    a key that most rows share puts them on one shard."""
    route_counts["groupby_colocated"] += 1
    vals = [c for c, _, _ in aggs]
    t = shrink_to_fit(shuffle_by_key(
        t.select(list(dict.fromkeys(list(keys) + vals))), keys))
    specs = tuple(op for _, op, _ in aggs)
    arrays = t.arrays(keys) + t.arrays(vals)
    pk_parts, pv_parts, ngs = [], [], []
    for i, shard in enumerate(_shard_arrays(arrays, t.num_shards)):
        pk, pv, ng = groupby_local(shard, int(t.counts[i]), specs,
                                   t.shard_capacity, len(keys))
        pk_parts.append(pk)
        pv_parts.append(pv)
        ngs.append(ng)
    counts = np.array(ngs, dtype=np.int64)
    cols: Dict[str, Column] = {}
    for kname, (kd, kv) in zip(keys, _concat_pairs(pk_parts)):
        src = t.column(kname)
        cols[kname] = Column(kd, kv, src.dtype, src.dictionary, src.vrange)
    for (cname, op, oname), (vd, vv) in zip(aggs, _concat_pairs(pv_parts)):
        cols[oname] = _agg_out_col(t.column(cname), op, vd, vv)
    return shrink_to_fit(Table(cols, int(counts.sum()), ONED, counts))


def _groupby_agg_sharded(t: Table, keys, aggs, specs) -> Table:
    """The 1D branch: partial aggregation per shard, a hash shuffle of
    the partials, combine and finalize per shard
    (parallel/shuffle.groupby_sharded)."""
    t = shrink_to_fit(t)
    arrays = t.arrays(keys) + t.arrays([c for c, _, _ in aggs])
    (out_keys, out_vals), counts, _ovf, method = groupby_sharded(
        arrays, t.counts, len(keys), specs)
    route_counts[f"groupby_sharded_{method}"] += 1
    cols: Dict[str, Column] = {}
    for kname, (kd, kv) in zip(keys, out_keys):
        src = t.column(kname)
        cols[kname] = Column(kd, kv, src.dtype, src.dictionary, src.vrange)
    for (cname, op, oname), (vd, vv) in zip(aggs, out_vals):
        cols[oname] = _agg_out_col(t.column(cname), op, vd, vv)
    return shrink_to_fit(Table(cols, int(counts.sum()), ONED, counts))


def _groupby_result(t, keys, aggs, out_keys, out_vals, ng) -> Table:
    cols: Dict[str, Column] = {}
    for kname, (kd, kv) in zip(keys, out_keys):
        src = t.column(kname)
        cols[kname] = Column(kd, kv, src.dtype, src.dictionary, src.vrange)
    for (cname, op, oname), (vd, vv) in zip(aggs, out_vals):
        cols[oname] = _agg_out_col(t.column(cname), op, vd, vv)
    return shrink_to_fit(Table(cols, ng))


def _groupby_agg_packed(t: Table, keys, aggs, pack) -> Table:
    route_counts["groupby_packed"] += 1
    tp = _packed_key_table(t, pack)
    val_cols = list(dict.fromkeys(c for c, _, _ in aggs))
    out = groupby_agg(tp.select(["__packed"] + val_cols), ["__packed"],
                      aggs)
    packed = out.column("__packed").data
    cols: Dict[str, Column] = {}
    for name, lo, bits, shift in pack:
        code = (packed >> shift) & ((1 << bits) - 1)
        cols[name] = _key_out(t.column(name), code + lo)
    for _, _, oname in aggs:
        cols[oname] = out.columns[oname]
    return Table(cols, out.nrows, out.distribution, out.counts)


def _dense_slots(key_arrays, los, sizes, mask, strict_range: bool = False):
    """Mixed-radix dense slot ids shared by the dense groupby and the
    dense-LUT join. Returns (slot int32[cap], live mask): null/NaN keys
    drop out of `mask`; with strict_range, rows whose key falls outside
    [lo, lo+size) (or is a non-integral float) drop too — the probe-side
    policy, where out of range means no match."""
    cap = key_arrays[0][0].shape[0]
    slot = torch.zeros(cap, dtype=torch.int32, device=mask.device)
    for (d, v), lo, size in zip(key_arrays, los, sizes):
        if v is not None:
            mask = mask & v
        if d.is_floating_point():
            mask = mask & ~torch.isnan(d)
            if strict_range:
                mask = mask & (d == torch.floor(d))
        code = d.to(torch.int64) - lo
        if strict_range:
            mask = mask & (code >= 0) & (code < size)
        slot = slot * size + code.clamp(0, size - 1).to(torch.int32)
    return slot, mask


def dense_agg_tail(tree, live, kn, vn, specs, sizes, los, n_slots: int,
                   accumulate: bool):
    """Scatter `live` rows into mixed-radix dense slots, reduce every
    aggregation, decode slot indices back into key columns and compact
    the present slots ascending (slot order == lexicographic key order).
    Returns (out_keys, out_vals, n_groups).

    accumulate=True (the gate `dense_accumulate_ok` passed) reduces every
    aggregation in one f32 `dense_accumulate` over the reference's column
    plan (relational.py:962-995): the present column first, then for each
    count, sum or mean a ones column (its count), followed for a sum or
    mean by its value column; otherwise each aggregation is its own
    segment sum."""
    slot, padmask = _dense_slots([tree[n] for n in kn], los, sizes, live)
    if accumulate:
        cols, oks, plan, voks = [None], [padmask], [], {}
        for c, op in zip(vn, specs):
            if op == "size":
                plan.append(("size", 0, None))  # == the present column
                continue
            d, v = tree[c]
            # one mask per value column, however many aggregations read it
            ok = voks.get(c)
            if ok is None:
                ok = voks[c] = K.value_ok(d, v, padmask)
            cnt_idx = len(cols)
            cols.append(None)
            oks.append(ok)
            s_idx = None
            if op in ("sum", "mean"):
                s_idx = len(cols)
                cols.append(d)
                oks.append(ok)
            plan.append((op, cnt_idx, s_idx))
        sums = CK.dense_accumulate(slot, cols, oks, n_slots)
        present = sums[0] > 0
        outs = [_accumulated(op, sums, cnt_idx, s_idx)
                for op, cnt_idx, s_idx in plan]
    else:
        present = segment_sum(padmask.to(torch.int32), slot, n_slots) > 0
        segs = SortedSegments(slot, n_slots)
        outs = [_segment_agg(op, tree[c][0], tree[c][1], slot, padmask,
                             n_slots, segs)
                for c, op in zip(vn, specs)]
    rem = torch.arange(n_slots, dtype=torch.int32, device=slot.device)
    key_cols = [None] * len(kn)
    for i in range(len(kn) - 1, -1, -1):
        key_cols[i] = (rem % sizes[i]).to(torch.int64) + los[i]
        rem = torch.div(rem, sizes[i], rounding_mode="floor")
    flat = list(key_cols)
    for d, v in outs:
        flat.extend((d, v))
    packed, n_groups = K.compact(present, tuple(flat))
    nk = len(kn)
    out_vals = tuple((packed[nk + 2 * i], packed[nk + 2 * i + 1])
                     for i in range(len(outs)))
    return tuple(packed[:nk]), out_vals, n_groups


def dense_accumulate_ok(capacity: int, val_dtypes, specs) -> bool:
    """The dense groupby's gate of the f32 accumulate (the reference's
    `dense_mxu_ok`, relational.py:1018-1030): sums and means only over
    float columns of 4 bytes or fewer (integer sums stay exact in int64),
    and only while the row capacity keeps counts within f32's exact
    integers (2^24; `present` is a count too)."""
    return (capacity <= (1 << 24)
            and all(op in ("sum", "count", "size", "mean") for op in specs)
            and all(op in ("count", "size")
                    or (d.is_floating_point and d.itemsize <= 4)
                    for d, op in zip(val_dtypes, specs)))


def _groupby_agg_dense(t: Table, keys, aggs, ranges) -> Table:
    """Sort-free dense groupby for small key spaces: when the exact
    product K of the key ranges fits the slot budget, rows scatter into K
    dense slots and every aggregation is one segment pass."""
    route_counts["groupby_dense"] += 1
    sizes = tuple(int(hi) - int(lo) + 1 for lo, hi in ranges)
    los = tuple(int(lo) for lo, _ in ranges)
    n_slots = 1
    for s in sizes:
        n_slots *= s
    specs = tuple(op for _, op, _ in aggs)
    val_names = [c for c, _, _ in aggs]
    # the f32 accumulate (relational.py:1056-1060): the reference takes
    # it on the TPU or in interpret mode, the port always
    accumulate = (n_slots <= CK.MAX_MATMUL_SLOTS and dense_accumulate_ok(
        t.capacity, [t.column(c).data.dtype for c in val_names], specs))
    live = K.row_mask(t.nrows, t.capacity, t.device)
    out_keys, out_vals, ng = dense_agg_tail(_tree(t), live, list(keys),
                                            val_names, specs, sizes, los,
                                            n_slots, accumulate)
    cols: Dict[str, Column] = {}
    for kname, kd in zip(keys, out_keys):
        cols[kname] = _key_out(t.column(kname), kd)
    for (cname, op, oname), (vd, vv) in zip(aggs, out_vals):
        cols[oname] = _agg_out_col(t.column(cname), op, vd, vv)
    return shrink_to_fit(Table(cols, ng))


# ---------------------------------------------------------------------------
# whole-column reductions
# ---------------------------------------------------------------------------

# op -> the per-shard partials its host combine reads
_REDUCE_PARTIALS = {"sum": ("sum",), "sumnull": ("sum", "count"),
                    "count": ("count",), "size": ("size",),
                    "min": ("min", "count"), "max": ("max", "count"),
                    "mean": ("sum", "count"),
                    "var": ("sum", "m2", "count"),
                    "std": ("sum", "m2", "count"),
                    "var0": ("sum", "m2", "count"),
                    "std0": ("sum", "m2", "count"),
                    "prod": ("prod",)}


def _reduce_partial(p: str, d, v, padmask, s: int):
    """One partial of one column per shard: a tensor [s]."""
    ok = K.value_ok(d, v, padmask).reshape(s, -1)
    if p == "count":
        return ok.sum(1)
    if p == "size":
        return padmask.reshape(s, -1).sum(1)
    d = d.reshape(s, -1)
    if p in ("sum", "prod"):
        # exact in the widened source family: f64, or int64 bits that
        # wrap modulo 2^64 (uint64 as the unsigned bits)
        acc = torch.float64 if d.is_floating_point() else \
            dt.TORCH_OF[result_dtype("sum", _np_dtype(d)).name]
        x = _widened(d, acc)
        if p == "sum":
            return _from_bits(torch.where(ok, x, 0).to(x.dtype).sum(1), acc)
        return _from_bits(torch.where(ok, x, 1).to(x.dtype).prod(1), acc)
    if p == "m2":
        # the centered second moment in f64 (Chan-combined on the host)
        x = d.to(torch.float64)
        n = ok.sum(1).clamp(min=1).to(torch.float64)
        mean = torch.where(ok, x, 0.0).sum(1) / n
        dd = torch.where(ok, x - mean[:, None], 0.0)
        return (dd * dd).sum(1)
    # min / max, keeping the source dtype
    w, back = _ordered(d)
    ident = _min_max_ident(p, d)
    w = torch.where(ok, w, torch.full((), ident, dtype=w.dtype,
                                      device=w.device))
    return back(w.amin(1) if p == "min" else w.amax(1))


def reduce_table(t: Table, aggs: Sequence[Tuple[str, str, str]]) -> Dict:
    """Whole-column reductions to host scalars (Series.sum() and the
    like); aggs = [(column, op, out_name)].

    Each shard reduces its rows to partials, which combine on the host
    as the two-phase groupby's do. median and quantile_<q> take a sort
    (`_reduce_quantile`). first, last, skew, kurt, nunique, mode and
    LISTAGG have no scalar partial: they run as a groupby on a constant
    key `__one` (on a 1D table the colocated groupby for the holistic
    ones, which sends every row to one shard). Integer products wrap
    modulo 2^64, as pandas' do (the JAX package takes them in f64)."""
    qaggs = [a for a in aggs if _norm_agg(a[1]).startswith("q:")]
    if qaggs:
        for c, op, _ in qaggs:
            agg_dtype(op, t.column(c).dtype)  # refuses decimals
        rest = [a for a in aggs if a not in qaggs]
        out = reduce_table(t, rest) if rest else {}
        for c, op, o in qaggs:
            out[o] = _reduce_quantile(t, c, float(_norm_agg(op)[2:]))
        return out
    gaggs = [(c, op, o) for c, op, o in aggs if op not in _REDUCE_PARTIALS]
    if gaggs:
        rest = [(c, op, o) for c, op, o in aggs if op in _REDUCE_PARTIALS]
        out = reduce_table(t, rest) if rest else {}
        tk = t.with_columns(t.columns)
        tk.columns["__one"] = Column(
            torch.zeros(t.capacity, dtype=torch.int32, device=t.device),
            None, dt.INT32)
        gp = groupby_agg(tk, ["__one"], gaggs).to_pandas()
        for _, _, o in gaggs:
            out[o] = gp[o].iloc[0] if len(gp) else None
        return out
    for c, op, _ in aggs:
        agg_dtype(op, t.column(c).dtype)  # refuses decimals
    padmask = _padmask(t)
    s = t.num_shards
    out = {}
    for col, op, oname in aggs:
        c = t.column(col)
        block = {p: _reduce_partial(p, c.data, c.valid, padmask, s)
                 .cpu().numpy() for p in _REDUCE_PARTIALS[op]}
        cnt = int(block["count"].sum()) if "count" in block else None
        if op in ("sum", "sumnull"):
            v = block["sum"].sum() if op == "sum" or cnt else np.nan
        elif op == "prod":
            v = np.prod(block["prod"])
        elif op in ("count", "size"):
            v = int(block[op].sum())
        elif op in ("min", "max"):
            if cnt == 0:
                out[oname] = np.nan
                continue
            v = block[op].min() if op == "min" else block[op].max()
        elif op == "mean":
            v = float(block["sum"].sum()) / cnt if cnt else np.nan
        else:  # var, std, var0, std0
            ddof = 0 if op.endswith("0") else 1
            if cnt > ddof:
                # the exact delta-form Chan combine of per-shard moments
                n_i = block["count"].astype(np.float64)
                s_i = block["sum"].astype(np.float64)
                mean_i = s_i / np.maximum(n_i, 1)
                m2 = block["m2"].sum() + \
                    (n_i * (mean_i - s_i.sum() / cnt) ** 2).sum()
                v = max(m2 / (cnt - ddof), 0.0)
                if op.startswith("std"):
                    v = float(np.sqrt(v))
            else:
                v = np.nan
        out[oname] = _reduce_scalar(v, op, c.dtype)
    return out


def _reduce_quantile(t: Table, col: str, q: float) -> float:
    """Linearly interpolated quantile of a whole column (pandas'
    interpolation='linear'). A 1D table's column is gathered. The values
    are sorted with the rows that are not ok (nulls, NaN, padding) last,
    as +inf: the first `n` sorted are the n ok values in order whatever
    they hold. Only the one or two values at (n - 1) * q come back to the
    host, which interpolates. A decimal column never reaches it:
    reduce_table refuses it first (agg_dtype)."""
    src = t.select([col])
    if src.distribution == ONED:
        src = src.gather()
    c = src.column(col)
    ok = K.value_ok(c.data, c.valid, K.row_mask(src.nrows, c.capacity,
                                                src.device))
    n = int(ok.sum())
    if n == 0:
        return float("nan")
    s_val = torch.sort(torch.where(ok, c.data.to(torch.float64),
                                   float("inf"))).values
    qpos = (n - 1) * q
    lo, hi = int(np.floor(qpos)), int(np.ceil(qpos))
    vals = s_val[lo:hi + 1].cpu().numpy()
    return float(vals[0]) if lo == hi else \
        float(vals[0] + (vals[1] - vals[0]) * (qpos - lo))


def _reduce_scalar(v, op: str, src: dt.DType):
    """A host reduction result as its logical scalar type."""
    import pandas as pd
    if op in ("count", "size"):
        return int(v)
    if op in ("min", "max"):
        if src is dt.DATETIME:
            return pd.Timestamp(int(v))
        if src is dt.TIMEDELTA:
            return pd.Timedelta(int(v))
        if src is dt.DATE:
            return (np.datetime64(0, "D") + int(v)).astype("datetime64[D]")
        if src.kind in ("i", "u"):
            return int(v)
        if src.kind == "b":
            return bool(v)
        return float(v)
    if op in ("sum", "sumnull", "prod") and src.kind in ("i", "u", "b"):
        return int(v) if not (isinstance(v, float) and np.isnan(v)) else v
    return float(v)


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------

def sort_table(t: Table, by: Sequence[str], ascending=None,
               na_last: bool = True) -> Table:
    """Stable multi-key sort; a 1D table takes the sample sort (each shard
    sorted, shard i's rows all before shard i+1's)."""
    by = list(by)
    local = _as_local(t)
    if local is not None:
        return sort_table(local, by, ascending, na_last)
    if ascending is None:
        ascending = [True] * len(by)
    elif isinstance(ascending, bool):
        ascending = [ascending] * len(by)
    # packed path: all-ascending small-range keys sort by one int64
    if all(ascending) and na_last and len(by) > 1:
        pack = _pack_plan(t, by, 62)
        if pack is not None:
            tp = _packed_key_table(t, pack, with_valid=False)
            res = sort_table(tp, ["__packed"], [True], na_last)
            return _keep_vranges(res.select(t.names), t)
    order = by + [n for n in t.names if n not in by]
    if t.distribution == ONED:
        t = shrink_to_fit(t)
        out, counts = sort_sharded(t.arrays(order), t.counts, len(by),
                                   tuple(ascending), na_last)
        route_counts["sort_sharded"] += 1
        res = shrink_to_fit(t.with_arrays(
            {n: out[i] for i, n in enumerate(order)},
            nrows=int(counts.sum()), counts=counts))
        return _keep_vranges(res.select(t.names), t)
    out, _ = sort_local(t.arrays(order), t.nrows, len(by), tuple(ascending),
                        na_last)
    route_counts["sort_local"] += 1
    res = t.with_arrays({n: out[i] for i, n in enumerate(order)},
                        nrows=t.nrows)
    return _keep_vranges(res.select(t.names), t)


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------

def _suffix_columns(left: Table, right: Table, left_on, right_on,
                    suffixes) -> Tuple[Dict[str, str], Dict[str, str]]:
    overlap = (set(left.names) & set(right.names)) - \
        (set(left_on) & set(right_on))
    lmap = {n: (n + suffixes[0] if n in overlap else n) for n in left.names}
    rmap = {n: (n + suffixes[1] if n in overlap else n) for n in right.names
            if not (n in right_on and left_on[right_on.index(n)] == n)}
    return lmap, rmap


def join_tables(left: Table, right: Table, left_on: Sequence[str],
                right_on: Sequence[str], how: str = "inner",
                suffixes=("_x", "_y"), null_equal: bool = True) -> Table:
    """Equi-join (pandas merge analogue); the build side is `right`.
    how: inner / left / right / outer. null_equal=True gives pandas merge
    semantics (null keys match each other); SQL passes False (null keys
    never match). how="cross" is the Cartesian product (the keys are
    ignored). Routes, in the JAX package's order: for two REP tables
    the dense-LUT join, the hash join, the sort join `_join_rep`; for a 1D
    probe side the broadcast join (a REP or small build side), the skew
    split or the shuffle join, with the decisions of plan/adaptive.py."""
    left_on, right_on = list(left_on), list(right_on)
    if how not in ("inner", "left", "right", "outer", "cross"):
        raise ValueError(f"join how={how!r} not supported")
    if how == "cross":
        return _cross_join(left, right, suffixes)
    if not left_on:
        raise ValueError(f"a {how} join needs join keys; a join without "
                         f"keys is how='cross'")
    if how == "right":
        # right join = left join with the sides swapped; restore the
        # pandas column order (left's columns first) afterwards
        out = join_tables(right, left, right_on, left_on, "left",
                          (suffixes[1], suffixes[0]), null_equal)
        lmap, rmap = _suffix_columns(left, right, left_on, right_on,
                                     suffixes)
        names = [lmap[n] for n in left.names if lmap[n] in out.columns]
        names += [rmap[n] for n in right.names
                  if n in rmap and rmap[n] in out.columns]
        return out.select(list(dict.fromkeys(names)))

    # unify the dictionaries of string keys so codes compare, and align
    # numeric key dtypes so hashing and comparison agree across sides
    left = left.with_columns(left.columns)
    right = right.with_columns(right.columns)
    for lk, rk in zip(left_on, right_on):
        lc, rc = left.columns[lk], right.columns[rk]
        if lc.dtype is dt.STRING or rc.dtype is dt.STRING:
            _, (nl, nr) = unify_dictionaries([lc, rc])
            left.columns[lk] = nl
            right.columns[rk] = nr
        elif lc.dtype is not rc.dtype and dt.is_numeric(lc.dtype) and \
                dt.is_numeric(rc.dtype):
            common = dt.common_numeric(lc.dtype, rc.dtype)
            # refuse lossy key casts: 64-bit integers promoted to float64
            # collapse distinct keys above 2**53
            for side in (lc, rc):
                if (side.dtype.numpy.kind in "iu"
                        and side.dtype.numpy.itemsize == 8
                        and common.numpy.kind == "f"):
                    raise NotImplementedError(
                        f"join on {lc.dtype.name} vs {rc.dtype.name} keys "
                        f"would promote a 64-bit integer key to float64, "
                        f"which is lossy above 2**53; cast one side "
                        f"explicitly to a common exact type first")
            if lc.dtype is not common:
                left.columns[lk] = Column(lc.data.to(common.torch),
                                          lc.valid, common)
            if rc.dtype is not common:
                right.columns[rk] = Column(rc.data.to(common.torch),
                                           rc.valid, common)

    ll, rl = _as_local(left), _as_local(right)
    if ll is not None:
        left = ll
    if rl is not None:
        right = rl
    if left.distribution == REP and right.distribution == ONED:
        left = left.shard()
    if left.distribution == REP and right.distribution == REP:
        out = _join_dense_try(left, right, left_on, right_on, how, suffixes,
                              null_equal)
        if out is not None:
            return out
        out = _join_hash_try(left, right, left_on, right_on, how, suffixes,
                             null_equal)
        if out is not None:
            return out
    from bodo_tpu_torch.plan import adaptive
    if how == "outer" and left.distribution == ONED and \
            right.distribution == REP:
        # a replicated build side would emit its unmatched rows once per
        # shard; shard it so every build row is owned by one shard
        right = right.shard()
    if left.distribution == ONED and right.distribution == REP and \
            adaptive.should_demote_broadcast(right):
        right = right.shard()
    if how != "outer" and left.distribution == ONED and \
            right.distribution == ONED and \
            adaptive.join_broadcast_decision(right, left):
        # a small build side is replicated instead of shuffling both
        right = right.gather()
    elif how == "inner" and left.distribution == ONED and \
            right.distribution == ONED and \
            adaptive.join_broadcast_decision(left, right):
        # a small left side: swap (inner joins are symmetric), broadcast
        # it, and restore the left-then-right column order
        out = join_tables(right, left, right_on, left_on, "inner",
                          (suffixes[1], suffixes[0]), null_equal)
        lmap, rmap = _suffix_columns(left, right, left_on, right_on,
                                     suffixes)
        names = [lmap[n] for n in left.names] + \
            [rmap[n] for n in right.names if n in rmap]
        return out.select([n for n in names if n in out.columns])
    if left.distribution == ONED and right.distribution == ONED:
        out = adaptive.try_skew_split_join(left, right, left_on, right_on,
                                           how, suffixes, null_equal)
        if out is not None:
            return out
        return _join_sharded(left, right, left_on, right_on, how, suffixes,
                             null_equal=null_equal)
    if left.distribution == ONED and right.distribution == REP:
        return _join_broadcast(left, right, left_on, right_on, how,
                               suffixes, null_equal)
    return _join_rep(left, right, left_on, right_on, how, suffixes,
                     null_equal)


def _join_dense_try(left, right, left_on, right_on, how, suffixes,
                    null_equal: bool = True) -> Optional[Table]:
    """Dense-LUT equi-join: when the build (right) side's keys have a
    small host-known range and are unique, the join is a perfect-hash
    lookup — the build scatters row indices into a dense LUT, the probe
    gathers through the `lut_gather` CUDA kernel, at every LUT size the
    gate admits. Output capacity == probe capacity. Returns None when
    not applicable."""
    if how not in ("inner", "left") or right.nrows == 0 or \
            config.dense_join_max_slots <= 0:
        return None
    if null_equal and \
            any(left.column(k).valid is not None for k in left_on) and \
            any(right.column(k).valid is not None for k in right_on):
        # dense slots drop null keys; under pandas null-match semantics a
        # null-null pair would be missed when both sides hold nulls
        return None
    ranges, inexact = _key_ranges(right, right_on)
    if any(r is None for r in ranges):
        return None

    def _slots(rs) -> int:
        n = 1
        for lo, hi in rs:
            n *= int(hi) - int(lo) + 1
            if n > config.dense_join_max_slots:
                break
        return n

    def _ok(n) -> bool:
        return (n <= config.dense_join_max_slots and
                n <= 16 * right.nrows + 1024)

    n_slots = _slots(ranges)
    if not _ok(n_slots) and inexact:
        ranges, inexact = _refine_ranges(right, right_on, ranges, inexact)
        n_slots = _slots(ranges)
    if not _ok(n_slots):
        return None  # too large or too sparse: LUT cost would dominate
    sizes = tuple(int(hi) - int(lo) + 1 for lo, hi in ranges)
    los = tuple(int(lo) for lo, _ in ranges)
    lorder, rorder, pa, ba = _probe_build_arrays(left, right, left_on,
                                                 right_on)
    nk = len(left_on)
    dev = right.device

    # build: scatter build row indices into the LUT
    bmask = K.row_mask(right.nrows, right.capacity, dev)
    slot, bmask = _dense_slots(ba[:nk], los, sizes, bmask)
    if bool((segment_sum(bmask.to(torch.int32), slot, n_slots) > 1).any()):
        return None  # duplicate build keys: not a perfect hash
    lut = torch.full((n_slots + 1,), -1, dtype=torch.int32, device=dev)
    lut[torch.where(bmask, slot, n_slots).to(torch.int64)] = torch.arange(
        right.capacity, dtype=torch.int32, device=dev)
    lut = lut[:n_slots]

    # probe
    pslot, live = _dense_slots(pa[:nk], los, sizes,
                               K.row_mask(left.nrows, left.capacity, dev),
                               strict_range=True)
    idx = torch.where(live, CK.lut_gather(pslot, lut), -1)
    out_p, out_b, nrows = _gather_probe_matches(pa, ba, idx, how,
                                                left.nrows)
    res = _assemble_join(left, right, left_on, right_on, lorder, rorder,
                         out_p, out_b, nrows, how, suffixes)
    route_counts["join_dense"] += 1
    return rebucket(res)


def _gather_probe_matches(pa, ba, idx, how: str, pcount: int):
    """Join output of a unique-build-key probe: `idx` holds each probe
    row's build row, or -1. Inner keeps the matched probe rows (stable
    compaction); left keeps every probe row, with the build columns
    invalid where nothing matched. Returns (out_p, out_b, nrows)."""
    hit = idx >= 0
    safe = idx.clamp(min=0).to(torch.int64)
    out_b = [(d[safe], hit if v is None else (hit & v[safe])) for d, v in ba]
    if how != "inner":
        return list(pa), out_b, pcount
    flat = []
    for d, v in tuple(pa) + tuple(out_b):
        flat.extend((d, v))
    packed, nrows = K.compact(hit, tuple(flat))
    pairs = [(packed[2 * i], packed[2 * i + 1])
             for i in range(len(flat) // 2)]
    return pairs[:len(pa)], pairs[len(pa):], nrows


def _join_hash_try(left, right, left_on, right_on, how, suffixes,
                   null_equal: bool = True) -> Optional[Table]:
    """Hash-LUT equi-join: the dense-LUT join freed from its key-range
    gate. The build side claims slots in a scatter-claim hash table
    (ops/hashtable.py) — its owner array is the LUT — and probe rows
    follow the same double-hash sequence to a match or an empty slot
    (`probe_slots`, the `hash_probe` CUDA kernel). Unique build keys
    give at most one match per probe row, so the output keeps the probe
    side's capacity. Returns None on duplicate build keys or probe-round
    exhaustion (the caller goes on to the sort join).

    The JAX package's `config.fusion_join` branch runs the same claim
    behind a device-resident build cache; the port builds every time."""
    if how not in ("inner", "left") or right.nrows == 0 or \
            not config.hash_join:
        return None
    lorder, rorder, pa, ba = _probe_build_arrays(left, right, left_on,
                                                 right_on)
    nk = len(left_on)
    dev = right.device
    T = HT.table_size(right.capacity)
    # an all-True null-column layout is always legal (a side without
    # nulls gets a zero null code column), and it does not depend on the
    # probe side
    null_cols = (True,) * nk

    bcodes, null_ok = HT.encode_columns_aligned(ba[:nk], null_cols,
                                                null_equal)
    ok = K.row_mask(right.nrows, right.capacity, dev)
    if null_ok is not None:
        ok = ok & null_ok
    slot, owner, _r, unresolved = HT.claim_slots(bcodes, ok, T)
    if unresolved or bool((segment_sum(torch.ones_like(slot), slot, T)
                           > 1).any()):
        return None  # duplicate build keys (or pathological probing)

    pcodes, pnull_ok = HT.encode_columns_aligned(pa[:nk], null_cols,
                                                 null_equal)
    live = K.row_mask(left.nrows, left.capacity, dev)
    if pnull_ok is not None:
        live = live & pnull_ok
    idx, p_unres = HT.probe_slots(bcodes, owner, pcodes, live, T)
    if bool(p_unres):
        return None
    out_p, out_b, nrows = _gather_probe_matches(pa, ba, idx, how,
                                                left.nrows)
    res = _assemble_join(left, right, left_on, right_on, lorder, rorder,
                         out_p, out_b, nrows, how, suffixes)
    route_counts["join_hash"] += 1
    return rebucket(res)


def _probe_build_arrays(left, right, left_on, right_on):
    lorder = left_on + [n for n in left.names if n not in left_on]
    rorder = right_on + [n for n in right.names if n not in right_on]
    return lorder, rorder, left.arrays(lorder), right.arrays(rorder)


def _assemble_join(left, right, left_on, right_on, lorder, rorder,
                   out_p, out_b, nrows, how, suffixes, counts=None) -> Table:
    lmap, rmap = _suffix_columns(left, right, left_on, right_on, suffixes)
    cols: Dict[str, Column] = {}
    # full outer with a merged key column (same name both sides): pandas
    # fills the key from the right side on build-only appended rows
    merged_keys = {}
    if how == "outer":
        for i, (ln, rn) in enumerate(zip(left_on, right_on)):
            if ln == rn:
                merged_keys[ln] = i
    for i, n in enumerate(lorder):
        src = left.column(n)
        d, v = out_p[i]
        vr = src.vrange
        if n in merged_keys:
            ki = merged_keys[n]
            bd, bv = out_b[ki]
            d = torch.where(v, d, bd.to(d.dtype))
            v = v | bv
            # the merged column carries right-side values on build-only
            # rows, so its bound is the union of both sides' (None if
            # either side is unbounded)
            rvr = right.column(right_on[ki]).vrange
            if vr is not None and rvr is not None:
                tight = (len(vr) > 2 and vr[2]) and (len(rvr) > 2
                                                     and rvr[2])
                vr = (min(vr[0], rvr[0]), max(vr[1], rvr[1]), tight)
            else:
                vr = None
        cols[lmap[n]] = Column(d, v, src.dtype, src.dictionary, vr)
    for i, n in enumerate(rorder):
        if n not in rmap:
            continue
        src = right.column(n)
        d, v = out_b[i]
        cols[rmap[n]] = Column(d, v, src.dtype, src.dictionary, src.vrange)
    # pandas column order: left columns, then right columns
    names: List[str] = [lmap[n] for n in left.names] + \
        [rmap[n] for n in right.names if n in rmap]
    if counts is None:
        return Table(cols, nrows).select(names)
    return Table(cols, nrows, ONED, counts).select(names)


def _join_rep(left, right, left_on, right_on, how, suffixes,
              null_equal: bool = True) -> Table:
    """The sort join (ops/join.py) of two replicated tables: gids by the
    hash table (config.hash_join) or by the union sort, then the per-gid
    expansion. A hash run whose probe hits its round cap is re-run by
    sort; an output that overflows its capacity is re-run at the exact
    size from join_count."""
    lorder, rorder, pa, ba = _probe_build_arrays(left, right, left_on,
                                                 right_on)
    nk = len(left_on)
    out_cap = round_capacity(max(left.nrows, right.nrows, 1))
    method = "hash" if config.hash_join else "sort"
    for _ in range(4):
        out_p, out_b, cnt, ovf, unres = join_local(
            pa, ba, left.nrows, right.nrows, nk, how, out_cap, null_equal,
            method)
        if method == "hash" and bool(unres):
            method = "sort"  # pathological probe chains: sort safety net
            continue
        if not ovf:
            break
        total, _ = join_count(pa[:nk], ba[:nk], left.nrows, right.nrows,
                              nk, how, null_equal, method)
        out_cap = round_capacity(total)
    route_counts[f"join_rep_{method}"] += 1
    return _assemble_join(left, right, left_on, right_on, lorder, rorder,
                          out_p, out_b, cnt, how, suffixes)


# ---------------------------------------------------------------------------
# 1D joins and the key shuffle
# ---------------------------------------------------------------------------

def _join_shards(pa, ba, pcounts, bcounts, nk: int, how: str, out_cap: int,
                 broadcast: bool, null_equal: bool, method: str,
                 num_shards: int):
    """join_local on every shard: probe shard i against build shard i, or
    against the whole replicated build side (`broadcast`). Returns
    (probe columns, build columns, rows per shard, overflow per shard,
    unresolved per shard)."""
    probes = _shard_arrays(pa, num_shards)
    builds = [ba] * num_shards if broadcast else \
        _shard_arrays(ba, num_shards)
    outs_p, outs_b, cnts, ovfs, unres = [], [], [], [], []
    for i in range(num_shards):
        out_p, out_b, cnt, ovf, un = join_local(
            probes[i], builds[i], int(pcounts[i]), int(bcounts[i]), nk, how,
            out_cap, null_equal, method)
        outs_p.append(out_p)
        outs_b.append(out_b)
        cnts.append(cnt)
        ovfs.append(ovf)
        unres.append(un)
    return (_concat_pairs(outs_p), _concat_pairs(outs_b),
            np.array(cnts, dtype=np.int64), np.array(ovfs, dtype=bool),
            bool(torch.stack(unres).any()))


def _join_sharded(left, right, left_on, right_on, how, suffixes,
                  broadcast: bool = False, null_equal: bool = True,
                  pre_shuffled: bool = False) -> Table:
    """Join of co-located shards: equal keys are brought to one shard by
    `shuffle_by_key` on both sides, or the build side is replicated
    (`broadcast`). Each shard runs join_local (hash gids unless
    config.hash_join is off). The output capacity starts at about one
    match per probe row; on overflow the exact per-shard counts size one
    last run."""
    s = mesh_mod.num_shards()
    if not broadcast and not pre_shuffled:
        left = shuffle_by_key(left, left_on)
        right = shuffle_by_key(right, right_on)
    left = shrink_to_fit(left)
    lorder, rorder, pa, ba = _probe_build_arrays(left, right, left_on,
                                                 right_on)
    nk = len(left_on)
    out_cap = round_capacity(2 * left.shard_capacity)
    bcounts = [right.nrows] * s if broadcast else right.counts
    method = "hash" if config.hash_join else "sort"
    for _ in range(4):
        out_p, out_b, counts, ovf, unres = _join_shards(
            pa, ba, left.counts, bcounts, nk, how, out_cap, broadcast,
            null_equal, method, s)
        if method == "hash" and unres:
            method = "sort"  # pathological probe chains on some shard
            continue
        if not ovf.any():
            break
        # exact per-shard counts, then one final right-sized run
        probes = _shard_arrays(pa[:nk], s)
        builds = [ba[:nk]] * s if broadcast else _shard_arrays(ba[:nk], s)
        exact = [join_count(probes[i], builds[i], int(left.counts[i]),
                            int(bcounts[i]), nk, how, null_equal,
                            method)[0] for i in range(s)]
        out_cap = round_capacity(int(max(exact)))
    else:
        raise RuntimeError("join output overflow after exact-count retry")
    route_counts["join_broadcast" if broadcast else "join_shuffle"] += 1
    res = _assemble_join(left, right, left_on, right_on, lorder, rorder,
                         out_p, out_b, int(counts.sum()), how, suffixes,
                         counts)
    return shrink_to_fit(res)


def _join_broadcast(left, right, left_on, right_on, how, suffixes,
                    null_equal: bool = True) -> Table:
    """A 1D probe side against a replicated build side: every shard joins
    its rows against the whole build side, nothing is shuffled."""
    return _join_sharded(left, right, left_on, right_on, how, suffixes,
                         broadcast=True, null_equal=null_equal)


def _cross_join(left, right, suffixes) -> Table:
    """Cartesian product (merge how='cross'), in pandas' row order:
    probe-major, each left row paired with every right row in order. A
    1D left side keeps its shards, and every shard pairs its rows with
    the whole right side (replicated: a 1D right side is gathered);
    since the shards' rows are in order, so is the product. A REP left
    side against a 1D right side gathers the right side. The output size
    is known on the host (the rows of a shard x the right side's), so
    the capacity is exact and there is no overflow retry."""
    ll, rl = _as_local(left), _as_local(right)
    if ll is not None:
        left = ll
    if rl is not None:
        right = rl
    if right.distribution == ONED:
        right = right.gather()
    route_counts["join_cross"] += 1
    if left.distribution == ONED:
        left = shrink_to_fit(left)
        lorder, rorder, pa, ba = _probe_build_arrays(left, right, [], [])
        s = left.num_shards
        percap = int(left.counts.max(initial=0))
        out_cap = round_capacity(max(percap * max(right.nrows, 1), 1))
        outs_p, outs_b, cnts = [], [], []
        for i, probe in enumerate(_shard_arrays(pa, s)):
            out_p, out_b, cnt = cross_local(probe, ba, int(left.counts[i]),
                                            right.nrows, out_cap)
            outs_p.append(out_p)
            outs_b.append(out_b)
            cnts.append(cnt)
        counts = np.array(cnts, dtype=np.int64)
        res = _assemble_join(left, right, [], [], lorder, rorder,
                             _concat_pairs(outs_p), _concat_pairs(outs_b),
                             int(counts.sum()), "cross", suffixes, counts)
        return shrink_to_fit(res)
    lorder, rorder, pa, ba = _probe_build_arrays(left, right, [], [])
    out_cap = round_capacity(max(left.nrows * right.nrows, 1))
    out_p, out_b, cnt = cross_local(pa, ba, left.nrows, right.nrows,
                                    out_cap)
    return _assemble_join(left, right, [], [], lorder, rorder, out_p, out_b,
                          cnt, "cross", suffixes)


def shuffle_by_key(t: Table, key_cols: Sequence[str]) -> Table:
    """Hash-partition the rows of a 1D table over its shards by key
    columns: rows with equal keys land on the same shard. The send
    buckets take a whole shard, so the shuffle never overflows."""
    if t.distribution != ONED:
        raise ValueError("shuffle_by_key needs a row-sharded (1D) table; "
                         "shard the table first")
    s = t.num_shards
    names = t.names
    nk = len(key_cols)
    korder = list(key_cols) + [n for n in names if n not in key_cols]
    karrays = t.arrays(korder)
    dest = dest_shard(hash_columns(karrays[:nk]), s)
    flat, slots = _flatten_with_valids(karrays)
    out, counts, _ = shuffle_rows(dest, flat, t.counts, s, t.shard_capacity)
    rebuilt = _rebuild_from_flat(out, slots)
    res = t.with_arrays({n: rebuilt[i] for i, n in enumerate(korder)},
                        nrows=int(counts.sum()), counts=counts)
    return _keep_vranges(shrink_to_fit(res.select(names)), t)


def shard_frames(t: Table) -> List:
    """Each shard of a 1D table decoded into its own pandas frame (the
    frame one worker holds after a shuffle; groupby.apply runs its
    function on each). A replicated table is one frame."""
    if t.distribution != ONED:
        return [t.to_pandas()]
    per = t.shard_capacity
    out = []
    for s in range(t.num_shards):
        sl = slice(s * per, (s + 1) * per)
        cols = {n: Column(c.data[sl],
                          None if c.valid is None else c.valid[sl],
                          c.dtype, c.dictionary)
                for n, c in t.columns.items()}
        out.append(Table(cols, int(t.counts[s]), REP, None).to_pandas())
    return out


def concat_tables(tables: Sequence[Table]) -> Table:
    """Row-wise concatenation (UNION ALL) into a replicated table: 1D
    inputs are gathered. Inputs share the column names (the first
    table's order); string dictionaries are unified; numeric dtypes
    promote by np.result_type; decimals of one scale keep it, at the
    largest precision, and any other mix with a decimal is descaled to
    float64; validity is merged, all-valid for an input without a mask.
    Columns of one datetime, timedelta or date type keep it, where the
    JAX package relabels their physical integers (ROADMAP F9)."""
    if not tables:
        raise ValueError("concat_tables needs at least one table")
    route_counts["concat_tables"] += 1
    names = tables[0].names
    parts = [t.gather() if t.distribution == ONED else t for t in tables]
    total = sum(t.nrows for t in parts)
    cap = round_capacity(max(total, 1))
    dev = parts[0].device
    cols: Dict[str, Column] = {}
    for n in names:
        src_cols = [t.columns[n] for t in parts]
        dictionary = None
        if any(c.dtype is dt.STRING for c in src_cols):
            dictionary, src_cols = unify_dictionaries(src_cols)
            out_dtype = dt.STRING
        elif any(dt.is_decimal(c.dtype) for c in src_cols):
            scales = {c.dtype.scale for c in src_cols
                      if dt.is_decimal(c.dtype)}
            if len(scales) == 1 and all(dt.is_decimal(c.dtype)
                                        for c in src_cols):
                out_dtype = dt.decimal(
                    scales.pop(),
                    precision=max(c.dtype.precision for c in src_cols))
            else:  # mixed scales, or a decimal beside another type
                out_dtype = dt.FLOAT64
                # the divisor as a device tensor: CUDA divides by a host
                # scalar as a product with its reciprocal, one ulp off
                # the quotient the CPU gives
                src_cols = [
                    Column(c.data.to(torch.float64) / torch.tensor(
                        10.0 ** c.dtype.scale, dtype=torch.float64,
                        device=dev), c.valid, dt.FLOAT64)
                    if dt.is_decimal(c.dtype) else c for c in src_cols]
        elif src_cols[0].dtype.kind in ("dt", "td", "date") and all(
                c.dtype is src_cols[0].dtype for c in src_cols):
            out_dtype = src_cols[0].dtype
        else:
            out_dtype = dt.from_numpy(np.result_type(
                *[c.dtype.numpy for c in src_cols]))
        any_valid = any(c.valid is not None for c in src_cols)
        data = torch.zeros(cap, dtype=out_dtype.torch, device=dev)
        valid = (torch.zeros(cap, dtype=torch.bool, device=dev)
                 if any_valid else None)
        at = 0
        for t, c in zip(parts, src_cols):
            data[at:at + t.nrows] = c.data[:t.nrows].to(out_dtype.torch)
            if any_valid:
                valid[at:at + t.nrows] = (True if c.valid is None
                                          else c.valid[:t.nrows])
            at += t.nrows
        cols[n] = Column(data, valid, out_dtype, dictionary)
    return Table(cols, total)
