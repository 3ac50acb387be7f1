"""Table-level relational operators on one device.

Counterpart of bodo_tpu/relational.py for replicated (REP) tables on one
device: projection (`assign_columns`), `filter_table`, the dense-LUT
equi-join, the dense / packed / hashed / sort groupby routes and
`sort_table`. The gates are the JAX package's, checked in the same
order, so both packages take the same route on the same data.

Where the JAX package would go on to a route this slice has not ported
(the hash join `_join_hash_try`, the sort join, right/outer/cross joins,
row-sharded 1D tables) the port raises NotImplementedError naming it.

`route_counts` counts the routes taken, so tests and the chip smoke can
show which one ran.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bodo_tpu_torch.config import config
from bodo_tpu_torch.ops import cuda_kernels as CK
from bodo_tpu_torch.ops import kernels as K
from bodo_tpu_torch.ops.groupby import (HASH_OPS, _segment_agg, agg_dtype,
                                        groupby_local, groupby_local_hashed,
                                        segment_sum)
from bodo_tpu_torch.ops.sort import sort_local
from bodo_tpu_torch.plan.expr import (ColRef, Expr, eval_expr, expr_range,
                                      infer_dtype)
from bodo_tpu_torch.table import dtypes as dt
from bodo_tpu_torch.table.table import Column, Table, round_capacity

# shrink a table's capacity when occupancy falls below this (the JAX
# package's default config.rebucket_threshold)
REBUCKET_THRESHOLD = 0.45

# route name -> times taken since the last reset_route_counts()
route_counts: Dict[str, int] = {
    "join_dense": 0, "groupby_dense": 0, "groupby_packed": 0,
    "groupby_hashed": 0, "groupby_sort": 0, "sort_local": 0,
}


def reset_route_counts() -> None:
    for k in route_counts:
        route_counts[k] = 0


def _schema(t: Table) -> Dict[str, dt.DType]:
    return {n: c.dtype for n, c in t.columns.items()}


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
    front). The slices are copied so the old buffers are freed."""
    new = round_capacity(max(t.nrows, 1))
    if new >= t.capacity:
        return t
    tree = {n: (c.data[:new].clone(),
                None if c.valid is None else c.valid[:new].clone())
            for n, c in t.columns.items()}
    return t.with_arrays(tree, nrows=t.nrows)


def rebucket(t: Table) -> Table:
    """Shrink the capacity when occupancy drops below the threshold."""
    if max(t.nrows, 1) / t.capacity >= REBUCKET_THRESHOLD:
        return t
    return shrink_to_fit(t)


# ---------------------------------------------------------------------------
# projection / assignment / filter
# ---------------------------------------------------------------------------

def assign_columns(t: Table, new: Dict[str, Expr]) -> Table:
    """Add/replace columns computed from expressions (df.assign); every
    expression sees the input table."""
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
    return Table(cols, t.nrows)


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
    """Filter rows; a null predicate counts as False (SQL semantics)."""
    mask, mv = eval_expr(predicate, _tree(t), _dicts(t), _schema(t))
    if mv is not None:
        mask = mask & mv
    mask = mask & K.row_mask(t.nrows, t.capacity, t.device)
    names = t.names
    flat = []
    for n in names:
        flat.extend((t.columns[n].data, t.columns[n].valid))
    out, cnt = K.compact(mask, tuple(flat))
    tree = {n: (out[2 * i], out[2 * i + 1]) for i, n in enumerate(names)}
    return _keep_vranges(rebucket(t.with_arrays(tree, nrows=cnt)), t)


# ---------------------------------------------------------------------------
# key ranges and key packing (multi-key -> one int64 when ranges fit)
# ---------------------------------------------------------------------------

def _min_max(t: Table, names: Sequence[str]) -> Dict[str, Optional[tuple]]:
    """Exact (min, max) of each named integer/date column over its valid
    rows, None for a column without one (the JAX package's
    `reduce_table` min/max, restricted to what the planners ask)."""
    if t.nrows == 0:
        return {k: (0, 0) for k in names}
    padmask = K.row_mask(t.nrows, t.capacity, t.device)
    out = {}
    for k in names:
        c = t.column(k)
        ok = K.value_ok(c.data, c.valid, padmask)
        vals = c.data[ok]
        if vals.numel() == 0:
            out[k] = None
            continue
        lo, hi = torch.stack([vals.min(), vals.max()]).tolist()
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
    return Table(cols, t.nrows)


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

    Routes, in the JAX package's order: dense slots when every key has a
    small known range; packed keys when they fit 62 bits; the
    scatter-claim hash groupby; the full sort."""
    keys = list(keys)
    if any(op == "median" or op.startswith(("quantile_", "listagg"))
           for _, op, _ in aggs):
        raise NotImplementedError("median/quantile/listagg groupby is not "
                                  "ported yet")
    dense_ok = (config.dense_groupby_max_slots > 0
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
    return Table(cols, out.nrows)


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


def dense_agg_tail(tree, live, kn, vn, specs, sizes, los, n_slots: int):
    """Scatter `live` rows into mixed-radix dense slots, reduce every
    aggregation with segment sums, decode slot indices back into key
    columns and compact the present slots ascending (slot order ==
    lexicographic key order). Returns (out_keys, out_vals, n_groups).

    The JAX package's one-hot matmul route (f32, at most 4096 slots) is a
    TPU route the port has not taken on."""
    slot, padmask = _dense_slots([tree[n] for n in kn], los, sizes, live)
    present = segment_sum(padmask.to(torch.int32), slot, n_slots) > 0
    outs = [_segment_agg(op, tree[c][0], tree[c][1], slot, padmask, n_slots)
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
    live = K.row_mask(t.nrows, t.capacity, t.device)
    out_keys, out_vals, ng = dense_agg_tail(_tree(t), live, list(keys),
                                            val_names, specs, sizes, los,
                                            n_slots)
    cols: Dict[str, Column] = {}
    for kname, kd in zip(keys, out_keys):
        cols[kname] = _key_out(t.column(kname), kd)
    for (cname, op, oname), (vd, vv) in zip(aggs, out_vals):
        cols[oname] = _agg_out_col(t.column(cname), op, vd, vv)
    return shrink_to_fit(Table(cols, ng))


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------

def sort_table(t: Table, by: Sequence[str], ascending=None,
               na_last: bool = True) -> Table:
    by = list(by)
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
                suffixes=("_x", "_y")) -> Table:
    """Equi-join (pandas merge: null keys match each other); the build
    side is `right`. This slice ports the dense-LUT join for inner and
    left joins."""
    left_on, right_on = list(left_on), list(right_on)
    if how not in ("inner", "left"):
        raise NotImplementedError(f"join how={how!r} is not ported yet")
    left = left.with_columns(left.columns)
    right = right.with_columns(right.columns)
    for lk, rk in zip(left_on, right_on):
        lc, rc = left.columns[lk], right.columns[rk]
        if lc.dtype is dt.STRING or rc.dtype is dt.STRING:
            if not (lc.dtype is rc.dtype and lc.dictionary is not None
                    and rc.dictionary is not None
                    and np.array_equal(lc.dictionary, rc.dictionary)):
                raise NotImplementedError(
                    "string join keys with different dictionaries "
                    "(unify_dictionaries) are not ported yet")
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
    out = _join_dense_try(left, right, left_on, right_on, how, suffixes)
    if out is not None:
        return out
    if left_on and config.hash_join:
        raise NotImplementedError("this join needs the hash join "
                                  "(_join_hash_try), not ported yet")
    raise NotImplementedError("this join needs the sort join (_join_rep), "
                              "not ported yet")


def _join_dense_try(left, right, left_on, right_on, how,
                    suffixes) -> Optional[Table]:
    """Dense-LUT equi-join: when the build (right) side's keys have a
    small host-known range and are unique, the join is a perfect-hash
    lookup — the build scatters row indices into a dense LUT, the probe
    gathers (the `lut_gather` CUDA kernel for LUTs of at most 4096
    slots). Output capacity == probe capacity. Returns None when not
    applicable."""
    if how not in ("inner", "left") or right.nrows == 0 or \
            config.dense_join_max_slots <= 0:
        return None
    if any(left.column(k).valid is not None for k in left_on) and \
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
    lorder = left_on + [n for n in left.names if n not in left_on]
    rorder = right_on + [n for n in right.names if n not in right_on]
    pa, ba = left.arrays(lorder), right.arrays(rorder)
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
    if n_slots <= CK.MAX_LUT_SLOTS:
        g = CK.lut_gather(pslot, lut)
    else:
        g = lut[pslot.to(torch.int64)]
    idx = torch.where(live, g, -1)
    hit = idx >= 0
    safe = idx.clamp(min=0).to(torch.int64)
    out_b = [(d[safe], hit if v is None else (hit & v[safe])) for d, v in ba]
    if how == "inner":
        flat = []
        for d, v in tuple(pa) + tuple(out_b):
            flat.extend((d, v))
        packed, nrows = K.compact(hit, tuple(flat))
        pairs = [(packed[2 * i], packed[2 * i + 1])
                 for i in range(len(flat) // 2)]
        out_p, out_b = pairs[:len(pa)], pairs[len(pa):]
    else:  # left join: every probe row stays; unmatched build cols invalid
        out_p, nrows = list(pa), left.nrows
    res = _assemble_join(left, right, left_on, right_on, lorder, rorder,
                         out_p, out_b, nrows, suffixes)
    route_counts["join_dense"] += 1
    return rebucket(res)


def _assemble_join(left, right, left_on, right_on, lorder, rorder,
                   out_p, out_b, nrows, suffixes) -> Table:
    lmap, rmap = _suffix_columns(left, right, left_on, right_on, suffixes)
    cols: Dict[str, Column] = {}
    for n, (d, v) in zip(lorder, out_p):
        src = left.column(n)
        cols[lmap[n]] = Column(d, v, src.dtype, src.dictionary, src.vrange)
    for n, (d, v) in zip(rorder, out_b):
        if n in rmap:
            src = right.column(n)
            cols[rmap[n]] = Column(d, v, src.dtype, src.dictionary,
                                   src.vrange)
    # pandas column order: left columns, then right columns
    names: List[str] = [lmap[n] for n in left.names] + \
        [rmap[n] for n in right.names if n in rmap]
    return Table(cols, nrows).select(names)
