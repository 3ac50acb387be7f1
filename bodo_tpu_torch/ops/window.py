"""Window kernels: cumulative ops, rolling windows, shift/diff, and the
sorted-pass ranking and aggregate windows.

Counterpart of bodo_tpu/ops/window.py. Every function is a plain
function on the tensors of one block (a replicated table, or one shard
of a row-sharded table): (x, valid, count), with the first `count` rows
real and the rest padding. The JAX package's 1D bodies run inside a
shard_map and reach the other shards through `all_gather` and the axis
index; the port's 1D bodies loop over the shards on the host
(relational.py), so the cross-shard state is a function of the shard
index and the per-shard values stacked on a leading shard axis: the
cumulative carries (`cum_carry_exscan`), the halo tails
(`multi_hop_halo`) and the last rows (`prev_last_value`).

Float prefixes (`prefix_scan`) are Hillis-Steele scans: ceil(log2 n)
elementwise passes, each adding (or multiplying, or taking the max of)
every value and the one `span` rows before it. The order of the
operations is fixed, so a prefix is the same bits on every run and on
the CPU and the card alike; torch.cumsum on a CUDA float tensor is a
scan whose decoupled look-back may associate differently from run to
run. The JAX package's jitted cumsum is reassociated too, so neither
package's float prefix is the left-to-right one: the two agree within
a few ulps of the largest prefix of |x| (ROADMAP F11). Integer prefixes
are exact in any order and take torch.cumsum.

The sorted pass (`_sorted_segments`) sorts by (partition keys, order
keys) with `ops/sort.lexsort_perm` (stable, so ties keep their row
order, which the JAX package gets from an `arange` last operand). Its
real rows come first in sorted order (padding ranks last), so the
segment and peer-group bounds are read off the positions of the
segment starts.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from bodo_tpu_torch.ops import kernels as K
from bodo_tpu_torch.ops import sort_encoding as SE
from bodo_tpu_torch.ops.sort import lexsort_perm

_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1


def prefix_scan(x, op: str = "sum"):
    """Inclusive scan of the 1-D tensor `x` by `op` (sum, prod, max or
    min) in ceil(log2 n) passes: pass j combines each value with the one
    2^j rows before it (Hillis-Steele). Deterministic: the same bits
    every run, on the CPU and on CUDA."""
    fn = {"sum": torch.add, "prod": torch.mul, "max": torch.maximum,
          "min": torch.minimum}[op]
    n = x.shape[0]
    if n < 2:
        return x.clone()
    cur, nxt = x.clone(), torch.empty_like(x)
    span = 1
    while span < n:
        nxt[:span] = cur[:span]
        fn(cur[span:], cur[:-span], out=nxt[span:])
        cur, nxt = nxt, cur
        span *= 2
    return cur


def _zero_first(x):
    """[0] followed by `x` (the exclusive form of a prefix)."""
    return torch.cat([x.new_zeros(1), x])


# ---------------------------------------------------------------------------
# cumulative ops: local part + carry combine
# ---------------------------------------------------------------------------

_CUM_NEUTRAL = {"cumsum": 0.0, "cumprod": 1.0,
                "cummax": -float("inf"), "cummin": float("inf")}
_CUM_SCAN = {"cumsum": "sum", "cumprod": "prod", "cummax": "max",
             "cummin": "min"}


def cum_local(op: str, x, valid, count: int):
    """Returns (local result, local carry scalar). Result positions of
    null rows are NaN (pandas semantics); padding rows are neutral."""
    if op not in _CUM_SCAN:
        raise ValueError(op)
    cap = x.shape[0]
    padmask = K.row_mask(count, cap, x.device)
    ok = K.value_ok(x, valid, padmask)
    base = torch.where(ok, x.to(torch.float64), _CUM_NEUTRAL[op])
    loc = prefix_scan(base, _CUM_SCAN[op])
    return loc, loc[-1]


def cum_combine(op: str, loc, carry_prefix):
    """Apply the exscan'd prefix carry from earlier shards."""
    if op == "cumsum":
        return loc + carry_prefix
    if op == "cumprod":
        return loc * carry_prefix
    if op == "cummax":
        return torch.maximum(loc, carry_prefix)
    if op == "cummin":
        return torch.minimum(loc, carry_prefix)
    raise ValueError(op)


def cum_carry_exscan(op: str, carries, shard: int):
    """Exclusive scan of the stacked per-shard carries [S] at `shard`:
    the carries of shards 0..shard-1 combined left to right (one fixed
    order on every device; a CUDA reduction would associate them
    otherwise), the identity for shard 0."""
    if op not in _CUM_SCAN:
        raise ValueError(op)
    acc = torch.full((), _CUM_NEUTRAL[op], dtype=carries.dtype,
                     device=carries.device)
    fn = {"cumsum": torch.add, "cumprod": torch.mul,
          "cummax": torch.maximum, "cummin": torch.minimum}[op]
    for j in range(shard):
        acc = fn(acc, carries[j])
    return acc


def cum_finalize(op: str, combined, x, valid, count: int):
    """NaN at null positions, zeros at padding."""
    cap = x.shape[0]
    padmask = K.row_mask(count, cap, x.device)
    ok = K.value_ok(x, valid, padmask)
    return torch.where(ok, combined, torch.where(
        padmask, float("nan"), 0.0).to(torch.float64))


# ---------------------------------------------------------------------------
# rolling windows (fixed window w, min_periods = w — pandas default)
# ---------------------------------------------------------------------------

def _nan_or_zero(padmask):
    """NaN on real rows, 0.0 on padding (float64)."""
    return torch.where(padmask, float("nan"), 0.0).to(torch.float64)


def rolling_local(op: str, window: int, x, valid, count: int, halo_x,
                  halo_ok, global_offset: int):
    """Rolling over the local block with a (window-1)-row halo from the
    previous rows. halo_x/halo_ok: [window-1] values/validity of the
    real rows before this block (from as many predecessor shards as
    needed); global_offset: the number of real rows before this block
    (positions < window-1 globally are NaN)."""
    cap = x.shape[0]
    w = window
    dev = x.device
    padmask = K.row_mask(count, cap, dev)
    ok = K.value_ok(x, valid, padmask)
    xf = torch.where(ok, x.to(torch.float64), 0.0)
    ext = torch.cat([torch.where(halo_ok, halo_x, 0.0), xf])
    ext_ok = torch.cat([halo_ok, ok])

    if op in ("sum", "mean"):
        cs0 = _zero_first(prefix_scan(ext, "sum"))
        out = cs0[w:] - cs0[:-w]          # [cap]: sum over ext[i..i+w-1]
    elif op in ("min", "max"):
        # sparse-table doubling: O(log w) shifted reductions
        ident = float("inf") if op == "min" else -float("inf")
        red = torch.minimum if op == "min" else torch.maximum
        level = torch.where(ext_ok, ext, ident)
        span = 1
        while span * 2 <= w:
            level = red(level, torch.cat(
                [level[span:], level.new_full((span,), ident)]))
            span *= 2
        # window [i, i+w) = block [i, i+span) ∪ block [i+w-span, i+w)
        lead = torch.cat([level[w - span:],
                          level.new_full((w - span,), ident)]) \
            if w > span else level
        out = red(level, lead)[:cap]
    elif op == "count":
        # the JAX package's float64 prefix of ones: exact integers, so
        # the integer prefix gives the same values
        cs0 = _zero_first(torch.cumsum(ext_ok.to(torch.int64), 0))
        out = (cs0[w:] - cs0[:-w]).to(torch.float64)
    else:
        raise ValueError(op)

    okc0 = _zero_first(torch.cumsum(ext_ok.to(torch.int64), 0))
    nvalid = okc0[w:] - okc0[:-w]
    if op == "mean":
        out = out / torch.clamp(nvalid, min=1)
    gpos = global_offset + torch.arange(cap, device=dev)
    if op == "count":
        # pandas >= 1.3: count obeys min_periods=window like other aggs
        full_pos = (gpos >= w - 1) & padmask
        return torch.where(full_pos, out, _nan_or_zero(padmask))
    full = (nvalid == w) & (gpos >= w - 1) & padmask
    return torch.where(full, out, _nan_or_zero(padmask))


def tail_rows(x, valid, count: int, k: int):
    """The last k row slots before the block's end of real rows (for the
    halo): (values as float64, the row exists, the row exists and its
    value is ok)."""
    cap = x.shape[0]
    dev = x.device
    at = count - k + torch.arange(k, device=dev)
    idx = torch.clamp(at, 0, cap - 1)
    exists = at >= 0
    okv = K.value_ok(x, valid, K.row_mask(count, cap, dev))
    tx = torch.where(exists, x.to(torch.float64)[idx], 0.0)
    return tx, exists, exists & okv[idx]


def halo_tails(xs, valids, counts, k: int):
    """Every shard's k-row tail stacked on the shard axis: ([S, k]
    float64 values, [S, k] row exists, [S, k] value ok)."""
    parts = [tail_rows(x, v, int(c), k)
             for x, v, c in zip(xs, valids, counts)]
    return tuple(torch.stack([p[j] for p in parts]) for j in range(3))


def multi_hop_halo(tails, shard: int, k: int):
    """Last k rows across ALL predecessor shards of `shard` (not just the
    immediate neighbour), from the stacked tails of every shard
    (`halo_tails`). Row EXISTENCE (position past padding) is tracked
    separately from value validity — a null predecessor row still
    occupies its halo slot so shift/rolling see its null, exactly as a
    local previous row would. Handles short and empty predecessor
    shards and a window wider than a shard."""
    all_tx, all_tex, all_tok = tails
    s = all_tx.shape[0]
    dev = all_tx.device
    shard_ids = torch.arange(s, device=dev).repeat_interleave(k)
    before = shard_ids < shard
    flat_x = all_tx.reshape(-1)
    flat_ex = all_tex.reshape(-1) & before
    flat_ok = all_tok.reshape(-1) & before
    # j-th existing row counted from the END goes to halo slot k - j;
    # the rest go to the spare slot k, which is dropped
    rev = torch.flip(torch.cumsum(torch.flip(flat_ex.to(torch.int64), [0]),
                                  0), [0])
    slot = torch.where(flat_ex & (rev <= k), k - rev, k)
    halo_x = torch.zeros(k + 1, dtype=flat_x.dtype, device=dev)
    halo_ok = torch.zeros(k + 1, dtype=torch.bool, device=dev)
    halo_x[slot] = flat_x
    halo_ok[slot] = flat_ok
    return halo_x[:k], halo_ok[:k]


def last_rows(xs, valids, counts):
    """Every shard's last real row, stacked: ([S] values in the source
    dtype, [S] value ok, [S] the shard has a row)."""
    vals, oks, haves = [], [], []
    for x, v, c in zip(xs, valids, counts):
        c = int(c)
        cap = x.shape[0]
        last_i = min(max(c - 1, 0), cap - 1)
        vals.append(x[last_i])
        ok = K.value_ok(x, v, K.row_mask(c, cap, x.device))[last_i]
        oks.append(ok & (c > 0))
        haves.append(c > 0)
    dev = xs[0].device
    return (torch.stack(vals), torch.stack(oks),
            torch.tensor(haves, dtype=torch.bool, device=dev))


def prev_last_value(lasts, shard: int):
    """The last real row's (value, value_ok, exists) from the nearest
    non-empty predecessor shard of `shard`, from the stacked last rows
    of every shard (`last_rows`), in the ORIGINAL dtype (no float64
    round-trip — int64 ticks stay exact). Used for cross-shard tie
    detection in global ranking."""
    all_v, all_ok, all_have = lasts
    s = all_v.shape[0]
    ids = torch.arange(s, device=all_v.device)
    cand = all_have & (ids < shard)
    best = torch.where(cand, ids, -1).max()
    exists = best >= 0
    sel = torch.clamp(best, 0, s - 1)
    return all_v[sel], all_ok[sel] & exists, exists


# ---------------------------------------------------------------------------
# shift / diff
# ---------------------------------------------------------------------------

def shift_local(x, valid, count: int, halo_x, halo_ok, n: int):
    """Shift by n>0 (from previous rows; the halo has the last n rows
    before the block). Returns (data, ok)."""
    cap = x.shape[0]
    padmask = K.row_mask(count, cap, x.device)
    ok = K.value_ok(x, valid, padmask)
    ext = torch.cat([halo_x, x.to(torch.float64)])
    ext_ok = torch.cat([halo_ok, ok])
    out = ext[:cap]
    out_ok = ext_ok[:cap] & padmask
    return torch.where(out_ok, out, float("nan")), out_ok


# ---------------------------------------------------------------------------
# the sorted pass shared by the ranking and aggregate windows
# ---------------------------------------------------------------------------

def _starts_to_bounds(starts_flag, n: int):
    """For each sorted row: (the id of its group, the group's first row,
    the group's last real row), groups starting where `starts_flag` is
    set among the first `n` (real) rows. Padding rows join the last
    group."""
    gid = torch.clamp(torch.cumsum(starts_flag.to(torch.int64), 0) - 1,
                      min=0)
    starts = torch.nonzero(starts_flag[:n]).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_full((1,), n)]) - 1
    return gid, starts[gid], ends[gid]


def _sorted_segments(key_arrays, order_arrays, count: int, ascending,
                     na_last: bool, cap: int, device):
    """Shared sort/segment machinery for ALL partitioned window kernels:
    stable sort by (partition keys, order cols); partition boundaries
    from null-canonicalized key changes (a null — mask or NaN — compares
    equal to another null, never to a value). Returns per-row arrays in
    sorted order: (perm, padmask_s, seg_start, seg_end, seg_cnt_row,
    peer_start, peer_end, peer_id, pos). The bounds hold on the real
    rows, which come first; `count` must be positive."""
    padmask = K.row_mask(count, cap, device)
    operands: list = []
    for d, v in key_arrays:
        # partition nulls group together: the null rank slot, padding
        # rows still sort last
        operands.extend(SE.key_operands(d, v, padmask=padmask))
    if not ascending:
        ascending = tuple(True for _ in order_arrays)
    for (d, v), asc in zip(order_arrays, ascending):
        operands.extend(SE.key_operands(d, v, ascending=asc,
                                        na_last=na_last, padmask=padmask))
    perm = lexsort_perm(operands) if operands else \
        torch.arange(cap, device=device)
    padmask_s = padmask[perm]
    pos = torch.arange(cap, device=device)

    def _changes(arrays):
        chg = torch.zeros(cap, dtype=torch.bool, device=device)
        for d, v in arrays:
            null = SE.null_flag(d, v)
            ds = d[perm]
            if ds.dtype == torch.uint64:
                ds = ds.view(torch.int64)   # equality of the same bits
            if null is not None:
                ns = null[perm]
                ds = torch.where(ns, torch.zeros((), dtype=ds.dtype,
                                                 device=device), ds)
                chg = chg | (ns != torch.roll(ns, 1))
            chg = chg | (ds != torch.roll(ds, 1))
        return chg

    newpart = (_changes(key_arrays) & padmask_s) | (pos == 0)
    _, seg_start, seg_end = _starts_to_bounds(newpart, count)
    seg_cnt_row = seg_end - seg_start + 1
    # peer groups: rows equal on ALL order keys (RANGE frame boundary)
    newval = newpart | (_changes(order_arrays) & padmask_s)
    peer_id, peer_start, peer_end = _starts_to_bounds(newval, count)
    return (perm, padmask_s, seg_start, seg_end, seg_cnt_row, peer_start,
            peer_end, peer_id, pos)


def _unsort(perm, o):
    """Sorted-order values back to the input row order."""
    if o.dtype == torch.uint64:  # torch has no uint64 index_put
        return _unsort(perm, o.view(torch.int64)).view(torch.uint64)
    out = torch.empty_like(o)
    out[perm] = o
    return out


# ---------------------------------------------------------------------------
# partitioned ranking windows: ROW_NUMBER / RANK / DENSE_RANK / NTILE /
# CUMCOUNT over (PARTITION BY keys ORDER BY order_cols)
# ---------------------------------------------------------------------------

def rank_window_local(key_arrays, order_arrays, count: int,
                      specs: Sequence[Tuple[str, int]],
                      ascending: Tuple[bool, ...] = (),
                      na_last: bool = True):
    """Ranking window functions in one sorted pass: stable sort by
    (partition keys, order cols), segment boundaries from key changes,
    then each rank flavor is an elementwise expression over
    segment-relative positions; results go back to the input row order.
    specs: (op, param) with op in row_number/rank/dense_rank/ntile/
    cumcount; param is ntile's bucket count.

    Null partition keys form their own partition (SQL semantics: NULLs
    group together in PARTITION BY). Returns int64 outputs aligned with
    input rows (0 on padding rows)."""
    for op, param in specs:
        if op == "ntile" and int(param) < 1:
            raise ValueError(
                f"NTILE argument must be positive, got {param}")
        if op not in ("row_number", "cumcount", "rank", "dense_rank",
                      "ntile"):
            raise ValueError(f"unknown rank window op: {op}")
    some = key_arrays[0][0] if key_arrays else order_arrays[0][0]
    cap, dev = some.shape[0], some.device
    if count == 0:
        return tuple(torch.zeros(cap, dtype=torch.int64, device=dev)
                     for _ in specs)
    (perm, padmask_s, seg_start, _seg_end, seg_cnt_row, peer_start, _pe,
     peer_id, pos) = _sorted_segments(key_arrays, order_arrays, count,
                                      ascending, na_last, cap, dev)
    row_no = pos - seg_start + 1                          # 1-based
    outs = []
    for op, param in specs:
        if op == "row_number":
            o = row_no
        elif op == "cumcount":
            o = row_no - 1
        elif op == "rank":
            # row_number of the first row with an equal order value
            o = peer_start - seg_start + 1
        elif op == "dense_rank":
            o = peer_id - peer_id[seg_start] + 1
        else:
            # SQL NTILE: first (cnt mod n) buckets get ceil(cnt/n) rows,
            # the rest floor(cnt/n)
            n = int(param)
            cnt = torch.clamp(seg_cnt_row, min=1)
            small = cnt // n
            rem = cnt - small * n
            big_rows = rem * (small + 1)       # rows in the big buckets
            r0 = row_no - 1
            o = torch.where(
                r0 < big_rows, r0 // (small + 1) + 1,
                rem + (r0 - big_rows) // torch.clamp(small, min=1) + 1)
        outs.append(_unsort(perm, torch.where(padmask_s, o, 0)))
    return tuple(outs)


# ---------------------------------------------------------------------------
# partitioned aggregate windows: SUM/AVG/MIN/MAX/COUNT ... OVER
# (PARTITION BY k ORDER BY o [ROWS BETWEEN a AND b]) + LEAD/LAG +
# FIRST_VALUE/LAST_VALUE
# ---------------------------------------------------------------------------

def _minmax_sparse_table(x_masked, n_levels: int, want_max: bool):
    """Sparse-table levels for range-min/max queries: levels[k][i] =
    red(x[i .. i+2^k-1]) (array-clamped; queries stay inside segments so
    no segment masking is needed at build time), in the value's own
    domain dtype so results are EXACT."""
    red = torch.maximum if want_max else torch.minimum
    cap = x_masked.shape[0]
    levels = torch.empty((n_levels, cap), dtype=x_masked.dtype,
                         device=x_masked.device)
    levels[0] = x_masked
    span = 1
    for j in range(1, n_levels):
        prev = levels[j - 1]
        idx = torch.clamp(torch.arange(cap, device=prev.device) + span,
                          max=cap - 1)
        red(prev, prev[idx], out=levels[j])
        span *= 2
    return levels  # [K, cap]


def _range_minmax(levels, a, b, empty, want_max: bool, sentinel):
    """min/max over [a, b] per row from sparse-table levels ([K, cap]):
    two overlapping blocks of 2^k rows, k = floor(log2(b - a + 1))."""
    length = torch.clamp(b - a + 1, min=1)
    # floor(log2(length)): frexp's exponent, exact for integers < 2^53
    k = torch.frexp(length.to(torch.float64)).exponent.to(torch.int64) - 1
    k = torch.clamp(k, max=levels.shape[0] - 1)
    cap = levels.shape[1]
    flat = levels.reshape(-1)
    left = flat[k * cap + torch.clamp(a, 0, cap - 1)]
    right = flat[k * cap + torch.clamp(b - (1 << k) + 1, 0, cap - 1)]
    red = torch.maximum if want_max else torch.minimum
    out = red(left, right)
    return torch.where(empty, sentinel, out)


def _minmax_domain(ds, want_max: bool):
    """(values in the exact domain of min/max, the sentinel, the map
    back): floats as float64, uint64 as int64 with the sign bit flipped
    (the same order; torch has no uint64 maximum), everything else
    (ints, bools, datetime ticks, dictionary codes) as int64."""
    if ds.is_floating_point():
        return (ds.to(torch.float64),
                -float("inf") if want_max else float("inf"), lambda m: m)
    sentinel = _INT64_MIN if want_max else _INT64_MAX
    if ds.dtype == torch.uint64:
        return (ds.view(torch.int64) ^ SE.SIGN64, sentinel,
                lambda m: (m ^ SE.SIGN64).view(torch.uint64))
    return ds.to(torch.int64), sentinel, lambda m: m


def agg_window_local(key_arrays, order_arrays, val_arrays, count: int,
                     specs: Sequence[Tuple], ascending: Tuple[bool, ...] = (),
                     na_last: bool = True):
    """Aggregate/navigation window functions in one sorted pass: sort
    once by (partition, order) keys, then every frame aggregate is a
    prefix-sum difference (sum/count/mean) or a sparse-table range query
    (min/max) over the sorted array.

    specs: tuple of (op, val_idx, frame, param):
      op    ∈ sum/sum0/mean/count/min/max/lead/lag/first_value/last_value
      frame ∈ ("all",)                — whole partition (no ORDER BY)
              ("cumrange",)           — RANGE UNBOUNDED PRECEDING..CURRENT
                                        ROW (ORDER BY default; peers incl.)
              ("rows", lo, hi)        — ROWS BETWEEN frames; lo/hi are
                                        row offsets (None = unbounded)
      param — LEAD/LAG offset (ignored otherwise)

    Returns one (data, valid_bool) pair per spec, aligned with input
    rows: prefix-sum ops (sum/mean/count) in float64; min/max in the
    value's exact domain (int64 for ints/datetimes/decimals, float64 for
    floats, uint64 for uint64); gather ops (lead/lag/first/last) in the
    SOURCE dtype so dictionary codes and datetimes survive."""
    some = (key_arrays[0][0] if key_arrays else
            (order_arrays[0][0] if order_arrays else val_arrays[0][0]))
    cap, dev = some.shape[0], some.device
    for op, *_ in specs:
        if op not in ("lead", "lag", "first_value", "last_value", "sum",
                      "sum0", "mean", "count", "min", "max"):
            raise ValueError(f"unknown agg window op: {op}")
    if count == 0:
        return tuple(_empty_agg(op, val_arrays[vi][0], cap, dev)
                     for op, vi, _, _ in specs)
    (perm, padmask_s, seg_start, seg_end, seg_cnt_row, _ps, peer_end, _pi,
     pos) = _sorted_segments(key_arrays, order_arrays, count, ascending,
                             na_last, cap, dev)
    padmask = K.row_mask(count, cap, dev)

    sorted_cache: dict = {}

    def _sorted_val(vi):
        if vi not in sorted_cache:
            d, v = val_arrays[vi]
            ok = K.value_ok(d, v, padmask)
            sorted_cache[vi] = (d[perm], ok[perm])
        return sorted_cache[vi]

    prefix_cache: dict = {}

    def _prefixes(vi):
        if vi not in prefix_cache:
            ds, oks = _sorted_val(vi)
            xf = torch.where(oks, ds.to(torch.float64), 0.0)
            P0 = _zero_first(prefix_scan(xf, "sum"))
            C0 = _zero_first(torch.cumsum(oks.to(torch.int64), 0))
            prefix_cache[vi] = (P0, C0)
        return prefix_cache[vi]

    # levels enough for the longest frame, which lies in one partition
    n_levels = max(int(seg_cnt_row[:count].max()).bit_length(), 1)
    table_cache: dict = {}

    def _tables(vi, want_max: bool):
        key = (vi, want_max)
        if key not in table_cache:
            ds, oks = _sorted_val(vi)
            dom, sentinel, back = _minmax_domain(ds, want_max)
            xm = torch.where(oks, dom, sentinel)
            table_cache[key] = (_minmax_sparse_table(xm, n_levels,
                                                     want_max),
                                sentinel, back)
        return table_cache[key]

    def _frame_bounds(frame):
        if frame[0] == "all":
            return seg_start, seg_end
        if frame[0] == "cumrange":
            return seg_start, peer_end
        lo, hi = frame[1], frame[2]
        a = seg_start if lo is None else torch.maximum(pos + lo, seg_start)
        b = seg_end if hi is None else torch.minimum(pos + hi, seg_end)
        return a, b

    outs = []
    for op, vi, frame, param in specs:
        if op in ("lead", "lag"):
            off = int(param) * (1 if op == "lead" else -1)
            tgt = pos + off
            ds, oks = _sorted_val(vi)
            inside = (tgt >= seg_start) & (tgt <= seg_end) & padmask_s
            safe = torch.clamp(tgt, 0, cap - 1)
            od = torch.where(inside, ds[safe], torch.zeros(
                (), dtype=ds.dtype, device=dev))
            ov = inside & oks[safe]
        elif op in ("first_value", "last_value"):
            a, b = _frame_bounds(frame)
            ds, oks = _sorted_val(vi)
            at = a if op == "first_value" else b
            nonempty = (b >= a) & padmask_s
            safe = torch.clamp(at, 0, cap - 1)
            od = torch.where(nonempty, ds[safe], torch.zeros(
                (), dtype=ds.dtype, device=dev))
            ov = nonempty & oks[safe]
        elif op in ("sum", "sum0", "mean", "count"):
            a, b = _frame_bounds(frame)
            P0, C0 = _prefixes(vi)
            a_ = torch.clamp(a, 0, cap)
            b_ = torch.clamp(b + 1, 0, cap)
            nonempty = (b >= a) & padmask_s
            wsum = torch.where(nonempty, P0[b_] - P0[a_], 0.0)
            wcnt = torch.where(nonempty, C0[b_] - C0[a_], 0)
            if op == "count":
                od = wcnt.to(torch.float64)
                ov = padmask_s
            elif op == "sum":
                od = wsum
                ov = wcnt > 0          # SQL: SUM over empty/all-null=NULL
            elif op == "sum0":
                od = wsum              # pandas: empty/all-null sums to 0
                ov = padmask_s
            else:
                od = wsum / torch.clamp(wcnt, min=1)
                ov = wcnt > 0
        else:  # min, max
            a, b = _frame_bounds(frame)
            lv, sentinel, back = _tables(vi, op == "max")
            _, C0 = _prefixes(vi)
            empty = (b < a) | ~padmask_s
            m = _range_minmax(lv, a, b, empty, op == "max", sentinel)
            # validity from the non-null COUNT, not isfinite(m): a real
            # +/-inf data value must survive as inf, not become NULL
            wcnt = torch.where(empty, 0,
                               C0[torch.clamp(b + 1, 0, cap)]
                               - C0[torch.clamp(a, 0, cap)])
            ov = wcnt > 0
            od = back(torch.where(ov, m, torch.zeros(
                (), dtype=m.dtype, device=dev)))
        outs.append((_unsort(perm, od), _unsort(perm, ov)))
    return tuple(outs)


def _empty_agg(op: str, d, cap: int, dev):
    """A spec's (data, valid) over a block without a real row."""
    if op in ("lead", "lag", "first_value", "last_value"):
        dtype = d.dtype
    elif op in ("min", "max"):
        dtype = d.dtype if d.dtype == torch.uint64 else (
            torch.float64 if d.is_floating_point() else torch.int64)
    else:
        dtype = torch.float64
    return (torch.zeros(cap, dtype=dtype, device=dev),
            torch.zeros(cap, dtype=torch.bool, device=dev))
