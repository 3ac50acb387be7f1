"""Groupby aggregation kernels.

Counterpart of bodo_tpu/ops/groupby.py for the decomposable
aggregations: segment reductions (`_segment_agg`) for size, count, sum,
sumnull, sum64, prod, min, max, first, last, mean, var, std, var0, std0
and the centered moments m2, m3, m4 with skew and kurt; the composite
combines chan_m2, chan_m3 and chan_m4 of the two-phase sharded groupby
(`groupby_local`); the scatter-claim hash groupby
(`groupby_local_hashed`, and `groupby_local_hashed_static` for the
partial stage of the two-phase sharded groupby), whose f32 sums, counts
and means over at most 4096 groups take the `groupby_sum` kernel
(`cuda_kernels.dense_accumulate`); and the sort-based `groupby_local`
that the JAX package itself takes when the hash route does not resolve.

Still refused with NotImplementedError: the quantiles (`_quantile_seg`),
`_nunique`, `_mode` and aggregation over decimals.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from bodo_tpu_torch.ops import cuda_kernels as CK
from bodo_tpu_torch.ops import hashtable as HT
from bodo_tpu_torch.ops import kernels as K
from bodo_tpu_torch.ops import sort_encoding as SE
from bodo_tpu_torch.ops.sort import lexsort_perm
from bodo_tpu_torch.table import dtypes as dt

# ops the JAX package's hash route accepts: everything _segment_agg
# computes from (segment ids, values) alone
HASH_OPS = frozenset({
    "count", "size", "sum", "sumnull", "sum64", "prod", "min", "max",
    "first", "last", "mean", "var", "std", "var0", "std0",
    "m2", "m3", "m4", "skew", "kurt",
})
# the ops the port's _segment_agg computes: all of them
_PORTED = HASH_OPS

# final op -> partial ops of the two-phase sharded groupby, and partial
# op -> its combine op (the JAX package's tables). The composite combines
# chan_m2/chan_m3/chan_m4 read the preceding partial columns, so the
# order of _VAR_PARTS, _SKEW_PARTS and _KURT_PARTS is load-bearing.
_VAR_PARTS = ["count", "sum64", "m2"]
_SKEW_PARTS = ["count", "sum64", "m2", "m3"]
_KURT_PARTS = ["count", "sum64", "m2", "m3", "m4"]
DECOMPOSE = {
    "sum": ["sum"], "sumnull": ["sumnull"], "prod": ["prod"],
    "count": ["count"], "size": ["size"], "min": ["min"], "max": ["max"],
    "first": ["first"], "last": ["last"], "mean": ["sum", "count"],
    "var": _VAR_PARTS, "std": _VAR_PARTS, "var0": _VAR_PARTS,
    "std0": _VAR_PARTS, "skew": _SKEW_PARTS, "kurt": _KURT_PARTS,
}
COMBINE_OF = {"sum": "sum", "sumnull": "sumnull", "sum64": "sum",
              "m2": "chan_m2", "m3": "chan_m3", "m4": "chan_m4",
              "count": "sum", "size": "sum",
              "min": "min", "max": "max", "first": "first", "last": "last",
              "prod": "prod"}


def result_dtype(op: str, d: np.dtype) -> np.dtype:
    d = np.dtype(d)
    if op in ("count", "size", "nunique"):
        return np.dtype(np.int64)
    if op in ("sum64", "m2", "m3", "m4", "skew", "kurt"):
        return np.dtype(np.float64)  # the moments accumulate in f64
    if op in ("mean", "var", "std", "var0", "std0", "median") or \
            op.startswith(("quantile_", "q:")):
        return np.dtype(np.float32) if d == np.float32 \
            else np.dtype(np.float64)
    if op in ("sum", "sumnull", "prod"):
        if d.kind == "f":
            return d
        return np.dtype(np.uint64) if d.kind == "u" else np.dtype(np.int64)
    if op in ("min", "max", "first", "last", "mode"):
        return d
    raise NotImplementedError(f"aggregation {op!r} is not ported yet")


def agg_dtype(op: str, src: dt.DType) -> dt.DType:
    """Logical result DType of an aggregation: the JAX package's, also for
    the aggregations whose routes the port has not (nunique, mode,
    listagg, median and quantiles), so plans that name them type-check;
    their execution raises in relational.groupby_agg."""
    if op in ("count", "size", "nunique"):
        return dt.INT64
    if dt.is_decimal(src):
        raise NotImplementedError(
            f"aggregation {op!r} over decimals is not ported yet")
    if op.startswith(("listagg", "listaggd")):
        return dt.STRING
    if op in ("min", "max", "first", "last", "mode"):
        return src
    return dt.from_numpy(result_dtype(op, src.numpy))


def _seg_index(seg, n: int):
    """Segment ids with those outside [0, n) sent to the spare slot n."""
    return torch.where((seg >= 0) & (seg < n), seg, n).to(torch.int64)


# a float sum on CUDA adds its sorted rows in pieces of at most PIECE
# rows of one segment, as the rows of a [pieces, PIECE] matrix summed
# along its rows, then the pieces' sums the same way, level by level,
# until each segment has one
PIECE = 8


class SortedSegments:
    """One segment-id vector's rows in stable order by segment, with each
    segment's length: what a deterministic float `segment_sum` reduces
    through. Made at the first float sum over the ids and reused by every
    later one, so a groupby of k float columns sorts its ids once.
    `presorted` ids are non-negative and non-decreasing already (the sort
    route's), and their order is the rows' own.

    `sum` reduces each segment in row order on the CPU (the sums of an
    index_add_, bit for bit). On CUDA it sums in levels of pieces
    (`levels`): torch.segment_reduce there gives every segment a thread
    block, so a groupby of millions of small groups took ~4.5 ms a
    20M-row column (H100 80GB HBM3, 700 W), where a row sum of a
    [pieces, PIECE] matrix keeps every thread busy. Both orders are
    fixed, so a sum is the same every run."""

    def __init__(self, seg, n: int, presorted: bool = False):
        self.seg, self.n, self.presorted = seg, n, presorted
        self._ol = None
        self._levels = None

    def order_lengths(self):
        if self._ol is None:
            idx = _seg_index(self.seg, self.n)
            order = None if self.presorted else torch.argsort(idx,
                                                              stable=True)
            self._ol = (order, torch.bincount(idx, minlength=self.n + 1),
                        idx)
        return self._ol[:2]

    def levels(self):
        """([(each value's piece, its column in the piece, the number of
        pieces)] a level, the ids in [0, n] that hold a row). A piece
        holds the next PIECE values of one segment; the levels end when
        each segment has one piece."""
        if self._levels is None:
            order, _ = self.order_lengths()
            idx = self._ol[2]
            ids = idx if order is None else idx[order]
            levels = []
            while True:
                pos = torch.arange(ids.shape[0], device=ids.device)
                new = torch.ones_like(pos, dtype=torch.bool)
                new[1:] = ids[1:] != ids[:-1]
                # each value's rank in its segment: a segment of k values
                # makes ceil(k / PIECE) pieces, so the levels end (torch's
                # cummax took ~35 ms on 20M values, H100 80GB HBM3, 700 W)
                heads = torch.nonzero(new).squeeze(1)
                rank = pos - heads[torch.cumsum(new, 0) - 1]
                start = rank % PIECE == 0
                first = torch.nonzero(start).squeeze(1)
                piece = torch.cumsum(start, 0) - 1
                levels.append((piece, pos - first[piece], first.shape[0]))
                ids = ids[first]
                if not bool((ids[1:] == ids[:-1]).any()):
                    break
            self._levels = (levels, ids)
        return self._levels

    def sum(self, x, in_pieces: bool = None):
        """Per-segment sums of the float rows `x` (in the ids' row order);
        `in_pieces` None: in levels of pieces on CUDA."""
        order, lengths = self.order_lengths()
        xs = x if order is None else x[order]
        if in_pieces is None:
            in_pieces = xs.is_cuda
        if not in_pieces or xs.shape[0] == 0:
            return torch.segment_reduce(xs, "sum", lengths=lengths,
                                        unsafe=True, initial=0)[:self.n]
        levels, held = self.levels()
        for piece, col, count in levels:
            m = torch.zeros((count, PIECE), dtype=xs.dtype,
                            device=xs.device)
            m[piece, col] = xs
            xs = m.sum(1)
        out = torch.zeros(self.n + 1, dtype=xs.dtype, device=xs.device)
        out[held] = xs
        return out[:self.n]


def segment_sum(x, seg, n: int, segs: SortedSegments = None):
    """Sum of `x` per segment id in [0, n); other ids are dropped (the
    out-of-range rule of jax.ops.segment_sum). `segs`, when given, holds
    `seg` and `n` sorted for float sums.

    A float sum is deterministic: the rows are stably sorted by segment
    and each segment is reduced on its own in a fixed order
    (SortedSegments.sum; on the CPU the same sums, bit for bit, as an
    index_add_). With atomics a float sum differs in its last bits from
    run to run on CUDA, and a query that compares a sum with the same
    sum computed again (TPC-H Q15's `total_revenue = (select
    max(total_revenue) ...)`) would find no row; the JAX package's
    scatter-add is deterministic on the TPU and on the CPU. Integer sums
    are exact in any order and keep index_add_."""
    if not x.is_floating_point():
        out = torch.zeros(n + 1, dtype=x.dtype, device=x.device)
        return out.index_add_(0, _seg_index(seg, n), x)[:n]
    if segs is None:
        segs = SortedSegments(seg, n)
    assert segs.seg is seg and segs.n == n
    return segs.sum(x)


def _segment_reduce(x, seg, n: int, reduce: str, init):
    """amin, amax or prod of `x` per segment id in [0, n), starting from
    `init` (the identity, which an empty segment keeps); other ids are
    dropped."""
    out = torch.full((n + 1,), init, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, _seg_index(seg, n), x, reduce)[:n]


_SIGN = -(1 << 63)


def _widened(v, rdt: torch.dtype):
    """`v` in the accumulator type `rdt` of a sum or product. Unsigned
    accumulators run as int64 with the same low 64 bits (uint64 keeps
    its bits), so sums and products wrap modulo 2^64 as the unsigned
    ones do: torch has no uint64 scatter arithmetic."""
    if rdt != torch.uint64:
        return v.to(rdt)
    return v.view(torch.int64) if v.dtype == torch.uint64 \
        else v.to(torch.int64)


def _from_bits(x, rdt: torch.dtype):
    return x.view(torch.uint64) if rdt == torch.uint64 else x


def _ordered(v):
    """(w, back): `v` in a dtype that scatter_reduce_ orders as `v`'s
    values (bool as uint8, uint16/32 widened, uint64 with its sign bit
    flipped), and the map back to `v`'s dtype."""
    if v.dtype == torch.bool:
        return v.to(torch.uint8), lambda w: w.to(torch.bool)
    if v.dtype == torch.uint64:
        return (v.view(torch.int64) ^ _SIGN,
                lambda w: (w ^ _SIGN).view(torch.uint64))
    if v.dtype in (torch.uint16, torch.uint32):
        return v.to(torch.int64), lambda w: w.to(v.dtype)
    return v, lambda w: w


def _min_max_ident(op: str, v):
    """The identity of min or max over `v`'s dtype, in `_ordered`'s
    domain: +-inf, the integer type's limits, True or False."""
    if v.is_floating_point():
        return float("inf") if op == "min" else float("-inf")
    if v.dtype == torch.bool:
        return int(op == "min")
    info = np.iinfo(_np_dtype(v))
    ident = int(info.max if op == "min" else info.min)
    return ident + _SIGN if v.dtype == torch.uint64 else ident


def _centered(v, ok, seg, cnt, n: int, segs: SortedSegments):
    """Per row, x - mean(x's segment) in f64 over the ok rows, 0
    elsewhere (the reference's two-pass moments)."""
    x = v.to(torch.float64)
    s = segment_sum(torch.where(ok, x, 0.0), seg, n, segs)
    mean = s / cnt.clamp(min=1).to(torch.float64)
    # ids outside [0, n) are on rows that are not ok; clamp the gather
    # as a jax gather does
    return torch.where(ok, x - mean[seg.clamp(0, n - 1).to(torch.int64)],
                       0.0)


def _segment_agg(op: str, v, valid, seg, padmask, out_cap: int,
                 segs: SortedSegments = None):
    """One primitive aggregation over values in the order the segment
    ids' route gives them (sorted on the sort route, the table's rows on
    the hashed and dense routes). Returns (data, valid). `segs` is shared
    by the aggregations of one groupby (SortedSegments(seg, out_cap))."""
    if segs is None:
        segs = SortedSegments(seg, out_cap)
    if op in ("nunique", "mode"):
        raise NotImplementedError(
            f"{op} (the sort groupby's _{op}) is not ported yet")
    if op.startswith("q:"):
        raise NotImplementedError("the groupby quantile (_quantile_seg) is "
                                  "not ported yet")
    if op not in _PORTED:
        raise ValueError(f"unknown agg op: {op}")
    ok = K.value_ok(v, valid, padmask)
    cnt = segment_sum(ok.to(torch.int64), seg, out_cap)
    if op == "count":
        return cnt, None
    if op == "size":
        return segment_sum(padmask.to(torch.int64), seg, out_cap), None
    rdt = dt.TORCH_OF[result_dtype(op, _np_dtype(v)).name]
    if op in ("sum", "sumnull", "sum64", "mean"):
        x = _widened(v, rdt)
        s = _from_bits(segment_sum(torch.where(ok, x, 0).to(x.dtype), seg,
                                   out_cap, segs), rdt)
        if op == "sumnull":  # SQL: SUM over an all-null group is NULL
            return s, cnt > 0
        if op != "mean":
            return s, None  # pandas: sum over all-null = 0
        m = s / cnt.clamp(min=1)
        return torch.where(cnt > 0, m, float("nan")).to(rdt), None
    if op == "prod":
        x = _widened(v, rdt)
        p = _segment_reduce(torch.where(ok, x, 1).to(x.dtype), seg, out_cap,
                            "prod", 1)
        return _from_bits(p, rdt), None
    if op in ("min", "max"):
        w, back = _ordered(v)
        ident = _min_max_ident(op, v)
        w = torch.where(ok, w, torch.full((), ident, dtype=w.dtype,
                                          device=w.device))
        out = _segment_reduce(w, seg, out_cap, "a" + op, ident)
        return back(out), cnt > 0
    if op in ("first", "last"):
        cap = v.shape[0]
        pos = torch.arange(cap, device=v.device)
        if op == "first":
            idx = _segment_reduce(torch.where(ok, pos, cap), seg, out_cap,
                                  "amin", cap)
        else:
            idx = _segment_reduce(torch.where(ok, pos, -1), seg, out_cap,
                                  "amax", -1)
        has = (idx >= 0) & (idx < cap)
        out = v[idx.clamp(0, cap - 1)]
        return torch.where(has, out, torch.zeros((), dtype=v.dtype,
                                                 device=v.device)), has
    d = _centered(v, ok, seg, cnt, out_cap, segs)
    m2 = segment_sum(d * d, seg, out_cap, segs)
    if op in ("var", "std", "var0", "std0"):
        out = _var_from_m2(m2, cnt, ddof=0 if op.endswith("0") else 1)
        if op.startswith("std"):
            out = torch.sqrt(out)
        return out.to(rdt), None
    if op == "m2":
        return m2, None
    m3 = segment_sum(d * d * d, seg, out_cap, segs)
    if op == "m3":
        return m3, None
    if op == "skew":
        return _skew_from_moments(cnt, m2, m3), None
    m4 = segment_sum(d * d * d * d, seg, out_cap, segs)
    if op == "m4":
        return m4, None
    return _kurt_from_moments(cnt, m2, m4), None


def _var_from_m2(m2, cnt, ddof: int = 1):
    """Variance from the centered second moment M2 = sum((x - mean)^2);
    NaN where the count is not above ddof."""
    var = m2 / (cnt.to(m2.dtype) - ddof).clamp(min=1)
    return torch.where(cnt > ddof, var.clamp(min=0), float("nan"))


def _skew_from_moments(cnt, m2, m3):
    """pandas-adjusted (Fisher-Pearson) skew from centered moments:
    g1 * sqrt(n(n-1))/(n-2) with g1 = (M3/n)/(M2/n)^1.5. As pandas'
    nanskew: NaN for n < 3, 0 for a constant group (M2 == 0)."""
    n = cnt.to(torch.float64)
    safe_m2 = m2.clamp(min=1e-300)
    n1 = n.clamp(min=1)
    g1 = (m3 / n1) / (safe_m2 / n1) ** 1.5
    adj = torch.sqrt(n * (n - 1)) / (n - 2).clamp(min=1)
    out = torch.where(m2 > 0, g1 * adj, 0.0)
    return torch.where(cnt >= 3, out, float("nan"))


def _kurt_from_moments(cnt, m2, m4):
    """pandas-adjusted (Fisher, excess) kurtosis from centered moments:
    n(n+1)(n-1) M4 / ((n-2)(n-3) M2^2) - 3(n-1)^2/((n-2)(n-3)). As
    pandas' nankurt: NaN for n < 4, 0 for a constant group (M2 == 0)."""
    n = cnt.to(torch.float64)
    safe_m2 = m2.clamp(min=1e-300)
    den = ((n - 2) * (n - 3)).clamp(min=1)
    out = n * (n + 1) * (n - 1) * m4 / (den * safe_m2 * safe_m2) \
        - 3.0 * (n - 1) * (n - 1) / den
    out = torch.where(m2 > 0, out, 0.0)
    return torch.where(cnt >= 4, out, float("nan"))


def _accumulated(op: str, sums, cnt_idx: int, s_idx):
    """One aggregation's (data, valid) from dense_accumulate's f32 sums:
    column cnt_idx counts its rows, column s_idx sums its values."""
    if op in ("count", "size"):
        return sums[cnt_idx].to(torch.int64), None
    if op == "sum":
        return sums[s_idx], None
    cnt = sums[cnt_idx]
    m = sums[s_idx] / cnt.clamp(min=1.0)
    return torch.where(cnt > 0, m, float("nan")), None


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return np.dtype(str(t.dtype).replace("torch.", ""))


# ---------------------------------------------------------------------------
# sort-based local kernel
# ---------------------------------------------------------------------------

def _group_segments(keys: Sequence[Tuple], count: int):
    """Sort rows by keys; return (perm, seg_ids, new_group, padmask_s,
    n_groups). Null-keyed rows are excluded (pandas dropna=True)."""
    data0 = keys[0][0]
    cap = data0.shape[0]
    padmask = K.row_mask(count, cap, data0.device)
    for data, valid in keys:
        if valid is not None:
            padmask = padmask & valid
        if data.is_floating_point():
            padmask = padmask & ~torch.isnan(data)
    operands = []
    for d, v in keys:
        operands.extend(SE.key_operands(d, v, padmask=padmask))
    perm = lexsort_perm(operands)
    padmask_s = padmask[perm]
    diff = torch.zeros(cap, dtype=torch.bool, device=data0.device)
    diff[0] = True
    for data, _ in keys:
        ks = data[perm]
        diff = diff | (ks != torch.roll(ks, 1))
    new_group = padmask_s & diff
    seg = (torch.cumsum(new_group.to(torch.int64), 0) - 1).clamp(min=0)
    return perm, seg, new_group, padmask_s, int(new_group.sum())


def groupby_local(arrays, count: int, specs: Tuple[str, ...],
                  out_capacity: int, num_keys: int):
    """Local groupby by a full row sort.

    arrays: tuple of (data, valid) — the first `num_keys` are key
    columns, the rest align 1:1 with `specs`. Returns (out_keys,
    out_vals, n_groups); outputs sorted by key ascending, packed at the
    front of `out_capacity`."""
    keys = arrays[:num_keys]
    values = arrays[num_keys:]
    perm, seg, new_group, padmask_s, n_groups = _group_segments(keys, count)
    dst = torch.where(new_group, seg, out_capacity)
    out_keys = []
    for data, _ in keys:
        z = torch.zeros(out_capacity + 1, dtype=data.dtype,
                        device=data.device)
        z[dst] = data[perm]
        out_keys.append((z[:out_capacity], None))
    out_vals = []
    segs = SortedSegments(seg, out_capacity, presorted=True)
    for i, ((data, valid), op) in enumerate(zip(values, specs)):
        valid_s = None if valid is None else valid[perm]
        if op.startswith("chan_"):
            out_vals.append(_chan_combine(op, values, i, perm, valid_s, seg,
                                          padmask_s, out_capacity, segs))
        else:
            out_vals.append(_segment_agg(op, data[perm], valid_s, seg,
                                         padmask_s, out_capacity, segs))
    return tuple(out_keys), tuple(out_vals), n_groups


def _chan_combine(op: str, values, i: int, perm, valid_s, seg, padmask_s,
                  out_cap: int, segs: SortedSegments):
    """The exact delta-form Chan combine of per-shard partial rows
    (count n, sum s, centered moments) for value column i; with
    d = mean_i - mean of the group:
      M2 = sum m2_i + n_i d^2
      M3 = sum m3_i + 3 d m2_i + n_i d^3
      M4 = sum m4_i + 4 d m3_i + 6 d^2 m2_i + n_i d^4
    It reads the preceding partial columns in the order _VAR_PARTS,
    _SKEW_PARTS and _KURT_PARTS pin: (count, sum64, m2[, m3])."""
    back = {"chan_m2": 2, "chan_m3": 3, "chan_m4": 4}[op]

    def col(j):
        return values[j][0][perm].to(torch.float64)

    n_s, s_s = col(i - back), col(i - back + 1)
    mk_s = col(i)
    okr = K.value_ok(mk_s, valid_s, padmask_s)
    n_tot = segment_sum(torch.where(okr, n_s, 0.0), seg, out_cap, segs)
    s_tot = segment_sum(torch.where(okr, s_s, 0.0), seg, out_cap, segs)
    mean = s_tot / n_tot.clamp(min=1.0)
    d = s_s / n_s.clamp(min=1.0) - mean[seg.clamp(0, out_cap - 1)]
    if op == "chan_m2":
        # the reference sums the cross term and the m2 column apart
        cross = segment_sum(torch.where(okr, n_s * d * d, 0.0), seg,
                            out_cap, segs)
        m2 = segment_sum(torch.where(okr, mk_s, 0.0), seg, out_cap, segs)
        return m2 + cross, None
    m2_s = col(i - back + 2)
    if op == "chan_m3":
        term = mk_s + 3.0 * d * m2_s + n_s * d * d * d
    else:
        m3_s = col(i - 1)
        term = mk_s + 4.0 * d * m3_s + 6.0 * d * d * m2_s \
            + n_s * d * d * d * d
    return segment_sum(torch.where(okr, term, 0.0), seg, out_cap,
                       segs), None


# ---------------------------------------------------------------------------
# hash-based local kernel (arbitrary key cardinality, no row sort)
# ---------------------------------------------------------------------------

def _hashed_claim(key_arrays, count: int):
    """Claim dense group ids for arbitrary keys (no row sort)."""
    data0 = key_arrays[0][0]
    cap = data0.shape[0]
    padmask = K.row_mask(count, cap, data0.device)
    codes, null_ok = HT.encode_columns(key_arrays, null_equal=False)
    ok = padmask if null_ok is None else (padmask & null_ok)
    T = HT.table_size(cap)
    slot, owner, _r, unresolved = HT.claim_slots(codes, ok, T)
    seg, group_row, n_groups = HT.densify(slot, owner, T)
    return seg, group_row, ok, n_groups, unresolved


def _hashed_agg(arrays, seg, group_row, ok, specs: Tuple[str, ...],
                num_keys: int, ng_cap: int):
    """Aggregate into the ng_cap-sized group space (hash order): f32
    sums, counts and means through one `dense_accumulate` when the group
    space is small (the reference's branch, ops/groupby.py:580-624, gate
    for gate), else segment reductions."""
    keys = arrays[:num_keys]
    values = arrays[num_keys:]
    cap = keys[0][0].shape[0]
    seg = torch.where(seg < ng_cap, seg, ng_cap)
    grs = group_row.clamp(0, cap - 1).to(torch.int64)
    gvalid = (group_row >= 0)[:ng_cap]
    gkeys = tuple(data[grs][:ng_cap] for data, _ in keys)
    # no aggregation (a DISTINCT's groupby): nothing to accumulate
    accumulate = (bool(specs) and ng_cap <= CK.MAX_MATMUL_SLOTS
                  and cap <= (1 << 24)
                  and all(op in ("sum", "count", "size", "mean")
                          for op in specs)
                  and all(op in ("count", "size") or
                          (d.is_floating_point() and d.element_size() <= 4)
                          for (d, _), op in zip(values, specs)))
    if not accumulate:
        segs = SortedSegments(seg, ng_cap)
        gvals = tuple(_segment_agg(op, data, valid, seg, ok, ng_cap, segs)
                      for (data, valid), op in zip(values, specs))
        return gkeys, gvals, gvalid
    live = seg < ng_cap
    ok = ok & live
    cols, oks, plan, voks = [], [], [], {}
    for (d, v), op in zip(values, specs):
        cnt_idx = len(cols)
        cols.append(None)  # ones: the count
        if op == "size":
            oks.append(ok)
            plan.append((op, cnt_idx, None))
            continue
        # one mask per value column, however many aggregations read it
        vok = voks.get(id(d))
        if vok is None:
            vok = voks[id(d)] = K.value_ok(d, v, ok)
        oks.append(vok)
        s_idx = None
        if op in ("sum", "mean"):
            s_idx = len(cols)
            cols.append(d)
            oks.append(vok)
        plan.append((op, cnt_idx, s_idx))
    sums = CK.dense_accumulate(torch.where(live, seg, 0), cols, oks, ng_cap)
    gvals = tuple(_accumulated(op, sums, cnt_idx, s_idx)
                  for op, cnt_idx, s_idx in plan)
    return gkeys, gvals, gvalid


def _hashed_sort_groups(gkeys, gvals, gvalid, out_capacity: int):
    """Sort the group table by keys ascending and emit [out_capacity]
    outputs packed at the front (pandas sort=True)."""
    ng_cap = gvalid.shape[0]
    operands = []
    for a in gkeys:
        operands.extend(SE.key_operands(a, None, padmask=gvalid))
    gperm = lexsort_perm(operands)
    m = min(ng_cap, out_capacity)

    def scatter(a):
        z = torch.zeros(out_capacity, dtype=a.dtype, device=a.device)
        z[:m] = a[gperm][:m]
        return z

    out_keys = tuple((scatter(a), None) for a in gkeys)
    out_vals = tuple((scatter(d), None if v is None else scatter(v))
                     for d, v in gvals)
    return out_keys, out_vals


def groupby_local_hashed_static(arrays, count: int, specs: Tuple[str, ...],
                                out_capacity: int, num_keys: int):
    """The hash groupby with its group space fixed at `out_capacity` (the
    row capacity) instead of sized from the group count: the partial
    stage of the two-phase sharded groupby, as the JAX package runs it
    inside its shard_map body. Returns (out_keys, out_vals, n_groups,
    unresolved)."""
    seg, group_row, ok, ng, unresolved = _hashed_claim(arrays[:num_keys],
                                                       count)
    gkeys, gvals, gvalid = _hashed_agg(arrays, seg, group_row, ok, specs,
                                       num_keys, out_capacity)
    out_keys, out_vals = _hashed_sort_groups(gkeys, gvals, gvalid,
                                             out_capacity)
    return out_keys, out_vals, ng, unresolved


def groupby_local_hashed(arrays, count: int, specs: Tuple[str, ...],
                         out_capacity: int, num_keys: int):
    """Local groupby through the scatter-claim hash table: rows claim
    dense group ids, aggregates run as segment reductions over the
    unsorted rows, and only the group table is sorted.

    Same contract as groupby_local, plus an `unresolved` flag: True means
    the probe-round cap was hit and the caller takes the sort route."""
    from bodo_tpu_torch.table.table import round_capacity

    seg, group_row, ok, ng, unresolved = _hashed_claim(arrays[:num_keys],
                                                       count)
    if unresolved:
        return None, None, 0, True
    cap = arrays[0][0].shape[0]
    ng_cap = min(round_capacity(max(ng, 1)), cap)
    gkeys, gvals, gvalid = _hashed_agg(arrays, seg, group_row, ok, specs,
                                       num_keys, ng_cap)
    out_keys, out_vals = _hashed_sort_groups(gkeys, gvals, gvalid,
                                             out_capacity)
    return out_keys, out_vals, ng, False
