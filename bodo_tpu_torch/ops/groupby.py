"""Groupby aggregation kernels.

Counterpart of bodo_tpu/ops/groupby.py for the routes of the one-GPU
relational path: segment reductions (`_segment_agg`) for size, count,
sum and mean; the scatter-claim hash groupby (`groupby_local_hashed`);
and the sort-based `groupby_local` that the JAX package itself takes when
the hash route does not resolve. Other aggregations raise
NotImplementedError until a later slice ports them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from bodo_tpu_torch.ops import hashtable as HT
from bodo_tpu_torch.ops import kernels as K
from bodo_tpu_torch.ops import sort_encoding as SE
from bodo_tpu_torch.ops.sort import lexsort_perm
from bodo_tpu_torch.table import dtypes as dt

# ops the JAX package's hash route accepts (its gate, kept so both
# packages take the same route); of these the port computes _PORTED
HASH_OPS = frozenset({
    "count", "size", "sum", "sumnull", "sum64", "prod", "min", "max",
    "first", "last", "mean", "var", "std", "var0", "std0",
    "m2", "m3", "m4", "skew", "kurt",
})
_PORTED = ("count", "size", "sum", "mean")


def result_dtype(op: str, d: np.dtype) -> np.dtype:
    d = np.dtype(d)
    if op in ("count", "size"):
        return np.dtype(np.int64)
    if op == "mean":
        return np.dtype(np.float32) if d == np.float32 \
            else np.dtype(np.float64)
    if op == "sum":
        if d.kind == "f":
            return d
        return np.dtype(np.uint64) if d.kind == "u" else np.dtype(np.int64)
    raise NotImplementedError(f"aggregation {op!r} is not ported yet")


def agg_dtype(op: str, src: dt.DType) -> dt.DType:
    """Logical result DType of an aggregation."""
    if op in ("count", "size"):
        return dt.INT64
    if dt.is_decimal(src):
        raise NotImplementedError(
            f"aggregation {op!r} over decimals is not ported yet")
    return dt.from_numpy(result_dtype(op, src.numpy))


def segment_sum(x, seg, n: int):
    """Sum of `x` per segment id in [0, n); other ids are dropped (the
    out-of-range rule of jax.ops.segment_sum)."""
    idx = torch.where((seg >= 0) & (seg < n), seg, n).to(torch.int64)
    out = torch.zeros(n + 1, dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx, x)[:n]


def _segment_agg(op: str, v, valid, seg, padmask, out_cap: int):
    """One primitive aggregation. Returns (data, valid)."""
    if op not in _PORTED:
        raise NotImplementedError(f"aggregation {op!r} is not ported yet")
    ok = K.value_ok(v, valid, padmask)
    cnt = segment_sum(ok.to(torch.int64), seg, out_cap)
    if op == "count":
        return cnt, None
    if op == "size":
        return segment_sum(padmask.to(torch.int64), seg, out_cap), None
    rdt = dt.TORCH_OF[result_dtype(op, _np_dtype(v)).name]
    s = segment_sum(torch.where(ok, v.to(rdt), 0).to(rdt), seg, out_cap)
    if op == "sum":
        return s, None
    m = s / cnt.clamp(min=1)
    return torch.where(cnt > 0, m, float("nan")).to(rdt), None


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
    for (data, valid), op in zip(values, specs):
        out_vals.append(_segment_agg(
            op, data[perm], None if valid is None else valid[perm], seg,
            padmask_s, out_capacity))
    return tuple(out_keys), tuple(out_vals), n_groups


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
    """Aggregate into the ng_cap-sized group space (hash order) by
    segment reductions. The JAX package's one-hot matmul route for small
    f32 group spaces is a TPU route the port has not taken on."""
    keys = arrays[:num_keys]
    values = arrays[num_keys:]
    cap = keys[0][0].shape[0]
    seg = torch.where(seg < ng_cap, seg, ng_cap)
    grs = group_row.clamp(0, cap - 1).to(torch.int64)
    gvalid = (group_row >= 0)[:ng_cap]
    gkeys = tuple(data[grs][:ng_cap] for data, _ in keys)
    gvals = tuple(_segment_agg(op, data, valid, seg, ok, ng_cap)
                  for (data, valid), op in zip(values, specs))
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
