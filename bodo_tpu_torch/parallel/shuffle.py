"""Hash and range shuffles across the mesh's shards, and the two-phase
sharded groupby.

Counterpart of bodo_tpu/parallel/shuffle.py. A shuffle packs each
shard's rows into S send buckets of a fixed capacity C (destination = a
hash or range of the key), exchanges the buckets (`all_to_all_rows`),
and compacts the received rows by the exchanged per-source counts. A row
that does not fit its bucket sets an overflow flag; the host re-runs
with a larger C. Each shard's bucket packing is the `partition_rank`
CUDA kernel (ops/cuda_kernels.py), launched once per shard.

The JAX package runs these bodies inside `shard_map`; here the S shards
share one device (parallel/mesh.py), so every function below takes the
global arrays of S * C rows and per-shard counts, loops its per-shard
body over the shards, and does the collective as a tensor op between
the loops. Per-shard counts come back as int64 numpy arrays [S].
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from bodo_tpu_torch.config import config
from bodo_tpu_torch.ops import cuda_kernels as CK
from bodo_tpu_torch.ops import kernels as K
from bodo_tpu_torch.ops.groupby import (COMBINE_OF, DECOMPOSE, HASH_OPS,
                                        _kurt_from_moments, _np_dtype,
                                        _skew_from_moments, _var_from_m2,
                                        groupby_local,
                                        groupby_local_hashed_static,
                                        result_dtype)
from bodo_tpu_torch.ops.hashing import dest_shard, hash_columns
from bodo_tpu_torch.parallel import collectives as C
from bodo_tpu_torch.parallel import mesh as mesh_mod


# ---------------------------------------------------------------------------
# bucket pack / exchange / compact
# ---------------------------------------------------------------------------

def bucket_rows(dest, arrays: Sequence, count: int, num_shards: int,
                bucket_cap: int):
    """Pack one shard's rows into per-destination buckets of capacity
    `bucket_cap`: a row goes to slot dest * bucket_cap + its stable rank
    among the rows of its destination (`partition_rank`).

    dest: int32 [cap] destination shard per row (padding rows ignored).
    Returns (packed arrays [S*C, ...], send_counts int64 [S], overflow: a
    0-d bool tensor)."""
    cap = dest.shape[0]
    dev = dest.device
    padmask = K.row_mask(count, cap, dev)
    d = torch.where(padmask, dest, num_shards).to(torch.int32)
    live = padmask & (d < num_shards)
    rank, counts = CK.partition_rank(d, live, num_shards)
    ok = live & (rank >= 0) & (rank < bucket_cap)
    overflow = (live & (rank >= bucket_cap)).any()
    total = num_shards * bucket_cap
    scatter_idx = torch.where(ok, d.to(torch.int64) * bucket_cap + rank,
                              total)
    packed = []
    for a in arrays:
        if a is None:
            packed.append(None)
            continue
        # torch has no uint64 index_put: its bits move as int64
        bits = a.view(torch.int64) if a.dtype == torch.uint64 else a
        z = torch.zeros((total + 1,) + tuple(a.shape[1:]), dtype=bits.dtype,
                        device=dev)
        z[scatter_idx] = bits  # rows that do not fit: the dropped slot
        packed.append(z[:total].view(a.dtype))
    send_counts = counts.to(torch.int64).clamp(max=bucket_cap)
    return packed, send_counts, overflow


def exchange_and_compact(packed: Sequence, send_counts, num_shards: int,
                         bucket_cap: int):
    """all_to_all the packed buckets and the counts, then compact each
    shard's received rows to its front.

    packed: global arrays [S * S*C, ...] (shard s's buckets at s*S*C);
    send_counts: int64 [S*S]. Returns (arrays [S * S*C, ...], received
    rows per shard as int64 numpy [S])."""
    s = num_shards
    recvd = [None if a is None else C.all_to_all_rows(a, s) for a in packed]
    rcounts = C.all_to_all_rows(send_counts, s).reshape(s, s)
    total = s * bucket_cap
    slot = torch.arange(total, device=send_counts.device)
    parts = [C.shard_views(a, s) for a in recvd]
    outs: List[List] = [[] for _ in recvd]
    cnts = []
    for i in range(s):
        mask = (slot % bucket_cap) < rcounts[i][slot // bucket_cap]
        out, cnt = K.compact(mask, tuple(p[i] for p in parts))
        for j, o in enumerate(out):
            outs[j].append(o)
        cnts.append(cnt)
    return ([C.concat_shards(o) for o in outs],
            np.array(cnts, dtype=np.int64))


def shuffle_rows(dest, arrays: Sequence, counts, num_shards: int,
                 bucket_cap: int):
    """Full shuffle of row-sharded arrays: bucket -> all_to_all ->
    compact. dest: int32 [S*cap] destination per row; counts: rows per
    shard. Returns (arrays [S * S*C, ...], received rows per shard,
    overflow per shard: bool numpy [S])."""
    s = num_shards
    cnts = [int(c) for c in counts]
    dests = C.shard_views(dest, s)
    views = [C.shard_views(a, s) for a in arrays]
    packed: List[List] = [[] for _ in arrays]
    sends, ovfs = [], []
    for i in range(s):
        p, sc, ovf = bucket_rows(dests[i], [v[i] for v in views], cnts[i],
                                 s, bucket_cap)
        for j, a in enumerate(p):
            packed[j].append(a)
        sends.append(sc)
        ovfs.append(ovf)
    out, cnt = exchange_and_compact([C.concat_shards(p) for p in packed],
                                    torch.cat(sends), s, bucket_cap)
    return out, cnt, torch.stack(ovfs).cpu().numpy()


# ---------------------------------------------------------------------------
# distributed groupby: partial-agg -> hash shuffle -> combine -> finalize
# ---------------------------------------------------------------------------

def _plan_decomposition(specs: Tuple[str, ...]):
    """Map final agg specs to (partial specs, combine specs, layout);
    layout[i] = (offset, n), the slice of partial columns feeding final
    spec i."""
    partial_specs: List[str] = []
    combine_specs: List[str] = []
    layout = []
    for op in specs:
        if op not in DECOMPOSE:
            raise NotImplementedError(
                f"agg '{op}' is not decomposable for the distributed "
                f"two-phase groupby (supported distributed aggs: "
                f"{sorted(DECOMPOSE)})")
        parts = DECOMPOSE[op]
        layout.append((len(partial_specs), len(parts)))
        partial_specs.extend(parts)
        combine_specs.extend(COMBINE_OF[p] for p in parts)
    return tuple(partial_specs), tuple(combine_specs), tuple(layout)


def _finalize(op: str, cols, orig_dtype: np.dtype):
    """The final column from the combined partial columns (laid out as
    DECOMPOSE gives them)."""
    if op == "mean":
        (s, _), (cnt, _) = cols
        rdt = getattr(torch, result_dtype("mean", orig_dtype).name)
        m = s.to(rdt) / cnt.clamp(min=1).to(rdt)
        return torch.where(cnt > 0, m, float("nan")).to(rdt), None
    if op in ("var", "std", "var0", "std0"):
        # (n, sum, M2), M2 merged by the chan_m2 combine
        (cnt, _), _s, (m2, _) = cols
        rdt = getattr(torch, result_dtype(op, orig_dtype).name)
        out = _var_from_m2(m2, cnt, ddof=0 if op.endswith("0") else 1)
        return (torch.sqrt(out) if op.startswith("std") else out).to(rdt), \
            None
    if op == "skew":
        (cnt, _), _s, (m2, _), (m3, _) = cols
        return _skew_from_moments(cnt, m2, m3), None
    if op == "kurt":
        (cnt, _), _s, (m2, _), _m3, (m4, _) = cols
        return _kurt_from_moments(cnt, m2, m4), None
    return cols[0]


def _flatten_with_valids(arrays):
    """Data and validity arrays in one list (validity masks ride next to
    their data), and which columns had a validity mask."""
    flat, slots = [], []
    for d, v in arrays:
        flat.append(d)
        slots.append(v is not None)
        if v is not None:
            flat.append(v)
    return flat, slots


def _rebuild_from_flat(flat, slots):
    out, j = [], 0
    for has_v in slots:
        if has_v:
            out.append((flat[j], flat[j + 1].to(torch.bool)))
            j += 2
        else:
            out.append((flat[j], None))
            j += 1
    return tuple(out)


def _shard_arrays(arrays, num_shards: int):
    """Per shard, the (data, valid) pairs of row-sharded arrays."""
    views = [(C.shard_views(d, num_shards), C.shard_views(v, num_shards))
             for d, v in arrays]
    return [tuple((d[i], v[i]) for d, v in views) for i in range(num_shards)]


def _concat_pairs(per_shard):
    """Global (data, valid) pairs from per-shard lists of pairs."""
    return tuple((C.concat_shards([p[j][0] for p in per_shard]),
                  C.concat_shards([p[j][1] for p in per_shard]))
                 for j in range(len(per_shard[0])))


def _groupby_partial(arrays, counts, num_keys: int, specs: Tuple[str, ...],
                     method: str, num_shards: int):
    """Stage 1: each shard aggregates its own rows into partials (hashed,
    or by a row sort). Returns ((partial keys, partial values), partial
    groups per shard, unresolved per shard)."""
    partial_specs, _, _ = _plan_decomposition(specs)
    cnts = [int(c) for c in counts]
    pk_parts, pv_parts, ngs, unres = [], [], [], []
    for i, shard in enumerate(_shard_arrays(arrays, num_shards)):
        cap = shard[0][0].shape[0]
        keys = shard[:num_keys]
        values = shard[num_keys:]
        p_inputs = tuple(keys) + tuple(
            values[j] for j, op in enumerate(specs) for _ in DECOMPOSE[op])
        if method == "hash":
            pk, pv, ng, un = groupby_local_hashed_static(
                p_inputs, cnts[i], partial_specs, cap, num_keys)
        else:
            pk, pv, ng = groupby_local(p_inputs, cnts[i], partial_specs,
                                       cap, num_keys)
            un = False
        pk_parts.append(pk)
        pv_parts.append(pv)
        ngs.append(ng)
        unres.append(bool(un))
    return ((_concat_pairs(pk_parts), _concat_pairs(pv_parts)),
            np.array(ngs, dtype=np.int64), unres)


def shuffle_partials(pk, pv, num_keys: int, num_shards: int,
                     bucket_cap: int, ngs):
    """Hash-shuffle packed groupby partials to their owner shard.

    pk/pv: key / partial-value (data, valid) pairs, each shard's `ngs[i]`
    live rows packed at its front. Validity masks ride the wire next to
    their data column; keys come back maskless. Returns (recv_keys,
    recv_vals, recv_count per shard, overflow per shard)."""
    dest = dest_shard(hash_columns(pk), num_shards)
    flat: List = [d for d, _ in pk]
    has_valid: List[bool] = []
    for d, v in pv:
        flat.append(d)
        has_valid.append(v is not None)
        if v is not None:
            flat.append(v)
    out, cnt, ovf = shuffle_rows(dest, flat, ngs, num_shards, bucket_cap)
    rk = tuple((out[i], None) for i in range(num_keys))
    rv = _rebuild_from_flat(out[num_keys:], has_valid)
    return rk, rv, cnt, ovf


def _groupby_combine(partials, ngs, num_keys: int, specs: Tuple[str, ...],
                     value_dtypes: Tuple, bucket_cap: int, final_cap: int,
                     num_shards: int):
    """Stage 2: hash-shuffle the partial rows at bucket capacity
    `bucket_cap`, then combine and finalize on each shard."""
    _, combine_specs, layout = _plan_decomposition(specs)
    pk, pv = partials
    rk, rv, cnt2, ovf = shuffle_partials(pk, pv, num_keys, num_shards,
                                         bucket_cap, ngs)
    keys_parts, final_parts, ng2 = [], [], []
    for i, shard in enumerate(_shard_arrays(rk + rv, num_shards)):
        fk, fv, ng = groupby_local(shard, int(cnt2[i]), combine_specs,
                                   final_cap, num_keys)
        finals = []
        for j, op in enumerate(specs):
            off, n = layout[j]
            finals.append(_finalize(op, fv[off:off + n], value_dtypes[j]))
        keys_parts.append(fk)
        final_parts.append(tuple(finals))
        ng2.append(ng)
    return ((_concat_pairs(keys_parts), _concat_pairs(final_parts)),
            np.array(ng2, dtype=np.int64), ovf)


def groupby_sharded(arrays, counts, num_keys: int, specs: Tuple[str, ...],
                    bucket_cap: Optional[int] = None,
                    final_cap: Optional[int] = None, mesh=None):
    """Distributed two-phase groupby over row-sharded arrays.

    arrays: (data, valid) pairs, data [S*cap]; counts: rows per shard.
    Returns ((out_keys, out_finals), groups per shard, overflow per
    shard, the method of the partial stage: "hash" or "sort").

    After the partial stage the host reads the per-shard partial counts
    and sizes the shuffle buckets tightly (expected rows per (src, dest)
    pair x skew headroom), growing them x4 on overflow up to the
    always-safe bound (the largest partial count). A hashed partial
    stage that does not resolve on some shard is re-run by sort."""
    from bodo_tpu_torch.table.table import round_capacity
    m = mesh or mesh_mod.get_mesh()
    s = m.n_shards
    value_dtypes = tuple(_np_dtype(arrays[num_keys + i][0])
                         for i in range(len(specs)))
    method = "sort"
    if config.hash_groupby:
        try:
            partial_specs, _, _ = _plan_decomposition(specs)
            if all(p in HASH_OPS for p in partial_specs):
                method = "hash"
        except NotImplementedError:
            pass
    while True:
        partials, ngs, unres = _groupby_partial(arrays, counts, num_keys,
                                                specs, method, s)
        if method == "hash" and any(unres):
            method = "sort"  # pathological keys on some shard
            continue
        break
    max_png = int(ngs.max()) if len(ngs) else 0
    safe_cap = round_capacity(max(max_png, 1))
    if bucket_cap is None:
        bucket_cap = round_capacity(
            int(config.shuffle_skew_factor * max(max_png, 1) / s) + 64)
        bucket_cap = min(bucket_cap, safe_cap)
    while True:
        fcap = final_cap if final_cap is not None else s * bucket_cap
        out, ng2, ovf = _groupby_combine(partials, ngs, num_keys, specs,
                                         value_dtypes, bucket_cap, fcap, s)
        if not ovf.any():
            return out, ng2, ovf, method
        if bucket_cap >= safe_cap:
            raise RuntimeError("groupby shuffle overflow at safe capacity")
        bucket_cap = min(bucket_cap * 4, safe_cap)
