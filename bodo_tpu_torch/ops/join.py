"""Join kernels: the equi-join with exact multi-key matching.

Counterpart of bodo_tpu/ops/join.py for one device:

  1. every probe and build row gets a group id (gid) whose equality is
     key equality: `_union_gids` segments the union of both sides' keys
     with one stable multi-key sort; `_hash_gids` claims the build keys
     in a hash table (ops/hashtable.py) and looks each probe key up with
     `probe_slots` (the `hash_probe` CUDA kernel);
  2. build rows are ordered by gid; per-gid [start, count) ranges come
     from a cumulative sum, and each probe row matches count[gid] rows;
  3. output slot j maps back to its (probe, build) pair with one
     searchsorted over the exclusive cumulative sum of match counts, in
     a capacity fixed beforehand; an overflow flag tells the caller to
     re-run at the exact size from `join_count`.

Every step follows the JAX package's, so the output rows come out in the
same order, not just as the same multiset. Its single multi-operand
stable `lax.sort` becomes successive stable torch sorts
(ops/sort.lexsort_perm), which give the same order.
"""

from __future__ import annotations

from typing import List

import torch

from bodo_tpu_torch.ops import hashtable as HT
from bodo_tpu_torch.ops import kernels as K
from bodo_tpu_torch.ops import sort_encoding as SE
from bodo_tpu_torch.ops.sort import lexsort_perm


def _union_gids(probe_keys, build_keys, p_padmask, b_padmask,
                null_equal: bool = False):
    """Segment the union of probe+build keys; returns (gid_p, gid_b)
    int64. Excluded rows get gid == ucap (a sentinel that matches
    nothing). null_equal=False (SQL): null keys never match.
    null_equal=True (pandas merge): nulls form one group per key
    position and match each other."""
    pcap = probe_keys[0][0].shape[0]
    bcap = build_keys[0][0].shape[0]
    ucap = pcap + bcap
    dev = p_padmask.device
    unionmask = torch.cat([p_padmask, b_padmask])
    operands: List = []
    ukeys = []
    for (pd_, pv), (bd, bv) in zip(probe_keys, build_keys):
        d = torch.cat([pd_, bd.to(pd_.dtype)])
        if pv is None and bv is None:
            v = None
        else:
            pv_ = pv if pv is not None else torch.ones(pcap, dtype=torch.bool,
                                                       device=dev)
            bv_ = bv if bv is not None else torch.ones(bcap, dtype=torch.bool,
                                                       device=dev)
            v = torch.cat([pv_, bv_])
        ukeys.append((d, v))
        nf = SE.null_flag(d, v)
        if not null_equal:
            if nf is not None:
                unionmask = unionmask & ~nf
            operands.extend(SE.key_operands(d, v, padmask=unionmask))
        elif nf is not None:
            # all nulls of this key sort into one block with a constant
            # value encoding (zeroed data): a masked null's payload must
            # not split equal follow-on keys
            dz = torch.where(nf, torch.zeros((), dtype=d.dtype, device=dev),
                             d)
            rank = torch.where(nf, 2, 1).to(torch.int8)
            rank = torch.where(unionmask, rank, 3).to(torch.int8)
            operands.extend([rank, SE.encode_value(dz) ^ SE.SIGN64])
        else:
            operands.extend(SE.key_operands(d, v, padmask=unionmask))
    perm = lexsort_perm(operands)
    umask_s = unionmask[perm]
    diff = torch.zeros(ucap, dtype=torch.bool, device=dev)
    diff[0] = True
    for d, v in ukeys:
        ks = d[perm]
        if null_equal:
            # all nulls (mask or NaN) equal each other and differ from
            # every value (raw NaN != NaN would split them)
            nf = SE.null_flag(d, v)
            if nf is not None:
                ns = nf[perm]
                ks = torch.where(ns, torch.zeros((), dtype=ks.dtype,
                                                 device=dev), ks)
                diff = diff | (ns != torch.roll(ns, 1))
        diff = diff | (ks != torch.roll(ks, 1))
    new_group = umask_s & diff
    seg = (torch.cumsum(new_group.to(torch.int64), 0) - 1).clamp(min=0)
    seg = torch.where(umask_s, seg, ucap)  # sentinel for excluded rows
    gid = torch.empty(ucap, dtype=torch.int64, device=dev)
    gid[perm] = seg
    return gid[:pcap], gid[pcap:]


def _hash_gids(probe_keys, build_keys, p_pad, b_pad,
               null_equal: bool = False):
    """Hash-table alternative to `_union_gids`: build keys claim slots in
    a scatter-claim table, gid = dense build-key group id; probe rows
    look their gid up with `probe_slots`. Duplicate build keys share a
    slot, and the per-gid expansion emits each of them.

    Returns (gid_p, gid_b, unresolved 0-d bool tensor); the sentinel gid
    pcap + bcap marks excluded and unmatched rows. `unresolved` True:
    the probe-round cap was hit and the caller must take the sort path."""
    pcap = probe_keys[0][0].shape[0]
    bcap = build_keys[0][0].shape[0]
    ucap = pcap + bcap
    pcodes, bcodes, p_ok0, b_ok0 = HT.aligned_codes(probe_keys, build_keys,
                                                    null_equal)
    b_ok = b_pad if b_ok0 is None else (b_pad & b_ok0)
    p_ok = p_pad if p_ok0 is None else (p_pad & p_ok0)
    T = HT.table_size(bcap)
    slot_b, owner, _r, un1 = HT.claim_slots(bcodes, b_ok, T)
    seg_b, _group_row, _ng = HT.densify(slot_b, owner, T)
    bidx, un2 = HT.probe_slots(bcodes, owner, pcodes, p_ok, T)
    gid_b = torch.where(b_ok, seg_b.to(torch.int64), ucap)
    gid_p = torch.where(bidx >= 0,
                        seg_b[bidx.clamp(min=0).to(torch.int64)]
                        .to(torch.int64), ucap)
    return gid_p, gid_b, un2 | un1


def _join_plan(probe_keys, build_keys, probe_count: int, build_count: int,
               how: str, null_equal: bool = False, method: str = "sort"):
    pcap = probe_keys[0][0].shape[0]
    bcap = build_keys[0][0].shape[0]
    ucap = pcap + bcap
    dev = probe_keys[0][0].device
    p_pad = K.row_mask(probe_count, pcap, dev)
    b_pad = K.row_mask(build_count, bcap, dev)
    if method == "hash":
        gid_p, gid_b, unresolved = _hash_gids(probe_keys, build_keys,
                                              p_pad, b_pad, null_equal)
    else:
        gid_p, gid_b = _union_gids(probe_keys, build_keys, p_pad, b_pad,
                                   null_equal)
        unresolved = torch.zeros((), dtype=torch.bool, device=dev)

    # order build rows by gid (sentinel rows last)
    b_perm = torch.sort(gid_b, stable=True).indices
    bc = torch.zeros(ucap + 1, dtype=torch.int64, device=dev)
    bc.index_add_(0, gid_b.clamp(max=ucap),
                  torch.ones(bcap, dtype=torch.int64, device=dev))
    bc[ucap] = 0  # the sentinel gid matches nothing
    starts = torch.cumsum(bc, 0) - bc

    keyed = gid_p < ucap  # real probe rows with non-null keys
    gp = gid_p.clamp(max=ucap)
    matches = torch.where(keyed, bc[gp], 0)
    if how in ("left", "outer"):
        L = torch.where(p_pad, matches.clamp(min=1), 0)
    else:  # inner
        L = matches
    offsets = torch.cumsum(L, 0) - L
    total = int(L.sum())

    # full outer: build rows whose gid no real keyed probe row shares are
    # appended after the probe-driven rows (null-key build rows never
    # match, so they are unmatched too)
    unm_idx = None
    n_unm = 0
    if how == "outer":
        pc_per_gid = torch.zeros(ucap + 1, dtype=torch.int64, device=dev)
        pc_per_gid.index_add_(0, gp, (p_pad & keyed).to(torch.int64))
        unmatched_b = b_pad & (
            (gid_b >= ucap) | (pc_per_gid[gid_b.clamp(max=ucap)] == 0))
        (unm_idx,), n_unm = K.compact(
            unmatched_b, (torch.arange(bcap, dtype=torch.int64, device=dev),))
        total += n_unm
    return (gid_p, b_perm, bc, starts, offsets, L, total, p_pad,
            unm_idx, n_unm, unresolved)


def join_count(probe_keys, build_keys, probe_count: int, build_count: int,
               num_keys: int, how: str, null_equal: bool = False,
               method: str = "sort"):
    """Exact output row count of the join (host int), and `unresolved`
    (a 0-d bool tensor, only ever True for method='hash')."""
    plan = _join_plan(probe_keys, build_keys, probe_count, build_count,
                      how, null_equal, method)
    return plan[6], plan[10]


def join_local(probe_arrays, build_arrays, probe_count: int,
               build_count: int, num_keys: int, how: str, out_capacity: int,
               null_equal: bool = False, method: str = "sort"):
    """Materialize the equi-join.

    probe_arrays/build_arrays: tuples of (data, valid); the first
    `num_keys` of each are the join keys (positionally aligned).
    Returns (out_probe, out_build, out_count, overflow, unresolved):
    out_probe holds every probe column gathered per output row,
    out_build every build column (invalid on unmatched left rows);
    out_count and overflow (out_capacity was too small, re-run bigger)
    are host values, unresolved a 0-d bool tensor (method='hash' hit its
    probe-round cap: re-run with method='sort')."""
    probe_keys = probe_arrays[:num_keys]
    build_keys = build_arrays[:num_keys]
    (gid_p, b_perm, bc, starts, offsets, L, total, p_pad,
     unm_idx, n_unm, unresolved) = _join_plan(
        probe_keys, build_keys, probe_count, build_count, how, null_equal,
        method)
    pcap = gid_p.shape[0]
    bcap = b_perm.shape[0]
    ucap = pcap + bcap
    dev = gid_p.device
    total_probe = total - n_unm  # probe-driven rows (== total unless outer)

    j = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    live = j < total
    probe_row = live & (j < total_probe)
    pidx = (torch.searchsorted(offsets, j, right=True) - 1).clamp(0, pcap - 1)
    k = j - offsets[pidx]
    g = gid_p[pidx].clamp(max=ucap)
    matched = probe_row & (k < bc[g])
    bpos = (starts[g] + k).clamp(0, bcap - 1)
    bidx = b_perm[bpos]
    if how == "outer":
        # appended unmatched-build rows: slots [total_probe, total)
        appended = live & (j >= total_probe)
        k_app = (j - total_probe).clamp(0, bcap - 1)
        bidx = torch.where(appended, unm_idx[k_app], bidx)
        build_emit = matched | appended
    else:
        build_emit = matched

    def zero(d):
        return torch.zeros((), dtype=d.dtype, device=dev)

    out_probe = []
    for d, v in probe_arrays:
        od = torch.where(probe_row, d[pidx], zero(d))
        base_v = probe_row if v is None else (probe_row & v[pidx])
        # probe columns are nullable on appended build-only rows
        ov = base_v if how == "outer" else (None if v is None else base_v)
        out_probe.append((od, ov))
    out_build = []
    for d, v in build_arrays:
        od = torch.where(build_emit, d[bidx], zero(d))
        base_v = build_emit if v is None else (build_emit & v[bidx])
        # build-side columns are nullable after a left/outer join
        ov = base_v if how in ("left", "outer") else (
            None if v is None else base_v)
        out_build.append((od, ov))
    return (tuple(out_probe), tuple(out_build), min(total, out_capacity),
            total > out_capacity, unresolved)


def cross_local(probe_arrays, build_arrays, probe_count: int,
                build_count: int, out_capacity: int):
    """Cartesian product in pandas row order (probe-major: each probe row
    paired with every build row in order): output slot j takes probe row
    j // nb and build row j % nb. The caller knows the exact output size
    (probe_count * build_count) beforehand, so there is no overflow
    retry. Returns (out_probe, out_build, out_count)."""
    pcap = probe_arrays[0][0].shape[0]
    bcap = build_arrays[0][0].shape[0]
    dev = probe_arrays[0][0].device
    total = probe_count * build_count
    nb = max(build_count, 1)
    j = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    live = j < total
    pidx = torch.div(j, nb, rounding_mode="floor").clamp(0, pcap - 1)
    bidx = (j % nb).clamp(0, bcap - 1)

    def gather(arrays, idx):
        out = []
        for d, v in arrays:
            od = torch.where(live, d[idx], torch.zeros((), dtype=d.dtype,
                                                       device=dev))
            ov = None if v is None else (live & v[idx])
            out.append((od, ov))
        return tuple(out)

    return (gather(probe_arrays, pidx), gather(build_arrays, bidx),
            min(total, out_capacity))
