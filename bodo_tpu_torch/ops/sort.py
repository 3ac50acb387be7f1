"""Local multi-key sort and the distributed sample sort.

Counterpart of bodo_tpu/ops/sort.py. The JAX package sorts all key
operands at once with a stable `lax.sort`; torch sorts one key at a
time, so the same lexicographic, stable order comes from stable sorts
from the last operand to the first.

`sort_sharded` is the sample sort of row-sharded columns: each shard
samples its partition keys, the samples are gathered to every shard,
which picks the same S-1 splitters; `range_partition` (a CUDA kernel,
ops/cuda_kernels.py) sends each row to its splitter range, the rows are
shuffled (parallel/shuffle.py) and each shard sorts what it received.
Partition keys are uint64 in the JAX package; here their bits live in
int64 tensors, shifted logically (`hashing.shr`) and ordered with the
sign bit flipped wherever torch compares or sorts them.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from bodo_tpu_torch.config import config
from bodo_tpu_torch.ops import cuda_kernels as CK
from bodo_tpu_torch.ops import kernels as K
from bodo_tpu_torch.ops import sort_encoding as SE
from bodo_tpu_torch.ops.hashing import shr

# oversampling factor for splitter selection (samples per shard = OS * S)
_OVERSAMPLE = 8
_PAD_KEY = -1  # 0xFFFFFFFFFFFFFFFF: padding and missing samples sort last


def lexsort_perm(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation ordering rows by `operands` lexicographically
    (first operand most significant); ties keep their row order."""
    n = operands[0].shape[0]
    perm = torch.arange(n, device=operands[0].device)
    for op in reversed(operands):
        idx = torch.sort(op[perm], stable=True).indices
        perm = perm[idx]
    return perm


def _sort_operands(keys: Sequence[Tuple], ascending: Sequence[bool],
                   na_last: bool, padmask) -> List:
    ops: List = []
    for (data, valid), asc in zip(keys, ascending):
        ops.extend(SE.key_operands(data, valid, ascending=asc,
                                   na_last=na_last, padmask=padmask))
    return ops


def sort_local(arrays, count: int, num_keys: int,
               ascending: Tuple[bool, ...], na_last: bool = True):
    """Stable multi-key sort of all columns; the first `num_keys` arrays
    are the sort keys. Returns (sorted arrays, perm)."""
    data0 = arrays[0][0]
    padmask = K.row_mask(count, data0.shape[0], data0.device)
    perm = lexsort_perm(_sort_operands(arrays[:num_keys], ascending,
                                       na_last, padmask))
    out = tuple((None if d is None else d[perm],
                 None if v is None else v[perm]) for d, v in arrays)
    return out, perm


def _sort_u64(x):
    """Ascending unsigned order of the uint64 bits held in int64 `x`."""
    return torch.sort(x ^ SE.SIGN64).values ^ SE.SIGN64


def _partition_key(keys: Sequence[Tuple], ascending: Sequence[bool],
                   na_last: bool, padmask):
    """Fold the leading sort key into one uint64 (held in int64) for
    range partitioning: [2 bits rank][62 bits value], the rank ordering
    nulls and padding. Ties from the fold are harmless: rows with equal
    partition keys may land on adjacent shards, which still yields a
    globally sorted concatenation."""
    data, valid = keys[0]
    enc = SE.encode_value(data, ascending[0])
    null = SE.null_flag(data, valid)
    rank = torch.ones(data.shape, dtype=torch.int64, device=data.device)
    if null is not None:
        rank = torch.where(null, 2 if na_last else 0, rank)
    pk = (rank << 62) | shr(enc, 2)
    return torch.where(padmask, pk, _PAD_KEY)


def _splitters(all_samples, num_shards: int):
    """The S-1 even quantiles of one shard's copy of the gathered samples
    [S*k] (missing samples are the padding key)."""
    svalid = all_samples != _PAD_KEY
    s_sorted = _sort_u64(torch.where(svalid, all_samples, _PAD_KEY))
    nvalid = svalid.sum().clamp(min=1)
    spl_idx = (torch.arange(1, num_shards, device=all_samples.device)
               * nvalid) // num_shards
    return s_sorted[spl_idx.clamp(0, all_samples.shape[0] - 1)]


def _sort_sharded_body(arrays, counts, num_keys: int,
                       ascending: Tuple[bool, ...], na_last: bool,
                       bucket_cap: int, num_shards: int):
    """One pass of the sample sort at send-bucket capacity `bucket_cap`.
    Returns (sorted arrays [S * S*C], rows per shard, overflow per
    shard)."""
    from bodo_tpu_torch.parallel import collectives as C
    from bodo_tpu_torch.parallel.shuffle import (_concat_pairs,
                                                 _flatten_with_valids,
                                                 _rebuild_from_flat,
                                                 _shard_arrays, shuffle_rows)
    s = num_shards
    cnts = [int(c) for c in counts]
    shards = _shard_arrays(arrays, s)
    cap = shards[0][0][0].shape[0]
    dev = shards[0][0][0].device

    # 1. sample partition keys at even local quantiles
    k = _OVERSAMPLE * s
    pks, samples = [], []
    for i, shard in enumerate(shards):
        count = cnts[i]
        pk = _partition_key(shard[:num_keys], ascending, na_last,
                            K.row_mask(count, cap, dev))
        idx = (torch.arange(k, device=dev) * max(count, 1)) // k
        smp = _sort_u64(pk)[idx.clamp(0, cap - 1)]
        pks.append(pk)
        samples.append(torch.where(idx < count, smp, _PAD_KEY))
    all_samples = C.all_gather_rows(torch.cat(samples), s)  # [S * S*k]

    # 2. range shuffle: dest = #splitters <= pk (the range_partition
    # kernel, one launch over every shard with its row of splitters,
    # written as the shuffle's destination column), then bucket ->
    # all_to_all -> compact
    spl = torch.stack([_splitters(a, s) for a in all_samples.reshape(s, -1)])
    dest = CK.range_partition(pks, spl)
    flat, slots = _flatten_with_valids(arrays)
    out, cnt2, ovf = shuffle_rows(dest, flat, cnts, s, bucket_cap)
    rebuilt = _rebuild_from_flat(out, slots)

    # 3. final local sort
    parts = [sort_local(shard, int(cnt2[i]), num_keys, ascending,
                        na_last)[0]
             for i, shard in enumerate(_shard_arrays(rebuilt, s))]
    return _concat_pairs(parts), cnt2, ovf


def sort_sharded(arrays, counts, num_keys: int, ascending: Tuple[bool, ...],
                 na_last: bool = True, mesh=None):
    """Distributed sample sort of row-sharded columns (the first
    `num_keys` arrays are the sort keys). Globally sorted result: shard
    i's rows all sort <= shard i+1's rows, each shard locally sorted.
    Send buckets are sized optimistically (cap/S x skew headroom) and
    grown x4 on overflow up to the always-safe bound of cap per (src,
    dest) pair. Returns (sorted arrays, rows per shard as int64 numpy)."""
    from bodo_tpu_torch.parallel import mesh as mesh_mod
    from bodo_tpu_torch.table.table import round_capacity
    m = mesh or mesh_mod.get_mesh()
    s = m.n_shards
    cap = arrays[0][0].shape[0] // s
    bucket_cap = min(round_capacity(
        int(config.shuffle_skew_factor * cap / s) + 64), cap)
    while True:
        out, cnts, ovf = _sort_sharded_body(arrays, counts, num_keys,
                                            tuple(ascending), na_last,
                                            bucket_cap, s)
        if not ovf.any():
            return out, cnts
        if bucket_cap >= cap:
            raise RuntimeError("sort shuffle overflow at safe capacity")
        bucket_cap = min(bucket_cap * 4, cap)
