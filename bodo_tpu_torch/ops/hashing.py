"""Hashing for shuffle partitioning.

Counterpart of bodo_tpu/ops/hashing.py: the same splitmix64 mixing,
computed on the uint64 bits held in int64 tensors (wrapping multiplies,
masked logical right shifts), bit-identical to the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def as_i64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >= (1 << 63) else c


def shr(x, s: int):
    """Logical right shift of the uint64 bits held in int64 `x`."""
    return (x >> s) & ((1 << (64 - s)) - 1)


_C1 = as_i64(0xBF58476D1CE4E5B9)
_C2 = as_i64(0x94D049BB133111EB)
_SEED_MIX = as_i64(0x9E3779B97F4A7C15)
_NULL_TAG = as_i64(0xDEADBEEFCAFEF00D)


def splitmix64(x):
    """splitmix64 finalizer on uint64 bits in int64 lanes."""
    x = (x ^ shr(x, 30)) * _C1
    x = (x ^ shr(x, 27)) * _C2
    return x ^ shr(x, 31)


def _to_u64(data):
    if data.is_floating_point():
        # canonicalize so equal keys hash equal: -0.0 -> +0.0, all NaN
        # payloads -> one quiet NaN
        data = data + 0.0
        data = torch.where(torch.isnan(data),
                           torch.full((), float("nan"), dtype=data.dtype,
                                      device=data.device), data)
        if data.dtype == torch.float64:
            return data.view(torch.int64)
        return data.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if data.dtype == torch.bool:
        return data.to(torch.int64)
    if data.dtype == torch.uint64:
        return data.view(torch.int64)
    return data.to(torch.int64)


def hash_column(data, valid=None):
    """64-bit hash of one column; nulls (mask or NaN) hash to a fixed tag."""
    h = splitmix64(_to_u64(data))
    null = None
    if valid is not None:
        null = ~valid
    if data.is_floating_point():
        isnan = torch.isnan(data)
        null = isnan if null is None else (null | isnan)
    if null is not None:
        h = torch.where(null, _NULL_TAG, h)
    return h


def hash_columns(cols: Sequence[Tuple], seed: int = 0):
    """Combined hash over several (data, valid) key columns."""
    data0 = cols[0][0]
    acc = torch.full(data0.shape, as_i64(seed + 0x9E3779B97F4A7C15),
                     dtype=torch.int64, device=data0.device)
    for data, valid in cols:
        h = hash_column(data, valid)
        acc = splitmix64(acc ^ (h + _SEED_MIX + (acc << 6) + shr(acc, 2)))
    return acc


def dest_shard(hashes, num_shards: int):
    """Destination shard per row: the uint64 hash modulo `num_shards`."""
    half = shr(hashes, 1) % num_shards
    return ((2 * half + (hashes & 1)) % num_shards).to(torch.int32)
