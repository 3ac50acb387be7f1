"""Scatter-claim hash table: arbitrary-cardinality group ids without sorting.

Counterpart of bodo_tpu/ops/hashtable.py (`claim_slots`, `densify`, the
join probe `probe_slots`, the key encodings). All rows claim table slots
in parallel with a scatter-min, and unresolved rows re-probe in
lock-step rounds (double hashing). The 64-bit arithmetic runs on uint64
bits held in int64 tensors and is bit-identical to the JAX package, so
both pick the same slots. The probe walk is the hand-written CUDA
kernel `hash_probe` (ops/cuda_kernels.py) at every table size.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from bodo_tpu_torch.ops import cuda_kernels as CK
from bodo_tpu_torch.ops import sort_encoding as SE
from bodo_tpu_torch.ops.hashing import as_i64, shr

# murmur3 fmix64 constants — the standard 64-bit avalanche finalizer
_M1 = as_i64(0xFF51AFD7ED558CCD)
_M2 = as_i64(0xC4CEB9FE1A85EC53)
_GOLD = as_i64(0x9E3779B97F4A7C15)  # 2^64/phi, for multi-key combine
_H0 = as_i64(0x5851F42D4C957F2D)

# rows that fail to resolve within this many probe rounds make the caller
# take its sort-based route (practically unreachable at load 0.5)
MAX_ROUNDS = 64
_BIG = 2 ** 31 - 1


def _fmix64(x):
    x = x ^ shr(x, 33)
    x = x * _M1
    x = x ^ shr(x, 33)
    x = x * _M2
    return x ^ shr(x, 33)


def combine_hash(codes: Sequence):
    """One 64-bit hash per row from bijective per-column 64-bit codes."""
    h = torch.full(codes[0].shape, _H0, dtype=torch.int64,
                   device=codes[0].device)
    for c in codes:
        h = _fmix64(h ^ c) + _GOLD
    return _fmix64(h)


def encode_columns(key_arrays: Sequence[Tuple], null_equal: bool = True):
    """(codes, ok) for hashing/equality: one bijective 64-bit code per key
    column. With `null_equal`, nulls get an extra 0/1 code column; without,
    null-keyed rows drop out through `ok` (groupby dropna semantics)."""
    return encode_columns_aligned(key_arrays, (False,) * len(key_arrays),
                                  null_equal)


def encode_columns_aligned(key_arrays: Sequence[Tuple],
                           null_cols: Sequence[bool],
                           null_equal: bool = True):
    """Like encode_columns, with a caller-fixed per-key null-column layout
    so the two sides of a join encode to structurally identical code
    tuples even when only one side is nullable. `null_cols[i]` is True
    when key i gets a null code column (the OR of both sides'
    nullability, or True throughout)."""
    codes = []
    ok = None
    for (data, valid), want_null in zip(key_arrays, null_cols):
        enc = SE.encode_value(data)
        null = SE.null_flag(data, valid)
        if null is None and want_null:
            null = torch.zeros(data.shape, dtype=torch.bool,
                               device=data.device)
        if null is not None:
            if null_equal:
                codes.append(null.to(torch.int64))
                enc = torch.where(null, 0, enc)
            else:
                ok = ~null if ok is None else (ok & ~null)
        codes.append(enc)
    return tuple(codes), ok


def aligned_codes(probe_keys: Sequence[Tuple], build_keys: Sequence[Tuple],
                  null_equal: bool):
    """Encode two positionally aligned key sets into structurally
    identical code tuples: build keys cast to the probe dtypes, one
    null-column layout for both sides. Returns (pcodes, bcodes, p_ok,
    b_ok), ok = None where no rows are excluded."""
    bkeys = tuple((bd.to(pd_.dtype), bv)
                  for (pd_, _pv), (bd, bv) in zip(probe_keys, build_keys))
    null_cols = tuple(
        SE.null_flag(pd_, pv) is not None
        or SE.null_flag(bd, bv) is not None
        for (pd_, pv), (bd, bv) in zip(probe_keys, bkeys))
    bcodes, b_ok = encode_columns_aligned(bkeys, null_cols, null_equal)
    pcodes, p_ok = encode_columns_aligned(probe_keys, null_cols,
                                          null_equal)
    return pcodes, bcodes, p_ok, b_ok


def table_size(capacity: int) -> int:
    """Power-of-two claim-table size at load factor <= 0.5."""
    t = 16
    while t < 2 * max(capacity, 1):
        t <<= 1
    return t


def claim_slots(codes: Tuple, ok, T: int, max_rounds: int = MAX_ROUNDS):
    """Give every ok row a slot in [0, T): equal keys share a slot,
    distinct keys get distinct slots.

    Returns (slot int32[N] (-1 for !ok), owner int32[T] (claiming row id
    per slot, -1 empty), rounds used, unresolved: True means some row
    never resolved and the caller must take another route)."""
    n = codes[0].shape[0]
    dev = codes[0].device
    mask = T - 1
    h = combine_hash(codes)
    # odd step: the probe sequence cycles through all T slots
    step = (_fmix64(h ^ _GOLD) | 1) & mask
    h = h & mask
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    slot = torch.where(ok, -1, -2).to(torch.int32)
    owner = torch.full((T,), -1, dtype=torch.int32, device=dev)
    r = 0
    while r < max_rounds and bool((slot == -1).any()):
        un = slot == -1
        p = ((h + r * step) & mask).to(torch.int64)
        # claim: the smallest probing row id wins each still-empty slot
        cand = torch.where(un, rows, _BIG)
        claim = torch.full((T,), _BIG, dtype=torch.int32, device=dev)
        claim.scatter_reduce_(0, p, cand, reduce="amin", include_self=True)
        owner = torch.where((owner < 0) & (claim < _BIG), claim, owner)
        # match: probing rows whose slot owner holds an equal key resolve
        o = owner[p]
        osafe = o.clamp(min=0).to(torch.int64)
        eq = o >= 0
        for c in codes:
            eq = eq & (c[osafe] == c)
        slot = torch.where(un & eq, p.to(torch.int32), slot)
        r += 1
    unresolved = bool((slot == -1).any())
    return torch.where(slot < 0, -1, slot), owner, r, unresolved


def densify(slot, owner, T: int):
    """Map claim-table slots to dense group ids [0, n_groups).

    Returns (seg int32[N] — dense group id per row, N for !ok rows;
    group_row int32[N] — a representative source row per dense group id,
    packed at the front; n_groups as a host int)."""
    n = slot.shape[0]
    present = owner >= 0
    newid = torch.cumsum(present.to(torch.int32), 0, dtype=torch.int32) - 1
    n_groups = int(newid[-1]) + 1
    seg = torch.where(slot >= 0,
                      newid[slot.clamp(min=0).to(torch.int64)], n)
    # representative row per dense group (ids are unique; the extra slot
    # n takes the writes of empty table slots and is cut off)
    buf = torch.full((n + 1,), -1, dtype=torch.int32, device=slot.device)
    dst = torch.where(present, newid, n).clamp(max=n).to(torch.int64)
    buf[dst] = owner.clamp(min=0)
    return seg.to(torch.int32), buf[:n], n_groups


def probe_slots(build_codes: Sequence, owner, probe_codes: Sequence, ok,
                T: int, max_rounds: int = MAX_ROUNDS):
    """For each probe row, the build row with an equal key, else -1.

    Follows claim_slots' double-hash sequence; a probe ends on a key
    match (hit) or an empty slot (miss). Returns (idx int32[M],
    unresolved 0-d bool tensor: some ok row was still walking after
    `max_rounds`). Nothing here syncs with the host."""
    mask = T - 1
    h = combine_hash(probe_codes)
    step = (_fmix64(h ^ _GOLD) | 1) & mask
    h = h & mask
    return CK.hash_probe(build_codes, owner, probe_codes, ok, h, step, T,
                         max_rounds)
