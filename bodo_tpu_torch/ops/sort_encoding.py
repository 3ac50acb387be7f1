"""Order-preserving 64-bit key encodings for multi-key sorts.

Counterpart of bodo_tpu/ops/sort_encoding.py. The JAX package maps every
key column to a uint64 whose unsigned order equals the logical order.
torch's uint64 support is partial, so here the same 64 bits live in an
int64 tensor: `encode_value` returns bit-identical codes (view them as
uint64 to compare), and `key_operands` flips the sign bit so that
torch's signed sort gives the unsigned order.
"""

from __future__ import annotations

from typing import List

import torch

SIGN64 = -(1 << 63)   # 0x8000000000000000 as an int64


def encode_value(data, ascending: bool = True):
    """uint64 bits (in int64) of an order-preserving, bijective encoding."""
    if data.is_floating_point():
        data = data + 0.0  # -0.0 -> +0.0 (equal keys, one code)
        if data.dtype == torch.float32:
            bits = (data.view(torch.int32).to(torch.int64)
                    & 0xFFFFFFFF) << 32
        else:
            bits = data.view(torch.int64)
        enc = torch.where(bits < 0, ~bits, bits | SIGN64)
    elif data.dtype == torch.bool:
        enc = data.to(torch.int64)
    elif data.dtype == torch.uint64:
        enc = data.view(torch.int64)
    elif data.dtype in (torch.uint8, torch.uint16, torch.uint32):
        enc = data.to(torch.int64)
    else:  # signed ints (incl. dict codes, datetimes)
        enc = data.to(torch.int64) ^ SIGN64
    return ~enc if not ascending else enc


def null_flag(data, valid=None):
    """Boolean null indicator (explicit mask OR float NaN)."""
    null = None
    if valid is not None:
        null = ~valid
    if data.is_floating_point():
        isnan = torch.isnan(data)
        null = isnan if null is None else (null | isnan)
    return null


def key_operands(data, valid=None, ascending: bool = True,
                 na_last: bool = True, padmask=None) -> List:
    """Sort operands for one key column: [rank, value], both ordered by
    torch's signed sort.

    rank orders padding rows last, then nulls per na_last, then real
    values; the value (the encoding with its sign bit flipped) breaks
    ties exactly."""
    enc = encode_value(data, ascending) ^ SIGN64
    null = null_flag(data, valid)
    if null is None and padmask is None:
        return [enc]
    if null is not None:
        rank = torch.where(null, 2 if na_last else 0, 1).to(torch.int8)
    else:
        rank = torch.ones(data.shape, dtype=torch.int8, device=data.device)
    if padmask is not None:
        rank = torch.where(padmask, rank, 3).to(torch.int8)
    return [rank, enc]
