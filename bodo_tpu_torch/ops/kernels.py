"""Shared kernel utilities: padding masks, null handling, compaction.

Counterpart of bodo_tpu/ops/kernels.py. Arrays are fixed-capacity; the
first `count` rows are real, the rest is padding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def row_mask(count: int, capacity: int, device) -> torch.Tensor:
    """Boolean mask of real (non-padding) rows."""
    return torch.arange(capacity, device=device) < count


def shard_row_mask(counts, shard_capacity: int, device) -> torch.Tensor:
    """Real-row mask of a row-sharded array: shard i's first counts[i]
    rows of its block of `shard_capacity`."""
    s = len(counts)
    c = torch.as_tensor([int(x) for x in counts], dtype=torch.int64,
                        device=device)
    pos = torch.arange(shard_capacity, device=device)
    return (pos[None, :] < c[:, None]).reshape(s * shard_capacity)


def value_ok(data, valid, padmask):
    """Mask of rows whose value takes part in aggregation: real row AND
    not null (explicit mask or float NaN)."""
    ok = padmask
    if valid is not None:
        ok = ok & valid
    if data.is_floating_point():
        ok = ok & ~torch.isnan(data)
    return ok


def compact(mask, arrays: Tuple, capacity_out: Optional[int] = None):
    """Stable-compact rows where `mask` is True to the front.

    Returns (compacted arrays, the number of live rows in `mask` as a
    host int). As in the JAX package, that count is taken before the cut
    to `capacity_out`, so a count above it reports an overflow; rows past
    the kept ones are zero."""
    cap = mask.shape[0]
    out_cap = capacity_out if capacity_out is not None else cap
    live = torch.nonzero(mask).squeeze(1)  # ascending: stable
    idx = live[:out_cap]
    n = idx.numel()
    outs = []
    for a in arrays:
        if a is None:
            outs.append(None)
            continue
        z = torch.zeros((out_cap,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=a.device)
        z[:n] = a[idx]
        outs.append(z)
    return tuple(outs), live.numel()


def gather_rows(perm, arrays: Tuple):
    """Apply a row permutation/selection index to several arrays."""
    return tuple(None if a is None else a[perm] for a in arrays)
