"""Local multi-key sort.

Counterpart of `sort_local` in bodo_tpu/ops/sort.py. The JAX package
sorts all key operands at once with a stable `lax.sort`; torch sorts one
key at a time, so the same lexicographic, stable order comes from stable
sorts from the last operand to the first. The distributed sample sort is
a later slice of the port.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from bodo_tpu_torch.ops import kernels as K
from bodo_tpu_torch.ops import sort_encoding as SE


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
