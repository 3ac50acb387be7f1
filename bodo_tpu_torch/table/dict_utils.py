"""Dictionary (string) column utilities: unification and re-encoding.

Counterpart of bodo_tpu/table/dict_utils.py. Dictionaries are host-side
sorted numpy string arrays; unification is a host `np.union1d` plus a
device gather that remaps the int32 codes (order-preserving, since
dictionaries stay sorted). The JAX package memoizes unions by object id
for its jit caches; the port compiles nothing per dictionary, so it
keeps no such cache.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from bodo_tpu_torch.table.table import Column


def _union(dicts: List[np.ndarray]) -> np.ndarray:
    union = dicts[0]
    for d in dicts[1:]:
        union = np.union1d(union, d)
    # prefer an existing object when the union adds nothing
    for d in dicts:
        if len(d) == len(union) and np.array_equal(d, union):
            return d
    return union


def unify_dictionaries(cols: Sequence[Column]
                       ) -> Tuple[np.ndarray, List[Column]]:
    """Re-encode string columns onto a shared sorted dictionary.

    Returns (union_dictionary, new columns with remapped codes)."""
    dicts = [c.dictionary if c.dictionary is not None
             else np.array([], dtype=str) for c in cols]
    union = _union(dicts) if len(dicts) > 1 else dicts[0]
    out = []
    for c, d in zip(cols, dicts):
        if len(d) == len(union) and (len(d) == 0 or np.array_equal(d, union)):
            out.append(Column(c.data, c.valid, c.dtype, union))
            continue
        mapping = np.searchsorted(union, d).astype(np.int32)
        mp = torch.from_numpy(mapping if len(mapping)
                              else np.zeros(1, np.int32)).to(c.data.device)
        new_codes = mp[c.data.clamp(0, max(len(d) - 1, 0)).long()]
        out.append(Column(new_codes, c.valid, c.dtype, union))
    return union, out
