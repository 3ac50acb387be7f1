"""Per-shard re-capacity and append of 1D tables.

Counterpart of the parts of bodo_tpu/plan/streaming_sharded.py that the
skew-split join appends its halves with (plan/adaptive._append_splits):
`shard_recapacity`, `append_sharded` and the dictionary checks
`_dict_template`, `_dicts_match_template` and `_dicts_compatible`. The
JAX package runs each as a jitted shard_map body; here a 1D column is
one tensor of S blocks (parallel/mesh.py), so each is a reshape, a pad
or one indexed copy of all shards at once. The streaming executors of
that module are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from bodo_tpu_torch.table.table import ONED, Column, Table


def _pow2_cap(n: int) -> int:
    """Round a capacity up to a power of two, at least 128 (the JAX
    package's plan/streaming._bucket_cap)."""
    c = 128
    while c < n:
        c <<= 1
    return c


def shard_recapacity(t: Table, new_per: int) -> Table:
    """Change a 1D table's per-shard capacity: each shard's block is cut
    or padded with zeros at its end. Rows stay at the front of each
    shard."""
    if t.distribution != ONED:
        raise ValueError("shard_recapacity needs a row-sharded (1D) table")
    per = t.shard_capacity
    if per == new_per:
        return t
    if new_per < int(t.counts.max(initial=0)):
        raise ValueError(f"shard_recapacity: {new_per} rows a shard cannot "
                         f"hold counts {t.counts.tolist()}")
    s = t.num_shards

    def one(a):
        if a is None:
            return None
        blocks = a.reshape(s, per)
        if new_per <= per:
            return blocks[:, :new_per].reshape(s * new_per)
        return torch.cat([blocks, blocks.new_zeros(s, new_per - per)],
                         1).reshape(s * new_per)

    tree = {n: (one(c.data), one(c.valid)) for n, c in t.columns.items()}
    return t.with_arrays(tree, nrows=t.nrows, counts=t.counts)


def append_sharded(state: Optional[Table], batch: Table) -> Table:
    """Append a 1D batch to a 1D state table shard by shard: shard i of
    the result holds shard i of the state, then shard i of the batch.

    A missing state is the batch at a power-of-two capacity. The capacity
    grows to the next power of two when a shard would overflow. Column
    schemas must match, and a batch column must cast safely to the
    state's dtype (ValueError otherwise); string columns keep the state's
    dictionary, so the caller checks `_dicts_compatible` first."""
    from bodo_tpu_torch import relational as R
    R.route_counts["append_sharded"] += 1
    if state is None:
        cap = _pow2_cap(max(int(batch.counts.max(initial=0)), 1))
        return shard_recapacity(batch, cap)
    if state.names != batch.names:
        raise ValueError(f"append_sharded: batch columns {batch.names} are "
                         f"not the state's {state.names}")
    s = state.num_shards
    sper, bper = state.shard_capacity, batch.shard_capacity
    need = int((state.counts + batch.counts).max(initial=0))
    new_cap = sper if need <= sper else _pow2_cap(need)
    for n in state.names:
        sd = state.column(n).dtype.numpy
        bd = batch.column(n).dtype.numpy
        # a batch dtype wider than the state's would wrap in the cast
        if bd != sd and not np.can_cast(bd, sd, casting="safe"):
            raise ValueError(
                f"append_sharded: batch column {n!r} dtype {bd} does not "
                f"safely cast to state dtype {sd}")
    # every live batch row: its flat position and its place after the
    # state's rows of its shard
    dev = state.device
    shard = torch.arange(s, device=dev).repeat_interleave(bper)
    i = torch.arange(bper, device=dev).repeat(s)
    s0 = torch.from_numpy(state.counts).to(dev)[shard]
    b0 = torch.from_numpy(batch.counts).to(dev)[shard]
    live = i < b0
    src = (shard * bper + i)[live]
    dst = (shard * new_cap + s0 + i)[live]

    def grown(a):
        if new_cap == sper:
            return a.clone()
        blocks = a.reshape(s, sper)
        return torch.cat([blocks, blocks.new_zeros(s, new_cap - sper)],
                         1).reshape(s * new_cap)

    def ones(t):
        return torch.ones(t.capacity, dtype=torch.bool, device=dev)

    cols: Dict[str, Column] = {}
    for n in state.names:
        sc, bc = state.column(n), batch.column(n)
        d = grown(sc.data)
        d[dst] = bc.data[src].to(d.dtype)
        v = None
        if sc.valid is not None or bc.valid is not None:
            v = grown(sc.valid if sc.valid is not None else ones(state))
            v[dst] = (bc.valid if bc.valid is not None else ones(batch))[src]
        cols[n] = Column(d, v, sc.dtype, sc.dictionary)
    counts = state.counts + batch.counts
    return Table(cols, int(counts.sum()), ONED, counts)


def _dict_template(t: Table) -> Dict:
    """Per-column dictionary snapshot."""
    return {n: t.column(n).dictionary for n in t.names}


def _dicts_match_template(tmpl: Optional[Dict], batch: Table) -> bool:
    if tmpl is None:
        return True
    for n, sd in tmpl.items():
        bd = batch.column(n).dictionary
        if sd is None and bd is None:
            continue
        if sd is None or bd is None:
            return False
        if sd is not bd and not (len(sd) == len(bd)
                                 and bool(np.all(sd == bd))):
            return False
    return True


def _dicts_compatible(state: Optional[Table], batch: Table) -> bool:
    if state is None:
        return True
    return _dicts_match_template(_dict_template(state), batch)
