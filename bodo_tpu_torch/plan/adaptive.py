"""Adaptive query execution: the runtime decisions of the 1D join.

Counterpart of the parts of bodo_tpu/plan/adaptive.py that
relational.join_tables calls:
  - the broadcast promote/demote (`join_broadcast_decision`,
    `should_demote_broadcast`): with `config.mem_governor` on (the
    default), a build side broadcasts while its device bytes fit
    `aqe_bcast_frac` x the memory governor's budget of a shard
    (runtime/memory_governor.py), past the rows rule or against it; off,
    the rows-only rule `bcast_join_threshold` decides;
  - the skew split (`try_skew_split_join`): the probe's join key is
    sampled, and rows of a hot key (>= `aqe_skew_frac` of the sample)
    broadcast-join against the hot build rows, while the cold rest takes
    the shuffle join; `_append_splits` appends the two halves shard by
    shard where both are 1D with the same dictionaries, else through
    `relational.concat_tables`.

The JAX package's decision counters, its key sketch at every shuffle
(`observe_shuffle`) and its suspension during degraded re-runs serve its
tracing and its resilience layer, which the port has not; the route each
join took is in `relational.route_counts`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from bodo_tpu_torch.config import config
from bodo_tpu_torch.runtime.memory_governor import (governor,
                                                    table_device_bytes)


def enabled() -> bool:
    return bool(config.aqe)


def _sample_key(t, name: str, m: int) -> Tuple[np.ndarray, int]:
    """Host sample of a 1D table's key column: a prefix slice per shard.
    Returns (non-null sampled values, sampled rows including nulls)."""
    c = t.column(name)
    per = t.shard_capacity
    take = max(m // max(t.num_shards, 1), 32)
    datas, valids = [], []
    total = 0
    for s in range(t.num_shards):
        n = min(int(t.counts[s]), take)
        if n <= 0:
            continue
        sl = slice(s * per, s * per + n)
        datas.append(c.data[sl].cpu().numpy())
        if c.valid is not None:
            valids.append(c.valid[sl].cpu().numpy())
        total += n
    if not datas:
        return np.empty(0), 0
    d = np.concatenate(datas)
    if c.valid is not None:
        d = d[np.concatenate(valids)]
    return d, total


# ---------------------------------------------------------------------------
# broadcast promote / demote
# ---------------------------------------------------------------------------

def _budget() -> int:
    if not config.mem_governor:
        return 0
    return governor().derived_budget()


def _table_bytes(t) -> int:
    return table_device_bytes(t)


def join_broadcast_decision(build, probe) -> bool:
    """The broadcast-vs-shuffle gate for a join of two 1D tables (True:
    gather the build side). With AQE off this is the rows-only rule;
    with AQE on and a governor budget, the build's device bytes against
    `aqe_bcast_frac` x the budget decide, promoting large but narrow
    builds past the rows threshold and demoting wide ones under it."""
    static = (build.nrows <= config.bcast_join_threshold
              and probe.nrows > 4 * build.nrows)
    if not enabled():
        return static
    if probe.nrows <= 4 * build.nrows:
        return False  # probe too small for a broadcast to pay off
    budget = _budget()
    if budget <= 0:
        return static
    return _table_bytes(build) <= config.aqe_bcast_frac * budget


def should_demote_broadcast(build) -> bool:
    """A replicated build side planned for a broadcast join whose bytes
    exceed the budget's broadcast share is sharded instead (a shuffle
    join), rather than kept whole on every shard."""
    if not enabled():
        return False
    budget = _budget()
    if budget <= 0:
        return False
    from bodo_tpu_torch.parallel import mesh as mesh_mod
    if mesh_mod.num_shards() <= 1 or build.nrows < mesh_mod.num_shards():
        return False
    return _table_bytes(build) > config.aqe_bcast_frac * budget


# ---------------------------------------------------------------------------
# hot-key split before the join shuffle
# ---------------------------------------------------------------------------

def try_skew_split_join(left, right, left_on, right_on, how, suffixes,
                        null_equal: bool):
    """Break shuffle skew: sample the probe's join key; rows carrying a
    hot key (>= aqe_skew_frac of the sample, at most 4 such keys) split
    off and broadcast-join against the hot rows of the build side, while
    the cold rest takes the shuffle join. Every probe row lands in
    exactly one half (null and unmatched keys stay cold), so inner and
    left semantics hold. Returns the joined Table, or None where the
    split does not apply."""
    if not enabled():
        return None
    if how not in ("inner", "left") or len(left_on) != 1:
        return None
    if left.nrows < max(config.aqe_skew_min_rows, 1):
        return None
    from bodo_tpu_torch.parallel import mesh as mesh_mod
    if mesh_mod.num_shards() <= 1:
        return None
    lk, rk = left_on[0], right_on[0]
    c = left.column(lk)
    # integer-typed, null-free probe keys only: the hot and cold masks
    # have no three-valued form, so a null key would leave both halves
    if c.valid is not None or c.dictionary is not None or \
            np.dtype(c.dtype.numpy).kind not in "iu":
        return None
    vals, n = _sample_key(left, lk, 8192)
    if n == 0:
        return None
    uniq, cnts = np.unique(vals, return_counts=True)
    hot = uniq[cnts.astype(np.float64) / n >= config.aqe_skew_frac]
    if hot.size == 0 or hot.size > 4:
        return None

    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.plan.expr import ColRef, IsIn, UnOp
    hotvals = tuple(np.asarray(hot).tolist())
    hot_pred = IsIn(ColRef(lk), hotvals)
    right_hot = R.filter_table(right, IsIn(ColRef(rk), hotvals))
    if right_hot.nrows > config.bcast_join_threshold:
        return None  # the build side is hot too: too big to broadcast
    left_hot = R.filter_table(left, hot_pred)
    if left_hot.nrows == 0:
        return None  # the sample found heat the data does not have
    left_cold = R.filter_table(left, UnOp("~", hot_pred))
    R.route_counts["join_skew_split"] += 1
    hot_out = R.join_tables(left_hot, right_hot.gather(), left_on,
                            right_on, how, suffixes, null_equal=null_equal)
    if left_cold.nrows == 0:
        return hot_out
    cold_out = R._join_sharded(left_cold, right, left_on, right_on, how,
                               suffixes, null_equal=null_equal)
    return _append_splits(hot_out, cold_out)


def _appendable(a, b) -> bool:
    """Whether `append_sharded` takes `b` after `a`: both 1D over the
    same shards, the same columns in the same order, the same
    dictionaries, and every column of `b` casting safely to `a`'s."""
    from bodo_tpu_torch.plan.streaming_sharded import _dicts_compatible
    from bodo_tpu_torch.table.table import ONED
    if a.distribution != ONED or b.distribution != ONED or \
            a.num_shards != b.num_shards or a.names != b.names:
        return False
    return _dicts_compatible(a, b) and all(
        np.can_cast(b.column(n).dtype.numpy, a.column(n).dtype.numpy,
                    casting="safe") for n in a.names)


def _append_splits(a, b):
    """Union of the hot and cold join halves: shard by shard where
    `_appendable`, else through concat_tables (a replicated result)."""
    from bodo_tpu_torch import relational as R
    if set(a.names) == set(b.names) and a.names != b.names:
        b = b.select(a.names)
    if _appendable(a, b):
        from bodo_tpu_torch.plan.streaming_sharded import append_sharded
        return append_sharded(a, b)
    return R.concat_tables([a, b])
