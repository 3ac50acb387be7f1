"""Adaptive query execution: the runtime decisions of the 1D join.

Counterpart of the parts of bodo_tpu/plan/adaptive.py that
relational.join_tables calls: the broadcast-vs-shuffle decision
(`join_broadcast_decision`, `should_demote_broadcast`) and the skew
detection before a shuffle join (`try_skew_split_join`). The JAX
package's decision counters and its key sketch at every shuffle
(`observe_shuffle`) feed only its tracing, which the port has not.

The port has no memory governor yet (bodo_tpu/runtime/memory_governor),
so its budget is 0 and both broadcast decisions take the rows-only rule:
the JAX package's behaviour with `config.mem_governor = False`. Where
the JAX package would split a hot key off a shuffle join, the port
raises NotImplementedError: the split's execution is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from bodo_tpu_torch.config import config


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


def join_broadcast_decision(build, probe) -> bool:
    """The broadcast-vs-shuffle gate for a join of two 1D tables (True:
    gather the build side). Without a governor budget (the JAX package's
    `_budget() <= 0`) this is the rows-only rule."""
    return (build.nrows <= config.bcast_join_threshold
            and probe.nrows > 4 * build.nrows)


def should_demote_broadcast(build) -> bool:
    """A replicated build side too large for the governor's budget is
    sharded instead. The JAX package decides nothing without a budget,
    and the port has none: nothing is demoted."""
    return False


def try_skew_split_join(left, right, left_on, right_on, how, suffixes,
                        null_equal: bool):
    """The hot-key test before a shuffle join, step for step as in the JAX
    package: sample the probe's join key; a key owning at least
    `aqe_skew_frac` of the sample is hot. Returns None where the JAX
    package goes on to the plain shuffle join; raises NotImplementedError
    where it would split the hot rows off into a broadcast join."""
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
    # integer-typed, null-free probe keys only
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
    from bodo_tpu_torch.plan.expr import ColRef, IsIn
    hotvals = tuple(np.asarray(hot).tolist())
    hot_pred = IsIn(ColRef(lk), hotvals)
    right_hot = R.filter_table(right, IsIn(ColRef(rk), hotvals))
    if right_hot.nrows > config.bcast_join_threshold:
        return None  # build itself is hot: broadcast too big
    left_hot = R.filter_table(left, hot_pred)
    if left_hot.nrows == 0:
        return None  # sample found heat the full data doesn't have
    raise NotImplementedError(
        f"try_skew_split_join: the split of hot key(s) {hotvals} off the "
        f"shuffle join (a broadcast join of the hot rows, a shuffle join "
        f"of the rest, appended per shard) is not ported yet")
