"""The skew-split join of the port (plan/adaptive.try_skew_split_join,
_append_splits; plan/streaming_sharded.append_sharded) against bodo_tpu
on the same inputs, on a CPU mesh of 4 shards, with aqe_skew_min_rows at
1 and bcast_join_threshold at 100 in both packages (so the 500-row build
side is not broadcast whole):

  1. inner and left joins of a probe side whose key 3 owns half the rows
     (one hot key) or keys 3 and 7 a third each (two): the hot rows
     broadcast-join the hot build rows, the cold rows take the shuffle
     join, and the halves append shard by shard (`join_skew_split`,
     `join_broadcast`, `join_shuffle`, `append_sharded`);
  2. every probe row hot: the cold half is empty and the hot join is the
     result;
  3. the bail: the hot key has 150 build rows, over bcast_join_threshold,
     so the plain shuffle join runs;
  4. heat in the sample but not in the data: both packages' `_sample_key`
     stubbed to sample a key the probe side lacks, so no hot probe row
     is found and the plain shuffle join runs;
  5. `_append_splits` called directly: two 1D tables with the same
     dictionaries (append_sharded, the capacity grown to a power of two,
     or kept; columns in another order), other dictionaries, a REP
     table, and a column of a wider dtype (each concat_tables, replicated);
     append_sharded with no state, its schema-drift ValueError, and
     shard_recapacity grown and cut.

Per-shard counts, row order, capacities, dictionaries, validity and data
bit-identical; the routes equal to the reference's. One test runs every
check (see tests/torch_parity.py on why each test_torch_* file holds one
test).
"""

import numpy as np
import pandas as pd
import pytest

from tests.torch_parity import (assert_same_table, both_configs,  # noqa
                                port_routes_reset, reference,
                                reference_routes, to_port,
                                torch_one_thread)

SHARDS = 4
N_PROBE = 2000
N_BUILD = 500


def _probe(r, hot):
    """Probe rows: each key of `hot` owns its share of the rows."""
    k = r.integers(0, N_BUILD, N_PROBE)
    u = r.random(N_PROBE)
    lo = 0.0
    for key, share in hot:
        k = np.where((u >= lo) & (u < lo + share), key, k)
        lo += share
    return pd.DataFrame({
        "k": k.astype(np.int64), "v": r.normal(size=N_PROBE),
        "s": r.choice(["aa", "bb", "cc"], N_PROBE),
        "i": pd.array(np.where(r.random(N_PROBE) < 0.2, None,
                               r.integers(0, 50, N_PROBE)), dtype="Int64"),
    })


def _build(r, hot_dups: int = 0):
    k = np.concatenate([np.arange(N_BUILD), np.full(hot_dups, 3)])
    n = len(k)
    return pd.DataFrame({"k": k.astype(np.int64), "w": r.normal(size=n),
                         "t": r.choice(["x", "y"], n)})


def _check_join(probe_df, build_df, how):
    import bodo_tpu.relational as R
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch import relational as PR

    tl = RefTable.from_pandas(probe_df).shard()
    tr = RefTable.from_pandas(build_df).shard()
    with reference_routes() as ref_routes:
        ref = R.join_tables(tl, tr, ["k"], ["k"], how)
    routes = port_routes_reset()
    port = PR.join_tables(to_port(tl), to_port(tr), ["k"], ["k"], how)
    assert_same_table(port, ref)
    assert routes == ref_routes, (how, routes, ref_routes)
    return {k: v for k, v in routes.items() if v}


def _check_append(a_df, b_df, layouts=("1D", "1D"), b_cols=None,
                  a_per=None):
    """_append_splits of two tables in both packages (`a_per`: the first
    table's capacity a shard)."""
    from bodo_tpu.plan import adaptive as ref_aqe
    from bodo_tpu.plan.streaming_sharded import shard_recapacity
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.plan import adaptive as port_aqe

    ta, tb = (RefTable.from_pandas(df) for df in (a_df, b_df))
    ta, tb = (t.shard() if lay == "1D" else t
              for t, lay in zip((ta, tb), layouts))
    if a_per is not None:
        ta = shard_recapacity(ta, a_per)
    if b_cols is not None:
        tb = tb.select(b_cols)
    with reference_routes() as ref_routes:
        ref = ref_aqe._append_splits(ta, tb)
    routes = port_routes_reset()
    port = port_aqe._append_splits(to_port(ta), to_port(tb))
    assert_same_table(port, ref)
    assert routes == ref_routes
    return port, {k: v for k, v in routes.items() if v}


def _check_streaming_helpers(r):
    from bodo_tpu.plan import streaming_sharded as ref_ss
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.plan import streaming_sharded as port_ss

    small = RefTable.from_pandas(_build(r).iloc[:300]).shard()
    assert_same_table(port_ss.append_sharded(None, to_port(small)),
                      ref_ss.append_sharded(None, small))
    grown = ref_ss.shard_recapacity(small, 256)
    assert_same_table(port_ss.shard_recapacity(to_port(small), 256), grown)
    assert_same_table(port_ss.shard_recapacity(to_port(grown), 130),
                      ref_ss.shard_recapacity(grown, 130))
    wide = RefTable.from_pandas(_build(r).iloc[:300].assign(
        k=lambda d: d["k"].astype(np.float64))).shard()
    narrow = small
    with pytest.raises(ValueError, match="safely cast"):
        ref_ss.append_sharded(narrow, wide)
    with pytest.raises(ValueError, match="safely cast"):
        port_ss.append_sharded(to_port(narrow), to_port(wide))


def test_skew_split_matches_reference(reference):
    import jax
    import bodo_tpu
    from bodo_tpu.plan import adaptive as ref_aqe
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.plan import adaptive as port_aqe

    r = np.random.default_rng(23)
    ref_mesh = bodo_tpu.make_mesh(jax.devices()[:SHARDS])
    with bodo_tpu.use_mesh(ref_mesh), \
            use_mesh(make_mesh(SHARDS, device="cpu")), \
            both_configs(aqe_skew_min_rows=1, bcast_join_threshold=100):
        build = _build(r)
        split = {"join_skew_split": 1, "join_broadcast": 1,
                 "join_shuffle": 1, "append_sharded": 1}
        for how in ("inner", "left"):
            assert _check_join(_probe(r, [(3, 0.5)]), build, how) == split
        assert _check_join(_probe(r, [(3, 0.35), (7, 0.35)]), build,
                           "inner") == split
        # every probe row hot: no cold half
        assert _check_join(_probe(r, [(3, 1.0)]), build, "left") == {
            "join_skew_split": 1, "join_broadcast": 1}
        # the hot key's build rows exceed the broadcast threshold
        assert _check_join(_probe(r, [(3, 0.5)]), _build(r, 150),
                           "inner") == {"join_shuffle": 1}
        # a sample whose hot key the probe side does not hold
        saved = (ref_aqe._sample_key, port_aqe._sample_key)

        def stub(t, name, m):
            return np.full(64, N_BUILD + 7, np.int64), 64
        ref_aqe._sample_key = port_aqe._sample_key = stub
        try:
            assert _check_join(_probe(r, [(3, 0.5)]), build, "inner") == {
                "join_shuffle": 1}
        finally:
            ref_aqe._sample_key, port_aqe._sample_key = saved
        # the two appends of _append_splits
        a, b = _probe(r, []), _probe(r, [])
        # shards of 128 and 512 rows, 128 + 512 > 128 rows: grown
        out, routes = _check_append(a.iloc[:300], b)
        assert routes == {"append_sharded": 1} and out.shard_capacity == 1024
        # 512 + 40 rows within 1024: kept
        out, routes = _check_append(b, a.iloc[:40], a_per=1024,
                                    b_cols=["v", "k", "i", "s"])
        assert routes == {"append_sharded": 1} and out.shard_capacity == 1024
        other = b.assign(s=r.choice(["aa", "zz"], len(b)))
        for pair, layouts in (((a, other), ("1D", "1D")),
                              ((a, b), ("REP", "1D")),
                              ((a, b.assign(i=b["i"].astype("Float64"))),
                               ("1D", "1D"))):
            out, routes = _check_append(*pair, layouts)
            assert routes == {"concat_tables": 1}
            assert out.distribution == "REP"
        _check_streaming_helpers(r)
