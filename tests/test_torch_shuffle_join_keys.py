"""The 1D shuffle join of the port (relational._join_sharded after
shuffle_by_key on both sides) against bodo_tpu on the same inputs, past
the one int64 key of tests/test_torch_graft.py, on a CPU mesh of 4
shards with bcast_join_threshold at 0 in both packages (so neither
broadcasts):

  - a string key whose dictionaries differ between the sides (each side
    has values the other lacks) and whose values differ between shards
    (the left side sorted by the key, so each shard holds its own range);
  - two keys, int64 and string;
  - null keys (a string key with nulls beside a nullable int64 key)
    with null_equal=False (SQL: nulls never match) and True (pandas:
    nulls match each other);
each as an inner, a left and an outer join. Per-shard counts, row
order, capacities, dictionaries, validity and data bit-identical, float64
columns exact (they are only moved); the routes (`join_shuffle`) equal
to the reference's. One test runs every check (see tests/torch_parity.py
on why each test_torch_* file holds one test).
"""

import numpy as np
import pandas as pd

from tests.torch_parity import (assert_same_table, both_configs,  # noqa
                                port_routes_reset, reference,
                                reference_routes, to_port,
                                torch_one_thread)

HOWS = ("inner", "left", "outer")
SHARDS = 4


def _frames(r, n: int):
    lw = np.array([f"w{i:02d}" for i in range(0, 30)])
    rw = np.array([f"w{i:02d}" for i in range(10, 45, 2)])
    left = pd.DataFrame({
        "s": np.sort(r.choice(lw, n)),
        "k": r.integers(0, 6, n).astype(np.int64),
        "v": r.normal(size=n),
    })
    m = n // 3
    right = pd.DataFrame({
        "s": r.choice(rw, m),
        "k": r.integers(0, 6, m).astype(np.int64),
        "w": r.normal(size=m),
    })
    return left, right


def _with_nulls(r, df, frac: float):
    out = df.copy()
    n = len(df)
    out["k"] = pd.array(np.where(r.random(n) < frac, None, df["k"]),
                        dtype="Int64")
    s = df["s"].to_numpy(dtype=object).copy()
    s[r.random(n) < frac] = None
    out["s"] = s
    return out


def _check(left, right, keys, how, null_equal=True):
    import bodo_tpu.relational as R
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch import relational as PR

    tl = RefTable.from_pandas(left).shard()
    tr = RefTable.from_pandas(right).shard()
    with reference_routes() as ref_routes:
        ref = R.join_tables(tl, tr, keys, keys, how, null_equal=null_equal)
    routes = port_routes_reset()
    port = PR.join_tables(to_port(tl), to_port(tr), keys, keys, how,
                          null_equal=null_equal)
    assert_same_table(port, ref)
    assert routes == ref_routes, (keys, how, null_equal)
    assert routes["join_shuffle"] == 1, (keys, how, routes)
    return port


def test_shuffle_join_keys_match_reference(reference):
    import jax
    import bodo_tpu
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh

    r = np.random.default_rng(11)
    ref_mesh = bodo_tpu.make_mesh(jax.devices()[:SHARDS])
    with bodo_tpu.use_mesh(ref_mesh), \
            use_mesh(make_mesh(SHARDS, device="cpu")), \
            both_configs(bcast_join_threshold=0):
        left, right = _frames(r, 900)
        nl, nr = _with_nulls(r, left, 0.1), _with_nulls(r, right, 0.1)
        for how in HOWS:
            out = _check(left, right, ["s"], how)
            if how == "inner":
                want = left.merge(right, on="s")
                assert out.nrows == len(want)
            _check(left, right, ["k", "s"], how)
            for null_equal in (False, True):
                _check(nl, nr, ["s", "k"], how, null_equal)
