"""SQL OVER clauses through the port's BodoSQLContext on the CPU against
bodo_tpu's and against sqlite on the same frames, with the routes each
package takes counted equal (torch_parity.reference_routes):

  1. the twelve queries of tests/test_agg_window.py (SUM, AVG, MIN, MAX,
     COUNT over whole partitions, RANGE and ROWS frames, LEAD, LAG,
     FIRST_VALUE, LAST_VALUE, COUNT(*)), on its frame of integral values
     and on one of float values;
  2. the global ranking of tests/test_distributed_windows.py (RANK,
     DENSE_RANK, ROW_NUMBER and NTILE with ties; DENSE_RANK over a
     string with nulls; a value over SUM(...) OVER ()) and a window over
     GROUP BY (RANK over SUM, a running SUM(SUM(...)));
  3. workloads/windows.WINDOW_SQL, the window queries the chip smoke
     runs at TPC-H scale factor 1, on gen_tpch(n_orders=900);
  4. with a 4-shard mesh in both packages and shard_min_rows 0, so the
     sources are 1D: a partitioned ROWS frame (the shuffle route), the
     global ranking (sample sort and carries) and OVER () (reduce_table
     broadcast).

Tolerances: integers, strings, dates and nulls exactly; float window
sums and means within 64 * 2^-52 * sum(|v|) in absolute terms, the
difference of two prefixes of the whole sorted column in each package
(the port's a Hillis-Steele scan, the reference's a jitted cumsum that
XLA reassociates, ROADMAP F11; sqlite's a running sum); on the integral
frame every sum is exact. One test runs every check (see
tests/torch_parity.py on why each test_torch_* file holds one test).
"""

import numpy as np
import pandas as pd

from tests.torch_parity import (both_configs,  # noqa: F401
                                fresh_observations, port_routes_reset,
                                reference_routes, reference_state,
                                sql_records_digest, torch_one_thread)

EPS = 2.0 ** -52
SHARDS = 4

GLOBAL_RANK = """
    select k, rank() over (order by v) as rk,
           dense_rank() over (order by v) as dr,
           row_number() over (order by v, k) as rn,
           ntile(7) over (order by v, k) as nt
    from t
"""
GROUPED = ("SELECT g, SUM(v) AS tv, "
           "RANK() OVER (ORDER BY SUM(v) DESC) AS rk, "
           "SUM(SUM(v)) OVER (ORDER BY g) AS run "
           "FROM t GROUP BY g")
SHARDED = ("SELECT g, o, SUM(v) OVER (PARTITION BY g ORDER BY o "
           "ROWS BETWEEN 3 PRECEDING AND 1 FOLLOWING) AS s FROM t")


def _float_df(n=60, seed=10):
    r = np.random.default_rng(seed)
    df = pd.DataFrame({"g": r.integers(0, 5, n), "o": r.permutation(n),
                       "v": np.round(r.normal(size=n) * 100, 2) + 0.0})
    df.loc[::11, "v"] = np.nan
    return df


def _rank_frames():
    r = np.random.default_rng(2)
    n = 500
    ranks = pd.DataFrame({"k": np.arange(n, dtype=np.int64),
                          "v": r.integers(0, 40, n),
                          "s": r.choice(["a", "b", "c"], n)})
    strings = pd.DataFrame({
        "k": np.arange(12, dtype=np.int64),
        "s": ["b", "a", None, "c", "a", None, "b", "a", "c", "b", None,
              "a"]})
    share = pd.DataFrame({"k": np.arange(20, dtype=np.int64),
                          "v": np.arange(20) * 1.5})
    return ranks, strings, share


def _sorted(df, keys):
    return df.sort_values(keys).reset_index(drop=True)


def _same(got, want, atol, label: str) -> None:
    """Same columns and dtypes; floats within `atol` (NaN matching; a
    number, or {column: a number or one a row}, 0 for a column it
    lacks), everything else exactly."""
    assert list(got.columns) == list(want.columns), label
    assert len(got) == len(want), label
    for c in want.columns:
        g, w = got[c], want[c]
        assert g.dtype == w.dtype, (label, c, g.dtype, w.dtype)
        if w.dtype.kind == "f":
            a = atol.get(c, 0.0) if isinstance(atol, dict) else atol
            gv, wv = g.to_numpy(np.float64), w.to_numpy(np.float64)
            assert np.array_equal(np.isnan(gv), np.isnan(wv)), (label, c)
            ok = ~np.isnan(wv)
            err = np.abs(gv - wv)[ok]
            assert (err <= np.broadcast_to(a, gv.shape)[ok]).all(), \
                (label, c, err.max())
        else:
            pd.testing.assert_series_equal(g, w, check_exact=True,
                                           obj=f"{label} {c}")


def _sqlite(frames, q):
    import sqlite3
    conn = sqlite3.connect(":memory:")
    for name, df in frames.items():
        df.to_sql(name, conn, index=False)
    out = pd.read_sql_query(q, conn)
    conn.close()
    return out


def _run(ref_ctx, port_ctx, q, keys, atol, label, want_route=None):
    """The query through both contexts (routes counted equal), held to
    each other; returns the port's frame sorted by `keys`."""
    with reference_routes() as ref_routes:
        want = ref_ctx.sql(q).to_pandas()
    routes = port_routes_reset()
    got = port_ctx.sql(q).to_pandas()
    assert routes == ref_routes, (label, routes, ref_routes)
    if want_route is not None:
        assert routes[want_route] >= 1, (label, routes)
    got, want = _sorted(got, keys), _sorted(want, keys)
    _same(got, want, atol, label)
    return got


def _against_sqlite(got, frames, q, keys, atol, label):
    exp = _sorted(_sqlite(frames, q), keys)
    for c in exp.columns:
        np.testing.assert_allclose(
            got[c].astype(float).fillna(-9e9).to_numpy(),
            exp[c].astype(float).fillna(-9e9).to_numpy(), rtol=0,
            atol=atol, err_msg=f"{label} {c}")


def _check_agg_queries(ref_sql, ctx_of):
    from tests.test_agg_window import QUERIES, _df
    for df in (_df(), _float_df()):
        frames = {"t": df}
        ref_ctx, port_ctx = ref_sql.BodoSQLContext(frames), ctx_of(frames)
        atol = 64 * EPS * float(np.nansum(np.abs(df["v"])))
        for q in QUERIES:
            got = _run(ref_ctx, port_ctx, q, ["g", "o"], atol, q)
            _against_sqlite(got, frames, q, ["g", "o"], atol, q)
        got = _run(ref_ctx, port_ctx, GROUPED, ["g"], atol, "grouped",
                   "rank_window_local")
        _against_sqlite(got, frames, GROUPED, ["g"], atol, "grouped")


def _check_global_ranks(ref_sql, ctx_of, want_route):
    ranks, strings, share = _rank_frames()
    got = _run(ref_sql.BodoSQLContext({"t": ranks}), ctx_of({"t": ranks}),
               GLOBAL_RANK, ["k"], 0.0, "global rank", want_route)
    np.testing.assert_array_equal(got["rk"], ranks["v"].rank(
        method="min").astype(np.int64))
    _against_sqlite(got, {"t": ranks}, GLOBAL_RANK, ["k"], 0.0,
                    "global rank")
    q = "select k, dense_rank() over (order by s) as dr from t"
    got = _run(ref_sql.BodoSQLContext({"t": strings}),
               ctx_of({"t": strings}), q, ["k"], 0.0, "strings")
    cats = {"a": 1, "b": 2, "c": 3}
    np.testing.assert_array_equal(
        got["dr"], [cats[v] if isinstance(v, str) else 4
                    for v in strings["s"]])
    q = "select k, v / sum(v) over () as share from t"
    got = _run(ref_sql.BodoSQLContext({"t": share}), ctx_of({"t": share}),
               q, ["k"], 1e-15, "share")
    np.testing.assert_allclose(got["share"], share["v"] / share["v"].sum(),
                               rtol=1e-12)


def _check_window_sql(ref_sql, ctx_of):
    from bodo_tpu_torch.workloads import windows as WN
    from bodo_tpu_torch.workloads.tpch import gen_tpch, sqlite_connection
    data = gen_tpch(n_orders=900, seed=3)
    conn = sqlite_connection(data)
    exp = {q: pd.read_sql_query(sql, conn)
           for q, sql in WN.WINDOW_SQL.items()}
    conn.close()
    atols = WN.sql_atols(data)
    ref_ctx, port_ctx = ref_sql.BodoSQLContext(data), ctx_of(data)
    for q, sql in WN.WINDOW_SQL.items():
        with reference_routes() as ref_routes:
            want = ref_ctx.sql(sql).to_pandas()
        routes = port_routes_reset()
        got = port_ctx.sql(sql).to_pandas()
        assert routes == ref_routes, (q, routes, ref_routes)
        assert len(got) > 1, q
        _same(got, want, atols.get(q, {}), q)
        WN.check_window_sql(got, exp[q], atols.get(q, {}), q)


def test_sql_windows_match_reference_and_sqlite(torch_one_thread):
    import bodo_tpu
    import bodo_tpu.plan.explain  # noqa: F401  (the SQL path's modules,
    import bodo_tpu.plan.physical  # noqa: F401  imported before the
    import bodo_tpu.runtime.elastic  # noqa: F401  digest is taken)
    import bodo_tpu.runtime.stats_store  # noqa: F401
    import bodo_tpu.sql as ref_sql
    import bodo_tpu.sql.plan_cache  # noqa: F401
    import jax
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.sql import BodoSQLContext

    def ctx_of(frames):
        return BodoSQLContext(frames, device="cpu")

    before = sql_records_digest()
    with reference_state(), fresh_observations():
        _check_agg_queries(ref_sql, ctx_of)
        _check_global_ranks(ref_sql, ctx_of, "rank_window_local")
        _check_window_sql(ref_sql, ctx_of)
        ref_mesh = bodo_tpu.make_mesh(jax.devices()[:SHARDS])
        with bodo_tpu.use_mesh(ref_mesh), \
                use_mesh(make_mesh(SHARDS, device="cpu")), \
                both_configs(shard_min_rows=0):
            from tests.test_agg_window import _df
            df = _df(100, seed=2)
            _run(ref_sql.BodoSQLContext({"t": df}), ctx_of({"t": df}),
                 SHARDED, ["g", "o"], 0.0, "1D rows frame",
                 "agg_window_shuffle")
            _check_global_ranks(ref_sql, ctx_of, "rank_window_global")
    assert sql_records_digest() == before
