"""The holistic aggregations of the port against bodo_tpu on the same
inputs: nunique, mode, median and quantile_<q>, which no per-shard
partial decomposes, so both packages compute them by a re-sort of each
group's rows by value.

  1. ops/sort_encoding.decode_value: the exact inverse of encode_value
     for float32, float64, bool, unsigned and signed integers, and the
     reference's decode of the same codes;
  2. groupby_agg on REP tables: two keys (the packed route, then the
     sort groupby on the packed key) and one key (the sort groupby), the
     routes counted on both sides equal; value columns float64 with NaN,
     float64 with -inf, inf and values of both signs, float32, int64 near
     +-2^62 with nulls, int32 and bool with nulls and a dictionary string
     with nulls; groups of one value, an empty group (every value null), a
     tie for the mode (the smallest of the most frequent wins) and a
     median between two values; the mode of int64 values above 2^53
     exact (test_agg_breadth's test_mode_exact_large_int64);
  3. groupby_agg on a 1D table of 4 shards: the colocated groupby (one
     hash shuffle through partition_rank, then the sort groupby a shard),
     its per-shard group counts equal to the reference's;
  4. reduce_table of the same aggregations on REP and 1D tables and on
     an empty table (median and quantiles by a whole-column sort; nunique
     and mode by the constant-key groupby, colocated on 1D);
  5. TPC-H's lineitem (gen_tpch(n_orders=900)) through the SQL entry
     point: COUNT(DISTINCT), MEDIAN and MODE grouped by the return flag
     and line status, against the reference's BodoSQLContext;
  6. the slice: workloads/taxi_aggs' HOLISTIC_AGGS on the taxi
     pipeline's joined table at 20,000 rows, REP (packed, then sort) and
     on 4 shards (colocated), grouped and reduced, against its
     numpy/pandas oracle (exact, quantiles within rtol 1e-14, as
     chip_smoke.py holds them), the oracle's own quantiles and modes
     against pandas' groupby quantile and value counts.

Tolerances: keys, nunique, mode (data, valid masks, and the data under a
false valid bit) exact; medians and quantiles bit-identical where the
position (cnt - 1) * q is whole, else within 1e-15 times the largest
|value| of the group: the reference's v_lo + (v_hi - v_lo) * frac is
one fused multiply-add under XLA on the CPU (ROADMAP F10), the port's a
product rounded and then a sum, which differ by up to 2^-53 |v_hi - v_lo|
plus a rounding of the result; near a result of 0 that is more than
1e-15 of the result itself (2.6e-15 seen). Whole-column quantiles are
interpolated on the host from the same two values in both packages:
within 1e-15 of the reference. The value columns hold no -0.0: the
port's encoding makes -0.0 and 0.0 one value, the reference's jitted
encoding may keep them apart (ROADMAP F4). One test runs every check
(see tests/torch_parity.py on why each test_torch_* file holds one
test).
"""

import numpy as np
import pandas as pd

from tests.torch_parity import (_live_rows, assert_same_frame,  # noqa: F401
                                fresh_observations, port_routes_reset,
                                reference, reference_routes, to_port,
                                torch_one_thread)

Q_RTOL = 1e-15
SHARDS = 4

# value column -> the aggregations over it
SPECS = {
    "f64": ("nunique", "mode", "median", "quantile_0.1", "quantile_0.9",
            "quantile_0.25", "count"),
    "fx": ("nunique", "mode"),
    "f32": ("nunique", "mode", "median", "quantile_0.75", "count"),
    "i64": ("nunique", "mode", "median", "quantile_0.9", "count"),
    "i32": ("mode", "quantile_0.25", "count"),
    "bo": ("nunique", "mode"),
    "s": ("nunique", "mode"),
}
AGGS = [(c, op, f"{c}_{op}") for c, ops in SPECS.items() for op in ops]
BIG = 1 << 62


def _q_of(op: str):
    if op == "median":
        return 0.5
    if op.startswith("quantile_"):
        return float(op[len("quantile_"):])
    return None


def _specials(a0: int):
    """(a, b, value index) of the edge groups, keyed a = a0 (past the
    random keys): b = 0 every value null; b = 1 one value; b = 2 a tie for
    the mode (values 3, 1, 3, 1, 2: the mode is 1); b = 3 two values."""
    groups = [[None] * 3, [2], [3, 1, 3, 1, 2], [1, 4]]
    return [(a0, b, v) for b, vals in enumerate(groups) for v in vals]


def _frame(r, n: int, a_hi: int, b_hi: int):
    """Random rows over keys a in [0, a_hi), b in [0, b_hi), then the
    special groups. Values repeat (so modes and distinct counts are
    interesting); floats with 10% NaN, the others with 10% nulls."""
    sp = _specials(a_hi)
    a = np.concatenate([r.integers(0, a_hi, n), [x[0] for x in sp]])
    b = np.concatenate([r.integers(0, b_hi, n), [x[1] for x in sp]])
    m = len(a)
    small = r.integers(-6, 7, m)
    null = r.random(m) < 0.1
    null[n:] = [v is None for _, _, v in sp]
    small[n:] = [0 if v is None else v for _, _, v in sp]
    # + 0.0 turns -0.0 into 0.0 (F4)
    f64 = np.round(r.normal(size=m), 1) + 0.0
    f64[n:] = small[n:]
    f64[null] = np.nan
    fx = r.choice([-np.inf, -1e300, -2.5, -1.0, 1.0, 2.5, 1e300, np.inf], m)
    fx[n:] = small[n:]
    fx[null] = np.nan
    i64 = np.where(small < 0, -BIG, BIG - 13) + small
    strs = np.array(["alpha", "beta", "gamma", "delta", "eps"])
    return pd.DataFrame({
        "a": a.astype(np.int64), "b": b.astype(np.int64),
        "f64": f64, "fx": fx, "f32": f64.astype(np.float32),
        "i64": pd.array(np.where(null, None, i64), dtype="Int64"),
        "i32": pd.array(np.where(null, None, small), dtype="Int32"),
        "bo": pd.array(np.where(null, None, small > 0), dtype="boolean"),
        "s": pd.array(np.where(null, None, strs[small % 5]), dtype=object),
    })


def _group_scale(ref, live, df, keys, col: str):
    """Per result row, the largest |value| of its group in `df` (0 for a
    group without a value): the scale of the quantiles' tolerance."""
    kdf = pd.DataFrame({k: np.asarray(ref.column(k).data)[live]
                        for k in keys})
    absx = df[col].astype(np.float64).abs().rename("__m")
    m = pd.concat([df[keys], absx], axis=1).groupby(keys)["__m"].max()
    return kdf.merge(m.fillna(0.0).reset_index(), on=keys,
                     how="left")["__m"].to_numpy(np.float64)


def _hold_table(port, ref, label: str, df, keys):
    """Port Table against reference Table: layout exactly, keys, counts,
    nunique and mode exactly (valid masks and the data under a false
    valid bit too); quantiles within Q_RTOL times the largest |value| of
    the group, and bit-identical where the position is whole."""
    assert port.nrows == ref.nrows, label
    assert port.names == ref.names, label
    assert port.distribution == ref.distribution, label
    assert port.capacity == ref.capacity, label
    if ref.counts is not None:
        np.testing.assert_array_equal(port.counts, ref.counts)
    live = _live_rows(ref)
    for name in ref.names:
        pc, rc = port.column(name), ref.column(name)
        lab = f"{label} {name}"
        assert pc.dtype.name == rc.dtype.name, lab
        if rc.dictionary is not None:
            np.testing.assert_array_equal(pc.dictionary, rc.dictionary)
        assert (pc.valid is None) == (rc.valid is None), lab
        if rc.valid is not None:
            np.testing.assert_array_equal(pc.valid.numpy()[live],
                                          np.asarray(rc.valid)[live],
                                          err_msg=lab)
        got = pc.data.numpy()[live]
        want = np.asarray(rc.data)[live]
        q = _q_of(name.split("_", 1)[1]) if "_" in name else None
        if q is None:
            np.testing.assert_array_equal(got, want, err_msg=lab)
            continue
        col = name.split("_")[0]
        assert np.array_equal(np.isnan(got), np.isnan(want)), lab
        ok = ~np.isnan(want)
        err = np.abs(got[ok] - want[ok])
        lim = Q_RTOL * _group_scale(ref, live, df, keys, col)[ok]
        assert (err <= lim).all(), (lab, err.max(), err[err > lim][:3])
        cnt = np.asarray(ref.column(f"{col}_count").data)[live]
        pos = (cnt - 1).astype(np.float64) * q
        whole = pos == np.floor(pos)
        np.testing.assert_array_equal(got[whole], want[whole], err_msg=lab)
    return port


def _check_groupby(ref_t, df, keys, label: str, want_routes, aggs=AGGS):
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    port_t = to_port(ref_t)
    with reference_routes() as ref_routes:
        ref = R.groupby_agg(ref_t, keys, aggs)
    routes = port_routes_reset()
    port = PR.groupby_agg(port_t, keys, aggs)
    assert routes == ref_routes, (label, routes, ref_routes)
    taken = {k: v for k, v in routes.items() if v}
    assert taken == want_routes, (label, taken)
    return _hold_table(port, ref, label, df, keys)


def _check_pandas(port, df, keys, label: str):
    """The edge groups and the exact large-int64 modes against pandas."""
    t = port.to_pandas().set_index(keys).sort_index()
    a0 = int(df["a"].max())
    if len(keys) == 2:
        assert t.loc[(a0, 0), "f64_nunique"] == 0
        assert pd.isna(t.loc[(a0, 0), "f64_mode"])
        assert np.isnan(t.loc[(a0, 0), "f64_median"])
        assert t.loc[(a0, 1), "f64_median"] == 2.0
        assert t.loc[(a0, 2), "f64_mode"] == 1.0
        assert t.loc[(a0, 2), "s_mode"] == "beta"
        assert t.loc[(a0, 3), "f64_median"] == 2.5
    # every mode and distinct count against pandas, exactly: a group's
    # mode is the first of its values by (count descending, value)
    g = df.groupby(keys)
    for col in ("i64", "s", "fx"):
        want_n = g[col].nunique()
        np.testing.assert_array_equal(t[f"{col}_nunique"].to_numpy(),
                                      want_n.to_numpy(), err_msg=label)
        n = df.dropna(subset=[col]).groupby(keys + [col]).size() \
            .rename("__n").reset_index()
        n = n.sort_values(keys + ["__n", col],
                          ascending=[True] * len(keys) + [False, True])
        want_m = n.drop_duplicates(keys).set_index(keys)[col]
        got_m = t[f"{col}_mode"]
        assert got_m.notna().sum() == len(want_m), (label, col)
        got = got_m.loc[want_m.index].to_numpy(dtype=object)
        assert (got == want_m.to_numpy(dtype=object)).all(), (label, col)


def _check_decode():
    """decode_value(encode_value(x)) == x for every dtype, and the codes
    and the decoded values equal the reference's."""
    import jax.numpy as jnp
    import torch
    from bodo_tpu.ops import sort_encoding as RSE
    from bodo_tpu_torch.ops import sort_encoding as SE
    r = np.random.default_rng(7)
    cases = {
        np.float64: np.array([-np.inf, -1e300, -2.5, -5e-324, 0.0, 5e-324,
                              1.0, 1e300, np.inf, np.nan]),
        np.float32: np.array([-np.inf, -3.5, -1e-45, 0.0, 1e-45, 2.0,
                              3.4e38, np.inf], np.float32),
        np.bool_: np.array([True, False, True]),
        np.int64: np.array([-(1 << 63), -BIG - 1, -1, 0, 1, BIG + 7,
                            (1 << 63) - 1]),
        np.int32: r.integers(-(1 << 31), 1 << 31, 50).astype(np.int32),
        np.int16: np.array([-32768, -1, 0, 32767], np.int16),
        np.int8: np.array([-128, -1, 0, 127], np.int8),
        np.uint8: np.array([0, 1, 255], np.uint8),
        np.uint16: np.array([0, 65535], np.uint16),
        np.uint32: np.array([0, 1, (1 << 32) - 1], np.uint32),
        np.uint64: np.array([0, 1, (1 << 63), (1 << 64) - 1], np.uint64),
    }
    for npdt, x in cases.items():
        x = x.astype(npdt)
        tdt = getattr(torch, np.dtype(npdt).name)
        tx = torch.from_numpy(x.copy()) if npdt != np.uint64 else \
            torch.from_numpy(x.view(np.int64).copy()).view(torch.uint64)
        enc = SE.encode_value(tx)
        back = SE.decode_value(enc, tdt)
        assert back.dtype == tdt, npdt
        got = back.view(torch.int64).numpy().view(np.uint64) \
            if npdt == np.uint64 else back.numpy()
        np.testing.assert_array_equal(got, x, err_msg=str(npdt))
        # the reference's XLA flushes subnormal floats to zero: its codes
        # are compared on the other values
        keep = np.ones(len(x), bool)
        if x.dtype.kind == "f":
            keep = ~((x != 0) & (np.abs(x) < np.finfo(x.dtype).tiny))
        ref_enc = np.asarray(RSE.encode_value(jnp.asarray(x[keep])))
        np.testing.assert_array_equal(enc.numpy().view(np.uint64)[keep],
                                      ref_enc, err_msg=str(npdt))
        ref_back = np.asarray(RSE.decode_value(jnp.asarray(ref_enc),
                                               jnp.dtype(npdt)))
        np.testing.assert_array_equal(got[keep], ref_back,
                                      err_msg=str(npdt))


def _same_scalar(got, want, label: str):
    if want is None or pd.isna(want):
        assert got is None or pd.isna(got), (label, got)
        return
    assert got == want or abs(got - want) <= Q_RTOL * abs(want), \
        (label, got, want)


def _check_reduce(ref_t, label: str, want_routes):
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    aggs = [a for a in AGGS if a[1] != "count"]
    with reference_routes() as ref_routes:
        want = R.reduce_table(ref_t, aggs)
    routes = port_routes_reset()
    got = PR.reduce_table(to_port(ref_t), aggs)
    assert routes == ref_routes, (label, routes, ref_routes)
    assert {k: v for k, v in routes.items() if v} == want_routes, label
    assert list(got) == list(want), label
    for _, _, o in aggs:
        _same_scalar(got[o], want[o], f"{label} {o}")
    return got


def _check_sql():
    """COUNT(DISTINCT), MEDIAN and MODE on TPC-H's lineitem through both
    packages' SQL entry points."""
    import bodo_tpu.sql as ref_sql
    from bodo_tpu_torch.sql import BodoSQLContext
    from bodo_tpu_torch.workloads.tpch import gen_tpch
    data = {"lineitem": gen_tpch(n_orders=900, seed=3)["lineitem"]}
    sql = ("SELECT l_returnflag, l_linestatus, COUNT(DISTINCT l_suppkey) "
           "AS n_supp, MEDIAN(l_extendedprice) AS med, MODE(l_quantity) "
           "AS qmode FROM lineitem GROUP BY l_returnflag, l_linestatus")
    with fresh_observations():
        want = ref_sql.BodoSQLContext(data).sql(sql).to_pandas()
        got = BodoSQLContext(data, device="cpu").sql(sql).to_pandas()
    assert len(got) > 1
    assert_same_frame(got, want, Q_RTOL, "sql lineitem")
    li = data["lineitem"]
    g = li.groupby(["l_returnflag", "l_linestatus"])
    np.testing.assert_array_equal(got["n_supp"],
                                  g["l_suppkey"].nunique().to_numpy())
    np.testing.assert_allclose(got["med"], g["l_extendedprice"].median()
                               .to_numpy(), rtol=Q_RTOL)


def test_holistic_aggs_match_reference(reference):
    import bodo_tpu
    import jax
    import bodo_tpu.plan.explain  # noqa: F401  (the SQL path's modules,
    import bodo_tpu.plan.physical  # noqa: F401  imported before the
    import bodo_tpu.runtime.elastic  # noqa: F401  scope's records)
    import bodo_tpu.runtime.stats_store  # noqa: F401
    import bodo_tpu.sql.plan_cache  # noqa: F401
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh

    _check_decode()
    r = np.random.default_rng(0)
    df = _frame(r, 4000, 40, 30)
    # 2. REP: packed then sort; one key: the sort groupby
    port = _check_groupby(RefTable.from_pandas(df), df, ["a", "b"], "REP",
                          {"groupby_packed": 1, "groupby_sort": 1})
    _check_pandas(port, df, ["a", "b"], "REP")
    port = _check_groupby(RefTable.from_pandas(df), df, ["a"], "REP one key",
                          {"groupby_sort": 1})
    _check_pandas(port, df, ["a"], "REP one key")
    base = (1 << 60) + 1
    big = pd.DataFrame({"g": [0] * 5, "v": np.array(
        [base, base, base + 1, base + 2, base + 3], dtype=np.int64)})
    port = _check_groupby(RefTable.from_pandas(big), big, ["g"], "large int64",
                          {"groupby_sort": 1}, [("v", "mode", "m")])
    assert port.to_pandas()["m"].tolist() == [base]
    # 3. 1D: the colocated groupby, its shuffle through partition_rank
    ref_mesh = bodo_tpu.make_mesh(jax.devices()[:SHARDS])
    calls = [0]
    orig = CK.partition_rank

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    CK.partition_rank = counted
    try:
        with bodo_tpu.use_mesh(ref_mesh), \
                use_mesh(make_mesh(SHARDS, device="cpu")):
            t1 = RefTable.from_pandas(df).shard()
            port = _check_groupby(t1, df, ["a", "b"], "1D",
                                  {"groupby_colocated": 1})
            assert len(port.counts) == SHARDS and min(port.counts) > 0
            _check_pandas(port, df, ["a", "b"], "1D")
            assert calls[0] == SHARDS, calls
            # 4. reduce_table on 1D: every row to one shard
            _check_reduce(t1, "reduce 1D", {"groupby_colocated": 1})
    finally:
        CK.partition_rank = orig
    got = _check_reduce(RefTable.from_pandas(df), "reduce REP",
                        {"groupby_sort": 1})
    assert got["i64_nunique"] == df["i64"].nunique()
    assert got["f64_median"] == df["f64"].median()
    assert got["f64_quantile_0.1"] == df["f64"].quantile(0.1)
    empty = _check_reduce(RefTable.from_pandas(df.iloc[:0]), "reduce empty",
                          {"groupby_sort": 1})
    assert np.isnan(empty["f64_median"]) and empty["f64_mode"] is None
    # 5. SQL; 6. the slice
    _check_sql()
    _check_taxi_slice()


def _check_taxi_slice():
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.workloads import taxi as T
    from bodo_tpu_torch.workloads import taxi_aggs as A
    trips_np, weather_np = T.gen_taxi_arrays(20_000, seed=0)
    want, want_red = A.holistic_oracle(trips_np, weather_np)
    # the oracle's numpy quantiles and modes against pandas' own
    cols, hit = T.numpy_joined(trips_np, weather_np)
    df = pd.DataFrame({"slot": T.slot_ids(cols)[0],
                       "m": trips_np["trip_miles"][hit],
                       "pu": trips_np["PULocationID"][hit]})
    g = df.groupby("slot")
    for q, name in ((0.1, "miles_q10"), (0.9, "miles_q90")):
        np.testing.assert_allclose(want[name], g["m"].quantile(q),
                                   rtol=1e-14, atol=0)
    modes = g["pu"].agg(lambda s: min(s.mode()))
    np.testing.assert_array_equal(want["pu_mode"], modes.to_numpy())
    trips, weather = T.tables_from_arrays(trips_np, weather_np,
                                          device="cpu")
    for shard in (False, True):
        with use_mesh(make_mesh(SHARDS, device="cpu")):
            routes = port_routes_reset()
            m = T.joined(trips.shard() if shard else trips, weather)
            label = f"taxi slice shard={shard}"
            A.check_groupby(A.table_arrays(A.groupby(m, A.HOLISTIC_AGGS)),
                            want, 1e-14, 0.0, label, A.HOLISTIC_AGGS)
            A.check_reduce(A.reduce(m, A.HOLISTIC_REDUCE), want_red, 1e-14,
                           0.0, label, A.HOLISTIC_REDUCE)
            taken = {k for k, v in routes.items() if v and "groupby" in k}
            assert taken == ({"groupby_colocated"} if shard else
                             {"groupby_packed", "groupby_sort"}), taken
