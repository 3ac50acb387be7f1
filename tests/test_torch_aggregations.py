"""The decomposable aggregations of the port against bodo_tpu on the same
inputs: sumnull, sum64, prod, min, max, first, last, var, std, var0,
std0, m2, m3, m4, skew and kurt (beside count, size, sum and mean) on
every groupby route, and `reduce_table`, on REP and 1D tables.

  1. groupby_agg on the dense route (two keys of small ranges), the
     packed route (two keys, 20,000 rows), the hashed route (pack_keys
     off), the sort route (hash_groupby off too), and the two-phase
     sharded groupby on a CPU mesh of 4 shards (hashed and sorted
     partials); the routes equal the reference's. Value columns f64 and
     f32 with NaN, int64, int32 and bool with nulls; groups of 1 to 4
     rows (the NaN thresholds of var, skew and kurt), constant groups
     (skew and kurt 0), all-null groups, a group holding -0.0 and 0.0,
     and an empty table;
  2. reduce_table on REP and 1D tables with the same columns, an
     all-null column and an empty table;
  3. the refusals that stay: aggregation over decimals (the holistic
     aggregations and LISTAGG, refused before, are held in
     test_torch_holistic_aggs.py and test_torch_listagg.py);
  4. the f32 gate: `min` beside `sum` over f32 never reaches
     `dense_accumulate` or `groupby_sum`, on the dense and hashed routes;
  5. the slice: workloads/taxi_aggs on the taxi pipeline's joined table
     at 20,000 rows, REP and on 4 shards, against its pandas oracle
     (chip_smoke.py's tolerances: pandas computes var by Welford).

Tolerances: keys, counts, min, max, first, last, integer sums and
products and bool results bit-identical, valid masks equal and the data
under a false valid bit too (min and max of floats compared as values:
which of -0.0 and 0.0 a min keeps depends on the order of the atomics on
the card); float64 sums, products, moments, var and std rtol 1e-12 (same
values, another order); float32 ones rtol 1e-5; skew and kurt
|delta| <= 1e-10 * (1 + |x|), NaN where the reference has NaN.

The integer products of `reduce_table` wrap modulo 2^64 in the port (as
pandas'); the reference takes them in float64, so the reduce frames keep
them below 2^53, where the two agree, and the wrap is held against
numpy's product. One test runs every check (see tests/torch_parity.py on
why each test_torch_* file holds one test).
"""

import decimal

import numpy as np
import pandas as pd
import pytest

from tests.torch_parity import (_live_rows, both_configs,  # noqa: F401
                                port_routes_reset, reference,
                                reference_routes, to_port,
                                torch_one_thread)

F64_RTOL = 1e-12
F32_RTOL = 1e-5
MOMENT_ATOL = 1e-10
SHARDS = 4

# value column -> the aggregations over it (few spec tuples, so the
# reference compiles few programs)
SPECS = {
    "f64": ("sumnull", "sum64", "prod", "min", "max", "first", "last",
            "var", "std", "var0", "std0", "m2", "m3", "m4", "skew", "kurt",
            "count", "mean"),
    "f32": ("sumnull", "prod", "min", "max", "first", "last", "var", "std",
            "skew", "kurt"),
    "i64": ("sumnull", "sum", "prod", "min", "max", "first", "last", "var0",
            "std0", "sum64", "kurt"),
    "i32": ("sumnull", "prod", "min", "max", "first", "last", "var",
            "skew", "size"),
    "bo": ("sumnull", "prod", "min", "max", "first", "last"),
}
AGGS = [(c, op, f"{c}_{op}") for c, ops in SPECS.items() for op in ops]
# the partial-only ops have no DECOMPOSE entry: on a 1D table both
# packages send them to the colocated groupby, not the two-phase one
AGGS_1D = [a for a in AGGS if a[1] not in ("sum64", "m2", "m3", "m4")]
REDUCE_OPS = ("sum", "sumnull", "count", "size", "min", "max", "mean",
              "var", "std", "var0", "std0", "prod", "first", "last", "skew",
              "kurt")
EXACT = ("min", "max", "first", "last", "count", "size")
MOMENTS = ("skew", "kurt")


def _specials(a0: int):
    """Rows of the groups whose sizes and values hit the edge rules, keyed
    a = a0 (past the random keys' range), b = 0..7: sizes 1 to 4; a
    constant group; an all-null group; a group with -0.0 and 0.0."""
    groups = [
        [1.5], [2.0, 7.0], [1.0, 4.0, 9.0], [0.5, 3.0, -2.0, 8.0],
        [3.0] * 5, [None] * 3, [-0.0, 0.0, -0.0], [2.0, None, 5.0, None],
    ]
    rows = []
    for b, vals in enumerate(groups):
        for v in vals:
            rows.append((a0, b, v))
    return rows


def _frame(r, n: int, a_hi: int, b_hi: int, prod_safe: bool = False):
    """Random rows over keys a in [0, a_hi), b in [0, b_hi), then the
    special groups; f64/f32 with 10% NaN, int64/int32/bool with 10%
    nulls. prod_safe keeps every integer product below 2^53."""
    a = list(r.integers(0, a_hi, n))
    b = list(r.integers(0, b_hi, n))
    f = list(r.gamma(2.0, 2.5, n))
    if prod_safe:
        f = list(1.0 + 0.01 * r.standard_normal(n))
    for ka, kb, v in _specials(a_hi):
        a.append(ka)
        b.append(kb)
        f.append(np.nan if v is None else v)
    m = len(a)
    f = np.array(f, dtype=np.float64)
    f[:n][r.random(n) < 0.1] = np.nan
    g = f.astype(np.float32)
    if prod_safe:
        ints = r.choice([-1, 1], m)
        ints[r.choice(m, 12, replace=False)] = r.choice([2, 3, -2], 12)
    else:
        ints = r.integers(-9, 10, m)
    ints[n:] = np.where(np.isnan(f[n:]), 0, np.round(f[n:]))
    null = r.random(m) < 0.1
    null[n:] = np.isnan(f[n:])
    return pd.DataFrame({
        "a": np.array(a, dtype=np.int64), "b": np.array(b, dtype=np.int64),
        "f64": f, "f32": g,
        "i64": pd.array(np.where(null, None, ints), dtype="Int64"),
        "i32": pd.array(np.where(null, None, ints), dtype="Int32"),
        "bo": pd.array(np.where(null, None, ints > 0), dtype="boolean"),
    })


def _op_of(name: str) -> str:
    return name.split("_", 1)[1]


def _close(got, want, op: str, kind: str, label: str):
    """Data of one aggregation column by its rule (see the docstring)."""
    if op in MOMENTS:
        assert np.array_equal(np.isnan(got), np.isnan(want)), label
        ok = ~np.isnan(want)
        np.testing.assert_array_less(
            np.abs(got[ok] - want[ok]), MOMENT_ATOL * (1 + np.abs(want[ok]))
            + 1e-300, err_msg=label)
    elif kind == "f" and op not in EXACT:
        rtol = F32_RTOL if got.dtype == np.float32 else F64_RTOL
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                   err_msg=label)
    else:
        # min and max of floats as values: -0.0 == 0.0; NaN == NaN
        np.testing.assert_array_equal(got, want, err_msg=label)


def _hold_table(port, ref, label: str):
    """Port Table against reference Table: layout exactly, keys and every
    aggregation by its rule, valid masks equal."""
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
        assert (pc.valid is None) == (rc.valid is None), lab
        if rc.valid is not None:
            np.testing.assert_array_equal(pc.valid.numpy()[live],
                                          np.asarray(rc.valid)[live],
                                          err_msg=lab)
        got = pc.data.numpy()[live]
        want = np.asarray(rc.data)[live]
        op = _op_of(name) if "_" in name else "count"
        _close(got, want, op, want.dtype.kind, lab)


def _routes_both(fn_ref, fn_port, label: str):
    with reference_routes() as ref_routes:
        ref = fn_ref()
    routes = port_routes_reset()
    port = fn_port()
    assert routes == ref_routes, (label, routes, ref_routes)
    return port, ref, {k: v for k, v in routes.items() if v}


def _check_groupby(ref_t, label: str, want_route: str, aggs=AGGS):
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    port_t = to_port(ref_t)
    port, ref, routes = _routes_both(
        lambda: R.groupby_agg(ref_t, ["a", "b"], aggs),
        lambda: PR.groupby_agg(port_t, ["a", "b"], aggs), label)
    assert routes.get(want_route, 0) >= 1, (label, routes)
    _hold_table(port, ref, label)
    return port


def _pin_special_groups(port, a0: int):
    """The edge groups read off the port's REP result directly."""
    t = port.gather() if port.distribution == "1D" else port
    n = t.nrows
    a = t.column("a").data.numpy()[:n]
    b = t.column("b").data.numpy()[:n]

    def at(name, bb):
        i = int(np.flatnonzero((a == a0) & (b == bb))[0])
        c = t.column(name)
        return (c.data.numpy()[i],
                None if c.valid is None else bool(c.valid.numpy()[i]))

    assert np.isnan(at("f64_var", 0)[0]) and at("f64_var0", 0)[0] == 0.0
    assert np.isnan(at("f64_skew", 1)[0]) and not np.isnan(at("f64_skew",
                                                               2)[0])
    assert np.isnan(at("f64_kurt", 2)[0]) and not np.isnan(at("f64_kurt",
                                                               3)[0])
    assert at("f64_skew", 4)[0] == 0.0 and at("f64_kurt", 4)[0] == 0.0
    # the all-null group: identities and zeros under a false valid bit
    assert at("f64_min", 5) == (np.inf, False)
    assert at("f64_max", 5) == (-np.inf, False)
    assert at("i64_min", 5) == (np.iinfo(np.int64).max, False)
    assert at("bo_max", 5) == (False, False)
    assert at("bo_min", 5) == (True, False)
    assert at("f64_first", 5) == (0.0, False)
    assert at("f64_sumnull", 5) == (0.0, False)
    assert at("f64_count", 5)[0] == 0
    # signed zeros: min and max are zero as values
    assert at("f64_min", 6)[0] == 0.0 and at("f64_max", 6)[0] == 0.0
    assert at("f64_first", 7) == (2.0, True)
    assert at("f64_last", 7) == (5.0, True)


def _same_scalar(got, want, op: str, label: str):
    if want is None:
        assert got is None, label
        return
    if pd.isna(want):
        assert pd.isna(got), (label, got)
        return
    assert not pd.isna(got), (label, got)
    if op in MOMENTS:
        assert abs(got - want) <= MOMENT_ATOL * (1 + abs(want)), label
    elif isinstance(want, (float, np.floating)) and op not in EXACT:
        assert got == pytest.approx(want, rel=F64_RTOL, abs=0), label
    else:
        assert got == want, (label, got, want)


def _check_reduce(ref_t, label: str):
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    port_t = to_port(ref_t)
    aggs = [(c, op, f"{c}_{op}") for c in ("f64", "f32", "i64", "i32", "nul")
            for op in REDUCE_OPS]
    aggs += [("bo", op, f"bo_{op}") for op in
             ("min", "max", "sumnull", "prod", "first", "last")]
    want = R.reduce_table(ref_t, aggs)
    got = PR.reduce_table(port_t, aggs)
    assert set(got) == set(want), label
    for _, op, o in aggs:
        _same_scalar(got[o], want[o], op, f"{label} {o}")
    return got


def _check_refusals():
    from bodo_tpu_torch import relational as PR
    from bodo_tpu_torch.table.table import Column, Table
    dec = Table({"a": Column.from_numpy(np.array([1, 1, 2]), device="cpu"),
                 "d": Column.from_numpy(np.array(
                     [decimal.Decimal("1.25"), decimal.Decimal("2.50"),
                      decimal.Decimal("0.75")], dtype=object),
                     device="cpu")}, 3)
    with pytest.raises(NotImplementedError, match="decimals"):
        PR.groupby_agg(dec, ["a"], [("d", "min", "x")])
    with pytest.raises(NotImplementedError, match="decimals"):
        PR.reduce_table(dec, [("d", "max", "x")])
    for op in ("median", "quantile_0.25", "mode"):
        with pytest.raises(NotImplementedError, match="decimals"):
            PR.groupby_agg(dec, ["a"], [("d", op, "x")])
        with pytest.raises(NotImplementedError, match="decimals"):
            PR.reduce_table(dec, [("d", op, "x")])


def _check_f32_gate(reference_table_of):
    """min beside sum over f32: the reference's gates refuse the f32
    accumulate, and so the port never calls it."""
    from bodo_tpu_torch.ops import cuda_kernels as CK
    r = np.random.default_rng(3)
    n = 3000
    for hi, want in ((8, "groupby_dense"), (1 << 40, "groupby_hashed")):
        df = pd.DataFrame({"a": r.integers(0, hi, n),
                           "b": r.integers(0, 4, n),
                           "v": r.standard_normal(n).astype(np.float32)})
        df.loc[r.random(n) < 0.1, "v"] = np.nan
        aggs = [("v", "sum", "v_sum"), ("v", "min", "v_min"),
                ("v", "count", "v_count")]
        calls = {"dense_accumulate": 0, "groupby_sum": 0}
        saved = {k: getattr(CK, k) for k in calls}

        def counted(name):
            def f(*a, **k):
                calls[name] += 1
                return saved[name](*a, **k)
            return f

        for k in calls:
            setattr(CK, k, counted(k))
        try:
            with both_configs(pack_keys=False):
                _check_groupby(reference_table_of(df), f"f32 gate {want}",
                               want, aggs)
        finally:
            for k, f in saved.items():
                setattr(CK, k, f)
        assert calls == {"dense_accumulate": 0, "groupby_sum": 0}, calls


def test_aggregations_match_reference(reference):
    import bodo_tpu
    import jax
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh

    def table_of(df):
        return RefTable.from_pandas(df)

    r = np.random.default_rng(0)
    # 1. groupby: dense (6 x 5 slots + the special row of keys)
    dense = _frame(r, 300, 6, 5)
    port = _check_groupby(table_of(dense), "dense", "groupby_dense")
    _pin_special_groups(port, 6)
    _check_groupby(table_of(dense.iloc[:0]), "dense empty", "groupby_dense")
    wide = _frame(r, 20_000, 1000, 1000)
    port = _check_groupby(table_of(wide), "packed", "groupby_packed")
    _pin_special_groups(port, 1000)
    with both_configs(pack_keys=False):
        _check_groupby(table_of(wide), "hashed", "groupby_hashed")
        with both_configs(hash_groupby=False):
            _check_groupby(table_of(wide), "sort", "groupby_sort")
    ref_mesh = bodo_tpu.make_mesh(jax.devices()[:SHARDS])
    with bodo_tpu.use_mesh(ref_mesh), \
            use_mesh(make_mesh(SHARDS, device="cpu")):
        t1 = table_of(wide).shard()
        port = _check_groupby(t1, "1D", "groupby_sharded_hash", AGGS_1D)
        _pin_special_groups(port, 1000)
        with both_configs(hash_groupby=False):
            _check_groupby(t1, "1D sort", "groupby_sharded_sort",
                           [a for a in AGGS_1D if a[0] in ("f64", "bo")])

    # 2. reduce_table on REP and 1D
    red = _frame(r, 400, 6, 5, prod_safe=True)
    red["nul"] = pd.array([None] * len(red), dtype="Float64")
    got = _check_reduce(table_of(red), "reduce REP")
    assert got["f64_min"] == red["f64"].min()
    assert got["i64_prod"] == int(np.prod(red["i64"].dropna().to_numpy()))
    empty = _check_reduce(table_of(red.iloc[:0]), "reduce empty")
    assert empty["f64_first"] is None and np.isnan(empty["f64_min"])
    with bodo_tpu.use_mesh(ref_mesh), \
            use_mesh(make_mesh(SHARDS, device="cpu")):
        _check_reduce(table_of(red).shard(), "reduce 1D")
    # the port's integer product wraps modulo 2^64, as numpy's and pandas'
    from bodo_tpu_torch import relational as PR
    from bodo_tpu_torch.table.table import Table
    big = np.random.default_rng(1).integers(1, 300, 5000)
    wrap = PR.reduce_table(Table.from_numpy({"x": big}, device="cpu"),
                           [("x", "prod", "p")])["p"]
    assert wrap == int(np.prod(big)), (wrap, int(np.prod(big)))

    # 3. the refusals that stay; 4. the f32 gate
    _check_refusals()
    _check_f32_gate(table_of)
    # 5. the slice
    _check_taxi_slice()


def _check_taxi_slice():
    """workloads/taxi_aggs on the taxi pipeline's joined table at 20,000
    rows, REP and on 4 shards, against its pandas oracle with the
    tolerances chip_smoke.py holds it to (pandas' own algorithms: Welford
    for var)."""
    from bodo_tpu_torch import relational as PR
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.workloads import taxi as T
    from bodo_tpu_torch.workloads import taxi_aggs as A
    trips_np, weather_np = T.gen_taxi_arrays(20_000, seed=0)
    want, want_red = A.pandas_oracle(trips_np, weather_np)
    trips, weather = T.tables_from_arrays(trips_np, weather_np,
                                          device="cpu")
    for shard in (False, True):
        with use_mesh(make_mesh(SHARDS, device="cpu")):
            routes = port_routes_reset()
            m = T.joined(trips.shard() if shard else trips, weather)
            label = f"taxi slice shard={shard}"
            A.check_groupby(A.table_arrays(A.groupby(m)), want, 1e-9, 1e-7,
                            label)
            A.check_reduce(A.reduce(m), want_red, 1e-9, 1e-7, label)
            assert routes["groupby_sharded_hash" if shard
                          else "groupby_hashed"] >= 1, routes
    assert PR.route_counts["join_broadcast"] == 1
