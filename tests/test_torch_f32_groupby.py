"""The float32 groupby slice on the port against the same relational calls
on bodo_tpu and against float64 sums with pandas:

  1. the workload (bodo_tpu_torch/workloads/f32_groupby.py) at 20,000
     rows: `pipeline_dense` (filter, x + x, the dense groupby of 64
     slots) and `pipeline_sparse` (the hashed groupby of 300 sparse int64
     keys);
  2. the frame of tests/test_dense_paths.py:155-184: keys a and b (63
     dense slots), float32 v with 10% NaN, int32 c; sum, mean, count of v
     and size of c;
  3. the frame of tests/test_hashtable.py:190-214: 300 keys drawn from
     [-10^18, 10^18), float32 v; sum, mean, count and size.

On each: the routes equal the reference's; keys and counts are
bit-identical; a spy on the port's `cuda_kernels.dense_accumulate` shows
the f32 accumulate was taken (the groupby_sum kernel's route); each sum
lies within 1e-5 * sum(|v|) over its group of the float64 sum, each mean
within that bound over its count (f32 sums in another order: the port's
plain version adds row by row, the reference's CPU route scatters). The
accumulate is not taken on a float64 twin of each case (then every
float is held to the reference within rtol 1e-12, as the port's other
float64 parity tests are), nor at 4097 dense slots or 4097 groups.

The reference runs its default CPU route, the scatter: it routes the
same groupbys, and only its inner accumulate differs. Nothing here sets
the reference's FORCE_INTERPRET. One test runs every check (see
tests/torch_parity.py on why each test_torch_* file holds one test)."""

import contextlib

import numpy as np
import pandas as pd

from tests.torch_parity import (assert_same_table, port_routes_reset,
                                reference, reference_routes,
                                torch_one_thread)  # noqa: F401

N_ROWS = 20_000
SUM_TOL = 1e-5
F64_RTOL = 1e-12


@contextlib.contextmanager
def _accumulate_spy():
    """The group-space sizes of the port's dense_accumulate calls."""
    from bodo_tpu_torch.ops import cuda_kernels as CK
    calls = []
    orig = CK.dense_accumulate

    def spy(codes, cols, oks, n_slots):
        calls.append(n_slots)
        return orig(codes, cols, oks, n_slots)

    CK.dense_accumulate = spy
    try:
        yield calls
    finally:
        CK.dense_accumulate = orig


def _oracle(df, keys, aggs):
    """float64 results by pandas: per output name, (values, sum of |v|
    per group, count per group) sorted by keys."""
    g = df.assign(**{c: df[c].astype(np.float64) for c, _, _ in aggs}
                  ).groupby(keys, sort=True)
    out = {}
    for c, op, name in aggs:
        col = g[c]
        absum = g[c].apply(lambda s: np.nansum(np.abs(s))).to_numpy()
        cnt = col.count().to_numpy()
        vals = {"sum": col.sum, "mean": col.mean, "count": col.count,
                "size": col.size}[op]().to_numpy()
        out[name] = (vals, absum, cnt)
    return out, g.size().reset_index()[keys]


def _hold(table, df, keys, aggs, label):
    """Keys and counts against pandas exactly, sums and means within
    SUM_TOL * sum(|v|) (over the count for a mean)."""
    want, want_keys = _oracle(df, keys, aggs)
    n = table.nrows
    assert n == len(want_keys), label
    for k in keys:
        np.testing.assert_array_equal(
            np.asarray(table.column(k).data)[:n], want_keys[k].to_numpy(),
            err_msg=f"{label} {k}")
    for c, op, name in aggs:
        got = np.asarray(table.column(name).data)[:n].astype(np.float64)
        vals, absum, cnt = want[name]
        if op in ("count", "size"):
            np.testing.assert_array_equal(got, vals, err_msg=label)
            continue
        bound = SUM_TOL * absum / (np.maximum(cnt, 1) if op == "mean" else 1)
        assert np.array_equal(np.isnan(got), np.isnan(vals)), (label, name)
        ok = np.isnan(vals) | (np.abs(got - vals) <= bound)
        assert ok.all(), (label, name, float(np.nanmax(np.abs(got - vals))))


def _same_shape(port, ref, keys, aggs, label):
    """Names, dtypes, rows, capacity equal; keys and counts bit-identical."""
    assert port.names == ref.names, label
    assert port.nrows == ref.nrows and port.capacity == ref.capacity, label
    exact = list(keys) + [name for _, op, name in aggs
                          if op in ("count", "size")]
    for name in port.names:
        assert port.column(name).dtype.name == ref.column(name).dtype.name
    for name in exact:
        np.testing.assert_array_equal(
            port.column(name).data[:port.nrows].numpy(),
            np.asarray(ref.column(name).data)[:ref.nrows],
            err_msg=f"{label} {name}")


def _ref_groupby(df, keys, aggs, query):
    import bodo_tpu.relational as R
    from bodo_tpu.plan.expr import ColRef, Lit
    from bodo_tpu.table import Table
    t = Table.from_pandas(df)
    if query == "dense":
        t = R.filter_table(t, ColRef("y") % Lit(3) != Lit(0))
        t = R.assign_columns(t, {"z": ColRef("x") + ColRef("x")})
    return R.groupby_agg(t, keys, aggs)


def _port_groupby(df, keys, aggs, query):
    """The workload's pipelines for its queries, else groupby_agg."""
    from bodo_tpu_torch import relational as PR
    from bodo_tpu_torch.table.table import Table
    from bodo_tpu_torch.workloads import f32_groupby as F
    arrays = {c: df[c].to_numpy() for c in df}
    if query == "dense":
        return F.pipeline_dense(arrays, device="cpu")
    if query == "sparse":
        return F.pipeline_sparse(arrays, device="cpu")
    return PR.groupby_agg(Table.from_numpy(arrays, device="cpu"), keys,
                          aggs)


def _case(df, keys, aggs, label, want_route, slots, query):
    """One groupby on both packages. `slots`: the group space the f32
    accumulate must take, None when it must not be taken."""
    with reference_routes() as ref_routes:
        ref = _ref_groupby(df, keys, aggs, query)
    routes = port_routes_reset()
    with _accumulate_spy() as calls:
        port = _port_groupby(df, keys, aggs, query)
    assert routes == ref_routes, label
    assert {k: v for k, v in routes.items() if v} == {want_route: 1}, label
    assert calls == ([] if slots is None else [slots]), (label, calls)
    return port, ref


def _check_case(df, keys, aggs, label, want_route, slots, query=None,
                f64_twin=None):
    """The f32 case against the reference and pandas, then its float64
    twin (`f64_twin`: the frame with its float32 columns as float64)."""
    port, ref = _case(df, keys, aggs, label, want_route, slots, query)
    _same_shape(port, ref, keys, aggs, label)
    oracle_df = df
    if query == "dense":
        oracle_df = df[df["y"] % 3 != 0].assign(z=lambda d: d.x + d.x)
    _hold(port, oracle_df, keys, aggs, "port " + label)
    _hold(ref, oracle_df, keys, aggs, "reference " + label)
    if f64_twin is not None:
        port64, ref64 = _case(f64_twin, keys, aggs, label + " f64",
                              want_route, None, query)
        assert_same_table(port64, ref64, float_rtol=F64_RTOL)
    return port


def _f64(df):
    return df.astype({c: np.float64 for c in df
                      if df[c].dtype == np.float32})


def test_f32_groupby_slice_matches_reference(reference):
    from bodo_tpu_torch.workloads import f32_groupby as F

    # 1. the workload
    dense, sparse = F.gen_f32_arrays(N_ROWS, seed=0)
    ddf, sdf = pd.DataFrame(dense), pd.DataFrame(sparse)
    port = _check_case(ddf, ["k"], F.DENSE_AGGS, "workload dense",
                       "groupby_dense", F.N_DENSE_KEYS, "dense", _f64(ddf))
    F.check_against(port.to_numpy(), F.numpy_dense(dense))
    port = _check_case(sdf, ["k"], F.SPARSE_AGGS, "workload sparse",
                       "groupby_hashed", 384, "sparse", _f64(sdf))
    F.check_against(port.to_numpy(), F.numpy_sparse(sparse))

    # 2. test_dense_paths' frame: two dense keys, NaN values
    r = np.random.default_rng(5)
    n = 6000
    df = pd.DataFrame({
        "a": r.integers(0, 9, n), "b": r.integers(0, 7, n),
        "v": r.normal(size=n).astype(np.float32),
        "c": r.integers(0, 100, n).astype(np.int32),
    })
    df.loc[r.random(n) < 0.1, "v"] = np.nan
    aggs = [("v", "sum", "s"), ("v", "mean", "m"), ("v", "count", "cnt"),
            ("c", "size", "sz")]
    _check_case(df, ["a", "b"], aggs, "dense frame", "groupby_dense", 63,
                f64_twin=_f64(df))

    # 3. test_hashtable's frame: 300 sparse keys
    r = np.random.default_rng(8)
    n = 5000
    keys = r.integers(-10**18, 10**18, 300)
    df = pd.DataFrame({"k": keys[r.integers(0, 300, n)],
                       "v": r.normal(size=n).astype(np.float32)})
    aggs = [("v", "sum", "s"), ("v", "mean", "m"), ("v", "count", "c"),
            ("v", "size", "z")]
    _check_case(df, ["k"], aggs, "sparse frame", "groupby_hashed", 384,
                f64_twin=_f64(df))

    # past the accumulate's 4096 slots: 4097 dense slots, 4097 groups
    r = np.random.default_rng(9)
    n = 10_000
    aggs = [("v", "sum", "s"), ("v", "count", "c")]
    df = pd.DataFrame({"k": np.r_[np.arange(4097), r.integers(0, 4097,
                                                               n - 4097)],
                       "v": r.normal(size=n).astype(np.float32)})
    _check_case(df, ["k"], aggs, "4097 dense slots", "groupby_dense", None)
    df = df.assign(k=r.integers(-10**18, 10**18, 4097)[df["k"]])
    _check_case(df, ["k"], aggs, "4097 groups", "groupby_hashed", None)
