"""BodoGroupBy of the port's lazy pandas frontend against the JAX
package's and against pandas, on the same seeded frames, REP and on a
CPU mesh of 4 shards (sources of 64 rows or more sharded in both
packages):

  - agg in its named, dict, string and list forms; every simple op (sum,
    mean, count, min, max, var and std with ddof 0 and 1, first, last,
    nunique, prod, median, skew, kurt, quantile) and size, as_index
    True and False, on a column with nulls too;
  - the row-aligned windows: rank (first, min, dense; ascending and
    not), cumcount, ntile, transform (sum, mean, count, min, max; one
    column and two) and shift (lag and lead);
  - apply, tests/test_groupby_apply.py's programs (a scalar, a Series
    and a frame per group, a same-length result, as_index=False): on 4
    shards through the 1D route (window_table's rowid, shuffle_by_key,
    relational.shard_frames), each row keeping its original label.

Port against reference: results equal (index, dtypes, row order exact;
float64 within rtol 1e-12, the whole-partition window sums of transform
within workloads/windows.prefix_atol, F11), the same optimized plans
and routes. Port against pandas: floats within rtol 1e-9, the rest
exact, a groupby's rows (shard order on 1D) sorted by its keys first;
ntile, which pandas lacks, against the SQL definition in numpy. The
fallback warning is an error throughout. Then shard_frames itself:
each shard of a 1D table as a frame, REP as one frame. One test runs
every check (see tests/torch_parity.py on why each test_torch_* file
holds one test)."""

import numpy as np
import pandas as pd

from tests.torch_parity import (assert_same_result, frontend_meshes,
                                no_fallback, reference, run_frontends,
                                torch_one_thread)  # noqa: F401

SHARDS = 4
F64_RTOL = 1e-12
PANDAS_RTOL = 1e-9
SHARD_MIN_ROWS = 64
# positions in _windows' results of transform("sum"), transform("mean")
# and the two-column transform("sum")
WINDOW_SUMS = (8, 9, 13)


def _frame(n=400, seed=5):
    r = np.random.default_rng(seed)
    df = pd.DataFrame({
        "k": r.integers(0, 12, n),
        "k2": r.choice(["a", "b", "c"], n),
        "v": r.normal(size=n),
        "w": r.integers(0, 100, n).astype(np.int64),
        "n": r.normal(size=n),
    })
    df.loc[r.random(n) < 0.15, "n"] = np.nan
    return df


def _src(fe, df):
    return fe.bd.from_pandas(df, **fe.kw)


def _flat(pdf):
    """pandas' (column, op) MultiIndex columns as the frontend's names."""
    pdf = pdf.copy()
    pdf.columns = [c if isinstance(c, str) else
                   (c[0] if c[1] == "" else f"{c[0]}_{c[1]}")
                   for c in pdf.columns]
    return pdf


def _aggregations(fe):
    df = _frame()
    b = _src(fe, df)
    out, exp = [], []

    def add(got, want, keys):
        # the frontend's groupby rows come in shard order on 1D
        if got.index.names != [None]:
            got = got.sort_index()
        else:
            got = got.sort_values(keys).reset_index(drop=True)
        out.append(got)
        exp.append(want)

    add(b.groupby(["k", "k2"], as_index=False).agg(
        s=("v", "sum"), m=("n", "mean"), c=("n", "count"),
        lo=("w", "min"), hi=("v", "max")).to_pandas(),
        df.groupby(["k", "k2"], as_index=False).agg(
            s=("v", "sum"), m=("n", "mean"), c=("n", "count"),
            lo=("w", "min"), hi=("v", "max")), ["k", "k2"])
    add(b.groupby("k").agg({"v": "sum", "w": "max"}).to_pandas(),
        df.groupby("k").agg({"v": "sum", "w": "max"}), ["k"])
    add(b.groupby("k").agg({"v": ["sum", "mean"]}).to_pandas(),
        _flat(df.groupby("k").agg({"v": ["sum", "mean"]})), ["k"])
    add(b.groupby("k")[["v", "w"]].agg("sum").to_pandas(),
        df.groupby("k")[["v", "w"]].agg("sum"), ["k"])
    add(b.groupby("k", as_index=False)[["v", "n"]].agg(
        ["min", "max"]).to_pandas(),
        _flat(df.groupby("k", as_index=False)[["v", "n"]].agg(
            ["min", "max"])), ["k"])
    g, pg = b.groupby("k")[["v", "w", "n"]], df.groupby("k")[["v", "w",
                                                              "n"]]
    for op in ("sum", "mean", "count", "min", "max", "first", "last",
               "nunique", "prod", "median", "skew"):
        add(getattr(g, op)().to_pandas(), getattr(pg, op)(), ["k"])
    add(g.kurt().to_pandas(), pg.apply(lambda x: x.kurt()), ["k"])
    for ddof in (0, 1):
        add(g.var(ddof=ddof).to_pandas(), pg.var(ddof=ddof), ["k"])
        add(g.std(ddof=ddof).to_pandas(), pg.std(ddof=ddof), ["k"])
    add(g.quantile(0.25).to_pandas(), pg.quantile(0.25), ["k"])
    add(b.groupby("k")["v"].median().to_pandas(),
        df.groupby("k")["v"].median(), ["k"])
    sz = b.groupby(["k", "k2"]).size().sort_index()
    return out + [sz], exp + [df.groupby(["k", "k2"]).size()]


def _windows(fe):
    df = _frame()
    b = _src(fe, df)
    g, pg = b.groupby("k"), df.groupby("k")
    out = [g["w"].rank(method=m, ascending=asc).to_pandas()
           for m in ("first", "min", "dense") for asc in (True, False)]
    exp = [pg["w"].rank(method=m, ascending=asc)
           for m in ("first", "min", "dense") for asc in (True, False)]
    out += [g.cumcount().to_pandas(), g.ntile(3).to_pandas()]
    exp += [pg.cumcount(), None]
    for op in ("sum", "mean", "count", "min", "max"):
        out.append(g["n"].transform(op).to_pandas())
        exp.append(pg["n"].transform(op))
    out.append(g[["v", "w"]].transform("sum").to_pandas())
    exp.append(pg[["v", "w"]].transform("sum"))
    for periods in (1, 2, -1):
        out.append(g["v"].shift(periods).to_pandas())
        exp.append(pg["v"].shift(periods))
    return out, exp


def _apply(fe):
    df = _frame()
    b = _src(fe, df)
    gk, pk = b.groupby("k"), df.groupby("k")
    spread = lambda s: float(s.max() - s.min())  # noqa: E731
    stats = lambda s: s.describe()[["mean", "std"]]  # noqa: E731
    sums = lambda g: g[["v", "w"]].sum()  # noqa: E731
    centered = lambda s: s - s.mean()  # noqa: E731
    total = lambda s: float(s.sum())  # noqa: E731
    out = [gk["v"].apply(spread), gk["v"].apply(stats),
           b.groupby(["k", "k2"]).apply(sums), gk["v"].apply(centered),
           b.groupby("k", as_index=False)["v"].apply(total)
           .reset_index(drop=True)]
    exp = [pk["v"].apply(spread), pk["v"].apply(stats),
           df.groupby(["k", "k2"]).apply(sums), pk["v"].apply(centered),
           df.groupby("k", as_index=False)["v"].apply(total)
           .reset_index(drop=True)]
    return out, exp


def _ntile(df, n):
    """SQL NTILE(n) over each k group in row order."""
    out = np.zeros(len(df), np.int64)
    for _, idx in df.groupby("k").indices.items():
        m = len(idx)
        small, big = divmod(m, n)
        sizes = [small + 1] * big + [small] * (n - big)
        out[idx] = np.repeat(np.arange(1, n + 1), sizes)[:m]
    return out


def _vs_pandas(got, exp, label):
    if isinstance(exp, pd.DataFrame):
        pd.testing.assert_frame_equal(got, exp, check_dtype=False,
                                      check_exact=False, rtol=PANDAS_RTOL,
                                      obj=label)
    else:
        pd.testing.assert_series_equal(got, exp, check_dtype=False,
                                       check_names=False, check_exact=False,
                                       rtol=PANDAS_RTOL, obj=label)


def _check(name, shards, window_atol):
    prog = {"aggregations": _aggregations, "windows": _windows,
            "apply": _apply}[name]
    label = f"{name} x{shards}"
    with frontend_meshes(shards, SHARD_MIN_ROWS):
        ref, port, routes = run_frontends(prog, label)
    for i, (got, want, exp) in enumerate(zip(port[0], ref[0], port[1])):
        lab = f"{label}[{i}]"
        if name == "windows" and i in WINDOW_SUMS:
            # transform sum and mean: whole-partition window sums (F11)
            assert type(got) is type(want) and got.shape == want.shape, lab
            assert got.index.equals(want.index), lab
            assert list(pd.DataFrame(got).dtypes) == \
                list(pd.DataFrame(want).dtypes), lab
            np.testing.assert_allclose(got.to_numpy(np.float64),
                                       want.to_numpy(np.float64),
                                       rtol=0, atol=window_atol,
                                       equal_nan=True, err_msg=lab)
        else:
            assert_same_result(got, want, F64_RTOL, lab)
        if exp is None:
            np.testing.assert_array_equal(got.to_numpy(),
                                          _ntile(_frame(), 3), err_msg=lab)
        else:
            _vs_pandas(got, exp, f"{lab} vs pandas")
    return routes


def _check_shard_frames():
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.table import Table
    df = _frame(1000)  # 4 shards of 256, 256, 256 and 232 rows
    t = Table.from_pandas(df, device="cpu")
    frames = R.shard_frames(t)
    assert len(frames) == 1
    pd.testing.assert_frame_equal(frames[0], df)
    with use_mesh(make_mesh(SHARDS, "cpu")):
        s = t.shard()
        frames = R.shard_frames(s)
    assert len(frames) == SHARDS
    assert [len(f) for f in frames] == [int(c) for c in s.counts]
    at = 0
    for f in frames:  # shard i holds the rows after shards 0..i-1
        pd.testing.assert_frame_equal(
            f, df.iloc[at:at + len(f)].reset_index(drop=True))
        at += len(f)
    assert at == len(df)


def test_frontend_groupby_matches_reference_and_pandas(reference):
    from bodo_tpu_torch.workloads.windows import prefix_atol
    window_atol = prefix_atol(_frame()["n"].to_numpy())
    with no_fallback():
        for shards in (1, SHARDS):
            for name in ("aggregations", "windows", "apply"):
                routes = _check(name, shards, window_atol)
                if shards > 1 and name == "windows":
                    assert routes.get("rank_window_shuffle") and \
                        routes.get("agg_window_shuffle"), routes
    _check_shard_frames()
