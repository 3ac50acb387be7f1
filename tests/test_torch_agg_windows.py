"""agg_window of the port against bodo_tpu on the same inputs: sum, sum0,
mean, count, min, max, lead, lag, first_value and last_value over the
frames ("all",), ("cumrange",) and ("rows", lo, hi) (bounded on both
sides, unbounded on either, forward-only and backward-only frames),
partitioned by an int64 key with nulls and ordered by a unique key or
by a key with ties (the RANGE frame's peers):

  1. on a replicated table (one sorted pass);
  2. on a 1D table of 4 shards (rowid, the hash shuffle through
     partition_rank, the sorted pass a shard, the sample sort on the
     position through range_partition), and with no ORDER BY, where
     the order-sensitive specs follow the original row order;
  3. on the 1D table, OVER () over sum, sum0, mean, min, max and count
     (reduce_table, broadcast to every row; the table stays 1D), and an
     ordered frame without partition keys (gathered to one table and
     sharded again, the reference's route);
  4. a decimal value column: sum, sum0, mean, min and max raise
     NotImplementedError in the port (decimal aggregation is not
     ported); count and lag work and equal the reference.

Value columns: a float64 with NaN (sums), a float64 with NaN and +-inf
(min, max, the gather ops), an int64 with nulls, an int64 above 2^60,
a uint64 above 2^63, a datetime with nulls and a dictionary string with
nulls.

Tolerances. Everything but the float sums and means is bit-identical to
the reference: counts, min and max in their exact domains, the gather
ops in the source dtype, the sums and means of integers (exact float64
prefixes), validity masks, layout and row order. A float frame sum is
the difference of two prefixes of the partition-sorted column; the
port's prefix is a Hillis-Steele scan, the reference's a jitted cumsum
that XLA reassociates (ROADMAP F11), so they agree within
64 * 2^-52 * sum(|x|) in absolute terms (each prefix is within about
(log2 n + 1) * 2^-53 * sum(|x|) of the exact one at n <= 1024), and a
mean within that over its count. OVER () sums come from reduce_table's
per-shard partials: rtol 1e-12, as test_torch_aggregations holds
reduce_table. One test runs every check (see tests/torch_parity.py on
why each test_torch_* file holds one test).
"""

import decimal

import numpy as np
import pandas as pd
import pytest

from tests.torch_parity import (_live_rows, port_routes_reset,  # noqa: F401
                                reference, reference_routes, to_port,
                                torch_one_thread)

SHARDS = 4
EPS = 2.0 ** -52
FRAMES = [("all",), ("cumrange",), ("rows", -2, 0), ("rows", -1, 1),
          ("rows", None, 0), ("rows", 0, None), ("rows", None, None),
          ("rows", 1, 3), ("rows", -4, -2)]
SUM_OPS = ("sum", "sum0", "mean", "count")


def _frame(n: int, seed: int):
    r = np.random.default_rng(seed)
    g = r.integers(0, 10, n)
    gnull = r.random(n) < 0.05
    f = np.round(r.normal(size=n) * 100, 2) + 0.0
    f[r.random(n) < 0.1] = np.nan
    fx = f.copy()
    fx[r.random(n) < 0.03] = np.inf
    fx[r.random(n) < 0.03] = -np.inf
    inull = r.random(n) < 0.1
    base = (1 << 60) + 7
    ts = pd.to_datetime(1_700_000_000_000_000_000
                        + r.integers(0, 10 ** 12, n))
    ts = pd.Series(ts).where(r.random(n) > 0.1)
    s = r.choice(["ash", "birch", "cedar", "elm"], n).astype(object)
    s[r.random(n) < 0.1] = None
    return pd.DataFrame({
        "g": pd.array(np.where(gnull, None, g), dtype="Int64"),
        "o": r.permutation(n).astype(np.int64),
        "t": r.integers(0, 40, n).astype(np.int64),   # ties: peers
        "f": f, "fx": fx,
        "i": pd.array(np.where(inull, None, r.integers(-500, 500, n)),
                      dtype="Int64"),
        "big": base + r.integers(0, 1000, n).astype(np.int64),
        "uu": (np.uint64(1 << 63) + r.integers(0, 1000, n)
               .astype(np.uint64)),
        "ts": ts, "s": s,
    })


def _specs(frames):
    """Every op over every frame on the float64 and the string columns
    (the sums on the int64 one); the other columns' exact domains over
    the first three frames."""
    specs = []
    for j, fr in enumerate(frames):
        tag = "_".join(str(x) for x in fr)
        for op in SUM_OPS:
            for c in ("f", "i"):
                specs.append((op, c, fr, 0, f"{c}__{op}__{tag}"))
        for op in ("min", "max", "first_value", "last_value"):
            cols = ("fx", "s") if j >= 3 else (
                ("fx", "s", "ts") if op.endswith("value") else
                ("fx", "s", "i", "big", "uu", "ts"))
            for c in cols:
                specs.append((op, c, fr, 0, f"{c}__{op}__{tag}"))
    for op in ("lead", "lag"):
        for n in (1, 3):
            for c in ("fx", "s", "ts", "big"):
                specs.append((op, c, ("all",), n, f"{c}__{op}{n}"))
    return specs


def _tol(name: str, df, whole: bool):
    """(kind, value) of an output column's tolerance."""
    parts = name.split("__")
    if len(parts) < 2 or parts[0] != "f" or parts[1] not in (
            "sum", "sum0", "mean"):
        return "exact", 0.0
    if whole:
        return "rel", 1e-12
    return "abs", 64 * EPS * float(np.nansum(np.abs(df["f"])))


def _hold(port, ref, df, label: str, whole: bool = False):
    import torch
    assert port.names == ref.names, label
    assert port.distribution == ref.distribution, label
    assert port.capacity == ref.capacity, label
    if ref.counts is not None:
        np.testing.assert_array_equal(port.counts, ref.counts)
    live = _live_rows(ref)
    for name in ref.names:
        pc, rc = port.column(name), ref.column(name)
        lab = f"{label} {name}"
        assert pc.dtype.name == rc.dtype.name, (lab, pc.dtype, rc.dtype)
        if rc.dictionary is not None:
            np.testing.assert_array_equal(pc.dictionary, rc.dictionary)
        assert (pc.valid is None) == (rc.valid is None), lab
        ok = np.ones(len(live), bool)
        if rc.valid is not None:
            ok = np.asarray(rc.valid)[live]
            np.testing.assert_array_equal(pc.valid.numpy()[live], ok,
                                          err_msg=lab)
        got = pc.data.view(torch.int64).numpy()[live] \
            if rc.dtype.name == "uint64" else pc.data.numpy()[live]
        want = np.asarray(rc.data)[live]
        if rc.dtype.name == "uint64":
            want = want.view(np.int64)
        kind, tol = _tol(name, df, whole)
        if kind == "exact":
            np.testing.assert_array_equal(got[ok], want[ok], err_msg=lab)
        elif kind == "abs":
            cnt = 1.0
            if name.split("__")[1] == "mean":
                cnt = np.maximum(np.asarray(ref.column(
                    name.replace("__mean__", "__count__")).data)[live], 1)
            err = np.abs(got[ok] - want[ok])
            assert (np.isnan(got[ok]) == np.isnan(want[ok])).all(), lab
            fin = ~np.isnan(want[ok])
            assert (err[fin] <= tol / (cnt[ok][fin] if np.ndim(cnt) else 1)
                    ).all(), (lab, err[fin].max(), tol)
        else:
            np.testing.assert_allclose(got[ok], want[ok], rtol=tol, atol=0,
                                       err_msg=lab)


def _check(ref_t, df, label: str, want_routes, pk, ob, specs, **kw):
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    with reference_routes() as ref_routes:
        ref = R.agg_window(ref_t, pk, ob, specs, **kw)
    routes = port_routes_reset()
    port = PR.agg_window(to_port(ref_t), pk, ob, specs, **kw)
    assert routes == ref_routes, (label, routes, ref_routes)
    taken = {k: v for k, v in routes.items() if v}
    for route in want_routes:
        assert taken.get(route, 0) >= 1, (label, route, taken)
    _hold(port, ref, df, label, whole=not ob and not pk)
    return port


def _check_pandas(port, df):
    """A few specs against pandas: the partition sums and counts
    (transform) and the 3-row moving sum (rolling on each group)."""
    got = port.to_pandas()
    g = df.groupby("g", dropna=False)
    want = g["i"].transform("sum")
    np.testing.assert_array_equal(got["i__sum0__all"].to_numpy(np.int64),
                                  want.to_numpy(np.int64))
    np.testing.assert_array_equal(got["f__count__all"],
                                  g["f"].transform("count"))
    srt = df.sort_values("o")
    mov = srt.groupby("g", dropna=False)["f"].rolling(
        3, min_periods=1).sum().reset_index(level=0, drop=True)
    np.testing.assert_allclose(got["f__sum0__rows_-2_0"],
                               mov.sort_index().fillna(0.0), rtol=0,
                               atol=64 * EPS * np.nansum(np.abs(df["f"])))


def _check_decimal(ref_t):
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    port_t = to_port(ref_t)
    for op in ("sum", "sum0", "mean", "min", "max"):
        with pytest.raises(NotImplementedError, match="decimal"):
            PR.agg_window(port_t, ["g"], ["o"],
                          [(op, "d", ("all",), 0, "x")])
    specs = [("count", "d", ("all",), 0, "d_count"),
             ("count", "d", ("rows", -1, 0), 0, "d_count_rows"),
             ("lag", "d", ("all",), 1, "d_lag1"),
             ("lead", "d", ("all",), 2, "d_lead2")]
    ref = R.agg_window(ref_t, ["g"], ["o"], specs)
    port = PR.agg_window(port_t, ["g"], ["o"], specs)
    _hold(port, ref, None, "decimal")
    assert port.column("d_lag1").dtype.name == ref_t.column("d").dtype.name


def test_agg_windows_match_reference(reference):
    import bodo_tpu
    import jax
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh

    df = _frame(1000, 0)
    specs = _specs(FRAMES)
    port = _check(RefTable.from_pandas(df), df, "REP", ["agg_window_local"],
                  ["g"], ["o"], specs)
    _check_pandas(port, df)
    ties = [s for s in _specs([("cumrange",), ("rows", -1, 1)])
            if s[1] in ("f", "i", "fx")]
    _check(RefTable.from_pandas(df), df, "REP ties", ["agg_window_local"],
           ["g"], ["t"], ties, ascending=[False])
    whole = [(op, c, ("all",), 0, f"{c}__{op}__whole")
             for op in ("sum", "sum0", "mean", "min", "max", "count")
             for c in ("f", "i")]
    _check(RefTable.from_pandas(df), df, "REP OVER ()",
           ["agg_window_local"], [], [], whole)
    dec = pd.DataFrame({
        "g": df["g"], "o": df["o"],
        "d": [None if i % 7 == 0 else decimal.Decimal(f"{i % 50}.{i % 9}5")
              for i in range(len(df))]})
    _check_decimal(RefTable.from_pandas(dec))

    launches = {"partition_rank": 0, "range_partition": 0}
    origs = {k: getattr(CK, k) for k in launches}

    def counted(name):
        def fn(*a, **k):
            launches[name] += 1
            return origs[name](*a, **k)
        return fn

    ref_mesh = bodo_tpu.make_mesh(jax.devices()[:SHARDS])
    try:
        for name in launches:
            setattr(CK, name, counted(name))
        with bodo_tpu.use_mesh(ref_mesh), \
                use_mesh(make_mesh(SHARDS, device="cpu")):
            t1 = RefTable.from_pandas(df).shard()
            assert list(t1.counts) == [256, 256, 256, 232]
            _check(t1, df, "1D", ["agg_window_shuffle"], ["g"], ["o"],
                   specs)
            assert launches["partition_rank"] >= SHARDS, launches
            assert launches["range_partition"] >= 1, launches
            unordered = [s for s in _specs([("all",), ("rows", -1, 0)])
                         if s[1] in ("f", "s")]
            _check(t1, df, "1D no ORDER BY", ["agg_window_shuffle"],
                   ["g"], [], unordered)
            out = _check(t1, df, "1D OVER ()", ["agg_window_broadcast"],
                         [], [], whole)
            assert out.distribution == "1D"
            running = [s for s in _specs([("rows", None, 0),
                                          ("rows", -3, 0)])
                       if s[1] in ("f", "i", "ts")]
            _check(t1, df, "1D ordered, no partition",
                   ["agg_window_gather", "agg_window_local"], [], ["o"],
                   running)
    finally:
        for name, fn in origs.items():
            setattr(CK, name, fn)
