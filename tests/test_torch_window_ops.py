"""window_table of the port against bodo_tpu on the same inputs: the
cumulative ops (cumsum, cumprod, cummax, cummin), the rolling ops
(rolling_{sum,mean,min,max,count}), shift, diff and rowid, on a
replicated table and on 1D tables of 4 shards (the cross-shard carries
and the multi-hop halos): shards of 256 rows, a window of 300 rows
(wider than a shard), an empty middle shard and a short shard (both
made by the reference's per-shard filter, whose layout to_port keeps),
and a table of fewer rows than shards; then the port against pandas on
the same arrays.

Tolerances. Integer-valued outputs bit-identical: cummax, cummin, the
rolling min, max and count, shift, diff (one subtraction of the same
two values) and rowid, with NaN where the reference has NaN. The float
prefixes (cumsum; rolling sum and mean, which are differences of two
prefixes over the block and its halo) agree within
64 * 2^-52 * sum(|x|) in absolute terms: the port's prefix is a
Hillis-Steele scan (ceil(log2 n) levels), the reference's jitted cumsum
is reassociated by XLA (ROADMAP F11), and each differs from the exact
prefix by at most about log2(n) + 1 roundings of values no larger than
the largest prefix of |x|, so their difference stays under
2 * 11 * 2^-53 * sum(|x|) at n <= 1024 (64 * 2^-52 leaves room);
relative to one small window sum that can be far above 1e-12. cumprod
over values near 1: rtol n * 2^-52, one rounding a product in either
order. Against pandas (its own sequential sums with compensation) the
same tolerances. One test runs every check (see tests/torch_parity.py
on why each test_torch_* file holds one test).
"""

import numpy as np
import pandas as pd

from tests.torch_parity import (port_routes_reset, reference,  # noqa: F401
                                to_port, torch_one_thread)

SHARDS = 4
EPS = 2.0 ** -52
ROLL_WINDOWS = (1, 3, 13, 300)
SHIFTS = (1, 7, 300)


def _specs(cols):
    specs = [("f", "rowid", None, "rid")]
    for c in cols:
        for op in ("cumsum", "cummax", "cummin"):
            specs.append((c, op, None, f"{c}_{op}"))
        for w in ROLL_WINDOWS:
            for op in ("sum", "mean", "min", "max", "count"):
                specs.append((c, f"rolling_{op}", w, f"{c}_r{op}{w}"))
        for n in SHIFTS:
            specs.append((c, "shift", n, f"{c}_shift{n}"))
            specs.append((c, "diff", n, f"{c}_diff{n}"))
    specs.append(("p", "cumprod", None, "p_cumprod"))
    return specs


def _frame(n: int, seed: int):
    """f: float64 with NaN, i: int64 with nulls, p: near 1 (cumprod),
    k: the 256-row block of each row (the filters' key), u: uniform."""
    r = np.random.default_rng(seed)
    f = np.round(r.normal(size=n) * 100, 3) + 0.0
    f[r.random(n) < 0.1] = np.nan
    inull = r.random(n) < 0.1
    i = r.integers(-1000, 1000, n)
    return pd.DataFrame({
        "f": f,
        "i": pd.array(np.where(inull, None, i), dtype="Int64"),
        "p": 1.0 + r.normal(size=n) * 0.01,
        "k": np.arange(n) // 256,
        "u": r.random(n),
    })


def _abs_tol(x) -> float:
    return 64 * EPS * float(np.nansum(np.abs(np.asarray(x, np.float64))))


def _tolerance(name: str, src):
    """(kind, scale) of an output column's tolerance."""
    if name == "p_cumprod":
        return "rel", len(src) * EPS
    if "_cumsum" in name or "_rsum" in name or "_rmean" in name:
        return "abs", _abs_tol(src)
    return "exact", 0.0


def _close(got, want, name: str, src, label: str):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    lab = f"{label} {name}"
    assert np.array_equal(np.isnan(got), np.isnan(want)), lab
    kind, tol = _tolerance(name, src)
    if kind == "exact":
        np.testing.assert_array_equal(got, want, err_msg=lab)
    elif kind == "abs":
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=lab)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=0, err_msg=lab)


def _hold(port, ref, src_df, label: str):
    """Layout exactly, every output column on the real rows."""
    from tests.torch_parity import _live_rows
    assert port.names == ref.names, label
    assert port.distribution == ref.distribution, label
    assert port.capacity == ref.capacity, label
    if ref.counts is not None:
        np.testing.assert_array_equal(port.counts, ref.counts)
    live = _live_rows(ref)
    for name in ref.names:
        pc, rc = port.column(name), ref.column(name)
        assert pc.dtype.name == rc.dtype.name, (label, name)
        assert (pc.valid is None) == (rc.valid is None), (label, name)
        got = pc.data.numpy()[live]
        want = np.asarray(rc.data)[live]
        if name in src_df.columns:
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        col = name.split("_")[0]
        src = src_df[col].astype("float64") if col in src_df else None
        _close(got, want, name, src, label)


def _pandas_oracle(df):
    """The same transforms by pandas on the rows in table order."""
    out = {"rid": np.arange(len(df), dtype=np.float64)}
    for c in ("f", "i"):
        s = df[c].astype("float64").reset_index(drop=True)
        out[f"{c}_cumsum"] = s.cumsum()
        out[f"{c}_cummax"] = s.cummax()
        out[f"{c}_cummin"] = s.cummin()
        for w in ROLL_WINDOWS:
            for op in ("sum", "mean", "min", "max", "count"):
                out[f"{c}_r{op}{w}"] = getattr(s.rolling(w), op)()
        for n in SHIFTS:
            out[f"{c}_shift{n}"] = s.shift(n)
            out[f"{c}_diff{n}"] = s.diff(n)
    out["p_cumprod"] = df["p"].reset_index(drop=True).cumprod()
    return out


def _check_pandas(port, df, label: str):
    got = port.to_pandas()
    want = _pandas_oracle(df)
    for name, w in want.items():
        _close(got[name].to_numpy(np.float64), np.asarray(w, np.float64),
               name, df[name.split("_")[0]].astype("float64")
               if name != "rid" else df["u"], f"{label} pandas")


def _run(ref_t, df, label: str):
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    specs = _specs(("f", "i"))
    ref = R.window_table(ref_t, specs)
    port_routes_reset()
    port = PR.window_table(to_port(ref_t), specs)
    _hold(port, ref, df, label)
    _check_pandas(port, df, label)
    return port


def test_window_ops_match_reference(reference):
    import bodo_tpu
    import bodo_tpu.relational as R
    import jax
    from bodo_tpu.plan.expr import ColRef as c
    from bodo_tpu.plan.expr import Lit
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh

    df = _frame(1000, 0)
    _run(RefTable.from_pandas(df), df, "REP")
    ref_mesh = bodo_tpu.make_mesh(jax.devices()[:SHARDS])
    with bodo_tpu.use_mesh(ref_mesh), \
            use_mesh(make_mesh(SHARDS, device="cpu")):
        t1 = RefTable.from_pandas(df).shard()
        assert list(t1.counts) == [256, 256, 256, 232]
        _run(t1, df, "1D")
        # an empty middle shard and a short shard: the reference's
        # per-shard filter keeps block 1 out and 5 rows of block 2
        pred = (c("k") != Lit(1)) & ((c("k") != Lit(2)) |
                                     (c("u") < Lit(0.02)))
        tf = R.filter_table(t1, pred)
        keep = (df["k"] != 1) & ((df["k"] != 2) | (df["u"] < 0.02))
        sub = df[keep].reset_index(drop=True)
        assert tf.counts[1] == 0 and 0 < tf.counts[2] < 13, tf.counts
        _run(tf, sub, "1D empty middle shard")
        # fewer rows than shards
        small = _frame(3, 1)
        ts = RefTable.from_pandas(small).shard()
        assert list(ts.counts) == [3, 0, 0, 0]
        _run(ts, small, "1D three rows")
