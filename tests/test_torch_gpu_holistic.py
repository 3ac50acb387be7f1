"""The holistic aggregations and LISTAGG on CUDA tensors against the same
calls on CPU tensors (the plain path): nunique, mode, median and
quantile_<q> through groupby_agg on the packed route (two keys, then
the sort groupby) and the sort route (one key), the colocated groupby
of a 1D table on 4 shards (its hash shuffle launches partition_rank),
reduce_table on REP and 1D tables, and listagg / listaggd beside
native aggregations, REP and 1D. Values: float64 with NaN and both
signs, int64 near +-2^62 with nulls, bool with nulls, a dictionary
string with nulls; an empty group, a one-value group and a tie for the
mode.

Keys, nunique, mode, strings and valid masks equal, and the data under
a false valid bit too; medians and quantiles within rtol 1e-15 (the
same sort and the same float64 interpolation on both devices); the
float64 sums beside listagg within 1e-12 times the group's sum of |x|
(CUDA adds each segment in pieces, the CPU in row order). Marked
`cuda`: skips without a GPU. It imports nothing of the test harness, so
on the card's machine it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_gpu_holistic.py
"""

import numpy as np
import pandas as pd
import pytest

Q_RTOL = 1e-15
SUM_RTOL = 1e-12
SHARDS = 4
BIG = 1 << 62
AGGS = [("f64", "nunique", "f64_nunique"), ("f64", "mode", "f64_mode"),
        ("f64", "median", "f64_median"), ("f64", "quantile_0.1", "f64_q"),
        ("i64", "nunique", "i64_nunique"), ("i64", "mode", "i64_mode"),
        ("i64", "quantile_0.9", "i64_q"), ("bo", "mode", "bo_mode"),
        ("s", "nunique", "s_nunique"), ("s", "mode", "s_mode")]
LISTAGGS = [("s", "listagg:|", "s_list"), ("i64", "listaggd", "i64_set"),
            ("f64", "sum", "f64_sum"), ("fabs", "sum", "fabs_sum"),
            ("s", "count", "s_count")]


def _frame(r, n: int, a_hi: int, b_hi: int):
    """Random rows over keys a < a_hi, b < b_hi, then at a = a_hi: an
    all-null group, a one-value group and a tie (3, 1, 3, 1, 2)."""
    edges = [[None] * 3, [2], [3, 1, 3, 1, 2]]
    a = np.concatenate([r.integers(0, a_hi, n)]
                       + [np.full(len(g), a_hi) for g in edges])
    b = np.concatenate([r.integers(0, b_hi, n)]
                       + [np.full(len(g), j) for j, g in enumerate(edges)])
    small = np.concatenate([r.integers(-6, 7, n)]
                           + [np.array([0 if v is None else v for v in g])
                              for g in edges])
    null = np.concatenate([r.random(n) < 0.1]
                          + [np.array([v is None for v in g])
                             for g in edges])
    f = np.round(r.normal(size=len(a)), 1) + 0.0
    f[n:] = small[n:]
    f[null] = np.nan
    i64 = np.where(small < 0, -BIG, BIG - 13) + small
    words = np.array(["alpha", "beta", "gamma", "delta", "eps"])
    return pd.DataFrame({
        "a": a.astype(np.int64), "b": b.astype(np.int64), "f64": f,
        "fabs": np.abs(f),
        "i64": pd.array(np.where(null, None, i64), dtype="Int64"),
        "bo": pd.array(np.where(null, None, small > 0), dtype="boolean"),
        "s": pd.array(np.where(null, None, words[small % 5]), dtype=object),
    })


def _arrays(t):
    g = t.gather() if t.distribution == "1D" else t
    n = g.nrows
    return {name: (c.dtype.name, c.data[:n].cpu().numpy(),
                   None if c.valid is None else c.valid[:n].cpu().numpy(),
                   None if c.dictionary is None else list(c.dictionary))
            for name, c in g.columns.items()}


def _hold(got, want, label: str):
    """Exact but for the float64 quantiles (rtol Q_RTOL) and sums (within
    SUM_RTOL times the sum of |x| of the group, the fabs_sum column:
    a sum of values of both signs may cancel to near 0, where CUDA's
    other order of additions differs by more than SUM_RTOL of it)."""
    assert list(got) == list(want), label
    for name, (dtype, data, valid, dictionary) in want.items():
        gd, gdata, gvalid, gdict = got[name]
        lab = f"{label} {name}"
        assert gd == dtype and gdict == dictionary, lab
        assert (gvalid is None) == (valid is None), lab
        if valid is not None:
            np.testing.assert_array_equal(gvalid, valid, err_msg=lab)
        if name.endswith("_sum"):
            scale = want["fabs_sum"][1]
            assert (np.abs(gdata - data) <= SUM_RTOL * scale).all(), lab
        elif name.endswith(("_median", "_q")):
            np.testing.assert_allclose(gdata, data, rtol=Q_RTOL, atol=0,
                                       equal_nan=True, err_msg=lab)
        else:
            np.testing.assert_array_equal(gdata, data, err_msg=lab)


@pytest.mark.cuda
def test_holistic_aggs_on_gpu_match_cpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels)")
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.table.table import Table

    r = np.random.default_rng(0)
    df = _frame(r, 20_000, 100, 50)

    def on(dev, shard, fn):
        t = Table.from_pandas(df, device=dev)
        if not shard:
            return fn(t)
        with use_mesh(make_mesh(SHARDS, device=t.device)):
            return fn(t.shard())

    cases = [(["a", "b"], False, "packed", {"groupby_packed",
                                            "groupby_sort"}, AGGS),
             (["a"], False, "sort", {"groupby_sort"}, AGGS),
             (["a", "b"], True, "1D", {"groupby_colocated"}, AGGS),
             (["a", "b"], False, "listagg", {"groupby_dense"}, LISTAGGS),
             (["a", "b"], True, "listagg 1D", {"groupby_packed",
                                               "groupby_sharded_hash"},
              LISTAGGS)]
    for keys, shard, label, routes, aggs in cases:
        outs = {}
        for dev in ("cuda", "cpu"):
            R.reset_route_counts()
            CK.reset_launches()
            outs[dev] = on(dev, shard, lambda t: _arrays(
                R.groupby_agg(t, keys, aggs)))
            taken = {k for k, v in R.route_counts.items()
                     if v and "groupby" in k}
            assert taken == routes, (label, dev, taken)
            if dev == "cuda" and label == "1D":
                assert CK.launches["partition_rank"] == SHARDS, label
        _hold(outs["cuda"], outs["cpu"], label)

    raggs = AGGS + [("f64", "quantile_0.99", "f64_q99"),
                                 ("s", "listagg", "s_list")]
    for shard in (False, True):
        got = on("cuda", shard, lambda t: R.reduce_table(t, raggs))
        want = on("cpu", shard, lambda t: R.reduce_table(t, raggs))
        assert list(got) == list(want)
        for _, _, o in raggs:
            g, w = got[o], want[o]
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=Q_RTOL, abs=0), o
            else:
                assert g == w, (shard, o, g, w)
