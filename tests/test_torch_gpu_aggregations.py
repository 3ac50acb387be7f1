"""The decomposable aggregations on CUDA tensors against the same calls on
CPU tensors (the plain path): groupby_agg on the dense, packed, hashed
and sort routes and the two-phase sharded groupby on 4 shards, and
reduce_table on REP and 1D tables, over f64 and f32 columns with NaN and
int64, int32 and bool columns with nulls, with groups of 1 to 4 rows,
constant and all-null groups and -0.0 beside 0.0.

Keys, counts, min, max (as values: which signed zero a min keeps depends
on the order of the atomics), first, last, integer sums and products,
bool results and valid masks equal, and the data under a false valid bit
too; float64 sums, products, moments, var and std within rtol 1e-9 (f64
atomics add in another order); float32 ones within rtol 1e-5; skew and
kurt within 1e-7 * (1 + |x|), NaN where the CPU has NaN. Marked `cuda`:
skips without a GPU. It imports nothing of the test harness, so on the
card's machine it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_gpu_aggregations.py
"""

import numpy as np
import pandas as pd
import pytest

F64_RTOL = 1e-9
F32_RTOL = 1e-5
MOMENT_TOL = 1e-7
SHARDS = 4
SPECS = {
    "f64": ("sumnull", "sum64", "prod", "min", "max", "first", "last",
            "var", "std", "var0", "std0", "skew", "kurt", "count", "mean"),
    "f32": ("sumnull", "prod", "min", "max", "first", "last", "var", "std",
            "skew", "kurt"),
    "i64": ("sumnull", "sum", "prod", "min", "max", "first", "last", "var0",
            "std0", "kurt"),
    "i32": ("sumnull", "prod", "min", "max", "first", "last", "var",
            "skew", "size"),
    "bo": ("sumnull", "prod", "min", "max", "first", "last"),
}
AGGS = [(c, op, f"{c}_{op}") for c, ops in SPECS.items() for op in ops]
AGGS_1D = [a for a in AGGS if a[1] != "sum64"]
REDUCE_OPS = ("sum", "sumnull", "count", "size", "min", "max", "mean",
              "var", "std", "var0", "std0", "prod", "first", "last", "skew",
              "kurt")
EXACT = ("min", "max", "first", "last", "count", "size")


def _frame(r, n: int, a_hi: int, b_hi: int, prod_safe: bool = False):
    """Random rows over keys a < a_hi, b < b_hi, then edge groups at
    a = a_hi: sizes 1 to 4, constant, all-null, signed zeros."""
    edges = [[1.5], [2.0, 7.0], [1.0, 4.0, 9.0], [0.5, 3.0, -2.0, 8.0],
             [3.0] * 5, [np.nan] * 3, [-0.0, 0.0, -0.0]]
    a = np.concatenate([r.integers(0, a_hi, n)]
                       + [np.full(len(g), a_hi) for g in edges])
    b = np.concatenate([r.integers(0, b_hi, n)]
                       + [np.full(len(g), j) for j, g in enumerate(edges)])
    f = 1.0 + 0.01 * r.standard_normal(n) if prod_safe \
        else r.gamma(2.0, 2.5, n)
    f = np.concatenate([f] + [np.array(g) for g in edges])
    f[:n][r.random(n) < 0.1] = np.nan
    m = len(f)
    ints = r.choice([-1, 1], m) if prod_safe else r.integers(-9, 10, m)
    ints[n:] = np.where(np.isnan(f[n:]), 0, np.round(f[n:]))
    null = r.random(m) < 0.1
    null[n:] = np.isnan(f[n:])
    return pd.DataFrame({
        "a": a.astype(np.int64), "b": b.astype(np.int64), "f64": f,
        "f32": f.astype(np.float32),
        "i64": pd.array(np.where(null, None, ints), dtype="Int64"),
        "i32": pd.array(np.where(null, None, ints), dtype="Int32"),
        "bo": pd.array(np.where(null, None, ints > 0), dtype="boolean"),
    })


def _close(got, want, op: str, label: str):
    if op in ("skew", "kurt"):
        assert np.array_equal(np.isnan(got), np.isnan(want)), label
        ok = ~np.isnan(want)
        assert (np.abs(got[ok] - want[ok])
                <= MOMENT_TOL * (1 + np.abs(want[ok]))).all(), label
    elif want.dtype.kind == "f" and op not in EXACT:
        rtol = F32_RTOL if want.dtype == np.float32 else F64_RTOL
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                   err_msg=label)
    else:
        np.testing.assert_array_equal(got, want, err_msg=label)


def _arrays(t):
    g = t.gather() if t.distribution == "1D" else t
    n = g.nrows
    return {name: (c.dtype.name, c.data[:n].cpu().numpy(),
                   None if c.valid is None else c.valid[:n].cpu().numpy())
            for name, c in g.columns.items()}


def _hold(got, want, label: str):
    assert list(got) == list(want), label
    for name, (dtype, data, valid) in want.items():
        gd, gdata, gvalid = got[name]
        lab = f"{label} {name}"
        assert gd == dtype, lab
        assert (gvalid is None) == (valid is None), lab
        if valid is not None:
            np.testing.assert_array_equal(gvalid, valid, err_msg=lab)
        op = name.split("_", 1)[1] if "_" in name else "count"
        _close(gdata, data, op, lab)


def _same_scalar(got, want, op: str, label: str):
    if want is None or pd.isna(want):
        assert (got is None) if want is None else pd.isna(got), label
        return
    if op in ("skew", "kurt"):
        assert abs(got - want) <= MOMENT_TOL * (1 + abs(want)), label
    elif isinstance(want, (float, np.floating)) and op not in EXACT:
        assert got == pytest.approx(want, rel=F64_RTOL, abs=0), label
    else:
        assert got == want, (label, got, want)


@pytest.mark.cuda
def test_aggregations_on_gpu_match_cpu():
    import contextlib

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels)")
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.config import config
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.table.table import Table

    r = np.random.default_rng(0)
    dense = _frame(r, 300, 6, 5)
    wide = _frame(r, 20_000, 1000, 1000)
    red = _frame(r, 400, 6, 5, prod_safe=True)
    red["nul"] = pd.array([None] * len(red), dtype="Float64")

    @contextlib.contextmanager
    def settings(**kw):
        saved = {k: getattr(config, k) for k in kw}
        for k, v in kw.items():
            setattr(config, k, v)
        try:
            yield
        finally:
            for k, v in saved.items():
                setattr(config, k, v)

    def on(dev, df, shard, fn):
        t = Table.from_pandas(df, device=dev)
        if not shard:
            return fn(t)
        with use_mesh(make_mesh(SHARDS, device=t.device)):
            return fn(t.shard())

    CK.reset_launches()
    cases = [(dense, {}, False, "dense", "groupby_dense", AGGS),
             (dense.iloc[:0], {}, False, "empty", "groupby_dense", AGGS),
             (wide, {}, False, "packed", "groupby_packed", AGGS),
             (wide, {"pack_keys": False}, False, "hashed", "groupby_hashed",
              AGGS),
             (wide, {"pack_keys": False, "hash_groupby": False}, False,
              "sort", "groupby_sort", AGGS),
             (wide, {}, True, "1D", "groupby_sharded_hash", AGGS_1D),
             (wide, {"hash_groupby": False}, True, "1D sort",
              "groupby_sharded_sort", AGGS_1D)]
    for df, kw, shard, label, route, aggs in cases:
        with settings(**kw):
            outs = {}
            for dev in ("cuda", "cpu"):
                R.reset_route_counts()
                outs[dev] = on(dev, df, shard, lambda t: _arrays(
                    R.groupby_agg(t, ["a", "b"], aggs)))
                assert R.route_counts[route] >= 1, (label, dev)
        _hold(outs["cuda"], outs["cpu"], label)

    raggs = [(c, op, f"{c}_{op}") for c in ("f64", "f32", "i64", "i32",
                                            "nul") for op in REDUCE_OPS]
    raggs += [("bo", op, f"bo_{op}") for op in
              ("min", "max", "sumnull", "prod", "first", "last")]
    for shard in (False, True):
        got = on("cuda", red, shard, lambda t: R.reduce_table(t, raggs))
        want = on("cpu", red, shard, lambda t: R.reduce_table(t, raggs))
        for _, op, o in raggs:
            _same_scalar(got[o], want[o], op, f"reduce shard={shard} {o}")
    # no aggregation here is one the f32 accumulate takes
    assert CK.launches["groupby_sum"] == 0
