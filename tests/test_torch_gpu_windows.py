"""The window functions on CUDA tensors against the same calls on CPU
tensors: window_table's cumulative, rolling, shift and diff ops,
rank_window and agg_window, REP and on a 1D table of 4 shards (their
hash shuffle launches partition_rank and their sample sorts
range_partition), and workloads/windows.WINDOW_SQL through
BodoSQLContext on gen_tpch(n_orders=3000), each query run twice on the
card.

Bit-identical: the float prefixes are Hillis-Steele scans, elementwise
IEEE additions in one fixed order on both devices; the sorts are stable;
every division is by a tensor. The one exception is OVER () on a 1D
table, whose sums are reduce_table's per-shard partials (torch's sum
reduces in another order on CUDA): rtol 1e-12 there. A query run twice
on the card gives the same bits. Marked `cuda`: skips without a GPU. It
imports nothing of the test harness, so on the card's machine it runs
with

    python -m pytest --noconftest -m cuda tests/test_torch_gpu_windows.py
"""

import numpy as np
import pandas as pd
import pytest

SHARDS = 4
WHOLE_RTOL = 1e-12


def _frame(n: int, seed: int):
    r = np.random.default_rng(seed)
    f = np.round(r.normal(size=n) * 100, 2) + 0.0
    f[r.random(n) < 0.1] = np.nan
    s = r.choice(["ash", "birch", "cedar", "elm"], n).astype(object)
    s[r.random(n) < 0.1] = None
    return pd.DataFrame({
        "g": pd.array(np.where(r.random(n) < 0.05, None,
                               r.integers(0, 40, n)), dtype="Int64"),
        "o": r.permutation(n).astype(np.int64),
        "t": r.integers(0, 50, n).astype(np.int64),
        "f": f, "s": s,
        "i": pd.array(np.where(r.random(n) < 0.1, None,
                               r.integers(-500, 500, n)), dtype="Int64"),
        "p": 1.0 + r.normal(size=n) * 0.01,
    })


TABLE_SPECS = ([("f", op, None, f"f_{op}")
                for op in ("cumsum", "cummax", "cummin")]
               + [("p", "cumprod", None, "p_cumprod")]
               + [("f", f"rolling_{op}", w, f"f_r{op}{w}")
                  for w in (1, 7, 1000)
                  for op in ("sum", "mean", "min", "max", "count")]
               + [("f", "shift", 3, "f_shift3"), ("f", "diff", 1, "f_diff1"),
                  ("i", "cumsum", None, "i_cumsum")])
RANKS = [("row_number", 0, "rn"), ("rank", 0, "rk"),
         ("dense_rank", 0, "dr"), ("ntile", 9, "nt")]
AGGS = [(op, c, fr, 0, f"{c}_{op}_{j}")
        for j, fr in enumerate([("all",), ("cumrange",), ("rows", -3, 1),
                                ("rows", None, 0)])
        for op in ("sum", "mean", "count", "min", "max", "first_value",
                   "last_value")
        for c in ("f", "s", "i") if not (c == "s" and op in ("sum", "mean"))
        ] + [(op, c, ("all",), 2, f"{c}_{op}") for op in ("lead", "lag")
             for c in ("f", "s")]
WHOLE = [(op, c, ("all",), 0, f"{c}_{op}_whole")
         for op in ("sum", "sum0", "mean", "min", "max", "count")
         for c in ("f", "i")]


def _arrays(t):
    g = t.gather() if t.distribution == "1D" else t
    n = g.nrows
    return {name: (c.dtype.name, c.data[:n].cpu().numpy(),
                   None if c.valid is None else c.valid[:n].cpu().numpy(),
                   None if c.dictionary is None else list(c.dictionary))
            for name, c in g.columns.items()}


def _hold(got, want, label: str, rtol: float = 0.0):
    assert list(got) == list(want), label
    for name, (dtype, data, valid, dictionary) in want.items():
        gd, gdata, gvalid, gdict = got[name]
        lab = f"{label} {name}"
        assert gd == dtype and gdict == dictionary, lab
        assert (gvalid is None) == (valid is None), lab
        if valid is not None:
            np.testing.assert_array_equal(gvalid, valid, err_msg=lab)
        if rtol and data.dtype.kind == "f":
            np.testing.assert_allclose(gdata, data, rtol=rtol, atol=0,
                                       equal_nan=True, err_msg=lab)
        else:
            np.testing.assert_array_equal(gdata, data, err_msg=lab)


@pytest.mark.cuda
def test_windows_on_gpu_match_cpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels)")
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.sql import BodoSQLContext
    from bodo_tpu_torch.table.table import Table
    from bodo_tpu_torch.workloads import windows as WN
    from bodo_tpu_torch.workloads.tpch import gen_tpch

    df = _frame(20_000, 0)

    def on(dev, shard, fn):
        t = Table.from_pandas(df, device=dev)
        if not shard:
            return fn(t)
        with use_mesh(make_mesh(SHARDS, device=t.device)):
            return fn(t.shard())

    cases = [
        ("window_table", lambda t: R.window_table(t, TABLE_SPECS), None),
        ("rank partitioned", lambda t: R.rank_window(
            t, ["g"], ["f", "o"], RANKS, ascending=[False, True]),
         "rank_window_shuffle"),
        ("rank global", lambda t: R.rank_window(t, [], ["s", "t"], RANKS),
         "rank_window_global"),
        ("agg partitioned", lambda t: R.agg_window(t, ["g"], ["o"], AGGS),
         "agg_window_shuffle"),
        ("agg ties", lambda t: R.agg_window(t, ["g"], ["t"], AGGS),
         "agg_window_shuffle"),
        ("agg ordered", lambda t: R.agg_window(t, [], ["o"], AGGS[:12]),
         "agg_window_gather"),
        ("agg OVER ()", lambda t: R.agg_window(t, [], [], WHOLE),
         "agg_window_broadcast"),
    ]
    for label, fn, route in cases:
        for shard in (False, True):
            outs = {}
            for dev in ("cuda", "cpu"):
                R.reset_route_counts()
                CK.reset_launches()
                outs[dev] = on(dev, shard, lambda t: _arrays(fn(t)))
                if dev == "cuda" and shard and route is not None:
                    assert R.route_counts[route] >= 1, (label, route)
                    if route.endswith("shuffle"):
                        assert CK.launches["partition_rank"] >= SHARDS
                    if route.endswith(("shuffle", "global")):
                        assert CK.launches["range_partition"] >= 1, label
            rtol = WHOLE_RTOL if shard and label == "agg OVER ()" else 0.0
            _hold(outs["cuda"], outs["cpu"], f"{label} shard={shard}", rtol)

    data = gen_tpch(n_orders=3000, seed=0)
    gpu, cpu = BodoSQLContext(data), BodoSQLContext(data, device="cpu")
    for q, sql in WN.WINDOW_SQL.items():
        got = gpu.sql(sql).to_pandas()
        again = gpu.sql(sql).to_pandas()
        want = cpu.sql(sql).to_pandas()
        pd.testing.assert_frame_equal(got, again, check_exact=True, obj=q)
        pd.testing.assert_frame_equal(got, want, check_exact=True, obj=q)
