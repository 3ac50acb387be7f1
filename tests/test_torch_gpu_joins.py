"""The rest of the 1D join family on CUDA tensors against the same calls
on CPU tensors (the plain path), on meshes of 4 shards: the cross join on
its four layouts and with an empty side; concat_tables of REP and 1D
inputs with other dictionaries, nulls in one input, int32 + int64 and
decimals of mixed scales; the skew-split join (inner and left, one hot
key) and `_append_splits`' two routes; the 1D shuffle join on a string
key with other dictionaries, on two keys, and on null keys with
null_equal False and True; the memory governor's probe of the card
(free bytes plus the allocator's unused cache, split over the shards)
and the broadcast decision it drives.

Row order, per-shard counts, dictionaries, validity and data equal (the
joins only move values; nothing is summed). Marked `cuda`: skips without
a GPU. It imports nothing of the test harness, so on the card's machine
it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_gpu_joins.py
"""

import numpy as np
import pandas as pd
import pytest

SHARDS = 4


def _arrays(t):
    g = t.gather() if t.distribution == "1D" else t
    n = g.nrows
    return (g.nrows, None if t.counts is None else t.counts.tolist(),
            {name: (c.dtype.name,
                    None if c.dictionary is None else list(c.dictionary),
                    c.data[:n].cpu().numpy(),
                    None if c.valid is None else c.valid[:n].cpu().numpy())
             for name, c in g.columns.items()})


def _same(got, want, label: str):
    assert got[:2] == want[:2], label
    assert list(got[2]) == list(want[2]), label
    for name, (dtype, dic, data, valid) in want[2].items():
        gd, gdic, gdata, gvalid = got[2][name]
        lab = f"{label} {name}"
        assert (gd, gdic) == (dtype, dic), lab
        assert (gvalid is None) == (valid is None), lab
        if valid is not None:
            np.testing.assert_array_equal(gvalid, valid, err_msg=lab)
        np.testing.assert_array_equal(gdata, data, err_msg=lab)


def _frames(r, n: int):
    left = pd.DataFrame({
        "k": r.integers(0, 400, n).astype(np.int64),
        "s": np.sort(r.choice([f"w{i:02d}" for i in range(30)], n)),
        "v": np.where(r.random(n) < 0.1, np.nan, r.normal(size=n)),
        "i": pd.array(np.where(r.random(n) < 0.2, None,
                               r.integers(0, 9, n)), dtype="Int32"),
    })
    m = 400
    right = pd.DataFrame({
        "k": np.arange(m, dtype=np.int64),
        "s": r.choice([f"w{i:02d}" for i in range(10, 45, 2)], m),
        "w": r.normal(size=m),
    })
    return left, right


@pytest.mark.cuda
def test_join_family_on_gpu_matches_cpu():
    import decimal

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels)")
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.config import config
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from bodo_tpu_torch.plan import adaptive
    from bodo_tpu_torch.runtime import memory_governor as MG
    from bodo_tpu_torch.table.table import Table

    r = np.random.default_rng(0)
    left, right = _frames(r, 3000)
    hot = left.assign(k=np.where(r.random(len(left)) < 0.5, 3, left["k"]))
    nl = left.assign(s=np.where(r.random(len(left)) < 0.1, None,
                                left["s"]).astype(object))
    dec = pd.DataFrame({"d": [decimal.Decimal(int(v)).scaleb(-2)
                              for v in r.integers(-999, 999, 50)]})
    dec4 = pd.DataFrame({"d": [decimal.Decimal(int(v)).scaleb(-4)
                               for v in r.integers(-999, 999, 30)]})
    small = left.assign(i=left["i"].astype("Int64"))
    other = left.assign(s=r.choice(["aa", "zz"], len(left)))

    def on(dev, fn, *dfs, layouts=None):
        with use_mesh(make_mesh(SHARDS, device=dev)):
            ts = [Table.from_pandas(df, device=dev) for df in dfs]
            ts = [t.shard() if lay == "1D" else t
                  for t, lay in zip(ts, layouts or ["1D"] * len(ts))]
            return _arrays(fn(*ts))

    saved = (config.aqe_skew_min_rows, config.bcast_join_threshold,
             config.mem_governor)
    config.mem_governor = False
    try:
        cases = []
        for lay in (("REP", "REP"), ("1D", "REP"), ("REP", "1D"),
                    ("1D", "1D")):
            cases.append((f"cross {lay}", lambda a, b: R.join_tables(
                a, b, [], [], "cross"), (left.iloc[:50], right.iloc[:7]),
                lay, {}))
        cases.append(("cross empty", lambda a, b: R.join_tables(
            a, b, [], [], "cross"), (left.iloc[:0], right.iloc[:7]),
            ("1D", "REP"), {}))
        for lay in (("REP", "1D"), ("1D", "1D")):
            cases.append((f"concat {lay}", lambda a, b: R.concat_tables(
                [a, b]), (left, nl.iloc[:900]), lay, {}))
        cases.append(("concat int32+int64", lambda a, b: R.concat_tables(
            [a, b]), (left, small), ("1D", "REP"), {}))
        cases.append(("concat decimals", lambda a, b: R.concat_tables(
            [a, b]), (dec, dec4), ("REP", "1D"), {}))
        for how in ("inner", "left"):
            cases.append((f"skew split {how}", lambda a, b, h=how:
                           R.join_tables(a, b, ["k"], ["k"], h),
                           (hot, right), ("1D", "1D"),
                           {"aqe_skew_min_rows": 1,
                            "bcast_join_threshold": 100}))
        cases.append(("append_sharded", lambda a, b:
                      adaptive._append_splits(a, b), (left, left.iloc[:700]),
                      ("1D", "1D"), {}))
        cases.append(("append via concat", lambda a, b:
                      adaptive._append_splits(a, b), (left, other),
                      ("1D", "1D"), {}))
        for how in ("inner", "left", "outer"):
            cases.append((f"shuffle s {how}", lambda a, b, h=how:
                           R.join_tables(a, b, ["s"], ["s"], h),
                           (left, right), ("1D", "1D"),
                           {"bcast_join_threshold": 0}))
            cases.append((f"shuffle k,s {how}", lambda a, b, h=how:
                           R.join_tables(a, b, ["k", "s"], ["k", "s"], h),
                           (left, right), ("1D", "1D"),
                           {"bcast_join_threshold": 0}))
            for ne in (False, True):
                cases.append((f"shuffle nulls {how} {ne}",
                              lambda a, b, h=how, e=ne: R.join_tables(
                                  a, b, ["s"], ["s"], h, null_equal=e),
                              (nl, nl.iloc[::7]), ("1D", "1D"),
                              {"bcast_join_threshold": 0}))
        for label, fn, dfs, lay, kw in cases:
            for k, v in kw.items():
                setattr(config, k, v)
            try:
                R.reset_route_counts()
                got = on("cuda", fn, *dfs, layouts=lay)
                routes = dict(R.route_counts)
                R.reset_route_counts()
                want = on("cpu", fn, *dfs, layouts=lay)
                assert routes == R.route_counts, label
            finally:
                (config.aqe_skew_min_rows, config.bcast_join_threshold) = \
                    saved[:2]
            _same(got, want, label)
            if label.startswith("skew split"):
                assert routes["join_skew_split"] == 1, label
                assert routes["append_sharded"] == 1, label
    finally:
        (config.aqe_skew_min_rows, config.bcast_join_threshold,
         config.mem_governor) = saved

    # the governor's probe of the card and the decision it drives
    MG.reset_governor()
    try:
        dev = torch.device("cuda")
        free, total = torch.cuda.mem_get_info(dev)
        raw = MG._probe_device_budget(dev, SHARDS)
        assert free // SHARDS <= raw <= total // SHARDS
        with use_mesh(make_mesh(SHARDS, device="cuda")):
            budget = MG.governor().derived_budget()
            assert 0 < budget <= int(total // SHARDS * 0.85)
            build = Table.from_pandas(right, device="cuda").shard()
            probe = Table.from_pandas(left, device="cuda").shard()
            fits = MG.table_device_bytes(build) <= \
                config.aqe_bcast_frac * budget
            assert adaptive.join_broadcast_decision(build, probe) == fits
    finally:
        MG.reset_governor()
