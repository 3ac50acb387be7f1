"""The port's join family against bodo_tpu on the same inputs (the probe
walk itself is held against the reference in tests/test_torch_probe.py):

  - `join_tables` for inner, left, right and outer joins on unique
    sparse keys (the hash join), duplicate build keys (`_join_rep` by
    hash gids), hash_join=False (`_join_rep` by the union sort), null
    keys with null_equal True and False, an int + string key pair whose
    dictionaries differ, and float keys: rows in the same order,
    bit-identical, over the same routes;
  - the arithmetic expressions against the reference's assign_columns.

One test runs every check (see tests/torch_parity.py on why each
test_torch_* file holds one test)."""

import numpy as np
import pandas as pd

from tests.torch_parity import (assert_same_table, port_routes_reset,
                                reference, reference_routes,
                                torch_one_thread)  # noqa: F401

def _both(df):
    from bodo_tpu.table import Table as RefTable
    from bodo_tpu_torch.table import Table
    return RefTable.from_pandas(df), Table.from_pandas(df, device="cpu")


def _nullable(r, values, p):
    return pd.array(np.where(r.random(len(values)) < p, None,
                             values).tolist(), dtype="Int64")


def _check_join(left, right, on, how, want_route, null_equal=True):
    import bodo_tpu.relational as R
    from bodo_tpu_torch import relational as PR
    rl, pl = _both(left)
    rr, pr = _both(right)
    with reference_routes() as ref_routes:
        ref = R.join_tables(rl, rr, on, on, how, null_equal=null_equal)
    routes = port_routes_reset()
    port = PR.join_tables(pl, pr, on, on, how, null_equal=null_equal)
    assert_same_table(port, ref, check_vrange=True)
    assert routes == ref_routes, (how, routes, ref_routes)
    assert {k: v for k, v in routes.items() if v} == {want_route: 1}, \
        (how, routes)


def _check_join_routes():
    from bodo_tpu.config import config as ref_config
    from bodo_tpu_torch.config import config
    r = np.random.default_rng(11)
    n_dim, n_fact = 700, 2500
    keys = np.unique(r.integers(0, 1 << 40, 2 * n_dim))[:n_dim]
    # unique sparse build keys; the probe side holds nulls and misses
    fact = pd.DataFrame({
        "k": _nullable(r, np.where(r.random(n_fact) < 0.1,
                                   r.integers(0, 1 << 40, n_fact),
                                   r.choice(keys, n_fact)), 0.05),
        "v": r.normal(size=n_fact),
        "s": np.array(["a", "b", "c"])[r.integers(0, 3, n_fact)]})
    dim = pd.DataFrame({"k": keys, "v": r.normal(size=n_dim),
                        "g": r.integers(0, 32, n_dim)})
    # the right join swaps the sides: the build side is then `fact`,
    # whose keys repeat, so it runs _join_rep; outer always does
    for how, route in (("inner", "join_hash"), ("left", "join_hash"),
                       ("right", "join_rep_hash"),
                       ("outer", "join_rep_hash")):
        _check_join(fact, dim, ["k"], how, route)
    # duplicate build keys, nulls on both sides (pandas: nulls match)
    dim_dup = pd.DataFrame({"k": _nullable(r, r.choice(keys[:300], 900),
                                           0.05),
                            "w": r.normal(size=900)})
    for how in ("inner", "left", "right"):
        _check_join(fact, dim_dup, ["k"], how, "join_rep_hash")
    # SQL nulls: never match, on the hash join and on _join_rep
    _check_join(fact, dim, ["k"], "left", "join_hash", null_equal=False)
    _check_join(fact, dim_dup, ["k"], "outer", "join_rep_hash",
                null_equal=False)
    ref_config.hash_join = False
    config.hash_join = False
    try:
        _check_join(fact, dim_dup, ["k"], "outer", "join_rep_sort")
        _check_join(fact, dim_dup, ["k"], "left", "join_rep_sort",
                    null_equal=False)
    finally:
        ref_config.hash_join = True
        config.hash_join = True


def _check_join_two_keys_and_float_keys():
    r = np.random.default_rng(12)
    n = 1500
    ids = r.integers(0, 1 << 40, 60)
    left = pd.DataFrame({
        "id": r.choice(ids, n),
        "city": np.array(["oslo", "rome", "lima", "kyiv"])[
            r.integers(0, 4, n)],
        "x": r.normal(size=n)})
    # another dictionary: one city the left lacks, one it never matches
    right = pd.DataFrame({
        "id": np.repeat(ids[:40], 3),
        "city": np.tile(np.array(["rome", "oslo", "bern"]), 40),
        "y": np.arange(120)})
    _check_join(left, right, ["id", "city"], "inner", "join_hash")
    _check_join(left, right, ["id", "city"], "outer", "join_rep_hash")
    # float keys (no -0.0: ROADMAP F4), NaN keys as nulls
    fk = np.round(r.normal(size=400), 3) + 0.0
    fl = pd.DataFrame({"f": np.where(r.random(n) < 0.05, np.nan,
                                     r.choice(fk, n)), "x": r.normal(size=n)})
    fr = pd.DataFrame({"f": np.append(np.unique(fk), np.nan),
                       "z": np.arange(len(np.unique(fk)) + 1)})
    _check_join(fl, fr, ["f"], "inner", "join_hash")
    _check_join(fl, fr, ["f"], "right", "join_rep_hash")


def _arith_frame(r, n):
    f = r.normal(size=n) * 50
    f[r.random(n) < 0.05] = np.nan
    g = np.round(r.normal(size=n) * 4)  # holds zero divisors
    return pd.DataFrame({
        "i": _nullable(r, r.integers(-1000, 1000, n), 0.1),
        "j": r.integers(-5, 6, n),  # holds zero divisors
        "e": r.integers(0, 5, n),
        "i32": r.integers(-100, 100, n).astype(np.int32),
        "j32": r.integers(-3, 4, n).astype(np.int32),
        "f": f, "g": g, "x": np.abs(f) / 10})


def _check_arithmetic():
    import bodo_tpu.relational as R
    from bodo_tpu.plan import expr as RE
    from bodo_tpu_torch import relational as PR
    from bodo_tpu_torch.plan import expr as E
    rt, pt = _both(_arith_frame(np.random.default_rng(13), 3000))

    def exact(X):
        c = X.ColRef
        return {
            "imod": c("i") % 7, "ifloor": c("i") // -7,
            "imodz": c("i") % c("j"), "ifloorz": c("i") // c("j"),
            "fmodz": c("f") % c("g"), "ffloorz": c("f") // c("g"),
            "idiv": c("i") / c("j"), "div32": c("i32") / c("j32"),
            "ipow": c("i") ** c("e"), "sq": c("i32") * c("i32"),
            "mix": c("i") * c("f"), "shift": c("f") - 2.5,
            "lit": 3 - c("j") + 1,
            "mx": X.BinOp("max2", c("i"), c("f")),
            "mn": X.BinOp("min2", c("j"), c("i")),
            "m32": c("i32") % 3,  # the reference keeps int32 data here
            "neg": -c("f"), "ab": abs(c("i")),
            "ci": X.Cast(c("f"), X.dt.INT32), "na": c("i").isna(),
            "ok": ~(c("f") > 0),
        }

    def inexact(X):
        c = X.ColRef
        return {"fpow": c("x") ** c("g"), "half": c("x") ** 0.5}

    ref = R.assign_columns(rt, exact(RE))
    port = PR.assign_columns(pt, exact(E))
    assert_same_table(port, ref)
    pred = lambda X: X.ColRef("j") % 3 != 0  # noqa: E731
    assert_same_table(PR.filter_table(port, pred(E)),
                      R.filter_table(ref, pred(RE)))
    # XLA's pow and libm's differ in the last bit on some inputs (and
    # XLA contracts a*b+c into one fused multiply-add, so the exact
    # checks above keep products and sums in separate columns)
    assert_same_table(PR.assign_columns(pt, inexact(E)),
                      R.assign_columns(rt, inexact(RE)), float_rtol=1e-15)


def test_join_family_matches_reference(reference):
    _check_join_routes()
    _check_join_two_keys_and_float_keys()
    _check_arithmetic()
