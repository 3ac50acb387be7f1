"""The lazy pandas frontend's taxi programs on the port against the JAX
package, at 20,000 rows from the same parquet/csv files, REP and on a
CPU mesh of 4 shards (sources of 1,000 rows or more sharded in both
packages):

  - `frontend_pipeline` (the reference benchmark's dataframe flavour,
    workloads/taxi.py) against the reference's `frontend_pipeline`:
    keys, trip_count and row order exact, avg_miles within rtol 1e-12
    (float64 sums in another order); every plan the frontends execute
    has the reference's optimized key(), and both packages take the
    same routes (REP: the dense-LUT join, the packed then hashed
    groupby; 4 shards: the broadcast join, the two-phase groupby).
    The result equals the port's relational `pipeline` on the same
    files (avg_miles bit for bit: the same groupby on the same joined
    rows) and the numpy oracle.
  - workloads/frontend.program (the breadth program: groupby
    aggregations with nunique and median, the groupby windows, the
    Series windows, value_counts, nlargest, drop_duplicates,
    pivot_table, melt, set_index/sort_index/head, a left merge with a
    from_pandas dimension) driven through both packages' frontends: the
    same results (integers, strings, NaN positions and row order
    exact, floats within rtol 1e-12, window sums within
    workloads/windows.prefix_atol, F11), the same optimized plans and
    routes; and against pandas (workloads/frontend.pandas_program,
    rtol 1e-12).
  - the datetime fields of the `.dt` accessor (ops/datetime.FIELDS)
    bit-identical to the reference's on timestamps from 1677 to 2262.

No frontend call falls back to pandas: the fallback warning is an error
throughout. One test runs every check (see tests/torch_parity.py on why
each test_torch_* file holds one test)."""

import numpy as np

from tests.torch_parity import (assert_same_frame, frontend_meshes,
                                no_fallback, reference, run_frontends,
                                torch_one_thread)  # noqa: F401

N_ROWS = 20_000
SHARDS = 4
F64_RTOL = 1e-12
SHARD_MIN_ROWS = 1_000


def _check_frontend_pipeline(pq, csv, shards):
    from bodo_tpu.workloads.taxi import frontend_pipeline as ref_fp
    from bodo_tpu_torch.workloads.taxi import (check_against,
                                               frontend_pipeline,
                                               gen_taxi_arrays,
                                               numpy_pipeline, pipeline)
    with frontend_meshes(shards, SHARD_MIN_ROWS):
        ref, port, routes = run_frontends(
            lambda fe: (ref_fp(pq, csv) if fe.package == "bodo_tpu" else
                        frontend_pipeline(pq, csv, **fe.kw)),
            f"frontend_pipeline x{shards}")
    assert_same_frame(port, ref, F64_RTOL, f"frontend_pipeline x{shards}")
    want = ({"join_dense": 1, "groupby_packed": 1, "groupby_hashed": 1}
            if shards == 1 else
            {"join_broadcast": 1, "groupby_packed": 1,
             "groupby_sharded_hash": 1})
    assert routes == want, routes
    got = {k: port[k].to_numpy() for k in port.columns}
    rel = pipeline(pq, csv, device="cpu").to_numpy()
    check_against(got, rel, rtol=0.0)
    check_against(got, numpy_pipeline(*gen_taxi_arrays(N_ROWS, seed=0)),
                  rtol=F64_RTOL)
    assert len(port) == 19_910


def _check_breadth_program(pq, shards):
    from bodo_tpu_torch.workloads import frontend as FE
    zones = FE.dimension_frame()
    with frontend_meshes(shards, SHARD_MIN_ROWS):
        ref, port, routes = run_frontends(
            lambda fe: FE.program(fe.bd, pq, zones, fe.kw),
            f"breadth x{shards}")
    FE.check(port, ref, F64_RTOL, f"breadth x{shards} vs reference")
    FE.check(port, FE.pandas_program(pq, zones), F64_RTOL,
             f"breadth x{shards} vs pandas")
    if shards > 1:
        for r in ("join_broadcast", "groupby_colocated",
                  "rank_window_shuffle", "agg_window_shuffle",
                  "sort_sharded"):
            assert routes.get(r), (r, routes)


def _check_dt_fields_match_reference():
    import jax.numpy as jnp
    import torch
    from bodo_tpu.ops import datetime as ref_dt
    from bodo_tpu_torch.ops import datetime as port_dt
    r = np.random.default_rng(5)
    ns = np.concatenate([
        r.integers(np.iinfo(np.int64).min + 1, np.iinfo(np.int64).max,
                   50_000),
        r.integers(-10**18, 10**18, 50_000),
        np.array([0, -1, 1, 86_399_999_999_999, -86_400_000_000_000])])
    assert set(port_dt.FIELDS) == set(ref_dt.FIELDS)
    for field in sorted(ref_dt.FIELDS):
        want = np.asarray(ref_dt.FIELDS[field](jnp.asarray(ns)))
        got = port_dt.FIELDS[field](torch.from_numpy(ns)).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)


def test_frontend_taxi_programs_match_reference(reference, tmp_path):
    from bodo_tpu.workloads.taxi import gen_taxi_data
    pq, csv = str(tmp_path / "trips.parquet"), str(tmp_path / "w.csv")
    gen_taxi_data(N_ROWS, pq, csv, seed=0)
    with no_fallback():
        for shards in (1, SHARDS):
            _check_frontend_pipeline(pq, csv, shards)
            _check_breadth_program(pq, shards)
    _check_dt_fields_match_reference()
