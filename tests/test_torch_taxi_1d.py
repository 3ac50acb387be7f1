"""The JAX package's default NYC-taxi pipeline, `bodo_tpu_pipeline(...,
shard=True)`, against the port's `pipeline(..., shard=True)` at 20,000
rows on a CPU mesh of 4 shards, from the same parquet/csv files: the
trips are row-sharded, the weather replicated, so the join is the
broadcast join, the 6-key groupby the two-phase sharded groupby of the
packed key, the sort the sample sort.

The result's per-shard counts, capacity, keys, trip_count and gathered
row order are bit-identical to the reference's, avg_miles within rtol
1e-12 (float64 sums in another order); both packages take the same
routes. Gathered, the result equals the port's shard=False result (keys
and counts exactly, avg_miles within rtol 1e-12) and the numpy oracle.
One test runs every check (see tests/torch_parity.py on why each
test_torch_* file holds one test)."""

import numpy as np

from tests.torch_parity import (assert_same_table, port_routes_reset,
                                reference, reference_routes,
                                torch_one_thread)  # noqa: F401

N_ROWS = 20_000
SHARDS = 4
AVG_RTOL = 1e-12


def test_taxi_1d_matches_reference_and_rep(reference, tmp_path):
    import jax
    import bodo_tpu
    from bodo_tpu.workloads.taxi import bodo_tpu_pipeline, gen_taxi_data
    from bodo_tpu_torch.workloads.taxi import (check_against,
                                               gen_taxi_arrays,
                                               numpy_pipeline, pipeline)
    pq, csv = str(tmp_path / "trips.parquet"), str(tmp_path / "w.csv")
    gen_taxi_data(N_ROWS, pq, csv, seed=0)
    with bodo_tpu.use_mesh(bodo_tpu.make_mesh(jax.devices()[:SHARDS])):
        with reference_routes() as ref_routes:
            ref = bodo_tpu_pipeline(pq, csv, shard=True)
    routes = port_routes_reset()
    port = pipeline(pq, csv, device="cpu", shard=True, n_shards=SHARDS)
    assert port.distribution == "1D" and port.num_shards == SHARDS
    assert_same_table(port, ref, float_rtol=AVG_RTOL)
    assert routes == ref_routes
    assert {k: v for k, v in routes.items() if v} == {
        "join_broadcast": 1, "groupby_packed": 1,
        "groupby_sharded_hash": 1, "sort_sharded": 1}

    rep = pipeline(pq, csv, device="cpu").to_numpy()
    got = port.to_numpy()
    check_against(got, rep, rtol=AVG_RTOL)
    check_against(got, numpy_pipeline(*gen_taxi_arrays(N_ROWS, seed=0)),
                  rtol=AVG_RTOL)
    assert len(got["trip_count"]) == 19_910
    assert int(np.sum(got["trip_count"])) == N_ROWS
