"""The NYC-taxi slice on the port against the JAX package's
bodo_tpu_pipeline(shard=False), the pandas oracle and the port's numpy
oracle, at 20k rows from the same parquet/csv files.

Group keys and trip_count must be bit-identical. avg_miles is a mean of
float64 segment sums, which the port accumulates with index_add_ and the
reference with XLA's scatter-add: the same values, possibly summed in
another order, hence rtol=1e-12 rather than equality.

One test runs every check (see tests/torch_parity.py on why each
test_torch_* file holds one test)."""

import numpy as np

from tests.torch_parity import (assert_same_table, port_routes_reset,
                                reference, reference_routes,
                                torch_one_thread)  # noqa: F401

N_ROWS = 20_000
AVG_RTOL = 1e-12


def _check_slice_matches_reference(taxi_files):
    from bodo_tpu.workloads.taxi import bodo_tpu_pipeline
    from bodo_tpu_torch.workloads.taxi import pipeline
    pq, csv = taxi_files
    with reference_routes() as ref_routes:
        ref = bodo_tpu_pipeline(pq, csv, shard=False)
    routes = port_routes_reset()
    port = pipeline(pq, csv, device="cpu")
    assert_same_table(port, ref, float_rtol=AVG_RTOL)
    assert port.nrows == 19_910
    assert routes == ref_routes
    assert {k: v for k, v in routes.items() if v} == {
        "join_dense": 1, "groupby_packed": 1, "groupby_hashed": 1,
        "sort_local": 1}


def _check_slice_matches_pandas_and_numpy_oracles(taxi_files):
    from bodo_tpu.workloads.taxi import pandas_pipeline
    from bodo_tpu_torch.workloads.taxi import (KEYS, check_against,
                                               gen_taxi_arrays,
                                               numpy_pipeline, pipeline)
    pq, csv = taxi_files
    got = pipeline(pq, csv, device="cpu").to_numpy()
    exp = pandas_pipeline(pq, csv)
    check_against(got, {k: exp[k].to_numpy() for k in exp.columns},
                  rtol=AVG_RTOL)
    oracle = numpy_pipeline(*gen_taxi_arrays(N_ROWS, seed=0))
    check_against(got, oracle, rtol=AVG_RTOL)
    assert list(oracle) == KEYS + ["trip_count", "avg_miles"]


def _check_tables_from_arrays_take_the_file_routes(taxi_files):
    """The arrays path that runs on the card (no pandas, no pyarrow) gives
    the same tables, bounds included, and so the same routes and result
    as the file path."""
    from bodo_tpu_torch.io import read_csv, read_parquet
    from bodo_tpu_torch.workloads.taxi import (gen_taxi_arrays, pipeline,
                                               tables_from_arrays)
    pq, csv = taxi_files
    trips, weather = tables_from_arrays(*gen_taxi_arrays(N_ROWS, seed=0),
                                        device="cpu")
    for mine, read in ((trips, read_parquet(pq, device="cpu")),
                       (weather, read_csv(csv, parse_dates=["DATE"],
                                          device="cpu"))):
        assert mine.names == read.names
        for name in mine.names:
            a, b = mine.column(name), read.column(name)
            assert a.dtype is b.dtype and a.vrange == b.vrange, name
            np.testing.assert_array_equal(a.data.numpy(), b.data.numpy())
            if a.dictionary is not None:
                np.testing.assert_array_equal(a.dictionary, b.dictionary)
    routes = port_routes_reset()
    from_arrays = pipeline(trips, weather).to_numpy()
    array_routes = dict(routes)
    port_routes_reset()
    from_files = pipeline(pq, csv, device="cpu").to_numpy()
    assert array_routes == routes
    for k, v in from_files.items():
        np.testing.assert_array_equal(np.asarray(from_arrays[k]),
                                      np.asarray(v), err_msg=k)


def _check_port_generator_writes_the_reference_files(tmp_path):
    import pandas as pd
    from bodo_tpu.workloads.taxi import gen_taxi_data as ref_gen
    from bodo_tpu_torch.workloads.taxi import gen_taxi_data
    ref_gen(3000, str(tmp_path / "r.parquet"), str(tmp_path / "r.csv"),
            seed=3)
    gen_taxi_data(3000, str(tmp_path / "p.parquet"),
                  str(tmp_path / "p.csv"), seed=3)
    pd.testing.assert_frame_equal(pd.read_parquet(tmp_path / "p.parquet"),
                                  pd.read_parquet(tmp_path / "r.parquet"))
    assert (tmp_path / "p.csv").read_text() == \
        (tmp_path / "r.csv").read_text()


def test_taxi_slice_matches_reference_and_oracles(reference, tmp_path):
    from bodo_tpu.workloads.taxi import gen_taxi_data
    pq, csv = str(tmp_path / "trips.parquet"), str(tmp_path / "weather.csv")
    gen_taxi_data(N_ROWS, pq, csv, seed=0)
    _check_slice_matches_reference((pq, csv))
    _check_slice_matches_pandas_and_numpy_oracles((pq, csv))
    _check_tables_from_arrays_take_the_file_routes((pq, csv))
    _check_port_generator_writes_the_reference_files(tmp_path)
