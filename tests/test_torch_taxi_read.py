"""The taxi slice from its parquet file through read_parquet's device
route (bodo_tpu_torch/io/device_decode.py) on the CPU, at 20,000 rows:
the file `gen_taxi_data` writes (pandas' to_parquet, pyarrow's
defaults: snappy, dictionary pages, RLE_DICTIONARY indexes) reads into
the same table as the arrays it was made from (`tables_from_arrays`:
data, masks, dictionaries, capacity and value bounds), every column
decoded on the device route, and the pipeline from the file equals the
pipeline from the arrays row for row (which tests/test_torch_taxi.py
holds against the reference).

Tolerance: none; the two pipelines run the same operations on the same
values. One test runs every check (see tests/torch_parity.py on why)."""

import numpy as np

from tests.torch_parity import torch_one_thread  # noqa: F401

N_ROWS = 20_000


def test_taxi_read_through_device_decode(torch_one_thread, tmp_path):
    from bodo_tpu_torch.config import config
    from bodo_tpu_torch.io import device_decode as DD
    from bodo_tpu_torch.io.parquet import read_parquet
    from bodo_tpu_torch.workloads.taxi import (gen_taxi_arrays, gen_taxi_data,
                                               pipeline, tables_from_arrays)
    pq, csv = str(tmp_path / "trips.parquet"), str(tmp_path / "w.csv")
    gen_taxi_data(N_ROWS, pq, csv, seed=0)
    trips, weather = tables_from_arrays(*gen_taxi_arrays(N_ROWS, seed=0),
                                        device="cpu")
    saved = config.device_decode_min_bytes
    config.device_decode_min_bytes = 0  # a 20k-row file is under 1 MiB
    try:
        DD.reset_decode_counts()
        read = read_parquet(pq, device="cpu")
        counts = dict(DD.decode_counts)
        from_file = pipeline(pq, weather, device="cpu").to_numpy()
    finally:
        config.device_decode_min_bytes = saved
    assert counts["host_decode_cols"] == 0
    assert counts["device_decode_cols"] == 5
    assert counts["pages_dict"] >= 5 and counts["pages_plain"] == 0
    assert read.names == trips.names and read.nrows == trips.nrows
    assert read.capacity == trips.capacity
    for name in trips.names:
        a, b = read.column(name), trips.column(name)
        assert a.dtype is b.dtype and a.vrange == b.vrange, name
        assert a.valid is None and b.valid is None, name
        np.testing.assert_array_equal(a.data.numpy(), b.data.numpy(),
                                      err_msg=name)
        if b.dictionary is not None:
            np.testing.assert_array_equal(a.dictionary, b.dictionary)
    from_arrays = pipeline(trips, weather).to_numpy()
    assert list(from_file) == list(from_arrays)
    for k, v in from_file.items():
        np.testing.assert_array_equal(np.asarray(from_arrays[k]),
                                      np.asarray(v), err_msg=k)
