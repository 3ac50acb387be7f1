"""The lazy pandas frontend on the card: tests/test_torch_frontend_taxi.py's
programs with the sources on CUDA against the same programs on the CPU,
REP and on a mesh of 4 shards of each device, from the same files
(20,000 trip rows, read through the device decode: the size gate set
to 0):

  - `frontend_pipeline`: keys, trip_count and row order equal, avg_miles
    within rtol 1e-12 (the groupby's float sums reduce each segment in
    row order on both devices); the same routes;
  - workloads/frontend.program: workloads/frontend.check at rtol 1e-12
    (window sums within workloads/windows.prefix_atol, the same bits
    in practice: the prefix is a Hillis-Steele scan on both devices).

lut_gather (the merge's dense-LUT probe), hybrid_expand and dict_gather
(the read) launch on REP; partition_rank, range_partition and
hash_probe on 4 shards. No call falls back to pandas.

Marked `cuda`: skips without a GPU. It imports nothing of the test
harness and nothing of the JAX package, so on the card's machine it runs
with

    python -m pytest --noconftest -m cuda tests/test_torch_gpu_frontend.py
"""

import warnings

import numpy as np
import pandas as pd
import pytest

N_ROWS = 20_000
SHARDS = 4


def _on(device, shards, fn):
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.parallel.mesh import make_mesh, use_mesh
    R.reset_route_counts()
    if shards == 1:
        out = fn()
    else:
        with use_mesh(make_mesh(shards, device)):
            out = fn()
    return out, {k: v for k, v in R.route_counts.items() if v}


@pytest.mark.cuda
def test_frontend_on_gpu_matches_cpu(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels)")
    import bodo_tpu_torch.pandas_api as bd
    from bodo_tpu_torch.config import config
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.workloads import frontend as FE
    from bodo_tpu_torch.workloads.taxi import (frontend_pipeline,
                                               gen_taxi_data)

    pq, csv = str(tmp_path / "trips.parquet"), str(tmp_path / "w.csv")
    gen_taxi_data(N_ROWS, pq, csv, seed=0)
    zones = FE.dimension_frame()
    saved = (config.device_decode_min_bytes, config.shard_min_rows)
    config.device_decode_min_bytes = 0
    config.shard_min_rows = 1_000
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error",
                                    message=".*falling back to pandas")
            for shards in (1, SHARDS):
                CK.reset_launches()
                cpu, cpu_routes = _on("cpu", shards, lambda: (
                    frontend_pipeline(pq, csv, device="cpu"),
                    FE.program(bd, pq, zones, {"device": "cpu"})))
                gpu, gpu_routes = _on("cuda", shards, lambda: (
                    frontend_pipeline(pq, csv, device="cuda"),
                    FE.program(bd, pq, zones, {"device": "cuda"})))
                assert gpu_routes == cpu_routes, shards
                got, want = gpu[0], cpu[0]
                assert list(got.columns) == list(want.columns)
                for c in want.columns:
                    if want[c].dtype.kind == "f":
                        np.testing.assert_allclose(
                            got[c].to_numpy(), want[c].to_numpy(),
                            rtol=1e-12, atol=0, err_msg=c)
                    else:
                        pd.testing.assert_series_equal(got[c], want[c],
                                                       check_exact=True)
                FE.check(gpu[1], cpu[1], 1e-12, f"breadth x{shards}")
                want_kernels = (("lut_gather", "hybrid_expand",
                                 "dict_gather") if shards == 1 else
                                ("partition_rank", "range_partition",
                                 "hash_probe"))
                for k in want_kernels:
                    assert CK.launches[k] > 0, (k, shards)
    finally:
        config.device_decode_min_bytes, config.shard_min_rows = saved
