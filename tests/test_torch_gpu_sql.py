"""The port's SQL entry point on the card: tests/test_torch_sql_tpch.py's
check with the context on CUDA. gen_tpch(n_orders=900, seed=3); each of
the 22 TPC-H queries through BodoSQLContext(device="cuda") against
sqlite (after the normalization of tests/test_tpch.py, floats
unrounded; within rtol 1e-9: sqlite sums in another order) and against
the same query through a context on the CPU (the same routes; integers,
strings, dates and nulls equal, floats within rtol 1e-12: the groupby's
float sums reduce each segment in row order on both devices, so only
whole-column reductions such as reduce_table's add in another order on
the card). Q16 raises NotImplementedError naming _nunique. The dense-LUT
join's lut_gather and the hash join's hash_probe launch on the card.

Marked `cuda`: skips without a GPU. It imports nothing of the test
harness and nothing of the JAX package, so on the card's machine it runs
with

    python -m pytest --noconftest -m cuda tests/test_torch_gpu_sql.py
"""

import numpy as np
import pandas as pd
import pytest


@pytest.mark.cuda
def test_sql_tpch_on_gpu_matches_sqlite_and_cpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels)")
    from bodo_tpu_torch import relational as R
    from bodo_tpu_torch.ops import cuda_kernels as CK
    from bodo_tpu_torch.sql import BodoSQLContext
    from bodo_tpu_torch.workloads.tpch import (QUERIES, UNSUPPORTED,
                                               check_against_sqlite,
                                               gen_tpch, sqlite_connection,
                                               to_sqlite)

    data = gen_tpch(n_orders=900, seed=3)
    conn = sqlite_connection(data)
    gpu = BodoSQLContext(data, device="cuda")
    cpu = BodoSQLContext(data, device="cpu")
    CK.reset_launches()
    for q in sorted(set(QUERIES) - set(UNSUPPORTED)):
        sql = QUERIES[q]
        R.reset_route_counts()
        want = cpu.sql(sql).to_pandas()
        cpu_routes = dict(R.route_counts)
        R.reset_route_counts()
        got = gpu.sql(sql).to_pandas()
        assert dict(R.route_counts) == cpu_routes, f"Q{q}"
        assert list(got.columns) == list(want.columns), f"Q{q}"
        for c in want.columns:
            assert got[c].dtype == want[c].dtype, f"Q{q} {c}"
            if want[c].dtype.kind == "f":
                np.testing.assert_allclose(got[c].to_numpy(),
                                           want[c].to_numpy(), rtol=1e-12,
                                           atol=0, equal_nan=True,
                                           err_msg=f"Q{q} {c}")
            else:
                pd.testing.assert_series_equal(got[c], want[c],
                                               check_exact=True)
        exp = pd.read_sql_query(to_sqlite(sql), conn)
        check_against_sqlite(got, exp, sql, rtol=1e-9, label=f"Q{q}")
    for q, route in sorted(UNSUPPORTED.items()):
        with pytest.raises(NotImplementedError, match=route):
            gpu.sql(QUERIES[q]).to_pandas()
    assert CK.launches["lut_gather"] > 0
    assert CK.launches["hash_probe"] > 0
    conn.close()
