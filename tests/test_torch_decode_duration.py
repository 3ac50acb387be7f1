"""Duration columns through the port's parquet device route.

An arrow duration is stored in parquet as an INT64 with no logical type;
only the file's ARROW:schema entry (base64 of an Arrow IPC schema
message) says it is a duration, and in which unit. The port's footer
reader parses that entry by hand (io/parquet.FileMetaData.durations), so
the device route types such a column as the reference's arrow bridge
does: `dt.from_numpy` of the numpy type pyarrow gives a duration, i.e.
timedelta64[ns], int64 ns ticks, with a validity mask for nulls (whose
ticks are 0, as a timestamp's are).

A pyarrow-written file with a duration[ns] column and a duration[us]
column, both with nulls, and an int64 column, read through the device
route (`device_decode_min_bytes` 0, restored afterwards) on the CPU:
every column decodes on the device; the durations' dtype, ticks and
nulls equal pyarrow's values cast to ns and the port's host route; the
int64 column equals the reference's `arrow_to_table(pq.read_table(f))`.
The reference's `arrow_to_table` itself raises on a duration column
(ROADMAP F8: jnp.asarray refuses numpy's timedelta64), so its dtype rule
is checked through its `dt.from_numpy` and the raise is pinned. Without
pyarrow (a subprocess), the device route reads an uncompressed copy of
the file to the same result.

No tolerance: ticks, masks and dtypes are bit-identical. One test runs
every check (see tests/torch_parity.py on why)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.torch_parity import reference, torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
N = 3000

_NO_PYARROW = r"""
import sys
sys.modules["pyarrow"] = None  # any import of pyarrow raises ImportError
import numpy as np
from bodo_tpu_torch.config import config
from bodo_tpu_torch.io.parquet import read_parquet
config.device_decode_min_bytes = 0
t = read_parquet(sys.argv[1], device="cpu")
np.savez(sys.argv[2], **{n: t.column(n).data.numpy() for n in t.names})
print("DTYPES", ",".join(t.column(n).dtype.name for n in t.names))
"""


def _table(rng):
    import pyarrow as pa
    nulls = rng.random(N) < 0.1
    return pa.table({
        "d_ns": pa.array(rng.integers(-10**15, 10**15, N),
                         pa.duration("ns"), mask=nulls),
        "d_us": pa.array(rng.integers(-10**12, 10**12, N),
                         pa.duration("us"), mask=rng.random(N) < 0.1),
        "i": pa.array(rng.integers(-10**12, 10**12, N), pa.int64()),
    })


def _want(at, name):
    """pyarrow's values of a duration column as (ns ticks, nulls 0;
    validity)."""
    import pyarrow as pa
    arr = at.column(name).combine_chunks()
    ticks = arr.cast(pa.duration("ns")).cast(pa.int64()).fill_null(0)
    return ticks.to_numpy(), ~np.asarray(arr.is_null())


def test_duration_columns_on_the_device_route(reference, tmp_path):
    import pyarrow.parquet as pq
    from bodo_tpu.io.arrow_bridge import arrow_to_table as ref_arrow
    from bodo_tpu.table import dtypes as ref_dt
    from bodo_tpu_torch.config import config
    from bodo_tpu_torch.io import device_decode as DD
    from bodo_tpu_torch.io.arrow_bridge import arrow_to_table
    from bodo_tpu_torch.io.parquet import footer_metadata, read_parquet

    at = _table(np.random.default_rng(0))
    path = str(tmp_path / "dur.parquet")
    pq.write_table(at, path)
    assert footer_metadata(path).durations == {"d_ns": "ns", "d_us": "us"}
    saved = config.device_decode_min_bytes
    config.device_decode_min_bytes = 0
    try:
        DD.reset_decode_counts()
        port = read_parquet(path, device="cpu")
        counts = dict(DD.decode_counts)
    finally:
        config.device_decode_min_bytes = saved
    assert counts["device_decode_cols"] == 3 and \
        counts["host_decode_cols"] == 0, counts
    host = arrow_to_table(pq.read_table(path), device="cpu")
    for name in ("d_ns", "d_us"):
        col = port.column(name)
        want_dt = ref_dt.from_numpy(np.dtype(
            at.schema.field(name).type.to_pandas_dtype())).name
        assert col.dtype.name == want_dt == "timedelta64[ns]", name
        ticks, valid = _want(at, name)
        np.testing.assert_array_equal(col.data[:N].numpy(), ticks,
                                      err_msg=name)
        np.testing.assert_array_equal(col.valid[:N].numpy(), valid,
                                      err_msg=name)
        hc = host.column(name)
        assert hc.dtype is col.dtype and col.vrange is None, name
        assert np.array_equal(hc.data.numpy(), col.data.numpy()), name
        assert np.array_equal(hc.valid.numpy(), col.valid.numpy()), name
    # the reference: the int64 column alike, and its raise on durations
    ref = ref_arrow(pq.read_table(path, columns=["i"]))
    assert port.column("i").dtype.name == ref.column("i").dtype.name
    np.testing.assert_array_equal(port.column("i").data.numpy(),
                                  np.asarray(ref.column("i").data))
    with pytest.raises(TypeError, match="timedelta64"):
        ref_arrow(pq.read_table(path, columns=["d_ns"]))

    # without pyarrow, an uncompressed copy
    plain = str(tmp_path / "dur_plain.parquet")
    pq.write_table(at, plain, compression="none")
    out = str(tmp_path / "dur.npz")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _NO_PYARROW, plain, out],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert "DTYPES timedelta64[ns],timedelta64[ns],int64" in \
        res.stdout.splitlines(), res.stdout
    got = np.load(out)
    for name in port.names:
        np.testing.assert_array_equal(got[name],
                                      port.column(name).data.numpy())
