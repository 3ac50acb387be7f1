"""The port's parquet device decode (bodo_tpu_torch/io/device_decode.py,
through read_parquet's device route on the CPU) against the JAX
package's host read, `arrow_to_table(pq.read_table(f))`, on files that
pyarrow writes: dictionary, PLAIN and RLE-boolean pages (v1 and v2),
definition levels with nulls, timestamps (ms, us, ns) and dates, narrow
and unsigned ints, several pages and row groups, dictionary pages whose
index bit width grows from page to page with nulls, the snappy, gzip,
zstd and no codecs, a dictionary page that overflows into PLAIN pages
(numeric: decoded on the device; strings: the host decode), DELTA and
BYTE_STREAM_SPLIT columns that take the host decode, with the
host/device split the reference's `_plan_chunk` gives, and column
pruning. Without pyarrow, the device route reads an uncompressed file,
and a column that needs the host decode raises naming the column and
the reason.

Tolerance: none. Data over the live rows, validity masks, dictionaries,
capacities and dtypes are bit-identical (NaN matching NaN). The
reference runs only inside the `reference` fixture, and nothing here
calls its read route. One test runs every check (see
tests/torch_parity.py on why)."""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from tests.torch_parity import (assert_same_table, reference,
                                torch_one_thread)  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def _device_route_always():
    """The test files are small: drop the port's size gate for a block."""
    from bodo_tpu_torch.config import config
    saved = config.device_decode, config.device_decode_min_bytes
    config.device_decode, config.device_decode_min_bytes = True, 0
    try:
        yield
    finally:
        config.device_decode, config.device_decode_min_bytes = saved


def _split(path):
    """(the reference's, the port's) `_plan_chunk` verdicts, 'device' or
    'host', for every (row group, column) of `path`."""
    import pyarrow.parquet as pq
    from bodo_tpu.io import device_decode as ref
    from bodo_tpu_torch.io import device_decode as port
    from bodo_tpu_torch.io.parquet import footer_metadata
    md = pq.ParquetFile(path).metadata
    sch = md.schema.to_arrow_schema()
    pmd = footer_metadata(path)
    out = ([], [])
    for rg in range(md.num_row_groups):
        for name in sch.names:
            for verdicts, mod, args in ((out[0], ref, (md, sch, rg, name)),
                                        (out[1], port, (pmd, rg, name))):
                try:
                    mod._plan_chunk(*args)
                    verdicts.append((rg, name, "device"))
                except mod.Unsupported:
                    verdicts.append((rg, name, "host"))
    return out


def _check(path, host_cols=0, columns=None, **want_pages):
    """Read `path` through the device route and the reference's host
    read; the tables must be the same, the route counts as given."""
    import pyarrow.parquet as pq
    from bodo_tpu.io.arrow_bridge import arrow_to_table
    from bodo_tpu_torch.io import device_decode as DD
    from bodo_tpu_torch.io.parquet import read_parquet
    ref_split, port_split = _split(path)
    assert port_split == ref_split
    DD.reset_decode_counts()
    port = read_parquet(path, columns=columns, device="cpu")
    counts = dict(DD.decode_counts)
    ref = arrow_to_table(pq.read_table(path, columns=columns))
    assert_same_table(port, ref)
    assert counts["host_decode_cols"] == host_cols, counts
    n_rg = pq.ParquetFile(path).metadata.num_row_groups
    assert counts["device_decode_cols"] == \
        len(port.names) * n_rg - host_cols, counts
    for kind, least in want_pages.items():
        assert counts[kind] >= least, (kind, counts)
    return counts


def _frame(n, rng):
    import pandas as pd
    return pd.DataFrame({
        "i64": rng.integers(-10**12, 10**12, n),
        "i32": rng.integers(-10**6, 10**6, n).astype(np.int32),
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "u16": rng.integers(0, 1 << 16, n).astype(np.uint16),
        "u32": rng.integers(0, 1 << 32, n).astype(np.uint32),
        "u64": rng.integers(0, 1 << 63, n).astype(np.uint64) * 2 + 1,
        "f64": rng.standard_normal(n),
        "f32": rng.standard_normal(n).astype(np.float32),
        "b": rng.integers(0, 2, n).astype(bool),
        "s": rng.choice(["alpha", "beta", "gamma", "delta"], n),
        "ts": pd.to_datetime(rng.integers(0, 10**18, n)),
    })


def _null_table(n, rng):
    """Optional columns with real nulls: an int keeps a mask, a float gets
    NaN and no mask, strings null rows, bools, timestamps in three units
    and dates; one column null everywhere, one nowhere."""
    import pyarrow as pa

    def masked(values, typ, p=0.15):
        return pa.array(values, typ, mask=rng.random(n) < p)
    return pa.table({
        "i64": masked(rng.integers(-10**12, 10**12, n), pa.int64()),
        "i16": masked(rng.integers(-999, 999, n).astype(np.int16),
                      pa.int16()),
        "f64": masked(rng.standard_normal(n), pa.float64()),
        "s": masked(rng.choice(["x", "yy", "zzz"], n), pa.string()),
        "b": masked(rng.integers(0, 2, n).astype(bool), pa.bool_()),
        "ts_ms": masked(rng.integers(0, 10**12, n), pa.timestamp("ms")),
        "ts_us": masked(rng.integers(0, 10**15, n), pa.timestamp("us")),
        "ts_ns": masked(rng.integers(0, 10**18, n), pa.timestamp("ns")),
        "d": masked(rng.integers(-20000, 20000, n).astype(np.int32),
                    pa.date32()),
        "all_null": masked(np.zeros(n, np.int64), pa.int64(), p=1.1),
        "no_null": masked(rng.integers(0, 9, n), pa.int64(), p=-1),
    })


def _check_encodings(tmp_path, rng):
    import pyarrow.parquet as pq
    df = _frame(3000, rng)
    p = str(tmp_path / "dict.parquet")
    df.to_parquet(p, index=False)
    _check(p, pages_dict=10, pages_boolplain=1)
    p = str(tmp_path / "plain.parquet")
    df.drop(columns=["s"]).to_parquet(p, index=False, use_dictionary=False)
    _check(p, pages_plain=9, pages_boolplain=1)
    p = str(tmp_path / "v2.parquet")
    df.to_parquet(p, index=False, data_page_version="2.0",
                  use_dictionary=["s"])
    _check(p, pages_plain=9, pages_boolrle=1, pages_dict=1)
    at = _null_table(4000, rng)
    for version in ("1.0", "2.0"):
        p = str(tmp_path / f"nulls{version}.parquet")
        pq.write_table(at, p, data_page_version=version)
        _check(p, pages_dict=9)
        p = str(tmp_path / f"nulls_plain{version}.parquet")
        pq.write_table(at, p, data_page_version=version,
                       use_dictionary=False, compression="gzip")
        _check(p, host_cols=1, pages_plain=8,
               **({"pages_boolrle": 1} if version == "2.0"
                  else {"pages_boolplain": 1}))


def _check_pages_row_groups_codecs(tmp_path, rng):
    import pyarrow.parquet as pq
    at = _null_table(9000, rng)
    for codec in ("snappy", "gzip", "zstd", "none"):
        p = str(tmp_path / f"mp_{codec}.parquet")
        pq.write_table(at, p, row_group_size=2500, data_page_size=2048,
                       compression=codec)
        counts = _check(p)
        assert counts["device_decode_pages"] > at.num_columns * 4
    p = str(tmp_path / "pruned.parquet")
    pq.write_table(at, p, row_group_size=4000)
    _check(p, columns=["f64", "s", "ts_us"])


def _check_dictionary_overflow(tmp_path, rng):
    """A dictionary page past its size limit falls back to PLAIN pages in
    the same chunk: numeric chunks decode both kinds on the device (the
    taxi file's trip_miles and pickup_datetime), string chunks take the
    host decode."""
    import pandas as pd
    n = 6000
    df = pd.DataFrame({
        "s": np.array([f"key_{i:06d}" for i in rng.integers(0, 4000, n)]),
        "f": rng.standard_normal(n),
        "i": rng.integers(0, 10, n),
    })
    p = str(tmp_path / "spill.parquet")
    df.to_parquet(p, index=False, dictionary_pagesize_limit=1024,
                  row_group_size=2500)
    counts = _check(p, host_cols=2)
    assert counts["pages_dict"] >= 3 and counts["pages_plain"] >= 2, counts


def _check_growing_bit_width(tmp_path, rng):
    """Chunks of several dictionary pages whose index bit width grows from
    page to page as the dictionary grows, with nulls: one chunk decode
    expands every page's definition levels in one launch and every page's
    indexes in another, each page at its own width."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from bodo_tpu_torch.io import device_decode as DD
    from bodo_tpu_torch.io.parquet import footer_metadata
    n = 6000
    new = np.arange(n) // 2  # a new value every other row
    null = rng.random(n) < 0.2
    at = pa.table({
        "x": pa.array(new * 7 - 5000, pa.int64(), mask=null),
        "s": pa.array([f"v{i:05d}" for i in new], pa.string(),
                      mask=rng.random(n) < 0.1),
    })
    p = str(tmp_path / "growing.parquet")
    pq.write_table(at, p, data_page_size=1024)
    bundle = DD.fetch_row_group(p, footer_metadata(p), 0, None)
    for name in ("x", "s"):
        rc = bundle.device_cols[name]
        widths = [pg.bit_width for pg in rc.pages if pg.kind == "dict"]
        assert len(widths) >= 3 and widths == sorted(widths) and \
            len(set(widths)) >= 3, (name, widths)
        assert rc.plan.max_def == 1 and rc.plan.null_count > 0
    counts = _check(p)
    assert counts["pages_dict"] >= 6, counts


def _check_host_columns(tmp_path, rng):
    import pandas as pd
    n = 3000
    df = pd.DataFrame({"d": np.cumsum(rng.integers(0, 9, n)),
                       "f": rng.standard_normal(n).astype(np.float32),
                       "ok": rng.standard_normal(n)})
    p = str(tmp_path / "delta.parquet")
    df.to_parquet(p, index=False, use_dictionary=False,
                  column_encoding={"d": "DELTA_BINARY_PACKED",
                                   "f": "BYTE_STREAM_SPLIT", "ok": "PLAIN"},
                  row_group_size=1000)
    _check(p, host_cols=6, pages_plain=3)


def _check_empty(tmp_path):
    import pyarrow.parquet as pq
    at = _null_table(0, np.random.default_rng(1))
    p = str(tmp_path / "empty.parquet")
    pq.write_table(at, p)
    from bodo_tpu.io.arrow_bridge import arrow_to_table
    from bodo_tpu_torch.io.parquet import read_parquet
    assert_same_table(read_parquet(p, device="cpu"),
                      arrow_to_table(pq.read_table(p)))


_NO_PYARROW = r"""
import sys
sys.modules["pyarrow"] = None  # any import of pyarrow raises ImportError
import numpy as np
from bodo_tpu_torch.config import config
from bodo_tpu_torch.io.parquet import read_parquet
config.device_decode_min_bytes = 0
t = read_parquet(sys.argv[1], device="cpu")
np.savez(sys.argv[2], **{n: t.column(n).data.numpy() for n in t.names})
for path in sys.argv[3:]:
    try:
        read_parquet(path, device="cpu")
    except RuntimeError as e:
        print("RAISED", e)
    else:
        print("READ", path)
print("PYARROW_IMPORTED", any(m.startswith("pyarrow.")
                              for m in sys.modules))
"""


def _check_without_pyarrow(tmp_path, rng):
    """The device route needs no pyarrow for an uncompressed file; a
    column that needs the host decode (or a codec) then raises, naming
    the column and the reason."""
    import pandas as pd
    from bodo_tpu_torch.io.parquet import read_parquet
    df = _frame(2000, rng)
    plain = str(tmp_path / "np.parquet")
    df.to_parquet(plain, index=False, compression="none")
    delta = str(tmp_path / "np_delta.parquet")
    pd.DataFrame({"d": np.arange(100), "x": np.arange(100.0)}).to_parquet(
        delta, index=False, compression="none", use_dictionary=False,
        column_encoding={"d": "DELTA_BINARY_PACKED", "x": "PLAIN"})
    snappy = str(tmp_path / "np_snappy.parquet")
    df.to_parquet(snappy, index=False)
    out = str(tmp_path / "np.npz")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _NO_PYARROW, plain, out,
                          delta, snappy], capture_output=True, text=True,
                         timeout=120, env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert "PYARROW_IMPORTED False" in lines, res.stdout
    raised = [ln for ln in lines if ln.startswith("RAISED")]
    assert len(raised) == 2, res.stdout
    assert "'d': encoding DELTA_BINARY_PACKED" in raised[0]
    assert "codec snappy: pyarrow is not installed" in raised[1]
    got = np.load(out)
    with _device_route_always():
        want = read_parquet(plain, device="cpu")
    assert sorted(got.files) == sorted(want.names)
    for n in want.names:
        np.testing.assert_array_equal(got[n], want.column(n).data.numpy())


def test_device_decode_matches_reference(reference, tmp_path):
    rng = np.random.default_rng(0)
    with _device_route_always():
        _check_encodings(tmp_path, rng)
        _check_pages_row_groups_codecs(tmp_path, rng)
        _check_dictionary_overflow(tmp_path, rng)
        _check_growing_bit_width(tmp_path, rng)
        _check_host_columns(tmp_path, rng)
        _check_empty(tmp_path)
    _check_without_pyarrow(tmp_path, rng)
