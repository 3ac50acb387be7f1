"""The port's parquet footer reader (`footer_metadata` in
bodo_tpu_torch/io/parquet.py, thrift compact bytes parsed without
pyarrow) against pyarrow's FileMetaData, field by field: the schema
leaves (path, physical, converted and logical type, definition and
repetition depth) and top-level names, the row groups (rows, byte size)
and the column chunks (codec, encodings, page offsets, sizes, value
counts, statistics min/max/null count), on flat, nested, decimal, time,
timestamp, date, unsigned, string and statistics-free columns over
several row groups. Then the value bounds that read_parquet attaches
from it (`Column.vrange`), on the device route and on the host route,
against the JAX package's `_attach_footer_ranges` over pyarrow's
statistics.

Tolerance: none, every field is equal. The reference's
`_attach_footer_ranges` runs inside the `reference` fixture on
pyarrow's FileMetaData given to it directly, so its footer cache is
never touched. One test runs every check (see tests/torch_parity.py on
why)."""

import datetime
import decimal
import json

import numpy as np

from tests.torch_parity import reference, torch_one_thread  # noqa: F401

_UNITS = {"milliseconds": "ms", "microseconds": "us", "nanoseconds": "ns"}
_SCALE = {"ms": 1_000_000, "us": 1000, "ns": 1}


def _files(tmp_path, rng):
    import pandas as pd
    import pyarrow as pa
    import pyarrow.parquet as pq
    n = 5000

    def masked(values, typ, p=0.1):
        return pa.array(values, typ, mask=rng.random(n) < p)
    flat = pa.table({
        "i64": masked(rng.integers(-10**12, 10**12, n), pa.int64()),
        "i8": masked(rng.integers(-128, 128, n).astype(np.int8), pa.int8()),
        "u32": pa.array(rng.integers(0, 1 << 32, n).astype(np.uint32)),
        "u64": pa.array(rng.integers(1 << 62, 1 << 63, n).astype(np.uint64)
                        * 2),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "f64": masked(rng.standard_normal(n), pa.float64()),
        "b": masked(rng.integers(0, 2, n).astype(bool), pa.bool_()),
        "s": masked(rng.choice(["x", "yy", "zzz"], n), pa.string()),
        "ts_ms": masked(rng.integers(-10**12, 10**12, n), pa.timestamp("ms")),
        "ts_us": pa.array(rng.integers(0, 10**15, n), pa.timestamp("us")),
        "ts_ns": masked(rng.integers(0, 10**18, n),
                        pa.timestamp("ns", tz="UTC")),
        "d": masked(rng.integers(-20000, 20000, n).astype(np.int32),
                    pa.date32()),
        "t": pa.array(rng.integers(0, 86_400_000, n).astype(np.int32),
                      pa.time32("ms")),
        "dec": pa.array([decimal.Decimal(int(v)).scaleb(-2)
                         for v in rng.integers(-10**6, 10**6, n)],
                        pa.decimal128(9, 2)),
        "all_null": pa.nulls(n, pa.int64()),
        "no_stats": pa.array(rng.integers(0, 100, n)),
    })
    out = []
    p = str(tmp_path / "flat.parquet")
    pq.write_table(flat, p, row_group_size=1500,
                   write_statistics=[c for c in flat.column_names
                                     if c != "no_stats"],
                   compression={c: ("zstd" if i % 2 else "snappy")
                                for i, c in enumerate(flat.column_names)})
    out.append(p)
    nested = pa.table({
        "id": pa.array(np.arange(100)),
        "lst": pa.array([[i, i + 1] if i % 3 else None for i in range(100)],
                        pa.list_(pa.int32())),
        "st": pa.array([{"a": i, "b": str(i)} for i in range(100)]),
    })
    p = str(tmp_path / "nested.parquet")
    pq.write_table(nested, p)
    out.append(p)
    p = str(tmp_path / "pandas.parquet")
    pd.DataFrame({"k": rng.integers(1, 180, n),
                  "v": rng.standard_normal(n)}).to_parquet(p)
    out.append(p)
    # the columns both packages' tables hold (no time or decimal), for
    # the ranges
    p = str(tmp_path / "ranges.parquet")
    pq.write_table(flat.drop_columns(["t", "dec"]), p, row_group_size=1500,
                   write_statistics=[c for c in flat.column_names
                                     if c != "no_stats"])
    out.append(p)
    return out


def _logical(lt):
    """pyarrow's LogicalType as the port's (kind, fields)."""
    kind = lt.type
    if kind == "NONE":
        return None
    j = json.loads(lt.to_json())
    if kind in ("TIME", "TIMESTAMP"):
        return kind, _UNITS[j["timeUnit"]], j["isAdjustedToUTC"]
    if kind == "INT":
        return kind, j["bitWidth"], j["isSigned"]
    if kind == "DECIMAL":
        return kind, j["scale"], j["precision"]
    return (kind,)


def _port_logical(lt):
    if lt is None:
        return None
    if lt.kind in ("TIME", "TIMESTAMP"):
        return lt.kind, lt.unit, lt.utc
    if lt.kind == "INT":
        return lt.kind, lt.bit_width, lt.signed
    if lt.kind == "DECIMAL":
        return lt.kind, lt.scale, lt.precision
    return (lt.kind,)


def _physical_stat(v, cs):
    """A pyarrow statistics value as its physical stored value."""
    lt = cs.logical_type
    if isinstance(v, datetime.datetime):
        unit = _UNITS[json.loads(lt.to_json())["timeUnit"]]
        if hasattr(v, "value"):  # a pandas Timestamp: ns since the epoch
            ns = int(v.value)
        else:
            ns = (v.replace(tzinfo=None) - datetime.datetime(1970, 1, 1)) \
                // datetime.timedelta(microseconds=1) * 1000
        return ns // _SCALE[unit]
    if isinstance(v, datetime.date):
        return int(np.datetime64(v, "D").astype(np.int64))
    if isinstance(v, datetime.time):
        us = ((v.hour * 60 + v.minute) * 60 + v.second) * 10**6 + \
            v.microsecond
        return us // 1000
    if isinstance(v, decimal.Decimal):
        return int(v.scaleb(json.loads(lt.to_json())["scale"]))
    if isinstance(v, str):
        return v.encode("utf-8")
    return v


def _check_footer_matches_pyarrow(paths):
    import pyarrow.parquet as pq
    from bodo_tpu_torch.io.parquet import footer_metadata
    stats_seen = 0
    for path in paths:
        want = pq.ParquetFile(path).metadata
        got = footer_metadata(path)
        assert (got.num_rows, got.num_row_groups, got.num_columns) == \
            (want.num_rows, want.num_row_groups, want.num_columns)
        assert list(got.schema.names) == \
            want.schema.to_arrow_schema().names
        for i in range(want.num_columns):
            a, b = got.schema.column(i), want.schema.column(i)
            assert (a.path, a.physical_type, a.max_definition_level,
                    a.max_repetition_level) == \
                (b.path, b.physical_type, b.max_definition_level,
                 b.max_repetition_level), b.path
            # pyarrow derives the converted type from the logical type and
            # reports none for a timestamp not adjusted to UTC, which the
            # file still annotates (TIMESTAMP_MILLIS/MICROS) for old readers
            if b.converted_type != "NONE" or b.logical_type.type == "NONE":
                assert (a.converted_type or "NONE") == b.converted_type, \
                    b.path
            assert _port_logical(a.logical_type) == \
                _logical(b.logical_type), b.path
        for rg in range(want.num_row_groups):
            ga, gb = got.row_group(rg), want.row_group(rg)
            assert (ga.num_rows, ga.total_byte_size, ga.num_columns) == \
                (gb.num_rows, gb.total_byte_size, gb.num_columns)
            for ci in range(gb.num_columns):
                a, b = ga.column(ci), gb.column(ci)
                assert (a.path_in_schema, a.physical_type, a.encodings,
                        a.compression, a.num_values,
                        a.total_compressed_size, a.data_page_offset) == \
                    (b.path_in_schema, b.physical_type, b.encodings,
                     b.compression, b.num_values, b.total_compressed_size,
                     b.data_page_offset)
                assert a.dictionary_page_offset == (
                    b.dictionary_page_offset if b.has_dictionary_page
                    else None)
                assert (a.statistics is None) == (b.statistics is None)
                if b.statistics is None:
                    continue
                sa, sb = a.statistics, b.statistics
                assert sa.has_null_count == sb.has_null_count
                assert sa.null_count == sb.null_count
                assert sa.has_min_max == sb.has_min_max, b.path_in_schema
                if sb.has_min_max:
                    cs = want.schema.column(ci)
                    got_bounds = (sa.min, sa.max)
                    if b.physical_type == "FIXED_LEN_BYTE_ARRAY":
                        # a decimal's unscaled big-endian integer
                        got_bounds = tuple(int.from_bytes(v, "big",
                                                          signed=True)
                                           for v in got_bounds)
                    assert got_bounds == (
                        _physical_stat(sb.min, cs),
                        _physical_stat(sb.max, cs)), b.path_in_schema
                    stats_seen += 1
    assert stats_seen > 50


def _check_ranges_match_reference(paths):
    """read_parquet's vranges, on both routes, against the reference's
    `_attach_footer_ranges` over pyarrow's statistics."""
    import pyarrow.parquet as pq
    import bodo_tpu.io.parquet as ref_pq
    from bodo_tpu.io.arrow_bridge import arrow_to_table
    from bodo_tpu_torch.config import config
    from bodo_tpu_torch.io import device_decode as DD
    from bodo_tpu_torch.io.parquet import read_parquet
    for path in paths[2:]:  # the pandas and ranges files
        ref = arrow_to_table(pq.read_table(path))
        md = pq.ParquetFile(path).metadata
        saved = ref_pq.footer_metadata
        ref_pq.footer_metadata = lambda f, sig=None: md
        try:
            ref_pq._attach_footer_ranges(ref, [path])
        finally:
            ref_pq.footer_metadata = saved
        want = {n: c.vrange for n, c in ref.columns.items()}
        assert any(v is not None for v in want.values())
        if "ts_ns" in want:
            # ROADMAP F7: pyarrow gives a tz-aware ns bound as a datetime,
            # so the reference's bound is cut to whole microseconds and can
            # exclude the data's own max; the port keeps the stored ticks
            import pyarrow.compute as pc
            mm = pc.min_max(pq.read_table(path, columns=["ts_ns"])
                            .column(0).cast("int64"))
            lo, hi = mm["min"].as_py(), mm["max"].as_py()
            assert want["ts_ns"] == (lo // 1000 * 1000, hi // 1000 * 1000,
                                     True)
            want["ts_ns"] = (lo, hi, True)
        # the size gate picks the route: 0 takes the device route, a gate
        # above the file's size the host route
        saved = config.device_decode_min_bytes
        try:
            for min_bytes in (0, 1 << 40):
                config.device_decode_min_bytes = min_bytes
                DD.reset_decode_counts()
                got = read_parquet(path, device="cpu")
                assert (DD.decode_counts["device_decode_cols"] > 0) == \
                    (min_bytes == 0), (path, DD.decode_counts)
                assert {n: c.vrange for n, c in got.columns.items()} == \
                    want, (path, min_bytes)
        finally:
            config.device_decode_min_bytes = saved


def test_footer_matches_pyarrow_and_reference(reference, tmp_path):
    paths = _files(tmp_path, np.random.default_rng(0))
    _check_footer_matches_pyarrow(paths)
    _check_ranges_match_reference(paths)
