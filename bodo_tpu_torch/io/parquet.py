"""Parquet reader: the device decode route first, the host pyarrow route
otherwise.

Counterpart of the read path of bodo_tpu/io/parquet.py. `read_parquet`
takes the device route of io/device_decode.py when config.device_decode
is on and the read passes its size gate (raw pages decode on the device;
columns it does not cover take the host decode per column), else it
decodes every row group on the host through pyarrow. On both routes the
integer/timestamp/date columns get exact value bounds (`Column.vrange`)
from the footer's row-group statistics, which the dense planners read
instead of reducing on the device.

The footer is parsed here (`footer_metadata`, on the thrift compact
reader of io/device_decode.py), so the device route needs no pyarrow:
pyarrow is imported only by the host decode and by the codecs of a
compressed file.
"""

from __future__ import annotations

import base64
import glob
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from bodo_tpu_torch.config import config, resolve_device
from bodo_tpu_torch.io import device_decode as DD
from bodo_tpu_torch.table.table import Table

# ---------------------------------------------------------------------------
# the footer (parquet.thrift FileMetaData), parsed without pyarrow
# ---------------------------------------------------------------------------

_PHYSICAL = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE",
             "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
_CONVERTED = ("UTF8", "MAP", "MAP_KEY_VALUE", "LIST", "ENUM", "DECIMAL",
              "DATE", "TIME_MILLIS", "TIME_MICROS", "TIMESTAMP_MILLIS",
              "TIMESTAMP_MICROS", "UINT_8", "UINT_16", "UINT_32", "UINT_64",
              "INT_8", "INT_16", "INT_32", "INT_64", "JSON", "BSON",
              "INTERVAL")
_ENCODINGS = {0: "PLAIN", 1: "GROUP_VAR_INT", 2: "PLAIN_DICTIONARY",
              3: "RLE", 4: "BIT_PACKED", 5: "DELTA_BINARY_PACKED",
              6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
              8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
_CODECS = ("UNCOMPRESSED", "SNAPPY", "GZIP", "LZO", "BROTLI", "LZ4", "ZSTD",
           "LZ4_RAW")
# LogicalType union member (field id) -> kind, pyarrow's names
_LOGICAL = {1: "STRING", 2: "MAP", 3: "LIST", 4: "ENUM", 5: "DECIMAL",
            6: "DATE", 7: "TIME", 8: "TIMESTAMP", 10: "INT", 11: "UNKNOWN",
            12: "JSON", 13: "BSON", 14: "UUID", 15: "FLOAT16",
            16: "VARIANT", 17: "GEOMETRY", 18: "GEOGRAPHY"}
_TIME_UNITS = {1: "ms", 2: "us", 3: "ns"}
_REQUIRED, _REPEATED = 0, 2  # FieldRepetitionType (1 is OPTIONAL)


def _name(table, i):
    return table[i] if 0 <= i < len(table) else f"UNKNOWN_{i}"


@dataclass(frozen=True)
class LogicalType:
    """A leaf's logical type: `kind` (pyarrow's name: STRING, INT,
    TIMESTAMP, DATE, DECIMAL, ...) and the fields of its kind."""
    kind: str
    unit: Optional[str] = None       # TIME/TIMESTAMP: 'ms', 'us', 'ns'
    utc: Optional[bool] = None       # TIME/TIMESTAMP: isAdjustedToUTC
    bit_width: Optional[int] = None  # INT
    signed: Optional[bool] = None    # INT
    scale: Optional[int] = None      # DECIMAL
    precision: Optional[int] = None  # DECIMAL


def _logical_type(u: Optional[dict]) -> Optional[LogicalType]:
    if not u:
        return None
    fid, body = next(iter(u.items()))
    kind = _LOGICAL.get(fid, f"UNKNOWN_{fid}")
    body = body or {}
    if kind in ("TIME", "TIMESTAMP"):
        unit = body.get(2) or {}
        return LogicalType(kind, unit=_TIME_UNITS.get(next(iter(unit), 0)),
                           utc=body.get(1))
    if kind == "INT":
        return LogicalType(kind, bit_width=body.get(1), signed=body.get(2))
    if kind == "DECIMAL":
        return LogicalType(kind, scale=body.get(1), precision=body.get(2))
    return LogicalType(kind)


@dataclass(frozen=True)
class ColumnSchema:
    """One leaf of the schema tree."""
    path: str                        # dotted names below the root
    physical_type: str
    converted_type: Optional[str]    # legacy annotation, None if absent
    logical_type: Optional[LogicalType]
    max_definition_level: int
    max_repetition_level: int


@dataclass(frozen=True)
class Schema:
    names: Tuple[str, ...]           # the root's fields (top-level names)
    leaves: Tuple[ColumnSchema, ...]

    def column(self, i: int) -> ColumnSchema:
        return self.leaves[i]


@dataclass(frozen=True)
class Statistics:
    """A column chunk's statistics. `min`/`max` are the physical values
    (ints signed or not as the logical type says; floats; bytes for
    byte arrays), None when the chunk records no bound."""
    null_count: Optional[int]
    min: object
    max: object

    @property
    def has_null_count(self) -> bool:
        return self.null_count is not None

    @property
    def has_min_max(self) -> bool:
        return self.min is not None and self.max is not None


@dataclass(frozen=True)
class ColumnChunk:
    path_in_schema: str
    physical_type: str
    encodings: Tuple[str, ...]
    compression: str
    num_values: int
    total_compressed_size: int
    data_page_offset: int
    dictionary_page_offset: Optional[int]
    statistics: Optional[Statistics]


@dataclass(frozen=True)
class RowGroup:
    num_rows: int
    total_byte_size: int
    columns: Tuple[ColumnChunk, ...]

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, i: int) -> ColumnChunk:
        return self.columns[i]


@dataclass(frozen=True)
class FileMetaData:
    """The parts of a parquet footer the readers use, under pyarrow's
    attribute names; `durations` maps each top-level column that the
    file's ARROW:schema declares an arrow duration to its unit ('s',
    'ms', 'us' or 'ns')."""
    num_rows: int
    schema: Schema
    row_groups: Tuple[RowGroup, ...]
    durations: Dict[str, str] = field(default_factory=dict)

    @property
    def num_columns(self) -> int:
        return len(self.schema.leaves)

    @property
    def num_row_groups(self) -> int:
        return len(self.row_groups)

    def row_group(self, i: int) -> RowGroup:
        return self.row_groups[i]


def _schema(elements: List[dict]) -> Schema:
    """The flattened (depth-first) schema elements as a tree's leaves,
    with their definition and repetition depths."""
    leaves: List[ColumnSchema] = []
    pos = 1

    def walk(prefix, n_children, max_def, max_rep):
        nonlocal pos
        names = []
        for _ in range(n_children):
            el = elements[pos]
            pos += 1
            name = el[4].decode("utf-8")
            rep = el.get(3, _REQUIRED)
            d = max_def + (rep != _REQUIRED)
            r = max_rep + (rep == _REPEATED)
            path = prefix + (name,)
            names.append(name)
            if 1 not in el:  # no physical type: a group
                walk(path, el.get(5, 0), d, r)
            else:
                ct = el.get(6)
                leaves.append(ColumnSchema(
                    path=".".join(path),
                    physical_type=_name(_PHYSICAL, el.get(1, -1)),
                    converted_type=None if ct is None
                    else _name(_CONVERTED, ct),
                    logical_type=_logical_type(el.get(10)),
                    max_definition_level=d, max_repetition_level=r))
        return names

    top = walk((), elements[0].get(5, 0), 0, 0)
    return Schema(tuple(top), tuple(leaves))


def _stat_value(raw: Optional[bytes], cs: ColumnSchema):
    """A statistics bound decoded from its plain encoding."""
    if raw is None:
        return None
    phys = cs.physical_type
    if phys in ("INT32", "INT64"):
        lt = cs.logical_type
        unsigned = (lt is not None and lt.kind == "INT" and not lt.signed) \
            or (cs.converted_type or "").startswith("UINT_")
        return int.from_bytes(raw, "little", signed=not unsigned)
    if phys == "FLOAT":
        return struct.unpack("<f", raw)[0]
    if phys == "DOUBLE":
        return struct.unpack("<d", raw)[0]
    if phys == "BOOLEAN":
        return bool(raw[0])
    return raw


def _signed_order(cs: ColumnSchema) -> bool:
    """Whether the deprecated min/max fields (written in signed order)
    are valid bounds for this leaf."""
    lt = cs.logical_type
    if cs.physical_type in ("BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY", "INT96"):
        return False
    if lt is not None and lt.kind == "INT" and not lt.signed:
        return False
    return not (cs.converted_type or "").startswith("UINT_")


def _statistics(st: Optional[dict], cs: ColumnSchema):
    if st is None:
        return None
    lo, hi = st.get(6), st.get(5)
    if (lo is None or hi is None) and _signed_order(cs):
        lo, hi = st.get(2), st.get(1)
    return Statistics(null_count=st.get(3), min=_stat_value(lo, cs),
                      max=_stat_value(hi, cs))


def _row_group(rg: dict, schema: Schema) -> RowGroup:
    cols = []
    for leaf, cc in zip(schema.leaves, rg[1]):
        m = cc.get(3)
        if m is None:
            raise ValueError("column chunk without metadata (encrypted or "
                             "external column chunks are not supported)")
        cols.append(ColumnChunk(
            path_in_schema=".".join(p.decode("utf-8") for p in m[3]),
            physical_type=_name(_PHYSICAL, m[1]),
            encodings=tuple(_ENCODINGS.get(e, f"UNKNOWN_{e}")
                            for e in m[2]),
            compression=_name(_CODECS, m[4]),
            num_values=m[5], total_compressed_size=m[7],
            data_page_offset=m[9],
            dictionary_page_offset=m.get(11),
            statistics=_statistics(m.get(12), leaf)))
    return RowGroup(num_rows=rg[3], total_byte_size=rg[2],
                    columns=tuple(cols))


# ---------------------------------------------------------------------------
# the ARROW:schema key-value entry: base64 of an Arrow IPC Schema message
# (a flatbuffer: Message -> Schema -> [Field {name, type_type, type}]),
# read by hand so that the footer needs no pyarrow
# ---------------------------------------------------------------------------

_ARROW_DURATION = 18   # Type union member Duration (Schema.fbs)
_ARROW_SCHEMA_MSG = 1  # MessageHeader union member Schema (Message.fbs)
_DURATION_UNITS = ("s", "ms", "us", "ns")  # TimeUnit SECOND..NANOSECOND


def _fb_field(buf: bytes, table: int, i: int) -> Optional[int]:
    """Position of field `i` of the flatbuffer table at `table`, or None
    when the table leaves it at its default."""
    (vt_back,) = struct.unpack_from("<i", buf, table)
    vt = table - vt_back
    (vt_len,) = struct.unpack_from("<H", buf, vt)
    if 4 + 2 * i >= vt_len:
        return None
    (off,) = struct.unpack_from("<H", buf, vt + 4 + 2 * i)
    return table + off if off else None


def _fb_ref(buf: bytes, pos: int) -> int:
    """The table, string or vector an offset field at `pos` points to."""
    return pos + struct.unpack_from("<I", buf, pos)[0]


def _fb_scalar(buf: bytes, table: int, i: int, fmt: str, default):
    pos = _fb_field(buf, table, i)
    return default if pos is None else struct.unpack_from(fmt, buf, pos)[0]


def _arrow_durations(encoded: bytes) -> Dict[str, str]:
    """{top-level field name: unit} of the duration fields of a base64
    ARROW:schema value."""
    raw = base64.b64decode(encoded)
    start = 8 if raw[:4] == b"\xff\xff\xff\xff" else 4  # continuation
    buf = raw[start:]
    msg = _fb_ref(buf, 0)
    if _fb_scalar(buf, msg, 1, "<B", 0) != _ARROW_SCHEMA_MSG:
        raise ValueError("ARROW:schema holds no Schema message")
    schema = _fb_ref(buf, _fb_field(buf, msg, 2))
    fields_pos = _fb_field(buf, schema, 1)
    if fields_pos is None:
        return {}
    vec = _fb_ref(buf, fields_pos)
    (n,) = struct.unpack_from("<I", buf, vec)
    out = {}
    for j in range(n):
        fld = _fb_ref(buf, vec + 4 + 4 * j)
        if _fb_scalar(buf, fld, 2, "<B", 0) != _ARROW_DURATION:
            continue
        name_at = _fb_ref(buf, _fb_field(buf, fld, 0))
        (ln,) = struct.unpack_from("<I", buf, name_at)
        name = buf[name_at + 4:name_at + 4 + ln].decode("utf-8")
        typ = _fb_ref(buf, _fb_field(buf, fld, 3))
        out[name] = _DURATION_UNITS[_fb_scalar(buf, typ, 0, "<h", 1)]
    return out


def footer_metadata(path: str) -> FileMetaData:
    """The parquet footer of `path`, parsed from its thrift compact bytes
    (the JAX package takes it from pyarrow's FileMetaData)."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size < 12:
            raise ValueError(f"{path}: {size} bytes is not a parquet file")
        f.seek(size - 8)
        tail = f.read(8)
        if tail[4:] != b"PAR1":
            raise ValueError(f"{path}: no parquet footer (magic "
                             f"{tail[4:]!r}; encrypted footers are not "
                             f"supported)")
        (n,) = struct.unpack("<I", tail[:4])
        if n + 12 > size:
            raise ValueError(f"{path}: footer of {n} bytes in a file of "
                             f"{size}")
        f.seek(size - 8 - n)
        buf = f.read(n)
    md, _ = DD._read_struct(buf, 0)
    schema = _schema(md[2])
    # key_value_metadata: KeyValue {1: key, 2: value}
    kv = {e[1]: e.get(2) for e in md.get(5, [])}
    arrow = kv.get(b"ARROW:schema")
    return FileMetaData(
        num_rows=md[3], schema=schema,
        row_groups=tuple(_row_group(rg, schema) for rg in md.get(4, [])),
        durations=_arrow_durations(arrow) if arrow else {})


def _raw_range(path: str, start: int, size: int) -> bytes:
    """One raw byte range of a file (a column chunk's pages)."""
    with open(path, "rb") as f:
        f.seek(start)
        return f.read(size)


# ---------------------------------------------------------------------------
# footer ranges and the read
# ---------------------------------------------------------------------------

def _dataset_files(path) -> list:
    """The parquet files of a dataset directory (sorted), or the file."""
    if not os.path.isdir(path):
        return [path]
    files = sorted(glob.glob(os.path.join(path, "**", "*.parquet"),
                             recursive=True))
    if not files:
        raise FileNotFoundError(f"no parquet files under {path}")
    return files


def _stat_bound(v, cs: ColumnSchema) -> Optional[int]:
    """A footer bound as the column's physical device value (timestamps
    in ns ticks, dates in days), else None."""
    if not isinstance(v, int) or isinstance(v, bool):
        return None
    lt = cs.logical_type
    if lt is not None and lt.kind == "TIMESTAMP":
        return v * DD._UNIT_SCALE.get(lt.unit, 1)
    if lt is None and cs.converted_type in DD._CONVERTED_TS:
        return v * DD._UNIT_SCALE[DD._CONVERTED_TS[cs.converted_type]]
    return v


def _attach_footer_ranges(t: Table, metadatas) -> None:
    """Column.vrange from row-group statistics; any row group without
    usable stats clears that column's bound."""
    ranges: dict = {}
    for md in metadatas:
        for g in md.row_groups:
            for leaf, col in zip(md.schema.leaves, g.columns):
                name = col.path_in_schema
                if "." in name or name not in t.columns:
                    continue
                st = col.statistics
                lo = hi = None
                if st is not None and st.has_min_max:
                    lo = _stat_bound(st.min, leaf)
                    hi = _stat_bound(st.max, leaf)
                if lo is None or hi is None:
                    ranges[name] = None
                elif name not in ranges:
                    ranges[name] = (lo, hi)
                elif ranges[name] is not None:
                    ranges[name] = (min(ranges[name][0], lo),
                                    max(ranges[name][1], hi))
    for name, r in ranges.items():
        c = t.columns[name]
        if r is not None and c.dtype.kind in ("i", "u", "dt", "date"):
            c.vrange = (r[0], r[1], True)  # scan stats are data-exact


def _read_host(files, columns, dev) -> Table:
    """Every row group decoded on the host through pyarrow."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from bodo_tpu_torch.io.arrow_bridge import arrow_to_table
    cols = list(columns) if columns else None
    pieces = [pq.ParquetFile(f).read(columns=cols) for f in files]
    at = pa.concat_tables(pieces) if len(pieces) > 1 else pieces[0]
    t = arrow_to_table(at, device=dev)
    DD.decode_counts["host_decode_cols"] += len(t.columns)
    return t


def read_parquet(path, columns: Optional[Sequence[str]] = None,
                 device=None) -> Table:
    """Read a parquet file or dataset directory (its `columns`, all by
    default) into a Table on `device` (CUDA by default)."""
    dev = resolve_device(device)
    files = _dataset_files(path)
    metadatas = [footer_metadata(f) for f in files]
    units = [(f, md, rg) for f, md in zip(files, metadatas)
             for rg in range(md.num_row_groups)]
    t = None
    if units and config.device_decode:
        t = DD.read_units_table(units, columns, dev)
    if t is None:
        t = _read_host(files, columns, dev)
    _attach_footer_ranges(t, metadatas)
    return t
