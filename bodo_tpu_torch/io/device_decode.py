"""Device-side Parquet decode: ship raw pages, decode on the device.

Counterpart of bodo_tpu/io/device_decode.py. Instead of pyarrow decoding
every page on the host before the copy to the device, the reader ships
raw column-chunk byte ranges (offsets from the footer, io/parquet.py's
`footer_metadata`) and decodes the common encodings on the device:

  * PLAIN fixed-width (INT32/INT64/FLOAT/DOUBLE): the little-endian bytes
    reinterpreted as the physical dtype,
  * dictionary pages + RLE_DICTIONARY index streams: the host walks the
    RLE/bit-packed hybrid *run headers* (a handful of varints per page),
    the device expands the runs and extracts the bit-packed values
    (the CUDA kernel `hybrid_expand`, ops/cuda_kernels.py), then maps the
    codes through the dictionary (a numeric gather on the device; string
    dictionaries stay host arrays, and codes remap through the
    sorted-rank LUT exactly like `arrow_bridge`, through the `lut_gather`
    kernel at its `dict_gather` call site),
  * RLE/bit-packed booleans and PLAIN bit-packed booleans,
  * definition levels -> validity masks, with densely-packed non-null
    values scattered to row positions via a cumsum of the mask.

Columns the device route does not cover (DELTA_BINARY_PACKED,
BYTE_STREAM_SPLIT, non-dictionary BYTE_ARRAY, INT96, FLBA, nested
columns, a codec pyarrow does not have) take the host pyarrow decode, per
column, where `_plan_chunk` or the page walk raises `Unsupported`, as in
the JAX package. Nothing else demotes: a device decode that fails raises.

Work split: the host does O(pages) work (raw range read, thrift
page-header parse, per-page decompression through pyarrow's codecs,
which is the one use of pyarrow on this route, and only for a compressed
file; the hybrid run-header walk); the device does everything O(values).
Each column chunk's pages, run tables and dictionary move to the device
in one copy.

The JAX package runs each page through a jitted program cached per page
shape (its DecodeProgramCache, with compile budgets in xla_observatory
and the fusion_stage lint), to bound the number of XLA executables.
Eager torch compiles no program per shape, so the port has none of that
machinery and no power-of-two page shapes. A page holds ~20,000 values,
a few microseconds of work against a launch's own cost, so the port
decodes a column chunk as one program (`_run_chunk_program`): one
`hybrid_expand` launch for the definition levels of all its pages, one
for all its dictionary-index or RLE-boolean streams, and chunk-wide
operations for the validity, the dense non-null positions, the
dictionary gather, the scale and dtype and the null fill. PLAIN pages
launch no kernel and are decoded page by page into the chunk's values.
Row groups are fetched one after another; the JAX package's io_pool
threads and fault injection belong to the runtime slice and change no
result.

Bit-identical parity with `arrow_bridge._arrow_column` is the contract:
float nulls become NaN with no mask, int/bool/timestamp/date nulls
become 0/False + mask, string nulls carry raw code 0 *before* the
sorted-rank remap, timestamps and durations scale to ns ticks.

The table dtype of a column comes from its parquet logical type (the
JAX package reads pyarrow's arrow schema), and for an arrow duration,
which parquet stores as an unannotated INT64, from the file's
ARROW:schema entry, which the footer reader parses without pyarrow
(`FileMetaData.durations`): timedelta64[ns], nulls 0 + mask, as the
host route reads it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bodo_tpu_torch.config import config
from bodo_tpu_torch.ops import cuda_kernels as CK
from bodo_tpu_torch.table import dtypes as dt
from bodo_tpu_torch.table.table import Column, Table, round_capacity

# ---------------------------------------------------------------------------
# format constants
# ---------------------------------------------------------------------------

# page types (parquet.thrift PageType)
_DATA_PAGE, _INDEX_PAGE, _DICT_PAGE, _DATA_PAGE_V2 = 0, 1, 2, 3
# encodings (parquet.thrift Encoding)
_PLAIN = 0
_PLAIN_DICTIONARY = 2
_RLE = 3
_BIT_PACKED = 4
_DELTA_BINARY_PACKED = 5
_DELTA_LENGTH_BYTE_ARRAY = 6
_DELTA_BYTE_ARRAY = 7
_RLE_DICTIONARY = 8
_BYTE_STREAM_SPLIT = 9

_DICT_ENCODINGS = (_PLAIN_DICTIONARY, _RLE_DICTIONARY)

# physical type -> itemsize
_PHYS_WIDTH = {"INT32": 4, "INT64": 8, "FLOAT": 4, "DOUBLE": 8}

# the widest index the kernel's 4-byte window extracts; wider indexes
# take the host decode
_MAX_BITWIDTH = CK.HYBRID_MAX_BITWIDTH


class Unsupported(Exception):
    """This chunk/page/file cannot decode on the device: the column takes
    the host pyarrow decode (a whole dataset the route cannot take at
    all takes read_parquet's host route). Never escapes this module."""


# ---------------------------------------------------------------------------
# thrift compact protocol
# ---------------------------------------------------------------------------
# Page headers are tiny (tens of bytes) TCompactProtocol structs; a
# minimal pure-python reader keeps the raw-page path dependency-free.
# The page-header parse keeps only the fields the decoder routes on; the
# footer parse (io/parquet.py) reads whole structs with `_read_struct`.

_CT_STOP = 0
_CT_TRUE, _CT_FALSE = 1, 2
_CT_BYTE, _CT_I16, _CT_I32, _CT_I64 = 3, 4, 5, 6
_CT_DOUBLE, _CT_BINARY, _CT_LIST, _CT_SET, _CT_MAP, _CT_STRUCT = \
    7, 8, 9, 10, 11, 12


def _uvarint(buf: bytes, off: int):
    out = shift = 0
    while True:
        b = buf[off]
        off += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, off
        shift += 7
        if shift > 63:
            raise Unsupported("varint overflow in page header")


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _skip_field(buf: bytes, off: int, ftype: int) -> int:
    if ftype in (_CT_TRUE, _CT_FALSE):
        return off
    if ftype == _CT_BYTE:
        return off + 1
    if ftype in (_CT_I16, _CT_I32, _CT_I64):
        return _uvarint(buf, off)[1]
    if ftype == _CT_DOUBLE:
        return off + 8
    if ftype == _CT_BINARY:
        n, off = _uvarint(buf, off)
        return off + n
    if ftype == _CT_STRUCT:
        return _skip_struct(buf, off)
    if ftype in (_CT_LIST, _CT_SET):
        head = buf[off]
        off += 1
        n = head >> 4
        if n == 15:
            n, off = _uvarint(buf, off)
        et = head & 0x0F
        for _ in range(n):
            off = _skip_field(buf, off, et)
        return off
    if ftype == _CT_MAP:
        n, off = _uvarint(buf, off)
        if n:
            kt, vt = buf[off] >> 4, buf[off] & 0x0F
            off += 1
            for _ in range(n):
                off = _skip_field(buf, off, kt)
                off = _skip_field(buf, off, vt)
        return off
    raise Unsupported(f"thrift compact type {ftype}")


def _field_header(buf: bytes, off: int, fid: int):
    """Read one compact-protocol field header. Returns
    (fid, ftype, off, stop)."""
    head = buf[off]
    off += 1
    if head == _CT_STOP:
        return fid, _CT_STOP, off, True
    delta = head >> 4
    ftype = head & 0x0F
    if delta:
        fid += delta
    else:
        z, off = _uvarint(buf, off)
        fid = _zigzag(z)
    return fid, ftype, off, False


def _skip_struct(buf: bytes, off: int) -> int:
    fid = 0
    while True:
        fid, ftype, off, stop = _field_header(buf, off, fid)
        if stop:
            return off
        off = _skip_field(buf, off, ftype)


def _read_value(buf: bytes, off: int, ftype: int):
    """One compact-protocol value of type `ftype` -> (value, off): ints
    zigzag-decoded, binary as bytes, lists as lists, structs as
    {field id: value} dicts; maps are skipped (None)."""
    if ftype in (_CT_TRUE, _CT_FALSE):
        return ftype == _CT_TRUE, off
    if ftype == _CT_BYTE:
        b = buf[off]
        return (b - 256 if b > 127 else b), off + 1
    if ftype in (_CT_I16, _CT_I32, _CT_I64):
        z, off = _uvarint(buf, off)
        return _zigzag(z), off
    if ftype == _CT_DOUBLE:
        return struct.unpack_from("<d", buf, off)[0], off + 8
    if ftype == _CT_BINARY:
        n, off = _uvarint(buf, off)
        return bytes(buf[off:off + n]), off + n
    if ftype == _CT_STRUCT:
        return _read_struct(buf, off)
    if ftype in (_CT_LIST, _CT_SET):
        head = buf[off]
        off += 1
        n = head >> 4
        if n == 15:
            n, off = _uvarint(buf, off)
        et = head & 0x0F
        out = []
        for _ in range(n):
            if et in (_CT_TRUE, _CT_FALSE):  # one byte per element
                out.append(buf[off] == _CT_TRUE)
                off += 1
            else:
                v, off = _read_value(buf, off, et)
                out.append(v)
        return out, off
    if ftype == _CT_MAP:
        return None, _skip_field(buf, off, ftype)
    raise Unsupported(f"thrift compact type {ftype}")


def _read_struct(buf: bytes, off: int):
    """A whole compact-protocol struct -> ({field id: value}, off)."""
    out = {}
    fid = 0
    while True:
        fid, ftype, off, stop = _field_header(buf, off, fid)
        if stop:
            return out, off
        out[fid], off = _read_value(buf, off, ftype)


@dataclass
class _PageHeader:
    type: int
    uncompressed_size: int
    compressed_size: int
    num_values: int = 0
    encoding: int = _PLAIN
    def_level_encoding: int = _RLE
    # DataPageHeaderV2 extras
    num_nulls: int = -1           # v2 records it; v1 = -1 (unknown)
    def_levels_byte_len: int = 0  # v2: uncompressed levels at page front
    v2_compressed: bool = True
    header_len: int = 0           # bytes consumed by the thrift header


def _parse_sub(buf, off, hdr, *, v2: bool) -> int:
    """DataPageHeader / DataPageHeaderV2 / DictionaryPageHeader."""
    fid = 0
    while True:
        fid, ftype, off, stop = _field_header(buf, off, fid)
        if stop:
            return off
        if ftype in (_CT_I16, _CT_I32, _CT_I64):
            z, off = _uvarint(buf, off)
            val = _zigzag(z)
        elif ftype in (_CT_TRUE, _CT_FALSE):
            val = ftype == _CT_TRUE
        else:
            off = _skip_field(buf, off, ftype)
            continue
        if fid == 1:
            hdr.num_values = val
        elif not v2:
            if fid == 2:
                hdr.encoding = val
            elif fid == 3:
                hdr.def_level_encoding = val
        else:
            if fid == 2:
                hdr.num_nulls = val
            elif fid == 4:
                hdr.encoding = val
            elif fid == 5:
                hdr.def_levels_byte_len = val
            elif fid == 6 and val != 0:
                raise Unsupported("repetition levels in v2 page")
            elif fid == 7:
                hdr.v2_compressed = bool(val)


def _parse_page_header(buf: bytes, off: int) -> _PageHeader:
    start = off
    hdr = _PageHeader(type=-1, uncompressed_size=0, compressed_size=0)
    fid = 0
    while True:
        fid, ftype, off, stop = _field_header(buf, off, fid)
        if stop:
            break
        if ftype in (_CT_I16, _CT_I32, _CT_I64):
            z, off = _uvarint(buf, off)
            val = _zigzag(z)
            if fid == 1:
                hdr.type = val
            elif fid == 2:
                hdr.uncompressed_size = val
            elif fid == 3:
                hdr.compressed_size = val
        elif ftype == _CT_STRUCT and fid in (5, 7):
            off = _parse_sub(buf, off, hdr, v2=False)
        elif ftype == _CT_STRUCT and fid == 8:
            hdr.v2_compressed = True
            off = _parse_sub(buf, off, hdr, v2=True)
        elif ftype in (_CT_TRUE, _CT_FALSE):
            pass
        else:
            off = _skip_field(buf, off, ftype)
    if hdr.type < 0 or hdr.compressed_size < 0:
        raise Unsupported("malformed page header")
    hdr.header_len = off - start
    return hdr


# ---------------------------------------------------------------------------
# decompression (host, per page, through pyarrow's codecs)
# ---------------------------------------------------------------------------

_codec_cache: dict = {}


def _codec(name: str):
    """pyarrow's codec for a footer compression name; None when the file
    is uncompressed (then nothing imports pyarrow)."""
    name = (name or "UNCOMPRESSED").lower()
    if name == "uncompressed":
        return None
    # parquet "LZ4" is the raw block format in every modern writer;
    # pa.Codec("lz4") is the FRAME codec, so map to lz4_raw
    if name == "lz4":
        name = "lz4_raw"
    c = _codec_cache.get(name)
    if c is None:
        try:
            import pyarrow as pa
        except ImportError as e:
            raise Unsupported(f"codec {name}: pyarrow is not installed") \
                from e
        try:
            c = pa.Codec(name)
        except ValueError as e:  # a codec this pyarrow was built without
            raise Unsupported(f"codec {name}: {e}") from e
        _codec_cache[name] = c
    return c


def _decompress(codec, raw: bytes, out_size: int) -> bytes:
    if codec is None:
        return raw
    try:
        return codec.decompress(raw,
                                decompressed_size=out_size).to_pybytes()
    except (ValueError, OSError) as e:
        # wrong codec flavor (a legacy LZ4 frame) or a malformed page: the
        # column re-reads from the file through pyarrow, where true
        # corruption surfaces
        raise Unsupported(f"decompress: {e}") from e


# ---------------------------------------------------------------------------
# RLE / bit-packed hybrid: host run-header walk -> device run tables
# ---------------------------------------------------------------------------

@dataclass
class _RunTable:
    """Host-parsed hybrid runs. ``starts[i]`` is the output index where
    run i begins; RLE runs carry ``vals[i]``, bit-packed runs carry the
    absolute bit offset ``bits[i]`` of their first value in the page
    (int64, so a page past 256 MiB keeps exact offsets)."""
    starts: np.ndarray   # int32 [n_runs]
    is_rle: np.ndarray   # bool  [n_runs]
    vals: np.ndarray     # int32 [n_runs]
    bits: np.ndarray     # int64 [n_runs]


def _parse_hybrid(buf: bytes, off: int, end: int, bw: int,
                  n: int, exact: bool = True) -> _RunTable:
    """Walk RLE/bit-packed hybrid run headers in buf[off:end] until n
    output values are covered. O(runs), not O(values): the value work
    happens on the device. ``exact=False`` tolerates a stream that ends
    early: dictionary-index and RLE-bool value streams store only the
    NON-NULL entries, so ``n`` (the page's row count) is an upper bound
    there and the stream simply runs out at the stored count."""
    starts: List[int] = []
    is_rle: List[int] = []
    vals: List[int] = []
    bits: List[int] = []
    vbw = (bw + 7) // 8
    count = 0
    while count < n:
        if off >= end:
            if exact:
                raise Unsupported("hybrid run stream truncated")
            break
        header, off = _uvarint(buf, off)
        if header & 1:  # bit-packed: (header >> 1) groups of 8 values
            groups = header >> 1
            if groups <= 0:
                raise Unsupported("empty bit-packed run")
            starts.append(count)
            is_rle.append(False)
            vals.append(0)
            bits.append(off * 8)
            off += groups * bw
            count += groups * 8
        else:  # RLE run: value in ceil(bw/8) LE bytes
            run = header >> 1
            if run <= 0:
                raise Unsupported("empty RLE run")
            v = int.from_bytes(buf[off:off + vbw], "little") if vbw else 0
            off += vbw
            starts.append(count)
            is_rle.append(True)
            vals.append(v)
            bits.append(0)
            count += run
        if off > end:
            raise Unsupported("hybrid run overruns page")
    return _RunTable(np.asarray(starts, np.int32),
                     np.asarray(is_rle, bool),
                     np.asarray(vals, np.int32),
                     np.asarray(bits, np.int64))


def _bucket(n: int, lo: int = 16) -> int:
    """Next power of two >= max(n, lo): the JAX package's page shapes."""
    b = lo
    while b < n:
        b <<= 1
    return b


_EMPTY_RUNS = _RunTable(np.zeros(0, np.int32), np.zeros(0, bool),
                        np.zeros(0, np.int32), np.zeros(0, np.int64))


# ---------------------------------------------------------------------------
# chunk programs: one column chunk's pages as chunk-wide torch operations
# ---------------------------------------------------------------------------

_TORCH_INT = {4: torch.int32, 8: torch.int64}
# physical dtypes a PLAIN page's bytes reinterpret as directly
_PLAIN_VIEW = {"int32": torch.int32, "uint32": torch.uint32,
               "float32": torch.float32, "int64": torch.int64,
               "uint64": torch.uint64, "float64": torch.float64}


def _assemble_plain_body(data: torch.Tensor, val_off: int, itemsize: int,
                         out_dtype: str, n: int) -> torch.Tensor:
    """PLAIN fixed-width: the dense value region's little-endian bytes
    reinterpreted as the physical dtype (narrow logical ints ride in
    INT32 and convert after)."""
    window = data[val_off:val_off + n * itemsize]
    if window.storage_offset() % itemsize:
        window = window.clone()  # a view needs an aligned start
    target = _PLAIN_VIEW.get(out_dtype)
    if target is not None and target.itemsize == itemsize:
        return window.view(target)
    return window.view(_TORCH_INT[itemsize]).to(dt.TORCH_OF[out_dtype])


def _plain_page_values(pg: _Page, data: torch.Tensor, itemsize: int,
                       out_dtype: str, pos: Optional[torch.Tensor]):
    """A PLAIN or PLAIN-boolean page's values at its rows: `data` is the
    page's staged bytes, `pos` each row's dense non-null position in the
    page (None when the page has no definition levels to expand)."""
    if pg.kind == "plain":
        dense = _assemble_plain_body(data, pg.val_off, itemsize, out_dtype,
                                     pg.num_values)
        return dense if pos is None else dense[pos]
    bits_i = pg.val_off * 8 + (torch.arange(pg.num_values,
                                            device=data.device)
                               if pos is None else pos)
    byte0 = (bits_i >> 3).clamp(0, data.shape[0] - 1)
    return ((data[byte0] >> (bits_i & 7).to(torch.uint8)) & 1) > 0


def _scaled(values: torch.Tensor, scale: int, out_t: torch.dtype):
    """Timestamp ticks to ns, then the table dtype."""
    return (values * scale if scale != 1 else values).to(out_t)


@dataclass
class _ChunkStage:
    """Host side of one chunk decode: everything staged for the one copy
    to the device, by slot."""
    stage: _Staging
    row_base: np.ndarray          # int64 [pages + 1]: each page's first row
    rows_slot: int                # row_base on the device
    page_slots: List[int]         # each page's bytes
    dict_slot: Optional[int]      # the padded numeric dictionary
    def_slots: Optional[tuple]    # definition levels: segs + run tables
    val_slots: Optional[tuple]    # dictionary indexes or RLE booleans


def _stage_chunk(rc: _RawColumn, has_defs: bool) -> _ChunkStage:
    """Stage a chunk's dictionary, page bytes and, for each stream kind
    that has hybrid pages, one segment table (cuda_kernels.hybrid_segments)
    over all its pages: every page is a segment of its kind at its first
    row, so a page whose values are not hybrid (PLAIN) is a segment
    without runs."""
    plan = rc.plan
    stage = _Staging()
    dict_slot = None
    if rc.dictionary is not None and not plan.is_string:
        dpad = np.zeros(_bucket(len(rc.dictionary), 16),
                        rc.dictionary.dtype.newbyteorder("="))
        dpad[:len(rc.dictionary)] = rc.dictionary
        dict_slot = stage.add(dpad)
    row_base = np.zeros(len(rc.pages) + 1, np.int64)
    np.cumsum([pg.num_values for pg in rc.pages], out=row_base[1:])
    page_slots, windows = [], []
    for pg in rc.pages:
        need = len(pg.data)
        if pg.kind == "plain":
            need = max(need, pg.val_off
                       + pg.num_values * _PHYS_WIDTH[plan.phys])
        elif pg.kind == "boolplain":
            need = max(need, pg.val_off + (pg.num_values + 7) // 8)
        # 8 zero bytes past the page: a last bit-packed group that runs
        # past the page's data reads zeros, never a neighbour's bytes
        slot = stage.add(np.frombuffer(pg.data, np.uint8), need + 8)
        off, _, nbytes = stage.parts[slot]
        page_slots.append(slot)
        windows.append((off, off + nbytes))

    def segments(widths_and_runs):
        """Stage one segment table over every page, given each page's
        (bit width, run table)."""
        tables = CK.hybrid_segments([
            (pg.num_values, lo, hi, bw, rt.starts, rt.is_rle, rt.vals,
             rt.bits) for pg, (lo, hi), (bw, rt)
            in zip(rc.pages, windows, widths_and_runs)])
        return tuple(stage.add(a) for a in tables)

    def_slots = val_slots = None
    if has_defs:
        def_slots = segments([(1, pg.def_runs) for pg in rc.pages])
    hybrid = [pg.kind in ("dict", "boolrle") and pg.val_runs is not None
              for pg in rc.pages]
    if any(hybrid):
        val_slots = segments([(pg.bit_width, pg.val_runs) if h
                              else (0, _EMPTY_RUNS)
                              for pg, h in zip(rc.pages, hybrid)])
    return _ChunkStage(stage, row_base, stage.add(row_base), page_slots,
                       dict_slot, def_slots, val_slots)


def _run_chunk_program(rc: _RawColumn, cs: _ChunkStage,
                       buf: torch.Tensor, views: list):
    """Decode a staged chunk on the device: one hybrid_expand launch per
    stream kind over all its pages, then chunk-wide validity, dense
    non-null positions, null codes, dictionary gather, scale, dtype and
    null fill; PLAIN pages write their rows in between. `buf` is the
    staged buffer and `views` its typed slots. Returns (values [n] in the
    table dtype, validity [n] or None when no definition levels were
    expanded)."""
    plan = rc.plan
    dev = buf.device
    n = int(cs.row_base[-1])
    out_name = "int32" if plan.is_string else plan.out_dtype
    out_t = dt.TORCH_OF[out_name]
    valid = idx = None
    if cs.def_slots is not None:
        levels = CK.hybrid_expand_segments(
            buf, *(views[s] for s in cs.def_slots), n)
        valid = levels == 1
        # a page's non-null values are packed densely at its first row:
        # row i reads the slot of its page's base plus the non-null rows
        # before it in the page (a chunk-wide cumsum less the non-null
        # rows of the pages before), 0 before the page's first one
        seen = torch.cumsum(valid, 0)
        rows = views[cs.rows_slot]
        before = torch.cat([seen.new_zeros(1), seen])[rows[:-1]]
        page = torch.repeat_interleave(
            torch.arange(len(rc.pages), device=dev), rows.diff(),
            output_size=n)
        idx = rows[:-1][page] + (seen - 1 - before[page]).clamp(min=0)

    def at_rows(dense):
        return dense if idx is None else dense[idx]

    if cs.val_slots is not None:
        codes = at_rows(CK.hybrid_expand_segments(
            buf, *(views[s] for s in cs.val_slots), n))
        if plan.phys == "BOOLEAN":  # RLE booleans
            vals = codes > 0
        else:  # dictionary indexes
            if valid is not None:
                # null rows carry raw code 0 (arrow_bridge's NaN -> 0
                # before the rank remap)
                codes = torch.where(valid, codes, 0)
            if cs.dict_slot is not None:
                dictvals = views[cs.dict_slot]
                vals = dictvals[codes.clamp(0, dictvals.shape[0] - 1)
                                .long()]
            else:
                vals = codes
        vals = _scaled(vals, plan.scale, out_t)
    else:
        vals = torch.empty(n, dtype=out_t, device=dev)
    itemsize = _PHYS_WIDTH.get(plan.phys, 0)
    for p, pg in enumerate(rc.pages):
        if pg.kind not in ("plain", "boolplain"):
            continue
        a, b = int(cs.row_base[p]), int(cs.row_base[p + 1])
        pos = None if idx is None else idx[a:b] - a
        vals[a:b] = _scaled(_plain_page_values(
            pg, views[cs.page_slots[p]], itemsize, out_name, pos),
            plan.scale, out_t)
    if valid is not None:
        # float nulls: NaN carries the null (arrow_bridge's densification)
        fill = float("nan") if out_t.is_floating_point else 0
        vals = torch.where(valid, vals, torch.full((), fill, dtype=out_t,
                                                   device=dev))
    return vals, valid


# ---------------------------------------------------------------------------
# chunk planning (footer -> device route or the host decode)
# ---------------------------------------------------------------------------

@dataclass
class _ColPlan:
    """Per-column decode plan derived from footer metadata alone (no
    data bytes touched yet)."""
    name: str
    leaf: int                 # leaf column index in the parquet schema
    phys: str                 # physical type
    codec_name: str
    max_def: int
    num_values: int
    start: int                # chunk byte range [start, start+size)
    size: int
    null_count: Optional[int]  # from chunk statistics (None = unknown)
    out_dtype: str            # numpy dtype of decoded values
    col_dtype: dt.DType       # logical table dtype
    scale: int = 1            # timestamp -> ns multiplier
    is_string: bool = False


# converted (legacy) integer annotations -> (bit width, signed)
_CONVERTED_INTS = {"INT_8": (8, True), "INT_16": (16, True),
                   "INT_32": (32, True), "INT_64": (64, True),
                   "UINT_8": (8, False), "UINT_16": (16, False),
                   "UINT_32": (32, False), "UINT_64": (64, False)}
_UNIT_SCALE = {"ns": 1, "us": 1000, "ms": 1_000_000}
# arrow duration unit -> ns multiplier (io/parquet.FileMetaData.durations)
_DURATION_SCALE = {"ns": 1, "us": 1000, "ms": 1_000_000, "s": 1_000_000_000}
_CONVERTED_TS = {"TIMESTAMP_MILLIS": "ms", "TIMESTAMP_MICROS": "us"}
_UNANNOTATED = {"INT32": "int32", "INT64": "int64", "FLOAT": "float32",
                "DOUBLE": "float64"}


def _logical_out(cs, phys: str, duration: Optional[str] = None):
    """Map a flat leaf's parquet types to (np dtype name, table DType, ns
    scale, is_string), the column arrow_bridge makes of the arrow type
    pyarrow reads the leaf as; or raise Unsupported. `duration`: the
    unit of an arrow duration the file's ARROW:schema declares the leaf,
    stored as an unannotated INT64."""
    lt = cs.logical_type
    kind = lt.kind if lt is not None else None
    ct = cs.converted_type
    if duration is not None and kind is None and ct is None and \
            phys == "INT64":
        return "int64", dt.TIMEDELTA, _DURATION_SCALE[duration], False
    if kind == "STRING" or (kind is None and ct == "UTF8"):
        if phys != "BYTE_ARRAY":
            raise Unsupported(f"string stored as {phys}")
        return "int32", dt.STRING, 1, True
    if phys == "BYTE_ARRAY":
        raise Unsupported("non-string BYTE_ARRAY")
    if kind == "TIMESTAMP" or (kind is None and ct in _CONVERTED_TS):
        unit = lt.unit if kind == "TIMESTAMP" else _CONVERTED_TS[ct]
        if unit not in _UNIT_SCALE or phys != "INT64":
            raise Unsupported(f"timestamp unit {unit} phys {phys}")
        return "int64", dt.DATETIME, _UNIT_SCALE[unit], False
    if kind == "DATE" or (kind is None and ct == "DATE"):
        if phys != "INT32":
            raise Unsupported(f"date stored as {phys}")
        return "int32", dt.DATE, 1, False
    if kind is None and ct is None and phys == "BOOLEAN":
        return "bool", dt.BOOL, 1, False
    if kind == "INT" or (kind is None and ct in _CONVERTED_INTS):
        width, signed = ((lt.bit_width, lt.signed) if kind == "INT"
                         else _CONVERTED_INTS[ct])
        np_name = f"{'' if signed else 'u'}int{width}"
        if phys not in ("INT32", "INT64"):
            raise Unsupported(f"{np_name} stored as {phys}")
        return np_name, dt.from_numpy(np.dtype(np_name)), 1, False
    if kind is None and ct is None and phys in _UNANNOTATED:
        np_name = _UNANNOTATED[phys]
        return np_name, dt.from_numpy(np.dtype(np_name)), 1, False
    raise Unsupported(f"logical type {kind or ct} on {phys}")


def _plan_chunk(md, rg: int, name: str) -> _ColPlan:
    """Decide whether one column chunk can decode on the device; raises
    Unsupported to route it to the host decode."""
    schema = md.schema
    leaf = None
    for i in range(md.num_columns):
        if schema.column(i).path == name:
            leaf = i
            break
    if leaf is None:
        raise Unsupported(f"no flat leaf for column {name!r} (nested?)")
    cs = schema.column(leaf)
    if cs.max_repetition_level > 0:
        raise Unsupported("repeated (nested) column")
    if cs.max_definition_level > 1:
        raise Unsupported("definition depth > 1 (nested optional)")
    col = md.row_group(rg).column(leaf)
    phys = col.physical_type
    if phys not in ("INT32", "INT64", "FLOAT", "DOUBLE", "BOOLEAN",
                    "BYTE_ARRAY"):
        raise Unsupported(f"physical type {phys}")
    for enc in col.encodings:
        if enc in ("DELTA_BINARY_PACKED", "DELTA_LENGTH_BYTE_ARRAY",
                   "DELTA_BYTE_ARRAY", "BYTE_STREAM_SPLIT"):
            raise Unsupported(f"encoding {enc}")
    out_dtype, col_dtype, scale, is_str = _logical_out(
        cs, phys, md.durations.get(name))
    _codec(col.compression)  # raises Unsupported for unavailable codecs
    dpo = col.dictionary_page_offset
    start = col.data_page_offset
    if dpo is not None and 0 < dpo < start:
        start = dpo
    stats = col.statistics
    null_count = None
    if stats is not None and stats.has_null_count:
        null_count = int(stats.null_count)
    return _ColPlan(name=name, leaf=leaf, phys=phys,
                    codec_name=col.compression,
                    max_def=cs.max_definition_level,
                    num_values=col.num_values, start=start,
                    size=col.total_compressed_size,
                    null_count=null_count, out_dtype=out_dtype,
                    col_dtype=col_dtype, scale=scale, is_string=is_str)


# ---------------------------------------------------------------------------
# raw row groups: bytes + parsed page descriptors
# ---------------------------------------------------------------------------

@dataclass
class _Page:
    kind: str                 # 'plain' | 'dict' | 'boolplain' | 'boolrle'
    num_values: int
    data: bytes               # decompressed page payload
    def_runs: Optional[_RunTable]
    val_runs: Optional[_RunTable]
    val_off: int              # byte offset of dense PLAIN/bool values
    bit_width: int            # dict-index bit width
    has_defs: bool


@dataclass
class _RawColumn:
    plan: _ColPlan
    pages: List[_Page] = field(default_factory=list)
    dictionary: Optional[np.ndarray] = None   # dict-page values (host)


@dataclass
class RawRowGroup:
    """One row group's payload: per-column raw pages for the device route,
    and the columns that take the host decode with the reason each
    does."""
    file: str
    rg: int
    nrows: int
    device_cols: Dict[str, _RawColumn]
    host_cols: Dict[str, str]   # name -> why it takes the host decode
    names: List[str]          # output column order


def _parse_string_dict(buf: bytes, n: int) -> np.ndarray:
    out = []
    off = 0
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", buf, off)
        off += 4
        out.append(buf[off:off + ln].decode("utf-8"))
        off += ln
    return np.asarray(out, dtype=str) if out else np.array([], dtype=str)


def _split_chunk_pages(plan: _ColPlan, raw: bytes) -> _RawColumn:
    """Walk a column chunk's pages: parse headers, decompress payloads,
    pre-parse run tables. Raises Unsupported on any page the device
    route cannot decode (the column then takes the host decode)."""
    codec = _codec(plan.codec_name)
    rc = _RawColumn(plan=plan)
    off = 0
    values_seen = 0
    while values_seen < plan.num_values:
        if off >= len(raw):
            raise Unsupported("chunk ended before all values")
        hdr = _parse_page_header(raw, off)
        off += hdr.header_len
        payload = raw[off:off + hdr.compressed_size]
        if len(payload) != hdr.compressed_size:
            raise Unsupported("page payload truncated")
        off += hdr.compressed_size
        if hdr.type == _DICT_PAGE:
            if rc.dictionary is not None:
                raise Unsupported("multiple dictionary pages")
            data = _decompress(codec, payload, hdr.uncompressed_size)
            if plan.is_string:
                rc.dictionary = _parse_string_dict(data, hdr.num_values)
            else:
                if plan.phys not in _PHYS_WIDTH:
                    raise Unsupported(f"dict of {plan.phys}")
                rc.dictionary = np.frombuffer(
                    data, dtype=_phys_np(plan.phys),
                    count=hdr.num_values)
            continue
        if hdr.type == _INDEX_PAGE:
            continue
        if hdr.type not in (_DATA_PAGE, _DATA_PAGE_V2):
            raise Unsupported(f"page type {hdr.type}")
        v2 = hdr.type == _DATA_PAGE_V2
        if v2:
            lvl_len = hdr.def_levels_byte_len
            levels = payload[:lvl_len]
            body = payload[lvl_len:]
            if hdr.v2_compressed:
                body = _decompress(codec, body,
                                   hdr.uncompressed_size - lvl_len)
            data = levels + body
            lvl_off, lvl_end = 0, lvl_len
            val_off = lvl_len
        else:
            data = _decompress(codec, payload, hdr.uncompressed_size)
            if plan.max_def > 0:
                if hdr.def_level_encoding != _RLE:
                    raise Unsupported("non-RLE definition levels")
                (lvl_len,) = struct.unpack_from("<I", data, 0)
                lvl_off, lvl_end = 4, 4 + lvl_len
                val_off = 4 + lvl_len
            else:
                lvl_off = lvl_end = val_off = 0
        def_runs = None
        if plan.max_def > 0:
            def_runs = _parse_hybrid(data, lvl_off, lvl_end, 1,
                                     hdr.num_values)
        page = _make_page(plan, hdr, data, val_off, def_runs)
        rc.pages.append(page)
        values_seen += hdr.num_values
    if values_seen != plan.num_values:
        raise Unsupported("page value counts disagree with footer")
    return rc


def _phys_np(phys: str) -> str:
    return {"INT32": "<i4", "INT64": "<i8", "FLOAT": "<f4",
            "DOUBLE": "<f8"}[phys]


def _make_page(plan: _ColPlan, hdr: _PageHeader, data: bytes,
               val_off: int, def_runs: Optional[_RunTable]) -> _Page:
    enc = hdr.encoding
    nn = hdr.num_values
    if enc in _DICT_ENCODINGS:
        bw = data[val_off] if val_off < len(data) else 0
        if bw > _MAX_BITWIDTH:
            raise Unsupported(f"dict index bit width {bw}")
        # n is an upper bound: with nulls the index stream stores only
        # the non-null entries (exact=False lets it run out early)
        val_runs = _parse_hybrid(data, val_off + 1, len(data), bw, nn,
                                 exact=False) \
            if nn else _RunTable(*(np.zeros(0, t) for t in
                                   (np.int32, bool, np.int32, np.int64)))
        return _Page("dict", nn, data, def_runs, val_runs, 0, bw,
                     plan.max_def > 0)
    if enc == _PLAIN:
        if plan.phys == "BOOLEAN":
            return _Page("boolplain", nn, data, def_runs, None, val_off,
                         1, plan.max_def > 0)
        if plan.is_string or plan.phys not in _PHYS_WIDTH:
            raise Unsupported("PLAIN variable-width values")
        return _Page("plain", nn, data, def_runs, None, val_off, 0,
                     plan.max_def > 0)
    if enc == _RLE and plan.phys == "BOOLEAN":
        (ln,) = struct.unpack_from("<I", data, val_off)
        val_runs = _parse_hybrid(data, val_off + 4, val_off + 4 + ln, 1,
                                 nn, exact=False) if nn else None
        return _Page("boolrle", nn, data, def_runs, val_runs, 0, 1,
                     plan.max_def > 0)
    raise Unsupported(f"data page encoding {enc}")


# ---------------------------------------------------------------------------
# fetch: raw ranges in, page descriptors out
# ---------------------------------------------------------------------------

def fetch_row_group(f: str, md, rg: int,
                    columns: Optional[Sequence[str]]) -> RawRowGroup:
    """One row group as raw pages: device-decodable columns carry
    decompressed page payloads + run tables; the rest are named in
    `host_cols` with the reason, for decode_row_group's host decode."""
    from bodo_tpu_torch.io.parquet import _raw_range

    g = md.row_group(rg)
    names = list(columns) if columns else list(md.schema.names)
    bundle = RawRowGroup(file=f, rg=rg, nrows=g.num_rows,
                         device_cols={}, host_cols={}, names=names)
    for name in names:
        try:
            plan = _plan_chunk(md, rg, name)
            raw = _raw_range(f, plan.start, plan.size)
            rc = _split_chunk_pages(plan, raw)
            if plan.is_string and rc.dictionary is None and \
                    plan.num_values > 0:
                raise Unsupported("string chunk without dictionary page")
            bundle.device_cols[name] = rc
        except Unsupported as e:
            bundle.host_cols[name] = str(e)
    return bundle


# ---------------------------------------------------------------------------
# decode: row groups -> device Tables
# ---------------------------------------------------------------------------

# route counts since the last reset_decode_counts(): columns decoded on
# the device and on the host (per row group on the device route, per
# table on read_parquet's host route), and device pages by kind
decode_counts: Dict[str, int] = {
    "device_decode_cols": 0, "host_decode_cols": 0,
    "device_decode_pages": 0, "pages_plain": 0, "pages_dict": 0,
    "pages_boolplain": 0, "pages_boolrle": 0,
}


def reset_decode_counts() -> None:
    for k in decode_counts:
        decode_counts[k] = 0


class _Staging:
    """Host arrays packed at 8-byte-aligned offsets into one buffer that
    moves to the device in one copy; each comes back as a typed view."""

    def __init__(self):
        self.parts = []   # (offset, array, reserved bytes)
        self.size = 0

    def add(self, a: np.ndarray, reserve: int = 0) -> int:
        """Stage `a`, zero-padded to `reserve` bytes; returns its slot."""
        a = np.ascontiguousarray(a)
        nbytes = max(a.nbytes, reserve)
        self.parts.append((self.size, a, nbytes))
        self.size += -(-nbytes // 8) * 8
        return len(self.parts) - 1

    def to(self, dev):
        """(the staged buffer on `dev`, a typed view of each array)"""
        buf = np.zeros(max(self.size, 8), np.uint8)
        for off, a, _ in self.parts:
            buf[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        d = torch.from_numpy(buf).to(dev)
        return d, [d[off:off + nbytes] if a.dtype == np.uint8 else
                   d[off:off + a.nbytes].view(
                       dt.TORCH_OF[a.dtype.name]).view(a.shape)
                   for off, a, nbytes in self.parts]


def _decode_column(rc: _RawColumn, cap: int, dev) -> Column:
    """Decode one column chunk on the device and assemble the padded
    column: one copy to the device, one chunk program."""
    plan = rc.plan
    # stats prove zero nulls -> every def level is 1, so the level
    # expansion and the dense-position cumsum are identities: decode as
    # if the chunk had no def levels (the same stats trust drops the
    # validity mask below)
    has_defs = plan.max_def > 0 and plan.null_count != 0
    out_t = dt.TORCH_OF["int32" if plan.is_string else plan.out_dtype]
    data = torch.zeros(cap, dtype=out_t, device=dev)
    valid_out = None
    if rc.pages:
        cs = _stage_chunk(rc, has_defs)
        buf, views = cs.stage.to(dev)
        vals, valid = _run_chunk_program(rc, cs, buf, views)
        n = min(vals.shape[0], cap)
        data[:n] = vals[:n]
        # mask presence must match arrow_bridge: floats never carry one
        # (NaN is the null), others only when the chunk actually has nulls
        if valid is not None and not out_t.is_floating_point and (
                (plan.null_count is not None and plan.null_count > 0)
                or bool((~valid).any())):
            valid_out = torch.zeros(cap, dtype=torch.bool, device=dev)
            valid_out[:n] = valid[:n]
        for pg in rc.pages:
            decode_counts[f"pages_{pg.kind}"] += 1
    dictionary = None
    if plan.is_string:
        raw_dict = rc.dictionary if rc.dictionary is not None \
            else np.array([], dtype=str)
        order = np.argsort(raw_dict, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        dictionary = raw_dict[order] if len(raw_dict) else raw_dict
        if len(raw_dict):
            # rank remap applies to live rows only; the pad region stays
            # raw zero, matching arrow_bridge's _pad(np.zeros)
            lut = torch.from_numpy(rank.astype(np.int32)).to(dev)
            remapped = CK.dict_gather(
                data.clamp(0, len(raw_dict) - 1).contiguous(), lut)
            live = torch.arange(cap, device=dev) < plan.num_values
            data = torch.where(live, remapped, 0)
    return Column(data, valid_out, plan.col_dtype, dictionary)


def decode_row_group(bundle: RawRowGroup, dev) -> Table:
    """Decode one row group into a REP Table on `dev`: the device route
    for planned columns, `arrow_bridge` over pyarrow for the columns that
    take the host decode (same capacity, so the merged table is
    indistinguishable from a host read)."""
    cap = round_capacity(bundle.nrows)
    cols: Dict[str, Optional[Column]] = {}
    for name in bundle.names:
        rc = bundle.device_cols.get(name)
        cols[name] = None if rc is None else _decode_column(rc, cap, dev)
        if rc is not None:
            decode_counts["device_decode_pages"] += len(rc.pages)
    if bundle.host_cols:
        from bodo_tpu_torch.io.arrow_bridge import _arrow_column
        at = _read_host_columns(bundle)
        for n in bundle.host_cols:
            cols[n] = _arrow_column(at.column(n), cap, dev)
    decode_counts["device_decode_cols"] += len(bundle.device_cols)
    decode_counts["host_decode_cols"] += len(bundle.host_cols)
    return Table(cols, bundle.nrows)


def _read_host_columns(bundle: RawRowGroup):
    """The row group's host-decode columns through pyarrow; without
    pyarrow, an error naming each column and why it needs the host."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        why = "; ".join(f"{n!r}: {r}" for n, r in bundle.host_cols.items())
        raise RuntimeError(
            f"{bundle.file} row group {bundle.rg}: columns that the device "
            f"decode does not cover need pyarrow, which is not installed "
            f"({why})") from e
    pf = pq.ParquetFile(bundle.file)
    return pf.read_row_group(bundle.rg, columns=list(bundle.host_cols))


# ---------------------------------------------------------------------------
# REP-table concat with dictionary unification
# ---------------------------------------------------------------------------

def concat_tables_rep(tables: List[Table]) -> Table:
    """Concatenate per-row-group REP tables on the device, unioning string
    dictionaries (host LUT, device gather)."""
    if len(tables) == 1:
        return tables[0]
    n_total = sum(t.nrows for t in tables)
    cap = round_capacity(n_total)
    dev = tables[0].device
    cols: Dict[str, Column] = {}
    for name in tables[0].columns:
        parts = [t.columns[name] for t in tables]
        dtype = parts[0].dtype
        if any(p.dtype is not dtype for p in parts):
            raise Unsupported(f"dtype drift across row groups: {name}")
        union = None
        if dtype is dt.STRING:
            dicts = [p.dictionary if p.dictionary is not None
                     else np.array([], str) for p in parts]
            union = dicts[0]
            for d in dicts[1:]:
                if d is not union and (len(union) != len(d)
                                       or not np.array_equal(union, d)):
                    union = np.union1d(union, d)
        datas, valids = [], []
        any_valid = any(p.valid is not None for p in parts)
        for t, p in zip(tables, parts):
            d = p.data[:t.nrows]
            if union is not None and p.dictionary is not None and \
                    union is not p.dictionary and len(p.dictionary):
                lut = torch.from_numpy(np.searchsorted(
                    union, p.dictionary).astype(np.int64)).to(dev)
                d = lut[d.clamp(0, len(p.dictionary) - 1).long()].to(
                    d.dtype)
            datas.append(d)
            if any_valid:
                valids.append(p.valid[:t.nrows] if p.valid is not None
                              else torch.ones(t.nrows, dtype=torch.bool,
                                              device=dev))
        data = torch.zeros(cap, dtype=datas[0].dtype, device=dev)
        data[:n_total] = torch.cat(datas)
        valid = None
        if any_valid:
            valid = torch.zeros(cap, dtype=torch.bool, device=dev)
            valid[:n_total] = torch.cat(valids)
            if dtype is dt.STRING and union is not None and len(union):
                # arrow's convention: null slots carry the code of the
                # column's FIRST non-null value (encounter-order
                # dictionary[0]); per-chunk decode filled rank(chunk's
                # own first value) instead, which only matches for the
                # first row group. Recover the global fill from the
                # first live row.
                null_code = data[torch.argmax(valid.to(torch.uint8))]
                live = torch.arange(cap, device=dev) < n_total
                data = torch.where(valid | ~live, data, null_code)
        cols[name] = Column(data, valid, dtype, union)
    return Table(cols, n_total)


# ---------------------------------------------------------------------------
# read-path entry points
# ---------------------------------------------------------------------------

def worth_device_decode(units) -> bool:
    """Size gate for the device route: the estimated decoded bytes
    (footer row-group totals) must reach config.device_decode_min_bytes.
    Small reads stay on the host, where dispatch costs dominate."""
    min_b = int(config.device_decode_min_bytes)
    if min_b <= 0:
        return True
    est = 0
    for _f, md, rg in units:
        est += md.row_group(rg).total_byte_size
        if est >= min_b:
            return True
    return False


def read_units_table(units, columns, dev) -> Optional[Table]:
    """Device route of io/parquet.read_parquet over (file, footer, row
    group) units, fetched and decoded one after another. Returns None
    when the read is below the size gate or the dataset cannot take the
    route at all (then the caller reads it on the host); decode errors
    propagate."""
    if not worth_device_decode(units):
        return None
    try:
        tables = [decode_row_group(fetch_row_group(f, md, rg, columns), dev)
                  for f, md, rg in units]
        return concat_tables_rep(tables)
    except Unsupported:
        return None
