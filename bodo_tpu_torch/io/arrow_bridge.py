"""Arrow -> device-table conversion.

Counterpart of the read side of bodo_tpu/io/arrow_bridge.py: host Arrow
columns become padded device tensors + validity masks; strings are
dictionary-encoded with a sorted dictionary (device code order == string
order). Nested Arrow types belong to a later slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bodo_tpu_torch.config import resolve_device
from bodo_tpu_torch.table import dtypes as dt
from bodo_tpu_torch.table.table import Column, Table, round_capacity


def _pad(arr: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros((cap,) + arr.shape[1:], dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def _column(vals: np.ndarray, valid_np, cap: int, dtype, dev,
            dictionary=None) -> Column:
    valid = None
    if valid_np is not None:
        valid = torch.from_numpy(_pad(valid_np, cap)).to(dev)
    return Column(torch.from_numpy(_pad(vals, cap)).to(dev), valid, dtype,
                  dictionary)


def _arrow_column(arr, cap: int, dev) -> Column:
    import pyarrow as pa
    import pyarrow.compute as pc

    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    typ = arr.type
    valid_np = ~np.asarray(arr.is_null()) if arr.null_count else None

    if pa.types.is_dictionary(typ) or pa.types.is_string(typ) or \
            pa.types.is_large_string(typ):
        if not pa.types.is_dictionary(typ):
            arr = pc.dictionary_encode(arr)
        dictionary = np.asarray(arr.dictionary.to_pylist(), dtype=str) \
            if len(arr.dictionary) else np.array([], dtype=str)
        codes = arr.indices.to_numpy(zero_copy_only=False)
        if codes.dtype.kind == "f":
            codes = np.where(np.isnan(codes), 0, codes)
        codes = codes.astype(np.int32)
        # sort the dictionary so code order == lexicographic order
        order = np.argsort(dictionary, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        if len(dictionary):
            codes = rank[np.clip(codes, 0, len(dictionary) - 1)]
        return _column(codes.astype(np.int32), valid_np, cap, dt.STRING,
                       dev, dictionary[order])
    if pa.types.is_timestamp(typ):
        a64 = arr.cast(pa.timestamp("ns")).to_numpy(zero_copy_only=False)
        nat = np.isnat(a64)
        ticks = a64.view(np.int64).copy()
        if nat.any():
            ticks[nat] = 0
            valid_np = ~nat if valid_np is None else (valid_np & ~nat)
        return _column(ticks, valid_np, cap, dt.DATETIME, dev)
    if pa.types.is_date(typ):
        days = arr.cast(pa.int32()).to_numpy(zero_copy_only=False)
        return _column(np.nan_to_num(days).astype(np.int32), valid_np, cap,
                       dt.DATE, dev)
    if pa.types.is_decimal(typ):
        if typ.precision > 18:
            raise NotImplementedError(
                f"decimal precision {typ.precision} > 18 does not fit a "
                f"scaled int64")
        # for precision <= 18 the low 64 bits of the little-endian int128
        # are the two's-complement scaled value
        raw = np.frombuffer(arr.buffers()[1], dtype=np.int64)
        vals = np.ascontiguousarray(
            raw.reshape(-1, 2)[arr.offset:arr.offset + len(arr), 0])
        if valid_np is not None:
            vals = np.where(valid_np, vals, 0)
        return _column(vals, valid_np, cap,
                       dt.decimal(typ.scale, precision=typ.precision), dev)
    if pa.types.is_boolean(typ):
        vals = arr.to_numpy(zero_copy_only=False)
        if vals.dtype == object:
            vals = np.array([bool(x) if x is not None else False
                             for x in vals])
        return _column(vals.astype(bool), valid_np, cap, dt.BOOL, dev)
    if pa.types.is_nested(typ):
        raise NotImplementedError(f"nested Arrow type {typ} is not ported "
                                  f"yet")
    # numeric
    vals = arr.to_numpy(zero_copy_only=False)
    if valid_np is not None and vals.dtype.kind == "f" and \
            not pa.types.is_floating(typ):
        vals = np.nan_to_num(vals)  # ints with nulls densified to float
    np_dtype = np.dtype(typ.to_pandas_dtype())
    dtype = dt.from_numpy(np_dtype)
    if dtype.kind == "f":
        valid_np = None  # NaN carries the null
    return _column(vals.astype(np_dtype), valid_np, cap, dtype, dev)


def arrow_to_table(at, device=None) -> Table:
    dev = resolve_device(device)
    n = at.num_rows
    cap = round_capacity(n)
    cols: Dict[str, Column] = {name: _arrow_column(at.column(name), cap, dev)
                               for name in at.column_names}
    return Table(cols, n)
