"""Logical dtype system for device-resident columns.

Counterpart of bodo_tpu/table/dtypes.py. Every logical type maps to a
physical numpy/torch dtype:

  - integers/floats/bool map directly,
  - strings are dictionary-encoded: int32 codes on device, the dictionary
    (unique strings, sorted so code order == string order) stays on host,
  - datetime64[ns]/timedelta64[ns] are int64 ticks, dates are int32 days,
  - decimals are scaled int64 (value = physical / 10^scale).

Nullability is carried by a separate validity mask. Nested types (list,
struct, map) belong to a later slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DType:
    name: str          # logical name
    np_dtype: str      # physical device representation
    kind: str          # 'i', 'u', 'f', 'b', 'str', 'dt', 'td', 'date', 'dec'

    @property
    def numpy(self) -> np.dtype:
        return np.dtype(self.np_dtype)

    @property
    def torch(self) -> torch.dtype:
        return TORCH_OF[self.np_dtype]

    def __repr__(self) -> str:  # pragma: no cover
        return f"DType({self.name})"


TORCH_OF = {
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64,
    "float32": torch.float32, "float64": torch.float64, "bool": torch.bool,
}

INT8 = DType("int8", "int8", "i")
INT16 = DType("int16", "int16", "i")
INT32 = DType("int32", "int32", "i")
INT64 = DType("int64", "int64", "i")
UINT8 = DType("uint8", "uint8", "u")
UINT16 = DType("uint16", "uint16", "u")
UINT32 = DType("uint32", "uint32", "u")
UINT64 = DType("uint64", "uint64", "u")
FLOAT32 = DType("float32", "float32", "f")
FLOAT64 = DType("float64", "float64", "f")
BOOL = DType("bool", "bool", "b")
STRING = DType("string", "int32", "str")          # dict codes
DATETIME = DType("datetime64[ns]", "int64", "dt")  # ns ticks
TIMEDELTA = DType("timedelta64[ns]", "int64", "td")
DATE = DType("date", "int32", "date")              # days since epoch

_BY_NAME = {
    t.name: t
    for t in (INT8, INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64,
              FLOAT32, FLOAT64, BOOL, STRING, DATETIME, TIMEDELTA, DATE)
}


@dataclass(frozen=True)
class DecimalDType(DType):
    """Fixed-point decimal as a scaled int64 (value = physical / 10^scale);
    `precision` carries the source schema's decimal128 precision."""
    scale: int = 2
    precision: int = 18


_DECIMALS: dict = {}


def decimal(scale: int, *, precision: int = 18) -> DecimalDType:
    """Interned decimal dtype of the given scale (identity-stable)."""
    t = _DECIMALS.get((scale, precision))
    if t is None:
        name = (f"decimal({scale})" if precision == 18
                else f"decimal({precision},{scale})")
        t = DecimalDType(name, "int64", "dec", scale, precision)
        _DECIMALS[(scale, precision)] = t
        _BY_NAME[t.name] = t
    return t


def is_decimal(t: DType) -> bool:
    return t.kind == "dec"


def by_name(name: str) -> DType:
    """DType from its logical name, decimals included."""
    if name.startswith("decimal(") and name not in _BY_NAME:
        parts = [int(p) for p in name[len("decimal("):-1].split(",")]
        if len(parts) == 1:
            return decimal(parts[0])
        return decimal(parts[1], precision=parts[0])
    return _BY_NAME[name]


def from_numpy(d: np.dtype) -> DType:
    d = np.dtype(d)
    if d.kind == "M":
        return DATETIME
    if d.kind == "m":
        return TIMEDELTA
    if d.kind in ("U", "S", "O", "T"):
        return STRING
    if d.name in _BY_NAME:
        return _BY_NAME[d.name]
    raise TypeError(f"unsupported numpy dtype: {d}")


def is_numeric(t: DType) -> bool:
    return t.kind in ("i", "u", "f", "b")


def common_numeric(a: DType, b: DType) -> DType:
    """Result dtype of arithmetic between two numeric columns."""
    return from_numpy(np.result_type(a.numpy, b.numpy))
