"""Device-resident columnar tables on torch tensors.

Counterpart of bodo_tpu/table/table.py: each column is a fixed-capacity
padded tensor plus an optional validity mask; the number of real rows is
tracked on the host (`nrows`). A table is replicated ("REP", one copy)
or row-sharded ("1D") over the S shards of a mesh (parallel/mesh.py):
then a column holds S blocks of `shard_capacity` rows, shard i owning
the first counts[i] rows of block i, the JAX package's global layout.
Strings are dictionary-encoded: the sorted dictionary lives on
the host, int32 codes on the device. Capacities follow the JAX package's
`round_capacity` rule so both packages see the same shapes.

pandas is imported only by the functions that convert to and from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bodo_tpu_torch.config import resolve_device
from bodo_tpu_torch.table import dtypes as dt
from bodo_tpu_torch.table.dtypes import DType

REP = "REP"   # replicated: one logical copy
ONED = "1D"   # row-sharded over the mesh's shards

# the JAX package's default capacity rounding (its config.capacity_round)
CAPACITY_ROUND = 128


def round_capacity(n: int) -> int:
    """Round a row count up to a padded capacity."""
    r = CAPACITY_ROUND
    return max(r, ((n + r - 1) // r) * r)


@dataclass
class Column:
    """One column: device data + optional validity + host dictionary."""
    data: torch.Tensor                   # [capacity] physical values/codes
    valid: Optional[torch.Tensor]        # [capacity] bool, None = no nulls
    dtype: DType
    dictionary: Optional[np.ndarray] = None  # sorted unique strings (host)
    # host-known (lo, hi[, tight]) bound on the PHYSICAL values (parquet
    # footer stats, static DtField ranges); row-preserving ops keep it
    vrange: Optional[tuple] = None

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    # ---- construction ----------------------------------------------------
    @staticmethod
    def from_numpy(arr: np.ndarray, capacity: Optional[int] = None,
                   valid: Optional[np.ndarray] = None,
                   device=None) -> "Column":
        dev = resolve_device(device)
        n = len(arr)
        cap = capacity if capacity is not None else round_capacity(n)
        if arr.dtype == object and _looks_decimal(arr):
            return _decimal_column(arr, cap, valid, dev)
        dtype = dt.from_numpy(arr.dtype)
        dictionary = None
        if dtype is dt.STRING and arr.dtype.kind in ("U", "S") and \
                valid is None:
            # fixed-width numpy strings hold no nulls
            dictionary, codes = np.unique(arr.astype(str),
                                          return_inverse=True)
            phys = codes.astype(np.int32)
        elif dtype is dt.STRING:
            vals = np.asarray(arr, dtype=object)
            isna = np.array([v is None or (isinstance(v, float) and np.isnan(v))
                             for v in vals], dtype=bool)
            if valid is not None:
                isna |= ~np.asarray(valid, dtype=bool)
            fill = vals[~isna]
            safe = np.where(isna, fill[0] if len(fill) else "", vals)
            dictionary, codes = np.unique(safe.astype(str), return_inverse=True)
            phys = codes.astype(np.int32)
            valid = None if not isna.any() else ~isna
        elif dtype is dt.DATETIME or dtype is dt.TIMEDELTA:
            unit = "datetime64[ns]" if dtype is dt.DATETIME else "timedelta64[ns]"
            a = np.asarray(arr).astype(unit)
            nat = np.isnat(a)
            phys = a.view(np.int64).copy()
            if nat.any():
                phys[nat] = 0
                valid = (~nat) if valid is None else (np.asarray(valid) & ~nat)
        else:
            # NaN stays NaN in float data (pandas float semantics); no mask
            phys = np.asarray(arr, dtype=dtype.numpy)
        padded = np.zeros((cap,), dtype=dtype.numpy)
        padded[:n] = phys
        vcol = None
        if valid is not None:
            v = np.zeros(cap, dtype=bool)
            v[:n] = np.asarray(valid, dtype=bool)
            vcol = torch.from_numpy(v).to(dev)
        return Column(torch.from_numpy(padded).to(dev), vcol, dtype,
                      dictionary)

    # ---- materialization -------------------------------------------------
    def to_numpy(self, nrows: int):
        """Decode the first `nrows` real rows to a host numpy/object array
        (pandas extension arrays for nullable ints and bools)."""
        data = self.data[:nrows].cpu().numpy()
        valid = (self.valid[:nrows].cpu().numpy()
                 if self.valid is not None else None)
        if self.dtype is dt.STRING:
            if self.dictionary is None or len(self.dictionary) == 0:
                return np.full(len(data), None, dtype=object)
            codes = np.clip(data, 0, len(self.dictionary) - 1)
            if len(data) >= len(self.dictionary):
                # at least as many rows as strings: make one str object
                # a distinct value and gather those, not one a row
                out = self.dictionary.astype(object)[codes]
            else:
                out = self.dictionary[codes].astype(object)
            if valid is not None:
                out[~valid] = None
            return out
        if self.dtype is dt.DATETIME:
            out = data.view("datetime64[ns]").copy()
            if valid is not None:
                out[~valid] = np.datetime64("NaT")
            return out
        if self.dtype is dt.TIMEDELTA:
            out = data.view("timedelta64[ns]").copy()
            if valid is not None:
                out[~valid] = np.timedelta64("NaT")
            return out
        if self.dtype is dt.DATE:
            # days since epoch -> datetime.date objects, None for nulls
            out = data.astype("datetime64[D]").astype(object)
            if valid is not None:
                out[~valid] = None
            return out
        if dt.is_decimal(self.dtype):
            import decimal as pydec
            q = pydec.Decimal(1).scaleb(-self.dtype.scale)
            out = np.array([pydec.Decimal(int(v)).scaleb(-self.dtype.scale)
                            .quantize(q) for v in data], dtype=object)
            if valid is not None:
                out[~valid] = None
            return out
        if valid is not None and self.dtype.kind in ("i", "u", "b"):
            return _masked_to_pandas(data, valid, self.dtype)
        if valid is not None and self.dtype.kind == "f":
            out = data.copy()
            out[~valid] = np.nan
            return out
        return data


def _dec_isna(v) -> bool:
    import decimal as pydec
    if v is None or (type(v).__name__ == "NAType"):
        return True
    if isinstance(v, float) and np.isnan(v):
        return True
    return isinstance(v, pydec.Decimal) and not v.is_finite()


def _looks_decimal(arr: np.ndarray) -> bool:
    import decimal as pydec
    for v in arr:
        if _dec_isna(v):
            continue
        return isinstance(v, pydec.Decimal)
    return False


def _decimal_column(arr: np.ndarray, cap: int, valid, dev) -> Column:
    """Object array of decimal.Decimal -> scaled int64 column; the scale is
    the largest fractional-digit count across the values."""
    import decimal as pydec
    isna = np.array([_dec_isna(v) for v in arr], dtype=bool)
    if valid is not None:
        isna |= ~np.asarray(valid, dtype=bool)
    scale = 0
    for v, na in zip(arr, isna):
        if not na:
            scale = max(scale, -int(v.as_tuple().exponent))
    phys = np.zeros(cap, dtype=np.int64)
    mul = pydec.Decimal(10) ** scale
    for i, (v, na) in enumerate(zip(arr, isna)):
        if not na:
            phys[i] = int(v * mul)
    vcol = None
    if isna.any():
        vm = np.zeros(cap, dtype=bool)
        vm[:len(arr)] = ~isna
        vcol = torch.from_numpy(vm).to(dev)
    return Column(torch.from_numpy(phys).to(dev), vcol, dt.decimal(scale))


def _masked_to_pandas(data, valid, dtype: DType):
    import pandas as pd
    mask = ~np.asarray(valid, dtype=bool)
    if dtype.kind == "b":
        return pd.arrays.BooleanArray(
            np.where(valid, data, False).astype(bool), mask)
    vals = np.where(valid, data, dtype.numpy.type(0)).astype(dtype.numpy)
    return pd.arrays.IntegerArray(vals, mask)


@dataclass
class Table:
    """Host-level handle to device-resident columns."""
    columns: Dict[str, Column]
    nrows: int
    distribution: str = REP
    counts: Optional[np.ndarray] = None  # per-shard real rows when 1D

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    @property
    def capacity(self) -> int:
        if not self.columns:
            return 0
        return next(iter(self.columns.values())).capacity

    @property
    def num_shards(self) -> int:
        return 1 if self.counts is None else len(self.counts)

    @property
    def shard_capacity(self) -> int:
        return self.capacity // self.num_shards

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).data.device

    def column(self, name: str) -> Column:
        return self.columns[name]

    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self.columns[n] for n in names}, self.nrows,
                     self.distribution, self.counts)

    def with_columns(self, columns: Dict[str, Column]) -> "Table":
        return Table(dict(columns), self.nrows, self.distribution,
                     self.counts)

    def arrays(self, names: Sequence[str]):
        """(data, valid) pairs of the named columns, in order."""
        return tuple((self.columns[n].data, self.columns[n].valid)
                     for n in names)

    def with_arrays(self, tree, nrows: Optional[int] = None,
                    counts: Optional[np.ndarray] = None) -> "Table":
        """Rebuild from {name: (data, valid)}, keeping each column's dtype
        and dictionary (value bounds are dropped, as in the JAX package).
        Per-shard `counts` make the result 1D."""
        cols = {}
        for name, (data, valid) in tree.items():
            src = self.columns[name]
            cols[name] = Column(data, valid, src.dtype, src.dictionary)
        if counts is None:
            return Table(cols, self.nrows if nrows is None else nrows,
                         self.distribution, self.counts)
        return Table(cols, self.nrows if nrows is None else nrows, ONED,
                     np.asarray(counts, dtype=np.int64))

    # ---- distribution ----------------------------------------------------
    def shard(self, mesh=None) -> "Table":
        """REP -> 1D: scatter rows over the shards of `mesh` (the active
        one by default; the default mesh is on CUDA, so without CUDA this
        raises unless a mesh on another device is given or active).

        Shard i owns global rows [i*per, i*per + counts[i]): the packed
        per-shard layout is the source layout, padded on the device to
        S * per rows with the tail past `nrows` zeroed."""
        if self.distribution == ONED:
            return self
        from bodo_tpu_torch.parallel import mesh as mesh_mod
        m = mesh or mesh_mod.get_mesh()
        if self.columns and self.device != m.device:
            raise ValueError(f"table on {self.device} cannot be sharded "
                             f"over a mesh on {m.device}")
        s = m.n_shards
        per = round_capacity(-(-max(self.nrows, 1) // s))
        counts = np.array(
            [max(0, min(per, self.nrows - i * per)) for i in range(s)],
            dtype=np.int64)
        target = s * per
        nrows = self.nrows

        def scatter(arr):
            if arr.shape[0] < target:
                d = torch.cat([arr, arr.new_zeros(target - arr.shape[0])])
            else:
                d = arr[:target].clone()
            d[nrows:] = 0  # the tail past the real rows
            return d

        cols = {name: Column(scatter(c.data),
                             None if c.valid is None else scatter(c.valid),
                             c.dtype, c.dictionary, c.vrange)
                for name, c in self.columns.items()}
        return Table(cols, self.nrows, ONED, counts)

    def gather(self) -> "Table":
        """1D -> REP: the shards' real rows in shard order, repacked at
        the front of a capacity of round_capacity(nrows)."""
        if self.distribution == REP:
            return self
        per = self.shard_capacity
        cap = round_capacity(max(self.nrows, 1))
        dev = self.device if self.columns else None
        idx = torch.cat([torch.arange(i * per, i * per + int(c), device=dev)
                         for i, c in enumerate(self.counts)]
                        + [torch.zeros(0, dtype=torch.int64, device=dev)])

        def pack(arr):
            out = arr.new_zeros(cap)
            out[:self.nrows] = arr[idx]
            return out

        cols = {name: Column(pack(c.data),
                             None if c.valid is None else pack(c.valid),
                             c.dtype, c.dictionary, c.vrange)
                for name, c in self.columns.items()}
        return Table(cols, self.nrows, REP, None)

    def counts_device(self) -> torch.Tensor:
        """Per-shard row counts as an int64 tensor [S] on the table's
        device ([nrows] for a replicated table)."""
        counts = (np.array([self.nrows], dtype=np.int64)
                  if self.counts is None else self.counts)
        return torch.from_numpy(np.asarray(counts, dtype=np.int64)).to(
            self.device)

    # ---- conversion ------------------------------------------------------
    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray], device=None) -> "Table":
        """Table from host arrays of equal length (one per column; None in
        an object array is a null)."""
        dev = resolve_device(device)
        n = len(next(iter(arrays.values()))) if arrays else 0
        cap = round_capacity(n)
        cols = {str(name): Column.from_numpy(np.asarray(a), capacity=cap,
                                             device=dev)
                for name, a in arrays.items()}
        return Table(cols, n)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        t = self.gather() if self.distribution == ONED else self
        return {n: c.to_numpy(t.nrows) for n, c in t.columns.items()}

    @staticmethod
    def from_pandas(df, device=None) -> "Table":
        dev = resolve_device(device)
        n = len(df)
        cap = round_capacity(n)
        cols: Dict[str, Column] = {}
        for name in df.columns:
            s = df[name]
            valid = None
            if s.isna().any():
                valid = (~s.isna()).to_numpy()
            if hasattr(s.dtype, "numpy_dtype"):
                # masked extension dtype (Int64/boolean/...): keep the exact
                # physical dtype instead of densifying to object/float64
                np_dt = s.dtype.numpy_dtype
                arr = s.to_numpy(dtype=np_dt, na_value=np_dt.type(0))
            elif valid is not None and s.dtype.kind not in (
                    "O", "U", "T", "M", "m", "f"):
                arr = s.to_numpy(na_value=0)
            else:
                arr = s.to_numpy()
            cols[str(name)] = Column.from_numpy(arr, capacity=cap,
                                                valid=valid, device=dev)
        return Table(cols, n)

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame(self.to_numpy())

    def __repr__(self) -> str:  # pragma: no cover
        schema = ", ".join(f"{n}:{c.dtype.name}"
                           for n, c in self.columns.items())
        return (f"Table[{self.nrows} rows, cap={self.capacity}, "
                f"{self.distribution}]({schema})")


def from_reference_arrays(columns: Dict[str, tuple], nrows: int,
                          device=None, counts=None) -> Table:
    """Port Table from the JAX package's Column fields exported as numpy:
    `columns` maps name -> (data, valid, dtype name, dictionary, vrange),
    with `data`/`valid` the padded physical arrays (of a 1D table: its
    global arrays, with its per-shard `counts`). The physical layout is
    the same in both packages, so this is a copy onto the device."""
    dev = resolve_device(device)
    cols: Dict[str, Column] = {}
    for name, (data, valid, dtype_name, dictionary, vrange) in \
            columns.items():
        dtype = dt.by_name(dtype_name)
        d = torch.from_numpy(np.array(data, dtype=dtype.numpy)).to(dev)
        v = None
        if valid is not None:
            v = torch.from_numpy(np.array(valid, dtype=bool)).to(dev)
        dic = None if dictionary is None else np.asarray(dictionary)
        cols[name] = Column(d, v, dtype, dic,
                            None if vrange is None else tuple(vrange))
    if counts is None:
        return Table(cols, nrows)
    return Table(cols, nrows, ONED, np.asarray(counts, dtype=np.int64))
