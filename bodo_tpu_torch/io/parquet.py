"""Parquet reader (host decode through pyarrow).

Counterpart of the host read path of bodo_tpu/io/parquet.py: row groups
decode on the host, columns move to the device, and integer/timestamp/
date columns get exact value bounds (`Column.vrange`) from the footer's
row-group statistics, which the dense planners read instead of reducing
on the device. Decoding on the device is a later slice.
"""

from __future__ import annotations

import datetime as _dtm
import glob
import os
from typing import Optional

import numpy as np

from bodo_tpu_torch.config import resolve_device
from bodo_tpu_torch.io.arrow_bridge import arrow_to_table
from bodo_tpu_torch.table.table import Table


def _dataset_files(path) -> list:
    """The parquet files of a dataset directory (sorted), or the file."""
    if not os.path.isdir(path):
        return [path]
    files = sorted(glob.glob(os.path.join(path, "**", "*.parquet"),
                             recursive=True))
    if not files:
        raise FileNotFoundError(f"no parquet files under {path}")
    return files


def _stat_int(v) -> Optional[int]:
    """A footer min/max as the column's physical integer, else None."""
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, _dtm.datetime):
        return int(np.datetime64(v, "ns").astype(np.int64))
    if isinstance(v, _dtm.date):  # DATE: days
        return int(np.datetime64(v, "D").astype(np.int64))
    return None


def _attach_footer_ranges(t: Table, metadatas) -> None:
    """Column.vrange from row-group statistics; any row group without
    usable stats clears that column's bound."""
    ranges: dict = {}
    for md in metadatas:
        for rg in range(md.num_row_groups):
            g = md.row_group(rg)
            for ci in range(g.num_columns):
                col = g.column(ci)
                name = col.path_in_schema
                if "." in name or name not in t.columns:
                    continue
                st = col.statistics
                lo = hi = None
                if st is not None and st.has_min_max:
                    lo, hi = _stat_int(st.min), _stat_int(st.max)
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


def read_parquet(path, device=None) -> Table:
    """Read a parquet file or dataset directory into a Table on `device`
    (CUDA by default)."""
    dev = resolve_device(device)
    import pyarrow as pa
    import pyarrow.parquet as pq

    pieces, metadatas = [], []
    for f in _dataset_files(path):
        pf = pq.ParquetFile(f)
        metadatas.append(pf.metadata)
        pieces.append(pf.read())
    at = pa.concat_tables(pieces) if len(pieces) > 1 else pieces[0]
    t = arrow_to_table(at, device=dev)
    _attach_footer_ranges(t, metadatas)
    return t
