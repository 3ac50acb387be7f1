"""CSV reader (host parse through pyarrow).

Counterpart of `read_csv` in bodo_tpu/io/csv.py: pyarrow's parser runs
on the host (`parse_dates` columns parse as ns timestamps), columns move
to the device, and integer/timestamp/date columns get exact value bounds
from one host min/max pass.
"""

from __future__ import annotations

from typing import Optional, Sequence

from bodo_tpu_torch.config import resolve_device
from bodo_tpu_torch.io.arrow_bridge import arrow_to_table
from bodo_tpu_torch.io.parquet import _stat_int
from bodo_tpu_torch.table.table import Table


def read_csv(path: str, parse_dates: Optional[Sequence[str]] = None,
             device=None) -> Table:
    """Read a csv file into a Table on `device` (CUDA by default);
    `parse_dates` columns parse as ns timestamps."""
    dev = resolve_device(device)
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.csv as pacsv

    convert = {c: pa.timestamp("ns") for c in parse_dates or ()}
    at = pacsv.read_csv(path, convert_options=pacsv.ConvertOptions(
        column_types=convert))
    t = arrow_to_table(at, device=dev)
    for name, col in t.columns.items():
        if col.dtype.kind not in ("i", "u", "dt", "date"):
            continue
        mm = pc.min_max(at.column(name))
        lo, hi = _stat_int(mm["min"].as_py()), _stat_int(mm["max"].as_py())
        if lo is not None and hi is not None:
            col.vrange = (lo, hi, True)
    return t
