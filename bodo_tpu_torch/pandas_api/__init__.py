"""The lazy pandas frontend of the port (counterpart of
bodo_tpu/pandas_api, the `bodo.pandas` analogue): every operation builds
a logical plan node; execution starts at a materialization point
(`to_pandas()`, `len()`, a reduction). Unsupported APIs fall back to
pandas with a warning (frame.py, series.py, groupby.py).

Each entry point takes `device=None`, which means CUDA, and raises
without it (config.resolve_device); the plan's sources live on that
device. `read_csv` with `chunksize` or `iterator`, `read_json` and
`read_iceberg` raise NotImplementedError naming the module they need.
pandas is imported inside the functions that need it.
"""

from __future__ import annotations

from bodo_tpu_torch.config import resolve_device
from bodo_tpu_torch.pandas_api.frame import BodoDataFrame, plan_device
from bodo_tpu_torch.pandas_api.series import BodoSeries
from bodo_tpu_torch.plan import logical as L

__all__ = ["BodoDataFrame", "BodoSeries", "read_parquet", "read_csv",
           "read_json", "read_iceberg", "from_pandas", "concat"]


def read_parquet(path, columns=None, device=None) -> BodoDataFrame:
    return BodoDataFrame(L.ReadParquet(path, columns,
                                       device=resolve_device(device)))


def read_csv(path, columns=None, parse_dates=None, chunksize=None,
             iterator=False, device=None):
    """Lazy CSV scan (`parse_dates` columns as datetime64[ns])."""
    if chunksize is not None or iterator:
        raise NotImplementedError(
            "read_csv with chunksize or iterator (io/csv.py "
            "read_csv_chunked) is not ported yet")
    return BodoDataFrame(L.ReadCsv(path, columns, parse_dates,
                                   device=resolve_device(device)))


def read_json(path, columns=None, chunksize=None, device=None):
    raise NotImplementedError("read_json (io/json.py) is not ported yet")


def read_iceberg(table_path, columns=None, snapshot_id=None, device=None):
    raise NotImplementedError(
        "read_iceberg (io/iceberg.py, the snapshot's file list as a "
        "ReadParquet scan) is not ported yet")


def from_pandas(df, device=None) -> BodoDataFrame:
    return BodoDataFrame(L.FromPandas(df, device=resolve_device(device)))


def concat(frames, ignore_index: bool = True,
           device=None) -> BodoDataFrame:
    """Row-wise concat of schema-compatible frames (pd.concat; UNION ALL
    underneath). pandas frames go to the lazy frames' device (`device`
    where none is lazy); lazy frames on two devices raise ValueError."""
    frames = list(frames)
    lazy = [f._plan for f in frames if isinstance(f, BodoDataFrame)]
    dev = plan_device(*lazy) if lazy else resolve_device(device)
    plans = [f._plan if isinstance(f, BodoDataFrame)
             else L.FromPandas(f, device=dev) for f in frames]
    if len(plans) == 1:
        return BodoDataFrame(plans[0])
    return BodoDataFrame(L.Union(plans))
