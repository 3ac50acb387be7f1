"""Host read paths into device tables (counterpart of bodo_tpu/io).

pyarrow is imported by the readers when they run, never at import."""

from bodo_tpu_torch.io.csv import read_csv
from bodo_tpu_torch.io.parquet import read_parquet

__all__ = ["read_csv", "read_parquet"]
