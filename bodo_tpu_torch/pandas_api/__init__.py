"""Dataframe surface of the port (counterpart of bodo_tpu/pandas_api):
the lazy BodoDataFrame that BodoSQLContext.sql returns."""

from bodo_tpu_torch.pandas_api.frame import BodoDataFrame

__all__ = ["BodoDataFrame"]
