"""Columnar tables on torch tensors (counterpart of bodo_tpu/table)."""

from bodo_tpu_torch.table.table import (ONED, REP, Column, Table,
                                        from_reference_arrays,
                                        round_capacity)

__all__ = ["ONED", "REP", "Column", "Table", "from_reference_arrays",
           "round_capacity"]
