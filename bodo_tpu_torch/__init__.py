"""bodo_tpu_torch: the PyTorch/CUDA port of the bodo_tpu dataframe engine.

The JAX package `bodo_tpu` is the reference; each module here keeps the
path and names of its counterpart there. Entry points run on CUDA unless
the caller names another device.
"""

from bodo_tpu_torch.config import config, resolve_device, set_config
from bodo_tpu_torch.table import Column, Table, from_reference_arrays

__all__ = ["Column", "Table", "config", "from_reference_arrays",
           "resolve_device", "set_config"]
