"""Column kernels of the port (counterpart of bodo_tpu/ops)."""
