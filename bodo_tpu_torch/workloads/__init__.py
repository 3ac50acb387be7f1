"""Workloads on the port (counterpart of bodo_tpu/workloads)."""
