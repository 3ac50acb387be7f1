"""Expression IR of the port (counterpart of bodo_tpu/plan)."""
