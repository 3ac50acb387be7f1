"""Runtime services of the port (counterpart of bodo_tpu/runtime): the
memory governor's device budget (runtime/memory_governor.py)."""
