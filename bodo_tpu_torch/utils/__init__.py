"""Utilities of the port (counterpart of bodo_tpu/utils): logging."""
