"""Row sharding over a mesh of shards (counterpart of bodo_tpu/parallel)."""
