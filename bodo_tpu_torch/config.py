"""Configuration of the relational path, and the device every entry point
runs on.

Only the fields the relational path reads (on one device, and on
row-sharded 1D tables), with the JAX package's defaults
(bodo_tpu/config.py), so both packages plan the same routes on the same
data.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch


@dataclass
class Config:
    # Dense (sort-free) groupby when the exact product of key ranges is at
    # most this many slots.
    dense_groupby_max_slots: int = 1 << 22
    # Dense-LUT join when the build side's key-range product is at most
    # this many slots (and its keys are unique).
    dense_join_max_slots: int = 1 << 22
    # Scatter-claim hash groupby / hash join (ops/hashtable.py).
    hash_groupby: bool = True
    hash_join: bool = True
    # Pack small-range multi-key groupby/sort keys into one int64.
    pack_keys: bool = True
    # Skew headroom factor for the all_to_all shuffle bucket capacity.
    shuffle_skew_factor: float = 2.0
    # Broadcast join: a 1D build side of at most this many rows is
    # gathered to every shard instead of hash-shuffled.
    bcast_join_threshold: int = 1 << 20
    # Sources with fewer rows stay replicated; larger ones are sharded.
    shard_min_rows: int = 100_000
    # Memory governor (runtime/memory_governor.py): derive a device
    # budget a shard from the card's free memory, behind the broadcast
    # decisions of the 1D join. Off -> the rows-only rule decides.
    mem_governor: bool = True
    # Fraction of the probed device memory kept as headroom.
    mem_headroom_frac: float = 0.15
    # Largest slice of the derived budget one operator may hold.
    mem_op_fraction: float = 0.5
    # Adaptive query execution (plan/adaptive.py): the broadcast decision
    # and the skew-split detection before a shuffle join.
    aqe: bool = True
    # Broadcast byte budget: a build side is broadcast while its device
    # bytes stay under this fraction of the memory governor's budget of
    # a shard (plan/adaptive.py).
    aqe_bcast_frac: float = 0.05
    # A sampled join/shuffle key owning at least this fraction of rows is
    # hot.
    aqe_skew_frac: float = 0.3
    # Probe sides smaller than this skip skew detection.
    aqe_skew_min_rows: int = 100_000
    # Device-side parquet decode (io/device_decode.py): read_parquet ships
    # raw page bytes and decodes PLAIN fixed-width / dictionary / RLE-bool
    # pages and definition levels on the device. Columns whose encoding
    # the device route does not cover (DELTA_*, BYTE_STREAM_SPLIT,
    # non-dictionary strings, nested) take the host pyarrow decode, per
    # column. Off -> every page decodes on the host.
    device_decode: bool = True
    # Minimum estimated decoded size (uncompressed bytes, from the footer's
    # row-group totals) before a read takes the device route; smaller
    # reads decode on the host. 0 -> always take the device route when
    # enabled.
    device_decode_min_bytes: int = 1 << 20


config = Config()


def set_config(**kwargs) -> None:
    """Override config values at runtime (tests / notebooks)."""
    valid = {f.name for f in fields(Config)}
    for k, v in kwargs.items():
        if k not in valid:
            raise ValueError(f"unknown config key: {k}")
        setattr(config, k, v)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means CUDA. A CUDA device
    on a machine without one raises; nothing falls back to the CPU, which
    runs only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bodo_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev
