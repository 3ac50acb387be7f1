"""Configuration of the relational path, and the device every entry point
runs on.

Only the fields the one-GPU relational path reads, with the JAX package's
defaults (bodo_tpu/config.py), so both packages plan the same routes on
the same data.
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
