"""The mesh of row shards.

Counterpart of bodo_tpu/parallel/mesh.py. The JAX package joins devices
into a 1-D `jax.sharding.Mesh` and shards rows over it. The port keeps S
shards on ONE device, in one process: a 1D column is one tensor of
S * shard_cap rows, shard i the slice [i*shard_cap, (i+1)*shard_cap),
which is exactly the JAX package's global-array layout under P("d"). It
is the counterpart of the JAX package's virtual CPU devices; the
collectives (parallel/collectives.py) become tensor ops on that layout.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch

from bodo_tpu_torch.config import resolve_device


@dataclass(frozen=True)
class Mesh:
    """S row shards on one device."""
    n_shards: int
    device: torch.device


_active_mesh: Optional[Mesh] = None


def make_mesh(n_shards: int = 1, device=None) -> Mesh:
    """A mesh of `n_shards` shards on `device`: CUDA unless the caller
    names another device; without CUDA it raises. The default of one
    shard is what the JAX package's default mesh is on a machine with
    one accelerator."""
    if int(n_shards) < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        # name the index, as a tensor's device does, so that tables made
        # on "cuda" compare equal to the mesh's device
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(int(n_shards), dev)


def get_mesh() -> Mesh:
    """The active mesh (the default one is made at first use)."""
    global _active_mesh
    if _active_mesh is None:
        _active_mesh = make_mesh()
    return _active_mesh


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _active_mesh
    _active_mesh = mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    global _active_mesh
    prev = _active_mesh
    _active_mesh = mesh
    try:
        yield mesh
    finally:
        _active_mesh = prev


def num_shards(mesh: Optional[Mesh] = None) -> int:
    """Number of row shards."""
    return (mesh or get_mesh()).n_shards
