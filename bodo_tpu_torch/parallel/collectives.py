"""Collectives over the mesh's shards, as tensor ops on one device.

Counterpart of bodo_tpu/parallel/collectives.py. There each shard runs
the body of a `shard_map` and the collectives are lax.psum, all_gather
and all_to_all. Here the S shards of a mesh share one device and one
process (parallel/mesh.py): a row-sharded array is the global tensor of
S * C rows, shard i its slice [i*C, (i+1)*C), and a collective is a
tensor op on that layout:

    MPI_Allreduce  -> dist_sum / dist_max / dist_min over the shard axis
    MPI_Exscan     -> dist_exscan_sum, an exclusive cumsum over shards
    MPI_Allgatherv -> all_gather_rows, the whole array repeated per shard
    MPI_Alltoallv  -> all_to_all_rows, a [S_src, S_dst, C] transpose

Per-shard values (a count, a flag) are stacked on a leading shard axis
[S, ...]. A reduction returns the one value every shard would see.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from bodo_tpu_torch.parallel import mesh as mesh_mod


def dist_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the per-shard values `x` [S, ...] (psum)."""
    return x.sum(0)


def dist_max(x: torch.Tensor) -> torch.Tensor:
    """Maximum of the per-shard values `x` [S, ...] (pmax)."""
    return x.amax(0)


def dist_min(x: torch.Tensor) -> torch.Tensor:
    """Minimum of the per-shard values `x` [S, ...] (pmin)."""
    return x.amin(0)


def dist_exscan_sum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum over shards: shard i gets the sum of the
    values of shards 0..i-1 (MPI_Exscan analogue)."""
    return torch.cat([torch.zeros_like(x[:1]), torch.cumsum(x[:-1], 0)])


def all_gather_rows(x: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Every shard receives the concatenation of all shards' rows:
    [S*k, ...] -> [S * S*k, ...], shard i's block the whole input."""
    return x.unsqueeze(0).expand((num_shards,) + tuple(x.shape)).reshape(
        (num_shards * x.shape[0],) + tuple(x.shape[1:]))


def all_to_all_rows(x: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Fixed-capacity all-to-all: shard s holds S blocks of C rows, block
    d going to shard d; shard d receives the S blocks sent to it in
    source order. [S*S*C, ...] -> [S*S*C, ...]."""
    s = num_shards
    c = x.shape[0] // (s * s)
    rest = tuple(x.shape[1:])
    return x.reshape((s, s, c) + rest).transpose(0, 1).reshape(
        (s * s * c,) + rest)


def shard_views(x: Optional[torch.Tensor], num_shards: int
                ) -> List[Optional[torch.Tensor]]:
    """The S shard slices of a row-sharded array (None stays None)."""
    if x is None:
        return [None] * num_shards
    return list(x.reshape((num_shards, -1) + tuple(x.shape[1:])).unbind(0))


def concat_shards(parts: Sequence[Optional[torch.Tensor]]
                  ) -> Optional[torch.Tensor]:
    """The row-sharded array of equal-capacity shard blocks."""
    if parts[0] is None:
        return None
    return torch.cat(list(parts))


# --------------------------------------------------------------------------
# host-level distribution helpers
# --------------------------------------------------------------------------

def shard_host_array(arr: np.ndarray,
                     capacity_per_shard: Optional[int] = None, mesh=None):
    """Scatter a host array into a row-sharded device array (MPI_Scatterv
    analogue): equal padded chunks, shard i owning rows [i*cap, i*cap +
    counts[i]). Returns (device tensor [S*cap], counts int64 [S])."""
    m = mesh or mesh_mod.get_mesh()
    s = m.n_shards
    n = arr.shape[0]
    base = -(-n // s) if n else 0
    cap = capacity_per_shard if capacity_per_shard is not None \
        else _round_cap(base)
    counts = np.array([max(0, min(cap, n - i * cap)) for i in range(s)],
                      dtype=np.int64)
    if counts.sum() != n:
        # capacity too small for equal chunking; grow
        cap = _round_cap(-(-n // s))
        counts = np.array([max(0, min(cap, n - i * cap)) for i in range(s)],
                          dtype=np.int64)
    padded = np.zeros((s * cap,) + arr.shape[1:], dtype=arr.dtype)
    if n:
        padded[: min(n, s * cap)] = arr[: s * cap]
    return torch.from_numpy(padded).to(m.device), counts


def gather_host_rows(dev_arr: torch.Tensor, counts) -> np.ndarray:
    """Gather a row-sharded device array back to the host, trimming each
    shard's padding (MPI_Gatherv analogue)."""
    counts = np.asarray(counts)
    s = len(counts)
    host = dev_arr.cpu().numpy()
    cap = host.shape[0] // s
    pieces = [host[i * cap: i * cap + int(counts[i])] for i in range(s)]
    return np.concatenate(pieces, axis=0) if pieces else host[:0]


def _round_cap(n: int) -> int:
    from bodo_tpu_torch.table.table import round_capacity
    return round_capacity(n)
