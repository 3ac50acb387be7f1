"""Memory governor: the device budget behind the 1D join decisions.

Counterpart of the part of bodo_tpu/runtime/memory_governor.py that
plan/adaptive.py reads: the derived per-shard budget
(`MemoryGovernor.derived_budget`), its per-operator slice
(`operator_budget`), the test hook `set_probe_for_testing`, the process
governor (`governor`, `reset_governor`) and `table_device_bytes`.
Admission control (`admit`, grants, `reserve`, `handle_oom`,
`preadmission_charge`) serves the streaming executors, which the port
has not yet.

The probe (`_probe_device_budget`) measures the memory of the mesh's
device and splits it over the mesh's shards, which all live on that one
device (parallel/mesh.py). This is the JAX package's rule for virtual
devices that share one memory (its CPU devices, `memory_governor.py:95-98`):
  - CUDA: the bytes free on the card, `torch.cuda.mem_get_info`, plus the
    bytes the caching allocator holds but no tensor uses
    (`memory_reserved - memory_allocated`): together the counterpart of
    XLA's `bytes_limit - bytes_in_use`; divided by the shards;
  - CPU: a quarter of host RAM, divided by the shards.
The JAX package's `_budget` catches every failure of its probe and takes
the rows-only rule; the port's probe raises instead, since a silent 0
would hide the fault behind that rule.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch

from bodo_tpu_torch.config import config

_CPU_RAM_FRACTION = 0.25   # a quarter of host RAM counts as device memory


def _host_ram_bytes() -> int:
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _probe_device_budget(device: torch.device, n_shards: int) -> int:
    """Bytes one shard of a mesh of `n_shards` shards on `device` may
    use."""
    n = max(int(n_shards), 1)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return int(free + cached) // n
    if device.type == "cpu":
        return int(_host_ram_bytes() * _CPU_RAM_FRACTION / n)
    raise ValueError(f"no memory probe for device type {device.type!r}")


class MemoryGovernor:
    """The derived device budget of the active mesh."""

    def __init__(self):
        self._mu = threading.Lock()
        self._derived = 0          # post-headroom budget a shard, bytes
        self._derived_key = None   # (device type, shards) of the probe
        self._probe_override: Optional[int] = None  # test hook

    def set_probe_for_testing(self, nbytes: Optional[int]) -> None:
        """Test hook: pretend the probe returned `nbytes` (None restores
        the real probe). Forces re-derivation."""
        with self._mu:
            self._probe_override = nbytes
            self._derived_key = None

    def derived_budget(self, mesh=None) -> int:
        """Budget of one shard after headroom; re-derived when the mesh's
        (device type, shards) changes."""
        from bodo_tpu_torch.parallel import mesh as mesh_mod
        m = mesh or mesh_mod.get_mesh()
        key = (m.device.type, m.n_shards)
        with self._mu:
            if key != self._derived_key:
                raw = (self._probe_override
                       if self._probe_override is not None
                       else _probe_device_budget(m.device, m.n_shards))
                headroom = min(max(config.mem_headroom_frac, 0.0), 0.9)
                self._derived = max(0, int(raw * (1.0 - headroom)))
                self._derived_key = key
            return self._derived

    def operator_budget(self, mesh=None) -> int:
        """Default per-operator slice of the derived budget."""
        frac = min(max(config.mem_op_fraction, 0.05), 1.0)
        return int(self.derived_budget(mesh) * frac)


_governor: Optional[MemoryGovernor] = None
_gov_lock = threading.Lock()


def governor() -> MemoryGovernor:
    global _governor
    with _gov_lock:
        if _governor is None:
            _governor = MemoryGovernor()
        return _governor


def reset_governor() -> None:
    """Drop all state (tests)."""
    global _governor
    with _gov_lock:
        _governor = None


def table_device_bytes(t) -> int:
    """Device bytes of a Table's columns (data + validity), counted on
    capacity, padding included."""
    n = 0
    for c in t.columns.values():
        n += c.data.numel() * c.data.element_size()
        if c.valid is not None:
            n += c.valid.numel()
    return n
