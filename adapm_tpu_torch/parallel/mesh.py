"""Device placement: the port's counterpart of the JAX package's
`parallel/mesh.py`.

There, the "nodes" are mesh devices: a pool is one `[S, slots, L]` array
sharded over the "kv" axis of S devices. Here all S shards are virtual
shards on ONE torch device (device/context.py DeviceContext), so
`MeshContext` is a DeviceContext under the mesh's names: `num_shards`,
`devices` (the one device), `shard0()` and `replicated()` (where a pool
and a staged array live: that device). On a launched multi-process run
`make_mesh` takes this process's own card (rank modulo the visible
cards: several ranks share one card when there are fewer cards than
ranks) and makes it the current CUDA device: every kernel wrapper of
`ops/kernels.py` launches on the current device's stream.

The collective exchange runs over the process list instead of a device
mesh: `ProcessMesh` names it (this process's rank, the process count and
the device its receive slabs live on), and `device/torchport.py
compile_collective` builds the exchange over it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..device.context import DeviceContext

KV_AXIS = "kv"
PROC_AXIS = "p"


class MeshContext(DeviceContext):
    """S virtual shards on one device, under the JAX mesh's names."""

    @property
    def devices(self) -> Sequence[torch.device]:
        return [self.device]

    def shard0(self) -> torch.device:
        """Placement of pool arrays [S, slots, L]: the one device."""
        return self.device

    def replicated(self) -> torch.device:
        return self.device


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The collective exchange's axis: `num_procs` processes, this one
    `pid`, its receive slabs on `device`."""
    pid: int
    num_procs: int
    device: torch.device
    axis: str = PROC_AXIS


def _own_device() -> torch.device:
    """This process's card: on a launched run, rank modulo the visible
    cards, made the current device (the kernel wrappers launch on the
    current device's stream); else the current CUDA device."""
    from . import control
    if control.num_processes() > 1 and torch.cuda.is_available():
        dev = torch.device("cuda", control.process_id()
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        return dev
    return torch.device("cuda")


def make_mesh(num_shards: Optional[int] = None,
              devices: Optional[Sequence] = None,
              device=None) -> MeshContext:
    """`num_shards` virtual shards (default 1) on `device`, on the first
    of `devices`, or (neither given) on this process's own card."""
    if device is None:
        device = devices[0] if devices else _own_device()
    return MeshContext(1 if num_shards is None else num_shards, device)


def process_mesh(pid: int, num_procs: int, device) -> ProcessMesh:
    return ProcessMesh(int(pid), int(num_procs), torch.device(device))


_default_ctx: Optional[MeshContext] = None


def get_mesh_context() -> MeshContext:
    global _default_ctx
    if _default_ctx is None:
        _default_ctx = make_mesh()
    return _default_ctx


def set_mesh_context(ctx: MeshContext) -> None:
    global _default_ctx
    _default_ctx = ctx
