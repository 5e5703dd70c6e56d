"""The device context: one torch device holding S virtual shards.

The counterpart of the JAX package's `parallel/mesh.py`. There, S shards
are S mesh devices and a pool is one `[S, slots, L]` array sharded over
them. Here all S shards live on ONE device in one `[S, slots, L]` tensor,
so (shard, slot) coordinates, routing, slot allocation and the
replicate-vs-relocate planner carry over unchanged. The default is S=1
on the card; tests pass S=8 to mirror the JAX suite's 8-device CPU mesh.
"""
from __future__ import annotations

from typing import Optional

import torch


class DeviceContext:
    """`num_shards` virtual shards on `device` (default: the current
    CUDA device)."""

    def __init__(self, num_shards: int = 1, device=None):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1 (got {num_shards})")
        self.num_shards = int(num_shards)
        self.device = torch.device("cuda" if device is None else device)

    def put_replicated(self, arr) -> torch.Tensor:
        """Stage a host array on the context's device."""
        from . import default_port
        return default_port().put_replicated(arr, self.device)


def make_context(num_shards: Optional[int] = None,
                 device=None) -> DeviceContext:
    return DeviceContext(1 if num_shards is None else num_shards, device)
