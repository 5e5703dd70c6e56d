"""The device plane.

    port.py      — the DevicePort protocol (the JAX package's, carried
                   over method for method).
    torchport.py — TorchDevicePort: the data-plane programs over torch
                   tensors and the hand-written CUDA kernels
                   (ops/kernels.py).
    context.py   — DeviceContext: one device holding S virtual shards
                   (replaces the JAX package's device mesh).
"""
from __future__ import annotations

from .context import DeviceContext, make_context  # noqa: F401
from .port import DevicePort, default_port, set_default_port  # noqa: F401
from .torchport import OOB, TorchDevicePort  # noqa: F401
