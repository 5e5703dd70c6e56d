"""adapm-tpu on PyTorch and CUDA: the adaptive parameter manager of the
JAX package `adapm_tpu`, ported to torch tensors on one NVIDIA GPU.

The port holds the JAX package's semantics: Pull/Push/Set, Intent +
advanceClock, adaptive relocate-vs-replicate, and the device-routed
fused training step, with data-plane results bit-identical to the JAX
package's. It imports nothing of that package (and no JAX). Its entry
points run on `cuda` unless the caller passes `device="cpu"`.
"""
from .base import CLOCK_MAX, LOCAL, WORKER_FINISHED, MgmtTechniques  # noqa
from .config import SystemOptions  # noqa
from .core.kv import Server, Worker  # noqa
from .device.context import DeviceContext, make_context  # noqa
from .parallel.mesh import MeshContext, get_mesh_context, make_mesh  # noqa

__version__ = "0.1.0"


def setup(num_keys: int, value_lengths, opts=None, num_shards=None,
          num_workers=None, device=None):
    """Convenience: build a device context + Server (reference
    `ps::Setup` + `ServerT server(...)`, apps/simple.cc:107-133).
    `num_shards` virtual shards (default 1) on `device` (default: this
    process's card, parallel/mesh.py make_mesh). Under the launcher
    (ADAPM_COORDINATOR set), this also joins the multi-process runtime —
    the reference's Postoffice::Start + scheduler rendezvous."""
    from .parallel import control
    control.init_from_env()
    ctx = make_mesh(num_shards, device=device)
    return Server(num_keys, value_lengths, opts=opts, ctx=ctx,
                  num_workers=num_workers)
