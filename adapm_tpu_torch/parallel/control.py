"""Process control plane, one-process part: the calls the apps make
(process_id, num_processes, barrier, allreduce), answered for a single
process. The JAX package's `parallel/control.py` rides JAX's
distributed coordinator; the port's multi-process layer (a
`torch.distributed` rendezvous) is ROADMAP queue A, item 11, and a run
that asks for more than one process raises until then.
"""
from __future__ import annotations

import os

import numpy as np

# env names of the launcher contract (the JAX package's launcher.py)
ENV_NUM_PROCS = "ADAPM_NUM_PROCESSES"


def num_processes() -> int:
    n = int(os.environ.get(ENV_NUM_PROCS, "1") or "1")
    if n > 1:
        raise NotImplementedError(
            f"{ENV_NUM_PROCS}={n}: multi-process runs are not ported yet "
            "(ROADMAP queue A, item 11)")
    return 1


def process_id() -> int:
    num_processes()
    return 0


def barrier(name: str = "adapm") -> None:
    """Global process barrier: nothing to wait for in one process."""
    num_processes()


def allreduce(values, op: str = "sum", site: str = "ar") -> np.ndarray:
    """Sum/mean/max a host scalar or vector across processes (reference
    ps_allreduce, include/utils.h:163-197). One process: the input as a
    float64 array."""
    if op not in ("sum", "mean", "max"):
        raise ValueError(f"unknown allreduce op {op}")
    num_processes()
    return np.atleast_1d(np.asarray(values, dtype=np.float64))
