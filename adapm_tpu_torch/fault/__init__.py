"""Fault injection and robustness layers (the JAX package's `fault/`):

  - `inject` — `FaultPlane`: deterministic, seeded, named injection
    points in the executor, sync rounds, tier promotion commits, serve
    drains and checkpoint I/O. Off by default (`Server.fault` is None;
    one `is None` check per site, zero `fault.*` registry names).
  - `policy` — `RetryPolicy`: transient-vs-fatal classification with
    bounded retry + exponential backoff for executor programs.
  - `ckpt` — incremental dirty-slot checkpoint chains
    (`IncrementalCheckpointer` / `restore_chain`) in the JAX package's
    format: atomic links, per-link sha256, a chained manifest; restore
    verifies the whole chain before touching the server and serves
    DEGRADED while it applies.
"""
from .ckpt import (CheckpointChainError,  # noqa: F401
                   CheckpointCorruptError, IncrementalCheckpointer,
                   restore_chain)
from .inject import (FatalInjectedFault, FaultPlane,  # noqa: F401
                     InjectedFault, parse_fault_spec)
from .policy import RetryPolicy, TransientFaultError  # noqa: F401
