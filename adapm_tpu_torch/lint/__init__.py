"""The port's lint plane: the AST invariant analyzer and the runtime
lock-order sentinel for the planes' concurrency contract (the twin of
the JAX package's `lint/`, retargeted to `adapm_tpu_torch/`).

Two halves, one contract (docs/INVARIANTS.md):

  - ``analyzer``/``rules`` — the static pass: rule IDs ``APM001``..
    ``APM008`` over the port's own ASTs, justified
    ``# apm-lint: disable=`` suppressions that fail the run when unused,
    deterministic JSON + human reports. Run by
    ``python -m adapm_tpu_torch.lint``.
  - ``lockorder`` — the dynamic pass: an opt-in
    (``--sys.lint.lockorder``) sentinel wrapped around the server
    locks, the dispatch gate and the admission lock, that records the
    per-thread acquisition graph and raises on a cycle or a gate-leaf
    violation — enabled inside the port's storm tests, so the runtime
    checker validates what the static rules claim.

Pure stdlib on purpose: importable with no device stack.
"""
from .analyzer import (Analyzer, Finding, ModuleInfo,  # noqa: F401
                       ProjectContext, Report, Rule, Suppression)
from .lockorder import (LockOrderError, LockOrderSentinel,  # noqa: F401
                        SentinelLock, enable_sentinel, get_sentinel,
                        disable_sentinel)
from .rules import default_rules  # noqa: F401
