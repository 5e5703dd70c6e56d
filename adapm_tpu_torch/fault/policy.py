"""Executor error policy: transient-vs-
fatal classification with bounded retry + exponential backoff.

A failed executor program used to have exactly one outcome: the error
reached the completion's waiters and the program was gone — a transient
hiccup in a self-rescheduling background program (the sync tick, a
serve drain, a tier commit) silently killed that subsystem's loop. The
RetryPolicy gives every stream a second chance with a bound:

  - **classification**: `classify(exc)` decides transient vs fatal.
    The default classifies exactly `TransientFaultError` (and its
    `InjectedFault` subclass) as transient — everything else is fatal
    and surfaces unchanged, so with no injection configured and no
    caller raising TransientFaultError the policy is INERT and the
    executor behaves byte-for-byte as before.
  - **bounded retry + backoff**: a transient failure re-queues the SAME
    program at the head of its stream (FIFO order preserved — the
    stream stays ordered) with `not_before = now + backoff`, where
    backoff doubles per attempt from `--sys.fault.backoff_ms`, capped.
    The completion stays open until the final outcome, so waiters see
    one result, never an intermediate failure.
  - **budget**: after `--sys.fault.retries` retries the error surfaces
    exactly as an unpolicied failure would (logged, completion error).

The watchdog half of the error policy lives in the executor itself
(`AsyncExecutor.wedged_streams`): a program busy past
`--sys.fault.watchdog_s` marks its stream WEDGED — readiness
(serve/health.py) folds that in, so a stuck program flips the traffic
signal instead of hanging probes behind it.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..obs.metrics import Counter


class TransientFaultError(RuntimeError):
    """Base classification for failures the executor's RetryPolicy may
    retry: the operation performed no durable side effects before
    raising, so re-running it is safe."""


def _default_classify(exc: BaseException) -> bool:
    return isinstance(exc, TransientFaultError)


class RetryPolicy:
    """Bounded-retry/backoff policy for executor programs (one per
    executor, applied to every stream; see module docstring). Counters
    are standalone (not registry names): they surface through the
    `fault` snapshot section only when a FaultPlane is attached, and
    `scripts/metrics_overhead_check.py` pins that the registry holds
    zero fault.* names by default."""

    def __init__(self, max_retries: int = 3,
                 backoff_base_s: float = 0.01,
                 backoff_max_s: float = 2.0,
                 classify: Optional[Callable[[BaseException], bool]]
                 = None):
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0 "
                             f"(got {max_retries})")
        if backoff_base_s < 0 or backoff_max_s < 0:
            raise ValueError("backoff bounds must be >= 0")
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.classify = classify or _default_classify
        self.c_retries = Counter("fault.retries_total")
        self.c_backoff_s = Counter("fault.backoff_s_total", unit="s")

    def backoff_s(self, attempt: int) -> float:
        """Delay before retry number `attempt` (1-based): exponential
        from the base, capped."""
        return min(self.backoff_max_s,
                   self.backoff_base_s * (2.0 ** (attempt - 1)))

    def stats(self) -> dict:
        return {"retries": int(self.c_retries.value),
                "backoff_s": float(self.c_backoff_s.value),
                "max_retries": self.max_retries}
