"""Deterministic, seeded fault injection: the port of the JAX package's
`fault/inject.py`.

The plane is a registry of NAMED injection points threaded through the
control paths — executor program dispatch/completion
(exec/executor.py), background sync rounds (core/kv.py tick), tier
promotion commits (tier/promote.py), serve drains (serve/batcher.py),
and checkpoint I/O (utils/checkpoint.py + fault/ckpt.py). Each point
fires with a configured probability and raises `InjectedFault` (a
`TransientFaultError` — the classification the executor's RetryPolicy
retries) or `FatalInjectedFault` (never retried: the completion-side
point, where the program's side effects already happened and a retry
would double-execute them).

Off by default at the cost of one `is None` check per site:
`Server.fault` is None unless `--sys.fault.spec` is set, and the
registry then holds zero `fault.*` metric names.

Determinism: each point owns its own `random.Random` seeded from
(`--sys.fault.seed`, crc32(point name)) exactly as in the JAX package,
so the Nth evaluation of a given point draws the same number regardless
of how OTHER points interleave across threads, and the same spec and
seed fire the same schedule on both packages.

Spec grammar (`--sys.fault.spec`): comma/semicolon-separated
`point=probability` pairs, e.g.

    --sys.fault.spec "sync.round=0.2,serve.drain=0.1,tier.promote=0.05"

Probabilities are in [0, 1]; unknown point names are allowed (a spec
may name a point the current configuration never reaches — it simply
never fires).

Injection points wired in the port:

    exec.dispatch   before an executor program runs (retry-safe)
    exec.complete   after a program ran, before completion (FATAL)
    sync.round      background sync tick, before run_round
    serve.drain     serve dispatcher drain, before any request is
                    claimed (retry-safe: no waiter is failed)
    tier.promote    tier promotion commit, before ensure_hot_rows
    ckpt.save       checkpoint save entry (atomic tmp+rename writes
                    make a failed save invisible)
    ckpt.restore    checkpoint restore entry, before any server
                    mutation

and the `net.*` wire points of the loopback transport (net/loopback.py:
net.send, net.recv, net.delay, net.dup, net.partition), evaluated with
`draw` (non-raising: a dropped or duplicated frame is the fault).
"""
from __future__ import annotations

import random
import threading
import zlib
from typing import Dict, Tuple

from .policy import TransientFaultError


class InjectedFault(TransientFaultError):
    """A seeded injection fired at a named point (retryable)."""


class FatalInjectedFault(RuntimeError):
    """A seeded injection at a point where the guarded work ALREADY
    happened (e.g. `exec.complete`) — retrying would double-execute,
    so this is deliberately NOT a TransientFaultError."""


def parse_fault_spec(spec: str) -> Dict[str, float]:
    """`point=prob` pairs, comma/semicolon separated. Raises ValueError
    on malformed entries or probabilities outside [0, 1]."""
    out: Dict[str, float] = {}
    for raw in spec.replace(";", ",").split(","):
        item = raw.strip()
        if not item:
            continue
        name, sep, val = item.partition("=")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"--sys.fault.spec entry {item!r} is not "
                f"'point=probability'")
        try:
            p = float(val)
        except ValueError:
            raise ValueError(
                f"--sys.fault.spec probability {val!r} for point "
                f"{name!r} is not a number") from None
        if not 0.0 <= p <= 1.0:
            raise ValueError(
                f"--sys.fault.spec probability {p!r} for point "
                f"{name!r} must be in [0, 1]")
        out[name] = p
    return out


class _Point:
    """One injection point's seeded RNG + accounting (own lock so
    firing threads of different points never contend)."""

    __slots__ = ("name", "prob", "rng", "lock", "evals", "fired")

    def __init__(self, name: str, prob: float, seed: int):
        self.name = name
        self.prob = prob
        # per-point stream (crc32, not hash(): str hashes are salted per
        # process) — the JAX package's seeding, bit for bit
        self.rng = random.Random(
            (int(seed) << 32) ^ zlib.crc32(name.encode()))
        self.lock = threading.Lock()
        self.evals = 0
        self.fired = 0


class FaultPlane:
    """Seeded probability-per-point injection (see module docstring).
    Constructed by Server only when `--sys.fault.spec` is non-empty;
    every instrumented site guards with `if fault is not None`."""

    def __init__(self, spec: str, seed: int = 0, registry=None):
        self.seed = int(seed)
        self._points: Dict[str, _Point] = {
            name: _Point(name, p, seed)
            for name, p in parse_fault_spec(spec).items()}
        # registry metrics exist ONLY when a plane exists: with
        # injection off the registry holds zero fault.* names
        from ..obs.metrics import Counter
        if registry is not None and registry.enabled:
            self._c_fired = registry.counter("fault.injections_total")
            self._c_by_point = {
                name: registry.counter(f"fault.injections.{name}")
                for name in self._points}
            # retries performed by self-healing loops (the background
            # sync tick, the periodic checkpointer) that catch their own
            # failures instead of riding the executor policy
            self.c_loop_retries = registry.counter(
                "fault.loop_retries_total")
        else:
            self._c_fired = Counter("fault.injections_total")
            self._c_by_point = {name: Counter(f"fault.injections.{name}")
                                for name in self._points}
            self.c_loop_retries = Counter("fault.loop_retries_total")

    def _eval(self, point: str):
        """One seeded draw of `point`: None when the point is not in the
        spec (or at p=0), else (hit, fired count, probability)."""
        pt = self._points.get(point)
        if pt is None or pt.prob <= 0.0:
            return None
        with pt.lock:
            pt.evals += 1
            hit = pt.rng.random() < pt.prob
            if hit:
                pt.fired += 1
            n = pt.fired
        if hit:
            self._c_fired.inc()
            self._c_by_point[point].inc()
        return hit, n, pt.prob

    def fire(self, point: str, transient: bool = True) -> None:
        """Evaluate `point`: raise with its configured probability,
        no-op otherwise (or when the point is not in the spec).
        `transient=False` raises `FatalInjectedFault` instead (the
        completion-side points, where a retry would double-execute)."""
        r = self._eval(point)
        if r is None or not r[0]:
            return
        cls = InjectedFault if transient else FatalInjectedFault
        raise cls(f"injected fault #{r[1]} at {point!r} "
                  f"(--sys.fault.spec p={r[2]:g}, seed={self.seed})")

    def draw(self, point: str) -> bool:
        """Non-raising evaluation for points where the fault is an ACTION
        the caller performs (drop/duplicate/delay a network frame) rather
        than an exception to unwind. Same seeded per-point stream and
        accounting as fire()."""
        r = self._eval(point)
        return r is not None and r[0]

    def counts(self, point: str) -> Tuple[int, int]:
        """(evaluations, fired) for one point — 0s when unconfigured."""
        pt = self._points.get(point)
        return (pt.evals, pt.fired) if pt is not None else (0, 0)

    def stats(self) -> Dict:
        """The `fault` snapshot section's injection half (the executor
        contributes retries / backoff / wedge flips)."""
        out: Dict = {"seed": self.seed,
                     "injections_fired": int(self._c_fired.value),
                     "loop_retries": int(self.c_loop_retries.value)}
        out["points"] = {
            name: {"prob": pt.prob, "evals": pt.evals,
                   "fired": pt.fired}
            for name, pt in self._points.items()}
        return out
