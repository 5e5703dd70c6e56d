"""Shared application harness: the idioms every reference app uses
(SURVEY.md §2.3 "Common app idioms"), as in the JAX package's
`apps/common.py`.

- `enforce_random_keys`: random key shuffling for load balance — apps address
  logical keys, a fixed permutation maps them to physical PM keys
  (reference apps shuffle key assignment, e.g. kge.cc / word2vec.cc flag).
- `enforce_full_replication`: Intent all keys to CLOCK_MAX as an ablation
  (replication-everywhere baseline).
- worker-0-initializes + BeginSetup/EndSetup bracket.
- `max_runtime` epoch cutoff.
- wrap-around batching: the tail of a data partition wraps to its start
  (a few duplicate points per epoch), so every step has the same shape.
- `ScanWindow`: the --scan_steps dispatch contract (K steps per
  DeviceRoutedRunner.run_scan).
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from ..base import CLOCK_MAX
from ..config import SystemOptions
from ..utils import Stopwatch, alog


def add_common_arguments(parser: argparse.ArgumentParser,
                         default_epochs: int = 4) -> None:
    g = parser.add_argument_group("run")
    g.add_argument("--num_workers", type=int, default=0,
                   help="logical workers (0 = one per mesh shard)")
    g.add_argument("--num_shards", type=int, default=0,
                   help="kv shards (0 = one; virtual shards share the "
                        "device)")
    g.add_argument("--epochs", type=int, default=default_epochs)
    g.add_argument("--batch_size", type=int, default=256)
    g.add_argument("--lr", type=float, default=0.1)
    g.add_argument("--seed", type=int, default=42)
    g.add_argument("--max_runtime", type=float, default=0.0,
                   help="stop after this many seconds (0 = unlimited)")
    g.add_argument("--enforce_random_keys", action="store_true",
                   help="randomly permute key assignment for load balance")
    g.add_argument("--enforce_full_replication", action="store_true",
                   help="ablation: Intent all keys everywhere, forever")
    g.add_argument("--sync_rounds_per_step", type=int, default=1,
                   help="planner sync rounds driven per training step")
    SystemOptions.add_arguments(parser)


def make_server(args, num_keys: int, value_lengths, num_workers: int,
                device=None):
    """The app's Server on `device` (default cuda)."""
    from .. import setup
    opts = SystemOptions.from_args(args)
    return setup(num_keys, value_lengths, opts=opts,
                 num_shards=args.num_shards or None,
                 num_workers=num_workers, device=device)


class KeyMapper:
    """Logical key -> physical PM key. Identity unless enforce_random_keys;
    then a seeded permutation (reference `enforce_random_keys`: shuffled
    assignment balances hot keys over servers)."""

    def __init__(self, num_keys: int, shuffle: bool, seed: int = 1234):
        if shuffle:
            rng = np.random.default_rng(seed)
            self.perm = rng.permutation(num_keys).astype(np.int64)
        else:
            self.perm = None

    def __call__(self, keys):
        keys = np.asarray(keys, dtype=np.int64)
        return self.perm[keys] if self.perm is not None else keys


def enforce_full_replication(workers, num_keys: int) -> None:
    """Every worker declares eternal intent on every key, then one forced
    sync round materializes the replicas (ablation mode)."""
    all_keys = np.arange(num_keys, dtype=np.int64)
    for w in workers:
        w.intent(all_keys, 0, CLOCK_MAX)
    workers[0].server.wait_sync()


def worker0_init(workers, keys: np.ndarray, values: np.ndarray,
                 slab: int = 100_000) -> None:
    """Worker 0 of PROCESS 0 initializes the model inside
    BeginSetup/EndSetup (the reference's worker-0-initializes pattern;
    under the launcher, cross-process Sets route to each key's owner)."""
    from ..parallel import control
    w0 = workers[0]
    w0.begin_setup()
    if control.process_id() == 0:
        for lo in range(0, len(keys), slab):
            hi = min(lo + slab, len(keys))
            w0.set(keys[lo:hi], values[lo:hi])
        w0.wait_all()
    w0.end_setup()  # barriers: every rank sees the initialized model


def global_worker_slices(n_items: int, num_local_workers: int):
    """Per-local-worker contiguous slices of [0, n_items) partitioned over
    ALL workers of ALL processes (reference apps partition data by global
    worker id, word2vec.cc:524-531, kge.cc:968-970). Returns a list of
    index arrays, one per local worker."""
    from ..parallel import control
    P, pid = control.num_processes(), control.process_id()
    parts = np.array_split(np.arange(n_items), P * num_local_workers)
    return [parts[pid * num_local_workers + wi]
            for wi in range(num_local_workers)]


def wrap_batches(n: int, batch_size: int, rng: Optional[np.random.Generator]
                 = None):
    """Yield index arrays of exactly batch_size covering [0, n), shuffled if
    rng given; the final batch wraps around to the start."""
    if n == 0:
        return
    order = rng.permutation(n) if rng is not None else np.arange(n)
    for lo in range(0, n, batch_size):
        idx = order[lo:lo + batch_size]
        if len(idx) < batch_size:
            reps = -(-batch_size // n)  # n may be smaller than the shortfall
            idx = np.concatenate([idx, np.tile(order, reps)])[:batch_size]
        yield idx


class ScanWindow:
    """The apps' shared --scan_steps dispatch contract: a full K-batch
    window trains in ONE dispatch (DeviceRoutedRunner.run_scan: a loop on
    the CPU, one CUDA graph replay on the card) followed by
    K * sync_rounds_per_step planner rounds; a partial tail window runs
    per step, each step followed by its rounds. Batches in one window
    must come from ONE worker shard: flush at worker/block boundaries."""

    def __init__(self, server, K: int, sync_rounds_per_step: int,
                 on_loss=None):
        self.server = server
        self.K = K
        self.rounds = sync_rounds_per_step
        self.on_loss = on_loss or (lambda loss: None)
        self.buf: list = []  # (runner, roles, aux)

    def add(self, runner, roles, aux, lr) -> None:
        self.buf.append((runner, roles, aux))
        if len(self.buf) == self.K:
            self.flush(lr)

    def flush(self, lr) -> None:
        if not self.buf:
            return
        runner = self.buf[0][0]
        if len(self.buf) == self.K and self.K > 1:
            has_aux = self.buf[0][2] is not None
            self.on_loss(runner.run_scan(
                [r for _, r, _ in self.buf],
                [a for _, _, a in self.buf] if has_aux else None, lr))
            self.server.drive_rounds(len(self.buf) * self.rounds)
        else:
            for rn, roles, aux in self.buf:
                self.on_loss(rn(roles, aux, lr))
                self.server.drive_rounds(self.rounds)
        self.buf.clear()


class RuntimeGuard:
    """max_runtime cutoff (reference apps' --max_runtime). The decision is
    COLLECTIVE in a multi-process run: every rank must leave the epoch
    loop together or the per-epoch barriers deadlock."""

    def __init__(self, max_runtime_s: float):
        self.max = max_runtime_s
        self.watch = Stopwatch(start=True)

    def expired(self) -> bool:
        mine = self.max > 0 and self.watch.elapsed_s > self.max
        from ..parallel import control
        if control.num_processes() == 1:
            return mine
        return bool(control.allreduce(float(mine), "max")[0] > 0)


def is_rank0() -> bool:
    from ..parallel import control
    return control.process_id() == 0


def epoch_report(name: str, epoch: int, loss: float, watch: Stopwatch,
                 extra: str = "") -> None:
    alog(f"[{name}] epoch {epoch}: loss={loss:.6f} "
         f"time={watch.elapsed_s:.2f}s {extra}")
