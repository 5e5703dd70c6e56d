"""Observability: key-event tracing and locality statistics.

Reference (SURVEY.md §5):
  - key tracing (PS_TRACE_KEYS + --sys.trace.keys): timestamped
    ALLOC/DEALLOC/REPLICA_SETUP/REPLICA_DROP/INTENT_START/INTENT_STOP events
    for traced keys, dumped to traces.<rank>.tsv at shutdown
    (coloc_kv_server_handle.h:86-104, 213-255, 978-992).
  - locality stats (PS_LOCALITY_STATS): per-key access / local-access
    counters written to locality_stats.rank.<r>.tsv
    (handle.h:206-210, 439-441, 961-975).

Here both are runtime-enabled (no compile-time define needed): tracing via
`--sys.trace.keys`, locality stats via `--sys.stats.locality`. Counter
updates are vectorized (np.add.at over the batch) so the overhead per op is
one masked scatter, not a per-key branch.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np

# event names follow the reference's trace vocabulary
ALLOC = "ALLOC"
DEALLOC = "DEALLOC"
REPLICA_SETUP = "REPLICA_SETUP"
REPLICA_DROP = "REPLICA_DROP"
INTENT_START = "INTENT_START"
INTENT_STOP = "INTENT_STOP"
RELOCATE = "RELOCATE"

# dump schemas, fixed as module constants so trace TSVs keep a stable,
# diffable column order across runs
TRACE_COLUMNS = ("time", "key", "event", "shard")
LOCALITY_COLUMNS = ("key", "accesses", "local_accesses",
                    "sampling_accesses")


def parse_trace_spec(spec: str, num_keys: int,
                     ) -> Optional[np.ndarray]:
    """Parse --sys.trace.keys (reference handle.h trace config):
    'all' | 'random-N-seed-S-range-A-B' | 'k1,k2,k3'. Returns traced key
    array or None."""
    if not spec:
        return None
    spec = spec.strip()
    if spec == "all":
        return np.arange(num_keys, dtype=np.int64)
    if spec.startswith("random-"):
        parts = spec.split("-")
        n = int(parts[1])
        seed = int(parts[parts.index("seed") + 1]) if "seed" in parts else 0
        if "range" in parts:
            i = parts.index("range")
            lo, hi = int(parts[i + 1]), int(parts[i + 2])
            if not (0 <= lo < hi <= num_keys):
                raise ValueError(
                    f"--sys.trace.keys range [{lo}, {hi}) outside the key "
                    f"space [0, {num_keys})")
        else:
            lo, hi = 0, num_keys
        rng = np.random.default_rng(seed)
        return np.unique(rng.integers(lo, hi, n).astype(np.int64))
    keys = np.unique(np.asarray(
        [int(k) for k in spec.split(",") if k.strip()], dtype=np.int64))
    if len(keys) and (keys[0] < 0 or keys[-1] >= num_keys):
        raise ValueError(
            f"--sys.trace.keys contains keys outside [0, {num_keys}): "
            f"{keys[(keys < 0) | (keys >= num_keys)].tolist()}")
    return keys


class KeyTracer:
    """Records timestamped placement events for a traced key subset."""

    def __init__(self, traced_keys: np.ndarray, num_keys: int):
        self._mask = np.zeros(num_keys, dtype=bool)
        self._mask[traced_keys] = True
        self.events: List[Tuple[float, int, str, int]] = []
        self._t0 = time.monotonic()

    def record(self, keys, event: str, shard: int = -1) -> None:
        keys = np.atleast_1d(np.asarray(keys, dtype=np.int64))
        hit = keys[self._mask[keys]]
        if len(hit) == 0:
            return
        t = time.monotonic() - self._t0
        for k in hit:
            self.events.append((t, int(k), event, shard))

    def dump(self, path: str) -> None:
        # deterministic row order: events are appended by several threads
        # (worker, sync, prefetch), so the list order varies run to run;
        # sorting by (time, key, event, shard) makes same-history dumps
        # diff cleanly
        with open(path, "w") as f:
            f.write("\t".join(TRACE_COLUMNS) + "\n")
            for t, k, e, s in sorted(self.events):
                f.write(f"{t:.6f}\t{k}\t{e}\t{s}\n")


class LocalityStats:
    """Per-key access counters: how many pulls/pushes, how many of those
    were served locally (owner or replica on the accessing shard)."""

    def __init__(self, num_keys: int, native_lib=None):
        self.accesses = np.zeros(num_keys, dtype=np.int64)
        self.local = np.zeros(num_keys, dtype=np.int64)
        self.sampling_accesses = np.zeros(num_keys, dtype=np.int64)
        self._native = native_lib

    def record(self, keys: np.ndarray, local_mask: np.ndarray) -> None:
        if self._native is not None:
            bad = self._native.adapm_count(
                np.ascontiguousarray(keys, np.int64),
                np.ascontiguousarray(local_mask, np.uint8), len(keys),
                len(self.accesses), self.accesses, self.local)
            if bad:
                raise IndexError(f"{bad} stat keys outside the key range")
            return
        from ..base import check_key_range
        check_key_range(keys, len(self.accesses), "stat key")
        np.add.at(self.accesses, keys, 1)
        np.add.at(self.local, keys, local_mask.astype(np.int64))

    def record_sampling(self, keys: np.ndarray) -> None:
        np.add.at(self.sampling_accesses, keys, 1)

    def dump(self, path: str) -> None:
        touched = np.nonzero(self.accesses + self.sampling_accesses)[0]
        with open(path, "w") as f:
            f.write("\t".join(LOCALITY_COLUMNS) + "\n")
            for k in touched:
                f.write(f"{k}\t{self.accesses[k]}\t{self.local[k]}"
                        f"\t{self.sampling_accesses[k]}\n")


def write_stats(stats_out: str, rank: int, tracer: Optional[KeyTracer],
                locality: Optional["LocalityStats"]) -> List[str]:
    """Dump enabled collectors into the stats dir (reference
    --sys.stats.out); returns written paths."""
    os.makedirs(stats_out, exist_ok=True)
    written = []
    if tracer is not None:
        p = os.path.join(stats_out, f"traces.{rank}.tsv")
        tracer.dump(p)
        written.append(p)
    if locality is not None:
        p = os.path.join(stats_out, f"locality_stats.rank.{rank}.tsv")
        locality.dump(p)
        written.append(p)
    return written
