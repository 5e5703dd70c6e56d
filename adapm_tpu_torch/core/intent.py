"""Intent queues, logical clocks, the ActionTimer and the plan cache.

Reference: ColoKVWorker::Intent pushes FutureIntent{start,end,keys} into
per-channel queues drained by the sync managers
(coloc_kv_worker.h:380-408, 723-744); ActionTimer estimates how many clocks a
worker will advance in ~2 sync rounds so intents are acted on just-in-time
(sync_manager.h:62-158). This is the JAX package's `core/intent.py`
without the prefetch pipeline and its staging pool (ROADMAP queue A,
item 7).
"""
from __future__ import annotations

import collections
import heapq
import itertools
import math
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..base import CLOCK_MAX


class IntentQueue:
    """Per-worker future-intent queue ordered by start clock."""

    def __init__(self):
        self._heap: List[Tuple[int, int, int, np.ndarray]] = []
        self._tie = itertools.count()

    def push(self, keys: np.ndarray, start: int, end: int) -> None:
        heapq.heappush(self._heap, (start, next(self._tie), end, keys))

    def pop_relevant(self, max_start: int):
        """Drain intents whose start clock is <= max_start (reference
        getNewRelevantIntents, coloc_kv_worker.h:684-708)."""
        out = []
        while self._heap and self._heap[0][0] <= max_start:
            start, _, end, keys = heapq.heappop(self._heap)
            out.append((keys, start, end))
        return out

    def __len__(self) -> int:
        return len(self._heap)

    def next_start(self) -> Optional[int]:
        return self._heap[0][0] if self._heap else None


class ActionTimer:
    """Estimates, per worker, how many clocks it will advance during the next
    `rounds_lookahead` sync rounds, so the planner registers intents
    just-in-time instead of eagerly (reference sync_manager.h:62-158).

    window(w) = quantile_q( Poisson(rate_w * lookahead_time) ), with the
    Poisson quantile approximated as mean + z_q * sqrt(mean) (normal approx).
    Rates and round duration are exponentially smoothed with alpha.
    """

    def __init__(self, num_workers: int, alpha: float = 0.1,
                 quantile: float = 0.9999, rounds_lookahead: float = 2.0,
                 enabled: bool = True):
        self.enabled = enabled
        self.alpha = alpha
        self.rounds_lookahead = rounds_lookahead
        # z for the standard normal quantile (Acklam-free: fixed table entry
        # for the default 0.9999; otherwise a rational approximation)
        self.z = _norm_quantile(quantile)
        self._rate = np.zeros(num_workers)          # clocks per second
        self._last_clock = np.zeros(num_workers, dtype=np.int64)
        self._last_time: Optional[float] = None
        self._round_secs = 0.01

    def observe(self, clocks: np.ndarray, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if self._last_time is not None:
            dt = max(now - self._last_time, 1e-6)
            inst = (clocks - self._last_clock) / dt
            self._rate += self.alpha * (inst - self._rate)
            self._round_secs += self.alpha * (dt - self._round_secs)
        self._last_time = now
        self._last_clock = clocks.copy()

    def window(self) -> np.ndarray:
        """Per-worker clock window: intents starting within
        [clock, clock+window] should be acted on now."""
        if not self.enabled:
            return np.full_like(self._last_clock, CLOCK_MAX)
        mean = np.maximum(
            self._rate * self._round_secs * self.rounds_lookahead, 1.0)
        w = np.ceil(mean + self.z * np.sqrt(mean)).astype(np.int64)
        return np.maximum(w, 1)


class PlanCache:
    """Routing-plan cache for the hot Pull/Push path.

    Keyed by (kind, shard, fingerprint-of-keys) and guarded by the
    server's `topology_version`: a plan is a pure function of the key
    batch and the addressbook tables, and every table mutation bumps the
    version as the last step of its critical section
    (Server._topology_mutation), so version-match == plan-valid — the
    same revalidation contract optimistic routing already relies on. The
    fingerprint is a content hash of the key bytes; the stored key array
    is compared exactly on lookup, so a hash collision degrades to a
    cache miss, never to a wrong plan.

    Every training loop replays the same batch *arrays* on two paths:
    the prefetch pipeline plans a batch at intent time and `pull` replans
    it at consume time (or after a write invalidated the staged values —
    writes invalidate staged VALUE buffers, not plans), and benches/test
    harnesses rotate a fixed batch set. Both skip `_plan_pull`/
    `_plan_push` entirely on a hit.

    Thread-safe: the prefetch thread and worker threads share it.

    Hit/miss/stale accounting lives in the metrics registry when one is
    passed (`plan_cache.*`; docs/OBSERVABILITY.md) — the `hits`/
    `misses`/`stale` attributes remain as read-only views so the
    pre-registry accessors keep working.
    """

    def __init__(self, max_entries: int = 64, registry=None):
        from ..obs.metrics import Counter
        self.max_entries = max_entries
        # (kind, shard, fp) -> (keys, topology_version, plan); insertion
        # order doubles as the LRU order
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()
        use_reg = registry is not None and registry.enabled
        mk = (lambda n: registry.counter(f"plan_cache.{n}")) if use_reg \
            else (lambda n: Counter(f"plan_cache.{n}"))
        self._c_hits = mk("hits")
        self._c_misses = mk("misses")
        self._c_stale = mk("stale")
        if use_reg:
            registry.gauge("plan_cache.entries",
                           fn=lambda: len(self._entries))

    @property
    def hits(self) -> int:
        return int(self._c_hits.value)

    @property
    def misses(self) -> int:
        return int(self._c_misses.value)

    @property
    def stale(self) -> int:
        return int(self._c_stale.value)

    @staticmethod
    def fingerprint(keys: np.ndarray) -> int:
        # siphash over the raw bytes; collisions are caught by the exact
        # compare in get()
        return hash(keys.tobytes())

    def get(self, kind: str, shard: int, keys: np.ndarray, version: int):
        if self.max_entries <= 0:
            return None
        k = (kind, shard, self.fingerprint(keys))
        with self._lock:
            ent = self._entries.get(k)
            if ent is None:
                self._c_misses.inc()
                return None
            k0, v0, plan = ent
            if v0 != version:
                self._c_stale.inc()
                del self._entries[k]
                return None
            if k0.shape != keys.shape or not np.array_equal(k0, keys):
                self._c_misses.inc()  # fingerprint collision: as a miss
                return None
            self._c_hits.inc()
            self._entries.move_to_end(k)
            return plan

    def put(self, kind: str, shard: int, keys: np.ndarray, version: int,
            plan) -> None:
        if self.max_entries <= 0:
            return
        k = (kind, shard, self.fingerprint(keys))
        with self._lock:
            self._entries[k] = (keys.copy(), version, plan)
            self._entries.move_to_end(k)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            n = len(self._entries)
        return {"entries": n, "hits": self.hits,
                "misses": self.misses, "stale": self.stale}


def _norm_quantile(q: float) -> float:
    """Standard normal quantile via Beasley-Springer/Moro approximation."""
    if q == 0.9999:
        return 3.719
    # Moro's approximation (sufficient accuracy for a planning heuristic)
    a = [2.50662823884, -18.61500062529, 41.39119773534, -25.44106049637]
    b = [-8.47351093090, 23.08336743743, -21.06224101826, 3.13082909833]
    c = [0.3374754822726147, 0.9761690190917186, 0.1607979714918209,
         0.0276438810333863, 0.0038405729373609, 0.0003951896511919,
         0.0000321767881768, 0.0000002888167364, 0.0000003960315187]
    y = q - 0.5
    if abs(y) < 0.42:
        r = y * y
        num = y * (((a[3] * r + a[2]) * r + a[1]) * r + a[0])
        den = (((b[3] * r + b[2]) * r + b[1]) * r + b[0]) * r + 1.0
        return num / den
    r = q if y > 0 else 1.0 - q
    s = math.log(-math.log(1.0 - r))
    t = c[0]
    for i in range(1, 9):
        t += c[i] * s**i
    return t if y > 0 else -t
