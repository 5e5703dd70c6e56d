"""Intent queues, logical clocks, the ActionTimer, the plan cache and
the intent-driven prefetch pipeline.

Reference: ColoKVWorker::Intent pushes FutureIntent{start,end,keys} into
per-channel queues drained by the sync managers
(coloc_kv_worker.h:380-408, 723-744); ActionTimer estimates how many clocks a
worker will advance in ~2 sync rounds so intents are acted on just-in-time
(sync_manager.h:62-158). This is the JAX package's `core/intent.py`;
PrefetchScheduler's device work writes torch tensors from executor
threads, and its class docstring says how that stays ordered.
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


class _StagingAbort(Exception):
    """Internal: a staging attempt hit its pool budget (not an error)."""


class _StagedPull:
    """One pre-gathered pull batch: the device value buffers plus the
    bookkeeping to decide, at consume time, whether they are still the
    values a fresh pull would return."""

    __slots__ = ("keys", "fp", "version", "groups", "n_remote",
                 "worker_id", "end", "acquired")

    def __init__(self, keys, fp, version, groups, n_remote, worker_id,
                 end, acquired):
        self.keys = keys            # the intended (unique, sorted) batch
        self.fp = fp
        self.version = version      # topology_version at gather time
        self.groups = groups        # Server._pull-shaped per-class groups
        self.n_remote = n_remote
        self.worker_id = worker_id
        self.end = end              # intent end clock (expiry)
        self.acquired = acquired    # [(StagingPool, rows)] to release


class PrefetchScheduler:
    """Intent-driven prefetch pipeline: the declared-intent lookahead of
    the reference (coloc_kv_worker.h Intent -> sync-manager action),
    extended to stage the data plane ahead of the access.

    Coalesced, self-rescheduling programs on the executor's `prefetch`
    stream consume `Worker.intent` declarations and, for intents whose
    start clock falls inside the ActionTimer window:

      1. drive planner rounds delegated via `pump()` — the per-step
         `sync.run_round` moves off the training thread;
      2. refresh registered device-side consumers (DeviceRouter table
         mirrors, local sampling indexes — `register_refresher`) as soon
         as the topology settles;
      3. pre-gather intended pull batches into staged device buffers
         (ShardedStore.stage_gather, K1) so `Worker.pull` of an intended
         batch is a staged-buffer hit: no planning, no server lock, no
         dispatch on the consuming thread.

    Consistency: a staged batch records the `topology_version` it was
    gathered under; any topology mutation invalidates it lazily at take
    time. Value writes are tracked eagerly: every server-side write path
    calls `note_writes(keys)` under the server lock, and staged batches
    intersecting the written keys are dropped and re-staged in the
    background — a pull never observes a staged buffer gathered before
    an overlapping write, and a staged hit is bit-identical to the pull
    it replaced.

    Device ordering (the port's part): every device enqueue of these
    programs — a delegated round's K3/K1/masked sets, a router refresh's
    copies, a staging gather — happens under the server lock and the
    process-wide dispatch gate, on the thread's current CUDA stream,
    which for executor threads and the training thread alike is the
    device's default stream. So all of it is stream-ordered with the
    training steps; a staged buffer is allocated and read on that one
    stream, and the caching allocator cannot hand its rows out again
    before the pull has read them. The one side stream, a graph
    window's first run (ops/fused.py `_graph_window`), is entered and
    left with the gate held, so nothing of this pipeline is enqueued
    while it runs.

    Pull staging is gated by `opts.prefetch_pull`: "auto" stages only
    for workers that use the Pull API (fused-runner loops never pull),
    "always"/"off" force it. Staged-buffer memory is bounded by a
    per-class StagingPool (opts.prefetch_staging_rows) and
    opts.prefetch_max_batches per worker. A pass that raises is logged,
    counted in `failures` and the pipeline stays up (the JAX
    package's behavior); callers that must not hide one read it.
    """

    def __init__(self, server, opts):
        self.server = server
        self.opts = opts
        self._cond = threading.Condition()
        self._stop = False
        self._busy = False
        self._rounds = 0            # delegated planner rounds (capped)
        self._sweep = False         # explicit expiry/deferred sweep request
        self._pending: List[tuple] = []   # (worker, keys, start, end)
        self._deferred: List[tuple] = []  # beyond the ActionTimer window
        self._restage: List[tuple] = []   # invalidated, still in window
        # staged entries + an O(1)-per-key membership mask for the write
        # intersection test (allocated lazily: it is num_keys ints)
        self._plock = threading.Lock()
        self._staged: Dict[tuple, _StagedPull] = {}
        self._mask: Optional[np.ndarray] = None
        self._refreshers: List = []
        self.failures = 0           # passes that raised (logged)
        # host wall seconds of the passes on their thread (waits for the
        # server lock and the interpreter lock included), and their count
        self.pass_s = 0.0
        self.passes = 0
        from .store import StagingPool
        self.pools = [StagingPool(opts.prefetch_staging_rows)
                      for _ in server.stores]
        from ..obs.metrics import CounterGroup
        reg = server.obs
        self.stats = CounterGroup(reg, "prefetch", (
            "staged", "hits", "expired", "invalidated_write",
            "invalidated_topology", "restaged", "rounds_driven",
            "pool_full", "evicted"))
        if reg.enabled:
            reg.gauge("prefetch.live", fn=lambda: len(self._staged))
            reg.gauge("staging.rows_in_use",
                      fn=lambda: sum(p.rows_in_use for p in self.pools))
            reg.gauge("staging.rows_hwm",
                      fn=lambda: max((p.rows_hwm for p in self.pools),
                                     default=0))
            reg.gauge("staging.rows_budget",
                      fn=lambda: sum(p.max_rows for p in self.pools))

    # -- producer side (training threads) -----------------------------------

    def on_intent(self, worker, keys: np.ndarray, start: int,
                  end: int) -> None:
        """Called by Worker.intent (keys already unique+sorted). Queues
        the batch for background staging; placement actions themselves
        stay with the planner rounds (inline or delegated via pump)."""
        if not self._should_stage(worker):
            return
        with self._cond:
            self._pending.append((worker, keys, start, end))
            # bound the backlog: a producer outrunning the stager keeps
            # only the freshest window of batches
            limit = 2 * max(1, self.opts.prefetch_max_batches)
            if len(self._pending) > limit:
                del self._pending[: len(self._pending) - limit]
            self._kick_locked()

    def pump(self, rounds: int = 1) -> None:
        """Delegate `rounds` planner rounds to the pipeline (the apps'
        per-step `run_round` slot). Backlogged rounds coalesce: each
        round drains ALL window-eligible intents, so when the training
        thread outruns the planner, coalesced rounds batch the same
        planner work into fewer, larger drains. The backlog is bounded
        at the largest pending request (floor 2)."""
        with self._cond:
            self._rounds = min(self._rounds + rounds,
                               max(self._rounds, rounds, 2))
            self._sweep = True  # pump(0) = expiry/deferred sweep only
            self._kick_locked()

    def register_refresher(self, fn) -> None:
        """Register a callable refreshed by the pipeline after planner
        rounds (called under the server lock): device table mirrors,
        local sampling indexes. Idempotent callables only. Bound methods
        are held weakly: a runner that goes away stops being refreshed."""
        import weakref
        try:
            ref = weakref.WeakMethod(fn)
        except TypeError:
            def ref(f=fn):  # plain function: keep a strong reference
                return f
        self._refreshers.append(ref)

    # -- consumer side (Worker.pull fast path) ------------------------------

    def take_staged(self, worker, keys: np.ndarray) -> Optional[_StagedPull]:
        """Pop a valid staged batch for `keys`, or None. Takes no server
        lock — this is the fast path."""
        if not self._staged:
            return None
        with self.server._span("prefetch.take"):
            return self._take_staged_impl(worker, keys)

    def _take_staged_impl(self, worker,
                          keys: np.ndarray) -> Optional[_StagedPull]:
        fp = PlanCache.fingerprint(keys)
        with self._plock:
            e = self._staged.pop((worker.worker_id, fp), None)
            if e is None:
                return None
            self._mask_sub(e.keys)
            self._release(e)
        if e.keys.shape != keys.shape or not np.array_equal(e.keys, keys):
            return None  # fingerprint collision
        if e.version != self.server.topology_version:
            # placement moved since the gather (a relocation may fold a
            # stale replica base into the moved row): not trusted
            self.stats.inc("invalidated_topology")
            return None
        self.stats.inc("hits")
        return e

    # -- invalidation (server write paths; caller holds the server lock) ----

    def note_writes(self, keys: np.ndarray) -> None:
        """Drop (and queue for re-staging) staged batches intersecting
        `keys`. Called from every value-write path before the write
        could be observed missing: push/set scatter, replica sync
        refreshes, fused steps."""
        if not self._staged or self._mask is None:
            return
        restage = []
        with self._plock:
            if not self._staged:
                return
            flat = keys.reshape(-1)
            if not self._mask[flat].any():
                return
            for k, e in list(self._staged.items()):
                if np.isin(e.keys, flat, assume_unique=False).any():
                    del self._staged[k]
                    self._mask_sub(e.keys)
                    self._release(e)
                    self.stats.inc("invalidated_write")
                    restage.append(e)
        if restage:
            with self._cond:
                for e in restage:
                    w = self.server._workers.get(e.worker_id)
                    if w is not None and e.end >= w.current_clock:
                        self._restage.append((w, e.keys, 0, e.end))
                self._kick_locked()

    def note_step_writes(self, key_batches, sampled: bool = False) -> None:
        """A fused training step is a batched Push (caller holds the
        server lock): drop the staged batches its keys intersect, or
        every staged batch when the step draws negatives on the device
        (`sampled`: those keys are not enumerable on the host)."""
        if not self._staged:
            return
        if sampled:
            self.invalidate_all()
            return
        self.note_writes(np.concatenate(
            [np.asarray(k, dtype=np.int64).ravel() for k in key_batches]))

    def invalidate_all(self) -> None:
        with self._plock:
            for e in self._staged.values():
                self._mask_sub(e.keys)
                self._release(e)
            self._staged.clear()

    # -- lifecycle -----------------------------------------------------------

    def flush(self, timeout: float = 60.0) -> None:
        """Block until the pipeline is idle (tests / quiesce)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while (self._busy or self._rounds or self._pending
                   or self._restage or self._sweep):
                if not self._cond.wait(timeout=min(
                        0.5, max(0.0, deadline - time.monotonic()))):
                    if time.monotonic() >= deadline:
                        raise TimeoutError("prefetch pipeline flush")

    def close(self) -> None:
        """Idempotent: stop accepting work, drain in-flight passes off
        the `prefetch` stream (a queued pass observes `_stop` and
        returns immediately), release every staged buffer."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        ex = self.server.exec
        if not ex.closed and not ex.drain("prefetch", timeout=30):
            from ..utils import alog
            alog("[prefetch] pipeline failed to drain within 30s of "
                 "close — a staging pass is wedged mid-dispatch")
        self.invalidate_all()

    # -- internals -----------------------------------------------------------

    def _should_stage(self, worker) -> bool:
        mode = self.opts.prefetch_pull
        if mode == "off":
            return False
        # auto: a worker that has pulled is a Pull user
        return mode == "always" or worker.stats["pull_ops"] > 0

    def _kick_locked(self) -> None:
        """Queue one pipeline pass on the `prefetch` stream (caller
        holds _cond; the executor lock is a leaf). Coalesced: kicks
        landing while a pass is queued are absorbed — the pass swaps out
        the whole backlog when it runs. A kick during a running pass
        queues the next one."""
        if not self._stop:
            self.server.exec.submit("prefetch", self._pass,
                                    label="prefetch.pass",
                                    coalesce_key="prefetch.pass")
        self._cond.notify_all()

    def _mask_add(self, keys: np.ndarray) -> None:
        if self._mask is None:
            self._mask = np.zeros(self.server.num_keys, dtype=np.int32)
        self._mask[keys] += 1

    def _mask_sub(self, keys: np.ndarray) -> None:
        if self._mask is not None:
            self._mask[keys] -= 1

    def _release(self, e: _StagedPull) -> None:
        for pool, rows in e.acquired:
            pool.release(rows)
        e.acquired = []

    def _pass(self) -> None:
        """One pipeline pass (an executor program on the `prefetch`
        stream): swap out the whole backlog under _cond, process it,
        then reschedule only if deferred intents need the 0.25 s window
        poll (an idle pipeline owns no queued program)."""
        from ..utils import alog
        from ..base import WORKER_FINISHED
        srv = self.server
        with self._cond:
            if self._stop:
                self._cond.notify_all()
                return
            self._busy = True
            self._sweep = False
            rounds, self._rounds = self._rounds, 0
            pending, self._pending = self._pending, []
            restage, self._restage = self._restage, []
        t0 = time.perf_counter()
        try:
            for _ in range(rounds):
                srv.sync.run_round()
                self.stats.inc("rounds_driven")
            if rounds:
                self._refresh_consumers()
            self._expire()
            now_deferred = []
            for item in self._deferred + pending:
                w, keys, start, end = item
                # a finalized worker never pulls again: its parked
                # intents must not keep the deferred poll alive
                if end < w.current_clock or \
                        w.current_clock == WORKER_FINISHED:
                    self.stats.inc("expired")
                    continue
                window = int(srv.sync.timer.window()[w.worker_id])
                if start > w.current_clock + window:
                    now_deferred.append(item)
                    continue
                self._stage_one(w, keys, end)
            self._deferred = now_deferred
            for w, keys, _, end in restage:
                if end >= w.current_clock:
                    # record=False: the first staging already counted
                    # this batch in the locality stats
                    if self._stage_one(w, keys, end, record=False):
                        self.stats.inc("restaged")
        except Exception as e:  # noqa: BLE001 — keep the pipeline up
            with self._cond:
                self.failures += 1
            alog(f"[prefetch] background task failed: "
                 f"{type(e).__name__}: {e}")
        finally:
            with self._cond:
                self.pass_s += time.perf_counter() - t0
                self.passes += 1
                self._busy = False
                if self._deferred and not self._stop:
                    # deferred intents enter the window as clocks
                    # advance: keep a delayed poll queued (coalesces
                    # with — and is tightened by — any real kick)
                    self.server.exec.submit("prefetch", self._pass,
                                            label="prefetch.pass",
                                            coalesce_key="prefetch.pass",
                                            delay=0.25)
                self._cond.notify_all()

    def _refresh_consumers(self) -> None:
        if not self._refreshers:
            return
        with self.server._lock:
            live = []
            for ref in self._refreshers:
                fn = ref()
                if fn is not None:  # consumer still alive
                    fn()
                    live.append(ref)
            self._refreshers = live

    def _expire(self) -> None:
        """Drop staged batches whose intent window has passed."""
        if not self._staged:
            return
        with self._plock:
            for k, e in list(self._staged.items()):
                w = self.server._workers.get(e.worker_id)
                if w is None or e.end < w.current_clock:
                    del self._staged[k]
                    self._mask_sub(e.keys)
                    self._release(e)
                    self.stats.inc("expired")

    def _stage_one(self, worker, keys: np.ndarray, end: int,
                   record: bool = True) -> bool:
        """Plan (through the plan cache) and pre-gather one intended
        batch; True when a staged entry was recorded. `record` gates the
        locality-stats record (False on restage)."""
        if len(keys) == 0:
            return False
        with self.server._span("prefetch.stage"):
            return self._stage_one_impl(worker, keys, end, record)

    def _stage_one_impl(self, worker, keys: np.ndarray, end: int,
                        record: bool) -> bool:
        srv = self.server
        from .store import OOB
        shard = worker.shard
        tv = srv.topology_version
        rem, _, cls = srv._plan_cached(
            "pull", shard, keys, tv, lambda: srv._plan_pull(keys, shard))
        if rem is not None:
            return False  # process-remote keys: the pull path serves them
        fp = PlanCache.fingerprint(keys)
        acquired = []
        groups = []
        n_remote = 0
        with srv._lock:
            if srv.topology_version != tv:
                return False  # placement moved mid-plan: retry next round
            try:
                for cid, pos, ks, (o_sh, o_sl, c_sh, c_sl, use_c, nr,
                                   local) in cls:
                    out = srv.stores[cid].stage_gather(
                        o_sh, np.where(use_c, OOB, o_sl).astype(np.int32),
                        c_sh, c_sl, use_c, self.pools[cid])
                    if out is None:  # staging pool budget spent
                        self.stats.inc("pool_full")
                        raise _StagingAbort()
                    vals, rows = out
                    acquired.append((self.pools[cid], rows))
                    n_remote += nr
                    if record and srv.locality is not None:
                        # recorded at stage time, as _pull records per
                        # pull; restages pass record=False
                        srv.locality.record(ks.ravel(), local.ravel())
                    groups.append((cid, pos, srv.value_lengths[ks], vals,
                                   len(ks)))
            except BaseException as e:
                # release every row already accounted: a mid-loop
                # failure must not leak budget
                for pool, rows in acquired:
                    pool.release(rows)
                if isinstance(e, _StagingAbort):
                    dc = srv.decisions
                    if dc is not None:
                        # decision telemetry: staging skipped on pool
                        # pressure
                        dc.record_prefetch("skip", len(keys), self.stats)
                    return False
                raise
            entry = _StagedPull(keys, fp, srv.topology_version, groups,
                                n_remote, worker.worker_id, end, acquired)
            # register while still holding the server lock: note_writes
            # runs under it, so a write can never land between the
            # gather above and the entry becoming visible for
            # invalidation (read-your-writes)
            with self._plock:
                old = self._staged.pop((worker.worker_id, fp), None)
                if old is not None:
                    self._mask_sub(old.keys)
                    self._release(old)
                mine = [k for k in self._staged
                        if k[0] == worker.worker_id]
                while len(mine) >= max(1, self.opts.prefetch_max_batches):
                    victim = self._staged.pop(mine.pop(0))
                    self._mask_sub(victim.keys)
                    self._release(victim)
                    self.stats.inc("evicted")
                self._staged[(worker.worker_id, fp)] = entry
                self._mask_add(keys)
        self.stats.inc("staged")
        dc = srv.decisions
        if dc is not None:
            # staged: the outcome window reads the hit/expired counter
            # deltas to judge whether the staged batch was ever consumed
            dc.record_prefetch("stage", len(keys), self.stats)
        return True

    def report(self) -> Dict[str, int]:
        out = self.stats.as_dict()
        out["live"] = len(self._staged)
        return out


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
