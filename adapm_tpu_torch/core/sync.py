"""The adaptive management planner: SyncManager.

Reference: one SyncManager thread per channel (sync_manager.h:452-520) drains
worker intent queues, materializes replicas, extracts/ships deltas, and — on
the owner side — decides per key whether to *relocate* the main copy to the
requesting node or *replicate* it there (sync_manager.h:553-739, decision at
:624-644: relocate iff no other node and no local worker has intent).

This is the JAX package's `core/sync.py` for one process: a host-side
loop driving the store programs (device/torchport.py). A "sync round"
for a channel is one program per length class (delta extract -> ordered
owner merge -> fresh-value refresh). Channels partition keys by the
Knuth multiplicative hash (reference handle.h:1016-1029). The
cross-process exchange, collective cadence and compressed rounds are not
ported (ROADMAP queue A, item 11; queue B, B8 and B10).
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from ..base import CLOCK_MAX, NO_SLOT, MgmtTechniques
from .intent import ActionTimer

KNUTH = np.uint64(2654435761)


def key_channel(keys: np.ndarray, num_channels: int) -> np.ndarray:
    """Key -> channel via Knuth multiplicative hash (handle.h:1016-1029).

    The HIGH half of the 32-bit product picks the channel: KNUTH is odd,
    so the product's low bits are just a permutation of the key's low
    bits — `h % 2^m` would degenerate to `key % 2^m`, perfectly
    correlated with the home-process layout (key % (S*P)), and one
    process's keys would all share a channel (observed in dcn_bench:
    chan_rounds == 1 at P = 4)."""
    h = (keys.astype(np.uint64) * KNUTH) & np.uint64(0xFFFFFFFF)
    return ((h >> np.uint64(16)) % np.uint64(num_channels)).astype(
        np.int32)


class ReplicaTable:
    """One channel's live-replica set as a numpy structure-of-arrays.

    Replaces the `set[(key, shard)]` the planner used to walk with
    per-key Python: parallel `keys` (int64) / `shards` (int32) columns,
    a `live` mask, and a LIFO free-list of dead rows — every operation
    (add / remove / contains / snapshot) is O(batch) vectorized.

    Membership is one fancy-indexed read of a `(num_shards, num_keys)`
    int32 row-lookup table. The lookup may be SHARED across the channel
    tables of one SyncManager: a (key, shard) pair lives in exactly one
    channel (channel = hash(key)), so one table serves all channels
    without collisions — and int32 at S x K matches the `intent_end`
    footprint decision above. Lookup entries are validated against the
    stored key/shard columns on every read, so a stale or foreign row
    id degrades to "absent", never to a wrong entry.

    Not internally locked: callers mutate under the server lock (the
    same discipline the replica sets had).
    """

    GROW_MIN = 1024

    def __init__(self, num_shards: int, num_keys: int,
                 row_lookup: Optional[np.ndarray] = None):
        self.num_shards = num_shards
        self.num_keys = num_keys
        self._row = row_lookup if row_lookup is not None else \
            np.full((num_shards, num_keys), -1, dtype=np.int32)
        cap = self.GROW_MIN
        self.keys = np.zeros(cap, dtype=np.int64)
        self.shards = np.zeros(cap, dtype=np.int32)
        self.live = np.zeros(cap, dtype=bool)
        self._free = np.empty(cap, dtype=np.int32)
        self._n_free = 0
        self._top = 0       # rows [0, _top) have been handed out
        self._size = 0

    def __len__(self) -> int:
        return self._size

    @staticmethod
    def _as_pair(keys, shards) -> Tuple[np.ndarray, np.ndarray]:
        keys = np.ascontiguousarray(keys, dtype=np.int64).ravel()
        if np.ndim(shards) == 0:
            shards = np.full(len(keys), int(shards), dtype=np.int32)
        else:
            shards = np.ascontiguousarray(shards, dtype=np.int32).ravel()
        return keys, shards

    def _valid_rows(self, rows: np.ndarray, keys: np.ndarray,
                    shards: np.ndarray) -> np.ndarray:
        """True where the lookup row really is (key, shard) in THIS
        table (bounds + column match — see class docstring)."""
        out = np.zeros(len(rows), dtype=bool)
        idx = np.nonzero((rows >= 0) & (rows < self._top))[0]
        if len(idx):
            r = rows[idx]
            out[idx] = (self.live[r] & (self.keys[r] == keys[idx])
                        & (self.shards[r] == shards[idx]))
        return out

    def _grow_cols(self, need: int) -> None:
        cap = len(self.keys)
        while cap < need:
            cap *= 2
        if cap == len(self.keys):
            return
        for name in ("keys", "shards", "live"):
            old = getattr(self, name)
            new = np.zeros(cap, dtype=old.dtype)
            new[: len(old)] = old
            setattr(self, name, new)

    def add(self, keys, shards) -> int:
        """Insert (key, shard) pairs; already-present and intra-batch
        duplicate pairs are ignored. Returns the number inserted."""
        keys, shards = self._as_pair(keys, shards)
        if len(keys) == 0:
            return 0
        fresh = ~self._valid_rows(self._row[shards, keys], keys, shards)
        k, s = keys[fresh], shards[fresh]
        if len(k) == 0:
            return 0
        # intra-batch dedup (first occurrence wins)
        _, first = np.unique(k * np.int64(self.num_shards) + s,
                             return_index=True)
        k, s = k[first], s[first]
        n = len(k)
        rows = np.empty(n, dtype=np.int64)
        take = min(n, self._n_free)
        if take:
            rows[:take] = self._free[self._n_free - take: self._n_free]
            self._n_free -= take
        if n - take:
            self._grow_cols(self._top + (n - take))
            rows[take:] = np.arange(self._top, self._top + (n - take))
            self._top += n - take
        self.keys[rows] = k
        self.shards[rows] = s
        self.live[rows] = True
        self._row[s, k] = rows
        self._size += n
        return n

    def remove(self, keys, shards) -> int:
        """Remove (key, shard) pairs; absent pairs are ignored. Returns
        the number removed."""
        keys, shards = self._as_pair(keys, shards)
        if len(keys) == 0 or self._size == 0:
            return 0
        rows = self._row[shards, keys]
        rows = np.unique(rows[self._valid_rows(rows, keys, shards)])
        n = len(rows)
        if n == 0:
            return 0
        self.live[rows] = False
        self._row[self.shards[rows], self.keys[rows]] = -1
        if self._n_free + n > len(self._free):
            cap = len(self._free)
            while cap < self._n_free + n:
                cap *= 2
            new = np.empty(cap, dtype=np.int32)
            new[: self._n_free] = self._free[: self._n_free]
            self._free = new
        self._free[self._n_free: self._n_free + n] = rows
        self._n_free += n
        self._size -= n
        return n

    def contains(self, keys, shards) -> np.ndarray:
        keys, shards = self._as_pair(keys, shards)
        return self._valid_rows(self._row[shards, keys], keys, shards)

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """Copies of the live (keys, shards) columns (safe to use after
        the caller releases whatever lock guarded the mutation)."""
        rows = np.nonzero(self.live[: self._top])[0]
        return self.keys[rows], self.shards[rows]


class SyncStats:
    """Planner counters. EVERY bump goes through the locked `add()`
    helper: rounds run concurrently (per-channel threads, the prefetch
    pipeline, DCN handlers) and `int +=` is not atomic, so an unlocked
    bump can lose a count."""

    FIELDS = ("rounds", "replicas_created", "replicas_dropped",
              "relocations", "keys_synced", "keys_considered",
              "intents_processed")

    def __init__(self):
        import threading
        self.lock = threading.Lock()
        # keys_considered: replicas examined by sync rounds (intent-live,
        # keep-partition); keys_synced: replicas actually SHIPPED to a
        # sync program after the dirty-delta filter. With sync_threshold
        # > 0 the final ship/hold decision is on device, so held-back
        # small-delta replicas still count as synced here (an exact
        # on-device count would cost a readback per round).
        for f in self.FIELDS:
            setattr(self, f, 0)

    def add(self, **deltas) -> None:
        with self.lock:
            for name, n in deltas.items():
                setattr(self, name, getattr(self, name) + n)


class SyncManager:
    """Plans and executes replication/relocation/sync for one Server."""

    def __init__(self, server, opts):
        self.server = server
        self.opts = opts
        self.effective_max_per_sec = float(opts.sync_max_per_sec)
        self.num_channels = opts.channels
        S = server.num_shards
        K = server.num_keys
        # per-shard registered intent horizon: max end clock of any active
        # intent by a worker on that shard (reference Parameter.local_intents
        # per customer, handle.h:122-152, aggregated to the node level)
        self.intent_end = np.full((S, K), -1, dtype=np.int32)
        # live replicas, partitioned by channel: one ReplicaTable per
        # channel sharing a single (S, K) row-lookup (a key belongs to
        # exactly one channel). Mutated under the server lock.
        self._replica_row = np.full((S, K), -1, dtype=np.int32)
        self.replicas: List[ReplicaTable] = [
            ReplicaTable(S, K, row_lookup=self._replica_row)
            for _ in range(self.num_channels)]
        self.timer = ActionTimer(
            server.max_workers, alpha=opts.timing_alpha,
            quantile=opts.timing_quantile,
            rounds_lookahead=opts.timing_rounds_lookahead,
            enabled=opts.time_intent_actions)
        self.stats = SyncStats()
        reg = server.obs
        self._h_round = reg.histogram("sync.round_s")
        self._h_staleness = reg.histogram(
            "sync.replica_staleness_clocks", unit="clocks",
            bounds=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
        if reg.enabled:
            for name in SyncStats.FIELDS:
                reg.gauge(f"sync.{name}",
                          fn=lambda n=name: getattr(self.stats, n))
            reg.gauge("sync.keys_shipped",
                      fn=lambda: self.stats.keys_synced)
            reg.gauge("sync.replicas_live",
                      fn=lambda: sum(len(t) for t in self.replicas))
        # per-channel min-active-clock at the channel's last sync round
        # (-1 = never synced yet); feeds _h_staleness
        self._chan_last_clock = np.full(self.num_channels, -1,
                                        dtype=np.int64)
        self._next_channel = 0
        self._last_round_t = 0.0

    # ------------------------------------------------------------------
    # intent registration + replicate-vs-relocate decision
    # ------------------------------------------------------------------

    def drain_intents(self, force: bool = False) -> None:
        """Drain worker intent queues for intents starting within the
        ActionTimer window (reference registerNewIntents,
        sync_manager.h:257-286); force=True drains everything (WaitSync)."""
        with self.server._span("sync.drain_intents"):
            clocks = self.server.worker_clocks()
            self.timer.observe(clocks)
            window = self.timer.window()
            for w in self.server.workers():
                max_start = CLOCK_MAX if force else int(
                    clocks[w.worker_id] + window[w.worker_id])
                for keys, start, end in \
                        w._intent_queue.pop_relevant(max_start):
                    # actions apply per intent entry: a later intent in
                    # the same drain must observe placement changes made
                    # by earlier ones
                    relocate_keys, replicate_keys = self._register(
                        w.shard, keys, end)
                    self.stats.add(intents_processed=len(keys))
                    if len(relocate_keys):
                        self.stats.add(relocations=self.server._relocate_to(
                            relocate_keys, w.shard))
                    if len(replicate_keys):
                        created = self.server._create_replicas(
                            replicate_keys, w.shard)
                        with self.server._lock:
                            self.replica_add(created, w.shard)
                        self.stats.add(replicas_created=len(created))

    # ------------------------------------------------------------------
    # replica registry (the channel tables; callers hold the server lock)
    # ------------------------------------------------------------------

    def _replica_op(self, keys: np.ndarray, shards, op: str) -> None:
        if len(keys) == 0:
            return
        keys = np.ascontiguousarray(keys, dtype=np.int64).ravel()
        chans = key_channel(keys, self.num_channels)
        sarr = None if np.ndim(shards) == 0 else \
            np.asarray(shards, dtype=np.int32).ravel()
        for c in np.unique(chans):
            m = chans == c
            getattr(self.replicas[c], op)(
                keys[m], shards if sarr is None else sarr[m])

    def replica_add(self, keys: np.ndarray, shards) -> None:
        self._replica_op(keys, shards, "add")

    def replica_discard(self, keys: np.ndarray, shards) -> None:
        self._replica_op(keys, shards, "remove")

    def replica_clear(self) -> None:
        S, K = self.intent_end.shape
        self._replica_row.fill(-1)
        self.replicas = [ReplicaTable(S, K, row_lookup=self._replica_row)
                         for _ in range(self.num_channels)]

    def _register(self, shard: int, keys: np.ndarray,
                  end: int) -> Tuple[np.ndarray, np.ndarray]:
        """Register an intent batch; returns (keys to relocate to `shard`,
        keys to replicate onto `shard`). Vectorized; capacity degradation
        is handled downstream (_relocate demotes to replication,
        _create_replicas truncates)."""
        ie = self.intent_end
        from ..base import check_key_range
        check_key_range(keys, self.server.num_keys, "intent key")
        if self.server._native is not None:
            self.server._native.adapm_intent_max(
                np.ascontiguousarray(keys, np.int64), len(keys),
                self.server.num_keys, int(end), ie[shard])
        else:
            np.maximum.at(ie[shard], keys, np.int32(min(end, 2**31 - 1)))
        if self.server.tracer is not None:
            from ..utils.stats import INTENT_START
            self.server.tracer.record(keys, INTENT_START, shard)
        cand = keys[~self.server.ab.is_local(keys, shard)]
        if len(cand) == 0:
            e = np.empty(0, dtype=np.int64)
            return e, e
        relocate = self._decide_batch(cand, shard)
        return cand[relocate], cand[~relocate]

    def _decide_batch(self, keys: np.ndarray, shard: int) -> np.ndarray:
        """Relocate vs replicate (reference sync_manager.h:624-644): relocate
        iff no *other* shard currently has interest in any of the keys (an
        active intent or a replica) — otherwise replicate. Returns a bool
        mask (True = relocate)."""
        t = self.opts.techniques
        if t == MgmtTechniques.REPLICATION_ONLY:
            return np.zeros(len(keys), dtype=bool)
        if t == MgmtTechniques.RELOCATION_ONLY:
            return np.ones(len(keys), dtype=bool)
        ab = self.server.ab
        clocks = self.server.shard_min_clocks()
        other_interest = np.zeros(len(keys), dtype=bool)
        for s in range(self.server.num_shards):
            if s == shard:
                continue
            other_interest |= (ab.cache_slot[s, keys] != NO_SLOT) | \
                (self.intent_end[s, keys] >= clocks[s])
        return ~other_interest

    # ------------------------------------------------------------------
    # sync rounds
    # ------------------------------------------------------------------

    def sync_channel(self, channel: int) -> None:
        """Refresh replicas with active intent; flush+drop expired ones
        (reference readAndPotentiallyDropReplica, handle.h:601-662). The
        server lock brackets only the table snapshot here and the
        revalidation + enqueue inside `_sync_replicas`/`_drop_replicas`."""
        srv = self.server
        table = self.replicas[channel]
        mc = self._min_active_clock()
        if mc is not None:
            last = int(self._chan_last_clock[channel])
            self._chan_last_clock[channel] = mc
            if 0 <= last <= mc and len(table):
                self._h_staleness.observe(float(mc - last))
        with srv._lock:
            if len(table) == 0:
                return
            keys, shards = table.snapshot()
        min_clocks = srv.shard_min_clocks()
        keep, drop = self._scan_partition(keys, shards, min_clocks)
        self.stats.add(keys_considered=len(keep))
        if len(keep):
            kk, ks = keys[keep], shards[keep]
            if self.opts.sync_dirty_only:
                # dirty-delta filter: a clean replica's sync program is a
                # bit-for-bit no-op, so skipping it cannot change a read;
                # a dirty replica's siblings ride along to pick up the
                # post-merge value
                dirty = srv._dirty_replica_mask(kk, ks)
                if dirty.any() and not dirty.all():
                    dirty |= np.isin(kk, kk[dirty])
                kk, ks = kk[dirty], ks[dirty]
            if len(kk):
                srv._sync_replicas(kk, ks,
                                   threshold=self.opts.sync_threshold)
                self.stats.add(keys_synced=len(kk))
        if len(drop):
            dk, ds = keys[drop], shards[drop]
            if srv.tracer is not None:
                from ..utils.stats import INTENT_STOP
                for s in np.unique(ds):
                    srv.tracer.record(dk[ds == s], INTENT_STOP, int(s))
            srv._drop_replicas(dk, ds)
            with srv._lock:
                self.replica_discard(dk, ds)
            self.stats.add(replicas_dropped=len(dk))

    def _scan_partition(self, keys: np.ndarray, shards: np.ndarray,
                        min_clocks: np.ndarray):
        """(keep, drop) index arrays of one channel snapshot: keep iff the
        holder shard's intent horizon is still active. One native pass or
        its vectorized numpy equivalent."""
        srv = self.server
        if srv._native is not None:
            from ..native import replica_scan_partition
            keep, _, drop, _ = replica_scan_partition(
                srv._native, keys, shards, self.intent_end,
                np.ascontiguousarray(min_clocks, np.int64),
                srv.num_keys, None)
            return keep, drop
        keep = self.intent_end[shards, keys] >= min_clocks[shards]
        return np.nonzero(keep)[0], np.nonzero(~keep)[0]

    def run_round(self, force_intents: bool = False,
                  all_channels: bool = False) -> None:
        # self-serializing (the round lock is reentrant)
        with self.server._round_lock:
            self._throttle()
            if self.server._in_setup and not force_intents:
                # BeginSetup/EndSetup bracket: management is paused
                return
            from ..obs.metrics import timed
            with timed(self._h_round), self.server._span("sync.round"):
                self.drain_intents(force=force_intents)
                if all_channels:
                    for c in range(self.num_channels):
                        self.sync_channel(c)
                else:
                    self.sync_channel(self._next_channel)
                    self._next_channel = \
                        (self._next_channel + 1) % self.num_channels
                self.stats.add(rounds=1)

    def close(self) -> None:
        pass

    def _min_active_clock(self):
        """Min clock over the registered, unfinished workers; None when no
        worker is active."""
        from ..base import WORKER_FINISHED
        srv = self.server
        clocks = [int(srv._clocks[wid]) for wid in list(srv._workers)
                  if srv._clocks[wid] != WORKER_FINISHED]
        return min(clocks) if clocks else None

    def _throttle(self) -> None:
        """Bound sync frequency (reference sync_manager.h:384-411, 805-814:
        --sys.sync.max_per_sec / --sys.sync.pause)."""
        if self.opts.sync_pause_ms > 0:
            time.sleep(self.opts.sync_pause_ms / 1e3)
            return
        if self.effective_max_per_sec <= 0:
            return
        min_gap = 1.0 / self.effective_max_per_sec
        now = time.monotonic()
        wait = self._last_round_t + min_gap - now
        if wait > 0:
            time.sleep(wait)
        self._last_round_t = time.monotonic()

    # ------------------------------------------------------------------

    def quiesce(self) -> None:
        """Force-process all intents and flush every pending delta; after
        this all reads observe identical values (reference
        test_many_key_operations.cc:375-385)."""
        srv = self.server
        with srv._round_lock:
            self.drain_intents(force=True)
            for c in range(self.num_channels):
                with srv._lock:
                    if len(self.replicas[c]) == 0:
                        continue
                    keys, shards = self.replicas[c].snapshot()
                # unconditional flush: quiesce bypasses the dirty filter
                # and the threshold so no pending delta is ever lost
                srv._sync_replicas(keys, shards)
                self.stats.add(keys_synced=len(keys),
                               keys_considered=len(keys))
            srv.block()

    def report(self) -> str:
        s = self.stats
        return (f"sync: rounds={s.rounds} intents={s.intents_processed} "
                f"replicas+={s.replicas_created} -={s.replicas_dropped} "
                f"relocations={s.relocations} "
                f"keys_shipped={s.keys_synced}/"
                f"considered={s.keys_considered}")
