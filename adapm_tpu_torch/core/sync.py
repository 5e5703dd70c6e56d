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
Knuth multiplicative hash (reference handle.h:1016-1029). Periodic
rounds ship in the --sys.sync.compress format (K12 sync_compress, with
the residual parked in the delta row); drop and quiesce flushes stay
exact. With tiered storage, each drained intent pins its owner rows hot
(TierManager.note_intent). Multi-process (parallel/pm.py GlobalPM): an
intent on a key another process owns asks the owner to relocate or
replicate it, and replicas of remote keys sync and drop over the node's
channel, per-channel rounds overlapping their round trips. With
--sys.collective_sync those deltas ship in the BSP collective exchange
instead (parallel/collective.py): at every WaitSync/quiesce point, and
at each --sys.collective_cadence clock boundary.
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
            # table occupancy + dirty fraction, per channel and total —
            # host arrays only, no device readback (best-effort reads,
            # without the server lock, at snapshot time)
            reg.gauge("sync.replicas_live",
                      fn=lambda: sum(len(t) for t in self.replicas))
            reg.gauge("sync.dirty_fraction",
                      fn=lambda: self._dirty_fraction(None))
            for c in range(self.num_channels):
                reg.gauge(f"sync.replicas_live.c{c}",
                          fn=lambda c=c: len(self.replicas[c]))
                reg.gauge(f"sync.dirty_fraction.c{c}",
                          fn=lambda c=c: self._dirty_fraction(c))
            # compression plane: wire bytes the most recent round shipped
            # (--sys.sync.compress format), cumulative shipped vs
            # full-width-f32 bytes, and the max-abs residual parked by
            # the last compressed round (read lazily, at snapshot time)
            reg.gauge("sync.bytes_per_round",
                      fn=lambda: self._last_round_bytes)
            reg.gauge("sync.bytes_shipped",
                      fn=lambda: sum(st.sync_bytes_shipped
                                     for st in server.stores))
            reg.gauge("sync.bytes_full_equiv",
                      fn=lambda: sum(st.sync_bytes_full
                                     for st in server.stores))
            reg.gauge("sync.ef_residual_norm",
                      fn=lambda: max((st.ef_residual_norm()
                                      for st in server.stores),
                                     default=0.0))
        # per-channel (monotonic, dirty, live) memo for the
        # dirty_fraction gauges (_dirty_counts)
        self._df_cache: dict = {}
        # lazy: the pool of concurrent all-channel rounds (multi-process)
        self._chan_exec = None
        # per-channel min-active-clock at the channel's last sync round
        # (-1 = never synced yet); feeds _h_staleness
        self._chan_last_clock = np.full(self.num_channels, -1,
                                        dtype=np.int64)
        self._next_channel = 0
        self._last_round_t = 0.0
        # wire bytes shipped by the most recent round (sync.bytes_per_round)
        self._last_round_bytes = 0
        # collective cadence state (--sys.collective_cadence K): local
        # joins of the BSP exchange are serialized (two local threads
        # entering it at once would corrupt the global exchange
        # sequence); _cad_joined counts the clock boundaries already
        # serviced since the last global sync point
        import threading
        self._coll_lock = threading.Lock()
        self._cad_joined = 0

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
                    relocate_keys, replicate_keys, remote_keys = \
                        self._register(w.shard, keys, end)
                    self.stats.add(intents_processed=len(keys))
                    if len(remote_keys):
                        # keys owned by another process: the OWNER
                        # decides relocate-vs-replicate (reference owner
                        # branch, sync_manager.h:553-739)
                        self.server.glob.intent_remote(remote_keys,
                                                       w.shard, end)
                    if len(relocate_keys):
                        self.stats.add(relocations=self.server._relocate_to(
                            relocate_keys, w.shard))
                    if len(replicate_keys):
                        created = self.server._create_replicas(
                            replicate_keys, w.shard)
                        with self.server._lock:
                            self.replica_add(created, w.shard)
                        self.stats.add(replicas_created=len(created))
                    if self.server.tier is not None:
                        # pin the intent batch's owner rows hot for the
                        # window and queue their promotion, AFTER the
                        # relocate/replicate actions so the pins land on
                        # the keys' final placement
                        self.server.tier.note_intent(keys, end)

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


    def _dirty_counts(self, channel: int) -> Tuple[int, int]:
        """(dirty, live) for one channel, memoized briefly: one
        metrics_snapshot() evaluates the total gauge AND every
        per-channel gauge, and without the memo each full-table pass
        would run twice per snapshot."""
        now = time.monotonic()
        ent = self._df_cache.get(channel)
        if ent is not None and now - ent[0] < 0.25:
            return ent[1], ent[2]
        t = self.replicas[channel]
        dirty = total = 0
        if len(t):
            keys, shards = t.snapshot()
            total = len(keys)
            if total:
                dirty = int(self.server._dirty_replica_mask(
                    keys, shards).sum())
        self._df_cache[channel] = (now, dirty, total)
        return dirty, total

    def _dirty_fraction(self, channel: Optional[int]) -> float:
        """Fraction of live replicas with unshipped writes (channel, or
        all channels for None). Best-effort lock-free gauge read."""
        chans = range(self.num_channels) if channel is None else (channel,)
        counts = [self._dirty_counts(c) for c in chans]
        total = sum(t for _, t in counts)
        return sum(d for d, _ in counts) / total if total else 0.0

    def _register(self, shard: int, keys: np.ndarray,
                  end: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Register an intent batch; returns (keys to relocate to `shard`,
        keys to replicate onto `shard`, remotely-owned keys for the
        cross-process layer). Vectorized; capacity degradation is
        handled downstream (_relocate demotes to replication,
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
        e = np.empty(0, dtype=np.int64)
        if len(cand) == 0:
            return e, e, e
        remote = e
        if self.server.glob is not None:
            rm = self.server.ab.owner[cand] < 0
            remote, cand = cand[rm], cand[~rm]
            if len(cand) == 0:
                return e, e, remote
        relocate = self._decide_batch(cand, shard)
        dc = self.server.decisions
        if dc is not None:
            # the relocate-vs-replicate split with its features;
            # replications open a window probing whether the replicas
            # were ever worth creating
            rep = cand[~relocate]
            dc.record_classify(int(shard), int(relocate.sum()),
                               len(rep), len(remote), rep)
        return cand[relocate], cand[~relocate], remote

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
        (reference readAndPotentiallyDropReplica, handle.h:601-662).
        Replicas of remotely-owned keys sync/drop over the node's channel.
        The server lock brackets only the table snapshot here and the
        revalidation + enqueue inside `_sync_replicas`/`_drop_replicas`."""
        srv = self.server
        table = self.replicas[channel]
        mc = self._min_active_clock()
        if mc is not None:
            last = int(self._chan_last_clock[channel])
            self._chan_last_clock[channel] = mc
            if 0 <= last <= mc and len(table):
                self._h_staleness.observe(float(mc - last))
        with srv._lock:  # snapshot only (channel handlers mutate too)
            if len(table) == 0:
                return
            keys, shards = table.snapshot()
            cross = (srv.ab.owner[keys] < 0).astype(np.uint8) \
                if srv.glob is not None else None
        min_clocks = srv.shard_min_clocks()
        keep, keep_x, drop, drop_x = self._scan_partition(
            keys, shards, cross, min_clocks)
        self.stats.add(keys_considered=len(keep) + len(keep_x))
        if len(keep):
            kk, ks = keys[keep], shards[keep]
            n_considered, n_dirty = len(kk), -1
            pol = srv.policy
            if not self.opts.sync_dirty_only and pol is not None and \
                    pol.active("sync") and \
                    pol.consult("sync", {"n_dirty": -1}, n_considered):
                # a learned sync law's predicted wasted wire applies the
                # exact dirty mask below though the static filter is off:
                # the same value-preservation guard the filter rests on
                pol.applied("sync")
                filter_dirty = True
            else:
                filter_dirty = self.opts.sync_dirty_only
            if filter_dirty:
                # dirty-delta filter: a clean replica's sync program is a
                # bit-for-bit no-op, so skipping it cannot change a read;
                # a dirty replica's siblings ride along to pick up the
                # post-merge value
                dirty = srv._dirty_replica_mask(kk, ks)
                n_dirty = int(dirty.sum())
                if dirty.any() and not dirty.all():
                    dirty |= np.isin(kk, kk[dirty])
                kk, ks = kk[dirty], ks[dirty]
            dc = srv.decisions
            if dc is not None:
                # the ship/hold verdict of this channel's batch: clean
                # ride-alongs (or a clean ship with the filter off) fold
                # into decision.shipped_clean
                dc.record_sync(channel, n_considered, n_dirty, len(kk))
            if len(kk):
                # periodic rounds ship in the --sys.sync.compress format
                # (the residual parks in the delta row); drop and quiesce
                # flushes stay exact (kv.py _sync_replicas)
                srv._sync_replicas(kk, ks,
                                   threshold=self.opts.sync_threshold,
                                   compress=True)
                self.stats.add(keys_synced=len(kk))
        if len(keep_x) and not self.opts.collective_sync:
            # replicas of remote keys: exempt from the dirty filter (the
            # owner's writes are invisible to local epochs, and the
            # round is also how they observe remote pushes). Collective
            # mode: they accumulate and ship in the BSP exchange at the
            # next WaitSync/quiesce point or cadence boundary
            srv.glob.sync_replicas(keys[keep_x], shards[keep_x])
            self.stats.add(keys_synced=len(keep_x))
        if (len(drop) or len(drop_x)) and srv.tracer is not None:
            from ..utils.stats import INTENT_STOP
            dk = np.concatenate([keys[drop], keys[drop_x]])
            ds = np.concatenate([shards[drop], shards[drop_x]])
            for s in np.unique(ds):
                srv.tracer.record(dk[ds == s], INTENT_STOP, int(s))
        if len(drop):
            dk, ds = keys[drop], shards[drop]
            srv._drop_replicas(dk, ds)
            with srv._lock:
                self.replica_discard(dk, ds)
            self.stats.add(replicas_dropped=len(dk))
        if len(drop_x):
            # discards from the channel tables itself
            srv.glob.drop_replicas(keys[drop_x], shards[drop_x])
            self.stats.add(replicas_dropped=len(drop_x))

    def _scan_partition(self, keys: np.ndarray, shards: np.ndarray,
                        cross: Optional[np.ndarray],
                        min_clocks: np.ndarray):
        """Partition one channel snapshot into (keep_local, keep_cross,
        drop_local, drop_cross) index arrays: keep iff the holder shard's
        intent horizon is still active. One native pass or its vectorized
        numpy equivalent."""
        srv = self.server
        if srv._native is not None:
            from ..native import replica_scan_partition
            return replica_scan_partition(
                srv._native, keys, shards, self.intent_end,
                np.ascontiguousarray(min_clocks, np.int64),
                srv.num_keys, cross)
        keep = self.intent_end[shards, keys] >= min_clocks[shards]
        x = np.zeros(len(keys), dtype=bool) if cross is None \
            else cross.astype(bool)
        return (np.nonzero(keep & ~x)[0], np.nonzero(keep & x)[0],
                np.nonzero(~keep & ~x)[0], np.nonzero(~keep & x)[0])

    def run_round(self, force_intents: bool = False,
                  all_channels: bool = False) -> None:
        # self-serializing (the round lock is reentrant)
        with self.server._round_lock:
            self._throttle()
            if self.server._in_setup and not force_intents:
                # BeginSetup/EndSetup bracket: management is paused
                return
            from ..obs.metrics import timed
            # the round's wire bytes across all its channels (exact drop
            # flushes included), for sync.bytes_per_round
            bytes_before = sum(st.sync_bytes_shipped
                               for st in self.server.stores)
            with timed(self._h_round), self.server._span("sync.round"):
                self.drain_intents(force=force_intents)
                if all_channels:
                    self._sync_all_channels()
                else:
                    self.sync_channel(self._next_channel)
                    self._next_channel = \
                        (self._next_channel + 1) % self.num_channels
                if force_intents and all_channels:
                    # the WaitSync shape: in collective mode the agreed
                    # point where every process joins the BSP exchange
                    self._collective_point()
                else:
                    self._maybe_cadence()
                self.stats.add(rounds=1)
            self._last_round_bytes = sum(
                st.sync_bytes_shipped for st in self.server.stores) - \
                bytes_before
            wt = self.server.wtrace
            if wt is not None:
                # the round as it landed: replay re-drives these where
                # the workload put them, not where a wall clock did
                wt.record_sync(forced=force_intents,
                               all_channels=all_channels,
                               bytes_shipped=self._last_round_bytes)

    def _sync_all_channels(self) -> None:
        """All channels' rounds. Multi-process, >1 channel: issued
        CONCURRENTLY — channels partition keys (per-channel delta locks,
        pm.delta_window), local device work serializes briefly under the
        server lock, and the expensive part (per-channel round trips to
        owners) overlaps instead of stacking (reference: C parallel
        SyncManager threads, coloc_kv_server.h:100-105). One process:
        serial — no network latency to hide, only thread overhead."""
        srv = self.server
        if srv.glob is None or self.num_channels == 1:
            for c in range(self.num_channels):
                self.sync_channel(c)
            return
        if self._chan_exec is None:
            from concurrent.futures import ThreadPoolExecutor
            self._chan_exec = ThreadPoolExecutor(
                max_workers=self.num_channels,
                thread_name_prefix="adapm-chan")
        futs = [self._chan_exec.submit(self.sync_channel, c)
                for c in range(self.num_channels)]
        errs = []
        for f in futs:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 — all reported below
                errs.append(e)
        if errs:
            # surface every channel's failure: log the others before
            # raising the first
            from ..utils.log import alog
            for e in errs[1:]:
                alog(f"[sync] concurrent channel round also failed: "
                     f"{type(e).__name__}: {e}")
            raise errs[0]

    def close(self) -> None:
        if self._chan_exec is not None:
            self._chan_exec.shutdown(wait=True)
            self._chan_exec = None

    def _collective_active(self) -> bool:
        return self.server.glob is not None and self.opts.collective_sync

    def _collective_exchange(self, quiescing: bool) -> bool:
        """One BSP exchange of every cross-process replica delta (caller
        holds _coll_lock). Returns True iff all processes entered it
        quiescing."""
        srv = self.server
        with srv._lock:
            parts = [t.snapshot() for t in self.replicas]
            karr = np.concatenate([k for k, _ in parts])
            sarr = np.concatenate([s for _, s in parts])
            m = srv.ab.owner[karr] < 0
            karr, sarr = karr[m], sarr[m]
        all_q = srv.glob.collective_sync(karr, sarr, quiescing=quiescing)
        self.stats.add(keys_synced=len(karr), keys_considered=len(karr))
        return all_q

    def _maybe_cadence(self) -> None:
        """--sys.collective_cadence K: join one BSP exchange per K-clock
        boundary this process's workers have crossed. Every process runs
        the same check in its run_round, so exchanges pair up globally in
        boundary order; a process that crosses fewer boundaries before
        its next WaitSync/quiesce is absorbed there by the flag loop
        (_collective_point). Bounded staleness: a replica observes any
        remote push within K clocks of the slowest process (plus one
        run_round)."""
        K = self.opts.collective_cadence
        if K <= 0 or not self._collective_active():
            return
        while True:
            mc = self._min_active_clock()
            if mc is None or mc < (self._cad_joined + 1) * K:
                return
            with self._coll_lock:
                # re-check: another local thread may have serviced it (or
                # the last worker may have finalized mid-check)
                mc = self._min_active_clock()
                if mc is None or mc < (self._cad_joined + 1) * K:
                    continue
                self._cad_joined += 1
                self._collective_exchange(quiescing=False)

    def _collective_point(self) -> None:
        """Ship all cross-process replica deltas through the collective
        exchange. Reached by every process together; runs (with possibly
        zero items) whenever collective mode is on. With a cadence this
        is a FLAG LOOP: the process keeps joining exchanges
        (quiescing=True) until every peer is also at its wait point —
        absorbing peers that crossed more cadence boundaries."""
        if not self._collective_active():
            return
        with self._coll_lock:
            while True:
                all_q = self._collective_exchange(quiescing=True)
                if all_q or self.opts.collective_cadence <= 0:
                    break
            # a global sync point: re-base the cadence so all processes
            # agree that past boundaries need no exchange
            K = self.opts.collective_cadence
            if K > 0:
                mc = self._min_active_clock()
                self._cad_joined = 0 if mc is None else mc // K

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
                    cross = (srv.ab.owner[keys] < 0) \
                        if srv.glob is not None else None
                if cross is not None:
                    lk, ls = keys[~cross], shards[~cross]
                    rk, rs = keys[cross], shards[cross]
                else:
                    lk, ls = keys, shards
                    rk = rs = np.empty(0, dtype=np.int64)
                if len(lk):
                    # unconditional flush: quiesce bypasses the dirty
                    # filter and the threshold so no pending delta is
                    # ever lost
                    srv._sync_replicas(lk, ls)
                    self.stats.add(keys_synced=len(lk),
                                   keys_considered=len(lk))
                if len(rk) and not self.opts.collective_sync:
                    srv.glob.sync_replicas(rk, rs)
                    self.stats.add(keys_synced=len(rk),
                                   keys_considered=len(rk))
            # collective mode: one BSP exchange covers every cross
            # replica (joined by all processes, items or not)
            self._collective_point()
            srv.block()

    def report(self) -> str:
        s = self.stats
        out = (f"sync: rounds={s.rounds} intents={s.intents_processed} "
               f"replicas+={s.replicas_created} -={s.replicas_dropped} "
               f"relocations={s.relocations} "
               f"keys_shipped={s.keys_synced}/"
               f"considered={s.keys_considered}")
        if self.server.glob is not None:
            out += " | " + self.server.glob.report()
        return out
