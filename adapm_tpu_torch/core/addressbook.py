"""Host-side ownership metadata: the reference's Addressbook reborn.

Per key the reference tracks (addressbook.h):
  - manager (home) shard = key % S              (addressbook.h:110-112)
  - current owner (dense vector at the manager)  (addressbook.h:151)
  - relocation counters to reject stale updates  (addressbook.h:92-102)
  - optional location cache                      (addressbook.h:114-133)

In the single-controller design the addressbook is a set of host numpy
tables shared by the planner and every local worker (one authoritative copy
per controller process, so the manager/owner/location-cache distinction
collapses locally; across hosts the control plane keeps them consistent). It
additionally owns slot allocation: every key maps to a (shard, slot) row in
its length class's device pool, and replicas map to (shard, cache slot).

Keys may have different value lengths (reference `get_len`,
coloc_kv_server_handle.h:996-999); keys are grouped into *length classes*,
each backed by its own pooled store, so `slot` is a row index within the
key's class pool.

Everything here is O(1) or vectorized per *batch*, never per key in Python —
the reference's addressbook is O(1)/key in C++ (addressbook.h:110-151), and a
5M-key Wikidata5M-scale table must construct in seconds, not minutes.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..base import NO_SLOT, REMOTE


class SlotAllocator:
    """Per-shard allocator over pool slots.

    A fresh-slot watermark plus a LIFO free list of returned slots: O(1)
    construction (no materialized range lists — at 5M slots per shard those
    alone would cost hundreds of MB) and O(batch) alloc/free.
    """

    def __init__(self, num_shards: int, slots_per_shard: int):
        self.num_shards = num_shards
        self.slots_per_shard = slots_per_shard
        # slots [watermark, slots_per_shard) have never been handed out
        self._watermark = np.zeros(num_shards, dtype=np.int64)
        self._returned: List[List[int]] = [[] for _ in range(num_shards)]

    def set_watermark(self, counts: np.ndarray) -> None:
        """Mark the first counts[s] slots of each shard as allocated (bulk
        initial allocation; callers assign those slots contiguously)."""
        assert (counts <= self.slots_per_shard).all()
        self._watermark[:] = counts

    def alloc(self, shard: int) -> int:
        ret = self._returned[shard]
        if ret:
            return ret.pop()
        w = int(self._watermark[shard])
        if w >= self.slots_per_shard:
            raise RuntimeError(
                f"shard {shard} out of pool slots ({self.slots_per_shard}); "
                "increase the pool over-allocation factor")
        self._watermark[shard] = w + 1
        return w

    def alloc_batch(self, shard: int, n: int) -> np.ndarray:
        """Allocate up to n slots (returns fewer when the pool runs out)."""
        n = min(n, self.num_free(shard))
        ret = self._returned[shard]
        take = min(n, len(ret))
        out = np.empty(n, dtype=np.int64)
        if take:
            out[:take] = ret[len(ret) - take:]
            del ret[len(ret) - take:]
        fresh = n - take
        if fresh:
            w = int(self._watermark[shard])
            out[take:] = np.arange(w, w + fresh)
            self._watermark[shard] = w + fresh
        return out

    def free(self, shard: int, slot: int) -> None:
        self._returned[shard].append(int(slot))

    def free_batch(self, shard: int, slots: np.ndarray) -> None:
        self._returned[shard].extend(np.asarray(slots).tolist())

    def num_free(self, shard: int) -> int:
        return (self.slots_per_shard - int(self._watermark[shard])
                + len(self._returned[shard]))

    def set_used(self, shard: int, used: np.ndarray) -> None:
        """Reset one shard so exactly `used` slots are allocated (checkpoint
        restore): watermark just past the highest used slot, gaps below it
        on the returned list."""
        used = np.asarray(used, dtype=np.int64)
        if len(used) == 0:
            self._watermark[shard] = 0
            self._returned[shard] = []
            return
        w = int(used.max()) + 1
        assert w <= self.slots_per_shard, \
            f"used slot {w - 1} outside pool of {self.slots_per_shard}"
        gap = np.ones(w, dtype=bool)
        gap[used] = False
        self._watermark[shard] = w
        self._returned[shard] = np.nonzero(gap)[0].tolist()


class Addressbook:
    """Global key → location tables over all length classes.

    Multi-process (num_procs > 1): the key space is partitioned over
    `num_procs * num_shards` *global* shards; this process's tables cover
    only the keys whose global home shard lands here. Keys owned by another
    process carry `owner == REMOTE` (and no slot) — the cross-process layer
    (parallel/pm.py GlobalPM) routes those, mirroring the reference split
    between the per-node store and the manager/owner metadata
    (addressbook.h:110-151)."""

    def __init__(self, key_class: np.ndarray, num_shards: int,
                 main_slots: Sequence[int], cache_slots: Sequence[int],
                 num_procs: int = 1, pid: int = 0):
        num_keys = len(key_class)
        self.num_keys = num_keys
        self.num_shards = num_shards
        self.num_procs = num_procs
        self.pid = pid
        self.key_class = key_class.astype(np.int32)
        # main copy location: owner shard + slot within the class pool;
        # REMOTE = owned by another process
        self.owner = np.full(num_keys, REMOTE, dtype=np.int32)
        self.slot = np.full(num_keys, NO_SLOT, dtype=np.int32)
        # replica locations: cache_slot[shard, key] = class-pool cache slot
        self.cache_slot = np.full((num_shards, num_keys), NO_SLOT,
                                  dtype=np.int32)
        self.replica_count = np.zeros(num_keys, dtype=np.int32)
        # bumped on every ownership move; rejects stale location info in the
        # multi-host control plane (reference addressbook.h:92-102)
        self.relocation_counter = np.zeros(num_keys, dtype=np.int32)
        # counted placement mutations (replica add/drop, relocation,
        # adopt/abandon) — paired with topology_version bumps by
        # Server._topology_mutation's discipline assertion; the initial
        # allocation below is construction, not a mutation
        self.mutations = 0

        self.main_alloc = [SlotAllocator(num_shards, m) for m in main_slots]
        self.cache_alloc = [SlotAllocator(num_shards, c) for c in cache_slots]

        # initial allocation, vectorized: global home shard = key % (S*P)
        # (reference manager = key % num_servers, addressbook.h:110-112);
        # within (class, local shard) keys take consecutive slots in key order
        gs = num_shards * num_procs
        single_class = len(self.main_alloc) == 1
        for cid, alloc in enumerate(self.main_alloc):
            if single_class:
                # fast path (uniform value lengths, the common case): keys
                # with the same global home shard are k ≡ g (mod S*P), so
                # the rank within the group is k // (S*P)
                g = np.arange(num_keys) % gs
                owned = (g // num_shards) == pid
                lsh = (g % num_shards).astype(np.int32)
                self.owner[:] = np.where(owned, lsh, REMOTE)
                self.slot[:] = np.where(owned, np.arange(num_keys) // gs,
                                        NO_SLOT)
                alloc.set_watermark(
                    np.bincount(lsh[owned], minlength=num_shards))
                continue
            keys_c = np.nonzero(self.key_class == cid)[0]
            g = keys_c % gs
            keys_c = keys_c[(g // num_shards) == pid]
            if len(keys_c) == 0:
                alloc.set_watermark(np.zeros(num_shards, dtype=np.int64))
                continue
            home = ((keys_c % gs) % num_shards).astype(np.int32)
            counts = np.zeros(num_shards, dtype=np.int64)
            for h in range(num_shards):  # S masked passes beat an argsort
                grp = keys_c[home == h]
                counts[h] = len(grp)
                self.owner[grp] = h
                self.slot[grp] = np.arange(len(grp))
            alloc.set_watermark(counts)

    # -- queries ------------------------------------------------------------
    def home(self, key: int) -> int:
        return int(key) % self.num_shards

    def is_local(self, keys: np.ndarray, shard: int) -> np.ndarray:
        """True per key if shard holds the main copy or a replica."""
        return (self.owner[keys] == shard) | (
            self.cache_slot[shard, keys] != NO_SLOT)

    def has_replica(self, keys: np.ndarray, shard: int) -> np.ndarray:
        return self.cache_slot[shard, keys] != NO_SLOT

    def replica_shards(self, key: int) -> np.ndarray:
        return np.nonzero(self.cache_slot[:, key] != NO_SLOT)[0]

    # -- replica bookkeeping -------------------------------------------------
    def add_replica(self, key: int, shard: int) -> int:
        cs = self.add_replicas(np.asarray([key], dtype=np.int64), shard)
        if len(cs) == 0:
            cls = int(self.key_class[key])
            raise RuntimeError(
                f"shard {shard} out of cache pool slots "
                f"({self.cache_alloc[cls].slots_per_shard}); increase "
                "cache_slots_per_shard")
        return int(cs[0])

    def add_replicas(self, keys: np.ndarray, shard: int) -> np.ndarray:
        """Allocate cache slots for `keys` (all same class, none already
        replicated on `shard`); returns the slots. Capacity-bounded: only
        the first num_free keys get slots; the returned array may be
        shorter than `keys` (callers truncate their batch accordingly)."""
        assert (self.cache_slot[shard, keys] == NO_SLOT).all()
        cls = self.key_class[keys]
        assert len(keys) == 0 or (cls == cls[0]).all(), \
            "add_replicas batch must be single-class"
        if len(keys) == 0:
            return np.empty(0, dtype=np.int64)
        alloc = self.cache_alloc[int(cls[0])]
        cs = alloc.alloc_batch(shard, len(keys))
        taken = keys[: len(cs)]
        if len(taken):
            self.mutations += 1
        self.cache_slot[shard, taken] = cs
        self.replica_count[taken] += 1
        return cs

    def drop_replica(self, key: int, shard: int) -> int:
        cs = int(self.cache_slot[shard, key])
        assert cs != NO_SLOT
        self.drop_replicas(np.asarray([key], dtype=np.int64), shard)
        return cs

    def drop_replicas(self, keys: np.ndarray, shard: int) -> None:
        """Free the cache slots of `keys` on `shard` (single class)."""
        if len(keys) == 0:
            return
        cs = self.cache_slot[shard, keys]
        assert (cs != NO_SLOT).all()
        cls = self.key_class[keys]
        assert (cls == cls[0]).all(), \
            "drop_replicas batch must be single-class"
        self.mutations += 1
        self.cache_slot[shard, keys] = NO_SLOT
        self.replica_count[keys] -= 1
        self.cache_alloc[int(cls[0])].free_batch(shard, cs)

    # -- relocation ----------------------------------------------------------
    def relocate(self, key: int, new_shard: int) -> tuple[int, int, int]:
        """Move ownership of `key` to `new_shard`. Returns
        (old_shard, old_slot, new_slot); the device row move is the caller's
        job (Server.relocate). Host metadata only."""
        old_shard = int(self.owner[key])
        old_slot = int(self.slot[key])
        assert old_shard != new_shard
        alloc = self.main_alloc[self.key_class[key]]
        new_slot = alloc.alloc(new_shard)
        self.mutations += 1
        self.owner[key] = new_shard
        self.slot[key] = new_slot
        alloc.free(old_shard, old_slot)
        self.relocation_counter[key] += 1
        return old_shard, old_slot, new_slot

    def adopt_batch(self, keys: np.ndarray, shard: int):
        """Cross-process relocation, requester side: this process takes
        ownership of `keys` (currently REMOTE, single class), preferring
        local `shard` and SPILLING OVER to sibling shards when its pool
        is full (reads reach sibling shards through the cross-shard
        gather, so spillover trades some intra-process locality, never
        correctness). Returns (shards, slots). Raises only if the whole
        process is out of pool — impossible by construction: per-shard
        pools are over-allocated so their sum exceeds the class size."""
        if len(keys) == 0:
            e = np.empty(0, dtype=np.int64)
            return e, e
        assert (self.owner[keys] == REMOTE).all(), \
            "adopt_batch keys must be remotely owned"
        cls = self.key_class[keys]
        assert (cls == cls[0]).all(), "adopt_batch must be single-class"
        alloc = self.main_alloc[int(cls[0])]
        sh_out = np.empty(len(keys), dtype=np.int64)
        sl_out = np.empty(len(keys), dtype=np.int64)
        order = [shard] + sorted(
            (s for s in range(self.num_shards) if s != shard),
            key=alloc.num_free, reverse=True)
        pos = 0
        for s in order:
            if pos >= len(keys):
                break
            slots = alloc.alloc_batch(s, len(keys) - pos)
            sh_out[pos:pos + len(slots)] = s
            sl_out[pos:pos + len(slots)] = slots
            pos += len(slots)
        if pos < len(keys):
            raise RuntimeError(
                f"process out of main pool slots while adopting "
                f"{len(keys) - pos} relocated keys; increase over_alloc")
        self.mutations += 1
        self.owner[keys] = sh_out
        self.slot[keys] = sl_out
        self.relocation_counter[keys] += 1
        return sh_out, sl_out

    def abandon_batch(self, keys: np.ndarray) -> None:
        """Cross-process relocation, owner side: release ownership of
        locally-owned `keys` (single class) — their main copies move to
        another process. Frees the main slots; owner becomes REMOTE."""
        if len(keys) == 0:
            return
        cls = self.key_class[keys]
        assert (cls == cls[0]).all(), "abandon_batch must be single-class"
        sh = self.owner[keys]
        sl = self.slot[keys]
        assert (sh >= 0).all(), "abandon_batch keys must be locally owned"
        alloc = self.main_alloc[int(cls[0])]
        self.mutations += 1
        for s in np.unique(sh):
            alloc.free_batch(int(s), sl[sh == s])
        self.owner[keys] = REMOTE
        self.slot[keys] = NO_SLOT
        self.relocation_counter[keys] += 1

    def relocate_batch(self, keys: np.ndarray, new_shard: int) -> tuple:
        """Move ownership of `keys` (single class, none already owned by
        `new_shard`) to `new_shard`. Capacity-bounded like add_replicas:
        only the first num_free keys move. Returns
        (moved_keys, old_shards, old_slots, new_slots)."""
        if len(keys) == 0:
            e = np.empty(0, dtype=np.int64)
            return e, e, e, e
        cls = self.key_class[keys]
        assert (cls == cls[0]).all(), "relocate_batch must be single-class"
        alloc = self.main_alloc[int(cls[0])]
        new_slots = alloc.alloc_batch(new_shard, len(keys))
        moved = keys[: len(new_slots)]
        if len(moved):
            self.mutations += 1
        old_shards = self.owner[moved].astype(np.int64)
        old_slots = self.slot[moved].astype(np.int64)
        assert (old_shards != new_shard).all()
        self.owner[moved] = new_shard
        self.slot[moved] = new_slots
        self.relocation_counter[moved] += 1
        # free per old shard (grouped, not per key)
        for s in np.unique(old_shards):
            alloc.free_batch(int(s), old_slots[old_shards == s])
        return moved, old_shards, old_slots, new_slots
