"""Device-resident sharded parameter pools.

The counterpart of the JAX package's `core/store.py`: three torch
tensors per length class, with S virtual shards in dimension 0
(device/context.py):

    main  [S, slots, L]   main copies          (owner shard holds the row)
    cache [S, cslots, L]  replica base values  (value at last refresh)
    delta [S, cslots, L]  additive updates accumulated against replicas

A replica read returns `cache + delta` (read-your-writes). Routing from
keys to (shard, slot) lives in Server/Addressbook; every program goes
through the DevicePort (device/torchport.py), which updates the pools in
place. Index batches are padded to power-of-two buckets with OOB
entries, exactly as in the JAX package, so both packages run the same
programs on the same padded inputs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import default_port
from ..device.torchport import OOB  # noqa: F401  (re-exported)


def bucket_size(n: int, minimum: int = 8) -> int:
    """Pad n up to a power of two."""
    if n <= minimum:
        return minimum
    return 1 << math.ceil(math.log2(n))


def pad_to(arr: np.ndarray, size: int, fill) -> np.ndarray:
    out = np.full((size,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def pad_bucket(n: int, *arrays_and_fills, minimum: int = 8):
    b = bucket_size(n, minimum)
    return [pad_to(np.asarray(a), b, fill) for a, fill in arrays_and_fills]


def _round8(n: int) -> int:
    """Slot counts rounded up to a multiple of 8 — the JAX package's
    layout rule, kept so slot counts (and with them addressbook slots)
    are identical in both packages and pools compare bitwise."""
    return -8 * (-n // 8)


class ShardedStore:
    """Pools for one length class. Index-level API; key routing lives
    above."""

    def __init__(self, num_keys_in_class: int, value_length: int, ctx,
                 dtype=torch.float32, over_alloc: float = 1.25,
                 cache_slots_per_shard: int = 0, bucket_min: int = 8,
                 tier_hot_rows: int = 0, port=None):
        if tier_hot_rows > 0:
            raise NotImplementedError(
                "tiered storage (--sys.tier) is not ported yet (ROADMAP "
                "queue A, item 8)")
        self.value_length = value_length
        self.ctx = ctx
        self.dtype = dtype
        self.port = port if port is not None else default_port()
        self.bucket_min = max(1, bucket_min)
        S = ctx.num_shards
        per_shard = max(1, math.ceil(num_keys_in_class / S))
        self.main_slots = _round8(max(per_shard,
                                      math.ceil(per_shard * over_alloc)))
        self.cache_slots = _round8(max(1, cache_slots_per_shard or
                                       per_shard))
        dev = ctx.device
        self.main = self.port.alloc_pool(
            (S, self.main_slots, value_length), dtype, dev)
        self.cache = self.port.alloc_pool(
            (S, self.cache_slots, value_length), dtype, dev)
        self.delta = self.port.alloc_pool(
            (S, self.cache_slots, value_length), dtype, dev)

        # dirty-delta tracking on the host (the JAX store's write
        # epochs): a sync of replica (s, cs) against owner row (o, os)
        # is a bit-for-bit no-op iff its pending delta is zero AND its
        # base still equals the main row.
        #   main_epoch[o, os]   — bumped by every program that can change
        #                         a main row's VALUE;
        #   repl_epoch[s, cs]   — the main row's epoch at the replica's
        #                         last base refresh;
        #   delta_dirty[s, cs]  — a delta write landed since that refresh.
        # dirty := delta_dirty | (main_epoch != repl_epoch); conservative
        # only toward syncing.
        self._epoch = 1
        self.main_epoch = np.zeros((S, self.main_slots), dtype=np.int64)
        self.repl_epoch = np.zeros((S, self.cache_slots), dtype=np.int64)
        self.delta_dirty = np.zeros((S, self.cache_slots), dtype=bool)
        # wire accounting of sync rounds (full-width f32 rows; the
        # compressed formats are not ported)
        self.sync_bytes_shipped = 0
        self.sync_bytes_full = 0
        self.gathers = 0

    def _next_epoch(self) -> int:
        self._epoch += 1
        return self._epoch

    def reset_write_tracking(self) -> None:
        """Conservatively mark everything dirty (pools replaced
        wholesale): the next sync round re-ships every live replica."""
        self._epoch += 1
        self.main_epoch.fill(self._epoch)
        self.repl_epoch.fill(0)
        self.delta_dirty.fill(True)

    def mark_shard_written(self, shard: int) -> None:
        """Conservative write tracking for in-program scatters whose rows
        the host cannot enumerate (device-drawn negatives)."""
        self.main_epoch[shard, :] = self._next_epoch()
        self.delta_dirty[shard, :] = True

    def mark_routed_writes(self, shard: int, cache_rows: np.ndarray,
                           owner_sh: np.ndarray,
                           owner_sl: np.ndarray) -> None:
        """Exact write tracking for a fused-step scatter of host-known
        keys (replica delta row where `cache_rows` >= 0, else the owner
        main row)."""
        repl = cache_rows >= 0
        if repl.any():
            self.delta_dirty[shard, cache_rows[repl]] = True
        m = ~repl & (owner_sl >= 0)
        if m.any():
            self.main_epoch[owner_sh[m], owner_sl[m]] = self._next_epoch()

    def _vals_bucket(self, vals, bucket: int) -> np.ndarray:
        v = np.zeros((bucket, self.value_length), dtype=np.float32)
        v[: vals.shape[0]] = np.asarray(vals)
        return v

    # index-level ops (np.int32 index arrays, padded here)

    def gather(self, o_shard, o_slot, c_shard, c_slot, use_cache):
        n = len(o_shard)
        self.gathers += 1
        a = pad_bucket(n, (o_shard, 0), (o_slot, OOB), (c_shard, 0),
                       (c_slot, OOB), (use_cache, False),
                       minimum=self.bucket_min)
        return self.port.gather(self.main, self.cache, self.delta, *a)

    def scatter_add(self, o_shard, o_slot, d_shard, d_slot, vals):
        n = len(o_shard)
        m = np.asarray(o_slot) != OOB
        if m.any():
            self.main_epoch[np.asarray(o_shard)[m],
                            np.asarray(o_slot)[m]] = self._next_epoch()
        md = np.asarray(d_slot) != OOB
        if md.any():
            self.delta_dirty[np.asarray(d_shard)[md],
                             np.asarray(d_slot)[md]] = True
        a = pad_bucket(n, (o_shard, 0), (o_slot, OOB), (d_shard, 0),
                       (d_slot, OOB), minimum=self.bucket_min)
        v = self._vals_bucket(vals, a[0].shape[0])
        self.main, self.delta = self.port.scatter_add(
            self.main, self.delta, *a, v)

    def set_rows(self, o_shard, o_slot, vals, c_shard, c_slot):
        n = len(o_shard)
        e = self._next_epoch()
        m = np.asarray(o_slot) != OOB
        if m.any():
            self.main_epoch[np.asarray(o_shard)[m],
                            np.asarray(o_slot)[m]] = e
        mc = np.asarray(c_slot) != OOB
        if mc.any():
            cs, cl = np.asarray(c_shard)[mc], np.asarray(c_slot)[mc]
            self.repl_epoch[cs, cl] = e
            self.delta_dirty[cs, cl] = False
        a = pad_bucket(n, (o_shard, 0), (o_slot, OOB), (c_shard, 0),
                       (c_slot, OOB), minimum=self.bucket_min)
        v = self._vals_bucket(vals, a[0].shape[0])
        self.main, self.cache, self.delta = self.port.set_rows(
            self.main, self.cache, self.delta, a[0], a[1], v,
            a[2], a[3])

    def replica_create(self, o_shard, o_slot, c_shard, c_slot):
        n = len(o_shard)
        self.repl_epoch[c_shard, c_slot] = self.main_epoch[o_shard, o_slot]
        self.delta_dirty[c_shard, c_slot] = False
        a = pad_bucket(n, (o_shard, 0), (o_slot, OOB), (c_shard, 0),
                       (c_slot, OOB), minimum=self.bucket_min)
        self.cache, self.delta = self.port.replica_create(
            self.main, self.cache, self.delta, *a)

    def sync_replicas(self, r_shard, r_cslot, o_shard, o_slot,
                      threshold: float = 0.0, compress: str = "off"):
        n = len(r_shard)
        self.sync_bytes_shipped += n * 4 * self.value_length
        self.sync_bytes_full += n * 4 * self.value_length
        if threshold <= 0.0:
            r_sh, r_cs = np.asarray(r_shard), np.asarray(r_cslot)
            o_sh, o_sl = np.asarray(o_shard), np.asarray(o_slot)
            # only owner rows receiving a DIRTY delta advance the epoch
            dd = self.delta_dirty[r_sh, r_cs]
            if dd.any():
                self.main_epoch[o_sh[dd], o_sl[dd]] = self._next_epoch()
            self.repl_epoch[r_sh, r_cs] = self.main_epoch[o_sh, o_sl]
            self.delta_dirty[r_sh, r_cs] = False
        a = pad_bucket(n, (r_shard, 0), (r_cslot, OOB), (o_shard, 0),
                       (o_slot, OOB), minimum=self.bucket_min)
        self.main, self.cache, self.delta = self.port.sync_replicas(
            self.main, self.cache, self.delta, *a, threshold=threshold,
            compress=compress)

    def relocate_rows(self, old_shard, old_slot, new_shard, new_slot,
                      rc_shard, rc_slot):
        n = len(old_shard)
        m = np.asarray(new_slot) != OOB
        if m.any():
            self.main_epoch[np.asarray(new_shard)[m],
                            np.asarray(new_slot)[m]] = self._next_epoch()
        mr = np.asarray(rc_slot) != OOB
        if mr.any():
            self.delta_dirty[np.asarray(rc_shard)[mr],
                             np.asarray(rc_slot)[mr]] = False
        a = pad_bucket(n, (old_shard, 0), (old_slot, OOB), (new_shard, 0),
                       (new_slot, OOB), (rc_shard, 0), (rc_slot, OOB),
                       minimum=self.bucket_min)
        self.main, self.delta = self.port.relocate(
            self.main, self.delta, *a)

    def read_rows(self, which: str, sh, sl) -> np.ndarray:
        """Host readback of pool rows (non-destructive)."""
        n = len(sh)
        a = pad_bucket(n, (sh, 0), (sl, OOB), minimum=self.bucket_min)
        arr = {"main": self.main, "cache": self.cache,
               "delta": self.delta}[which]
        return self.port.read_rows_at(arr, *a)[:n].cpu().numpy()

    def main_host(self) -> np.ndarray:
        """The full main table [S, main_slots, L] on the host."""
        return self.main.cpu().numpy()

    def block(self) -> None:
        if self.main.device.type == "cuda":
            torch.cuda.synchronize(self.main.device)
