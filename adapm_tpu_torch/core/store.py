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

With `tier_hot_rows > 0` the store is TIERED (adapm_tpu_torch/tier):
the device main pool holds that many rows per shard, the authoritative
table lives in the host cold store `coldq` (tier/quant.py QuantCold, in
--sys.tier.cold_dtype format), and `res` (tier/residency.py Residency)
maps slots to hot rows. Every index-level op keeps taking (shard, SLOT)
coordinates; the tiered branches (tier/coldpath.py) translate them to
hot rows at dispatch time, so routing and the addressbook never see the
tier.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import cuda as dcuda
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


class StagingPool:
    """Row budget for the prefetch pipeline's staged gather buffers (one
    per length class; core/intent.py PrefetchScheduler).

    Not a preallocated arena: the gather already writes its rows into a
    fresh tensor, so copying them into a reserved pool would only add a
    device-to-device copy. What staging needs is a BOUND — prefetch must
    not be able to exhaust device memory by racing ahead of the consumer
    — so the pool accounts rows (the tensors stay owned by the staged
    entries) and `stage_gather` refuses to gather past the budget.
    Thread-safe: executor programs acquire, any thread that drops or
    consumes an entry releases."""

    def __init__(self, max_rows: int):
        import threading
        self.max_rows = max_rows
        self._rows = 0
        self._hwm = 0  # occupancy high-water mark (staging.rows_hwm)
        self._lock = threading.Lock()

    def try_acquire(self, rows: int) -> bool:
        with self._lock:
            if self._rows + rows > self.max_rows:
                return False
            self._rows += rows
            if self._rows > self._hwm:
                self._hwm = self._rows
            return True

    def release(self, rows: int) -> None:
        with self._lock:
            self._rows -= rows
            assert self._rows >= 0, "staging pool released more than held"

    @property
    def rows_in_use(self) -> int:
        return self._rows

    @property
    def rows_hwm(self) -> int:
        """Highest concurrent row occupancy seen (never resets)."""
        return self._hwm


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
                 tier_hot_rows: int = 0, tier_cold_dtype: str = "fp32",
                 port=None):
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
        # tiered residency (module docstring): the cold store's residual
        # capacity scales with the hot pool (the rows that cycle through
        # promote/demote are the ones that park remainders)
        self.res = None
        self.coldq = None
        self.tier_hot_hits = 0   # owner-served gather entries, hot
        self.tier_cold_hits = 0  # owner-served gather entries, cold
        self.tier_hist = None    # cold-serve latency (TierManager)
        dev_main_slots = self.main_slots
        if tier_hot_rows > 0:
            from ..tier.quant import QuantCold
            from ..tier.residency import Residency
            dev_main_slots = _round8(
                min(self.main_slots, max(8, tier_hot_rows)))
            self.res = Residency(S, self.main_slots, dev_main_slots)
            self.coldq = QuantCold(
                S, self.main_slots, value_length, mode=tier_cold_dtype,
                resid_cap=min(65536, max(1024, 4 * dev_main_slots)))
        dev = ctx.device
        self.main = self.port.alloc_pool(
            (S, dev_main_slots, value_length), dtype, dev)
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
        # wire accounting of sync rounds: bytes shipped in the
        # --sys.sync.compress format vs full-width f32 for the same rows
        # (sync.bytes_* gauges). With a threshold the ship/hold decision
        # is on the device, so these count the CONSIDERED rows.
        self.sync_bytes_shipped = 0
        self.sync_bytes_full = 0
        # max-abs residual parked by the last compressed round: a device
        # scalar read lazily (ef_residual_norm), and the tiered
        # cold-owner rounds' host value
        self._ef_resid_dev = None
        self._ef_resid_host = 0.0
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

    def export_epochs(self, o_sh: np.ndarray,
                      o_sl: np.ndarray) -> np.ndarray:
        """Copy of the main-row write epochs at (shard, slot) coordinates,
        recorded by the serve replica under the server lock when it
        takes a snapshot."""
        return self.main_epoch[o_sh, o_sl].copy()

    def epochs_unchanged(self, o_sh: np.ndarray, o_sl: np.ndarray,
                         epochs: np.ndarray) -> bool:
        """True iff every (shard, slot) row's main epoch still equals the
        exported value: the serve replica's staleness guard. A host read,
        safe without the lock: every write path bumps the epoch under the
        server lock BEFORE it enqueues its program, so a write that
        completed before this check is always seen."""
        return bool(np.array_equal(self.main_epoch[o_sh, o_sl], epochs))

    def _vals_bucket(self, vals, bucket: int) -> np.ndarray:
        v = np.zeros((bucket, self.value_length), dtype=np.float32)
        v[: vals.shape[0]] = np.asarray(vals)
        return v

    # index-level ops (np.int32 index arrays, padded here)

    def gather(self, o_shard, o_slot, c_shard, c_slot, use_cache):
        n = len(o_shard)
        self.gathers += 1
        if self.res is not None:
            from ..tier import coldpath
            return coldpath.gather_tiered(self, o_shard, o_slot,
                                          c_shard, c_slot, use_cache)
        a = pad_bucket(n, (o_shard, 0), (o_slot, OOB), (c_shard, 0),
                       (c_slot, OOB), (use_cache, False),
                       minimum=self.bucket_min)
        return self.port.gather(self.main, self.cache, self.delta, *a)

    def gather_pool(self, o_shard, o_slot, c_shard, c_slot, use_cache,
                    seg, nbags: int, pooling: str = "sum"):
        """Fused embedding-bag read: the member rows read as `gather`
        reads them, pooled into per-bag rows in one port program (K8).
        `seg` maps each member to its bag (< nbags); the result's first
        `nbags` rows are the pooled rows (the rest is bucket padding).
        Bit-identical to host-pooling this batch's `gather` rows with
        `np.add.at`."""
        n = len(o_shard)
        self.gathers += 1
        nb = bucket_size(max(int(nbags), 1), self.bucket_min)
        out = torch.zeros((nb, self.value_length), dtype=self.dtype,
                          device=self.main.device)
        if self.res is not None:
            from ..tier import coldpath
            return coldpath.gather_pool_tiered(
                self, o_shard, o_slot, c_shard, c_slot, use_cache, seg,
                out, pooling)
        a = pad_bucket(n, (o_shard, 0), (o_slot, OOB), (c_shard, 0),
                       (c_slot, OOB), (use_cache, False),
                       (np.asarray(seg, dtype=np.int32), OOB),
                       minimum=self.bucket_min)
        return self.port.gather_pool(self.main, self.cache, self.delta,
                                     *a, out, pooling=pooling)

    def stage_gather(self, o_shard, o_slot, c_shard, c_slot, use_cache,
                     pool: StagingPool):
        """The prefetch pipeline's gather: the same program (K1) and
        result as `gather` — a staged pull must be bit-identical to the
        pull it replaces — accounted against `pool`'s row budget.
        Returns (device rows, accounted row count), or None when the
        budget is spent (the consumer then pulls the plain way). The
        caller releases the rows when the entry is consumed or
        dropped."""
        rows = bucket_size(len(o_shard), self.bucket_min)
        if not pool.try_acquire(rows):
            return None
        try:
            return self.gather(o_shard, o_slot, c_shard, c_slot,
                               use_cache), rows
        except BaseException:
            pool.release(rows)
            raise

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
        if self.res is not None:
            from ..tier import coldpath
            coldpath.scatter_add_tiered(self, o_shard, o_slot,
                                        d_shard, d_slot, vals)
            return
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
        if self.res is not None:
            from ..tier import coldpath
            coldpath.set_rows_tiered(self, o_shard, o_slot, vals,
                                     c_shard, c_slot)
            return
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
        if self.res is not None:
            from ..tier import coldpath
            coldpath.replica_create_tiered(self, o_shard, o_slot,
                                           c_shard, c_slot)
            return
        a = pad_bucket(n, (o_shard, 0), (o_slot, OOB), (c_shard, 0),
                       (c_slot, OOB), minimum=self.bucket_min)
        self.cache, self.delta = self.port.replica_create(
            self.main, self.cache, self.delta, *a)

    def sync_replicas(self, r_shard, r_cslot, o_shard, o_slot,
                      threshold: float = 0.0, compress: str = "off"):
        n = len(r_shard)
        from ..tier.quant import wire_bytes_per_row
        self.sync_bytes_shipped += n * wire_bytes_per_row(
            compress, self.value_length)
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
        # threshold > 0: the ship/hold decision is made on the device,
        # so the tracking is left alone (replicas stay dirty)
        if self.res is not None:
            from ..tier import coldpath
            coldpath.sync_replicas_tiered(self, r_shard, r_cslot,
                                          o_shard, o_slot,
                                          threshold=threshold,
                                          compress=compress)
            return
        a = pad_bucket(n, (r_shard, 0), (r_cslot, OOB), (o_shard, 0),
                       (o_slot, OOB), minimum=self.bucket_min)
        out = self.port.sync_replicas(
            self.main, self.cache, self.delta, *a, threshold=threshold,
            compress=compress)
        if compress != "off":
            self.main, self.cache, self.delta, self._ef_resid_dev = out
        else:
            self.main, self.cache, self.delta = out

    def ef_residual_norm(self) -> float:
        """Max-abs residual parked by the most recent compressed sync
        round (device and tiered host rounds). Reading the device
        scalar waits for its round: snapshot time only."""
        dev = 0.0 if self._ef_resid_dev is None else \
            float(self._ef_resid_dev)
        return max(dev, self._ef_resid_host)

    def install_replica_rows(self, c_shard, c_slot, vals) -> None:
        """Install replicas of remote-owned keys: `vals` is the owner's
        base, the delta rows start at zero."""
        n = len(c_shard)
        # cross-process replica: its base comes from a remote owner, so
        # local epochs cannot track it (cross replicas are exempt from
        # the dirty filter — core/sync.py sync_channel)
        self.delta_dirty[c_shard, c_slot] = False
        a = pad_bucket(n, (c_shard, 0), (c_slot, OOB),
                       minimum=self.bucket_min)
        v = self._vals_bucket(vals, a[0].shape[0])
        self.cache, self.delta = self.port.install_rows(
            self.cache, self.delta, *a, v)

    def refresh_after_sync(self, c_shard, c_slot, fresh, shipped) -> None:
        """A cross-process sync round's landing: the owner's fresh value
        becomes the replica base and exactly the shipped delta leaves the
        delta row (K3), so a local read sees base + delta throughout."""
        n = len(c_shard)
        a = pad_bucket(n, (c_shard, 0), (c_slot, OOB),
                       minimum=self.bucket_min)
        b = a[0].shape[0]
        self.cache, self.delta = self.port.refresh_after_sync(
            self.cache, self.delta, *a,
            self._vals_bucket(fresh, b), self._vals_bucket(shipped, b))

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
        if self.res is not None:
            from ..tier import coldpath
            coldpath.relocate_tiered(self, old_shard, old_slot,
                                     new_shard, new_slot,
                                     rc_shard, rc_slot)
            return
        a = pad_bucket(n, (old_shard, 0), (old_slot, OOB), (new_shard, 0),
                       (new_slot, OOB), (rc_shard, 0), (rc_slot, OOB),
                       minimum=self.bucket_min)
        self.main, self.delta = self.port.relocate(
            self.main, self.delta, *a)

    def read_rows(self, which: str, sh, sl) -> np.ndarray:
        """Host readback of pool rows (non-destructive). Slot-indexed for
        "main" — tier-aware: hot rows from the device, cold rows from the
        cold store."""
        if which == "main" and self.res is not None:
            from ..tier import coldpath
            return coldpath.read_main_rows_tiered(self, sh, sl)
        n = len(sh)
        a = pad_bucket(n, (sh, 0), (sl, OOB), minimum=self.bucket_min)
        arr = {"main": self.main, "cache": self.cache,
               "delta": self.delta}[which]
        return self.port.read_rows_at(arr, *a)[:n].cpu().numpy()

    def read_hot_rows_at(self, sh: np.ndarray, row: np.ndarray) -> np.ndarray:
        """Host readback of hot-pool rows by DEVICE ROW (the demotion and
        relocation readback of a tiered store; non-destructive)."""
        n = len(sh)
        a = pad_bucket(n, (sh, 0), (row, OOB), minimum=self.bucket_min)
        return self.port.read_rows_at(self.main, *a)[:n].cpu().numpy()

    def main_host(self) -> np.ndarray:
        """The full authoritative main table [S, main_slots, L] on the
        host: one copy of the pool untiered, the cold store overlaid with
        the hot rows tiered."""
        if self.res is None:
            # an owned copy: on the CPU `.cpu()` is the pool itself
            return self.main.to("cpu", copy=True).numpy()
        from ..tier import coldpath
        return coldpath.main_full_host(self)

    @property
    def main_shape_full(self):
        """Shape of the authoritative main table (checkpoint geometry —
        the same whether or not the store is tiered, so checkpoints
        restore across tier configurations)."""
        return (self.ctx.num_shards, self.main_slots, self.value_length)

    def install_main_full(self, arr: np.ndarray) -> None:
        """Install a full main table [S, main_slots, L] (a loaded state):
        untiered into the pool, in place; tiered, it becomes the cold
        store and residency resets (everything cold, promoted again on
        access and intent)."""
        if self.res is None:
            self.main.copy_(torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32)))
            return
        from ..tier import coldpath
        coldpath.install_main_full(self, arr)

    def install_replica_pools(self, cache: np.ndarray,
                              delta: np.ndarray) -> None:
        """Install the cache and delta pools [S, cache_slots, L] (a
        loaded state), in place: a tensor captured before the install
        (a CUDA graph's pool argument) keeps reading the live pools."""
        for pool, arr in ((self.cache, cache), (self.delta, delta)):
            assert arr.shape == tuple(pool.shape), (
                f"pool geometry mismatch: {arr.shape} vs "
                f"{tuple(pool.shape)}")
            pool.copy_(torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32)))

    def block(self) -> None:
        if self.main.device.type == "cuda":
            dcuda.synchronize(self.main.device)
