"""The correct-but-slow cold path: main-row operations whose rows live
in the host cold store (the port of the JAX package's
`tier/coldpath.py`).

Every function here is the tiered twin of a `ShardedStore` program and
preserves its bit-exact semantics:

  - reads select the cold row's bits verbatim (a select, never `+ 0` —
    addition maps -0.0 to +0.0);
  - additive writes are single f32 adds on either side (in-batch
    duplicates accumulate in batch order on both K3 and `np.add.at`);
  - a replica sync against a cold owner extracts the delta (device
    readback), merges on host, and installs the post-merge value as the
    new base with a zeroed delta (or the parked residual, compressed) —
    the extract -> merge-all -> refresh-all order of the device round.

Callers hold the server lock (the residency discipline, residency.py);
the readbacks these paths pay are the cold tier's cost — misses are
served correctly and queued for promotion so repeated access turns hot.

The cold store may be quantized (--sys.tier.cold_dtype, tier/quant.py):
every access below goes through `store.coldq`, whose fp32 mode is a
raw-array passthrough. A cold row's visible value is its dequantized
stored value, the same through the card's dequantizing reads (K9
`gather_cold`, K10 `gather_pool_cold`) and the host reads here. Every
device program goes through the store's DevicePort.
"""
from __future__ import annotations

import time

import numpy as np

from ..core.store import OOB, pad_bucket, pad_to

# ---------------------------------------------------------------------------
# residency resolution
# ---------------------------------------------------------------------------


def split_owner(store, o_sh: np.ndarray, o_sl: np.ndarray):
    """Resolve owner (shard, slot) coordinates against the residency
    map. Returns (g_row, cold, valid): the device hot-pool row per entry
    (OOB where the entry is padding/replica-served or cold), the cold
    mask, and the valid-entry mask."""
    o_sh = np.asarray(o_sh, dtype=np.int64).ravel()
    o_sl = np.asarray(o_sl, dtype=np.int64).ravel()
    valid = (o_sl >= 0) & (o_sl != OOB)
    g_row = np.full(o_sl.shape, OOB, dtype=np.int32)
    cold = np.zeros(o_sl.shape, dtype=bool)
    if valid.any():
        rows = store.res.dev_row[o_sh[valid], o_sl[valid]]
        g_row[valid] = np.where(rows >= 0, rows, OOB)
        cold[valid] = rows < 0
    return g_row, cold, valid


def _note_access(store, o_sh, o_sl, cold, valid) -> None:
    """Score the touched rows, count hot/cold serves, and queue cold
    rows for promotion (waking the maintenance worker — the miss path
    must drive adaptation even in workloads that never signal intent
    or serve lookups)."""
    res = store.res
    if valid.any():
        res.touch(o_sh[valid], o_sl[valid])
    nc = int(cold.sum())
    store.tier_hot_hits += int(valid.sum()) - nc
    store.tier_cold_hits += nc
    if nc:
        res.request_promote(o_sh[cold], o_sl[cold])
        res.kick()


# ---------------------------------------------------------------------------
# tiered store ops (called by ShardedStore when residency is enabled;
# caller holds the server lock)
# ---------------------------------------------------------------------------


def gather_tiered(store, o_shard, o_slot, c_shard, c_slot, use_cache):
    o_sh = np.asarray(o_shard, dtype=np.int64).ravel()
    o_sl = np.asarray(o_slot, dtype=np.int64).ravel()
    g_row, cold, valid = split_owner(store, o_sh, o_sl)
    _note_access(store, o_sh, o_sl, cold, valid)
    n = len(o_sh)
    a = pad_bucket(n, (o_sh.astype(np.int32), 0), (g_row, OOB),
                   (c_shard, 0), (c_slot, OOB), (use_cache, False),
                   minimum=store.bucket_min)
    if not cold.any():
        return store.port.gather(store.main, store.cache,
                                 store.delta, *a)
    t0 = time.perf_counter()
    b = a[0].shape[0]
    use_cold = np.zeros(b, dtype=bool)
    use_cold[:n] = cold
    mode = store.coldq.mode
    if mode == "fp32":
        cold_vals = np.zeros((b, store.value_length), dtype=np.float32)
        cold_vals[:n][cold] = store.coldq.read(o_sh[cold], o_sl[cold])
        out = store.port.gather_cold(store.main, store.cache,
                                     store.delta, *a, cold_vals,
                                     use_cold)
    else:
        # dequant-fused cold-miss gather (the port's wire ingest): ship
        # the WIRE rows — half/quarter the host->device bytes — and
        # invert the format inside the gather program itself
        q, s = store.coldq.wire(o_sh[cold], o_sl[cold])
        qbuf = np.zeros((b, store.value_length), dtype=q.dtype)
        qbuf[:n][cold] = q
        sbuf = None
        if mode != "fp16":
            sbuf = np.zeros(b, dtype=np.float32)
            sbuf[:n][cold] = s
        out = store.port.gather_cold_wire(
            mode, store.main, store.cache, store.delta, *a,
            qbuf, sbuf, use_cold)
    if store.tier_hist is not None:
        store.tier_hist.observe(time.perf_counter() - t0)
    return out


def gather_pool_tiered(store, o_shard, o_slot, c_shard, c_slot,
                       use_cache, seg, out, pooling):
    """`gather_tiered`'s fused-bag twin: identical residency
    resolution and cold-row staging, but the member rows reduce into
    `out` inside the port program (`gather_pool_cold[_wire]`) instead
    of coming back raw. The pooled result is bit-identical to host-
    pooling `gather_tiered`'s rows — the gather half is the same
    program body, and the segment sum accumulates in batch order on
    both sides."""
    o_sh = np.asarray(o_shard, dtype=np.int64).ravel()
    o_sl = np.asarray(o_slot, dtype=np.int64).ravel()
    g_row, cold, valid = split_owner(store, o_sh, o_sl)
    _note_access(store, o_sh, o_sl, cold, valid)
    n = len(o_sh)
    a = pad_bucket(n, (o_sh.astype(np.int32), 0), (g_row, OOB),
                   (c_shard, 0), (c_slot, OOB), (use_cache, False),
                   minimum=store.bucket_min)
    b = a[0].shape[0]
    segb = pad_to(np.asarray(seg, dtype=np.int32), b, OOB)
    if not cold.any():
        return store.port.gather_pool(store.main, store.cache,
                                      store.delta, *a, segb, out,
                                      pooling=pooling)
    t0 = time.perf_counter()
    use_cold = np.zeros(b, dtype=bool)
    use_cold[:n] = cold
    mode = store.coldq.mode
    if mode == "fp32":
        cold_vals = np.zeros((b, store.value_length), dtype=np.float32)
        cold_vals[:n][cold] = store.coldq.read(o_sh[cold], o_sl[cold])
        pooled = store.port.gather_pool_cold(
            store.main, store.cache, store.delta, *a, cold_vals,
            use_cold, segb, out, pooling=pooling)
    else:
        q, s = store.coldq.wire(o_sh[cold], o_sl[cold])
        qbuf = np.zeros((b, store.value_length), dtype=q.dtype)
        qbuf[:n][cold] = q
        sbuf = None
        if mode != "fp16":
            sbuf = np.zeros(b, dtype=np.float32)
            sbuf[:n][cold] = s
        pooled = store.port.gather_pool_cold_wire(
            mode, store.main, store.cache, store.delta, *a,
            qbuf, sbuf, use_cold, segb, out, pooling=pooling)
    if store.tier_hist is not None:
        store.tier_hist.observe(time.perf_counter() - t0)
    return pooled


def scatter_add_tiered(store, o_shard, o_slot, d_shard, d_slot, vals):
    o_sh = np.asarray(o_shard, dtype=np.int64).ravel()
    o_sl = np.asarray(o_slot, dtype=np.int64).ravel()
    g_row, cold, valid = split_owner(store, o_sh, o_sl)
    _note_access(store, o_sh, o_sl, cold, valid)
    rows = np.asarray(vals, dtype=np.float32).reshape(
        len(o_sh), store.value_length)
    if cold.any():
        # additive merge on the authoritative host row (in-batch
        # duplicates accumulate in batch order, like the device
        # scatter; quantized modes fold through the EF residual)
        store.coldq.add_at(o_sh[cold], o_sl[cold], rows[cold])
    n = len(o_sh)
    a = pad_bucket(n, (o_sh.astype(np.int32), 0), (g_row, OOB),
                   (d_shard, 0), (d_slot, OOB), minimum=store.bucket_min)
    v = store._vals_bucket(rows, a[0].shape[0])
    store.main, store.delta = store.port.scatter_add(
        store.main, store.delta, *a, v)


def set_rows_tiered(store, o_shard, o_slot, vals, c_shard, c_slot):
    o_sh = np.asarray(o_shard, dtype=np.int64).ravel()
    o_sl = np.asarray(o_slot, dtype=np.int64).ravel()
    g_row, cold, valid = split_owner(store, o_sh, o_sl)
    _note_access(store, o_sh, o_sl, cold, valid)
    rows = np.asarray(vals, dtype=np.float32).reshape(
        len(o_sh), store.value_length)
    if cold.any():
        store.coldq.set_at(o_sh[cold], o_sl[cold], rows[cold])
    n = len(o_sh)
    a = pad_bucket(n, (o_sh.astype(np.int32), 0), (g_row, OOB),
                   (c_shard, 0), (c_slot, OOB), minimum=store.bucket_min)
    v = store._vals_bucket(rows, a[0].shape[0])
    store.main, store.cache, store.delta = store.port.set_rows(
        store.main, store.cache, store.delta, a[0], a[1], v,
        a[2], a[3])


def replica_create_tiered(store, o_shard, o_slot, c_shard, c_slot):
    """Materialize replicas: hot owners through the device program (with
    remapped rows), cold owners via host read + base install."""
    o_sh = np.asarray(o_shard, dtype=np.int64).ravel()
    o_sl = np.asarray(o_slot, dtype=np.int64).ravel()
    c_sh = np.asarray(c_shard, dtype=np.int32).ravel()
    c_sl = np.asarray(c_slot, dtype=np.int32).ravel()
    g_row, cold, valid = split_owner(store, o_sh, o_sl)
    hot = valid & ~cold
    if hot.any():
        a = pad_bucket(int(hot.sum()),
                       (o_sh[hot].astype(np.int32), 0), (g_row[hot], OOB),
                       (c_sh[hot], 0), (c_sl[hot], OOB),
                       minimum=store.bucket_min)
        store.cache, store.delta = store.port.replica_create(
            store.main, store.cache, store.delta, *a)
    if cold.any():
        # a fresh replica copies the VISIBLE cold value (deq only —
        # the parked residual stays with the owner row)
        vals = store.coldq.read(o_sh[cold], o_sl[cold])
        a = pad_bucket(int(cold.sum()), (c_sh[cold], 0), (c_sl[cold], OOB),
                       minimum=store.bucket_min)
        v = store._vals_bucket(vals, a[0].shape[0])
        store.cache, store.delta = store.port.install_cache_rows(
            store.cache, store.delta, *a, v)


def sync_replicas_tiered(store, r_shard, r_cslot, o_shard, o_slot,
                         threshold: float = 0.0, compress: str = "off"):
    """One sync batch with tier-aware owners: replicas of hot owners
    ride the fused device program; replicas of cold owners sync through
    the cold path — delta readback → host merge → base install (the
    tentpole's "replicas of cold keys sync through the cold path").
    `compress` applies the --sys.sync.compress wire transform on both
    halves: the device program for hot owners, the host twin
    (quant.compress_delta) for cold owners — with the residual parked
    in the replica's delta row either way."""
    r_sh = np.asarray(r_shard, dtype=np.int32).ravel()
    r_cs = np.asarray(r_cslot, dtype=np.int32).ravel()
    o_sh = np.asarray(o_shard, dtype=np.int64).ravel()
    o_sl = np.asarray(o_slot, dtype=np.int64).ravel()
    g_row, cold, valid = split_owner(store, o_sh, o_sl)
    hot = ~cold  # invalid (padding) entries ride the device program: OOB
    if hot.any():
        a = pad_bucket(int(hot.sum()), (r_sh[hot], 0), (r_cs[hot], OOB),
                       (o_sh[hot].astype(np.int32), 0), (g_row[hot], OOB),
                       minimum=store.bucket_min)
        out = store.port.sync_replicas(
            store.main, store.cache, store.delta, *a,
            threshold=threshold, compress=compress)
        if compress != "off":
            (store.main, store.cache, store.delta,
             store._ef_resid_dev) = out
        else:
            store.main, store.cache, store.delta = out
    if not cold.any():
        return
    t0 = time.perf_counter()
    ci = np.nonzero(cold)[0]
    # extract: the pending deltas of the cold-owner replicas (the
    # readback serializes behind every enqueued delta write — exact)
    dvals = store.read_rows("delta", r_sh[ci], r_cs[ci])
    ship = np.ones(len(ci), dtype=bool)
    if threshold > 0.0:
        # the reference's sync threshold, decided on host for cold rows
        # (the device program decides on device for hot rows)
        ship = np.max(np.abs(dvals), axis=1) >= threshold
    if ship.any():
        si = ci[ship]
        merged = dvals[ship]
        resid = None
        if compress != "off":
            # host twin of _sync_replicas_compressed: the owner merges
            # what the wire format reconstructs; the remainder parks in
            # the replica's delta row below
            from .quant import compress_delta
            merged, resid = compress_delta(compress, merged)
            if len(resid):
                store._ef_resid_host = float(np.max(np.abs(resid)))
        # merge-all THEN refresh-all, like the device program: all
        # shipped deltas land before any fresh value is read, so every
        # replica of a key sees the post-merge value
        store.coldq.add_at(o_sh[si], o_sl[si], merged)
        fresh = store.coldq.read(o_sh[si], o_sl[si])
        a = pad_bucket(len(si), (r_sh[si], 0), (r_cs[si], OOB),
                       minimum=store.bucket_min)
        v = store._vals_bucket(fresh, a[0].shape[0])
        rv = None if resid is None else \
            store._vals_bucket(resid, a[0].shape[0])
        store.cache, store.delta = store.port.install_cache_rows(
            store.cache, store.delta, *a, v, resid=rv)
    if store.tier_hist is not None:
        store.tier_hist.observe(time.perf_counter() - t0)


def relocate_tiered(store, old_shard, old_slot, new_shard, new_slot,
                    rc_shard, rc_slot):
    """Relocation on the tiered store runs through the host: read the
    authoritative old rows (device readback where hot, cold store
    otherwise), merge the destination replica's pending delta, land the
    moved rows COLD at the destination (relocation is intent-driven, so
    the pin/promote path makes them hot right after), and free the old
    residency. All reads happen before all writes — the device
    program's intra-batch slot-reuse discipline."""
    from .promote import release_rows
    old_sh = np.asarray(old_shard, dtype=np.int64).ravel()
    old_sl = np.asarray(old_slot, dtype=np.int64).ravel()
    new_sh = np.asarray(new_shard, dtype=np.int64).ravel()
    new_sl = np.asarray(new_slot, dtype=np.int64).ravel()
    rc_sh = np.asarray(rc_shard, dtype=np.int32).ravel()
    rc_sl = np.asarray(rc_slot, dtype=np.int32).ravel()
    n = len(old_sh)
    g_row, cold, valid = split_owner(store, old_sh, old_sl)
    rows = np.zeros((n, store.value_length), dtype=np.float32)
    hot = valid & ~cold
    if hot.any():
        rows[hot] = store.read_hot_rows_at(old_sh[hot].astype(np.int32),
                                           g_row[hot])
    if cold.any():
        # a relocation MOVES the authoritative value: take the full-
        # precision row (deq + parked residual, consuming it) so the
        # error-feedback state travels with the key
        rows[cold] = store.coldq.take_true(old_sh[cold], old_sl[cold])
    has_rc = (rc_sl != OOB) & (rc_sl >= 0)
    if has_rc.any():
        d = store.read_rows("delta", rc_sh[has_rc], rc_sl[has_rc])
        rows[has_rc] += d
        a = pad_bucket(int(has_rc.sum()), (rc_sh[has_rc], 0),
                       (rc_sl[has_rc], OOB), minimum=store.bucket_min)
        store.delta = store.port.clear_rows(store.delta, *a)
    # free the old residency (value already extracted), land cold
    release_rows(store, old_sh[valid], old_sl[valid])
    dst_ok = (new_sl >= 0) & (new_sl != OOB)
    if dst_ok.any():
        store.coldq.set_at(new_sh[dst_ok], new_sl[dst_ok], rows[dst_ok])
        # defensively clear any stale mapping at the destination slot
        # (a correctly-released slot is already -1)
        store.res.dev_row[new_sh[dst_ok], new_sl[dst_ok]] = -1


def read_main_rows_tiered(store, sh, sl) -> np.ndarray:
    """Host readback of main rows on the tiered store (read_rows'
    "main" pool): hot rows via a device gather, cold rows from the cold
    store."""
    sh = np.asarray(sh, dtype=np.int64).ravel()
    sl = np.asarray(sl, dtype=np.int64).ravel()
    g_row, cold, valid = split_owner(store, sh, sl)
    out = np.zeros((len(sh), store.value_length), dtype=np.float32)
    hot = valid & ~cold
    if hot.any():
        out[hot] = store.read_hot_rows_at(sh[hot].astype(np.int32),
                                          g_row[hot])
    if cold.any():
        out[cold] = store.coldq.read(sh[cold], sl[cold])
    return out


def read_main_rows_bulk(store, sh: np.ndarray,
                        sl: np.ndarray) -> np.ndarray:
    """Bulk-scale host read of main rows (checkpoint/eval/export path):
    fancy-index the REQUESTED rows out of the cold store (no full-table
    copy — at beyond-HBM model sizes a whole-table copy would
    transiently double host RAM) and overlay the hot subset via one
    device gather of those rows (bounded by hot_rows, not model size)."""
    sh = np.asarray(sh, dtype=np.int64).ravel()
    sl = np.asarray(sl, dtype=np.int64).ravel()
    # fancy index -> copy of the REQUESTED rows only; quantized modes
    # dequantize that same bounded slice (wire copy + f32 result), so
    # the dequant path keeps the no-second-full-table-copy contract
    out = store.coldq.read(sh, sl)
    rows = store.res.dev_row[sh, sl]
    m = rows >= 0
    if m.any():
        out[m] = store.read_hot_rows_at(sh[m].astype(np.int32),
                                        rows[m].astype(np.int32))
    return out


def main_full_host(store) -> np.ndarray:
    """Assemble the full authoritative main table [S, main_slots, L] on
    host (checkpoint save, bulk reads): the cold store overlaid with the
    hot pool's rows. One device readback of the whole hot pool."""
    full = store.coldq.full()
    res = store.res
    sh_idx, row_idx = np.nonzero(res.row_slot >= 0)
    if len(sh_idx):
        hot_host = store.main.cpu().numpy()
        full[sh_idx, res.row_slot[sh_idx, row_idx]] = \
            hot_host[sh_idx, row_idx]
    return full


def install_main_full(store, arr: np.ndarray) -> None:
    """Checkpoint restore into a tiered store: the full main table
    becomes the cold store and residency resets — everything cold,
    re-promoted lazily by access/intent (the restore contract,
    tests/test_tier.py)."""
    store.coldq.install_full(np.asarray(arr, dtype=np.float32))
    store.res.reset()
