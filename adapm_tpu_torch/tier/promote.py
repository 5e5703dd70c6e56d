"""Batched promotion/demotion between the device-hot pool and the host
cold store: the port of the JAX package's `tier/promote.py`.

Promotion is one upload per (class, shard) batch: the cold rows'
authoritative host values, in the cold store's wire format, are written
into freshly-allocated hot rows by K11 `write_main_rows` (the port's
`write_main_rows[_wire]`, dequantizing in the write; the hot pool is
the bound, and it is updated in place, never reallocated). Demotion is the
reverse: a device gather readback lands the rows in the cold store and
frees the device rows. Both are BIT-EXACT moves — a float32 row is the
same bits on either side — so residency changes can never change what a
Pull/Push/serve lookup returns (the tentpole's bit-identity contract,
pinned by tests/test_tier.py's storm).

Discipline: mutations run under the server lock and bump the store's
residency epoch (see residency.py). The maintenance worker computes its
victim plans OUTSIDE the lock against an epoch snapshot and revalidates
under the lock before acting — stale plans are recomputed, never
dispatched (the topology_version discipline applied to residency).
"""
from __future__ import annotations

import threading
from functools import partial

import numpy as np

from ..core.store import OOB, pad_bucket


def promote_rows(store, shard: int, slots: np.ndarray) -> int:
    """Promote cold `slots` of `shard` into the hot pool (caller holds
    the server lock). Capacity-bounded: only as many rows as the free
    list covers promote; the surplus stays cold — slower, never wrong.
    Returns the number promoted."""
    res = store.res
    slots = np.unique(np.asarray(slots, dtype=np.int64))
    slots = slots[res.dev_row[shard, slots] < 0]
    if len(slots) == 0:
        return 0
    rows = res.alloc.alloc_batch(shard, len(slots))
    take = slots[: len(rows)]
    if len(take) == 0:
        return 0
    a = pad_bucket(len(take),
                   (np.full(len(take), shard, np.int32), 0),
                   (rows.astype(np.int32), OOB),
                   minimum=store.bucket_min)
    b = a[0].shape[0]
    mode = store.coldq.mode
    if mode == "fp32":
        v = store._vals_bucket(store.coldq.read(
            np.full(len(take), shard), take), b)
        store.main = store.port.write_main_rows(store.main, a[0],
                                                a[1], v)
    else:
        # dequant-fused upload (the port's wire ingest): ship the WIRE
        # rows — half/quarter the host->device bytes — and invert the
        # format inside the write (K11). Rows with a parked EF
        # residual (few) get their full-precision value re-set exactly
        # right after: the residual folds into the promote, so the hot
        # row carries the true long-run sum (docs/MEMORY.md contract).
        q, s, fix_pos, fix_vals = store.coldq.promote_wire(shard, take)
        qb = np.zeros((b, store.value_length), dtype=q.dtype)
        qb[: len(take)] = q
        sb = None
        if mode != "fp16":
            sb = np.zeros(b, dtype=np.float32)
            sb[: len(take)] = s
        store.main = store.port.write_main_rows_wire(
            mode, store.main, a[0], a[1], qb, sb)
        if len(fix_pos):
            f = pad_bucket(len(fix_pos),
                           (np.full(len(fix_pos), shard, np.int32), 0),
                           (rows[fix_pos].astype(np.int32), OOB),
                           minimum=store.bucket_min)
            fv = store._vals_bucket(fix_vals, f[0].shape[0])
            store.main = store.port.write_main_rows(store.main, f[0],
                                                    f[1], fv)
    res.dev_row[shard, take] = rows
    res.row_slot[shard, rows] = take
    res.epoch += 1
    return len(take)


def demote_rows(store, shard: int, slots: np.ndarray) -> int:
    """Demote hot `slots` of `shard` back to the cold store (caller
    holds the server lock). The readback synchronizes with every
    enqueued program on the pool (dispatch order), so the landed bits
    are the row's current authoritative value. Returns rows demoted."""
    res = store.res
    slots = np.unique(np.asarray(slots, dtype=np.int64))
    rows = res.dev_row[shard, slots]
    m = rows >= 0
    slots, rows = slots[m], rows[m]
    if len(slots) == 0:
        return 0
    vals = store.read_hot_rows_at(
        np.full(len(rows), shard, dtype=np.int32), rows.astype(np.int32))
    # land the readback in the cold tier's at-rest format; quantized
    # modes park the sub-grid remainder as the demote's EF residual
    # (folded back in at the next promote — docs/MEMORY.md contract)
    store.coldq.set_at(np.full(len(slots), shard), slots, vals)
    res.dev_row[shard, slots] = -1
    res.row_slot[shard, rows] = -1
    res.alloc.free_batch(shard, rows)
    res.epoch += 1
    return len(slots)


def release_rows(store, shards: np.ndarray, slots: np.ndarray) -> None:
    """Free the residency of slots leaving the store entirely (slot
    free on relocation/abandonment): the hot rows are returned WITHOUT a
    copy-back — the caller has already read the authoritative value out.
    Caller holds the server lock."""
    res = store.res
    if res is None or len(slots) == 0:
        return
    shards = np.asarray(shards, dtype=np.int64).ravel()
    slots = np.asarray(slots, dtype=np.int64).ravel()
    changed = False
    for s in np.unique(shards):
        sl = slots[shards == s]
        rows = res.dev_row[s, sl]
        hot = rows >= 0
        if hot.any():
            res.row_slot[s, rows[hot]] = -1
            res.alloc.free_batch(int(s), rows[hot])
            res.dev_row[s, sl[hot]] = -1
            changed = True
        res.score[s, sl] = 0
        res.pin_until[s, sl] = -1
        # the slot's value has left the store: its parked EF residual
        # must not leak onto whatever key reuses the slot
        store.coldq.drop_resid(np.full(len(sl), int(s)), sl)
    if changed:
        res.epoch += 1


def _count_demotions(server, n: int) -> None:
    """Fold victim demotions into tier.demotions (the promotions/
    demotions pair must balance occupancy, so EVERY demote_rows path
    counts — eviction victims included, not just the pressure worker
    and the tooling surface)."""
    if n and getattr(server, "tier", None) is not None:
        server.tier.c_demotions.inc(n)


def _pick_victims(store, shard: int, need: int, min_clock: int,
                  protect: np.ndarray,
                  force: bool = False) -> np.ndarray:
    """Lowest-score, unpinned hot slots of `shard` (up to `need`), never
    from `protect` (the batch being made hot right now). `force=True`
    falls back to PINNED rows (still never `protect`) when unpinned
    victims alone cannot cover `need` — the fused-step path, where the
    current batch being hot is a correctness requirement and an older
    pin is only a performance hint."""
    res = store.res
    rows = np.nonzero(res.row_slot[shard] >= 0)[0]
    if len(rows) == 0:
        return np.empty(0, dtype=np.int64)
    slots = res.row_slot[shard, rows].astype(np.int64)
    if len(protect):
        slots = slots[~np.isin(slots, protect)]
    unpinned = slots[~res.pinned_mask(shard, slots, min_clock)]
    cand = unpinned
    if force and len(unpinned) < need:
        pinned = slots[res.pinned_mask(shard, slots, min_clock)]
        cand = np.concatenate([unpinned, pinned])
        # prefer unpinned victims; overflow into pinned by score
        if len(cand) > need:
            extra = need - len(unpinned)
            sc = res.score[shard, pinned]
            pick = pinned[np.argpartition(sc, extra - 1)[:extra]] \
                if extra < len(pinned) else pinned
            return np.concatenate([unpinned, pick])
        return cand
    if len(cand) <= need:
        return cand
    sc = res.score[shard, cand]
    idx = np.argpartition(sc, need - 1)[:need]
    return cand[idx]


def ensure_hot_rows(server, store, shards: np.ndarray, slots: np.ndarray,
                    min_clock: int = 0, force: bool = False) -> int:
    """Promote any cold rows among (shards, slots), demoting low-score
    unpinned victims when a shard's hot pool is full (caller holds the
    server lock). `force=True` (the fused-step path) additionally evicts
    PINNED victims — never the batch itself — and raises when even that
    cannot fit the batch (the batch's own unique rows exceed the hot
    pool: a configuration error, like a full cache pool). Returns rows
    promoted."""
    res = store.res
    n = 0
    for s in np.unique(shards):
        s = int(s)
        sl = np.unique(slots[shards == s]).astype(np.int64)
        cold = sl[res.dev_row[s, sl] < 0]
        if len(cold) == 0:
            continue
        if force:
            short = len(cold) - res.alloc.num_free(s)
            if short > 0:
                victims = _pick_victims(store, s, short, min_clock, sl,
                                        force=True)
                if len(victims):
                    _count_demotions(server,
                                     demote_rows(store, s, victims))
            got = promote_rows(store, s, cold)
            if got < len(cold):
                raise RuntimeError(
                    f"tier hot pool exhausted on shard {s}: a fused "
                    f"step needs {len(cold)} cold rows hot but only "
                    f"{got} fit (hot_rows={res.hot_rows}); raise "
                    f"--sys.tier.hot_rows above the step's per-shard "
                    f"unique-key working set")
            n += got
            continue
        # background (non-forced) policy — anti-thrash: PINNED cold
        # candidates (live intent windows) outrank unpinned residents
        # and may demote them; unpinned candidates fill free capacity
        # and beyond that evict only STRICTLY lower-scored unpinned
        # residents (equal scores never churn)
        is_pin = res.pinned_mask(s, cold, min_clock)
        pc, uc = cold[is_pin], cold[~is_pin]
        n_pinned, n_unpinned = len(pc), len(uc)
        n_victims = n_beat = 0
        if len(pc):
            short = len(pc) - res.alloc.num_free(s)
            if short > 0:
                victims = _pick_victims(store, s, short, min_clock, sl)
                n_victims += len(victims)
                if len(victims):
                    _count_demotions(server,
                                     demote_rows(store, s, victims))
            n += promote_rows(store, s, pc)
        pol = server.policy
        if len(uc) and pol is not None and pol.active("tier") and \
                pol.consult("tier", {"n_pinned": n_pinned,
                                     "n_unpinned": n_unpinned},
                            n_pinned + n_unpinned):
            # a learned tier law's predicted promoted-never-hit regret
            # HOLDS this shard's unpinned background promotions: the rows
            # stay cold and read exactly from the cold pool (slower,
            # never wrong). Pinned candidates and the force=True fused
            # step are never policy-gated
            pol.applied("tier")
            uc = uc[:0]
        if len(uc):
            over = len(uc) - res.alloc.num_free(s)
            if over > 0:
                uc = uc[np.argsort(-res.score[s, uc], kind="stable")]
                victims = _pick_victims(store, s, over, min_clock, sl)
                n_victims += len(victims)
                if len(victims):
                    victims = victims[np.argsort(
                        res.score[s, victims], kind="stable")]
                    k = min(len(victims), len(uc))
                    beat = res.score[s, victims[:k]] < \
                        res.score[s, uc[:k]]
                    n_beat = int(beat.sum())
                    if beat.any():
                        _count_demotions(
                            server,
                            demote_rows(store, s, victims[:k][beat]))
                uc = uc[: res.alloc.num_free(s)]
            if len(uc):
                n += promote_rows(store, s, uc)
        dc = server.decisions
        if dc is not None and (n_pinned or n_unpinned):
            # decision telemetry: this shard's promotion batch with the
            # anti-thrash verdict; the promoted rows open a window
            # probing re-touch while hot
            dc.record_tier(store, s, np.concatenate((pc, uc)),
                           n_pinned, n_unpinned, n_victims, n_beat,
                           min_clock)
    return n


class PromotionEngine:
    """The tier maintenance worker, as a self-rescheduling executor
    task on the `tier` stream (exec/executor.py). Each pass:

      1. drains the residency `want` queues (cold-miss and intent
         promotion requests) into batched `ensure_hot_rows` calls —
         DOUBLE-BUFFERED: the host-side prep of chunk N+1 (dedup,
         coordinate split) runs on the `tier` stream while chunk N's
         device scatter — committed on the `tier_commit` stream — is
         still in flight (GraphVite's episodic transfer/compute
         overlap; the exec.overlap_fraction gauge measures it);
      2. pressure-demotes: keeps a bounded free-row headroom per shard
         so hot-path promotions rarely wait on a victim readback;
      3. decays the access scores periodically (the CLOCK sweep).

    Every mutating batch takes the server lock for revalidation +
    ENQUEUE only (the lock-narrowing rule, docs/EXECUTOR.md); candidate
    scans run outside it and revalidate via the residency epoch.
    `run_once()` exposes one synchronous pass for deterministic tests
    and tooling. A pass that moved rows reschedules itself; an idle pass
    parks (no queued task). `failures` counts passes that raised (each
    is logged and retried after a backoff)."""

    _INTERVAL_S = 0.02
    _DECAY_EVERY = 64

    def __init__(self, server, opts, manager):
        self.server = server
        self.opts = opts
        self.manager = manager
        self._run_lock = threading.Lock()
        self._stop = False
        self._passes = 0
        self.failures = 0

    # -- producer ------------------------------------------------------------

    def kick(self) -> None:
        """Queue one maintenance pass (coalesced: a pass already queued
        absorbs the kick; a running pass reschedules itself while it
        finds work)."""
        if self._stop:
            return
        self.server.exec.submit("tier", self._pass,
                                label="tier.maintain",
                                coalesce_key="tier.maintain")

    # -- worker --------------------------------------------------------------

    def _pass(self) -> None:
        from ..utils import alog
        if self._stop:
            return
        delay = self._INTERVAL_S
        try:
            moved = self.run_once()
        except Exception as e:  # noqa: BLE001 — keep the worker up
            # retry after a backoff (the pre-PR thread loop's behavior):
            # a transient failure must not strand queued wants, pressure
            # demotion, and the CLOCK decay until the next external kick
            moved = 1
            delay = self._INTERVAL_S * 5
            self.failures += 1
            import traceback
            alog(f"[tier] maintenance pass failed: "
                 f"{type(e).__name__}: {e}\n{traceback.format_exc()}")
        if moved and not self._stop:
            # work found (or a failed pass retrying): keep draining at
            # the maintenance cadence
            self.server.exec.submit("tier", self._pass,
                                    label="tier.maintain",
                                    coalesce_key="tier.maintain",
                                    delay=delay)

    def run_once(self) -> int:
        """One maintenance pass (see class doc). Safe to call from any
        thread; takes the server lock internally per batch. Returns the
        number of rows moved (0 = the pass was a no-op).

        Passes are serialized (`_run_lock`): a synchronous pass
        (`TierManager.maintain`) waits for a background pass in flight,
        so on return every want queued before the call has been
        committed — by that pass or by this one."""
        with self._run_lock:
            return self._run_once()

    def _run_once(self) -> int:
        srv = self.server
        mgr = self.manager
        moved = 0
        min_clock = mgr._min_active_clock()
        batch = max(1, self.opts.tier_demote_batch)
        ex = srv.exec
        # double-buffering needs a second worker to run the commit
        # while this pass preps the next chunk; the serialized fallback
        # (--sys.exec.single_stream) and a closing executor commit
        # inline — same results, no overlap
        pipelined = (not ex.single_stream and not ex.closed
                     and ex.max_workers >= 2)
        for st in srv.stores:
            res = st.res
            # 1. drain promotion wants — deduplicated, then processed in
            # bounded chunks so no single lock hold scans an unbounded
            # batch (the whole drained set IS processed this pass; a
            # capped-and-dropped remainder would silently starve
            # intent-pinned promotions behind access-driven noise).
            # `take_wants` swaps the list under the residency's want
            # lock: a want appended concurrently lands in this drain or
            # the next, never in neither.
            wants = res.take_wants()
            if wants:
                sh = np.concatenate([w[0] for w in wants]).astype(np.int64)
                sl = np.concatenate([w[1] for w in wants]).astype(np.int64)
                pair = np.unique(sh * np.int64(res.main_slots) + sl)
                # DOUBLE-BUFFERED drain: chunk N commits (server lock ->
                # revalidate -> cold-row copy -> device scatter enqueue)
                # on the `tier_commit` stream while this pass preps
                # chunk N+1's coordinates on the `tier` stream — at most
                # one commit in flight, so host prep of batch N+1
                # overlaps the device upload of batch N and nothing
                # runs unboundedly ahead
                prev = None
                for lo in range(0, len(pair), 4 * batch):
                    p = pair[lo: lo + 4 * batch]
                    csh = (p // res.main_slots).astype(np.int32)
                    csl = (p % res.main_slots).astype(np.int32)
                    commit = partial(self._commit_chunk, st, csh, csl,
                                     min_clock)
                    if pipelined:
                        cur = ex.submit("tier_commit", commit,
                                        label="tier.promote_commit")
                    else:
                        cur = None
                        moved += commit()
                    if prev is not None:
                        moved += self._commit_result(prev)
                    prev = cur
                if prev is not None:
                    moved += self._commit_result(prev)
            # 2. pressure demotion: keep a MODEST free-row headroom per
            # shard so hot-path promotions rarely pay a victim readback
            # — bounded by a fraction of the pool, NOT the raw batch
            # knob (a target above the pool size would demote every
            # unpinned row every pass, a permanent demote/promote storm)
            target = min(batch, max(1, res.hot_rows // 8))
            for s in range(res.num_shards):
                free = res.alloc.num_free(s)
                if free >= target:
                    continue
                # plan outside the lock; revalidate epoch under it
                epoch = res.epoch
                victims = _pick_victims(st, s, target - free, min_clock,
                                        np.empty(0, dtype=np.int64))
                if len(victims) == 0:
                    continue
                with srv._lock:
                    if res.epoch != epoch:
                        # residency moved underneath the scan: replan
                        victims = _pick_victims(
                            st, s, target - res.alloc.num_free(s),
                            min_clock, np.empty(0, dtype=np.int64))
                    # a pin written since the scan (pins are lock-free
                    # and move no epoch) still protects its row: pressure
                    # never demotes a live pin
                    victims = victims[~res.pinned_mask(s, victims,
                                                       min_clock)]
                    n = demote_rows(st, s, victims) if len(victims) else 0
                if n:
                    moved += n
                    mgr.c_demotions.inc(n)
                    dc = srv.decisions
                    if dc is not None:
                        # headroom-reclaim demotion (outcome immediate)
                        dc.record_tier_demote(s, n, free, target)
        # 3. score decay
        self._passes += 1
        if self._passes % self._DECAY_EVERY == 0:
            for st in srv.stores:
                st.res.decay()
        return moved

    def _commit_chunk(self, st, sh: np.ndarray, sl: np.ndarray,
                      min_clock: int) -> int:
        """Commit one promotion chunk: server lock -> coordinate
        revalidation -> program enqueue (the lock-narrowing rule —
        dispatch itself is async under the gate)."""
        srv = self.server
        if srv.fault is not None:
            # injection point: fires BEFORE the commit takes the lock or
            # moves any row, so a retried commit (the executor policy on
            # `tier_commit`, or _pass's own backoff retry when inline)
            # re-runs cleanly; the wanted rows stay cold until a commit
            # succeeds — slower, never wrong
            srv.fault.fire("tier.promote")
        with srv._lock:
            n = ensure_hot_rows(srv, st, sh, sl, min_clock=min_clock)
        if n:
            self.manager.c_promotions.inc(n)
            wt = srv.wtrace
            if wt is not None:
                # the promotion as it landed: observational (replay's
                # candidate tier policy re-decides)
                wt.record_decision("promote", n)
        return n

    @staticmethod
    def _commit_result(completion) -> int:
        """Join one in-flight commit; a commit cancelled by executor
        close counts zero (teardown path)."""
        n = completion.result(timeout=60)
        return int(n or 0)

    def close(self) -> None:
        """Stop the worker (idempotent; drains the tier streams so no
        maintenance pass can outlive the server into pool teardown)."""
        self._stop = True
        ex = self.server.exec
        if not ex.closed:
            if not ex.drain("tier", timeout=30) or \
                    not ex.drain("tier_commit", timeout=30):
                from ..utils import alog
                alog("[tier] maintenance pass failed to drain within "
                     "30s of close")
