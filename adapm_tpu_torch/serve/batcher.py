"""Micro-batching coalescer: many concurrent lookups -> one gather.

The port of the JAX package's `serve/batcher.py`. The `LookupBatcher`
dispatches as event-driven drain programs on the server's executor:
every `AdmissionQueue.submit` kicks a coalesced drain for the request's
lane, and `--sys.serve.dispatchers N` runs N drains on distinct executor
streams (`serve`, `serve.1`, ...), one per admission lane. A drain

  1. takes up to `--sys.serve.max_batch` requests from its lane,
     lingering at most `--sys.serve.max_wait_us` after the first (the
     micro-batch window; while a batch's gather is in flight the queue
     refills, so sustained load coalesces without waiting);
  2. deduplicates the union key set (concurrent clients hit the same
     hot rows; the card gathers one row per unique key);
  3. serves the union from the read-only serve replica when one is
     attached (`--sys.serve.replica_rows`; serve/replica.py) and its
     snapshot covers the whole batch (no server lock, no device work);
     otherwise dispatches one K1 gather per length class through the
     Pull machinery the training path uses (the routing-plan cache,
     `Server._plan_pull`, `Server._pull` under the server lock), and
     scatters the union result back to each request.

Bag reads (`BagLookupRequest`) coalesce apart: their union is pooled by
K8 `gather_pool` (one launch per length class and pooling; on a tiered
store whose batch holds cold members, K10 `gather_pool_cold` through
tier/coldpath.py gather_pool_tiered), by the host over a replica
snapshot, or by the host over a flat union gather (`--sys.serve.bags 0`,
or a measured cost table that prefers it), with the same bits on every
path (serve/bags.py).

Consistency: the locked path's plan is computed outside the lock
against a `topology_version` snapshot and revalidated under the lock,
exactly as `Worker.pull` does; each class's gather is one program
enqueued under the lock, so every key of a batch is read from one pool
state. A serve lookup is therefore bit-identical to a plain
`Worker.pull` of the same keys at the same point in dispatch order.

Tiering feeds back through `tier.note_serve` (scores and promotion of
the looked-up cold keys). Request-flight tracing (`srv.flight`) records
each coalesced batch, and the fault plane (`srv.fault`) fires
`serve.drain`; the learned policy plane (`srv.policy`) sees each
batch's close reason and decision telemetry (`srv.decisions`) the
measured-cost verdicts. Each use stays behind an `is not None` guard,
as in the JAX package.
"""
from __future__ import annotations

import collections
import itertools
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.kv import _offsets, _select_flat
from ..exec.executor import dispatch_gate
from ..obs.metrics import BATCH_SIZE_BOUNDS, SERVE_LATENCY_BOUNDS_S
from .admission import AdmissionQueue, LookupRequest, ServeDegradedError
from .bags import BagLookupRequest, plan_bag_batch, pool_bags_host


def _shed_interrupted(reqs) -> None:
    """Fail every undelivered request of a batch whose dispatcher is
    being torn down by KeyboardInterrupt/SystemExit (so no waiter
    hangs); the caller re-raises."""
    for r in reqs:
        if not r._done.is_set():
            r.fail(RuntimeError(
                "serve dispatcher interrupted (KeyboardInterrupt/"
                "SystemExit): claimed batch shed"))


class LookupBatcher:
    """Owns the dispatch logic (drain programs on the per-lane executor
    streams); one per ServePlane."""

    def __init__(self, server, opts, queue: AdmissionQueue,
                 shard: int = 0):
        self.server = server
        self.opts = opts
        self.queue = queue
        # the shard serve lookups route from: a local replica there is
        # preferred, otherwise the owner row is gathered directly (all
        # shards' pools are one tensor on the card)
        self.shard = int(shard)
        # one drain stream per admission lane; stream 0 is `serve`
        self.dispatchers = max(1, int(getattr(opts, "serve_dispatchers",
                                              1)))
        self.streams = ["serve"] + [f"serve.{i}"
                                    for i in range(1, self.dispatchers)]
        # wall-clock start of the batch each dispatcher is serving (None
        # = idle). Written only by the owning drain; read lock-free by
        # the health monitor's wedge probe.
        self._busy_since: List[Optional[float]] = \
            [None] * self.dispatchers
        # lane assignment: by length class on multi-class servers, else
        # round-robin so single-class load still spreads over N lanes
        self._rr = itertools.count()
        # read-only serve replica (serve/replica.py), attached by
        # ServePlane when --sys.serve.replica_rows > 0
        self.replica = None
        # the effective micro-batch window: the static knob, adapted by
        # the SLO controller (obs/slo.py) only when --sys.serve.slo_ms
        # is set
        self.max_wait_us = int(opts.serve_max_wait_us)
        # per-priority-class windows ({prio: wait_us}) and their bounded
        # sample ring of (t, latency_s, prio): set by the SLO controller
        # only for --sys.serve.slo_ms class overrides
        self.class_wait_us: Optional[Dict[int, int]] = None
        self._class_samples: Optional[collections.deque] = None
        self._running = False
        reg = server.obs
        # shared=True: a plane rebuilt on the same server reuses them
        self.c_lookups = reg.counter("serve.lookups_total", shared=True)
        self.c_batches = reg.counter("serve.batches_total", shared=True)
        self.c_keys = reg.counter("serve.keys_total", shared=True)
        self.c_keys_unique = reg.counter("serve.keys_deduped_total",
                                         shared=True)
        self.c_replica_hits = reg.counter("serve.replica_hits_total",
                                          shared=True)
        if reg.enabled:
            reg.gauge("serve.replica_hit_rate", shared=True,
                      fn=self.replica_hit_rate)
        self.h_latency = reg.histogram("serve.latency_s",
                                       bounds=SERVE_LATENCY_BOUNDS_S,
                                       shared=True)
        self.h_batch = reg.histogram("serve.batch_size", unit="requests",
                                     bounds=BATCH_SIZE_BOUNDS, shared=True)
        # bag reads: requests and pooled vectors delivered, and which
        # path produced the bits (K8 batches vs host-pooled batches, the
        # replica-snapshot subset of the latter counted apart)
        self.c_bag_lookups = reg.counter("serve.bag_lookups_total",
                                         shared=True)
        self.c_bag_pooled = reg.counter("serve.bag_pooled_total",
                                        shared=True)
        self.c_bag_fused = reg.counter("serve.bag_fused_total",
                                       shared=True)
        self.c_bag_hostpool = reg.counter("serve.bag_hostpool_total",
                                          shared=True)
        self.c_bag_replica_hits = reg.counter(
            "serve.bag_replica_hits_total", shared=True)

    def replica_hit_rate(self) -> float:
        """Fraction of coalesced batches served from the read-only
        replica snapshot (0 with no replica attached)."""
        b = float(self.c_batches.value)
        return float(self.c_replica_hits.value) / b if b else 0.0

    # -- lane assignment (called by ServeSession) ----------------------------

    def assign_lane(self, keys: np.ndarray) -> int:
        """Admission lane for a request: its length class on multi-class
        servers, round-robin otherwise; lane 0 with one dispatcher."""
        if self.dispatchers == 1:
            return 0
        srv = self.server
        if len(srv.stores) > 1 and len(keys):
            return int(srv.ab.key_class[keys[0]]) % self.dispatchers
        return next(self._rr) % self.dispatchers

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self.queue.set_kick(self._kick)
        for lane in range(self.dispatchers):
            self._kick(lane)  # drain anything admitted before start

    def stop(self) -> None:
        """Close the queue (failing queued requests loudly) and drain
        every dispatcher stream under ONE 30 s bound. A drain that does
        not finish within it is wedged and still reads the pools, so
        this raises instead of proceeding into teardown (and keeps
        `_running` set, so readiness stays truthful)."""
        self.queue.set_kick(None)
        self.queue.close()
        ex = self.server.exec
        if not ex.closed and not ex.drain_streams(self.streams,
                                                  timeout=30):
            from ..utils import alog
            alog("[serve] dispatcher(s) failed to exit within 30s — "
                 "wedged mid-dispatch")
            raise RuntimeError(
                "serve dispatcher wedged: did not exit within 30s "
                "of queue close; refusing to proceed into pool "
                "teardown under a live reader")
        self._running = False

    def is_alive(self) -> bool:
        """Started, not stopped, and the executor that runs the drain
        programs is still open."""
        return self._running and not self.server.exec.closed

    def wedged_dispatchers(self, bound_s: float) -> List[int]:
        """Dispatchers serving ONE batch for longer than `bound_s`. Reads
        the busy stamps lock-free: a wedged drain cannot be asked."""
        now = time.monotonic()
        return [i for i, t in enumerate(self._busy_since)
                if t is not None and now - t > bound_s]

    # -- dispatchers ---------------------------------------------------------

    def _kick(self, lane: int = 0) -> None:
        """Queue one drain for `lane` on its stream (coalesced: kicks
        landing while that drain is queued are absorbed; a kick during a
        RUNNING drain queues the next one, so no admitted request is
        left undrained)."""
        if self._running:
            self.server.exec.submit(
                self.streams[lane], lambda: self._drain(lane),
                label=f"serve.drain.{lane}",
                coalesce_key=f"serve.drain.{lane}")

    def _drain(self, lane: int) -> None:
        """Serve micro-batches until the lane is empty (one executor
        program). The non-blocking take still lingers up to the
        micro-batch window after claiming a first request."""
        srv = self.server
        if srv.fault is not None:
            # injection point: fires BEFORE any request is claimed; the
            # lane is re-kicked first, so a drain whose retries run out
            # still leaves a follow-up drain queued
            try:
                srv.fault.fire("serve.drain")
            except BaseException:
                if self._running:
                    srv.exec.submit(
                        self.streams[lane], lambda: self._drain(lane),
                        label=f"serve.drain.{lane}",
                        coalesce_key=f"serve.drain.{lane}", delay=0.02)
                raise
        max_batch = self.opts.serve_max_batch
        while True:
            # re-read per batch: the SLO controller adapts the window
            max_wait_s = self.max_wait_us * 1e-6
            cw = self.class_wait_us
            reqs = self.queue.take(
                max_batch, max_wait_s, block=False, lane=lane,
                wait_s_by_prio=(
                    {p: w * 1e-6 for p, w in cw.items()}
                    if cw is not None else None))
            if not reqs:
                return  # empty (or closed): park until the next kick
            self._busy_since[lane] = time.monotonic()
            pol = srv.policy
            if pol is not None:
                pol.note_batch(len(reqs) < max_batch)
            try:
                self._serve_batch(reqs)
            except (KeyboardInterrupt, SystemExit):
                for r in reqs:
                    if not r._done.is_set():
                        if r.tenant is not None:
                            r.tenant.c_shed.inc()
                        self.queue.c_shed.inc()
                _shed_interrupted(reqs)
                raise
            except BaseException as e:  # noqa: BLE001 — the dispatcher
                # outlives any one batch: fail its waiters loudly
                for r in reqs:
                    if not r._done.is_set():
                        r.fail(e)
            finally:
                self._busy_since[lane] = None

    def _serve_batch(self, reqs: List[LookupRequest]) -> None:
        srv = self.server
        # degraded window: requests admitted BEFORE it opened are shed
        # here with the error the session door uses
        reason = srv._degraded_reason
        if reason is not None:
            for r in reqs:
                self.queue.c_degraded.inc()
                self.queue.c_shed.inc()
                if r.tenant is not None:
                    r.tenant.c_shed.inc()
                r.fail(ServeDegradedError(
                    f"serve degraded: {reason} — queued lookup shed"))
            return
        fl = srv.flight
        t_dispatch = time.perf_counter()
        self.c_batches.inc()
        self.h_batch.observe(float(len(reqs)))
        # bag reads coalesce apart (their reply is pooled vectors); a
        # failed bag batch fails only its own waiters
        bag_reqs = [r for r in reqs if isinstance(r, BagLookupRequest)]
        if bag_reqs:
            try:
                self._serve_bag_batch(bag_reqs, fl, t_dispatch)
            except (KeyboardInterrupt, SystemExit):
                _shed_interrupted(reqs)
                raise
            except BaseException as e:  # noqa: BLE001 — see _drain
                for r in bag_reqs:
                    if not r._done.is_set():
                        r.fail(e)
            reqs = [r for r in reqs
                    if not isinstance(r, BagLookupRequest)]
            if not reqs:
                return
        allk = reqs[0].keys if len(reqs) == 1 else \
            np.concatenate([r.keys for r in reqs])
        union = np.unique(allk)
        if srv.tier is not None:
            srv.tier.note_serve(union)
        after = tuple(f for r in reqs for f in r.after)
        served = None
        rep = self.replica
        if rep is not None and not after:
            served = rep.try_serve(union)
        if served is not None:
            flat, t_cutoff = served
            self.c_replica_hits.inc()
            t_enqueued = t_dispatch
        else:
            try:
                flat, t_enqueued = self._lookup_union(union)
                t_cutoff = t_enqueued
            except (KeyboardInterrupt, SystemExit):
                _shed_interrupted(reqs)
                raise
            except BaseException as e:  # noqa: BLE001 — fail every waiter
                for r in reqs:
                    r.fail(e)
                return
        # scatter the deduplicated union back to each request's keys
        # (duplicates within a request fan out here, like Worker.pull)
        lens_u = srv.value_lengths[union]
        offs_u = _offsets(lens_u)
        self.c_keys_unique.inc(len(union))
        # the flight's t_done: taken after `_lookup_union`'s host
        # readback (`_assemble_flat`'s .cpu() waits for the gathers on
        # the card), never at a launch's return, so the device slice
        # t_enqueued -> t_done holds the card's work
        now = time.perf_counter()
        if fl is not None:
            fl.record_serve_batch(
                [r.trace for r in reqs if r.trace is not None],
                t_dispatch, t_enqueued, now, n_requests=len(reqs),
                n_keys=len(allk), n_unique=len(union))
            fl.freshness.note_read(union, t_cutoff)
        for r in reqs:
            pos = np.searchsorted(union, r.keys)
            if r.trace is not None:
                r.trace.t_deliver = time.perf_counter()
            r.deliver(_select_flat(flat, offs_u, lens_u, pos))
            self.c_lookups.inc()
            self.c_keys.inc(len(r.keys))
            self._served(r, now)

    def _served(self, r: LookupRequest, now: float) -> None:
        """Per-request accounting after delivery."""
        if r.tenant is not None:
            r.tenant.c_served.inc()
        self.h_latency.observe(now - r.t0)
        cs = self._class_samples
        if cs is not None:
            cs.append((now, now - r.t0, r.priority))

    def _lookup_union(self, keys: np.ndarray):
        """One coalesced pull of the (unique, sorted) union: an
        optimistic plan through the shared routing-plan cache,
        revalidated against `topology_version` under the lock, then
        `Server._pull` (one K1 launch per length class). Returns (flat
        values, the stamp taken right after the gathers were
        enqueued)."""
        srv = self.server
        with srv._span("serve.lookup"):
            plan, tv = None, -1
            if srv.opts.optimistic_routing:
                tv = srv.topology_version
                plan = srv._plan_cached(
                    "pull", self.shard, keys, tv,
                    lambda: srv._plan_pull(keys, self.shard))
            with srv._lock:
                if plan is not None and srv.topology_version != tv:
                    plan = None  # topology moved underneath us: re-plan
                groups, _ = srv._pull(keys, self.shard, plan=plan)
                t_enqueued = time.perf_counter()
            return srv._assemble_flat(keys, groups), t_enqueued

    # -- bag reads -----------------------------------------------------------

    def _serve_bag_batch(self, reqs: List[BagLookupRequest], fl,
                         t_dispatch: float) -> None:
        """Serve a coalesced batch of bag lookups. Path per batch (the
        bits are the same on every path, serve/bags.py):

          1. the replica snapshot covers the member-key union → host pool
             over the snapshot rows (lock-free, no device work);
          2. `--sys.serve.bags` on → one K8 launch per (length class,
             pooling) under the server lock; only pooled rows cross;
          3. otherwise → the flat union gather (`_lookup_union`) + host
             pool."""
        srv = self.server
        allk = np.concatenate([r.keys for r in reqs]) \
            if len(reqs) > 1 else reqs[0].keys
        union = np.unique(allk)
        if srv.tier is not None:
            srv.tier.note_serve(union)
        after = tuple(f for r in reqs for f in r.after)
        groups, slices = plan_bag_batch(reqs, srv.ab.key_class)
        rep = self.replica
        served = rep.try_serve(union) \
            if rep is not None and not after else None
        if served is not None:
            flat, t_cutoff = served
            self.c_bag_replica_hits.inc()
            self.c_bag_hostpool.inc()
            pooled = self._pool_from_flat(flat, union, groups)
            t_enqueued = t_dispatch
        else:
            fused = (bool(getattr(self.opts, "serve_bags", True))
                     and srv.glob is None and not after)
            costs = srv.costs
            if fused and costs is not None:
                # measured-cost consult (ops/costs.py): host-pool this
                # batch only if the table measures the flat gather + host
                # pool cheaper for EVERY group's shape; a group without
                # an entry (None) keeps K8
                from ..ops.costs import dtype_name
                verdicts = [costs.prefer_fused(
                    int(srv.value_lengths[g["keys"][0]]),
                    len(g["keys"]), dtype_name(srv.stores[gkey[0]]),
                    gkey[1]) for gkey, g in groups.items()]
                if verdicts and all(v is False for v in verdicts):
                    fused = False
                    costs.c_overrides.inc()
                dc = srv.decisions
                if dc is not None and verdicts:
                    dc.record_costs(
                        fused, len(verdicts), len(union),
                        sum(1 for v in verdicts if v is False),
                        sum(1 for v in verdicts if v is None))
            if fused:
                dev, t_enqueued = self._lookup_bags_fused(groups)
                pooled = {k: v[:groups[k]["nbags"]].cpu().numpy()
                          for k, v in dev.items()}
                self.c_bag_fused.inc()
            else:
                flat, t_enqueued = self._lookup_union(union)
                self.c_bag_hostpool.inc()
                pooled = self._pool_from_flat(flat, union, groups)
            t_cutoff = t_enqueued
        now = time.perf_counter()   # after the pooled rows' readback
        if fl is not None:
            fl.record_serve_batch(
                [r.trace for r in reqs if r.trace is not None],
                t_dispatch, t_enqueued, now, n_requests=len(reqs),
                n_keys=len(allk), n_unique=len(union))
            fl.freshness.note_read(union, t_cutoff)
        for r, rs in zip(reqs, slices):
            parts = [np.ascontiguousarray(
                pooled[g][s:s + nb]).ravel() for g, s, nb in rs]
            if r.trace is not None:
                r.trace.t_deliver = time.perf_counter()
            r.deliver(np.concatenate(parts)
                      if len(parts) > 1 else parts[0])
            self.c_bag_lookups.inc()
            self.c_bag_pooled.inc(sum(nb for _, _, nb in rs))
            self._served(r, now)

    def _lookup_bags_fused(self, groups):
        """One K8 launch per (length class, pooling) group: route the
        members and enqueue every group's program back to back under
        ONE dispatch-gate hold inside the server lock. Returns
        ({gkey: pooled rows on the card}, the enqueue stamp); the
        readback happens on the caller, outside the lock."""
        srv = self.server
        from ..core.store import OOB
        with srv._span("serve.bag_lookup"):
            with srv._lock:
                dev = {}
                with dispatch_gate():
                    for gkey, g in groups.items():
                        cid, pooling = gkey
                        o_sh, o_sl, c_sh, c_sl, use_c, _, _ = \
                            srv._route(g["keys"], self.shard,
                                       record=False)
                        o_sl = np.where(use_c, OOB,
                                        o_sl).astype(np.int32)
                        dev[gkey] = srv.stores[cid].gather_pool(
                            o_sh, o_sl, c_sh, c_sl, use_c, g["seg"],
                            g["nbags"], pooling=pooling)
                t_enqueued = time.perf_counter()
        return dev, t_enqueued

    def _pool_from_flat(self, flat, union, groups):
        """Host-pool each group's bags out of a flat union value buffer
        (replica snapshot rows or a `_lookup_union` result): the
        bit-identical twin of K8 (pool_bags_host)."""
        srv = self.server
        lens_u = srv.value_lengths[union]
        offs_u = _offsets(lens_u)
        out = {}
        for gkey, g in groups.items():
            ks = g["keys"]
            pos = np.searchsorted(union, ks)
            L = int(srv.value_lengths[ks[0]])
            rows = _select_flat(flat, offs_u, lens_u,
                                pos).reshape(len(ks), L)
            out[gkey] = pool_bags_host(rows, g["seg"], g["nbags"],
                                       gkey[1])
        return out
