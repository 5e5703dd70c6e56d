"""The user-facing parameter-manager API: Server + Worker.

API parity with the reference's ColoKVServer / ColoKVWorker
(include/ps/coloc_kv_server.h, include/ps/coloc_kv_worker.h): Pull / Push /
Set / PullIfLocal / Intent / Wait / WaitAll / WaitSync / IsFinished /
advanceClock / Barrier / BeginSetup / EndSetup / Finalize, with the
reference's async contract: ops return a timestamp, `Wait(ts)` blocks, and
`-1` means "answered entirely locally, nothing to wait for"
(coloc_kv_worker.h:120-186).

This is the JAX package's `core/kv.py` for one process, over torch pools
(core/store.py) on one device holding S virtual shards
(device/context.py):
  - workers map onto shards (worker w -> shard w % S);
  - values are flat float buffers with per-key lengths, or [B, L] arrays
    for uniform-length calls;
  - ops ENQUEUE device programs and return; a pull's values reach the
    host when it is finished;
  - a single coarse lock serializes table and pool mutation.

Every optional plane of the JAX server (tiering, prefetch, serving,
streaming, workload/decision traces, learned policy, checkpoints, kernel
cost tables, fault injection, the multi-process layer) is not ported:
asking for one raises NotImplementedError naming its ROADMAP item, and
the corresponding attributes stay None.
"""
from __future__ import annotations

import contextlib
import threading
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..base import LOCAL, WORKER_FINISHED
from ..config import SystemOptions
from ..device.context import DeviceContext, make_context
from ..exec.executor import dispatch_gate
from ..obs.spans import NULL_SPAN
from .addressbook import Addressbook
from .store import OOB, ShardedStore
from .sync import SyncManager


def _offsets(lens: np.ndarray) -> np.ndarray:
    offs = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    return offs


def _ragged_index(offs: np.ndarray, lens: np.ndarray,
                  pos: np.ndarray) -> Optional[np.ndarray]:
    """Flat-buffer element index of the segments at `pos`; None when all
    lengths are equal (callers then use a [-1, L] reshape)."""
    if len(lens) and (lens == lens[0]).all():
        return None
    sub = lens[pos]
    so = _offsets(sub)
    return np.repeat(offs[pos], sub) + (np.arange(so[-1])
                                        - np.repeat(so[:-1], sub))


def _select_flat(flat, offs, lens, pos) -> np.ndarray:
    """Value segments of key positions `pos` from a flat concat buffer."""
    if len(pos) == 0:
        return np.empty(0, dtype=np.float32)
    idx = _ragged_index(offs, lens, pos)
    if idx is None:
        return np.ascontiguousarray(
            flat.reshape(-1, int(lens[0]))[pos]).ravel()
    return flat[idx]


def _fill_flat(out, offs, lens, pos, part) -> None:
    """Write `part` (flat concat for positions `pos`) into `out`."""
    if len(pos) == 0:
        return
    idx = _ragged_index(offs, lens, pos)
    if idx is None:
        out.reshape(-1, int(lens[0]))[pos] = part.reshape(len(pos), -1)
    else:
        out[idx] = part


# SystemOptions knobs of planes this package does not have yet, with the
# ROADMAP item that ports each
_UNPORTED_PLANES = (
    ("tier", "tiered storage (--sys.tier)", "queue A, item 8"),
    ("prefetch", "the prefetch pipeline (--sys.prefetch)", "queue A, item 7"),
    ("trace_flight", "request-flight tracing", "queue A, item 10"),
    ("crash_dumps", "crash dumps", "queue A, item 10"),
    ("trace_workload", "workload trace capture", "queue A, item 10"),
    ("trace_decisions", "decision telemetry", "queue A, item 10"),
    ("policy_file", "the learned policy plane", "queue A, item 10"),
    ("fault_spec", "fault injection", "queue A, item 10"),
    ("ckpt_every_s", "periodic checkpoints", "queue A, item 10"),
    ("costs_table", "the kernel cost table", "queue A, item 9"),
    ("stream_batch", "the streaming plane", "queue A, item 11"),
    ("stream_freshness_slo_ms", "the streaming plane", "queue A, item 11"),
    ("collective_sync", "the collective exchange", "queue B, B10"),
    ("lint_lockorder", "the lock-order sentinel", "queue A, item 12"),
)


class _WaitEntry:
    __slots__ = ("groups", "out", "is_write", "keys")

    def __init__(self, groups=None, out=None, is_write=False, keys=None):
        # groups: list of (class_id, row_positions, key_lengths, vals, n)
        self.groups = groups or []
        self.out = out
        self.is_write = is_write
        self.keys = keys


class _TopoHandle:
    """Yielded by Server._topology_mutation; cancel() marks a section
    that mutated nothing (exit then skips the version bump)."""

    __slots__ = ("cancelled",)

    def __init__(self):
        self.cancelled = False

    def cancel(self):
        self.cancelled = True


class Server:
    """Owns the sharded pools, addressbook, planner, and worker registry.

    Reference ColoKVServer (coloc_kv_server.h:58-354). `value_lengths` may be
    a scalar (uniform) or a per-key array; keys are grouped into length
    classes, each with its own pooled store.
    """

    def __init__(self, num_keys: int,
                 value_lengths: Union[int, Sequence[int]],
                 opts: Optional[SystemOptions] = None,
                 ctx: Optional[DeviceContext] = None,
                 num_workers: Optional[int] = None,
                 dtype=torch.float32):
        self.opts = opts or SystemOptions()
        for knob, what, item in _UNPORTED_PLANES:
            if getattr(self.opts, knob):
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP {item})")
        if self.opts.sync_compress != "off":
            raise NotImplementedError("compressed sync rounds are not "
                                      "ported yet (ROADMAP queue B, B8)")
        self.ctx = ctx or make_context()
        self.num_keys = int(num_keys)
        self.dtype = dtype

        lens = np.asarray(value_lengths)
        if lens.ndim == 0:
            lens = np.full(self.num_keys, int(lens), dtype=np.int64)
        if len(lens) != self.num_keys:
            raise ValueError("value_lengths must be a scalar or one "
                             "length per key")
        self.value_lengths = lens.astype(np.int64)
        uniq = np.unique(self.value_lengths)
        self.class_lengths = [int(u) for u in uniq]
        key_class = np.searchsorted(uniq, self.value_lengths).astype(np.int32)
        class_counts = np.bincount(key_class, minlength=len(uniq))
        # one process (the multi-process layer is ROADMAP queue A, item 11)
        self.num_procs = 1
        self.pid = 0

        from ..obs import metrics as _obs_metrics
        self.obs = _obs_metrics.MetricsRegistry(enabled=self.opts.metrics)
        _obs_metrics.set_global_registry(self.obs)
        self.spans = None
        if self.opts.trace_spans:
            from ..obs.spans import SpanTracer
            self.spans = SpanTracer(
                rank=self.pid, max_events=self.opts.trace_spans_max_events,
                registry=self.obs)
        from ..fault.policy import RetryPolicy
        self._retry_policy = RetryPolicy(
            max_retries=self.opts.fault_retries,
            backoff_base_s=self.opts.fault_backoff_ms * 1e-3,
            backoff_max_s=self.opts.fault_backoff_max_ms * 1e-3)
        from ..exec import AsyncExecutor
        self.exec = AsyncExecutor(registry=self.obs,
                                  workers=self.opts.exec_workers,
                                  single_stream=self.opts.exec_single_stream,
                                  retry_policy=self._retry_policy)
        # the planes that are not ported: always None here
        self.tier = self.prefetch = self.glob = self.net = None
        self.stream = self.wtrace = self.decisions = self.policy = None
        self.ckpt = self.costs = self.flight = self.fault = None
        self.sampling = None  # set by enable_sampling_support

        self._c_topo_bumps = self.obs.counter("kv.topology_bumps")
        self.obs.gauge("kv.topology_version",
                       fn=lambda: self.topology_version)
        self.obs.gauge("kv.workers", fn=lambda: len(self._workers))

        self.stores: List[ShardedStore] = [
            ShardedStore(int(class_counts[cid]), L, self.ctx,
                         dtype=self.dtype,
                         over_alloc=self.opts.main_over_alloc,
                         cache_slots_per_shard=self.opts.
                         cache_slots_per_shard,
                         bucket_min=self.opts.remote_bucket_min)
            for cid, L in enumerate(self.class_lengths)]
        if self.obs.enabled and self.stores:
            _port = self.stores[0].port
            self.obs.gauge("device.programs_total", shared=True,
                           fn=lambda p=_port: p.programs)

        self.ab = Addressbook(
            key_class, self.ctx.num_shards,
            [s.main_slots for s in self.stores],
            [s.cache_slots for s in self.stores])
        # every counted ab mutation happens inside _topology_mutation(),
        # which bumps topology_version as the LAST step of the section
        self._ab_mut_acked = self.ab.mutations

        self.num_shards = self.ctx.num_shards
        self._wb_declared = num_workers is not None
        self.max_workers = num_workers or max(self.num_shards, 1)
        self._workers: Dict[int, "Worker"] = {}
        self._clocks = np.zeros(self.max_workers, dtype=np.int64)
        self._lock = threading.RLock()
        # serializes sync ROUNDS (reentrant: run_round takes it itself)
        self._round_lock = threading.RLock()
        self._in_setup = False
        self._wb_cond = threading.Condition()
        self._wb_waiting: set = set()
        self._wb_gen = 0
        self._wb_done = 0
        # bumped whenever placement changes (replica add/drop, relocation)
        self.topology_version = 0

        self.sync = SyncManager(self, self.opts)

        from .intent import PlanCache
        self._plan_cache = PlanCache(self.opts.plan_cache_entries,
                                     registry=self.obs) \
            if self.opts.plan_cache_entries > 0 else None

        self._shutdown_done = False
        # native host-routing core (C++ via ctypes; None -> numpy fallback)
        from ..native import get_lib
        self._native = get_lib()

        from ..utils.stats import KeyTracer, LocalityStats, ALLOC, \
            parse_trace_spec
        traced = parse_trace_spec(self.opts.trace_keys or "", self.num_keys)
        self.tracer = KeyTracer(traced, self.num_keys) \
            if traced is not None else None
        self.locality = LocalityStats(self.num_keys, self._native) \
            if self.opts.locality_stats else None
        # device-routed runners register a counts callback here
        self._locality_sources: List = []
        if self.tracer is not None:
            owners = self.ab.owner[traced]
            for s in np.unique(owners):
                self.tracer.record(traced[owners == s], ALLOC, int(s))

    # -- topology-mutation discipline ----------------------------------------

    def _check_topology_discipline(self) -> None:
        assert self.ab.mutations == self._ab_mut_acked, (
            "addressbook mutated outside Server._topology_mutation(): "
            "optimistic routing and the plan cache revalidate against "
            "topology_version, so an unpaired mutation lets stale plans "
            "dispatch into freed or reassigned pool slots")

    @contextlib.contextmanager
    def _topology_mutation(self):
        """Every site that mutates placement tables runs inside this
        context: it holds the server lock and bumps `topology_version` as
        the LAST mutation of its critical section, which makes optimistic
        routing's plan-then-revalidate sound. `cancel()` on the handle
        marks a section that mutated nothing."""
        with self._lock:
            self._check_topology_discipline()
            before = self.ab.mutations
            h = _TopoHandle()
            try:
                yield h
            finally:
                if h.cancelled:
                    assert self.ab.mutations == before, (
                        "topology mutation section cancelled after "
                        "mutating the addressbook")
                else:
                    self.topology_version += 1
                    self._c_topo_bumps.inc()
                    self._ab_mut_acked = self.ab.mutations

    def _span(self, name: str):
        sp = self.spans
        return NULL_SPAN if sp is None else sp.span(name)

    # -- worker management ---------------------------------------------------

    def make_worker(self, worker_id: Optional[int] = None) -> "Worker":
        with self._lock:
            if worker_id is None:
                worker_id = len(self._workers)
            if worker_id >= self.max_workers:
                raise ValueError(f"worker_id {worker_id} >= num_workers "
                                 f"{self.max_workers}")
            w = Worker(self, worker_id)
            self._workers[worker_id] = w
            return w

    def workers(self):
        return list(self._workers.values())

    def worker_clocks(self) -> np.ndarray:
        return self._clocks.copy()

    def shard_min_clocks(self) -> np.ndarray:
        """Min clock over the workers mapped to each shard (used for intent
        expiry; reference compares per-customer clocks, handle.h:542-578)."""
        out = np.full(self.num_shards, np.iinfo(np.int64).max)
        for wid, w in self._workers.items():
            out[w.shard] = min(out[w.shard], self._clocks[wid])
        out[out == np.iinfo(np.int64).max] = 0
        return out

    def enable_sampling_support(self, sample_key_fn, min_key: int = 0,
                                max_key: Optional[int] = None,
                                allowed_keys=None) -> None:
        """Install a sampling scheme (reference
        ColoKVServer::enable_sampling_support, coloc_kv_server.h;
        `sample_key_fn(n, rng) -> np.ndarray[int64]` draws app-distribution
        keys, like the reference's `Key sample_key()` callback).
        `allowed_keys` bounds the Local scheme's snap population when the
        sampled keys are not a contiguous range."""
        from .sampling import make_sampling
        self.sampling = make_sampling(self, sample_key_fn, min_key,
                                      max_key if max_key is not None
                                      else self.num_keys,
                                      allowed_keys=allowed_keys)

    # -- routing helpers (host) ---------------------------------------------

    def _route(self, keys: np.ndarray, shard: int,
               write_through: bool = False, record: bool = True):
        """Resolve keys (any shape) to pool coordinates for a worker on
        `shard`, preferring a local replica over the owner row. Returns
        (o_sh, o_sl, c_sh, c_sl, use_c, n_remote, local). `write_through`
        marks ops that must reach the owner (Set), so a replica doesn't
        count as local."""
        ab = self.ab
        if self._native is not None:
            from ..native import route
            flat = np.ascontiguousarray(keys.ravel(), dtype=np.int64)
            o_sh, o_sl, c_sh, c_sl, use_c, n_remote, local = route(
                self._native, flat, ab.owner, ab.slot,
                ab.cache_slot[shard], shard, int(OOB), write_through)
            if record and self.locality is not None:
                self.locality.record(flat, local)
            sh = keys.shape
            return (o_sh.reshape(sh), o_sl.reshape(sh), c_sh.reshape(sh),
                    c_sl.reshape(sh), use_c.reshape(sh), n_remote,
                    local.reshape(sh))
        from ..base import check_key_range
        check_key_range(keys, self.num_keys)
        o_sh = ab.owner[keys].astype(np.int32)
        o_sl = ab.slot[keys].astype(np.int32)
        cs = ab.cache_slot[shard, keys].astype(np.int32)
        use_c = cs >= 0
        on_owner = o_sh == shard
        local = on_owner if write_through else (use_c | on_owner)
        n_remote = int((~local).sum())
        if record and self.locality is not None:
            self.locality.record(keys.ravel(), local.ravel())
        c_sh = np.full_like(o_sh, shard)
        c_sl = np.where(use_c, cs, OOB).astype(np.int32)
        return o_sh, o_sl, c_sh, c_sl, use_c, n_remote, local

    def _group_by_class(self, keys: np.ndarray):
        """Split a key batch by length class; returns [(cid, positions)]."""
        if len(self.stores) == 1:
            return [(0, np.arange(len(keys)))]
        kc = self.ab.key_class[keys]
        return [(cid, np.nonzero(kc == cid)[0]) for cid in np.unique(kc)]

    def _flat_parts(self, keys: np.ndarray, flat: np.ndarray, positions,
                    length: int) -> np.ndarray:
        lens = self.value_lengths[keys]
        return _select_flat(flat, _offsets(lens), lens,
                            np.asarray(positions)).reshape(-1, length)

    # -- core ops (called by Worker; all under the server lock) --------------

    def _plan_pull(self, keys: np.ndarray, shard: int):
        """Routing plan for `_pull`: no device dispatch, no side effects.
        Safe without the server lock — callers revalidate
        `topology_version` under the lock and re-plan on a miss
        (optimistic routing)."""
        with self._span("kv.plan_pull"):
            cls = []
            if len(keys):
                for cid, pos in self._group_by_class(keys):
                    ks = keys[pos]
                    cls.append((cid, pos, ks,
                                self._route(ks, shard, record=False)))
            return cls

    def _pull(self, keys: np.ndarray, shard: int, plan=None):
        """Returns (groups, n_remote): one gather per length class."""
        if plan is None:
            plan = self._plan_pull(keys, shard)
        groups = []
        n_remote = 0
        with dispatch_gate():
            for cid, pos, ks, (o_sh, o_sl, c_sh, c_sl, use_c, nr,
                               local) in plan:
                n_remote += nr
                if self.locality is not None:
                    self.locality.record(ks.ravel(), local.ravel())
                o_sl = np.where(use_c, OOB, o_sl).astype(np.int32)
                vals = self.stores[cid].gather(o_sh, o_sl, c_sh, c_sl,
                                               use_c)
                groups.append((cid, pos, self.value_lengths[ks], vals,
                               len(ks)))
        return groups, n_remote

    def _plan_push_routes(self, keys: np.ndarray, shard: int,
                          is_set: bool = False):
        """The cacheable routing part of `_plan_push` (the PlanCache entry
        for the 'push'/'set' kinds)."""
        cls = []
        if len(keys):
            for cid, pos in self._group_by_class(keys):
                ks = keys[pos]
                cls.append((cid, pos, ks,
                            self._route(ks, shard, write_through=is_set,
                                        record=False)))
        return cls

    def _plan_push(self, keys: np.ndarray, vals: np.ndarray, shard: int,
                   is_set: bool = False, routes=None):
        """Routing + staging plan for `_push`; same lock-free contract as
        `_plan_pull`. `routes` is an optional (plan-cached)
        `_plan_push_routes` result."""
        with self._span("kv.plan_push"):
            if routes is None:
                routes = self._plan_push_routes(keys, shard, is_set=is_set)
            flat = vals.ndim == 1
            cls = []
            for cid, pos, ks, route in routes:
                L = self.class_lengths[cid]
                rows = self._flat_parts(keys, vals, pos, L) if flat \
                    else vals[pos]
                cls.append((cid, ks, rows, route))
            return cls

    def _push(self, keys: np.ndarray, vals: np.ndarray, shard: int,
              is_set: bool = False, plan=None) -> int:
        """Returns n_remote. `plan` is an optional `_plan_push` result
        revalidated under the lock."""
        if plan is None:
            plan = self._plan_push(keys, vals, shard, is_set=is_set)
        n_remote = 0
        for cid, ks, rows, (o_sh, o_sl, c_sh, c_sl, use_c, nr,
                            local) in plan:
            n_remote += nr
            if self.locality is not None:
                self.locality.record(ks.ravel(), local.ravel())
            if is_set:
                # Set writes through to the main copy and refreshes the
                # writer's local replica
                self.stores[cid].set_rows(o_sh, o_sl, rows, c_sh, c_sl)
            else:
                o_sl = np.where(use_c, OOB, o_sl).astype(np.int32)
                self.stores[cid].scatter_add(o_sh, o_sl, c_sh, c_sl, rows)
        return n_remote

    def _plan_cached(self, kind: str, shard: int, keys: np.ndarray,
                     tv: int, compute):
        """The one plan-cache get-or-compute-then-put sequence."""
        cache = self._plan_cache
        plan = cache.get(kind, shard, keys, tv) \
            if cache is not None else None
        if plan is None:
            plan = compute()
            if cache is not None:
                cache.put(kind, shard, keys, tv, plan)
        return plan

    def ensure_local(self, keys: np.ndarray, shard: int) -> None:
        """Make process-remote keys locally servable: a no-op in one
        process (the only mode this package has)."""

    # -- planner ops (called by SyncManager) ---------------------------------

    def _create_replicas(self, keys: np.ndarray, shard: int) -> np.ndarray:
        """Allocate+materialize replicas on `shard`; returns created keys.
        One allocator batch + one device program per length class; a full
        cache pool truncates the batch (surplus keys stay remote)."""
        with self._lock:
            ab = self.ab
            todo = np.unique(keys[~ab.is_local(keys, shard)])
            todo = todo[ab.owner[todo] >= 0]
            if len(todo) == 0:
                return np.empty(0, dtype=np.int64)
            created = []
            with self._topology_mutation() as tm:
                for cid, pos in self._group_by_class(todo):
                    cs = ab.add_replicas(todo[pos], shard)
                    ks = todo[pos][: len(cs)]
                    if len(ks) == 0:
                        continue
                    c_sl = cs.astype(np.int32)
                    o_sh = ab.owner[ks].astype(np.int32)
                    o_sl = ab.slot[ks].astype(np.int32)
                    c_sh = np.full_like(o_sh, shard)
                    self.stores[cid].replica_create(o_sh, o_sl, c_sh, c_sl)
                    created.append(ks)
                if not created:
                    tm.cancel()
            if not created:
                return np.empty(0, dtype=np.int64)
            out = np.concatenate(created)
            if self.tracer is not None:
                from ..utils.stats import REPLICA_SETUP
                self.tracer.record(out, REPLICA_SETUP, shard)
            return out

    def _dirty_replica_mask(self, keys: np.ndarray,
                            shards: np.ndarray) -> np.ndarray:
        """True per (key, holder-shard) replica iff a sync would change any
        bit: an unshipped delta write or a base older than the main row."""
        out = np.zeros(len(keys), dtype=bool)
        ab = self.ab
        for cid, pos in self._group_by_class(keys):
            ks, ss = keys[pos], shards[pos]
            cs = ab.cache_slot[ss, ks]
            o_sh = ab.owner[ks]
            o_sl = ab.slot[ks]
            st = self.stores[cid]
            d = np.zeros(len(ks), dtype=bool)
            has = np.nonzero(cs >= 0)[0]
            if len(has) == 0:
                continue
            d[has] = st.delta_dirty[ss[has], cs[has]]
            loc = has[o_sl[has] >= 0]
            if len(loc):
                d[loc] |= (st.main_epoch[o_sh[loc], o_sl[loc]]
                           != st.repl_epoch[ss[loc], cs[loc]])
            out[pos] = d
        return out

    def _sync_replicas(self, keys: np.ndarray, shards: np.ndarray,
                       threshold: float = 0.0) -> None:
        """Sync replicas given parallel (key, holder-shard) arrays;
        threshold > 0 leaves small-delta replicas out of the round
        (--sys.sync.threshold). Under the lock: revalidation + enqueue."""
        with self._lock:
            ab = self.ab
            karr = np.ascontiguousarray(keys, dtype=np.int64)
            sarr = np.ascontiguousarray(shards, dtype=np.int32)
            for cid, pos in self._group_by_class(karr):
                ks, ss = karr[pos], sarr[pos]
                r_cs = ab.cache_slot[ss, ks].astype(np.int32)
                o_sh = ab.owner[ks].astype(np.int32)
                o_sl = ab.slot[ks].astype(np.int32)
                # a -1 index must never reach a program: re-validate
                ok = (r_cs >= 0) & (o_sl >= 0)
                if not ok.all():
                    ss, r_cs = ss[ok], r_cs[ok]
                    o_sh, o_sl = o_sh[ok], o_sl[ok]
                    if not ok.any():
                        continue
                self.stores[cid].sync_replicas(ss, r_cs, o_sh, o_sl,
                                               threshold=threshold)

    def _drop_replicas(self, keys: np.ndarray,
                       shards: np.ndarray) -> None:
        with self._lock:
            karr = np.ascontiguousarray(keys, dtype=np.int64)
            sarr = np.ascontiguousarray(shards, dtype=np.int32)
            ok = self.ab.cache_slot[sarr, karr] >= 0
            if not ok.any():
                return
            karr, sarr = karr[ok], sarr[ok]
            # flush pending deltas first, then free the slots (reference
            # readAndPotentiallyDropReplica)
            self._sync_replicas(karr, sarr)
            with self._topology_mutation():
                for s in np.unique(sarr):
                    sk = karr[sarr == s]
                    for _, pos in self._group_by_class(sk):
                        self.ab.drop_replicas(sk[pos], int(s))
                    if self.tracer is not None:
                        from ..utils.stats import REPLICA_DROP
                        self.tracer.record(sk, REPLICA_DROP, int(s))

    def _relocate(self, moves: List[Tuple[int, int]]) -> int:
        """Move main copies given (key, dest_shard) pairs. Returns the
        number of moves actually performed; see _relocate_to."""
        if not moves:
            return 0
        karr = np.fromiter((k for k, _ in moves), np.int64, len(moves))
        sarr = np.fromiter((s for _, s in moves), np.int32, len(moves))
        return sum(self._relocate_to(karr[sarr == dest], int(dest))
                   for dest in np.unique(sarr))

    def _relocate_to(self, keys: np.ndarray, dest: int) -> int:
        """Move the main copies of `keys` to shard `dest`: one allocator
        batch + one device program per class. A move whose destination
        main pool is full is demoted to a replication attempt."""
        demoted = np.empty(0, dtype=np.int64)
        n_moved = 0
        with self._lock:
            ab = self.ab
            keys = np.unique(keys)
            keys = keys[(ab.owner[keys] != dest) & (ab.owner[keys] >= 0)]
            if len(keys) == 0:
                return 0
            with self._topology_mutation() as tm:
                for cid, pos in self._group_by_class(keys):
                    ks = keys[pos]
                    moved, old_sh, old_sl, new_sl = \
                        ab.relocate_batch(ks, dest)
                    if len(moved) < len(ks):
                        demoted = np.concatenate((demoted, ks[len(moved):]))
                    if len(moved) == 0:
                        continue
                    # a replica at the destination upgrades to owner: its
                    # pending delta merges in the program, its slot frees
                    cs = ab.cache_slot[dest, moved]
                    has_rep = cs >= 0
                    rc_sh = np.where(has_rep, dest, 0).astype(np.int32)
                    rc_sl = np.where(has_rep, cs, OOB).astype(np.int32)
                    rep_keys = moved[has_rep]
                    if len(rep_keys):
                        self.sync.replica_discard(rep_keys, dest)
                        ab.drop_replicas(rep_keys, dest)
                    self.stores[cid].relocate_rows(
                        old_sh.astype(np.int32), old_sl.astype(np.int32),
                        np.full(len(moved), dest, np.int32),
                        new_sl.astype(np.int32), rc_sh, rc_sl)
                    n_moved += len(moved)
                    if self.tracer is not None:
                        from ..utils.stats import RELOCATE
                        self.tracer.record(moved, RELOCATE, dest)
                if n_moved == 0:
                    tm.cancel()
        if len(demoted):
            created = self._create_replicas(demoted, dest)
            with self._lock:
                self.sync.replica_add(created, dest)
            self.sync.stats.add(replicas_created=len(created))
        return n_moved

    # -- lifecycle -----------------------------------------------------------

    def _wb_active_ids(self) -> set:
        ids = range(self.max_workers) if self._wb_declared \
            else list(self._workers)
        return {wid for wid in ids
                if self._clocks[wid] != WORKER_FINISHED}

    def worker_barrier(self, worker_id: int) -> None:
        """Barrier across all active worker threads (reference
        ColoKVWorker::Barrier). A worker that finalizes while others wait
        is excluded (finalize() re-notifies)."""
        with self._wb_cond:
            gen = self._wb_gen
            self._wb_waiting.add(worker_id)
            while self._wb_done <= gen:
                if self._wb_gen == gen and \
                        self._wb_waiting >= self._wb_active_ids():
                    self._wb_gen += 1
                    self._wb_waiting = set()
                    self.block()
                    self._wb_done = gen + 1
                    self._wb_cond.notify_all()
                    return
                self._wb_cond.wait(timeout=5.0)

    def barrier(self) -> None:
        """Process barrier. One process: flush dispatch."""
        with self._span("collective.barrier"):
            self.block()

    def block(self) -> None:
        with self._lock:
            for s in self.stores:
                s.block()

    def drive_rounds(self, n: int = 1) -> None:
        """One training step's planner-drive slot (inline: the prefetch
        pipeline that would overlap it is not ported)."""
        for _ in range(n):
            self.sync.run_round()

    def shutdown(self) -> None:
        """Idempotent teardown: executor, pool quiesce, stats/trace
        export, registry unhook."""
        if self._shutdown_done:
            return
        self._shutdown_done = True
        self.exec.close()
        self.block()
        self.sync.close()
        self.write_stats()
        self.write_trace()
        if self.spans is not None:
            self.spans.close()
        from ..obs import metrics as _obs_metrics
        _obs_metrics.clear_global_registry(self.obs)

    def locality_summary(self) -> Dict[str, float]:
        """Aggregate worker op/param locality ratios (reference shutdown
        summary, coloc_kv_server.h:147-157). Device-routed runners' fused
        gather+scatter count as both a pull and a push."""
        agg: Dict[str, int] = {}
        for w in self._workers.values():
            for k, v in w.stats.items():
                agg[k] = agg.get(k, 0) + v
        for src in self._locality_sources:
            c = src()
            for kind in ("pull", "push"):
                for unit in ("ops", "params"):
                    agg[f"{kind}_{unit}"] = \
                        agg.get(f"{kind}_{unit}", 0) + c[unit]
                    agg[f"{kind}_{unit}_local"] = \
                        agg.get(f"{kind}_{unit}_local", 0) + \
                        c[f"{unit}_local"]
        out = {}
        for kind in ("pull", "push"):
            for unit in ("ops", "params"):
                tot = agg.get(f"{kind}_{unit}", 0)
                loc = agg.get(f"{kind}_{unit}_local", 0)
                out[f"{kind}_{unit}_local_frac"] = \
                    loc / tot if tot else float("nan")
        return out

    def write_stats(self) -> List[str]:
        """Dump trace/locality files into --sys.stats.out and log the final
        locality + sync summary."""
        from ..utils import alog, verbose_level
        if self.opts.stats_out or self.tracer is not None \
                or self.locality is not None or verbose_level() > 0:
            summ = self.locality_summary()
            if any(v == v for v in summ.values()):
                alog("[stats] " + " ".join(f"{k}={v:.3f}" for k, v in
                                           summ.items() if v == v))
            alog("[stats]", self.sync.report())
        if not self.opts.stats_out:
            return []
        from ..utils.stats import write_stats
        return write_stats(self.opts.stats_out, self.pid, self.tracer,
                           self.locality)

    def metrics_snapshot(self) -> Dict:
        """The structured telemetry dict: `schema_version`,
        `metrics_enabled`, and the registry's sections plus `kv`, `exec`
        and `device`."""
        out: Dict = {"schema_version": 1,
                     "metrics_enabled": bool(self.obs.enabled),
                     "kv": {}, "exec": {}, "device": {}}
        if not self.obs.enabled:
            return out
        for sec, vals in self.obs.snapshot().items():
            out.setdefault(sec, {}).update(vals)
        agg: Dict[str, int] = {}
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            for k, v in w.stats.items():
                agg[k] = agg.get(k, 0) + int(v)
        out["kv"].update(agg)
        out["kv"]["locality"] = self.locality_summary()
        out["exec"].update(self.exec.stats())
        if self.stores:
            out["device"].update(self.stores[0].port.stats())
        return out

    def write_trace(self) -> Optional[str]:
        """Export the span trace (Chrome trace-event JSON) when
        --sys.trace.spans is on; returns the path."""
        if self.spans is None:
            return None
        import os
        path = self.opts.trace_spans_out or os.path.join(
            self.opts.stats_out or ".", f"spans.{self.pid}.trace.json")
        return self.spans.export(path)

    def wait_sync(self) -> None:
        """Act on all signalled intents and complete a full sync round
        (reference WaitSync, coloc_kv_worker.h:517)."""
        with self._round_lock:
            self.sync.run_round(force_intents=True, all_channels=True)
        self.block()

    def quiesce(self) -> None:
        with self._round_lock:
            self.sync.quiesce()

    def read_main(self, keys) -> np.ndarray:
        """Current authoritative main-copy values (flat concat)."""
        keys = np.asarray(keys, dtype=np.int64)
        with self._lock:
            groups = []
            for cid, pos in self._group_by_class(keys):
                ks = keys[pos]
                n = len(ks)
                vals = self.stores[cid].gather(
                    self.ab.owner[ks].astype(np.int32),
                    self.ab.slot[ks].astype(np.int32),
                    np.zeros(n, np.int32), np.full(n, OOB, np.int32),
                    np.zeros(n, bool))
                groups.append((cid, pos, self.value_lengths[ks], vals, n))
        return self._assemble_flat(keys, groups)

    def _assemble_flat(self, keys: np.ndarray, groups) -> np.ndarray:
        lens = self.value_lengths[keys]
        offs = _offsets(lens)
        out = np.empty(offs[-1], dtype=np.float32)
        for cid, pos, klens, vals, n in groups:
            _fill_flat(out, offs, lens, np.asarray(pos),
                       vals[:n].cpu().numpy().ravel())
        return out


class Worker:
    """Reference ColoKVWorker (coloc_kv_worker.h). One per logical worker;
    mapped to shard `worker_id % num_shards` (co-location)."""

    def __init__(self, server: Server, worker_id: int):
        self.server = server
        self.worker_id = worker_id
        self.shard = worker_id % server.num_shards
        self._clock = int(server._clocks[worker_id])
        self._ts = 0
        self._pending: Dict[int, _WaitEntry] = {}
        from .intent import IntentQueue
        self._intent_queue = IntentQueue()
        self.stats = {"pull_ops": 0, "pull_ops_local": 0,
                      "pull_params": 0, "pull_params_local": 0,
                      "push_ops": 0, "push_ops_local": 0,
                      "push_params": 0, "push_params_local": 0}
        if server.obs.enabled:
            self._h_pull = server.obs.histogram("kv.pull_s", shared=True)
            self._h_push = server.obs.histogram("kv.push_s", shared=True)
            self._h_set = server.obs.histogram("kv.set_s", shared=True)
        else:
            self._h_pull = self._h_push = self._h_set = None

    def _keys(self, keys) -> np.ndarray:
        return np.ascontiguousarray(np.asarray(keys, dtype=np.int64).ravel())

    def _new_ts(self, entry: _WaitEntry) -> int:
        self._ts += 1
        self._pending[self._ts] = entry
        return self._ts

    def _instrumented(self, name: str, h, impl, *args):
        """Latency histogram + span bracket for a worker op; a plain call
        when both are off."""
        sp = self.server.spans
        if h is None and sp is None:
            return impl(*args)
        t0 = _time.perf_counter()
        tok = sp.begin(name) if sp is not None else None
        try:
            return impl(*args)
        finally:
            if h is not None:
                h.observe(_time.perf_counter() - t0)
            if tok is not None:
                sp.end(name, tok)

    def _cached_push_routes(self, keys: np.ndarray, tv: int, is_set: bool):
        srv = self.server
        return srv._plan_cached(
            "set" if is_set else "push", self.shard, keys, tv,
            lambda: srv._plan_push_routes(keys, self.shard, is_set=is_set))

    # -- API: Pull / Push / Set ----------------------------------------------

    def pull(self, keys, out: Optional[np.ndarray] = None) -> int:
        """Async pull. Returns ts (use wait) or LOCAL=-1 if every key was
        served from this worker's shard (owned or replicated) — then `out`
        is already filled when provided."""
        return self._instrumented("kv.pull", self._h_pull,
                                  self._pull_op, keys, out)

    def _pull_op(self, keys, out: Optional[np.ndarray]) -> int:
        keys = self._keys(keys)
        srv = self.server
        plan, tv = None, -1
        if srv.opts.optimistic_routing:
            # route outside the lock; revalidate the topology below
            tv = srv.topology_version
            plan = srv._plan_cached(
                "pull", self.shard, keys, tv,
                lambda: srv._plan_pull(keys, self.shard))
        with srv._lock:
            if plan is not None and srv.topology_version != tv:
                plan = None  # topology moved underneath us: re-plan
            groups, n_remote = srv._pull(keys, self.shard, plan=plan)
        self.stats["pull_ops"] += 1
        self.stats["pull_params"] += len(keys)
        self.stats["pull_params_local"] += len(keys) - n_remote
        entry = _WaitEntry(groups=groups, out=out, keys=keys)
        if n_remote == 0:
            self.stats["pull_ops_local"] += 1
            self._finish_pull(keys, entry)
            return LOCAL
        return self._new_ts(entry)

    def pull_sync(self, keys) -> np.ndarray:
        """Pull and materialize; returns flat values (or [B, L] when the
        batch is single-length)."""
        keys = self._keys(keys)
        ts = self.pull(keys)
        flat = self._last_result if ts == LOCAL else self.wait(ts)
        lens = self.server.value_lengths[keys]
        if len(np.unique(lens)) == 1:
            return flat.reshape(len(keys), int(lens[0]))
        return flat

    def _finish_pull(self, keys, entry: _WaitEntry) -> np.ndarray:
        flat = self.server._assemble_flat(keys, entry.groups)
        if entry.out is not None:
            np.copyto(entry.out.reshape(-1)[: len(flat)], flat)
        self._last_result = flat
        return flat

    def pull_if_local(self, keys, out: Optional[np.ndarray] = None):
        """Pull only if all keys are local (reference PullIfLocal,
        coloc_kv_worker.h:352). Returns (success, values|None)."""
        keys = self._keys(keys)
        srv = self.server
        with srv._lock:
            if not bool(srv.ab.is_local(keys, self.shard).all()):
                return False, None
            groups, _ = srv._pull(keys, self.shard)
        return True, self._finish_pull(keys, _WaitEntry(groups=groups,
                                                        out=out))

    def push(self, keys, vals, asynchronous: bool = True) -> int:
        """Additive push (reference Push, coloc_kv_worker.h:120). vals is a
        flat buffer or [B, L]. Returns ts or LOCAL."""
        return self._instrumented("kv.push", self._h_push,
                                  self._write_op, keys, vals, False)

    def set(self, keys, vals) -> int:
        """Overwrite values (reference Set: non-additive write)."""
        return self._instrumented("kv.set", self._h_set,
                                  self._write_op, keys, vals, True)

    def _write_op(self, keys, vals, is_set: bool) -> int:
        keys = self._keys(keys)
        vals = np.asarray(vals, dtype=np.float32)
        srv = self.server
        plan, tv = None, -1
        if srv.opts.optimistic_routing:
            tv = srv.topology_version
            plan = srv._plan_push(
                keys, vals, self.shard, is_set=is_set,
                routes=self._cached_push_routes(keys, tv, is_set))
        with srv._lock:
            if plan is not None and srv.topology_version != tv:
                plan = None
            n_remote = srv._push(keys, vals, self.shard, is_set=is_set,
                                 plan=plan)
        if not is_set:
            self.stats["push_ops"] += 1
            self.stats["push_params"] += len(keys)
            self.stats["push_params_local"] += len(keys) - n_remote
            if n_remote == 0:
                self.stats["push_ops_local"] += 1
        if n_remote == 0:
            return LOCAL
        return self._new_ts(_WaitEntry(is_write=True))

    # -- API: waiting ---------------------------------------------------------

    def wait(self, ts: int):
        """Block until op `ts` is complete; for pulls returns the values."""
        if ts == LOCAL:
            return getattr(self, "_last_result", None)
        entry = self._pending.pop(ts, None)
        if entry is None:
            return None
        if entry.groups:
            return self._finish_pull(entry.keys, entry)
        self.server.block()
        return None

    def wait_all(self) -> None:
        for ts in sorted(self._pending.keys()):
            self.wait(ts)

    def is_finished(self, ts: int) -> bool:
        """Non-blocking completion check (reference IsFinished)."""
        if ts == LOCAL or ts not in self._pending:
            return True
        dev = self.server.ctx.device
        return dev.type != "cuda" or torch.cuda.current_stream(dev).query()

    def wait_sync(self) -> None:
        self.server.wait_sync()

    # -- API: intent + clock --------------------------------------------------

    def intent(self, keys, start: int, end: Optional[int] = None) -> None:
        """Declare future access to `keys` in clock window [start, end]
        (reference Intent, coloc_kv_worker.h:380-408; end defaults to
        start)."""
        keys = np.unique(self._keys(keys))
        end = start if end is None else end
        self._intent_queue.push(keys, int(start), int(end))

    def advance_clock(self) -> int:
        self._clock += 1
        self.server._clocks[self.worker_id] = self._clock
        return self._clock

    @property
    def current_clock(self) -> int:
        return self._clock

    # -- API: sampling --------------------------------------------------------

    def prepare_sample(self, n: int, start: Optional[int] = None,
                       end: Optional[int] = None) -> int:
        """Reference PrepareSample (coloc_kv_worker.h:418): announce that this
        worker will sample `n` keys around clock [start, end]."""
        start = self._clock if start is None else start
        end = start if end is None else end
        return self.server.sampling.prepare(self, n, int(start), int(end))

    def pull_sample(self, handle: int, n: Optional[int] = None):
        """Draw n keys (default: all prepared) from sampling handle; returns
        (keys, values[B, L])."""
        return self.server.sampling.pull(self, handle, n)

    def pull_sample_keys(self, handle: int, n: Optional[int] = None):
        """Draw n keys without fetching values (for fused steps that gather
        values themselves); locality behavior matches pull_sample."""
        return self.server.sampling.pull_keys(self, handle, n)

    def finish_sample(self, handle: int) -> None:
        self.server.sampling.finish(self, handle)

    # -- API: lifecycle -------------------------------------------------------

    def barrier(self) -> None:
        """Barrier with every other active worker (reference
        ColoKVWorker::Barrier)."""
        self.server.worker_barrier(self.worker_id)

    def begin_setup(self) -> None:
        """Bracket initialization (reference BeginSetup/EndSetup): sync is
        paused so bulk Set/Push of initial values runs at full speed."""
        self.server._in_setup = True

    def end_setup(self) -> None:
        self.server._in_setup = False
        self.server.barrier()

    def finalize(self) -> None:
        """Mark worker finished (reference Finalize): clock to infinity so
        its intents expire and replicas can be dropped."""
        self.wait_all()
        self._clock = WORKER_FINISHED
        self.server._clocks[self.worker_id] = WORKER_FINISHED
        with self.server._wb_cond:
            self.server._wb_cond.notify_all()
