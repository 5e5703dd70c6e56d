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

The intent-driven prefetch pipeline (`prefetch`, core/intent.py; on by
default, `--sys.prefetch 0` is the kill switch) and the background
planner (`start_sync_thread`) run as programs on the server's executor.
Tiered storage (`tier`, adapm_tpu_torch/tier; --sys.tier) keeps a
capacity-bounded hot pool per class on the device and the full table in
a host cold store; compressed sync rounds (--sys.sync.compress) ship
quantized deltas with error feedback. The serving plane
(`adapm_tpu_torch/serve`) attaches itself as `_serve_plane` and reads
the kernel cost table (`costs`, `--sys.costs.table`). The fault plane
(`fault`, --sys.fault.spec), periodic checkpoint chains (`ckpt`,
--sys.checkpoint.every/path; fault/ckpt.py), request-flight tracing
(`flight`, --sys.trace.flight), crash dumps with the executor flight
recorder (--sys.crash_dumps, on by default) and the periodic metrics
reporter (--sys.metrics.report) are built as the JAX server builds them,
and so are workload trace capture (`wtrace`, --sys.trace.workload;
obs/wtrace.py, replayed by adapm_tpu_torch/replay), decision telemetry
(`decisions`, --sys.trace.decisions; obs/decisions.py) and the learned
policy plane (`policy`, --sys.policy.*; adapm_tpu_torch/policy).

Multi-process: with a `net_node` (a LoopbackNode of net/loopback.py) or
under the launcher (parallel/control.py), N servers form one parameter
manager (`glob`, parallel/pm.py GlobalPM): keys owned by another process
carry owner REMOTE here, and their pulls, pushes and sets ride the
node's channel to the owner, ordered per worker by write futures
(`_rw_pending` defers replica installs behind in-flight remote writes).
`net` is the node's membership plane (loopback). With
--sys.collective_sync the cross-process replica deltas ride the BSP
collective exchange (parallel/collective.py; `collective_pull/push`).
`stream` is the streaming plane (adapm_tpu_torch/stream) when a
--sys.stream.* knob is set. The lock-order sentinel is not ported yet:
asking for it raises NotImplementedError naming its ROADMAP item.
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
from ..device import cuda as dcuda
from ..device.context import DeviceContext, make_context
from ..exec.executor import dispatch_gate
from ..obs.spans import profiling, span
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


class _WaitEntry:
    __slots__ = ("groups", "out", "is_write", "keys", "remote", "futures")

    def __init__(self, groups=None, out=None, is_write=False, keys=None,
                 remote=None, futures=None):
        # groups: list of (class_id, row_positions, key_lengths, vals, n)
        self.groups = groups or []
        self.out = out
        self.is_write = is_write
        self.keys = keys
        self.remote = remote          # (positions, Future): remote keys
        self.futures = futures or []  # outstanding cross-process writes


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
                 dtype=torch.float32, net_node=None):
        self.opts = opts or SystemOptions()
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
        # identity comes from the net node when one is injected (a
        # LoopbackNode gives each in-process node its own rank), else
        # from the launcher's control plane (one process without it)
        self._net_node = net_node
        if net_node is not None:
            self.num_procs = int(net_node.num_procs)
            self.pid = int(net_node.pid)
        else:
            from ..parallel import control
            self.num_procs = control.num_processes()
            self.pid = control.process_id()

        from ..obs import metrics as _obs_metrics
        self.obs = _obs_metrics.MetricsRegistry(enabled=self.opts.metrics)
        _obs_metrics.set_global_registry(self.obs)
        self.spans = None
        # crash dumps (obs/crash.py; default on): faulthandler into a
        # per-rank file, the span breadcrumb, the flight-recorder ring
        self.crash_dump_path = None
        bc_path = ring_path = None
        if self.opts.crash_dumps:
            from ..obs.crash import enable_crash_dumps
            try:
                self.crash_dump_path, bc_path, ring_path = \
                    enable_crash_dumps(self.pid, self.opts.stats_out)
            except OSError:  # unwritable dump dir must not block startup
                bc_path = ring_path = None
        if self.opts.trace_spans:
            from ..obs.spans import SpanTracer
            self.spans = SpanTracer(
                rank=self.pid, breadcrumb_path=bc_path,
                max_events=self.opts.trace_spans_max_events,
                registry=self.obs)
        # request-flight tracing (obs/flight.py; default off: None, one
        # `is None` check per site, zero flight.* registry names)
        self.flight = None
        if self.opts.trace_flight:
            from ..obs.flight import FlightTracer
            self.flight = FlightTracer(
                registry=self.obs, rank=self.pid,
                freshness_bound=self.opts.flight_freshness_samples)
        # the executor flight-recorder ring rides --sys.crash_dumps: per
        # PROGRAM, never on the per-op hot path
        self.flight_recorder = None
        if self.opts.crash_dumps:
            from ..obs.flight import FlightRecorder
            self.flight_recorder = FlightRecorder(path=ring_path)
        # the fault-injection plane (fault/inject.py): None unless
        # --sys.fault.spec names points
        self.fault = None
        if self.opts.fault_spec:
            from ..fault.inject import FaultPlane
            self.fault = FaultPlane(self.opts.fault_spec,
                                    seed=self.opts.fault_seed,
                                    registry=self.obs)
        # workload trace capture (obs/wtrace.py): the semantic op stream
        # to a versioned, checksummed .wtrace for the replay engine. Off:
        # None, one `is None` check per site, no wtrace.* names
        self.wtrace = None
        if self.opts.trace_workload:
            from ..obs.wtrace import WorkloadTraceRecorder
            self.wtrace = WorkloadTraceRecorder(
                self, self.opts.trace_workload,
                key_budget=self.opts.trace_workload_keys)
        # decision telemetry (obs/decisions.py): every adaptive decision
        # with its features and a bounded outcome window, to a .dtrace.
        # Off: None, no decision.* names
        self.decisions = None
        if self.opts.trace_decisions:
            from ..obs.decisions import DecisionRecorder
            self.decisions = DecisionRecorder(
                self, self.opts.trace_decisions,
                follow_events=self.opts.trace_decisions_window)
        # the learned policy plane (adapm_tpu_torch/policy): trained
        # per-plane regret scorers that may veto a heuristic decision
        # (learned) or score it without applying (shadow). Off: None, no
        # policy.* names; a corrupt artifact raises PolicyError here
        self.policy = None
        if self.opts.policy_file:
            from ..policy.runtime import PolicyPlane
            self.policy = PolicyPlane(self)
        # set by a ReplayEngine that drove this server (the snapshot's
        # `replay` section)
        self.replay_stats: Optional[Dict] = None
        # the last checkpoint-chain restore's wall time (fault/ckpt.py
        # restore_chain) and the stream cursor a chain carried (also
        # applied to self.stream.cursor when the plane exists; kept apart
        # so a restore into a plane-less server still surfaces it)
        self._last_recovery_s: Optional[float] = None
        self._restored_stream_cursor: Optional[int] = None
        from ..fault.policy import RetryPolicy
        self._retry_policy = RetryPolicy(
            max_retries=self.opts.fault_retries,
            backoff_base_s=self.opts.fault_backoff_ms * 1e-3,
            backoff_max_s=self.opts.fault_backoff_max_ms * 1e-3)
        from ..exec import AsyncExecutor
        self.exec = AsyncExecutor(registry=self.obs,
                                  workers=self.opts.exec_workers,
                                  single_stream=self.opts.exec_single_stream,
                                  recorder=self.flight_recorder,
                                  retry_policy=self._retry_policy,
                                  fault=self.fault)
        # tier, the cross-process layer and the streaming plane are
        # built below
        self.tier = self.glob = self.net = self.stream = None
        # outstanding remote writes (future, keys): replication of a key
        # with an in-flight remote write is deferred — the owner's base
        # snapshot might miss the write (pm.py _install_replicas)
        self._rw_pending: List = []
        self.sampling = None  # set by enable_sampling_support
        # the serving plane attaches itself here (serve.ServePlane), so
        # metrics_snapshot folds its readiness in and shutdown closes it
        self._serve_plane = None
        # set while the server is DEGRADED (begin_degraded): the serving
        # plane sheds every lookup with ServeDegradedError
        self._degraded_reason: Optional[str] = None

        self._c_topo_bumps = self.obs.counter("kv.topology_bumps")
        self.obs.gauge("kv.topology_version",
                       fn=lambda: self.topology_version)
        self.obs.gauge("kv.workers", fn=lambda: len(self._workers))
        # collective wait-time histograms, observed by the (server-less)
        # control plane via observe_global (parallel/control.py)
        self.obs.histogram("collective.barrier_wait_s")
        self.obs.histogram("collective.allreduce_wait_s")

        self.stores: List[ShardedStore] = []
        for cid, L in enumerate(self.class_lengths):
            cache_slots = self.opts.cache_slots_per_shard
            if cache_slots == 0 and self.num_procs > 1:
                # multi-process auto default: data-parallel workloads
                # contest keys across processes, so give each shard 2x
                # the per-shard fair share (bounded by the class size);
                # ensure_local raises with a hint when the pool is the
                # limit
                fair = -(-int(class_counts[cid]) // self.ctx.num_shards)
                cache_slots = min(2 * fair, int(class_counts[cid]))
            self.stores.append(ShardedStore(
                int(class_counts[cid]), L, self.ctx, dtype=self.dtype,
                over_alloc=self.opts.main_over_alloc,
                cache_slots_per_shard=cache_slots,
                bucket_min=self.opts.remote_bucket_min,
                tier_hot_rows=(self.opts.tier_hot_rows
                               if self.opts.tier else 0),
                tier_cold_dtype=(self.opts.tier_cold_dtype
                                 if self.opts.tier else "fp32")))
        if self.obs.enabled and self.stores:
            _port = self.stores[0].port
            self.obs.gauge("device.programs_total", shared=True,
                           fn=lambda p=_port: p.programs)
            self.obs.gauge("device.wire_ingest_rows_total", shared=True,
                           fn=lambda p=_port: p.wire_ingest_rows)

        # the measured kernel cost table (ops/costs.py), attached when
        # --sys.costs.table names one: calibrate=1 measures K1 and K8 on
        # these stores and writes the table; otherwise a missing or
        # unreadable file means no table (the built-in choice applies)
        self.costs = None
        if self.opts.costs_table:
            from ..ops.costs import KernelCostTable, calibrate_server
            if self.opts.costs_calibrate:
                self.costs = calibrate_server(self)
                self.costs.save(self.opts.costs_table)
            else:
                try:
                    self.costs = KernelCostTable.load(
                        self.opts.costs_table)
                except OSError:
                    self.costs = None
            if self.costs is not None:
                self.costs.bind_metrics(self.obs)

        self.ab = Addressbook(
            key_class, self.ctx.num_shards,
            [s.main_slots for s in self.stores],
            [s.cache_slots for s in self.stores],
            num_procs=self.num_procs, pid=self.pid)
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
        if self.opts.lint_lockorder:
            # the runtime lock-order sentinel (lint/lockorder.py): this
            # server's locks join the process-wide acquisition graph, so a
            # cycle or a lock taken under the dispatch gate raises
            # LockOrderError at the acquire instead of deadlocking a
            # storm. Off (the default) keeps the plain locks above.
            from ..lint import lockorder
            lockorder.enable_sentinel()
            self._lock = lockorder.SentinelLock("server", self._lock)
            self._round_lock = lockorder.SentinelLock(
                "sync_round", self._round_lock)
            self.obs._lock = lockorder.SentinelLock(
                "metrics_registry", self.obs._lock)
        self._in_setup = False
        self._wb_cond = threading.Condition()
        self._wb_waiting: set = set()
        self._wb_gen = 0
        self._wb_done = 0
        # bumped whenever placement changes (replica add/drop, relocation)
        self.topology_version = 0

        self.sync = SyncManager(self, self.opts)
        # tiered storage (adapm_tpu_torch/tier): device-hot / host-cold
        # main-row residency with intent-driven promotion; None when
        # --sys.tier is off (the stores are then plain device pools)
        if self.opts.tier:
            self.opts.validate_serve()  # tier knob ranges (hand-built
            # SystemOptions skip parse-time validation)
            from ..tier.residency import TierManager
            self.tier = TierManager(self, self.opts)
        # the background planner's started/stopped token (None = stopped)
        self._sync_thread = None
        self._sync_stop = threading.Event()
        # background rounds that raised (each is logged and retried)
        self.sync_loop_failures = 0

        # cross-process layer: N processes (or loopback nodes) form one
        # PM (parallel/pm.py; reference van/postoffice data plane)
        if self.num_procs > 1:
            from ..parallel.pm import GlobalPM
            self.glob = GlobalPM(self, node=self._net_node)
            node = self.glob.node
            if hasattr(node, "bind"):
                # loopback: attach the executor + fault plane to the
                # port and start the membership beat thread
                node.bind(self)
            self.net = node.net_plane()
            if self.opts.heartbeat_s > 0:
                node.start_heartbeat(self.opts.heartbeat_s)

        # streaming plane (adapm_tpu_torch/stream): the acked-event
        # cursor, the ingest accounting and the FreshnessSLO controller.
        # None unless a --sys.stream.* knob is set (no stream.* names
        # then). Built after the sync manager (the controller's first
        # lever) and the executor (its tick and the trainer's pump run
        # there), started here so a freshness target steers at once
        if self.opts.stream_batch > 0 or \
                self.opts.stream_freshness_slo_ms > 0:
            from ..stream import StreamPlane
            plane = self.stream = StreamPlane(self)
            plane.start()

        # routing-plan cache + intent-driven prefetch pipeline (the hot
        # Pull/Push path levers; core/intent.py). Both revalidate against
        # topology_version, i.e. they depend on the _topology_mutation
        # discipline above.
        from .intent import PlanCache, PrefetchScheduler
        self._plan_cache = PlanCache(self.opts.plan_cache_entries,
                                     registry=self.obs) \
            if self.opts.plan_cache_entries > 0 else None
        self.prefetch = PrefetchScheduler(self, self.opts) \
            if self.opts.prefetch else None

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

        # periodic incremental checkpoints (fault/ckpt.py): with
        # --sys.checkpoint.every N + --sys.checkpoint.path D, a
        # self-rescheduling `ckpt`-stream program appends a dirty-slot
        # delta (base first) every N seconds. None when off.
        self.ckpt = None
        if self.opts.ckpt_every_s > 0:
            if not self.opts.ckpt_path:
                raise ValueError(
                    "--sys.checkpoint.every requires "
                    "--sys.checkpoint.path (chain directory)")
            from ..fault.ckpt import IncrementalCheckpointer
            self.ckpt = IncrementalCheckpointer(self, self.opts.ckpt_path)
            self.ckpt.start_periodic(self.opts.ckpt_every_s)

        # periodic metrics reporter (--sys.metrics.report N). The import
        # is inside the gate: with --sys.metrics 0 the reporter module
        # never loads (tests assert this).
        self._reporter = None
        if self.opts.metrics and self.opts.metrics_report_s > 0:
            from ..obs.reporter import Reporter
            self._reporter = Reporter(self.obs,
                                      self.opts.metrics_report_s,
                                      rank=self.pid)
            self._reporter.start()

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
        return span(self.spans, name)

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
        (optimistic routing). Returns (rem, loc_map, cls): `rem` is
        (positions, keys) of process-remote keys (None when there are
        none), `loc_map` the positions of the rest."""
        with self._span("kv.plan_pull"):
            rem = loc_map = None
            if self.glob is not None:
                proc_rem = (self.ab.owner[keys] < 0) & \
                    (self.ab.cache_slot[shard, keys] < 0)
                if proc_rem.any():
                    rem_pos = np.nonzero(proc_rem)[0]
                    rem = (rem_pos, keys[rem_pos])
                    loc_map = np.nonzero(~proc_rem)[0]
                    keys = keys[loc_map]
            cls = []
            if len(keys):
                for cid, pos in self._group_by_class(keys):
                    ks = keys[pos]
                    cls.append((cid, pos, ks,
                                self._route(ks, shard, record=False)))
            return rem, loc_map, cls

    def _pull(self, keys: np.ndarray, shard: int, after=(), plan=None):
        """Returns (groups, n_remote, remote): one gather per length
        class; `remote` is (positions, Future) for process-remote keys,
        served over the node's channel after `after` (this worker's
        outstanding remote writes: read-your-writes)."""
        if plan is None:
            plan = self._plan_pull(keys, shard)
        rem, loc_map, cls = plan
        groups = []
        remote = None
        n_remote = 0
        if rem is not None:
            rem_pos, rem_keys = rem
            remote = (rem_pos, self.glob.pull_async(rem_keys, after=after))
            n_remote = len(rem_pos)
        with dispatch_gate():
            for cid, pos, ks, (o_sh, o_sl, c_sh, c_sl, use_c, nr,
                               local) in cls:
                n_remote += nr
                if self.locality is not None:
                    self.locality.record(ks.ravel(), local.ravel())
                o_sl = np.where(use_c, OOB, o_sl).astype(np.int32)
                vals = self.stores[cid].gather(o_sh, o_sl, c_sh, c_sl,
                                               use_c)
                gpos = pos if loc_map is None else loc_map[pos]
                groups.append((cid, gpos, self.value_lengths[ks], vals,
                               len(ks)))
        return groups, n_remote, remote

    def _plan_push_routes(self, keys: np.ndarray, shard: int,
                          is_set: bool = False):
        """The cacheable routing part of `_plan_push` (the PlanCache entry
        for the 'push'/'set' kinds): (rem_pos, loc_pos, cls)."""
        rem_pos = loc_pos = None
        kloc = keys
        if self.glob is not None:
            # Set must reach the owner; Push may land in a local
            # replica's delta row
            if is_set:
                proc_rem = self.ab.owner[keys] < 0
            else:
                proc_rem = (self.ab.owner[keys] < 0) & \
                    (self.ab.cache_slot[shard, keys] < 0)
            if proc_rem.any():
                rem_pos = np.nonzero(proc_rem)[0]
                loc_pos = np.nonzero(~proc_rem)[0]
                kloc = keys[loc_pos]
        cls = []
        if len(kloc):
            for cid, pos in self._group_by_class(kloc):
                ks = kloc[pos]
                cls.append((cid, pos, ks,
                            self._route(ks, shard, write_through=is_set,
                                        record=False)))
        return rem_pos, loc_pos, cls

    def _plan_push(self, keys: np.ndarray, vals: np.ndarray, shard: int,
                   is_set: bool = False, routes=None):
        """Routing + staging plan for `_push`; same lock-free contract as
        `_plan_pull`. `routes` is an optional (plan-cached)
        `_plan_push_routes` result."""
        with self._span("kv.plan_push"):
            if routes is None:
                routes = self._plan_push_routes(keys, shard, is_set=is_set)
            rem_pos, loc_pos, cls_r = routes
            flat = vals.ndim == 1
            rem = None
            if rem_pos is not None:
                rem_keys = keys[rem_pos]
                if flat:
                    lens = self.value_lengths[keys]
                    offs = _offsets(lens)
                    rem_flat = _select_flat(vals, offs, lens, rem_pos)
                    vals = _select_flat(vals, offs, lens, loc_pos)
                else:
                    rem_flat = np.ascontiguousarray(vals[rem_pos]).ravel()
                    vals = vals[loc_pos]
                keys = keys[loc_pos]
                rem = (rem_pos, rem_keys, rem_flat)
            cls = []
            for cid, pos, ks, route in cls_r:
                L = self.class_lengths[cid]
                rows = self._flat_parts(keys, vals, pos, L) if flat \
                    else vals[pos]
                cls.append((cid, ks, rows, route))
            return rem, cls

    def _push(self, keys: np.ndarray, vals: np.ndarray, shard: int,
              is_set: bool = False, after=(), plan=None):
        """Returns (n_remote, futures): futures are outstanding
        cross-process writes, chained after `after` (the worker's
        earlier write futures) to keep per-worker write order. `plan` is
        an optional `_plan_push` result revalidated under the lock."""
        self._prefetch_note(keys)
        if plan is None:
            plan = self._plan_push(keys, vals, shard, is_set=is_set)
        rem, cls = plan
        n_remote = 0
        futures = []
        if rem is not None:
            rem_pos, rem_keys, rem_flat = rem
            chain = list(after)
            hk = None
            if is_set:
                # Set invalidates any local replicas of these keys: a
                # kept replica's pending delta would re-add on top of
                # the overwritten value. Flush the delta (ordered BEFORE
                # the set) and drop the replica; reads route to the
                # owner afterwards.
                cs = self.ab.cache_slot[shard, rem_keys]
                has = cs >= 0
                if has.any():
                    hk = np.unique(rem_keys[has])
                    lens_h = self.value_lengths[hk]
                    offs_h = _offsets(lens_h)
                    dflat = np.zeros(offs_h[-1], np.float32)
                    for cid, pos in self._group_by_class(hk):
                        rows = self.stores[cid].read_rows(
                            "delta", np.full(len(pos), shard, np.int32),
                            self.ab.cache_slot[
                                shard, hk[pos]].astype(np.int32))
                        _fill_flat(dflat, offs_h, lens_h, pos,
                                   rows.ravel())
                    self._drop_cross_replicas(hk, shard)
                    chain = chain + [self.glob.write_async(
                        hk, dflat, is_set=False, after=chain)]
            fut = self.glob.write_async(
                rem_keys, rem_flat.astype(np.float32), is_set,
                after=chain)
            if hk is not None:
                # the owner keeps serving sync for our dropped replicas
                # until we unsubscribe; do it once the set has landed
                fut = self.glob.unsub_async(hk, after=[fut])
            futures.append(fut)
            if len(self._rw_pending) > 64:
                self._prune_rw_pending()
            self._rw_pending.append((fut, rem_keys))
            n_remote += len(rem_pos)
        for cid, ks, rows, (o_sh, o_sl, c_sh, c_sl, use_c, nr,
                            local) in cls:
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
        return n_remote, futures

    # -- cross-process service endpoints (GlobalPM, under the lock) ---------

    def _read_owned_flat(self, keys: np.ndarray) -> np.ndarray:
        """Current main-copy values of locally-owned keys (flat concat):
        one K1 gather per class, read back before the reply is built."""
        if self.tier is not None and len(keys) >= self._BULK_READ_MIN:
            return self._read_owned_bulk(keys)
        return self._assemble_flat(keys, self._pull_main_only(keys))

    def _pull_main_only(self, keys: np.ndarray):
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
        return groups

    def _apply_remote_write(self, keys: np.ndarray, flat: np.ndarray,
                            is_set: bool) -> None:
        """Apply a cross-process push/set to locally-owned main rows."""
        self._prefetch_note(keys)
        flat = np.asarray(flat, dtype=np.float32)
        for cid, pos in self._group_by_class(keys):
            ks = keys[pos]
            L = self.class_lengths[cid]
            rows = self._flat_parts(keys, flat, pos, L)
            o_sh = self.ab.owner[ks].astype(np.int32)
            o_sl = self.ab.slot[ks].astype(np.int32)
            n = len(ks)
            zeros = np.zeros(n, np.int32)
            oob = np.full(n, OOB, np.int32)
            if is_set:
                self.stores[cid].set_rows(o_sh, o_sl, rows, zeros, oob)
            else:
                self.stores[cid].scatter_add(o_sh, o_sl, zeros, oob, rows)

    def _prune_rw_pending(self) -> None:
        """Drop completed remote-write records (caller holds the lock). A
        completed future means the write is applied at its owner, so any
        owner-side read after the prune observes it."""
        self._rw_pending = [(f, k) for f, k in self._rw_pending
                            if not f.done()]

    def _rw_blocked_keys(self):
        """Keys with remote writes recorded since the last prune (caller
        holds the lock); replication installs must skip them."""
        if not self._rw_pending:
            return None
        return np.unique(np.concatenate([k for _, k in self._rw_pending]))

    def _drop_cross_replicas(self, keys: np.ndarray, shard: int) -> None:
        """Drop this shard's replicas of remotely-owned `keys` (metadata +
        channel registry only; the caller flushes the deltas and
        unsubscribes at the owner). Caller holds the lock."""
        keys = keys[self.ab.cache_slot[shard, keys] >= 0]
        if len(keys) == 0:
            return
        with self._topology_mutation():
            self.sync.replica_discard(keys, shard)
            for _, pos in self._group_by_class(keys):
                self.ab.drop_replicas(keys[pos], shard)
            self.sync.stats.add(replicas_dropped=len(keys))

    def _flush_drop_local_replicas(self, keys: np.ndarray) -> None:
        """Flush pending deltas of all local replicas of `keys` into their
        local main copies and drop the replicas (before a forced
        cross-process relocation, so no delta is lost)."""
        sh_idx, k_idx = np.nonzero(self.ab.cache_slot[:, keys] >= 0)
        if len(k_idx) == 0:
            return
        karr = keys[k_idx].astype(np.int64)
        sarr = sh_idx.astype(np.int32)
        self._sync_replicas(karr, sarr)
        with self._topology_mutation():
            self.sync.replica_discard(karr, sarr)
            for s in np.unique(sarr):
                sk = karr[sarr == s]
                for _, pos in self._group_by_class(sk):
                    self.ab.drop_replicas(sk[pos], int(s))
            self.sync.stats.add(replicas_dropped=len(karr))

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

    def _prefetch_note(self, keys: np.ndarray) -> None:
        """Invalidate staged prefetch buffers that intersect a value
        write (caller holds the lock; every write path passes through
        here before a reader could miss the write — see
        PrefetchScheduler.note_writes)."""
        if self.prefetch is not None:
            self.prefetch.note_writes(keys)

    def ensure_local(self, keys: np.ndarray, shard: int) -> None:
        """Make process-remote `keys` locally servable (replicate or adopt
        via the owner's decision) — the fused runners' miss path: apps
        signal intent ahead so keys are local by step time; a cold miss
        blocks here once instead of computing on missing rows. No-op in a
        single process. Must not be called holding the server lock with
        a remote key among `keys` (it makes round trips)."""
        if self.glob is None:
            return
        with self._lock:
            rem = keys[(self.ab.owner[keys] < 0)
                       & (self.ab.cache_slot[shard, keys] < 0)]
        if len(rem) == 0:
            return
        rem = np.unique(rem)
        end = int(self._clocks.max()) + 2
        self.sync.intent_end[shard, rem] = np.maximum(
            self.sync.intent_end[shard, rem], end)
        for attempt in range(50):
            self.glob.intent_remote(rem, shard, end)
            # installs are deferred for keys with in-flight remote writes
            # (and capacity-truncated ones get unsubscribed) — retry until
            # everything is servable locally
            with self._lock:
                rem = rem[(self.ab.owner[rem] < 0)
                          & (self.ab.cache_slot[shard, rem] < 0)]
            if len(rem) == 0:
                return
            # a full cache pool frees up as expired replicas drop: drive a
            # full sync round (flush + drop) before retrying
            with self._round_lock:
                self.sync.run_round(all_channels=True)
            _time.sleep(0.005 * (attempt + 1))
        raise RuntimeError(
            f"{len(rem)} keys could not be made local on shard {shard} "
            f"(cache pool full? raise --sys.cache_slots); first: "
            f"{rem[:5].tolist()}")

    def all_local(self, keys: np.ndarray, shard: int) -> bool:
        """Whether every key is servable on `shard` without the network
        (owned here or replicated on the shard); always in one process."""
        if self.glob is None:
            return True
        return bool(((self.ab.owner[keys] >= 0)
                     | (self.ab.cache_slot[shard, keys] >= 0)).all())

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
                       threshold: float = 0.0,
                       compress: bool = False) -> None:
        """Sync replicas given parallel (key, holder-shard) arrays;
        threshold > 0 leaves small-delta replicas out of the round
        (--sys.sync.threshold). compress=True ships the deltas in the
        --sys.sync.compress format with the residual parked in the delta
        row; ONLY the periodic rounds pass it. Drop and quiesce flushes
        stay exact: a dropped replica's delta row is freed, so a
        compressed flush there would lose its parked residual. Under the
        lock: revalidation + enqueue."""
        mode = self.opts.sync_compress if compress else "off"
        with self._lock:
            ab = self.ab
            karr = np.ascontiguousarray(keys, dtype=np.int64)
            sarr = np.ascontiguousarray(shards, dtype=np.int32)
            # a sync refreshes replica bases (and may advance owner rows):
            # staged pull buffers of these keys are no longer what a
            # fresh pull would return
            self._prefetch_note(karr)
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
                                               threshold=threshold,
                                               compress=mode)

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
        pol = self.policy
        if pol is not None and len(keys) and pol.active("reloc"):
            # a learned reloc law may HOLD the whole batch in place: the
            # keys stay owned where they are and every pull and push
            # reaches the same main row — slower, never wrong. The
            # value-preservation guard: a dest replica's pending delta
            # merges inside the relocate program, so holding the move is
            # a bitwise no-op only when every dest replica of the batch
            # is verifiably clean (the exact store-epoch mask); otherwise
            # the heuristic's move proceeds unvetoed
            if pol.consult("reloc",
                           {"n_moved": len(keys), "n_demoted": 0},
                           len(keys)):
                rk = keys[self.ab.cache_slot[dest, keys] >= 0]
                if len(rk) == 0 or not self._dirty_replica_mask(
                        rk, np.full(len(rk), dest, np.int32)).any():
                    pol.applied("reloc")
                    return 0
                pol.guard_blocked("reloc")
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
        wt = self.wtrace
        if wt is not None and (n_moved or len(demoted)):
            # the move as it landed, with the pool-full demotions:
            # observational (replay lets the candidate policy re-decide)
            wt.record_decision("reloc", n_moved, dest=int(dest),
                               demoted=int(len(demoted)))
        dc = self.decisions
        if dc is not None and (n_moved or len(demoted)):
            # the same move with its features and a post-move-locality
            # outcome window over the keys that actually moved
            moved_keys = np.setdiff1d(keys, demoted) if len(demoted) \
                else keys
            dc.record_move(int(dest), n_moved, int(len(demoted)),
                           moved_keys)
        return n_moved

    # -- lifecycle -----------------------------------------------------------

    def start_sync_thread(self) -> None:
        """Run sync rounds in the background (reference SyncManager
        threads, coloc_kv_server.h:100-105). Optional: tests and apps
        drive rounds themselves.

        Rounds run as a self-rescheduling program on the executor's
        `sync` stream (one round per program, resubmitted until
        stopped). `_sync_thread` is the started/stopped token (None =
        stopped). A round that raises is logged, counted in
        `sync_loop_failures` and retried after a capped exponential
        backoff: the loop never dies of one failure."""
        if self._sync_thread is not None:
            return
        self._sync_stop.clear()
        state = {"last_report": _time.monotonic(), "last_rounds": 0,
                 "fail_streak": 0}
        token = object()
        self._sync_thread = token

        def tick():
            from ..utils import alog
            if self._sync_stop.is_set() or self._sync_thread is not token:
                return
            delay = 0.0
            try:
                if self.fault is not None:
                    # injection point: fires BEFORE the round does any
                    # work, so a retried tick re-runs cleanly
                    self.fault.fire("sync.round")
                with self._round_lock:
                    self.sync.run_round()
                state["fail_streak"] = 0
                # periodic report (reference SyncManager 10-second
                # reports, sync_manager.h:482-497)
                rs = self.opts.sync_report_s
                now = _time.monotonic()
                if rs > 0 and now - state["last_report"] >= rs:
                    dr = self.sync.stats.rounds - state["last_rounds"]
                    alog(f"[sync] "
                         f"{dr / (now - state['last_report']):.1f} "
                         f"rounds/s | " + self.sync.report())
                    state["last_report"] = now
                    state["last_rounds"] = self.sync.stats.rounds
            except Exception as e:  # noqa: BLE001 — the loop outlives
                # any one round: it reschedules with its own capped
                # backoff instead of dying with an error nobody waits on
                state["fail_streak"] += 1
                self.sync_loop_failures += 1
                delay = min(2.0, self.opts.fault_backoff_ms * 1e-3 *
                            (2.0 ** min(state["fail_streak"], 10)))
                if self.fault is not None:
                    self.fault.c_loop_retries.inc()
                alog(f"[sync] background round failed "
                     f"(streak {state['fail_streak']}): "
                     f"{type(e).__name__}: {e} — retrying in "
                     f"{delay * 1e3:.0f} ms")
            if not self._sync_stop.is_set() and \
                    self._sync_thread is token:
                self.exec.submit("sync", tick, label="sync.round",
                                 coalesce_key="sync.round", delay=delay)

        self.exec.submit("sync", tick, label="sync.round",
                         coalesce_key="sync.round")

    def stop_sync_thread(self) -> None:
        if self._sync_thread is None:
            return
        self._sync_stop.set()
        # drain, not join: at most one more queued round observes the
        # stop flag and returns. A round that does not drain is wedged
        # and still reads through the pools — proceeding into executor
        # close and pool teardown would be a use-after-teardown, so
        # fail-stop loudly instead
        if not self.exec.drain("sync", timeout=60):
            from ..utils import alog
            alog("[sync] background round failed to drain within 60s "
                 "of stop — wedged mid-round")
            raise RuntimeError(
                "sync round wedged: did not drain within 60s of stop; "
                "refusing to proceed into pool teardown under a live "
                "reader")
        self._sync_thread = None

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
        """Process barrier (the control plane's, parallel/control.py,
        replacing the reference's scheduler BARRIER protocol,
        src/postoffice.cc:149-174). One process: flush dispatch. The
        background sync rounds pause across it."""
        was_running = self._sync_thread is not None
        if was_running:
            self.stop_sync_thread()
        with self._span("collective.barrier"):
            self.block()
            if self.glob is not None:
                self.glob.node.barrier()
        if was_running:
            self.start_sync_thread()

    def block(self) -> None:
        with self._lock:
            for s in self.stores:
                # apm-lint: disable=APM002 quiesce point BY DESIGN: the
                # lock must be held across the device wait here, or a
                # racing op enqueues more work on the rows being drained
                s.block()

    def drive_rounds(self, n: int = 1) -> None:
        """One training step's planner-drive slot (the apps' per-step
        `sync.run_round` loop): inline when no prefetch pipeline, else
        delegated to the pipeline's programs on the executor, so planner
        work overlaps the in-flight device step instead of serializing
        after it."""
        if self.prefetch is not None:
            self.prefetch.pump(n)
        else:
            for _ in range(n):
                self.sync.run_round()

    def dead_nodes(self, max_age_s: float = 10.0) -> list:
        """Peer processes whose heartbeat has gone stale (reference
        Postoffice::GetDeadNodes; requires --sys.heartbeat > 0). With a
        net node attached, its membership plane is the authority."""
        if self.glob is not None:
            return self.glob.node.dead_peers(max_age_s)
        from ..parallel import control
        return control.dead_processes(max_age_s)

    # -- degraded readiness --------------------------------------------------

    def begin_degraded(self, reason: str) -> None:
        """Flip the server into DEGRADED state: the serving plane sheds
        every lookup loudly with ServeDegradedError (at the session door
        AND at batch-serve time), and readiness reports the reason. For
        any maintenance window in which reads must not race a state
        mutation. A plain write: readers are lock-free, and a lookup
        that read None just before the flip linearizes before the
        guarded mutation begins."""
        self._degraded_reason = str(reason)

    def end_degraded(self) -> None:
        self._degraded_reason = None

    @property
    def degraded(self) -> bool:
        return self._degraded_reason is not None

    @property
    def degraded_reason(self) -> Optional[str]:
        return self._degraded_reason

    def shutdown(self) -> None:
        """Idempotent teardown; readers go down before their substrate:
        the serving plane (its dispatchers read the pools), the metrics
        reporter, the prefetch pipeline (staged gathers, delegated
        rounds), the tier maintenance worker (demotion readbacks), the
        periodic checkpointer (an in-flight save reads the pools: its
        `ckpt` stream drains here), the background planner, then the
        executor, pool quiesce, stats/trace/flight export, registry
        unhook, then the cross-process layer (whose fallback drain and
        serve pools still answer peers until its pm-down barrier); the
        workload and decision recorders seal their files after the
        producers stopped."""
        if self._shutdown_done:
            return
        self._shutdown_done = True
        if self._serve_plane is not None:
            self._serve_plane.close()
        if self.stream is not None:
            # the ingest pump pushes through the live pools (its `stream`
            # stream drains inside close) and the freshness tick walks
            # sync and replica state
            self.stream.close()
        if self._reporter is not None:
            self._reporter.stop()
            self._reporter = None
        if self.prefetch is not None:
            self.prefetch.close()
        if self.tier is not None:
            self.tier.close()
        if self.ckpt is not None:
            self.ckpt.close()
        self.stop_sync_thread()
        self.exec.close()
        self.block()
        self.sync.close()
        self.write_stats()
        self.write_trace()
        self.write_flight_trace()
        if self.wtrace is not None:
            # final flush and seal after every producer stopped: the
            # .wtrace on disk is the complete recorded stream
            self.wtrace.close()
        if self.decisions is not None:
            # the same rule; close() force-resolves the open outcome
            # windows, whose probes read residency and addressbook state
            self.decisions.close()
        if self.spans is not None:
            self.spans.close()
        if self.flight_recorder is not None:
            self.flight_recorder.close()
        from ..obs import metrics as _obs_metrics
        _obs_metrics.clear_global_registry(self.obs)
        if self.glob is not None:
            self.glob.node.stop_heartbeat()
            self.glob.shutdown()

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
            if self.prefetch is not None:
                alog("[stats] prefetch: " + " ".join(
                    f"{k}={v}" for k, v in self.prefetch.report().items()))
            if self.tier is not None:
                alog("[stats] tier: " + " ".join(
                    f"{k}={v}" for k, v in self.tier.report().items()))
        if not self.opts.stats_out:
            return []
        from ..utils.stats import write_stats
        return write_stats(self.opts.stats_out, self.pid, self.tracer,
                           self.locality)

    # snapshot sections present (possibly empty) in every
    # metrics_snapshot(): the schema-stability contract tests pin
    _SNAPSHOT_SECTIONS = ("kv", "prefetch", "plan_cache", "staging",
                          "sync", "exec", "fused", "device", "serve",
                          "slo", "tier", "episode", "flight", "fault", "ckpt",
                          "wtrace", "replay", "decision", "policy", "pm",
                          "net", "collective", "stream")

    def metrics_snapshot(self) -> Dict:
        """The structured telemetry dict: `schema_version`,
        `metrics_enabled`, and the registry's sections plus every name
        in `_SNAPSHOT_SECTIONS` (`{}` where the subsystem is off).
        Schema 2 added `flight` (the tracer's stats and breakdown
        histograms with --sys.trace.flight; the flight recorder's
        summary as `recorder` with --sys.crash_dumps), `fault` (the
        injection plane's points and the executor's retries, with
        --sys.fault.spec) and `ckpt` (the checkpointer's saves and
        bytes; `recovery_s` after a chain restore), and
        `kv.local_answer_frac`. `tier` holds the residency gauges and
        counters (hit rate, promotions, demotions, hot rows used and
        capacity, cold bytes per row, the error-feedback residual map);
        `sync` the compression plane's `bytes_per_round`,
        `bytes_shipped`, `bytes_full_equiv` and `ef_residual_norm`;
        `episode` the EpisodicRunner's counters and prep/commit
        histograms. With a plane attached,
        `serve.readiness` is its `health.readiness()` dict. Schema 3
        added `wtrace` (the capture's events, drops, sampled batches,
        bytes, path and flushes, with --sys.trace.workload), `replay`
        (the stats a ReplayEngine stamped on the server it drove:
        events replayed, reads, `reads_digest`), `decision` (the
        recorder's tallies and regret gauges, with
        --sys.trace.decisions) and `policy` (consults, vetoes, applied,
        guard-blocked and shadow tallies per plane, with
        --sys.policy.file). With more than one process, `pm` holds the
        GlobalPM's counters and its hop histogram, and `net` (loopback
        nodes) the transport plane's msgs, bytes, retransmits, peers and
        failovers; with --sys.collective_sync, `collective` holds the BSP
        exchange's `bsp_rounds`, `bsp_iterations`, `bsp_rows_out` and
        `bsp_rows_in`. `stream` holds the streaming plane's cursor,
        ingest counters, trainer and FreshnessSLO report when a
        --sys.stream.* knob is set."""
        out: Dict = {"schema_version": 3,
                     "metrics_enabled": bool(self.obs.enabled)}
        for sec in self._SNAPSHOT_SECTIONS:
            out[sec] = {}
        if not self.obs.enabled:
            return out
        plane = self._serve_plane
        serve_ready = None
        if plane is not None:
            # probe readiness ONCE, before the registry snapshot: the
            # serve.ready/dead_peers gauges then read this result
            serve_ready = plane.health.readiness()
        for sec, vals in self.obs.snapshot().items():
            out.setdefault(sec, {}).update(vals)
        agg: Dict[str, int] = {}
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            for k, v in w.stats.items():
                agg[k] = agg.get(k, 0) + int(v)
        out["kv"].update(agg)
        po = agg.get("pull_ops", 0)
        out["kv"]["local_answer_frac"] = \
            (agg.get("pull_ops_local", 0) / po) if po else None
        out["kv"]["locality"] = self.locality_summary()
        if self.prefetch is not None:
            out["prefetch"].update(
                {k: int(v) for k, v in self.prefetch.report().items()})
        if self._plan_cache is not None:
            out["plan_cache"].update(self._plan_cache.stats())
        if self.glob is not None:
            with self.glob._stats_lock:
                out["pm"].update({k: int(v)
                                  for k, v in self.glob.stats.items()})
                out["pm"]["hops"] = [int(h) for h in self.glob.hops]
            if self.glob.coll is not None:
                out["collective"].update(
                    {f"bsp_{k}": int(v)
                     for k, v in self.glob.coll.stats.items()})
        if self.stream is not None:
            out["stream"].update(self.stream.stats())
        if self.net is not None:
            out["net"].update(self.net.stats())
        out["exec"].update(self.exec.stats())
        if self.stores:
            out["device"].update(self.stores[0].port.stats())
        if plane is not None and plane.slo is not None:
            out["slo"].update(plane.slo.report())
        if self.flight is not None:
            out["flight"].update(self.flight.stats())
        if self.flight_recorder is not None:
            out["flight"]["recorder"] = self.flight_recorder.summary()
        # fault/ckpt: populated only while the respective plane exists
        if self.fault is not None:
            out["fault"].update(self.fault.stats())
            out["fault"].update(self.exec.fault_stats())
        if self.ckpt is not None:
            out["ckpt"].update(self.ckpt.stats())
        if self._last_recovery_s is not None:
            out["ckpt"]["recovery_s"] = self._last_recovery_s
        if self.wtrace is not None:
            out["wtrace"].update(self.wtrace.stats())
        if self.decisions is not None:
            out["decision"].update(self.decisions.stats())
        if self.policy is not None:
            out["policy"].update(self.policy.stats())
        if self.replay_stats is not None:
            out["replay"].update(self.replay_stats)
        if serve_ready is not None:
            out["serve"]["readiness"] = serve_ready
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

    def write_flight_trace(self) -> Optional[str]:
        """Export the request-flight trace (Perfetto flow-event JSON)
        when --sys.trace.flight is on; returns the path. Called by
        shutdown; callable earlier for a mid-run export."""
        if self.flight is None:
            return None
        import os
        path = self.opts.trace_flight_out or os.path.join(
            self.opts.stats_out or ".", f"flight.{self.pid}.trace.json")
        return self.flight.export(path)

    def wait_sync(self) -> None:
        """Act on all signalled intents and complete a full sync round
        (reference WaitSync, coloc_kv_worker.h:517)."""
        with self._round_lock:
            self.sync.run_round(force_intents=True, all_channels=True)
        self.block()

    def quiesce(self) -> None:
        wt = self.wtrace
        if wt is not None:
            # recorded at entry: replay re-drives the quiesce at the same
            # point of the op stream
            wt.record_quiesce()
        with self._round_lock:
            self.sync.quiesce()

    def collective_pull(self, keys) -> np.ndarray:
        """BSP pull through the collective exchange — EVERY process must
        call this together (parallel/pm.py collective_pull;
        --sys.collective_sync). Returns owner values, flat."""
        assert self.glob is not None, "single process: use Worker.pull"
        return self.glob.collective_pull(keys)

    def collective_push(self, keys, vals) -> None:
        """BSP additive push through the collective exchange — same
        collective contract as collective_pull."""
        assert self.glob is not None, "single process: use Worker.push"
        self.glob.collective_push(keys, vals)

    # tiered batches at least this large read through _read_owned_bulk
    _BULK_READ_MIN = 65536

    def read_main(self, keys) -> np.ndarray:
        """Current authoritative main-copy values (flat concat).
        Multi-process: remotely-owned keys are read from their owner over
        the node's channel."""
        keys = np.asarray(keys, dtype=np.int64)
        if self.glob is not None:
            lens = self.value_lengths[keys]
            offs = _offsets(lens)
            out = np.empty(offs[-1], dtype=np.float32)
            with self._lock:
                owned = self.ab.owner[keys] >= 0
                pos = np.nonzero(owned)[0]
                if len(pos):
                    _fill_flat(out, offs, lens, pos,
                               self._read_owned_flat(keys[pos]))
            rem = np.nonzero(~owned)[0]
            if len(rem):
                flat_r, _ = self.glob.request_pull(keys[rem])
                _fill_flat(out, offs, lens, rem, flat_r)
            return out
        with self._lock:
            if self.tier is not None and len(keys) >= self._BULK_READ_MIN:
                return self._read_owned_bulk(keys)
            groups = self._pull_main_only(keys)
        return self._assemble_flat(keys, groups)

    def _read_owned_bulk(self, keys: np.ndarray) -> np.ndarray:
        """Checkpoint/eval/export-scale read of a tiered server: only the
        REQUESTED rows (the cold store's fancy index and one gather of
        the hot ones) — a whole-table copy would double host memory at
        the sizes tiering exists for."""
        from ..tier.coldpath import read_main_rows_bulk
        lens = self.value_lengths[keys]
        offs = _offsets(lens)
        out = np.empty(offs[-1], dtype=np.float32)
        for cid, pos in self._group_by_class(keys):
            ks = keys[pos]
            rows = read_main_rows_bulk(self.stores[cid], self.ab.owner[ks],
                                       self.ab.slot[ks])
            _fill_flat(out, offs, lens, pos, rows.ravel())
        return out

    def _assemble_flat(self, keys: np.ndarray, groups,
                       remote=None) -> np.ndarray:
        lens = self.value_lengths[keys]
        offs = _offsets(lens)
        out = np.empty(offs[-1], dtype=np.float32)
        for cid, pos, klens, vals, n in groups:
            _fill_flat(out, offs, lens, np.asarray(pos),
                       vals[:n].cpu().numpy().ravel())
        if remote is not None:
            rem_pos, fut = remote
            _fill_flat(out, offs, lens, rem_pos, fut.result())
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
        # outstanding cross-process write futures (read-your-writes and
        # per-worker write order across the channel)
        self._write_futs: List = []
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

    def _live_write_futs(self):
        self._write_futs = [f for f in self._write_futs if not f.done()]
        return list(self._write_futs)

    def _instrumented(self, name: str, h, impl, *args):
        """Latency histogram + span + flight bracket for a worker op; a
        plain call when all are off and no profiler records."""
        sp = self.server.spans
        fl = self.server.flight
        if h is None and sp is None and fl is None and not profiling():
            return impl(*args)
        t0 = _time.perf_counter()
        try:
            with span(sp, name):
                return impl(*args)
        finally:
            if h is not None:
                h.observe(_time.perf_counter() - t0)
            if fl is not None:
                # a plain Worker op is a single-segment flight: one
                # minted id, one slice on the caller's thread
                fl.record_op(name, t0)

    def _cached_push_routes(self, keys: np.ndarray, tv: int, is_set: bool):
        srv = self.server
        return srv._plan_cached(
            "set" if is_set else "push", self.shard, keys, tv,
            lambda: srv._plan_push_routes(keys, self.shard, is_set=is_set))

    # -- API: Pull / Push / Set ----------------------------------------------

    def pull(self, keys, out: Optional[np.ndarray] = None) -> int:
        """Async pull. Returns ts (use wait) or LOCAL=-1 if every key was
        served from this worker's shard (owned or replicated) — then `out`
        is already filled when provided.

        Fast path: a batch this worker declared intent for may have been
        pre-gathered by the prefetch pipeline (core/intent.py); the pull
        then consumes the staged device buffers — no planning, no server
        lock, no dispatch. The pipeline enforced validity (topology
        unchanged since the gather, no intersecting write), so a staged
        hit is bit-identical to the pull it replaced."""
        return self._instrumented("kv.pull", self._h_pull,
                                  self._pull_op, keys, out)

    def _pull_op(self, keys, out: Optional[np.ndarray]) -> int:
        keys = self._keys(keys)
        srv = self.server
        wt = srv.wtrace
        if wt is not None:
            wt.record_kv("pull", self.worker_id, self._clock, keys)
        if srv.prefetch is not None:
            st = srv.prefetch.take_staged(self, keys)
            if st is not None:
                self.stats["pull_ops"] += 1
                self.stats["pull_params"] += len(keys)
                self.stats["pull_params_local"] += len(keys) - st.n_remote
                entry = _WaitEntry(groups=st.groups, out=out, keys=keys)
                if st.n_remote == 0:
                    self.stats["pull_ops_local"] += 1
                    self._finish_pull(keys, entry)
                    return LOCAL
                return self._new_ts(entry)
        after = self._live_write_futs() if srv.glob is not None else ()
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
            groups, n_remote, remote = srv._pull(keys, self.shard,
                                                 after=after, plan=plan)
        self.stats["pull_ops"] += 1
        self.stats["pull_params"] += len(keys)
        self.stats["pull_params_local"] += len(keys) - n_remote
        entry = _WaitEntry(groups=groups, out=out, keys=keys,
                           remote=remote)
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
        flat = self.server._assemble_flat(keys, entry.groups,
                                          remote=entry.remote)
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
            groups, _, _ = srv._pull(keys, self.shard)
        return True, self._finish_pull(keys, _WaitEntry(groups=groups,
                                                        out=out))

    def push(self, keys, vals, asynchronous: bool = True) -> int:
        """Additive push (reference Push, coloc_kv_worker.h:120). vals is a
        flat buffer or [B, L]. Returns ts or LOCAL."""
        return self._instrumented("kv.push", self._h_push,
                                  self._write_op, keys, vals, False)

    def staggered_push(self, keys, vals, group_size: int = 100_000) -> int:
        """Push a large key set in groups (reference StaggeredPush,
        coloc_kv_worker.h:556-580: bounds per-request buffering when
        pushing e.g. a whole initial model). Returns the last group's
        ts."""
        keys = self._keys(keys)
        vals = np.asarray(vals, dtype=np.float32)
        flat = vals.ndim == 1
        if flat:
            cum = _offsets(self.server.value_lengths[keys])
        ts = LOCAL
        for lo in range(0, len(keys), group_size):
            hi = min(lo + group_size, len(keys))
            part = vals[cum[lo]:cum[hi]] if flat else vals[lo:hi]
            ts = self.push(keys[lo:hi], part)
        return ts

    def set(self, keys, vals) -> int:
        """Overwrite values (reference Set: non-additive write)."""
        return self._instrumented("kv.set", self._h_set,
                                  self._write_op, keys, vals, True)

    def _write_op(self, keys, vals, is_set: bool) -> int:
        keys = self._keys(keys)
        vals = np.asarray(vals, dtype=np.float32)
        srv = self.server
        wt = srv.wtrace
        if wt is not None:
            wt.record_kv("set" if is_set else "push", self.worker_id,
                         self._clock, keys)
        probe = None
        fl = srv.flight
        if fl is not None and not is_set:
            # event-to-servable freshness probe (sampled): push wall
            # time -> first serve read of the key; marked visible under
            # the lock once the scatter is enqueued
            probe = fl.freshness.note_push(keys)
        after = self._live_write_futs() if srv.glob is not None else ()
        plan, tv = None, -1
        if srv.opts.optimistic_routing:
            tv = srv.topology_version
            plan = srv._plan_push(
                keys, vals, self.shard, is_set=is_set,
                routes=self._cached_push_routes(keys, tv, is_set))
        # Set may invalidate (consume the delta of) cross-process
        # replicas; that must not interleave with an in-flight sync
        # round's extracted delta (pm.py delta_window, taken BEFORE the
        # server lock)
        dm = srv.glob.delta_window_for(keys) \
            if srv.glob is not None and is_set else contextlib.nullcontext()
        with dm, srv._lock:
            if plan is not None and srv.topology_version != tv:
                plan = None
            n_remote, futs = srv._push(keys, vals, self.shard,
                                       is_set=is_set, after=after,
                                       plan=plan)
            if probe is not None:
                fl.freshness.push_visible(probe)
        self._write_futs.extend(futs)
        if not is_set:
            self.stats["push_ops"] += 1
            self.stats["push_params"] += len(keys)
            self.stats["push_params_local"] += len(keys) - n_remote
            if n_remote == 0:
                self.stats["push_ops_local"] += 1
        if n_remote == 0:
            return LOCAL
        return self._new_ts(_WaitEntry(is_write=True, futures=futs))

    # -- API: waiting ---------------------------------------------------------

    def wait(self, ts: int):
        """Block until op `ts` is complete; for pulls returns the values."""
        if ts == LOCAL:
            return getattr(self, "_last_result", None)
        entry = self._pending.pop(ts, None)
        if entry is None:
            return None
        if entry.groups or entry.remote is not None:
            return self._finish_pull(entry.keys, entry)
        # write op: stream order covers the local programs; cross-process
        # writes complete when their futures resolve
        for f in entry.futures:
            f.result()
        self.server.block()
        return None

    def wait_all(self) -> None:
        for ts in sorted(self._pending.keys()):
            self.wait(ts)

    def is_finished(self, ts: int) -> bool:
        """Non-blocking completion check (reference IsFinished)."""
        if ts == LOCAL or ts not in self._pending:
            return True
        entry = self._pending[ts]
        if not all(f.done() for f in entry.futures):
            return False
        if entry.remote is not None and not entry.remote[1].done():
            return False
        dev = self.server.ctx.device
        return dev.type != "cuda" or dcuda.stream_idle(dev)

    def wait_sync(self) -> None:
        self.server.wait_sync()

    # -- API: intent + clock --------------------------------------------------

    def intent(self, keys, start: int, end: Optional[int] = None) -> None:
        """Declare future access to `keys` in clock window [start, end]
        (reference Intent, coloc_kv_worker.h:380-408; end defaults to
        start). With the prefetch pipeline on, the declaration also
        queues background staging: a later `pull` of exactly this
        (unique, sorted) key batch inside the window can be served from
        a pre-gathered staged buffer."""
        keys = np.unique(self._keys(keys))
        end = start if end is None else end
        srv = self.server
        wt = srv.wtrace
        if wt is not None:
            wt.record_intent(self.worker_id, self._clock, keys,
                             int(start), int(end))
        self._intent_queue.push(keys, int(start), int(end))
        if srv.prefetch is not None:
            srv.prefetch.on_intent(self, keys, int(start), int(end))

    def advance_clock(self) -> int:
        self._clock += 1
        self.server._clocks[self.worker_id] = self._clock
        wt = self.server.wtrace
        if wt is not None:
            wt.record_clock(self.worker_id, self._clock)
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
        h = self.server.sampling.prepare(self, n, int(start), int(end))
        wt = self.server.wtrace
        if wt is not None:
            wt.record_sample("prep_sample", self.worker_id, self._clock,
                             h, n, int(start), int(end))
        return h

    def pull_sample(self, handle: int, n: Optional[int] = None):
        """Draw n keys (default: all prepared) from sampling handle; returns
        (keys, values[B, L])."""
        wt = self.server.wtrace
        if wt is not None:
            wt.record_sample("pull_sample", self.worker_id, self._clock,
                             handle, n)
        return self.server.sampling.pull(self, handle, n)

    def pull_sample_keys(self, handle: int, n: Optional[int] = None):
        """Draw n keys without fetching values (for fused steps that gather
        values themselves); locality behavior matches pull_sample."""
        return self.server.sampling.pull_keys(self, handle, n)

    def finish_sample(self, handle: int) -> None:
        wt = self.server.wtrace
        if wt is not None:
            wt.record_sample("finish_sample", self.worker_id,
                             self._clock, handle, None)
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
