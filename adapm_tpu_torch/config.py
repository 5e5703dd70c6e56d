"""System configuration.

One dataclass replaces the reference's three config tiers (env vars + boost
program_options `--sys.*` + compile-time defines; SURVEY.md §5 "Config / flag
system"). `SystemOptions.add_arguments`/`from_args` provide the `--sys.*` CLI
surface so apps keep the reference's flag names.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from .base import MgmtTechniques

# wire/at-rest formats the knobs below accept (the JAX package's
# tier/quant.py tables; this package implements only fp32 / "off")
COLD_DTYPES = ("fp32", "fp16", "int8")
SYNC_COMPRESS_MODES = ("off", "fp16", "int8")


def parse_class_targets(base_ms: float, spec: str,
                        flag: str = "--sys.serve.slo_ms"):
    """Parse a per-priority-class target spec — comma-separated
    "prio=ms" pairs, e.g. "1=10,0=50" — into {priority: target_ms}.
    Empty spec -> {} (the byte-identical no-override path). Raises
    ValueError on a malformed pair, a negative priority, a non-positive
    target, a duplicate class, or overrides without a base target."""
    out = {}
    if not spec:
        return out
    if base_ms <= 0:
        raise ValueError(
            f"{flag}: per-class overrides ({spec!r}) require a base "
            f"target > 0 — classes without an override fall back to "
            f"the base, which must therefore exist")
    for part in spec.split(","):
        part = part.strip()
        cls_s, eq, val_s = part.partition("=")
        if not eq or not cls_s or not val_s:
            raise ValueError(
                f"{flag}: malformed per-class override {part!r} "
                f"(expected 'priority=target_ms', e.g. '1=10')")
        try:
            cls = int(cls_s)
            val = float(val_s)
        except ValueError:
            raise ValueError(
                f"{flag}: malformed per-class override {part!r} "
                f"(priority must be an int, target a float)") from None
        if cls < 0:
            raise ValueError(
                f"{flag}: priority class must be >= 0 (got {cls})")
        if val <= 0:
            raise ValueError(
                f"{flag}: per-class target must be > 0 ms "
                f"(got {val:g} for class {cls})")
        if cls in out:
            raise ValueError(
                f"{flag}: duplicate override for class {cls}")
        out[cls] = val
    return out


def _slo_spec(text: str) -> str:
    """argparse type for SLO flags that accept "base_ms" or
    "base_ms,prio=ms,...": syntax-checks at parse time (range and
    consistency checks live in validate_serve) and returns the raw
    string for from_args to split."""
    head, _, rest = text.partition(",")
    try:
        float(head)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected 'target_ms' or 'target_ms,prio=ms,...' "
            f"(got {text!r})") from None
    for part in rest.split(",") if rest else ():
        cls_s, eq, val_s = part.strip().partition("=")
        ok = bool(eq)
        if ok:
            try:
                int(cls_s)
                float(val_s)
            except ValueError:
                ok = False
        if not ok:
            raise argparse.ArgumentTypeError(
                f"malformed per-class override {part!r} in {text!r} "
                f"(expected 'priority=target_ms')")
    return text


def _split_slo_spec(text: str):
    """"25,1=10" -> (25.0, "1=10"); "25" -> (25.0, "")."""
    head, _, rest = str(text).partition(",")
    return float(head), rest


@dataclasses.dataclass
class SystemOptions:
    """Knobs for the parameter manager (reference coloc_kv_server.h:205-222,
    sync_manager.h:805-814, sampling.h:163-172)."""

    # -- management techniques (sys.techniques)
    techniques: MgmtTechniques = MgmtTechniques.ALL
    # -- channels (sys.channels): number of independent sync streams.
    #    On the device the sync program is a single fused collective per round;
    #    channels partition
    #    keys so each round can sync a subset (bounding per-round payload).
    channels: int = 4
    # -- location caches (sys.location_caches): keep per-host stale owner hints
    location_caches: bool = True
    # -- intent action timing (sys.time_intent_actions): ActionTimer on/off
    time_intent_actions: bool = True

    # -- heartbeat (reference PS_HEARTBEAT_INTERVAL, src/van.cc:515-527;
    #    0 = off, matching the reference's default)
    heartbeat_s: float = 0.0

    # -- cross-process channel concurrency (reference --sys.zmq_threads,
    #    coloc_kv_server.h:208): read-executor width of the GlobalPM;
    #    write executors get half, floored at 2 (a write task may wait on
    #    an earlier write future, so one thread could self-block)
    dcn_threads: int = 8

    # -- transport plane (sys.net.*; adapm_tpu/net, docs/NETWORK.md):
    #    backend selects the wire under GlobalPM — "auto" = the legacy
    #    DCN channel (byte-identical pre-NetPort behavior), "tcp" = the
    #    framed TcpNetPort, "loopback" = the in-process fabric (tests/
    #    storms; normally injected via Server(net_node=...)); queue
    #    bounds the loopback per-peer inbox; timeout_ms is the per-
    #    attempt request timeout; heartbeat_ms paces membership beats
    net_backend: str = "auto"
    net_queue: int = 64
    net_timeout_ms: float = 5000.0
    net_heartbeat_ms: float = 100.0

    # -- sync throttling (sys.sync.*)
    sync_max_per_sec: float = 1000.0
    sync_pause_ms: float = 0.0
    sync_threshold: float = 0.0      # drop deltas with max-abs below threshold
    # dirty-delta filtering (core/sync.py sync_channel): rounds ship only
    # replicas with an unshipped write or a stale base (store.py write
    # epochs) — exact, so a filtered round reads bit-identically to a
    # full one. Default on; 0 is the kill switch (re-sync every
    # intent-live replica every round, the pre-PR-3 behavior).
    sync_dirty_only: bool = True
    # delta compression for sync rounds: periodic
    # rounds ship deltas in fp16 (half the bytes) or int8 + per-key
    # fp16 scale (~quarter) with per-key error feedback — the
    # quantization remainder parks in the replica's delta row and
    # rides the next round, keeping the main copy's long-run sum
    # unbiased; drop/quiesce flushes stay exact. "off" (default) is
    # bit-identical to pre-compression behavior. Requires the dirty
    # filter: compression marks synced replicas clean with a sub-grid
    # residual parked, a bookkeeping step the full-resync path has no
    # epoch state for (validate_serve rejects the combination).
    sync_compress: str = "off"

    # -- collective sync data plane (parallel/collective.py): replica
    #    delta ship + fresh-value refresh ride device all-to-all exchanges
    #    at WaitSync/quiesce points instead of per-destination DCN RPC
    #    (SURVEY's ICI mapping; off = the reference-parity host channel)
    collective_sync: bool = False
    collective_bucket: int = 1024    # rows per peer per exchange iteration
    # bounded staleness for collective mode: every process joins a BSP
    # exchange each time its workers' min clock crosses a multiple of K
    # (checked in run_round), so a replica observes remote pushes within
    # K clocks — the reference's continuously-running sync loop analog
    # (sync_manager.h:452-520). 0 = exchanges only at WaitSync/quiesce.
    # Requires clock-advancing training loops on EVERY process (the
    # co-located worker+server model); skewed per-process batch counts
    # are absorbed by the quiesce-time flag loop.
    collective_cadence: int = 0

    # -- optimistic routing (reference per-key lock array,
    #    handle.h:1069-1083): worker Pull/Push route + stage OUTSIDE the
    #    server lock against a topology_version snapshot, then revalidate
    #    under the lock and re-plan on a miss. Shrinks the serialized
    #    critical section to the device dispatch itself so N worker
    #    threads scale on multi-core hosts; off = route under the lock.
    optimistic_routing: bool = True

    # -- prefetch pipeline (sys.prefetch.*; core/intent.py
    #    PrefetchScheduler): consume Worker.intent declarations on a
    #    background thread — delegated planner rounds, staged device
    #    table mirrors, and pre-gathered pull buffers — so the training
    #    thread's per-step critical path is the device dispatch alone.
    #    Not ported yet (ROADMAP queue A, item 7): default off here, and
    #    the Server refuses it.
    prefetch: bool = False
    # staged pull batches kept per worker (oldest evicted beyond this)
    prefetch_max_batches: int = 4
    # device rows the staging pool may hold per length class (bounds the
    # HBM the pipeline can pin; 65536 rows of 512 f32 = 128 MiB)
    prefetch_staging_rows: int = 65536
    # when to pre-gather pull buffers: "auto" stages only for workers
    # that use the Pull API (fused-runner loops never pull — staging
    # gathers for them is wasted device work), "always"/"off" force it
    prefetch_pull: str = "auto"
    # routing-plan cache entries (core/intent.py PlanCache; 0 = off)
    plan_cache_entries: int = 64

    # -- ActionTimer (sys.timing.*; reference sync_manager.h:62-158)
    timing_alpha: float = 0.1
    timing_quantile: float = 0.9999
    timing_rounds_lookahead: float = 2.0

    # -- tiered parameter storage (sys.tier.*; adapm_tpu/tier,
    #    docs/MEMORY.md): split each server's owned keys between a
    #    capacity-bounded device-hot main pool and a host-resident cold
    #    store, with intent-driven promotion and a background demotion
    #    worker. Decouples model size from HBM: the device main pool
    #    holds --sys.tier.hot_rows rows per shard per length class
    #    instead of the whole table. Reads/writes of cold rows are
    #    served correctly-but-slowly through the cold path and remain
    #    bit-identical to the untiered store. Default off.
    tier: bool = False
    # device-resident main rows per shard per length class
    tier_hot_rows: int = 65536
    # cold-store at-rest format: fp32 keeps
    # the bit-identity pin; fp16 halves host bytes/row (exact where
    # the value is fp16-representable); int8 + per-row scale quarters
    # them (exact on the row's int grid) — both otherwise follow the
    # error-compensated contract in docs/MEMORY.md (demote parks the
    # sub-grid remainder host-side; the next promote folds it back)
    tier_cold_dtype: str = "fp32"
    # pin keys inside an active Intent window hot for the window
    tier_pin_intent: bool = True
    # demotion batch size / per-shard free-row headroom the maintenance
    # worker maintains (a promotion that finds headroom never pays a
    # victim readback on the caller's path)
    tier_demote_batch: int = 1024

    # -- unified async executor (sys.exec.*; adapm_tpu/exec,
    #    docs/EXECUTOR.md): the one ordered-stream dispatch plane under
    #    sync rounds, prefetch staging, tier maintenance, serve
    #    batching, and fused steps. Worker-pool width bounds how many
    #    streams make progress concurrently (background subsystems
    #    share it; the training thread dispatches inline).
    exec_workers: int = 4
    # serialized fallback: one worker thread, so background programs
    # execute strictly one at a time (oldest submission first) with
    # zero cross-stream overlap; streams keep their identity, so
    # per-subsystem drains and delayed programs still behave. The
    # baseline the bench `exec` phase and scripts/exec_overlap_check.py
    # compare the overlapped default against, and the conservative
    # escape hatch.
    exec_single_stream: bool = False

    # -- episodic execution (sys.episode.*; the JAX package's
    #    device/episode.py): default step-batches per episode for EpisodicRunner
    #    — the window whose union working set is pinned device-hot as a
    #    unit while the next window's samples/gathers/wire rows stage on
    #    the `episode` stream. Larger episodes amortize prep over more
    #    steps but need hot capacity for two windows to overlap fully.
    episode_batches: int = 8

    # -- store geometry
    cache_slots_per_shard: int = 0   # 0 = auto (num_keys // num_shards)
    remote_bucket_min: int = 8       # min padded size of the remote op bucket
    # main-pool headroom factor for relocations (slots per shard =
    # keys_per_shard * over_alloc); at memory-bound scale (e.g. a
    # Wikidata5M-sized table filling most of HBM) set close to 1.0
    main_over_alloc: float = 1.25

    # -- observability (sys.stats.*, sys.trace.*, sys.metrics*; obs/)
    stats_out: Optional[str] = None
    trace_keys: Optional[str] = None
    # per-key access counters (PS_LOCALITY_STATS)
    locality_stats: bool = False
    sync_report_s: float = 10.0      # periodic sync-thread report (0 = off)
    # unified metrics registry (docs/OBSERVABILITY.md): counters/gauges/
    # histograms behind Server.metrics_snapshot(). Default ON (<2%
    # overhead budget on the bench probe phase; guarded by
    # scripts/metrics_overhead_check.py); --sys.metrics 0 disables the
    # registry entirely (null metrics, empty snapshot, no reporter import)
    metrics: bool = True
    # periodic one-line metrics report every N seconds (0 = off; the
    # reporter module is only imported when > 0 AND metrics is on)
    metrics_report_s: float = 0.0
    # span tracing: begin/end events for named phases, exported as
    # Chrome trace-event JSON (Perfetto-loadable) at shutdown. Default
    # off — spans bracket the hot Pull/Push path.
    trace_spans: bool = False
    # trace output path (default: <stats_out or cwd>/spans.<rank>.trace.json)
    trace_spans_out: Optional[str] = None
    # faulthandler crash dumps with a per-rank file (+ last-open-span
    # breadcrumb when trace_spans is on, + the executor flight-recorder
    # ring file). Not ported yet (ROADMAP queue A, item 10): default
    # off here, and the Server refuses it.
    crash_dumps: bool = False
    # request-flight tracing (obs/flight.py, docs/OBSERVABILITY.md):
    # per-request trace ids minted at ServeSession.lookup /
    # Worker.pull|push, carried through admission -> batch -> executor
    # program -> reply and exported as Perfetto FLOW events, plus the
    # queue/batch_wait/dispatch/device breakdown histograms and the
    # push-to-servable freshness probe. Default off — same skip-wrapper
    # discipline as trace_spans: off costs one `is None` check per op
    # and registers zero flight.* metrics.
    trace_flight: bool = False
    # flight trace output path
    # (default: <stats_out or cwd>/flight.<rank>.trace.json)
    trace_flight_out: Optional[str] = None
    # freshness-probe table bound: how many
    # in-flight push-to-servable probes the FreshnessProbe may hold
    # before evicting the oldest unresolved one. The earlier hardcoded
    # bound (256) was fine for a spot gauge but too noisy as an SLO
    # input — at-bound eviction silently drops the probes a controller
    # steers by. >= 8; raise further for high-fanout streams.
    flight_freshness_samples: int = 1024
    # workload trace capture:
    # record the semantic op stream — pull/push/set key batches, intent
    # windows, clock advances, serve lookups with tenant/priority/
    # deadline, PrepareSample/PullSample, and relocation/sync/promotion
    # decisions as they landed — into a versioned, checksummed .wtrace
    # file at this path, replayable offline by adapm_tpu/replay/.
    # Default off (None): Server.wtrace is None, every instrumented
    # site pays one `is None` check, zero wtrace.* registry names (the
    # skip-wrapper discipline; scripts/metrics_overhead_check.py).
    trace_workload: Optional[str] = None
    # per-event exact-key budget: batches up to this record their exact
    # keys; larger batches record an evenly-strided sample + the true
    # count, loudly (wtrace.sampled_batches_total)
    trace_workload_keys: int = 4096
    # decision telemetry capture: record every
    # adaptive decision — relocate-vs-replicate, tier promote/demote
    # with the anti-thrash verdict, dirty-sync ship/hold, SLO window
    # moves, prefetch stage/skip, cost-table overrides — with the
    # feature vector visible at decision time and a bounded follow-up
    # outcome window, into a versioned, checksummed .dtrace file at
    # this path (replay/dataset.py exports the labeled join). Default
    # off (None): Server.decisions is None, every instrumented site
    # pays one `is None` check, zero decision.* registry names (the
    # skip-wrapper discipline; scripts/metrics_overhead_check.py).
    trace_decisions: Optional[str] = None
    # outcome-attribution follow-up window: a decision's outcome probe
    # resolves after this many same-plane decisions (or 8x any-plane
    # events, or the recorder's wall deadline, whichever first); >= 1
    trace_decisions_window: int = 8
    # span-event buffer bound (obs/spans.py): spans
    # beyond it are counted loudly in spans.dropped instead of stored.
    # Validated >= 1000 — a tiny bound would silently gut every trace
    trace_spans_max_events: int = 1_000_000

    # -- online serving plane (sys.serve.*; adapm_tpu/serve,
    #    docs/SERVING.md). Knob ranges are validated by validate_serve()
    #    at parse time AND at ServePlane construction — bad combinations
    #    fail loudly instead of mis-serving.
    # requests coalesced into one fused lookup gather (>= 1)
    serve_max_batch: int = 64
    # micro-batch window: how long the dispatcher lingers after the
    # first request to coalesce more (>= 0; 0 = dispatch immediately
    # with whatever is already queued)
    serve_max_wait_us: int = 200
    # admission queue bound (> 0): submissions beyond this are rejected
    # with ServeOverloadError (backpressure, never an unbounded queue)
    serve_queue: int = 1024
    # default per-lookup deadline in ms (0 = none); expired requests
    # are shed loudly (DeadlineExceededError), never parked
    serve_deadline_ms: float = 0.0
    # tail-latency SLO target in ms (0 = off, the default). When set, a
    # closed-loop controller (obs/slo.py) observes the serve P99 from
    # the latency histogram and adapts the effective max_wait_us —
    # bounded, with hysteresis — so tails track the target instead of
    # the hand-tuned static window. When unset, serve behavior is
    # IDENTICAL to the static-knob path (no controller exists).
    # Requires --sys.metrics (the controller reads the histogram).
    # The CLI flag also accepts per-priority-class overrides:
    # "25,1=10,0=50" sets the base target to 25 ms, class 1 (gold) to
    # 10 ms, class 0 (bronze) to 50 ms — parsed into serve_slo_class
    # below.
    serve_slo_ms: float = 0.0
    # per-priority-class SLO overrides: "prio=ms" pairs, comma-separated
    # ("1=10,0=50"). With any override set the SLO controller keeps a
    # per-class effective batch window (batcher.class_wait_us) and
    # walks each class's window against ITS target from per-class
    # windowed P99s; empty (the default) leaves the single-window path
    # byte-identical to the single-target form. Requires serve_slo_ms > 0.
    serve_slo_class: str = ""
    # dispatcher drains: N
    # admission lanes, each drained by its own executor stream
    # (`serve`, `serve.1`, ...), so a long-row length class's gather no
    # longer head-of-line-blocks short ones. Lanes are keyed by length
    # class on multi-class servers, round-robin otherwise. 1 (the
    # default) is the pre-PR single-consumer path, bit-identical.
    serve_dispatchers: int = 1
    # read-only serve replica:
    # rows in the epoch-versioned snapshot of the hottest locally-owned
    # rows. A lookup fully covered by a snapshot whose per-slot write
    # epochs (and topology_version) are unchanged gathers WITHOUT the
    # server lock — bit-identical to the locked path by construction;
    # any staleness signal falls back to the exact path. 0 (default) =
    # off: every lookup takes the pre-PR locked path.
    serve_replica_rows: int = 0
    # min interval between snapshot refreshes (the coalesced
    # `serve_refresh` executor program's throttle), in ms
    serve_replica_refresh_ms: float = 50.0
    # fused embedding-bag reads: serve
    # `ServeSession.lookup_bags` through ONE gather+pool device program
    # per (length class, pooling) — only the pooled vectors cross the
    # device boundary. Off = pool on the host after the flat union
    # gather; bit-identical either way (the knob moves WHERE the
    # reduction runs, never what it returns).
    serve_bags: bool = True

    # -- streaming plane (sys.stream.*; adapm_tpu/stream,
    #    docs/STREAMING.md): the PM as a continuously-trained online
    #    service — a micro-batching StreamTrainer turning click events
    #    into fused Push steps while ServeSessions read, plus a
    #    FreshnessSLO controller closing the loop on event-to-servable
    #    staleness. With NO stream knob set the Server holds no stream
    #    plane object and the registry holds zero stream.* names (the
    #    skip-wrapper discipline).
    # events per fused push micro-batch (the trainer's unit of work AND
    # its ack/checkpoint granularity — the acked-event cursor only
    # advances at batch boundaries). 0 (default) = no trainer support;
    # > 0 turns the stream plane on.
    stream_batch: int = 0
    # target ingest rate in events/s for the executor pump (0 =
    # unthrottled: each micro-batch is pushed as soon as the previous
    # one finishes). Requires stream_batch > 0.
    stream_rate: float = 0.0
    # event-to-servable freshness SLO target in ms (0 = off). When set,
    # a FreshnessSLO controller (stream/freshness.py) observes the
    # windowed P99 of flight.freshness_s and walks TWO levers — the
    # effective sync rate (sync.effective_max_per_sec above the static
    # --sys.sync.max_per_sec throttle) and the effective serve-replica
    # refresh window (ServeReplica.refresh_s below the static
    # --sys.serve.replica_refresh_ms) — with the obs/slo.py law:
    # multiplicative shrink/grow, deadband hysteresis, hard bounds,
    # bounded move log. Requires --sys.trace.flight (the freshness
    # probe is the sensor) and --sys.metrics. The CLI flag accepts the
    # same per-class override syntax as --sys.serve.slo_ms
    # ("400,1=200"): the controller steers to the TIGHTEST class
    # target (freshness is a write-path property shared by all
    # classes; docs/STREAMING.md).
    stream_freshness_slo_ms: float = 0.0
    # per-priority-class freshness overrides ("prio=ms" pairs; parsed
    # from the flag above). Requires stream_freshness_slo_ms > 0.
    stream_freshness_slo_class: str = ""

    # -- measured kernel cost table (sys.costs.*; adapm_tpu/ops/
    #    costs.py, docs/PERF.md "Kernel cost table"): per-(variant,
    #    length class, batch bucket, dtype, pooling) measured dispatch
    #    costs, persisted as versioned JSON at costs_table. The serve
    #    batcher consults it to pick fused vs host-pool bag dispatch;
    #    the episodic planner sizes prep windows from the per-class
    #    entries. No table (the default) = built-in preference order,
    #    no file I/O anywhere.
    costs_table: Optional[str] = None
    # measure-and-write at server construction (one-time calibration
    # pass over the cost probes; requires costs_table for the output)
    costs_calibrate: bool = False

    # -- fault injection + error policy (sys.fault.*; adapm_tpu/fault,
    #    docs/failure_handling.md). The spec is `point=prob` pairs
    #    (comma-separated), e.g. "sync.round=0.2,serve.drain=0.1" —
    #    empty (the default) means NO FaultPlane exists: every
    #    instrumented site pays one `is None` check and the registry
    #    holds zero fault.* names (scripts/metrics_overhead_check.py).
    fault_spec: str = ""
    # seed for the per-point injection RNGs (deterministic drills)
    fault_seed: int = 0
    # executor error policy: bounded retries for TRANSIENT program
    # failures (TransientFaultError classification — inert unless
    # something raises it), exponential backoff from backoff_ms capped
    # at backoff_max_ms
    fault_retries: int = 3
    fault_backoff_ms: float = 10.0
    fault_backoff_max_ms: float = 2000.0
    # per-program watchdog: an executor program busy past this marks
    # its stream WEDGED (readiness escalation; never an interrupt —
    # the waiters' own bounds fail-stop)
    fault_watchdog_s: float = 30.0

    # -- incremental checkpoints (sys.checkpoint.*; adapm_tpu/fault/
    #    ckpt.py): every N seconds a `ckpt`-stream executor program
    #    appends a dirty-slot delta (base first) to the chain at
    #    checkpoint.path. 0 (default) = no periodic checkpointing;
    #    explicit IncrementalCheckpointer use needs no knobs.
    ckpt_every_s: float = 0.0
    ckpt_path: Optional[str] = None

    # -- learned adaptive-policy plane (sys.policy.*; adapm_tpu/
    #    policy, docs/POLICY.md). policy_file names a trained artifact
    #    (`python -m adapm_tpu.policy.train`); each per-plane mode
    #    knob picks `heuristic` (default — the hand-tuned law, exactly
    #    as before) or `learned` (the trained regret scorer may VETO
    #    the heuristic's action through a value-preservation guard —
    #    a policy changes what/when, never values). policy_shadow
    #    scores the learned policy live WITHOUT applying it
    #    (policy.shadow_agree/disagree — the promotion runbook's A/B).
    #    No file (the default) means NO PolicyPlane exists: every hook
    #    site pays one `is None` check and the registry holds zero
    #    policy.* names (the skip-wrapper discipline;
    #    scripts/metrics_overhead_check.py).
    policy_reloc: str = "heuristic"
    policy_tier: str = "heuristic"
    policy_sync: str = "heuristic"
    policy_serve: str = "heuristic"
    policy_file: Optional[str] = None
    policy_shadow: bool = False

    # -- runtime lock-order sentinel (sys.lint.*; adapm_tpu/lint/
    #    lockorder.py, docs/INVARIANTS.md): wrap the server lock, the
    #    dispatch gate, and the admission/registry locks in a recorder
    #    that raises LockOrderError on an acquisition-graph cycle or a
    #    gate-leaf violation (any lock taken while the gate is held).
    #    Default off — the Server then builds plain RLocks and the
    #    gate proxy pays one `is None` check per acquire (the
    #    skip-wrapper discipline). The tier-1 storm tests run with it
    #    on, so the dynamic checker validates exactly what the static
    #    adapm-lint rules (APM001/APM002) claim.
    lint_lockorder: bool = False

    # -- sampling (--sampling.*)
    sampling_scheme: str = "local"   # naive | preloc | pool | local
    sampling_reuse_factor: int = 32  # pool scheme
    sampling_pool_size: int = 0      # pool scheme; 0 = auto
    sampling_batch_size: int = 1024  # RNG batching
    sampling_with_replacement: bool = True

    def validate_serve(self) -> None:
        """Range/consistency checks for the --sys.serve.* surface.
        Raises ValueError; called by `from_args`
        (parse-time) and by `ServePlane.__init__` (hand-built options),
        so a bad knob fails loudly before it can mis-serve."""
        if self.serve_max_batch < 1:
            raise ValueError(
                f"--sys.serve.max_batch must be >= 1 "
                f"(got {self.serve_max_batch}): a coalescer that can "
                f"never form a batch serves nothing")
        if self.serve_max_wait_us < 0:
            raise ValueError(
                f"--sys.serve.max_wait_us must be >= 0 "
                f"(got {self.serve_max_wait_us})")
        if self.serve_queue < 1:
            raise ValueError(
                f"--sys.serve.queue must be > 0 (got {self.serve_queue}): "
                f"a zero-bound admission queue rejects every request")
        if self.serve_deadline_ms < 0:
            raise ValueError(
                f"--sys.serve.deadline_ms must be >= 0 "
                f"(got {self.serve_deadline_ms}; 0 = no deadline)")
        if self.serve_slo_ms < 0:
            raise ValueError(
                f"--sys.serve.slo_ms must be >= 0 "
                f"(got {self.serve_slo_ms}; 0 = no SLO controller)")
        if self.serve_slo_ms > 0 and not self.metrics:
            raise ValueError(
                "--sys.serve.slo_ms requires --sys.metrics: the SLO "
                "controller observes the serve P99 from the "
                "serve.latency_s histogram and is blind without it")
        # per-class override specs: parse loudly
        # here so a malformed "prio=ms" pair fails at parse time / plane
        # construction, never inside a controller tick
        parse_class_targets(self.serve_slo_ms, self.serve_slo_class,
                            flag="--sys.serve.slo_ms")
        parse_class_targets(self.stream_freshness_slo_ms,
                            self.stream_freshness_slo_class,
                            flag="--sys.stream.freshness_slo_ms")
        if self.flight_freshness_samples < 8:
            raise ValueError(
                f"--sys.flight.freshness_samples must be >= 8 "
                f"(got {self.flight_freshness_samples}): a smaller "
                f"probe table evicts nearly every probe at the bound — "
                f"a freshness gauge with no samples behind it")
        if self.stream_batch < 0:
            raise ValueError(
                f"--sys.stream.batch must be >= 0 "
                f"(got {self.stream_batch}; 0 = no stream trainer)")
        if self.stream_rate < 0:
            raise ValueError(
                f"--sys.stream.rate must be >= 0 "
                f"(got {self.stream_rate}; 0 = unthrottled)")
        if self.stream_rate > 0 and self.stream_batch < 1:
            raise ValueError(
                "--sys.stream.rate requires --sys.stream.batch >= 1: "
                "the rate throttles the trainer pump, which does not "
                "exist without a micro-batch size")
        if self.stream_freshness_slo_ms < 0:
            raise ValueError(
                f"--sys.stream.freshness_slo_ms must be >= 0 "
                f"(got {self.stream_freshness_slo_ms}; 0 = no "
                f"freshness controller)")
        if self.stream_freshness_slo_ms > 0 and not self.trace_flight:
            raise ValueError(
                "--sys.stream.freshness_slo_ms requires "
                "--sys.trace.flight: the freshness controller's sensor "
                "is the flight plane's push-to-servable probe "
                "(flight.freshness_s) and is blind without it")
        if self.stream_freshness_slo_ms > 0 and not self.metrics:
            raise ValueError(
                "--sys.stream.freshness_slo_ms requires --sys.metrics: "
                "the freshness controller reads the flight.freshness_s "
                "histogram through the registry")
        if self.net_backend not in ("auto", "dcn", "tcp", "loopback"):
            raise ValueError(
                f"--sys.net.backend must be one of auto/dcn/tcp/"
                f"loopback (got {self.net_backend!r})")
        if self.net_queue < 1:
            raise ValueError(
                f"--sys.net.queue must be >= 1 (got {self.net_queue}): "
                f"a zero-bound peer inbox delivers nothing")
        if self.net_timeout_ms <= 0:
            raise ValueError(
                f"--sys.net.timeout_ms must be > 0 "
                f"(got {self.net_timeout_ms})")
        if self.net_heartbeat_ms <= 0:
            raise ValueError(
                f"--sys.net.heartbeat_ms must be > 0 "
                f"(got {self.net_heartbeat_ms})")
        if self.tier_cold_dtype not in COLD_DTYPES:
            raise ValueError(
                f"--sys.tier.cold_dtype must be one of "
                f"{'/'.join(COLD_DTYPES)} (got "
                f"{self.tier_cold_dtype!r})")
        if self.sync_compress not in SYNC_COMPRESS_MODES:
            raise ValueError(
                f"--sys.sync.compress must be one of "
                f"{'/'.join(SYNC_COMPRESS_MODES)} (got "
                f"{self.sync_compress!r})")
        if self.sync_compress != "off" and not self.sync_dirty_only:
            raise ValueError(
                "--sys.sync.compress requires --sys.sync.dirty_only 1: "
                "compressed rounds mark shipped replicas clean with a "
                "sub-grid residual parked in the delta row — the "
                "full-resync path re-ships every replica every round, "
                "re-quantizing residuals that can never clear (bytes "
                "and convergence both regress); turn the dirty filter "
                "back on or turn compression off")
        if self.sync_compress == "int8" and not self.metrics:
            raise ValueError(
                "--sys.sync.compress int8 requires --sys.metrics: the "
                "int8 error-feedback loop is only auditable through "
                "the sync.ef_residual_norm gauge — running a lossy "
                "grid a quarter of fp32 wide with no metrics-visible "
                "residual is a silent-quality-loss trap")
        if self.tier and self.tier_hot_rows < 8:
            raise ValueError(
                f"--sys.tier.hot_rows must be >= 8 (got "
                f"{self.tier_hot_rows}): a hot pool smaller than one "
                f"padded bucket cannot serve any gather from device")
        if self.tier and self.tier_demote_batch < 1:
            raise ValueError(
                f"--sys.tier.demote_batch must be >= 1 "
                f"(got {self.tier_demote_batch})")
        if self.episode_batches < 1:
            raise ValueError(
                f"--sys.episode.batches must be >= 1 "
                f"(got {self.episode_batches}): an episode must hold "
                f"at least one step batch")
        if self.exec_workers < 1:
            raise ValueError(
                f"--sys.exec.workers must be >= 1 "
                f"(got {self.exec_workers}): the executor's streams "
                f"need at least one worker to make progress")
        if self.serve_dispatchers < 1:
            raise ValueError(
                f"--sys.serve.dispatchers must be >= 1 "
                f"(got {self.serve_dispatchers}): the serve plane needs "
                f"at least one dispatcher drain")
        if self.serve_replica_rows < 0:
            raise ValueError(
                f"--sys.serve.replica_rows must be >= 0 "
                f"(got {self.serve_replica_rows}; 0 = no read-only "
                f"serve replica)")
        if self.serve_replica_refresh_ms <= 0:
            raise ValueError(
                f"--sys.serve.replica_refresh_ms must be > 0 "
                f"(got {self.serve_replica_refresh_ms}): a zero "
                f"refresh throttle would let every snapshot miss queue "
                f"an immediate refresh program")
        if self.costs_table is not None and not self.costs_table:
            raise ValueError(
                "--sys.costs.table needs a non-empty path for the "
                "cost-table JSON (omit the flag to run without a "
                "measured table)")
        if self.costs_calibrate and not self.costs_table:
            raise ValueError(
                "--sys.costs.calibrate requires --sys.costs.table: a "
                "calibration pass measures kernel costs and must have "
                "somewhere to persist them")
        if self.trace_workload_keys < 1:
            raise ValueError(
                f"--sys.trace.workload_keys must be >= 1 "
                f"(got {self.trace_workload_keys}): a zero key budget "
                f"would record no keys at all — an unreplayable trace")
        if self.trace_workload is not None and not self.trace_workload:
            raise ValueError(
                "--sys.trace.workload needs a non-empty path for the "
                ".wtrace file (omit the flag to disable capture)")
        if self.trace_decisions is not None and not self.trace_decisions:
            raise ValueError(
                "--sys.trace.decisions needs a non-empty path for the "
                ".dtrace file (omit the flag to disable capture)")
        if self.trace_decisions_window < 1:
            raise ValueError(
                f"--sys.trace.decisions_window must be >= 1 "
                f"(got {self.trace_decisions_window}): a zero window "
                f"would close every outcome probe before any follow-up "
                f"could land — attribution without evidence")
        if self.trace_spans_max_events < 1000:
            raise ValueError(
                f"--sys.trace.spans.max_events must be >= 1000 "
                f"(got {self.trace_spans_max_events}): a smaller bound "
                f"would drop nearly every span — an unreadable trace "
                f"masquerading as a cheap one")
        _policy_planes = (("reloc", self.policy_reloc),
                          ("tier", self.policy_tier),
                          ("sync", self.policy_sync),
                          ("serve", self.policy_serve))
        for _plane, _mode in _policy_planes:
            if _mode not in ("heuristic", "learned"):
                raise ValueError(
                    f"--sys.policy.{_plane} must be heuristic or "
                    f"learned (got {_mode!r})")
        if self.policy_file is not None and not self.policy_file:
            raise ValueError(
                "--sys.policy.file needs a non-empty path for the "
                "policy artifact (omit the flag to run pure "
                "heuristics)")
        if not self.policy_file:
            _learned = [p for p, m in _policy_planes if m == "learned"]
            if _learned:
                raise ValueError(
                    f"--sys.policy.{_learned[0]} learned requires "
                    f"--sys.policy.file: a learned mode without a "
                    f"trained artifact has nothing to consult")
            if self.policy_shadow:
                raise ValueError(
                    "--sys.policy.shadow requires --sys.policy.file: "
                    "shadow mode scores the TRAINED policy against "
                    "the live heuristic and is meaningless without "
                    "an artifact")
        if self.fault_seed < 0:
            raise ValueError(
                f"--sys.fault.seed must be >= 0 (got {self.fault_seed})")
        if self.fault_retries < 0:
            raise ValueError(
                f"--sys.fault.retries must be >= 0 "
                f"(got {self.fault_retries}; 0 = no retries, failures "
                f"surface immediately)")
        if self.fault_backoff_ms < 0 or self.fault_backoff_max_ms < 0:
            raise ValueError(
                f"--sys.fault.backoff_ms bounds must be >= 0 (got "
                f"{self.fault_backoff_ms}/{self.fault_backoff_max_ms})")
        if self.fault_watchdog_s <= 0:
            raise ValueError(
                f"--sys.fault.watchdog_s must be > 0 "
                f"(got {self.fault_watchdog_s}): a zero watchdog would "
                f"flag every program wedged the instant it starts")
        if self.ckpt_every_s < 0:
            raise ValueError(
                f"--sys.checkpoint.every must be >= 0 "
                f"(got {self.ckpt_every_s}; 0 = no periodic "
                f"checkpointing)")
        if self.ckpt_every_s > 0 and not self.ckpt_path:
            raise ValueError(
                "--sys.checkpoint.every requires --sys.checkpoint.path: "
                "periodic incremental checkpoints need a chain "
                "directory to append to")
        if self.serve_queue < self.serve_max_batch:
            raise ValueError(
                f"inconsistent serve knobs: --sys.serve.queue "
                f"({self.serve_queue}) < --sys.serve.max_batch "
                f"({self.serve_max_batch}) — the admission queue could "
                f"never hold a full micro-batch, so the configured batch "
                f"size is unreachable; raise the queue bound or lower "
                f"max_batch")

    @staticmethod
    def add_arguments(parser: argparse.ArgumentParser) -> None:
        g = parser.add_argument_group("system")
        g.add_argument("--sys.techniques", dest="sys_techniques",
                       default="all",
                       choices=[t.value for t in MgmtTechniques])
        g.add_argument("--sys.channels", dest="sys_channels", type=int,
                       default=4)
        g.add_argument("--sys.location_caches", dest="sys_location_caches",
                       type=int, default=1)
        g.add_argument("--sys.time_intent_actions",
                       dest="sys_time_intent_actions",
                       type=int, default=1)
        g.add_argument("--sys.heartbeat", dest="sys_heartbeat",
                       type=float, default=0.0)
        g.add_argument("--sys.dcn_threads", dest="sys_dcn_threads",
                       type=int, default=8)
        g.add_argument("--sys.net.backend", dest="sys_net_backend",
                       type=str, default="auto")
        g.add_argument("--sys.net.queue", dest="sys_net_queue",
                       type=int, default=64)
        g.add_argument("--sys.net.timeout_ms", dest="sys_net_timeout_ms",
                       type=float, default=5000.0)
        g.add_argument("--sys.net.heartbeat_ms",
                       dest="sys_net_heartbeat_ms",
                       type=float, default=100.0)
        g.add_argument("--sys.sync.max_per_sec", dest="sys_sync_max_per_sec",
                       type=float, default=1000.0)
        g.add_argument("--sys.sync.pause", dest="sys_sync_pause", type=float,
                       default=0.0)
        g.add_argument("--sys.sync.threshold", dest="sys_sync_threshold",
                       type=float, default=0.0)
        g.add_argument("--sys.sync.dirty_only", dest="sys_sync_dirty_only",
                       type=int, default=1)
        g.add_argument("--sys.sync.compress", dest="sys_sync_compress",
                       default="off", choices=["off", "fp16", "int8"])
        g.add_argument("--sys.collective_sync", dest="sys_collective_sync",
                       type=int, default=0)
        g.add_argument("--sys.collective_bucket",
                       dest="sys_collective_bucket", type=int, default=1024)
        g.add_argument("--sys.collective_cadence",
                       dest="sys_collective_cadence", type=int, default=0)
        g.add_argument("--sys.main_over_alloc", dest="sys_main_over_alloc",
                       type=float, default=1.25)
        g.add_argument("--sys.optimistic_routing",
                       dest="sys_optimistic_routing", type=int, default=1)
        g.add_argument("--sys.prefetch", dest="sys_prefetch", type=int,
                       default=0)
        g.add_argument("--sys.prefetch.max_batches",
                       dest="sys_prefetch_max_batches", type=int, default=4)
        g.add_argument("--sys.prefetch.staging_rows",
                       dest="sys_prefetch_staging_rows", type=int,
                       default=65536)
        g.add_argument("--sys.prefetch.pull", dest="sys_prefetch_pull",
                       default="auto", choices=["auto", "always", "off"])
        g.add_argument("--sys.plan_cache", dest="sys_plan_cache", type=int,
                       default=64)
        g.add_argument("--sys.tier", dest="sys_tier", type=int, default=0)
        g.add_argument("--sys.tier.hot_rows", dest="sys_tier_hot_rows",
                       type=int, default=65536)
        g.add_argument("--sys.tier.cold_dtype",
                       dest="sys_tier_cold_dtype", default="fp32",
                       choices=["fp32", "fp16", "int8"])
        g.add_argument("--sys.tier.pin_intent",
                       dest="sys_tier_pin_intent", type=int, default=1)
        g.add_argument("--sys.tier.demote_batch",
                       dest="sys_tier_demote_batch", type=int,
                       default=1024)
        g.add_argument("--sys.exec.workers", dest="sys_exec_workers",
                       type=int, default=4)
        g.add_argument("--sys.exec.single_stream",
                       dest="sys_exec_single_stream", type=int,
                       default=0)
        g.add_argument("--sys.episode.batches",
                       dest="sys_episode_batches", type=int, default=8)
        g.add_argument("--sys.stats.out", dest="sys_stats_out", default=None)
        g.add_argument("--sys.trace.keys", dest="sys_trace_keys", default=None)
        g.add_argument("--sys.stats.locality", dest="sys_stats_locality",
                       action="store_true")
        g.add_argument("--sys.sync.report", dest="sys_sync_report",
                       type=float, default=10.0)
        g.add_argument("--sys.metrics", dest="sys_metrics", type=int,
                       default=1)
        g.add_argument("--sys.metrics.report", dest="sys_metrics_report",
                       type=float, default=0.0)
        g.add_argument("--sys.trace.spans", dest="sys_trace_spans",
                       type=int, default=0)
        g.add_argument("--sys.trace.spans_out",
                       dest="sys_trace_spans_out", default=None)
        g.add_argument("--sys.crash_dumps", dest="sys_crash_dumps",
                       type=int, default=0)
        g.add_argument("--sys.trace.flight", dest="sys_trace_flight",
                       type=int, default=0)
        g.add_argument("--sys.trace.flight_out",
                       dest="sys_trace_flight_out", default=None)
        g.add_argument("--sys.flight.freshness_samples",
                       dest="sys_flight_freshness_samples", type=int,
                       default=1024)
        g.add_argument("--sys.trace.workload",
                       dest="sys_trace_workload", default=None)
        g.add_argument("--sys.trace.workload_keys",
                       dest="sys_trace_workload_keys", type=int,
                       default=4096)
        g.add_argument("--sys.trace.decisions",
                       dest="sys_trace_decisions", default=None)
        g.add_argument("--sys.trace.decisions_window",
                       dest="sys_trace_decisions_window", type=int,
                       default=8)
        g.add_argument("--sys.trace.spans.max_events",
                       dest="sys_trace_spans_max_events", type=int,
                       default=1_000_000)
        g.add_argument("--sys.serve.max_batch", dest="sys_serve_max_batch",
                       type=int, default=64)
        g.add_argument("--sys.serve.max_wait_us",
                       dest="sys_serve_max_wait_us", type=int, default=200)
        g.add_argument("--sys.serve.queue", dest="sys_serve_queue",
                       type=int, default=1024)
        g.add_argument("--sys.serve.deadline_ms",
                       dest="sys_serve_deadline_ms", type=float,
                       default=0.0)
        g.add_argument("--sys.serve.slo_ms", dest="sys_serve_slo_ms",
                       type=_slo_spec, default="0")
        g.add_argument("--sys.serve.dispatchers",
                       dest="sys_serve_dispatchers", type=int, default=1)
        g.add_argument("--sys.serve.replica_rows",
                       dest="sys_serve_replica_rows", type=int, default=0)
        g.add_argument("--sys.serve.replica_refresh_ms",
                       dest="sys_serve_replica_refresh_ms", type=float,
                       default=50.0)
        g.add_argument("--sys.serve.bags", dest="sys_serve_bags",
                       type=int, default=1)
        g.add_argument("--sys.stream.batch", dest="sys_stream_batch",
                       type=int, default=0)
        g.add_argument("--sys.stream.rate", dest="sys_stream_rate",
                       type=float, default=0.0)
        g.add_argument("--sys.stream.freshness_slo_ms",
                       dest="sys_stream_freshness_slo_ms",
                       type=_slo_spec, default="0")
        g.add_argument("--sys.costs.table", dest="sys_costs_table",
                       default=None)
        g.add_argument("--sys.costs.calibrate",
                       dest="sys_costs_calibrate", type=int, default=0)
        g.add_argument("--sys.fault.spec", dest="sys_fault_spec",
                       default="")
        g.add_argument("--sys.fault.seed", dest="sys_fault_seed",
                       type=int, default=0)
        g.add_argument("--sys.fault.retries", dest="sys_fault_retries",
                       type=int, default=3)
        g.add_argument("--sys.fault.backoff_ms",
                       dest="sys_fault_backoff_ms", type=float,
                       default=10.0)
        g.add_argument("--sys.fault.backoff_max_ms",
                       dest="sys_fault_backoff_max_ms", type=float,
                       default=2000.0)
        g.add_argument("--sys.fault.watchdog_s",
                       dest="sys_fault_watchdog_s", type=float,
                       default=30.0)
        g.add_argument("--sys.checkpoint.every",
                       dest="sys_ckpt_every", type=float, default=0.0)
        g.add_argument("--sys.checkpoint.path",
                       dest="sys_ckpt_path", default=None)
        g.add_argument("--sys.policy.reloc", dest="sys_policy_reloc",
                       default="heuristic",
                       choices=["heuristic", "learned"])
        g.add_argument("--sys.policy.tier", dest="sys_policy_tier",
                       default="heuristic",
                       choices=["heuristic", "learned"])
        g.add_argument("--sys.policy.sync", dest="sys_policy_sync",
                       default="heuristic",
                       choices=["heuristic", "learned"])
        g.add_argument("--sys.policy.serve", dest="sys_policy_serve",
                       default="heuristic",
                       choices=["heuristic", "learned"])
        g.add_argument("--sys.policy.file", dest="sys_policy_file",
                       default=None)
        g.add_argument("--sys.policy.shadow",
                       dest="sys_policy_shadow", type=int, default=0)
        g.add_argument("--sys.lint.lockorder",
                       dest="sys_lint_lockorder", type=int, default=0)
        s = parser.add_argument_group("sampling")
        s.add_argument("--sampling.scheme", dest="sampling_scheme",
                       default="local",
                       choices=["naive", "preloc", "pool", "local"])
        s.add_argument("--sampling.reuse", dest="sampling_reuse", type=int,
                       default=32)
        s.add_argument("--sampling.pool_size", dest="sampling_pool_size",
                       type=int,
                       default=0)
        s.add_argument("--sampling.batch_size", dest="sampling_batch_size",
                       type=int, default=1024)
        s.add_argument("--sampling.without_replacement",
                       dest="sampling_without_replacement",
                       action="store_true")

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "SystemOptions":
        serve_slo_ms, serve_slo_class = \
            _split_slo_spec(args.sys_serve_slo_ms)
        stream_slo_ms, stream_slo_class = \
            _split_slo_spec(args.sys_stream_freshness_slo_ms)
        opts = cls(
            techniques=MgmtTechniques(args.sys_techniques),
            channels=args.sys_channels,
            location_caches=bool(args.sys_location_caches),
            time_intent_actions=bool(args.sys_time_intent_actions),
            heartbeat_s=args.sys_heartbeat,
            dcn_threads=args.sys_dcn_threads,
            net_backend=args.sys_net_backend,
            net_queue=args.sys_net_queue,
            net_timeout_ms=args.sys_net_timeout_ms,
            net_heartbeat_ms=args.sys_net_heartbeat_ms,
            sync_max_per_sec=args.sys_sync_max_per_sec,
            sync_pause_ms=args.sys_sync_pause,
            sync_threshold=args.sys_sync_threshold,
            sync_dirty_only=bool(args.sys_sync_dirty_only),
            sync_compress=args.sys_sync_compress,
            collective_sync=bool(args.sys_collective_sync),
            collective_bucket=args.sys_collective_bucket,
            collective_cadence=args.sys_collective_cadence,
            main_over_alloc=args.sys_main_over_alloc,
            optimistic_routing=bool(args.sys_optimistic_routing),
            prefetch=bool(args.sys_prefetch),
            prefetch_max_batches=args.sys_prefetch_max_batches,
            prefetch_staging_rows=args.sys_prefetch_staging_rows,
            prefetch_pull=args.sys_prefetch_pull,
            plan_cache_entries=args.sys_plan_cache,
            tier=bool(args.sys_tier),
            tier_hot_rows=args.sys_tier_hot_rows,
            tier_cold_dtype=args.sys_tier_cold_dtype,
            tier_pin_intent=bool(args.sys_tier_pin_intent),
            tier_demote_batch=args.sys_tier_demote_batch,
            exec_workers=args.sys_exec_workers,
            exec_single_stream=bool(args.sys_exec_single_stream),
            episode_batches=args.sys_episode_batches,
            stats_out=args.sys_stats_out,
            trace_keys=args.sys_trace_keys,
            locality_stats=args.sys_stats_locality,
            sync_report_s=args.sys_sync_report,
            metrics=bool(args.sys_metrics),
            metrics_report_s=args.sys_metrics_report,
            trace_spans=bool(args.sys_trace_spans),
            trace_spans_out=args.sys_trace_spans_out,
            crash_dumps=bool(args.sys_crash_dumps),
            trace_flight=bool(args.sys_trace_flight),
            trace_flight_out=args.sys_trace_flight_out,
            trace_workload=args.sys_trace_workload,
            trace_workload_keys=args.sys_trace_workload_keys,
            trace_decisions=args.sys_trace_decisions,
            trace_decisions_window=args.sys_trace_decisions_window,
            trace_spans_max_events=args.sys_trace_spans_max_events,
            serve_max_batch=args.sys_serve_max_batch,
            serve_max_wait_us=args.sys_serve_max_wait_us,
            serve_queue=args.sys_serve_queue,
            serve_deadline_ms=args.sys_serve_deadline_ms,
            serve_slo_ms=serve_slo_ms,
            serve_slo_class=serve_slo_class,
            serve_dispatchers=args.sys_serve_dispatchers,
            serve_replica_rows=args.sys_serve_replica_rows,
            serve_replica_refresh_ms=args.sys_serve_replica_refresh_ms,
            serve_bags=bool(args.sys_serve_bags),
            stream_batch=args.sys_stream_batch,
            stream_rate=args.sys_stream_rate,
            stream_freshness_slo_ms=stream_slo_ms,
            stream_freshness_slo_class=stream_slo_class,
            flight_freshness_samples=args.sys_flight_freshness_samples,
            costs_table=args.sys_costs_table,
            costs_calibrate=bool(args.sys_costs_calibrate),
            fault_spec=args.sys_fault_spec,
            fault_seed=args.sys_fault_seed,
            fault_retries=args.sys_fault_retries,
            fault_backoff_ms=args.sys_fault_backoff_ms,
            fault_backoff_max_ms=args.sys_fault_backoff_max_ms,
            fault_watchdog_s=args.sys_fault_watchdog_s,
            ckpt_every_s=args.sys_ckpt_every,
            ckpt_path=args.sys_ckpt_path,
            policy_reloc=args.sys_policy_reloc,
            policy_tier=args.sys_policy_tier,
            policy_sync=args.sys_policy_sync,
            policy_serve=args.sys_policy_serve,
            policy_file=args.sys_policy_file,
            policy_shadow=bool(args.sys_policy_shadow),
            lint_lockorder=bool(args.sys_lint_lockorder),
            sampling_scheme=args.sampling_scheme,
            sampling_reuse_factor=args.sampling_reuse,
            sampling_pool_size=args.sampling_pool_size,
            sampling_batch_size=args.sampling_batch_size,
            sampling_with_replacement=not args.sampling_without_replacement,
        )
        opts.validate_serve()  # parse-time rejection of bad serve knobs
        return opts
