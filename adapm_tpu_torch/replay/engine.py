"""The deterministic replay engine (the JAX package's
`replay/engine.py`, on the port's data plane).

`ReplayEngine` re-drives a captured `.wtrace` op stream against a fresh
in-process server under candidate knob overrides and scores the run
from `metrics_snapshot()`. The server is built from the trace's
recorded geometry and knobs, with the determinism pins applied on top,
on the card unless the caller passes `device="cpu"`. One thread
replays the recorded event order. The contract:

  **same trace + same seed + same knobs => bit-identical replayed
  reads** (the sha256 `reads_digest` folded over every pull, serve
  lookup and sample result).

It holds because every plane keeps its reads bit-identical to a plain
pull at the same dispatch point (tier churn with fp32 cold rows, sync
rounds, relocations, serve coalescing), and the engine fixes the
dispatch order: it

  - drives every op from one thread in recorded `seq` order;
  - disables the timer-driven planes (`sync_max_per_sec=0`, prefetch
    off) and re-drives sync rounds and quiesces where the trace
    recorded them;
  - strips serve deadlines (a shed is a wall-clock race) unless
    `keep_deadlines=True`;
  - synthesizes push and set values, and rebuilds key-sampled batches,
    from numpy generators seeded with (`seed`, event seq) — the same
    draws as the JAX engine's, so a trace replays to the same digest in
    both packages.

Background programs (tier maintenance, SLO ticks) still run: they move
rows and windows, never read values. Recorded monotonic gaps are slept
at `gap / speed` (capped per gap); `speed=100` is as fast as possible.

`rank_candidates` sweeps overrides over one trace and writes the ranked
comparison artifact.
"""
from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional

import numpy as np

from ..obs.wtrace import WorkloadTrace, event_keys, load_wtrace

# per-gap sleep cap: long idle gaps replay in bounded time even at 1x
_MAX_GAP_SLEEP_S = 0.05

# objective name -> direction for rank_candidates (every numeric key
# extract_scores produces ranks; keep the two in sync)
OBJECTIVES = {
    "hot_hit_rate": "max",
    "replica_hit_rate": "max",
    "plan_cache_hit_rate": "max",
    "serve_p50_ms": "min",
    "serve_p99_ms": "min",
    "cold_serve_p99_ms": "min",
    "bytes_per_round": "min",
    "bytes_shipped": "min",
    "dispatch_wait_p99_ms": "min",
    "shed_total": "min",
    "wall_s": "min",
    # decision-regret rates: need score_decisions=True
    "regret_rate_reloc": "min",
    "regret_rate_tier": "min",
    "regret_rate_sync": "min",
    "regret_rate_serve": "min",
}

# determinism pins a candidate may NOT override
_PINNED_KNOBS = ("serve_deadline_ms", "sync_max_per_sec", "prefetch")

# observed decisions: the candidate policy under test re-decides these
_DECISION_KINDS = frozenset({"reloc", "promote"})


def _build_opts(trace: WorkloadTrace, overrides: Optional[Dict]):
    """SystemOptions for one replay run: the RECORDED knobs, the
    determinism and hygiene pins, then the candidate's overrides
    (SystemOptions field names; unknown or pinned names fail loudly)."""
    from ..base import MgmtTechniques
    from ..config import SystemOptions
    opts = SystemOptions()
    for k, v in dict(trace.meta.get("knobs", {})).items():
        if not hasattr(opts, k):
            continue  # knob of a newer or older recorder: skip
        if k == "techniques":
            v = MgmtTechniques(v)  # serialized as the enum value
        setattr(opts, k, v)
    # determinism pins: the trace drives rounds
    opts.sync_max_per_sec = 0
    opts.prefetch = False
    opts.serve_deadline_ms = 0.0
    # scoring reads the registry; a replay never captures itself
    opts.metrics = True
    opts.trace_workload = None
    opts.trace_decisions = None
    # outputs and timers belong to the system that recorded the trace
    opts.stats_out = None
    opts.trace_spans = False
    opts.trace_spans_out = None
    opts.trace_flight = False
    opts.trace_flight_out = None
    opts.metrics_report_s = 0.0
    opts.ckpt_every_s = 0.0
    opts.ckpt_path = None
    opts.heartbeat_s = 0.0
    # every push a streaming ingest issued is already in the op stream
    opts.stream_batch = 0
    opts.stream_rate = 0.0
    opts.stream_freshness_slo_ms = 0.0
    opts.stream_freshness_slo_class = ""
    num_shards = int(trace.meta.get("num_shards", 0)) or None
    for k, v in dict(overrides or {}).items():
        if k == "num_shards":  # engine-level: the capacity-sim knob
            num_shards = int(v)
            continue
        if not hasattr(opts, k):
            raise ValueError(
                f"unknown replay knob override {k!r} (use "
                f"SystemOptions field names, e.g. tier_hot_rows, "
                f"serve_dispatchers, sync_compress, serve_slo_ms, "
                f"episode_batches)")
        if k in _PINNED_KNOBS:
            raise ValueError(
                f"replay determinism pin {k!r} cannot be overridden "
                f"by a candidate: deadlines/timer loops are wall-clock "
                f"races, not replayable behavior (use "
                f"keep_deadlines=True on the engine to study sheds)")
        setattr(opts, k, v)
    if not opts.metrics:
        raise ValueError("replay scoring requires metrics; do not "
                         "override metrics=False")
    if opts.trace_workload:
        raise ValueError("replay must not capture itself; do not "
                         "override trace_workload")
    if opts.trace_decisions:
        raise ValueError("replay must not capture itself; do not "
                         "override trace_decisions (export the "
                         "labeled dataset from the CAPTURED run's "
                         ".dtrace via replay/dataset.py)")
    opts.validate_serve()
    return opts, num_shards


class ReplayEngine:
    """One replay run of one trace under one knob configuration.

    Construction loads and verifies the trace (`WorkloadTraceError`
    before any server exists); `run()` builds the fresh server on
    `device` (default: the card), re-drives the stream, scores it, and
    shuts the server down."""

    def __init__(self, trace, overrides: Optional[Dict] = None,
                 seed: int = 0, speed: float = 100.0,
                 keep_deadlines: bool = False,
                 score_decisions: bool = False, device=None):
        if not isinstance(trace, WorkloadTrace):
            trace = load_wtrace(trace)  # raises WorkloadTraceError
        if speed <= 0:
            raise ValueError(f"replay speed must be > 0 (got {speed}); "
                             f"1 = recorded pacing, 100 = as fast as "
                             f"possible")
        self.trace = trace
        self.overrides = dict(overrides or {})
        self.seed = int(seed)
        self.speed = float(speed)
        self.keep_deadlines = bool(keep_deadlines)
        # attach a metrics-only DecisionRecorder (path=None) so the
        # decision.regret_rate.<plane> gauges score the re-decided run
        self.score_decisions = bool(score_decisions)
        self.device = device

    # -- deterministic reconstruction ---------------------------------------

    def _rng(self, ev_seq: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, int(ev_seq)])

    def _keys(self, ev: Dict) -> np.ndarray:
        return event_keys(ev, rng=self._rng(ev["seq"]))

    def _vals(self, srv, ev: Dict, keys: np.ndarray) -> np.ndarray:
        total = int(srv.value_lengths[keys].sum())
        return self._rng(ev["seq"]).normal(
            size=total).astype(np.float32)

    # -- the run -------------------------------------------------------------

    def run(self, include_snapshot: bool = False) -> Dict:
        import adapm_tpu_torch

        trace = self.trace
        opts, num_shards = _build_opts(trace, self.overrides)
        nw = trace.max_worker_id() + 1
        srv = adapm_tpu_torch.setup(int(trace.meta["num_keys"]),
                                    trace.value_lengths, opts=opts,
                                    num_shards=num_shards,
                                    num_workers=nw, device=self.device)
        if self.score_decisions:
            # metrics-only mode: windows resolve and the regret gauges
            # fold into snap["decision"]; nothing is written
            from ..obs.decisions import DecisionRecorder
            srv.decisions = DecisionRecorder(srv, None)
        digest = hashlib.sha256()
        workers: Dict[int, object] = {}
        sessions: Dict = {}
        handles: Dict[int, int] = {}  # recorded handle -> live handle
        plane = None
        replayed = 0
        reads = 0
        skipped: Dict[str, int] = {}
        prev_mono: Optional[float] = None
        t0 = time.perf_counter()

        def worker(wid: int):
            w = workers.get(wid)
            if w is None:
                w = workers[wid] = srv.make_worker(wid)
            return w

        def fold(arr) -> None:
            nonlocal reads
            reads += 1
            digest.update(np.ascontiguousarray(
                arr, dtype=arr.dtype).tobytes())

        def get_session(tenant: Optional[str], priority: int):
            nonlocal plane
            if plane is None:
                from ..serve import ServePlane
                plane = ServePlane(srv)
            skey = (tenant, priority)
            sess = sessions.get(skey)
            if sess is None:
                if tenant is not None:
                    plane.configure_tenant(tenant, priority=priority)
                sess = sessions[skey] = plane.session(
                    tenant=tenant, priority=priority)
            return sess

        if any(ev["kind"] == "prep_sample" for ev in trace.events):
            nk = int(trace.meta["num_keys"])
            srv.enable_sampling_support(
                lambda n, rng: rng.integers(0, nk, n), 0, nk)

        try:
            for ev in trace.events:
                mono = ev.get("mono")
                if prev_mono is not None and mono is not None:
                    gap = (mono - prev_mono) / self.speed
                    if gap > 1e-4:
                        time.sleep(min(gap, _MAX_GAP_SLEEP_S))
                prev_mono = mono
                kind = ev["kind"]
                if kind in _DECISION_KINDS:
                    skipped[kind] = skipped.get(kind, 0) + 1
                    continue
                replayed += 1
                if kind == "pull":
                    fold(worker(ev["wid"]).pull_sync(self._keys(ev)))
                elif kind in ("push", "set"):
                    w = worker(ev["wid"])
                    keys = self._keys(ev)
                    op = w.push if kind == "push" else w.set
                    w.wait(op(keys, self._vals(srv, ev, keys)))
                elif kind == "intent":
                    worker(ev["wid"]).intent(self._keys(ev),
                                             ev["start"], ev["end"])
                elif kind == "clock":
                    worker(ev["wid"]).advance_clock()
                elif kind == "serve":
                    sess = get_session(ev.get("tenant"),
                                       int(ev.get("priority", 0)))
                    dl = ev.get("deadline_ms") or None
                    fold(sess.lookup(
                        self._keys(ev),
                        deadline_ms=dl if self.keep_deadlines
                        else None))
                elif kind == "prep_sample":
                    handles[ev["handle"]] = worker(
                        ev["wid"]).prepare_sample(
                        ev["n"], ev.get("start"), ev.get("end"))
                elif kind == "pull_sample":
                    h = handles.get(ev["handle"])
                    if h is None:
                        skipped[kind] = skipped.get(kind, 0) + 1
                        replayed -= 1
                        continue
                    ks, vals = worker(ev["wid"]).pull_sample(
                        h, ev.get("n"))
                    fold(np.asarray(ks, dtype=np.int64))
                    fold(np.asarray(vals, dtype=np.float32))
                elif kind == "finish_sample":
                    h = handles.pop(ev["handle"], None)
                    if h is not None:
                        worker(ev["wid"]).finish_sample(h)
                elif kind == "sync":
                    with srv._round_lock:
                        srv.sync.run_round(
                            force_intents=bool(ev.get("forced")),
                            all_channels=bool(ev.get("all")))
                elif kind == "quiesce":
                    srv.quiesce()
                else:  # unknown kind from a newer recorder: loud skip
                    skipped[kind] = skipped.get(kind, 0) + 1
                    replayed -= 1
            srv.quiesce()
            wall_s = time.perf_counter() - t0
            reads_digest = digest.hexdigest()
            srv.replay_stats = {
                "trace": trace.path,
                "events_replayed": replayed,
                "events_skipped_total": int(sum(skipped.values())),
                "reads": reads,
                "reads_digest": reads_digest,
                "seed": self.seed,
                "speed": self.speed,
            }
            snap = srv.metrics_snapshot()
        finally:
            if plane is not None:
                plane.close()
            srv.shutdown()
        out = {"overrides": dict(self.overrides), "seed": self.seed,
               "speed": self.speed,
               "events_total": len(trace.events),
               "events_replayed": replayed,
               "events_skipped": skipped,
               "reads": reads, "reads_digest": reads_digest,
               "wall_s": round(wall_s, 4),
               "score": extract_scores(snap, wall_s)}
        if include_snapshot:
            out["snapshot"] = snap
        return out


def replay_trace(trace, overrides: Optional[Dict] = None, seed: int = 0,
                 speed: float = 100.0, **kw) -> Dict:
    """One-shot: load (or take) a trace, replay under `overrides`
    (`device=` and the engine's other options pass through), return the
    scored result."""
    return ReplayEngine(trace, overrides=overrides, seed=seed,
                        speed=speed, **kw).run()


def per_shard_hot_rows(num_keys: int, fraction: float,
                       num_shards: Optional[int] = None) -> int:
    """`--sys.tier.hot_rows` for "this fraction of the table hot": the
    knob is per shard, so the whole-table fraction divides by the shard
    count (`num_shards`, default the port's default context's count).
    Floors at the smallest pool the store accepts."""
    if num_shards is None:
        from ..device.context import make_context
        num_shards = make_context().num_shards
    s = max(1, int(num_shards))
    want = int(num_keys * float(fraction))
    return max(8, -(-want // s))


def extract_scores(snap: Dict, wall_s: float) -> Dict:
    """The policy-scoring surface of one metrics snapshot: hit rates,
    wire bytes per round, executor dispatch wait, serve tails, sheds.
    Keys double as `rank_candidates` objective names; absent subsystems
    score None."""
    from ..obs.metrics import hist_percentile

    def _pct(section: Dict, name: str, q: float):
        h = section.get(name)
        if isinstance(h, dict) and h.get("count"):
            return round(hist_percentile(h, q) * 1e3, 4)
        return None

    serve = snap.get("serve", {})
    tier = snap.get("tier", {})
    sync = snap.get("sync", {})
    ex = snap.get("exec", {})
    pc = snap.get("plan_cache", {})
    dec = snap.get("decision", {})
    hits = float(pc.get("hits", 0))
    misses = float(pc.get("misses", 0))
    shed = (serve.get("shed_total", 0) or 0) + \
        (serve.get("rejected_total", 0) or 0) + \
        (serve.get("degraded_shed_total", 0) or 0)
    return {
        "wall_s": round(wall_s, 4),
        "serve_p50_ms": _pct(serve, "latency_s", 0.50),
        "serve_p99_ms": _pct(serve, "latency_s", 0.99),
        "shed_total": int(shed),
        "replica_hit_rate": serve.get("replica_hit_rate"),
        "hot_hit_rate": tier.get("hot_hit_rate"),
        "cold_serve_p99_ms": _pct(tier, "cold_serve_s", 0.99),
        "bytes_per_round": sync.get("bytes_per_round"),
        "bytes_shipped": sync.get("bytes_shipped"),
        "dispatch_wait_p99_ms": _pct(ex, "dispatch_wait_s", 0.99),
        "plan_cache_hit_rate": round(hits / (hits + misses), 4)
        if (hits + misses) else None,
        # present only with score_decisions=True; None ranks last
        "regret_rate_reloc": dec.get("regret_rate.reloc"),
        "regret_rate_tier": dec.get("regret_rate.tier"),
        "regret_rate_sync": dec.get("regret_rate.sync"),
        "regret_rate_serve": dec.get("regret_rate.serve"),
    }


def _auto_objective(results: Dict[str, Dict]) -> str:
    """The headline objective from what the runs scored: tiered runs
    rank by hot-hit rate, serving runs by P99, else wall time."""
    scores = [r["score"] for r in results.values()]
    if any(s.get("hot_hit_rate") is not None for s in scores):
        return "hot_hit_rate"
    if any(s.get("serve_p99_ms") is not None for s in scores):
        return "serve_p99_ms"
    return "wall_s"


def rank_candidates(trace, candidates: Dict[str, Optional[Dict]],
                    objective: str = "auto", seed: int = 0,
                    speed: float = 100.0,
                    out_path: Optional[str] = None,
                    score_decisions: bool = False,
                    device=None) -> Dict:
    """Replay one trace under each candidate's overrides (on `device`,
    default the card) and return the ranked comparison artifact (best
    first; name tie-break; runs missing the objective rank last).
    `candidates` maps a name to an overrides dict (None = recorded
    knobs). With `out_path` the artifact is also written (atomic)."""
    if not candidates:
        raise ValueError("rank_candidates needs at least one candidate")
    trace_obj = trace if isinstance(trace, WorkloadTrace) \
        else load_wtrace(trace)
    results: Dict[str, Dict] = {}
    for name in sorted(candidates):
        results[name] = ReplayEngine(
            trace_obj, overrides=candidates[name], seed=seed,
            speed=speed, score_decisions=score_decisions,
            device=device).run()
    if objective == "auto":
        objective = _auto_objective(results)
    direction = OBJECTIVES.get(objective)
    if direction is None:
        raise ValueError(
            f"unknown objective {objective!r}; one of "
            f"{sorted(OBJECTIVES)} (or 'auto')")

    def sort_key(name: str):
        v = results[name]["score"].get(objective)
        missing = v is None
        if missing:
            v = 0.0
        return (missing, -v if direction == "max" else v, name)

    ranking: List[str] = sorted(results, key=sort_key)
    artifact = {
        "format": "adapm-replay-compare",
        "version": 1,
        "trace": trace_obj.path,
        "trace_events": len(trace_obj.events),
        "trace_kinds": trace_obj.kinds(),
        "seed": int(seed),
        "speed": float(speed),
        "objective": objective,
        "direction": direction,
        "candidates": {n: {"overrides": dict(candidates[n] or {}),
                           **{k: v for k, v in results[n].items()
                              if k != "overrides"}}
                       for n in sorted(results)},
        "ranking": ranking,
        "winner": ranking[0],
    }
    if out_path:
        import json

        from ..utils import write_atomic
        write_atomic(out_path,
                     json.dumps(artifact, indent=1,
                                default=float).encode())
    return artifact
