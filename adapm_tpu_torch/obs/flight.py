"""Request-flight tracing: causal traces across admission -> batch ->
executor -> device, plus the freshness probe and the executor
flight-recorder ring. The port of the JAX package's `obs/flight.py`,
with its Chrome-JSON export.

Three pieces, each independently cheap:

  - **FlightTracer** (`--sys.trace.flight`, default **off**): a
    per-request trace id minted at `ServeSession.lookup` (and at
    `Worker.pull|push|set`, which are single-segment flights), carried
    on the `AdmissionQueue` entry, recorded when the batcher coalesces
    requests into a fused gather, and stamped onto the dispatched
    program. Exported as Chrome trace-event JSON with Perfetto **flow
    events** (`ph: s/t/f`, bound by id), so ONE served lookup renders
    as a single connected chain: client wait -> queue -> batch window
    -> dispatch -> device gather -> reply. Per-request breakdown
    histograms (`flight.queue_s` / `batch_wait_s` / `dispatch_s` /
    `device_s`) say where each millisecond went. When off the Server
    holds no tracer, every instrumented site pays one `is None` check,
    and the registry holds zero `flight.*` names.

    On the card a launch returns before the work is done, so the
    device slice (`t_enqueued` -> `t_done`) must END at an event that
    synchronizes with the card: the batcher stamps `t_done` after the
    union's host readback (`.cpu()` of the gathered rows), never at the
    launch's return — otherwise `device_s` would read ~0 and the work
    would show up under the reply.

  - **FreshnessProbe** (rides the tracer): event-to-servable staleness
    — the wall time from a `Worker.push` of a key to the FIRST serve
    lookup that reads it, sampled (every Nth push records one key into
    a bounded probe table; the batcher checks the union key set against
    it). `flight.freshness_s` is the histogram.

  - **FlightRecorder** (rides `--sys.crash_dumps`, default **on**): a
    bounded per-stream ring of the last executor programs (stream,
    label, coalesce key, queue-wait and run times). Each record also
    overwrites one fixed-width slot of a ring FILE via `pwrite`, so
    after a hard abort the file is a post-mortem of what was in flight.
    It records per executor PROGRAM (drains, sync rounds, tier passes),
    never per Pull/Push op.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# the causal phases of one served lookup, in flow order; the exporter
# emits one Perfetto flow chain (s -> t -> t -> t -> f) per trace id
# that completed all five
FLIGHT_PHASES = ("flight.lookup", "flight.queue", "flight.batch",
                 "flight.program", "flight.reply")
_PHASE_IDX = {n: i for i, n in enumerate(FLIGHT_PHASES)}

# virtual Perfetto tracks for phases that happen on no one thread
# (queue residence) or across threads (the coalescing window)
_VIRTUAL_TRACKS = ("serve.queue", "serve.batch-window")


class FlightTrace:
    """One request's causal context: the minted id plus the phase
    timestamps stamped along the way (perf_counter values; 0.0 = the
    phase never happened, e.g. a shed request has no claim)."""

    __slots__ = ("id", "t_mint", "t_claim", "t_dispatch", "t_enqueued",
                 "t_done", "t_deliver")

    def __init__(self, trace_id: int, t_mint: float):
        self.id = trace_id
        self.t_mint = t_mint
        self.t_claim = 0.0      # AdmissionQueue try_claim (dispatcher side)
        self.t_dispatch = 0.0   # batcher starts the coalesced lookup
        self.t_enqueued = 0.0   # device gather programs enqueued
        self.t_done = 0.0       # union values read back to the host (on
        # the card: after the synchronizing copy, not at the launch)
        self.t_deliver = 0.0    # result handed to the waiting client

    def breakdown_s(self) -> Dict[str, float]:
        """queue / batch_wait / dispatch / device split in seconds
        (only meaningful for a completed trace)."""
        return {"queue_s": max(0.0, self.t_claim - self.t_mint),
                "batch_wait_s": max(0.0, self.t_dispatch - self.t_claim),
                "dispatch_s": max(0.0, self.t_enqueued - self.t_dispatch),
                "device_s": max(0.0, self.t_done - self.t_enqueued)}


class FreshnessProbe:
    """Event-to-servable staleness, sampled (see module docstring).

    `note_push` is called per Worker.push ONLY when flight tracing is
    on (the caller holds the `server.flight is not None` gate); every
    `sample_every`-th push stamps its first key + the event clock into
    a bounded table and returns a token; the pusher calls
    `push_visible(token)` once the scatter is ENQUEUED (under the
    server lock — enqueue order is this codebase's read-visibility
    order). `note_read` (the serve batcher, per coalesced union,
    passing the gather's own under-lock enqueue stamp) resolves a
    probed key only when the gather was enqueued AFTER the push became
    visible — a batch already in flight when the push landed returns
    the OLD value and must not retire the probe — then observes
    read-materialize minus push-EVENT time and retires the entry:
    FIRST servable read, measured once per probe entry."""

    def __init__(self, registry=None, sample_every: int = 8,
                 bound: int = 256):
        from .metrics import Counter, Histogram
        self._sample = max(1, int(sample_every))
        self._bound = int(bound)
        self._lock = threading.Lock()
        # key -> [t_event, t_visible|None] (t_visible None until the
        # scatter is enqueued; unresolvable probes never observe)
        self._pending: Dict[int, List[Optional[float]]] = {}
        self._n_pushes = 0
        self.evicted = 0    # probes displaced by newer ones at bound
        use_reg = registry is not None and registry.enabled
        if use_reg:
            self.h_freshness = registry.histogram("flight.freshness_s")
            self.c_samples = registry.counter("flight.freshness_samples")
        else:  # flight tracing works with --sys.metrics 0 (standalone)
            self.h_freshness = Histogram("flight.freshness_s")
            self.c_samples = Counter("flight.freshness_samples")

    def note_push(self, keys) -> Optional[int]:
        with self._lock:
            self._n_pushes += 1
            if self._n_pushes % self._sample or len(keys) == 0:
                return None
            k = int(keys[0])
            if k in self._pending:
                return None
            if len(self._pending) >= self._bound:
                # evict the oldest unresolved probe (insertion order)
                # so never-served keys can't permanently silence the
                # gauge once they fill the table
                self._pending.pop(next(iter(self._pending)))
                self.evicted += 1
            self._pending[k] = [time.perf_counter(), None]
            return k

    def push_visible(self, token: Optional[int]) -> None:
        """Stamp the probed push as enqueued. Call with the server lock
        held, right after the scatter enqueue, so the stamp totally
        orders against gather enqueue stamps taken under the same
        lock."""
        if token is None:
            return
        with self._lock:
            ent = self._pending.get(token)
            if ent is not None and ent[1] is None:
                ent[1] = time.perf_counter()

    def note_read(self, keys, t_enqueued: Optional[float] = None) -> None:
        if not self._pending:   # lock-free fast path: nothing probed
            return
        import numpy as np
        now = time.perf_counter()
        cutoff = now if t_enqueued is None else t_enqueued
        with self._lock:
            if not self._pending:
                return
            probed = np.fromiter(self._pending, dtype=np.int64,
                                 count=len(self._pending))
            hits = probed[np.isin(probed, keys)]
            for k in hits:
                ent = self._pending.get(int(k))
                if ent is None or ent[1] is None or ent[1] > cutoff:
                    continue  # gather predates the push: old data
                del self._pending[int(k)]
                self.h_freshness.observe(now - ent[0])
                self.c_samples.inc()


class FlightTracer:
    """Records flight slices + phase timestamps; exports Perfetto flow
    chains. Appends are GIL-atomic list appends (client threads, the
    serve drain on the executor pool, and worker threads all record
    concurrently); memory is bounded at `max_slices`, beyond which new
    slices are counted as dropped."""

    def __init__(self, registry=None, rank: int = 0,
                 max_slices: int = 200_000,
                 freshness_bound: int = 1024):
        from .metrics import (Counter, Histogram,
                              SERVE_LATENCY_BOUNDS_S)
        self.rank = rank
        self.max_slices = max_slices
        self.dropped = 0
        self._t0 = time.perf_counter()
        self._next_id = itertools.count(1)
        # guards the plain-int tallies below: += from concurrent client
        # threads is a load/add/store that loses increments (the
        # GIL-atomic-append claim covers _slices only). Trace counts
        # are derived from the sharded registry counter instead.
        self._stats_lock = threading.Lock()
        self._complete = 0
        self._last_complete: Optional[FlightTrace] = None
        # (name, tid_key, t0, t1, ids, args) — tid_key is a real thread
        # ident (int) or a virtual-track name (str)
        self._slices: List[Tuple] = []
        # probe-table bound: --sys.flight.freshness_samples (deep
        # enough that the hot head's probes aren't all evicted between
        # serve reads)
        self.freshness = FreshnessProbe(registry, bound=freshness_bound)
        use_reg = registry is not None and registry.enabled

        def _hist(name):
            return registry.histogram(name, bounds=SERVE_LATENCY_BOUNDS_S) \
                if use_reg else Histogram(name,
                                          bounds=SERVE_LATENCY_BOUNDS_S)

        # the per-request breakdown ladder (x2 serve ladder: this is
        # where the SLO lives, docs/OBSERVABILITY.md)
        self.h_queue = _hist("flight.queue_s")
        self.h_batch_wait = _hist("flight.batch_wait_s")
        self.h_dispatch = _hist("flight.dispatch_s")
        self.h_device = _hist("flight.device_s")
        if use_reg:
            self.c_traces = registry.counter("flight.traces_total")
            self.c_programs = registry.counter("flight.programs_total")
        else:
            self.c_traces = Counter("flight.traces_total")
            self.c_programs = Counter("flight.programs_total")

    # -- recording -----------------------------------------------------------

    def mint(self) -> FlightTrace:
        """New per-request trace id (ServeSession.lookup)."""
        self.c_traces.inc()
        return FlightTrace(next(self._next_id), time.perf_counter())

    def _slice(self, name: str, tid_key, t0: float, t1: float,
               ids: Tuple[int, ...], args: Optional[Dict]) -> None:
        if len(self._slices) >= self.max_slices:
            with self._stats_lock:
                self.dropped += 1
            return
        self._slices.append((name, tid_key, t0, t1, ids, args))

    def record_op(self, name: str, t0: float) -> int:
        """Single-segment flight for a plain Worker op (kv.pull /
        kv.push / kv.set): mints an id and records one slice on the
        caller's thread. Returns the id."""
        self.c_traces.inc()
        i = next(self._next_id)
        self._slice("flight." + name, threading.get_ident(), t0,
                    time.perf_counter(), (i,), None)
        return i

    def record_serve_batch(self, traces: Sequence[FlightTrace],
                           t_dispatch: float, t_enqueued: float,
                           t_done: float, n_requests: int, n_keys: int,
                           n_unique: int) -> None:
        """One coalesced micro-batch: stamps the program timestamps on
        every member trace, records the queue slice per member, the
        batch-window slice (which N requests rode this program — the
        membership attribution), the program slice on the dispatching
        thread with a nested device slice, and observes the breakdown
        histograms."""
        if not traces:
            return
        self.c_programs.inc()
        ids = tuple(t.id for t in traces)
        claims = [t.t_claim for t in traces if t.t_claim > 0.0]
        t_first_claim = min(claims) if claims else t_dispatch
        tid = threading.get_ident()
        args = {"requests": int(n_requests), "keys": int(n_keys),
                "unique_keys": int(n_unique)}
        self._slice("flight.batch", "serve.batch-window", t_first_claim,
                    t_dispatch, ids, args)
        self._slice("flight.program", tid, t_dispatch, t_done, ids,
                    {"stream": "serve"})
        self._slice("flight.device", tid, t_enqueued, t_done, ids, None)
        for tr in traces:
            tr.t_dispatch = t_dispatch
            tr.t_enqueued = t_enqueued
            tr.t_done = t_done
            if tr.t_claim > 0.0:
                self._slice("flight.queue", "serve.queue", tr.t_mint,
                            tr.t_claim, (tr.id,), None)
                self.h_queue.observe(max(0.0, tr.t_claim - tr.t_mint))
                self.h_batch_wait.observe(
                    max(0.0, t_dispatch - tr.t_claim))
            self.h_dispatch.observe(max(0.0, t_enqueued - t_dispatch))
            self.h_device.observe(max(0.0, t_done - t_enqueued))

    def finish_lookup(self, tr: FlightTrace, ok: bool) -> None:
        """Client side, at lookup return (success or shed/error): the
        reply + lookup slices close the flow; a request that never got
        served records a terminal lookup slice with its status so no
        trace dangles silently."""
        now = time.perf_counter()
        tid = threading.get_ident()
        if ok and tr.t_deliver > 0.0:
            self._slice("flight.reply", tid, tr.t_deliver, now,
                        (tr.id,), None)
            self._slice("flight.lookup", tid, tr.t_mint, now,
                        (tr.id,), None)
            if tr.t_claim > 0.0 and tr.t_dispatch > 0.0:
                with self._stats_lock:
                    self._complete += 1
                    self._last_complete = tr
        else:
            self._slice("flight.lookup", tid, tr.t_mint, now, (tr.id,),
                        {"status": "shed"})

    # -- summaries -----------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        return {"traces": int(self.c_traces.value),
                "slices": len(self._slices),
                "complete": self._complete, "dropped": self.dropped}

    def exemplar(self) -> Optional[Dict[str, float]]:
        """One sampled complete trace's queue/batch/dispatch/device
        split (ms) — the bench artifact's 'where did the time go'
        exhibit. None until a lookup completed under tracing."""
        tr = self._last_complete
        if tr is None:
            return None
        out = {"trace_id": tr.id}
        out.update({k.replace("_s", "_ms"): round(v * 1e3, 4)
                    for k, v in tr.breakdown_s().items()})
        return out

    # -- export --------------------------------------------------------------

    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def export(self, path: str) -> str:
        """Chrome trace-event JSON with flow events: load in
        https://ui.perfetto.dev, click any `flight.lookup` slice and
        follow the flow arrows through queue -> batch -> program ->
        reply (docs/OBSERVABILITY.md has the recipe)."""
        slices = list(self._slices)
        # tid assignment: real thread idents first (named from live
        # threads), then the virtual tracks
        tids: Dict = {}
        names: Dict[int, str] = {t.ident: t.name
                                 for t in threading.enumerate()
                                 if t.ident is not None}
        out = []
        # per-id phase index for the flow chains: id -> {phase: slice}
        by_id: Dict[int, Dict[int, Tuple]] = {}
        for sl in slices:
            name, tid_key, t0, t1, ids, args = sl
            tid = tids.setdefault(tid_key, len(tids))
            ev_args = dict(args or {})
            ev_args["traces"] = list(ids[:64])
            out.append({"name": name, "cat": "flight", "ph": "X",
                        "ts": round(self._us(t0), 3),
                        "dur": round(max(0.0, (t1 - t0) * 1e6), 3),
                        "pid": self.rank, "tid": tid, "args": ev_args})
            pi = _PHASE_IDX.get(name)
            if pi is not None:
                for i in ids:
                    by_id.setdefault(i, {}).setdefault(pi, sl)
        flows = []
        complete = 0
        for trace_id, phases in sorted(by_id.items()):
            if len(phases) != len(FLIGHT_PHASES):
                continue  # incomplete (shed / still in flight): slices
                # are exported above, but no flow chain is fabricated
            complete += 1
            for pi in range(len(FLIGHT_PHASES)):
                name, tid_key, t0, t1, _ids, _args = phases[pi]
                tid = tids[tid_key]
                # anchor INSIDE the slice: the chain start sits at the
                # lookup's begin, every later step near its phase's end
                # so the flow ts order mirrors causal order
                eps = min(0.5, max(0.0, (t1 - t0) * 1e6 / 2))
                ts = self._us(t0) if pi == 0 else self._us(t1) - eps
                ev = {"name": "flight", "cat": "flight",
                      "ph": "s" if pi == 0 else
                      ("f" if pi == len(FLIGHT_PHASES) - 1 else "t"),
                      "id": int(trace_id), "pid": self.rank,
                      "tid": tid, "ts": round(ts, 3)}
                if ev["ph"] == "f":
                    ev["bp"] = "e"  # bind the finish to the enclosing
                    # slice, like the steps
                flows.append(ev)
        meta = []
        for tid_key, tid in tids.items():
            label = tid_key if isinstance(tid_key, str) else \
                names.get(tid_key, f"thread-{tid_key}")
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": self.rank, "tid": tid,
                         "args": {"name": label}})
        meta.append({"name": "process_name", "ph": "M",
                     "pid": self.rank,
                     "args": {"name": f"adapm flight rank {self.rank}"}})
        doc = {"traceEvents": meta + out + flows,
               "displayTimeUnit": "ms",
               "adapm_flight": {"complete_flows": complete,
                                **self.stats()}}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


# ---------------------------------------------------------------------------
# executor flight-recorder ring
# ---------------------------------------------------------------------------

_RING_WIDTH = 192


class FlightRecorder:
    """Bounded per-stream ring of the last executor programs, mirrored
    into a fixed-size ring FILE one `pwrite` per program (see module
    docstring). Always cheap: one deque append + one small write per
    executor PROGRAM — never on the per-op hot path."""

    def __init__(self, path: Optional[str] = None, per_stream: int = 32,
                 file_slots: int = 128):
        self.path = path
        self._per_stream = int(per_stream)
        self._slots = int(file_slots)
        # several executor workers record concurrently: the lock covers
        # the ring/count mutation only (per PROGRAM, never per op)
        self._lock = threading.Lock()
        self._rings: Dict[str, collections.deque] = {}
        self._counts: Dict[str, int] = {}
        self._total = 0
        self._seq = itertools.count()
        self._fd = None
        if path:
            try:
                self._fd = os.open(path,
                                   os.O_CREAT | os.O_WRONLY | os.O_TRUNC,
                                   0o644)
            except OSError:  # unwritable dir must not block startup
                self._fd = None

    def record(self, stream: str, label: str,
               coalesce_key: Optional[str], wait_s: float, run_s: float,
               failed: bool = False) -> None:
        # BOTH clock domains: span/flight slices are monotonic, so a
        # ring stamped with wall time alone skews against them across
        # NTP steps when timelines are merged — record wall (for
        # post-mortems) AND monotonic (for ordering)
        entry = (time.time(), time.monotonic(), label, coalesce_key,
                 wait_s, run_s, failed)
        with self._lock:
            dq = self._rings.get(stream)
            if dq is None:
                dq = self._rings.setdefault(
                    stream, collections.deque(maxlen=self._per_stream))
            dq.append(entry)
            self._counts[stream] = self._counts.get(stream, 0) + 1
            self._total += 1
        fd = self._fd
        if fd is not None:
            line = (f"{entry[0]:.3f} stream={stream} label={label} "
                    f"key={coalesce_key or '-'} "
                    f"wait_us={wait_s * 1e6:.0f} run_us={run_s * 1e6:.0f}"
                    f"{' FAILED' if failed else ''}").encode()
            line = line[:_RING_WIDTH - 1].ljust(_RING_WIDTH - 1) + b"\n"
            try:
                os.pwrite(fd, line,
                          (next(self._seq) % self._slots) * _RING_WIDTH)
            except OSError:
                pass  # a full disk must not take the executor down

    def tail(self, stream: Optional[str] = None) -> List[Dict]:
        """Most-recent-last entries of one stream's ring (or all
        streams merged by the MONOTONIC stamp — wall time can step
        backwards under NTP; each entry carries both as `t`/`t_mono`)."""
        if stream is not None:
            rings = [(stream, self._rings.get(stream, ()))]
        else:
            rings = list(self._rings.items())
        out = []
        for name, dq in rings:
            for (t, mono, label, ck, wait_s, run_s, failed) in list(dq):
                out.append({"t": t, "t_mono": mono, "stream": name,
                            "label": label, "coalesce_key": ck,
                            "wait_s": wait_s, "run_s": run_s,
                            "failed": failed})
        # merge by the MONOTONIC stamp: wall time can step backwards
        # under NTP, and a merged timeline must never reorder
        out.sort(key=lambda e: e["t_mono"])
        return out

    def summary(self) -> Dict:
        return {"programs_recorded": self._total,
                "per_stream": dict(sorted(self._counts.items())),
                "ring_path": self.path}

    def close(self) -> None:
        fd = self._fd
        self._fd = None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass
