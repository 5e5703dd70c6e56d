"""Decision telemetry: every adaptive choice, with the features it saw
and the outcome it bought (the JAX package's `obs/decisions.py`, on the
port's Server).

With `--sys.trace.decisions PATH` (default off) the `DecisionRecorder`
captures each adaptive decision as a structured event:

  `reloc`     relocate-vs-replicate classification (core/sync.py
              `_register`) and the landed ownership move (core/kv.py
              `_relocate_to`, with pool-full demotions to replication)
  `tier`      background hot-pool promotion with its anti-thrash verdict
              (tier/promote.py `ensure_hot_rows`) and pressure demotion
              (`PromotionEngine.run_once`)
  `sync`      ship/hold per channel batch (core/sync.py `sync_channel`)
  `serve`     SLO window moves (obs/slo.py `_control`)
  `prefetch`  stage vs pool-full skip (core/intent.py)
  `costs`     measured-cost fused-vs-hostpool verdicts
              (serve/batcher.py)

  - Default off: `Server.decisions is None`, one `is None` check per
    site, no `decision.*` registry name.
  - Every event carries `CORE_FEATURES` (policy/features.py, the
    extractor the runtime policy reads through too) plus plane fields,
    the logical clock, `wall` and `mono`. All reads are lock-free host
    reads: capture never takes the server lock or waits on the device.
  - The `.dtrace` file is the JAX package's format (name, version,
    fields), written and verified by `obs/wtrace.py`'s trace-file
    machinery; `load_dtrace` raises `DecisionTraceError` on a truncated
    or flipped file. A trace from either package loads in the other.

Outcome attribution: a decision may open a bounded follow-up window
(`follow_events` same-plane events, `8 x follow_events` events of any
plane, or `follow_s` seconds, whichever comes first; close() resolves
stragglers with `truncated: true`). Resolution appends an `outcome`
event referencing the decision's `seq` and folds per-plane regret
(`decision.promoted_never_hit`, `decision.replicated_never_read`,
`decision.shipped_clean`, `decision.regret_rate.<plane>`).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# the shared feature extractor: the module the runtime PolicyPlane
# vectorizes through (CORE_FEATURES is re-exported for consumers)
from ..policy.features import CORE_FEATURES, core_features  # noqa: F401

DTRACE_FORMAT = "adapm-dtrace"
DTRACE_VERSION = 1

# hard bounds on the buffered stream (loud drop counter beyond either),
# mirroring wtrace: decisions are management-plane events, far sparser
# than the op stream, so the defaults are generous
DEFAULT_MAX_EVENTS = 1_000_000
DEFAULT_MAX_BYTES = 256 * 1024 * 1024

# planes that open follow-up windows and fold a regret rate
_REGRET_PLANES = ("reloc", "tier", "sync", "serve", "prefetch")
_PLANES = _REGRET_PLANES + ("costs",)

# per-decision key/slot sample bound for outcome probes: windows
# re-read addressbook/residency state for at most this many entries
# (outcome fields are therefore sample-based for larger batches — the
# event says so via "sampled": true)
_PROBE_CAP = 64


class DecisionTraceError(RuntimeError):
    """The `.dtrace` file is unreadable: wrong format/version, truncated
    body, checksum mismatch, or malformed JSON. Raised by `load_dtrace`
    during verification, BEFORE anything consumes the trace (the
    wtrace/ckpt verify-before-use discipline)."""


class _Window:
    """One open follow-up window: resolves into an `outcome` event via
    `resolve(truncated)` -> (fields, regret-or-None)."""

    __slots__ = ("seq", "plane", "deadline_mono", "plane_due",
                 "total_due", "resolve")

    def __init__(self, seq: int, plane: str, deadline_mono: float,
                 plane_due: int, total_due: int,
                 resolve: Callable[[bool], Tuple[Dict, Optional[bool]]]):
        self.seq = seq
        self.plane = plane
        self.deadline_mono = deadline_mono
        self.plane_due = plane_due
        self.total_due = total_due
        self.resolve = resolve


def _sample(arr: np.ndarray, cap: int = _PROBE_CAP) -> np.ndarray:
    """Evenly-strided sample of at most `cap` entries (the wtrace
    sampled-with-counts discipline, applied to outcome probes)."""
    a = np.ascontiguousarray(arr, dtype=np.int64)
    if len(a) <= cap:
        return a
    stride = -(-len(a) // cap)  # ceil: <= cap samples
    return a[::stride]


class DecisionRecorder:
    """One per Server when `--sys.trace.decisions` names a path; owned
    and closed by the server (shutdown, after every producer is
    stopped, alongside the wtrace recorder). Thread-safe: decision
    sites record concurrently under one small lock (append + counter
    bumps only — never a device wait, never the server lock); window
    resolution runs outside it on pure host reads."""

    def __init__(self, server, path: Optional[str],
                 follow_events: int = 8, follow_s: float = 2.0,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        from .metrics import Counter, Gauge
        if path is not None and not path:
            raise ValueError("decision trace capture needs a path "
                             "(--sys.trace.decisions)")
        # path=None is the METRICS-ONLY mode (internal; the CLI knob
        # always names a file): windows open, outcomes resolve, and
        # the regret gauges fold exactly as in capture mode, but
        # flush() writes nothing. The replay engine uses this to score
        # a candidate's decision quality (`score_decisions=True`)
        # while still PINNING `trace_decisions` off — the simulator
        # scores itself through the registry, it never emits a trace
        # of itself (replay/engine.py).
        self._server = server
        self.path = path
        self.follow_events = max(1, int(follow_events))
        self.follow_s = float(follow_s)
        self.max_events = int(max_events)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()  # wtrace ordering discipline
        self._wlock = threading.Lock()
        self._events: List[Dict] = []
        self._windows: List[_Window] = []
        self._sweeping = False
        self._approx_bytes = 0
        self._seq = 0
        self._closed = False
        self._flushes = 0
        self._warned_drop = False
        self.wall_t0 = time.time()
        self.mono_t0 = time.monotonic()
        # per-plane tallies (plain ints; the regret gauges are the
        # registry-visible ratio view over these)
        self._decided = {p: 0 for p in _PLANES}
        self._resolved = {p: 0 for p in _PLANES}
        self._regrets = {p: 0 for p in _PLANES}
        self._plane_seen = {p: 0 for p in _PLANES}
        self._total_seen = 0
        self._opened = 0
        self._forced = 0
        reg = server.obs
        use_reg = reg is not None and reg.enabled
        if use_reg:
            self.c_events = reg.counter("decision.events_total")
            self.c_dropped = reg.counter("decision.dropped_total")
            self.g_bytes = reg.gauge("decision.bytes_written")
            self.c_promoted_never_hit = \
                reg.counter("decision.promoted_never_hit")
            self.c_replicated_never_read = \
                reg.counter("decision.replicated_never_read")
            self.c_shipped_clean = reg.counter("decision.shipped_clean")
            self.g_regret = {p: reg.gauge(f"decision.regret_rate.{p}")
                             for p in _REGRET_PLANES}
        else:  # capture works with --sys.metrics 0 (standalone tallies)
            self.c_events = Counter("decision.events_total")
            self.c_dropped = Counter("decision.dropped_total")
            self.g_bytes = Gauge("decision.bytes_written")
            self.c_promoted_never_hit = \
                Counter("decision.promoted_never_hit")
            self.c_replicated_never_read = \
                Counter("decision.replicated_never_read")
            self.c_shipped_clean = Counter("decision.shipped_clean")
            self.g_regret = {p: Gauge(f"decision.regret_rate.{p}")
                             for p in _REGRET_PLANES}

    # -- event plumbing ------------------------------------------------------

    def _server_clock(self) -> int:
        c = self._server._clocks
        return int(c.max()) if len(c) else 0

    def _base(self, kind: str, plane: str) -> Dict:
        return {"kind": kind, "plane": plane,
                "clock": self._server_clock(),
                "wall": time.time(), "mono": time.monotonic()}

    def _append(self, ev: Dict) -> Optional[int]:
        """Buffer one event; returns its seq (None when dropped)."""
        cost = 96 + 8 * (len(ev.get("features", ())) +
                         len(ev.get("sample", ())))
        with self._lock:
            if self._closed:
                return None
            if len(self._events) >= self.max_events or \
                    self._approx_bytes + cost > self.max_bytes:
                self.c_dropped.inc()
                if not self._warned_drop:
                    self._warned_drop = True
                    from ..utils import alog
                    alog(f"[decisions] event buffer full "
                         f"({len(self._events)} events, "
                         f"~{self._approx_bytes >> 20} MiB); further "
                         f"decision/outcome events are DROPPED (counted "
                         f"in decision.dropped_total) — the captured "
                         f"trace is a loud prefix, not a silent lie")
                return None
            seq = self._seq
            ev["seq"] = seq
            self._seq += 1
            self._events.append(ev)
            self._approx_bytes += cost
        self.c_events.inc()
        return seq

    def _features(self, batch_n: int) -> Dict:
        """The CORE_FEATURES context visible at decision time, through
        the SHARED extractor (policy/features.py) — the same code path
        runtime inference reads, so a trained model's inputs mean
        exactly what the captured rows meant."""
        return core_features(self._server, batch_n)

    def _record(self, plane: str, action: str, features: Dict,
                **fields) -> Optional[int]:
        ev = self._base("decision", plane)
        ev["action"] = action
        ev["features"] = features
        for k, v in fields.items():
            ev[k] = v
        seq = self._append(ev)
        if seq is not None:
            self._decided[plane] += 1
        self._tick(plane)
        return seq

    # -- follow-up windows ---------------------------------------------------

    def _open_window(self, seq: Optional[int], plane: str,
                     resolve: Callable) -> None:
        if seq is None:
            return  # the decision itself was dropped: nothing to tie to
        w = _Window(seq, plane,
                    time.monotonic() + self.follow_s,
                    self._plane_seen[plane] + self.follow_events,
                    self._total_seen + 8 * self.follow_events,
                    resolve)
        with self._wlock:
            self._windows.append(w)
            self._opened += 1

    def _tick(self, plane: str) -> None:
        """Advance the window clocks and resolve due windows. Reentrancy
        guard: outcome appends inside a sweep never re-sweep."""
        with self._wlock:
            self._plane_seen[plane] += 1
            self._total_seen += 1
            if self._sweeping or not self._windows:
                return
            self._sweeping = True
        try:
            self._sweep(forced=False)
        finally:
            with self._wlock:
                self._sweeping = False

    def _sweep(self, forced: bool) -> None:
        now = time.monotonic()
        with self._wlock:
            due, rest = [], []
            for w in self._windows:
                if forced or now >= w.deadline_mono or \
                        self._plane_seen[w.plane] >= w.plane_due or \
                        self._total_seen >= w.total_due:
                    due.append(w)
                else:
                    rest.append(w)
            self._windows = rest
            if forced:
                self._forced += len(due)
        for w in due:
            try:
                fields, regret = w.resolve(forced)
            except Exception as e:  # a probe racing teardown resolves
                fields, regret = {"error": type(e).__name__}, None
            ev = self._base("outcome", w.plane)
            ev["ref"] = w.seq
            ev["truncated"] = bool(forced)
            ev.update(fields)
            if regret is not None:
                ev["regret"] = bool(regret)
            self._append(ev)
            self._fold(w.plane, regret)

    def _fold(self, plane: str, regret: Optional[bool]) -> None:
        self._resolved[plane] += 1
        if regret:
            self._regrets[plane] += 1
        g = self.g_regret.get(plane)
        if g is not None and self._resolved[plane]:
            g.set(self._regrets[plane] / self._resolved[plane])

    def _immediate(self, plane: str, seq: Optional[int], fields: Dict,
                   regret: Optional[bool]) -> None:
        """A decision whose outcome is known at decision time: append
        the outcome event directly (the dataset join is uniform — every
        decision has an outcome ref) and fold the tallies."""
        if seq is None:
            return
        self._opened += 1
        ev = self._base("outcome", plane)
        ev["ref"] = seq
        ev["truncated"] = False
        ev.update(fields)
        if regret is not None:
            ev["regret"] = bool(regret)
        self._append(ev)
        self._fold(plane, regret)

    # -- decision sites ------------------------------------------------------

    def record_classify(self, shard: int, n_relocate: int,
                        n_replicate: int, n_remote: int,
                        replicate_keys: np.ndarray) -> None:
        """sync._register: the relocate-vs-replicate split for one
        intent batch. Replications open a window probing whether the
        replicas were ever worth it (still live, or intent renewed, by
        window close — sampled at `_PROBE_CAP`)."""
        f = self._features(n_relocate + n_replicate + n_remote)
        f["n_relocate"] = int(n_relocate)
        f["n_replicate"] = int(n_replicate)
        f["n_remote"] = int(n_remote)
        seq = self._record("reloc", "classify", f, shard=int(shard),
                           sampled=len(replicate_keys) > _PROBE_CAP)
        if n_replicate == 0:
            self._immediate("reloc", seq, {"replicated": 0}, False)
            return
        srv = self._server
        sample = _sample(replicate_keys)

        def resolve(truncated: bool):
            from ..base import NO_SLOT
            ab = srv.ab
            live = ab.cache_slot[shard, sample] != NO_SLOT
            mc = srv.shard_min_clocks()[int(shard)]
            active = srv.sync.intent_end[shard, sample] >= mc
            never = int((~live & ~active).sum())
            if never:
                self.c_replicated_never_read.inc(never)
            return ({"replicated": int(n_replicate),
                     "probed": int(len(sample)),
                     "replicas_live": int(live.sum()),
                     "intent_active": int(active.sum()),
                     "never_read": never},
                    never == len(sample) and len(sample) > 0)

        self._open_window(seq, "reloc", resolve)

    def record_move(self, dest: int, n_moved: int, n_demoted: int,
                    moved_keys: np.ndarray) -> None:
        """kv._relocate_to: the landed ownership move (plus pool-full
        demotions to replication). The window probes post-move
        locality: the fraction of moved keys still owned by `dest` at
        close — a move immediately undone is a regretted thrash."""
        f = self._features(n_moved + n_demoted)
        f["n_moved"] = int(n_moved)
        f["n_demoted"] = int(n_demoted)
        seq = self._record("reloc", "move", f, dest=int(dest),
                           sampled=len(moved_keys) > _PROBE_CAP)
        if n_moved == 0:
            self._immediate("reloc", seq, {"locality": 0.0}, None)
            return
        srv = self._server
        sample = _sample(moved_keys)

        def resolve(truncated: bool):
            still = int((srv.ab.owner[sample] == dest).sum())
            loc = still / len(sample) if len(sample) else 0.0
            return ({"probed": int(len(sample)),
                     "still_owned": still,
                     "locality": round(loc, 4)},
                    len(sample) > 0 and still == 0)

        self._open_window(seq, "reloc", resolve)

    def record_tier(self, store, shard: int, promoted: np.ndarray,
                    n_pinned: int, n_unpinned: int, n_victims: int,
                    n_beat: int, min_clock: int) -> None:
        """tier ensure_hot_rows (background path): one shard's
        promotion batch with the anti-thrash verdict — the pinned/
        unpinned candidate split, victims scanned, and victims whose
        scores were STRICTLY beaten. The window probes whether the
        promoted rows were re-touched while still hot; a batch with
        zero such hits is a regretted promotion
        (decision.promoted_never_hit counts the rows)."""
        f = self._features(n_pinned + n_unpinned)
        f["n_pinned"] = int(n_pinned)
        f["n_unpinned"] = int(n_unpinned)
        f["n_victims"] = int(n_victims)
        f["n_beat"] = int(n_beat)
        seq = self._record("tier", "promote", f, shard=int(shard),
                           promoted=int(len(promoted)),
                           min_clock=int(min_clock),
                           sampled=len(promoted) > _PROBE_CAP)
        if len(promoted) == 0:
            self._immediate("tier", seq, {"hit_rows": 0}, None)
            return
        res = store.res
        slots = _sample(promoted)
        score_then = np.array(res.score[shard, slots], copy=True)

        def resolve(truncated: bool):
            now = res.score[shard, slots]
            hot = res.dev_row[shard, slots] >= 0
            hit = (now > score_then) & hot
            hits, never = int(hit.sum()), int((~hit).sum())
            if never:
                self.c_promoted_never_hit.inc(never)
            return ({"probed": int(len(slots)), "hit_rows": hits,
                     "never_hit_rows": never,
                     "still_hot_rows": int(hot.sum())},
                    hits == 0)

        self._open_window(seq, "tier", resolve)

    def record_tier_demote(self, shard: int, n: int, free: int,
                           target: int) -> None:
        """tier run_once pressure demotion: headroom reclaim. Outcome is
        immediate — the demotion's cost shows up as later promotions'
        regret, not its own."""
        f = self._features(n)
        f["free_before"] = int(free)
        f["target_free"] = int(target)
        seq = self._record("tier", "demote", f, shard=int(shard),
                           demoted=int(n))
        self._immediate("tier", seq, {"demoted": int(n)}, None)

    def record_sync(self, channel: int, considered: int, dirty: int,
                    shipped: int) -> None:
        """sync_channel ship/hold for one channel round: `considered`
        live local replicas, `dirty` with unshipped writes (-1 = dirty
        filter off), `shipped` after sibling propagation. Outcome is
        immediate: clean ride-alongs count in decision.shipped_clean; a
        ship with ZERO dirty rows (filter off) is regretted wire."""
        f = self._features(considered)
        f["n_dirty"] = int(dirty)
        f["n_shipped"] = int(shipped)
        f["n_held"] = int(considered - shipped)
        action = "ship" if shipped else "hold"
        seq = self._record("sync", action, f, channel=int(channel))
        clean = (shipped - dirty) if dirty >= 0 else shipped
        clean = max(0, int(clean)) if shipped else 0
        if clean:
            self.c_shipped_clean.inc(clean)
        regret = bool(shipped) and dirty == 0
        self._immediate("sync", seq, {"shipped": int(shipped),
                                      "shipped_clean": clean}, regret)

    def record_serve(self, old_us: int, new_us: int, p99_ms: float,
                     target_ms: float,
                     p99_fn: Callable[[], float]) -> None:
        """obs/slo.py _control: one autopilot batch-window move. The
        window re-reads the controller's windowed P99 at close: a move
        that left the tail FARTHER from target than it found it is
        regretted."""
        f = self._features(1)
        f["old_us"] = int(old_us)
        f["new_us"] = int(new_us)
        f["p99_ms"] = round(float(p99_ms), 3)
        f["target_ms"] = round(float(target_ms), 3)
        action = "shrink" if new_us < old_us else "grow"
        seq = self._record("serve", action, f)
        then_err = abs(float(p99_ms) - float(target_ms))

        def resolve(truncated: bool):
            now = float(p99_fn())
            now_err = abs(now - float(target_ms))
            return ({"p99_after_ms": round(now, 3),
                     "err_before_ms": round(then_err, 3),
                     "err_after_ms": round(now_err, 3)},
                    now > 0 and now_err > then_err + 1e-9)

        self._open_window(seq, "serve", resolve)

    def record_prefetch(self, action: str, n_keys: int, stats) -> None:
        """core/intent.py staging: `stage` (batch staged) or `skip`
        (pool budget exhausted). The stage window reads the prefetch
        hit/expired counter deltas at close: staged work that only ever
        expired is regretted staging."""
        f = self._features(n_keys)
        f["pool_full"] = int(action == "skip")
        seq = self._record("prefetch", action, f)
        if action != "stage":
            self._immediate("prefetch", seq, {"hits_delta": 0}, None)
            return
        h0, e0 = int(stats["hits"]), int(stats["expired"])

        def resolve(truncated: bool):
            dh = int(stats["hits"]) - h0
            de = int(stats["expired"]) - e0
            return ({"hits_delta": dh, "expired_delta": de},
                    de > 0 and dh == 0)

        self._open_window(seq, "prefetch", resolve)

    def record_costs(self, fused: bool, n_groups: int, n_keys: int,
                     n_false: int, n_none: int) -> None:
        """serve/batcher.py bag dispatch: the measured-cost verdict —
        fused gather_pool kept, or overridden to flat-gather+host-pool.
        Purely observational (the table is already measured); outcome is
        immediate and never regretted here."""
        f = self._features(n_keys)
        f["n_groups"] = int(n_groups)
        f["verdicts_false"] = int(n_false)
        f["verdicts_none"] = int(n_none)
        seq = self._record("costs", "fused" if fused else "hostpool", f)
        self._immediate("costs", seq, {"overridden": not fused}, None)

    # -- meta / stats --------------------------------------------------------

    def _meta(self) -> Dict:
        from .wtrace import options_doc
        srv = self._server
        return {"num_keys": int(srv.num_keys),
                "num_shards": int(srv.ctx.num_shards),
                "rank": int(srv.pid),
                "follow_events": self.follow_events,
                "follow_s": self.follow_s,
                "probe_cap": _PROBE_CAP,
                "wall_t0": self.wall_t0,
                "mono_t0": self.mono_t0,
                "knobs": options_doc(srv.opts)}

    def stats(self) -> Dict:
        """Plain-value summary for `metrics_snapshot()["decision"]` (the
        registry-backed decision.* counters land in the same section)."""
        with self._lock:
            n = len(self._events)
        with self._wlock:
            open_w = len(self._windows)
        out: Dict = {"path": self.path, "events_buffered": n,
                     "flushes": self._flushes, "closed": self._closed,
                     "windows_opened": self._opened,
                     "windows_resolved": sum(self._resolved.values()),
                     "windows_forced": self._forced,
                     "windows_open": open_w}
        for p in _PLANES:
            out[f"decided.{p}"] = self._decided[p]
            out[f"resolved.{p}"] = self._resolved[p]
            out[f"regretted.{p}"] = self._regrets[p]
        return out

    # -- flush / close -------------------------------------------------------

    def flush(self) -> str:
        """Write the full trace atomically (wtrace header discipline);
        returns the path (empty string in metrics-only mode — there is
        no file to write). Safe to call mid-run for a point-in-time
        trace; close() performs the final flush."""
        if self.path is None:
            return ""
        from .wtrace import write_trace_file
        with self._flush_lock:
            with self._lock:
                doc = {"meta": self._meta(),
                       "events": list(self._events),
                       "dropped": int(self.c_dropped.value)}
            nbytes = write_trace_file(self.path, doc, DTRACE_FORMAT,
                                      DTRACE_VERSION)
            with self._lock:
                self._flushes += 1
            self.g_bytes.set(float(nbytes))
        return self.path

    def close(self) -> None:
        """Resolve every still-open window (truncated — the follow-up
        horizon is the run's end), then final flush + seal (idempotent).
        Called by Server.shutdown AFTER every producer is stopped, so
        the probes read settled state."""
        with self._lock:
            if self._closed:
                return
        self._sweep(forced=True)
        self.flush()
        with self._lock:
            self._closed = True


# ---------------------------------------------------------------------------
# loading (shared by replay/dataset.py and tooling)
# ---------------------------------------------------------------------------


class DecisionTrace:
    """A verified, parsed `.dtrace`: `meta` dict + `events` list (seq
    order). Construction implies the checksum passed."""

    __slots__ = ("path", "meta", "events", "dropped")

    def __init__(self, path: str, meta: Dict, events: List[Dict],
                 dropped: int):
        self.path = path
        self.meta = meta
        self.events = events
        self.dropped = dropped

    def decisions(self) -> List[Dict]:
        return [e for e in self.events if e["kind"] == "decision"]

    def outcomes(self) -> Dict[int, Dict]:
        """outcome events keyed by the decision seq they reference."""
        return {int(e["ref"]): e for e in self.events
                if e["kind"] == "outcome"}

    def planes(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.decisions():
            out[e["plane"]] = out.get(e["plane"], 0) + 1
        return out


def load_dtrace(path: str) -> DecisionTrace:
    """Read + verify a `.dtrace` file. Raises `DecisionTraceError` on a
    missing/truncated/corrupt/incompatible file — named, and BEFORE
    anything consumes the trace."""
    from .wtrace import load_trace_doc
    doc = load_trace_doc(path, DTRACE_FORMAT, DTRACE_VERSION,
                         DecisionTraceError, "decision trace")
    return DecisionTrace(path, doc["meta"], doc["events"],
                         int(doc.get("dropped", 0)))
