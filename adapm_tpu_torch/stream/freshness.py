"""FreshnessSLO (the JAX package's `stream/freshness.py`): the closed
loop over event-to-servable staleness.

The FreshnessProbe (obs/flight.py) measures the wall time from a push
EVENT to the first serve read that observes it (`flight.freshness_s`).
This controller re-targets the obs/slo.py control law at that
histogram and walks the TWO levers that bound staleness:

  - **sync cadence** — `SyncManager.effective_max_per_sec`, the
    effective rate bound `_throttle` honors. Tightening multiplies it
    ABOVE the static `--sys.sync.max_per_sec` (more rounds/s -> newer
    replicas), bounded at 64x static; relaxing walks it back down,
    never below the static knob. An unthrottled static knob (<= 0)
    leaves this lever inert.
  - **serve-replica refresh** — `ServeReplica.refresh_s`, the snapshot
    refresh throttle. Tightening divides it toward a 1 ms floor
    (fresher snapshots on the lock-free fast path); relaxing grows it
    back, never above the static `--sys.serve.replica_refresh_ms`.
    With no replica attached the lever is skipped (the exact locked
    path reads live values — sync cadence is then the whole story).

Law (identical shape to the serve SLO controller): windowed P99 —
each tick diffs the cumulative histogram against the previous window
mark and extracts the quantile of just that window; a window short of
`min_samples` EXTENDS across ticks (the probe samples every Nth push,
so low ingest rates would otherwise starve the controller) — compared
to the target with a +/- tol deadband; outside it, every available
lever moves one multiplicative step in the correcting direction. Bounded,
hysteretic, and logged: every applied move lands in a bounded
adjustment log and increments `stream.slo_adjustments_total`.

Per-class targets (`--sys.stream.freshness_slo_ms 400,1=200`): the
controller steers to the TIGHTEST class target. Freshness is a
write-path property — sync rounds and snapshot refreshes serve every
class's reads at once, so per-class freshness cannot be steered
independently the way per-class LANE WINDOWS can (obs/slo.py grows
that half); meeting gold's bound meets bronze's automatically.

Runs as a self-rescheduling delayed program on the executor's
`stream.slo` stream; requires `--sys.trace.flight` (the sensor) and
`--sys.metrics` (validate_serve rejects the combinations loudly).
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

from ..obs.metrics import hist_percentile

# sync-rate ceiling, as a multiple of the static knob: the controller
# may run sync up to this much hotter than the operator's throttle
_RATE_CAP_X = 64.0
# replica-refresh floor: below ~1 ms the refresh program itself is the
# staleness (and the executor would spin on coalesced refresh kicks)
_REFRESH_FLOOR_S = 1e-3


class FreshnessSLO:
    """One per StreamPlane when `--sys.stream.freshness_slo_ms > 0`;
    owned and closed by the plane."""

    def __init__(self, server, target_ms: float,
                 class_targets: Optional[Dict[int, float]] = None,
                 interval_s: float = 0.1, tol: float = 0.25,
                 step: float = 1.5, min_samples: int = 4,
                 quantile: float = 0.99):
        assert target_ms > 0, "freshness SLO target must be positive"
        self.server = server
        self.class_targets = dict(class_targets or {})
        # steer to the tightest class (module docstring): the base
        # target covers classes without an override
        eff_ms = min([float(target_ms)] +
                     [float(v) for v in self.class_targets.values()])
        self.target_ms = float(target_ms)
        self.target_s = eff_ms * 1e-3
        self.interval_s = float(interval_s)
        self.tol = float(tol)
        self.step = float(step)
        self.min_samples = int(min_samples)
        self.quantile = float(quantile)
        # lever bounds, anchored at the operator's static knobs
        self.static_rate = float(server.opts.sync_max_per_sec)
        self.hi_rate = self.static_rate * _RATE_CAP_X
        self.static_refresh_s = \
            float(server.opts.serve_replica_refresh_ms) * 1e-3
        # sensor: the freshness histogram itself (probe-owned — present
        # whenever flight tracing is on, which validate_serve requires)
        self._h = server.flight.freshness.h_freshness
        self._prev_snap: Optional[Dict] = None
        self._closed = False
        # bounded move log: (wall, mono, [(lever, old, new), ...],
        # p99_ms); the first move is kept past the deque bound for the
        # convergence guard's direction check
        self.adjustments: "collections.deque" = collections.deque(
            maxlen=256)
        self.first_adjustment: Optional[Tuple] = None
        reg = server.obs
        self.c_adjust = reg.counter("stream.slo_adjustments_total",
                                    shared=True)
        self.c_ticks = reg.counter("stream.slo_ticks_total", shared=True)
        self.g_p99 = reg.gauge("stream.freshness_p99_ms", shared=True)
        self.g_target = reg.gauge("stream.freshness_target_ms",
                                  shared=True)
        self.g_rate = reg.gauge("stream.sync_rate", shared=True)
        self.g_refresh = reg.gauge("stream.refresh_ms", shared=True)
        self.g_target.set(eff_ms)
        self.g_rate.set(self.static_rate)
        self.g_refresh.set(self.static_refresh_s * 1e3)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._resubmit()

    def close(self) -> None:
        """Stop rescheduling. Idempotent; a queued tick sees _closed
        and exits without resubmitting."""
        self._closed = True

    def _resubmit(self) -> None:
        if self._closed:
            return
        # per-INSTANCE coalesce key (obs/slo.py discipline): a plane
        # rebuilt within one interval must not have its first tick
        # absorbed into the closed predecessor's queued tick
        self.server.exec.submit(
            "stream.slo", self._tick, label="stream.slo.tick",
            coalesce_key=f"stream.slo.tick.{id(self)}",
            delay=self.interval_s)

    def _tick(self) -> None:
        if self._closed or self.server.exec.closed:
            return
        try:
            self._control()
        finally:
            self._resubmit()

    # -- control law ---------------------------------------------------------

    def _window_p99(self) -> Optional[float]:
        """Quantile of the freshness observations accumulated since the
        last ACTED-ON tick (cumulative histogram diffed against the
        previous window mark). The probe samples every Nth push, so at
        modest ingest rates one tick interval holds fewer than
        `min_samples` observations — the window mark then stays put and
        the window EXTENDS across ticks until it qualifies (a
        fixed-width window would starve the controller into never
        acting); None until then."""
        snap = self._h.snap()
        prev = self._prev_snap
        if prev is None:
            self._prev_snap = snap
            return None
        count = snap["count"] - prev["count"]
        if count < self.min_samples:
            return None         # extend: keep the window mark
        self._prev_snap = snap
        buckets = [a - b for a, b in zip(snap["buckets"],
                                         prev["buckets"])]
        return hist_percentile({"count": count,
                                "bounds": snap["bounds"],
                                "buckets": buckets}, self.quantile)

    def _control(self) -> None:
        self.c_ticks.inc()
        p99 = self._window_p99()
        if p99 is None:
            return
        self.g_p99.set(p99 * 1e3)
        if p99 > self.target_s * (1.0 + self.tol):
            tighten = True
        elif p99 < self.target_s * (1.0 - self.tol):
            tighten = False
        else:
            return  # deadband: hysteresis against lever chatter
        moves: List[Tuple[str, float, float]] = []
        # lever 1: effective sync rate (inert when unthrottled)
        sm = self.server.sync
        cur = float(sm.effective_max_per_sec)
        if self.static_rate > 0:
            if tighten:
                new = min(self.hi_rate, max(cur * self.step, cur + 1.0))
            else:
                new = max(self.static_rate, cur / self.step) \
                    if cur > self.static_rate else cur
            if new != cur:
                sm.effective_max_per_sec = new
                self.g_rate.set(new)
                moves.append(("sync_rate", cur, new))
        # lever 2: serve-replica refresh window (skipped without a
        # replica — the locked path reads live values already)
        plane = getattr(self.server, "_serve_plane", None)
        rep = plane.replica if plane is not None else None
        if rep is not None:
            cur_s = float(rep.refresh_s)
            if tighten:
                new_s = max(_REFRESH_FLOOR_S, cur_s / self.step) \
                    if cur_s > _REFRESH_FLOOR_S else cur_s
            else:
                new_s = min(self.static_refresh_s, cur_s * self.step) \
                    if cur_s < self.static_refresh_s else cur_s
            if new_s != cur_s:
                rep.refresh_s = new_s
                self.g_refresh.set(new_s * 1e3)
                moves.append(("refresh_ms", cur_s * 1e3, new_s * 1e3))
        if not moves:
            return  # both levers pinned at their bounds
        self.c_adjust.inc(len(moves))
        # BOTH clock domains: the flight slices this log is read
        # against are monotonic; wall time is for
        # humans and cross-run joins
        move = (time.time(), time.monotonic(), moves, p99 * 1e3)
        if self.first_adjustment is None:
            self.first_adjustment = move
        self.adjustments.append(move)

    # -- reporting -----------------------------------------------------------

    @staticmethod
    def _fmt(move: Tuple) -> Dict:
        t, tm, levers, p99 = move
        return {"t": round(t, 3), "t_mono": round(tm, 6),
                "levers": [{"lever": lv, "old": round(o, 4),
                            "new": round(n, 4)}
                           for (lv, o, n) in levers],
                "p99_ms": round(p99, 3)}

    def report(self) -> Dict:
        """JSON-safe summary for `metrics_snapshot()["stream"]` and
        the north-star artifact."""
        sm = self.server.sync
        plane = getattr(self.server, "_serve_plane", None)
        rep = plane.replica if plane is not None else None
        return {"active": True,
                "target_ms": round(self.target_s * 1e3, 3),
                "base_target_ms": round(self.target_ms, 3),
                "class_targets": {str(k): v for k, v in
                                  sorted(self.class_targets.items())},
                "sync_rate": float(sm.effective_max_per_sec),
                "static_sync_rate": self.static_rate,
                "refresh_ms": (float(rep.refresh_s) * 1e3
                               if rep is not None else None),
                "static_refresh_ms": self.static_refresh_s * 1e3,
                "adjustments": int(self.c_adjust.value),
                "first_adjustment": (
                    self._fmt(self.first_adjustment)
                    if self.first_adjustment is not None else None),
                "recent_adjustments": [
                    self._fmt(m) for m in list(self.adjustments)[-8:]]}
