"""SLO autopilot: a closed-loop tail-latency controller for the serve
plane (the port of the JAX package's `obs/slo.py`).

`--sys.serve.max_wait_us` — the micro-batch coalescing window — is the
throughput/latency dial of the serving plane, and before this module it
was a hand-tuned constant every deployment shared. With
`--sys.serve.slo_ms` set, an `SLOController` observes the serve P99
from the existing `serve.latency_s` histogram ladder (windowed: each
control tick diffs the cumulative buckets against the previous tick and
extracts the quantile of JUST that window via `hist_percentile`) and
walks the batcher's effective `max_wait_us` so the observed tail tracks
the target instead:

  - P99 above `target * (1 + tol)`  -> shrink the window
    (multiplicative, floor 0: stop lingering, dispatch immediately);
  - P99 below `target * (1 - tol)`  -> grow the window (multiplicative
    with a minimum step so growth escapes 0, capped) — latency budget
    is being left on the table that coalescing can spend;
  - inside the deadband                -> no change (the hysteresis
    that keeps the knob from chattering on a noisy box).

Bounded: the window never exceeds `max(static knob, 75% of the SLO)` —
the operator's explicit knob stays reachable as the ceiling, and a
tiny knob may still grow to 75% of the SLO for useful batching (note:
with a knob set ABOVE the SLO, a quiet period can regrow the window
past the target; the next busy window overshoots once before the law
re-shrinks) — and never goes below 0. Every adjustment increments
`slo.adjustments_total`, updates the `slo.wait_us` / `slo.p99_ms`
gauges, and lands in a bounded adjustment log (the bench artifact's
`wait_us_adjustments`). With `--sys.serve.slo_ms` unset (the default)
no controller exists and the static knob path is untouched.

The controller runs as a self-rescheduling delayed program on the
executor's `slo` stream (timer work without a sleeping thread);
`close()` stops the reschedule and the executor's shutdown cancels any
queued tick.

Requires `--sys.metrics` (the controller is blind without the latency
histogram); `SystemOptions.validate_serve` rejects the combination
loudly.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

from .metrics import hist_percentile

# growth needs a minimum absolute step so the window can escape 0
_MIN_GROW_US = 50


class SLOController:
    """One per ServePlane when `--sys.serve.slo_ms > 0`; owned and
    closed by the plane."""

    def __init__(self, server, batcher, target_ms: float,
                 class_targets: Optional[Dict[int, float]] = None,
                 interval_s: float = 0.1, tol: float = 0.25,
                 step: float = 1.5, min_samples: int = 4,
                 quantile: float = 0.99):
        assert target_ms > 0, "SLO target must be positive"
        self.server = server
        self.batcher = batcher
        self.target_s = float(target_ms) * 1e-3
        self.interval_s = float(interval_s)
        self.tol = float(tol)
        self.step = float(step)
        self.min_samples = int(min_samples)
        self.quantile = float(quantile)
        self.lo_us = 0
        # ceiling: the operator's explicit knob stays reachable, and a
        # knob far below the SLO may still grow to 75% of the target
        # for useful batching. An oversized knob (> SLO) remains the
        # cap, so quiet periods can regrow past the target — one
        # overshoot window before the law re-shrinks, by design.
        self.hi_us = max(int(batcher.max_wait_us),
                         int(self.target_s * 1e6 * 0.75))
        self._h = batcher.h_latency     # serve.latency_s (real Histogram;
        # validate_serve guarantees metrics are on when slo_ms is set)
        self._prev_snap: Optional[Dict] = None
        self._closed = False
        # bounded adjustment log:
        # (wall_time, mono_time, old_us, new_us, p99_ms)
        self.adjustments: "collections.deque" = collections.deque(
            maxlen=256)
        # the very first move, kept past the deque bound: the
        # convergence guard checks ITS direction (the oldest of the
        # last-8 window is not the first once the law has oscillated)
        self.first_adjustment: Optional[Tuple] = None
        reg = server.obs
        self.c_adjust = reg.counter("slo.adjustments_total", shared=True)
        self.c_ticks = reg.counter("slo.ticks_total", shared=True)
        self.g_wait = reg.gauge("slo.wait_us", shared=True)
        self.g_p99 = reg.gauge("slo.p99_ms", shared=True)
        self.g_target = reg.gauge("slo.target_ms", shared=True)
        self.g_target.set(float(target_ms))
        self.g_wait.set(float(batcher.max_wait_us))
        # per-priority-class targets
        # (`--sys.serve.slo_ms 20,1=5,2=50`): each overridden class gets
        # its OWN effective lane window, walked by the same law against
        # that class's windowed quantile. Batches are priority-pure
        # (admission.take pins the class after the first claim), so a
        # class's window is well-defined per batch; the base window
        # still serves classes without an override. Empty (the default)
        # touches nothing — the batcher's class hooks stay None and the
        # take() path is byte-identical.
        self.class_targets_s: Dict[int, float] = {
            int(p): float(ms) * 1e-3
            for p, ms in (class_targets or {}).items()}
        self.class_adjustments: "collections.deque" = \
            collections.deque(maxlen=256)
        self._class_prev_cut: Optional[float] = None
        self.class_hi_us: Dict[int, int] = {}
        if self.class_targets_s:
            base = int(batcher.max_wait_us)
            batcher.class_wait_us = {p: base
                                     for p in self.class_targets_s}
            batcher._class_samples = collections.deque(maxlen=4096)
            self.class_hi_us = {
                p: max(base, int(ts * 1e6 * 0.75))
                for p, ts in self.class_targets_s.items()}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._resubmit()

    def close(self) -> None:
        """Stop rescheduling. Idempotent; a tick already queued on the
        `slo` stream sees `_closed` and exits without resubmitting (and
        executor close cancels it outright)."""
        self._closed = True

    def _resubmit(self) -> None:
        if self._closed:
            return
        # coalesce per controller INSTANCE: a plane rebuilt within one
        # tick interval must not have its first tick absorbed into the
        # closed predecessor's still-queued tick (which early-returns
        # without rescheduling — the new controller would never run)
        self.server.exec.submit("slo", self._tick, label="slo.tick",
                                coalesce_key=f"slo.tick.{id(self)}",
                                delay=self.interval_s)

    def _tick(self) -> None:
        if self._closed or self.server.exec.closed:
            return
        try:
            self._control()
            if self.class_targets_s:
                self._control_classes()
        finally:
            self._resubmit()

    # -- control law ---------------------------------------------------------

    def _window_p99(self) -> Optional[float]:
        """Quantile of the observations since the LAST tick (cumulative
        histogram diffed against the previous snapshot); None when the
        window holds too few samples to act on."""
        snap = self._h.snap()
        prev = self._prev_snap
        self._prev_snap = snap
        if prev is None:
            return None
        count = snap["count"] - prev["count"]
        if count < self.min_samples:
            return None
        buckets = [a - b for a, b in zip(snap["buckets"],
                                         prev["buckets"])]
        return hist_percentile({"count": count, "bounds": snap["bounds"],
                                "buckets": buckets}, self.quantile)

    def _control(self) -> None:
        self.c_ticks.inc()
        p99 = self._window_p99()
        if p99 is None:
            return
        self.g_p99.set(p99 * 1e3)
        cur = int(self.batcher.max_wait_us)
        if p99 > self.target_s * (1.0 + self.tol):
            if cur <= self.lo_us:
                return  # already dispatching immediately; the tail is
                # now dominated by dispatch/device time, not the window
            new = max(self.lo_us, min(cur - 1, int(cur / self.step)))
        elif p99 < self.target_s * (1.0 - self.tol):
            if cur >= self.hi_us:
                return
            new = min(self.hi_us, max(cur + _MIN_GROW_US,
                                      int(cur * self.step)))
        else:
            return  # deadband: hysteresis against knob chatter
        if new == cur:
            return
        pol = self.server.policy
        if pol is not None and pol.active("serve"):
            # a learned serve law may hold the window where the heuristic
            # proposes a move (value-preserving: the window only paces
            # coalescing)
            if pol.consult("serve",
                           {"old_us": cur, "new_us": new,
                            "p99_ms": round(p99 * 1e3, 3),
                            "target_ms": round(self.target_s * 1e3,
                                               3)}, 1):
                pol.applied("serve")
                return
        self.batcher.max_wait_us = new
        self.c_adjust.inc()
        self.g_wait.set(float(new))
        # both clock domains: the serve latency slices this log is read
        # against are monotonic
        move = (time.time(), time.monotonic(), cur, new, p99 * 1e3)
        if self.first_adjustment is None:
            self.first_adjustment = move
        self.adjustments.append(move)
        dc = self.server.decisions
        if dc is not None:
            # decision telemetry: the move with its window and target
            # features
            dc.record_serve(cur, new, p99 * 1e3, self.target_s * 1e3,
                            lambda: float(self.g_p99.value))

    def _control_classes(self) -> None:
        """Walk each overridden class's lane window against its own
        windowed quantile (the batcher's bounded (t, latency, prio)
        sample ring — per-class percentiles without per-class registry
        names). Same law, same deadband, same bounds discipline as the
        base window; moves land in `class_adjustments` and count into
        `slo.adjustments_total`."""
        samples = self.batcher._class_samples
        cw = self.batcher.class_wait_us
        if samples is None or cw is None:
            return
        now = time.perf_counter()  # the sample stamps' clock
        cut = self._class_prev_cut
        self._class_prev_cut = now
        if cut is None:
            return
        by_prio: Dict[int, List[float]] = {}
        for (t, lat, prio) in list(samples):
            if t > cut and prio in self.class_targets_s:
                by_prio.setdefault(prio, []).append(lat)
        for prio in sorted(self.class_targets_s):
            target_s = self.class_targets_s[prio]
            lats = by_prio.get(prio)
            if lats is None or len(lats) < self.min_samples:
                continue
            lats.sort()
            p99 = lats[min(len(lats) - 1,
                           int(self.quantile * len(lats)))]
            cur = int(cw.get(prio, self.batcher.max_wait_us))
            hi = self.class_hi_us[prio]
            if p99 > target_s * (1.0 + self.tol):
                if cur <= self.lo_us:
                    continue
                new = max(self.lo_us, min(cur - 1, int(cur / self.step)))
            elif p99 < target_s * (1.0 - self.tol):
                if cur >= hi:
                    continue
                new = min(hi, max(cur + _MIN_GROW_US,
                                  int(cur * self.step)))
            else:
                continue  # deadband
            if new == cur:
                continue
            cw[prio] = new
            self.c_adjust.inc()
            self.class_adjustments.append(
                (time.time(), time.monotonic(), prio, cur, new,
                 p99 * 1e3))

    # -- reporting -----------------------------------------------------------

    def report(self) -> Dict:
        """JSON-safe summary for `metrics_snapshot()["slo"]` and the
        bench artifact."""
        last: List = [
            {"t": round(t, 3), "t_mono": round(tm, 6), "old_us": o,
             "new_us": n, "p99_ms": round(p, 3)}
            for (t, tm, o, n, p) in list(self.adjustments)[-8:]]
        first = None
        if self.first_adjustment is not None:
            t, tm, o, n, p = self.first_adjustment
            first = {"t": round(t, 3), "t_mono": round(tm, 6),
                     "old_us": o, "new_us": n, "p99_ms": round(p, 3)}
        out = {"active": True,
               "target_ms": round(self.target_s * 1e3, 3),
               "wait_us": int(self.batcher.max_wait_us),
               "bounds_us": [self.lo_us, self.hi_us],
               "adjustments": int(self.c_adjust.value),
               "first_adjustment": first,
               "recent_adjustments": last}
        if self.class_targets_s:
            # per-class keys present ONLY with class overrides — the
            # no-override report (and every pre-existing consumer of
            # it) is byte-identical
            cw = self.batcher.class_wait_us or {}
            out["class_targets_ms"] = {
                str(p): round(ts * 1e3, 3)
                for p, ts in sorted(self.class_targets_s.items())}
            out["class_wait_us"] = {str(p): int(w)
                                    for p, w in sorted(cw.items())}
            out["class_adjustments"] = [
                {"t": round(t, 3), "t_mono": round(tm, 6),
                 "priority": pr, "old_us": o, "new_us": n,
                 "p99_ms": round(p, 3)}
                for (t, tm, pr, o, n, p)
                in list(self.class_adjustments)[-8:]]
        return out
