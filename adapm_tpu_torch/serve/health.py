"""Liveness/readiness of the serving plane (the port of the JAX
package's `serve/health.py`).

Readiness folds these signals:
  - the dispatch plane is running (a dead dispatcher serves nothing);
  - no dispatcher is WEDGED: busy on one micro-batch for longer than the
    wedge bound (the 30 s fail-stop bound `LookupBatcher.stop` uses).
    The probe reads per-drain busy stamps lock-free, so it never hangs
    behind the drain it reports;
  - no other executor stream is busy on one program past
    `--sys.fault.watchdog_s`;
  - the admission queue is not saturated (depth < bound);
  - the server is not DEGRADED (`Server.begin_degraded`);
  - no peer is dead (`Server.dead_nodes`: always empty in one process,
    as in the JAX package with heartbeats off; a test or a deployment
    may inject its own detector).

The `serve.ready` (0/1) and `serve.dead_peers` gauges land in
`Server.metrics_snapshot()["serve"]`, which also embeds the full
`readiness()` dict while a plane is attached.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional


class HealthMonitor:
    """Owned by a ServePlane; see module docstring."""

    def __init__(self, plane, max_age_s: float = 10.0,
                 dead_nodes_fn: Optional[Callable[[], list]] = None,
                 wedge_s: float = 30.0):
        self.plane = plane
        self.server = plane.server
        self.max_age_s = max_age_s
        # per-dispatcher wedge bound: a drain busy on ONE batch longer
        # than this is stuck (matches the stop()-time fail-stop bound;
        # injectable for tests)
        self.wedge_s = wedge_s
        # injectable for tests (and for deployments with an external
        # failure detector); default: the server's heartbeat-staleness
        # detection
        self._dead_nodes_fn = dead_nodes_fn or \
            (lambda: self.server.dead_nodes(self.max_age_s))
        # last readiness() result + its wall time: the gauges read this
        # (refreshed past _GAUGE_MAX_AGE_S) instead of each probing, so
        # one metrics_snapshot() probes once and its gauges agree with
        # its embedded readiness dict
        self._cache = None
        reg = self.server.obs
        reg.gauge("serve.ready", shared=True,
                  fn=lambda: int(self._cached()["ready"]))
        reg.gauge("serve.dead_peers", shared=True,
                  fn=lambda: len(self._cached()["dead_nodes"]))

    _GAUGE_MAX_AGE_S = 1.0

    def _cached(self) -> Dict:
        """The readiness dict for gauge reads: fresh enough, probing at
        most once per _GAUGE_MAX_AGE_S. metrics_snapshot() calls
        readiness() first, so one snapshot performs exactly one probe
        and its gauges agree with its embedded readiness dict."""
        import time
        c = self._cache
        if c is not None and time.monotonic() - c[0] < \
                self._GAUGE_MAX_AGE_S:
            return c[1]
        return self.readiness()

    def _dead(self) -> List:
        try:
            return list(self._dead_nodes_fn())
        except Exception:  # noqa: BLE001 — a failing probe is itself
            # a not-ready signal, not a crash in the metrics path
            return ["<heartbeat probe failed>"]

    def liveness(self) -> Dict:
        """Process-is-up probe: cheap, no cross-process calls."""
        return {"alive": True,
                "dispatcher_alive": self.plane.batcher.is_alive(),
                "dispatchers": self.plane.batcher.dispatchers}

    def readiness(self) -> Dict:
        """Can this process take NEW serving traffic, and if not, why.
        Always probes fresh (and refreshes the gauge cache). Never
        blocks: the wedge probe reads busy stamps, so a stuck
        dispatcher flips the signal within the wedge bound instead of
        hanging the probe behind it."""
        import time
        reasons: List[str] = []
        batcher = self.plane.batcher
        # degraded window: the server sheds every lookup with
        # ServeDegradedError — not-ready by definition
        degraded = getattr(self.server, "_degraded_reason", None)
        if degraded is not None:
            reasons.append(f"degraded: {degraded} (lookups shed with "
                           f"ServeDegradedError)")
        if not batcher.is_alive():
            reasons.append("dispatcher thread not running")
        wedged = batcher.wedged_dispatchers(self.wedge_s)
        if wedged:
            reasons.append(
                f"dispatcher(s) {wedged} wedged: busy on one "
                f"micro-batch > {self.wedge_s:.0f}s (fail-stop bound)")
        depth = self.plane.queue.depth()   # live requests only
        bound = self.plane.queue.bound
        if depth >= bound:
            reasons.append(
                f"admission queue saturated ({depth}/{bound})")
        # executor watchdog: any stream whose CURRENT program is busy
        # past --sys.fault.watchdog_s is wedged (a stuck sync round
        # flips readiness as a stuck dispatcher does; the probe reads
        # busy stamps, never blocking behind the wedged program)
        exw = self.server.exec.wedged_streams(
            self.server.opts.fault_watchdog_s,
            exclude=batcher.streams)
        if exw:
            names = [w["stream"] for w in exw]
            reasons.append(
                f"executor stream(s) {names} wedged: busy on one "
                f"program > {self.server.opts.fault_watchdog_s:.0f}s "
                f"(--sys.fault.watchdog_s)")
        dead = self._dead()
        # failover detail: what a membership plane did about dead peers
        # (None without one: the port has no network plane yet)
        net = getattr(self.server, "net", None)
        failover = None
        if net is not None:
            s = net.stats()
            failover = {"failovers": s["failovers"],
                        "failover_s": s["failover_s"],
                        "promoted_keys": s["promoted_keys"],
                        "lost_keys": s["lost_keys"],
                        "peers_live": s["peers_live"],
                        "peers_total": s["peers_total"]}
        if dead:
            if failover is not None:
                reasons.append(
                    f"dead peers {dead}: failover promoted "
                    f"{failover['promoted_keys']} replica key(s), "
                    f"{failover['lost_keys']} lost")
            else:
                reasons.append(
                    f"stale peer heartbeats (detection-only): {dead}")
        out = {"ready": not reasons, "reasons": reasons,
               "dead_nodes": dead, "queue_depth": depth,
               "queue_bound": bound,
               "dispatchers": batcher.dispatchers,
               "wedged_dispatchers": wedged,
               "wedged_streams": [w["stream"] for w in exw],
               "degraded": degraded, "failover": failover}
        self._cache = (time.monotonic(), out)
        return out
