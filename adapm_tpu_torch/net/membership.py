"""Elastic membership + dead-peer failover for the loopback backend.

Every node runs one Membership plane: a daemon thread that beats
(FAMILY_CTRL posts, fire-and-forget — loss is absorbed by the next
beat) every `heartbeat_s` and monitors peer staleness. The state
machine per peer:

    live --(no beat for DEAD_AFTER_BEATS intervals)--> dead
    live --("leave" ctrl msg, graceful shutdown)-----> left
    dead --("beat" ctrl msg, restore drill)----------> live (rejoin)

`left` is terminal for a teardown and NEVER triggers failover —
GlobalPM.shutdown announces the leave via `NetNode.pre_down` BEFORE the
pm-pre-down barrier, so a graceful exit cannot be mistaken for a death
even though the executor (and its beats-carrying streams — beats ride
their own thread precisely so they DON'T) is already closed.

`dead` triggers failover exactly once per transition: pending requests
to the corpse fail fast with NetPeerDeadError, then
`GlobalPM.failover_dead_peer` promotes every replica of a dead-owned
key to main through the existing `_adopt` path (`Server.
_topology_mutation` discipline — the same replica→main upgrade intent
uses, so pending sync deltas merge instead of dropping). Keys the dead
rank owned WITHOUT a live replica are lost — counted, surfaced in
`net.lost_keys`, and subsequent reads raise NetPeerDeadError rather
than hang. Wall-clock from detection to served-again is recorded in
`net.failover_s` (bounded by the storm check + bench `net` phase).

The plane IS the snapshot `net` section and registers the
`net.*` registry names — both exist only when a loopback node is
attached, so the default single-process/DCN server keeps zero net cost
(plane off: no object, no names)."""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from .port import NetPeerDeadError

DEAD_AFTER_BEATS = 5  # missed-beat count before declaring a peer dead


class Membership:
    """Per-node membership/heartbeat/failover plane (module docstring).
    Doubles as the NetPlane: stats() feeds the snapshot `net` section,
    and net.* registry gauges read through it."""

    def __init__(self, node, server, heartbeat_s: float = 0.1):
        self.node = node
        self.server = server
        self.port = node.port
        self.heartbeat_s = max(1e-3, float(heartbeat_s))
        self._lock = threading.Lock()
        now = time.monotonic()
        self.state: Dict[int, str] = {
            r: "live" for r in range(node.num_procs)}
        self._last_beat: Dict[int, float] = {
            r: now for r in range(node.num_procs)}
        # monitor-loop iteration counter + per-peer last-seen tick:
        # death needs BOTH the wall-clock horizon AND DEAD_AFTER_BEATS
        # of OUR OWN completed loop iterations since the last beat — a
        # whole-process stall (GIL, XLA compile) freezes the tick
        # counter along with the peers' beat threads, so it can never
        # read as everyone dying at once
        self._tick = 0
        self._tick_seen: Dict[int, int] = {
            r: 0 for r in range(node.num_procs)}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.beats_out = 0
        self.joins = 0
        self.leaves = 0
        self.failovers = 0
        self.failover_s = 0.0   # most recent detection->promoted wall
        self.promoted_keys = 0
        self.lost_keys = 0
        self._register_metrics(server.obs)

    def _register_metrics(self, registry) -> None:
        # net.* names exist ONLY when a plane exists (a default
        # server's registry holds none of them). Shared: a rebuilt
        # plane rebinds readers.
        if registry is None or not registry.enabled:
            return
        for key in ("msgs_out", "msgs_in", "bytes_out", "bytes_in",
                    "retransmits", "dup_suppressed", "decode_errors",
                    "dropped_frames"):
            registry.gauge(f"net.{key}", shared=True,
                           fn=lambda k=key: self.port.stats[k])
        registry.gauge("net.peers_live", shared=True,
                       fn=lambda: self.live_count())
        registry.gauge("net.peers_total", shared=True,
                       fn=lambda: self.node.num_procs)
        registry.gauge("net.peers_dead", shared=True,
                       fn=lambda: len(self.dead_peers()))
        registry.gauge("net.failovers", shared=True,
                       fn=lambda: self.failovers)
        registry.gauge("net.failover_s", unit="s", shared=True,
                       fn=lambda: self.failover_s)
        registry.gauge("net.lost_keys", shared=True,
                       fn=lambda: self.lost_keys)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        t = threading.Thread(target=self._loop, daemon=True,
                             name=f"adapm-net-beat{self.node.pid}")
        self._thread = t
        t.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def announce_leave(self) -> None:
        """Graceful-leave broadcast (NetNode.pre_down): peers mark this
        rank `left` so the teardown never reads as a death."""
        for peer in self._peers("live"):
            try:
                self.port.post(peer, ("leave", self.node.pid))
            except NetPeerDeadError:
                pass

    # -- beat/monitor loop ---------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            me = self.node.pid
            for peer in self._peers("live"):
                try:
                    self.port.post(peer, ("beat", me))
                    self.beats_out += 1
                except NetPeerDeadError:
                    pass  # staleness, not send failure, declares death
            self._tick += 1
            self._check_stale()

    def _check_stale(self) -> None:
        horizon = time.monotonic() - DEAD_AFTER_BEATS * self.heartbeat_s
        for peer in self._peers("live"):
            if self._last_beat.get(peer, 0.0) < horizon and \
                    self._tick - self._tick_seen.get(peer, 0) > \
                    DEAD_AFTER_BEATS:
                self._mark_dead(peer)

    def _peers(self, state: str) -> List[int]:
        me = self.node.pid
        with self._lock:
            return [r for r, s in self.state.items()
                    if s == state and r != me]

    # -- ctrl plane ----------------------------------------------------------

    def on_ctrl(self, src: int, msg) -> None:
        op = msg[0] if isinstance(msg, tuple) and msg else msg
        now = time.monotonic()
        with self._lock:
            self._last_beat[src] = now
            self._tick_seen[src] = self._tick
            prev = self.state.get(src, "live")
            if op == "leave":
                self.state[src] = "left"
                self.leaves += 1
                return
            if op in ("beat", "join") and prev == "dead":
                # restore drill: a corpse beating again rejoins live
                self.state[src] = "live"
                self.joins += 1

    # -- death + failover ----------------------------------------------------

    def _mark_dead(self, peer: int) -> None:
        with self._lock:
            if self.state.get(peer) != "live":
                return  # already dead/left; failover ran once
            self.state[peer] = "dead"
        t0 = time.monotonic()
        self.port.fail_pending_to(
            peer, NetPeerDeadError(
                f"peer {peer} declared dead (no beat for "
                f"{DEAD_AFTER_BEATS:g} x {self.heartbeat_s:g}s)"))
        glob = getattr(self.server, "glob", None)
        promoted = lost = 0
        if glob is not None:
            try:
                promoted, lost = glob.failover_dead_peer(peer)
            except Exception:  # noqa: BLE001 — a failed failover must
                # not kill the beat thread; the keys stay dead-owned
                # and reads surface NetPeerDeadError per-key
                pass
        with self._lock:
            self.failovers += 1
            self.failover_s = time.monotonic() - t0
            self.promoted_keys += promoted
            self.lost_keys += lost

    # -- liveness surface (NetNode.dead_peers / serve/health.py) -------------

    def dead_peers(self) -> List[int]:
        with self._lock:
            return sorted(r for r, s in self.state.items()
                          if s == "dead")

    def live_count(self) -> int:
        with self._lock:
            return sum(1 for s in self.state.values() if s == "live")

    def peer_states(self) -> Dict[int, str]:
        with self._lock:
            return dict(self.state)

    # -- snapshot `net` section -----------------------------------------------

    def stats(self) -> Dict:
        out: Dict = dict(self.port.stats_snapshot())
        with self._lock:
            out.update({
                "backend": self.node.kind,
                "peers_total": self.node.num_procs,
                "peers_live": sum(1 for s in self.state.values()
                                  if s == "live"),
                "peers_dead": sum(1 for s in self.state.values()
                                  if s == "dead"),
                "peers_left": sum(1 for s in self.state.values()
                                  if s == "left"),
                "beats_out": self.beats_out,
                "joins": self.joins,
                "leaves": self.leaves,
                "failovers": self.failovers,
                "failover_s": self.failover_s,
                "promoted_keys": self.promoted_keys,
                "lost_keys": self.lost_keys,
            })
        return out
