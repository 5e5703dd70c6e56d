"""In-process loopback backend: the whole mp matrix in one container.

`LoopbackFabric` is the wire: per-(src, dst) bounded FIFO queues of
ENCODED frames (bytes — the codec genuinely runs, so corruption and
version drills exercise the same decode path a socket would), a
pairwise partition table, a kill switch per rank, and generation-
counted barriers over the LIVE member set (a killed rank never wedges
a survivor's barrier).

`LoopbackPort` is the per-node endpoint. Inbound frames drain on the
owning server's executor (exec/), one `net.<peer>` stream per source —
ordered FIFO per peer, visible in exec.* accounting, overlapping
across peers (NestPipe's overlap structure for lookup/sync traffic
across shards). During teardown the executor closes BEFORE the PM's
pm-pre-down barrier (Server.shutdown step 7 vs 10, same order as the
real DCN path, where serving rides the channel's own pool) — so each
port keeps one fallback drain thread that takes over the moment the
executor stops accepting programs; late peer requests are still served
and the shutdown barriers converge.

Fault injection (fault/inject.py, `--sys.fault.spec`): the named wire
points

    net.send       outbound frame dropped at the sender
    net.recv       inbound frame dropped at the receiver
    net.delay      outbound frame delayed ~5 ms
    net.dup        outbound frame delivered twice
    net.partition  the (src, dst) link misbehaves for this frame

are evaluated with `FaultPlane.draw` (seeded, per-point streams) —
non-raising: a dropped/duplicated frame is the fault, and the
at-most-once machinery (rid dedup + retransmit) must absorb it
bit-identically (tests/test_torch_netport.py holds a seeded storm to a
NumPy shadow)."""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from .port import (FAMILY_CTRL, NetDecodeError, NetNode,
                   NetPeerDeadError, NetPort, NetTimeoutError)

_FAMILY_CTRL_BYTE = FAMILY_CTRL  # header family byte sits at offset 6

# fabric-level barrier bound: generous next to the per-request timeout
# (--sys.net.timeout_ms) — a barrier wedging for this long means a
# node's thread died without leaving, which should fail loudly
_BARRIER_TIMEOUT_S = 60.0
_DELAY_S = 0.005  # net.delay injected latency per fired frame


class LoopbackFabric:
    """The shared in-process wire between `world` loopback nodes."""

    def __init__(self, world: int, queue: int = 64,
                 timeout_ms: float = 2000.0, retries: int = 16,
                 heartbeat_ms: float = 100.0):
        assert world >= 1
        self.world = int(world)
        self.queue = max(1, int(queue))
        self.timeout_s = float(timeout_ms) * 1e-3
        self.retries = int(retries)
        self.heartbeat_s = float(heartbeat_ms) * 1e-3
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.ports: Dict[int, "LoopbackPort"] = {}
        self.killed: Set[int] = set()
        self.left: Set[int] = set()
        self._partitioned: Set[frozenset] = set()
        # name -> (generation, set of arrived ranks)
        self._barriers: Dict[str, Tuple[int, set]] = {}

    # -- membership of the wire ---------------------------------------------

    def register(self, port: "LoopbackPort") -> None:
        with self._lock:
            self.ports[port.pid] = port

    def live_ranks(self) -> List[int]:
        with self._lock:
            return [r for r in range(self.world)
                    if r not in self.killed and r not in self.left]

    def kill(self, rank: int) -> None:
        """Hard-kill `rank`: sever every link NOW (sends to and from it
        raise NetPeerDeadError, queued frames are dropped), fail its
        peers' pending requests, and release any barrier it was
        blocking. Its heartbeats stop with its port — survivors DETECT
        the death through beat staleness (net/membership.py), which is
        what the failover drill exercises."""
        with self._lock:
            self.killed.add(rank)
            self._cond.notify_all()
        err = NetPeerDeadError(f"rank {rank} was killed")
        for r, port in list(self.ports.items()):
            port.fail_pending_to(rank, err)
            port.drop_queues_from(rank)
        victim = self.ports.get(rank)
        if victim is not None:
            victim.fail_all_pending(NetPeerDeadError(
                f"rank {rank} was killed (self)"))

    def mark_left(self, rank: int) -> None:
        with self._lock:
            self.left.add(rank)
            self._cond.notify_all()

    def partition(self, a: int, b: int) -> None:
        """Deterministically block the (a, b) link both ways until
        heal() — drill API; the probabilistic net.partition point is
        per-frame."""
        with self._lock:
            self._partitioned.add(frozenset((a, b)))

    def heal(self, a: int, b: int) -> None:
        with self._lock:
            self._partitioned.discard(frozenset((a, b)))

    def link_blocked(self, a: int, b: int) -> bool:
        with self._lock:
            return frozenset((a, b)) in self._partitioned

    def is_dead(self, rank: int) -> bool:
        with self._lock:
            return rank in self.killed

    # -- barriers ------------------------------------------------------------

    def barrier(self, name: str, rank: int,
                timeout_s: float = _BARRIER_TIMEOUT_S) -> None:
        """Generation-counted barrier over the LIVE ranks. A rank that
        dies (kill) or leaves mid-wait shrinks the quorum, so the
        survivors converge instead of hanging — the property the
        kill/restore drill needs from pm-pre-down/pm-down."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            gen, arrived = self._barriers.get(name, (0, set()))
            my_gen = gen
            arrived = set(arrived)
            arrived.add(rank)
            self._barriers[name] = (gen, arrived)
            self._cond.notify_all()
            while True:
                gen, arrived = self._barriers.get(name, (0, set()))
                if gen != my_gen:
                    return  # generation completed while we waited
                live = {r for r in range(self.world)
                        if r not in self.killed and r not in self.left}
                if arrived >= live:
                    self._barriers[name] = (my_gen + 1, set())
                    self._cond.notify_all()
                    return
                rem = deadline - time.monotonic()
                if rem <= 0:
                    raise NetTimeoutError(
                        f"loopback barrier {name!r} gen {my_gen} timed "
                        f"out at rank {rank}: arrived={sorted(arrived)} "
                        f"live={sorted(live)}")
                self._cond.wait(min(rem, 0.25))


class LoopbackPort(NetPort):
    """One node's endpoint on the fabric (see module docstring)."""

    def __init__(self, fabric: LoopbackFabric, pid: int, handler,
                 ctrl_handler=None):
        super().__init__(pid, fabric.world, handler,
                         ctrl_handler=ctrl_handler)
        self.fabric = fabric
        # (src -> deque of frames) + per-src claimed flag: exactly one
        # drainer (executor program OR the fallback thread) owns a
        # queue at a time, so per-peer FIFO order holds no matter who
        # drains
        self._in_lock = threading.Lock()
        self._in_cond = threading.Condition(self._in_lock)
        self._inbox: Dict[int, deque] = {}
        self._claimed: Set[int] = set()
        self._closed = False
        # late-bound by LoopbackNode.bind(server): the executor the
        # net.<peer> streams run on, and the fault plane for the wire
        # points (None = no injection, zero cost)
        self._exec = None
        self.fault = None
        self._fallback: Optional[threading.Thread] = None
        fabric.register(self)

    # -- wiring --------------------------------------------------------------

    def bind(self, executor, fault) -> None:
        self._exec = executor
        self.fault = fault

    def request(self, peer: int, msg, timeout_s: Optional[float] = None,
                retries: Optional[int] = None):
        return super().request(
            peer, msg,
            timeout_s=self.fabric.timeout_s if timeout_s is None
            else timeout_s,
            retries=self.fabric.retries if retries is None else retries)

    # -- send side -----------------------------------------------------------

    def _send_bytes(self, dest: int, buf: bytes) -> None:
        fab = self.fabric
        if fab.is_dead(dest):
            raise NetPeerDeadError(f"peer {dest} is dead")
        if fab.is_dead(self.pid):
            raise NetPeerDeadError(f"rank {self.pid} was killed")
        f = self.fault
        if f is not None:
            if fab.link_blocked(self.pid, dest) or \
                    f.draw("net.partition"):
                self._acct(dropped_frames=1)
                return  # the link ate it; retransmit absorbs
            if f.draw("net.send"):
                self._acct(dropped_frames=1)
                return
            if f.draw("net.delay"):
                time.sleep(_DELAY_S)
            copies = 2 if f.draw("net.dup") else 1
        else:
            if fab.link_blocked(self.pid, dest):
                self._acct(dropped_frames=1)
                return
            copies = 1
        port = fab.ports.get(dest)
        if port is None:
            raise NetPeerDeadError(f"peer {dest} has no port")
        # CTRL frames (beats/membership) bypass the data queues and
        # deliver inline on the sender's thread: heartbeats ride the
        # CONTROL plane, exactly as the real DCN path's beats ride the
        # TCPStore, never the data channel — so a data-plane
        # backlog (busy executor, full queue) can not fake a death
        if buf[6] == _FAMILY_CTRL_BYTE:
            try:
                for _ in range(copies):
                    port._on_frame(buf)
            except NetDecodeError:
                self._acct(dropped_frames=1)
            return
        for _ in range(copies):
            port._enqueue(self.pid, buf)

    # -- receive side --------------------------------------------------------

    def _enqueue(self, src: int, buf: bytes) -> None:
        """Called on the SENDER's thread: append to the bounded per-src
        FIFO (blocking briefly on backpressure), then kick a drain."""
        deadline = time.monotonic() + self.fabric.timeout_s
        with self._in_cond:
            if self._closed:
                return
            q = self._inbox.get(src)
            if q is None:
                q = self._inbox[src] = deque()
            while len(q) >= self.fabric.queue:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    # bounded queue stayed full past the timeout: the
                    # frame is dropped; requester retransmits
                    self._acct(dropped_frames=1)
                    return
                self._in_cond.wait(min(rem, 0.05))
                if self._closed:
                    return
            q.append(buf)
            self._in_cond.notify_all()
        self._kick(src)

    def _kick(self, src: int) -> None:
        ex = self._exec
        if ex is not None and not ex.closed:
            c = ex.submit(f"net.{src}", lambda: self._drain(src),
                          label=f"net.drain.{src}",
                          coalesce_key=f"net.drain.{src}")
            if not c.cancelled:
                return
        # executor gone (teardown window between exec.close and the
        # pm-down barriers): the fallback thread serves late peers
        self._ensure_fallback()

    def _ensure_fallback(self) -> None:
        with self._in_cond:
            if self._fallback is not None and self._fallback.is_alive():
                self._in_cond.notify_all()
                return
            t = threading.Thread(target=self._fallback_loop,
                                 daemon=True,
                                 name=f"adapm-net-drain{self.pid}")
            self._fallback = t
        t.start()

    def _fallback_loop(self) -> None:
        while True:
            with self._in_cond:
                if self._closed:
                    return
                srcs = [s for s, q in self._inbox.items()
                        if q and s not in self._claimed]
                if not srcs:
                    if not self._in_cond.wait(1.0):
                        # idle for a second — park until re-kicked
                        if not any(self._inbox.values()):
                            self._fallback = None
                            return
                    continue
            for s in srcs:
                self._drain(s)

    def _drain(self, src: int) -> None:
        """Drain src's queue FIFO. Claim discipline: one drainer per
        src at a time (executor FIFO usually guarantees it; the claim
        closes the executor/fallback handover race)."""
        with self._in_cond:
            if src in self._claimed:
                return
            self._claimed.add(src)
        try:
            while True:
                with self._in_cond:
                    q = self._inbox.get(src)
                    if not q:
                        return
                    buf = q.popleft()
                    self._in_cond.notify_all()
                f = self.fault
                if f is not None and f.draw("net.recv"):
                    self._acct(dropped_frames=1)
                    continue
                try:
                    self._on_frame(buf)
                except NetDecodeError:
                    # counted in _on_frame; a corrupt frame is dropped
                    # before any server mutation
                    continue
        finally:
            with self._in_cond:
                self._claimed.discard(src)

    def drop_queues_from(self, src: int) -> None:
        with self._in_cond:
            q = self._inbox.get(src)
            if q is not None:
                q.clear()
            self._in_cond.notify_all()

    def fail_all_pending(self, err: BaseException) -> None:
        with self._pending_lock:
            pend = list(self._pending.values())
        for p in pend:
            if not p.event.is_set():
                p.error = err
                p.event.set()

    def shutdown(self) -> None:
        with self._in_cond:
            self._closed = True
            self._inbox.clear()
            self._in_cond.notify_all()


class LoopbackNode(NetNode):
    """NetNode over a LoopbackFabric: identity, channel, barriers,
    membership-backed liveness. One per in-process 'node'."""

    kind = "loopback"

    def __init__(self, fabric: LoopbackFabric, rank: int):
        self.fabric = fabric
        self.pid = int(rank)
        self.num_procs = fabric.world
        self.port: Optional[LoopbackPort] = None
        self.membership = None  # net/membership.py, built at bind
        self.server = None

    def make_channel(self, handler, serve_threads: int):
        self.port = LoopbackPort(
            self.fabric, self.pid, handler,
            ctrl_handler=self._on_ctrl)
        return self.port

    def _on_ctrl(self, src: int, msg) -> None:
        m = self.membership
        if m is not None:
            m.on_ctrl(src, msg)

    def bind(self, server) -> None:
        """Called by Server.__init__ once the executor and fault plane
        exist; the membership plane starts beating here."""
        self.server = server
        if self.port is not None:
            self.port.bind(server.exec, server.fault)
        from .membership import Membership
        self.membership = Membership(self, server,
                                     heartbeat_s=self.fabric.heartbeat_s)
        self.membership.start()

    def barrier(self, name: Optional[str] = None) -> None:
        self.fabric.barrier(name or "adapm", self.pid)

    def dead_peers(self, max_age_s: float = 10.0) -> list:
        m = self.membership
        if m is not None:
            return m.dead_peers()
        return sorted(self.fabric.killed)

    def pre_down(self) -> None:
        if self.membership is not None:
            self.membership.announce_leave()
            self.membership.stop()
        self.fabric.mark_left(self.pid)

    def net_plane(self):
        return self.membership


class LoopbackCluster:
    """N full Servers in one process, wired through the fabric — the
    loopback analog of a launcher run of N processes. Servers
    are constructed on per-rank threads (the pm-up barrier rendezvouses
    exactly like a real launch), and `run(fn)` drives one callable per
    rank the way a launched scenario drives one process per rank. Each
    node's Server gets its own device context of `num_shards` shards on
    `device` (default cuda): on the card every node's pools live on the
    one GPU."""

    def __init__(self, world: int, num_keys: int, value_lengths,
                 opts_factory=None, queue: int = 64,
                 timeout_ms: float = 2000.0, heartbeat_ms: float = 50.0,
                 retries: int = 16, num_workers: Optional[int] = None,
                 num_shards: Optional[int] = None, device=None):
        from ..config import SystemOptions
        from ..device.context import make_context
        self.fabric = LoopbackFabric(world, queue=queue,
                                     timeout_ms=timeout_ms,
                                     retries=retries,
                                     heartbeat_ms=heartbeat_ms)
        self.nodes = [LoopbackNode(self.fabric, r) for r in range(world)]
        self.servers: List = [None] * world
        errs: List = [None] * world

        def build(rank: int) -> None:
            from ..core.kv import Server
            opts = opts_factory(rank) if opts_factory is not None \
                else SystemOptions(sync_max_per_sec=0, prefetch=False)
            try:
                self.servers[rank] = Server(
                    num_keys, value_lengths, opts=opts,
                    ctx=make_context(num_shards, device),
                    num_workers=num_workers, net_node=self.nodes[rank])
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errs[rank] = e
                self.fabric.mark_left(rank)  # unblock peers' pm-up

        threads = [threading.Thread(target=build, args=(r,),
                                    name=f"adapm-loop-build{r}")
                   for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(_BARRIER_TIMEOUT_S)
        for e in errs:
            if e is not None:
                raise e

    def run(self, fn, ranks: Optional[List[int]] = None) -> List:
        """Drive `fn(rank, server)` on one thread per rank; re-raise
        the first failure. `ranks` restricts to survivors after a
        kill."""
        ranks = list(range(self.fabric.world)) if ranks is None else ranks
        out: List = [None] * self.fabric.world
        errs: List = [None] * self.fabric.world

        def drive(rank: int) -> None:
            try:
                out[rank] = fn(rank, self.servers[rank])
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errs[rank] = e

        threads = [threading.Thread(target=drive, args=(r,),
                                    name=f"adapm-loop-run{r}")
                   for r in ranks]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errs:
            if e is not None:
                raise e
        return out

    def kill(self, rank: int) -> None:
        self.fabric.kill(rank)

    def shutdown(self, ranks: Optional[List[int]] = None) -> None:
        ranks = [r for r in (ranks if ranks is not None
                             else range(self.fabric.world))
                 if r not in self.fabric.killed
                 and self.servers[r] is not None]
        self.run(lambda r, srv: srv.shutdown(), ranks=ranks)
