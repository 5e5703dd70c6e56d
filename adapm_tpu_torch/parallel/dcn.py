"""Host-side DCN data channel for cross-process parameter traffic (the
JAX package's `parallel/dcn.py`).

The reference moves every cross-node byte through its ZeroMQ van
(include/zmq_van.h, src/van.cc). Here the hot data plane is on the
device (intent makes keys local before use), so what remains for the
network is the thin tail the reference also has: misses (pull/push of
keys owned by another process), row fetches for replica creation and
relocation, and delta shipping during sync rounds. Those ride this
channel: one TCP listener per process, peer addresses rendezvoused
through the control plane's TCPStore (parallel/control.py; the
scheduler's replacement — src/van.cc:40-111 ADD_NODE), length-framed
pickle messages (protocol 5). Payloads are host numpy arrays: a device
tensor is read back before its message is built.

Concurrency model (the reference multiplexes via ZMQ identity frames + N
IO threads, zmq_van.h:109-112; the analog here is request-id
demultiplexing): every frame carries a request id, a per-peer reader
thread resolves replies to their waiting futures, and the serving side
dispatches handler calls to a small pool and tags each reply with the
request's id — so concurrent requests to the SAME peer overlap instead
of queueing head-of-line behind one another. Requests from one process
to one peer are NOT serialized; read-your-writes is enforced above the
channel by write futures (core/kv.py), never by socket FIFO.

Request handling takes the server lock only around local table/pool
operations — never across a nested channel call — so two processes
pulling from each other cannot deadlock.
"""
from __future__ import annotations

import itertools
import pickle
import socket
import struct
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Optional

_LEN = struct.Struct("!Q")


def _send_msg(sock: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=5)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket):
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return pickle.loads(body)


class DcnChannel:
    """Request/reply channel between the launcher's processes.

    `handler(msg) -> reply` is called for every incoming request on the
    serve pool. Outgoing `request(peer, msg)` is synchronous for the
    caller (send + await its reply future) but overlaps freely with other
    in-flight requests to the same or other peers. Peer addresses go
    through the control plane's TCPStore (net/socket.py StoreRendezvous).
    """

    def __init__(self, process_id: int, num_processes: int,
                 handler: Callable, serve_threads: int = 4):
        from ..net.socket import StoreRendezvous
        self.pid = process_id
        self.num = num_processes
        self.handler = handler
        self.rv = StoreRendezvous()
        self._listener: Optional[socket.socket] = None
        self._peers: Dict[int, socket.socket] = {}
        # held only across sendall (frame atomicity), never across a recv
        self._send_locks: Dict[int, threading.Lock] = {}
        # guards _peers/_send_locks mutation: two threads making first
        # requests to the same peer must agree on one (socket, lock) pair
        self._resolve_lock = threading.Lock()
        self._rid = itertools.count(1)
        self._pending: Dict[int, Future] = {}
        self._pending_lock = threading.Lock()
        # peer -> rids awaiting its reply (failed fast on disconnect)
        self._pending_by_peer: Dict[int, set] = {}
        self._serve_pool = ThreadPoolExecutor(
            max_workers=max(1, serve_threads),
            thread_name_prefix="adapm-dcn-h")
        self._threads = []
        self._stop = threading.Event()
        # wire accounting (the DCN bytes a run ships), under one lock:
        # senders and per-connection readers run on many threads
        self.stats = {"msgs_out": 0, "bytes_out": 0, "msgs_in": 0}
        self._stats_lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", 0))
        self._listener.listen(self.num)
        port = self._listener.getsockname()[1]
        host = socket.gethostname()
        self.rv.set(f"adapm/dcn/{self.pid}", f"{host}:{port}")
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="adapm-dcn-accept")
        t.start()
        self._threads.append(t)

    def _resolve(self, peer: int) -> socket.socket:
        with self._resolve_lock:
            sock = self._peers.get(peer)
            if sock is not None:
                return sock
            addr = self.rv.get(f"adapm/dcn/{peer}", 60_000)
            host, port = addr.rsplit(":", 1)
            sock = socket.create_connection((host, int(port)), timeout=60)
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._peers[peer] = sock
            self._send_locks[peer] = threading.Lock()
            self._pending_by_peer.setdefault(peer, set())
            t = threading.Thread(target=self._read_replies,
                                 args=(peer, sock), daemon=True,
                                 name=f"adapm-dcn-r{peer}")
            t.start()
            self._threads.append(t)
            return sock

    def _read_replies(self, peer: int, sock: socket.socket) -> None:
        """Demux loop: deliver each tagged reply to its waiting future."""
        try:
            while not self._stop.is_set():
                try:
                    frame = _recv_msg(sock)
                except Exception:  # noqa: BLE001 — a corrupt frame must
                    # still run the death-cleanup below, or every waiter
                    # hangs forever on an unresolved future
                    frame = None
                if frame is None:
                    return  # disconnect: cleanup in finally
                rid, reply = frame
                with self._pending_lock:
                    fut = self._pending.pop(rid, None)
                    self._pending_by_peer.get(peer, set()).discard(rid)
                if fut is not None:
                    fut.set_result(reply)
        finally:
            # disconnect. Remove the dead socket FIRST so new requests
            # re-resolve (a keepalive-restarted peer reconnects; a dead
            # one fails at connect), THEN fail everything still waiting —
            # any rid registered against the old socket after this drain
            # is caught by request()'s post-send liveness check.
            with self._resolve_lock:
                if self._peers.get(peer) is sock:
                    del self._peers[peer]
            with self._pending_lock:
                rids = self._pending_by_peer.pop(peer, set())
                futs = [self._pending.pop(r) for r in rids
                        if r in self._pending]
            for f in futs:
                if not f.done():
                    f.set_exception(
                        ConnectionError(f"peer {peer} closed the channel"))

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True, name="adapm-dcn-serve")
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        """Per-connection reader: requests fan out to the serve pool and
        replies return tagged + out-of-order as handlers finish."""
        send_lock = threading.Lock()

        def run(rid, msg):
            try:
                reply = self.handler(msg)
            except Exception as e:  # noqa: BLE001 - ship errors to requester
                reply = ("error", f"{type(e).__name__}: {e}")
            try:
                with send_lock:
                    _send_msg(conn, (rid, reply))
            except OSError:
                pass  # requester is gone; its future fails on disconnect

        while not self._stop.is_set():
            try:
                frame = _recv_msg(conn)
            except OSError:
                frame = None
            if frame is None:
                try:
                    conn.close()
                except OSError:
                    pass
                return
            rid, msg = frame
            with self._stats_lock:
                self.stats["msgs_in"] += 1
            self._serve_pool.submit(run, rid, msg)

    # -- requests ------------------------------------------------------------

    def request(self, peer: int, msg):
        """Synchronous round-trip to `peer`. Raises on remote error.
        Concurrent callers' requests to the same peer are in flight
        simultaneously (demuxed by request id)."""
        assert peer != self.pid, "use local ops, not a self-request"
        sock = self._resolve(peer)
        rid = next(self._rid)
        fut: Future = Future()
        with self._pending_lock:
            self._pending[rid] = fut
            self._pending_by_peer.setdefault(peer, set()).add(rid)
        data = pickle.dumps((rid, msg), protocol=5)
        try:
            with self._send_locks[peer]:
                sock.sendall(_LEN.pack(len(data)) + data)
            with self._stats_lock:
                self.stats["msgs_out"] += 1
                self.stats["bytes_out"] += _LEN.size + len(data)
        except OSError as e:
            with self._pending_lock:
                self._pending.pop(rid, None)
                self._pending_by_peer.get(peer, set()).discard(rid)
            raise ConnectionError(f"peer {peer} send failed: {e}") from e
        # liveness check closing the race with the reader's death: if the
        # reader drained pendings BEFORE this rid registered, nothing will
        # ever resolve the future — the reader removes the socket from
        # _peers before draining, so observing it gone (or replaced) here
        # means this rid may have been orphaned.
        if self._peers.get(peer) is not sock:
            with self._pending_lock:
                orphaned = self._pending.pop(rid, None)
                self._pending_by_peer.get(peer, set()).discard(rid)
            if orphaned is not None and not orphaned.done():
                raise ConnectionError(f"peer {peer} closed the channel")
        reply = fut.result()
        if isinstance(reply, tuple) and reply \
                and isinstance(reply[0], str) and reply[0] == "error":
            raise RuntimeError(f"peer {peer}: {reply[1]}")
        return reply

    def shutdown(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        # snapshot under the lock: closing a socket wakes its reader
        # thread, whose death-cleanup removes the peer from _peers —
        # iterating the live dict here would race that removal
        with self._resolve_lock:
            socks = list(self._peers.values())
            self._peers.clear()
        for sock in socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._serve_pool.shutdown(wait=False)
