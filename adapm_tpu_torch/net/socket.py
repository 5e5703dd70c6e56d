"""TCP backend for the NetPort — one class by construction (the JAX
package's `net/socket.py`; a port node and a JAX node serve each other
through one rendezvous, since the frames are the same bytes).

`NetPort` (port.py) already owns the codec, rid demux, reply-error
propagation, at-most-once dedup, and accounting; `TcpNetPort` only adds
byte transport: a listener, lazily-connected per-peer sockets (peer
addresses rendezvoused through a pluggable key-value store — the
control plane's TCPStore in real launches, a dict in tests), and
reader threads that reassemble frames header-first with the SAME
`decode_header` the loopback and the corruption quartet exercise.

Every reader feeds `_on_frame`, which dispatches requests AND resolves
replies — so it does not matter which of the pair's two sockets a frame
arrives on, and the whole class stays under ~150 lines. Stream-level
decode errors (bad magic = lost framing) close the connection: unlike a
datagram fabric there is no way to resynchronize a spliced TCP stream,
and the peer's retransmit path re-establishes it."""
from __future__ import annotations

import socket
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

from .port import (HEADER_SIZE, NetDecodeError, NetPeerDeadError,
                   NetPort, decode_header)


class DictRendezvous:
    """In-process key-value rendezvous for tests: the store's
    set/blocking-get surface over a plain dict + condition."""

    def __init__(self):
        self._kv: Dict[str, str] = {}
        self._cond = threading.Condition()

    def set(self, key: str, value: str) -> None:
        with self._cond:
            self._kv[key] = value
            self._cond.notify_all()

    def get(self, key: str, timeout_ms: int = 60_000) -> str:
        with self._cond:
            ok = self._cond.wait_for(lambda: key in self._kv,
                                     timeout_ms * 1e-3)
            if not ok:
                raise TimeoutError(f"rendezvous key {key!r} never set")
            return self._kv[key]


class StoreRendezvous:
    """The real thing: the control plane's `torch.distributed.TCPStore`
    (parallel/control.py; the same store parallel/dcn.py rendezvouses
    through), behind the set / blocking-get surface, on a client
    connection of its own: a reply that needs a peer's address must not
    wait behind this process's barrier."""

    def __init__(self):
        self._st = None
        self._lock = threading.Lock()

    def _client(self):
        with self._lock:
            if self._st is None:
                from ..parallel import control
                self._st = control.new_client()
            return self._st

    def set(self, key: str, value: str) -> None:
        self._client().set(key, value)

    def get(self, key: str, timeout_ms: int = 60_000) -> str:
        import datetime
        st = self._client()
        st.wait([key], datetime.timedelta(milliseconds=timeout_ms))
        return st.get(key).decode()


def store_rendezvous():
    return StoreRendezvous()


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


class TcpNetPort(NetPort):
    """NetPort frames over TCP (see module docstring)."""

    def __init__(self, pid: int, num: int, handler: Callable,
                 rendezvous=store_rendezvous,
                 serve_threads: int = 4, timeout_s: float = 30.0,
                 ctrl_handler=None, kv_prefix: str = "adapm/net"):
        super().__init__(pid, num, handler, ctrl_handler=ctrl_handler)
        self.rv = rendezvous() if callable(rendezvous) else rendezvous
        self.timeout_s = float(timeout_s)
        self.kv_prefix = kv_prefix
        self._listener: Optional[socket.socket] = None
        self._peers: Dict[int, socket.socket] = {}
        self._send_locks: Dict[int, threading.Lock] = {}
        self._resolve_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, serve_threads),
            thread_name_prefix="adapm-net-h")
        self._stop = threading.Event()
        self._threads = []

    def request(self, peer, msg, timeout_s: Optional[float] = None,
                retries: int = 1):
        return super().request(
            peer, msg,
            timeout_s=self.timeout_s if timeout_s is None else timeout_s,
            retries=retries)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", 0))
        self._listener.listen(self.num)
        port = self._listener.getsockname()[1]
        self.rv.set(f"{self.kv_prefix}/{self.pid}",
                    f"{socket.gethostname()}:{port}")
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"adapm-net-accept{self.pid}")
        t.start()
        self._threads.append(t)

    def shutdown(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._resolve_lock:
            socks = list(self._peers.values())
            self._peers.clear()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        self._pool.shutdown(wait=False)

    # -- transport -----------------------------------------------------------

    def _send_bytes(self, dest: int, buf: bytes) -> None:
        try:
            sock, lock = self._resolve(dest)
            with lock:
                sock.sendall(buf)
        except (OSError, TimeoutError) as e:
            # drop the dead socket so a retransmit re-resolves (a
            # restarted peer re-rendezvouses; a dead one fails again)
            with self._resolve_lock:
                if self._peers.get(dest) is not None:
                    try:
                        self._peers.pop(dest).close()
                    except OSError:
                        pass
            raise NetPeerDeadError(
                f"send to peer {dest} failed: "
                f"{type(e).__name__}: {e}") from e

    def _resolve(self, peer: int):
        with self._resolve_lock:
            sock = self._peers.get(peer)
            if sock is not None:
                return sock, self._send_locks[peer]
            addr = self.rv.get(f"{self.kv_prefix}/{peer}",
                               int(self.timeout_s * 1e3))
            host, port = addr.rsplit(":", 1)
            sock = socket.create_connection((host, int(port)),
                                            timeout=self.timeout_s)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._peers[peer] = sock
            lock = self._send_locks[peer] = threading.Lock()
            t = threading.Thread(target=self._read_loop, args=(sock,),
                                 daemon=True,
                                 name=f"adapm-net-r{self.pid}.{peer}")
            t.start()
            self._threads.append(t)
            return sock, lock

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._read_loop, args=(conn,),
                                 daemon=True,
                                 name=f"adapm-net-s{self.pid}")
            t.start()
            self._threads.append(t)

    def _read_loop(self, sock: socket.socket) -> None:
        """Header-first frame reassembly; every frame — request or
        reply — goes through _on_frame on the serve pool."""
        while not self._stop.is_set():
            try:
                head = _recv_exact(sock, HEADER_SIZE)
                if head is None:
                    return
                try:
                    plen = decode_header(head)[4]
                except NetDecodeError:
                    # lost framing on a byte stream is unrecoverable:
                    # count + drop the connection (peer re-resolves)
                    self._acct(decode_errors=1, dropped_frames=1)
                    try:
                        sock.close()
                    except OSError:
                        pass
                    return
                body = _recv_exact(sock, plen)
                if body is None:
                    return
            except OSError:
                return
            self._pool.submit(self._dispatch, head + body)

    def _dispatch(self, buf: bytes) -> None:
        try:
            self._on_frame(buf)
        except NetDecodeError:
            self._acct(dropped_frames=1)
