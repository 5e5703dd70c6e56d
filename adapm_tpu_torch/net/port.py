"""The NetPort protocol: framed, checksummed PM wire messages (the JAX
package's `net/port.py`, pure standard library; frames are byte for byte
the JAX package's for the same message, so the two packages' nodes
decode each other's traffic).

One frame per message, fixed binary header + pickled payload:

    offset  size  field
    0       4     magic  b"APMN"
    4       2     wire version (u16; WIRE_VERSION)
    6       1     family (u8; FAMILY_*)
    7       1     flags  (u8; bit0 REPLY, bit1 POST — no reply expected)
    8       8     request id (u64; per-sender monotonic)
    16      4     sender rank (u32)
    20      4     payload length (u32)
    24      4     crc32 of payload (u32)
    28      ...   payload (pickle protocol 5)

Decode failures raise NAMED errors before any server mutation — the
corruption quartet (truncated / flipped byte / wrong version / spliced
frame) maps to FrameTruncatedError / FrameChecksumError /
FrameVersionError / FrameSpliceError, the integrity discipline of the
checkpoint chains and the workload traces.

The five wire families follow the reference van's message taxonomy
(PAPER.md L0/L1):

    FAMILY_SYNC   replica delta ship/unsubscribe ("sync", "unsub") —
                  deltas travel as the f32 rows _extract_deltas
                  reads from the delta pool
    FAMILY_RELOC  intent-driven relocation/replication with
                  residual-carrying value rows ("intent")
    FAMILY_OWNER  ownership/addressbook moves ("owner_update")
    FAMILY_SERVE  forwarded reads/writes ("pull", "push", "set")
    FAMILY_CTRL   membership + heartbeat control ("beat", "leave",
                  "join", net/membership.py)

`NetPort` is the base class owning the codec, the request-id demux
(pending-future table), reply-error propagation, the receiver-side
at-most-once dedup cache, and the msgs/bytes accounting — so a backend
(loopback fabric, TCP socket) only supplies byte transport. That is
what makes socket.py "one class by construction" (the DevicePort
recipe, applied to the network).

Payloads are numpy arrays and Python scalars, never torch tensors: a
device tensor must be read back to the host before its frame is
encoded."""
from __future__ import annotations

import pickle
import struct
import threading
import zlib
from collections import OrderedDict
from typing import Callable, Dict, Optional

WIRE_VERSION = 1
_MAGIC = b"APMN"
_HEADER = struct.Struct("!4sHBBQIII")
HEADER_SIZE = _HEADER.size  # 28

FAMILY_SYNC = 1
FAMILY_RELOC = 2
FAMILY_OWNER = 3
FAMILY_SERVE = 4
FAMILY_CTRL = 5
_FAMILIES = (FAMILY_SYNC, FAMILY_RELOC, FAMILY_OWNER, FAMILY_SERVE,
             FAMILY_CTRL)
FAMILY_NAMES = {FAMILY_SYNC: "sync", FAMILY_RELOC: "reloc",
                FAMILY_OWNER: "owner", FAMILY_SERVE: "serve",
                FAMILY_CTRL: "ctrl"}

FLAG_REPLY = 0x01
FLAG_POST = 0x02   # fire-and-forget (heartbeats): no reply is produced

# op string (msg[0]) -> wire family; replies reuse the request's family
_OP_FAMILY = {"sync": FAMILY_SYNC, "unsub": FAMILY_SYNC,
              "intent": FAMILY_RELOC,
              "owner_update": FAMILY_OWNER,
              "pull": FAMILY_SERVE, "push": FAMILY_SERVE,
              "set": FAMILY_SERVE,
              "beat": FAMILY_CTRL, "leave": FAMILY_CTRL,
              "join": FAMILY_CTRL}


# ---------------------------------------------------------------------------
# named errors
# ---------------------------------------------------------------------------


class NetError(RuntimeError):
    """Base class for every transport-plane failure."""


class NetDecodeError(NetError):
    """Base for frame-integrity failures: raised by decode_frame BEFORE
    the payload reaches any handler, so a corrupt frame can never
    mutate server state."""


class FrameTruncatedError(NetDecodeError):
    """Frame shorter than its header, or than the declared payload."""


class FrameChecksumError(NetDecodeError):
    """Payload crc32 does not match the header (flipped byte)."""


class FrameVersionError(NetDecodeError):
    """Wire version is not WIRE_VERSION (cross-version peer)."""


class FrameSpliceError(NetDecodeError):
    """Bad magic: the byte stream lost framing (spliced/misaligned)."""


class FrameFamilyError(NetDecodeError):
    """Unknown message family byte."""


class NetTimeoutError(NetError):
    """A request exhausted its timeout budget (including retransmits),
    or a fabric barrier timed out."""


class NetPeerDeadError(NetError):
    """The destination is known dead (killed, left, or declared dead by
    membership) — fail fast instead of burning the timeout."""


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


def encode_frame(family: int, rid: int, src: int, obj,
                 flags: int = 0) -> bytes:
    payload = pickle.dumps(obj, protocol=5)
    return _HEADER.pack(_MAGIC, WIRE_VERSION, family, flags, rid, src,
                        len(payload), zlib.crc32(payload)) + payload


def decode_header(buf: bytes):
    """(family, flags, rid, src, payload_len, crc) — validates magic /
    version / family / length, raising the named errors. Used by both
    decode_frame (whole-buffer backends) and the TCP stream reader
    (header-first reads)."""
    if len(buf) < HEADER_SIZE:
        raise FrameTruncatedError(
            f"frame header truncated: {len(buf)} < {HEADER_SIZE} bytes")
    magic, ver, family, flags, rid, src, plen, crc = \
        _HEADER.unpack_from(buf)
    if magic != _MAGIC:
        raise FrameSpliceError(
            f"bad frame magic {magic!r} (expected {_MAGIC!r}): "
            f"spliced or misaligned byte stream")
    if ver != WIRE_VERSION:
        raise FrameVersionError(
            f"wire version {ver} != {WIRE_VERSION}")
    if family not in _FAMILIES:
        raise FrameFamilyError(f"unknown message family {family}")
    return family, flags, rid, src, plen, crc


def decode_frame(buf: bytes):
    """(family, flags, rid, src, obj) or a named NetDecodeError."""
    family, flags, rid, src, plen, crc = decode_header(buf)
    if len(buf) != HEADER_SIZE + plen:
        raise FrameTruncatedError(
            f"frame payload truncated: have {len(buf) - HEADER_SIZE} "
            f"of {plen} declared bytes")
    payload = buf[HEADER_SIZE:]
    if zlib.crc32(payload) != crc:
        raise FrameChecksumError(
            f"payload crc mismatch (family="
            f"{FAMILY_NAMES.get(family, family)}, rid={rid})")
    return family, flags, rid, src, pickle.loads(payload)


def family_for_msg(msg) -> int:
    """Wire family for a PM op tuple; unknown ops ride FAMILY_SERVE."""
    if isinstance(msg, tuple) and msg and isinstance(msg[0], str):
        return _OP_FAMILY.get(msg[0], FAMILY_SERVE)
    return FAMILY_SERVE


# ---------------------------------------------------------------------------
# the port base class
# ---------------------------------------------------------------------------


class _Pending:
    __slots__ = ("event", "reply", "error", "peer")

    def __init__(self, peer: int = -1):
        self.event = threading.Event()
        self.reply = None
        self.error: Optional[BaseException] = None
        self.peer = peer


class NetPort:
    """Request/reply demux + at-most-once execution over any byte
    transport. Subclasses implement `_send_bytes(dest, buf)` and feed
    received buffers to `_on_frame(buf)`; everything else — rid
    allocation, pending futures, reply-error propagation, the
    receiver-side rid dedup cache (pushes are additive, NOT idempotent:
    a retransmitted request must re-send the cached reply, never
    re-execute), and msgs/bytes accounting — lives here."""

    DEDUP_CACHE = 4096

    def __init__(self, pid: int, num: int,
                 handler: Callable[[object], object],
                 ctrl_handler: Optional[Callable[[int, object], None]]
                 = None):
        self.pid = int(pid)
        self.num = int(num)
        self.handler = handler
        # CTRL frames (membership/heartbeat) bypass the PM handler
        self.ctrl_handler = ctrl_handler
        self._rid_lock = threading.Lock()
        self._rid = 0
        self._pending: Dict[int, _Pending] = {}
        self._pending_lock = threading.Lock()
        # (src, rid) -> encoded reply bytes; OrderedDict as bounded LRU
        self._served: "OrderedDict[tuple, bytes]" = OrderedDict()
        self._served_lock = threading.Lock()
        # accounting (plain ints under one lock: the snapshot-side
        # NetPlane reads them; no registry names unless a plane exists)
        self._stats_lock = threading.Lock()
        self.stats = {"msgs_out": 0, "msgs_in": 0,
                      "bytes_out": 0, "bytes_in": 0,
                      "replies_out": 0, "retransmits": 0,
                      "dup_suppressed": 0, "decode_errors": 0,
                      "dropped_frames": 0}
        for name in FAMILY_NAMES.values():
            self.stats[f"msgs_{name}"] = 0

    # -- subclass surface ----------------------------------------------------

    def _send_bytes(self, dest: int, buf: bytes) -> None:
        raise NotImplementedError

    def start(self) -> None:  # lifecycle parity with DcnChannel
        pass

    def shutdown(self) -> None:
        pass

    # -- accounting ----------------------------------------------------------

    def _acct(self, **deltas) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self.stats[k] += v

    # -- requests ------------------------------------------------------------

    def _next_rid(self) -> int:
        with self._rid_lock:
            self._rid += 1
            return self._rid

    def request(self, peer: int, msg, timeout_s: float = 30.0,
                retries: int = 0):
        """Synchronous round-trip. Raises RuntimeError on remote error
        (DcnChannel parity), NetTimeoutError when the budget (timeout
        per attempt x (retries + 1)) is exhausted, NetPeerDeadError
        when the backend knows the peer is gone. Retransmits reuse the
        SAME rid, so the receiver's dedup cache guarantees at-most-once
        execution under duplicate delivery."""
        assert peer != self.pid, "use local ops, not a self-request"
        rid = self._next_rid()
        family = family_for_msg(msg)
        buf = encode_frame(family, rid, self.pid, msg)
        pend = _Pending(peer)
        with self._pending_lock:
            self._pending[rid] = pend
        try:
            attempt = 0
            while True:
                self._send_bytes(peer, buf)
                self._acct(msgs_out=1, bytes_out=len(buf),
                           **{f"msgs_{FAMILY_NAMES[family]}": 1})
                if pend.event.wait(timeout_s):
                    break
                attempt += 1
                if attempt > retries:
                    raise NetTimeoutError(
                        f"no reply from peer {peer} for "
                        f"{FAMILY_NAMES[family]} rid={rid} after "
                        f"{attempt} attempt(s) x {timeout_s:g}s")
                self._acct(retransmits=1)
        finally:
            with self._pending_lock:
                self._pending.pop(rid, None)
        if pend.error is not None:
            raise pend.error
        reply = pend.reply
        if isinstance(reply, tuple) and reply \
                and isinstance(reply[0], str) and reply[0] == "error":
            raise RuntimeError(f"peer {peer}: {reply[1]}")
        return reply

    def post(self, peer: int, msg) -> None:
        """Fire-and-forget (heartbeats/membership control): no pending
        entry, no reply, loss is acceptable by design."""
        family = family_for_msg(msg)
        buf = encode_frame(family, self._next_rid(), self.pid, msg,
                           flags=FLAG_POST)
        self._send_bytes(peer, buf)
        self._acct(msgs_out=1, bytes_out=len(buf),
                   **{f"msgs_{FAMILY_NAMES[family]}": 1})

    def fail_pending_to(self, peer: int, err: BaseException) -> None:
        """Fail every request currently awaiting `peer` (dead-peer
        cleanup: the requester raises the named error instead of
        burning its full timeout budget)."""
        with self._pending_lock:
            pend = [p for p in self._pending.values() if p.peer == peer]
        for p in pend:
            if not p.event.is_set():
                p.error = err
                p.event.set()

    # -- receive path --------------------------------------------------------

    def _on_frame(self, buf: bytes) -> None:
        """Decode + dispatch one received frame. Decode errors are
        COUNTED and re-raised to the backend (which drops the frame —
        the named error surfaces to tests via decode_frame directly,
        and a production backend logs it); they can never reach the
        handler, so no server mutation happens on a corrupt frame."""
        try:
            family, flags, rid, src, obj = decode_frame(buf)
        except NetDecodeError:
            self._acct(decode_errors=1)
            raise
        self._acct(msgs_in=1, bytes_in=len(buf))
        if flags & FLAG_REPLY:
            with self._pending_lock:
                pend = self._pending.get(rid)
            if pend is not None and not pend.event.is_set():
                pend.reply = obj
                pend.event.set()
            return
        if family == FAMILY_CTRL and self.ctrl_handler is not None:
            self.ctrl_handler(src, obj)
            return
        if flags & FLAG_POST:
            # fire-and-forget for a non-ctrl family: execute, no reply
            self.handler(obj)
            return
        key = (src, rid)
        with self._served_lock:
            cached = self._served.get(key)
            if cached is not None:
                self._served.move_to_end(key)
        if cached is not None:
            # duplicate delivery (retransmit or net.dup): at-most-once
            # execution — re-send the cached reply, never re-run the
            # handler (pushes are additive; double-apply corrupts)
            self._acct(dup_suppressed=1)
            self._send_reply_bytes(src, cached)
            return
        try:
            reply = self.handler(obj)
        except Exception as e:  # noqa: BLE001 — ship errors to requester
            reply = ("error", f"{type(e).__name__}: {e}")
        out = encode_frame(family, rid, self.pid, reply,
                           flags=FLAG_REPLY)
        with self._served_lock:
            self._served[key] = out
            while len(self._served) > self.DEDUP_CACHE:
                self._served.popitem(last=False)
        self._send_reply_bytes(src, out)

    def _send_reply_bytes(self, dest: int, buf: bytes) -> None:
        try:
            self._send_bytes(dest, buf)
            self._acct(replies_out=1, bytes_out=len(buf))
        except NetError:
            # requester is gone/partitioned: it will retransmit or fail
            # on its own timeout; the reply stays in the dedup cache
            self._acct(dropped_frames=1)

    def stats_snapshot(self) -> Dict[str, int]:
        with self._stats_lock:
            return dict(self.stats)


# ---------------------------------------------------------------------------
# node abstraction: what GlobalPM/Server need from "the cluster"
# ---------------------------------------------------------------------------


class NetNode:
    """The narrow surface GlobalPM and Server consume: identity, a
    request channel, barriers, liveness. Implementations: DcnNode (the
    real multi-process default — the TCPStore control plane + the DCN
    data channel), LoopbackNode (in-process fabric), and a TCP flavor of
    DcnNode (--sys.net.backend tcp)."""

    kind = "abstract"
    pid: int
    num_procs: int

    def make_channel(self, handler, serve_threads: int):
        raise NotImplementedError

    def barrier(self, name: Optional[str] = None) -> None:
        raise NotImplementedError

    def dead_peers(self, max_age_s: float = 10.0) -> list:
        return []

    def start_heartbeat(self, interval_s: float) -> None:
        pass

    def stop_heartbeat(self) -> None:
        pass

    def pre_down(self) -> None:
        """Called at the top of GlobalPM.shutdown, before the pm-pre-
        down barrier: announce a graceful leave so peers never mistake
        this teardown for a death (loopback membership)."""

    def net_plane(self):
        """The NetPlane stats surface (snapshot `net` section), or None
        for the legacy DCN backend (its accounting lives in `pm`)."""
        return None


class DcnNode(NetNode):
    """Default multi-process node: identity + barriers from the TCPStore
    control plane (parallel/control.py), data plane from DcnChannel —
    or, with `--sys.net.backend tcp`, from the TcpNetPort speaking
    NetPort frames over the same store's rendezvous."""

    kind = "dcn"

    def __init__(self, opts=None):
        from ..parallel import control
        self.pid = control.process_id()
        self.num_procs = control.num_processes()
        self.opts = opts
        self._chan = None

    def make_channel(self, handler, serve_threads: int):
        backend = getattr(self.opts, "net_backend", "auto") \
            if self.opts is not None else "auto"
        if backend == "tcp":
            from .socket import TcpNetPort, store_rendezvous
            self._chan = TcpNetPort(
                self.pid, self.num_procs, handler,
                rendezvous=store_rendezvous,
                serve_threads=serve_threads,
                timeout_s=(getattr(self.opts, "net_timeout_ms", 30_000.0)
                           * 1e-3))
        else:
            from ..parallel.dcn import DcnChannel
            self._chan = DcnChannel(self.pid, self.num_procs, handler,
                                    serve_threads=serve_threads)
        return self._chan

    def barrier(self, name: Optional[str] = None) -> None:
        from ..parallel import control
        if name is None:
            control.barrier()
        else:
            control.barrier(name)

    def dead_peers(self, max_age_s: float = 10.0) -> list:
        from ..parallel import control
        return control.dead_processes(max_age_s)

    def start_heartbeat(self, interval_s: float) -> None:
        from ..parallel import control
        control.start_heartbeat(interval_s)

    def stop_heartbeat(self) -> None:
        from ..parallel import control
        control.stop_heartbeat()
