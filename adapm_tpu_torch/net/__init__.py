"""NetPort transport plane (the JAX package's `net/`).

The PM's cross-process traffic — sync deltas, relocations, ownership
moves, serve forwards, and membership control — rides a narrow
`NetPort` carrying versioned, checksummed frames. Three backends:

  - `loopback.py` — in-process fabric: per-peer bounded FIFO queues
    drained on the executor's `net.<peer>` streams, so every multi-node
    path runs, storm-tests, and fault-drills in one process,
    bit-identically to a single-process shadow;
  - `socket.py` — the TCP backend: it adds sockets to the frame/demux
    machinery the base class owns;
  - the DCN channel (parallel/dcn.py), wrapped by `DcnNode` — the
    default for real multi-process launches.

`membership.py` adds elastic shard join/leave and dead-peer failover
(replica -> main promotion through `Server._topology_mutation`)."""
from .port import (NetPort, NetNode, DcnNode, NetError, NetDecodeError,
                   FrameTruncatedError, FrameChecksumError,
                   FrameVersionError, FrameSpliceError, FrameFamilyError,
                   NetTimeoutError, NetPeerDeadError,
                   FAMILY_SYNC, FAMILY_RELOC, FAMILY_OWNER, FAMILY_SERVE,
                   FAMILY_CTRL, WIRE_VERSION)
from .loopback import LoopbackFabric, LoopbackNode, LoopbackCluster
from .membership import Membership

__all__ = [
    "NetPort", "NetNode", "DcnNode", "NetError", "NetDecodeError",
    "FrameTruncatedError", "FrameChecksumError", "FrameVersionError",
    "FrameSpliceError", "FrameFamilyError", "NetTimeoutError",
    "NetPeerDeadError", "FAMILY_SYNC", "FAMILY_RELOC", "FAMILY_OWNER",
    "FAMILY_SERVE", "FAMILY_CTRL", "WIRE_VERSION", "LoopbackFabric",
    "LoopbackNode", "LoopbackCluster", "Membership",
]
