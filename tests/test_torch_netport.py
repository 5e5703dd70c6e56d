"""The port's NetPort transport plane (adapm_tpu_torch/net), twin of
tests/test_netport.py, plus cross-package cases against adapm_tpu/net.

Four layers, mirroring docs/NETWORK.md:
  - frame codec: round trips + the corruption quartet (truncated /
    flipped byte / wrong version / spliced), each raising its NAMED
    error BEFORE any handler/server mutation;
  - port semantics: request/reply demux, error-tuple propagation
    (DcnChannel parity), at-most-once execution under duplicate
    delivery, dead-peer fast-fail;
  - TCP backend: a real socket pair in-process through DictRendezvous;
  - loopback cluster: the mp matrix in-container — cross-node
    pull/push/set, intent relocation/replication, eventual consistency,
    the seeded fault storm bit-identical to a NumPy shadow, and the
    dead-peer kill -> replica-promotion failover drill.

Cross-package: (a) frames are byte-identical and each package decodes
the other's; (b) a JAX TcpNetPort and a port TcpNetPort serve each other
through one DictRendezvous; (c) one seeded integer-push loopback
scenario reads bitwise equal in both packages and to a NumPy shadow;
(d) with one intending worker the owner and replica maps agree across
packages after wait_sync. The port's loopback nodes run 8 shards each on
the CPU, as the JAX nodes run on the 8-device test mesh.
"""
import threading
import time

import numpy as np
import pytest

import adapm_tpu_torch
from adapm_tpu_torch.config import SystemOptions
from adapm_tpu_torch.net import (FAMILY_CTRL, FAMILY_OWNER, FAMILY_RELOC,
                                 FAMILY_SERVE, FAMILY_SYNC,
                                 FrameChecksumError, FrameFamilyError,
                                 FrameSpliceError, FrameTruncatedError,
                                 FrameVersionError, LoopbackCluster,
                                 NetPeerDeadError, NetTimeoutError,
                                 WIRE_VERSION)
from adapm_tpu_torch.net.port import (HEADER_SIZE, NetPort, decode_frame,
                                      encode_frame, family_for_msg)

SHARDS = 8  # per node: the JAX package's nodes run on the 8-device mesh


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


def test_frame_round_trip_all_families():
    payloads = [
        (FAMILY_SYNC, ("sync", np.arange(8), b"compressed-bytes")),
        (FAMILY_RELOC, ("intent", np.arange(4, dtype=np.int64), 7, 1)),
        (FAMILY_SERVE, ("pull", np.array([1, 2, 3]))),
        (FAMILY_CTRL, ("beat", 0)),
    ]
    for fam, obj in payloads:
        buf = encode_frame(fam, rid=42, src=3, obj=obj)
        f2, flags, rid, src, obj2 = decode_frame(buf)
        assert (f2, flags, rid, src) == (fam, 0, 42, 3)
        assert obj2[0] == obj[0]
        np.testing.assert_array_equal(np.asarray(obj2[1]),
                                      np.asarray(obj[1]))


def test_family_for_msg_op_map():
    assert family_for_msg(("sync", 1)) == FAMILY_SYNC
    assert family_for_msg(("unsub", 1)) == FAMILY_SYNC
    assert family_for_msg(("intent", 1)) == FAMILY_RELOC
    assert family_for_msg(("pull", 1)) == FAMILY_SERVE
    assert family_for_msg(("beat", 1)) == FAMILY_CTRL
    assert family_for_msg(("unknown-op", 1)) == FAMILY_SERVE
    assert family_for_msg("not-a-tuple") == FAMILY_SERVE


def test_corruption_quartet_named_errors():
    """Truncated / flipped byte / wrong version / spliced each raise
    their NAMED decode error (the checkpoint and trace integrity
    discipline)."""
    buf = encode_frame(FAMILY_SERVE, rid=7, src=0,
                       obj=("pull", np.arange(16)))
    # 1. truncated: short header AND short payload both named
    with pytest.raises(FrameTruncatedError):
        decode_frame(buf[: HEADER_SIZE - 4])
    with pytest.raises(FrameTruncatedError):
        decode_frame(buf[:-3])
    # 2. flipped payload byte -> checksum
    flipped = bytearray(buf)
    flipped[HEADER_SIZE + 5] ^= 0xFF
    with pytest.raises(FrameChecksumError):
        decode_frame(bytes(flipped))
    # 3. wrong wire version
    vbuf = bytearray(buf)
    vbuf[4:6] = (WIRE_VERSION + 1).to_bytes(2, "big")
    with pytest.raises(FrameVersionError):
        decode_frame(bytes(vbuf))
    # 4. spliced/misaligned stream -> bad magic
    with pytest.raises(FrameSpliceError):
        decode_frame(b"XXXX" + buf[4:])
    # bonus: unknown family byte
    fbuf = bytearray(buf)
    fbuf[6] = 99
    with pytest.raises(FrameFamilyError):
        decode_frame(bytes(fbuf))


# ---------------------------------------------------------------------------
# port semantics (in-memory pair: _send_bytes wired directly)
# ---------------------------------------------------------------------------


class _PairPort(NetPort):
    """Minimal transport: frames go straight to the peer's _on_frame
    on the sender's thread (or are captured for replay tests)."""

    def __init__(self, pid, handler):
        super().__init__(pid, 2, handler)
        self.peer_port = None
        self.sent = []  # captured (dest, buf) for duplicate-replay

    def _send_bytes(self, dest, buf):
        self.sent.append((dest, buf))
        self.peer_port._on_frame(buf)


def _make_pair(handler_b):
    a = _PairPort(0, lambda msg: ("ok-from-a", msg))
    b = _PairPort(1, handler_b)
    a.peer_port, b.peer_port = b, a
    return a, b


def test_request_reply_and_error_tuple():
    a, b = _make_pair(lambda msg: ("served", msg[0]))
    assert a.request(1, ("pull", 1), timeout_s=5.0) == ("served", "pull")

    def boom(msg):
        raise KeyError("nope")
    a2, b2 = _make_pair(boom)
    with pytest.raises(RuntimeError, match="peer 1: KeyError"):
        a2.request(1, ("pull", 1), timeout_s=5.0)


def test_at_most_once_duplicate_suppressed():
    """A duplicated request frame must NOT re-execute the handler
    (pushes are additive): the cached reply is re-sent instead."""
    calls = []

    def handler(msg):
        calls.append(msg)
        return ("applied", len(calls))

    a, b = _make_pair(handler)
    assert a.request(1, ("push", 5), timeout_s=5.0) == ("applied", 1)
    # replay the exact request frame (retransmit / net.dup delivery)
    req = next(buf for d, buf in a.sent if d == 1)
    b._on_frame(req)
    assert len(calls) == 1, "duplicate delivery re-executed the handler"
    assert b.stats["dup_suppressed"] == 1


def test_decode_error_counted_never_reaches_handler():
    calls = []
    a, b = _make_pair(lambda msg: calls.append(msg) or "ok")
    buf = encode_frame(FAMILY_SERVE, rid=1, src=0, obj=("push", 1))
    bad = bytearray(buf)
    bad[HEADER_SIZE] ^= 0xFF
    with pytest.raises(FrameChecksumError):
        b._on_frame(bytes(bad))
    assert calls == [] and b.stats["decode_errors"] == 1


def test_timeout_and_dead_peer_fastfail():
    class _BlackHole(NetPort):
        def _send_bytes(self, dest, buf):
            pass  # the wire eats everything

    p = _BlackHole(0, 2, lambda m: m)
    t0 = time.monotonic()
    with pytest.raises(NetTimeoutError):
        p.request(1, ("pull", 1), timeout_s=0.05, retries=2)
    assert time.monotonic() - t0 < 5.0
    assert p.stats["retransmits"] == 2

    # fail_pending_to releases only the named peer's waiters
    p2 = _BlackHole(0, 3, lambda m: m)
    errs = {}

    def waiter(peer):
        try:
            p2.request(peer, ("pull", 1), timeout_s=30.0)
        except Exception as e:  # noqa: BLE001 — recorded for asserts
            errs[peer] = e

    ts = [threading.Thread(target=waiter, args=(pr,)) for pr in (1, 2)]
    for t in ts:
        t.start()
    time.sleep(0.1)
    p2.fail_pending_to(1, NetPeerDeadError("peer 1 gone"))
    ts[0].join(5.0)
    assert isinstance(errs.get(1), NetPeerDeadError)
    assert 2 not in errs, "peer 2's pending request was wrongly failed"
    p2.fail_pending_to(2, NetPeerDeadError("peer 2 gone"))
    ts[1].join(5.0)
    assert isinstance(errs.get(2), NetPeerDeadError)


# ---------------------------------------------------------------------------
# TCP backend (real sockets, in-process rendezvous)
# ---------------------------------------------------------------------------


def _eventually(pred, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


def test_tcp_port_pair_round_trip():
    from adapm_tpu_torch.net.socket import DictRendezvous, TcpNetPort
    rv = DictRendezvous()
    a = TcpNetPort(0, 2, lambda m: ("a-serves", m[0]), rendezvous=rv,
                   timeout_s=10.0)
    b = TcpNetPort(1, 2, lambda m: ("b-serves", m[0]), rendezvous=rv,
                   timeout_s=10.0)
    a.start()
    b.start()
    try:
        assert a.request(1, ("pull", np.arange(4))) == \
            ("b-serves", "pull")
        assert b.request(0, ("push", 1)) == ("a-serves", "push")
        # big numpy payload survives framing
        big = np.random.default_rng(0).random((256, 32)).astype(
            np.float32)
        reply = a.request(1, ("set", big))
        assert reply == ("b-serves", "set")
        # a reply is counted just after its bytes go out: the requester
        # may return before the server's thread has counted it
        assert a.stats["msgs_out"] >= 2 and _eventually(
            lambda: b.stats["replies_out"] >= 2)
    finally:
        a.shutdown()
        b.shutdown()


# ---------------------------------------------------------------------------
# loopback cluster: the mp matrix in-container
# ---------------------------------------------------------------------------


def _opts(**kw):
    return SystemOptions(sync_max_per_sec=0, prefetch=False, **kw)


def _cluster(world=2, num_keys=64, L=4, fault_spec="", **kw):
    def factory(rank):
        return _opts(fault_spec=fault_spec)
    return LoopbackCluster(world, num_keys=num_keys, value_lengths=L,
                           opts_factory=factory, num_shards=SHARDS,
                           device="cpu", **kw)


def test_loopback_cluster_pull_push_set():
    """scenario_pullpush rerouted through the loopback backend: the 7-
    seed mp matrix's core value checks run fully in-container."""
    cl = _cluster()
    try:
        base = np.tile(np.arange(64, dtype=np.float32)[:, None], (1, 4))

        def scenario(rank, srv):
            w = srv.make_worker(0)
            keys = np.arange(64, dtype=np.int64)
            if rank == 0:
                w.wait(w.set(keys, base))
            srv.barrier()
            v = w.pull_sync(keys)
            assert np.array_equal(v, base), "pull after set"
            w.wait(w.push(keys, np.ones((64, 4), np.float32)))
            srv.barrier()
            return w.pull_sync(keys)

        outs = cl.run(scenario)
        for rank, v in enumerate(outs):
            assert np.array_equal(v, base + 2.0), f"rank {rank}"
        s = cl.servers[0].net.stats()
        assert s["msgs_serve"] > 0 and s["decode_errors"] == 0
        assert s["peers_live"] == 2
    finally:
        cl.shutdown()


def test_loopback_intent_relocation_and_eventual_consistency():
    """Intent moves/replicates keys across loopback nodes; push+revert
    restores the exact base after the quiesce protocol."""
    from adapm_tpu_torch.base import CLOCK_MAX
    cl = _cluster()
    try:
        base = np.tile(np.arange(64, dtype=np.float32)[:, None], (1, 4))

        def scenario(rank, srv):
            w = srv.make_worker(0)
            keys = np.arange(64, dtype=np.int64)
            if rank == 0:
                w.wait(w.set(keys, base))
            srv.barrier()
            if rank == 1:
                w.intent(keys, 0, CLOCK_MAX)
                srv.wait_sync()
                moved = (srv.ab.owner[keys] >= 0) | \
                    (srv.ab.cache_slot[:, keys] >= 0).any(axis=0)
                assert moved.any(), "intent moved/replicated nothing"
            srv.barrier()
            x = np.full((64, 4), 3.0, np.float32)
            w.wait(w.push(keys, x))
            w.wait(w.push(keys, -x))
            # quiesce: WaitSync -> Barrier -> WaitSync
            srv.wait_sync()
            srv.barrier()
            srv.wait_sync()
            srv.barrier()
            return w.pull_sync(keys)

        outs = cl.run(scenario)
        for rank, v in enumerate(outs):
            assert np.array_equal(v, base), \
                f"rank {rank} not restored to base"
    finally:
        cl.shutdown()


def test_loopback_storm_bit_identical_under_faults():
    """Seeded integer-push storm under injected drop/dup/delay: every
    post-quiesce read bit-identical to a NumPy shadow. Exercises the
    retransmit + at-most-once machinery for real (dropped frames MUST
    be retransmitted, duplicated frames MUST NOT double-apply)."""
    K, L, ROUNDS = 48, 4, 6
    cl = _cluster(
        num_keys=K, L=L,
        fault_spec="net.send=0.08,net.recv=0.08,net.dup=0.1,"
                   "net.delay=0.02,net.partition=0.02")
    try:
        shadow = np.zeros((K, L), np.float64)
        # integer-valued pushes: fp addition on the integer grid is
        # exact and order-independent, so shadow == device bitwise
        per_rank = []
        for rank in range(2):
            rng = np.random.default_rng(1000 + rank)
            rounds = []
            for r in range(ROUNDS):
                keys = np.sort(rng.choice(K, size=8, replace=False))
                vals = rng.integers(-8, 9, size=(8, L)).astype(
                    np.float32)
                rounds.append((keys.astype(np.int64), vals))
                shadow[keys] += vals
            per_rank.append(rounds)

        def scenario(rank, srv):
            w = srv.make_worker(0)
            allk = np.arange(K, dtype=np.int64)
            if rank == 0:
                w.wait(w.set(allk, np.zeros((K, L), np.float32)))
            srv.barrier()
            for r in range(ROUNDS):
                keys, vals = per_rank[rank][r]
                w.wait(w.push(keys, vals))
                srv.wait_sync()
                srv.barrier()
                srv.wait_sync()
                srv.barrier()
            return w.pull_sync(allk)

        outs = cl.run(scenario)
        expect = shadow.astype(np.float32)
        for rank, v in enumerate(outs):
            np.testing.assert_array_equal(
                v, expect, err_msg=f"rank {rank} diverged from shadow")
        s = cl.servers[0].net.stats()
        # the storm must actually have exercised the machinery
        fired = sum(cl.servers[i].fault.counts(p)[1]
                    for i in range(2)
                    for p in ("net.send", "net.recv", "net.dup"))
        assert fired > 0, "no wire faults fired — storm proved nothing"
        assert s["decode_errors"] == 0
    finally:
        cl.shutdown()


def test_loopback_dead_peer_failover_promotes_replicas():
    """Kill one node: the survivor's membership plane detects the death
    by beat staleness, promotes its replicas of dead-owned keys to
    mains via GlobalPM.failover_dead_peer, serves them correctly, and
    records a bounded failover_s; dead-owned keys WITHOUT a replica
    are counted lost and fail fast."""
    from adapm_tpu_torch.base import CLOCK_MAX
    cl = _cluster(heartbeat_ms=40.0)
    try:
        base = np.tile(np.arange(64, dtype=np.float32)[:, None], (1, 4))

        def prep(rank, srv):
            w = srv.make_worker(0)
            keys = np.arange(64, dtype=np.int64)
            if rank == 0:
                w.wait(w.set(keys, base))
            srv.barrier()
            # COMPETING intents replicate (an uncontended exclusive
            # intent would relocate instead): rank 1 claims its own
            # homed keys first, then rank 0 claims the same keys —
            # rank 1 keeps ownership, rank 0 gets replica rows
            theirs = keys[srv.glob.home_proc(keys) == 1]
            if rank == 1:
                w.intent(theirs, 0, CLOCK_MAX)
                srv.wait_sync()
            srv.barrier()
            if rank == 0:
                w.intent(theirs, 0, CLOCK_MAX)
                srv.wait_sync()
            srv.barrier()

        cl.run(prep)
        srv0 = cl.servers[0]
        keys = np.arange(64, dtype=np.int64)
        theirs = keys[srv0.glob.home_proc(keys) == 1]
        covered = theirs[
            (srv0.ab.cache_slot[:, theirs] >= 0).any(axis=0)
            & (srv0.ab.owner[theirs] < 0)]
        assert len(covered) > 0, "prep installed no replicas"

        cl.kill(1)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and \
                srv0.net.stats()["failovers"] == 0:
            time.sleep(0.02)
        s = srv0.net.stats()
        assert s["failovers"] == 1, "death never detected/failed-over"
        assert s["peers_dead"] == 1 and s["peers_live"] == 1
        assert s["promoted_keys"] > 0
        assert 0.0 < s["failover_s"] < 10.0
        assert srv0.dead_nodes() == [1]

        # the survivor serves every covered (non-lost) key correctly
        w = srv0.make_worker(0)
        v = w.pull_sync(covered)
        assert np.array_equal(v, base[covered])
        # readiness reflects the failover action, not bare detection
        rep = srv0.net.stats()
        assert rep["lost_keys"] + rep["promoted_keys"] >= len(theirs)
        cl.shutdown(ranks=[0])
    finally:
        pass


def test_loopback_net_section_and_metrics_names():
    """The snapshot `net` section and net.* registry
    names exist on loopback servers — and a single-process server has
    NEITHER (the plane is off by default)."""
    cl = _cluster()
    try:
        srv = cl.servers[0]
        assert srv.net is not None
        snap = srv.metrics_snapshot()
        assert snap["schema_version"] == 3
        net = snap["net"]
        assert net["peers_total"] == 2 and net["backend"] == "loopback"
        for k in ("msgs_out", "bytes_out", "retransmits",
                  "dup_suppressed", "decode_errors", "failovers",
                  "failover_s", "lost_keys"):
            assert k in net, f"net section missing {k}"
        names = [m for m in srv.obs.names() if m.startswith("net.")]
        assert "net.msgs_out" in names and "net.peers_live" in names
        pm = snap["pm"]
        assert len(pm["hops"]) == 3 and "relocations_out" in pm
    finally:
        cl.shutdown()


def test_single_process_server_has_no_net_plane():
    srv = adapm_tpu_torch.setup(32, 4, opts=_opts(), num_workers=2,
                                device="cpu")
    try:
        assert srv.net is None and srv.glob is None
        snap = srv.metrics_snapshot()
        assert snap["net"] == {} and snap["pm"] == {}
        assert not [m for m in srv.obs.names()
                    if m.startswith("net.")]
    finally:
        srv.shutdown()


def test_collective_sync_rejected_on_loopback():
    """Collective mode needs the dcn backend: on the loopback fabric the
    port raises the JAX package's ValueError before any node is built,
    and with the mode off the GlobalPM's collective entry points refuse
    as the JAX package's do."""
    with pytest.raises(ValueError, match="collective_sync"):
        LoopbackCluster(
            2, num_keys=32, value_lengths=4, device="cpu",
            opts_factory=lambda r: _opts(collective_sync=True))
    cl = _cluster(num_keys=32)
    try:
        g = cl.servers[0].glob
        assert g.coll is None
        for call in (lambda: g.collective_pull(np.arange(2)),
                     lambda: g.collective_push(np.arange(2),
                                               np.zeros(8, np.float32)),
                     lambda: g.collective_sync(np.arange(2),
                                               np.zeros(2, np.int32))):
            with pytest.raises(AssertionError, match="collective_sync"):
                call()
    finally:
        cl.shutdown()


# ---------------------------------------------------------------------------
# cross-package
# ---------------------------------------------------------------------------


def _msgs():
    rng = np.random.default_rng(5)
    return [
        ("sync", np.arange(8, dtype=np.int64),
         rng.random(32).astype(np.float32), 1),
        ("unsub", np.arange(3, dtype=np.int64), np.zeros(12, np.float32),
         0),
        ("intent", np.arange(4, dtype=np.int64), 7, 1),
        ("owner_update", np.arange(2, dtype=np.int64), 1,
         np.array([3, 4], np.int32)),
        ("pull", np.array([1, 2, 3], np.int64)),
        ("push", np.array([5], np.int64), np.ones(4, np.float32)),
        ("beat", 0),
        ("leave", 1),
        (np.ones(3, np.uint8), np.zeros(3, np.float32),
         np.array([0, 1, -1], np.int32)),  # a reply tuple
    ]


def test_frames_byte_identical_across_packages():
    """(a) Every family's frame is the same bytes in both packages, and
    each package decodes the other's."""
    from adapm_tpu.net import port as jport
    fams = set()
    for i, msg in enumerate(_msgs()):
        for flags in (0, 1, 2):
            fam = family_for_msg(msg)
            assert fam == jport.family_for_msg(msg)
            fams.add(fam)
            mine = encode_frame(fam, rid=100 + i, src=i % 3, obj=msg,
                                flags=flags)
            theirs = jport.encode_frame(fam, rid=100 + i, src=i % 3,
                                        obj=msg, flags=flags)
            assert mine == theirs, f"frame bytes differ for {msg[0]!r}"
            for dec, buf in ((decode_frame, theirs),
                             (jport.decode_frame, mine)):
                f2, fl2, rid, src, obj = dec(buf)
                assert (f2, fl2, rid, src) == (fam, flags, 100 + i, i % 3)
                assert pickle_equal(obj, msg)
    assert fams == {FAMILY_SYNC, FAMILY_RELOC, FAMILY_OWNER, FAMILY_SERVE,
                    FAMILY_CTRL}
    # the named errors are raised by both decoders on the same corruption
    buf = encode_frame(FAMILY_SERVE, rid=7, src=0, obj=("pull", 1))
    bad = bytearray(buf)
    bad[HEADER_SIZE + 2] ^= 0xFF
    with pytest.raises(FrameChecksumError):
        decode_frame(bytes(bad))
    with pytest.raises(jport.FrameChecksumError):
        jport.decode_frame(bytes(bad))


def pickle_equal(a, b) -> bool:
    import pickle
    return pickle.dumps(a, protocol=5) == pickle.dumps(b, protocol=5)


def test_tcp_ports_serve_across_packages():
    """(b) A JAX TcpNetPort and a port TcpNetPort serve each other's
    requests through one DictRendezvous."""
    from adapm_tpu.net.socket import TcpNetPort as JaxTcp
    from adapm_tpu_torch.net.socket import DictRendezvous, TcpNetPort
    rv = DictRendezvous()
    a = TcpNetPort(0, 2, lambda m: ("port-serves", m[0], m[1] * 2),
                   rendezvous=rv, timeout_s=10.0)
    b = JaxTcp(1, 2, lambda m: ("jax-serves", m[0], m[1] + 1),
               rendezvous=rv, timeout_s=10.0)
    a.start()
    b.start()
    try:
        big = np.random.default_rng(1).random((64, 16)).astype(np.float32)
        r = a.request(1, ("push", big))
        assert r[:2] == ("jax-serves", "push")
        np.testing.assert_array_equal(r[2], big + 1)
        r = b.request(0, ("pull", np.arange(5)))
        assert r[:2] == ("port-serves", "pull")
        np.testing.assert_array_equal(r[2], np.arange(5) * 2)
        assert _eventually(lambda: a.stats["replies_out"] >= 1
                           and b.stats["replies_out"] >= 1)
        assert a.stats["decode_errors"] == 0 == b.stats["decode_errors"]
    finally:
        a.shutdown()
        b.shutdown()


def _jax_cluster(num_keys, L):
    from adapm_tpu.config import SystemOptions as JOpts
    from adapm_tpu.net import LoopbackCluster as JCluster
    return JCluster(2, num_keys=num_keys, value_lengths=L,
                    opts_factory=lambda r: JOpts(sync_max_per_sec=0,
                                                 prefetch=False))


def _draws(K, L, rounds, n):
    per_rank = []
    shadow = np.zeros((K, L), np.float64)
    for rank in range(2):
        rng = np.random.default_rng(77 + rank)
        rr = []
        for _ in range(rounds):
            keys = np.sort(rng.choice(K, size=n, replace=False))
            vals = rng.integers(-6, 7, size=(n, L)).astype(np.float32)
            rr.append((keys.astype(np.int64), vals))
            shadow[keys] += vals
        per_rank.append(rr)
    return per_rank, shadow.astype(np.float32)


def _shadow_scenario(per_rank, K, L, CLOCK_MAX):
    def scenario(rank, srv):
        w = srv.make_worker(0)
        allk = np.arange(K, dtype=np.int64)
        if rank == 0:
            w.wait(w.set(allk, np.zeros((K, L), np.float32)))
        srv.barrier()
        # rank 1 claims every key (relocations), then rank 0 claims the
        # even ones (replications of rank-1-owned keys)
        if rank == 1:
            w.intent(allk, 0, CLOCK_MAX)
            srv.wait_sync()
        srv.barrier()
        if rank == 0:
            w.intent(allk[::2], 0, CLOCK_MAX)
            srv.wait_sync()
        srv.barrier()
        for keys, vals in per_rank[rank]:
            w.wait(w.push(keys, vals))
            srv.wait_sync()
            srv.barrier()
            srv.wait_sync()
            srv.barrier()
        return w.pull_sync(allk), srv.read_main(allk).reshape(K, L)
    return scenario


def test_loopback_runs_bitwise_across_packages():
    """(c) The same seeded integer-push scenario with relocations and
    replications through both packages' LoopbackClusters: every rank's
    pulls and main reads are bitwise the NumPy shadow in both."""
    from adapm_tpu_torch.base import CLOCK_MAX
    K, L = 40, 4
    per_rank, shadow = _draws(K, L, rounds=4, n=10)
    outs = {}
    for name, make in (("port", lambda: _cluster(num_keys=K, L=L)),
                       ("jax", lambda: _jax_cluster(K, L))):
        cl = make()
        try:
            outs[name] = cl.run(_shadow_scenario(per_rank, K, L, CLOCK_MAX))
            reloc = sum(s.glob.stats["relocations_in"] for s in cl.servers)
            reps = sum(s.glob.stats["replicas_granted"]
                       for s in cl.servers)
            assert reloc > 0 and reps > 0, (name, reloc, reps)
        finally:
            cl.shutdown()
    for rank in range(2):
        for name in ("port", "jax"):
            pulled, main = outs[name][rank]
            np.testing.assert_array_equal(pulled, shadow,
                                          err_msg=f"{name} rank {rank}")
            np.testing.assert_array_equal(main, shadow)
        assert outs["port"][rank][0].tobytes() == \
            outs["jax"][rank][0].tobytes()


def test_intent_placement_matches_across_packages():
    """(d) One intending worker (rank 1, on a slice of rank-0-homed
    keys): after wait_sync the owner tables, the replica maps and the
    owner hints are equal across packages."""
    from adapm_tpu_torch.base import CLOCK_MAX
    K, L = 64, 4

    def scenario(rank, srv):
        w = srv.make_worker(0)
        keys = np.arange(K, dtype=np.int64)
        if rank == 0:
            w.wait(w.set(keys, np.ones((K, L), np.float32)))
        srv.barrier()
        if rank == 1:
            w.intent(keys[:24], 0, CLOCK_MAX)
            srv.wait_sync()
        srv.barrier()
        with srv._lock:
            return (srv.ab.owner.copy(), srv.ab.slot.copy(),
                    srv.ab.cache_slot.copy(), srv.glob.owner_hint.copy(),
                    srv.glob.interest.copy())

    got = {}
    for name, make in (("port", lambda: _cluster(num_keys=K, L=L)),
                       ("jax", lambda: _jax_cluster(K, L))):
        cl = make()
        try:
            got[name] = cl.run(scenario)
        finally:
            cl.shutdown()
    for rank in range(2):
        for a, b in zip(got["port"][rank], got["jax"][rank]):
            np.testing.assert_array_equal(a, b)
    # the intent moved something: rank 1 owns keys it did not own before
    assert (got["port"][1][0][:24] >= 0).any()
