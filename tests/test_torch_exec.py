"""The port's executor (adapm_tpu_torch/exec/executor.py) and the planes
that run on it, held to tests/test_exec.py's scenarios.

1. Executor mechanics — per-stream FIFO, free cross-stream
   interleaving, `after` edges, coalescing, delayed eligibility, error
   containment, idempotent close with cancellation, drain, the
   serialized single-stream fallback, the overlap accounting and the
   process-wide dispatch gate — each scenario run on the JAX package's
   AsyncExecutor and on the port's, which must behave alike.

2. The enqueue-order property test: a randomized interleaving of the
   producers (writes, prefetch intents with pumped planner rounds, tier
   promotion/demotion churn with maintenance kicks, served lookups,
   sync rounds, relocations) driven identically through tiered servers:
   an overlapped port server and a `--sys.exec.single_stream` port
   server, and through the JAX package's overlapped server: every read
   (whole-table `read_main`, duplicate-heavy pulls, served lookups)
   must be bitwise the same on all three at every step and after
   quiesce. A single-stream tiered server with the background planner,
   a serving plane and tier maintenance shuts down promptly. Both port
   runs go under the port's lock-order sentinel
   (`--sys.lint.lockorder`): it must record edges and no violation.
"""
import threading
import time

import numpy as np
import pytest

import adapm_tpu
import adapm_tpu_torch
from adapm_tpu.exec import AsyncExecutor as JaxExecutor
from adapm_tpu.exec import dispatch_gate as jax_gate
from adapm_tpu_torch.exec import AsyncExecutor as PortExecutor
from adapm_tpu_torch.exec import dispatch_gate as port_gate

E = 384
L = 8

EXECUTORS = pytest.mark.parametrize(
    "Ex", [JaxExecutor, PortExecutor], ids=["jax", "port"])


# ---------------------------------------------------------------------------
# 1. executor mechanics, on both executors
# ---------------------------------------------------------------------------


@EXECUTORS
def test_stream_fifo_order(Ex):
    ex = Ex(workers=4)
    order = []
    lock = threading.Lock()

    def mk(i):
        def fn():
            with lock:
                order.append(i)
        return fn

    last = None
    for i in range(50):
        last = ex.submit("s", mk(i))
    assert last.wait(10)
    assert order == list(range(50)), "stream order must be submission order"
    ex.close()


@EXECUTORS
def test_streams_interleave_and_after_edges(Ex):
    ex = Ex(workers=4)
    events = []
    lock = threading.Lock()
    gate_a = threading.Event()

    def slow_a():
        gate_a.wait(10)
        with lock:
            events.append("a")

    def fast_b():
        with lock:
            events.append("b")

    ca = ex.submit("a", slow_a)
    cb = ex.submit("b", fast_b)
    assert cb.wait(10)
    assert not ca.done()
    gate_a.set()
    assert ca.wait(10)
    c1 = ex.submit("a", lambda: events.append("first"))
    c2 = ex.submit("b", lambda: events.append("second"), after=[c1])
    assert c2.wait(10)
    assert events.index("first") < events.index("second")
    ex.close()


@EXECUTORS
def test_coalesce_key_absorbs_queued_duplicates(Ex):
    ex = Ex(workers=1)
    block = threading.Event()
    ran = []
    ex.submit("s", lambda: block.wait(10))
    c1 = ex.submit("s", lambda: ran.append(1), coalesce_key="k")
    c2 = ex.submit("s", lambda: ran.append(2), coalesce_key="k")
    assert c2 is c1, "queued same-key program is reused, not duplicated"
    block.set()
    assert c1.wait(10)
    assert ran == [1]
    ex.close()


@EXECUTORS
def test_delay_and_coalesce_tightening(Ex):
    ex = Ex(workers=2)
    t0 = time.monotonic()
    c = ex.submit("s", lambda: time.monotonic(), delay=0.15)
    assert c.result(10) - t0 >= 0.14, "delayed program ran early"
    c1 = ex.submit("s", lambda: "x", coalesce_key="k", delay=30.0)
    c2 = ex.submit("s", lambda: "y", coalesce_key="k", delay=0.0)
    assert c2 is c1
    assert c1.wait(10), "tightened program must run promptly, not in 30s"
    ex.close()


@EXECUTORS
def test_error_containment_and_result(Ex):
    ex = Ex(workers=2)

    def boom():
        raise ValueError("program failed")

    c = ex.submit("s", boom)
    with pytest.raises(ValueError, match="program failed"):
        c.result(10)
    assert ex.submit("s", lambda: 41 + 1).result(10) == 42
    ex.close()


@EXECUTORS
def test_close_idempotent_cancels_queued(Ex):
    ex = Ex(workers=1)
    block = threading.Event()
    ex.submit("s", lambda: block.wait(10))
    queued = ex.submit("s", lambda: "never")
    block.set()
    ex.close()
    ex.close()
    assert ex.closed
    assert queued.done()
    late = ex.submit("s", lambda: 1)
    assert late.done() and late.cancelled
    assert ex.live_streams() == []


@EXECUTORS
def test_drain_and_queue_depth(Ex):
    ex = Ex(workers=2)
    started = threading.Event()
    block = threading.Event()

    def blocker():
        started.set()
        block.wait(10)

    ex.submit("s", blocker)
    assert started.wait(10)
    ex.submit("s", lambda: None)
    assert ex.queue_depth("s") == 1
    assert not ex.drain("s", timeout=0.2)
    block.set()
    assert ex.drain("s", timeout=10)
    assert ex.queue_depth() == 0
    ex.close()


@EXECUTORS
def test_single_stream_serializes_everything(Ex):
    ex = Ex(workers=4, single_stream=True)
    assert ex.max_workers == 1
    order = []
    lock = threading.Lock()

    def mk(tag):
        def fn():
            with lock:
                order.append(tag)
            time.sleep(0.002)
        return fn

    cs = [ex.submit(f"stream{i % 3}", mk(i)) for i in range(10)]
    for c in cs:
        assert c.wait(10)
    assert order == list(range(10))
    assert ex.stats()["overlap_fraction"] == 0.0
    ex.close()


@EXECUTORS
def test_overlap_accounting_sees_concurrent_streams(Ex):
    ex = Ex(workers=4)
    b1, b2 = threading.Event(), threading.Event()
    c1 = ex.submit("a", lambda: b1.wait(10))
    c2 = ex.submit("b", lambda: b2.wait(10))
    time.sleep(0.15)
    b1.set(), b2.set()
    assert c1.wait(10) and c2.wait(10)
    st = ex.stats()
    assert st["overlap_s"] > 0.1, "two busy streams must count as overlap"
    assert 0.0 < st["overlap_fraction"] <= 1.0
    ex.close()


@EXECUTORS
def test_single_stream_keeps_stream_identity(Ex):
    ex = Ex(workers=4, single_stream=True)
    stop = threading.Event()

    def tick():
        if not stop.is_set():
            ex.submit("sync", tick, delay=0.01)  # self-rescheduling

    ex.submit("sync", tick)
    ex.submit("prefetch", lambda: None, delay=30.0)
    ran = ex.submit("serve", lambda: "served")
    assert ran.result(5) == "served"
    t0 = time.monotonic()
    assert ex.drain("serve", timeout=5), \
        "draining 'serve' must not wait on the sync stream"
    assert time.monotonic() - t0 < 2.0
    stop.set()
    ex.close()


@pytest.mark.parametrize("gate", [jax_gate, port_gate],
                         ids=["jax", "port"])
def test_dispatch_gate_is_reentrant_process_wide(gate):
    g1, g2 = gate(), gate()
    assert g1 is g2, "one gate per process"
    with g1:
        with g2:
            pass


# ---------------------------------------------------------------------------
# 2. servers on the executor
# ---------------------------------------------------------------------------


def _port_server(single_stream: bool):
    opts = adapm_tpu_torch.SystemOptions(
        sync_max_per_sec=0, prefetch=True, prefetch_pull="off",
        tier=True, tier_hot_rows=16, exec_single_stream=single_stream,
        lint_lockorder=True)
    return adapm_tpu_torch.setup(E, L, opts=opts, num_shards=8,
                                 device="cpu")


def _jax_server():
    opts = adapm_tpu.SystemOptions(sync_max_per_sec=0, prefetch=True,
                                   prefetch_pull="off", tier=True,
                                   tier_hot_rows=16)
    return adapm_tpu.setup(E, L, opts=opts)


@pytest.fixture
def port_sentinel():
    """The port's lock-order sentinel, off before the test and torn down
    after it (the shared conftest tears down only the JAX package's)."""
    from adapm_tpu_torch.lint import lockorder
    lockorder.disable_sentinel()
    yield lockorder
    lockorder.disable_sentinel()


def _assert_sentinel_clean(lockorder):
    """The storm recorded a non-trivial acquisition graph and no ordering
    violation (the dynamic check of APM001/APM002's static claims)."""
    sen = lockorder.get_sentinel()
    assert sen is not None and sen.edges(), \
        "sentinel saw no lock edges: the storm exercised nothing"
    sen.assert_clean()


def test_single_stream_server_shutdown_with_sync_and_serve(port_sentinel):
    """A single-stream tiered port server running the background planner,
    a serving plane AND tier maintenance shuts down promptly (each drain
    targets its own stream)."""
    from adapm_tpu_torch.serve import ServePlane
    rng = np.random.default_rng(0)
    srv = _port_server(True)
    w = srv.make_worker(0)
    w.set(np.arange(E), rng.normal(size=(E, L)).astype(np.float32))
    plane = ServePlane(srv)
    sess = plane.session()
    srv.start_sync_thread()
    srv.tier.engine.kick()
    assert np.asarray(sess.lookup(np.arange(8))).shape == (8, L)
    t0 = time.monotonic()
    srv.shutdown()
    assert time.monotonic() - t0 < 25.0, \
        "single-stream shutdown stalled on a cross-subsystem drain"
    assert srv.exec.live_streams() == []
    assert srv.sync_loop_failures == 0
    _assert_sentinel_clean(port_sentinel)


def test_enqueue_order_property_producers_match_jax(port_sentinel):
    from adapm_tpu.serve import ServePlane as JaxPlane
    from adapm_tpu_torch.serve import ServePlane
    rng = np.random.default_rng(0)
    srv = _port_server(False)          # overlapped default
    ref = _port_server(True)           # serialized shadow
    jx = _jax_server()                 # the reference package
    assert jx.num_shards == srv.num_shards
    servers = (srv, ref, jx)
    ws = [s.make_worker(0) for s in servers]
    planes = [ServePlane(srv), ServePlane(ref), JaxPlane(jx)]
    sessions = [p.session() for p in planes]
    vals = rng.normal(size=(E, L)).astype(np.float32)
    for w in ws:
        w.set(np.arange(E), vals)
    keys = np.arange(E)

    def settle():
        # the pumped planner rounds are value-visible: drain them so all
        # servers compare at the same logical point
        for s in servers:
            s.prefetch.flush()

    def same(arrs, what):
        a = np.asarray(arrs[0], dtype=np.float32)
        for b in arrs[1:]:
            assert np.array_equal(a.view(np.uint32), np.asarray(
                b, dtype=np.float32).view(np.uint32)), what

    for step in range(40):
        op = int(rng.integers(0, 6))
        if op == 0:      # writes
            ks = rng.integers(0, E, 24)
            v = rng.normal(size=(24, L)).astype(np.float32)
            for w in ws:
                w.push(ks, v)
        elif op == 1:    # prefetch pipeline: intent + one pumped round
            ks = rng.choice(keys[srv.ab.owner[keys] != ws[0].shard], 16,
                            replace=False)
            end = int(ws[0].current_clock + rng.integers(1, 4))
            for s, w in zip(servers, ws):
                w.intent(ks, w.current_clock, end)
                s.drive_rounds(1)
            settle()
        elif op == 2:    # serve plane: coalesced lookups
            ks = rng.integers(0, E, 20)
            same([s.lookup(ks) for s in sessions],
                 f"step {step}: served lookup diverged")
        elif op == 5:    # tier maintenance: churn + a kick of the worker
            ks = rng.choice(E, 24, replace=False)
            for s in servers:
                s.tier.promote_keys(ks)
                s.tier.demote_keys(ks[:12])
                s.tier.engine.kick()
        elif op == 3:    # sync rounds
            for s in servers:
                s.sync.run_round(force_intents=True, all_channels=True)
        else:            # relocation (topology churn under everything)
            ks = rng.choice(E, 12, replace=False)
            dest = int(rng.integers(0, srv.num_shards))
            for s in servers:
                s._relocate_to(ks, dest)
        if rng.integers(0, 3) == 0:
            for w in ws:
                w.advance_clock()
        settle()
        same([s.read_main(keys) for s in servers],
             f"step {step} (op {op}): read_main diverged")
        pk = rng.integers(0, E, 20)
        same([w.pull_sync(pk) for w in ws], f"step {step}: pull diverged")
        np.testing.assert_array_equal(srv.ab.owner, jx.ab.owner)
    for s in servers:
        s.quiesce()
    same([s.read_main(keys) for s in servers],
         "after quiesce: state diverged")
    assert ref.exec.single_stream and not srv.exec.single_stream
    assert srv.prefetch.stats["rounds_driven"] > 0
    assert srv.prefetch.failures == 0 and ref.prefetch.failures == 0
    assert srv.tier.engine.failures == 0 and ref.tier.engine.failures == 0
    for p in planes:
        p.close()
    for s in servers:
        s.shutdown()
        assert s.exec.live_streams() == []
    _assert_sentinel_clean(port_sentinel)
