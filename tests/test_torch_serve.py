"""The serving plane of the port (adapm_tpu_torch/serve) on the CPU: the
scenarios of tests/test_serve.py, one for one, on the port's Server with
8 virtual shards (the JAX suite's 8-device mesh), and the same scripted
lookups and bag reads on a JAX ServePlane and a port ServePlane, bitwise.

Every wait is bounded (join timeouts, deadlines); no assertion rests on
a tight wall-clock margin.
"""
import threading
import time

import numpy as np
import pytest

from adapm_tpu_torch import Server, SystemOptions
from adapm_tpu_torch.device.context import make_context
from adapm_tpu_torch.serve import (DeadlineExceededError, LookupRequest,
                                   ServeDegradedError, ServeOverloadError,
                                   ServePlane)
from adapm_tpu_torch.serve.bags import pool_bags_host

NK = 96
VL = 4


@pytest.fixture
def ctx():
    return make_context(8, "cpu")


@pytest.fixture
def port_sentinel():
    """The port's lock-order sentinel, off before the test and torn down
    after it (the shared conftest tears down only the JAX package's)."""
    from adapm_tpu_torch.lint import lockorder
    lockorder.disable_sentinel()
    yield lockorder
    lockorder.disable_sentinel()


def _assert_sentinel_clean(lockorder):
    """The storm's locks (server, round, registry, admission, gate)
    joined the graph, and nothing cycled or was taken under the gate."""
    sen = lockorder.get_sentinel()
    assert sen is not None and sen.edges(), \
        "sentinel saw no lock edges: the storm exercised nothing"
    sen.assert_clean()


def make_server(ctx, num_keys=NK, vlen=VL, **kw):
    opts = kw.pop("opts", None) or SystemOptions(sync_max_per_sec=0)
    return Server(num_keys, vlen, opts=opts, ctx=ctx, **kw)


def _seed(w, num_keys=NK, vlen=VL):
    keys = np.arange(num_keys)
    vals = (np.arange(num_keys * vlen, dtype=np.float32)
            .reshape(num_keys, vlen))
    w.wait(w.set(keys, vals))
    return vals


def test_lookup_matches_pull(ctx):
    s = make_server(ctx)
    w = s.make_worker(0)
    _seed(w)
    with ServePlane(s) as plane:
        sess = plane.session()
        for batch in (np.array([1, 5, 9]),
                      np.array([7, 7, 3, 7]),          # duplicates
                      np.arange(NK),                    # everything
                      np.array([42])):
            got = sess.lookup(batch)
            ref = w.pull_sync(batch)
            assert np.array_equal(got, ref), batch
        assert sess.lookup([]).size == 0
        # an out-of-range key fails ITS client at the session boundary
        # (it must not reach the dispatcher and poison a co-batch)
        with pytest.raises(IndexError):
            sess.lookup(np.array([NK]))
        with pytest.raises(IndexError):
            sess.lookup(np.array([-1]))
        # the plane still serves after the rejection
        assert np.array_equal(sess.lookup(np.array([0])),
                              w.pull_sync(np.array([0])))
    s.shutdown()


def test_lookup_mixed_length_classes(ctx):
    """Ragged batches span length classes: one fused gather per class,
    reassembled flat exactly like pull_sync."""
    lens = np.where(np.arange(32) % 3 == 0, 8, 4)
    s = Server(32, lens, opts=SystemOptions(sync_max_per_sec=0), ctx=ctx)
    w = s.make_worker(0)
    flat = np.arange(lens.sum(), dtype=np.float32)
    w.wait(w.set(np.arange(32), flat))
    with ServePlane(s) as plane:
        sess = plane.session()
        batch = np.array([0, 1, 3, 6, 2, 0])  # mixed classes + duplicate
        got = sess.lookup(batch)
        ref = w.pull_sync(batch)
        assert got.ndim == 1 and np.array_equal(got, ref)
    s.shutdown()


def test_coalesced_batch_single_dispatch(ctx):
    """N requests queued while the dispatcher is paused are served by
    ONE micro-batch: one deduplicated union gather, every request's
    values correct (deterministic — no timing assumptions)."""
    s = make_server(ctx)
    w = s.make_worker(0)
    vals = _seed(w)
    plane = ServePlane(s, start=False)
    reqs = [LookupRequest(np.array([i, i + 1, 40])) for i in range(8)]
    for r in reqs:
        plane.queue.submit(r)
    b0 = s.obs.find("serve.batches_total").value
    plane.start()
    for i, r in enumerate(reqs):
        assert r.wait(30), "request not served"
        got = r.take_result().reshape(3, VL)
        assert np.array_equal(got, vals[[i, i + 1, 40]])
    assert s.obs.find("serve.batches_total").value == b0 + 1
    assert s.obs.find("serve.batch_size").snap()["max"] == 8.0
    # the union was deduplicated: 8 requests x 3 keys share key 40 and
    # overlap pairwise -> far fewer unique keys than submitted keys
    assert s.obs.find("serve.keys_deduped_total").value < \
        s.obs.find("serve.keys_total").value
    plane.close()
    s.shutdown()


def test_backpressure_rejects_loudly(ctx):
    s = make_server(ctx)
    w = s.make_worker(0)
    vals = _seed(w)
    opts = SystemOptions(sync_max_per_sec=0, serve_queue=4,
                         serve_max_batch=4)
    plane = ServePlane(s, opts=opts, start=False)
    reqs = [LookupRequest(np.array([i])) for i in range(4)]
    for r in reqs:
        plane.queue.submit(r)
    sess = plane.session()
    with pytest.raises(ServeOverloadError):
        sess.lookup(np.array([9]))
    assert s.obs.find("serve.rejected_total").value >= 1
    # backpressure is transient: once the dispatcher drains, admission
    # resumes and the queued requests were all served correctly
    plane.start()
    for i, r in enumerate(reqs):
        assert r.wait(30)
        assert np.array_equal(r.take_result(), vals[i])
    assert np.array_equal(sess.lookup(np.array([9]))[0], vals[9])
    plane.close()
    s.shutdown()


def test_deadline_sheds_never_hangs(ctx):
    s = make_server(ctx)
    w = s.make_worker(0)
    vals = _seed(w)
    plane = ServePlane(s, start=False)  # paused: nothing will serve
    sess = plane.session()
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceededError):
        sess.lookup(np.array([1]), deadline_ms=30)
    assert time.monotonic() - t0 < 5.0, "shed was not prompt"
    assert s.obs.find("serve.shed_total").value >= 1
    # the shed corpse still sits in the deque, but it is NOT live work:
    # depth (and hence readiness/queue_depth) must not count it
    assert plane.queue.depth() == 0
    # an already-expired request queued behind a live one is shed at
    # take time (dispatcher-side deadline check), the live one served
    dead = LookupRequest(np.array([2]), deadline_s=0.0)
    live = LookupRequest(np.array([3]))
    plane.queue.submit(dead)
    plane.queue.submit(live)
    plane.start()
    assert live.wait(30)
    assert np.array_equal(live.take_result(), vals[3])
    assert dead.wait(30)
    with pytest.raises(DeadlineExceededError):
        dead.take_result()
    # the plane keeps serving after sheds
    assert np.array_equal(sess.lookup(np.array([4]))[0], vals[4])
    plane.close()
    s.shutdown()


def test_serve_storm_bit_identical(ctx, port_sentinel):
    """THE acceptance storm: a randomized (but deterministic) sequence
    of pushes, sets, relocations, replica churn, and sync rounds, with
    a serve lookup + plain `Worker.pull` of the same keys after every
    mutation — bit-identical at every read, read-your-writes included
    (the pull and the lookup route from the same shard as the serving
    plane, which is the consistency contract; docs/SERVING.md). Under
    the lock-order sentinel."""
    s = make_server(ctx, opts=SystemOptions(sync_max_per_sec=0,
                                            cache_slots_per_shard=64,
                                            lint_lockorder=True))
    w0 = s.make_worker(0)   # shard 0 — the serve plane's shard
    w1 = s.make_worker(1)   # shard 1 — a second writer + replica holder
    _seed(w0)
    plane = ServePlane(s)
    sess = plane.session(worker=w0)
    rng = np.random.default_rng(7)
    for step in range(50):
        op = rng.integers(0, 6)
        kset = np.unique(rng.integers(0, NK, rng.integers(1, 9)))
        if op == 0:
            w0.push(kset, rng.normal(size=(len(kset), VL))
                    .astype(np.float32))
        elif op == 1:
            w1.push(kset, rng.normal(size=(len(kset), VL))
                    .astype(np.float32))
        elif op == 2:
            w0.set(kset, rng.normal(size=(len(kset), VL))
                   .astype(np.float32))
        elif op == 3:
            s._relocate_to(kset, int(rng.integers(0, s.num_shards)))
        elif op == 4:
            # replica churn: a short-lived intent window on shard 1
            w1.intent(kset, w1.current_clock, w1.current_clock + 2)
            with s._round_lock:
                s.sync.run_round(force_intents=True, all_channels=True)
            w1.advance_clock()
        else:
            with s._round_lock:
                s.sync.run_round(all_channels=True)
        batch = rng.integers(0, NK, 12)  # duplicates allowed
        got = sess.lookup(batch)
        ref = w0.pull_sync(batch)
        assert np.array_equal(got, ref), f"step {step} (op {op}) diverged"
    assert s.obs.find("serve.lookups_total").value == 50
    plane.close()
    s.shutdown()
    _assert_sentinel_clean(port_sentinel)


def test_serve_concurrent_storm_no_hang(ctx, port_sentinel):
    """Concurrent clients, writers, a relocator, and a sync-round
    thread: the additive-sum invariant holds exactly (each client's
    disjoint key slice reads exactly its own push count — coalesced
    lookups are ordered with the client's pushes), and every thread
    joins within its bound (reject/shed loudly, never hang). Under the
    lock-order sentinel: four threads take the server, round, admission
    and gate locks in every interleaving the storm produces."""
    s = make_server(ctx, num_keys=64,
                    opts=SystemOptions(sync_max_per_sec=0,
                                       lint_lockorder=True))
    w0, w1 = s.make_worker(0), s.make_worker(1)
    w0.wait(w0.set(np.arange(64), np.zeros((64, VL), np.float32)))
    plane = ServePlane(s)
    errs = []
    stop = threading.Event()

    def client(w, lo, hi):
        # pushes land on owner main rows (no replicas of these keys —
        # no intents are signalled for them), so a coalesced lookup
        # observes exactly the pushes dispatched before it
        try:
            sess = plane.session(worker=w)
            mine = np.arange(lo, hi)
            for n in range(1, 31):
                w.push(mine, np.ones((len(mine), VL), np.float32))
                got = sess.lookup(mine)
                if not np.array_equal(
                        got, np.full((len(mine), VL), float(n))):
                    errs.append((lo, n, got))
                    return
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    def relocator():
        rng = np.random.default_rng(11)
        try:
            while not stop.is_set():
                keys = np.unique(rng.integers(0, 64, 6))
                s._relocate_to(keys, int(rng.integers(0, s.num_shards)))
                time.sleep(0.001)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    def syncer():
        try:
            while not stop.is_set():
                with s._round_lock:
                    s.sync.run_round(all_channels=True)
                time.sleep(0.001)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(w0, 0, 16)),
               threading.Thread(target=client, args=(w1, 16, 32)),
               threading.Thread(target=relocator),
               threading.Thread(target=syncer)]
    for t in threads[:2]:
        t.start()
    for t in threads[2:]:
        t.start()
    for t in threads[:2]:
        t.join(timeout=120)
        assert not t.is_alive(), "serve client hung"
    stop.set()
    for t in threads[2:]:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs[:3]
    plane.close()
    s.shutdown()
    _assert_sentinel_clean(port_sentinel)


def test_readiness_flips_on_stale_peer(ctx):
    """Heartbeat/dead-node detection is DETECTION-ONLY — a stale peer
    flips the readiness signal while the request queue keeps serving
    (never hangs)."""
    s = make_server(ctx)
    w = s.make_worker(0)
    vals = _seed(w)
    dead = []
    plane = ServePlane(s, dead_nodes_fn=lambda: list(dead))
    sess = plane.session()
    r = plane.health.readiness()
    assert r["ready"] and r["dead_nodes"] == []
    assert plane.health.liveness()["dispatcher_alive"]
    # a peer's heartbeat goes stale: not ready, reason names it...
    dead.append(2)
    r = plane.health.readiness()
    assert not r["ready"] and r["dead_nodes"] == [2]
    assert any("stale peer" in x for x in r["reasons"])
    snap = s.metrics_snapshot()
    assert snap["serve"]["ready"] == 0
    assert snap["serve"]["dead_peers"] == 1
    assert snap["serve"]["readiness"]["dead_nodes"] == [2]
    # ...but the queue is NOT hung: lookups still serve promptly
    t0 = time.monotonic()
    assert np.array_equal(sess.lookup(np.array([5]))[0], vals[5])
    assert time.monotonic() - t0 < 10.0
    # detection clears -> ready again
    dead.clear()
    assert plane.health.readiness()["ready"]
    plane.close()
    s.shutdown()


def test_serve_snapshot_section_and_lifecycle(ctx):
    s = make_server(ctx)
    w = s.make_worker(0)
    _seed(w)
    # before any plane: the section exists (schema stability) but is {}
    snap = s.metrics_snapshot()
    assert snap["serve"] == {} and snap["slo"] == {}
    plane = ServePlane(s)
    # one live plane per server
    with pytest.raises(RuntimeError):
        ServePlane(s)
    sess = plane.session()
    sess.lookup(np.array([1, 2, 3]))
    snap = s.metrics_snapshot()
    for key in ("lookups_total", "batches_total", "keys_total",
                "keys_deduped_total", "latency_s", "batch_size",
                "queue_depth", "shed_total", "rejected_total", "ready",
                "dead_peers", "readiness"):
        assert key in snap["serve"], key
    assert snap["serve"]["lookups_total"] >= 1
    assert snap["serve"]["latency_s"]["count"] >= 1
    plane.close()
    # close() is loud for queued work and final for this plane...
    with pytest.raises(RuntimeError):
        sess.lookup(np.array([1]))
    # ...but a NEW plane may be built on the same server (shared serve.*
    # metrics are reused; gauges rebind to the new plane's structures)
    plane2 = ServePlane(s)
    assert np.array_equal(plane2.session().lookup(np.array([1])),
                          w.pull_sync(np.array([1])))
    assert s.metrics_snapshot()["serve"]["ready"] == 1
    # Server.shutdown closes an attached plane (no dangling dispatcher)
    s.shutdown()
    assert not plane2.batcher.is_alive()


def test_serve_works_with_metrics_off(ctx):
    """--sys.metrics 0: the plane serves correctly on null metrics (the
    shed/reject accounting degrades to standalone counters)."""
    s = make_server(ctx, opts=SystemOptions(sync_max_per_sec=0,
                                            metrics=False))
    w = s.make_worker(0)
    vals = _seed(w)
    plane = ServePlane(s, start=False)
    sess = plane.session()
    with pytest.raises(DeadlineExceededError):
        sess.lookup(np.array([1]), deadline_ms=20)
    assert plane.queue.c_shed.value >= 1  # standalone counter
    plane.start()
    assert np.array_equal(sess.lookup(np.array([8]))[0], vals[8])
    assert s.metrics_snapshot()["serve"] == {}
    plane.close()
    s.shutdown()


def test_serve_default_deadline_from_opts(ctx):
    """--sys.serve.deadline_ms sets the per-request default."""
    s = make_server(ctx, opts=SystemOptions(sync_max_per_sec=0,
                                            serve_deadline_ms=25.0))
    w = s.make_worker(0)
    _seed(w)
    plane = ServePlane(s, start=False)
    sess = plane.session()
    with pytest.raises(DeadlineExceededError):
        sess.lookup(np.array([1]))   # default deadline applies
    # an explicit deadline_ms=0 overrides to "no deadline"
    req_served = []

    def late():
        req_served.append(sess.lookup(np.array([2]), deadline_ms=0))

    t = threading.Thread(target=late)
    t.start()
    time.sleep(0.1)
    plane.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(req_served) == 1
    plane.close()
    s.shutdown()


# ---------------------------------------------------------------------------
# read-only serve replicas, sharded dispatch, tenant-aware admission
# ---------------------------------------------------------------------------


def test_replica_storm_bit_identical(ctx):
    """The acceptance storm extended to the replica path (the JAX test's
    untiered case; test_replica_storm_bit_identical_tiered is the tiered
    one)."""
    _replica_storm(ctx, tiered=False)


def test_replica_storm_bit_identical_tiered(ctx):
    """The JAX test's tiered case: 8 hot rows a shard force a live cold
    path under the storm, with promotion/demotion churn as op 6."""
    _replica_storm(ctx, tiered=True)


def _replica_storm(ctx, tiered: bool):
    """Randomized push/set/relocate/sync/replica-churn (+ tier
    promote/demote when tiered) with the read-only
    snapshot refreshed mid-storm — every lookup bit-identical to
    `Worker.pull` of the same
    keys, including snapshot-stale fallbacks (a bumped write epoch or a
    moved topology forces the exact locked path) and same-session
    read-your-writes. Asserts the fast path actually fired (hits > 0)
    AND actually fell back (stale fallbacks > 0), so neither branch is
    vacuously green."""
    opts = SystemOptions(sync_max_per_sec=0, cache_slots_per_shard=64,
                         serve_replica_rows=48,
                         serve_replica_refresh_ms=1.0)
    if tiered:
        opts.tier = True
        opts.tier_hot_rows = 8   # a live cold path under the storm
    s = make_server(ctx, opts=opts)
    w0 = s.make_worker(0)   # shard 0 — the serve plane's shard
    w1 = s.make_worker(1)   # shard 1 — a second writer + replica holder
    _seed(w0)
    plane = ServePlane(s)
    sess = plane.session(worker=w0)
    rep = plane.replica
    assert rep is not None
    hot = np.arange(24)     # the working set the snapshot should cover
    # deterministic warm-up: build serve-load scores, snapshot, and pin
    # the first replica-path hit + the first epoch-staleness fallback
    assert np.array_equal(sess.lookup(hot), w0.pull_sync(hot))
    assert rep.refresh_now() > 0
    h0 = s.obs.find("serve.replica_hits_total").value
    assert np.array_equal(sess.lookup(hot), w0.pull_sync(hot))
    assert s.obs.find("serve.replica_hits_total").value == h0 + 1
    w0.wait(w0.push(hot[:2], np.ones((2, VL), np.float32)))
    # the push bumped the rows' write epochs: the very next lookup must
    # fall back to the locked path and still read its own write
    assert np.array_equal(sess.lookup(hot), w0.pull_sync(hot))
    assert s.obs.find("serve.replica_stale_fallbacks_total").value >= 1
    rng = np.random.default_rng(7)
    for step in range(50):
        op = rng.integers(0, 7)   # 6: the tiered churn
        kset = np.unique(rng.integers(0, NK, rng.integers(1, 9)))
        if op == 0:
            w0.push(kset, rng.normal(size=(len(kset), VL))
                    .astype(np.float32))
        elif op == 1:
            w1.push(kset, rng.normal(size=(len(kset), VL))
                    .astype(np.float32))
        elif op == 2:
            w0.set(kset, rng.normal(size=(len(kset), VL))
                   .astype(np.float32))
        elif op == 3:
            s._relocate_to(kset, int(rng.integers(0, s.num_shards)))
        elif op == 4:
            # replica churn: a short-lived intent window on shard 1
            w1.intent(kset, w1.current_clock, w1.current_clock + 2)
            with s._round_lock:
                s.sync.run_round(force_intents=True, all_channels=True)
            w1.advance_clock()
        elif op == 5:
            with s._round_lock:
                s.sync.run_round(all_channels=True)
        elif s.tier is not None:  # promotion/demotion churn (tiered)
            s.tier.demote_keys(kset)
            s.tier.promote_keys(kset[: len(kset) // 2 + 1])
        if step % 6 == 0:
            rep.refresh_now()   # mid-storm snapshot rebuilds
        for batch in (np.concatenate([rng.integers(0, NK, 6),
                                      rng.choice(hot, 6)]),
                      hot):
            got = sess.lookup(batch)
            ref = w0.pull_sync(batch)
            assert np.array_equal(got, ref), \
                f"step {step} (op {op}) diverged"
    assert s.obs.find("serve.replica_hits_total").value > h0
    plane.close()
    s.shutdown()


def test_replica_mixed_length_classes(ctx):
    """Replica-path hits across length classes assemble the ragged flat
    result exactly like the locked path."""
    lens = np.where(np.arange(32) % 3 == 0, 8, 4)
    opts = SystemOptions(sync_max_per_sec=0, serve_replica_rows=32,
                         serve_replica_refresh_ms=1.0)
    s = Server(32, lens, opts=opts, ctx=ctx)
    w = s.make_worker(0)
    flat = np.arange(lens.sum(), dtype=np.float32)
    w.wait(w.set(np.arange(32), flat))
    with ServePlane(s) as plane:
        sess = plane.session()
        batch = np.array([0, 1, 3, 6, 2, 0])  # mixed classes + duplicate
        ref = w.pull_sync(batch)
        assert np.array_equal(sess.lookup(batch), ref)
        assert plane.replica.refresh_now() > 0
        h0 = s.obs.find("serve.replica_hits_total").value
        assert np.array_equal(sess.lookup(batch), ref)
        assert s.obs.find("serve.replica_hits_total").value == h0 + 1
    s.shutdown()


def test_multi_consumer_take_exactly_once(ctx):
    """N concurrent consumers on ONE queue claim disjoint request sets
    (the claim/shed state machine is N-consumer safe — the property the
    sharded dispatchers rely on), with client sheds racing the claims:
    every request ends exactly one of claimed / shed, never both."""
    from adapm_tpu_torch.serve.admission import AdmissionQueue
    q = AdmissionQueue(1024)
    reqs = [LookupRequest(np.array([i])) for i in range(300)]
    for r in reqs:
        q.submit(r)
    # a racing client sheds a third of them while consumers claim
    shed_set = [r for i, r in enumerate(reqs) if i % 3 == 0]
    claimed = [[] for _ in range(4)]
    errs = []

    def consumer(ci):
        try:
            while True:
                batch = q.take(7, 0.0, block=False)
                if not batch:
                    return
                claimed[ci].extend(batch)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    def shedder():
        try:
            for r in shed_set:
                r.try_shed()
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=consumer, args=(ci,))
               for ci in range(4)] + [threading.Thread(target=shedder)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs[:3]
    got = [int(r.keys[0]) for c in claimed for r in c]
    assert len(got) == len(set(got)), "a request was claimed twice"
    for r in reqs:  # exactly one terminal state each
        assert r.claimed != (r._state == 2), int(r.keys[0])
    assert q.depth() == 0


def test_admission_priority_preemption_and_compaction_race(ctx):
    """At a full queue a higher-priority submission
    preempts (sheds) the lowest-priority pending request instead of
    being rejected; bound accounting stays exact while low-priority
    corpses are compacted out under a racing high-priority take."""
    from adapm_tpu_torch.serve.admission import AdmissionQueue
    q = AdmissionQueue(8)
    lo = q.configure_tenant("lo", priority=0)
    hi = q.configure_tenant("hi", priority=2)
    lows = [LookupRequest(np.array([i]), tenant=lo, priority=0)
            for i in range(8)]
    for r in lows:
        q.submit(r)
    assert q.depth() == 8
    # same-priority submission at bound: plain rejection (no preemption
    # of an equal class)
    with pytest.raises(ServeOverloadError):
        q.submit(LookupRequest(np.array([90]), tenant=lo, priority=0))
    assert lo.c_rejected.value == 1
    # higher priority preempts: one low sheds loudly, the high admits
    h0 = LookupRequest(np.array([91]), tenant=hi, priority=2)
    q.submit(h0)
    assert q.depth() == 8          # bound exact: 7 lows + 1 high
    shed = [r for r in lows if r._done.is_set()]
    assert len(shed) == 1 and lo.c_shed.value == 1
    with pytest.raises(ServeOverloadError):
        shed[0].take_result()
    # fair-share take: the high-priority request is claimed FIRST even
    # though it arrived last (no FIFO starvation under pressure)
    batch = q.take(3, 0.0, block=False)
    assert batch[0] is h0
    # racing segment: a taker drains while high-priority submissions
    # keep preempting/admitting — conservation must hold exactly
    taken = list(batch)
    stop = threading.Event()
    errs = []

    def taker():
        try:
            while not stop.is_set():
                taken.extend(q.take(2, 0.0, block=False))
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=taker)
    t.start()
    highs = []
    rejected = 0
    for i in range(64):
        r = LookupRequest(np.array([100 + i]), tenant=hi, priority=2)
        try:
            q.submit(r)
            highs.append(r)
        except ServeOverloadError:
            rejected += 1
    time.sleep(0.05)
    stop.set()
    t.join(timeout=30)
    assert not t.is_alive()
    taken.extend(q.take(64, 0.0, block=False))
    assert not errs, errs[:3]
    # exact accounting: every admitted request is exactly one of
    # claimed / shed; nothing lost, nothing double-counted
    for r in lows + [h0] + highs:
        assert r.claimed != (r._state == 2), int(r.keys[0])
    n_shed = sum(1 for r in lows + [h0] + highs if r._state == 2)
    assert len(taken) + n_shed == len(lows) + 1 + len(highs)
    assert len(set(id(r) for r in taken)) == len(taken)
    assert q.depth() == 0


def test_tenant_quota_and_fair_share(ctx):
    """Token-bucket quotas reject at submit (quota backpressure, typed
    + counted per tenant); batch formation serves the higher priority
    class first and fair-shares slots across tenants within a class."""
    s = make_server(ctx)
    w = s.make_worker(0)
    vals = _seed(w)
    plane = ServePlane(s, start=False)
    bz = plane.configure_tenant("bronze", priority=0, qps=0.5, burst=2)
    plane.configure_tenant("gold", priority=1)
    gold = plane.queue.tenant("gold")
    silver = plane.configure_tenant("silver", priority=1)
    # bronze burst=2: two admits, third rejects on the dry bucket
    b1 = LookupRequest(np.array([1]), tenant=bz)
    b2 = LookupRequest(np.array([2]), tenant=bz)
    plane.queue.submit(b1)
    plane.queue.submit(b2)
    with pytest.raises(ServeOverloadError):
        plane.queue.submit(LookupRequest(np.array([3]), tenant=bz))
    assert bz.c_rejected.value == 1
    # queue now: bronze, bronze; add gold+silver (priority 1) — a
    # 4-slot batch claims the priority-1 class first, round-robin
    # across gold/silver, and stays PRIORITY-PURE (bronze keys must
    # not ride the high class's union gather); the next take serves
    # the bronzes
    g1 = LookupRequest(np.array([4]), tenant=gold, priority=1)
    g2 = LookupRequest(np.array([5]), tenant=gold, priority=1)
    s1 = LookupRequest(np.array([6]), tenant=silver, priority=1)
    for r in (g1, g2, s1):
        plane.queue.submit(r)
    batch = plane.queue.take(4, 0.0, block=False)
    assert [int(r.priority) for r in batch] == [1, 1, 1]
    assert {r.tenant.name for r in batch[:2]} == {"gold", "silver"}, \
        "fair share must alternate tenants within the priority class"
    batch2 = plane.queue.take(4, 0.0, block=False)
    assert set(batch2) == {b1, b2}
    # end to end: a started plane serves tenant sessions and counts
    # per-tenant serves in the snapshot
    plane.start()
    sess = plane.session(tenant="gold")
    assert np.array_equal(sess.lookup(np.array([7]))[0], vals[7])
    snap = s.metrics_snapshot()
    assert snap["serve"]["tenant.gold.served_total"] >= 1
    assert snap["serve"]["tenant.bronze.rejected_total"] == 1
    plane.close()
    s.shutdown()


def test_sharded_dispatchers_serve_concurrently(ctx):
    """--sys.serve.dispatchers N: N lanes on N executor streams serve
    concurrent clients correctly (exactly-once, bit-identical), the
    per-lane depth gauges exist, and all N streams were
    exercised."""
    opts = SystemOptions(sync_max_per_sec=0, serve_dispatchers=3)
    s = make_server(ctx, opts=opts)
    w = s.make_worker(0)
    vals = _seed(w)
    plane = ServePlane(s)
    errs = []

    def client(ci):
        try:
            sess = plane.session()
            rng = np.random.default_rng(ci)
            for _ in range(20):
                batch = rng.integers(0, NK, 8)
                got = sess.lookup(batch)
                if not np.array_equal(got, vals[batch]):
                    errs.append((ci, batch))
                    return
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs[:3]
    snap = s.metrics_snapshot()
    for i in range(3):
        assert f"lane_depth.{i}" in snap["serve"]
        assert snap["serve"][f"lane_depth.{i}"] == 0  # all drained
    # round-robin lane assignment spread the load over every stream
    assert "queue_depth.serve.1" in snap["exec"]
    assert "queue_depth.serve.2" in snap["exec"]
    assert snap["serve"]["lookups_total"] >= 120
    plane.close()
    s.shutdown()


def test_wedged_dispatcher_flips_readiness(ctx):
    """ONE wedged dispatcher of N flips
    `serve.ready` within the wedge bound — the probe reads busy stamps
    lock-free, never hanging behind the stuck drain — while the
    healthy dispatchers keep serving; recovery clears the signal."""
    opts = SystemOptions(sync_max_per_sec=0, serve_dispatchers=2)
    s = make_server(ctx, opts=opts)
    w = s.make_worker(0)
    vals = _seed(w)
    plane = ServePlane(s)
    plane.health.wedge_s = 0.3   # injectable bound (default 30 s)
    gate = threading.Event()
    orig = plane.batcher._serve_batch

    def stuck(reqs):
        if any(int(r.keys[0]) == 77 for r in reqs):
            gate.wait(30)   # the injected wedge
        return orig(reqs)

    plane.batcher._serve_batch = stuck
    assert plane.health.readiness()["ready"]
    wedge_req = LookupRequest(np.array([77]), lane=1)
    plane.queue.submit(wedge_req)
    deadline = time.monotonic() + 10
    flipped = False
    while time.monotonic() < deadline:
        t0 = time.monotonic()
        rd = plane.health.readiness()
        assert time.monotonic() - t0 < 5.0, "readiness probe blocked"
        if not rd["ready"] and rd["wedged_dispatchers"] == [1]:
            assert any("wedged" in x for x in rd["reasons"])
            flipped = True
            break
        time.sleep(0.02)
    assert flipped, "wedged dispatcher did not flip readiness in bound"
    assert s.metrics_snapshot()["serve"]["ready"] == 0
    # the healthy dispatcher (lane 0) still serves while 1 is stuck
    ok_req = LookupRequest(np.array([3]), lane=0)
    plane.queue.submit(ok_req)
    assert ok_req.wait(30)
    assert np.array_equal(ok_req.take_result(), vals[3])
    # release the wedge: the claimed request completes, ready recovers
    gate.set()
    assert wedge_req.wait(30)
    assert np.array_equal(wedge_req.take_result(), vals[77])
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        rd = plane.health.readiness()
        if rd["ready"] and rd["wedged_dispatchers"] == []:
            break
        time.sleep(0.02)
    assert plane.health.readiness()["ready"]
    plane.batcher._serve_batch = orig
    plane.close()
    s.shutdown()


def test_dispatchers_one_no_tenants_is_inert(ctx):
    """The default knobs (--sys.serve.dispatchers 1, no
    tenants, no replica) keep the single-consumer FIFO path and carry
    the serve sections present-but-inert."""
    s = make_server(ctx)
    w = s.make_worker(0)
    vals = _seed(w)
    plane = ServePlane(s)
    assert plane.batcher.dispatchers == 1
    assert plane.replica is None
    assert plane.queue.lanes == 1 and not plane.queue._has_qos
    sess = plane.session()
    assert np.array_equal(sess.lookup(np.array([5]))[0], vals[5])
    snap = s.metrics_snapshot()
    assert snap["serve"]["replica_hit_rate"] == 0.0
    assert snap["serve"]["replica_hits_total"] == 0
    assert snap["serve"]["lane_depth.0"] == 0
    assert snap["serve"]["readiness"]["dispatchers"] == 1
    assert snap["serve"]["readiness"]["wedged_dispatchers"] == []
    assert not any(k.startswith("tenant.") for k in snap["serve"])
    plane.close()
    s.shutdown()


# ---------------------------------------------------------------------------
# bag reads (K8 on the fused path), degraded windows, the cost table, the
# SLO controller, and the cross-package check
# ---------------------------------------------------------------------------


def _bag_reference(w, tables, bags, pooling):
    """pool_bags_host over Worker.pull of each table's members."""
    out = []
    for ks, bg in zip(tables, bags):
        seg = np.repeat(np.arange(len(bg) - 1), np.diff(bg)).astype(np.int32)
        out.append(pool_bags_host(w.pull_sync(ks), seg, len(bg) - 1,
                                  pooling))
    return out


def test_lookup_bags_every_path_bitwise(ctx):
    """Bag reads through the fused path (K8's plain version here), the
    flat union + host pool (`serve_bags` off) and the replica snapshot
    all return pool_bags_host over Worker.pull, bit for bit: duplicate
    members, empty bags, two tables, both poolings."""
    opts = SystemOptions(sync_max_per_sec=0, serve_replica_rows=64,
                         serve_replica_refresh_ms=1000.0)
    s = make_server(ctx, opts=opts)
    w = s.make_worker(0)
    rng = np.random.default_rng(3)
    w.wait(w.set(np.arange(NK),
                 rng.normal(size=(NK, VL)).astype(np.float32)))
    tables = [np.array([5, 5, 9, 1, 40, 41, 41]), np.array([7, 3, 3])]
    bags = [np.array([0, 3, 3, 7]), np.array([0, 0, 3])]
    plane = ServePlane(s)
    sess = plane.session(worker=w)
    c = {k: s.obs.find(f"serve.{k}") for k in
         ("bag_fused_total", "bag_hostpool_total",
          "bag_replica_hits_total")}
    for pooling in ("sum", "mean"):
        ref = _bag_reference(w, tables, bags, pooling)
        got = sess.lookup_bags(tables, bags, pooling=pooling)
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert c["bag_fused_total"].value == 2
    plane.opts.serve_bags = False
    ref = _bag_reference(w, tables, bags, "mean")
    got = sess.lookup_bags(tables, bags, pooling="mean")
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert c["bag_hostpool_total"].value == 1
    assert plane.replica.refresh_now() > 0
    got = sess.lookup_bags(tables, bags, pooling="mean")
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert c["bag_replica_hits_total"].value == 1
    with pytest.raises(ValueError, match="pooling"):
        sess.lookup_bags(tables, bags, pooling="max")
    with pytest.raises(ValueError, match="offsets"):
        sess.lookup_bags(tables, [np.array([0, 2]), bags[1]])
    plane.close()
    s.shutdown()


def test_degraded_window_sheds_loudly(ctx):
    s = make_server(ctx)
    w = s.make_worker(0)
    vals = _seed(w)
    plane = ServePlane(s)
    sess = plane.session()
    s.begin_degraded("maintenance")
    assert s.degraded and s.degraded_reason == "maintenance"
    with pytest.raises(ServeDegradedError, match="maintenance"):
        sess.lookup(np.array([1]))
    with pytest.raises(ServeDegradedError):
        sess.lookup_bags([np.array([1, 2])], [np.array([0, 2])])
    rd = plane.health.readiness()
    assert not rd["ready"] and rd["degraded"] == "maintenance"
    assert s.obs.find("serve.degraded_shed_total").value == 2
    s.end_degraded()
    assert plane.health.readiness()["ready"]
    assert np.array_equal(sess.lookup(np.array([1]))[0], vals[1])
    assert s.dead_nodes() == []
    plane.close()
    s.shutdown()


def test_cost_table_calibrates_and_steers_bag_dispatch(ctx, tmp_path):
    """--sys.costs.table with calibrate: the Server measures K1 and K8 on
    its stores and writes the table; a table that measures the host
    pool cheaper for the batch's shape reroutes it (same bits)."""
    from adapm_tpu_torch.ops.costs import KernelCostTable
    path = str(tmp_path / "costs.json")
    s = make_server(ctx, opts=SystemOptions(
        sync_max_per_sec=0, costs_table=path, costs_calibrate=True))
    assert s.costs is not None and len(s.costs) > 0
    entries = KernelCostTable.load(path).entries()
    assert entries == s.costs.entries()
    assert {k.split("|")[0] for k in entries} == {
        "gather", "gather_pool", "gather_hostpool"}
    w = s.make_worker(0)
    _seed(w)
    tables, bags = [np.array([1, 2, 3, 4])], [np.array([0, 2, 4])]
    ref = _bag_reference(w, tables, bags, "sum")
    for k in list(s.costs._us):
        if k.startswith("gather_pool|"):
            s.costs._us[k] = 1e9          # K8 measured slower
    plane = ServePlane(s)
    got = plane.session().lookup_bags(tables, bags)
    assert np.array_equal(got[0], ref[0])
    snap = s.metrics_snapshot()
    assert snap["device"]["costs_consults_total"] >= 1
    assert snap["device"]["costs_overrides_total"] == 1
    assert snap["serve"]["bag_hostpool_total"] == 1
    plane.close()
    s.shutdown()


def test_slo_controller_reports_in_snapshot(ctx):
    """--sys.serve.slo_ms builds the SLO controller; its report lands in
    the snapshot's slo section, and close() stops it."""
    s = make_server(ctx, opts=SystemOptions(sync_max_per_sec=0,
                                            serve_slo_ms=50.0,
                                            serve_slo_class="1=20"))
    w = s.make_worker(0)
    vals = _seed(w)
    plane = ServePlane(s)
    assert plane.slo is not None
    assert plane.batcher.class_wait_us == {1: plane.batcher.max_wait_us}
    sess = plane.session()
    for i in range(8):
        assert np.array_equal(sess.lookup(np.array([i]))[0], vals[i])
    slo = s.metrics_snapshot()["slo"]
    assert slo["active"] and slo["target_ms"] == 50.0
    assert slo["class_targets_ms"] == {"1": 20.0}
    plane.close()
    s.shutdown()


def test_same_replies_as_the_jax_serve_plane_bitwise():
    """One scripted sequence of sets, pushes, lookups and bag reads on a
    JAX ServePlane and a port ServePlane (CPU, 8 shards each): every
    reply bitwise equal."""
    import adapm_tpu
    from adapm_tpu.parallel.mesh import make_mesh
    from adapm_tpu.serve import ServePlane as JaxServePlane
    replies = []
    for pkg, plane_cls, c in (
            (adapm_tpu, JaxServePlane, make_mesh(8)),
            (__import__("adapm_tpu_torch"), ServePlane,
             make_context(8, "cpu"))):
        s = pkg.Server(NK, 8, ctx=c, opts=pkg.SystemOptions(
            sync_max_per_sec=0, serve_replica_rows=32))
        w = s.make_worker(0)
        rng = np.random.default_rng(5)
        w.wait(w.set(np.arange(NK),
                     rng.normal(size=(NK, 8)).astype(np.float32)))
        plane = plane_cls(s)
        sess = plane.session(worker=w)
        out = []
        for step in range(12):
            k = rng.integers(0, NK, 10)
            w.wait(w.push(k, rng.normal(size=(10, 8)).astype(np.float32)))
            out.append(sess.lookup(rng.integers(0, NK, 16)))
            nb = int(rng.integers(1, 6))
            sizes = rng.integers(0, 5, nb)
            sizes[0] = max(1, sizes[0])
            mem = rng.integers(0, NK, int(sizes.sum()))
            bg = np.concatenate([[0], np.cumsum(sizes)])
            pooling = ("sum", "mean")[step % 2]
            out.extend(sess.lookup_bags([mem], [bg], pooling=pooling))
            if step == 6:
                plane.replica.refresh_now()
        plane.close()
        s.shutdown()
        replies.append(out)
    for a, b in zip(*replies):
        assert np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                              np.asarray(b, np.float32).view(np.uint32))
