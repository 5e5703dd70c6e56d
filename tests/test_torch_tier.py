"""Tiered parameter storage of the port (adapm_tpu_torch/tier,
core/store.py's tiered branches, the fused runners' tier translation)
against the JAX package's, scenario by scenario.

The scenarios of tests/test_tier.py run on both packages (8 shards:
`adapm_tpu.setup` on the 8-device CPU mesh beside
`adapm_tpu_torch.setup(..., num_shards=8, device="cpu")`) with the same
seeds. Each keeps the JAX test's own checks, run on each package, and
returns what it read; the reads are compared bitwise across packages.
The device-routed negatives scenario holds tiered to untiered bitwise
within each package (the packages' negative draws come from different
generators). The two checkpoint cases (`test_checkpoint_roundtrip_across_
tiers`, `test_untiered_checkpoint_restores_into_tiered`) run on both
packages too. The storm and the shutdown case run under each
package's lock-order sentinel (`--sys.lint.lockorder`), which must
record edges and no violation. Left out: the shutdown case runs without
the periodic checkpointer.
"""
import threading

import numpy as np
import pytest
import torch

import adapm_tpu
import adapm_tpu_torch

E = 384
L = 8
D = L // 2


class Pkg:
    def __init__(self, mod):
        self.mod = mod
        self.is_jax = mod is adapm_tpu
        self.SystemOptions = mod.SystemOptions
        base = __import__(f"{mod.__name__}.base", fromlist=["x"])
        self.CLOCK_MAX = base.CLOCK_MAX
        self.MgmtTechniques = base.MgmtTechniques
        self.OOB = __import__(f"{mod.__name__}.core.store",
                              fromlist=["x"]).OOB
        ops = __import__(f"{mod.__name__}.ops", fromlist=["x"])
        self.DeviceRoutedRunner = ops.DeviceRoutedRunner
        self.ServePlane = __import__(f"{mod.__name__}.serve",
                                     fromlist=["x"]).ServePlane
        ck = __import__(f"{mod.__name__}.utils.checkpoint",
                        fromlist=["x"])
        self.save_server = ck.save_server
        self.restore_server = ck.restore_server

    def setup(self, num_keys, vlen, opts):
        if self.is_jax:
            return adapm_tpu.setup(num_keys, vlen, opts=opts)
        return adapm_tpu_torch.setup(num_keys, vlen, opts=opts,
                                     num_shards=8, device="cpu")

    def mk(self, tier, hot_rows=16, **kw):
        opts = self.SystemOptions(sync_max_per_sec=0, prefetch=False,
                                  tier=tier, tier_hot_rows=hot_rows, **kw)
        return self.setup(E, L, opts)

    def neg_loss(self):
        if self.is_jax:
            import jax.numpy as jnp

            def loss(embs, aux):
                return jnp.mean(jnp.sum(embs["a"][:, None, :] * embs["n"],
                                        axis=-1))
            return loss

        def loss(embs, aux):
            return torch.mean(torch.sum(embs["a"][:, None, :] * embs["n"],
                                        dim=-1))
        return loss


JAX, PORT = Pkg(adapm_tpu), Pkg(adapm_tpu_torch)


def _read_all(srv):
    return np.asarray(srv.read_main(np.arange(E)))


def _both(scenario, *args):
    """Run a scenario on both packages; return (jax, port) results."""
    return scenario(JAX, *args), scenario(PORT, *args)


def _sentinel_clean(P):
    """The package's lock-order sentinel recorded edges and no violation;
    then it is torn down."""
    lockorder = __import__(f"{P.mod.__name__}.lint.lockorder",
                           fromlist=["x"])
    sen = lockorder.get_sentinel()
    assert sen is not None and sen.edges(), \
        "sentinel saw no lock edges: the scenario exercised nothing"
    sen.assert_clean()
    lockorder.disable_sentinel()


@pytest.fixture
def port_sentinel():
    """The port's lock-order sentinel, off before the test and torn down
    after it (the shared conftest tears down only the JAX package's)."""
    from adapm_tpu_torch.lint import lockorder
    lockorder.disable_sentinel()
    yield
    lockorder.disable_sentinel()


def _same_reads(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(np.asarray(x), np.asarray(y)), \
            f"read {i} differs across packages"


# -- the scenarios -----------------------------------------------------------


def sc_storm(P):
    """test_tier.py's acceptance storm: push (duplicates), set,
    relocation, replica churn, sync rounds, promote and demote on a
    tiered server beside an untiered shadow; every read bitwise the
    shadow's at every step and after quiesce, under the lock-order
    sentinel."""
    rng = np.random.default_rng(0)
    srv = P.mk(True, hot_rows=16, lint_lockorder=True)
    ref = P.mk(False)
    w, wr = srv.make_worker(0), ref.make_worker(0)
    vals = rng.normal(size=(E, L)).astype(np.float32)
    for ww in (w, wr):
        ww.set(np.arange(E), vals)
    keys = np.arange(E)
    reads = []
    for step in range(50):
        op = rng.integers(0, 7)
        if op == 0:
            ks = rng.integers(0, E, 24)
            v = rng.normal(size=(24, L)).astype(np.float32)
            w.push(ks, v)
            wr.push(ks, v)
        elif op == 1:
            ks = rng.choice(E, 16, replace=False)
            v = rng.normal(size=(16, L)).astype(np.float32)
            w.set(ks, v)
            wr.set(ks, v)
        elif op == 2:
            ks = rng.choice(E, 12, replace=False)
            dest = int(rng.integers(0, srv.num_shards))
            srv._relocate_to(ks, dest)
            ref._relocate_to(ks, dest)
        elif op == 3:
            ks = rng.choice(keys[srv.ab.owner[keys] != w.shard], 16,
                            replace=False)
            end = int(w.current_clock + rng.integers(1, 4))
            w.intent(ks, w.current_clock, end)
            wr.intent(ks, wr.current_clock, end)
            srv.sync.run_round(force_intents=True, all_channels=True)
            ref.sync.run_round(force_intents=True, all_channels=True)
        elif op == 4:
            srv.sync.run_round(force_intents=True, all_channels=True)
            ref.sync.run_round(force_intents=True, all_channels=True)
        elif op == 5:
            srv.tier.promote_keys(rng.choice(E, 32, replace=False))
        else:
            srv.tier.demote_keys(rng.choice(E, 32, replace=False))
            srv.tier.maintain()
        if rng.integers(0, 3) == 0:
            w.advance_clock()
            wr.advance_clock()
        a = _read_all(srv)
        assert np.array_equal(a, _read_all(ref)), \
            f"step {step} (op {op}): tiered read diverged from the shadow"
        pk = rng.integers(0, E, 20)
        p = np.asarray(w.pull_sync(pk))
        assert np.array_equal(p, np.asarray(wr.pull_sync(pk))), \
            f"step {step}: pull diverged"
        reads += [a, p]
    srv.quiesce()
    ref.quiesce()
    a = _read_all(srv)
    assert np.array_equal(a, _read_all(ref)), "after quiesce"
    srv.shutdown()
    ref.shutdown()
    _sentinel_clean(P)
    return reads + [a]


def sc_capacity(P):
    rng = np.random.default_rng(0)
    srv = P.mk(True, hot_rows=8)
    w = srv.make_worker(0)
    w.set(np.arange(E), rng.normal(size=(E, L)).astype(np.float32))
    srv.tier.promote_keys(np.arange(E))
    st = srv.stores[0]
    for s in range(st.res.num_shards):
        assert st.res.hot_count(s) <= st.res.hot_rows
    pulled = np.asarray(w.pull_sync(np.arange(E))).ravel()
    assert np.array_equal(pulled, _read_all(srv))
    assert st.tier_cold_hits > 0
    srv.shutdown()
    return [pulled]


def sc_intent_pins(P):
    rng = np.random.default_rng(0)
    srv = P.mk(True, hot_rows=16, tier_demote_batch=4,
               techniques=P.MgmtTechniques.REPLICATION_ONLY)
    w = srv.make_worker(0)
    w.set(np.arange(E), rng.normal(size=(E, L)).astype(np.float32))
    pinned = np.arange(0, 32)
    w.intent(pinned, 0, P.CLOCK_MAX)
    srv.sync.run_round(force_intents=True, all_channels=True)
    srv.tier.maintain()
    st = srv.stores[0]
    o_sh, o_sl = srv.ab.owner[pinned], srv.ab.slot[pinned]
    assert (st.res.dev_row[o_sh, o_sl] >= 0).all(), \
        "intent-pinned keys were not promoted"
    srv.tier.promote_keys(np.arange(64, E))
    srv.tier.maintain()
    assert (st.res.dev_row[srv.ab.owner[pinned],
                           srv.ab.slot[pinned]] >= 0).all(), \
        "pressure demotion evicted intent-pinned rows"
    out = [_read_all(srv)]
    srv.shutdown()
    return out


def sc_epoch(P):
    rng = np.random.default_rng(0)
    srv = P.mk(True, hot_rows=16)
    w = srv.make_worker(0)
    w.set(np.arange(E), rng.normal(size=(E, L)).astype(np.float32))
    e0 = srv.tier.epoch
    srv.tier.promote_keys(np.arange(0, 16))
    e1 = srv.tier.epoch
    assert e1 > e0
    srv.tier.demote_keys(np.arange(0, 8))
    assert srv.tier.epoch > e1
    out = [_read_all(srv)]
    srv.shutdown()
    return out


def sc_metrics(P):
    rng = np.random.default_rng(0)
    srv = P.mk(True, hot_rows=16)
    w = srv.make_worker(0)
    w.set(np.arange(E), rng.normal(size=(E, L)).astype(np.float32))
    got = np.asarray(w.pull_sync(np.arange(0, 64)))
    srv.tier.promote_keys(np.arange(0, 16))
    t = srv.metrics_snapshot()["tier"]
    assert t["promotions"] >= 16
    assert 0.0 <= t["hot_hit_rate"] <= 1.0
    assert t["hot_rows_used"] <= t["hot_rows_capacity"]
    assert "cold_serve_s" in t
    for k in ("cold_bytes_per_row", "ef_resid_rows", "ef_evicted",
              "demotions", "epoch"):
        assert k in t, k
    srv.shutdown()
    return [got]


def sc_compose_oob(P):
    rng = np.random.default_rng(0)
    srv = P.mk(True, hot_rows=16)
    w = srv.make_worker(0)
    w.set(np.arange(E), rng.normal(size=(E, L)).astype(np.float32))
    srv.tier.promote_keys(np.arange(0, 32))
    eff = srv.tier.compose_slot_table()
    assert (eff >= 0).all()
    res = srv.stores[0].res
    rows = res.dev_row[srv.ab.owner[np.arange(E)],
                       srv.ab.slot[np.arange(E)]]
    assert (eff[rows < 0] == P.OOB).all(), "cold rows must mirror as OOB"
    assert np.array_equal(eff[rows >= 0], rows[rows >= 0])
    srv.shutdown()
    return [eff >= 0]


def sc_neg_bitwise(P):
    """Device-routed steps with device-drawn negatives, tiered vs
    untiered: with the population kept device-resident the whole
    trajectory is bitwise the same."""
    pop = np.arange(0, 64)
    outs = []
    for tier in (True, False):
        srv = P.mk(tier, hot_rows=32)
        w = srv.make_worker(0)
        vals = np.random.default_rng(5).normal(size=(E, L)).astype(
            np.float32)
        vals[:, D:] = np.abs(vals[:, D:])
        w.set(np.arange(E), vals)
        w.intent(pop, 0, P.CLOCK_MAX)
        srv.sync.run_round(force_intents=True, all_channels=True)
        if tier:
            srv.tier.promote_keys(pop)
        run = P.DeviceRoutedRunner(
            srv, P.neg_loss(), {"a": 0, "n": 0}, {"a": D, "n": D},
            shard=0, neg_role="n", neg_shape=(8, 4), neg_population=pop,
            seed=11)
        kb = np.random.default_rng(6)
        for _ in range(5):
            run({"a": kb.choice(pop, 8, replace=False)}, None, lr=0.05)
        outs.append(_read_all(srv))
        srv.shutdown()
    assert np.array_equal(outs[0], outs[1]), \
        "device-drawn negatives diverged under tier"
    return outs[0]


def sc_neg_fallback(P):
    """All-cold population owned by other shards: the negative index
    promotes a slice of it and draws from the resident part."""
    srv = P.mk(True, hot_rows=32)
    w = srv.make_worker(0)
    vals = np.random.default_rng(5).normal(size=(E, L)).astype(np.float32)
    vals[:, D:] = np.abs(vals[:, D:])
    w.set(np.arange(E), vals)
    pop = np.arange(E)[srv.ab.owner[np.arange(E)] != 0][:48]
    run = P.DeviceRoutedRunner(
        srv, P.neg_loss(), {"a": 0, "n": 0}, {"a": D, "n": D}, shard=0,
        neg_role="n", neg_shape=(8, 4), neg_population=pop, seed=3)
    run({"a": np.arange(0, 8)}, None, lr=0.05)
    res = srv.stores[0].res
    o_sh, o_sl = srv.ab.owner[pop], srv.ab.slot[pop]
    hot = res.dev_row[o_sh, o_sl] >= 0
    assert hot.any(), "fallback did not promote any population rows"
    srv.shutdown()
    return hot


def sc_two_servers(P):
    """Two tiered servers in one process dispatch concurrently (tier
    maintenance on both executors, a driving thread each); every join
    is bounded."""
    rng = np.random.default_rng(0)
    srv1 = P.mk(True, hot_rows=16)
    srv2 = P.mk(True, hot_rows=16)
    vals = rng.normal(size=(E, L)).astype(np.float32)
    w1, w2 = srv1.make_worker(0), srv2.make_worker(0)
    w1.set(np.arange(E), vals)
    w2.set(np.arange(E), vals)
    errs = []

    def churn(srv, w, seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(12):
                ks = r.integers(0, E, 16)
                w.push(ks, r.normal(size=(16, L)).astype(np.float32))
                srv.tier.promote_keys(r.choice(E, 24, replace=False))
                srv.tier.demote_keys(r.choice(E, 24, replace=False))
                srv.tier.engine.kick()
                w.pull_sync(r.integers(0, E, 16))
        except BaseException as e:  # noqa: BLE001 — surface in-thread
            errs.append(e)

    ts = [threading.Thread(target=churn, args=(srv1, w1, 1)),
          threading.Thread(target=churn, args=(srv2, w2, 2))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts), "concurrent dispatch stalled"
    assert not errs, errs
    out = [_read_all(srv1), _read_all(srv2)]
    srv1.shutdown()
    srv2.shutdown()
    return out


def sc_shutdown(P):
    rng = np.random.default_rng(0)
    srv = P.mk(True, hot_rows=16, lint_lockorder=True)
    w = srv.make_worker(0)
    w.set(np.arange(E), rng.normal(size=(E, L)).astype(np.float32))
    plane = P.ServePlane(srv)
    got = np.asarray(plane.session().lookup(np.arange(8)))
    srv.tier.engine.kick()
    srv.start_sync_thread()
    srv.shutdown()
    assert srv._sync_thread is None
    assert not plane.batcher.is_alive()
    assert srv.exec.closed
    assert srv.exec.live_streams() == []
    srv.shutdown()
    c = srv.exec.submit("tier", lambda: 1)
    assert c.done() and c.cancelled
    srv2 = P.mk(True, hot_rows=16)
    p2 = P.ServePlane(srv2)
    p2.close()
    p2.close()
    srv2.shutdown()
    srv2.shutdown()
    _sentinel_clean(P)
    return [got]


@pytest.mark.parametrize("scenario", [
    sc_storm, sc_capacity, sc_intent_pins, sc_epoch, sc_metrics,
    sc_compose_oob, sc_neg_fallback, sc_two_servers, sc_shutdown],
    ids=lambda f: f.__name__[3:])
def test_tier_scenario_both_packages(scenario, port_sentinel):
    a, b = _both(scenario)
    _same_reads(a, b)


def test_device_routed_negatives_under_tier():
    # bitwise tiered vs untiered inside each package (the scenario's own
    # check); the packages draw their negatives from different
    # generators (jax.random, torch.Generator), so the trained rows are
    # not compared across them
    for P in (JAX, PORT):
        out = sc_neg_bitwise(P)
        assert np.isfinite(out).all()


def test_tier_bag_reads_through_cold_members():
    """A tiered store's bag reads (gather_pool_tiered: K8 without cold
    members, K10 with) are bitwise host pooling of the same server's
    pulls and bitwise the JAX package's, for every cold format."""
    outs = {}
    for P in (JAX, PORT):
        res = []
        for mode in ("fp32", "fp16", "int8"):
            srv = P.mk(True, hot_rows=16, tier_cold_dtype=mode)
            # no background promotion: a promoted row of a quantized
            # store reads its exact value, a cold one its dequantized
            # value, so residency must not move between the reads
            srv.tier.engine.kick = lambda: None
            w = srv.make_worker(0)
            w.set(np.arange(E), np.random.default_rng(3).normal(
                size=(E, L)).astype(np.float32))
            srv.tier.promote_keys(np.arange(0, 40))
            plane = P.ServePlane(srv)
            sess = plane.session()
            members = np.random.default_rng(4).integers(0, E, 64)
            offs = np.array([0, 3, 3, 10, 30, 64])
            bags = __import__(f"{P.mod.__name__}.serve.bags",
                              fromlist=["x"])
            for pooling in ("sum", "mean"):
                got = np.asarray(sess.lookup_bags([members], [offs],
                                                  pooling=pooling)[0])
                rows = np.asarray(w.pull_sync(members)).reshape(-1, L)
                want = bags.pool_bags_host(
                    rows, np.repeat(np.arange(5), np.diff(offs)), 5,
                    pooling)
                assert np.array_equal(got, want), (mode, pooling)
                res.append(got)
            plane.close()
            srv.shutdown()
        outs[P.is_jax] = res
    _same_reads(outs[True], outs[False])


def test_jax_tiered_state_loads_into_the_port():
    """weights.from_jax_arrays with `tiers`: a JAX tiered server's hot
    pool, residency maps and int8 cold store (scales and the residual
    map) load into the port's tiered server; reads agree bitwise, and
    again after the same pushes, promotions and demotions on both."""
    from adapm_tpu_torch.weights import from_jax_arrays
    srvs = []
    for P in (JAX, PORT):
        srv = P.mk(True, hot_rows=16, tier_cold_dtype="int8")
        # no background promotion: a promoted row reads its exact value,
        # a cold one its dequantized value
        srv.tier.engine.kick = lambda: None
        srvs.append(srv)
    j, t = srvs
    rng = np.random.default_rng(7)
    w = j.make_worker(0)
    w.set(np.arange(E), rng.normal(size=(E, L)).astype(np.float32))
    w.push(rng.integers(0, E, 64), rng.normal(size=(64, L)).astype(
        np.float32))
    j.tier.promote_keys(rng.choice(E, 48, replace=False))
    j.tier.demote_keys(rng.choice(E, 24, replace=False))
    st = j.stores[0]
    tiers = [dict(dev_row=st.res.dev_row, row_slot=st.res.row_slot,
                  score=st.res.score, pin_until=st.res.pin_until,
                  q=st.coldq.q, scale=st.coldq.scale, resid=st.coldq.resid)]
    pools = [tuple(np.asarray(p) for p in (st.main, st.cache, st.delta))]
    assert len(st.coldq.resid) > 0
    from_jax_arrays(t, pools, j.ab.owner, j.ab.slot, j.ab.cache_slot,
                    tiers=tiers)
    wt = t.make_worker(0)
    _same_reads([_read_all(j)], [_read_all(t)])
    for step in range(4):
        ks = rng.integers(0, E, 32)
        v = rng.normal(size=(32, L)).astype(np.float32)
        w.push(ks, v)
        wt.push(ks, v)
        pk = rng.choice(E, 40, replace=False)
        j.tier.promote_keys(pk)
        t.tier.promote_keys(pk)
        dk = rng.choice(E, 20, replace=False)
        j.tier.demote_keys(dk)
        t.tier.demote_keys(dk)
        _same_reads([_read_all(j), w.pull_sync(ks)],
                    [_read_all(t), wt.pull_sync(ks)])
    j.shutdown()
    t.shutdown()


# -- checkpoints across tier configurations -----------------------------------


def sc_checkpoint_roundtrip_across_tiers(P, tmp, restore_tier):
    """test_tier.py's case: a tiered server with mixed residency and
    replicas carrying unshipped deltas saves; the checkpoint restores
    bitwise into a tiered (everything cold) or an untiered server, and
    both keep syncing and taking writes bitwise."""
    rng = np.random.default_rng(0)
    srv = P.mk(True, hot_rows=16)
    w = srv.make_worker(0)
    w.set(np.arange(E), rng.normal(size=(E, L)).astype(np.float32))
    srv.tier.promote_keys(np.arange(0, 128))
    rem = np.arange(E)[srv.ab.owner[np.arange(E)] != w.shard][:32]
    w.intent(rem, 0, P.CLOCK_MAX)
    srv.sync.run_round(force_intents=True, all_channels=True)
    w.push(rem, rng.normal(size=(len(rem), L)).astype(np.float32))
    path = str(tmp / "ck.npz")
    P.save_server(srv, path)
    before = _read_all(srv)
    srv2 = P.mk(restore_tier, hot_rows=16)
    P.restore_server(srv2, path)
    if restore_tier:
        # residency reset cleanly: everything cold (checked before the
        # first read, whose cold misses kick the maintenance worker)
        for st in srv2.stores:
            assert (st.res.dev_row < 0).all()
            assert (st.res.row_slot < 0).all()
            assert st.res.alloc.num_free(0) == st.res.hot_rows
    reads = [before, _read_all(srv2)]
    assert np.array_equal(reads[-1], before)
    if restore_tier:
        srv2.tier.promote_keys(np.arange(0, 64))
        assert np.array_equal(_read_all(srv2), before)
    w2 = srv2.make_worker(0)
    srv2.sync.run_round(force_intents=True, all_channels=True)
    srv.sync.run_round(force_intents=True, all_channels=True)
    before = _read_all(srv)
    assert np.array_equal(_read_all(srv2), before)
    ks = np.arange(0, 16)
    v = rng.normal(size=(16, L)).astype(np.float32)
    w2.push(ks, v)
    srv2.quiesce()
    expect = before.reshape(E, L).copy()
    expect[ks] += v
    got = _read_all(srv2)
    assert np.array_equal(got.reshape(E, L), expect)
    srv.shutdown()
    srv2.shutdown()
    return reads + [before, got]


def sc_untiered_checkpoint_restores_into_tiered(P, tmp):
    rng = np.random.default_rng(0)
    src = P.mk(False)
    w = src.make_worker(0)
    w.set(np.arange(E), rng.normal(size=(E, L)).astype(np.float32))
    path = str(tmp / "ck.npz")
    P.save_server(src, path)
    before = _read_all(src)
    dst = P.mk(True, hot_rows=16)
    P.restore_server(dst, path)
    got = _read_all(dst)
    assert np.array_equal(got, before)
    src.shutdown()
    dst.shutdown()
    return [before, got]


def _both_tmp(tmp_path, scenario, *args):
    out = []
    for P in (JAX, PORT):
        d = tmp_path / ("jax" if P.is_jax else "port")
        d.mkdir()
        out.append(scenario(P, d, *args))
    return out


@pytest.mark.parametrize("restore_tier", [True, False])
def test_checkpoint_roundtrip_across_tiers(tmp_path, restore_tier):
    a, b = _both_tmp(tmp_path, sc_checkpoint_roundtrip_across_tiers,
                     restore_tier)
    _same_reads(a, b)


def test_untiered_checkpoint_restores_into_tiered(tmp_path):
    a, b = _both_tmp(tmp_path, sc_untiered_checkpoint_restores_into_tiered)
    _same_reads(a, b)


def test_promotion_wants_never_lost_under_concurrent_drain():
    """The port's want queue: producers append while a drain swaps the
    list (the maintenance pass); every want appended lands in exactly
    one drain. 8 producers of 8 wants each stay under the queue's
    64-entry window, so none is trimmed; the switch interval is cut so
    the threads interleave inside the append and the swap."""
    import sys
    import time
    from adapm_tpu_torch.tier.residency import Residency
    res = Residency(2, 64, 16)
    taken, stop = [], threading.Event()

    def produce(p):
        for i in range(8):
            res.request_promote(np.array([p % 2]), np.array([8 * p + i]))

    def drain():
        while not stop.is_set():
            taken.extend(res.take_wants())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        d = threading.Thread(target=drain)
        d.start()
        ps = [threading.Thread(target=produce, args=(p,)) for p in range(8)]
        for t in ps:
            t.start()
        for t in ps:
            t.join(timeout=30)
        time.sleep(0.01)
        stop.set()
        d.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not d.is_alive() and not any(t.is_alive() for t in ps)
    taken.extend(res.take_wants())
    got = sorted(int(sl[0]) for _, sl in taken)
    assert got == list(range(64)), "a promotion want was lost or doubled"
    assert all(len(sh) == len(sl) == 1 for sh, sl in taken)
