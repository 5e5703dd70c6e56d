"""Episodic execution of the port (adapm_tpu_torch/device/episode.py)
against the JAX package's, with test_episode.py's scenarios.

The storm runs on both packages (8 shards, the same seeds): a tiered
server driven by an EpisodicRunner under push / set / relocation /
replica churn / sync rounds / serve lookups beside an untiered
sequential shadow — every loss, read, pull and lookup bitwise the
shadow's within each package. Across the packages the fused model math
differs in the last bits (autograd and XLA group the sums differently),
so the final tables are held to rtol 1e-5 / atol 1e-6. The mechanics
cases (partition, the inline degradation, FusedStepRunner's pin-only
prep, the snapshot sections, the port boundary, the knob) run on the
port. The storm's tiered server runs under each package's lock-order
sentinel (`--sys.lint.lockorder`), which must record edges and no
violation.
"""
import numpy as np
import pytest
import torch

import adapm_tpu
import adapm_tpu_torch
from adapm_tpu_torch.config import SystemOptions
from adapm_tpu_torch.device import EpisodicRunner, plan_episodes
from adapm_tpu_torch.ops import FusedStepRunner

E = 384
L = 8
D = L // 2


def _torch_loss(embs, aux):
    return torch.mean(torch.sum(embs["a"] * embs["b"], dim=-1))


def _jax_loss(embs, aux):
    import jax.numpy as jnp
    return jnp.mean(jnp.sum(embs["a"] * embs["b"], axis=-1))


class Pkg:
    def __init__(self, mod):
        self.mod = mod
        self.is_jax = mod is adapm_tpu
        self.SystemOptions = mod.SystemOptions
        ops = __import__(f"{mod.__name__}.ops", fromlist=["x"])
        dev = __import__(f"{mod.__name__}.device", fromlist=["x"])
        self.DeviceRoutedRunner = ops.DeviceRoutedRunner
        self.EpisodicRunner = dev.EpisodicRunner
        self.ServePlane = __import__(f"{mod.__name__}.serve",
                                     fromlist=["x"]).ServePlane
        self.loss = _jax_loss if self.is_jax else _torch_loss

    def mk(self, tier, hot_rows=16, **kw):
        opts = self.SystemOptions(sync_max_per_sec=0, prefetch=False,
                                  tier=tier, tier_hot_rows=hot_rows, **kw)
        if self.is_jax:
            return adapm_tpu.setup(E, L, opts=opts)
        return adapm_tpu_torch.setup(E, L, opts=opts, num_shards=8,
                                     device="cpu")

    def runner(self, srv, seed=7):
        return self.DeviceRoutedRunner(srv, self.loss, {"a": 0, "b": 0},
                                       {"a": D, "b": D}, shard=0, seed=seed)


def _init_vals(rng):
    vals = rng.normal(size=(E, L)).astype(np.float32)
    vals[:, D:] = np.abs(vals[:, D:]) + 1e-3   # AdaGrad columns > 0
    return vals


def _read_all(srv):
    return np.asarray(srv.read_main(np.arange(E)))


def _batches(rng, n, bsz=16):
    return [{"a": rng.integers(0, E, bsz), "b": rng.integers(0, E, bsz)}
            for _ in range(n)]


def sc_storm(P):
    rng = np.random.default_rng(0)
    srv = P.mk(True, hot_rows=16, lint_lockorder=True)
    ref = P.mk(False)
    w, wr = srv.make_worker(0), ref.make_worker(0)
    vals = _init_vals(rng)
    for ww in (w, wr):
        ww.set(np.arange(E), vals)
    run_e = P.EpisodicRunner(P.runner(srv), episode_batches=3)
    run_s = P.runner(ref)
    plane, plane_r = P.ServePlane(srv), P.ServePlane(ref)
    sess, sess_r = plane.session(), plane_r.session()
    keys = np.arange(E)
    losses = []
    for step in range(14):
        bs = _batches(rng, int(rng.integers(3, 7)))
        le = run_e.run(bs, lr=0.05)
        ls = [run_s(b, None, lr=0.05) for b in bs]
        assert len(le) == len(bs)
        for a, b in zip(le, ls):
            assert float(a) == float(b), f"step {step}: loss diverged"
        losses += [float(a) for a in le]
        op = rng.integers(0, 6)
        if op == 0:
            ks = rng.integers(0, E, 24)
            v = rng.normal(size=(24, L)).astype(np.float32) * 1e-3
            w.push(ks, v)
            wr.push(ks, v)
        elif op == 1:
            ks = rng.choice(E, 16, replace=False)
            v = _init_vals(rng)[:16]
            w.set(ks, v)
            wr.set(ks, v)
        elif op == 2:
            ks = rng.choice(E, 12, replace=False)
            dest = int(rng.integers(0, srv.num_shards))
            srv._relocate_to(ks, dest)
            ref._relocate_to(ks, dest)
        elif op == 3:
            cand = keys[srv.ab.owner[keys] != w.shard]
            ks = rng.choice(cand, min(16, len(cand)), replace=False)
            end = int(w.current_clock + rng.integers(1, 4))
            w.intent(ks, w.current_clock, end)
            wr.intent(ks, wr.current_clock, end)
            srv.sync.run_round(force_intents=True, all_channels=True)
            ref.sync.run_round(force_intents=True, all_channels=True)
        elif op == 4:
            srv.sync.run_round(force_intents=True, all_channels=True)
            ref.sync.run_round(force_intents=True, all_channels=True)
        else:
            ks = rng.integers(0, E, 20)
            assert np.array_equal(np.asarray(sess.lookup(ks)),
                                  np.asarray(sess_r.lookup(ks))), \
                f"step {step}: serve lookup diverged"
        if rng.integers(0, 3) == 0:
            w.advance_clock()
            wr.advance_clock()
        a, b = _read_all(srv), _read_all(ref)
        assert np.array_equal(a, b), f"step {step} (op {op}): diverged"
        pk = rng.integers(0, E, 20)
        assert np.array_equal(np.asarray(w.pull_sync(pk)),
                              np.asarray(wr.pull_sync(pk)))
    srv.quiesce()
    ref.quiesce()
    final = _read_all(srv)
    assert np.array_equal(final, _read_all(ref)), "post-quiesce"
    plane.close()
    plane_r.close()
    srv.shutdown()
    ref.shutdown()
    lockorder = __import__(f"{P.mod.__name__}.lint.lockorder",
                           fromlist=["x"])
    sen = lockorder.get_sentinel()
    assert sen is not None and sen.edges(), \
        "sentinel saw no lock edges: the storm exercised nothing"
    sen.assert_clean()
    lockorder.disable_sentinel()
    return np.asarray(losses), final


@pytest.fixture
def port_sentinel():
    """The port's lock-order sentinel, off before the test and torn down
    after it (the shared conftest tears down only the JAX package's)."""
    from adapm_tpu_torch.lint import lockorder
    lockorder.disable_sentinel()
    yield
    lockorder.disable_sentinel()


def test_episodic_storm_bit_identical_to_sequential_shadow(port_sentinel):
    lj, tj = sc_storm(Pkg(adapm_tpu))
    lp, tp = sc_storm(Pkg(adapm_tpu_torch))
    np.testing.assert_allclose(lp, lj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp, tj, rtol=1e-5, atol=1e-6)


# -- mechanics (port) ----------------------------------------------------------

PORT = Pkg(adapm_tpu_torch)


def test_plan_episodes_partition_preserves_order():
    bs = [{"a": np.array([i])} for i in range(10)]
    eps = plan_episodes(bs, None, 4)
    assert [len(e.batches) for e in eps] == [4, 4, 2]
    assert [int(b["a"][0]) for e in eps for b in e.batches] == \
        list(range(10))
    eps = plan_episodes(bs, list(range(10)), 3)
    assert [e.auxes for e in eps] == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]
    with pytest.raises(ValueError):
        plan_episodes(bs, None, 0)


def test_episodic_single_stream_degrades_inline():
    vals = _init_vals(np.random.default_rng(0))
    kb = np.random.default_rng(11)
    bs = _batches(kb, 7)
    outs = []
    for single in (True, False):
        srv = PORT.mk(True, hot_rows=16, exec_single_stream=single)
        w = srv.make_worker(0)
        w.set(np.arange(E), vals)
        losses = EpisodicRunner(PORT.runner(srv),
                                episode_batches=2).run(bs, lr=0.05)
        assert len(losses) == len(bs)
        outs.append(_read_all(srv))
        srv.shutdown()
    assert np.array_equal(outs[0], outs[1])


def test_episodic_fused_step_runner_pin_only_prep():
    vals = _init_vals(np.random.default_rng(0))
    bs = _batches(np.random.default_rng(13), 6)
    outs = []
    for episodic in (True, False):
        srv = PORT.mk(True, hot_rows=16)
        w = srv.make_worker(0)
        w.set(np.arange(E), vals)
        run = FusedStepRunner(srv, _torch_loss, {"a": 0, "b": 0},
                              {"a": D, "b": D})
        if episodic:
            EpisodicRunner(run, episode_batches=2).run(bs, lr=0.05)
        else:
            for b in bs:
                run(b, None, 0.05)
        outs.append(_read_all(srv))
        srv.shutdown()
    assert np.array_equal(outs[0], outs[1])


def test_device_and_episode_snapshot_sections():
    srv = PORT.mk(True, hot_rows=16)
    w = srv.make_worker(0)
    w.set(np.arange(E), _init_vals(np.random.default_rng(0)))
    bs = _batches(np.random.default_rng(17), 4)
    EpisodicRunner(PORT.runner(srv), episode_batches=2).run(bs, lr=0.05)
    snap = srv.metrics_snapshot()
    dev = snap["device"]
    assert dev["backend"] == "torch"
    assert dev["programs_total"] > 0 and dev["wire_ingest_rows_total"] >= 0
    ep = snap["episode"]
    assert ep["episodes_total"] == 2
    assert ep["staged_batches_total"] == 4
    assert ep["prep_s"]["count"] == 2 and ep["commit_s"]["count"] == 2
    assert snap["tier"]["promotions"] > 0
    srv.shutdown()
    srv2 = PORT.mk(False, metrics=False)
    snap2 = srv2.metrics_snapshot()
    assert snap2["device"] == {} and snap2["episode"] == {}
    srv2.shutdown()


def test_port_swap_is_the_backend_boundary():
    from adapm_tpu_torch.device import default_port, set_default_port

    class CountingPort:
        def __init__(self, inner):
            self._inner = inner
            self.calls = 0

        def __getattr__(self, name):
            attr = getattr(self._inner, name)
            if callable(attr) and not name.startswith("_"):
                def wrapped(*a, **kw):
                    self.calls += 1
                    return attr(*a, **kw)
                return wrapped
            return attr

    counting = CountingPort(default_port())
    set_default_port(counting)
    try:
        srv = PORT.mk(True, hot_rows=16)
        w = srv.make_worker(0)
        w.set(np.arange(E), _init_vals(np.random.default_rng(0)))
        w.pull_sync(np.arange(64))
        srv.tier.promote_keys(np.arange(32))
        assert counting.calls > 0
        assert srv.stores[0].port is counting
        srv.shutdown()
    finally:
        set_default_port(None)


def test_episode_batches_knob_validation():
    with pytest.raises(ValueError, match="episode.batches"):
        SystemOptions(episode_batches=0).validate_serve()
    SystemOptions(episode_batches=3).validate_serve()


def test_suggest_episode_batches_from_cost_table():
    """The port's cost table sizes episodes as the JAX package's does."""
    from adapm_tpu.ops.costs import KernelCostTable as JT
    from adapm_tpu_torch.ops.costs import KernelCostTable as TT
    for us in (50.0, 800.0, 9000.0):
        tabs = []
        for T in (JT, TT):
            t = T()
            t.record("gather", 64, 512, "float32", "sum", us)
            tabs.append(t)
        assert tabs[0].suggest_episode_batches(8, [64]) == \
            tabs[1].suggest_episode_batches(8, [64])
        assert TT().suggest_episode_batches(8, [64]) == 8
