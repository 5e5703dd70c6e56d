"""The port's device-routed fused step (adapm_tpu_torch/ops/fused.py)
against the JAX package's DeviceRoutedRunner, on the same servers, keys
and negatives.

Negatives: jax threefry and torch Philox are different random streams,
so the parity runs pass the negatives as an ordinary "neg" role to
runners built without `neg_role`, on both packages; the device draw is
tested on its own (every draw lies in the local index, and the draw
count is right).

Tolerance: pools rtol 1e-5 / atol 1e-6 — the loss gradient and rsqrt are
float32 model math that XLA and PyTorch round differently in the last
bits; everything else (routing, gathers, ordered scatters, sync rounds)
is exact."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import adapm_tpu
import adapm_tpu_torch
from adapm_tpu.models import make_kge_loss as jax_loss
from adapm_tpu.ops import DeviceRoutedRunner as JaxRunner
from adapm_tpu.ops import FusedStepRunner as JaxHostRunner
from adapm_tpu.parallel.mesh import make_mesh
from adapm_tpu_torch.device.context import make_context
from adapm_tpu_torch.models import make_kge_loss as torch_loss
from adapm_tpu_torch.ops.fused import DeviceRoutedRunner as TorchRunner
from adapm_tpu_torch.ops.fused import FusedStepRunner as TorchHostRunner
from adapm_tpu_torch.weights import from_jax_arrays

E, R, d, B, N, S = 96, 8, 4, 12, 3, 8
ROLES = ("s", "r", "o", "neg")
RTOL, ATOL = 1e-5, 1e-6


def _servers(tech="all"):
    opts = dict(sync_max_per_sec=0, cache_slots_per_shard=32)
    j = adapm_tpu.Server(E + R, 4 * d, ctx=make_mesh(S), num_workers=2,
                         opts=adapm_tpu.SystemOptions(
                             prefetch=False,
                             techniques=adapm_tpu.MgmtTechniques(tech),
                             **opts))
    t = adapm_tpu_torch.Server(
        E + R, 4 * d, ctx=make_context(S, "cpu"), num_workers=2,
        opts=adapm_tpu_torch.SystemOptions(
            techniques=adapm_tpu_torch.MgmtTechniques(tech), **opts))
    wj = [j.make_worker(i) for i in range(2)]
    wt = [t.make_worker(i) for i in range(2)]
    vals = np.random.default_rng(0).normal(
        size=(E + R, 4 * d)).astype(np.float32) * 0.1
    vals[:, 2 * d:] = 1e-6
    wj[0].wait(wj[0].set(np.arange(E + R), vals))
    wt[0].wait(wt[0].set(np.arange(E + R), vals))
    return j, t, wj, wt


def _batch(rng):
    return {"s": rng.integers(0, E, B), "r": rng.integers(E, E + R, B),
            "o": rng.integers(0, E, B),
            "neg": rng.integers(0, E, (B, N))}


def _runners(j, t):
    rc = {k: 0 for k in ROLES}
    rd = {k: 2 * d for k in ROLES}
    return (JaxRunner(j, jax_loss("complex"), role_class=rc, role_dim=rd),
            TorchRunner(t, torch_loss("complex"), role_class=rc,
                        role_dim=rd))


def _check_pools(j, t, what):
    for sj, st in zip(j.stores, t.stores):
        for name in ("main", "cache", "delta"):
            np.testing.assert_allclose(
                getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                rtol=RTOL, atol=ATOL, err_msg=f"{what}: {name}")


def _replicate_on_shard0(j, t, wj, wt, keys):
    """REPLICATION_ONLY intents from worker 0: replicas of `keys` on
    shard 0, so the runner takes its replica variant."""
    for w in (wj[0], wt[0]):
        w.intent(keys, 0, 1000)
    j.wait_sync()
    t.wait_sync()
    np.testing.assert_array_equal(t.ab.cache_slot, j.ab.cache_slot)


@pytest.mark.parametrize("variant", ["no_replicas", "replicas"])
def test_fused_step_matches_jax_one_then_twenty_steps(variant):
    tech = "replication_only" if variant == "replicas" else "all"
    j, t, wj, wt = _servers(tech)
    rj, rt = _runners(j, t)
    if variant == "replicas":
        _replicate_on_shard0(j, t, wj, wt, np.arange(0, E + R, 3))
        assert rt._shard_has_replicas() and rj._shard_has_replicas()
    else:
        assert not rt._shard_has_replicas()
    rng = np.random.default_rng(1)
    batches = [_batch(rng) for _ in range(2)]
    losses_j, losses_t = [], []
    for step in range(21):
        b = batches[step % 2]
        losses_j.append(float(rj(b, None, 0.1)))
        losses_t.append(float(rt(b, None, 0.1)))
        if step == 0:
            _check_pools(j, t, "after one step")
        if variant == "replicas" and step % 5 == 4:
            # replica deltas merge into their owners (K3 in the sync)
            j.sync.run_round(all_channels=True)
            t.sync.run_round(all_channels=True)
    _check_pools(j, t, "after 21 steps")
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[-1] < losses_t[0]
    assert rt.locality_counts() == rj.locality_counts()
    j.quiesce()
    t.quiesce()
    _check_pools(j, t, "after quiesce")


@pytest.mark.parametrize("variant", ["owners", "replicas"])
def test_host_routed_step_matches_jax(variant):
    """FusedStepRunner (host routes, K1 cache+delta form, K3 main then
    delta per role) against the JAX runner: both workers step on their
    own shard with the same keys and negatives."""
    tech = "replication_only" if variant == "replicas" else "all"
    j, t, wj, wt = _servers(tech)
    rc = {k: 0 for k in ROLES}
    rd = {k: 2 * d for k in ROLES}
    rj = JaxHostRunner(j, jax_loss("complex"), role_class=rc, role_dim=rd)
    rt = TorchHostRunner(t, torch_loss("complex"), role_class=rc,
                         role_dim=rd)
    if variant == "replicas":
        _replicate_on_shard0(j, t, wj, wt, np.arange(0, E + R, 3))
    rng = np.random.default_rng(4)
    losses_j, losses_t = [], []
    for step in range(12):
        b = _batch(rng)
        shard = step % 2
        losses_j.append(float(rj(b, None, 0.1, shard=shard)))
        losses_t.append(float(rt(b, None, 0.1, shard=shard)))
        if step == 0:
            _check_pools(j, t, "after one step")
        if step % 4 == 3:
            j.sync.run_round(all_channels=True)
            t.sync.run_round(all_channels=True)
    _check_pools(j, t, "after 12 steps")
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert rt.n_remote == rj.n_remote and rt.steps == rj.steps == 12
    j.quiesce()
    t.quiesce()
    _check_pools(j, t, "after quiesce")


def test_alias_drawn_negatives_snap_to_local_keys():
    """neg_alias: a Vose draw over the population, each candidate snapped
    to the next locally-resident key (searchsorted, wrapping)."""
    from adapm_tpu_torch.models.sgns import build_alias_table
    t = adapm_tpu_torch.Server(E + R, 4 * d, ctx=make_context(S, "cpu"),
                               opts=adapm_tpu_torch.SystemOptions(
                                   sync_max_per_sec=0))
    w = t.make_worker(0)
    w.wait(w.set(np.arange(E + R), np.full((E + R, 4 * d), 0.1,
                                           np.float32)))
    weights = np.arange(1, E + 1, dtype=np.float64)
    prob, alias = build_alias_table(weights, power=1.0)
    rc = {k: 0 for k in ROLES}
    runner = TorchRunner(t, torch_loss("complex"), role_class=rc,
                         role_dim={k: 2 * d for k in ROLES}, shard=0,
                         neg_role="neg", neg_shape=(B, N),
                         neg_population=np.arange(E),
                         neg_alias=(prob, alias), seed=9)
    b = {k: v for k, v in _batch(np.random.default_rng(2)).items()
         if k != "neg"}
    runner(b, None, 0.1)
    idx, count = runner._local_neg_index()
    local = np.nonzero(t.ab.owner[:E] == 0)[0]
    # replay the draw from the runner's seed
    g = torch.Generator().manual_seed(9)
    u = torch.randint(0, E, (B, N), generator=g).numpy()
    v = torch.rand((B, N), generator=g).numpy()
    cand = np.where(v < prob[u], u, alias[u])
    pos = np.searchsorted(local, cand)
    snapped = local[np.where(pos >= count, 0, pos)]
    assert np.isin(snapped, local).all()
    # the draw follows the weights: the heavier half dominates
    many = torch.Generator().manual_seed(1)
    from adapm_tpu_torch.ops.fused import _draw_negatives
    tables = tuple(torch.as_tensor(x) for x in
                   (prob, alias, np.arange(E, dtype=np.int32)))
    draws = _draw_negatives((20000,), None, tables, many).numpy()
    assert (draws >= E // 2).mean() > 0.7
    snapped_t = _draw_negatives((B, N), (idx, count), tables,
                                torch.Generator().manual_seed(9)).numpy()
    np.testing.assert_array_equal(snapped_t, snapped)


def test_device_drawn_negatives_lie_in_local_index():
    t = adapm_tpu_torch.Server(E + R, 4 * d, ctx=make_context(S, "cpu"),
                               opts=adapm_tpu_torch.SystemOptions(
                                   sync_max_per_sec=0))
    w = t.make_worker(0)
    vals = np.random.default_rng(0).normal(
        size=(E + R, 4 * d)).astype(np.float32)
    w.wait(w.set(np.arange(E + R), vals))
    rc = {k: 0 for k in ROLES}
    runner = TorchRunner(t, torch_loss("complex"), role_class=rc,
                         role_dim={k: 2 * d for k in ROLES}, shard=0,
                         neg_role="neg", neg_shape=(B, N),
                         neg_population=np.arange(E), seed=5)
    b = {k: v for k, v in _batch(np.random.default_rng(2)).items()
         if k != "neg"}
    before = t.stores[0].main.clone()
    runner(b, None, 0.1)
    # replay the draw: the same generator stream over the local index
    idx, count = runner._local_neg_index()
    local = np.nonzero(t.ab.owner[:E] == 0)[0]
    np.testing.assert_array_equal(idx[:count].numpy(), local)
    g = torch.Generator().manual_seed(5)
    drawn = idx[torch.randint(0, count, (B, N), generator=g)].numpy()
    assert np.isin(drawn, local).all()
    p = runner.locality_counts()
    assert p["params"] == 3 * B + B * N and p["ops"] == 1
    # rows that changed are exactly batch keys or drawn negatives
    changed = (t.stores[0].main != before).any(-1).nonzero().numpy()
    keys_changed = {int(k) for k in range(E + R)
                    if (t.ab.owner[k], t.ab.slot[k]) in
                    {tuple(c) for c in changed}}
    assert keys_changed <= set(np.concatenate(
        [b["s"], b["r"], b["o"], drawn.ravel()]).tolist())
    assert set(drawn.ravel().tolist()) <= keys_changed


def test_from_jax_arrays_roundtrip_pulls_bitwise():
    j, t, wj, wt = _servers("all")
    rng = np.random.default_rng(3)
    # placement the default layout would never produce: relocations and
    # replicas with pending deltas
    wj[1].intent(np.arange(0, 40), 0, 1000)
    j.wait_sync()
    wj[0].intent(np.arange(20, 60), 0, 1000)
    j.wait_sync()
    for i in (0, 1):
        k = rng.integers(0, E + R, 30)
        wj[i].wait(wj[i].push(k, rng.normal(size=(30, 4 * d))
                              .astype(np.float32)))
    assert j.ab.replica_count.sum() > 0
    pools = [tuple(np.asarray(a) for a in (s.main, s.cache, s.delta))
             for s in j.stores]
    from_jax_arrays(t, pools, j.ab.owner, j.ab.slot, j.ab.cache_slot)
    for i in (0, 1):
        a = wj[i].pull_sync(np.arange(E + R))
        b = wt[i].pull_sync(np.arange(E + R))
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    # and both keep computing the same thing
    for w in (wj[0], wt[0]):
        w.intent(np.arange(50, 70), w.current_clock, w.current_clock + 5)
    j.wait_sync()
    t.wait_sync()
    k = rng.integers(0, E + R, 30)
    v = rng.normal(size=(30, 4 * d)).astype(np.float32)
    wj[0].wait(wj[0].push(k, v))
    wt[0].wait(wt[0].push(k, v))
    j.quiesce()
    t.quiesce()
    a = wj[1].pull_sync(np.arange(E + R))
    b = wt[1].pull_sync(np.arange(E + R))
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, numpy as np\n"
        "import adapm_tpu_torch as at\n"
        "from adapm_tpu_torch.models import make_kge_loss\n"
        "from adapm_tpu_torch.ops.fused import DeviceRoutedRunner\n"
        "s = at.setup(40, 16, num_shards=2, device='cpu')\n"
        "w = s.make_worker(0)\n"
        "w.wait(w.set(np.arange(40), np.full((40, 16), 0.1, np.float32)))\n"
        "r = DeviceRoutedRunner(s, make_kge_loss('complex'),\n"
        "    role_class=dict.fromkeys('s r o neg'.split(), 0),\n"
        "    role_dim=dict.fromkeys('s r o neg'.split(), 8),\n"
        "    neg_role='neg', neg_shape=(4, 2))\n"
        "loss = float(r({'s': [0, 1, 2, 3], 'r': [30, 31, 32, 33],\n"
        "                'o': [4, 5, 6, 7]}, None, 0.1))\n"
        "assert loss == loss\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'adapm_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr[-2000:]
