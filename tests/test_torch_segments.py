"""The multi-segment forms of K1 and K3 (one launch per pool class) and
the fused steps that use them, on the CPU, through the kernels' plain
versions:

- the multi-segment plain K3 equals sequential per-segment calls, the
  JAX package's `jaxport._scatter_add` and `NumpyRefPort` on the
  concatenation, bitwise (duplicates across segments, out-of-range and
  negative coordinates, -0.0, empty segments);
- the multi-segment plain K1 equals per-segment calls, both forms;
- one and several merged steps (both runners, both variants, a frozen
  role) equal the per-role composition of the plain kernels, bitwise;
- the step calls K1 once per class and K3 once per class and pool.

Negative coordinates are held to `NumpyRefPort` alone: XLA wraps them
(see tests/test_torch_kernels.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adapm_tpu.device import jaxport, refport
import adapm_tpu_torch
from adapm_tpu_torch.device.context import make_context
from adapm_tpu_torch.models import make_kge_loss
from adapm_tpu_torch.ops import fused
from adapm_tpu_torch.ops import kernels as K

OOB = int(jaxport.OOB)
S, R, C, L = 8, 24, 16, 12
SIZES = [(37, 0, 51, 9), (0, 64, 3, 0, 20), (5, 5, 5, 5, 5, 5, 5, 5, 5, 5)]


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _split(a, sizes):
    return np.split(a, np.cumsum(sizes)[:-1])


def _coords(rng, n, shards, slots, negative):
    sh = rng.integers(0, 2, n).astype(np.int32)      # few rows: duplicates
    sl = rng.integers(0, 5, n).astype(np.int32)
    u = rng.random(n)
    sl[u < 0.1] = OOB
    sh[(u >= 0.1) & (u < 0.15)] = -1 if negative else shards
    if negative:
        sl[(u >= 0.15) & (u < 0.2)] = -2
    sl[(u >= 0.2) & (u < 0.25)] = slots              # one past the pool
    return sh, sl


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("negative", [False, True])
def test_segmented_scatter_plain_equals_sequential_jax_and_refport(
        seed, negative):
    rng = np.random.default_rng(seed)
    sizes = SIZES[seed]
    n = sum(sizes)
    main = rng.normal(size=(S, R, L)).astype(np.float32)
    main[0, :2] = -0.0
    sh, sl = _coords(rng, n, S, R, negative)
    vals = (rng.normal(size=(n, L)) * 10.0 ** rng.integers(-3, 4, (n, 1))
            ).astype(np.float32)
    vals[::7] = -0.0        # -0.0 + -0.0 stays -0.0
    segs = [(_t(a), _t(b)) for a, b in zip(_split(sh, sizes),
                                           _split(sl, sizes))]
    got = _t(main.copy())
    K.ordered_scatter_add_segments(got, segs, _t(vals))
    seq = _t(main.copy())
    for (a, b), v in zip(segs, _split(vals, sizes)):
        K.ordered_scatter_add(seq, a, b, _t(v))
    np.testing.assert_array_equal(_bits(got), _bits(seq))
    ref = main.copy()
    refport._drop_add(ref, sh, sl, vals)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert np.signbit(got.numpy()[0, :2]).any(), "-0.0 must survive"
    if not negative:
        ref_jax, _ = jaxport._scatter_add(
            jnp.asarray(main), jnp.asarray(main[:, :C]), sh, sl,
            np.zeros(n, np.int32), np.full(n, OOB, np.int32), vals)
        np.testing.assert_array_equal(_bits(got), _bits(ref_jax))


def test_segmented_scatter_split_into_order_and_fold():
    """The wrapper is its ordering pass and its fold; more segments than
    one launch takes are joined, not dropped."""
    rng = np.random.default_rng(5)
    sizes = [3] * (K.MAX_SEGMENTS + 3)
    n = sum(sizes)
    main = rng.normal(size=(S, R, L)).astype(np.float32)
    sh, sl = _coords(rng, n, S, R, negative=True)
    vals = rng.normal(size=(n, L)).astype(np.float32)
    segs = [(_t(a), _t(b)) for a, b in zip(_split(sh, sizes),
                                           _split(sl, sizes))]
    assert len(K._pack_segments(segs)) == K.MAX_SEGMENTS
    got = _t(main.copy())
    K.ordered_scatter_add_segments(got, segs, _t(vals))
    split = _t(main.copy())
    sf, perm = K.ordered_scatter_order(split, segs)
    assert bool((sf[1:] >= sf[:-1]).all())
    K.ordered_scatter_fold(split, sf, perm, _t(vals))
    ref = main.copy()
    refport._drop_add(ref, sh, sl, vals)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(_bits(split), _bits(ref))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("form", ["main_only", "cache_delta"])
def test_segmented_gather_plain_equals_per_segment_calls(seed, form):
    rng = np.random.default_rng(seed)
    sizes = SIZES[seed]
    n = sum(sizes)
    main, cache, delta = (rng.normal(size=(S, k, L)).astype(np.float32)
                          for k in (R, C, C))
    main[0, :2] = -0.0
    o_sh, o_sl = _coords(rng, n, S, R, negative=True)
    c_sh, c_sl = _coords(rng, n, S, C, negative=True)
    use_c = rng.random(n) < 0.5
    cols = [o_sh, o_sl] + ([c_sh, c_sl, use_c] if form == "cache_delta"
                           else [])
    pools = (main, cache, delta) if form == "cache_delta" else \
        (main, None, None)
    tp = [None if p is None else _t(p) for p in pools]
    segs = [tuple(_t(c) for c in seg)
            for seg in zip(*[_split(c, sizes) for c in cols])]
    got = K.routed_gather_segments(*tp, segs)
    assert tuple(got.shape) == (n, L)
    per = torch.cat([K.routed_gather(*tp, *seg) for seg in segs])
    np.testing.assert_array_equal(_bits(got), _bits(per))
    ref = refport.NumpyRefPort().gather(
        main, cache, delta, o_sh, o_sl,
        *((c_sh, c_sl, use_c) if form == "cache_delta"
          else (o_sh, np.full(n, OOB, np.int32), np.zeros(n, bool))))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


# -- the merged steps against the per-role composition ----------------------

E, NR, d, B, N = 96, 8, 4, 12, 3
ROLES = ("neg", "o", "r", "s")


def _server(shards, replicas):
    tech = "replication_only" if replicas else "all"
    srv = adapm_tpu_torch.Server(
        E + NR, 4 * d, ctx=make_context(shards, "cpu"), num_workers=2,
        opts=adapm_tpu_torch.SystemOptions(
            sync_max_per_sec=0, cache_slots_per_shard=32,
            techniques=adapm_tpu_torch.MgmtTechniques(tech)))
    w = srv.make_worker(0)
    vals = np.random.default_rng(0).normal(
        size=(E + NR, 4 * d)).astype(np.float32) * 0.1
    vals[:, 2 * d:] = 1e-6
    w.wait(w.set(np.arange(E + NR), vals))
    if replicas:
        w.intent(np.arange(0, E + NR, 3), 0, 1000)
        srv.wait_sync()
    return srv


def _batches(seed, steps):
    rng = np.random.default_rng(seed)
    return [{"s": rng.integers(0, E, B), "r": rng.integers(E, E + NR, B),
             "o": rng.integers(0, E, B), "neg": rng.integers(0, E, (B, N))}
            for _ in range(steps)]


def _per_role_step(srv, batch, frozen, shard, routes, lr=0.1, eps=1e-10):
    """The step as it ran before the roles were merged: each role routed,
    gathered, updated (K2) and scattered (K3 main, then delta) on its
    own, through the plain kernels."""
    main, cache, delta = srv.stores[0].main, srv.stores[0].cache, \
        srv.stores[0].delta
    rows = {}
    for r in ROLES:
        g_sh, g_sl, c_sh, c_sl, use_c = (t.reshape(-1) for t in routes[r])
        rows[r] = K.routed_gather_plain(main, cache, delta, g_sh, g_sl,
                                        c_sh, c_sl, use_c).reshape(
            tuple(routes[r][0].shape) + (4 * d,))
    trainable = [r for r in ROLES if r not in frozen]
    embs = {r: rows[r][..., :2 * d] for r in ROLES}
    leaves = {r: embs[r].detach().requires_grad_() for r in trainable}
    with torch.enable_grad():
        merged = dict(embs)
        merged.update(leaves)
        loss = make_kge_loss("complex")(merged, None)
        grads = torch.autograd.grad(loss, [leaves[r] for r in trainable])
    for r, g in zip(trainable, grads):
        flat = rows[r].reshape(-1, 4 * d)
        upd = K.adagrad_update_plain(g.reshape(-1, 2 * d), flat[:, 2 * d:],
                                     lr, eps)
        g_sh, g_sl, c_sh, c_sl, _ = (t.reshape(-1) for t in routes[r])
        K.ordered_scatter_add_plain(main, g_sh, g_sl, upd)
        K.ordered_scatter_add_plain(delta, c_sh, c_sl, upd)
    return loss.detach()


def _device_routes(srv, batch, shard):
    tables = fused.DeviceRouter(srv, shard).tables()
    return {r: tuple(t.reshape(np.shape(batch[r])) for t in
                     fused._route_on_device(
                         tables, torch.as_tensor(
                             np.asarray(batch[r], np.int32).ravel()),
                         shard))
            for r in ROLES}


def _host_routes(srv, batch, shard):
    return {r: fused.build_routes(srv, batch[r], shard).as_tuple()
            for r in ROLES}


@pytest.mark.parametrize("runner", ["device", "host"])
@pytest.mark.parametrize("shards,replicas", [(1, False), (8, True)])
@pytest.mark.parametrize("steps", [1, 3])
def test_merged_steps_equal_per_role_composition(runner, shards, replicas,
                                                 steps):
    frozen = ("r",)
    a, b = _server(shards, replicas), _server(shards, replicas)
    rc = dict.fromkeys(ROLES, 0)
    rd = dict.fromkeys(ROLES, 2 * d)
    if runner == "device":
        run = fused.DeviceRoutedRunner(a, make_kge_loss("complex"), rc, rd,
                                       frozen_roles=frozen)
        assert run._shard_has_replicas() == replicas
        routes_of = _device_routes
    else:
        run = fused.FusedStepRunner(a, make_kge_loss("complex"), rc, rd,
                                    frozen_roles=frozen)
        routes_of = _host_routes
    for batch in _batches(7, steps):
        la = run(batch, None, 0.1)
        lb = _per_role_step(b, batch, frozen, 0, routes_of(b, batch, 0))
        assert torch.equal(la, lb)
    for name in ("main", "cache", "delta"):
        np.testing.assert_array_equal(
            _bits(getattr(a.stores[0], name)),
            _bits(getattr(b.stores[0], name)), err_msg=name)
    before = np.asarray(_server(shards, replicas).stores[0].main)
    assert not np.array_equal(_bits(a.stores[0].main), _bits(before))


def _square_loss(embs, aux):
    """A loss over roles of different widths (ComplEx needs one width)."""
    return sum((v * v).mean() for v in embs.values())


def _count_calls(monkeypatch):
    calls = {"routed_gather": 0, "ordered_scatter_add": 0}

    def counted(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped
    for attr, name in (("routed_gather", "routed_gather"),
                       ("routed_gather_segments", "routed_gather"),
                       ("ordered_scatter_add_segments",
                        "ordered_scatter_add")):
        monkeypatch.setattr(fused, attr, counted(name, getattr(fused, attr)))
    return calls


@pytest.mark.parametrize("runner", ["device", "host"])
@pytest.mark.parametrize("shards,replicas", [(1, False), (8, True)])
def test_one_gather_and_one_scatter_per_class_and_pool(
        monkeypatch, runner, shards, replicas):
    """Two classes (relations of another length, as RESCAL has): one K1
    call per class per step; one K3 call per class and pool (main, and
    delta in the replica variant) — the frozen class is never scattered
    when all its roles are frozen."""
    rl = np.full(E + NR, 4 * d)
    rl[E:] = 2 * d
    for frozen in ((), ("r",)):
        srv = adapm_tpu_torch.Server(
            E + NR, rl, ctx=make_context(shards, "cpu"),
            opts=adapm_tpu_torch.SystemOptions(
                sync_max_per_sec=0, cache_slots_per_shard=32,
                techniques=adapm_tpu_torch.MgmtTechniques(
                    "replication_only" if replicas else "all")))
        w = srv.make_worker(0)
        for k0, k1, ln in ((0, E, 4 * d), (E, E + NR, 2 * d)):
            w.wait(w.set(np.arange(k0, k1),
                         np.full((k1 - k0, ln), 0.1, np.float32)))
        if replicas:
            w.intent(np.arange(0, E + NR, 3), 0, 1000)
            srv.wait_sync()
        ent, rel = int(srv.ab.key_class[0]), int(srv.ab.key_class[E])
        assert ent != rel
        rc = {"s": ent, "o": ent, "neg": ent, "r": rel}
        rd = {"s": 2 * d, "o": 2 * d, "neg": 2 * d, "r": d}
        cls = fused.DeviceRoutedRunner if runner == "device" else \
            fused.FusedStepRunner
        run = cls(srv, _square_loss, rc, rd, frozen_roles=frozen)
        calls = _count_calls(monkeypatch)
        steps = 3
        for batch in _batches(3, steps):
            assert np.isfinite(float(run(batch, None, 0.1)))
        pools = 2 if (replicas or runner == "host") else 1
        trained_classes = 2 - len(frozen)
        assert calls == {"routed_gather": 2 * steps,
                         "ordered_scatter_add":
                             trained_classes * pools * steps}, (frozen, calls)
        monkeypatch.undo()
