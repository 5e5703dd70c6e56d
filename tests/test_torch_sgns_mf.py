"""K6 sgns_step and K7 mf_step's plain versions (adapm_tpu_torch/ops/
kernels.py), the SGNS and MF losses (models/sgns.py, models/mf.py), the
numpy IO helpers of the two apps, and the fused steps that run them, on
the CPU.

- sgns_step_plain / mf_step_plain against the JAX package's losses
  under jax.value_and_grad plus the fused step's AdaGrad rule
  (adapm_tpu/ops/fused.py :437-445), at rtol 1e-5 / atol 1e-6: float32
  model math that XLA and PyTorch sum in different orders.
- the same against the port's own autograd path (the loss under
  autograd plus K2's plain rule), bitwise: the closed forms group their
  terms as autograd does.
- the fused steps go through K6 / K7 (and not K2) on both routing
  paths; run_scan with per-step ratings as aux equals sequential steps
  bitwise.
- io/text.py and io/mf.py produce the JAX package's bytes."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import adapm_tpu_torch
from adapm_tpu.io import mf as jmfio
from adapm_tpu.io import text as jtext
from adapm_tpu.models.mf import make_mf_loss as jax_mf_loss
from adapm_tpu.models.sgns import sgns_loss as jax_sgns_loss
from adapm_tpu.models.sgns import subsample_mask as jax_subsample
from adapm_tpu_torch.device.context import make_context
from adapm_tpu_torch.io import mf as tmfio
from adapm_tpu_torch.io import text as ttext
from adapm_tpu_torch.models import mf as tmf
from adapm_tpu_torch.models import sgns as tsgns
from adapm_tpu_torch.ops import fused
from adapm_tpu_torch.ops import kernels as K

B, N = 32, 5
LR, EPS = 0.1, 1e-10
RTOL, ATOL = 1e-5, 1e-6


def _rows(rng, d, *shape):
    x = rng.normal(size=shape + (2 * d,)).astype(np.float32) * 0.4
    x[..., d:] = rng.random(shape + (d,)).astype(np.float32) * 0.01 + 1e-6
    return x


def _sgns_rows(seed, d):
    """Gathered rows per role, with duplicates: two pairs share a center
    row and each pair's first negative repeats its context row."""
    rng = np.random.default_rng(seed)
    out = {"center": _rows(rng, d, B), "ctx": _rows(rng, d, B),
           "neg": _rows(rng, d, B, N)}
    out["center"][1] = out["center"][0]
    out["neg"][:, 0] = out["ctx"]
    return out


def _mf_rows(seed, d):
    rng = np.random.default_rng(seed)
    out = {"w": _rows(rng, d, B), "h": _rows(rng, d, B)}
    out["h"][2] = out["h"][0]
    return out, rng.normal(size=B).astype(np.float32)


def _nrows(role):
    return B * N if role == "neg" else B


def _jax_upd(rows, grads, d):
    upd = {}
    for k, gk in grads.items():
        acc = jnp.asarray(rows[k][..., d:])
        g2 = gk * gk
        upd[k] = np.asarray(jnp.concatenate(
            [-LR * gk * jax.lax.rsqrt(acc + g2 + EPS), g2], -1)
        ).reshape(-1, 2 * d)
    return upd


def _check(loss, grad, out, loss_j, grad_j, upd_j, trainable):
    np.testing.assert_allclose(float(loss), loss_j, rtol=RTOL, atol=ATOL)
    for k, g in grad_j.items():
        np.testing.assert_allclose(grad[k].numpy(),
                                   np.asarray(g).reshape(grad[k].shape),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"gradient {k}")
    for k in trainable:
        np.testing.assert_allclose(out[k].numpy(), upd_j[k], rtol=RTOL,
                                   atol=ATOL, err_msg=f"update rows {k}")


def _run_sgns(rows, d, trainable=K.SGNS_ROLES):
    t = {k: torch.from_numpy(v) for k, v in rows.items()}
    out = {k: torch.full((_nrows(k), 2 * d), float("nan"))
           for k in trainable}
    grad = {k: torch.empty(_nrows(k), d) for k in K.SGNS_ROLES}
    per = K.sgns_step(t["center"], t["ctx"], t["neg"],
                      torch.tensor([LR, EPS]), out=out, grad_out=grad)
    return per, grad, out


def _run_mf(rows, x, d, l2, trainable=K.MF_ROLES):
    t = {k: torch.from_numpy(v) for k, v in rows.items()}
    out = {k: torch.full((B, 2 * d), float("nan")) for k in trainable}
    grad = {k: torch.empty(B, d) for k in K.MF_ROLES}
    per = K.mf_step(t["w"], t["h"], torch.from_numpy(x),
                    torch.tensor([LR, EPS]), l2, out=out, grad_out=grad)
    return per, grad, out


@pytest.mark.parametrize("d,frozen", [(8, ()), (128, ()), (7, ("neg",)),
                                      (8, ("center", "ctx"))])
def test_sgns_plain_matches_jax_value_and_grad(d, frozen):
    rows = _sgns_rows(d, d)
    trainable = [k for k in K.SGNS_ROLES if k not in frozen]
    per, grad, out = _run_sgns(rows, d, trainable)
    embs = {k: jnp.asarray(v[..., :d]) for k, v in rows.items()}
    loss_j, g_j = jax.value_and_grad(
        lambda e: jax_sgns_loss(e, None))(embs)
    _check(per.mean(), grad, out, float(loss_j), g_j,
           _jax_upd(rows, g_j, d), trainable)
    for k in frozen:
        assert k not in out
    # every occurrence of a duplicated row gets its own gradient row
    assert not torch.equal(grad["center"][0], grad["center"][1])


@pytest.mark.parametrize("d", [4, 128])
@pytest.mark.parametrize("l2", [0.0, 0.01])
def test_mf_plain_matches_jax_value_and_grad(d, l2):
    rows, x = _mf_rows(d + int(l2 * 100), d)
    per, grad, out = _run_mf(rows, x, d, l2)
    embs = {k: jnp.asarray(v[..., :d]) for k, v in rows.items()}
    loss_j, g_j = jax.value_and_grad(
        lambda e: jax_mf_loss(l2)(e, jnp.asarray(x)))(embs)
    _check(per.mean(), grad, out, float(loss_j), g_j,
           _jax_upd(rows, g_j, d), K.MF_ROLES)


def _autograd(loss_fn, rows, d, aux):
    t = {k: torch.from_numpy(v) for k, v in rows.items()}
    leaves = {k: v[..., :d].clone().requires_grad_() for k, v in t.items()}
    loss = loss_fn(leaves, aux)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    upd = {k: K.adagrad_update_plain(g.reshape(-1, d),
                                     t[k].reshape(-1, 2 * d)[:, d:], LR,
                                     EPS) for k, g in grads.items()}
    return loss.detach(), grads, upd


@pytest.mark.parametrize("d", [8, 128])
def test_sgns_plain_matches_the_autograd_path_bitwise(d):
    rows = _sgns_rows(d + 1, d)
    per, grad, out = _run_sgns(rows, d)
    loss, grads, upd = _autograd(tsgns.sgns_loss, rows, d, None)
    assert torch.equal(per.mean(), loss)
    for k in K.SGNS_ROLES:
        assert torch.equal(grad[k], grads[k].reshape(-1, d)), k
        assert torch.equal(out[k], upd[k]), k


@pytest.mark.parametrize("d", [4, 128])
@pytest.mark.parametrize("l2", [0.0, 0.01])
def test_mf_plain_matches_the_autograd_path_bitwise(d, l2):
    rows, x = _mf_rows(d + 3, d)
    per, grad, out = _run_mf(rows, x, d, l2)
    loss, grads, upd = _autograd(tmf.make_mf_loss(l2), rows, d, x)
    assert torch.equal(per.mean(), loss)
    for k in K.MF_ROLES:
        assert torch.equal(grad[k], grads[k]), k
        assert torch.equal(out[k], upd[k]), k


def test_wrappers_reject_bad_shapes():
    lr_eps = torch.tensor([LR, EPS])
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="neg"):
        K.sgns_step(x, x, torch.zeros(4, 8), lr_eps)
    with pytest.raises(ValueError, match="output 'ctx'"):
        K.sgns_step(x, x, torch.zeros(4, 2, 8), lr_eps,
                    out={"ctx": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match="x \\[B\\]"):
        K.mf_step(x, x, torch.zeros(3), lr_eps)
    with pytest.raises(ValueError, match="roles"):
        tsgns.sgns_loss.fused_update({"center": x, "ctx": x}, {}, lr_eps,
                                     None)
    with pytest.raises(ValueError, match="roles"):
        tmf.make_mf_loss().fused_update({"w": x}, {}, lr_eps, None)


def _server(keys=200, L=16, shards=1, seed=0):
    srv = adapm_tpu_torch.Server(
        keys, L, ctx=make_context(shards, "cpu"), num_workers=1,
        opts=adapm_tpu_torch.SystemOptions(sync_max_per_sec=0))
    w = srv.make_worker(0)
    vals = np.random.default_rng(seed).normal(
        size=(keys, L)).astype(np.float32) * 0.1
    vals[:, L // 2:] = 1e-6
    w.wait(w.set(np.arange(keys), vals))
    return srv


def _count(monkeypatch):
    """Count the fused steps' calls of K6's, K7's and K2's wrappers."""
    calls = dict.fromkeys(("sgns_step", "mf_step", "adagrad_update"), 0)

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    for mod, name in ((tsgns, "sgns_step"), (tmf, "mf_step"),
                      (fused, "adagrad_update")):
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    return calls


@pytest.mark.parametrize("runner", ["device", "host"])
def test_fused_steps_run_k6_and_k7_not_k2(monkeypatch, runner):
    """An SGNS step runs K6, an MF step K7 (its ratings as aux), a frozen
    role stays untouched, and the step's pools equal the autograd + K2
    composition of the same loss bitwise."""
    d = 8
    rng = np.random.default_rng(1)
    w2v = ({"center": 0, "ctx": 0, "neg": 0},
           {"center": 2 * rng.integers(0, 100, B),
            "ctx": 2 * rng.integers(0, 100, B) + 1,
            "neg": 2 * rng.integers(0, 100, (B, 3)) + 1}, None)
    mfb = ({"w": 0, "h": 0}, {"w": rng.integers(0, 120, B),
                              "h": rng.integers(120, 200, B)},
           rng.normal(size=B).astype(np.float32))
    cls = fused.DeviceRoutedRunner if runner == "device" else \
        fused.FusedStepRunner
    for (rc, batch, aux), loss, kernel in (
            (w2v, tsgns.sgns_loss, "sgns_step"),
            (mfb, tmf.make_mf_loss(0.01), "mf_step")):
        for frozen in ((), (sorted(rc)[0],)):
            pools = []
            for form in ("fused", "autograd"):
                srv = _server()
                fn = loss if form == "fused" else \
                    (lambda e, a, _f=loss: _f(e, a))   # hides fused_update
                run = cls(srv, fn, rc, dict.fromkeys(rc, d),
                          frozen_roles=frozen)
                calls = _count(monkeypatch)
                before = srv.read_main(np.arange(200)).copy()
                for _ in range(2):
                    assert np.isfinite(float(run(batch, aux, 0.1)))
                want = (2, 0) if form == "fused" else \
                    (0, 2 * (len(rc) - len(frozen)))
                assert (calls[kernel], calls["adagrad_update"]) == want, \
                    (kernel, form, frozen, calls)
                monkeypatch.undo()
                after = srv.read_main(np.arange(200))
                for r in frozen:
                    k = np.asarray(batch[r]).ravel()
                    assert np.array_equal(after.reshape(200, -1)[k],
                                          before.reshape(200, -1)[k])
                pools.append(after)
                srv.shutdown()
            assert np.array_equal(pools[0].view(np.uint32),
                                  pools[1].view(np.uint32)), (kernel, frozen)


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("loss", ["sgns", "mf"])
def test_run_scan_with_aux_equals_sequential_steps_bitwise(loss):
    """Two windows of 3 against 6 sequential steps: SGNS with
    alias-drawn negatives, MF with per-step ratings (numpy arrays, as
    the app passes them) as aux. Losses, pools and locality equal."""
    d = 8
    out = []
    for mode in ("sequential", "scan"):
        srv = _server(shards=2)
        rng = np.random.default_rng(2)
        if loss == "sgns":
            rc = {"center": 0, "ctx": 0, "neg": 0}
            run = fused.DeviceRoutedRunner(
                srv, tsgns.sgns_loss, rc, dict.fromkeys(rc, d),
                neg_role="neg", neg_shape=(B, 3),
                neg_population=tsgns.syn1_key(np.arange(100)),
                neg_alias=tsgns.build_alias_table(
                    1.0 / (np.arange(100) + 10.0)), seed=4)
            batches = [{"center": 2 * rng.integers(0, 100, B),
                        "ctx": 2 * rng.integers(0, 100, B) + 1}
                       for _ in range(6)]
            auxes = [None] * 6
        else:
            rc = {"w": 0, "h": 0}
            run = fused.DeviceRoutedRunner(srv, tmf.make_mf_loss(0.01), rc,
                                           dict.fromkeys(rc, d))
            batches = [{"w": rng.integers(0, 120, B),
                        "h": rng.integers(120, 200, B)} for _ in range(6)]
            auxes = [rng.normal(size=B).astype(np.float32)
                     for _ in range(6)]
        if mode == "sequential":
            losses = torch.stack([run(b, a, 0.1)
                                  for b, a in zip(batches, auxes)])
        else:
            losses = torch.cat([
                run.run_scan(batches[i:i + 3],
                             None if loss == "sgns" else auxes[i:i + 3],
                             0.1) for i in (0, 3)])
        out.append((losses, srv.stores[0].main.clone(),
                    run.locality_counts()))
        srv.shutdown()
    (la, pa, ca), (lb, pb, cb) = out
    assert torch.equal(_bits(la), _bits(lb))
    assert torch.equal(_bits(pa), _bits(pb))
    assert ca == cb and ca["ops"] == 6


def test_skipgram_pairs_and_corpus_match_the_jax_package(tmp_path):
    pj, pt = tmp_path / "j.txt", tmp_path / "t.txt"
    jtext.generate_synthetic_corpus(str(pj), 300, 200, seed=5)
    ttext.generate_synthetic_corpus(str(pt), 300, 200, seed=5)
    assert pj.read_bytes() == pt.read_bytes()
    wj, cj, vj = jtext.build_vocab(str(pj), 2)
    wt, ct, vt = ttext.build_vocab(str(pt), 2)
    assert wj == wt and vj == vt and np.array_equal(cj, ct)
    sj = list(jtext.sentences(str(pj), vj, max_len=7))
    st = list(ttext.sentences(str(pt), vt, max_len=7))
    assert len(sj) == len(st) and all(np.array_equal(a, b)
                                      for a, b in zip(sj, st))
    total = int(ct.sum())
    for i, s in enumerate(st):
        for window in (1, 3, 5):
            a = jtext.skipgram_pairs(s, window, np.random.default_rng(i))
            b = ttext.skipgram_pairs(s, window, np.random.default_rng(i))
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        ka = jax_subsample(cj, s, total, 1e-3, np.random.default_rng(i))
        kb = tsgns.subsample_mask(ct, s, total, 1e-3,
                                  np.random.default_rng(i))
        assert np.array_equal(ka, kb)


def test_sampling_tables_match_the_jax_package():
    from adapm_tpu.models.sgns import build_alias_table as jalias
    from adapm_tpu.models.sgns import build_unigram_table as juni
    counts = np.random.default_rng(0).integers(1, 500, 300)
    for a, b in zip(jalias(counts), tsgns.build_alias_table(counts)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    sj = juni(counts)(1000, np.random.default_rng(3))
    st = tsgns.build_unigram_table(counts)(1000, np.random.default_rng(3))
    assert np.array_equal(sj, st)
    assert np.array_equal(tsgns.syn0_key([0, 3]), [0, 6])
    assert np.array_equal(tsgns.syn1_key([0, 3]), [1, 7])
    assert np.array_equal(tmf.col_key([0, 2], 10), [10, 12])
    assert np.array_equal(tmf.row_key([4]), [4])


def test_mf_generators_match_the_jax_package(tmp_path):
    a = jmfio.generate_synthetic(40, 30, 4, 500, seed=3)
    b = tmfio.generate_synthetic(40, 30, 4, 500, seed=3)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    rows, cols, vals = b[:3]
    for parts in (1, 3, 8):
        assert np.array_equal(jmfio.partition_points(rows, parts, 40),
                              tmfio.partition_points(rows, parts, 40))
        assert np.array_equal(jmfio.column_block(cols, parts, 30),
                              tmfio.column_block(cols, parts, 30))
        for epoch in range(3):
            assert np.array_equal(jmfio.dsgd_schedule(parts, epoch, 42),
                                  tmfio.dsgd_schedule(parts, epoch, 42))
    W = b[3]
    tmfio.write_dense(str(tmp_path / "W.mma"), W)
    jmfio.write_dense(str(tmp_path / "Wj.mma"), W)
    assert (tmp_path / "W.mma").read_bytes() == \
        (tmp_path / "Wj.mma").read_bytes()
    assert np.array_equal(tmfio.read_dense(str(tmp_path / "W.mma")),
                          jmfio.read_dense(str(tmp_path / "W.mma")))
    coo = tmp_path / "m.mma"
    coo.write_text("%%MatrixMarket matrix coordinate real general\n"
                   "% a comment\n5 4 3\n1 1 0.5\n5 2 1.5\n3 4 -2\n")
    for x, y in zip(jmfio.read_coo(str(coo)), tmfio.read_coo(str(coo))):
        assert np.array_equal(x, y)
    bare = tmp_path / "bare.txt"
    bare.write_text("2 3 4\n1 1\n")
    for x, y in zip(jmfio.read_coo(str(bare)), tmfio.read_coo(str(bare))):
        assert np.array_equal(x, y)
    from adapm_tpu.models.mf import full_loss as jfull
    coo_t = (rows, cols, vals)
    H = b[4]
    assert jfull(W, H, coo_t, 0.01) == tmf.full_loss(W, H, coo_t, 0.01)


@pytest.mark.parametrize("loss", ["sgns", "mf"])
def test_jax_trained_state_carries_over_and_trains_alike(loss):
    """A word2vec or MF model is its table rows: a JAX server trained by
    its fused step on 8 shards, with replicas in play, is carried into
    the port (weights.from_jax_arrays); then both take the same
    host-routed steps (same keys, negatives and ratings) and sync
    rounds. Pulls agree bitwise right after the carry, pools within
    rtol 1e-5 / atol 1e-6 after the steps (float32 model math)."""
    import adapm_tpu
    from adapm_tpu.models.mf import make_mf_loss as jmf_loss
    from adapm_tpu.ops import FusedStepRunner as JaxHostRunner
    from adapm_tpu.parallel.mesh import make_mesh
    from adapm_tpu_torch.weights import from_jax_arrays
    keys, d, S = 200, 8, 8
    opts = dict(sync_max_per_sec=0, cache_slots_per_shard=32)
    j = adapm_tpu.Server(keys, 2 * d, ctx=make_mesh(S), num_workers=2,
                         opts=adapm_tpu.SystemOptions(prefetch=False,
                                                      **opts))
    t = adapm_tpu_torch.Server(keys, 2 * d, ctx=make_context(S, "cpu"),
                               num_workers=2,
                               opts=adapm_tpu_torch.SystemOptions(
                                   prefetch=False, **opts))
    wj = [j.make_worker(i) for i in range(2)]
    wt = [t.make_worker(i) for i in range(2)]
    rng = np.random.default_rng(6)
    vals = rng.normal(size=(keys, 2 * d)).astype(np.float32) * 0.2
    vals[:, d:] = 1e-6
    wj[0].wait(wj[0].set(np.arange(keys), vals))
    if loss == "sgns":
        rc = {"center": 0, "ctx": 0, "neg": 0}
        fj, ft = jax_sgns_loss, tsgns.sgns_loss

        def batch():
            return ({"center": 2 * rng.integers(0, 100, B),
                     "ctx": 2 * rng.integers(0, 100, B) + 1,
                     "neg": 2 * rng.integers(0, 100, (B, 3)) + 1}, None)
    else:
        rc = {"w": 0, "h": 0}
        fj, ft = jmf_loss(0.01), tmf.make_mf_loss(0.01)

        def batch():
            return ({"w": rng.integers(0, 120, B),
                     "h": rng.integers(120, keys, B)},
                    rng.normal(size=B).astype(np.float32))
    rj = JaxHostRunner(j, fj, role_class=rc, role_dim=dict.fromkeys(rc, d))
    hot = np.arange(0, keys, 3)
    wj[1].intent(hot, 0, 1000)
    j.wait_sync()
    wj[0].intent(hot, 0, 1000)
    j.wait_sync()
    for step in range(4):                  # the JAX side trains first
        b, aux = batch()
        rj(b, aux, 0.1, shard=step % 2)
    assert j.ab.replica_count.sum() > 0
    pools = [tuple(np.asarray(a) for a in (s.main, s.cache, s.delta))
             for s in j.stores]
    from_jax_arrays(t, pools, j.ab.owner, j.ab.slot, j.ab.cache_slot)
    for i in (0, 1):
        a, b_ = wj[i].pull_sync(np.arange(keys)), wt[i].pull_sync(
            np.arange(keys))
        assert np.array_equal(a.view(np.uint32), b_.view(np.uint32))
    # the carry moves placement, not the workers' intents: declare them
    # on the port too, so both planners keep the same replicas
    for w in wt[::-1]:
        w.intent(hot, 0, 1000)
    rt = fused.FusedStepRunner(t, ft, role_class=rc,
                               role_dim=dict.fromkeys(rc, d))
    for step in range(8):
        b, aux = batch()
        lj = float(rj(b, aux, 0.1, shard=step % 2))
        lt = float(rt(b, aux, 0.1, shard=step % 2))
        np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
        if step % 4 == 3:
            j.sync.run_round(all_channels=True)
            t.sync.run_round(all_channels=True)
    j.quiesce()
    t.quiesce()
    np.testing.assert_allclose(t.read_main(np.arange(keys)),
                               j.read_main(np.arange(keys)), rtol=RTOL,
                               atol=ATOL)
    j.shutdown()
    t.shutdown()
