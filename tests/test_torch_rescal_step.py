"""K16's plain version (adapm_tpu_torch/ops/kernels.py rescal_step_plain)
and the RESCAL step through the port's runners on the CPU.

- rescal_step_plain against the JAX package's RESCAL loss under
  jax.value_and_grad plus the fused step's AdaGrad rule
  (adapm_tpu/ops/fused.py), and against the port's own autograd path
  (KgeLoss + autograd + K2's plain version), both at rtol 1e-5 / atol
  1e-6: float32 model math whose sums run in other orders (the closed
  form sums u = R o once; autograd and XLA differentiate the score's
  einsum).
- a RESCAL step goes through rescal_step (and not K2) on both runners
  and in the app; a batch of negatives shared by the triples ([N]) goes
  to autograd and K2.
- run_scan against sequential steps of the port, bitwise, and against
  the JAX package's run_scan at rtol 1e-5 (losses) / atol 1e-5 (pools),
  as tests/test_torch_complex_step.py holds ComplEx."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import adapm_tpu
import adapm_tpu_torch
from adapm_tpu.models.kge import make_kge_loss as jax_loss
from adapm_tpu.ops import DeviceRoutedRunner as JaxRunner
from adapm_tpu_torch.device.context import make_context
from adapm_tpu_torch.models import kge, make_kge_loss
from adapm_tpu_torch.ops import fused
from adapm_tpu_torch.ops import kernels as K

B, N, d = 16, 4, 8
ROLES = ("s", "r", "o", "neg")
WIDTH = {"s": d, "r": d * d, "o": d, "neg": d}
LR, EPS = 0.1, 1e-10
RTOL, ATOL = 1e-5, 1e-6


def _rows(seed):
    """Gathered rows [emb | acc] per role, with duplicates: each triple's
    first negative is its subject row, two triples share a relation row,
    and the first coordinate of every entity row is -0.0."""
    rng = np.random.default_rng(seed)

    def rows(shape, w):
        x = rng.normal(size=shape + (2 * w,)).astype(np.float32) * 0.3
        x[..., w:] = rng.random(shape + (w,)).astype(np.float32) * 0.01 \
            + 1e-6
        return x
    out = {"s": rows((B,), d), "r": rows((B,), d * d), "o": rows((B,), d),
           "neg": rows((B, N), d)}
    for k in ("s", "o", "neg"):
        out[k][..., 0] = -0.0
    out["neg"][:, 0] = out["s"]
    out["r"][1] = out["r"][0]
    return out


def _nrows(role):
    return B * N if role == "neg" else B


def _plain(rows, T, l2, trainable=ROLES):
    t = {k: torch.from_numpy(v) for k, v in rows.items()}
    out = {k: torch.full((_nrows(k), 2 * WIDTH[k]), float("nan"))
           for k in trainable}
    grad = {k: torch.empty(_nrows(k), WIDTH[k]) for k in ROLES}
    per = K.rescal_step(t["s"], t["r"], t["o"], t["neg"],
                        torch.tensor([LR, EPS]), T, l2, out=out,
                        grad_out=grad)
    return per.sum() / B, grad, out


def _jax(rows, T, l2):
    embs = {k: jnp.asarray(v[..., :WIDTH[k]]) for k, v in rows.items()}
    f = jax_loss("rescal", T, l2)
    loss, g = jax.value_and_grad(lambda e: f(e, None))(embs)
    upd = {}
    for k in ROLES:
        gk = g[k]
        acc = jnp.asarray(rows[k][..., WIDTH[k]:])
        g2 = gk * gk
        upd[k] = np.asarray(jnp.concatenate(
            [-LR * gk * jax.lax.rsqrt(acc + g2 + EPS), g2], -1)
        ).reshape(-1, 2 * WIDTH[k])
    return float(loss), {k: np.asarray(v).reshape(-1, WIDTH[k])
                         for k, v in g.items()}, upd


@pytest.mark.parametrize("T,l2,frozen", [(0.0, 0.0, ()), (1.0, 0.0, ()),
                                         (0.0, 0.1, ()), (1.0, 0.1, ()),
                                         (0.0, 0.0, ("r", "neg"))])
def test_plain_matches_jax_value_and_grad(T, l2, frozen):
    rows = _rows(3)
    trainable = [k for k in ROLES if k not in frozen]
    loss, grad, out = _plain(rows, T, l2, trainable)
    loss_j, grad_j, upd_j = _jax(rows, T, l2)
    np.testing.assert_allclose(float(loss), loss_j, rtol=RTOL, atol=ATOL)
    for k in ROLES:
        np.testing.assert_allclose(grad[k].numpy(), grad_j[k], rtol=RTOL,
                                   atol=ATOL, err_msg=f"gradient {k}")
    for k in trainable:
        np.testing.assert_allclose(out[k].numpy(), upd_j[k], rtol=RTOL,
                                   atol=ATOL, err_msg=f"update rows {k}")
    assert set(out) == set(trainable)
    # every occurrence of a duplicated row gets its own gradient row
    assert not np.allclose(grad["neg"].numpy()[0], grad["s"].numpy()[0])
    assert not np.allclose(grad["r"].numpy()[0], grad["r"].numpy()[1])


@pytest.mark.parametrize("T,l2", [(0.0, 0.0), (1.0, 0.0), (0.0, 0.1),
                                  (1.0, 0.1)])
def test_plain_matches_the_autograd_path(T, l2):
    """The closed form against KgeLoss under autograd plus K2's plain
    rule (the step's math before K16): loss, gradients and update rows
    within rtol 1e-5 / atol 1e-6."""
    rows = _rows(5)
    loss, grad, out = _plain(rows, T, l2)
    t = {k: torch.from_numpy(v) for k, v in rows.items()}
    leaves = {k: v[..., :WIDTH[k]].clone().requires_grad_()
              for k, v in t.items()}
    ref = make_kge_loss("rescal", T, l2)(leaves, None)
    g = dict(zip(ROLES, torch.autograd.grad(ref, [leaves[k]
                                                   for k in ROLES])))
    torch.testing.assert_close(loss, ref.detach(), rtol=RTOL, atol=ATOL)
    for k in ROLES:
        w = WIDTH[k]
        gk = g[k].reshape(-1, w)
        torch.testing.assert_close(grad[k], gk, rtol=RTOL, atol=ATOL)
        upd = K.adagrad_update_plain(gk, t[k].reshape(-1, 2 * w)[:, w:],
                                     LR, EPS)
        torch.testing.assert_close(out[k], upd, rtol=RTOL, atol=ATOL)


def test_rescal_step_checks_its_arguments():
    t = {k: torch.from_numpy(v) for k, v in _rows(1).items()}
    lr_eps = torch.tensor([LR, EPS])
    with pytest.raises(ValueError, match=r"r \[B, 2d\^2\]"):
        K.rescal_step(t["s"], t["s"], t["o"], t["neg"], lr_eps)
    with pytest.raises(ValueError, match="output 'r'"):
        K.rescal_step(t["s"], t["r"], t["o"], t["neg"], lr_eps,
                      out={"r": torch.empty(B, 2 * d)})
    with pytest.raises(ValueError, match="self_adv_temp"):
        K.rescal_step(t["s"], t["r"], t["o"], t["neg"], lr_eps, -1.0)


ENT, REL = 100, 20


def _server(shards=1, tech="all", seed=0):
    """A two-class server: ENT entity rows [emb d | acc d], REL relation
    rows [emb d^2 | acc d^2]."""
    vl = np.array([2 * d] * ENT + [2 * d * d] * REL)
    srv = adapm_tpu_torch.Server(
        ENT + REL, vl, ctx=make_context(shards, "cpu"), num_workers=2,
        opts=adapm_tpu_torch.SystemOptions(
            sync_max_per_sec=0, cache_slots_per_shard=32,
            techniques=adapm_tpu_torch.MgmtTechniques(tech)))
    ws = [srv.make_worker(i) for i in range(2)]
    rng = np.random.default_rng(seed)
    for keys, w in ((np.arange(ENT), d), (np.arange(ENT, ENT + REL), d * d)):
        vals = rng.normal(size=(len(keys), 2 * w)).astype(np.float32) * 0.1
        vals[:, w:] = 1e-6
        ws[0].wait(ws[0].set(keys, vals))
    return srv, ws


def _classes(srv):
    ec, rc = int(srv.ab.key_class[0]), int(srv.ab.key_class[ENT])
    return {"s": ec, "r": rc, "o": ec, "neg": ec}


def _count(monkeypatch):
    """Count the step's calls of K16's wrapper (which KgeLoss's fused
    form calls) and K2's (which the fused step calls)."""
    calls = {"rescal_step": 0, "adagrad_update": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    for mod, name in ((kge, "rescal_step"), (fused, "adagrad_update")):
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    return calls


@pytest.mark.parametrize("runner", ["device", "host"])
def test_rescal_steps_run_k16_and_shared_negatives_k2(monkeypatch, runner):
    srv, _ = _server()
    rc = _classes(srv)
    cls = fused.DeviceRoutedRunner if runner == "device" else \
        fused.FusedStepRunner
    rng = np.random.default_rng(1)
    for neg_shape, frozen, want in (((B, N), (), (1, 0)),
                                    ((B, N), ("r",), (1, 0)),
                                    ((N,), (), (0, 4)),
                                    ((N,), ("r",), (0, 3))):
        batch = {"s": rng.integers(0, ENT, B),
                 "r": rng.integers(ENT, ENT + REL, B),
                 "o": rng.integers(0, ENT, B),
                 "neg": rng.integers(0, ENT, neg_shape)}
        run = cls(srv, make_kge_loss("rescal", 1.0, 0.1), rc, WIDTH,
                  frozen_roles=frozen)
        calls = _count(monkeypatch)
        for _ in range(2):
            assert np.isfinite(float(run(batch, None, 0.1)))
        assert (calls["rescal_step"], calls["adagrad_update"]) == \
            tuple(2 * w for w in want), (neg_shape, frozen, calls)
        monkeypatch.undo()


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("variant", ["no_replicas", "replicas"])
def test_run_scan_equals_sequential_steps_bitwise(variant):
    """Two windows of 3 against 6 sequential steps, with device-drawn
    negatives: the losses, both classes' pools and the locality counts
    are equal."""
    out = []
    for mode in ("sequential", "scan"):
        tech = "replication_only" if variant == "replicas" else "all"
        srv, ws = _server(shards=2, tech=tech)
        if variant == "replicas":
            ws[0].intent(np.arange(0, ENT + REL, 3), 0, 1000)
            srv.wait_sync()
        run = fused.DeviceRoutedRunner(
            srv, make_kge_loss("rescal"), _classes(srv), WIDTH,
            neg_role="neg", neg_shape=(B, N),
            neg_population=np.arange(ENT), seed=4)
        assert run._shard_has_replicas() == (variant == "replicas")
        rng = np.random.default_rng(2)
        batches = [{"s": rng.integers(0, ENT, B),
                    "r": rng.integers(ENT, ENT + REL, B),
                    "o": rng.integers(0, ENT, B)} for _ in range(6)]
        if mode == "sequential":
            losses = torch.stack([run(b, None, 0.1) for b in batches])
        else:
            losses = torch.cat([run.run_scan(batches[i:i + 3], None, 0.1)
                                for i in (0, 3)])
        assert run.steps == 6
        out.append((losses, [t.clone() for st in srv.stores
                             for t in (st.main, st.cache, st.delta)],
                    run.locality_counts()))
    (la, pa, ca), (lb, pb, cb) = out
    assert torch.equal(_bits(la), _bits(lb))
    assert len(pa) == 6
    for a, b in zip(pa, pb):
        assert torch.equal(_bits(a), _bits(b))
    assert ca == cb and ca["ops"] == 6


def test_run_scan_matches_jax_run_scan():
    """tests/test_device_routed.py's run_scan scenario with RESCAL's two
    classes on both packages (keys injected, no device draw: the two RNG
    streams differ); the port runs K16's plain version."""
    from adapm_tpu.config import SystemOptions
    e, r, de = 24, 4, 4
    vl = np.array([2 * de] * e + [2 * de * de] * r)
    srv_j = adapm_tpu.setup(e + r, vl, opts=SystemOptions(
        sync_max_per_sec=0, cache_slots_per_shard=8))
    srv_t = adapm_tpu_torch.setup(
        e + r, vl, device="cpu", num_shards=srv_j.num_shards,
        opts=adapm_tpu_torch.SystemOptions(sync_max_per_sec=0,
                                           cache_slots_per_shard=8))
    rng = np.random.default_rng(0)
    wt = srv_t.make_worker(0)
    for keys, w in ((np.arange(e), de), (np.arange(e, e + r), de * de)):
        init = rng.normal(size=(len(keys), 2 * w)).astype(np.float32)
        init[:, w:] = 1e-6
        srv_j.make_worker(0).set(keys, init)
        wt.wait(wt.set(keys, init))
    rc = {"s": int(srv_t.ab.key_class[0]), "o": int(srv_t.ab.key_class[0]),
          "neg": int(srv_t.ab.key_class[0]),
          "r": int(srv_t.ab.key_class[e])}
    assert rc == {k: int(srv_j.ab.key_class[0 if k != "r" else e])
                  for k in rc}
    kw = dict(role_class=rc, role_dim={"s": de, "r": de * de, "o": de,
                                       "neg": de}, shard=0)
    rj = JaxRunner(srv_j, jax_loss("rescal", 1.0, 0.1), **kw)
    rt = fused.DeviceRoutedRunner(srv_t, make_kge_loss("rescal", 1.0, 0.1),
                                  **kw)
    batches = [{"s": rng.integers(0, e, 16), "r": rng.integers(e, e + r, 16),
                "o": rng.integers(0, e, 16),
                "neg": rng.integers(0, e, (16, 3))} for _ in range(4)]
    batches = [{k: v.astype(np.int64) for k, v in b.items()}
               for b in batches]
    lj = np.asarray(rj.run_scan(batches, None, 0.1))
    lt = rt.run_scan(batches, None, 0.1).numpy()
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    np.testing.assert_allclose(srv_t.read_main(np.arange(e + r)),
                               srv_j.read_main(np.arange(e + r)), atol=1e-5)
    assert rt.locality_counts() == rj.locality_counts()
    assert rt.steps == rj.steps == 4
    srv_j.shutdown()
    srv_t.shutdown()


@pytest.mark.parametrize("route", ["host", "device", "scan"])
def test_app_rescal_steps_run_k16(monkeypatch, route):
    """The KGE app with --model rescal sends every step to K16's wrapper
    on host routes, device routes and --scan_steps windows, and K2 never
    runs."""
    from adapm_tpu_torch.apps import knowledge_graph_embeddings as tk
    argv = ["--model", "rescal", "--dim", "4", "--neg_ratio", "2",
            "--synthetic_entities", "40", "--synthetic_relations", "3",
            "--synthetic_triples", "200", "--epochs", "1",
            "--batch_size", "32", "--lr", "0.2", "--eval_every", "0",
            "--sys.sync.max_per_sec", "0", "--sys.prefetch", "0"]
    argv += {"host": ["--no-device_routes"], "device": [],
             "scan": ["--scan_steps", "2"]}[route]
    calls = _count(monkeypatch)
    res = tk.run_app(tk.build_parser().parse_args(argv), device="cpu")
    assert np.isfinite(res["epoch_losses"]).all()
    steps = 200 // 32 + (200 % 32 > 0)
    assert calls == {"rescal_step": steps, "adagrad_update": 0}, calls
