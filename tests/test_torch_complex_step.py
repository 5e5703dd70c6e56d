"""K5's plain version (adapm_tpu_torch/ops/kernels.py complex_step_plain)
and the port's run_scan on the CPU.

- complex_step_plain against the JAX package's ComplEx loss under
  jax.value_and_grad plus the fused step's AdaGrad rule
  (adapm_tpu/ops/fused.py), at rtol 1e-5 / atol 1e-6: float32 model math
  that XLA and PyTorch sum in different orders; and against the port's
  own autograd path (KgeLoss + autograd + K2's plain version), bitwise:
  the closed form groups its terms as autograd does.
- a ComplEx step goes through complex_step (and not K2); other losses
  through autograd and K2.
- run_scan against sequential steps of the port, bitwise (same tables,
  same generator stream for device-drawn negatives), and against the JAX
  package's run_scan at rtol 1e-5 (losses) / atol 1e-5 (pools), as in
  tests/test_device_routed.py.
- the KGE app with --scan_steps 4, and ScanWindow's tail."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import adapm_tpu
import adapm_tpu_torch
from adapm_tpu.models.kge import make_kge_loss as jax_loss
from adapm_tpu.ops import DeviceRoutedRunner as JaxRunner
from adapm_tpu_torch.apps.common import ScanWindow
from adapm_tpu_torch.device.context import make_context
from adapm_tpu_torch.models import kge, make_kge_loss
from adapm_tpu_torch.ops import fused
from adapm_tpu_torch.ops import kernels as K

B, N, d = 16, 4, 8
D, L = 2 * d, 4 * d
ROLES = ("s", "r", "o", "neg")
LR, EPS = 0.1, 1e-10
RTOL, ATOL = 1e-5, 1e-6


def _rows(seed):
    """Gathered rows [emb 2d | acc 2d] per role, with duplicates: each
    triple's first negative is its subject row, and two triples share a
    relation row."""
    rng = np.random.default_rng(seed)

    def rows(*shape):
        x = rng.normal(size=shape + (L,)).astype(np.float32) * 0.3
        x[..., D:] = rng.random(shape + (D,)).astype(np.float32) * 0.01 \
            + 1e-6
        return x
    out = {"s": rows(B), "r": rows(B), "o": rows(B), "neg": rows(B, N)}
    out["neg"][:, 0] = out["s"]
    out["r"][1] = out["r"][0]
    return out


def _nrows(role):
    return B * N if role == "neg" else B


def _plain(rows, T, l2, trainable=ROLES):
    t = {k: torch.from_numpy(v) for k, v in rows.items()}
    out = {k: torch.full((_nrows(k), L), float("nan")) for k in trainable}
    grad = {k: torch.empty(_nrows(k), D) for k in ROLES}
    per = K.complex_step(t["s"], t["r"], t["o"], t["neg"],
                         torch.tensor([LR, EPS]), T, l2, out=out,
                         grad_out=grad)
    return per.sum() / B, grad, out


def _jax(rows, T, l2):
    embs = {k: jnp.asarray(v[..., :D]) for k, v in rows.items()}
    f = jax_loss("complex", T, l2)
    loss, g = jax.value_and_grad(lambda e: f(e, None))(embs)
    upd = {}
    for k in ROLES:
        gk = g[k]
        acc = jnp.asarray(rows[k][..., D:])
        g2 = gk * gk
        upd[k] = np.asarray(jnp.concatenate(
            [-LR * gk * jax.lax.rsqrt(acc + g2 + EPS), g2], -1)
        ).reshape(-1, L)
    return float(loss), {k: np.asarray(v).reshape(-1, D)
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
    # every occurrence of a duplicated row gets its own gradient row
    assert not np.allclose(grad["neg"].numpy()[0], grad["s"].numpy()[0])


@pytest.mark.parametrize("T,l2", [(0.0, 0.0), (1.0, 0.0), (0.0, 0.1),
                                  (1.0, 0.1)])
def test_plain_matches_the_autograd_path_bitwise(T, l2):
    """The closed form against KgeLoss under autograd plus K2's plain
    rule (the step's math for every other loss): gradients and update
    rows bitwise; the loss bitwise without L2 (with it the step sums
    per triple, autograd takes two means)."""
    rows = _rows(5)
    loss, grad, out = _plain(rows, T, l2)
    t = {k: torch.from_numpy(v) for k, v in rows.items()}
    leaves = {k: v[..., :D].clone().requires_grad_() for k, v in t.items()}
    ref = make_kge_loss("complex", T, l2)(leaves, None)
    g = dict(zip(ROLES, torch.autograd.grad(ref, [leaves[k]
                                                   for k in ROLES])))
    for k in ROLES:
        gk = g[k].reshape(-1, D)
        assert torch.equal(grad[k], gk), k
        upd = K.adagrad_update_plain(gk, t[k].reshape(-1, L)[:, D:], LR, EPS)
        assert torch.equal(out[k], upd), k
    if l2 == 0.0:
        assert torch.equal(loss, ref.detach())
    else:
        np.testing.assert_allclose(float(loss), float(ref.detach()), rtol=1e-6)


def _server(keys=120, shards=1, tech="all", seed=0):
    srv = adapm_tpu_torch.Server(
        keys, L, ctx=make_context(shards, "cpu"), num_workers=2,
        opts=adapm_tpu_torch.SystemOptions(
            sync_max_per_sec=0, cache_slots_per_shard=32,
            techniques=adapm_tpu_torch.MgmtTechniques(tech)))
    ws = [srv.make_worker(i) for i in range(2)]
    vals = np.random.default_rng(seed).normal(
        size=(keys, L)).astype(np.float32) * 0.1
    vals[:, D:] = 1e-6
    ws[0].wait(ws[0].set(np.arange(keys), vals))
    return srv, ws


def _square_loss(embs, aux):
    return sum((v * v).mean() for v in embs.values())


def _count(monkeypatch):
    """Count the step's calls of K5's wrapper (which KgeLoss's fused
    form calls) and K2's (which the fused step calls)."""
    calls = {"complex_step": 0, "adagrad_update": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    for mod, name in ((kge, "complex_step"), (fused, "adagrad_update")):
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    return calls


@pytest.mark.parametrize("runner", ["device", "host"])
def test_complex_steps_run_k5_and_other_losses_k2(monkeypatch, runner):
    srv, _ = _server()
    rc = dict.fromkeys(ROLES, 0)
    rd = dict.fromkeys(ROLES, D)
    cls = fused.DeviceRoutedRunner if runner == "device" else \
        fused.FusedStepRunner
    rng = np.random.default_rng(1)
    batch = {"s": rng.integers(0, 100, B), "r": rng.integers(100, 120, B),
             "o": rng.integers(0, 100, B),
             "neg": rng.integers(0, 100, (B, N))}
    for loss, frozen, want in (
            (make_kge_loss("complex"), (), (1, 0)),
            (make_kge_loss("complex", 1.0, 0.1), ("r",), (1, 0)),
            (_square_loss, (), (0, 4)), (_square_loss, ("r",), (0, 3))):
        run = cls(srv, loss, rc, rd, frozen_roles=frozen)
        calls = _count(monkeypatch)
        for _ in range(2):
            assert np.isfinite(float(run(batch, None, 0.1)))
        assert (calls["complex_step"], calls["adagrad_update"]) == \
            tuple(2 * w for w in want), (loss, frozen, calls)
        monkeypatch.undo()


def _aux_loss(embs, aux):
    pos = (embs["s"] * embs["o"]).sum(-1)
    neg = (embs["s"][:, None, :] * embs["neg"]).sum(-1)
    return (aux * torch.nn.functional.softplus(-pos)
            + torch.nn.functional.softplus(neg).sum(-1)).mean()


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("loss", ["complex", "aux"])
@pytest.mark.parametrize("variant", ["no_replicas", "replicas"])
def test_run_scan_equals_sequential_steps_bitwise(loss, variant):
    """Two windows of 3 against 6 sequential steps, with device-drawn
    negatives (and a per-step aux for the aux loss): the losses, the
    pools and the locality counts are equal."""
    out = []
    for mode in ("sequential", "scan"):
        tech = "replication_only" if variant == "replicas" else "all"
        srv, ws = _server(shards=2, tech=tech)
        if variant == "replicas":
            ws[0].intent(np.arange(0, 120, 3), 0, 1000)
            srv.wait_sync()
        roles = ("s", "r", "o", "neg") if loss == "complex" else \
            ("s", "o", "neg")
        fn = make_kge_loss("complex") if loss == "complex" else _aux_loss
        run = fused.DeviceRoutedRunner(
            srv, fn, dict.fromkeys(roles, 0), dict.fromkeys(roles, D),
            neg_role="neg", neg_shape=(B, N),
            neg_population=np.arange(100), seed=4)
        assert run._shard_has_replicas() == (variant == "replicas")
        rng = np.random.default_rng(2)
        batches = [{k: rng.integers(100, 120, B) if k == "r"
                    else rng.integers(0, 100, B) for k in roles
                    if k != "neg"} for _ in range(6)]
        auxes = [torch.full((B,), w) for w in (1.0, 0.5, 2.0, 1.5, 0.25,
                                               3.0)] \
            if loss == "aux" else [None] * 6
        if mode == "sequential":
            losses = torch.stack([run(b, a, 0.1)
                                  for b, a in zip(batches, auxes)])
        else:
            losses = torch.cat([
                run.run_scan(batches[i:i + 3],
                             auxes[i:i + 3] if loss == "aux" else None, 0.1)
                for i in (0, 3)])
        assert run.steps == 6
        out.append((losses, [t.clone() for st in srv.stores
                             for t in (st.main, st.cache, st.delta)],
                    run.locality_counts()))
    (la, pa, ca), (lb, pb, cb) = out
    assert torch.equal(_bits(la), _bits(lb))
    for a, b in zip(pa, pb):
        assert torch.equal(_bits(a), _bits(b))
    assert ca == cb and ca["ops"] == 6


def test_run_scan_rejects_mixed_windows():
    srv, _ = _server()
    rc = {"s": 0, "o": 0}
    run = fused.DeviceRoutedRunner(srv, _square_loss, rc,
                                   dict.fromkeys(rc, D))
    with pytest.raises(ValueError, match="share roles and shapes"):
        run.run_scan([{"s": [0, 1], "o": [2, 3]},
                      {"s": [0, 1, 2], "o": [2, 3, 4]}], None, 0.1)
    with pytest.raises(ValueError, match="one aux per batch"):
        run.run_scan([{"s": [0, 1], "o": [2, 3]}], [None, None], 0.1)


def _jax_make(num_keys=24):
    from adapm_tpu.config import SystemOptions
    srv = adapm_tpu.setup(num_keys, 8,
                          opts=SystemOptions(sync_max_per_sec=0,
                                             cache_slots_per_shard=8))
    t = adapm_tpu_torch.setup(num_keys, 8, device="cpu",
                              num_shards=srv.num_shards,
                              opts=adapm_tpu_torch.SystemOptions(
                                  sync_max_per_sec=0,
                                  cache_slots_per_shard=8))
    init = np.random.default_rng(0).normal(
        size=(num_keys, 8)).astype(np.float32)
    init[:, 4:] = 1e-6
    srv.make_worker(0).set(np.arange(num_keys), init)
    w = t.make_worker(0)
    w.wait(w.set(np.arange(num_keys), init))
    return srv, t


@pytest.mark.parametrize("loss", ["dot", "complex"])
def test_run_scan_matches_jax_run_scan(loss):
    """tests/test_device_routed.py's run_scan scenario on both packages
    (keys injected, no device draw: the two RNG streams differ); the
    ComplEx form runs K5's plain version in the port."""
    srv_j, srv_t = _jax_make()
    if loss == "dot":
        roles = ("a", "b")

        def f_j(embs, aux):
            return ((embs["a"] * embs["b"]).sum(-1) ** 2).mean()

        def f_t(embs, aux):
            return ((embs["a"] * embs["b"]).sum(-1) ** 2).mean()
    else:
        roles = ROLES
        f_j, f_t = jax_loss("complex", 1.0, 0.1), \
            make_kge_loss("complex", 1.0, 0.1)
    kw = dict(role_class=dict.fromkeys(roles, 0),
              role_dim=dict.fromkeys(roles, 4), shard=0)
    rj, rt = JaxRunner(srv_j, f_j, **kw), \
        fused.DeviceRoutedRunner(srv_t, f_t, **kw)
    rng = np.random.default_rng(7)
    batches = [{r: rng.integers(0, 24, (16, 3) if r == "neg" else 16)
                .astype(np.int64) for r in roles} for _ in range(4)]
    lj = np.asarray(rj.run_scan(batches, None, 0.1))
    lt = rt.run_scan(batches, None, 0.1).numpy()
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    np.testing.assert_allclose(srv_t.read_main(np.arange(24)),
                               srv_j.read_main(np.arange(24)), atol=1e-5)
    assert rt.locality_counts() == rj.locality_counts()
    assert rt.steps == rj.steps == 4
    srv_j.shutdown()
    srv_t.shutdown()


def test_app_scan_steps_trains(monkeypatch):
    """tests/test_apps.py's --scan_steps 4 configuration on the port (one
    shard: 13 batches an epoch, three windows and a one-step tail): the
    windows run through run_scan, the quality bar holds, and the epochs
    equal the per-step run's."""
    from adapm_tpu_torch.apps import knowledge_graph_embeddings as tk
    argv = ["--dim", "8", "--neg_ratio", "2", "--synthetic_entities", "60",
            "--synthetic_relations", "4", "--synthetic_triples", "400",
            "--epochs", "4", "--batch_size", "32", "--lr", "0.2",
            "--eval_every", "4", "--eval_triples", "60",
            "--sys.sync.max_per_sec", "0", "--sys.prefetch", "0"]
    windows = []
    scan = fused.DeviceRoutedRunner.run_scan
    monkeypatch.setattr(fused.DeviceRoutedRunner, "run_scan",
                        lambda self, b, *a: windows.append(len(b))
                        or scan(self, b, *a))
    res = tk.run_app(tk.build_parser().parse_args(
        argv + ["--scan_steps", "4"]), device="cpu")
    assert windows == [4] * 12, windows
    assert res["mrr"] > 0.12, res
    per_step = tk.run_app(tk.build_parser().parse_args(argv), device="cpu")
    assert res["epoch_losses"] == per_step["epoch_losses"]


class _FakeRunner:
    def __init__(self):
        self.calls = []

    def __call__(self, roles, aux, lr):
        self.calls.append(("step", roles))
        return torch.tensor(1.0)

    def run_scan(self, batches, auxes, lr):
        self.calls.append(("scan", len(batches), auxes))
        return torch.ones(len(batches))


class _FakeServer:
    def __init__(self):
        self.rounds = []

    def drive_rounds(self, n):
        self.rounds.append(n)


def test_scan_window_full_and_tail():
    srv, run, losses = _FakeServer(), _FakeRunner(), []
    win = ScanWindow(srv, 3, 2, on_loss=losses.append)
    for i in range(7):
        win.add(run, {"k": i}, None, 0.1)
    win.flush(0.1)
    assert [c[0] for c in run.calls] == ["scan", "scan", "step"]
    assert run.calls[0][2] is None
    assert srv.rounds == [6, 6, 2]
    assert [x.numel() for x in losses] == [3, 3, 1]
    win.add(run, {"k": 0}, {"w": 1}, 0.1)
    win.add(run, {"k": 1}, {"w": 2}, 0.1)
    win.add(run, {"k": 2}, {"w": 3}, 0.1)
    assert run.calls[-1] == ("scan", 3, [{"w": 1}, {"w": 2}, {"w": 3}])
