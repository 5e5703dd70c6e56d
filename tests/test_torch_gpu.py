"""The port's CUDA kernels on the card, against their plain PyTorch
versions (adapm_tpu_torch/ops/kernels.py) — bitwise for K1 and K3, within
rtol 1e-5 for K2 (CUDA's rsqrt vs the CPU's 1/sqrt) — plus a small fused
step on cuda against the same step on cpu.

Every case needs a CUDA device and skips without one. This file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from adapm_tpu_torch.ops import kernels as K

OOB = 2**31 - 2
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


def _coords(rng, n, shards, slots):
    sh = rng.integers(0, shards, n).astype(np.int32)
    sl = rng.integers(0, slots, n).astype(np.int32)
    u = rng.random(n)
    sl[u < 0.1] = OOB
    sl[(u >= 0.1) & (u < 0.15)] = -3
    sh[(u >= 0.15) & (u < 0.2)] = shards
    return torch.from_numpy(sh), torch.from_numpy(sl)


@pytest.mark.parametrize("L", [12, 64, 7])
def test_routed_gather_both_forms_bitwise(cuda, L):
    rng = np.random.default_rng(L)
    S, R, C, n = 3, 40, 20, 500
    main, cache, delta = (torch.randn(S, k, L) for k in (R, C, C))
    main[0, :3] = -0.0
    o = _coords(rng, n, S, R)
    c = _coords(rng, n, S, C)
    use_c = torch.from_numpy(rng.random(n) < 0.5)
    for args in ((main, None, None) + o,
                 (main, cache, delta) + o + c + (use_c,)):
        ref = K.routed_gather(*args)
        got = K.routed_gather(*[a if a is None else a.to(cuda)
                                for a in args])
        assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("L", [16, 5])
def test_ordered_scatter_add_bitwise_and_deterministic(cuda, L):
    rng = np.random.default_rng(L)
    S, R, n = 2, 30, 3000
    base = torch.randn(S, R, L)
    sh, sl = _coords(rng, n, S, 6)              # heavy duplicates
    vals = torch.from_numpy((rng.normal(size=(n, L)) * 10.0 ** rng.integers(
        -3, 4, (n, 1))).astype(np.float32))
    ref = base.clone()
    K.ordered_scatter_add(ref, sh, sl, vals)
    outs = []
    for _ in range(2):
        pool = base.clone().to(cuda)
        K.ordered_scatter_add(pool, sh.to(cuda), sl.to(cuda), vals.to(cuda))
        outs.append(pool)
    assert torch.equal(_bits(outs[0]), _bits(ref))
    assert torch.equal(_bits(outs[1]), _bits(ref))


def test_adagrad_both_forms(cuda):
    g = torch.randn(300, 16)
    rows = torch.rand(300, 32)
    ref = K.adagrad_update(g, rows[:, 16:], 0.1, 1e-10)
    got = K.adagrad_update(g.to(cuda), rows.to(cuda)[:, 16:], 0.1, 1e-10)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-7)
    assert torch.equal(_bits(got[:, 16:]), _bits(ref[:, 16:]))
    emb, acc = rows[:, :16].contiguous(), rows[:, 16:].contiguous()
    re, ra = K.adagrad_apply(g, emb, acc, 0.1, 1e-10)
    ge, ga = K.adagrad_apply(g.to(cuda), emb.to(cuda), acc.to(cuda), 0.1,
                             1e-10)
    torch.testing.assert_close(ga.cpu(), ra, rtol=1e-5, atol=0)
    torch.testing.assert_close(ge.cpu(), re, rtol=1e-4, atol=1e-6)


def test_wrappers_raise_on_bad_cuda_input(cuda):
    pool = torch.zeros(2, 4, 8, device=cuda)
    idx = torch.zeros(3, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        K.routed_gather(pool, None, None, idx, idx)       # int64 coords
    with pytest.raises(ValueError):
        K.ordered_scatter_add(pool.double(), idx.int(), idx.int(),
                              torch.zeros(3, 8, device=cuda))


def test_small_fused_steps_cuda_match_cpu(cuda):
    import adapm_tpu_torch as at
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    roles = ("s", "r", "o", "neg")
    pools = []
    for dev in (cuda, "cpu"):
        rng = np.random.default_rng(0)
        srv = at.setup(300, 32, num_shards=2, num_workers=2, device=dev,
                       opts=at.SystemOptions(sync_max_per_sec=0))
        w0, w1 = srv.make_worker(0), srv.make_worker(1)
        vals = rng.normal(size=(300, 32)).astype(np.float32) * 0.1
        vals[:, 16:] = 1e-6                    # AdaGrad accumulators
        w0.wait(w0.set(np.arange(300), vals))
        w1.intent(np.arange(0, 300, 2), 0, 100)
        srv.wait_sync()
        w0.intent(np.arange(0, 300, 2), 0, 100)
        srv.wait_sync()
        runner = DeviceRoutedRunner(
            srv, make_kge_loss("complex"),
            role_class=dict.fromkeys(roles, 0),
            role_dim=dict.fromkeys(roles, 16))
        for _ in range(4):
            runner({"s": rng.integers(0, 280, 32),
                    "r": rng.integers(280, 300, 32),
                    "o": rng.integers(0, 280, 32),
                    "neg": rng.integers(0, 280, (32, 3))}, None, 0.1)
            srv.sync.run_round(all_channels=True)
        assert runner._shard_has_replicas()
        pools.append([t.cpu() for t in (srv.stores[0].main,
                                        srv.stores[0].cache,
                                        srv.stores[0].delta)])
    for a, b in zip(*pools):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
