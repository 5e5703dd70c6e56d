"""The port's CUDA kernels on the card, against their plain PyTorch
versions (adapm_tpu_torch/ops/kernels.py) — bitwise for K1 and K3, within
rtol 1e-5 for K2 (CUDA's rsqrt vs the CPU's 1/sqrt), K4's counts equal on
integer-valued data (every summation order gives the same f32 sums) and
within the near-tie rule on random data — plus a small fused step on
cuda against the same step on cpu.

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


def _k4_case(rng, dev, B, K, L, E=700, C=256, integer=False):
    S, R = 2, 400
    nk = E + 10
    flat = rng.permutation(S * R)[:nk]
    owner = torch.from_numpy((flat // R).astype(np.int32))
    slot = torch.from_numpy((flat % R).astype(np.int32))
    if integer:
        pool = torch.from_numpy(rng.integers(-4, 5, (S, R, L))).float()
        q_o, q_s = (torch.from_numpy(rng.integers(-3, 4, (B, K))).float()
                    for _ in range(2))
    else:
        pool = torch.randn(S, R, L)
        q_o, q_s = torch.randn(B, K), torch.randn(B, K)
    nch = -(-E // C)
    pad = np.zeros(nch * C, np.int32)
    pad[:E] = rng.permutation(E)
    keys = torch.from_numpy(pad.reshape(nch, C))
    okey = torch.from_numpy(rng.integers(0, E, B).astype(np.int32))
    skey = torch.from_numpy(rng.integers(0, E, B).astype(np.int32))
    # true scores of real candidates: exact ties on integer data
    rows = pool[owner[okey.long()].long(), slot[okey.long()].long(), :K]
    true = (q_o * rows).sum(1)
    args = [pool, owner, slot, keys, E, q_o, q_s, true, okey, skey]
    return args, [a.to(dev) if torch.is_tensor(a) else a for a in args]


@pytest.mark.parametrize("B,Kd,L", [(64, 256, 512), (150, 16, 32),
                                    (37, 7, 9), (5, 130, 130)])
def test_pool_eval_counts_exact_on_integers(cuda, B, Kd, L):
    """Vector and scalar staging, several query blocks, K not a
    multiple of the 32-column chunk, a padded candidate tail."""
    rng = np.random.default_rng(Kd)
    ref_args, dev_args = _k4_case(rng, cuda, B, Kd, L, integer=True)
    ref = K.pool_eval_counts(*ref_args)
    got = K.pool_eval_counts(*dev_args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
    assert int(ref[0].sum()) > 0


def test_pool_eval_counts_near_ties(cuda):
    rng = np.random.default_rng(1)
    ref_args, dev_args = _k4_case(rng, cuda, 64, 256, 512)
    g_o, g_s = K.pool_eval_counts(*dev_args, parts=2)
    p_o, p_s, t_o, t_s = K.pool_eval_counts_plain(*ref_args, parts=2,
                                                  ties=True)
    assert ((g_o.cpu() - p_o).abs() <= t_o).all()
    assert ((g_s.cpu() - p_s).abs() <= t_s).all()


def test_wrappers_raise_on_bad_cuda_input(cuda):
    pool = torch.zeros(2, 4, 8, device=cuda)
    idx = torch.zeros(3, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        K.routed_gather(pool, None, None, idx, idx)       # int64 coords
    with pytest.raises(ValueError):
        K.ordered_scatter_add(pool.double(), idx.int(), idx.int(),
                              torch.zeros(3, 8, device=cuda))
    q = torch.zeros(2, 8, device=cuda)
    with pytest.raises(ValueError):                       # int64 keys
        K.pool_eval_counts(pool, idx.int(), idx.int(), idx.view(1, 3), 3,
                           q, q, q[:, 0].contiguous(), idx.int()[:2],
                           idx.int()[:2])


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
