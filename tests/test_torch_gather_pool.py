"""K8 gather_pool (adapm_tpu_torch/ops/kernels.py, csrc/gather_pool.cu)
on the CPU: its plain version, TorchDevicePort.gather_pool and the
port's ShardedStore.gather_pool against the JAX package's NumpyRefPort
and JaxDevicePort, bitwise, on inputs made from a numpy seed.

Cases: sum and mean; duplicate members in one bag; empty bags; seg=OOB
padding and out-of-range coordinates (zero rows); replica-served
members (cache + delta); -0.0 rows; unsorted seg; L = 256 and an L not
divisible by 4. Negative coordinates are held to NumpyRefPort only
(jaxport wraps a negative index; the port reads 0, as refport does)."""
import numpy as np
import pytest
import torch

from adapm_tpu.device.jaxport import JaxDevicePort
from adapm_tpu.device.refport import OOB, NumpyRefPort
from adapm_tpu_torch.device.torchport import TorchDevicePort
from adapm_tpu_torch.ops import kernels as K

S, R, C = 2, 48, 16


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _case(seed, L, n=96, nbags=24, pad=8, negative=False):
    """Pools, member coordinates and a non-decreasing seg with duplicate
    members, empty bags, OOB coordinates, replica-served members, -0.0
    rows and OOB padding."""
    rng = np.random.default_rng(seed)
    pools = [rng.normal(size=(S, k, L)).astype(np.float32)
             for k in (R, C, C)]
    pools[0][0, :3] = -0.0                       # -0.0 main rows
    pools[1][1, :2] = -0.0                       # -0.0 cache + -0.0 delta
    pools[2][1, :2] = -0.0
    o_sh = rng.integers(0, S, n).astype(np.int32)
    o_sl = rng.integers(0, 12, n).astype(np.int32)       # duplicates
    o_sh[:4], o_sl[:4] = 0, np.arange(3).tolist() + [0]  # -0.0 members
    c_sh = rng.integers(0, S, n).astype(np.int32)
    c_sl = rng.integers(0, C, n).astype(np.int32)
    use_c = rng.random(n) < 0.25
    u = rng.random(n)
    u[:4] = 1.0                                   # bag 0: -0.0 members
    use_c[:4] = False
    o_sl[u < 0.08] = OOB                          # zero rows
    c_sl[(u >= 0.08) & (u < 0.12)] = OOB
    o_sh[(u >= 0.12) & (u < 0.15)] = S + 3
    if negative:
        o_sl[(u >= 0.15) & (u < 0.2)] = -3
        c_sh[(u >= 0.2) & (u < 0.25)] = -1
    # bags: every third bag empty, the rest 1..9 members, in order; bag
    # 0 holds the four -0.0 members
    sizes = rng.integers(1, 10, nbags)
    sizes[1::3] = 0
    sizes[0] = 4
    seg = np.repeat(np.arange(nbags), sizes)[:n].astype(np.int32)
    seg = np.concatenate([seg, np.full(n - len(seg), OOB, np.int32)])
    a = [o_sh, o_sl, c_sh, c_sl, use_c, seg]
    a = [np.concatenate([x, np.full(pad, f, x.dtype)])
         for x, f in zip(a, (0, OOB, 0, OOB, False, OOB))]
    out = np.zeros((nbags + 3, L), np.float32)
    out[[0, 1]] = -0.0            # -0.0 starting values: bag 0, empty bag 1
    return pools, a, out


def _torch_port(pools, a, out, pooling):
    tp = TorchDevicePort()
    t = [torch.from_numpy(p.copy()) for p in pools]
    return tp.gather_pool(*t, *a, out, pooling=pooling).numpy()


def _plain(pools, a, out, pooling):
    t = [torch.from_numpy(p.copy()) for p in pools]
    ta = [torch.from_numpy(x) for x in a]
    return K.gather_pool_plain(*t, *ta, torch.from_numpy(out.copy()),
                               pooling).numpy()


@pytest.mark.parametrize("L", [256, 7])
@pytest.mark.parametrize("pooling", ["sum", "mean"])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_k8_matches_refport_and_jaxport_bitwise(L, pooling, order):
    pools, a, out = _case(3 + L, L)
    if order == "unsorted":
        perm = np.random.default_rng(L).permutation(len(a[0]))
        a = [x[perm] for x in a]
    ref = NumpyRefPort().gather_pool(*pools, *a, out, pooling=pooling)
    jx = np.asarray(JaxDevicePort().gather_pool(*pools, *a, out,
                                                pooling=pooling))
    assert np.array_equal(_bits(ref), _bits(jx))
    for what, got in (("TorchDevicePort", _torch_port(pools, a, out,
                                                      pooling)),
                      ("gather_pool_plain", _plain(pools, a, out,
                                                   pooling))):
        assert np.array_equal(_bits(got), _bits(ref)), what
    # the cases are all there: duplicates, empty bags, -0.0 kept (bag 0
    # folds four -0.0 rows into -0.0; empty bag 1 keeps its -0.0 for sum)
    seg = a[5]
    cnt = np.bincount(seg[seg < 64], minlength=out.shape[0])
    assert (cnt == 0).any() and cnt.max() > 1 and (seg == OOB).any()
    assert np.signbit(ref[0]).all()
    assert np.signbit(ref[1]).all() == (pooling == "sum")


def test_k8_negative_coordinates_against_refport():
    for pooling in ("sum", "mean"):
        pools, a, out = _case(11, 12, negative=True)
        ref = NumpyRefPort().gather_pool(*pools, *a, out, pooling=pooling)
        assert np.array_equal(_bits(_torch_port(pools, a, out, pooling)),
                              _bits(ref))


def test_k8_owner_reads_and_starting_values():
    """Every member owner-served (use_c all False, as a table without
    replicas routes it); a non-zero `out` is each bag's starting value,
    as in jaxport."""
    pools, a, out = _case(5, 16)
    a[4] = np.zeros_like(a[4])
    out = np.random.default_rng(1).normal(size=out.shape).astype(np.float32)
    for pooling in ("sum", "mean"):
        ref = NumpyRefPort().gather_pool(*pools, *a, out, pooling=pooling)
        jx = np.asarray(JaxDevicePort().gather_pool(*pools, *a, out,
                                                    pooling=pooling))
        assert np.array_equal(_bits(_plain(pools, a, out, pooling)),
                              _bits(ref))
        assert np.array_equal(_bits(jx), _bits(ref))


def test_k8_wrapper_on_cpu_tensors_is_the_plain_version():
    pools, a, out = _case(9, 8)
    t = [torch.from_numpy(p) for p in pools]
    ta = [torch.from_numpy(x) for x in a]
    before = K.LAUNCHES["gather_pool"]
    got = K.gather_pool(*t, *ta, torch.from_numpy(out.copy()), "mean")
    assert K.LAUNCHES["gather_pool"] == before   # no launch on the CPU
    ref = NumpyRefPort().gather_pool(*pools, *a, out, pooling="mean")
    assert np.array_equal(_bits(got.numpy()), _bits(ref))
    with pytest.raises(ValueError, match="pooling"):
        K.gather_pool(*t, *ta, torch.from_numpy(out.copy()), "max")


def test_store_gather_pool_matches_the_jax_store():
    """ShardedStore.gather_pool of both packages on one seeded table:
    bucketed out, seg padded with OOB, pooled rows bitwise."""
    from adapm_tpu.core.store import ShardedStore as JStore
    from adapm_tpu.parallel.mesh import make_mesh
    from adapm_tpu_torch.core.store import ShardedStore as TStore
    from adapm_tpu_torch.device.context import make_context
    rng = np.random.default_rng(2)
    L, nk = 12, 40
    js = JStore(nk, L, make_mesh(2))
    ts = TStore(nk, L, make_context(2, "cpu"))
    sh = (np.arange(nk) % 2).astype(np.int32)
    sl = (np.arange(nk) // 2).astype(np.int32)
    vals = rng.normal(size=(nk, L)).astype(np.float32)
    z = np.zeros(nk, np.int32)
    for st in (js, ts):
        st.set_rows(sh, sl, vals, z, np.full(nk, OOB, np.int32))
    m = 37
    pick = rng.integers(0, nk, m)
    seg = np.sort(rng.integers(0, 11, m)).astype(np.int32)
    args = (sh[pick], sl[pick], np.zeros(m, np.int32),
            np.full(m, OOB, np.int32), np.zeros(m, bool), seg, 11)
    for pooling in ("sum", "mean"):
        a = np.asarray(js.gather_pool(*args, pooling=pooling))
        b = ts.gather_pool(*args, pooling=pooling).numpy()
        assert a.shape == b.shape == (16, L)
        assert np.array_equal(_bits(a), _bits(b))
    e = ts.export_epochs(sh[:5], sl[:5])
    assert ts.epochs_unchanged(sh[:5], sl[:5], e)
    ts.scatter_add(sh[:1], sl[:1], z[:1], np.full(1, OOB, np.int32),
                   vals[:1])
    assert not ts.epochs_unchanged(sh[:5], sl[:5], e)


# the DLRM-DCNv2 multi-hot sizes the bag path serves (chip_smoke.py
# DLRM_HOTS): one bag of 100 members, one of 27, one of 12 a sample
DLRM_HOTS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
             100, 27, 10, 3, 1, 1)


@pytest.mark.parametrize("pooling", ["sum", "mean"])
def test_k8_plain_on_bags_of_very_different_lengths(pooling):
    """The plain version and TorchDevicePort against NumpyRefPort on the
    bag lengths K8's redesign is built for: 4 samples of the DLRM
    multi-hot sizes, then a bag of 1,500 members among singletons, an
    empty bag in the middle, a last bag that runs up to the OOB padding
    and empty padding bags after it."""
    rng = np.random.default_rng(17)
    L = 6
    sizes = np.concatenate([np.tile(DLRM_HOTS, 4), [1, 1, 1500, 0, 1, 9]])
    seg = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    m = len(seg)
    n = 1 << int(np.ceil(np.log2(m)))
    pools = [rng.normal(size=(S, k, L)).astype(np.float32)
             for k in (R, C, C)]
    a = [rng.integers(0, S, n).astype(np.int32),
         rng.integers(0, R, n).astype(np.int32),
         rng.integers(0, S, n).astype(np.int32),
         rng.integers(0, C, n).astype(np.int32), rng.random(n) < 0.25,
         np.concatenate([seg, np.full(n - m, OOB, np.int32)])]
    out = rng.normal(size=(len(sizes) + 5, L)).astype(np.float32)
    ref = NumpyRefPort().gather_pool(*pools, *a, out, pooling=pooling)
    assert np.array_equal(_bits(_plain(pools, a, out, pooling)), _bits(ref))
    assert np.array_equal(_bits(_torch_port(pools, a, out, pooling)),
                          _bits(ref))
