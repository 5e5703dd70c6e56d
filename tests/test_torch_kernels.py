"""The port's kernels (adapm_tpu_torch/ops/kernels.py) against the JAX
package: each kernel's plain PyTorch version is held to the JAX program
it replaces on the CPU — bitwise for the data plane (K1 routed gather,
K3 ordered scatter-add), within the Pallas test's tolerances for K2
(AdaGrad). The CUDA launches themselves are checked on the card by
tests/test_torch_gpu.py and chip_smoke.py.

Negative coordinates: the port reads 0 for them and drops their writes,
as `refport._valid` specifies. XLA instead wraps an index in [-n, 0)
(the JAX package never dispatches one: its callers validate first), so
cases with negative coordinates are held to `NumpyRefPort` alone."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adapm_tpu.device import jaxport, refport
from adapm_tpu.ops import fused as jfused
from adapm_tpu.ops.pallas_kernels import adagrad_apply as pallas_adagrad
from adapm_tpu_torch.ops import kernels as K

OOB = int(jaxport.OOB)
S, R, C, L = 8, 24, 16, 12


def _pools(rng):
    main = rng.normal(size=(S, R, L)).astype(np.float32)
    cache = rng.normal(size=(S, C, L)).astype(np.float32)
    delta = rng.normal(size=(S, C, L)).astype(np.float32)
    # signed zeros: a select keeps -0.0, an add of +0.0 would not
    main[0, :3] = -0.0
    cache[1, :2] = -0.0
    delta[1, :2] = -0.0
    return main, cache, delta


def _coords(rng, n, shards, slots, negative=False):
    sh = rng.integers(0, shards, n).astype(np.int32)
    sl = rng.integers(0, slots, n).astype(np.int32)
    bad = rng.random(n)
    sl[bad < 0.1] = OOB            # the padding sentinel
    sh[(bad >= 0.15) & (bad < 0.2)] = shards  # shard past the end
    if negative:                   # must read 0 / drop, never wrap
        sl[(bad >= 0.1) & (bad < 0.15)] = -3
    sl[:4] = [0, 1, 2, 0]
    sh[:4] = 0
    return sh, sl


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gather_case(seed, negative):
    rng = np.random.default_rng(seed)
    main, cache, delta = _pools(rng)
    n = 96
    o_sh, o_sl = _coords(rng, n, S, R, negative)
    c_sh, c_sl = _coords(rng, n, S, C, negative)
    c_sh[4:8], c_sl[4:8] = 1, np.arange(4)     # cached -0.0 + -0.0 rows
    use_c = rng.random(n) < 0.5
    use_c[4:8] = True
    args = (main, cache, delta, o_sh, o_sl, c_sh, c_sl, use_c)
    return args, K.routed_gather(*[_t(a) for a in args])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routed_gather_plain_matches_jax_gather_bitwise(seed):
    (main, cache, delta, *idx), got = _gather_case(seed, negative=False)
    ref = jaxport._gather(jnp.asarray(main), jnp.asarray(cache),
                          jnp.asarray(delta), *idx)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    # the fused step's read is the same program
    ref2 = jfused._read_rows(jnp.asarray(main), jnp.asarray(cache),
                             jnp.asarray(delta), tuple(idx))
    np.testing.assert_array_equal(_bits(got), _bits(ref2))


@pytest.mark.parametrize("seed", [0, 1])
def test_routed_gather_plain_matches_refport_with_negatives(seed):
    args, got = _gather_case(seed, negative=True)
    ref = refport.NumpyRefPort().gather(*args)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_routed_gather_main_only_matches_fill_gather_bitwise():
    rng = np.random.default_rng(3)
    main, _, _ = _pools(rng)
    sh, sl = _coords(rng, 64, S, R, negative=True)
    ref = refport._fill_gather(main, sh, sl)
    got = K.routed_gather(_t(main), None, None, _t(sh), _t(sl))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert np.signbit(got.numpy()[:3]).any(), "-0.0 rows must survive"


@pytest.mark.parametrize("seed,negative", [(0, False), (1, False),
                                           (2, True)])
def test_ordered_scatter_plain_matches_jax_and_add_at_bitwise(seed,
                                                              negative):
    rng = np.random.default_rng(seed)
    main, _, delta = _pools(rng)
    n = 200
    # heavy duplicates: 200 entries over a handful of rows
    sh = rng.integers(0, 2, n).astype(np.int32)
    sl = rng.integers(0, 4, n).astype(np.int32)
    sl[rng.random(n) < 0.1] = OOB
    sh[rng.random(n) < 0.05] = -1 if negative else S
    vals = (rng.normal(size=(n, L)) * 10.0 ** rng.integers(-3, 4, (n, 1))
            ).astype(np.float32)
    ref_np = main.copy()
    refport._drop_add(ref_np, sh, sl, vals)
    pool = _t(main.copy())
    K.ordered_scatter_add(pool, _t(sh), _t(sl), _t(vals))
    np.testing.assert_array_equal(_bits(pool), _bits(ref_np))
    if not negative:
        oob = np.full(n, OOB, np.int32)
        ref_jax, _ = jaxport._scatter_add(
            jnp.asarray(main), jnp.asarray(delta), sh, sl,
            np.zeros(n, np.int32), oob, vals)
        np.testing.assert_array_equal(_bits(pool), _bits(ref_jax))


def test_adagrad_apply_plain_matches_pallas():
    rng = np.random.default_rng(1)
    n, D = 512, 16
    g = rng.normal(size=(n, D)).astype(np.float32)
    emb = rng.normal(size=(n, D)).astype(np.float32)
    acc = np.abs(rng.normal(size=(n, D))).astype(np.float32)
    ref_emb, ref_acc = pallas_adagrad(jnp.asarray(g), jnp.asarray(emb),
                                      jnp.asarray(acc), 0.1, 1e-10,
                                      interpret=True)
    got_emb, got_acc = K.adagrad_apply(_t(g), _t(emb), _t(acc), 0.1, 1e-10)
    # the Pallas test's tolerances (tests/test_pallas_kernels.py)
    np.testing.assert_allclose(got_acc.numpy(), np.asarray(ref_acc),
                               rtol=1e-5)
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(ref_emb),
                               rtol=1e-4, atol=1e-6)


def test_adagrad_update_plain_matches_fused_delta_row():
    rng = np.random.default_rng(2)
    n, D = 256, 16
    g = rng.normal(size=(n, D)).astype(np.float32)
    rows = np.abs(rng.normal(size=(n, 2 * D))).astype(np.float32)
    lr, eps = 0.05, 1e-10
    # the delta row exactly as ops/fused.py writes it
    gj, accj = jnp.asarray(g), jnp.asarray(rows[:, D:])
    import jax
    ref = jnp.concatenate(
        [-jnp.float32(lr) * gj * jax.lax.rsqrt(accj + gj * gj + eps),
         gj * gj], axis=-1)
    got = K.adagrad_update(_t(g), _t(rows)[:, D:], lr, eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)
    # g^2 half is one rounded multiply on both sides
    np.testing.assert_array_equal(_bits(got[:, D:]), _bits(ref[:, D:]))


def test_wrappers_reject_mixed_or_unsupported_devices():
    pool = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError):
        K._on_cuda(pool, torch.zeros(3, device="meta"))
    with pytest.raises(ValueError):
        K._on_cuda(torch.zeros(1, device="meta"))
