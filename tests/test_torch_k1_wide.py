"""K1 routed_gather at RESCAL's relation-row widths (rows [emb d² |
adagrad d²] of 32,768 f32 at d=128; 32,766 for the 4-byte form): its
plain version bitwise the JAX programs it replaces (device/jaxport.py
_gather and _read_rows_at, ops/fused.py _read_rows) in both forms, over
several segments, with out-of-range coordinates, cached -0.0 + -0.0 rows
and heavy repeats (48 rows from 6 distinct slots). Negative coordinates
are held to NumpyRefPort alone (XLA wraps them; the JAX package never
dispatches one). And K1's column slab (ops/kernels.py _k1_slab): every
column in exactly one slab, whole 16-byte elements on the float4 form,
whole rows at 512 f32, a slab's named rows within the L2 budget.
The CUDA launches themselves are checked on the card by
tests/test_torch_gpu.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adapm_tpu.device import jaxport, refport
from adapm_tpu.ops import fused as jfused
from adapm_tpu_torch.ops import kernels as K

OOB = int(jaxport.OOB)
S, R, C = 2, 4, 3
N_ROWS = 48
WIDTHS = [32_768, 32_766]


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(L, negative, seed=0):
    """Pools of a few slots, and N_ROWS coordinates into them: 6 distinct
    main rows and 6 distinct cache rows, each named ~8 times, with OOB,
    shard-past-the-end (and negative) coordinates and cached -0.0 +
    -0.0 rows."""
    rng = np.random.default_rng(seed + L)
    main = rng.normal(size=(S, R, L)).astype(np.float32)
    cache = rng.normal(size=(S, C, L)).astype(np.float32)
    delta = rng.normal(size=(S, C, L)).astype(np.float32)
    main[0, 0] = -0.0
    cache[1, 0] = -0.0
    delta[1, 0] = -0.0

    def coords(slots):
        pick = rng.integers(0, 6, N_ROWS)
        sh = (pick % S).astype(np.int32)
        sl = (pick // S % slots).astype(np.int32)
        bad = rng.random(N_ROWS)
        sl[bad < 0.1] = OOB
        sh[(bad >= 0.1) & (bad < 0.15)] = S
        if negative:
            sl[(bad >= 0.15) & (bad < 0.2)] = -3
        return sh, sl

    o_sh, o_sl = coords(R)
    o_sh[:3], o_sl[:3] = 0, 0                   # main -0.0 rows
    c_sh, c_sl = coords(C)
    c_sh[3:6], c_sl[3:6] = 1, 0                 # cached -0.0 + -0.0 rows
    use_c = rng.random(N_ROWS) < 0.5
    use_c[3:6] = True
    use_c[:3] = False
    return main, cache, delta, (o_sh, o_sl, c_sh, c_sl, use_c)


@pytest.mark.parametrize("L", WIDTHS)
@pytest.mark.parametrize("full", [False, True])
def test_plain_matches_jax_bitwise(L, full):
    main, cache, delta, idx = _case(L, negative=False)
    if full:
        got = K.routed_gather(*[_t(a) for a in (main, cache, delta) + idx])
        ref = jaxport._gather(jnp.asarray(main), jnp.asarray(cache),
                              jnp.asarray(delta), *idx)
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        ref2 = jfused._read_rows(jnp.asarray(main), jnp.asarray(cache),
                                 jnp.asarray(delta), tuple(idx))
        np.testing.assert_array_equal(_bits(got), _bits(ref2))
        assert np.signbit(got.numpy()[3:6]).all(), \
            "-0.0 + -0.0 must stay -0.0"
    else:
        got = K.routed_gather(_t(main), None, None, _t(idx[0]), _t(idx[1]))
        ref = jaxport._read_rows_at(jnp.asarray(main), *idx[:2])
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        assert np.signbit(got.numpy()[:3]).all(), "-0.0 rows must survive"


@pytest.mark.parametrize("L", WIDTHS)
@pytest.mark.parametrize("full", [False, True])
def test_plain_matches_refport_with_negatives(L, full):
    main, cache, delta, idx = _case(L, negative=True, seed=1)
    if full:
        got = K.routed_gather(*[_t(a) for a in (main, cache, delta) + idx])
        ref = refport.NumpyRefPort().gather(main, cache, delta, *idx)
    else:
        got = K.routed_gather(_t(main), None, None, _t(idx[0]), _t(idx[1]))
        ref = refport._fill_gather(main, *idx[:2])
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("L", WIDTHS)
@pytest.mark.parametrize("full", [False, True])
def test_segments_match_jax_bitwise(L, full):
    """Several segments, one empty, in one call: the JAX program on the
    joined batch, rows in segment order."""
    main, cache, delta, idx = _case(L, negative=False, seed=2)
    cols = idx if full else idx[:2]
    cuts = np.cumsum([10, 0, 17])
    segs = [tuple(_t(c) for c in parts)
            for parts in zip(*[np.split(c, cuts) for c in cols])]
    pools = (_t(main), _t(cache), _t(delta)) if full else (_t(main), None,
                                                          None)
    got = K.routed_gather_segments(*pools, segs)
    ref = jaxport._gather(jnp.asarray(main), jnp.asarray(cache),
                          jnp.asarray(delta), *idx) if full else \
        jaxport._read_rows_at(jnp.asarray(main), *idx[:2])
    assert got.shape == (N_ROWS, L)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


# (n, L, pool rows, vec): RESCAL's relation class and its 4-byte twin,
# the fused step's entity rows (512 and 256 f32), the GPU tests' shapes,
# a batch smaller than its pool, and a row of one block past 512 f32
PLAN_SHAPES = [(4096, 32_768, 1256, True), (4096, 32_766, 1256, False),
               (4096, 32_768, 3 * 1256, True), (143_360, 512, 250_000, True),
               (143_360, 512, 250_000, False), (278_528, 256, 250_000, True),
               (500, 32_768, 220, True), (500, 32_766, 220, False),
               (48, 32_768, 8, True), (20_000, 1_028, 100_000, True),
               (1, 4, 1, True)]


@pytest.mark.parametrize("n,L,rows,vec", PLAN_SHAPES)
def test_k1_slab_covers_every_column_once(n, L, rows, vec):
    """The slab K1's launch walks (the C entry's grid y: ceil(L / slab)
    slabs of `slab` f32, the last one cut at L) covers every column of
    the row exactly once, in whole 16-byte elements on the float4 form,
    in at most 65,535 slabs."""
    slab = K._k1_slab(n, L, rows, vec)
    assert 1 <= slab <= L
    slabs = [(lo, min(L, lo + slab)) for lo in range(0, L, slab)]
    assert 1 <= len(slabs) <= 65_535
    cover = np.zeros(L, np.int64)
    for lo, hi in slabs:
        assert lo < hi, "no empty slab"
        cover[lo:hi] += 1
        if vec:
            assert lo % 4 == 0 and hi % 4 == 0, "16-byte slabs"
    assert (cover == 1).all()


@pytest.mark.parametrize("n,L,rows,vec", [(143_360, 512, 250_000, True),
                                          (143_360, 512, 250_000, False),
                                          (143_360, 510, 250_000, False),
                                          (278_528, 256, 250_000, True),
                                          (500, 12, 120, True),
                                          (48, 32_768, 6, True)])
def test_k1_slab_keeps_whole_rows_where_they_fit(n, L, rows, vec):
    """Rows of at most 512 f32, or rows whose named set fits in half of
    L2, are walked whole: one slab, the kernel the narrow rows had."""
    assert K._k1_slab(n, L, rows, vec) == L


@pytest.mark.parametrize("vec", [True, False])
def test_k1_slab_of_relation_rows_fits_the_budget(vec):
    """RESCAL's 4,096 relation rows (1,000 relations, 1,256 pool slots):
    slabs of one column block (512 f32 on the float4 form, 128 on the
    4-byte one), the pool's rows times a slab within K1_L2_BYTES."""
    L = 32_768 if vec else 32_766
    slab = K._k1_slab(4096, L, 1256, vec)
    assert slab == (512 if vec else 128)
    assert 1256 * slab * 4 <= K.K1_L2_BYTES
    assert 1256 * L * 4 > K.K1_L2_BYTES


@pytest.mark.parametrize("L", [32_768 * 4096, 32_766 * 4096])
def test_k1_slab_caps_the_slabs_of_very_wide_rows(L):
    """Rows too wide for 65,535 one-block slabs take slabs of several
    blocks, still whole 16-byte elements on the float4 form."""
    vec = L % 4 == 0
    slab = K._k1_slab(2, L, 2, vec)
    assert -(-L // slab) <= 65_535 < -(-L // (512 if vec else 128))
    assert slab % (512 if vec else 128) == 0
