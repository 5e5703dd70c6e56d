"""The port's KGE eval programs, dataset generators and alias table against
the JAX package's, on the same numpy inputs.

Pool-eval counts (K4's plain version, which the wrapper takes on the
CPU) against JAX make_pool_eval_counts, for ComplEx and RESCAL in both
`shared_pool` forms, with a chunk that does not divide E. The near-tie
rule: the two sum their dot products in different orders, so a
candidate whose score lies within the f32 dot-product error bound of
the true score (2*g*sum|q_k*row_k|, g = K*2^-24/(1 - K*2^-24); see
`pool_eval_counts_plain`) may be counted by one and not the other; each
count may therefore differ by at most the number of such candidates
(`pool_eval_counts_plain(ties=True)`), and must be equal where there
is none. True scores: rtol 1e-6 (one float32 score, summed in another
order), with atol 1e-6 for the scores near zero, where that sum
cancels terms of order one. Dense all-entity scores: rtol 1e-5 / atol
1e-5 (float32 matmuls). Host-path datasets and the alias table: bitwise."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adapm_tpu.io import kge as jio
from adapm_tpu.models import kge as jkge
from adapm_tpu.models.sgns import build_alias_table as j_alias
from adapm_tpu_torch.io import kge as tio
from adapm_tpu_torch.models import kge as tkge
from adapm_tpu_torch.models.sgns import build_alias_table as t_alias
from adapm_tpu_torch.ops import kernels as K

S, SLOTS, E, R, B, C = 2, 96, 150, 6, 10, 64   # C does not divide E


def _pool_case(model, shared, d=6, seed=0, B=B):
    """A random pool with entity and relation rows placed by a random
    owner/slot table; returns numpy inputs of the count program."""
    rng = np.random.default_rng(seed)
    ent_dim = 2 * d if model == "complex" else d
    rel_dim = 2 * d if model == "complex" else d * d
    L = 2 * max(ent_dim, rel_dim)
    nk = E + R
    flat = rng.permutation(S * SLOTS)[:nk]
    owner = (flat // SLOTS).astype(np.int32)
    slot = (flat % SLOTS).astype(np.int32)
    ent_main = rng.normal(size=(S, SLOTS, L)).astype(np.float32)
    rel_main = ent_main if shared else \
        rng.normal(size=(S, SLOTS, L)).astype(np.float32)
    ekeys = rng.permutation(E).astype(np.int32)
    nch = -(-E // C)
    pad = np.full(nch * C, ekeys[0], np.int32)
    pad[:E] = ekeys
    s = rng.integers(0, E, B).astype(np.int32)
    o = rng.integers(0, E, B).astype(np.int32)
    o[:3] = s[:3]  # true key excluded by key on both sides
    r = (E + rng.integers(0, R, B)).astype(np.int32)
    return dict(ent_dim=ent_dim, rel_dim=rel_dim, owner=owner, slot=slot,
                ent_main=ent_main, rel_main=rel_main,
                keys=pad.reshape(nch, C), s=s, r=r, o=o)


def _jax_and_torch_counts(c, model, shared, batches):
    """The JAX program on the whole query batch, the port's program once
    per slice of it in `batches`, and the plain version's near-tie counts
    of the port's inputs: numpy arrays."""
    cache_row = np.full(E + R, -1, np.int32)
    fj = jkge.make_pool_eval_counts(model, c["ent_dim"], c["rel_dim"], C,
                                    shared_pool=shared)
    ft = tkge.make_pool_eval_counts(model, c["ent_dim"], c["rel_dim"], C,
                                    shared_pool=shared)
    tj = tuple(jnp.asarray(x) for x in (c["owner"], c["slot"], cache_row))
    tt = tuple(torch.from_numpy(x) for x in (c["owner"], c["slot"],
                                             cache_row))
    pj = (jnp.asarray(c["ent_main"]),) if shared else \
        (jnp.asarray(c["ent_main"]), jnp.asarray(c["rel_main"]))
    pt = (torch.from_numpy(c["ent_main"]),) if shared else \
        (torch.from_numpy(c["ent_main"]), torch.from_numpy(c["rel_main"]))
    q = [c[k] for k in ("s", "r", "o")]
    gj_o, gj_s, tj_sc = (np.asarray(x) for x in fj(
        *pj, tj, jnp.asarray(c["keys"]), np.int32(E),
        *[jnp.asarray(x) for x in q]))
    outs = [ft(*pt, tt, torch.from_numpy(c["keys"]), E,
               *[torch.from_numpy(x[lo:hi]) for x in q])
            for lo, hi in batches]
    gt_o, gt_s, tt_sc = (torch.cat(x) for x in zip(*outs))
    np.testing.assert_allclose(tt_sc.numpy(), tj_sc, rtol=1e-6, atol=1e-6)
    for g in (gt_o.numpy(), gt_s.numpy()):
        assert g.min() >= 0 and g.max() <= E - 1 and g.any()

    # the near-tie counts of the same inputs, from the plain version
    se = torch.from_numpy(c["ent_main"][c["owner"][c["s"]],
                                        c["slot"][c["s"]], :c["ent_dim"]])
    oe = torch.from_numpy(c["ent_main"][c["owner"][c["o"]],
                                        c["slot"][c["o"]], :c["ent_dim"]])
    re_ = torch.from_numpy(c["rel_main"][c["owner"][c["r"]],
                                         c["slot"][c["r"]], :c["rel_dim"]])
    if model == "complex":
        a, b, cc, dd = tkge._complex_queries(se, re_, oe)
        q_o, q_s, parts = torch.cat([a, b], -1), torch.cat([cc, dd], -1), 2
    else:
        (q_o, q_s), parts = tkge._rescal_queries(se, re_, oe), 1
    _, _, ties_o, ties_s = K.pool_eval_counts_plain(
        pt[0], tt[0], tt[1], torch.from_numpy(c["keys"]), E, q_o, q_s,
        tt_sc, torch.from_numpy(c["o"]), torch.from_numpy(c["s"]),
        parts=parts, ties=True)
    return (gj_o, gj_s), (gt_o.numpy(), gt_s.numpy()), \
        (ties_o.numpy(), ties_s.numpy())


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "twopool"])
@pytest.mark.parametrize("model", ["complex", "rescal"])
def test_pool_eval_counts_match_jax(model, shared):
    c = _pool_case(model, shared)
    jax_c, port_c, ties = _jax_and_torch_counts(c, model, shared, [(0, B)])
    for j, t, n in zip(jax_c, port_c, ties):
        assert (np.abs(t - j) <= n).all()


@pytest.mark.parametrize("model", ["complex", "rescal"])
def test_pool_eval_counts_app_batch_split_match_jax(model):
    """The app's eval of 100 triples: batches of 64 and 36 (the kernel's
    two query-block plans on the card) against the JAX program on all
    100 at once."""
    c = _pool_case(model, True, seed=4, B=100)
    jax_c, port_c, ties = _jax_and_torch_counts(c, model, True,
                                                [(0, 64), (64, 100)])
    for j, t, n in zip(jax_c, port_c, ties):
        assert (np.abs(t - j) <= n).all()


@pytest.mark.parametrize("model", ["complex", "rescal"])
def test_dense_eval_scores_match_jax(model):
    rng = np.random.default_rng(3)
    d = 5
    ent = rng.normal(size=(40, 2 * d if model == "complex" else d))
    rel = rng.normal(size=(4, 2 * d if model == "complex" else d * d))
    ent, rel = ent.astype(np.float32), rel.astype(np.float32)
    s, r, o = rng.integers(0, 40, 7), rng.integers(0, 4, 7), \
        rng.integers(0, 40, 7)
    so_j, ss_j = jkge.make_eval_scores(model)(
        jnp.asarray(ent), jnp.asarray(rel), jnp.asarray(ent[s]),
        jnp.asarray(rel[r]), jnp.asarray(ent[o]))
    te, tr = torch.from_numpy(ent), torch.from_numpy(rel)
    so_t, ss_t = tkge.make_eval_scores(model)(te, tr, te[s], tr[r], te[o])
    np.testing.assert_allclose(so_t.numpy(), np.asarray(so_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ss_t.numpy(), np.asarray(ss_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        tkge.score_numpy(model, ent[s], rel[r], ent[o]),
        jkge.score_numpy(model, ent[s], rel[r], ent[o]))
    np.testing.assert_allclose(
        tkge.make_true_score(model)(te[s], tr[r], te[o]).numpy(),
        np.asarray(jkge.make_true_score(model)(
            jnp.asarray(ent[s]), jnp.asarray(rel[r]), jnp.asarray(ent[o]))),
        rtol=1e-6, atol=1e-6)


def _same_dataset(a, b):
    assert (a.num_entities, a.num_relations) == (b.num_entities,
                                                 b.num_relations)
    for split in ("train", "valid", "test"):
        x, y = getattr(a, split), getattr(b, split)
        assert x.dtype == y.dtype and np.array_equal(x, y), split
    assert a.filters() == b.filters()


def test_generate_synthetic_bitwise():
    _same_dataset(tio.generate_synthetic(60, 4, 300, seed=5),
                  jio.generate_synthetic(60, 4, 300, seed=5))


def test_generate_lowrank_host_path_bitwise():
    dt, ct = tio.generate_lowrank(200, 8, 600, 40, 40, seed=2, device=False)
    dj, cj = jio.generate_lowrank(200, 8, 600, 40, 40, seed=2, device=False)
    _same_dataset(dt, dj)
    assert ct == cj and dt.truth_mrr_o == dj.truth_mrr_o \
        and dt.truth_mrr_s == dj.truth_mrr_s


def test_generate_lowrank_torch_device_path_ceiling():
    """The torch device path (a torch.Generator Gumbel draw) agrees with
    the host path on the truth model's ceiling within the tolerance of
    the JAX package's device-vs-host test: same truth model and rank
    rule, other object draws."""
    ds_h, c_h = tio.generate_lowrank(800, 8, 3000, 50, 50, seed=1,
                                     device=False)
    ds_d, c_d = tio.generate_lowrank(800, 8, 3000, 50, 50, seed=1,
                                     device=True, torch_device="cpu")
    assert ds_d.train.shape == ds_h.train.shape
    np.testing.assert_array_equal(ds_d.train[:, :2], ds_h.train[:, :2])
    assert abs(c_d - c_h) < 0.15 * max(c_h, 1e-6), (c_h, c_d)
    assert ds_d.truth_mrr_o > 0 and ds_d.truth_mrr_s > 0


def test_alias_table_bitwise():
    counts = np.random.default_rng(4).integers(1, 500, 300).astype(float)
    for a, b in zip(t_alias(counts, 0.75), j_alias(counts, 0.75)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
