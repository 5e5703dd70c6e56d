"""K4's multi-process form (models/kge.py make_pool_eval_counts_mp: K4,
ops/kernels.py pool_eval_counts, over a rank's owned candidates, its
plain twin on the CPU) against the JAX package's
make_pool_eval_counts_mp, on the same numpy inputs.

E = 300 entities split over 2 and 3 simulated ranks by a seeded owner
draw: each rank's candidate tiles hold only the entities it owns
(padded at the tail, `nvalid` masking the padding), the query triples
arrive as rows, and the true score is an input. Checks:

  - each rank's counts equal the JAX program's on the same rows and
    owned tiles, under the near-tie rule of tests/test_torch_eval.py (a
    count may differ by at most the plain version's near-tie count, and
    must be equal where there is none);
  - the per-rank counts summed equal the one-process K4 twin's counts
    over all entities: exactly on integer-valued rows (every f32 sum is
    then exact in any order), under the near-tie rule on random rows;
  - a rank that owns no entity returns zeros.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adapm_tpu.models import kge as jkge
from adapm_tpu_torch.models import kge as tkge

E, R, S, SLOTS, C = 300, 5, 2, 200, 64   # C does not divide a rank's share


def _case(model, P, seed=0, integer=False, B=24, d=4):
    """A pool holding every entity/relation row (one table: every rank
    reads its owned candidates from it), the owner rank of each entity,
    and a batch of query triples with their rows."""
    rng = np.random.default_rng(seed)
    ent_dim = 2 * d if model == "complex" else d
    rel_dim = 2 * d if model == "complex" else d * d
    L = 2 * max(ent_dim, rel_dim)
    nk = E + R
    flat = rng.permutation(S * SLOTS)[:nk]
    owner = (flat // SLOTS).astype(np.int32)
    slot = (flat % SLOTS).astype(np.int32)
    if integer:
        main = rng.integers(-3, 4, size=(S, SLOTS, L)).astype(np.float32)
    else:
        main = rng.normal(size=(S, SLOTS, L)).astype(np.float32)
    rank_of = rng.integers(0, P, E)
    s = rng.integers(0, E, B)
    o = rng.integers(0, E, B)
    o[:3] = s[:3]
    r = E + rng.integers(0, R, B)

    def rows(keys, dim):
        return main[owner[keys], slot[keys], :dim].copy()

    return dict(model=model, ent_dim=ent_dim, rel_dim=rel_dim, owner=owner,
                slot=slot, main=main, rank_of=rank_of, s=s, r=r, o=o,
                se=rows(s, ent_dim), re=rows(r, rel_dim),
                oe=rows(o, ent_dim))


def _tiles(keys):
    """Owned keys as padded [nch, C] int32 tiles (one row of padding for
    a rank that owns nothing) and their count."""
    n = len(keys)
    nch = max(1, -(-n // C))
    pad = np.full(nch * C, keys[0] if n else 0, np.int32)
    pad[:n] = keys
    return pad.reshape(nch, C), n


def _true_score(c):
    return tkge.make_true_score(c["model"])(
        torch.from_numpy(c["se"]), torch.from_numpy(c["re"]),
        torch.from_numpy(c["oe"]))


def _port_counts(c, tiles, n, ties=False):
    fn = tkge.make_pool_eval_counts_mp(c["model"], c["ent_dim"],
                                       c["rel_dim"], C)
    tables = (torch.from_numpy(c["owner"]), torch.from_numpy(c["slot"]),
              None)
    out = fn(torch.from_numpy(c["main"]), tables, torch.from_numpy(tiles),
             n, torch.from_numpy(c["se"]), torch.from_numpy(c["re"]),
             torch.from_numpy(c["oe"]), torch.from_numpy(c["s"]),
             torch.from_numpy(c["o"]), _true_score(c), ties=ties)
    return tuple(x.numpy().astype(np.int64) for x in out)


def _jax_counts(c, tiles, n, true_sc):
    fn = jkge.make_pool_eval_counts_mp(c["model"], c["ent_dim"],
                                       c["rel_dim"], C)
    tables = (jnp.asarray(c["owner"]), jnp.asarray(c["slot"]),
              jnp.full(E + R, -1, jnp.int32))
    g_o, g_s = fn(jnp.asarray(c["main"]), tables, jnp.asarray(tiles),
                  np.int32(n), jnp.asarray(c["se"]), jnp.asarray(c["re"]),
                  jnp.asarray(c["oe"]), jnp.asarray(c["s"]),
                  jnp.asarray(c["o"]), jnp.asarray(true_sc))
    return np.asarray(g_o).astype(np.int64), np.asarray(g_s).astype(np.int64)


def _one_process(c):
    """The one-process K4 twin over all entities, with the queries of the
    same rows, and its near-tie counts."""
    tiles, n = _tiles(np.arange(E, dtype=np.int32))
    out, _ = tkge._k4_counts(
        c["model"], torch.from_numpy(c["main"]),
        torch.from_numpy(c["owner"]), torch.from_numpy(c["slot"]),
        torch.from_numpy(tiles), n, torch.from_numpy(c["se"]),
        torch.from_numpy(c["re"]), torch.from_numpy(c["oe"]),
        _true_score(c), torch.from_numpy(c["s"]), torch.from_numpy(c["o"]),
        ties=True)
    return tuple(x.numpy().astype(np.int64) for x in out)


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("model", ["complex", "rescal"])
def test_rank_counts_match_jax_and_sum_to_one_process(model, P):
    c = _case(model, P, seed=P)
    true_sc = _true_score(c).numpy()
    tot_o = np.zeros(len(c["s"]), np.int64)
    tot_s = np.zeros_like(tot_o)
    for rank in range(P):
        owned = np.nonzero(c["rank_of"] == rank)[0].astype(np.int32)
        tiles, n = _tiles(owned)
        g_o, g_s, t_o, t_s = _port_counts(c, tiles, n, ties=True)
        pg_o, pg_s = _port_counts(c, tiles, n)
        np.testing.assert_array_equal(pg_o, g_o)  # wrapper == twin here
        np.testing.assert_array_equal(pg_s, g_s)
        j_o, j_s = _jax_counts(c, tiles, n, true_sc)
        assert (np.abs(g_o - j_o) <= t_o).all()
        assert (np.abs(g_s - j_s) <= t_s).all()
        assert g_o.max() <= n and g_s.max() <= n
        tot_o += g_o
        tot_s += g_s
    a_o, a_s, n_o, n_s = _one_process(c)
    assert (np.abs(tot_o - a_o) <= n_o).all()
    assert (np.abs(tot_s - a_s) <= n_s).all()
    assert a_o.any() and a_s.any()


@pytest.mark.parametrize("model", ["complex", "rescal"])
def test_rank_counts_sum_exactly_on_integer_rows(model):
    c = _case(model, 3, seed=11, integer=True)
    true_sc = _true_score(c).numpy()
    tot = [np.zeros(len(c["s"]), np.int64) for _ in range(2)]
    for rank in range(3):
        owned = np.nonzero(c["rank_of"] == rank)[0].astype(np.int32)
        tiles, n = _tiles(owned)
        got = _port_counts(c, tiles, n)
        for t, g, j in zip(tot, got, _jax_counts(c, tiles, n, true_sc)):
            np.testing.assert_array_equal(g, j)
            t += g
    a_o, a_s, _, _ = _one_process(c)
    np.testing.assert_array_equal(tot[0], a_o)
    np.testing.assert_array_equal(tot[1], a_s)


def test_rank_owning_nothing_returns_zeros():
    c = _case("complex", 2, seed=3)
    tiles, n = _tiles(np.zeros(0, np.int32))
    g_o, g_s = _port_counts(c, tiles, n)
    assert n == 0 and not g_o.any() and not g_s.any()
    assert g_o.shape == (len(c["s"]),)
    j_o, j_s = _jax_counts(c, tiles, n, _true_score(c).numpy())
    assert not j_o.any() and not j_s.any()


@pytest.mark.parametrize("model", ["complex", "rescal"])
def test_one_rank_owning_all_matches_one_process_entry(model):
    """A rank that owns every entity counts what the one-process entry
    (make_pool_eval_counts, which reads the query rows from the pool by
    key) counts, near-tie counts included: the two entries form the same
    queries and run the same K4."""
    c = _case(model, 1, seed=7)
    tiles, n = _tiles(np.arange(E, dtype=np.int32))
    g_o, g_s, t_o, t_s = _port_counts(c, tiles, n, ties=True)
    one = tkge.make_pool_eval_counts(model, c["ent_dim"], c["rel_dim"], C,
                                     shared_pool=True)
    tables = (torch.from_numpy(c["owner"]), torch.from_numpy(c["slot"]),
              None)
    a_o, a_s, _, n_o, n_s = one(
        torch.from_numpy(c["main"]), tables, torch.from_numpy(tiles), n,
        torch.from_numpy(c["s"]), torch.from_numpy(c["r"]),
        torch.from_numpy(c["o"]), ties=True)
    for got, want in ((g_o, a_o), (g_s, a_s), (t_o, n_o), (t_s, n_s)):
        np.testing.assert_array_equal(got, want.numpy())
    assert g_o.any() and g_s.any()
