"""RotatE in the port (models/kge.py, the KGE app) against the plain
reference of the benchmark (benchmark/reference/rotate.py: complex128,
the published formula), on seeded random rows, on the CPU.

- The loss (RotatE eq. 5 on f = gamma - distance, with and without
  self-adversarial weights) and its gradients: rtol 1e-5 / atol 1e-7
  against float64 autograd, as the ComplEx and RESCAL losses are held to
  the JAX package's (f32 sums of a few terms; the moduli's square roots
  and the phases' cosines add a few ulps).
- The eval programs (K17's plain version, one process and the
  multi-process form): each count within the plain version's near-tie
  count of the float64 reference's (an f32 distance lies within g*dist of
  the exact one, ops/kernels.py pool_eval_dist_plain), true scores (the
  rank score -distance) rtol 1e-6.
- A trained `--model rotate` app: its filtered MRR equals a dense float64
  ranking of its own checkpoint by the reference's distances to 1e-12
  (no near-tie at these sizes), and the dense eval path equals the pool
  path's."""
import numpy as np
import pytest
import torch

from adapm_tpu_torch.apps import knowledge_graph_embeddings as tk
from adapm_tpu_torch.models import kge
from adapm_tpu_torch.ops import kernels as K
from benchmark.reference import rotate as ref

FAST = ["--sys.sync.max_per_sec", "0", "--sys.prefetch", "0"]
B, N, D = 6, 5, 4
ROLES = ("s", "r", "o", "neg")


def _embs(seed):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(B, 2 * D))
    r[:, :D] *= np.pi     # phases; the second half is never read
    return {"s": rng.normal(size=(B, 2 * D)), "o": rng.normal(size=(B, 2 * D)),
            "r": r, "neg": rng.normal(size=(B, N, 2 * D))}


def _ref_loss(e, gamma, temp):
    """RotatE eq. 5 in float64: -log sig(gamma - d) - sum_i p_i log
    sig(d_i - gamma) over both corrupted sides, p the self-adversarial
    softmax of the negatives' scores (detached), or 1 each without it."""
    f = torch.nn.functional.logsigmoid
    s, r, o, neg = e["s"], e["r"], e["o"], e["neg"]
    pos = ref.score(s, r, o, gamma)
    loss = -f(pos)
    for sc in (ref.score(neg, r[:, None], o[:, None], gamma),
               ref.score(s[:, None], r[:, None], neg, gamma)):
        w = torch.softmax(temp * sc.detach(), -1) if temp > 0 else 1.0
        loss = loss - (w * f(-sc)).sum(-1)
    return loss.mean()


@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("gamma", [12.0, 2.0])
def test_loss_and_grads_match_reference(gamma, temp):
    embs = _embs(7)
    f64 = {k: torch.from_numpy(v).requires_grad_() for k, v in embs.items()}
    want = _ref_loss(f64, gamma, temp)
    g_want = torch.autograd.grad(want, [f64[k] for k in ROLES])
    f32 = {k: torch.from_numpy(v.astype(np.float32)).requires_grad_()
           for k, v in embs.items()}
    loss_fn = kge.make_kge_loss("rotate", self_adv_temp=temp, margin=gamma)
    assert loss_fn.fused_update is None      # autograd + K2 in the step
    got = loss_fn(f32, None)
    g_got = torch.autograd.grad(got, [f32[k] for k in ROLES])
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
    for k, a, b in zip(ROLES, g_got, g_want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert not g_got[1][:, D:].any()       # the relation row's held half


def test_score_numpy_is_the_rank_score():
    e = _embs(3)
    got = kge.score_numpy("rotate", e["s"], e["r"], e["o"])
    want = ref.score(*(torch.from_numpy(e[k]) for k in "sro"), gamma=0.0)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12)


S, SLOTS, E, R, C, Q = 2, 96, 150, 6, 64, 10   # C does not divide E


def _pool_case(shared, d=6, seed=0):
    """A random pool (entity rows at 0.3, relation phases at pi) placed by
    a random owner/slot table; the count program's inputs."""
    rng = np.random.default_rng(seed)
    L = 4 * d + 2
    flat = rng.permutation(S * SLOTS)[:E + R]
    owner = (flat // SLOTS).astype(np.int32)
    slot = (flat % SLOTS).astype(np.int32)
    ent_main = (0.3 * rng.normal(size=(S, SLOTS, L))).astype(np.float32)
    rel_main = ent_main if shared else \
        (0.3 * rng.normal(size=(S, SLOTS, L))).astype(np.float32)
    rel_main[owner[E:], slot[E:], :d] = np.pi * rng.normal(size=(R, d))
    ekeys = rng.permutation(E).astype(np.int32)
    nch = -(-E // C)
    pad = np.full(nch * C, ekeys[0], np.int32)
    pad[:E] = ekeys
    s = rng.integers(0, E, Q).astype(np.int32)
    o = rng.integers(0, E, Q).astype(np.int32)
    o[:3] = s[:3]  # true key excluded by key on both sides
    r = (E + rng.integers(0, R, Q)).astype(np.int32)
    return dict(d=d, owner=owner, slot=slot, ent_main=ent_main,
                rel_main=rel_main, keys=pad.reshape(nch, C), s=s, r=r, o=o)


def _rows(c, pool, keys):
    return torch.from_numpy(pool[c["owner"][keys], c["slot"][keys],
                                 :2 * c["d"]])


def _reference_counts(c):
    """The float64 reference's counts and true distances: every entity e
    != o with distance(s, r, e) < distance(s, r, o), and e != s with
    distance(e, r, o) < distance(s, r, o)."""
    se, oe = (ref.complex_rows(_rows(c, c["ent_main"], c[k])) for k in "so")
    rot = ref.rotation(_rows(c, c["rel_main"], c["r"]))
    ent = ref.complex_rows(_rows(c, c["ent_main"], np.arange(E)))[None]
    true = ref.distance(se, rot, oe)
    d_o = ref.distance(se[:, None], rot[:, None], ent)
    d_s = ref.distance(ent, rot[:, None], oe[:, None])
    keys = torch.arange(E)
    g_o = ((d_o < true[:, None]) & (keys != torch.from_numpy(c["o"])[:, None]))
    g_s = ((d_s < true[:, None]) & (keys != torch.from_numpy(c["s"])[:, None]))
    return g_o.sum(1).numpy(), g_s.sum(1).numpy(), true.numpy()


def _near_ties(c, true_sc):
    """The plain version's near-tie counts for the program's queries."""
    se, re_, oe = (_rows(c, m, c[k]) for m, k in
                   ((c["ent_main"], "s"), (c["rel_main"], "r"),
                    (c["ent_main"], "o")))
    q_o, q_s = kge._rotate_queries(se, re_, oe)
    _, _, t_o, t_s = K.pool_eval_dist_plain(
        torch.from_numpy(c["ent_main"]), torch.from_numpy(c["owner"]),
        torch.from_numpy(c["slot"]), torch.from_numpy(c["keys"]), E,
        q_o, q_s, -true_sc, torch.from_numpy(c["o"]),
        torch.from_numpy(c["s"]), ties=True)
    return t_o.numpy(), t_s.numpy()


def _check(c, g_o, g_s, true_sc):
    r_o, r_s, r_true = _reference_counts(c)
    np.testing.assert_allclose(-true_sc.numpy(), r_true, rtol=1e-6)
    t_o, t_s = _near_ties(c, true_sc)
    assert (np.abs(g_o.numpy() - r_o) <= t_o).all()
    assert (np.abs(g_s.numpy() - r_s) <= t_s).all()
    assert r_o.any() and r_s.any()


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "twopool"])
def test_pool_eval_counts_match_reference(shared):
    c = _pool_case(shared)
    d = c["d"]
    fn = kge.make_pool_eval_counts("rotate", 2 * d, 2 * d, C,
                                   shared_pool=shared)
    tables = (torch.from_numpy(c["owner"]), torch.from_numpy(c["slot"]),
              torch.full((E + R,), -1, dtype=torch.int32))
    pools = (torch.from_numpy(c["ent_main"]),) if shared else \
        (torch.from_numpy(c["ent_main"]), torch.from_numpy(c["rel_main"]))
    g_o, g_s, true_sc = fn(*pools, tables, torch.from_numpy(c["keys"]), E,
                           *(torch.from_numpy(c[k]) for k in "sro"))
    _check(c, g_o, g_s, true_sc)


def test_pool_eval_counts_mp_match_reference():
    """The multi-process form over two ranks' owned tiles: the counts of
    the two partitions sum to the reference's, within the near-tie rule,
    the true score an input of the same bytes on both."""
    c = _pool_case(True, seed=4)
    d = c["d"]
    fn = kge.make_pool_eval_counts_mp("rotate", 2 * d, 2 * d, C)
    se, re_, oe = (_rows(c, c["ent_main"], c[k]) for k in "sro")
    true_sc = kge.make_true_score("rotate")(se, re_, oe)
    tables = (torch.from_numpy(c["owner"]), torch.from_numpy(c["slot"]),
              None)
    g = [torch.zeros(Q, dtype=torch.int32) for _ in range(2)]
    for part in np.array_split(np.random.default_rng(1).permutation(E), 2):
        nch = -(-len(part) // C)
        pad = np.full(nch * C, part[0], np.int32)
        pad[:len(part)] = part
        out = fn(torch.from_numpy(c["ent_main"]), tables,
                 torch.from_numpy(pad.reshape(nch, C)), len(part), se, re_,
                 oe, torch.from_numpy(c["s"]), torch.from_numpy(c["o"]),
                 true_sc)
        g = [a + b for a, b in zip(g, out)]
    _check(c, g[0], g[1], true_sc)


def _dense_filtered_mrr(ent, rel, triples, ds):
    """Filtered MRR of both sides by the reference's float64 distances
    against every entity, the known true entities filtered out."""
    sr_o, ro_s = ds.filters()
    ents = ref.complex_rows(torch.from_numpy(ent))
    rots = ref.rotation(torch.from_numpy(rel))
    inv = []
    for s, r, o in triples:
        true = ref.distance(ents[s], rots[r], ents[o])
        for d, skip, own in ((ref.distance(ents[s], rots[r], ents),
                              sr_o.get((s, r), ()), o),
                             (ref.distance(ents, rots[r], ents[o]),
                              ro_s.get((r, o), ()), s)):
            keep = np.ones(len(ent), bool)
            keep[list(skip)] = False
            keep[own] = False
            inv.append(1.0 / (1 + int((d.numpy()[keep] < true.item()).sum())))
    return float(np.mean(inv))


@pytest.mark.parametrize("routes", ["device", "host"])
def test_rotate_app_trains_and_its_mrr_is_the_dense_ranking(tmp_path,
                                                            routes):
    argv = ["--model", "rotate", "--dim", "8", "--neg_ratio", "4",
            "--synthetic_entities", "60", "--synthetic_relations", "4",
            "--synthetic_triples", "400", "--epochs", "6", "--batch_size",
            "32", "--lr", "0.2", "--eval_every", "6", "--eval_triples",
            "60", "--self_adv_temp", "1.0", "--margin", "6",
            "--eval_chunk", "16", "--checkpoint_every", "6",
            "--checkpoint_dir", str(tmp_path), "--num_shards", "8"] + FAST
    if routes == "host":
        argv.append("--no-device_routes")
    res = tk.run_app(tk.build_parser().parse_args(argv), device="cpu")
    losses = res["epoch_losses"]
    assert losses[-1] < 0.5 * losses[0], losses
    assert res["mrr"] > 0.25, res["mrr"]
    from adapm_tpu_torch.io import kge as kgeio
    ds = kgeio.generate_synthetic(60, 4, 400, seed=42)   # the app's --seed
    ck = np.load(tmp_path / "kge_epoch5.npz")
    assert not ck["rel"][:, 8:].any()     # the relation row's held half
    want = _dense_filtered_mrr(ck["ent"], ck["rel"], ds.valid[:60], ds)
    assert abs(res["mrr"] - want) <= 1e-12, (res["mrr"], want)


def test_dense_eval_equals_pool_eval():
    """--eval_chunk 0 (dense scores) gives the pool path's (K17's plain
    version) filtered statistics on a fresh RotatE table."""
    from adapm_tpu_torch.io import kge as kgeio
    args = tk.build_parser().parse_args(
        ["--model", "rotate", "--dim", "8", "--synthetic_entities", "60",
         "--synthetic_relations", "4", "--synthetic_triples", "300",
         "--eval_chunk", "16", "--num_shards", "8"] + FAST)
    ds = kgeio.generate_synthetic(60, 4, 300, seed=1)
    run = tk.KgeRun(args, ds, device="cpu")
    try:
        run.init_model()
        rel = run.current_model()[2]
        assert np.abs(rel[:, :8]).max() <= np.pi and not rel[:, 8:].any()
        pool = tk.evaluate(run, ds.test[:60])
        args.eval_chunk = 0
        dense = tk.evaluate(run, ds.test[:60])
    finally:
        run.srv.shutdown()
    assert np.allclose(pool, dense), (pool[:4], dense[:4])
