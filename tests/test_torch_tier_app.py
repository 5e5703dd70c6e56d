"""The port's KGE app against the JAX app on a tiered store (`--sys.tier
1`, one shard, a small E, the hot pool smaller than the table): epoch
losses within rtol 1e-4 and the filtered eval counts equal under the
near-tie rule.

The JAX tiered eval reads its candidate rows through the tiered slot
mirror, which maps a cold key to OOB, and an XLA gather clamps an
out-of-range index: every cold key reads the last row of its owner
shard's hot pool. Most candidates are cold here, and they all score the
same row, so the counts move in large blocks of exact ties; the port's
eval clamps its slot mirror the same way
(apps/knowledge_graph_embeddings.py `_clamped_tier_tables`). The counts
are held per triple: the JAX count lies within the port's count plus or
minus its near-tie count (tests/test_torch_eval.py's rule: f32 sums in
another order can break an exact tie either way).

Background promotion is switched off in both packages for the run
(`PromotionEngine.kick`), so residency moves only with the steps' own
pins and is the same in both packages at every eval, which is checked.
The host-routed path draws the same negatives from the same PullSample
stream in both packages.
"""
import numpy as np

import adapm_tpu.tier.promote as jax_promote
import adapm_tpu_torch.tier.promote as port_promote
from adapm_tpu.apps import knowledge_graph_embeddings as jk
from adapm_tpu_torch.apps import knowledge_graph_embeddings as tk

ARGV = ["--model", "complex", "--dim", "8", "--neg_ratio", "2",
        "--synthetic_entities", "200", "--synthetic_relations", "4",
        "--synthetic_triples", "600", "--epochs", "3", "--batch_size", "16",
        "--lr", "0.2", "--eval_every", "3", "--eval_triples", "60",
        "--num_shards", "1", "--sys.tier", "1", "--sys.tier.hot_rows", "96",
        "--no-device_routes", "--sys.sync.max_per_sec", "0",
        "--sys.prefetch", "0"]


def _instrument(mod, monkeypatch, rec, with_ties):
    """Record, per evaluate() call, the residency map and the filtered
    per-side counts (and for the port, the near-tie counts)."""
    losses = []
    if mod is jk:
        monkeypatch.setattr(mod, "epoch_report",
                            lambda name, ep, loss, watch, extra="":
                            losses.append(loss))
    orig_eval = mod.evaluate
    orig_stats = mod._rank_side_stats

    def stats(greater):
        rec[-1]["counts"].append(np.array(greater, dtype=np.int64))
        return orig_stats(greater)

    def evaluate(run, triples, batch=64):
        ent = run.ekey(np.arange(run.E))
        st = run.srv.stores[run.ent_class]
        o_sh, o_sl = run.srv.ab.owner[ent], run.srv.ab.slot[ent]
        rec.append({"hot": st.res.dev_row[o_sh, o_sl] >= 0, "counts": [],
                    "ties": []})
        if with_ties:
            for lo in range(0, len(triples), batch):
                t = triples[lo:lo + batch]
                out = tk._pool_counts(run, t[:, 0], t[:, 1], t[:, 2],
                                      ties=True)
                rec[-1]["ties"] += [out[3], out[4]]
        return orig_eval(run, triples, batch)

    monkeypatch.setattr(mod, "_rank_side_stats", stats)
    monkeypatch.setattr(mod, "evaluate", evaluate)
    return losses


def test_tiered_kge_app_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_promote.PromotionEngine, "kick",
                        lambda self: None)
    monkeypatch.setattr(port_promote.PromotionEngine, "kick",
                        lambda self: None)
    rec_j, rec_t = [], []
    losses_j = _instrument(jk, monkeypatch, rec_j, False)
    _instrument(tk, monkeypatch, rec_t, True)
    rj = jk.run_app(jk.build_parser().parse_args(ARGV))
    rt = tk.run_app(tk.build_parser().parse_args(ARGV), device="cpu")
    assert len(losses_j) == len(rt["epoch_losses"]) == 3
    np.testing.assert_allclose(rt["epoch_losses"], losses_j, rtol=1e-4)
    # the validation eval and the test eval
    assert len(rec_j) == len(rec_t) == 2
    for ej, et in zip(rec_j, rec_t):
        assert np.array_equal(ej["hot"], et["hot"]), "residency differs"
        # a tiered eval: most candidates are cold at eval time
        assert 0 < et["hot"].sum() < 0.6 * len(et["hot"])
        assert len(ej["counts"]) == len(et["counts"]) == len(et["ties"])
        for gj, gt, tie in zip(ej["counts"], et["counts"], et["ties"]):
            tie = np.asarray(tie, dtype=np.int64)
            assert (np.abs(gj - gt) <= tie).all(), (gj, gt, tie)
            # away from ties the counts are equal
            assert np.array_equal(gj[tie == 0], gt[tie == 0])
    # the JAX app reports no tier section; the port's shows the hot pool
    # bounded by --sys.tier.hot_rows
    assert rt["tier"]["hot_rows_per_shard_max"] <= 96
    assert np.isfinite([rj["mrr"], rt["mrr"]]).all()
