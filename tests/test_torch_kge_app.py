"""The port's KGE application (adapm_tpu_torch/apps/
knowledge_graph_embeddings.py) on the CPU: against the JAX app on the
host-routed path (same numpy streams: datasets, batches, PullSample
negatives), the test_apps.py KGE runs with their floors on the port,
and a JAX checkpoint evaluated by the port.

Tolerances: epoch losses rtol 1e-4 (float32 model math that XLA and
PyTorch round differently in the last bits, compounded over the run's
steps), MRR within 0.02 absolute. Eval of one checkpoint on both
packages: the near-tie rule of tests/test_torch_eval.py; with no
near-tie the statistics are equal."""
import os
import subprocess
import sys

import numpy as np
import pytest

from adapm_tpu.apps import knowledge_graph_embeddings as jk
from adapm_tpu_torch.apps import knowledge_graph_embeddings as tk

FAST = ["--sys.sync.max_per_sec", "0", "--sys.prefetch", "0"]
S8 = ["--num_shards", "8"]  # the JAX suite's 8-device mesh


def _port(argv):
    return tk.run_app(tk.build_parser().parse_args(argv + FAST),
                      device="cpu")


def _jax(argv, monkeypatch):
    """The JAX app's result plus its per-epoch losses."""
    losses = []
    monkeypatch.setattr(jk, "epoch_report",
                        lambda name, ep, loss, watch, extra="":
                        losses.append(loss))
    res = jk.run_app(jk.build_parser().parse_args(argv + FAST))
    res["epoch_losses"] = losses
    return res


@pytest.mark.parametrize("neg", ["uniform", "freq"])
@pytest.mark.parametrize("model", ["complex", "rescal"])
def test_host_routed_app_matches_jax(model, neg, monkeypatch):
    """test_kge_app's configuration (--no-device_routes) on both
    packages: the negatives come from the same PullSample stream."""
    argv = ["--model", model, "--dim", "8", "--neg_ratio", "2",
            "--synthetic_entities", "60", "--synthetic_relations", "4",
            "--synthetic_triples", "400", "--epochs", "6",
            "--batch_size", "32", "--lr", "0.2", "--eval_every", "6",
            "--eval_triples", "60", "--neg_sampling", neg,
            "--no-device_routes"] + S8
    rj, rt = _jax(argv, monkeypatch), _port(argv)
    assert len(rt["epoch_losses"]) == len(rj["epoch_losses"]) == 6
    np.testing.assert_allclose(rt["epoch_losses"], rj["epoch_losses"],
                               rtol=1e-4)
    assert abs(rt["mrr"] - rj["mrr"]) <= 0.02, (rt["mrr"], rj["mrr"])
    assert rt["mrr"] > 0.15, rt  # test_kge_app's floor


def test_device_routes_default():
    args = tk.build_parser().parse_args(
        ["--dim", "8", "--neg_ratio", "2", "--synthetic_entities", "60",
         "--synthetic_relations", "4", "--synthetic_triples", "400",
         "--epochs", "4", "--batch_size", "32", "--lr", "0.2",
         "--eval_every", "4", "--eval_triples", "60"] + S8 + FAST)
    assert args.device_routes, "device routing must be the KGE default"
    assert tk.run_app(args, device="cpu")["mrr"] > 0.12


def test_pool_eval_matches_dense():
    """The pool-count eval (K4's path) gives the dense path's filtered
    statistics, with a chunk that does not divide E."""
    from adapm_tpu_torch.io import kge as kgeio
    args = tk.build_parser().parse_args(
        ["--dim", "8", "--synthetic_entities", "60",
         "--synthetic_relations", "4", "--synthetic_triples", "300",
         "--eval_chunk", "16"] + S8 + FAST)
    ds = kgeio.generate_synthetic(60, 4, 300, seed=1)
    run = tk.KgeRun(args, ds, device="cpu")
    run.init_model()
    pool = tk.evaluate(run, ds.test[:60])
    args.eval_chunk = 0
    dense = tk.evaluate(run, ds.test[:60])
    assert np.allclose(pool, dense), (pool[:4], dense[:4])
    run.srv.shutdown()


@pytest.mark.parametrize("routes", ["device", "host"])
def test_freq_negatives_and_self_adversarial(routes):
    argv = ["--dim", "8", "--neg_ratio", "4", "--synthetic_entities", "60",
            "--synthetic_relations", "4", "--synthetic_triples", "400",
            "--epochs", "4", "--batch_size", "32", "--lr", "0.2",
            "--eval_every", "4", "--eval_triples", "60",
            "--neg_sampling", "freq", "--self_adv_temp", "1.0"] + S8
    if routes == "host":
        argv.append("--no-device_routes")
    assert _port(argv)["mrr"] > 0.12


def test_checkpoint_resume(tmp_path):
    base = ["--dim", "4", "--neg_ratio", "2", "--synthetic_entities", "30",
            "--synthetic_relations", "2", "--synthetic_triples", "100",
            "--epochs", "1", "--batch_size", "32", "--eval_every", "0"]
    _port(base + ["--checkpoint_every", "1", "--checkpoint_dir",
                  str(tmp_path)])
    ck = tmp_path / "kge_epoch0.npz"
    assert ck.exists()
    assert np.isfinite(_port(base + ["--init_from", str(ck)])["loss"])
    assert tk.main(base + ["--init_from", str(ck)] + FAST,
                   device="cpu") == 0


def test_lowrank_reaches_truth_ceiling_fraction():
    res = _port(["--dim", "32", "--neg_ratio", "4",
                 "--synthetic_entities", "200", "--synthetic_relations",
                 "8", "--synthetic_triples", "3000", "--synthetic_mode",
                 "lowrank", "--epochs", "40", "--batch_size", "128",
                 "--lr", "0.3", "--eval_every", "40", "--eval_triples",
                 "100", "--seed", "0"] + S8)
    ceiling = res["truth_mrr"]
    assert ceiling > 0.5, ceiling
    assert res["test_mrr"] > 0.45 * ceiling, (res["test_mrr"], ceiling)


def test_jax_checkpoint_evaluates_alike(tmp_path, monkeypatch):
    """Weights carried across: a checkpoint written by the JAX app,
    loaded by the port through --init_from; the first evaluation's rank
    counts agree with the JAX app's under the near-tie rule, and the
    statistics are equal where no near-tie exists."""
    base = ["--model", "complex", "--dim", "8", "--neg_ratio", "2",
            "--synthetic_entities", "60", "--synthetic_relations", "4",
            "--synthetic_triples", "400", "--batch_size", "32",
            "--lr", "0.2", "--eval_triples", "60", "--eval_chunk", "16"] \
        + S8
    _jax(base + ["--epochs", "2", "--eval_every", "0",
                 "--checkpoint_every", "2", "--checkpoint_dir",
                 str(tmp_path)], monkeypatch)
    ck = str(tmp_path / "kge_epoch1.npz")
    resume = base + ["--epochs", "0", "--eval_every", "1",
                     "--init_from", ck]
    rj, rt = _jax(resume, monkeypatch), _port(resume)

    # per-query counts of the same triples on both
    from adapm_tpu.io import kge as jio
    from adapm_tpu.models.kge import make_pool_eval_counts
    from adapm_tpu.ops import DeviceRouter
    from adapm_tpu_torch.io import kge as tio
    args_j = jk.build_parser().parse_args(resume + FAST)
    args_t = tk.build_parser().parse_args(resume + FAST)
    run_j = jk.KgeRun(args_j, jio.generate_synthetic(60, 4, 400, seed=42))
    run_j.init_model()
    ds = tio.generate_synthetic(60, 4, 400, seed=42)
    run_t = tk.KgeRun(args_t, ds, device="cpu")
    run_t.init_model()
    t = ds.test[:60]
    s, r, o = t[:, 0], t[:, 1], t[:, 2]
    g_o, g_s, _, ties_o, ties_s = tk._pool_counts(run_t, s, r, o,
                                                  ties=True)
    g_o2, g_s2, _ = tk._pool_counts(run_t, s, r, o)
    assert np.array_equal(g_o, g_o2) and np.array_equal(g_s, g_s2)
    srv = run_j.srv
    fn = make_pool_eval_counts("complex", run_j.ent_dim, run_j.rel_dim,
                               16, shared_pool=True)
    put = srv.ctx.put_replicated
    ekeys = run_j.ekey(np.arange(60))
    pad = np.full(64, ekeys[0], np.int64)
    pad[:60] = ekeys
    jo, js, _ = (np.asarray(x) for x in fn(
        srv.stores[run_j.ent_class].main, DeviceRouter(srv, 0).tables(),
        put(pad.reshape(4, 16)), np.int32(60), put(run_j.ekey(s)),
        put(run_j.rkey(r)), put(run_j.ekey(o))))
    assert (np.abs(g_o - jo) <= ties_o).all()
    assert (np.abs(g_s - js) <= ties_s).all()
    if int(ties_o.sum()) + int(ties_s.sum()) == 0:
        assert rt["test_mrr"] == rj["test_mrr"], (rt, rj)
    else:
        assert abs(rt["test_mrr"] - rj["test_mrr"]) <= 0.02
    run_j.srv.shutdown()
    run_t.srv.shutdown()


def test_unported_options_raise():
    """What the port has not taken over raises: the multi-process pool
    eval (ROADMAP queue A, item 11). (--scan_steps is ported:
    tests/test_torch_complex_step.py.)"""
    from adapm_tpu_torch.io import kge as kgeio
    args = tk.build_parser().parse_args(
        ["--dim", "4", "--synthetic_entities", "30",
         "--synthetic_relations", "2", "--synthetic_triples", "64"] + FAST)
    ds = kgeio.generate_synthetic(30, 2, 64, seed=1)
    run = tk.KgeRun(args, ds, device="cpu")
    run.init_model()
    run.srv.glob = object()            # what a multi-process run holds
    with pytest.raises(NotImplementedError, match="queue A, item 11"):
        tk.evaluate(run, ds.test[:8])
    run.srv.glob = None
    run.srv.shutdown()


def test_app_imports_neither_jax_nor_the_jax_package():
    """The app's whole path on the CPU in a fresh interpreter: no module
    of JAX or of the JAX package gets imported."""
    code = (
        "import sys\n"
        "from adapm_tpu_torch.apps import knowledge_graph_embeddings as k\n"
        "argv = ['--dim', '4', '--neg_ratio', '2', '--synthetic_entities',\n"
        "        '30', '--synthetic_relations', '2', '--synthetic_triples',\n"
        "        '64', '--epochs', '1', '--batch_size', '16',\n"
        "        '--eval_every', '1', '--eval_triples', '8',\n"
        "        '--neg_sampling', 'freq', '--sys.sync.max_per_sec', '0']\n"
        "assert k.main(argv, device='cpu') == 0\n"
        "assert k.main(argv + ['--no-device_routes', '--eval_chunk', '0'],\n"
        "              device='cpu') == 0\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'adapm_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip().endswith("ok"), \
        p.stderr[-2000:]
