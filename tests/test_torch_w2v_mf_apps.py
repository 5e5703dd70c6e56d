"""The port's word2vec, matrix-factorization and simple apps
(adapm_tpu_torch/apps/) on the CPU, against the JAX package's apps on the
same flags and seeds, with the JAX suite's 8-shard layout.

- Host-routed word2vec: its negatives come from the PullSample stream,
  which both packages draw with numpy in the same order, so the epoch
  losses agree within rtol 1e-4 (float32 model math that XLA and PyTorch
  round differently in the last bits, compounded over the run's steps).
- Device-routed word2vec draws its negatives from a torch.Generator
  (jax's threefry and torch's Philox differ): it is held as the JAX
  suite holds it (tests/test_device_routed.py): it learns, and lands
  within 0.35 (relative) of the host-routed loss.
- Matrix factorization draws nothing in the step, so its two routing
  paths compute the same updates: the port's runs on both paths, in all
  three access orders, agree within rtol 1e-4 with the JAX app's
  host-routed run. That run is the reference because it is
  deterministic; the JAX app's device-routed run is not in the plain
  order on 8 shards (first-epoch losses 79.358, 80.472, 79.486 in three
  runs of one configuration; its host-routed run and both of the port's
  paths give 79.486 every time), a planner-timing effect of the JAX
  package, which stays as it is.
- --scan_steps against per-step runs on both apps; export and import;
  simple.main; the whole app paths import neither JAX nor the JAX
  package."""
import os
import subprocess
import sys

import numpy as np
import pytest

from adapm_tpu.apps import matrix_factorization as jmf
from adapm_tpu.apps import word2vec as jw2v
from adapm_tpu_torch.apps import matrix_factorization as tmf
from adapm_tpu_torch.apps import simple as tsimple
from adapm_tpu_torch.apps import word2vec as tw2v

# inline planner rounds, no sync throttling: the JAX suite's FAST flags
FAST = ["--sys.sync.max_per_sec", "0", "--sys.prefetch", "0"]
S8 = ["--num_shards", "8"]  # the JAX suite's 8-device mesh


def _jax(app, argv, monkeypatch):
    """The JAX app's per-epoch losses (its epoch_report lines)."""
    losses = []
    monkeypatch.setattr(app, "epoch_report",
                        lambda name, ep, loss, watch, extra="":
                        losses.append(loss))
    app.run(app.build_parser().parse_args(argv + FAST))
    monkeypatch.undo()
    return losses


def _port(app, argv):
    return app.run_app(app.build_parser().parse_args(argv + FAST),
                       device="cpu")


def _w2v_argv(tmp_path, *extra):
    return ["--synthetic_vocab", "80", "--synthetic_sentences", "120",
            "--synthetic_path", str(tmp_path / "c.txt"),
            "--dim", "8", "--window", "3", "--negative", "4",
            "--epochs", "3", "--batch_size", "256", "--lr", "0.03",
            "--readahead", "30", "--seed", "11"] + list(extra)


def test_host_routed_w2v_matches_jax(tmp_path, monkeypatch):
    argv = _w2v_argv(tmp_path, "--no-device_routes") + S8
    lj = _jax(jw2v, argv, monkeypatch)
    rt = _port(tw2v, argv)
    assert len(lj) == len(rt["epoch_losses"]) == 3
    np.testing.assert_allclose(rt["epoch_losses"], lj, rtol=1e-4)


def test_device_routed_w2v_learns(tmp_path):
    """tests/test_device_routed.py's w2v check on the port: the device
    path (K6 on alias-drawn, Local-snapped negatives) learns and lands
    near the host-routed loss."""
    base = _w2v_argv(tmp_path) + S8
    host = _port(tw2v, base + ["--no-device_routes"])["loss"]
    dev = _port(tw2v, base + ["--device_routes"])["loss"]
    untrained = np.log(2.0) * 5
    assert dev < 0.9 * untrained, f"device path did not learn: {dev}"
    assert abs(dev - host) < 0.35 * max(host, 1e-6), (dev, host)


def _mf_argv(algorithm, routes):
    argv = ["--rows", "48", "--cols", "32", "--nnz", "600", "--rank", "4",
            "--epochs", "6", "--batch_size", "16", "--lr", "0.1",
            "--algorithm", algorithm] + S8
    return argv + (["--no-device_routes"] if routes == "host" else [])


@pytest.mark.parametrize("routes", ["device", "host"])
@pytest.mark.parametrize("algorithm", ["dsgd", "columnwise", "plain"])
def test_mf_matches_jax(algorithm, routes, monkeypatch):
    """test_mf_app's configuration: the port on `routes` against the JAX
    app's host-routed run (see the module docstring); the bold driver's
    lr follows the same losses, and the floor of test_mf_app holds."""
    lj = _jax(jmf, _mf_argv(algorithm, "host"), monkeypatch)
    rt = _port(tmf, _mf_argv(algorithm, routes))
    assert len(lj) == len(rt["epoch_losses"]) == 6
    np.testing.assert_allclose(rt["epoch_losses"], lj, rtol=1e-4)
    from adapm_tpu_torch.io import mf as mfio
    _, _, vals, _, _ = mfio.generate_synthetic(48, 32, 4, 600, seed=42)
    assert rt["loss"] < 0.5 * float((vals ** 2).sum()), rt["loss"]


@pytest.mark.parametrize("algorithm", ["dsgd", "plain"])
def test_mf_scan_steps_matches_per_step(algorithm):
    """K batches per run_scan window (ratings as per-step aux) train
    exactly like per-step dispatches at fixed placement (one shard);
    partial windows at block ends run per step."""
    def run_with(scan):
        return _port(tmf, ["--rows", "48", "--cols", "32", "--nnz", "600",
                           "--rank", "4", "--epochs", "3", "--batch_size",
                           "16", "--lr", "0.1", "--algorithm", algorithm,
                           "--num_shards", "1", "--scan_steps", str(scan)])
    r1, r4 = run_with(1), run_with(4)
    assert r1["epoch_losses"] == r4["epoch_losses"]
    assert r1["steps"] == r4["steps"]


def test_w2v_scan_steps_matches_per_step(tmp_path):
    """K batches per run_scan window train exactly like per-step
    dispatches: same batches, same device draws, same embeddings."""
    def run_with(scan, export):
        return _port(tw2v, [
            "--synthetic_vocab", "50", "--synthetic_sentences", "60",
            "--synthetic_path", str(tmp_path / "corpus.txt"),
            "--dim", "8", "--window", "3", "--negative", "3",
            "--epochs", "2", "--batch_size", "64", "--lr", "0.1",
            "--readahead", "20", "--sample", "0", "--num_shards", "1",
            "--scan_steps", str(scan),
            "--export_prefix", str(tmp_path / export)])
    r1, r3 = run_with(1, "a_"), run_with(3, "b_")
    assert r1["epoch_losses"] == r3["epoch_losses"]
    assert r1["steps"] == r3["steps"] and r1["steps"][0] > 3
    a = (tmp_path / "a_epoch1.txt").read_text()
    b = (tmp_path / "b_epoch1.txt").read_text()
    assert a == b, "scan-trained embeddings differ from per-step"


def test_w2v_learns_and_exports(tmp_path):
    """test_apps.py's word2vec configuration on the port."""
    export = str(tmp_path / "emb_")
    res = _port(tw2v, [
        "--synthetic_vocab", "60", "--synthetic_sentences", "80",
        "--synthetic_path", str(tmp_path / "corpus.txt"),
        "--dim", "8", "--window", "3", "--negative", "3",
        "--epochs", "2", "--batch_size", "128", "--lr", "0.1",
        "--readahead", "20", "--export_prefix", export, "--sample", "0"])
    assert res["loss"] < (1 + 3) * np.log(2), res
    lines = (tmp_path / "emb_epoch1.txt").read_text().splitlines()
    V, d = (int(x) for x in lines[0].split())
    assert d == 8 and len(lines) == V + 1
    assert all(len(ln.split()) == d + 1 for ln in lines[1:])


def test_w2v_subsampling(tmp_path):
    """--sample drops frequent-word pairs: fewer steps than without."""
    argv = ["--synthetic_vocab", "40", "--synthetic_sentences", "40",
            "--synthetic_path", str(tmp_path / "c.txt"), "--dim", "4",
            "--window", "2", "--negative", "2", "--epochs", "1",
            "--batch_size", "64", "--readahead", "10"]
    sub = _port(tw2v, argv + ["--sample", "1e-3"])
    full = _port(tw2v, argv + ["--sample", "0"])
    assert np.isfinite(sub["loss"])
    assert sub["steps"][0] < full["steps"][0], (sub["steps"], full["steps"])


def test_mf_export_import(tmp_path):
    prefix = str(tmp_path) + "/"
    base = ["--rows", "24", "--cols", "16", "--nnz", "200", "--rank", "3",
            "--epochs", "1", "--batch_size", "32", "--algorithm", "plain"]
    _port(tmf, base + ["--export_prefix", prefix])
    from adapm_tpu.io.mf import read_dense as jax_read_dense
    from adapm_tpu_torch.io.mf import read_dense
    W = read_dense(prefix + "W.mma")
    assert W.shape == (24, 3)
    assert np.array_equal(W, jax_read_dense(prefix + "W.mma"))
    res = _port(tmf, base + ["--init_w", prefix + "W.mma", "--init_h",
                             prefix + "H.mma"])
    assert np.isfinite(res["loss"])
    assert tmf.main(base + ["--enforce_random_keys"] + FAST,
                    device="cpu") == 0


def test_simple_main_returns_zero():
    assert tsimple.main(["--iterations", "5"] + FAST, device="cpu") == 0
    assert tsimple.main(["--iterations", "3", "--num_shards", "4"] + FAST,
                        device="cpu") == 0


def test_apps_import_neither_jax_nor_the_jax_package(tmp_path):
    """Every module of the port imported, and the new apps' and the
    bindings' whole paths run on the CPU, in a fresh interpreter: no
    module of JAX or of the JAX package gets imported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import numpy as np\n"
        "import adapm_tpu_torch\n"
        "for m in pkgutil.walk_packages(adapm_tpu_torch.__path__,\n"
        "                               'adapm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from adapm_tpu_torch.apps import word2vec, matrix_factorization\n"
        "from adapm_tpu_torch.apps import simple\n"
        "from adapm_tpu_torch import bindings\n"
        "fast = ['--sys.sync.max_per_sec', '0']\n"
        f"corpus = {str(tmp_path / 'c.txt')!r}\n"
        "w = ['--synthetic_vocab', '30', '--synthetic_sentences', '20',\n"
        "     '--synthetic_path', corpus, '--dim', '4', '--epochs', '1',\n"
        "     '--batch_size', '32', '--readahead', '5'] + fast\n"
        "assert word2vec.main(w, device='cpu') == 0\n"
        "assert word2vec.main(w + ['--no-device_routes'], device='cpu') == 0\n"
        "m = ['--rows', '12', '--cols', '8', '--nnz', '60', '--rank', '2',\n"
        "     '--epochs', '1', '--batch_size', '8'] + fast\n"
        "assert matrix_factorization.main(m + ['--scan_steps', '2'],\n"
        "                                 device='cpu') == 0\n"
        "assert matrix_factorization.main(m + ['--no-device_routes'],\n"
        "                                 device='cpu') == 0\n"
        "assert simple.main(['--iterations', '2'] + fast, device='cpu') == 0\n"
        "bindings.setup(10, 1)\n"
        "s = bindings.Server(2, num_keys=10, device='cpu')\n"
        "wk = bindings.Worker(0, s)\n"
        "v = np.zeros((2, 2), np.float32)\n"
        "wk.push([1, 2], np.ones((2, 2), np.float32))\n"
        "wk.pull([1, 2], v)\n"
        "assert (v == 1).all()\n"
        "s.shutdown()\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'adapm_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip().endswith("ok"), \
        p.stderr[-2000:]
