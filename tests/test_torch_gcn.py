"""The twin of examples/gcn_example.py on the port's bindings: the
two-layer GCN over a stochastic block model, its node embeddings and
dense weights held in the parameter manager with per-key value lengths,
at the example's own size and seeds.

The round-robin case runs the example's two workers as interleaved
epochs on one thread, in both packages alike (the round-robin stands in
for the per-epoch barrier), so the comparison with the JAX package's
run is deterministic: per-epoch losses within rtol 1e-4 (the pulled
rows and the torch model are the same on both sides), the trained
tables within rtol 1e-4 / atol 1e-6, and the final accuracy above the
example's 0.85. The threaded case runs the example's own `run_worker`
threads (barriers included) against the port's bindings on the CPU."""
import importlib.util
import os
import threading

import numpy as np
import torch

from adapm_tpu import bindings as jax_adapm
from adapm_tpu_torch import bindings as adapm


def _example():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "gcn_example.py")
    spec = importlib.util.spec_from_file_location("gcn_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GE = _example()


def _server(mod, rng, **server_kw):
    """The example's main() up to the workers: setup, the per-key
    lengths, the seeded initial rows in a setup bracket."""
    mod.setup(GE.NUM_KEYS, GE.NUM_WORKERS)
    lens = np.concatenate([np.full(GE.N, 2 * GE.D), np.full(GE.H, 2 * GE.D),
                           np.full(GE.C, 2 * GE.H)]).astype(np.int64)
    server = mod.Server(lens, **server_kw)
    w0 = mod.Worker(0, server)
    w0.begin_setup()
    flat = []
    for width, count in ((GE.D, GE.N), (GE.D, GE.H), (GE.H, GE.C)):
        rows = np.zeros((count, 2 * width), dtype=np.float32)
        rows[:, :width] = rng.normal(0, 0.3, (count, width))
        rows[:, width:] = 1e-6
        flat.append(rows.ravel())
    w0.set(np.arange(GE.NUM_KEYS), np.concatenate(flat))
    w0.end_setup()
    w0.wait_sync()
    return server


def _worker_epochs(mod, wid, server, a_hat, labels, losses):
    """The example's run_worker, one yield per epoch."""
    w = mod.Worker(wid, server)
    node_keys = np.arange(GE.N, dtype=np.int64)
    w1_keys = np.arange(GE.KEY_W1, GE.KEY_W1 + GE.H, dtype=np.int64)
    w2_keys = np.arange(GE.KEY_W2, GE.KEY_W2 + GE.C, dtype=np.int64)
    mine = torch.arange(wid, GE.N, GE.NUM_WORKERS)
    w.intent(np.concatenate([w1_keys, w2_keys, node_keys]),
             w.current_clock, w.current_clock + GE.EPOCHS + 1)
    for _ in range(GE.EPOCHS):
        x, accx = GE.pull_matrix(w, node_keys, GE.D)
        w1, acc1 = GE.pull_matrix(w, w1_keys, GE.D)
        w2, acc2 = GE.pull_matrix(w, w2_keys, GE.H)
        h1 = torch.relu(a_hat @ (x @ w1.t()))
        logits = a_hat @ (h1 @ w2.t())
        loss = torch.nn.functional.cross_entropy(logits[mine],
                                                 labels[mine])
        loss.backward()
        GE.push_adagrad(w, node_keys, x, accx)
        GE.push_adagrad(w, w1_keys, w1, acc1)
        GE.push_adagrad(w, w2_keys, w2, acc2)
        w.advance_clock()
        w.waitall()
        losses[wid].append(loss.item())
        yield
    w.wait_sync()


def _accuracy(mod, server, a_hat, labels):
    w = mod.Worker(0, server)
    x, _ = GE.pull_matrix(w, np.arange(GE.N, dtype=np.int64), GE.D)
    w1, _ = GE.pull_matrix(w, np.arange(GE.KEY_W1, GE.KEY_W1 + GE.H), GE.D)
    w2, _ = GE.pull_matrix(w, np.arange(GE.KEY_W2, GE.KEY_W2 + GE.C), GE.H)
    with torch.no_grad():
        logits = a_hat @ (torch.relu(a_hat @ (x @ w1.t())) @ w2.t())
    return float((logits.argmax(1) == labels).float().mean())


def _train(mod, **server_kw):
    rng = np.random.default_rng(3)
    a_hat, labels = GE.make_graph(rng)
    server = _server(mod, rng, **server_kw)
    losses = [[] for _ in range(GE.NUM_WORKERS)]
    live = [_worker_epochs(mod, i, server, a_hat, labels, losses)
            for i in range(GE.NUM_WORKERS)]
    while live:
        for g in list(live):
            if next(g, StopIteration) is StopIteration:
                live.remove(g)
    acc = _accuracy(mod, server, a_hat, labels)
    table = server._srv.read_main(np.arange(GE.NUM_KEYS))
    server.shutdown()
    return losses, table, acc


def test_gcn_example_on_the_port_round_robin():
    jlosses, jtable, jacc = _train(jax_adapm)
    losses, table, acc = _train(adapm, device="cpu")
    for a, b in zip(losses, jlosses):
        assert len(a) == len(b) == GE.EPOCHS
        np.testing.assert_allclose(a, b, rtol=1e-4)
    np.testing.assert_allclose(table, jtable, rtol=1e-4, atol=1e-6)
    assert acc > 0.85 and jacc > 0.85, (acc, jacc)
    assert losses[0][-1] < 0.5 * losses[0][0]


def test_gcn_example_threads_on_the_port():
    """The example's own worker threads (intent, pulls, AdaGrad pushes,
    barrier per epoch, final wait_sync) on the port's bindings."""
    rng = np.random.default_rng(3)
    a_hat, labels = GE.make_graph(rng)
    server = _server(adapm, rng, device="cpu")
    out = [None] * GE.NUM_WORKERS
    errors = []
    real = GE.adapm
    GE.adapm = adapm   # run_worker builds its Worker through `adapm`

    def run(i):
        try:
            GE.run_worker(i, server, a_hat, labels, out)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append((i, e))

    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(GE.NUM_WORKERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads), "a worker hung"
    finally:
        GE.adapm = real
    assert not errors, errors
    assert out[0] > 0.85, out
    server.shutdown()
