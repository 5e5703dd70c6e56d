"""The twin of examples/ctr_example.py on the port's bindings: the
factorization machine trained through the parameter manager, then served
through the port's ServePlane (fused bag reads next to flat lookups),
at the example's own size and seeds.

The example's two workers run in threads; here their steps interleave
round-robin on one thread, in both packages alike, so the comparison
with the JAX example's run is deterministic: the per-step losses must
be within rtol 1e-4 (the pulled rows and the torch model are the same
on both sides), and the trained tables equal. The served bag reads
must be bitwise the host pool of the flat lookups and of the
training-path pull."""
import importlib.util
import os
import threading

import numpy as np
import torch

from adapm_tpu import bindings as jax_adapm
from adapm_tpu_torch import bindings as adapm
from adapm_tpu_torch.serve import ServePlane
from adapm_tpu_torch.serve.bags import pool_bags_host


def _example():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "ctr_example.py")
    spec = importlib.util.spec_from_file_location("ctr_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CE = _example()


def _worker_steps(mod, wid, server, feats, clicks, losses):
    """The example's run_worker, one yield per step; the round-robin
    loop stands in for the per-epoch barrier."""
    w = mod.Worker(wid, server)
    part = np.arange(wid, CE.SAMPLES, CE.NUM_WORKERS)
    for _ in range(CE.EPOCHS):
        for lo in range(0, len(part), CE.BATCH):
            idx = part[lo:lo + CE.BATCH]
            nxt = part[lo + CE.BATCH:lo + 2 * CE.BATCH]
            if len(nxt):
                w.intent(np.unique(feats[nxt]), w.current_clock + 1,
                         w.current_clock + 2)
            uniq, inv = np.unique(feats[idx], return_inverse=True)
            buf = torch.zeros(len(uniq), CE.ROW)
            w.pull(uniq, buf)
            rows = buf[:, :1 + CE.DIM].clone().requires_grad_(True)
            acc = buf[:, 1 + CE.DIM:]
            score = CE.fm_forward(rows, torch.from_numpy(
                inv.reshape(len(idx), CE.FIELDS)))
            loss = torch.nn.functional.binary_cross_entropy_with_logits(
                score, torch.from_numpy(clicks[idx]))
            loss.backward()
            g = rows.grad
            delta = torch.cat([-CE.LR * g / torch.sqrt(acc + g * g + CE.EPS),
                               g * g], dim=1)
            w.push(uniq, delta, asynchronous=True)
            losses[wid].append(loss.item())
            w.advance_clock()
            yield
        w.waitall()


def _train(mod, **server_kw):
    """The example's main() up to the end of training."""
    rng = np.random.default_rng(7)
    feats, clicks = CE.make_click_log(rng)
    mod.setup(CE.NUM_KEYS, CE.NUM_WORKERS)
    server = mod.Server(CE.ROW, num_keys=CE.NUM_KEYS, **server_kw)
    init = np.zeros((CE.NUM_KEYS, CE.ROW), dtype=np.float32)
    init[:, 1:1 + CE.DIM] = rng.normal(0, 0.05, (CE.NUM_KEYS, CE.DIM))
    init[:, 1 + CE.DIM:] = 1e-6
    w0 = mod.Worker(0, server)
    w0.begin_setup()
    w0.set(np.arange(CE.NUM_KEYS), init)
    w0.end_setup()
    w0.wait_sync()
    losses = [[] for _ in range(CE.NUM_WORKERS)]
    gens = [_worker_steps(mod, i, server, feats, clicks, losses)
            for i in range(CE.NUM_WORKERS)]
    live = list(gens)
    while live:
        for g in list(live):
            if next(g, StopIteration) is StopIteration:
                live.remove(g)
    return server, feats, clicks, losses


def _serve_inference(server, feats, clicks, n_clients=4, batch=32,
                     samples=256):
    """The example's serve_inference on the port's ServePlane: each
    client scores its share of the samples with one fused bag read per
    batch (one bag per sample over its FIELDS keys) and a flat lookup of
    the batch's unique keys; every bag read must be bitwise the host
    pool of the flat read."""
    plane = ServePlane(server._srv)
    parts = np.array_split(np.arange(samples), n_clients)
    preds = [None] * n_clients
    rows_seen = [None] * n_clients
    errors = []

    def client(ci):
        try:
            sess = plane.session()
            out, seen = [], {}
            for lo in range(0, len(parts[ci]), batch):
                idx = parts[ci][lo:lo + batch]
                fk = feats[idx]
                b = len(idx)
                ks = fk.ravel().astype(np.int64)
                (pooled,) = sess.lookup_bags(
                    [ks], [np.arange(0, len(ks) + 1, CE.FIELDS)],
                    pooling="sum", deadline_ms=10_000)
                uniq, inv = np.unique(fk, return_inverse=True)
                inv = inv.reshape(-1)
                rows = sess.lookup(uniq, deadline_ms=10_000)
                host = pool_bags_host(
                    rows[inv], np.repeat(np.arange(b), CE.FIELDS)
                    .astype(np.int32), b, "sum")
                assert np.array_equal(pooled.view(np.uint32),
                                      host.view(np.uint32)), \
                    "bag read differs from the host pool of the flat read"
                sw, sv = pooled[:, 0], pooled[:, 1:1 + CE.DIM]
                v = rows[:, 1:1 + CE.DIM][inv.reshape(b, CE.FIELDS)]
                out.append(sw + 0.5 * ((sv ** 2).sum(1)
                                       - (v ** 2).sum((1, 2))))
                for k, r in zip(uniq, rows):
                    seen[int(k)] = r
            preds[ci] = np.concatenate(out)
            rows_seen[ci] = seen
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append((ci, e))

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a serve client hung"
    assert not errors, errors
    # every served row is bitwise the training-path pull of its key
    wchk = adapm.Worker(0, server)
    for seen in rows_seen:
        keys = np.fromiter(seen, np.int64, len(seen))
        buf = np.zeros((len(keys), CE.ROW), np.float32)
        wchk.pull(keys, buf)
        served = np.stack([seen[int(k)] for k in keys])
        assert np.array_equal(served.view(np.uint32), buf.view(np.uint32))
    snap = server._srv.metrics_snapshot()["serve"]
    plane.close()
    y = clicks[:samples]
    p = 1.0 / (1.0 + np.exp(-np.concatenate(preds)))
    logloss = float(-np.mean(y * np.log(p + 1e-9)
                             + (1 - y) * np.log(1 - p + 1e-9)))
    return logloss, snap


def test_ctr_example_on_the_port():
    jsrv, _, _, jlosses = _train(jax_adapm)
    jtable = jsrv._srv.read_main(np.arange(CE.NUM_KEYS))
    jsrv.shutdown()
    server, feats, clicks, losses = _train(adapm, device="cpu")
    for a, b in zip(losses, jlosses):
        np.testing.assert_allclose(a, b, rtol=1e-4)
    table = server._srv.read_main(np.arange(CE.NUM_KEYS))
    np.testing.assert_allclose(table, jtable, rtol=1e-4, atol=1e-7)
    first = float(np.mean(losses[0][:4]))
    last = float(np.mean(losses[0][-4:]))
    assert last < 0.92 * first, "FM failed to learn the click model"
    logloss, snap = _serve_inference(server, feats, clicks)
    assert logloss < first
    assert snap["bag_lookups_total"] == 8 and snap["bag_fused_total"] >= 1
    assert snap["lookups_total"] == 8 and snap["ready"] == 1
    server.shutdown()
