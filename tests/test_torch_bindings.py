"""The port's bindings surface (adapm_tpu_torch/bindings.py), the twin of
tests/test_bindings.py's API cases on the CPU: torch/numpy zero-copy
ops, async flags, validation errors, built-in sampling distributions;
plus one push/pull/set sequence on both packages' bindings, bitwise."""
import numpy as np
import pytest
import torch

from adapm_tpu_torch import bindings as adapm
from adapm_tpu_torch.base import LOCAL


@pytest.fixture
def server():
    adapm.setup(50, 2, use_techniques="all", num_channels=2)
    s = adapm.Server(4, num_keys=50, device="cpu")
    yield s
    s.shutdown()


def test_pull_push_torch_tensor(server):
    w = adapm.Worker(0, server)
    keys = torch.tensor([1, 2, 3], dtype=torch.int64)
    vals = torch.zeros(3, 4)
    w.pull(keys, vals)
    assert vals.abs().sum() == 0
    w.push(keys, torch.ones(3, 4))
    w.pull(keys, vals)
    assert torch.allclose(vals, torch.ones(3, 4))
    # in-place: the same tensor object is filled (zero-copy contract)
    w.push(keys, torch.full((3, 4), 2.0))
    w.pull(keys, vals)
    assert torch.allclose(vals, torch.full((3, 4), 3.0))


def test_pull_push_numpy(server):
    w = adapm.Worker(0, server)
    keys = np.array([7, 8], dtype=np.int64)
    vals = np.zeros((2, 4), dtype=np.float32)
    w.set(keys, np.full((2, 4), 5.0, dtype=np.float32))
    w.pull(keys, vals)
    assert np.allclose(vals, 5.0)


def test_async_contract(server):
    w = adapm.Worker(0, server)
    keys = torch.tensor([10], dtype=torch.int64)
    vals = torch.zeros(1, 4)
    ts = w.pull(keys, vals, asynchronous=True)
    if ts != LOCAL:
        w.wait(ts)
    w.waitall()


def test_validation_errors(server):
    w = adapm.Worker(0, server)
    with pytest.raises(IndexError, match="outside the key range"):
        w.pull(torch.tensor([99], dtype=torch.int64), torch.zeros(1, 4))
    with pytest.raises(ValueError, match="does not match the size"):
        w.pull(torch.tensor([1], dtype=torch.int64), torch.zeros(1, 3))
    with pytest.raises(ValueError, match="contiguous"):
        w.pull(torch.tensor([1, 2], dtype=torch.int64),
               torch.zeros(4, 2).t())
    with pytest.raises(TypeError, match="num_keys"):
        adapm.Server(4, device="cpu")


def test_intent_and_clock(server):
    w = adapm.Worker(0, server)
    w.intent(torch.tensor([5], dtype=torch.int64), 0, 10)
    assert w.advance_clock() == 1
    assert w.current_clock == 1
    w.wait_sync()


def test_sampling_uniform(server):
    server.enable_sampling_support("naive", True, "uniform", 0, 50)
    w = adapm.Worker(0, server)
    h = w.prepare_sample(8, 0)
    keys = np.zeros(8, dtype=np.int64)
    vals = np.zeros((8, 4), dtype=np.float32)
    w.pull_sample(h, keys, vals)
    assert keys.min() >= 0 and keys.max() < 50


def test_sampling_log_uniform(server):
    server.enable_sampling_support("naive", True, "log-uniform", 0, 50)
    w = adapm.Worker(0, server)
    h = w.prepare_sample(64, 0)
    keys = np.zeros(64, dtype=np.int64)
    vals = np.zeros((64, 4), dtype=np.float32)
    w.pull_sample(h, keys, vals)
    assert keys.min() >= 0 and keys.max() < 50
    assert np.median(keys) < 25
    with pytest.raises(ValueError, match="Unknown sampling"):
        server.enable_sampling_support("naive", True, "zipf", 0, 50)


def test_misc_api():
    adapm.setup(50, 1)
    server = adapm.Server(4, num_keys=50, device="cpu")
    w = adapm.Worker(0, server)
    assert w.num_keys == 50
    assert w.get_key_size(3) == 4
    w.begin_setup()
    w.end_setup()
    w.barrier()
    assert server.my_rank() == 0
    adapm.scheduler(50, 2)  # no-op, must not raise
    w.finalize()
    server.shutdown()


def test_per_key_value_lengths():
    adapm.setup(10, 1)
    lens = torch.tensor([2] * 5 + [6] * 5, dtype=torch.int64)
    s = adapm.Server(lens, device="cpu")
    w = adapm.Worker(0, s)
    keys = torch.tensor([0, 7], dtype=torch.int64)
    w.set(keys, torch.arange(8.0))
    got = torch.zeros(8)
    w.pull(keys, got)
    assert torch.allclose(got, torch.arange(8.0))
    assert w.get_key_size(0) == 2 and w.get_key_size(7) == 6
    s.shutdown()


def test_pull_sample_async_contract(server):
    server.enable_sampling_support("naive", True, "uniform", 0, 50)
    w = adapm.Worker(0, server)
    allk = np.arange(50, dtype=np.int64)
    w.set(allk, np.full((50, 4), 7.0, np.float32))
    w.wait_sync()
    h = w.prepare_sample(8, 0)
    keys = np.zeros(8, dtype=np.int64)
    vals = np.zeros((8, 4), dtype=np.float32)
    ts = w.pull_sample(h, keys, vals, asynchronous=True)
    if ts != -1:
        w.wait(ts)
    assert np.allclose(vals, 7.0)
    vals2 = np.zeros((8, 4), dtype=np.float32)
    h2 = w.prepare_sample(8, 0)
    ts2 = w.pull_sample(h2, keys, vals2)
    assert isinstance(ts2, int)
    assert np.allclose(vals2, 7.0)


def test_same_ops_as_the_jax_bindings_bitwise():
    """One sequence of sets, duplicate-key pushes, intents and pulls on
    both packages' bindings: every read is bitwise equal."""
    from adapm_tpu import bindings as jax_adapm
    reads = []
    for mod, kw in ((jax_adapm, {}), (adapm, {"device": "cpu"})):
        mod.setup(40, 2)
        s = mod.Server(3, num_keys=40, **kw)
        w0, w1 = mod.Worker(0, s), mod.Worker(1, s)
        r = np.random.default_rng(0)
        w0.set(np.arange(40), r.normal(size=(40, 3)).astype(np.float32))
        out = []
        for step in range(8):
            k = r.integers(0, 40, 12)
            v = r.normal(size=(12, 3)).astype(np.float32)
            w = (w0, w1)[step % 2]
            w.intent(k, w.current_clock, w.current_clock + 2)
            w.push(k, v)
            w.advance_clock()
            got = np.zeros((12, 3), np.float32)
            w.pull(k, got)
            out.append(got)
        w0.wait_sync()
        allv = np.zeros((40, 3), np.float32)
        w1.pull(np.arange(40), allv)
        out.append(allv)
        s.shutdown()
        reads.append(out)
    for a, b in zip(*reads):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_threaded_workers_like_the_bindings_example():
    """examples/bindings_example.py (the reference's bindings/example.py)
    on the port: 4 worker threads training their own keys with intent
    and the managed sampling support; pushes are additive, so each
    worker reads back ITERS x 0.1."""
    import threading
    num_keys, vlen, nw, iters = 100, 8, 4, 20
    adapm.setup(num_keys, nw)
    server = adapm.Server(vlen, num_keys=num_keys, device="cpu")
    server.enable_sampling_support("local", True, "uniform", 0, num_keys)
    results = [None] * nw
    errors = []

    def run_worker(wid):
        try:
            w = adapm.Worker(wid, server)
            keys = torch.tensor([wid, nw + wid], dtype=torch.int64)
            vals = torch.zeros(2, vlen)
            for _ in range(iters):
                w.intent(keys, w.current_clock, w.current_clock + 2)
                w.pull(keys, vals)
                w.push(keys, torch.ones(2, vlen) * 0.1)
                h = w.prepare_sample(4, w.current_clock)
                w.pull_sample(h, torch.zeros(4, dtype=torch.int64),
                              torch.zeros(4, vlen))
                w.advance_clock()
            w.wait_sync()
            w.pull(keys, vals)
            results[wid] = vals.clone()
            w.finalize()
        except Exception as e:   # reported below, with the thread's id
            errors.append((wid, e))

    threads = [threading.Thread(target=run_worker, args=(i,))
               for i in range(nw)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a worker hung"
    assert not errors, errors
    server.barrier()
    for r in results:
        assert abs(float(r[0, 0]) - iters * 0.1) < 1e-4, r
    server.shutdown()
