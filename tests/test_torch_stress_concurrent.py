"""True-concurrency stress on the port, with the background planner:
tests/test_stress_concurrent.py's two scenarios (the reference's
tests/test_dynamic_allocation.cc:84-103) on both packages, 8 shards
each (`make_context(8, "cpu")` beside the JAX suite's 8-device mesh).

Python threads push integer-valued updates to contended keys under
random intent while `Server.start_sync_thread()` relocates and
replicates underneath them; after WaitSync -> Barrier -> WaitSync,
`stop_sync_thread()` and `quiesce()`, every main row must be bitwise the
exact sequential sum — on the port and on the JAX package alike (integer
values make the fold order irrelevant) — and no background round may
have failed.
"""
import sys
import threading

import numpy as np

import adapm_tpu
import adapm_tpu_torch

KEY = 9
RUNS = 200
N_WORKERS = 4


def _setup(pkg, num_keys, vlen, **opts):
    o = pkg.SystemOptions(sync_report_s=0, **opts)
    if pkg is adapm_tpu:
        return adapm_tpu.setup(num_keys, vlen, opts=o)
    return adapm_tpu_torch.setup(num_keys, vlen, opts=o, num_shards=8,
                                 device="cpu")


def _quiesce_and_read(srv, keys):
    srv.wait_sync()
    srv.barrier()
    srv.wait_sync()
    srv.stop_sync_thread()
    srv.quiesce()
    return np.array(srv.read_main(keys), dtype=np.float32)


def _join(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive(), "worker thread hung"


def _many_thread(pkg):
    K, runs, n_threads = 12, 400, 8
    srv = _setup(pkg, 64, 2, cache_slots_per_shard=16,
                 sync_max_per_sec=4000.0)
    workers = [srv.make_worker(i) for i in range(n_threads)]
    srv.start_sync_thread()
    errors: list = []
    keys = np.arange(K, dtype=np.int64)
    counts = np.zeros((n_threads, K), dtype=np.int64)

    def hammer(w):
        rng = np.random.default_rng(7_000 + w.worker_id)
        try:
            for run in range(runs):
                k = int(rng.integers(0, K))
                if rng.integers(0, 40) == 0:
                    w.intent(keys, w.current_clock + 5,
                             w.current_clock + 30)
                w.push(np.array([k]), np.ones((1, 2), np.float32))
                counts[w.worker_id, k] += 1
                if run % 16 == 0:
                    w.wait_all()
                w.advance_clock()
            w.wait_all()
        except Exception as e:  # noqa: BLE001 - surface to main thread
            errors.append(f"worker {w.worker_id}: {type(e).__name__}: {e}")

    _join([threading.Thread(target=hammer, args=(w,)) for w in workers])
    assert not errors, errors
    got = _quiesce_and_read(srv, keys).reshape(K, 2)
    want = np.repeat(counts.sum(0)[:, None], 2, axis=1).astype(np.float32)
    st = srv.sync.stats
    assert st.rounds > 0 and st.intents_processed > 0
    out = (got, want, _failures(srv))
    srv.shutdown()
    return out


def _dynamic_allocation(pkg):
    srv = _setup(pkg, 36, 2, cache_slots_per_shard=8,
                 sync_max_per_sec=2000.0)
    workers = [srv.make_worker(i) for i in range(N_WORKERS)]
    srv.start_sync_thread()
    errors: list = []

    def run(w):
        rng = np.random.default_rng(1000 + w.worker_id)
        push_val = np.array([[1.0, 2.0]], np.float32)
        keys = np.array([KEY])
        last = -np.inf
        try:
            for i in range(RUNS):
                if rng.integers(0, 50) == 0:
                    w.intent(keys, w.current_clock + 10,
                             w.current_clock + 40)
                w.push(keys, push_val)
                got = w.pull_sync(keys)
                # concurrent pushes are never lost: the total only grows
                if got[0, 0] < last:
                    errors.append(f"worker {w.worker_id}: value regressed "
                                  f"{last} -> {got[0, 0]} at run {i}")
                    return
                last = float(got[0, 0])
                w.advance_clock()
            w.wait_all()
        except Exception as e:  # noqa: BLE001 - surface to main thread
            errors.append(f"worker {w.worker_id}: {type(e).__name__}: {e}")

    _join([threading.Thread(target=run, args=(w,)) for w in workers])
    assert not errors, errors
    got = _quiesce_and_read(srv, np.array([KEY]))
    want = (N_WORKERS * RUNS * np.array([1.0, 2.0])).astype(np.float32)
    st = srv.sync.stats
    assert st.rounds > 0 and st.intents_processed > 0
    out = (got, want, _failures(srv))
    srv.shutdown()
    return out


def _failures(srv):
    """Background rounds that raised: the port counts them; the JAX
    server counts them only with its fault plane, so read 0 there."""
    return getattr(srv, "sync_loop_failures", 0)


def _check(scenario):
    gj, wj, _ = scenario(adapm_tpu)
    # the port's run with a short interpreter switch interval, so its
    # threads (workers, executor, planner) interleave far more often
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        gt, wt, failed = scenario(adapm_tpu_torch)
    finally:
        sys.setswitchinterval(old)
    for got, want in ((gj, wj), (gt, wt)):
        assert np.array_equal(got.view(np.uint32),
                              want.reshape(got.shape).view(np.uint32)), \
            (got, want)
    assert np.array_equal(gt.view(np.uint32), gj.view(np.uint32))
    assert failed == 0, f"{failed} background rounds failed"


def test_many_thread_exact_sum_stress():
    _check(_many_thread)


def test_dynamic_allocation_stress():
    _check(_dynamic_allocation)
