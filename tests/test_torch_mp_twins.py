"""The remaining multi-process twins of tests/test_multiprocess.py
(tests/mp_scenarios.py: monotonic, stress, sampling under four schemes,
bindings, heartbeat, elastic recovery under the launcher's keepalive,
checkpoint crash recovery), on the port in 2-3 launched CPU processes
of THIS file (`python tests/test_torch_mp_twins.py <scenario> <outdir>
[args]`).

The checkpoint case also holds the per-rank shard and the manifest to
the JAX package's format (adapm_tpu/utils/checkpoint.py save_server):
the single-process file's arrays plus the cross-process tables, with
the JAX package's names, dtypes and shapes. Four cases run in tier-1;
the rest are marked slow.
"""
import faulthandler
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from test_torch_collective import run_mp as _run  # noqa: E402

SCRIPT = os.path.abspath(__file__)
CACHE_SLOTS = 16


def run_mp(n, scenario, out, *args, timeout=120):
    return _run(n, scenario, out, *args, timeout=timeout, script=SCRIPT)


# ---------------------------------------------------------------------------
# the rank programs (run as __main__)
# ---------------------------------------------------------------------------


def _rank_main(argv) -> None:
    faulthandler.dump_traceback_later(
        int(os.environ.get("ADAPM_FAULT_T", "100")), exit=True)
    sys.path.insert(0, REPO)
    scenario, out = argv[0], argv[1]
    rest = argv[2:]
    if scenario == "bindings":
        # the bindings join the multi-process runtime themselves
        _bindings(out)
        return
    import adapm_tpu_torch as at
    from adapm_tpu_torch.base import CLOCK_MAX, NO_SLOT, REMOTE
    from adapm_tpu_torch.parallel import control
    rank, P = control.process_id(), control.num_processes()

    def setup(n, L, num_shards=None, **kw):
        return at.setup(n, L, opts=at.SystemOptions(
            prefetch=False, **kw), num_shards=num_shards, device="cpu")

    def owned_by_proc(srv, proc, n=None):
        keys = np.arange(srv.num_keys, dtype=np.int64)
        mine = keys[srv.glob.home_proc(keys) == proc]
        return mine if n is None else mine[:n]

    if scenario == "monotonic":
        srv = setup(32, 2, sync_max_per_sec=500)
        srv.start_sync_thread()
        w = srv.make_worker(0)
        kk = owned_by_proc(srv, 0, 1)
        rng = np.random.default_rng(rank)
        R = 30
        for applied in range(1, R + 1):
            if rng.random() < 0.4:
                w.intent(kk, w.current_clock, w.current_clock + 3)
            w.wait(w.push(kk, np.ones((1, 2), np.float32)))
            v = float(w.pull_sync(kk)[0, 0])
            assert v >= applied, \
                f"rank {rank}: pulled {v} < own applied {applied}"
            w.advance_clock()
        w.wait_all()
        srv.wait_sync()
        srv.barrier()
        srv.wait_sync()
        srv.barrier()
        final = float(srv.read_main(kk)[0])
        assert final == P * R, f"rank {rank}: final {final} != {P * R}"
        assert float(w.pull_sync(kk)[0, 0]) == P * R
        srv.barrier()
        srv.shutdown()
    elif scenario == "stress":
        import threading
        K = 48
        # two shards, a worker on each (the JAX scenario's two devices)
        srv = setup(K, 2, num_shards=2, sync_max_per_sec=300)
        srv.start_sync_thread()
        ws = [srv.make_worker(i) for i in range(2)]
        counts = np.zeros(K, dtype=np.float64)
        lock = threading.Lock()
        errs = []

        def work(wi):
            w = ws[wi]
            rng = np.random.default_rng(1000 * rank + wi)
            try:
                for _ in range(25):
                    keys = np.unique((K * rng.random(6) ** 2).astype(
                        np.int64))
                    if rng.random() < 0.5:
                        w.intent(keys, w.current_clock,
                                 w.current_clock + 3)
                    w.wait(w.push(keys, np.ones((len(keys), 2),
                                                np.float32)))
                    with lock:
                        counts[keys] += 1
                    if rng.random() < 0.3:
                        assert np.isfinite(w.pull_sync(keys)).all()
                    w.advance_clock()
            except Exception as e:  # noqa: BLE001 — asserted below
                errs.append(e)

        threads = [threading.Thread(target=work, args=(i,))
                   for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        for w in ws:
            w.wait_all()
        srv.wait_sync()
        srv.barrier()
        srv.wait_sync()
        srv.barrier()
        total = control.allreduce(counts, "sum")
        final = srv.read_main(np.arange(K)).reshape(K, 2)
        assert np.array_equal(final, np.repeat(
            total[:, None], 2, axis=1).astype(np.float32)), \
            f"rank {rank}: lost or duplicated updates"
        srv.barrier()
        srv.shutdown()
    elif scenario == "sampling":
        scheme = rest[0]
        K = 48
        srv = setup(K, 4, sync_max_per_sec=0, sampling_scheme=scheme,
                    sampling_with_replacement=False)
        w = srv.make_worker(0)
        keys = np.arange(K, dtype=np.int64)
        if rank == 0:
            vals = np.zeros((K, 4), np.float32)
            vals[:, 0] = keys
            w.wait(w.set(keys, vals))
        srv.barrier()
        srv.enable_sampling_support(
            lambda n, rng: rng.integers(0, K, n).astype(np.int64))
        h = w.prepare_sample(12)
        if scheme == "preloc":
            srv.wait_sync()
        drawn, vals = w.pull_sample(h)
        assert len(drawn) == 12
        assert np.array_equal(vals[:, 0], drawn.astype(np.float32))
        assert len(np.unique(drawn)) == len(drawn), "WOR drew duplicates"
        if scheme == "local":
            loc = (srv.ab.owner[drawn] >= 0) | \
                (srv.ab.cache_slot[:, drawn] >= 0).any(axis=0)
            assert loc.all(), f"local drew non-resident {drawn[~loc]}"
        w.finish_sample(h)
        srv.barrier()
        srv.shutdown()
    elif scenario == "heartbeat":
        import time
        srv = setup(16, 4, sync_max_per_sec=0, heartbeat_s=0.3)
        time.sleep(1.0)
        assert srv.dead_nodes(max_age_s=5.0) == [], "live peers dead"
        srv.barrier()
        if rank == 1:
            control.stop_heartbeat()
        srv.barrier()
        if rank == 0:
            deadline = time.time() + 20
            dead = None
            while time.time() < deadline:
                dead = srv.dead_nodes(max_age_s=1.5)
                if dead == [1]:
                    break
                time.sleep(0.3)
            assert dead == [1], f"rank 1 not detected dead: {dead}"
        srv.barrier()
        srv.shutdown()
    elif scenario in ("ckpt_save", "ckpt_restore"):
        from adapm_tpu_torch.utils.checkpoint import restore_server, \
            save_server
        path = rest[0]
        srv = setup(48, 4, sync_max_per_sec=0,
                    cache_slots_per_shard=CACHE_SLOTS)
        w = srv.make_worker(0)
        keys = np.arange(48, dtype=np.int64)
        moved = owned_by_proc(srv, 0, 6)
        base = np.arange(48, dtype=np.float32)[:, None] * \
            np.ones(4, np.float32)
        if scenario == "ckpt_save":
            if rank == 0:
                w.wait(w.set(keys, base))
            srv.barrier()
            # rank 1 takes rank 0's keys; rank 0 subscribes to two of
            # them: cross-process replicas exist at the save
            if rank == 1:
                w.intent(moved, 0, CLOCK_MAX)
            srv.wait_sync()
            srv.barrier()
            if rank == 0:
                w.intent(moved[:2], 0, CLOCK_MAX)
            srv.wait_sync()
            srv.barrier()
            w.wait(w.push(keys, np.ones((48, 4), np.float32)))
            w.wait_all()
            save_server(srv, path)   # the distributed quiesce inside
            np.save(os.path.join(out, f"saved{rank}.npy"),
                    w.pull_sync(keys))
            srv.barrier()
            srv.shutdown()
        else:
            restore_server(srv, path)
            want = base + P
            v = w.pull_sync(keys)
            assert np.array_equal(v, want), f"rank {rank}: restored values"
            if rank == 1:
                assert (srv.ab.owner[moved] >= 0).all(), "ownership lost"
            if rank == 0:
                assert (srv.ab.owner[moved] == REMOTE).all()
                assert (srv.glob.owner_hint[moved] == 1).all(), \
                    "manager table lost"
                assert (srv.ab.cache_slot[w.shard, moved[:2]]
                        != NO_SLOT).any(), "replicas lost"
            np.save(os.path.join(out, f"restored{rank}.npy"), v)
            srv.barrier()
            w.wait(w.push(keys, np.ones((48, 4), np.float32)))
            w.wait(w.push(keys, -np.ones((48, 4), np.float32)))
            w.wait_all()
            srv.wait_sync()
            srv.barrier()
            srv.wait_sync()
            srv.barrier()
            assert np.array_equal(w.pull_sync(keys), want), \
                f"rank {rank}: not consistent after the restore"
            srv.barrier()
            srv.shutdown()
    elif scenario == "elastic":
        from adapm_tpu_torch.utils.checkpoint import restore_server, \
            save_server
        path = rest[0]
        srv = setup(48, 4, sync_max_per_sec=0)
        marker = f"{path}.attempt.rank{rank}"
        first = not os.path.exists(marker)
        w = srv.make_worker(0)
        keys = np.arange(48, dtype=np.int64)
        moved = owned_by_proc(srv, 0, 4)
        if first:
            open(marker, "w").write("1")
            if rank == 0:
                w.wait(w.set(keys, np.ones((48, 4), np.float32)))
            srv.barrier()
            if rank == 1:
                w.intent(moved, 0, CLOCK_MAX)
                srv.wait_sync()
            srv.barrier()
            w.wait(w.push(keys, np.ones((48, 4), np.float32)))
            w.wait_all()
            save_server(srv, path)
            # work after the checkpoint: lost in the crash
            w.wait(w.push(keys, np.full((48, 4), 7.0, np.float32)))
            w.wait_all()
            srv.barrier()
            sys.stdout.flush()
            os._exit(254)    # the keepalive restarts this rank
        restore_server(srv, path)
        want = np.full((48, 4), 1.0 + P, np.float32)
        assert np.array_equal(w.pull_sync(keys), want), \
            f"rank {rank}: restored values wrong"
        if rank == 1:
            assert (srv.ab.owner[moved] >= 0).all(), "ownership lost"
        if rank == 0:
            assert (srv.ab.owner[moved] == REMOTE).all(), "relocation lost"
        srv.barrier()
        w.wait(w.push(keys, np.ones((48, 4), np.float32)))
        w.wait(w.push(keys, -np.ones((48, 4), np.float32)))
        w.wait_all()
        srv.wait_sync()
        srv.barrier()
        srv.wait_sync()
        srv.barrier()
        assert np.array_equal(w.pull_sync(keys), want), "not consistent"
        srv.shutdown()
        open(f"{path}.done.rank{rank}", "w").write("1")
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    print(f"MP-OK {scenario} rank={rank}", flush=True)


def _bindings(out) -> None:
    import adapm_tpu_torch.bindings as adapm
    from adapm_tpu_torch.parallel import control
    adapm.setup(num_keys=32, num_threads=1)  # joins the runtime first
    rank, P = control.process_id(), control.num_processes()
    srv = adapm.Server(4, 32, device="cpu")
    w = adapm.Worker(0, srv)
    keys = np.arange(32, dtype=np.int64)
    w.wait(w.push(keys, np.ones((32, 4), np.float32), asynchronous=True))
    srv.barrier()
    got = np.zeros((32, 4), np.float32)
    w.pull(keys, got)
    assert np.array_equal(got, np.full((32, 4), float(P), np.float32))
    w.intent(keys[:4], w.current_clock, w.current_clock + 10)
    w.wait_sync()
    srv.barrier()
    w.finalize()
    srv.shutdown()
    print(f"MP-OK bindings rank={rank}", flush=True)


# ---------------------------------------------------------------------------
# the cases (pytest)
# ---------------------------------------------------------------------------


def test_mp_monotonic_contended_pushes(tmp_path):
    """Own pushes never lost under churn and the background planner;
    the final value exact (3 processes)."""
    run_mp(3, "monotonic", tmp_path)


def test_mp_checkpoint_crash_recovery(tmp_path):
    """Per-rank shards + manifest, bracketed by the quiesce protocol,
    restore values, adapted placement and the consistency invariant in
    a fresh launch; the files carry the JAX package's arrays."""
    import adapm_tpu
    from adapm_tpu.config import SystemOptions
    from adapm_tpu.utils.checkpoint import save_server as jax_save
    path = str(tmp_path / "ck")
    run_mp(2, "ckpt_save", tmp_path, path)
    run_mp(2, "ckpt_restore", tmp_path, path)
    for r in range(2):
        assert np.array_equal(np.load(tmp_path / f"saved{r}.npy"),
                              np.load(tmp_path / f"restored{r}.npy"))
    # the JAX package's single-process file of the same geometry, and
    # the cross-process tables its GlobalPM adds (parallel/pm.py:
    # owner_hint and reloc int32, interest uint64, one entry a key)
    srv = adapm_tpu.setup(48, 4, num_shards=1, opts=SystemOptions(
        sync_max_per_sec=0, cache_slots_per_shard=CACHE_SLOTS))
    jax_save(srv, str(tmp_path / "jax.npz"))
    srv.shutdown()
    ref = dict(np.load(tmp_path / "jax.npz"))
    ref.update(owner_hint=np.zeros(48, np.int32),
               reloc=np.zeros(48, np.int32),
               interest=np.zeros(48, np.uint64))
    for r in range(2):
        shard = np.load(f"{path}.rank{r}.npz")
        assert set(shard.files) == set(ref)
        for k in ref:
            assert shard[k].dtype == ref[k].dtype, k
            assert shard[k].shape == ref[k].shape, k
        assert int(shard["pid"]) == r and int(shard["num_procs"]) == 2
    mf = np.load(f"{path}.manifest.npz")
    assert set(mf.files) == {"format_version", "num_procs", "num_shards",
                             "num_keys"}
    assert all(mf[k].dtype == np.int64 and mf[k].shape == ()
               for k in mf.files)
    assert (int(mf["num_procs"]), int(mf["num_keys"])) == (2, 48)
    assert int(mf["format_version"]) == int(ref["format_version"])


@pytest.mark.parametrize("scheme", [
    "pool", pytest.param("naive", marks=pytest.mark.slow),
    pytest.param("preloc", marks=pytest.mark.slow),
    pytest.param("local", marks=pytest.mark.slow)])
def test_mp_sampling_schemes(tmp_path, scheme):
    """Every sampling scheme draws remotely owned keys exactly across 3
    processes; WOR unique; Local draws only resident keys."""
    run_mp(3, "sampling", tmp_path, scheme)


def test_mp_bindings(tmp_path):
    """The bindings surface across 2 launched processes."""
    run_mp(2, "bindings", tmp_path)


@pytest.mark.slow
def test_mp_thread_process_stress(tmp_path):
    """2 worker threads x 2 processes on overlapping skewed keys under
    intent churn and the background planner: the exact global counts."""
    run_mp(2, "stress", tmp_path, timeout=240)


@pytest.mark.slow
def test_mp_heartbeat_dead_node_detection(tmp_path):
    run_mp(2, "heartbeat", tmp_path)


@pytest.mark.slow
def test_mp_elastic_recovery_under_keepalive(tmp_path, monkeypatch):
    """Both ranks crash with exit code 254 after a checkpoint; the
    launcher's keepalive restarts them and the restarted job restores
    values, placement and consistency."""
    from adapm_tpu_torch import launcher
    path = str(tmp_path / "ck")
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setenv("TORCH_CPP_LOG_LEVEL", "ERROR")
    code = launcher.launch_local(
        2, [sys.executable, SCRIPT, "elastic", str(tmp_path), path],
        keepalive=True)
    assert code == 0
    for r in range(2):
        assert os.path.exists(f"{path}.attempt.rank{r}")
        assert os.path.exists(f"{path}.done.rank{r}")


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
