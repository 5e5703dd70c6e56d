"""The port's parameter manager across real processes (twin of
tests/test_multiprocess.py with tests/mp_scenarios.py).

Each case launches N CPU processes of THIS file (`python
tests/test_torch_multiprocess.py <scenario> <outdir> [arg]`), rendezvoused
through the launcher's env contract and the TCPStore control plane, with
the parameter traffic on the DCN channel (adapm_tpu_torch/parallel).
The scenarios are the multi-process twins of the reference's
test_many_key_operations.cc / test_locality_api.cc phases:
pull/push/set, intent relocation and replication, eventual consistency
under each management technique, and location caches on and off. Final
reads are checked against a NumPy shadow and, for the integer-valued
scenario, against the JAX package's LoopbackCluster run of the same
draws (integer values make every summation order exact, so the
comparison is bitwise).

Every case has its own subprocess timeout, and each rank arms
faulthandler to dump its stacks before it. Ports come from
`launcher.free_port()`, never a fixed number.
"""
import faulthandler
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
K_EV, L_EV, ROUNDS_EV, N_EV = 48, 4, 4, 12


def _draws(seed: int = 31):
    """The eventual scenario's integer-valued pushes per rank, and the
    NumPy shadow of the final table (base + every push)."""
    base = np.arange(K_EV, dtype=np.float32)[:, None] * \
        np.ones(L_EV, np.float32)
    shadow = base.astype(np.float64)
    per_rank = []
    for rank in range(2):
        rng = np.random.default_rng(seed + rank)
        rr = []
        for _ in range(ROUNDS_EV):
            keys = np.sort(rng.choice(K_EV, size=N_EV, replace=False))
            vals = rng.integers(-9, 10, size=(N_EV, L_EV)).astype(
                np.float32)
            rr.append((keys.astype(np.int64), vals))
            shadow[keys] += vals
        per_rank.append(rr)
    return base, per_rank, shadow.astype(np.float32)


def eventual_body(rank, srv, clock_max):
    """Rank 1 first claims a slice of the keys alone (exclusive intent:
    relocations), then every rank subscribes to every key (full
    replication pressure), pushes its integer draws round by round, and
    reads after the quiesce protocol (WaitSync -> Barrier -> WaitSync).
    The same function drives a launched port rank and a JAX
    LoopbackCluster node."""
    base, per_rank, _ = _draws()
    w = srv.make_worker(0)
    keys = np.arange(K_EV, dtype=np.int64)
    if rank == 0:
        w.wait(w.set(keys, base))
    srv.barrier()
    if rank == 1:
        w.intent(keys[:16], 0, clock_max)
        srv.wait_sync()
    srv.barrier()
    w.intent(keys, 0, clock_max)
    srv.wait_sync()
    srv.barrier()
    for ks, vals in per_rank[rank]:
        w.wait(w.push(ks, vals))
        srv.wait_sync()
    w.wait_all()
    srv.wait_sync()
    srv.barrier()
    srv.wait_sync()
    srv.barrier()
    return w.pull_sync(keys), srv.read_main(keys).reshape(K_EV, L_EV)


# ---------------------------------------------------------------------------
# the rank programs (run as __main__)
# ---------------------------------------------------------------------------


def _rank_main(argv) -> None:
    faulthandler.dump_traceback_later(
        int(os.environ.get("ADAPM_FAULT_T", "100")), exit=True)
    sys.path.insert(0, REPO)
    import adapm_tpu_torch as at
    from adapm_tpu_torch.base import (CLOCK_MAX, LOCAL, MgmtTechniques,
                                      NO_SLOT, NOT_CACHED, REMOTE)
    from adapm_tpu_torch.parallel import control

    scenario, out = argv[0], argv[1]
    arg = argv[2] if len(argv) > 2 else None

    def setup(n, L, **kw):
        return at.setup(n, L, opts=at.SystemOptions(
            sync_max_per_sec=0, prefetch=False, **kw), device="cpu")

    def owned_by_proc(srv, proc, n=None):
        keys = np.arange(srv.num_keys, dtype=np.int64)
        mine = keys[srv.glob.home_proc(keys) == proc]
        return mine if n is None else mine[:n]

    if scenario == "pullpush":
        # arg "tcp": the NetPort TCP backend (--sys.net.backend tcp, its
        # peers rendezvoused through the control plane's TCPStore) in
        # place of the DCN channel
        srv = setup(64, 4, **({"net_backend": "tcp"} if arg == "tcp"
                              else {}))
        if arg == "tcp":
            assert type(srv.glob.chan).__name__ == "TcpNetPort"
        rank, P = control.process_id(), control.num_processes()
        assert srv.glob is not None and srv.num_procs == P
        w = srv.make_worker(0)
        keys = np.arange(64, dtype=np.int64)
        base = np.arange(64, dtype=np.float32)[:, None] * \
            np.ones(4, np.float32)
        if rank == 0:
            w.wait(w.set(keys, base))
        srv.barrier()
        v = w.pull_sync(keys)
        bad = np.nonzero((v != base).any(axis=1))[0]
        assert not len(bad), f"pull after set: keys {bad} read {v[bad]}"
        srv.barrier()  # every rank read the set before any rank pushes
        w.wait(w.push(keys, np.ones((64, 4), np.float32)))
        srv.barrier()
        v = w.pull_sync(keys)
        assert np.array_equal(v, base + P), "pull after pushes"
        assert np.array_equal(srv.read_main(keys).reshape(64, 4),
                              base + P), "read_main disagrees"
        mine = owned_by_proc(srv, rank)
        mine = mine[srv.ab.owner[mine] == w.shard]
        assert w.pull(mine) == LOCAL, "own-shard keys should be LOCAL"
        srv.barrier()  # every rank read the pushes before any rank sets
        # a set after pushes overwrites at the owner, for every rank
        if rank == P - 1:
            w.wait(w.set(keys[:8], np.full((8, 4), -3.0, np.float32)))
        srv.barrier()
        assert (w.pull_sync(keys[:8]) == -3.0).all(), "set lost"
        np.save(os.path.join(out, f"r{rank}.npy"), w.pull_sync(keys))
        srv.barrier()
        srv.shutdown()
    elif scenario == "intent":
        srv = setup(64, 4)
        rank = control.process_id()
        w = srv.make_worker(0)
        keys = owned_by_proc(srv, 0, 8)
        if rank == 0:
            w.wait(w.set(keys, np.full((8, 4), 7.0, np.float32)))
        srv.barrier()
        if rank == 1:
            w.intent(keys, 0, CLOCK_MAX)
            srv.wait_sync()
            assert (srv.ab.owner[keys] >= 0).all(), \
                "exclusive intent should relocate cross-process"
            assert srv.glob.stats["relocations_in"] >= 8
            assert np.allclose(w.pull_sync(keys), 7.0), "value lost"
        srv.barrier()
        if rank == 0:
            assert (srv.ab.owner[keys] == REMOTE).all()
            assert (srv.glob.owner_hint[keys] == 1).all()
            # competing intent: rank 1 still holds intent -> replicate
            w.intent(keys, 0, CLOCK_MAX)
            srv.wait_sync()
            assert (srv.ab.cache_slot[w.shard, keys] != NO_SLOT).all(), \
                "competing intent should replicate"
            assert w.pull(keys) == LOCAL
        srv.barrier()
        if rank == 1:
            w.wait(w.push(keys, np.ones((8, 4), np.float32)))
        w.wait_all()
        srv.wait_sync()
        srv.barrier()
        srv.wait_sync()
        srv.barrier()
        v = w.pull_sync(keys)
        assert np.array_equal(v, np.full((8, 4), 8.0, np.float32)), \
            f"replica did not converge: {v[:2]}"
        if rank == 0:
            assert srv.glob.stats["replicas_granted"] == 0
            assert srv.sync.stats.replicas_created >= 8
        else:
            assert srv.glob.stats["replicas_granted"] >= 8
        np.save(os.path.join(out, f"r{rank}.npy"), v)
        srv.barrier()
        srv.shutdown()
    elif scenario == "eventual":
        tech = MgmtTechniques(arg or "all")
        srv = setup(K_EV, L_EV, techniques=tech)
        rank = control.process_id()
        pulled, main = eventual_body(rank, srv, CLOCK_MAX)
        np.save(os.path.join(out, f"r{rank}.npy"), pulled)
        np.save(os.path.join(out, f"m{rank}.npy"), main)
        np.save(os.path.join(out, f"pm{rank}.npy"), np.array(
            [srv.glob.stats["relocations_in"],
             srv.glob.stats["replicas_granted"]], np.int64))
        srv.barrier()
        srv.shutdown()
    elif scenario == "caches":
        caches = bool(int(arg))
        srv = setup(12, 4, location_caches=caches)
        rank = control.process_id()
        w = srv.make_worker(0)
        k = owned_by_proc(srv, 0, 1)  # managed (initially owned) by rank 0
        if rank == 0:
            w.wait(w.set(k, np.full((1, 4), 5.0, np.float32)))
        srv.barrier()
        if rank == 1:
            w.intent(k, 0, CLOCK_MAX)
            srv.wait_sync()
            assert (srv.ab.owner[k] >= 0).all()
        srv.barrier()
        if rank == 2:
            assert float(w.pull_sync(k)[0, 0]) == 5.0
            if caches:
                assert srv.glob.owner_hint[k[0]] == 1, \
                    "location cache should have learned the owner"
            else:
                assert srv.glob.owner_hint[k[0]] == NOT_CACHED, \
                    "caches off: the hint table must stay cold"
            before = srv.glob.stats["redirects"]
            h1 = int(srv.glob.hops[0])
            assert float(w.pull_sync(k)[0, 0]) == 5.0
            if caches:
                assert srv.glob.stats["redirects"] == before
                assert int(srv.glob.hops[0]) == h1 + 1, \
                    "cached owner: one hop"
        srv.barrier()
        if rank == 0 and caches:
            assert srv.glob.stats["pulls_in"] >= 1
        np.save(os.path.join(out, f"r{rank}.npy"), w.pull_sync(k))
        srv.barrier()
        srv.shutdown()
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    print(f"MP-OK {scenario} rank={control.process_id()}", flush=True)


# ---------------------------------------------------------------------------
# the cases (pytest)
# ---------------------------------------------------------------------------


def run_mp(n, scenario, out, arg=None, timeout=90):
    """Launch `n` ranks of a scenario; assert all exit 0."""
    from adapm_tpu_torch import launcher
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["TORCH_CPP_LOG_LEVEL"] = "ERROR"
    # a hung scenario dumps its stacks and exits before our timeout
    env["ADAPM_FAULT_T"] = str(max(timeout - 15, 20))
    coordinator = f"localhost:{launcher.free_port()}"
    cmd = [sys.executable, os.path.abspath(__file__), scenario, str(out)]
    if arg is not None:
        cmd.append(str(arg))
    procs = [subprocess.Popen(cmd, env=launcher.make_env(r, n, coordinator,
                                                         env),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(n)]
    outs = []
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"MP-OK {scenario} rank={r}" in o, \
            f"rank {r} failed:\n" + "\n".join(
                f"--- rank {q}:\n{x[-3000:]}" for q, x in enumerate(outs))
    return outs


def _jax_eventual(tech: str):
    """The eventual scenario on the JAX package's LoopbackCluster, with
    the same draws."""
    from adapm_tpu.base import CLOCK_MAX, MgmtTechniques
    from adapm_tpu.config import SystemOptions
    from adapm_tpu.net import LoopbackCluster
    cl = LoopbackCluster(
        2, num_keys=K_EV, value_lengths=L_EV,
        opts_factory=lambda r: SystemOptions(
            sync_max_per_sec=0, prefetch=False,
            techniques=MgmtTechniques(tech)))
    try:
        return cl.run(lambda rank, srv: eventual_body(rank, srv,
                                                      CLOCK_MAX))
    finally:
        cl.shutdown()


def _check_eventual(tmp_path, tech):
    run_mp(2, "eventual", tmp_path, tech)
    _, _, shadow = _draws()
    jax_outs = _jax_eventual(tech)
    moved = np.zeros(2, np.int64)
    for r in range(2):
        pulled = np.load(tmp_path / f"r{r}.npy")
        main = np.load(tmp_path / f"m{r}.npy")
        np.testing.assert_array_equal(pulled, shadow,
                                      err_msg=f"rank {r} vs shadow")
        np.testing.assert_array_equal(main, shadow)
        assert pulled.tobytes() == jax_outs[r][0].tobytes(), \
            f"rank {r}: the port's read differs from the JAX run"
        moved += np.load(tmp_path / f"pm{r}.npy")
    if tech != "replication_only":
        assert moved[0] > 0, "no relocation happened"
    if tech != "relocation_only":
        assert moved[1] > 0, "no replication happened"


def test_mp_pull_push_set(tmp_path):
    run_mp(2, "pullpush", tmp_path)
    base = np.arange(64, dtype=np.float32)[:, None] * np.ones(4, np.float32)
    want = base + 2
    want[:8] = -3.0
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"r{r}.npy"), want)


def test_mp_intent_relocation_replication(tmp_path):
    run_mp(2, "intent", tmp_path)
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"r{r}.npy"),
                                      np.full((8, 4), 8.0, np.float32))


def test_mp_eventual_consistency_all(tmp_path):
    _check_eventual(tmp_path, "all")


def test_mp_location_caches_off(tmp_path):
    run_mp(3, "caches", tmp_path, 0)
    for r in range(3):
        assert (np.load(tmp_path / f"r{r}.npy") == 5.0).all()


@pytest.mark.slow
@pytest.mark.parametrize("tech", ["replication_only", "relocation_only"])
def test_mp_eventual_consistency_techniques(tmp_path, tech):
    _check_eventual(tmp_path, tech)


@pytest.mark.slow
def test_mp_pull_push_set_tcp_backend(tmp_path):
    run_mp(2, "pullpush", tmp_path, "tcp")
    base = np.arange(64, dtype=np.float32)[:, None] * np.ones(4, np.float32)
    want = base + 2
    want[:8] = -3.0
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"r{r}.npy"), want)


@pytest.mark.slow
def test_mp_location_caches_on(tmp_path):
    run_mp(3, "caches", tmp_path, 1)
    for r in range(3):
        assert (np.load(tmp_path / f"r{r}.npy") == 5.0).all()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
