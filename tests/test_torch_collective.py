"""The port's BSP collective exchange across real processes (the
collective twins of tests/test_multiprocess.py with tests/mp_scenarios.py:
scenario_coll_pullpush, scenario_eventual with "coll", scenario_cadence).

The JAX package's collective runs over jaxlib's cross-process CPU
collectives, which this image lacks (its tests are gated off there), so
these cases hold the port to a NumPy shadow and to the port's own RPC
mode on the same draws: integer-valued tables and pushes make every
summation order exact, so the comparisons are bitwise. On the CPU the
exchange is K13's plain version over shared-memory slabs
(parallel/exchange.py), in 2-3 launched processes of THIS file
(`python tests/test_torch_collective.py <scenario> <outdir> [args]`).

Small keys force many exchange iterations. The pull/push case has
E=2,000 keys of length 4 and bucket 8: with two processes each drains
~1,000 remote keys in ~125 iterations a round, past the JAX loop's
bound on iterations (collective.py MAX_ROUNDS, which raises there); the
port bounds each item's tries instead. The eventual cases have two
length classes (4 and 8), each with its own loop.
"""
import faulthandler
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
E_PP = 2000           # pull/push scenario's keys
K_EV, ROUNDS_EV, N_EV = 48, 3, 12


def _lens(n):
    """Two length classes: 4 and 8 floats, alternating."""
    return np.where(np.arange(n) % 2 == 0, 4, 8).astype(np.int64)


def _base(n, length=None):
    """Integer-valued rows, flat: key k's row is k*100 + [0, 1, ...]."""
    lens = _lens(n) if length is None else np.full(n, length)
    return np.concatenate([k * 100 + np.arange(L, dtype=np.float32)
                           for k, L in enumerate(lens)]).astype(np.float32)


def _ev_draws(P, seed=41):
    """Integer pushes per rank per round (flat over the chosen keys)."""
    lens = _lens(K_EV)
    shadow = _base(K_EV).astype(np.float64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    per_rank = []
    for rank in range(P):
        rng = np.random.default_rng(seed + rank)
        rr = []
        for _ in range(ROUNDS_EV):
            keys = np.sort(rng.choice(K_EV, size=N_EV, replace=False))
            vals = rng.integers(-9, 10, size=int(lens[keys].sum())).astype(
                np.float32)
            rr.append((keys.astype(np.int64), vals))
            idx = np.concatenate([np.arange(offs[k], offs[k + 1])
                                  for k in keys])
            shadow[idx] += vals
        per_rank.append(rr)
    return per_rank, shadow.astype(np.float32)


# ---------------------------------------------------------------------------
# the rank programs (run as __main__)
# ---------------------------------------------------------------------------


def _rank_main(argv) -> None:
    faulthandler.dump_traceback_later(
        int(os.environ.get("ADAPM_FAULT_T", "100")), exit=True)
    sys.path.insert(0, REPO)
    import adapm_tpu_torch as at
    from adapm_tpu_torch.base import CLOCK_MAX, MgmtTechniques
    from adapm_tpu_torch.parallel import control

    scenario, out = argv[0], argv[1]
    rank, P = control.process_id(), control.num_processes()

    # the card's cases (tests/test_torch_gpu.py) run these ranks on cuda
    device = os.environ.get("ADAPM_TEST_DEVICE", "cpu")

    def setup(n, lens, **kw):
        return at.setup(n, lens, opts=at.SystemOptions(
            sync_max_per_sec=0, prefetch=False, **kw), device=device)

    if scenario == "pullpush":
        srv = setup(E_PP, 4, collective_sync=True, collective_bucket=8)
        assert type(srv.glob.coll._xchg).__name__ == "SlabExchange"
        w = srv.make_worker(0)
        keys = np.arange(E_PP, dtype=np.int64)
        base = _base(E_PP, 4)
        if rank == 0:
            w.wait(w.set(keys, base))
        srv.barrier()
        got = srv.collective_pull(keys)
        assert np.array_equal(got, base), f"rank {rank}: coll pull"
        # every rank adds its rank+1 everywhere through the exchange
        srv.collective_push(keys, np.full(base.size, rank + 1.0,
                                          np.float32))
        srv.barrier()
        after = srv.collective_pull(keys)
        # the RPC read path agrees (same owner state, other transport)
        rm = srv.read_main(keys)
        np.save(os.path.join(out, f"c{rank}.npy"), after)
        np.save(os.path.join(out, f"m{rank}.npy"), rm)
        srv.barrier()   # RPC reads done before the next exchange
        # an empty-keys join still participates
        srv.collective_pull(keys if rank == 0 else keys[:0])
        snap = srv.metrics_snapshot()
        np.save(os.path.join(out, f"s{rank}.npy"), np.array(
            [snap["collective"]["bsp_rounds"],
             snap["collective"]["bsp_iterations"],
             snap["collective"]["bsp_rows_out"],
             snap["collective"]["bsp_rows_in"],
             snap["collective"]["exchange_s"]["count"]], np.int64))
        srv.barrier()
        srv.shutdown()
    elif scenario == "eventual":
        tech, mode = MgmtTechniques(argv[2]), argv[3]
        srv = setup(K_EV, _lens(K_EV), techniques=tech,
                    collective_sync=mode == "coll", collective_bucket=8)
        per_rank, _ = _ev_draws(P)
        w = srv.make_worker(0)
        keys = np.arange(K_EV, dtype=np.int64)
        if rank == 0:
            w.wait(w.set(keys, _base(K_EV)))
        srv.barrier()
        # rank 1 claims a slice alone (relocations), then everyone
        # subscribes everywhere (replication pressure); every WaitSync
        # is reached by every rank (the collective contract)
        if rank == 1:
            w.intent(keys[:16], 0, CLOCK_MAX)
        srv.wait_sync()
        srv.barrier()
        w.intent(keys, 0, CLOCK_MAX)
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
        np.save(os.path.join(out, f"r{rank}.npy"), w.pull_sync(keys))
        np.save(os.path.join(out, f"m{rank}.npy"), srv.read_main(keys))
        np.save(os.path.join(out, f"pm{rank}.npy"), np.array(
            [srv.glob.stats["relocations_in"],
             srv.glob.stats["replicas_granted"],
             srv.glob.coll.stats["rows_out"] if srv.glob.coll else 0],
            np.int64))
        srv.barrier()
        srv.shutdown()
    elif scenario == "cadence":
        K = 4
        srv = setup(16, 4, collective_sync=True, collective_bucket=8,
                    collective_cadence=K)
        w = srv.make_worker(0)
        keys = np.arange(16, dtype=np.int64)
        k = keys[srv.glob.home_proc(keys) == 0][:1]
        if rank == 0:
            w.wait(w.set(k, np.full((1, 4), 1.0, np.float32)))
        srv.barrier()
        # every rank subscribes: owner-local interest forces REPLICATE
        w.intent(k, 0, CLOCK_MAX)
        srv.wait_sync()
        srv.barrier()
        if rank == 1:
            ok, v = w.pull_if_local(k)
            assert ok and float(np.ravel(v)[0]) == 1.0, \
                f"rank 1: replica not installed ({ok}, {v})"
        if rank == 0:
            w.wait(w.push(k, np.full((1, 4), 1.0, np.float32)))
        srv.barrier()  # the push is at the owner before clocks count
        seen_at = -1
        for step in range(4 * K):
            w.advance_clock()
            srv.sync.run_round()
            if rank == 1 and seen_at < 0:
                ok, v = w.pull_if_local(k)
                if ok and float(np.ravel(v)[0]) == 2.0:
                    seen_at = step
        srv.quiesce()
        srv.barrier()
        srv.quiesce()
        np.save(os.path.join(out, f"r{rank}.npy"), np.array(
            [seen_at, float(np.ravel(w.pull_sync(k))[0]),
             srv.glob.coll.stats["rounds"]], np.float64))
        srv.barrier()
        srv.shutdown()
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    print(f"MP-OK {scenario} rank={rank}", flush=True)


# ---------------------------------------------------------------------------
# the cases (pytest)
# ---------------------------------------------------------------------------


def run_mp(n, scenario, out, *args, timeout=120, device="cpu",
           script=None):
    """Launch `n` ranks of a scenario of `script` (this file) on
    `device`; assert all exit 0."""
    from adapm_tpu_torch import launcher
    env = dict(os.environ, ADAPM_TEST_DEVICE=device)
    env["PYTHONPATH"] = REPO
    env["TORCH_CPP_LOG_LEVEL"] = "ERROR"
    env["ADAPM_FAULT_T"] = str(max(timeout - 15, 20))
    coordinator = f"localhost:{launcher.free_port()}"
    cmd = [sys.executable, script or os.path.abspath(__file__), scenario,
           str(out), *map(str, args)]
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


@pytest.mark.parametrize("n", [2, 3])
def test_collective_pull_push_bitwise(tmp_path, n):
    run_mp(n, "pullpush", tmp_path)
    want = _base(E_PP, 4) + sum(r + 1.0 for r in range(n))
    for r in range(n):
        for tag in ("c", "m"):
            got = np.load(tmp_path / f"{tag}{r}.npy")
            assert got.tobytes() == want.astype(np.float32).tobytes(), \
                f"rank {r} ({tag}) differs from the shadow"
        rounds, iters, rows_out, rows_in, xchg = np.load(
            tmp_path / f"s{r}.npy")
        assert rounds == 4
        # bucket 8 over ~E/n remote keys: with two processes each round
        # takes past the JAX loop's 64-iteration bound
        assert iters > (4 * 64 if n == 2 else 64)
        assert rows_out > 0 and rows_in > 0
        assert xchg == 2 * iters        # X1 + X2 per iteration


def _eventual(tmp_path, n, tech, mode):
    d = tmp_path / mode
    d.mkdir()
    run_mp(n, "eventual", d, tech, mode)
    return [(np.load(d / f"r{r}.npy"), np.load(d / f"m{r}.npy"),
             np.load(d / f"pm{r}.npy")) for r in range(n)]


@pytest.mark.parametrize("n,tech", [(2, "all"), (2, "replication_only"),
                                    (2, "relocation_only"), (3, "all")])
def test_collective_eventual_bitwise_vs_shadow_and_rpc(tmp_path, n, tech):
    """Collective mode holds the quiesce invariant bitwise: after
    WaitSync -> Barrier -> WaitSync every rank reads the NumPy shadow
    of base + every push, and exactly what the RPC mode reads."""
    _, shadow = _ev_draws(n)
    coll = _eventual(tmp_path, n, tech, "coll")
    rpc = _eventual(tmp_path, n, tech, "rpc")
    moved = np.zeros(2, np.int64)
    for r in range(n):
        for got in (coll[r][0], coll[r][1]):
            assert got.tobytes() == shadow.tobytes(), \
                f"rank {r}: collective read differs from the shadow"
        assert coll[r][0].tobytes() == rpc[r][0].tobytes(), \
            f"rank {r}: collective and RPC modes differ"
        moved += coll[r][2][:2]
    if tech != "replication_only":
        assert moved[0] > 0, "no relocation happened"
    if tech != "relocation_only":
        assert moved[1] > 0, "no replication happened"
        assert sum(int(c[2][2]) for c in coll) > 0, \
            "no replica delta rode the exchange"


def test_collective_cadence_staleness_bound(tmp_path):
    """--sys.collective_cadence K: rank 1's replica observes rank 0's
    push within K+1 clock advances with no WaitSync in between."""
    run_mp(2, "cadence", tmp_path)
    seen_at, final, rounds = np.load(tmp_path / "r1.npy")
    assert 0 <= seen_at <= 4 + 1, f"observed at step {seen_at}"
    assert final == 2.0
    assert rounds >= 4     # cadence boundaries joined exchanges
    assert np.load(tmp_path / "r0.npy")[1] == 2.0


@pytest.mark.parametrize("rank,cards,want", [(1, 2, 1), (2, 2, 0),
                                             (3, 4, 3)])
def test_setup_makes_the_rank_card_current(monkeypatch, rank, cards, want):
    """On a launched run with several cards, setup() places rank r on
    card r % cards AND makes that card current: every kernel wrapper
    launches on the current device's stream, so a rank whose pools lie
    on another card would launch against foreign pointers."""
    import torch

    import adapm_tpu_torch
    from adapm_tpu_torch.parallel import control
    current = []
    monkeypatch.setattr(control, "init_from_env", lambda: True)
    monkeypatch.setattr(control, "num_processes", lambda: cards)
    monkeypatch.setattr(control, "process_id", lambda: rank)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: current.append(torch.device(d)))
    monkeypatch.setattr(adapm_tpu_torch, "Server",
                        lambda *a, ctx=None, **kw: ctx)
    ctx = adapm_tpu_torch.setup(16, 4)
    assert ctx.device == torch.device("cuda", want)
    assert current == [ctx.device]


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
