"""The PM core's remaining parity scenarios on the port: the 3 scenarios
of tests/test_set_operation.py, the 5 of tests/test_replica_table.py
(the ReplicaTable property tests and the dirty-filtered sync's
bit-identity to full sync) and the 5 of tests/test_misc_api.py
(StaggeredPush, BeginSetup/EndSetup, PullIfLocal, the worker barrier).

Each scenario runs on both packages with the same seeds and shard
counts (`make_mesh(S)` beside `make_context(S, "cpu")`), keeps the JAX
test's own checks on each, and returns what it observed: every read
(compared bitwise), the planner counters and the placement tables
(compared exactly)."""
import threading
import time

import numpy as np
import pytest

import adapm_tpu
import adapm_tpu_torch
from adapm_tpu.parallel.mesh import make_mesh
from adapm_tpu_torch.device.context import make_context

_MESH = {}

NK = 48
VL = 3


class Pkg:
    """One package's Server, options and S-shard context."""

    def __init__(self, mod, shards):
        self.mod = mod
        self.is_jax = mod is adapm_tpu
        if self.is_jax:
            if shards not in _MESH:
                _MESH[shards] = make_mesh(shards)
            self.ctx = _MESH[shards]
        else:
            self.ctx = make_context(shards, "cpu")
        sync = __import__(f"{mod.__name__}.core.sync", fromlist=["x"])
        self.ReplicaTable = sync.ReplicaTable
        self.key_channel = sync.key_channel
        self.MgmtTechniques = mod.MgmtTechniques
        self.CLOCK_MAX = mod.CLOCK_MAX

    def server(self, num_keys, vlen, opts=None, **kw):
        return self.mod.Server(num_keys, vlen, ctx=self.ctx,
                               opts=opts or self.mod.SystemOptions(), **kw)

    def opts(self, **kw):
        return self.mod.SystemOptions(**kw)


def _placement(s):
    return {n: np.array(getattr(s.ab, n))
            for n in ("owner", "slot", "cache_slot")}


def _sync_counts(s):
    st = s.sync.stats
    return {f: int(getattr(st, f)) for f in (
        "rounds", "replicas_created", "replicas_dropped", "relocations",
        "keys_synced", "keys_considered", "intents_processed")}


# -- tests/test_set_operation.py --------------------------------------------


def set_then_push_orders(P):
    s = P.server(16, 2, num_workers=4)
    ws = [s.make_worker(i) for i in range(4)]
    k = np.array([6])
    ws[0].wait(ws[0].push(k, np.full(2, 10.0, np.float32)))
    ws[1].wait(ws[1].set(k, np.full(2, 3.0, np.float32)))
    ws[2].wait(ws[2].push(k, np.full(2, 2.0, np.float32)))
    s.quiesce()
    reads = [w.pull_sync(k) for w in ws]
    for r in reads:
        np.testing.assert_allclose(r, 5.0)
    out = {"reads": reads, "placement": _placement(s)}
    s.shutdown()
    return out


def set_visible_through_replicas(P):
    s = P.server(16, 2, num_workers=4, opts=P.opts(sync_max_per_sec=0))
    ws = [s.make_worker(i) for i in range(4)]
    k = np.array([9])  # home shard 1
    ws[0].intent(k, 0, 100)
    ws[1].intent(k, 0, 100)
    s.wait_sync()
    assert s.ab.has_replica(k, 0).all() or s.ab.owner[9] == 0
    ws[1].wait(ws[1].set(k, np.full(2, 42.0, np.float32)))
    s.quiesce()
    reads = [ws[0].pull_sync(k), ws[1].pull_sync(k)]
    for r in reads:
        np.testing.assert_allclose(r, 42.0)
    out = {"reads": reads, "placement": _placement(s),
           "counts": _sync_counts(s)}
    s.shutdown()
    return out


def set_on_replica_holder_clears_pending_delta(P):
    s = P.server(16, 2, num_workers=4, opts=P.opts(sync_max_per_sec=0))
    ws = [s.make_worker(i) for i in range(4)]
    k = np.array([9])
    ws[0].intent(k, 0, 100)
    ws[1].intent(k, 0, 100)
    s.wait_sync()
    ws[0].push(k, np.full(2, 5.0, np.float32))  # pending in replica delta
    ws[0].wait_all()
    ws[0].wait(ws[0].set(k, np.full(2, 1.0, np.float32)))
    s.quiesce()
    reads = [w.pull_sync(k) for w in ws]
    for r in reads:
        np.testing.assert_allclose(r, 1.0)
    out = {"reads": reads, "placement": _placement(s),
           "counts": _sync_counts(s)}
    s.shutdown()
    return out


# -- tests/test_replica_table.py --------------------------------------------


def _pairs(keys, shards):
    return {(int(k), int(s)) for k, s in zip(keys, shards)}


def replica_table_matches_shadow_set(P):
    rng = np.random.default_rng(0)
    S, K = 4, 200
    t = P.ReplicaTable(S, K)
    shadow = set()
    answers = []
    for step in range(400):
        n = int(rng.integers(1, 16))
        keys = rng.integers(0, K, size=n)
        shards = rng.integers(0, S, size=n)
        op = rng.random()
        if op < 0.5:
            added = t.add(keys, shards)
            fresh = _pairs(keys, shards) - shadow
            assert added == len(fresh)
            shadow |= fresh
            answers.append(added)
        elif op < 0.85:
            removed = t.remove(keys, shards)
            gone = _pairs(keys, shards) & shadow
            assert removed == len(gone)
            shadow -= gone
            answers.append(removed)
        else:
            got = t.contains(keys, shards)
            assert got.tolist() == [(int(k), int(s)) in shadow
                                    for k, s in zip(keys, shards)]
            answers.append(got.tolist())
        assert len(t) == len(shadow)
    k, s = t.snapshot()
    assert _pairs(k, s) == shadow
    return {"reads": [], "answers": answers,
            "snapshot": (np.array(k).tolist(), np.array(s).tolist())}


def replica_table_scalar_shard_and_growth(P):
    t = P.ReplicaTable(2, 5000)
    keys = np.arange(4000, dtype=np.int64)  # forces column growth
    assert t.add(keys, 1) == 4000
    assert t.contains(keys, 1).all()
    assert not t.contains(keys, 0).any()
    assert t.remove(keys[::2], 1) == 2000
    assert len(t) == 2000
    top = t._top
    assert t.add(keys[::2], 0) == 2000
    assert t._top == top  # free-list reuse
    k, s = t.snapshot()
    assert len(k) == 4000 and (np.sort(k[s == 0]) == keys[::2]).all()
    return {"reads": [], "snapshot": (np.array(k).tolist(),
                                      np.array(s).tolist())}


def replica_tables_shared_lookup_interleaved_channels(P):
    rng = np.random.default_rng(0)
    S, K, C = 4, 256, 4
    row = np.full((S, K), -1, dtype=np.int32)
    tables = [P.ReplicaTable(S, K, row_lookup=row) for _ in range(C)]
    shadows = [set() for _ in range(C)]
    for _ in range(300):
        n = int(rng.integers(1, 24))
        keys = rng.integers(0, K, size=n).astype(np.int64)
        shards = rng.integers(0, S, size=n)
        ch = P.key_channel(keys, C)
        add = rng.random() < 0.6
        for c in np.unique(ch):
            m = ch == c
            if add:
                shadows[c] |= _pairs(keys[m], shards[m])
                tables[c].add(keys[m], shards[m])
            else:
                shadows[c] -= _pairs(keys[m], shards[m])
                tables[c].remove(keys[m], shards[m])
    snaps = []
    for c in range(C):
        k, s = tables[c].snapshot()
        assert _pairs(k, s) == shadows[c], f"channel {c} diverged"
        snaps.append((np.array(k).tolist(), np.array(s).tolist()))
    return {"reads": [], "snapshot": snaps, "row": row.tolist()}


def _storm(P, dirty_only: bool):
    """Deterministic push/intent/round storm: every intermediate read,
    the post-quiesce state and the ship/consider counters."""
    s = P.server(NK, VL, num_workers=4, opts=P.opts(
        sync_max_per_sec=0, prefetch=False, sync_dirty_only=dirty_only))
    ws = [s.make_worker(i) for i in range(4)]
    rng = np.random.default_rng(11)
    base = rng.normal(size=(NK, VL)).astype(np.float32)
    ws[0].wait(ws[0].set(np.arange(NK), base))
    expected = base.copy()
    reads = []
    for it in range(40):
        w = ws[int(rng.integers(4))]
        k = np.unique(rng.choice(NK, size=6, replace=False))
        if rng.random() < 0.6:
            w.intent(k, w.current_clock, w.current_clock + 3)
        d = rng.normal(size=(len(k), VL)).astype(np.float32)
        w.push(k, d)
        expected[k] += d
        if rng.random() < 0.5:
            s.sync.run_round(all_channels=(it % 3 == 0))
        if rng.random() < 0.4:
            w.advance_clock()
        reads.append(w.pull_sync(np.arange(NK)).copy())
    for w in ws:
        w.wait_all()
    s.quiesce()
    final = np.stack([w.pull_sync(np.arange(NK)) for w in ws])
    mains = s.read_main(np.arange(NK)).reshape(NK, VL).copy()
    stats = (s.sync.stats.keys_synced, s.sync.stats.keys_considered)
    s.shutdown()
    return reads, final, mains, stats, expected


def dirty_filtered_sync_bit_identical_to_full(P):
    reads_f, final_f, mains_f, (ship_f, cons_f), expected = \
        _storm(P, dirty_only=False)
    reads_d, final_d, mains_d, (ship_d, cons_d), _ = \
        _storm(P, dirty_only=True)
    for i, (a, b) in enumerate(zip(reads_f, reads_d)):
        assert np.array_equal(a, b), f"read {i} diverged under the filter"
    assert np.array_equal(final_f, final_d)
    assert np.array_equal(mains_f, mains_d)
    assert np.array_equal(final_d[0], final_d[1])
    np.testing.assert_allclose(mains_d, expected, atol=1e-4)
    assert ship_f == cons_f
    assert cons_d == cons_f
    assert ship_d < ship_f, (ship_d, ship_f)
    return {"reads": reads_d + [final_d, mains_d],
            "counts": (ship_f, cons_f, ship_d, cons_d)}


def dirty_filter_skips_clean_rounds(P):
    s = P.server(NK, VL, num_workers=2, opts=P.opts(
        techniques=P.MgmtTechniques.REPLICATION_ONLY, sync_max_per_sec=0,
        prefetch=False, cache_slots_per_shard=NK))
    w0, w1 = s.make_worker(0), s.make_worker(1)
    w0.wait(w0.set(np.arange(NK), np.ones((NK, VL), np.float32)))
    remote = np.arange(NK)[s.ab.owner[: NK] != w1.shard]
    w1.intent(remote, 0, 10_000)
    s.wait_sync()
    assert (s.ab.cache_slot[w1.shard, remote] >= 0).all()
    before = s.sync.stats.keys_synced
    for _ in range(8):
        s.sync.run_round(all_channels=True)
    assert s.sync.stats.keys_synced == before, "idle replicas re-shipped"
    assert s.sync.stats.keys_considered > 0
    w1.push(remote[:4], np.full((4, VL), 2.0, np.float32))
    s.sync.run_round(all_channels=True)
    assert s.sync.stats.keys_synced == before + 4
    got = s.read_main(remote[:4]).reshape(4, VL)
    assert np.allclose(got, 3.0)
    out = {"reads": [got], "counts": _sync_counts(s),
           "placement": _placement(s)}
    s.shutdown()
    return out


# -- tests/test_misc_api.py -------------------------------------------------


def staggered_push(P):
    s = P.server(40, 4, opts=P.opts(sync_max_per_sec=0))
    w = s.make_worker(0)
    keys = np.arange(40)
    w.staggered_push(keys, np.ones((40, 4), np.float32), group_size=7)
    w.wait_all()
    reads = [w.pull_sync(keys)]
    assert np.allclose(reads[0], 1.0)
    w.staggered_push(keys, np.ones(160, np.float32) * 2, group_size=11)
    w.wait_all()
    reads.append(w.pull_sync(keys))
    assert np.allclose(reads[1], 3.0)
    out = {"reads": reads, "stats": dict(w.stats)}
    s.shutdown()
    return out


def begin_setup_pauses_management(P):
    s = P.server(32, 4, opts=P.opts(sync_max_per_sec=0))
    w = s.make_worker(0)
    w.begin_setup()
    remote = np.array([k for k in range(32) if s.ab.owner[k] != w.shard])
    w.intent(remote[:4], 0, P.CLOCK_MAX)
    s.sync.run_round(all_channels=True)
    assert s.sync.stats.intents_processed == 0, \
        "management must pause during setup"
    w.end_setup()
    s.wait_sync()
    assert s.sync.stats.intents_processed > 0, \
        "management must resume after setup"
    assert s.ab.is_local(remote[:4], w.shard).all()
    out = {"reads": [], "counts": _sync_counts(s),
           "placement": _placement(s)}
    s.shutdown()
    return out


def pull_if_local(P):
    s = P.server(16, 2, opts=P.opts(sync_max_per_sec=0))
    w = s.make_worker(0)
    w.wait(w.set(np.arange(16), np.arange(32, dtype=np.float32)))
    local_keys = np.array([k for k in range(16) if s.ab.owner[k] == w.shard])
    ok, vals = w.pull_if_local(local_keys)
    assert ok and vals is not None
    reads = [vals]
    remote = np.array([k for k in range(16) if s.ab.owner[k] != w.shard])
    if len(remote):
        ok2, vals2 = w.pull_if_local(remote[:1])
        assert not ok2 and vals2 is None
    out = {"reads": reads}
    s.shutdown()
    return out


def worker_barrier_rendezvous(P):
    s = P.server(8, 2, num_workers=3, opts=P.opts(sync_max_per_sec=0))
    ws = [s.make_worker(i) for i in range(3)]
    arrived, passed, bad = [], [], []
    lock = threading.Lock()

    def run(i):
        if i == 2:
            time.sleep(0.2)  # the last worker is late
        with lock:
            arrived.append(i)
        ws[i].barrier()
        with lock:
            if len(arrived) != 3:
                bad.append(i)
            passed.append(i)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not bad, "a worker passed the barrier before all arrived"
    assert sorted(passed) == [0, 1, 2]
    s.shutdown()
    return {"reads": [], "passed": sorted(passed)}


def worker_barrier_excludes_finalized(P):
    s = P.server(8, 2, num_workers=2, opts=P.opts(sync_max_per_sec=0))
    w0, w1 = s.make_worker(0), s.make_worker(1)
    done = threading.Event()

    def waiter():
        w0.barrier()
        done.set()

    t = threading.Thread(target=waiter)
    t.start()
    held = not done.wait(0.2)
    assert held, "barrier must hold until w1 acts"
    w1.finalize()
    assert done.wait(5.0), "finalize must release the barrier"
    t.join()
    s.shutdown()
    return {"reads": [], "held": held}


SCENARIOS = [
    (set_then_push_orders, 4), (set_visible_through_replicas, 4),
    (set_on_replica_holder_clears_pending_delta, 4),
    (replica_table_matches_shadow_set, 4),
    (replica_table_scalar_shard_and_growth, 4),
    (replica_tables_shared_lookup_interleaved_channels, 4),
    (dirty_filtered_sync_bit_identical_to_full, 4),
    (dirty_filter_skips_clean_rounds, 4),
    (staggered_push, 8), (begin_setup_pauses_management, 8),
    (pull_if_local, 8), (worker_barrier_rendezvous, 8),
    (worker_barrier_excludes_finalized, 8)]


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("fn,shards", SCENARIOS,
                         ids=[f.__name__ for f, _ in SCENARIOS])
def test_core_scenario_matches_jax(fn, shards):
    rj = fn(Pkg(adapm_tpu, shards))
    rt = fn(Pkg(adapm_tpu_torch, shards))
    assert set(rj) == set(rt)
    assert len(rj["reads"]) == len(rt["reads"])
    for i, (a, b) in enumerate(zip(rj["reads"], rt["reads"])):
        assert np.array_equal(_bits(a), _bits(b)), f"read {i} differs"
    for k in rj:
        if k in ("reads", "placement"):
            continue
        assert rj[k] == rt[k], f"{k} differs"
    if "placement" in rj:
        for n in rj["placement"]:
            np.testing.assert_array_equal(rt["placement"][n],
                                          rj["placement"][n])
