"""Server/Worker of the port (adapm_tpu_torch/core/kv.py) against the JAX
package's, scenario by scenario: the scenarios of test_kv_basic.py,
test_consistency.py and test_locality_api.py run on both packages with
the same seeds, op by op. Every read is compared bitwise, every op's
local/remote answer (ts == LOCAL) must agree, and owner, slot and
replica placement must match after every op."""
import numpy as np
import pytest

import adapm_tpu
import adapm_tpu_torch
from adapm_tpu.parallel.mesh import make_mesh
from adapm_tpu_torch.device.context import make_context

_MESHES = {}


def _mesh(n):
    if n not in _MESHES:
        _MESHES[n] = make_mesh(n)
    return _MESHES[n]


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


class Twin:
    """One JAX server and one port server built alike; `w(i, meth, ...)`
    runs a worker op on both and checks that they agree."""

    def __init__(self, num_keys, vlen, shards, num_workers=None,
                 techniques="all", **opts):
        jt = adapm_tpu.MgmtTechniques(techniques)
        tt = adapm_tpu_torch.MgmtTechniques(techniques)
        self.j = adapm_tpu.Server(
            num_keys, vlen, ctx=_mesh(shards), num_workers=num_workers,
            opts=adapm_tpu.SystemOptions(prefetch=False, techniques=jt,
                                         **opts))
        self.t = adapm_tpu_torch.Server(
            num_keys, vlen, ctx=make_context(shards, "cpu"),
            num_workers=num_workers,
            opts=adapm_tpu_torch.SystemOptions(prefetch=False,
                                               techniques=tt, **opts))
        self.wj, self.wt = [], []

    def workers(self, n):
        for i in range(n):
            self.wj.append(self.j.make_worker(i))
            self.wt.append(self.t.make_worker(i))
        return self

    def placement(self):
        for name in ("owner", "slot", "cache_slot", "replica_count"):
            np.testing.assert_array_equal(
                getattr(self.t.ab, name), getattr(self.j.ab, name),
                err_msg=f"addressbook {name} differs")

    def w(self, i, meth, *args):
        rj = getattr(self.wj[i], meth)(*args)
        rt = getattr(self.wt[i], meth)(*args)
        if meth in ("pull_sync", "wait") and rj is not None:
            assert np.array_equal(_bits(rj), _bits(rt)), f"{meth} differs"
        elif meth in ("push", "set", "pull"):
            assert (rj == adapm_tpu.LOCAL) == (rt == adapm_tpu.LOCAL), \
                f"{meth}: local answers differ"
        self.placement()
        return rj, rt

    def pull(self, i, keys):
        return self.w(i, "pull_sync", keys)[0]

    def s(self, meth, *args, **kw):
        getattr(self.j, meth)(*args, **kw)
        getattr(self.t, meth)(*args, **kw)
        self.placement()

    def rounds(self, **kw):
        self.j.sync.run_round(**kw)
        self.t.sync.run_round(**kw)
        self.placement()

    def tables(self):
        """Full main tables must agree bitwise."""
        for sj, st in zip(self.j.stores, self.t.stores):
            assert np.array_equal(_bits(np.asarray(sj.main)),
                                  _bits(st.main_host()))


# -- test_kv_basic scenarios ------------------------------------------------


def test_basic_push_pull_set_local_paths():
    tw = Twin(64, 4, 8).workers(2)
    np.testing.assert_allclose(tw.pull(0, np.arange(10)), 0.0)
    keys = np.array([1, 5, 9])
    tw.w(0, "wait", tw.w(0, "push", keys,
                         np.arange(12, dtype=np.float32).reshape(3, 4))[0])
    for _ in range(5):
        tw.w(0, "push", np.array([3]), np.ones((1, 4), np.float32))
    tw.w(0, "push", np.array([7, 7]), np.ones((2, 4), np.float32))
    tw.w(0, "push", np.array([2]), np.full((1, 4), 5.0, np.float32))
    tw.w(0, "set", np.array([2]), np.full((1, 4), 1.5, np.float32))
    tw.w(0, "push", np.array([2]), np.ones((1, 4), np.float32))
    tw.w(0, "push", np.array([4, 6]), np.arange(8, dtype=np.float32))
    got = tw.pull(0, np.array([1, 5, 9, 3, 7, 2, 4, 6]))
    np.testing.assert_allclose(got[:, 0], [0, 4, 8, 5, 2, 2.5, 0, 4])
    # owned keys answer locally (ts == LOCAL) on both
    tw.w(0, "pull", np.array([0, 8, 16]))
    tw.w(0, "push", np.array([0, 8, 16]), np.ones((3, 4), np.float32))
    tw.w(1, "pull", np.array([1, 2]))
    rj, rt = tw.w(0, "pull_if_local", np.array([0, 8]))
    assert rj[0] and rt[0] and np.array_equal(_bits(rj[1]), _bits(rt[1]))
    tw.tables()


def test_basic_concurrent_pushes_and_per_key_lengths():
    tw = Twin(64, 4, 8, num_workers=8).workers(8)
    for _ in range(3):
        for i in range(8):
            tw.w(i, "push", np.array([13]), np.ones((1, 4), np.float32))
    for i in range(8):
        tw.wj[i].wait_all()
        tw.wt[i].wait_all()
    tw.s("barrier")
    for i in range(8):
        np.testing.assert_allclose(tw.pull(i, [13]), 24.0)
    lens = np.array([2, 3, 2, 3, 1])
    tw2 = Twin(5, lens, 8).workers(1)
    tw2.w(0, "push", np.array([0, 1, 4]),
          np.array([1, 1, 2, 2, 2, 3], dtype=np.float32))
    got = tw2.pull(0, np.array([0, 1, 4]))
    np.testing.assert_allclose(got, [1, 1, 2, 2, 2, 3])


def test_basic_optimistic_plan_revalidation():
    tw = Twin(64, 4, 8).workers(2)
    key = np.array([3], dtype=np.int64)
    tw.w(0, "set", key, np.full((1, 4), 7.0, np.float32))
    for srv in (tw.j, tw.t):
        orig = srv._plan_pull
        calls = {"n": 0}

        def racy(keys, shard, srv=srv, orig=orig, calls=calls):
            plan = orig(keys, shard)
            if calls["n"] == 0:
                # the planner moves the key after the plan was taken
                srv._relocate([(int(key[0]), (shard + 1) % srv.num_shards)])
            calls["n"] += 1
            return plan

        srv._plan_pull = racy
    got = tw.pull(0, key)
    np.testing.assert_allclose(got, 7.0)
    tw.w(1, "push", key, np.ones((1, 4), np.float32))
    np.testing.assert_allclose(tw.pull(1, key), 8.0)


# -- test_consistency scenarios ----------------------------------------------

TECHS = ["all", "replication_only", "relocation_only"]
NK, VL = 48, 2


@pytest.mark.parametrize("tech", TECHS)
def test_consistency_storms(tech):
    """Pull+intent storm, monotonic pushes and push/revert storms on both
    packages (test_consistency.py phases 1-3), op by op."""
    tw = Twin(NK, VL, 4, num_workers=4, techniques=tech,
              sync_max_per_sec=0).workers(4)
    rng = np.random.default_rng(0)
    for it in range(12):
        i = it % 4
        keys = rng.choice(NK, size=rng.integers(1, 8), replace=False)
        c = tw.wj[i].current_clock
        tw.w(i, "intent", keys, c, c + 3)
        np.testing.assert_allclose(tw.pull(i, keys), 0.0)
        tw.w(i, "advance_clock")
        if it % 3 == 0:
            tw.rounds(all_channels=True)
    key = np.array([17])
    for it in range(20):
        i = int(rng.integers(4))
        tw.w(i, "push", key, np.full(VL, float(rng.integers(1, 3)),
                                     np.float32))
        if rng.random() < 0.3:
            c = tw.wj[i].current_clock
            tw.w(i, "intent", key, c, c + 2)
        if rng.random() < 0.4:
            tw.rounds(all_channels=True)
        tw.pull(i, key)
        if rng.random() < 0.2:
            tw.w(i, "advance_clock")
    # phase 3 starts from a flushed table (its own server in
    # test_consistency.py): no replica delta may outlive the set
    tw.s("quiesce")
    base = rng.normal(size=(NK, VL)).astype(np.float32)
    tw.w(0, "set", np.arange(NK), base)
    tw.s("quiesce")
    for it in range(12):
        i, i2 = int(rng.integers(4)), int(rng.integers(4))
        k = rng.choice(NK, size=4, replace=False)
        d = rng.normal(size=(4, VL)).astype(np.float32)
        c = tw.wj[i].current_clock
        tw.w(i, "intent", k, c, c + 2)
        tw.w(i, "push", k, d)
        tw.w(i2, "push", k, -d)
        if it % 4 == 0:
            tw.rounds(all_channels=True)
        tw.w(i, "advance_clock")
    tw.s("quiesce")
    for i in range(4):
        np.testing.assert_allclose(tw.pull(i, np.arange(NK)), base,
                                   atol=1e-4)
    tw.tables()


def test_consistency_relocation_preserves_value():
    tw = Twin(NK, VL, 4, num_workers=4, techniques="relocation_only",
              sync_max_per_sec=0).workers(4)
    key = np.array([5])
    for it in range(12):
        i = it % 4
        c = tw.wj[i].current_clock
        tw.w(i, "intent", key, c, c + 1)
        tw.rounds(force_intents=True, all_channels=True)
        tw.w(i, "push", key, np.ones(VL, np.float32))
        tw.w(i, "advance_clock")
    tw.s("quiesce")
    for i in range(4):
        np.testing.assert_allclose(tw.pull(i, key), 12.0)


# -- test_locality_api scenarios ---------------------------------------------


def test_locality_relocate_replicate_expire_flush():
    tw = Twin(30, 2, 3, num_workers=3).workers(3)
    for k in range(9):
        assert tw.t.ab.owner[k] == k % 3
    tw.w(1, "pull", np.array([1, 4, 7]))
    tw.w(1, "push", np.array([1]), np.ones(2, np.float32))
    tw.w(0, "intent", [4], 0, 10)
    tw.w(0, "wait_sync")
    assert tw.t.ab.owner[4] == 0
    tw.w(0, "intent", [5], 0, 100)
    tw.w(0, "wait_sync")
    tw.w(1, "intent", [5], 0, 100)
    tw.w(1, "wait_sync")
    assert tw.t.ab.owner[5] == 0
    assert list(tw.t.ab.replica_shards(5)) == [1]
    tw.w(0, "pull", np.array([5]))
    tw.w(1, "pull", np.array([5]))
    tw.w(0, "intent", [8], 0, 3)
    tw.w(2, "intent", [8], 0, 3)
    tw.s("wait_sync")
    assert tw.t.ab.replica_count[8] == 1
    tw.w(0, "push", [8], np.full(2, 7.0, np.float32))
    for _ in range(5):
        for i in range(3):
            tw.w(i, "advance_clock")
    tw.s("wait_sync")
    assert tw.t.ab.replica_count[8] == 0
    np.testing.assert_allclose(tw.pull(2, [8]), 7.0)
    tw.tables()


@pytest.mark.parametrize("tech", ["replication_only", "relocation_only"])
def test_locality_techniques(tech):
    tw = Twin(30, 2, 3, num_workers=3, techniques=tech).workers(3)
    tw.w(0, "intent", [4], 0, 10)
    tw.w(0, "wait_sync")
    tw.w(0, "intent", [5], 0, 100)
    tw.w(0, "wait_sync")
    tw.w(1, "intent", [5], 0, 100)
    tw.w(1, "wait_sync")
    if tech == "replication_only":
        assert tw.t.ab.owner[4] == 1 and list(tw.t.ab.replica_shards(4)) \
            == [0]
    else:
        assert tw.t.ab.owner[5] == 1
        assert len(tw.t.ab.replica_shards(5)) == 0


def test_locality_future_intent_not_acted_early():
    tw = Twin(30, 2, 3, num_workers=3).workers(3)
    tw.w(0, "intent", [7], 1000, 1010)
    tw.rounds(all_channels=True)
    assert tw.t.ab.owner[7] == 1
    for _ in range(999):
        tw.wj[0].advance_clock()
        tw.wt[0].advance_clock()
    tw.rounds(all_channels=True)
    assert tw.t.ab.is_local(np.array([7]), 0).all()


def test_unported_planes_raise_naming_roadmap_item():
    """The lock-order sentinel (ROADMAP A12) still raises, naming its
    item; a stream knob, whose plane is ported now, builds the plane."""
    with pytest.raises(NotImplementedError, match="item 12"):
        adapm_tpu_torch.Server(
            8, 2, ctx=make_context(2, "cpu"),
            opts=adapm_tpu_torch.SystemOptions(lint_lockorder=True))
    srv = adapm_tpu_torch.Server(
        8, 2, ctx=make_context(2, "cpu"),
        opts=adapm_tpu_torch.SystemOptions(stream_batch=8))
    try:
        assert srv.stream is not None and srv.stream.freshness is None
        assert srv.metrics_snapshot()["stream"]["cursor"] == 0
    finally:
        srv.shutdown()


def _constant_policy(path):
    from adapm_tpu_torch.policy import PLANE_FEATURES, PlaneModel
    from adapm_tpu_torch.policy.model import PolicyBundle
    PolicyBundle({}, {p: PlaneModel.constant(p, 0.1)
                      for p in PLANE_FEATURES}).save(str(path))
    return str(path)


def test_ported_planes_build(tmp_path):
    """The fault plane, periodic checkpoints, flight tracing, crash
    dumps, the metrics reporter, workload and decision trace capture and
    the learned policy plane build on the port's Server (each was
    refused before it was ported) and go down with it."""
    opts = adapm_tpu_torch.SystemOptions(
        sync_max_per_sec=0, fault_spec="sync.round=0.5", fault_seed=1,
        ckpt_every_s=60.0, ckpt_path=str(tmp_path / "chain"),
        trace_flight=True, crash_dumps=True, metrics_report_s=30.0,
        stats_out=str(tmp_path),
        trace_workload=str(tmp_path / "run.wtrace"),
        trace_decisions=str(tmp_path / "run.dtrace"),
        policy_file=_constant_policy(tmp_path / "policy.json"))
    srv = adapm_tpu_torch.Server(8, 2, ctx=make_context(2, "cpu"),
                                 opts=opts)
    assert srv.fault is not None and srv.ckpt is not None
    assert srv.flight is not None and srv.flight_recorder is not None
    assert srv.crash_dump_path is not None and srv._reporter is not None
    assert srv.wtrace is not None and srv.decisions is not None
    assert srv.policy is not None
    srv.shutdown()
    assert srv._reporter is None
    assert (tmp_path / "flight.0.trace.json").exists()
    assert (tmp_path / "run.wtrace").exists()
    assert (tmp_path / "run.dtrace").exists()


def test_trace_and_policy_planes_off_by_default():
    """With none of the three knobs, the Server's wtrace, decisions and
    policy are None, and the registry holds no wtrace.*, decision.* or
    policy.* name."""
    srv = adapm_tpu_torch.Server(8, 2, ctx=make_context(2, "cpu"),
                                 opts=adapm_tpu_torch.SystemOptions(
                                     sync_max_per_sec=0))
    w = srv.make_worker(0)
    w.wait(w.set(np.arange(8), np.ones((8, 2), np.float32)))
    w.intent(np.arange(4), 0, 4)
    w.pull_sync(np.arange(8))
    srv.wait_sync()
    assert srv.wtrace is None and srv.decisions is None
    assert srv.policy is None and srv.replay_stats is None
    assert not [n for n in srv.obs.names() if n.split(".")[0] in
                ("wtrace", "decision", "policy")]
    snap = srv.metrics_snapshot()
    for sec in ("wtrace", "replay", "decision", "policy"):
        assert snap[sec] == {}, sec
    srv.shutdown()
