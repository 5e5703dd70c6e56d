"""The intent-driven prefetch pipeline of the port (core/intent.py
PrefetchScheduler, core/store.py StagingPool, ops/fused.py StagedKeys)
against the JAX package's, scenario by scenario.

The 18 single-process scenarios of tests/test_prefetch.py run on both
packages (8 shards: `make_mesh(8)` beside `make_context(8, "cpu")`) with
the same seeds. Each scenario keeps the JAX test's own checks, run on
each package, and returns what it observed: every read (compared
bitwise), the `prefetch.report()` counters after `flush()` and the
placement tables (compared exactly). The fused-step scenarios' losses
and trained rows are model math, held to rtol 1e-5 / atol 1e-6 across
packages (bitwise within each). The nineteenth JAX scenario,
`test_control_payload_framing`, tests `parallel/control.py`: its twin
is in tests/test_torch_launcher.py, with the port's control plane.
"""
import argparse

import numpy as np
import pytest

import adapm_tpu
import adapm_tpu_torch
from adapm_tpu.parallel.mesh import make_mesh
from adapm_tpu_torch.device.context import make_context

_MESH = {}


class Pkg:
    """The pieces of one package a scenario needs."""

    def __init__(self, mod):
        self.mod = mod
        self.is_jax = mod is adapm_tpu
        self.SystemOptions = mod.SystemOptions
        if self.is_jax:
            if "m" not in _MESH:
                _MESH["m"] = make_mesh(8)
            self.ctx = _MESH["m"]
        else:
            self.ctx = make_context(8, "cpu")
        models = __import__(f"{mod.__name__}.models", fromlist=["x"])
        ops = __import__(f"{mod.__name__}.ops", fromlist=["x"])
        self.make_kge_loss = models.make_kge_loss
        self.DeviceRoutedRunner = ops.DeviceRoutedRunner
        self.FusedStepRunner = ops.FusedStepRunner

    def server(self, num_keys=64, vlen=4, opts=None, **kw):
        opts = opts or self.SystemOptions(prefetch_pull="always")
        return self.mod.Server(num_keys, vlen, opts=opts, ctx=self.ctx,
                               **kw)

    def opts(self, **kw):
        return self.SystemOptions(**kw)


def _seed(w, keys, base=0.0):
    vals = (np.arange(len(keys) * 4, dtype=np.float32)
            .reshape(len(keys), 4) + base)
    w.wait(w.set(keys, vals))
    return vals


def _stage(s, w, keys, horizon=50):
    """Declare intent for `keys` now and wait for the pipeline to stage."""
    w.intent(keys, w.current_clock, w.current_clock + horizon)
    s.prefetch.flush()


def _report(s):
    s.prefetch.flush()
    return {k: int(v) for k, v in s.prefetch.report().items()}


def _placement(s):
    return {n: np.array(getattr(s.ab, n))
            for n in ("owner", "slot", "cache_slot")}


# -- the scenarios: each returns {"reads": [...], "counters": {...}, ...} --


def sc_staged_pull_bit_identical(P):
    s = P.server()
    w = s.make_worker(0)
    keys = np.unique(np.array([1, 5, 9, 17, 33]))
    vals = _seed(w, keys)
    _stage(s, w, keys)
    assert s.prefetch.report()["live"] == 1
    got = w.pull_sync(keys)
    assert s.prefetch.stats["hits"] == 1
    assert (got == vals).all()
    again = w.pull_sync(keys)
    assert (again == vals).all()
    out = {"reads": [got, again], "counters": _report(s)}
    s.shutdown()
    return out


def sc_read_your_writes_through_staged(P):
    s = P.server()
    w = s.make_worker(0)
    keys = np.unique(np.array([2, 10, 18]))
    vals = _seed(w, keys)
    _stage(s, w, keys)
    w.wait(w.push(keys, np.ones((3, 4), np.float32)))
    assert s.prefetch.stats["invalidated_write"] >= 1
    s.prefetch.flush()
    got = w.pull_sync(keys)
    assert (got == vals + 1.0).all()
    out = {"reads": [got], "counters": _report(s)}
    s.shutdown()
    return out


def sc_set_invalidates_staged(P):
    s = P.server()
    w = s.make_worker(0)
    keys = np.unique(np.array([3, 11]))
    _seed(w, keys)
    _stage(s, w, keys)
    new = np.full((2, 4), 7.5, np.float32)
    w.wait(w.set(keys, new))
    s.prefetch.flush()
    got = w.pull_sync(keys)
    assert (got == new).all()
    out = {"reads": [got], "counters": _report(s)}
    s.shutdown()
    return out


def sc_disjoint_write_keeps_staged(P):
    s = P.server()
    w = s.make_worker(0)
    keys = np.unique(np.array([4, 12]))
    vals = _seed(w, keys)
    _stage(s, w, keys)
    w.wait(w.push(np.array([40, 48]), np.ones((2, 4), np.float32)))
    assert s.prefetch.report()["live"] == 1
    got = w.pull_sync(keys)
    assert (got == vals).all()
    assert s.prefetch.stats["hits"] == 1
    out = {"reads": [got], "counters": _report(s)}
    s.shutdown()
    return out


def sc_relocation_between_stage_and_pull(P):
    s = P.server()
    w = s.make_worker(0)
    keys = np.unique(np.array([1, 9, 25]))  # home shard 1
    vals = _seed(w, keys)
    _stage(s, w, keys)
    assert s.prefetch.report()["live"] == 1
    assert s._relocate_to(keys, 3) == len(keys)
    got = w.pull_sync(keys)
    assert (got == vals).all()
    assert s.prefetch.stats["invalidated_topology"] >= 1
    assert s.prefetch.stats["hits"] == 0
    out = {"reads": [got], "counters": _report(s),
           "placement": _placement(s)}
    s.shutdown()
    return out


def sc_plan_cache_hits_and_topology_invalidation(P):
    s = P.server()
    w = s.make_worker(0)
    keys = np.unique(np.array([6, 14, 22]))
    vals = _seed(w, keys)
    h0 = s._plan_cache.hits
    reads = [w.pull_sync(keys), w.pull_sync(keys)]
    assert all((r == vals).all() for r in reads)
    assert s._plan_cache.hits > h0
    st0 = s._plan_cache.stale
    s._relocate_to(keys, 5)
    reads.append(w.pull_sync(keys))
    assert (reads[-1] == vals).all()
    assert s._plan_cache.stale > st0
    out = {"reads": reads, "counters": _report(s),
           "plan_cache": s._plan_cache.stats()}
    s.shutdown()
    return out


def sc_plan_cache_push_routes(P):
    s = P.server()
    w = s.make_worker(0)
    keys = np.unique(np.array([7, 15]))
    _seed(w, keys, base=0.0)
    one = np.ones((2, 4), np.float32)
    for _ in range(3):
        w.wait(w.push(keys, one))
    expect = np.arange(8, dtype=np.float32).reshape(2, 4) + 3.0
    got = w.pull_sync(keys)
    assert (got == expect).all()
    out = {"reads": [got], "counters": _report(s),
           "plan_cache": s._plan_cache.stats()}
    s.shutdown()
    return out


def sc_plan_cache_collision_is_exact(P):
    s = P.server()
    w = s.make_worker(0)
    a = np.unique(np.array([8, 16, 24]))
    b = np.unique(np.array([9, 17, 25]))
    va = _seed(w, a, base=0.0)
    vb = _seed(w, b, base=100.0)
    reads = []
    for _ in range(2):
        reads += [w.pull_sync(a), w.pull_sync(b)]
        assert (reads[-2] == va).all() and (reads[-1] == vb).all()
    out = {"reads": reads, "counters": _report(s)}
    s.shutdown()
    return out


def sc_topology_mutation_discipline(P):
    s = P.server()
    with s._lock:
        with s._topology_mutation():
            cs = s.ab.add_replicas(np.array([1]), 0)  # paired: fine
            assert len(cs) == 1
        v = s.topology_version
        s.ab.add_replicas(np.array([2]), 0)  # unpaired mutation
        with pytest.raises(AssertionError, match="outside"):
            with s._topology_mutation():
                pass
        assert s.topology_version == v
    out = {"reads": [], "version": s.topology_version,
           "placement": _placement(s)}
    s.shutdown()
    return out


def sc_topology_mutation_cancel(P):
    s = P.server()
    v = s.topology_version
    with s._topology_mutation() as tm:
        tm.cancel()
    assert s.topology_version == v
    with s._topology_mutation():
        pass  # uncancelled: bumps even without ab mutations
    assert s.topology_version == v + 1
    out = {"reads": [], "version": s.topology_version}
    s.shutdown()
    return out


def sc_staging_pool_bounds_memory(P):
    s = P.server(opts=P.opts(prefetch_pull="always",
                             prefetch_staging_rows=4))
    w = s.make_worker(0)
    keys = np.arange(32)  # a bucket of 32 rows > the 4-row budget
    vals = _seed(w, keys)
    _stage(s, w, keys)
    assert s.prefetch.report()["live"] == 0
    assert s.prefetch.stats["pool_full"] >= 1
    got = w.pull_sync(keys)
    assert (got == vals).all()
    assert all(p.rows_in_use == 0 for p in s.prefetch.pools)
    out = {"reads": [got], "counters": _report(s)}
    s.shutdown()
    return out


def sc_prefetch_pull_auto_gating(P):
    s = P.server(opts=P.opts())  # prefetch_pull="auto"
    w = s.make_worker(0)
    keys = np.unique(np.array([5, 13]))
    vals = _seed(w, keys)
    _stage(s, w, keys)
    assert s.prefetch.report()["live"] == 0  # never pulled: not staged
    reads = [w.pull_sync(keys)]
    _stage(s, w, keys)  # now a known Pull user
    assert s.prefetch.report()["live"] == 1
    reads.append(w.pull_sync(keys))
    assert all((r == vals).all() for r in reads)
    out = {"reads": reads, "counters": _report(s)}
    s.shutdown()
    return out


def sc_staged_entry_expires_with_clock(P):
    s = P.server()
    w = s.make_worker(0)
    keys = np.unique(np.array([20, 28]))
    vals = _seed(w, keys)
    w.intent(keys, w.current_clock, w.current_clock)  # end = now
    s.prefetch.flush()
    w.advance_clock()
    w.advance_clock()
    s.prefetch.pump(0)  # wake the expiry sweep
    s.prefetch.flush()
    assert s.prefetch.report()["live"] == 0
    got = w.pull_sync(keys)
    assert (got == vals).all()
    out = {"reads": [got], "counters": _report(s)}
    s.shutdown()
    return out


def sc_drive_rounds_delegates_planner(P):
    s = P.server()
    w = s.make_worker(0)
    keys = np.unique(np.array([3, 11, 19]))  # home shard 3
    vals = _seed(w, keys)
    assert not s.ab.is_local(keys, w.shard).any()
    w.intent(keys, w.current_clock, w.current_clock + 10)
    s.drive_rounds()
    s.prefetch.flush()
    assert s.ab.is_local(keys, w.shard).all()
    assert s.prefetch.stats["rounds_driven"] >= 1
    got = w.pull_sync(keys)
    assert (got == vals).all()
    out = {"reads": [got], "counters": _report(s),
           "placement": _placement(s)}
    s.shutdown()
    return out


def sc_runner_staged_keys(P):
    s = P.server(num_keys=40, vlen=8)
    w = s.make_worker(0)
    w.wait(w.set(np.arange(40), np.full((40, 8), 0.1, np.float32)))
    runner = P.DeviceRoutedRunner(
        s, P.make_kge_loss("complex"),
        role_class={"s": 0, "r": 0, "o": 0, "neg": 0},
        role_dim={k: 4 for k in ("s", "r", "o", "neg")})
    rng = np.random.default_rng(0)
    roles = {k: rng.integers(0, 40, 8).astype(np.int64)
             for k in ("s", "r", "o", "neg")}
    stg = runner.prefetch_keys(roles)
    loss = float(runner(roles, None, 0.1, staged=stg))
    assert np.isfinite(loss)
    other = {k: (v + 1) % 40 for k, v in roles.items()}
    with pytest.raises(ValueError, match="staged keys differ"):
        runner(other, None, 0.1, staged=stg)
    out = {"reads": [], "model": [np.float32(loss),
                                  s.read_main(np.arange(40))],
           "counters": _report(s)}
    s.shutdown()
    return out


def sc_fused_step_invalidates_staged(P):
    s = P.server(num_keys=40, vlen=8)  # row = [emb 4 | acc 4]
    w = s.make_worker(0)
    w.wait(w.set(np.arange(40), np.full((40, 8), 0.1, np.float32)))
    runner = P.FusedStepRunner(
        s, P.make_kge_loss("complex"),
        role_class={"s": 0, "r": 0, "o": 0, "neg": 0},
        role_dim={k: 4 for k in ("s", "r", "o", "neg")})
    uk = np.unique(np.array([1, 2, 3, 4]))
    _stage(s, w, uk)
    assert s.prefetch.report()["live"] == 1
    loss = float(runner({"s": uk, "r": uk, "o": uk, "neg": uk}, None, 0.5,
                        shard=w.shard))
    assert s.prefetch.stats["invalidated_write"] >= 1
    # the restage of the dropped batch runs in the background: wait for
    # it, so the pull is its staged hit in both packages (the counters
    # compared below would otherwise depend on which thread wins)
    s.prefetch.flush()
    got = w.pull_sync(uk)
    expect = s.read_main(uk).reshape(4, 8)
    assert (got == expect).all()
    assert not np.allclose(got, 0.1)  # the step really moved the rows
    out = {"reads": [], "model": [np.float32(loss), got],
           "counters": _report(s)}
    s.shutdown()
    return out


def sc_prefetch_config_knobs(P):
    SO = P.SystemOptions
    p = argparse.ArgumentParser()
    SO.add_arguments(p)
    args = p.parse_args([
        "--sys.prefetch", "0", "--sys.prefetch.max_batches", "2",
        "--sys.prefetch.staging_rows", "1024",
        "--sys.prefetch.pull", "always", "--sys.plan_cache", "16"])
    opts = SO.from_args(args)
    assert opts.prefetch is False  # the kill switch
    assert opts.prefetch_max_batches == 2
    assert opts.prefetch_staging_rows == 1024
    assert opts.prefetch_pull == "always"
    assert opts.plan_cache_entries == 16
    # defaults: pipeline on, in both packages
    assert SO.from_args(p.parse_args([])).prefetch is True
    assert SO().prefetch is True
    return {"reads": [], "knobs": (opts.prefetch, opts.prefetch_max_batches,
                                   opts.prefetch_staging_rows,
                                   opts.prefetch_pull,
                                   opts.plan_cache_entries)}


def sc_kill_switch_disables_pipeline(P):
    s = P.server(opts=P.opts(prefetch=False, plan_cache_entries=0))
    assert s.prefetch is None and s._plan_cache is None
    w = s.make_worker(0)
    keys = np.unique(np.array([1, 2, 3]))
    vals = _seed(w, keys)
    w.intent(keys, w.current_clock, w.current_clock + 5)
    got = w.pull_sync(keys)
    assert (got == vals).all()
    s.drive_rounds()  # inline fallback
    out = {"reads": [got], "placement": _placement(s)}
    s.shutdown()
    return out


SCENARIOS = sorted(n for n in dir() if n.startswith("sc_"))


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("name", SCENARIOS)
def test_prefetch_scenario_matches_jax(name):
    fn = globals()[name]
    rj = fn(Pkg(adapm_tpu))
    rt = fn(Pkg(adapm_tpu_torch))
    assert set(rj) == set(rt)
    assert len(rj["reads"]) == len(rt["reads"])
    for i, (a, b) in enumerate(zip(rj["reads"], rt["reads"])):
        assert np.array_equal(_bits(a), _bits(b)), f"read {i} differs"
    for a, b in zip(rj.get("model", []), rt.get("model", [])):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-5, atol=1e-6)
    for k in ("counters", "plan_cache", "version", "knobs"):
        if k in rj:
            assert rj[k] == rt[k], f"{k}: {rj[k]} != {rt[k]}"
    if "placement" in rj:
        for n in rj["placement"]:
            np.testing.assert_array_equal(rt["placement"][n],
                                          rj["placement"][n])


def test_all_eighteen_scenarios_present():
    assert len(SCENARIOS) == 18
