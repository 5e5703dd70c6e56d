"""The fault plane of the port (adapm_tpu_torch/fault: injection, the
executor's error policy, incremental checkpoint chains, degraded-mode
serving) against the JAX package's, scenario by scenario.

The fifteen scenarios of tests/test_fault.py run on both packages (8
shards: `adapm_tpu.setup` on the 8-device CPU mesh beside
`adapm_tpu_torch.setup(..., num_shards=8, device="cpu")`) with the same
seeds; each keeps the JAX test's own checks on each package and returns
what it read or drew, and those are compared across packages: reads
bitwise, seeded fire/draw schedules exactly. Scenarios whose outcome
depends on thread timing (background loops, the watchdog) return
nothing to compare. Every wait is bounded.
"""
import threading
import time

import numpy as np
import pytest

import adapm_tpu
import adapm_tpu_torch

E = 128
L = 4


class Pkg:
    def __init__(self, mod):
        self.mod = mod
        self.is_jax = mod is adapm_tpu
        self.SystemOptions = mod.SystemOptions
        self.CLOCK_MAX = __import__(f"{mod.__name__}.base",
                                    fromlist=["x"]).CLOCK_MAX
        self.fault = __import__(f"{mod.__name__}.fault", fromlist=["x"])
        self.serve = __import__(f"{mod.__name__}.serve", fromlist=["x"])
        self.LookupRequest = __import__(
            f"{mod.__name__}.serve.admission",
            fromlist=["x"]).LookupRequest
        self.schema = 16 if self.is_jax else 3

    def setup(self, num_keys, vlen, opts, num_workers=None):
        if self.is_jax:
            return adapm_tpu.setup(num_keys, vlen, opts=opts,
                                   num_workers=num_workers)
        return adapm_tpu_torch.setup(num_keys, vlen, opts=opts,
                                     num_shards=8, device="cpu",
                                     num_workers=num_workers)

    def mk(self, **kw):
        opts = self.SystemOptions(sync_max_per_sec=0, prefetch=False, **kw)
        return self.setup(E, L, opts, num_workers=2)


JAX, PORT = Pkg(adapm_tpu), Pkg(adapm_tpu_torch)


def _read(srv, n=E):
    return np.asarray(srv.read_main(np.arange(n)))


def _fire_seq(P, plane, point, n):
    out = []
    for _ in range(n):
        try:
            plane.fire(point)
            out.append(False)
        except P.fault.InjectedFault:
            out.append(True)
    return out


# -- injection plane ----------------------------------------------------------


def sc_spec_parse_and_rejection(P):
    assert P.fault.parse_fault_spec("a.b=0.5, c=1; d.e.f=0") == {
        "a.b": 0.5, "c": 1.0, "d.e.f": 0.0}
    for bad in ("nope", "x=2", "x=-0.1", "x=abc", "=0.5"):
        with pytest.raises(ValueError):
            P.fault.parse_fault_spec(bad)
    with pytest.raises(ValueError):
        P.SystemOptions(fault_spec="x=7").validate_serve()
    with pytest.raises(ValueError):
        P.SystemOptions(fault_watchdog_s=0).validate_serve()
    with pytest.raises(ValueError):
        P.SystemOptions(ckpt_every_s=1.0).validate_serve()
    return []


def sc_plane_deterministic(P):
    a = P.fault.FaultPlane("p.one=0.5,p.two=0.3", seed=42)
    b = P.fault.FaultPlane("p.one=0.5,p.two=0.3", seed=42)
    seq_a = _fire_seq(P, a, "p.one", 50)
    _fire_seq(P, b, "p.two", 17)
    assert _fire_seq(P, b, "p.one", 50) == seq_a
    assert any(seq_a) and not all(seq_a)
    c = P.fault.FaultPlane("p.one=0.5", seed=43)
    seq_c = _fire_seq(P, c, "p.one", 50)
    assert seq_c != seq_a
    a.fire("never.configured")
    evals, fired = a.counts("p.one")
    assert evals == 50 and fired == sum(seq_a)
    d = P.fault.FaultPlane("x=1.0", seed=0)
    with pytest.raises(P.fault.FatalInjectedFault):
        d.fire("x", transient=False)
    assert not issubclass(P.fault.FatalInjectedFault,
                          P.fault.TransientFaultError)
    return [np.array(seq_a), np.array(seq_c)]


def sc_off_by_default(P):
    srv = P.mk()
    try:
        assert srv.fault is None
        assert not [n for n in srv.obs.names() if n.startswith("fault.")]
        snap = srv.metrics_snapshot()
        assert snap["schema_version"] == P.schema
        assert snap["fault"] == {} and snap["ckpt"] == {}
    finally:
        srv.shutdown()
    return []


# -- executor error policy ----------------------------------------------------


def sc_executor_retries_transient(P):
    srv = P.mk(fault_backoff_ms=1.0)
    try:
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise P.fault.TransientFaultError("flaky")
            return "ok"

        assert srv.exec.submit("t", flaky).result(10) == "ok"
        assert calls["n"] == 3
        st = srv.exec.fault_stats()
        assert st["retries"] >= 2 and st["backoff_s"] > 0
        fatal = {"n": 0}

        def boom():
            fatal["n"] += 1
            raise ValueError("fatal")

        c2 = srv.exec.submit("t", boom)
        with pytest.raises(ValueError):
            c2.result(10)
        assert fatal["n"] == 1
    finally:
        srv.shutdown()
    return [np.array([calls["n"], fatal["n"]])]


def sc_executor_retry_budget(P):
    srv = P.mk(fault_retries=2, fault_backoff_ms=1.0)
    try:
        calls = {"n": 0}

        def always():
            calls["n"] += 1
            raise P.fault.TransientFaultError("always")

        c = srv.exec.submit("t", always)
        with pytest.raises(P.fault.TransientFaultError):
            c.result(10)
        assert calls["n"] == 3
    finally:
        srv.shutdown()
    return [np.array([calls["n"]])]


def sc_executor_retry_fifo(P):
    srv = P.mk(fault_backoff_ms=1.0)
    try:
        order = []

        def flaky():
            order.append("a")
            if order.count("a") < 2:
                raise P.fault.TransientFaultError("once")

        srv.exec.submit("s", flaky)
        srv.exec.submit("s", lambda: order.append("b")).result(10)
        assert order == ["a", "a", "b"]
    finally:
        srv.shutdown()
    return []


def sc_executor_watchdog(P):
    srv = P.mk()
    try:
        release = threading.Event()
        started = threading.Event()

        def stuck():
            started.set()
            release.wait(10)

        c = srv.exec.submit("w", stuck)
        assert started.wait(5)
        time.sleep(0.1)
        wedged = srv.exec.wedged_streams(0.05)
        assert [w["stream"] for w in wedged] == ["w"]
        assert srv.exec.fault_stats()["wedge_flips"] == 1
        assert srv.exec.wedged_streams(0.05, exclude=("w",)) == []
        release.set()
        c.result(10)
        assert srv.exec.wedged_streams(0.05) == []
        assert srv.exec.fault_stats()["wedge_flips"] == 1
    finally:
        srv.shutdown()
    return []


def sc_background_sync_survives(P):
    srv = P.mk(fault_spec="sync.round=0.4", fault_seed=3,
               fault_backoff_ms=1.0, fault_retries=10)
    try:
        w = srv.make_worker(0)
        w.set(np.arange(E), np.ones((E, L), np.float32))
        srv.start_sync_thread()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if (srv.sync.stats.rounds >= 5
                    and srv.fault.counts("sync.round")[1] >= 2):
                break
            time.sleep(0.05)
        srv.stop_sync_thread()
        assert srv.sync.stats.rounds >= 5, "sync loop died under faults"
        assert srv.fault.counts("sync.round")[1] >= 2
        snap = srv.metrics_snapshot()
        assert snap["fault"]["injections_fired"] >= 2
        assert snap["fault"]["loop_retries"] >= 2
    finally:
        srv.shutdown()
    return []


def sc_background_sync_immortal(P):
    srv = P.mk(fault_spec="sync.round=1.0", fault_seed=0,
               fault_retries=1, fault_backoff_ms=1.0)
    try:
        srv.start_sync_thread()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                srv.fault.counts("sync.round")[1] < 5:
            time.sleep(0.02)
        assert srv.fault.counts("sync.round")[1] >= 5, \
            "loop died inside the failure streak"
        assert srv.sync.stats.rounds == 0
        srv.fault._points["sync.round"].prob = 0.0
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and srv.sync.stats.rounds < 3:
            time.sleep(0.02)
        srv.stop_sync_thread()
        assert srv.sync.stats.rounds >= 3, \
            "loop did not recover after the failure streak ended"
    finally:
        srv.shutdown()
    return []


# -- incremental checkpoint chain ---------------------------------------------


def _chained_state(P, tmp):
    rng = np.random.default_rng(0)
    srv = P.mk(cache_slots_per_shard=16)
    w0, w1 = srv.make_worker(0), srv.make_worker(1)
    w0.set(np.arange(E), rng.normal(size=(E, L)).astype(np.float32))
    path = str(tmp / "chain")
    ck = P.fault.IncrementalCheckpointer(srv, path)
    base = ck.save()
    assert base["kind"] == "base"
    w0.push(np.arange(7), np.ones((7, L), np.float32))
    d1 = ck.save()
    assert d1["kind"] == "delta" and d1["slots"] >= 7
    shared = np.array([5, 9, 13])
    w0.intent(shared, 0, P.CLOCK_MAX)
    w1.intent(shared, 0, P.CLOCK_MAX)
    srv.wait_sync()
    w0.push(shared, np.full((3, L), 0.25, np.float32))
    srv.block()
    ck.save()
    expected_main = _read(srv)
    expected_pull = np.asarray(w0.pull_sync(np.arange(E)))
    owner = srv.ab.owner.copy()
    cache_slot = srv.ab.cache_slot.copy()
    srv.shutdown()
    return path, expected_main, expected_pull, owner, cache_slot


def sc_chain_roundtrip_bit_exact(P, tmp):
    path, exp_main, exp_pull, owner, cache_slot = _chained_state(P, tmp)
    srv2 = P.mk(cache_slots_per_shard=16)
    w0b = srv2.make_worker(0)
    recovery_s = P.fault.restore_chain(srv2, path)
    assert recovery_s > 0
    assert not srv2.degraded
    assert (srv2.ab.owner == owner).all()
    assert (srv2.ab.cache_slot == cache_slot).all()
    got_main = _read(srv2)
    assert np.array_equal(got_main, exp_main), "read_main not bit-exact"
    got_pull = np.asarray(w0b.pull_sync(np.arange(E)))
    assert np.array_equal(got_pull, exp_pull), "pull not bit-exact"
    assert srv2.metrics_snapshot()["ckpt"]["recovery_s"] == recovery_s
    srv2.quiesce()
    after = _read(srv2)
    assert np.isfinite(after).all()
    srv2.shutdown()
    return [exp_main, exp_pull, got_main, got_pull, after]


def sc_chain_delta_bytes_small(P, tmp):
    rng = np.random.default_rng(0)
    srv = P.setup(4096, 16, P.SystemOptions(sync_max_per_sec=0,
                                            prefetch=False),
                  num_workers=2)
    try:
        w = srv.make_worker(0)
        w.set(np.arange(4096),
              rng.normal(size=(4096, 16)).astype(np.float32))
        ck = P.fault.IncrementalCheckpointer(srv, str(tmp / "chain"))
        base = ck.save()
        dirty = rng.choice(4096, size=41, replace=False)
        w.push(dirty, np.ones((41, 16), np.float32))
        delta = ck.save()
        assert delta["slots"] == 41
        assert delta["bytes"] <= 0.10 * base["bytes"], (
            f"1%-dirty delta {delta['bytes']}B vs base "
            f"{base['bytes']}B")
    finally:
        srv.shutdown()
    return [np.array([base["slots"], delta["slots"]])]


def sc_periodic_checkpointer(P, tmp):
    srv = P.mk(ckpt_every_s=0.03, ckpt_path=str(tmp / "chain"))
    try:
        w = srv.make_worker(0)
        w.set(np.arange(E), np.ones((E, L), np.float32))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and srv.ckpt.saves_total < 2:
            time.sleep(0.02)
        assert srv.ckpt.saves_total >= 2, "periodic ckpt never ran"
        snap = srv.metrics_snapshot()
        assert snap["ckpt"]["saves_total"] >= 2
        assert snap["ckpt"]["bases_total"] == 1
    finally:
        srv.shutdown()
    srv2 = P.mk()
    P.fault.restore_chain(srv2, str(tmp / "chain"))
    got = _read(srv2)
    assert np.allclose(got, 1.0)
    srv2.shutdown()
    return [got]


def sc_restore_rejects_geometry(P, tmp):
    path, _, _, _, _ = _chained_state(P, tmp)
    other = P.setup(64, L, P.SystemOptions(sync_max_per_sec=0,
                                           prefetch=False))
    try:
        before = _read(other, 64)
        with pytest.raises(P.fault.CheckpointChainError, match="mismatch"):
            P.fault.restore_chain(other, path)
        assert not other.degraded
        assert np.array_equal(_read(other, 64), before)
    finally:
        other.shutdown()
    return [before]


# -- degraded-mode serving ----------------------------------------------------


def sc_degraded_window_sheds(P):
    srv = P.mk()
    plane = P.serve.ServePlane(srv)
    try:
        sess = plane.session()
        w = srv.make_worker(0)
        w.set(np.arange(E), np.ones((E, L), np.float32))
        first = sess.lookup(np.arange(4))
        assert np.array_equal(first, np.ones((4, L), np.float32))
        srv.begin_degraded("unit-test window")
        with pytest.raises(P.serve.ServeDegradedError, match="unit-test"):
            sess.lookup(np.arange(4))
        rd = plane.health.readiness()
        assert not rd["ready"]
        assert rd["degraded"] == "unit-test window"
        assert any("degraded" in x for x in rd["reasons"])
        req = P.LookupRequest(np.arange(4, dtype=np.int64))
        plane.queue.submit(req)
        assert req.wait(10)
        with pytest.raises(P.serve.ServeDegradedError):
            req.take_result()
        assert plane.queue.c_degraded.value >= 2
        srv.end_degraded()
        again = sess.lookup(np.arange(4))
        assert np.array_equal(again, np.ones((4, L), np.float32))
        assert plane.health.readiness()["ready"]
    finally:
        plane.close()
        srv.shutdown()
    return [first, again]


def sc_restore_chain_brackets_degraded(P, tmp):
    path, exp_main, _, _, _ = _chained_state(P, tmp)
    srv = P.mk(cache_slots_per_shard=16)
    plane = P.serve.ServePlane(srv)
    sess = plane.session()
    try:
        outcomes = []
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    v = sess.lookup(np.arange(8))
                    outcomes.append(("ok", np.asarray(v).copy()))
                except P.serve.ServeDegradedError:
                    outcomes.append(("degraded", None))
                except Exception as e:  # noqa: BLE001
                    outcomes.append((type(e).__name__, None))
                time.sleep(0.002)

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        P.fault.restore_chain(srv, path, hold_degraded_s=0.3)
        stop.set()
        t.join(5)
        kinds = {k for k, _ in outcomes}
        assert "degraded" in kinds, (
            f"no lookup shed during the degraded window: {kinds}")
        assert kinds <= {"ok", "degraded"}, kinds
        exp8 = exp_main[: 8 * L].reshape(8, L)
        got = np.asarray(sess.lookup(np.arange(8)))
        assert np.array_equal(got, exp8)
    finally:
        plane.close()
        srv.shutdown()
    return [got]


_PLAIN = [sc_spec_parse_and_rejection, sc_plane_deterministic,
          sc_off_by_default, sc_executor_retries_transient,
          sc_executor_retry_budget, sc_executor_retry_fifo,
          sc_executor_watchdog, sc_background_sync_survives,
          sc_background_sync_immortal, sc_degraded_window_sheds]
_WITH_TMP = [sc_chain_roundtrip_bit_exact, sc_chain_delta_bytes_small,
             sc_periodic_checkpointer, sc_restore_rejects_geometry,
             sc_restore_chain_brackets_degraded]


def _same(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(np.asarray(x), np.asarray(y)), \
            f"result {i} differs across packages"


@pytest.mark.parametrize("scenario", _PLAIN + _WITH_TMP,
                         ids=lambda f: f.__name__[3:])
def test_fault_scenario_both_packages(scenario, tmp_path):
    out = []
    for P in (JAX, PORT):
        if scenario in _WITH_TMP:
            d = tmp_path / ("jax" if P.is_jax else "port")
            d.mkdir()
            out.append(scenario(P, d))
        else:
            out.append(scenario(P))
    _same(*out)


def test_same_spec_and_seed_same_schedule_on_both():
    """The per-point seeding is the JAX package's: the same spec and
    seed give the same `fire` and `draw` schedule on both packages,
    whatever the interleaving of other points, and the same counts."""
    spec = "exec.dispatch=0.1,sync.round=0.35,net.send=0.2,net.dup=0.5"
    scheds = []
    for P in (JAX, PORT):
        plane = P.fault.FaultPlane(spec, seed=7)
        draws = {pt: [plane.draw(pt) for _ in range(200)]
                 for pt in ("net.dup", "net.send")}
        fires = _fire_seq(P, plane, "sync.round", 200)
        # interleaving another point does not move this one's stream
        other = P.fault.FaultPlane(spec, seed=7)
        _fire_seq(P, other, "exec.dispatch", 33)
        assert [other.draw("net.send") for _ in range(200)] == \
            draws["net.send"]
        st = plane.stats()
        scheds.append((draws, fires, st["points"],
                       st["injections_fired"]))
    assert scheds[0] == scheds[1]
    assert any(scheds[0][1]) and not all(scheds[0][1])
