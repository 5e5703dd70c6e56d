"""The port's streaming plane (adapm_tpu_torch/stream), held to the JAX
package's (adapm_tpu/stream): the twins of tests/test_stream.py's ten
cases on the port, plus cross-package cases —

  - EventLog: event i is the same bytes in both packages (keys and
    gradient rows), for several seeds, skews and indices;
  - a checkpoint chain written by a JAX single-process server with a
    stream plane (its cursor rides as `aux_stream_cursor`) restores into
    the port: the cursor, and the table bitwise; the port's trainer then
    replays the acked tail to the JAX unkilled shadow, bitwise;
  - FreshnessSLO: the same control law makes the same moves in both
    packages on the same observations;
  - the kill/restore drill: the port's replayed table is bitwise the
    JAX package's unkilled shadow of the same prefix.

Every port server runs on the CPU (device="cpu"); JAX stays on its CPU
mesh.
"""
import os
import tempfile

import numpy as np
import pytest

import adapm_tpu
import adapm_tpu_torch as at

NK = 256
VLEN = 8
S = 2


def _port(opts, num_workers=None):
    return at.setup(NK, VLEN, opts=opts, num_shards=S,
                    num_workers=num_workers, device="cpu")


def _jax(opts, num_workers=None):
    return adapm_tpu.setup(NK, VLEN, opts=opts, num_shards=S,
                           num_workers=num_workers)


def _stream_opts(mod=at, **kw):
    base = dict(sync_max_per_sec=0, prefetch=False, stream_batch=8)
    base.update(kw)
    return mod.SystemOptions(**base)


def _init_vals(srv):
    w = srv.make_worker(0)
    rng = np.random.default_rng(11)
    w.wait(w.set(np.arange(NK),
                 rng.normal(size=(NK, VLEN)).astype(np.float32)))
    return w


# -- default off -------------------------------------------------------------

def test_stream_default_off():
    srv = _port(at.SystemOptions(sync_max_per_sec=0, prefetch=False))
    assert srv.stream is None
    assert not [n for n in srv.obs.names() if n.startswith("stream.")]
    snap = srv.metrics_snapshot()
    assert snap["stream"] == {}
    from adapm_tpu_torch.stream import EventLog, StreamTrainer
    with pytest.raises(RuntimeError):
        StreamTrainer(srv, EventLog(NK))
    srv.shutdown()


# -- EventLog ----------------------------------------------------------------

def test_event_log_deterministic_and_bounded():
    from adapm_tpu_torch.stream import EventLog
    vlen = np.full(NK, VLEN, dtype=np.int64)
    a = EventLog(NK, seed=3, keys_per_event=8, bound=4)
    b = EventLog(NK, seed=3, keys_per_event=8, bound=4096)
    for i in (0, 1, 17, 1000):
        ka, va = a.event(i, vlen)
        kb, vb = b.event(i, vlen)
        assert np.array_equal(ka, kb) and np.array_equal(va, vb)
        assert len(np.unique(ka)) == len(ka)
        assert ka.max() < NK and ka.min() >= 0
    assert len(a._memo) <= 4
    k0, v0 = a.event(0, vlen)
    kb0, vb0 = b.event(0, vlen)
    assert np.array_equal(k0, kb0) and np.array_equal(v0, vb0)
    c = EventLog(NK, seed=4, keys_per_event=8)
    kc, vc = c.event(0, vlen)
    assert not (np.array_equal(k0, kc) and np.array_equal(v0, vc))


@pytest.mark.parametrize("seed,kpe,skew", [(0, 8, 3.0), (7, 8, 3.0),
                                           (5, 3, 1.5)])
def test_event_log_bytes_equal_across_packages(seed, kpe, skew):
    from adapm_tpu.stream import EventLog as JaxLog
    from adapm_tpu_torch.stream import EventLog
    vlen = np.where(np.arange(NK) % 3 == 0, 4, VLEN).astype(np.int64)
    p, j = EventLog(NK, seed, kpe, skew), JaxLog(NK, seed, kpe, skew)
    for i in (0, 1, 2, 99, 4095, 123456):
        kp, vp = p.event(i, vlen)
        kj, vj = j.event(i, vlen)
        assert kp.tobytes() == kj.tobytes() and vp.tobytes() == vj.tobytes()
        assert p.keys(i).tobytes() == j.keys(i).tobytes()


# -- trainer accounting ------------------------------------------------------

def test_trainer_cursor_and_counters():
    from adapm_tpu_torch.stream import EventLog, StreamTrainer
    srv = _port(_stream_opts(), num_workers=2)
    _init_vals(srv)
    tr = StreamTrainer(srv, EventLog(NK, seed=5))
    assert tr.batch == 8 and tr.resumed_from == 0
    assert tr.step() == 8 and tr.cursor == 8
    assert tr.run_until(24) == 24
    st = srv.stream.stats()
    assert st["cursor"] == 24
    assert st["events_total"] == 24 and st["batches_total"] == 3
    assert st["acked_events_total"] == 24
    assert st["replayed_events_total"] == 0
    snap = srv.metrics_snapshot()
    assert snap["stream"]["cursor"] == 24
    assert snap["stream"]["trainer"]["batch"] == 8
    srv.shutdown()


def test_trainer_pump_on_executor_reaches_target():
    """The executor pump (`start(target)`) applies whole batches until
    the target and parks; shutdown drains it."""
    from adapm_tpu_torch.stream import EventLog, StreamTrainer
    srv = _port(_stream_opts(stream_rate=0.0), num_workers=2)
    _init_vals(srv)
    tr = StreamTrainer(srv, EventLog(NK, seed=5))
    tr.start(target_events=40)
    assert srv.exec.drain("stream", timeout=30)
    assert tr.cursor == 40
    srv.shutdown()
    assert tr.stats()["closed"]


# -- the kill/restore drill --------------------------------------------------

def _jax_shadow(n_events):
    """The JAX package's unkilled shadow: the same init and prefix."""
    from adapm_tpu.stream import EventLog, StreamTrainer
    srv = _jax(_stream_opts(adapm_tpu), num_workers=2)
    _init_vals(srv)
    StreamTrainer(srv, EventLog(NK, seed=5)).run_until(n_events)
    want = srv.read_main(np.arange(NK))
    srv.shutdown()
    return want


def test_kill_restore_drill_bitwise_vs_shadow():
    """Mid-stream kill with the chain LAGGING the ack watermark,
    restore, replay the acked tail: every acked event applied exactly
    once — bitwise vs an unkilled shadow of the same prefix, the port's
    and the JAX package's."""
    from adapm_tpu_torch.fault.ckpt import IncrementalCheckpointer, \
        restore_chain
    from adapm_tpu_torch.stream import EventLog, StreamTrainer
    allk = np.arange(NK)
    with tempfile.TemporaryDirectory() as tmp:
        chain = os.path.join(tmp, "chain")
        srv = _port(_stream_opts(), num_workers=2)
        _init_vals(srv)
        tr = StreamTrainer(srv, EventLog(NK, seed=5))
        ck = IncrementalCheckpointer(srv, chain)
        ck.save()
        tr.run_until(40)
        ck.save()
        tr.run_until(72)
        acked = tr.cursor
        assert acked == 72
        srv.shutdown()
        srv2 = _port(_stream_opts(), num_workers=2)
        srv2.make_worker(0)
        restore_chain(srv2, chain)
        assert int(srv2.stream.cursor[0]) == 40
        tr2 = StreamTrainer(srv2, EventLog(NK, seed=5))
        assert tr2.resumed_from == 40
        replayed = tr2.replay_tail(acked)
        assert replayed == 32 and tr2.cursor == 72
        assert int(srv2.stream.c_replayed.value) == 32
        got = srv2.read_main(allk)
        srv2.shutdown()
        srv3 = _port(_stream_opts(), num_workers=2)
        _init_vals(srv3)
        StreamTrainer(srv3, EventLog(NK, seed=5)).run_until(72)
        want = srv3.read_main(allk)
        srv3.shutdown()
        assert got.tobytes() == want.tobytes()
        assert got.tobytes() == _jax_shadow(72).tobytes()


def test_jax_chain_with_stream_cursor_restores_in_port():
    """A JAX single-process chain carrying `aux_stream_cursor` restores
    into the port: cursor and table; the port then replays the acked
    tail to the JAX unkilled shadow, bitwise."""
    from adapm_tpu.fault.ckpt import IncrementalCheckpointer
    from adapm_tpu.stream import EventLog as JaxLog
    from adapm_tpu.stream import StreamTrainer as JaxTrainer
    from adapm_tpu_torch.fault.ckpt import restore_chain
    from adapm_tpu_torch.stream import EventLog, StreamTrainer
    allk = np.arange(NK)
    with tempfile.TemporaryDirectory() as tmp:
        chain = os.path.join(tmp, "chain")
        srv = _jax(_stream_opts(adapm_tpu), num_workers=2)
        _init_vals(srv)
        tr = JaxTrainer(srv, JaxLog(NK, seed=5))
        ck = IncrementalCheckpointer(srv, chain)
        ck.save()
        tr.run_until(24)
        ck.save()
        at_save = srv.read_main(allk)
        tr.run_until(56)
        srv.shutdown()
        dst = _port(_stream_opts(), num_workers=2)
        dst.make_worker(0)
        restore_chain(dst, chain)
        assert int(dst.stream.cursor[0]) == 24
        assert dst._restored_stream_cursor == 24
        assert dst.read_main(allk).tobytes() == at_save.tobytes()
        tr2 = StreamTrainer(dst, EventLog(NK, seed=5))
        assert tr2.replay_tail(56) == 32
        got = dst.read_main(allk)
        dst.shutdown()
    assert got.tobytes() == _jax_shadow(56).tobytes()


def test_cursor_restore_into_planeless_server():
    from adapm_tpu_torch.fault.ckpt import IncrementalCheckpointer, \
        restore_chain
    from adapm_tpu_torch.stream import EventLog, StreamTrainer
    with tempfile.TemporaryDirectory() as tmp:
        chain = os.path.join(tmp, "chain")
        srv = _port(_stream_opts(), num_workers=2)
        _init_vals(srv)
        StreamTrainer(srv, EventLog(NK, seed=5)).run_until(16)
        IncrementalCheckpointer(srv, chain).save()
        srv.shutdown()
        srv2 = _port(at.SystemOptions(sync_max_per_sec=0, prefetch=False),
                     num_workers=2)
        assert srv2.stream is None
        restore_chain(srv2, chain)
        assert srv2._restored_stream_cursor == 16
        srv2.shutdown()


# -- freshness controller law ------------------------------------------------

def _fresh(mod, setup, slo_ms=50.0, **kw):
    return setup(mod.SystemOptions(
        sync_max_per_sec=2.0, prefetch=False, metrics=True,
        trace_flight=True, stream_freshness_slo_ms=slo_ms, **kw))


def test_freshness_law_direction_and_bounds(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)     # the flight trace lands in the cwd
    srv = _fresh(at, _port)
    ctl = srv.stream.freshness
    assert ctl is not None and ctl.target_s == 0.05
    h = srv.flight.freshness.h_freshness
    sm = srv.sync
    assert sm.effective_max_per_sec == 2.0
    ctl._control()
    assert int(ctl.c_adjust.value) == 0
    h.observe(1.0), h.observe(1.0)
    ctl._control()
    assert int(ctl.c_adjust.value) == 0
    h.observe(1.0), h.observe(1.0)
    ctl._control()
    assert int(ctl.c_adjust.value) == 1
    assert sm.effective_max_per_sec > 2.0
    assert ctl.first_adjustment is not None
    (lever, old, new) = ctl.first_adjustment[2][0]
    assert lever == "sync_rate" and new > old
    for _ in range(30):
        for _ in range(4):
            h.observe(1.0)
        ctl._control()
    assert sm.effective_max_per_sec == pytest.approx(128.0)
    for _ in range(40):
        for _ in range(4):
            h.observe(1e-4)
        ctl._control()
    assert sm.effective_max_per_sec == pytest.approx(2.0)
    rep = ctl.report()
    assert rep["active"] and rep["target_ms"] == 50.0
    assert rep["adjustments"] == int(ctl.c_adjust.value) >= 2
    srv.shutdown()


def test_freshness_law_same_moves_across_packages(monkeypatch, tmp_path):
    """The same observation script drives both packages' controllers
    (their timer ticks closed first): the same levers move to the same
    values at the same ticks."""
    from adapm_tpu.serve import ServePlane as JaxPlane
    from adapm_tpu_torch.serve import ServePlane
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(9)
    script = [rng.choice([1e-4, 0.02, 0.05, 0.3, 1.0], size=int(n))
              for n in rng.integers(0, 7, size=60)]
    moves = []
    for mod, setup, plane_cls in ((adapm_tpu, _jax, JaxPlane),
                                  (at, _port, ServePlane)):
        srv = _fresh(mod, setup, serve_replica_rows=32,
                     serve_replica_refresh_ms=250.0)
        plane = plane_cls(srv)
        ctl = srv.stream.freshness
        ctl.close()
        h = srv.flight.freshness.h_freshness
        seq = []
        for obs in script:
            for x in obs:
                h.observe(float(x))
            ctl._control()
            seq.append((int(ctl.c_adjust.value),
                        float(srv.sync.effective_max_per_sec),
                        float(plane.replica.refresh_s)))
        moves.append((seq, [lv for m in ctl.adjustments for lv in m[2]]))
        plane.close()
        srv.shutdown()
    assert moves[0] == moves[1]
    assert moves[1][0][-1][0] > 0


def test_freshness_steers_to_tightest_class_target(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    srv = _fresh(at, _port, slo_ms=400.0,
                 stream_freshness_slo_class="1=200")
    ctl = srv.stream.freshness
    assert ctl.target_s == pytest.approx(0.2)
    rep = ctl.report()
    assert rep["base_target_ms"] == 400.0
    assert rep["target_ms"] == 200.0
    assert rep["class_targets"] == {"1": 200.0}
    srv.shutdown()


# -- per-priority-class serve windows (obs/slo.py) ---------------------------

def test_serve_class_windows_walk_independently():
    import time

    from adapm_tpu_torch.serve import ServePlane
    srv = _port(at.SystemOptions(
        sync_max_per_sec=0, prefetch=False, serve_max_wait_us=200,
        serve_slo_ms=20.0, serve_slo_class="1=5"))
    plane = ServePlane(srv)
    ctl = plane.slo
    b = plane.batcher
    assert ctl is not None and b.class_wait_us == {1: 200}
    assert b._class_samples is not None
    ctl._control_classes()
    now = time.perf_counter()
    for _ in range(8):
        b._class_samples.append((now, 0.050, 1))
    ctl._control_classes()
    assert b.class_wait_us[1] < 200
    rep = ctl.report()
    assert rep["class_targets_ms"] == {"1": 5.0}
    assert rep["class_adjustments"] and \
        rep["class_adjustments"][-1]["priority"] == 1
    assert rep["class_wait_us"] == {
        str(p): int(w) for p, w in b.class_wait_us.items()}
    srv.shutdown()


def test_serve_no_class_override_path_untouched():
    from adapm_tpu_torch.serve import ServePlane
    srv = _port(at.SystemOptions(
        sync_max_per_sec=0, prefetch=False, serve_slo_ms=20.0))
    plane = ServePlane(srv)
    b = plane.batcher
    assert b.class_wait_us is None and b._class_samples is None
    rep = plane.slo.report()
    assert "class_targets_ms" not in rep
    assert "class_wait_us" not in rep and "class_adjustments" not in rep
    srv.shutdown()


# -- replay hygiene ----------------------------------------------------------

def test_replay_zeroes_stream_knobs():
    from adapm_tpu_torch.replay.engine import _build_opts

    class _Trace:
        meta = {"knobs": {"stream_batch": 32, "stream_rate": 2000.0,
                          "stream_freshness_slo_ms": 400.0,
                          "stream_freshness_slo_class": "1=200"}}

    opts, _ = _build_opts(_Trace(), overrides=None)
    assert opts.stream_batch == 0 and opts.stream_rate == 0.0
    assert opts.stream_freshness_slo_ms == 0.0
    assert opts.stream_freshness_slo_class == ""


# -- the north-star scenario ---------------------------------------------------

def test_northstar_small_on_cpu(tmp_path, monkeypatch):
    """run_northstar at a small size: the drill lands behind the acked
    watermark and replays to it, the replayed table is bitwise an
    unkilled shadow (read through `on_replayed`), and the captured
    .wtrace replays to one digest twice."""
    from adapm_tpu_torch.obs.wtrace import load_wtrace
    from adapm_tpu_torch.replay import ReplayEngine
    from adapm_tpu_torch.stream import EventLog, StreamTrainer
    from adapm_tpu_torch.stream.scenario import _build, _opts, \
        run_northstar
    monkeypatch.chdir(tmp_path)
    nk, vl = 2048, 8
    held = {}

    def on_replayed(srv):
        held["t"] = srv.read_main(np.arange(nk))

    res = run_northstar(num_keys=nk, vlen=vl, segment_s=0.6,
                        ckpt_every_s=0.2, trailing_s=0.3,
                        workdir=str(tmp_path), device="cpu",
                        on_replayed=on_replayed)
    d = res["drill"]
    assert d["restored_cursor"] <= d["acked_at_kill"]
    assert d["replayed_events"] == d["acked_at_kill"] - \
        d["restored_cursor"]
    assert res["events_applied"] > 0 and res["served_lookups"] > 0
    # segment B counts its own pumped events (the JAX scenario subtracts
    # the restored cursor from a counter that starts at 0 on the fresh
    # server and includes the replayed tail)
    ing = res["ingest"]
    assert 0 < ing["B"]["events"] <= \
        res["stream_section"]["cursor"] - d["acked_at_kill"]
    assert res["events_applied"] == ing["A"]["events"] + ing["B"]["events"]
    for seg in ("A", "B"):
        assert set(ing[seg]) == {"paced_s", "queue_s", "events_s",
                                 "lock_s", "push_s", "cpu_s", "wall_s",
                                 "events"}
        assert all(v >= 0 for v in ing[seg].values())
    f = res["freshness"]
    assert f["segment_b_samples"] <= f["cumulative_samples"]
    assert f["samples"] <= f["segment_b_samples"]
    shadow, _, _ = _build(nk, vl, _opts(32, 0.0, 0.0, None),
                          np.arange(512), "cpu")
    StreamTrainer(shadow, EventLog(nk, seed=7)).run_until(
        d["acked_at_kill"])
    want = shadow.read_main(np.arange(nk))
    shadow.shutdown()
    assert held["t"].tobytes() == want.tobytes()
    tr = load_wtrace(res["wtrace_path"])
    digests = {ReplayEngine(tr, seed=11, device="cpu").run()["reads_digest"]
               for _ in range(2)}
    assert len(digests) == 1
