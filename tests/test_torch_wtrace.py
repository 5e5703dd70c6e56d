"""Workload trace capture and deterministic replay on the port
(adapm_tpu_torch/obs/wtrace.py, adapm_tpu_torch/replay/) against the
JAX package's.

The thirteen tests of tests/test_wtrace.py run on the port at the same
size (NK=128, VL=4, 8 CPU shards, `device="cpu"`), with the JAX test's
own checks. The cross-package cases hold the `.wtrace` format and the
replay contract across the two packages, bitwise: the 5-plane storm
captured by the JAX package replays to the same `reads_digest`, `reads`
and `events_replayed` in both packages; the storm captured by the port
loads and verifies in the JAX package and its JAX replay equals the
port's; a storm with managed sampling does the same (the port's
sampling generator draws the JAX package's keys). Inputs are numpy
draws from fixed seeds.
"""
import json

import numpy as np
import pytest

import adapm_tpu
import adapm_tpu_torch as at
from adapm_tpu_torch import Server, SystemOptions, make_context
from adapm_tpu_torch.obs.wtrace import (WTRACE_VERSION,
                                        WorkloadTraceError,
                                        WorkloadTraceRecorder,
                                        event_keys, load_wtrace)
from adapm_tpu_torch.replay import (ReplayEngine, per_shard_hot_rows,
                                    rank_candidates, replay_trace)
from adapm_tpu_torch.serve import ServePlane

NK = 128
VL = 4
CPU = "cpu"


@pytest.fixture(scope="module")
def ctx():
    return make_context(8, CPU)


def make_server(ctx, tmp_path=None, num_keys=NK, vlen=VL, **kw):
    opts = kw.pop("opts", None)
    if opts is None:
        opts = SystemOptions(sync_max_per_sec=0)
    if tmp_path is not None and not opts.trace_workload:
        opts.trace_workload = str(tmp_path / "capture.wtrace")
    return Server(num_keys, vlen, opts=opts, ctx=ctx, **kw)


def _seed(w, num_keys=NK, vlen=VL):
    w.wait(w.set(np.arange(num_keys),
                 np.ones((num_keys, vlen), np.float32)))


def _storm(srv, plane, steps, sampling=False):
    """test_wtrace.py's seeded multi-plane storm on a built server (any
    package); with `sampling`, a seventh op runs a managed-sampling
    round (prepare, two pulls, finish)."""
    w0, w1 = srv.make_worker(0), srv.make_worker(1)
    _seed(w0)
    if sampling:
        srv.enable_sampling_support(
            lambda n, rng: rng.integers(0, NK, n), 0, NK)
    rng = np.random.default_rng(7)
    sessions = {}
    n_serves = 0
    if plane is not None:
        plane.configure_tenant("gold", priority=1)
        sessions["gold"] = plane.session(tenant="gold")
        sessions[None] = plane.session()
    for i in range(steps):
        w = w0 if i % 2 == 0 else w1
        op = rng.integers(0, 7 if sampling else 6)
        ks = np.unique(rng.integers(0, NK, int(rng.integers(1, 24))))
        if op == 0:
            w.pull_sync(ks)
        elif op == 1:
            w.wait(w.push(ks, rng.normal(
                size=(len(ks), VL)).astype(np.float32)))
        elif op == 2:
            w.wait(w.set(ks, rng.normal(
                size=(len(ks), VL)).astype(np.float32)))
        elif op == 3:
            w.intent(ks, w.current_clock, w.current_clock + 4)
            w.advance_clock()
        elif op == 4 and plane is not None:
            sess = sessions["gold" if n_serves % 2 else None]
            n_serves += 1
            sess.lookup(rng.integers(0, NK, 16))
        elif op == 6:
            h = w.prepare_sample(8, w.current_clock,
                                 w.current_clock + 2)
            w.pull_sample(h, 4)
            w.pull_sample(h, 4)
            w.finish_sample(h)
        else:
            srv.wait_sync()
    srv.quiesce()


def _capture_storm(ctx, tmp_path, steps=40, key_budget=4096,
                   with_serve=True, sampling=False,
                   name="storm.wtrace"):
    """One seeded storm on the port under capture; returns the trace
    path after a clean shutdown (final flush)."""
    opts = SystemOptions(sync_max_per_sec=0, prefetch=False,
                         trace_workload=str(tmp_path / name),
                         trace_workload_keys=key_budget)
    srv = Server(NK, VL, opts=opts, ctx=ctx, num_workers=2)
    plane = ServePlane(srv) if with_serve else None
    _storm(srv, plane, steps, sampling)
    path = srv.opts.trace_workload
    if plane is not None:
        plane.close()
    srv.shutdown()
    return path


def _capture_storm_jax(tmp_path, steps, key_budget, sampling=False,
                       name="jax.wtrace"):
    """The same storm captured by the JAX package (its 8-device CPU
    mesh)."""
    from adapm_tpu.serve import ServePlane as JaxServePlane
    opts = adapm_tpu.SystemOptions(
        sync_max_per_sec=0, prefetch=False,
        trace_workload=str(tmp_path / name),
        trace_workload_keys=key_budget)
    srv = adapm_tpu.Server(NK, VL, opts=opts, ctx=adapm_tpu.make_mesh(8),
                           num_workers=2)
    plane = JaxServePlane(srv)
    _storm(srv, plane, steps, sampling)
    plane.close()
    srv.shutdown()
    return opts.trace_workload


# ---------------------------------------------------------------------------
# the off pin
# ---------------------------------------------------------------------------


def test_capture_off_pin(ctx):
    """Default server: no recorder, zero wtrace.* names, empty
    wtrace/replay snapshot sections."""
    srv = make_server(ctx)
    w = srv.make_worker(0)
    _seed(w)
    w.pull_sync(np.arange(8))
    assert srv.wtrace is None and srv.replay_stats is None
    assert not [n for n in srv.obs.names() if n.startswith("wtrace.")]
    snap = srv.metrics_snapshot()
    assert snap["schema_version"] == 3
    assert snap["wtrace"] == {} and snap["replay"] == {}
    srv.shutdown()


# ---------------------------------------------------------------------------
# capture mechanics
# ---------------------------------------------------------------------------


def test_capture_event_stream_and_clock_domains(ctx, tmp_path):
    path = _capture_storm(ctx, tmp_path)
    tr = load_wtrace(path)
    kinds = tr.kinds()
    for k in ("pull", "push", "set", "intent", "clock", "serve",
              "sync", "quiesce"):
        assert kinds.get(k, 0) >= 1, (k, kinds)
    monos = []
    for ev in tr.events:
        assert {"kind", "clock", "wall", "mono", "seq"} <= set(ev), ev
        monos.append(ev["mono"])
    assert monos == sorted(monos)
    sv = [e for e in tr.events if e["kind"] == "serve"]
    assert {e["tenant"] for e in sv} >= {None, "gold"}
    assert any(e["priority"] == 1 for e in sv)
    assert tr.meta["num_keys"] == NK
    assert tr.meta["value_lengths"] == VL
    assert tr.meta["num_shards"] == 8
    assert tr.meta["knobs"]["prefetch"] is False
    assert tr.dropped == 0


def test_capture_registers_metrics_and_snapshot_section(ctx, tmp_path):
    srv = make_server(ctx, tmp_path)
    w = srv.make_worker(0)
    _seed(w)
    w.pull_sync(np.arange(4))
    names = srv.obs.names()
    for n in ("wtrace.events_total", "wtrace.dropped_total",
              "wtrace.sampled_batches_total", "wtrace.bytes_written"):
        assert n in names, n
    snap = srv.metrics_snapshot()
    assert snap["wtrace"]["events_total"] >= 2
    assert snap["wtrace"]["path"] == srv.opts.trace_workload
    assert snap["wtrace"]["closed"] is False
    srv.shutdown()
    assert srv.metrics_snapshot()["wtrace"]["closed"] is True


def test_key_budget_lossless_or_loudly_sampled(ctx, tmp_path):
    opts = SystemOptions(sync_max_per_sec=0, prefetch=False,
                         trace_workload=str(tmp_path / "b.wtrace"),
                         trace_workload_keys=16)
    srv = Server(NK, VL, opts=opts, ctx=ctx)
    w = srv.make_worker(0)
    _seed(w)                      # set of 128 keys: sampled
    small = np.arange(10)
    w.pull_sync(small)            # exact
    big = np.arange(100)
    w.pull_sync(big)              # sampled
    assert int(srv.obs.find("wtrace.sampled_batches_total").value) == 2
    srv.shutdown()
    tr = load_wtrace(str(tmp_path / "b.wtrace"))
    pulls = [e for e in tr.events if e["kind"] == "pull"]
    exact = next(e for e in pulls if e["n"] == 10)
    assert exact["keys"] == [int(k) for k in small]
    assert "sampled" not in exact
    samp = next(e for e in pulls if e["n"] == 100)
    assert samp["sampled"] is True and "keys" not in samp
    assert 1 <= len(samp["sample"]) <= 16
    assert set(samp["sample"]) <= set(int(k) for k in big)
    k1 = event_keys(samp, rng=np.random.default_rng(5))
    k2 = event_keys(samp, rng=np.random.default_rng(5))
    assert len(k1) == 100 and np.array_equal(k1, k2)
    with pytest.raises(ValueError, match="key-sampled"):
        event_keys(samp)
    assert np.array_equal(event_keys(exact), small)


def test_event_buffer_bound_drops_loudly(ctx, tmp_path):
    opts = SystemOptions(sync_max_per_sec=0, prefetch=False,
                         trace_workload=str(tmp_path / "d.wtrace"))
    srv = Server(NK, VL, opts=opts, ctx=ctx)
    srv.wtrace.max_events = 4
    w = srv.make_worker(0)
    _seed(w)
    for _ in range(8):
        w.pull_sync(np.arange(4))
    assert int(srv.obs.find("wtrace.dropped_total").value) >= 4
    srv.shutdown()
    tr = load_wtrace(str(tmp_path / "d.wtrace"))
    assert len(tr.events) == 4 and tr.dropped >= 4


def test_flush_is_atomic_and_mid_run_readable(ctx, tmp_path):
    srv = make_server(ctx, tmp_path)
    w = srv.make_worker(0)
    _seed(w)
    w.pull_sync(np.arange(6))
    p = srv.wtrace.flush()
    mid = load_wtrace(p)
    assert mid.kinds().get("pull", 0) >= 1
    assert not list(tmp_path.glob("*.tmp")), "tmp file left behind"
    w.pull_sync(np.arange(6))
    srv.shutdown()
    assert len(load_wtrace(p).events) > len(mid.events)


# ---------------------------------------------------------------------------
# corruption: named error before any server exists
# ---------------------------------------------------------------------------


def test_corrupt_trace_raises_named_error(ctx, tmp_path):
    path = _capture_storm(ctx, tmp_path, steps=10, with_serve=False)
    raw = open(path, "rb").read()
    trunc = tmp_path / "trunc.wtrace"
    trunc.write_bytes(raw[:-20])
    with pytest.raises(WorkloadTraceError, match="bytes"):
        load_wtrace(str(trunc))
    nl = raw.find(b"\n")
    flip = bytearray(raw)
    flip[nl + 30] ^= 0xFF
    bad = tmp_path / "flip.wtrace"
    bad.write_bytes(bytes(flip))
    with pytest.raises(WorkloadTraceError, match="sha256"):
        load_wtrace(str(bad))
    hdr = json.loads(raw[:nl])
    hdr["version"] = WTRACE_VERSION + 1
    vbad = tmp_path / "v.wtrace"
    vbad.write_bytes(json.dumps(hdr).encode() + raw[nl:])
    with pytest.raises(WorkloadTraceError, match="version"):
        load_wtrace(str(vbad))
    junk = tmp_path / "junk.wtrace"
    junk.write_bytes(b"{}")
    with pytest.raises(WorkloadTraceError):
        load_wtrace(str(junk))
    with pytest.raises(WorkloadTraceError, match="cannot read"):
        load_wtrace(str(tmp_path / "missing.wtrace"))
    with pytest.raises(WorkloadTraceError):
        ReplayEngine(str(bad), device=CPU)


# ---------------------------------------------------------------------------
# the determinism property test
# ---------------------------------------------------------------------------


def test_capture_replay_determinism_property(ctx, tmp_path):
    """Same seed => bit-identical reads digest across runs, logical
    speeds and the value-preserving tier candidate; another seed moves
    it."""
    path = _capture_storm(ctx, tmp_path, steps=48, key_budget=12)
    tr = load_wtrace(path)
    assert tr.kinds().get("serve", 0) >= 1

    def run(**kw):
        return ReplayEngine(tr, device=CPU, **kw).run()

    r1 = run(seed=11, speed=100)
    r2 = run(seed=11, speed=100)
    assert r1["reads_digest"] == r2["reads_digest"]
    assert r1["reads"] == r2["reads"] > 0
    assert r1["events_replayed"] == r2["events_replayed"] > 0
    assert run(seed=11, speed=10.0)["reads_digest"] == r1["reads_digest"]
    r_tier = run(overrides={"tier": True, "tier_hot_rows": 16},
                 seed=11, speed=100)
    assert r_tier["reads_digest"] == r1["reads_digest"]
    assert r_tier["score"]["hot_hit_rate"] is not None
    assert run(seed=12, speed=100)["reads_digest"] != r1["reads_digest"]


@pytest.fixture
def port_sentinel():
    """The port's lock-order sentinel, off before the test and torn down
    after it (the shared conftest tears down only the JAX package's)."""
    from adapm_tpu_torch.lint import lockorder
    lockorder.disable_sentinel()
    yield lockorder
    lockorder.disable_sentinel()


def test_replay_rejects_bad_knobs_and_bad_speed(ctx, tmp_path,
                                                port_sentinel):
    path = _capture_storm(ctx, tmp_path, steps=8, with_serve=False)

    def run(overrides):
        return ReplayEngine(path, overrides=overrides, device=CPU).run()

    with pytest.raises(ValueError, match="unknown replay knob"):
        run({"hot_rows": 8})
    with pytest.raises(ValueError, match="speed"):
        ReplayEngine(path, speed=0)
    with pytest.raises(ValueError, match="metrics"):
        run({"metrics": False})
    with pytest.raises(ValueError, match="capture itself"):
        run({"trace_workload": "/tmp/x.wtrace"})
    for pin in ("serve_deadline_ms", "sync_max_per_sec", "prefetch"):
        with pytest.raises(ValueError, match="determinism pin"):
            run({pin: 1})
    # the lock-order sentinel's knob builds the replay's server with the
    # port's sentinel on, and the replay records edges and no violation
    run({"lint_lockorder": True})
    sen = port_sentinel.get_sentinel()
    assert sen is not None and sen.edges()
    sen.assert_clean()
    # recorded stream knobs are zeroed, as the JAX engine zeroes them:
    # every push the ingest issued is already in the op stream
    from adapm_tpu_torch.replay.engine import _build_opts
    trace = load_wtrace(path)
    trace.meta.setdefault("knobs", {}).update(
        stream_batch=32, stream_rate=2000.0, stream_freshness_slo_ms=400.0,
        stream_freshness_slo_class="1=200")
    opts, _ = _build_opts(trace, overrides=None)
    assert opts.stream_batch == 0 and opts.stream_rate == 0.0
    assert opts.stream_freshness_slo_ms == 0.0
    assert opts.stream_freshness_slo_class == ""


def test_replay_snapshot_section_and_decisions_skipped(ctx, tmp_path):
    path = _capture_storm(ctx, tmp_path, steps=32)
    tr = load_wtrace(path)
    assert tr.kinds().get("reloc", 0) >= 1
    res = replay_trace(tr, seed=1, speed=100, device=CPU)
    assert res["events_skipped"].get("reloc", 0) >= 1
    assert res["events_total"] == len(tr.events)
    res2 = ReplayEngine(tr, seed=1, device=CPU).run(include_snapshot=True)
    rep = res2["snapshot"]["replay"]
    assert rep["reads_digest"] == res["reads_digest"]
    assert rep["events_replayed"] == res["events_replayed"]
    assert rep["trace"] == path


def test_rank_candidates_artifact(ctx, tmp_path):
    path = _capture_storm(ctx, tmp_path, steps=24, with_serve=False)
    art = rank_candidates(
        path,
        {"hot_all": {"tier": True, "tier_hot_rows": NK},
         "hot_8": {"tier": True, "tier_hot_rows": 8}},
        objective="hot_hit_rate", seed=2, speed=100,
        out_path=str(tmp_path / "compare.json"), device=CPU)
    assert art["winner"] in ("hot_all", "hot_8")
    assert sorted(art["ranking"]) == ["hot_8", "hot_all"]
    assert art["objective"] == "hot_hit_rate"
    for name, cand in art["candidates"].items():
        assert cand["score"]["hot_hit_rate"] is not None, name
        assert cand["reads_digest"]
    s_all = art["candidates"]["hot_all"]["score"]["hot_hit_rate"]
    s_8 = art["candidates"]["hot_8"]["score"]["hot_hit_rate"]
    assert s_all >= s_8
    assert art["winner"] == "hot_all" or s_all == s_8
    on_disk = json.loads((tmp_path / "compare.json").read_text())
    assert on_disk["winner"] == art["winner"]
    with pytest.raises(ValueError, match="objective"):
        rank_candidates(path, {"a": None}, objective="nope", device=CPU)


def test_replay_inherits_recorded_knobs(ctx, tmp_path):
    from adapm_tpu_torch.replay.engine import _build_opts
    opts = SystemOptions(sync_max_per_sec=0, prefetch=False,
                         serve_max_batch=32, channels=2,
                         trace_workload=str(tmp_path / "k.wtrace"))
    srv = Server(NK, VL, opts=opts, ctx=ctx)
    w = srv.make_worker(0)
    _seed(w)
    srv.shutdown()
    tr = load_wtrace(str(tmp_path / "k.wtrace"))
    built, ns = _build_opts(tr, None)
    assert built.serve_max_batch == 32 and built.channels == 2
    assert ns == srv.ctx.num_shards
    assert built.sync_max_per_sec == 0 and built.prefetch is False
    assert built.trace_workload is None and built.metrics is True
    assert built.ckpt_every_s == 0.0 and built.stats_out is None
    built2, _ = _build_opts(tr, {"serve_max_batch": 16})
    assert built2.serve_max_batch == 16


def test_recorder_knob_validation():
    with pytest.raises(ValueError, match="workload_keys"):
        SystemOptions(trace_workload_keys=0).validate_serve()
    with pytest.raises(ValueError, match="path"):
        WorkloadTraceRecorder(None, "")


# ---------------------------------------------------------------------------
# the port's own surfaces
# ---------------------------------------------------------------------------


def test_replay_server_runs_on_the_card_unless_asked(monkeypatch,
                                                     ctx, tmp_path):
    """`run()` builds its server with adapm_tpu_torch.setup on the
    caller's device: the card by default, the CPU only when asked."""
    path = _capture_storm(ctx, tmp_path, steps=4, with_serve=False)
    seen = []
    real = at.setup

    def spy(*a, **kw):
        seen.append(kw.get("device"))
        return real(*a, **{**kw, "device": CPU})

    monkeypatch.setattr(at, "setup", spy)
    ReplayEngine(path).run()
    ReplayEngine(path, device=CPU).run()
    assert seen == [None, CPU]
    assert at.make_context(1, None).device.type == "cuda"
    assert per_shard_hot_rows(NK, 0.5, 8) == 8
    assert per_shard_hot_rows(1000, 0.5) == 500  # one shard by default


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


def _both_replays(path, seed=11):
    from adapm_tpu.replay import ReplayEngine as JaxReplayEngine
    from adapm_tpu.replay import load_wtrace as jax_load_wtrace
    a = JaxReplayEngine(jax_load_wtrace(path), seed=seed).run()
    b = ReplayEngine(load_wtrace(path), seed=seed, device=CPU).run()
    return a, b


def _same_replay(a, b):
    for k in ("reads_digest", "reads", "events_replayed",
              "events_total", "events_skipped"):
        assert a[k] == b[k], (k, a[k], b[k])


def test_jax_capture_replays_bitwise_on_both_packages(tmp_path):
    """The 5-plane storm captured by the JAX package (a key budget
    that samples the larger batches) replays to the same digest, reads
    and events in both packages."""
    path = _capture_storm_jax(tmp_path, steps=48, key_budget=12)
    a, b = _both_replays(path)
    assert a["reads"] > 0
    _same_replay(a, b)


def test_port_capture_loads_and_replays_bitwise_in_jax(ctx, tmp_path):
    """The storm captured by the port verifies in the JAX package's
    loader, and the JAX replay equals the port's."""
    from adapm_tpu.obs.wtrace import load_wtrace as jax_load_wtrace
    path = _capture_storm(ctx, tmp_path, steps=48, key_budget=12)
    jtr = jax_load_wtrace(path)
    ptr = load_wtrace(path)
    assert jtr.kinds() == ptr.kinds()
    assert jtr.meta == ptr.meta and jtr.events == ptr.events
    a, b = _both_replays(path)
    _same_replay(a, b)


@pytest.mark.parametrize("capturer", ["jax", "port"])
def test_sampling_trace_replays_bitwise_across_packages(ctx, tmp_path,
                                                        capturer):
    """A storm with managed sampling: its replays digest the sampled
    keys and values, and both packages draw the same."""
    if capturer == "jax":
        path = _capture_storm_jax(tmp_path, steps=40, key_budget=12,
                                  sampling=True)
    else:
        path = _capture_storm(ctx, tmp_path, steps=40, key_budget=12,
                              sampling=True)
    assert load_wtrace(path).kinds().get("pull_sample", 0) >= 2
    a, b = _both_replays(path)
    _same_replay(a, b)
