"""Decision telemetry on the port (adapm_tpu_torch/obs/decisions.py,
adapm_tpu_torch/replay/dataset.py) against the JAX package's.

The nine tests of tests/test_decisions.py run on the port at the same
size (NK=256, VL=4, 8 CPU shards, `device="cpu"`), with the JAX test's
own checks. The cross-package case holds the `.dtrace` format: a
decision trace captured by either package loads with the other's
`load_dtrace`, and both packages' `export_dataset` turn it (with its
`.wtrace`) into the same dataset, byte for byte.
"""
import json

import numpy as np
import pytest

import adapm_tpu
from adapm_tpu_torch import Server, SystemOptions, make_context
from adapm_tpu_torch.obs.decisions import (CORE_FEATURES, DTRACE_VERSION,
                                           DecisionRecorder,
                                           DecisionTraceError,
                                           load_dtrace)
from adapm_tpu_torch.replay import (ReplayEngine, dataset_bytes,
                                    export_dataset, load_wtrace)

NK = 256
VL = 4
CPU = "cpu"


@pytest.fixture(scope="module")
def ctx():
    return make_context(8, CPU)


def _drive(srv, steps):
    """test_decisions.py's seeded zipf pull/push/intent storm."""
    w0, w1 = srv.make_worker(0), srv.make_worker(1)
    w0.wait(w0.set(np.arange(NK), np.ones((NK, VL), np.float32)))
    rng = np.random.default_rng(17)
    for i in range(steps):
        w = w0 if i % 2 == 0 else w1
        ks = np.unique((NK * rng.random(16) ** 6.0)
                       .astype(np.int64).clip(0, NK - 1))
        w.pull_sync(ks)
        w.wait(w.push(ks, np.ones((len(ks), VL), np.float32)))
        if i % 4 == 0:
            w.intent(ks, w.current_clock, w.current_clock + 4)
            w.advance_clock()
        srv.wait_sync()
    srv.shutdown()


def _opts(mod, tmp_path, tag, decisions, wtrace, tier, tier_rows,
          window):
    return mod.SystemOptions(
        sync_max_per_sec=0, prefetch=False, tier=tier,
        tier_hot_rows=tier_rows,
        trace_decisions=str(tmp_path / f"{tag}.dtrace")
        if decisions else None,
        trace_decisions_window=window,
        trace_workload=str(tmp_path / f"{tag}.wtrace") if wtrace else None)


def _storm(ctx, tmp_path, tag, decisions=True, wtrace=False, steps=40,
           tier=True, tier_rows=16, window=4):
    """The storm on the port; returns (dtrace_path, wtrace_path, server)
    after shutdown (final flush)."""
    opts = _opts(__import__("adapm_tpu_torch"), tmp_path, tag, decisions,
                 wtrace, tier, tier_rows, window)
    srv = Server(NK, VL, opts=opts, ctx=ctx, num_workers=2)
    _drive(srv, steps)
    return opts.trace_decisions, opts.trace_workload, srv


def _storm_jax(tmp_path, tag, steps=24):
    opts = _opts(adapm_tpu, tmp_path, tag, True, True, True, 16, 4)
    srv = adapm_tpu.Server(NK, VL, opts=opts, ctx=adapm_tpu.make_mesh(8),
                           num_workers=2)
    _drive(srv, steps)
    return opts.trace_decisions, opts.trace_workload


# ---------------------------------------------------------------------------
# the off pin
# ---------------------------------------------------------------------------


def test_capture_off_pin(ctx):
    srv = Server(NK, VL, opts=SystemOptions(sync_max_per_sec=0), ctx=ctx)
    w = srv.make_worker(0)
    w.wait(w.set(np.arange(NK), np.ones((NK, VL), np.float32)))
    w.pull_sync(np.arange(8))
    assert srv.decisions is None
    assert not [n for n in srv.obs.names()
                if n.startswith("decision.")]
    snap = srv.metrics_snapshot()
    assert snap["schema_version"] == 3
    assert snap["decision"] == {}
    srv.shutdown()


# ---------------------------------------------------------------------------
# capture mechanics
# ---------------------------------------------------------------------------


def test_capture_storm_features_outcomes_and_clock_domains(ctx,
                                                           tmp_path):
    dpath, _, srv = _storm(ctx, tmp_path, "storm", steps=40)
    tr = load_dtrace(dpath)
    planes = tr.planes()
    for must in ("tier", "sync", "reloc"):
        assert planes.get(must, 0) >= 1, planes
    decisions, outcomes = tr.decisions(), tr.outcomes()
    assert decisions and outcomes
    monos = []
    for d in decisions:
        assert {"kind", "plane", "seq", "clock", "wall", "mono",
                "action", "features"} <= set(d), d
        for k in CORE_FEATURES:
            assert k in d["features"], (k, d)
        monos.append(d["mono"])
    assert monos == sorted(monos)
    seqs = {d["seq"] for d in decisions}
    for ref, oc in outcomes.items():
        assert ref in seqs
        assert oc["kind"] == "outcome" and "truncated" in oc
    closed = sum(1 for d in decisions if d["seq"] in outcomes)
    assert closed / len(decisions) >= 0.90
    assert tr.meta["knobs"]["tier"] is True
    assert tr.meta["follow_events"] == 4
    assert tr.dropped == 0


def test_capture_registers_metrics_and_snapshot_section(ctx, tmp_path):
    opts = SystemOptions(sync_max_per_sec=0, prefetch=False,
                         tier=True, tier_hot_rows=16,
                         trace_decisions=str(tmp_path / "m.dtrace"))
    srv = Server(NK, VL, opts=opts, ctx=ctx)
    w = srv.make_worker(0)
    w.wait(w.set(np.arange(NK), np.ones((NK, VL), np.float32)))
    rng = np.random.default_rng(2)
    for _ in range(6):
        ks = np.unique(rng.integers(0, NK, 24))
        w.pull_sync(ks)
        w.wait(w.push(ks, np.ones((len(ks), VL), np.float32)))
        srv.wait_sync()
    names = srv.obs.names()
    for n in ("decision.events_total", "decision.dropped_total",
              "decision.bytes_written", "decision.promoted_never_hit",
              "decision.replicated_never_read",
              "decision.shipped_clean", "decision.regret_rate.tier",
              "decision.regret_rate.sync"):
        assert n in names, n
    snap = srv.metrics_snapshot()
    assert snap["decision"]["path"] == opts.trace_decisions
    assert snap["decision"]["closed"] is False
    srv.shutdown()
    snap2 = srv.metrics_snapshot()
    assert snap2["decision"]["closed"] is True
    assert snap2["decision"]["events_total"] >= 1


def test_event_budget_drops_loudly(ctx, tmp_path):
    opts = SystemOptions(sync_max_per_sec=0, prefetch=False,
                         tier=True, tier_hot_rows=16,
                         trace_decisions=str(tmp_path / "d.dtrace"))
    srv = Server(NK, VL, opts=opts, ctx=ctx)
    srv.decisions.max_events = 4
    w = srv.make_worker(0)
    w.wait(w.set(np.arange(NK), np.ones((NK, VL), np.float32)))
    rng = np.random.default_rng(4)
    for _ in range(12):
        ks = np.unique(rng.integers(0, NK, 24))
        w.pull_sync(ks)
        w.wait(w.push(ks, np.ones((len(ks), VL), np.float32)))
        srv.wait_sync()
    assert int(srv.obs.find("decision.dropped_total").value) >= 1
    srv.shutdown()
    tr = load_dtrace(str(tmp_path / "d.dtrace"))
    assert len(tr.events) == 4 and tr.dropped >= 1


# ---------------------------------------------------------------------------
# the observer-effect pin
# ---------------------------------------------------------------------------


def test_decision_capture_does_not_steer_replay(ctx, tmp_path):
    """The same storm captured with decision telemetry on and off
    replays to a bit-identical reads digest."""
    d_on, w_on, _ = _storm(ctx, tmp_path, "on", decisions=True,
                           wtrace=True, steps=24, tier=False)
    _, w_off, _ = _storm(ctx, tmp_path, "off", decisions=False,
                         wtrace=True, steps=24, tier=False)
    assert load_dtrace(d_on).decisions()
    r_on = ReplayEngine(load_wtrace(w_on), seed=3, device=CPU).run()
    r_off = ReplayEngine(load_wtrace(w_off), seed=3, device=CPU).run()
    assert r_on["reads"] == r_off["reads"] > 0
    assert r_on["reads_digest"] == r_off["reads_digest"]


# ---------------------------------------------------------------------------
# corruption
# ---------------------------------------------------------------------------


def test_corrupt_dtrace_raises_named_error(ctx, tmp_path):
    dpath, _, _ = _storm(ctx, tmp_path, "c", steps=8)
    raw = open(dpath, "rb").read()
    trunc = tmp_path / "trunc.dtrace"
    trunc.write_bytes(raw[:-20])
    with pytest.raises(DecisionTraceError, match="bytes"):
        load_dtrace(str(trunc))
    nl = raw.find(b"\n")
    flip = bytearray(raw)
    flip[nl + 30] ^= 0xFF
    bad = tmp_path / "flip.dtrace"
    bad.write_bytes(bytes(flip))
    with pytest.raises(DecisionTraceError, match="sha256"):
        load_dtrace(str(bad))
    hdr = json.loads(raw[:nl])
    hdr["version"] = DTRACE_VERSION + 1
    vbad = tmp_path / "v.dtrace"
    vbad.write_bytes(json.dumps(hdr).encode() + raw[nl:])
    with pytest.raises(DecisionTraceError, match="version"):
        load_dtrace(str(vbad))
    _, w2, _ = _storm(ctx, tmp_path, "c2", wtrace=True, steps=8)
    with pytest.raises(DecisionTraceError, match="format"):
        load_dtrace(w2)
    with pytest.raises(DecisionTraceError, match="cannot read"):
        load_dtrace(str(tmp_path / "missing.dtrace"))
    with pytest.raises(DecisionTraceError):
        export_dataset(str(bad))


# ---------------------------------------------------------------------------
# dataset export
# ---------------------------------------------------------------------------


def test_dataset_export_deterministic_and_joined(ctx, tmp_path):
    dpath, wpath, _ = _storm(ctx, tmp_path, "ds", wtrace=True, steps=24)
    p1, p2 = tmp_path / "a.json", tmp_path / "b.json"
    art = export_dataset(dpath, wpath, out_path=str(p1))
    export_dataset(dpath, wpath, out_path=str(p2))
    assert p1.read_bytes() == p2.read_bytes()
    tr = load_dtrace(dpath)
    assert art["n_rows"] == len(tr.decisions()) > 0
    assert art["rows"] == sorted(art["rows"], key=lambda r: r["seq"])
    cols = set(art["columns"])
    for k in CORE_FEATURES:
        assert f"f.{k}" in cols, k
    for w in ("w.events_after", "w.keys_read_after",
              "w.keys_written_after"):
        assert w in cols, w
    for r in art["rows"]:
        if r["resolved"]:
            assert "outcome_latency_s" in r
        assert r["regret"] in (True, False, None)
    solo = export_dataset(dpath)
    assert solo["source"]["wtrace"] is None
    assert not [c for c in solo["columns"] if c.startswith("w.")]
    assert solo["n_rows"] == art["n_rows"]
    with pytest.raises(ValueError, match="horizon"):
        export_dataset(dpath, horizon_clocks=0)


def test_replay_refuses_to_capture_itself(ctx, tmp_path):
    _, wpath, _ = _storm(ctx, tmp_path, "r", wtrace=True, steps=8)
    with pytest.raises(ValueError, match="capture itself"):
        ReplayEngine(wpath, overrides={
            "trace_decisions": "/tmp/x.dtrace"}, device=CPU).run()


# ---------------------------------------------------------------------------
# recorder-level validation
# ---------------------------------------------------------------------------


def test_recorder_rejects_empty_path(ctx):
    srv = Server(NK, VL, opts=SystemOptions(sync_max_per_sec=0), ctx=ctx)
    with pytest.raises(ValueError, match="path"):
        DecisionRecorder(srv, "")
    srv.shutdown()


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capturer", ["jax", "port"])
def test_dtrace_loads_and_exports_the_same_across_packages(ctx, tmp_path,
                                                           capturer):
    """A `.dtrace` (with its `.wtrace`) from either package loads with
    the other's `load_dtrace` and both packages export the same dataset
    bytes from it."""
    from adapm_tpu.obs.decisions import load_dtrace as jax_load_dtrace
    from adapm_tpu.replay import dataset_bytes as jax_dataset_bytes
    from adapm_tpu.replay import export_dataset as jax_export_dataset
    if capturer == "jax":
        dpath, wpath = _storm_jax(tmp_path, "x")
    else:
        dpath, wpath, _ = _storm(ctx, tmp_path, "x", wtrace=True,
                                 steps=24)
    jtr, ptr = jax_load_dtrace(dpath), load_dtrace(dpath)
    assert jtr.meta == ptr.meta and jtr.events == ptr.events
    for must in ("tier", "sync", "reloc"):
        assert ptr.planes().get(must, 0) >= 1, ptr.planes()
    a = jax_export_dataset(dpath, wpath)
    b = export_dataset(dpath, wpath)
    assert a["rows"] == b["rows"] and a["n_rows"] > 0
    assert jax_dataset_bytes(a) == dataset_bytes(b)
