"""Request-flight tracing, the executor flight recorder and the metrics
reporter of the port (adapm_tpu_torch/obs/flight.py, obs/reporter.py)
against the JAX package's.

The flight, recorder and reporter cases of tests/test_flight.py run on
both packages (8 shards: the JAX package's 8-device CPU mesh beside the
port's `make_context(8, "cpu")`), each with the JAX test's own checks on
each package; what they read (served rows, export structure, counts,
the reporter's line) is compared across packages. The timestamps
themselves are host-clock readings and are not compared; the flow
structure they must satisfy is checked on each package. Every wait is
bounded.
"""
import json
import threading
import time

import numpy as np
import pytest

import adapm_tpu
import adapm_tpu_torch

NK = 96
VL = 4


class Pkg:
    def __init__(self, mod):
        self.mod = mod
        self.is_jax = mod is adapm_tpu
        self.Server = mod.Server
        self.SystemOptions = mod.SystemOptions
        self.flight = __import__(f"{mod.__name__}.obs.flight",
                                 fromlist=["x"])
        self.metrics = __import__(f"{mod.__name__}.obs.metrics",
                                  fromlist=["x"])
        self.slo = __import__(f"{mod.__name__}.obs.slo", fromlist=["x"])
        serve = __import__(f"{mod.__name__}.serve", fromlist=["x"])
        self.ServePlane = serve.ServePlane
        self.DeadlineExceededError = serve.DeadlineExceededError
        self._ctx = None

    def reporter(self):
        return __import__(f"{self.mod.__name__}.obs.reporter",
                          fromlist=["x"])

    def ctx(self):
        if self._ctx is None:
            if self.is_jax:
                self._ctx = adapm_tpu.make_mesh(8)
            else:
                self._ctx = adapm_tpu_torch.make_context(8, "cpu")
        return self._ctx

    def server(self, **kw):
        opts = kw.pop("opts", None) or self.SystemOptions(
            sync_max_per_sec=0)
        return self.Server(NK, VL, opts=opts, ctx=self.ctx(), **kw)


JAX, PORT = Pkg(adapm_tpu), Pkg(adapm_tpu_torch)


def _both(scenario, tmp_path=None):
    out = []
    for P in (JAX, PORT):
        if tmp_path is None:
            out.append(scenario(P))
        else:
            d = tmp_path / ("jax" if P.is_jax else "port")
            d.mkdir()
            out.append(scenario(P, d))
    a, b = out
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(np.asarray(x), np.asarray(y)), \
            f"result {i} differs across packages: {x!r} vs {y!r}"


def _seed(w):
    keys = np.arange(NK)
    vals = np.arange(NK * VL, dtype=np.float32).reshape(NK, VL)
    w.wait(w.set(keys, vals))
    return vals


def _load_flight(srv):
    path = srv.write_flight_trace()
    assert path is not None
    return json.load(open(path))


def _flow_chains(doc):
    chains = {}
    for e in doc["traceEvents"]:
        if e.get("ph") in ("s", "t", "f") and e.get("cat") == "flight":
            chains.setdefault(e["id"], []).append(e)
    return chains


def _phase_slices(P, doc):
    out = {n: [] for n in P.flight.FLIGHT_PHASES}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e["name"] in out:
            out[e["name"]].append(e)
    return out


def _flight_opts(P, d):
    return P.SystemOptions(sync_max_per_sec=0, trace_flight=True,
                           stats_out=str(d))


# -- flight tracing -----------------------------------------------------------


def sc_flow_export_walk(P, d):
    """A served lookup renders as one connected flow: 5 steps per trace
    id (s, t, t, t, f), each anchored inside an X slice of its causal
    phase that lists the id, with non-decreasing timestamps."""
    s = P.server(opts=_flight_opts(P, d))
    w = s.make_worker(0)
    _seed(w)
    got = []
    with P.ServePlane(s) as plane:
        sess = plane.session()
        for batch in (np.array([1, 5, 9]), np.array([7, 7, 3]),
                      np.array([42])):
            v = sess.lookup(batch)
            assert np.array_equal(v, w.pull_sync(batch))
            got.append(v)
    doc = _load_flight(s)
    s.shutdown()
    assert doc["adapm_flight"]["complete_flows"] >= 3
    chains = _flow_chains(doc)
    slices = _phase_slices(P, doc)
    assert len(chains) >= 3
    for trace_id, evs in chains.items():
        assert [e["ph"] for e in evs] == ["s", "t", "t", "t", "f"], \
            trace_id
        ts = [e["ts"] for e in evs]
        assert all(a <= b + 1e-3 for a, b in zip(ts, ts[1:])), \
            (trace_id, ts)
        for phase, ev in zip(P.flight.FLIGHT_PHASES, evs):
            hits = [sl for sl in slices[phase]
                    if sl["tid"] == ev["tid"]
                    and sl["ts"] - 1e-3 <= ev["ts"] <= sl["ts"]
                    + sl["dur"] + 1e-3
                    and trace_id in sl["args"]["traces"]]
            assert hits, (trace_id, phase, ev)
    assert all("traces" in p["args"] for p in slices["flight.program"])
    for b in slices["flight.batch"]:
        assert b["args"]["requests"] >= 1
        assert b["args"]["unique_keys"] <= b["args"]["keys"]
    return got + [len(chains)]


def sc_storm_every_chain_complete(P, d):
    """Concurrent serve clients vs a pusher, a relocator and a sync
    driver: every served lookup's chain is complete and no id dangles
    with a partial chain; the breakdown histograms saw every lookup."""
    s = P.server(opts=_flight_opts(P, d))
    w0, w1 = s.make_worker(0), s.make_worker(1)
    _seed(w0)
    plane = P.ServePlane(s)
    errs: list = []
    served = [0, 0]
    stop = threading.Event()

    def client(ci):
        try:
            sess = plane.session()
            rng = np.random.default_rng(100 + ci)
            for _ in range(20):
                assert sess.lookup(rng.integers(0, NK, 8)).shape == (8, VL)
                served[ci] += 1
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    def pusher():
        try:
            rng = np.random.default_rng(5)
            while not stop.is_set():
                ks = np.unique(rng.integers(0, NK, 6))
                w1.push(ks, rng.normal(size=(len(ks), VL))
                        .astype(np.float32))
                time.sleep(0.001)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    def relocator():
        try:
            rng = np.random.default_rng(11)
            while not stop.is_set():
                keys = np.unique(rng.integers(0, NK, 4))
                s._relocate_to(keys, int(rng.integers(0, s.num_shards)))
                time.sleep(0.002)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    def syncer():
        try:
            while not stop.is_set():
                with s._round_lock:
                    s.sync.run_round(all_channels=True)
                time.sleep(0.002)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    clients = [threading.Thread(target=client, args=(ci,))
               for ci in range(2)]
    churn = [threading.Thread(target=f)
             for f in (pusher, relocator, syncer)]
    for t in clients + churn:
        t.start()
    for t in clients:
        t.join(timeout=120)
        assert not t.is_alive(), "serve client hung"
    stop.set()
    for t in churn:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs[:3]
    n_served = sum(served)
    assert n_served == 40
    doc = _load_flight(s)
    assert doc["adapm_flight"]["complete_flows"] == n_served
    chains = _flow_chains(doc)
    assert len(chains) == n_served
    phase_ids, shed_ids = set(), set()
    for e in doc["traceEvents"]:
        if e.get("ph") != "X" or e["name"] not in P.flight.FLIGHT_PHASES:
            continue
        ids = set(e["args"]["traces"])
        phase_ids |= ids
        if e["args"].get("status") == "shed":
            shed_ids |= ids
    orphans = phase_ids - set(chains) - shed_ids
    assert not orphans, f"orphaned trace ids: {sorted(orphans)[:8]}"
    snap = s.metrics_snapshot()
    for h in ("queue_s", "batch_wait_s", "dispatch_s", "device_s"):
        assert snap["flight"][h]["count"] == n_served, h
    assert snap["flight"]["complete"] == n_served
    plane.close()
    s.shutdown()
    return [n_served]


def sc_shed_records_terminal_slice(P, d):
    s = P.server(opts=_flight_opts(P, d))
    _seed(s.make_worker(0))
    plane = P.ServePlane(s, start=False)
    sess = plane.session()
    with pytest.raises(P.DeadlineExceededError):
        sess.lookup(np.array([1]), deadline_ms=20)
    doc = _load_flight(s)
    assert doc["adapm_flight"]["complete_flows"] == 0
    assert _flow_chains(doc) == {}
    sheds = [e for e in doc["traceEvents"]
             if e.get("ph") == "X" and e["name"] == "flight.lookup"
             and e["args"].get("status") == "shed"]
    assert len(sheds) == 1
    plane.close()
    s.shutdown()
    return [len(sheds)]


def sc_worker_ops_single_segment(P, d):
    s = P.server(opts=_flight_opts(P, d))
    w = s.make_worker(0)
    _seed(w)
    got = w.pull_sync(np.array([1, 2]))
    w.push(np.array([1, 2]), np.ones((2, VL), np.float32))
    doc = _load_flight(s)
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"flight.kv.pull", "flight.kv.push", "flight.kv.set"} <= names
    assert s.flight.stats()["traces"] >= 3
    traces = s.flight.stats()["traces"]
    s.shutdown()
    return [got, sorted(n for n in names if n.startswith("flight.kv.")),
            traces]


def sc_off_default_untouched(P):
    s = P.server()
    w = s.make_worker(0)
    _seed(w)
    assert s.flight is None
    assert s.write_flight_trace() is None
    with P.ServePlane(s) as plane:
        got = plane.session().lookup(np.array([1, 2, 3]))
    assert not [n for n in s.obs.names() if n.startswith("flight.")]
    snap = s.metrics_snapshot()
    assert set(snap["flight"]) <= {"recorder"}
    s.shutdown()
    s2 = P.server(opts=P.SystemOptions(sync_max_per_sec=0, metrics=False))
    w2 = s2.make_worker(0)
    assert w2._h_pull is None and s2.spans is None and s2.flight is None
    s2.shutdown()
    return [got]


def sc_tracer_bounded_drops(P):
    tr = P.flight.FlightTracer(registry=None, max_slices=4)
    for _ in range(10):
        tr.record_op("kv.pull", time.perf_counter())
    st = tr.stats()
    assert st["slices"] == 4 and st["dropped"] == 6
    assert st["traces"] == 10
    return [sorted(st.items())]


def sc_freshness_probe_unit(P):
    p = P.flight.FreshnessProbe(registry=None, sample_every=1, bound=4)
    tok = p.note_push(np.array([5, 6]))
    assert tok == 5
    t_before = time.perf_counter()
    p.push_visible(tok)
    p.note_read(np.array([5, 9]), t_before)
    assert p.h_freshness.snap()["count"] == 0
    p.note_read(np.array([7]))
    assert p.h_freshness.snap()["count"] == 0
    p.note_read(np.array([5, 9]))
    assert p.h_freshness.snap()["count"] == 1
    p.note_read(np.array([5]))
    assert p.h_freshness.snap()["count"] == 1
    p.note_push(np.array([6]))
    p.note_read(np.array([6]))
    assert p.h_freshness.snap()["count"] == 1
    for k in range(100):
        assert p.note_push(np.array([100 + k])) == 100 + k
    assert len(p._pending) <= 4
    assert p.evicted > 0
    tok = p.note_push(np.array([999]))
    assert tok == 999
    p.push_visible(tok)
    p.note_read(np.array([999]))
    assert p.h_freshness.snap()["count"] == 2
    return [p.evicted, sorted(p._pending)]


def sc_freshness_probe_end_to_end(P, d):
    s = P.server(opts=_flight_opts(P, d))
    w = s.make_worker(0)
    _seed(w)
    with P.ServePlane(s) as plane:
        sess = plane.session()
        for _ in range(s.flight.freshness._sample):
            w.push(np.array([7]), np.ones((1, VL), np.float32))
        got = sess.lookup(np.array([7, 8]))
        snap = s.metrics_snapshot()
        assert snap["flight"]["freshness_s"]["count"] >= 1
        assert snap["flight"]["freshness_samples"] >= 1
    s.shutdown()
    return [got]


# -- the executor flight recorder (rides --sys.crash_dumps) -------------------


def sc_recorder_ring_and_crash_tail(P, d):
    s = P.server(opts=P.SystemOptions(sync_max_per_sec=0,
                                      stats_out=str(d)))
    w = s.make_worker(0)
    _seed(w)
    assert s.flight is None and s.flight_recorder is not None
    with P.ServePlane(s) as plane:
        sess = plane.session()
        for _ in range(4):
            got = sess.lookup(np.array([1, 2, 3]))
    tail = s.flight_recorder.tail()
    assert tail, "no executor programs recorded"
    assert {e["stream"] for e in tail} >= {"serve"}
    for e in tail:
        assert e["run_s"] >= 0.0 and e["wait_s"] >= 0.0
    serve_tail = s.flight_recorder.tail("serve")
    assert serve_tail and all(e["stream"] == "serve" for e in serve_tail)
    rec = s.metrics_snapshot()["flight"]["recorder"]
    assert rec["programs_recorded"] >= len(serve_tail)
    assert rec["per_stream"].get("serve", 0) >= 1
    rings = sorted(d.glob("adapm_flightring.*.log"))
    assert rings, "flight ring file missing"
    content = rings[-1].read_text()
    assert "stream=serve" in content and "label=serve.drain" in content
    s.shutdown()
    assert rings[-1].exists()
    return [got]


def sc_recorder_unit(P, d):
    path = str(d / "ring.log")
    rec = P.flight.FlightRecorder(path=path, per_stream=2, file_slots=4)
    for i in range(6):
        rec.record("sync", f"prog{i}", None, 0.001, 0.002)
    rec.record("serve", "drain", "serve.drain", 0.0, 0.001, failed=True)
    tail = rec.tail()
    assert [e["label"] for e in tail if e["stream"] == "sync"] \
        == ["prog4", "prog5"]
    assert tail[-1]["stream"] == "serve" and tail[-1]["failed"]
    assert rec.summary()["programs_recorded"] == 7
    assert rec.summary()["per_stream"] == {"serve": 1, "sync": 6}
    rec.close()
    data = open(path, "rb").read()
    assert len(data) <= 4 * 192
    assert b"FAILED" in data
    return [[(e["stream"], e["label"], e["failed"]) for e in tail],
            sorted(rec.summary()["per_stream"].items())]


class _FakeBatcher:
    def __init__(self, wait_us, h):
        self.max_wait_us = wait_us
        self.h_latency = h


class _FakeServer:
    def __init__(self, P):
        self.obs = P.metrics.MetricsRegistry()
        self.decisions = None
        self.policy = None


def sc_clock_domains_recorded(P, d):
    """The recorder ring and the SLO move log each stamp wall time and a
    monotonic clock; the merged tail is ordered by the monotonic one."""
    rec = P.flight.FlightRecorder(path=str(d / "r.log"))
    m0, w0 = time.monotonic(), time.time()
    rec.record("sync", "a", None, 0.0, 0.001)
    rec.record("serve", "b", None, 0.0, 0.001)
    m1, w1 = time.monotonic(), time.time()
    tail = rec.tail()
    assert len(tail) == 2
    for e in tail:
        assert m0 <= e["t_mono"] <= m1
        assert w0 <= e["t"] <= w1 + 1.0
    assert tail[0]["t_mono"] <= tail[1]["t_mono"]
    rec.close()
    h = P.metrics.Histogram("serve.latency_s",
                            bounds=P.metrics.SERVE_LATENCY_BOUNDS_S)
    b = _FakeBatcher(20_000, h)
    c = P.slo.SLOController(_FakeServer(P), b, target_ms=10.0)
    c._control()
    m0 = time.monotonic()
    for _ in range(10):
        h.observe(0.050)
    c._control()
    m1 = time.monotonic()
    rep = c.report()
    assert rep["adjustments"] == 1
    first = rep["first_adjustment"]
    last = rep["recent_adjustments"][-1]
    for entry in (first, last):
        assert m0 <= entry["t_mono"] <= m1
        assert entry["t"] > 1e9
    assert first == last
    return [[e["stream"] for e in tail], b.max_wait_us]


# -- the reporter -------------------------------------------------------------


def sc_hist_percentile_edges(P):
    hp = P.metrics.hist_percentile
    h = P.metrics.Histogram("t.h", bounds=(1.0, 10.0))
    out = [hp(h.snap(), 0.99)]
    for v in (0.5, 5.0, 100.0, 200.0):
        h.observe(v)
    assert hp(h.snap(), 0.99) == 10.0
    assert hp(h.snap(), 0.75) == 10.0
    p50 = hp(h.snap(), 0.50)
    assert 1.0 <= p50 <= 10.0
    h2 = P.metrics.Histogram("t.h2", bounds=(1.0, 10.0))
    for _ in range(5):
        h2.observe(50.0)
    assert hp(h2.snap(), 0.50) == 10.0
    h3 = P.metrics.Histogram("t.h3", bounds=(8.0,))
    for v in (2.0, 4.0, 6.0, 8.0):
        h3.observe(v)
    assert 0.0 < hp(h3.snap(), 0.50) <= 8.0
    h3.observe(100.0)
    assert hp(h3.snap(), 0.99) == 8.0
    assert out == [0.0]
    return [p50, hp(h3.snap(), 0.50)]


def sc_reporter_line_format(P):
    fmt = P.reporter()._fmt
    assert fmt({}) == "no activity yet"
    snap = {
        "kv": {"pull_s": {"count": 2, "avg": 1.05e-3}},
        "serve": {"lookups_total": 4,
                  "latency_s": {"count": 4, "bounds": [0.001],
                                "buckets": [4, 0]}},
        "exec": {"programs_total": 3, "overlap_fraction": 0.25},
        "tier": {"hot_hits": 9, "cold_hits": 1, "hot_hit_rate": 0.9},
        "flight": {"freshness_s": {"count": 2, "bounds": [0.002],
                                   "buckets": [2, 0]}},
        "decision": {"events_total": 10, "regret_rate.tier": 0.25,
                     "regret_rate.sync": 0.10},
    }
    line = fmt(snap)
    assert line == ("pull=2 avg=1.05ms serve=4 p50=0.50ms p99=0.99ms "
                    "overlap=0.25 hot_hit=0.90 fresh=1.98ms regret=0.25")
    snap["net"] = {"msgs_out": 12, "bytes_out": 3456,
                   "peers_live": 2, "peers_total": 3}
    assert fmt(snap).endswith(" net=12/3456 peers=2/3")
    assert fmt({"serve": {"latency_s": {"count": 0}},
                "exec": {"programs_total": 0},
                "tier": {"hot_hits": 0, "cold_hits": 0},
                "flight": {"freshness_s": {"count": 0}},
                "decision": {"events_total": 0, "regret_rate.tier": 0.0},
                "net": {"msgs_out": 0, "msgs_in": 0, "peers_live": 1,
                        "peers_total": 1}}) == "no activity yet"
    return [line, fmt(snap)]


def sc_reporter_logs_lines_while_serving(P, d):
    """`--sys.metrics.report` starts a reporter that logs a line each
    interval while the server serves; shutdown stops it."""
    lines = []
    log = __import__(f"{P.mod.__name__}.utils.log", fromlist=["x"])
    orig = log.alog

    def capture(*parts, **kw):
        lines.append(" ".join(str(p) for p in parts))

    # the reporter thread binds `alog` when it starts
    log.alog = capture
    try:
        s = P.server(opts=P.SystemOptions(sync_max_per_sec=0,
                                          metrics_report_s=0.05,
                                          stats_out=str(d)))
        rep = s._reporter
        assert rep is not None
        w = s.make_worker(0)
        _seed(w)
        with P.ServePlane(s) as plane:
            sess = plane.session()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not any(
                    "serve=" in ln for ln in lines):
                sess.lookup(np.array([1, 2, 3]))
                time.sleep(0.01)
        s.shutdown()
    finally:
        log.alog = orig
    assert s._reporter is None and rep._thread is None
    mine = [ln for ln in lines if ln.startswith("[metrics r0] ")]
    assert any("serve=" in ln and "p99=" in ln for ln in mine), lines[-3:]
    return []


@pytest.mark.parametrize("scenario", [
    sc_flow_export_walk, sc_storm_every_chain_complete,
    sc_shed_records_terminal_slice, sc_worker_ops_single_segment,
    sc_freshness_probe_end_to_end, sc_recorder_ring_and_crash_tail,
    sc_recorder_unit, sc_clock_domains_recorded,
    sc_reporter_logs_lines_while_serving],
    ids=lambda f: f.__name__[3:])
def test_flight_scenario_both_packages(scenario, tmp_path):
    _both(scenario, tmp_path)


@pytest.mark.parametrize("scenario", [
    sc_off_default_untouched, sc_tracer_bounded_drops,
    sc_freshness_probe_unit, sc_hist_percentile_edges,
    sc_reporter_line_format], ids=lambda f: f.__name__[3:])
def test_flight_unit_both_packages(scenario):
    _both(scenario)


def test_flight_off_default_untouched():
    """The off pin on the port alone (the ISSUE's named case): no tracer,
    zero flight.* names, the worker wrapper degrades to a plain call."""
    sc_off_default_untouched(PORT)
