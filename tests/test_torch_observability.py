"""The twin of tests/test_observability.py: the port's telemetry
(adapm_tpu_torch/obs: the metrics registry, span traces, crash dumps,
the reporter; utils/stats.py trace and locality files) against the JAX
package's, case by case.

Each of the seventeen cases runs on both packages (8 shards: the JAX
package's 8-device CPU mesh beside the port's `make_context(8, "cpu")`)
with the JAX test's own checks on each package, and returns what must
agree across packages (counts, event sets, file columns and rows without
their time stamps, reads), which is compared exactly. Each package's
snapshot keeps its own schema version and section list (the port has no
multi-process or streaming sections yet).
"""
import json
import sys
import threading

import numpy as np
import pytest

import adapm_tpu
import adapm_tpu_torch


class Pkg:
    def __init__(self, mod):
        self.mod = mod
        self.name = mod.__name__
        self.is_jax = mod is adapm_tpu
        self.SystemOptions = mod.SystemOptions
        self.CLOCK_MAX = __import__(f"{self.name}.base",
                                    fromlist=["x"]).CLOCK_MAX
        self.stats = __import__(f"{self.name}.utils.stats", fromlist=["x"])
        self.metrics = __import__(f"{self.name}.obs.metrics",
                                  fromlist=["x"])
        self.utils = __import__(f"{self.name}.utils", fromlist=["x"])
        self.schema = 16 if self.is_jax else 3

    def setup(self, num_keys, vlen, opts, num_workers=None):
        if self.is_jax:
            return adapm_tpu.setup(num_keys, vlen, opts=opts,
                                   num_workers=num_workers)
        return adapm_tpu_torch.setup(num_keys, vlen, opts=opts,
                                     num_shards=8, device="cpu",
                                     num_workers=num_workers)


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
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert np.array_equal(np.asarray(x), np.asarray(y)), i
        else:
            assert x == y, f"result {i} differs: {x!r} vs {y!r}"


# -- reference surfaces (trace events, locality, sync report) -----------------


def sc_parse_trace_spec(P):
    pts = P.stats.parse_trace_spec
    assert len(pts("all", 10)) == 10
    ks = pts("3,7,7,1", 10)
    assert ks.tolist() == [1, 3, 7]
    r = pts("random-5-seed-3-range-0-100", 1000)
    assert len(r) <= 5 and r.max() < 100
    assert pts("", 10) is None
    return [r.tolist()]


def sc_trace_events_and_locality_files(P, d):
    opts = P.SystemOptions(trace_keys="all", locality_stats=True,
                           stats_out=str(d), sync_max_per_sec=0,
                           cache_slots_per_shard=16)
    srv = P.setup(32, 4, opts)
    w0, w1 = srv.make_worker(0), srv.make_worker(1)
    keys = np.arange(8, dtype=np.int64)
    w0.set(keys, np.ones((8, 4), np.float32))
    w0.pull_sync(keys)
    w0.intent(np.array([5]), 0, P.CLOCK_MAX)
    w1.intent(np.array([5]), 0, P.CLOCK_MAX)
    w0.intent(np.array([9]), 0, P.CLOCK_MAX)
    srv.wait_sync()
    got = w0.pull_sync(np.array([5, 9]))
    files = srv.write_stats()
    srv.shutdown()
    paths = {p.split("/")[-1] for p in files}
    assert "traces.0.tsv" in paths
    assert "locality_stats.rank.0.tsv" in paths
    trace = (d / "traces.0.tsv").read_text().splitlines()
    events = {ln.split("\t")[2] for ln in trace[1:]}
    assert "ALLOC" in events and "INTENT_START" in events
    assert ("REPLICA_SETUP" in events) or ("RELOCATE" in events)
    loc = (d / "locality_stats.rank.0.tsv").read_text().splitlines()
    assert loc[0].startswith("key\taccesses")
    rows = {int(ln.split("\t")[0]): [int(x) for x in ln.split("\t")[1:]]
            for ln in loc[1:]}
    for k, (acc, local, _samp) in rows.items():
        assert acc >= local
    # the trace rows without their time column; the locality file's
    # header and keys (its counts move with the background prefetch
    # pipeline's timing in either package: a staged gather that lands
    # before the pull counts one more access)
    no_time = sorted(tuple(ln.split("\t")[1:]) for ln in trace[1:])
    return [np.asarray(got), sorted(events), loc[0], sorted(rows),
            no_time]


def sc_locality_counts_fused_path(P):
    opts = P.SystemOptions(locality_stats=True, sync_max_per_sec=0)
    srv = P.setup(16, 8, opts)
    w = srv.make_worker(0)
    w.set(np.arange(16), np.ones((16, 8), np.float32))
    if P.is_jax:
        from adapm_tpu.ops import FusedStepRunner

        def loss_fn(embs, aux):
            return (embs["x"] ** 2).mean()
    else:
        from adapm_tpu_torch.ops import FusedStepRunner

        def loss_fn(embs, aux):
            return (embs["x"] ** 2).mean()
    runner = FusedStepRunner(srv, loss_fn, role_class={"x": 0},
                             role_dim={"x": 4})
    runner({"x": np.arange(8, dtype=np.int64)}, None, 0.1)
    acc = int(srv.locality.accesses.sum())
    assert acc >= 8
    summ = srv.locality_summary()
    srv.shutdown()
    return [acc, {k: round(v, 9) for k, v in summ.items() if v == v}]


def sc_sync_report_string(P):
    srv = P.setup(8, 2, P.SystemOptions(sync_max_per_sec=0))
    w = srv.make_worker(0)
    w.intent(np.arange(4), 0, 10)
    srv.wait_sync()
    rep = srv.sync.report()
    assert "rounds=" in rep and "intents=" in rep
    srv.shutdown()
    return [rep]


# -- the registry -------------------------------------------------------------


def sc_counter_sharded_across_threads(P):
    c = P.metrics.Counter("t.c")
    threads = [threading.Thread(
        target=lambda: [c.inc() for _ in range(1000)]) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 4000
    return [c.value]


def sc_histogram_bucket_counts(P):
    h = P.metrics.Histogram("t.h", bounds=(1.0, 10.0, 100.0))
    for v in (0.5, 0.1, 1.0, 5.0, 50.0, 500.0):
        h.observe(v)
    s = h.snap()
    assert s["buckets"] == [3, 1, 1, 1]
    assert s["count"] == 6 and sum(s["buckets"]) == s["count"]
    assert s["max"] == 500.0
    assert abs(s["sum"] - 556.6) < 1e-9
    assert s["bounds"] == [1.0, 10.0, 100.0]
    return [sorted(s.items())]


def sc_duplicate_metric_name_check(P):
    reg = P.metrics.MetricsRegistry()
    reg.counter("a.b")
    with pytest.raises(ValueError):
        reg.counter("a.b")
    with pytest.raises(ValueError):
        reg.histogram("a.b", shared=True)
    c1 = reg.counter("a.c", shared=True)
    c2 = reg.counter("a.c", shared=True)
    assert c1 is c2
    return [reg.names()]


def sc_registry_snapshot_sections_and_gauges(P):
    reg = P.metrics.MetricsRegistry()
    reg.counter("kv.ops").inc(3)
    reg.gauge("staging.occ", fn=lambda: 7)
    reg.histogram("sync.lat_s").observe(0.01)
    s = reg.snapshot()
    assert s["kv"]["ops"] == 3
    assert s["staging"]["occ"] == 7
    assert s["sync"]["lat_s"]["count"] == 1
    return [json.dumps(s, sort_keys=True)]


def sc_counter_group_legacy_dict_api(P):
    reg = P.metrics.MetricsRegistry()
    g = P.metrics.CounterGroup(reg, "prefetch", ("hits", "staged"))
    g.inc("hits")
    g["staged"] += 2
    assert g["hits"] == 1 and g["staged"] == 2
    assert dict(g.items()) == {"hits": 1, "staged": 2}
    assert reg.snapshot()["prefetch"] == {"hits": 1, "staged": 2}
    return [dict(g.items())]


# -- Server.metrics_snapshot end to end ---------------------------------------


def _run_instrumented(P, opts, n_keys=32, vlen=4):
    srv = P.setup(n_keys, vlen, opts, num_workers=2)
    w = srv.make_worker(0)
    keys = np.arange(8, dtype=np.int64)
    w.set(keys, np.ones((8, vlen), np.float32))
    w.pull_sync(keys)
    w.intent(keys, 0, 100)
    if srv.prefetch is not None:
        srv.prefetch.flush()
    w.pull_sync(keys)
    w.push(keys, np.ones((8, vlen), np.float32))
    srv.wait_sync()
    return srv, w


def sc_metrics_snapshot_schema_stable(P):
    srv, w = _run_instrumented(P, P.SystemOptions(
        sync_max_per_sec=0, prefetch_pull="always"))
    snap = srv.metrics_snapshot()
    assert snap["schema_version"] == P.schema and snap["metrics_enabled"]
    assert snap["serve"] == {} and snap["tier"] == {}
    assert snap["slo"] == {}
    # flight tracing is off; the executor flight recorder rides
    # --sys.crash_dumps (on by default)
    assert set(snap["flight"]) == {"recorder"}
    assert snap["flight"]["recorder"]["programs_recorded"] >= 0
    assert snap["fault"] == {} and snap["ckpt"] == {}
    for sec in srv._SNAPSHOT_SECTIONS:
        assert isinstance(snap[sec], dict), sec
    assert snap["sync"]["keys_shipped"] == snap["sync"]["keys_synced"]
    assert snap["sync"]["keys_considered"] >= snap["sync"]["keys_synced"]
    assert snap["sync"]["replicas_live"] >= 0
    assert 0.0 <= snap["sync"]["dirty_fraction"] <= 1.0
    assert "replicas_live.c0" in snap["sync"]
    assert snap["kv"]["pull_s"]["count"] >= 2
    assert snap["kv"]["push_s"]["count"] >= 1
    assert snap["kv"]["pull_ops"] >= 2
    assert 0.0 <= snap["kv"]["local_answer_frac"] <= 1.0
    assert snap["prefetch"]["staged"] >= 1 and snap["prefetch"]["hits"] >= 1
    assert snap["plan_cache"]["hits"] + snap["plan_cache"]["misses"] >= 1
    assert snap["staging"]["rows_hwm"] >= 1
    assert snap["sync"]["rounds"] >= 1
    assert snap["sync"]["round_s"]["count"] >= 1
    json.dumps(snap)
    snap2 = srv.metrics_snapshot()
    assert set(snap2) == set(snap)
    for sec in srv._SNAPSHOT_SECTIONS:
        assert set(snap2[sec]) == set(snap[sec]), sec
    srv.shutdown()
    return [snap["kv"]["pull_ops"], snap["prefetch"]["hits"],
            snap["sync"]["keys_shipped"], snap["kv"]["local_answer_frac"]]


def sc_snapshot_single_source_for_legacy_views(P):
    srv, w = _run_instrumented(P, P.SystemOptions(
        sync_max_per_sec=0, prefetch_pull="always"))
    snap = srv.metrics_snapshot()
    for k, v in srv.prefetch.stats.items():
        assert snap["prefetch"][k] == v
    pc = srv._plan_cache.stats()
    for k in ("hits", "misses", "stale"):
        assert snap["plan_cache"][k] == pc[k]
    srv.shutdown()
    return [dict(srv.prefetch.stats.items())]


def sc_metrics_off_no_reporter_import(P):
    mod = f"{P.name}.obs.reporter"
    sys.modules.pop(mod, None)
    srv, w = _run_instrumented(P, P.SystemOptions(sync_max_per_sec=0,
                                                  metrics=False))
    assert not srv.obs.enabled
    assert srv.obs.names() == []
    snap = srv.metrics_snapshot()
    assert snap["metrics_enabled"] is False
    for sec in srv._SNAPSHOT_SECTIONS:
        assert snap[sec] == {}, sec
    assert w._h_pull is None
    assert srv.prefetch.stats["hits"] >= 1
    assert mod not in sys.modules
    srv.shutdown()
    return [srv.prefetch.stats["hits"]]


def sc_metrics_reporter_runs_and_stops(P):
    srv, w = _run_instrumented(P, P.SystemOptions(sync_max_per_sec=0,
                                                  metrics_report_s=0.05))
    assert srv._reporter is not None
    fmt = __import__(f"{P.name}.obs.reporter", fromlist=["x"])._fmt
    line = fmt(srv.obs.snapshot())
    assert "pull=" in line
    srv.shutdown()
    assert srv._reporter is None
    return [line.split(" avg=")[0]]


# -- span traces + crash breadcrumbs ------------------------------------------


def sc_span_trace_chrome_json(P, d):
    opts = P.SystemOptions(sync_max_per_sec=0, trace_spans=True,
                           stats_out=str(d), prefetch_pull="always")
    srv, w = _run_instrumented(P, opts)
    path = srv.write_trace()
    srv.shutdown()
    doc = json.load(open(path))
    evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert evs, "no complete events recorded"
    names = {e["name"] for e in evs}
    must = ("kv.pull", "kv.push", "kv.set", "kv.plan_pull", "sync.round",
            "sync.drain_intents", "prefetch.stage", "prefetch.take")
    for m in must:
        assert m in names, m
    for e in evs:
        assert e["ts"] >= 0 and e["dur"] >= 0 and e["pid"] == 0
    assert any(e.get("ph") == "M" and e.get("name") == "thread_name"
               for e in doc["traceEvents"])
    return [sorted(m for m in must if m in names)]


def sc_crash_dump_and_breadcrumb(P, d):
    import faulthandler
    import os
    opts = P.SystemOptions(sync_max_per_sec=0, trace_spans=True,
                           stats_out=str(d))
    srv, w = _run_instrumented(P, opts)
    assert faulthandler.is_enabled()
    assert os.path.exists(srv.crash_dump_path)
    assert os.path.dirname(srv.crash_dump_path) == str(d)
    bc = sorted(d.glob("adapm_breadcrumb.*.txt"))
    assert bc, "breadcrumb file missing"
    content = bc[-1].read_text().split()[0]
    assert content.split(".")[0] in ("kv", "sync", "prefetch",
                                     "collective")
    srv.shutdown()
    return [len(bc), len(sorted(d.glob("adapm_crash.*.log")))]


def sc_trace_event_ordering_and_columns(P, d):
    opts = P.SystemOptions(trace_keys="all", locality_stats=True,
                           stats_out=str(d), sync_max_per_sec=0,
                           cache_slots_per_shard=16, metrics=False)
    srv = P.setup(32, 4, opts)
    w0, w1 = srv.make_worker(0), srv.make_worker(1)
    keys = np.arange(8, dtype=np.int64)
    w0.set(keys, np.ones((8, 4), np.float32))
    w0.intent(np.array([5]), 0, 1)
    w1.intent(np.array([5]), 0, 1)
    srv.wait_sync()
    w0.pull_sync(np.array([5]))
    for _ in range(4):
        w0.advance_clock()
        w1.advance_clock()
    srv.wait_sync()
    srv.write_stats()
    srv.shutdown()
    trace = (d / "traces.0.tsv").read_text().splitlines()
    assert trace[0] == "\t".join(P.stats.TRACE_COLUMNS)
    rows = [ln.split("\t") for ln in trace[1:]]
    keyed = [(float(t), int(k), e, int(s)) for t, k, e, s in rows]
    assert keyed == sorted(keyed)
    by_key = {}
    for t, k, e, s in keyed:
        by_key.setdefault(k, []).append((t, e))
    for k, evs in by_key.items():
        times = {e: t for t, e in reversed(evs)}
        if "REPLICA_SETUP" in times:
            assert "ALLOC" in times
            assert times["ALLOC"] <= times["REPLICA_SETUP"], k
        starts = [t for t, e in evs if e == "INTENT_START"]
        stops = [t for t, e in evs if e == "INTENT_STOP"]
        assert len(stops) <= len(starts)
        if stops:
            assert min(starts) <= min(stops)
    assert any(e == "INTENT_STOP" for _, k, e, _ in keyed)
    loc = (d / "locality_stats.rank.0.tsv").read_text().splitlines()
    assert loc[0] == "\t".join(P.stats.LOCALITY_COLUMNS)
    ks = [int(ln.split("\t")[0]) for ln in loc[1:]]
    assert ks == sorted(ks)
    return [list(P.stats.TRACE_COLUMNS), list(P.stats.LOCALITY_COLUMNS),
            sorted((k, e, s) for _, k, e, s in keyed), loc]


def sc_stopwatch_concurrent_readers(P):
    import time
    sw = P.utils.Stopwatch()
    stop = threading.Event()
    errs = []

    def hammer():
        try:
            while not stop.is_set():
                sw.start()
                sw.stop()
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    def read():
        try:
            last = -1.0
            while not stop.is_set():
                v = sw.elapsed_s
                assert v >= 0.0
                assert v >= last - 1e-3
                last = v
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=hammer),
               threading.Thread(target=hammer),
               threading.Thread(target=read)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join()
    assert not errs, errs
    assert sw.elapsed_s >= 0.0
    return []


_PLAIN = [sc_parse_trace_spec, sc_locality_counts_fused_path,
          sc_sync_report_string, sc_counter_sharded_across_threads,
          sc_histogram_bucket_counts, sc_duplicate_metric_name_check,
          sc_registry_snapshot_sections_and_gauges,
          sc_counter_group_legacy_dict_api,
          sc_metrics_snapshot_schema_stable,
          sc_snapshot_single_source_for_legacy_views,
          sc_metrics_off_no_reporter_import,
          sc_metrics_reporter_runs_and_stops,
          sc_stopwatch_concurrent_readers]
_WITH_DIR = [sc_trace_events_and_locality_files, sc_span_trace_chrome_json,
             sc_crash_dump_and_breadcrumb,
             sc_trace_event_ordering_and_columns]


@pytest.mark.parametrize("scenario", _PLAIN, ids=lambda f: f.__name__[3:])
def test_observability_both_packages(scenario):
    _both(scenario)


@pytest.mark.parametrize("scenario", _WITH_DIR,
                         ids=lambda f: f.__name__[3:])
def test_observability_files_both_packages(scenario, tmp_path):
    _both(scenario, tmp_path)


def test_crash_dumps_on_by_default_as_in_jax():
    """`--sys.crash_dumps` defaults to on in both packages, in the
    options and on the command line."""
    import argparse
    for P in (JAX, PORT):
        assert P.SystemOptions().crash_dumps is True
        p = argparse.ArgumentParser()
        P.SystemOptions.add_arguments(p)
        assert P.SystemOptions.from_args(p.parse_args([])).crash_dumps
        assert not P.SystemOptions.from_args(
            p.parse_args(["--sys.crash_dumps", "0"])).crash_dumps
