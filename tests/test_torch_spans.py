"""The port's program spans (adapm_tpu_torch/obs/spans.py `span`): one
entry point with two sinks, the span tracer (Chrome JSON, behind
`--sys.trace.spans`) and torch.profiler's trace, where a span is the
range `adapm.<name>` on the profiler's clock. With neither sink active a
site gets the shared NULL_SPAN. The eval program (models/kge.py) opens
`eval.rows`, `eval.queries` and `eval.k4` once a call, in that order.
CPU only, no JAX."""
import json

import numpy as np
import pytest
import torch

import adapm_tpu_torch as at
from adapm_tpu_torch.models import kge
from adapm_tpu_torch.obs import NULL_SPAN, SpanTracer, span
from adapm_tpu_torch.obs.spans import profiling


def _profiled(fn):
    """fn() under the CPU profiler that torch.profiler drives (its own
    first start imports the compiler stack, seconds): the names of its
    adapm.* ranges in the order they began."""
    with torch.autograd.profiler.profile() as prof:
        fn()
    evs = sorted((e.time_range.start, e.name) for e in prof.function_events
                 if e.name.startswith("adapm."))
    return [n for _, n in evs]


def _server(**kw):
    return at.setup(32, 4, num_shards=2, device="cpu", num_workers=1,
                    opts=at.SystemOptions(sync_max_per_sec=0,
                                          prefetch=False, **kw))


def test_no_sink_is_null_span():
    assert not profiling()
    assert span(None, "x") is NULL_SPAN
    srv = _server()
    try:
        assert srv.spans is None and srv._span("kv.plan_pull") is NULL_SPAN
    finally:
        srv.shutdown()


def test_tracer_only_keeps_the_chrome_export(tmp_path):
    t = SpanTracer(rank=3)
    with span(t, "sync.round"):
        pass
    doc = json.load(open(t.export(str(tmp_path / "t.json"))))
    ev, = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert set(ev) == {"name", "cat", "ph", "ts", "dur", "pid", "tid"}
    assert (ev["name"], ev["cat"], ev["pid"]) == ("sync.round", "adapm", 3)
    assert ev["ts"] >= 0 and ev["dur"] >= 0


@pytest.mark.parametrize("with_tracer", [False, True],
                         ids=["profiler", "profiler+tracer"])
def test_profiler_sees_the_span(with_tracer):
    t = SpanTracer() if with_tracer else None

    def fn():
        with span(t, "eval.rows"):
            torch.ones(3).sum()

    assert _profiled(fn) == ["adapm.eval.rows"]
    assert (t.stats()["events"] if t else 1) == 1


def _eval_case(model, d=4, E=40, R=3, B=5, chunk=16, seed=1):
    """A tiny pool on the CPU with entities and relations in one class."""
    rng = np.random.default_rng(seed)
    ent_dim = 2 * d if model == "complex" else d
    rel_dim = 2 * d if model == "complex" else d * d
    L = 2 * max(ent_dim, rel_dim)
    main = torch.from_numpy(
        rng.normal(size=(1, E + R, L)).astype(np.float32))
    tables = (torch.zeros(E + R, dtype=torch.int32),
              torch.arange(E + R, dtype=torch.int32),
              torch.full((E + R,), -1, dtype=torch.int32))
    nch = -(-E // chunk)
    pad = np.zeros(nch * chunk, np.int32)
    pad[:E] = np.arange(E)
    q = [torch.from_numpy(x.astype(np.int32)) for x in (
        rng.integers(0, E, B), E + rng.integers(0, R, B),
        rng.integers(0, E, B))]
    return (ent_dim, rel_dim, chunk, main, tables,
            torch.from_numpy(pad.reshape(nch, chunk)), E, q)


@pytest.mark.parametrize("form,model", [("pool", "complex"),
                                        ("pool", "rescal"),
                                        ("mp", "complex")])
def test_eval_program_spans_once_in_order(form, model):
    ent_dim, rel_dim, chunk, main, tables, keys, E, (s, r, o) = \
        _eval_case(model)
    t = SpanTracer()
    if form == "pool":
        fn = kge.make_pool_eval_counts(model, ent_dim, rel_dim, chunk,
                                       shared_pool=True, tracer=t)
        want = ["eval.rows", "eval.queries", "eval.k4"]

        def call():
            return fn(main, tables, keys, E, s, r, o)
    else:
        fn = kge.make_pool_eval_counts_mp(model, ent_dim, rel_dim, chunk,
                                          tracer=t)
        want = ["eval.queries", "eval.k4"]
        rows = [main[0, k.long()] for k in (s, r, o)]
        true_sc = kge.make_true_score(model)(
            rows[0][:, :ent_dim], rows[1][:, :rel_dim], rows[2][:, :ent_dim])

        def call():
            return fn(main, tables, keys, E, *rows, s, o, true_sc)

    untraced = call()
    got = _profiled(call)
    assert got == ["adapm." + n for n in want]
    assert [e[1] for e in t._events] == want * 2  # both calls
    traced = call()
    for a, b in zip(untraced, traced):    # the spans change no answer
        assert torch.equal(a, b)


def test_server_spans_reach_the_profiler():
    """A Worker op (`kv.pull` through `_instrumented`) and a `Server._span`
    site (`kv.plan_pull`) are profiler ranges with every plane off."""
    srv = _server()
    try:
        w = srv.make_worker(0)
        keys = np.arange(8, dtype=np.int64)
        w.set(keys, np.ones((8, 4), np.float32))
        srv.wait_sync()
        got = _profiled(lambda: w.pull_sync(keys))
    finally:
        srv.shutdown()
    assert "adapm.kv.pull" in got and "adapm.kv.plan_pull" in got
    assert got.index("adapm.kv.pull") < got.index("adapm.kv.plan_pull")
