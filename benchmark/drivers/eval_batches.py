"""The `eval_batches` traffic: one client ranks a closed loop of test
triple batches over every entity, both sides, through the program's
shared-pool eval program (models/kge.py make_pool_eval_counts: K4 over
the main pool); each batch's raw rank counts are read to the host before
the next batch is dispatched, as the app reads them. The batches come
from a ring made in set-up from the seed; the table is the benchmark's
seeded rows, untrained.

Every answer of the window is judged: the first answer to each ring
batch against the float64 reference, every later answer to the same
batch against that first one."""
import sys
import time
import types

import numpy as np
import torch

from .. import compare, costs, inputs, trace as tracing
from ..common import Spans, device_info
from ..reference import rank
from . import kge_pm


def make_ring(cfg: dict, tr: dict, seed: int) -> list:
    """The ring of query batches, each a dict of s, r, o PM keys."""
    rng = np.random.default_rng(inputs.seed_int(seed, 6))
    return [inputs.triples(rng, cfg["entities"], cfg["relations"],
                           tr["batch"], tr["entity_skew_power"])
            for _ in range(tr["ring_batches"])]


def run(c: dict, seed: int, seconds: float, trace: bool, dev,
        clock: kge_pm.SetupClock):
    cfg, tr = c["config_data"], c["traffic_data"]
    P = kge_pm.imports(dev, clock)
    E = cfg["entities"]
    B, chunk = tr["batch"], tr["chunk"]
    ew, rw = kge_pm.widths(cfg)
    srv = kge_pm.build_server(P, cfg, dev)
    clock.lap("server build")
    kge_pm.fill(srv, cfg, seed)
    kge_pm.sync(dev)
    clock.lap("device fill")
    fn = P.kge.make_pool_eval_counts(cfg["model"], ew, rw, chunk,
                                     shared_pool=True)
    main = srv.stores[0].main
    nch = -(-E // chunk)
    pad = np.zeros(nch * chunk, dtype=np.int32)
    pad[:E] = np.arange(E)
    ent_keys = torch.as_tensor(pad.reshape(nch, chunk), device=dev)
    ring = make_ring(cfg, tr, seed)
    ring_dev = [tuple(torch.as_tensor(b[k], device=dev) for k in "sro")
                for b in ring]
    clock.lap("eval program and query ring")
    tables = P.fused.DeviceRouter(srv, 0).tables()
    kge_pm.sync(dev)
    clock.lap("mirror upload")

    spans = Spans()

    def batch(i):
        s, r, o = ring_dev[i % len(ring)]
        with spans("dispatch"):
            g_o, g_s, _ = fn(main, tables, ent_keys, E, s, r, o)
        with spans("readback"):
            return torch.stack((g_o, g_s)).cpu().numpy()

    for i in range(tr["warm_batches"]):
        batch(i)
    kge_pm.sync(dev)
    clock.lap("warm batches")

    spans.s = {}
    answers, unit_s = [], []
    t_start = time.perf_counter()
    setup_s = clock.total(t_start)
    i = 0
    while True:
        a = time.perf_counter()
        answers.append(batch(i))
        i += 1
        b = time.perf_counter()
        unit_s.append(b - a)
        if b - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    device = device_info(dev)
    batches = i
    print(f"window: {batches} batches of {B} in {window_s:.3f} s",
          file=sys.stderr, flush=True)

    rec = None
    if trace and dev.type == "cuda":
        def run_units(n):
            for j in range(n):
                batch(j)
        rec = tracing.take(run_units, tr["trace_batches"], spans, dev)
        print(f"trace: {rec['window_s']:.4f} s traced, busy "
              f"{rec['busy_s']:.4f} s, retakes {rec['retakes']}, lost "
              f"{rec['lost']} {rec['mismatch']}", file=sys.stderr,
              flush=True)
    srv.shutdown()
    del srv, fn, tables, main, ent_keys, ring_dev
    kge_pm.collect()

    seen = min(batches, len(ring))
    first = answers[:seen]
    repeat_gap = sum(int(not np.array_equal(a, first[j % len(ring)]))
                     for j, a in enumerate(answers))
    t0 = time.perf_counter()
    keys = {k: np.concatenate([b[k] for b in ring[:seen]]) for k in "sro"}
    ref_o, ref_s = rank.counts(cfg, seed, keys["s"], keys["r"], keys["o"],
                               dev)
    prog = np.concatenate(first, axis=1)
    numbers = compare.eval_numbers((prog[0], prog[1]), (ref_o, ref_s))
    numbers["repeat_gap"] = float(repeat_gap)
    print(f"reference: {seen * B} queries in {time.perf_counter() - t0:.2f}"
          " s", file=sys.stderr, flush=True)
    k4 = costs.load("k4").cost(B, E, ew)
    return types.SimpleNamespace(
        cell=c, config=cfg, traffic=tr, seed=seed, setup_s=setup_s,
        parts=clock.parts, window_s=window_s, units=batches,
        examples=batches * B, unit_s=unit_s, spans=spans.s, trace=rec,
        device=device, attempted=batches, failed=repeat_gap,
        numbers=numbers, k4_cost=k4, k4_ops_s=k4[0] / costs.peaks.F32_FLOPS)


def readings(c: dict, seed: int, dev) -> dict:
    """The readings of the limits other than the program's own (see
    benchmark.tools.readings): `control`, the reference's TF32 scores;
    `half`, the second half of each batch's answers left out, read as
    0; `altered`, each batch's answers moved one query on where they
    are produced."""
    cfg, tr = c["config_data"], c["traffic_data"]
    ring = make_ring(cfg, tr, seed)
    keys = {k: np.concatenate([b[k] for b in ring]) for k in "sro"}
    truth = rank.counts(cfg, seed, keys["s"], keys["r"], keys["o"], dev)
    ctl = rank.counts(cfg, seed, keys["s"], keys["r"], keys["o"], dev,
                      control=True)
    B = tr["batch"]

    def per_batch(f):
        return tuple(np.concatenate([f(x[i:i + B])
                                     for i in range(0, len(x), B)])
                     for x in truth)

    half = per_batch(lambda a: np.concatenate([a[:B // 2],
                                               np.zeros(B - B // 2, a.dtype)]))
    altered = per_batch(lambda a: np.roll(a, 1))
    return {name: compare.eval_numbers(p, truth)
            for name, p in (("control", ctl), ("half", half),
                            ("altered", altered))}
