"""The `eval_dist_batches` traffic: the `eval_batches` closed loop (one
client ranks a ring of test triple batches over every entity, both
sides, each batch's raw rank counts on the host before the next is
dispatched) for a model that ranks by distance (RotatE): the program's
shared-pool eval program, models/kge.py make_pool_eval_counts(model,
...), K17 over the main pool. The ring is eval_batches' (make_ring); the
table the benchmark's seeded rows, untrained, with the relation rows'
phases drawn at their own scale (`phase_scale`).

Every answer of the window is judged against the first answer to the
same ring batch (`repeat_gap`). A float64 distance over all of a ring's
queries would take hours, so the reference judges a seeded sample of the
first answers: `judged_per_batch` queries of each ring batch, both sides
(`count_gap`). The traced slice's K17 records are checked against the
program's launch counter, as the harness checks the kernels it lists."""
import sys
import time
import types

import numpy as np
import torch

from .. import compare, costs, inputs, trace as tracing
from ..common import Spans, device_info
from ..inputs import RELATION as REL
from ..reference import rank_dist
from . import eval_batches, kge_pm

K17 = ("pool_eval_dist", "pool_eval_dist_kernel")  # counter, record name


def judged(seed: int, tr: dict) -> np.ndarray:
    """[ring batches, judged_per_batch] query indices the reference judges,
    distinct within a batch, drawn from the seed."""
    rng = np.random.default_rng(inputs.seed_int(seed, 8))
    return np.stack([np.sort(rng.choice(tr["batch"], tr["judged_per_batch"],
                                        replace=False))
                     for _ in range(tr["ring_batches"])])


def fill_phases(srv, cfg: dict, seed: int) -> None:
    """Write the relation rows' embedding columns at the phases' scale,
    over kge_pm.fill's rows (which placed the relations in consecutive
    slots of shard 0): the benchmark's relation slabs drawn at
    `phase_scale`, as the reference draws them."""
    from adapm_tpu_torch.exec import dispatch_gate
    E, R = cfg["entities"], cfg["relations"]
    rw = kge_pm.widths(cfg)[1]
    main = srv.stores[int(srv.ab.key_class[E])].main
    s0 = int(srv.ab.slot[E])
    with torch.no_grad(), dispatch_gate():
        for lo, hi, rows in inputs.slabs(seed, REL, R, rw,
                                         cfg["phase_scale"], main.device):
            main[0, s0 + lo:s0 + hi, :rw] = rows
    srv.block()


def take_trace(batch, n: int, spans, dev) -> dict:
    """The harness's traced slice of n batches (trace.take), taken again
    while its K17 records differ from K17's launches in it, up to
    trace.RETAKES times; after that the slice is marked lost."""
    from adapm_tpu_torch.ops import kernels
    launched = {}

    def run_units(m):
        k0 = kernels.LAUNCHES[K17[0]]
        for j in range(m):
            batch(j)
        launched["n"] = kernels.LAUNCHES[K17[0]] - k0

    for _ in range(tracing.RETAKES + 1):
        rec = tracing.take(run_units, n, spans, dev)
        seen = tracing.kernel_s(rec, K17[1])[0]
        if seen == launched["n"]:
            return rec
    rec["mismatch"][K17[0]] = (launched["n"], seen)
    rec["lost"] = True
    return rec


def run(c: dict, seed: int, seconds: float, trace: bool, dev,
        clock: kge_pm.SetupClock):
    cfg, tr = c["config_data"], c["traffic_data"]
    P = kge_pm.imports(dev, clock)
    E = cfg["entities"]
    B, chunk = tr["batch"], tr["chunk"]
    ew, rw = kge_pm.widths(cfg)
    # first, so that a program without the model fails before the fill
    fn = P.kge.make_pool_eval_counts(cfg["model"], ew, rw, chunk,
                                     shared_pool=True)
    srv = kge_pm.build_server(P, cfg, dev)
    clock.lap("server build")
    kge_pm.fill(srv, cfg, seed)
    fill_phases(srv, cfg, seed)
    kge_pm.sync(dev)
    clock.lap("device fill")
    main = srv.stores[0].main
    nch = -(-E // chunk)
    pad = np.zeros(nch * chunk, dtype=np.int32)
    pad[:E] = np.arange(E)
    ent_keys = torch.as_tensor(pad.reshape(nch, chunk), device=dev)
    ring = eval_batches.make_ring(cfg, tr, seed)
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
        rec = take_trace(batch, tr["trace_batches"], spans, dev)
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
    pick = judged(seed, tr)[:seen]
    keys = {k: np.concatenate([b[k][q] for b, q in zip(ring, pick)])
            for k in "sro"}
    ref_o, ref_s = rank_dist.counts(cfg, seed, keys["s"], keys["r"],
                                    keys["o"], dev)
    prog = np.concatenate([a[:, q] for a, q in zip(first, pick)], axis=1)
    numbers = compare.eval_numbers((prog[0], prog[1]), (ref_o, ref_s))
    numbers["repeat_gap"] = float(repeat_gap)
    print(f"reference: {len(ref_o)} of {seen * B} queries in "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
    return types.SimpleNamespace(
        cell=c, config=cfg, traffic=tr, seed=seed, setup_s=setup_s,
        parts=clock.parts, window_s=window_s, units=batches,
        examples=batches * B, unit_s=unit_s, spans=spans.s, trace=rec,
        device=device, attempted=batches, failed=repeat_gap,
        numbers=numbers, k17_cost=costs.load("k17").cost(B, E, ew))


def readings(c: dict, seed: int, dev) -> dict:
    """The readings of the limits other than the program's own (see
    benchmark.tools.readings), over the judged queries of the whole ring:
    `control`, the reference in f32 on TF32 operands; `half`, the second
    half of each batch's answers left out, read as 0; `altered`, each
    batch's answers moved one query on where they are produced (a judged
    query reads its predecessor's count); `squared`, ranked by the squared
    Euclidean distance; `no_rotation`, ranked with the rotation left
    out (a = s, b = o)."""
    cfg, tr = c["config_data"], c["traffic_data"]
    ring = eval_batches.make_ring(cfg, tr, seed)
    B = tr["batch"]
    pick = judged(seed, tr)
    prev = (pick - 1) % B

    def keys(idx):
        return [np.concatenate([b[k][q] for b, q in zip(ring, idx)])
                for k in "sro"]

    truth = rank_dist.counts(cfg, seed, *keys(pick), dev)
    before = rank_dist.counts(cfg, seed, *keys(prev), dev)
    below = (pick < B // 2).reshape(-1)
    out = {"control": rank_dist.counts(cfg, seed, *keys(pick), dev,
                                       control=True),
           "half": tuple(np.where(below, t, 0) for t in truth),
           "altered": before}
    for v in ("squared", "no_rotation"):
        out[v] = rank_dist.counts(cfg, seed, *keys(pick), dev, variant=v)
    return {name: compare.eval_numbers(p, truth) for name, p in out.items()}
