"""North-star scale runs on one card (the JAX package's
`scripts/northstar.py`, ported):

  kge      Wikidata5M-sized ComplEx: 4.6M entities / 822 relations,
           d=128, B=4096, 32 negatives drawn on the device; reports
           ms/step and the derived epoch time over Wikidata5M's 20.6M
           train triples. `--epoch` also times one measured epoch,
           `--eval` full-entity ranking (K4 over the shared pool) at
           B=64 and B=512.
  w2v      1B-words-sized SGNS: 800k vocab (the benchmark corpus'
           min-count-5 vocabulary), d=128, B=8192 pairs, 5 negatives
           drawn on the device from a unigram^0.75 alias table; reports
           pairs/s.
  w2v_app  the word2vec app's loop (apps/word2vec.py) over a generated
           on-disk corpus: pairs/s of a whole epoch.
  mf       MovieLens-25M-sized: 162,541 users x 59,047 movies, rank 128,
           B=16384 ratings; reports updates/s and the derived epoch time
           over 25M ratings.

Each run drives the bench PM loop (intent for the next batch, the
device-routed fused step, one planner round, a clock tick) at full
table size: the point is the table SIZE, not new machinery. `--tier`
runs the same workloads on the tiered store with a quarter of the keys
hot. Timing is slope-based (`slope_time`). Prints one JSON line per
workload, with the JAX script's metric names and keys and the device
the run used.

    python -m adapm_tpu_torch.northstar [kge w2v w2v_app mf] [--epoch]
        [--eval] [--tier]

runs on the card; `ADAPM_NS_SMOKE=1` runs every path at toy sizes.
`main(argv, device="cpu")` and each `run_*(..., device="cpu")` run on
the CPU, where every kernel takes its plain version.
"""
from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

T0 = time.perf_counter()
SLAB = 262_144          # rows of one slab of the untiered bulk fill
TIER_HOT_FRAC = 0.25    # --tier: the share of each shard's keys held hot


def progress(msg: str) -> None:
    print(f"[northstar +{time.perf_counter() - T0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def bulk_device_init(store, emb_cols: int, scale: float, seed: int) -> None:
    """Fill a store's whole main table: normal(0, scale) embedding
    columns, 1e-6 optimizer-state columns. Slot assignment is irrelevant:
    every slot gets an i.i.d. row, so this equals a per-key host init in
    distribution.

    Untiered: filled in place on the pool's device, SLAB rows at a time,
    from a generator there seeded with `seed`; no full-size temporary
    (the pool is the card's largest allocation, 8.95 GiB for kge).
    Tiered: the authoritative table
    is the host cold store, filled in place from a numpy generator seeded
    with `seed` (the JAX script's draw, byte for byte) and installed
    through tier/coldpath.install_main_full, which resets residency:
    rows promote to the device hot pool as the workload touches them."""
    from .exec import dispatch_gate

    if store.res is not None:
        from .tier.coldpath import install_main_full
        cold = store.coldq
        rng = np.random.default_rng(seed)
        full = cold.q if cold.mode == "fp32" else \
            np.empty(cold.q.shape, dtype=np.float32)
        rng.standard_normal(dtype=np.float32, out=full)
        full *= np.float32(scale)
        full[:, :, emb_cols:] = 1e-6
        install_main_full(store, full)
        return
    main = store.main
    gen = torch.Generator(device=main.device)
    gen.manual_seed(int(seed))
    with dispatch_gate():
        for lo in range(0, main.shape[1], SLAB):
            rows = main[:, lo:lo + SLAB]
            rows[:, :, :emb_cols].normal_(0.0, scale, generator=gen)
            rows[:, :, emb_cols:].fill_(1e-6)
    store.block()


def _sys_opts(num_keys: int, tier: bool = False, **kw):
    """The runs' SystemOptions: one cache slot a shard and no planner
    rate limit; `tier` holds TIER_HOT_FRAC of the keys hot on the runs'
    one shard (and drops main_over_alloc: slots past the hot pool are
    host rows)."""
    from .config import SystemOptions
    if tier:
        kw.pop("main_over_alloc", None)
        kw.update(tier=True, tier_hot_rows=max(
            8, math.ceil(num_keys * TIER_HOT_FRAC)))
    return SystemOptions(cache_slots_per_shard=1, sync_max_per_sec=0, **kw)


def skewed(rng, n, size):
    return (n * rng.random(size) ** 3).astype(np.int64).clip(0, n - 1)


def slope_time(step, steps: int) -> float:
    """Seconds a step: (T_long - T_short) / (steps - steps // 4), each
    loop ending in the host-visible value of its last step (a device
    result is read with .item(), which waits for the device). Raises
    where the long loop took no longer than the short one: the steps
    were not in a steady state, and the slope would be no time."""
    if steps < 4:
        raise ValueError("slope timing needs steps >= 4 (two loop lengths)")

    def timed(n):
        t0 = time.perf_counter()
        out = None
        for i in range(n):
            out = step(i)
        out.item() if isinstance(out, torch.Tensor) else float(out)
        return time.perf_counter() - t0

    timed(1)
    t_s = timed(steps // 4)
    t_l = timed(steps)
    if t_l <= t_s:
        raise RuntimeError(
            f"slope timing: {steps} steps took {t_l:.4f} s, {steps // 4} "
            f"took {t_s:.4f} s: the steps are not in a steady state")
    return (t_l - t_s) / (steps - steps // 4)


def pm_loop(srv, w, runner, batches, aux, lr, steps, warmup):
    """The bench PM step shape: intent for the NEXT batch, fused step,
    one planner round, clock tick. `warmup` steps train the batches in
    turn before the timing (the runs warm each batch once: on a tiered
    store a batch's first step promotes its rows, which a timed loop
    must not pay). Returns slope_time's seconds a step."""
    nb = len(batches)
    intent_keys = [np.unique(np.concatenate([v.ravel() for v in b.values()]))
                   for b in batches]

    def step(i):
        nxt = (i + 1) % nb
        w.intent(intent_keys[nxt], w.current_clock + 1, w.current_clock + 2)
        loss = runner(batches[i % nb], None if aux is None else aux[i % nb],
                      lr)
        srv.sync.run_round()
        w.advance_clock()
        return loss

    for i in range(warmup):
        step(i)
    return slope_time(step, steps)


def _device_name(dev: torch.device) -> str:
    """What a result line names as its device: the card's name, or cpu."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else \
        str(dev)


def _kge_batch(rng, E, R, B):
    return {"s": skewed(rng, E, B),
            "r": rng.integers(E, E + R, B).astype(np.int64),
            "o": skewed(rng, E, B)}


def run_kge(E=4_600_000, R=822, d=128, B=4096, N=32, steps=16,
            train_triples=20_614_279, full_epoch=False, do_eval=False,
            tier=False, device=None):
    from . import setup
    from .models import make_kge_loss
    from .ops.fused import DeviceRoutedRunner

    progress(f"kge: building server ({E + R} keys x {4 * d} f32 = "
             f"{(E + R) * 4 * d * 4 / 2**30:.1f} GiB main table"
             + (", tiered)" if tier else " on device)"))
    srv = setup(E + R, 4 * d, opts=_sys_opts(E + R, tier,
                                             main_over_alloc=1.02),
                device=device)
    try:
        bulk_device_init(srv.stores[0], 2 * d, 0.1, seed=0)
        progress("kge: init done (bulk init)")
        w = srv.make_worker(0)
        runner = DeviceRoutedRunner(
            srv, make_kge_loss("complex"),
            role_class={"s": 0, "r": 0, "o": 0, "neg": 0},
            role_dim={k: 2 * d for k in ("s", "r", "o", "neg")},
            neg_role="neg", neg_shape=(B, N), neg_population=np.arange(E))
        rng = np.random.default_rng(0)
        batches = [_kge_batch(rng, E, R, B) for _ in range(4)]
        progress("kge: warmup + timing")
        dt = pm_loop(srv, w, runner, batches, None, 0.1, steps,
                     warmup=len(batches))
        out = {"metric": "northstar_kge_wikidata5m_scale",
               "entities": E, "relations": R, "dim": d,
               "ms_per_step": round(dt * 1e3, 2),
               "triples_per_sec": round(B / dt, 1),
               "derived_epoch_s_20.6M_triples": round(
                   dt * train_triples / B, 1),
               "device": _device_name(srv.ctx.device)}
        if full_epoch:
            out["measured_epoch_s"] = _kge_epoch(srv, w, runner, rng, E, R,
                                                 B, train_triples)
        if do_eval:
            out.update(_kge_eval(srv, rng, E, R, d))
    finally:
        srv.shutdown()
    return out


def _kge_epoch(srv, w, runner, rng, E, R, B, train_triples) -> float:
    """One ACTUAL epoch end to end (every step ships a fresh host batch,
    its intent and a planner round), not the slope-derived steady
    state: the epoch's seconds."""
    n_steps = -(-train_triples // B)
    progress(f"kge: full epoch ({n_steps} steps)")
    t0 = time.perf_counter()
    loss = None
    nxt = _kge_batch(rng, E, R, B)
    for _ in range(n_steps):
        b, nxt = nxt, _kge_batch(rng, E, R, B)
        # the pm_loop step shape: intent covers the NEXT batch one clock
        # ahead, then the current batch trains
        w.intent(np.unique(np.concatenate([nxt["s"], nxt["r"], nxt["o"]])),
                 w.current_clock + 1, w.current_clock + 2)
        loss = runner(b, None, 0.1)
        srv.sync.run_round()
        w.advance_clock()
    loss.item()
    epoch_s = round(time.perf_counter() - t0, 1)
    progress(f"kge: epoch done in {epoch_s} s")
    return epoch_s


EVAL_CHUNK = 65_536


def eval_program(srv, E, d, chunk=EVAL_CHUNK):
    """The full-entity eval over the shared pool: (counts, tables,
    ent_keys), where counts(srv.stores[0].main, tables, ent_keys, E,
    skeys, rkeys, okeys) is models/kge.make_pool_eval_counts' shared-pool
    program (K4 over every entity), `tables` worker shard 0's device
    mirrors and `ent_keys` the [ceil(E / chunk), chunk] int32 entity key
    table, padded with key 0."""
    from .models.kge import make_pool_eval_counts
    from .ops.fused import DeviceRouter
    nch = -(-E // chunk)
    pad = np.zeros(nch * chunk, dtype=np.int32)
    pad[:E] = np.arange(E)
    ent_keys = srv.ctx.put_replicated(pad.reshape(nch, chunk))
    # shared_pool: entities and relations live in ONE length class
    fn = make_pool_eval_counts("complex", 2 * d, 2 * d, chunk,
                               shared_pool=True)
    return fn, DeviceRouter(srv, 0).tables(), ent_keys


def _kge_eval(srv, rng, E, R, d) -> dict:
    """Full-entity chunked eval at table scale: candidates read from the
    pool by K4 in [B_ev, chunk] tiles, only [B_ev] rank counts returned
    (eval_program), at two batch sizes: 64 (the app default) and 512
    (the same candidate reads over 8x the triples)."""
    put = srv.ctx.put_replicated
    fn, tables, ent_keys = eval_program(srv, E, d)
    ent_main = srv.stores[0].main
    out = {}
    for B_ev in (64, 512):
        ev_batches = [tuple(put(k) for k in (
            skewed(rng, E, B_ev), rng.integers(E, E + R, B_ev),
            skewed(rng, E, B_ev))) for _ in range(4)]
        progress(f"kge: eval timing (B={B_ev})")

        def ev_step(i):
            s, r, o = ev_batches[i % 4]
            g_o, g_s, _ = fn(ent_main, tables, ent_keys, E, s, r, o)
            return g_o.sum() + g_s.sum()

        dt_ev = slope_time(ev_step, 12)
        out[f"eval_ms_per_batch{B_ev}"] = round(dt_ev * 1e3, 2)
        out[f"eval_triples_per_sec_b{B_ev}"] = round(B_ev / dt_ev, 1)
        out[f"derived_eval_s_per_10k_triples_b{B_ev}"] = \
            round(dt_ev / B_ev * 1e4, 1)
        progress(f"kge: eval {B_ev / dt_ev:.1f} triples/s "
                 f"({dt_ev * 1e3:.0f} ms / batch of {B_ev})")
    return out


def run_w2v(V=800_000, d=128, B=8192, N=5, steps=24, tier=False,
            device=None):
    from . import setup
    from .models.sgns import build_alias_table, sgns_loss, syn1_key
    from .ops.fused import DeviceRoutedRunner

    progress(f"w2v: building server ({2 * V} keys x {2 * d} f32)")
    srv = setup(2 * V, 2 * d, opts=_sys_opts(2 * V, tier), device=device)
    try:
        bulk_device_init(srv.stores[0], d, 0.05, seed=1)
        w = srv.make_worker(0)
        counts = 1.0 / (np.arange(V) + 10.0)  # zipf corpus frequencies
        runner = DeviceRoutedRunner(
            srv, sgns_loss, role_class={"center": 0, "ctx": 0, "neg": 0},
            role_dim={k: d for k in ("center", "ctx", "neg")},
            neg_role="neg", neg_shape=(B, N),
            neg_population=syn1_key(np.arange(V)),
            neg_alias=build_alias_table(counts))
        rng = np.random.default_rng(1)
        batches = [{"center": 2 * skewed(rng, V, B),
                    "ctx": 2 * skewed(rng, V, B) + 1} for _ in range(4)]
        progress("w2v: warmup + timing")
        dt = pm_loop(srv, w, runner, batches, None, 0.05, steps,
                     warmup=len(batches))
        name = _device_name(srv.ctx.device)
    finally:
        srv.shutdown()
    return {"metric": "northstar_w2v_1bwords_scale", "vocab": V, "dim": d,
            "ms_per_step": round(dt * 1e3, 2),
            "pairs_per_sec": round(B / dt, 1), "device": name}


def run_w2v_app(V=800_000, sentences=8_000, sent_len=1000, d=128, B=8192,
                N=5, device=None):
    """w2v through the APP loop: corpus on disk, vocab build,
    per-sentence deterministic pair generation + subsampling + batching +
    intent readahead + device steps, the number the 1B-words north star
    needs, not the bare step rate. The corpus is generated once into the
    temporary directory and reused."""
    from .apps import word2vec as w2v
    from .io import text as textio

    path = os.path.join(tempfile.gettempdir(), f"ns_w2v_{V}.txt")
    if not os.path.exists(path):
        progress(f"w2v-app: generating corpus ({sentences} x {sent_len} "
                 f"tokens over {V} vocab)")
        textio.generate_synthetic_corpus(path, vocab_size=V,
                                         num_sentences=sentences,
                                         sentence_len=sent_len, seed=3)
    args = w2v.build_parser().parse_args(
        ["--data", path, "--dim", str(d), "--window", "5",
         "--negative", str(N), "--epochs", "1", "--batch_size", str(B),
         "--lr", "0.025", "--min_count", "1", "--readahead", "200",
         "--sys.sync.max_per_sec", "0"])
    progress("w2v-app: running one epoch through the app loop")
    t0 = time.perf_counter()
    w2v.run_app(args, device=device)
    dt = time.perf_counter() - t0
    # count the pairs the epoch trained (pair generation is deterministic
    # per sentence: a dry re-pass is exact)
    words, counts, vocab = textio.build_vocab(path, 1)
    total = int(counts.sum())
    n_pairs = 0
    for si, sent in enumerate(textio.sentences(path, vocab)):
        c, _ = w2v._pairs_for(sent, si, args.window, args.seed, counts,
                              total, args.sample)
        n_pairs += len(c)
    progress(f"w2v-app: {n_pairs} pairs in {dt:.1f} s")
    return {"metric": "northstar_w2v_app_loop", "vocab": len(words),
            "corpus_tokens": total, "pairs": n_pairs,
            "epoch_s": round(dt, 1),
            "pairs_per_sec_app_loop": round(n_pairs / dt, 1),
            "device": _device_name(torch.device(
                "cuda" if device is None else device))}


def run_mf(users=162_541, movies=59_047, rank=128, B=16_384, steps=24,
           ratings=25_000_095, tier=False, device=None):
    from . import setup
    from .models import make_mf_loss
    from .ops.fused import DeviceRoutedRunner

    K = users + movies
    progress(f"mf: building server ({K} keys x {2 * rank} f32)")
    srv = setup(K, 2 * rank, opts=_sys_opts(K, tier), device=device)
    try:
        bulk_device_init(srv.stores[0], rank, 0.1, seed=2)
        w = srv.make_worker(0)
        runner = DeviceRoutedRunner(
            srv, make_mf_loss(l2=0.01), role_class={"w": 0, "h": 0},
            role_dim={"w": rank, "h": rank})
        rng = np.random.default_rng(2)
        batches = [{"w": skewed(rng, users, B),
                    "h": users + skewed(rng, movies, B)} for _ in range(4)]
        aux = [torch.from_numpy(rng.random(B).astype(np.float32) * 4 + 1)
               .to(srv.ctx.device) for _ in range(4)]
        progress("mf: warmup + timing")
        dt = pm_loop(srv, w, runner, batches, aux, 0.05, steps,
                     warmup=len(batches))
        name = _device_name(srv.ctx.device)
    finally:
        srv.shutdown()
    return {"metric": "northstar_mf_movielens25m_scale",
            "users": users, "movies": movies, "rank": rank,
            "ms_per_step": round(dt * 1e3, 2),
            "ratings_per_sec": round(B / dt, 1),
            "derived_epoch_s_25M_ratings": round(dt * ratings / B, 1),
            "device": name}


SMOKE = {"kge": dict(E=20_000, R=20, d=16, B=256, N=4, steps=6,
                     train_triples=10_000),
         "w2v": dict(V=5_000, d=16, B=512, N=3, steps=6),
         "w2v_app": dict(V=2_000, sentences=200, sent_len=80, d=16, B=512),
         "mf": dict(users=2_000, movies=1_000, rank=8, B=1024, steps=6)}


def main(argv=None, device=None) -> int:
    """The CLI: workloads (default kge w2v mf) and flags as the module
    docstring says; `device` None is the card, which must be present."""
    argv = sys.argv[1:] if argv is None else list(argv)
    flags = {"--epoch", "--eval", "--tier"}
    which = [a for a in argv if a not in flags] or ["kge", "w2v", "mf"]
    runs = {"kge": run_kge, "w2v": run_w2v, "w2v_app": run_w2v_app,
            "mf": run_mf}
    bad = [w for w in which if w not in runs]
    if bad:
        raise SystemExit(f"northstar: unknown workload(s) {bad}; choose "
                         f"from {sorted(runs)}")
    if device is None and not torch.cuda.is_available():
        raise SystemExit("northstar: no CUDA device; the north-star runs "
                         "measure the card (main(device='cpu') runs the "
                         "CPU on purpose)")
    smoke = os.environ.get("ADAPM_NS_SMOKE", "0").lower() not in \
        ("", "0", "false")
    tier = "--tier" in argv
    for name in which:
        kw = dict(SMOKE[name]) if smoke else {}
        kw["device"] = device
        if name == "kge":
            kw.update(full_epoch="--epoch" in argv, do_eval="--eval" in argv)
        if name != "w2v_app":
            kw["tier"] = tier
        print(json.dumps(runs[name](**kw)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
