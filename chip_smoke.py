"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels, holds each against its plain PyTorch version at the main path's
shapes, drives the device-routed ComplEx KGE training step through the
parameter manager at full width, checks a small replica run against the
CPU, and runs the KGE application end to end on both routing paths.

    python3 chip_smoke.py [--json PATH]

Phases (any failure raises and exits non-zero):
  1. card name + power limit; build the kernels (nvcc, sm_90a).
  2. each kernel vs its plain version at the main path's shapes
     (K1 routed_gather: 143,360 rows of 512 f32, both forms, bitwise;
     K3 ordered_scatter_add: the same rows with zipf duplicates, bitwise
     and deterministic over two runs; K2 adagrad_update: [143,360, 256]
     within tolerance; K4 pool_eval_counts: 64 queries against a
     200,000-entity pool in 65,536-key chunks: exact on integer-valued
     data, and ComplEx K=256 and RESCAL K=128 on random data under the
     near-tie rule), with CUDA-event times (the
     median and the min-max spread of 20 launches) of kernel, plain
     version and one library call, and the least time the card could
     take.
  3. the main path: setup(201,000 keys, 512) on cuda, slab fill, a
     DeviceRoutedRunner for ComplEx with on-device negatives (B=4096,
     N=32), warmup, then 32 steps of intent -> step -> sync round ->
     advance_clock; launch counts of every kernel over the main path.
  4. replica phase: 2 virtual shards, two workers with competing
     intents (the replica step variant, K1's cache+delta form, K3 in the
     sync merge), the same fused steps on cuda and on cpu within
     tolerance, then an add-only push/pull/set/sync sequence on both,
     bitwise.
  5. the KGE app (apps/knowledge_graph_embeddings.py, main's parse and
     run) at full width: ComplEx d=128, 200,000 entities, 409,600
     lowrank triples generated on the card, B=4096, N=32, 2 epochs of
     100 device-routed steps, pool-count eval (K4) after each; launch
     counts of K1-K4 over the run.
  6. the host-routed app path (--no-device_routes, PullSample
     negatives) at the same width for 10 steps; then test_kge_app's
     small configuration on cuda and on cpu (epoch losses within rtol
     1e-4, MRR within 0.02, and the eval counts of one checkpoint under
     the near-tie rule).
The near-tie rule: the kernel sums each dot in another order than the
plain version's matmuls, so a count may differ by at most the number of
candidates whose score lies within the f32 dot-product error bound of
the true score (ops/kernels.py pool_eval_counts_plain). K4 is also held
to its plain version exactly on integer-valued data, where every order
of summation gives the same f32 sums.
The last two lines are the per-kernel JSON record and the device JSON
line; `--json PATH` also writes the full record (main-path numbers and
the profile included) to PATH. Needs one CUDA card; exits non-zero
without one.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# main-path shape (the repo's flagship KGE configuration)
E, R, D_MODEL, B, N = 200_000, 1_000, 128, 4096, 32
EVAL_B, EVAL_CHUNK = 64, 65_536          # the app's eval batch and chunk
STEP_KERNELS = ("routed_gather", "adagrad_update", "ordered_scatter_add")
L = 4 * D_MODEL                       # [emb 2d | adagrad 2d]
ROWS = 3 * B + B * N                  # gathered rows per step: 143,360
STEPS, WARMUP = 32, 3
HBM_BYTES_PER_S = 3.35e12             # H100 SXM
F32_FLOPS = 67e12                     # H100 SXM, outside the tensor cores


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def skewed_keys(rng, n, size):
    """Power-law key skew (the JAX package's bench._skewed_keys)."""
    return (n * rng.random(size) ** 3).astype(np.int64).clip(0, n - 1)


def cuda_ms(fn, reps=20, warmup=3):
    """Milliseconds of fn() per launch over `reps` launches, each between
    its own pair of CUDA events: (median, min, max)."""
    for _ in range(warmup):
        fn()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    t = np.array([a.elapsed_time(b) for a, b in evs])
    return float(np.median(t)), float(t.min()), float(t.max())


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_breakdown(step, n):
    """Device time of `n` calls of step() by kernel name (torch.profiler,
    CUDA activity), the wall time, and the share of it the device was
    busy. Returns None when the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_name[ev.key] = by_name.get(ev.key, 0.0) + \
            ev.self_device_time_total / 1e3
    busy_ms = sum(by_name.values())
    if busy_ms <= 0:
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(wall_ms_per_step=wall_ms / n, device_ms_per_step=busy_ms / n,
                busy_share=busy_ms / wall_ms,
                top_ms_per_step=[(_kernel_label(k), v / n) for k, v in top])


def _kernel_label(name):
    """Short label of a CUDA kernel name: the innermost functor of a
    PyTorch elementwise/reduce kernel, else the kernel's own name."""
    import re
    functors = re.findall(r"\w*(?:Functor|_functor)\w*", name)
    head = name.replace("(anonymous namespace)::", "").replace("void ", "")
    head = head.split("(")[0].split("<")[0].split("::")[-1]
    return f"{head}[{functors[-1]}]" if functors else head


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def phase_kernels(K, dev, rng):
    """Phase 2: each kernel against its plain version, timed."""
    rec = {}
    slots = -8 * (-int(np.ceil((E + R) * 1.25)) // 8)    # the store's rule
    main = torch.randn((1, slots, L), device=dev)
    main[0, :4] = -0.0
    keys = np.concatenate([skewed_keys(rng, E, B), rng.integers(E, E + R, B),
                           skewed_keys(rng, E, B),
                           rng.integers(0, E, B * N)])
    o_sh = torch.zeros(ROWS, dtype=torch.int32, device=dev)
    o_sl = torch.as_tensor(keys.astype(np.int32), device=dev)

    # -- K1 routed_gather, main-only form (the no-replica step's read)
    got = K.routed_gather(main, None, None, o_sh, o_sl)
    ref = K.routed_gather_plain(main, None, None, o_sh, o_sl)
    check(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
          "K1 main-only form differs from its plain version")
    # full form: replica rows from cache+delta for 30% of the entries
    cslots = 16_384
    cache = torch.randn((1, cslots, L), device=dev)
    delta = torch.randn((1, cslots, L), device=dev)
    c_sl = torch.randint(0, cslots, (ROWS,), device=dev, dtype=torch.int32)
    c_sl[::97] = 2**31 - 2
    use_c = torch.rand(ROWS, device=dev) < 0.3
    full = (main, cache, delta, o_sh, o_sl, o_sh, c_sl, use_c)
    got_f = K.routed_gather(*full)
    ref_f = K.routed_gather_plain(*full)
    check(torch.equal(got_f.view(torch.int32), ref_f.view(torch.int32)),
          "K1 cache+delta form differs from its plain version")
    n_main = int(torch.unique(o_sl.long()).numel())
    k1_bytes = n_main * L * 4 + ROWS * 4 * 2 + ROWS * L * 4
    flat = o_sl.long()
    mflat = main.view(-1, L)
    rec["routed_gather"] = timed(
        max_abs_err=float((got - ref).abs().max()),
        ms=cuda_ms(lambda: K.routed_gather(main, None, None, o_sh, o_sl)),
        plain_ms=cuda_ms(
            lambda: K.routed_gather_plain(main, None, None, o_sh, o_sl)),
        library_ms=cuda_ms(lambda: mflat.index_select(0, flat)),
        bound=bound(k1_bytes, 0))
    del cache, delta, got_f, ref_f

    # -- K3 ordered_scatter_add, zipf duplicates, twice for determinism
    vals = torch.randn((ROWS, L), device=dev)
    outs = []
    for _ in range(2):
        pool = main.clone()
        K.ordered_scatter_add(pool, o_sh, o_sl, vals)
        outs.append(pool)
    ref_pool = main.clone()
    K.ordered_scatter_add_plain(ref_pool, o_sh, o_sl, vals)
    check(torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32)),
          "K3 is not deterministic from run to run")
    check(torch.equal(outs[0].view(torch.int32), ref_pool.view(torch.int32)),
          "K3 differs from its plain version (np.add.at order)")
    err3 = float((outs[0] - ref_pool).abs().max())
    del outs, ref_pool
    scratch = main.clone()
    k3_bytes = ROWS * L * 4 + 2 * n_main * L * 4 + ROWS * 4 * 2
    rec["ordered_scatter_add"] = timed(
        max_abs_err=err3,
        ms=cuda_ms(lambda: K.ordered_scatter_add(scratch, o_sh, o_sl, vals)),
        plain_ms=cuda_ms(lambda: K.ordered_scatter_add_plain(
            scratch, o_sh, o_sl, vals), warmup=1),
        library_ms=cuda_ms(lambda: scratch.view(-1, L).index_add_(
            0, flat, vals)),
        bound=bound(k3_bytes, ROWS * L))
    del scratch

    # -- K2 adagrad_update on the gathered rows' accumulator half
    Dh = L // 2
    g = torch.randn((ROWS, Dh), device=dev)
    rows = torch.rand((ROWS, L), device=dev)
    acc = rows[:, Dh:]
    got2 = K.adagrad_update(g, acc, 0.1, 1e-10)
    ref2 = K.adagrad_update_plain(g, acc, 0.1, 1e-10)
    check(torch.allclose(got2, ref2, rtol=1e-5, atol=1e-7),
          "K2 differs from its plain version beyond rtol 1e-5 / atol 1e-7")
    emb_a, acc_a = K.adagrad_apply(g, rows[:, :Dh].contiguous(),
                                   acc.contiguous(), 0.1, 1e-10)
    emb_r, acc_r = K.adagrad_apply_plain(g, rows[:, :Dh], acc, 0.1, 1e-10)
    check(torch.allclose(acc_a, acc_r, rtol=1e-5)
          and torch.allclose(emb_a, emb_r, rtol=1e-4, atol=1e-6),
          "K2 standalone form differs beyond the Pallas test's tolerance")
    k2_bytes = ROWS * Dh * 4 * 2 + ROWS * L * 4
    lib_ms = None
    fused = getattr(torch, "_fused_adagrad_", None)
    if fused is not None:
        # yardstick only: PyTorch's fused AdaGrad over the same rows
        p, s_ = rows[:, :Dh].contiguous(), acc.contiguous()
        step = [torch.zeros((), device=dev)]
        lib_ms = cuda_ms(lambda: fused([p], [g], [s_], step, lr=0.1,
                                       lr_decay=0.0, weight_decay=0.0,
                                       eps=1e-10, maximize=False))
    rec["adagrad_update"] = timed(
        max_abs_err=float((got2 - ref2).abs().max()),
        ms=cuda_ms(lambda: K.adagrad_update(g, acc, 0.1, 1e-10)),
        plain_ms=cuda_ms(lambda: K.adagrad_update_plain(g, acc, 0.1, 1e-10)),
        library_ms=lib_ms, bound=bound(k2_bytes, ROWS * Dh * 7))
    del main, vals, g, rows
    torch.cuda.empty_cache()
    rec["pool_eval_counts"] = phase_k4(K, dev, rng)
    torch.cuda.empty_cache()
    return rec


def timed(ms, plain_ms, library_ms, **kw):
    """A kernel record from (median, min, max) timings."""
    out = dict(kw, ms=ms[0], ms_spread=ms[1:], plain_ms=plain_ms[0],
               plain_ms_spread=plain_ms[1:])
    out["library_ms"] = None if library_ms is None else library_ms[0]
    out["library_ms_spread"] = None if library_ms is None \
        else library_ms[1:]
    return out


def phase_k4(K, dev, rng):
    """K4 against its plain version at eval width: 64 queries, a
    200,000-entity ComplEx pool (rows of 512 f32, K=256 read through the
    row stride) in 4 chunks of 65,536 keys with a padded tail; the RESCAL
    form (K=128) on the same pool."""
    from adapm_tpu_torch.models.kge import (_complex_queries,
                                            _rescal_queries, complex_score,
                                            rescal_score)
    nk = E + R
    slots = -8 * (-int(np.ceil(nk * 1.25)) // 8)
    pool = torch.randn((1, slots, L), device=dev) * 0.1
    owner = torch.zeros(nk, dtype=torch.int32, device=dev)
    slot = torch.as_tensor(rng.permutation(slots)[:nk].astype(np.int32),
                           device=dev)
    nch = -(-E // EVAL_CHUNK)
    pad = np.zeros(nch * EVAL_CHUNK, np.int32)
    pad[:E] = rng.permutation(E)
    pad[E:] = pad[0]
    keys = torch.as_tensor(pad.reshape(nch, EVAL_CHUNK), device=dev)
    s_k = torch.as_tensor(rng.integers(0, E, EVAL_B).astype(np.int32),
                          device=dev)
    o_k = torch.as_tensor(rng.integers(0, E, EVAL_B).astype(np.int32),
                          device=dev)
    r_k = torch.as_tensor(rng.integers(E, nk, EVAL_B).astype(np.int32),
                          device=dev)

    def rows(k, dim):
        return pool[0, slot[k.long()], :dim]

    # exact: small integers make every partial sum exact in f32, so the
    # kernel's counts must equal the plain version's in any order; true
    # scores taken from real candidates make exact ties (not counted)
    ipool = torch.randint(-4, 5, pool.shape, device=dev).float()
    Ki = 2 * D_MODEL
    qi_o = torch.randint(-3, 4, (EVAL_B, Ki), device=dev).float()
    qi_s = torch.randint(-3, 4, (EVAL_B, Ki), device=dev).float()
    cand_i = ipool[0, slot[o_k.long()], :Ki]
    true_i = (qi_o * cand_i).sum(1).contiguous()
    iargs = (ipool, owner, slot, keys, E, qi_o, qi_s, true_i, o_k, s_k)
    ge = K.pool_eval_counts(*iargs, parts=2)
    pe = K.pool_eval_counts_plain(*iargs, parts=2)
    check(all(torch.equal(a, b) for a, b in zip(ge, pe)),
          "K4 counts differ from the plain version on integer data")
    exact_counted = int(ge[0].sum() + ge[1].sum())
    del ipool, cand_i

    out = {}
    for model in ("complex", "rescal"):
        d = D_MODEL
        if model == "complex":
            se, re_, oe = rows(s_k, 2 * d), rows(r_k, 2 * d), rows(o_k, 2 * d)
            a, b, c, dd = _complex_queries(se, re_, oe)
            q_o, q_s = torch.cat([a, b], -1), torch.cat([c, dd], -1)
            true = complex_score(se, re_, oe)
            parts = 2
        else:
            se, oe = rows(s_k, d), rows(o_k, d)
            re_ = torch.randn((EVAL_B, d * d), device=dev) * 0.1
            q_o, q_s = _rescal_queries(se, re_, oe)
            true = rescal_score(se, re_, oe)
            parts = 1
        q_o, q_s, true = q_o.contiguous(), q_s.contiguous(), \
            true.contiguous()
        args = (pool, owner, slot, keys, E, q_o, q_s, true, o_k, s_k)
        g_o, g_s = K.pool_eval_counts(*args, parts=parts)
        p_o, p_s, t_o, t_s = K.pool_eval_counts_plain(*args, parts=parts,
                                                      ties=True)
        torch.cuda.synchronize()
        diff = torch.cat([(g_o - p_o).abs(), (g_s - p_s).abs()])
        ties = torch.cat([t_o, t_s])
        check(bool((diff <= ties).all()),
              f"K4 ({model}) counts differ from the plain version beyond "
              f"the near-tie rule: diff {diff.tolist()} ties "
              f"{ties.tolist()}")
        check(bool((g_o > 0).any() and (g_o < E - 1).any()),
              f"K4 ({model}) counts are degenerate")
        Kd = q_o.shape[1]
        flat = slot[torch.as_tensor(pad[:E], device=dev).long()]
        cand = pool[0, flat, :Kd].contiguous()   # the dense yardstick

        def library():
            t = true[:, None]
            return ((q_o @ cand.T) > t).sum(1), ((q_s @ cand.T) > t).sum(1)

        out[model] = timed(
            max_abs_err=float(diff.max()), ties=int(ties.sum()),
            counted=int(g_o.sum() + g_s.sum()), K=Kd,
            ms=cuda_ms(lambda: K.pool_eval_counts(*args, parts=parts)),
            plain_ms=cuda_ms(lambda: K.pool_eval_counts_plain(
                *args, parts=parts)),
            library_ms=cuda_ms(library),
            # each real candidate row's K floats read once; 2 sides x B x
            # E x K multiply-adds, 2 operations each
            bound=bound(E * Kd * 4 + E * 4 + 2 * EVAL_B * Kd * 4,
                        2 * 2 * EVAL_B * E * Kd))
        del cand
    rec = dict(out["complex"])
    rec["rescal"] = out["rescal"]
    rec["exact_counted"] = exact_counted
    return rec


def phase_main_path(at, K, dev, rng):
    """Phase 3: the port's main path at full width."""
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    t0 = time.perf_counter()
    srv = at.setup(E + R, L, opts=at.SystemOptions(
        cache_slots_per_shard=1, sync_max_per_sec=0), device=dev)
    w = srv.make_worker(0)
    for lo in range(0, E + R, 50_000):
        hi = min(lo + 50_000, E + R)
        vals = rng.normal(size=(hi - lo, L)).astype(np.float32) * 0.1
        vals[:, L // 2:] = 1e-6
        w.set(np.arange(lo, hi), vals)
    srv.block()
    fill_s = time.perf_counter() - t0
    roles = ("s", "r", "o", "neg")
    runner = DeviceRoutedRunner(
        srv, make_kge_loss("complex"), role_class=dict.fromkeys(roles, 0),
        role_dim=dict.fromkeys(roles, L // 2), neg_role="neg",
        neg_shape=(B, N), neg_population=np.arange(E), seed=0)
    batches = [{"s": skewed_keys(rng, E, B),
                "r": rng.integers(E, E + R, B),
                "o": skewed_keys(rng, E, B)} for _ in range(4)]
    intents = [np.unique(np.concatenate(list(b.values()))) for b in batches]

    def pm_step(i):
        nxt = (i + 1) % len(batches)
        w.intent(intents[nxt], w.current_clock + 1, w.current_clock + 2)
        loss = runner(batches[i % len(batches)], None, 0.1)
        srv.sync.run_round()
        w.advance_clock()
        return loss

    first = float(pm_step(0))
    for i in range(1, WARMUP + 1):
        pm_step(i)
    torch.cuda.synchronize()
    before = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    losses = [pm_step(i) for i in range(WARMUP + 1, WARMUP + 1 + STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / STEPS
    per_step = {k: (K.LAUNCHES[k] - before[k]) / STEPS for k in K.LAUNCHES}
    # the last step trains batch 0 again: its loss must have fallen
    last = float(pm_step(WARMUP + 1 + STEPS))
    losses = [float(x) for x in losses]
    # where the step's time goes: a short profiled window after timing
    prof = device_breakdown(lambda i: pm_step(WARMUP + 2 + STEPS + i), 4)
    check((WARMUP + 1 + STEPS) % len(batches) == 0, "last step batch")
    check(np.isfinite(losses).all() and np.isfinite([first, last]).all(),
          "non-finite loss on the main path")
    check(last < first, f"loss did not fall: first {first}, last {last}")
    check(not runner._shard_has_replicas(), "main path expected no replicas")
    main = srv.stores[0].main
    check(bool(torch.isfinite(main).all()), "non-finite parameters")
    out = dict(fill_s=fill_s, ms_per_step=dt * 1e3, triples_per_s=B / dt,
               first_loss=first, last_loss=last, per_step=per_step,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               profile=prof)
    srv.shutdown()
    return out


def replica_run(at, dev, rng_seed):
    """Phase 4 body on `dev`: two shards, competing intents, fused steps
    with injected negatives in the replica variant, sync merges, then an
    add-only push/pull/set/sync sequence. Returns (pools, reads, runner)."""
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    e, r, d, b, n = 512, 16, 8, 64, 4
    rng = np.random.default_rng(rng_seed)
    srv = at.setup(e + r, 4 * d, num_shards=2, num_workers=2, device=dev,
                   opts=at.SystemOptions(sync_max_per_sec=0,
                                         cache_slots_per_shard=256))
    w0, w1 = srv.make_worker(0), srv.make_worker(1)
    vals = rng.normal(size=(e + r, 4 * d)).astype(np.float32) * 0.1
    vals[:, 2 * d:] = 1e-6
    w0.wait(w0.set(np.arange(e + r), vals))
    hot = np.arange(0, e + r, 2)
    # worker 1 first (keys move to shard 1), then worker 0 competes:
    # shard 0 ends up holding replicas
    w1.intent(hot, 0, 10_000)
    srv.wait_sync()
    w0.intent(hot, 0, 10_000)
    srv.wait_sync()
    roles = ("s", "r", "o", "neg")
    runner = DeviceRoutedRunner(
        srv, make_kge_loss("complex"), role_class=dict.fromkeys(roles, 0),
        role_dim=dict.fromkeys(roles, 2 * d), shard=0)
    for step in range(6):
        batch = {"s": rng.integers(0, e, b), "r": rng.integers(e, e + r, b),
                 "o": rng.integers(0, e, b),
                 "neg": rng.integers(0, e, (b, n))}
        runner(batch, None, 0.1)
        srv.sync.run_round(all_channels=True)
    pools = [t.detach().cpu().clone() for t in
             (srv.stores[0].main, srv.stores[0].cache, srv.stores[0].delta)]
    # add-only sequence from one exactly known state (the fused steps'
    # model math may differ in the last bits between devices): flush,
    # then a set from each worker (a set refreshes the writer's own
    # replicas), then pushes with duplicates from both workers, pulls,
    # sets, sync rounds, quiesce
    srv.quiesce()
    for w in (w0, w1):
        w.wait(w.set(np.arange(e + r), vals))
    reads = []
    for step in range(12):
        k = rng.integers(0, e + r, 40)
        v = rng.normal(size=(40, 4 * d)).astype(np.float32)
        wk = (w0, w1)[step % 2]
        wk.wait(wk.push(k, v))
        if step % 3 == 2:
            wk.wait(wk.set(k[:8], v[:8]))
        if step % 4 == 3:
            srv.sync.run_round(all_channels=True)
        reads.append(wk.pull_sync(k))
    srv.quiesce()
    reads.append(w0.pull_sync(np.arange(e + r)))
    reads.append(w1.pull_sync(np.arange(e + r)))
    has_rep = runner._shard_has_replicas()
    srv.shutdown()
    return pools, reads, has_rep


def phase_replicas(at, K, dev):
    before = dict(K.LAUNCHES)
    pools_g, reads_g, rep_g = replica_run(at, dev, 7)
    used = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
    check(rep_g, "the replica phase held no replicas on the runner's shard")
    check(all(used[k] > 0 for k in STEP_KERNELS),
          f"replica phase skipped a kernel: {used}")
    pools_c, reads_c, _ = replica_run(at, "cpu", 7)
    for a, b_ in zip(pools_g, pools_c):
        check(torch.allclose(a, b_, rtol=1e-5, atol=1e-6),
              "fused steps on cuda and cpu differ beyond rtol 1e-5 / "
              "atol 1e-6")
    for i, (a, b_) in enumerate(zip(reads_g, reads_c)):
        check(np.array_equal(a.view(np.uint32), b_.view(np.uint32)),
              f"add-only read {i} differs between cuda and cpu")
    return used


APP_ARGS = ["--model", "complex", "--dim", str(D_MODEL), "--neg_ratio",
            str(N), "--batch_size", str(B), "--synthetic_mode", "lowrank",
            "--synthetic_entities", str(E), "--synthetic_relations", str(R),
            "--eval_chunk", str(EVAL_CHUNK), "--sys.sync.max_per_sec", "0",
            "--sys.prefetch", "0"]
# test_apps.py test_kge_app's configuration, on 8 virtual shards
SMALL_ARGS = ["--model", "complex", "--dim", "8", "--neg_ratio", "2",
              "--synthetic_entities", "60", "--synthetic_relations", "4",
              "--synthetic_triples", "400", "--epochs", "6",
              "--batch_size", "32", "--lr", "0.2", "--eval_every", "6",
              "--eval_triples", "60", "--no-device_routes",
              "--num_shards", "8", "--sys.sync.max_per_sec", "0",
              "--sys.prefetch", "0"]


def run_app(kge, K, argv, dev=None):
    """The app as `main(argv)` runs it (parse, then run_app), with the
    launch counts set to 0 just before and read just after."""
    args = kge.build_parser().parse_args(argv)
    K.reset_launches()
    res = kge.run_app(args, device=dev)
    return res, dict(K.LAUNCHES)


def check_app(res, launches, what, kernels):
    losses = res["epoch_losses"]
    check(np.isfinite(losses).all(), f"{what}: non-finite loss {losses}")
    check(0 < res["mrr"] <= 1, f"{what}: MRR {res['mrr']} outside (0, 1]")
    missing = [k for k in kernels if launches[k] == 0]
    check(not missing, f"{what}: kernels never launched: {missing}")


class HostClock:
    """Host seconds spent inside chosen functions (wrapped for the
    duration of a `with` block): where an app run's wall clock goes."""

    def __init__(self, targets):
        self.targets = targets  # [(owner, attribute name, label)]
        self.seconds = {label: 0.0 for _, _, label in targets}

    def __enter__(self):
        self.saved = []
        for owner, name, label in self.targets:
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))

            def wrapped(*a, _fn=fn, _label=label, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.seconds[_label] += time.perf_counter() - t0
            setattr(owner, name, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)


def phase_app(K):
    """Phase 5: the app at full width, device routes, 2 epochs."""
    from adapm_tpu_torch.apps import knowledge_graph_embeddings as kge
    from adapm_tpu_torch.core.sync import SyncManager
    from adapm_tpu_torch.io import kge as kgeio
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    argv = APP_ARGS + ["--synthetic_triples", str(100 * B), "--epochs", "2",
                       "--eval_every", "1", "--eval_triples", "100"]
    torch.cuda.reset_peak_memory_stats()
    clock = HostClock([
        (kgeio, "_generate_lowrank_device", "generate (total)"),
        (kgeio.TripleDataset, "filters", "TripleDataset.filters"),
        (kge.KgeRun, "init_model", "init_model"),
        (DeviceRoutedRunner, "__call__", "fused step call"),
        (SyncManager, "run_round", "sync round"),
        (kge, "_pool_counts", "eval device counts"),
        (kge, "_filter_correct", "eval filter correction")])
    with clock:
        res, launches = run_app(kge, K, argv)
    res["host_seconds"] = clock.seconds
    check_app(res, launches, "phase 5", list(K.LAUNCHES))
    losses = res["epoch_losses"]
    check(losses[1] < losses[0], f"phase 5: loss did not fall: {losses}")
    check(res["replicas_created"] == 0,
          f"phase 5: {res['replicas_created']} replicas at S=1")
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res, launches


def phase_host_routes(K):
    """Phase 6: the host-routed path at full width (10 steps of 131,072
    PullSample negatives), then the small configuration on cuda and cpu."""
    from adapm_tpu_torch.apps import knowledge_graph_embeddings as kge
    argv = APP_ARGS + ["--synthetic_triples", str(10 * B), "--epochs", "1",
                       "--eval_every", "1", "--eval_triples", "100",
                       "--no-device_routes"]
    full, launches = run_app(kge, K, argv)
    check_app(full, launches, "phase 6 (full width)", list(K.LAUNCHES))

    ck_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_ckpt")
    small = SMALL_ARGS + ["--checkpoint_every", "6", "--checkpoint_dir",
                          ck_dir]
    res_g, _ = run_app(kge, K, small)
    res_c, _ = run_app(kge, K, small, dev="cpu")
    lg, lc = np.array(res_g["epoch_losses"]), np.array(res_c["epoch_losses"])
    check(np.allclose(lg, lc, rtol=1e-4, atol=0),
          f"phase 6: cuda and cpu epoch losses differ beyond rtol 1e-4: "
          f"{lg} vs {lc}")
    check(abs(res_g["mrr"] - res_c["mrr"]) <= 0.02,
          f"phase 6: MRR cuda {res_g['mrr']} vs cpu {res_c['mrr']}")
    # one checkpoint (the cuda run's) evaluated on both devices
    from adapm_tpu_torch.io import kge as kgeio
    args = kge.build_parser().parse_args(
        small + ["--init_from", os.path.join(ck_dir, "kge_epoch5.npz")])
    ds = kgeio.generate_synthetic(60, 4, 400, seed=args.seed)
    t = ds.valid[:60]
    counts = {}
    for dev in ("cuda", "cpu"):
        run = kge.KgeRun(args, ds, device=dev)
        run.init_model()
        counts[dev] = kge._pool_counts(run, t[:, 0], t[:, 1], t[:, 2],
                                       ties=dev == "cpu")
        run.srv.shutdown()
    g_o, g_s = counts["cuda"][:2]
    c_o, c_s, _, t_o, t_s = counts["cpu"]
    check((np.abs(g_o - c_o) <= t_o).all() and (np.abs(g_s - c_s) <= t_s)
          .all(), "phase 6: eval counts of one checkpoint differ between "
          "cuda and cpu beyond the near-tie rule")
    return dict(full=full, full_launches=launches,
                small_losses_cuda=lg.tolist(), small_losses_cpu=lc.tolist(),
                small_mrr_cuda=res_g["mrr"], small_mrr_cpu=res_c["mrr"],
                count_diff=int(np.abs(g_o - c_o).sum()
                               + np.abs(g_s - c_s).sum()),
                ties=int(t_o.sum() + t_s.sum()))


def fmt_t(r, key):
    v = r[key]
    if v is None:
        return "none"
    lo, hi = r[key + "_spread"]
    return f"{v:.4f} [{lo:.4f}, {hi:.4f}]"


def main(argv):
    json_path = argv[argv.index("--json") + 1] if "--json" in argv else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    import adapm_tpu_torch as at
    from adapm_tpu_torch.ops import kernels as K
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    build_s = K.build()
    print(f"phase 1: kernels built in {build_s:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    rec = phase_kernels(K, dev, rng)
    for name, r in rec.items():
        print(f"phase 2: {name}: {fmt_t(r, 'ms')} ms (bound "
              f"{r['bound'][0]:.4f} ms, {r['bound'][1]}), plain "
              f"{fmt_t(r, 'plain_ms')} ms, library {fmt_t(r, 'library_ms')}"
              f" ms, max_abs_err {r['max_abs_err']}", flush=True)
    k1 = rec["routed_gather"]
    print(f"phase 2: K1 vs index_select, median [min, max] of 20: "
          f"{fmt_t(k1, 'ms')} vs {fmt_t(k1, 'library_ms')} ms", flush=True)
    k4 = rec["pool_eval_counts"]
    for model, r in (("complex", k4), ("rescal", k4["rescal"])):
        print(f"phase 2: K4 {model} K={r['K']}: {fmt_t(r, 'ms')} ms (bound "
              f"{r['bound'][0]:.4f} ms, {r['bound'][1]}), plain "
              f"{fmt_t(r, 'plain_ms')} ms, matmul+compare+sum "
              f"{fmt_t(r, 'library_ms')} ms, count diff {r['max_abs_err']}"
              f" within {r['ties']} near-ties, {r['counted']} counted",
              flush=True)
    print(f"phase 2: K4 exact on integer data: {k4['exact_counted']} "
          f"counted, equal to the plain version", flush=True)
    K.reset_launches()
    mp = phase_main_path(at, K, dev, rng)
    step_launches = dict(K.LAUNCHES)
    print(f"phase 3: fill {mp['fill_s']:.1f} s, {mp['ms_per_step']:.3f} "
          f"ms/step, {mp['triples_per_s']:.0f} triples/s, loss "
          f"{mp['first_loss']:.5f} -> {mp['last_loss']:.5f}, launches "
          f"{step_launches} (per step {mp['per_step']}), peak "
          f"{mp['peak_mem_gib']:.2f} GiB", flush=True)
    prof = mp["profile"]
    if prof is None:
        print("phase 3: device time breakdown not measured (the profiler "
              "recorded no device time)", flush=True)
    else:
        print(f"phase 3: profiled {prof['wall_ms_per_step']:.3f} ms/step "
              f"wall, device busy {prof['device_ms_per_step']:.3f} ms/step "
              f"({prof['busy_share']:.3f}); top: " + "; ".join(
                  f"{k} {v:.3f}" for k, v in prof["top_ms_per_step"][:8]),
              flush=True)
    check(all(step_launches[k] > 0 for k in STEP_KERNELS),
          f"a kernel of the main path never launched: {step_launches}")
    used = phase_replicas(at, K, dev)
    print(f"phase 4: replica phase launches {used}; cuda and cpu agree",
          flush=True)
    app, app_launches = phase_app(K)
    tps = [100 * B / t for t in app["epoch_s"]]
    print(f"phase 5: app: generation {app['gen_s']:.2f} s, epochs "
          f"{[round(t, 3) for t in app['epoch_s']]} s "
          f"({[round(x) for x in tps]} triples/s), evals "
          f"{[round(t, 3) for t in app['eval_s']]} s, losses "
          f"{app['epoch_losses']}, MRR {app['mrr']:.4g} (o "
          f"{app['mrr_o']:.4g}, s {app['mrr_s']:.4g}), test MRR "
          f"{app['test_mrr']:.4g}, ceiling {app['truth_mrr']:.4f}, launches "
          f"{app_launches}, peak {app['peak_mem_gib']:.2f} GiB", flush=True)
    print("phase 5: host seconds inside: " + "; ".join(
        f"{k} {v:.3f}" for k, v in app["host_seconds"].items()), flush=True)
    hr = phase_host_routes(K)
    f = hr["full"]
    print(f"phase 6: host routes: generation {f['gen_s']:.2f} s, epoch "
          f"{f['epoch_s'][0]:.3f} s ({10 * B / f['epoch_s'][0]:.0f} "
          f"triples/s), eval {[round(t, 3) for t in f['eval_s']]} s, loss "
          f"{f['epoch_losses']}, MRR {f['mrr']:.4g}, launches "
          f"{hr['full_launches']}; small config losses cuda "
          f"{hr['small_losses_cuda']} vs cpu {hr['small_losses_cpu']}, MRR "
          f"{hr['small_mrr_cuda']:.4f} vs {hr['small_mrr_cpu']:.4f}, count "
          f"diff {hr['count_diff']} within {hr['ties']} near-ties",
          flush=True)
    sources = {"routed_gather": ("adapm_tpu_torch/csrc/routed_gather.cu",
                                 "adapm_tpu/ops/pallas_kernels.py:36"),
               "adagrad_update": ("adapm_tpu_torch/csrc/adagrad.cu",
                                  "adapm_tpu/ops/pallas_kernels.py:76"),
               "ordered_scatter_add": ("adapm_tpu_torch/csrc/"
                                       "ordered_scatter.cu",
                                       "adapm_tpu/device/jaxport.py:95"),
               "pool_eval_counts": ("adapm_tpu_torch/csrc/"
                                    "pool_eval_counts.cu",
                                    "adapm_tpu/models/kge.py:238")}
    kernels = [dict(name=n, route="cuda", source=sources[n][0],
                    replaces=sources[n][1], launches=app_launches[n],
                    launches_by_path=dict(
                        step=step_launches[n], app=app_launches[n],
                        host_routes=hr["full_launches"][n]),
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                    bound_by=r["bound"][1], library_ms=r["library_ms"])
               for n, r in rec.items()]
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as fh:
            json.dump({"card": smi, "kernels": kernels, "timings": rec,
                       "main_path": mp, "replica_launches": used,
                       "app": app, "host_routes": hr, "build_s": build_s},
                      fh, indent=1, default=str)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
