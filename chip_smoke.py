"""Smoke run of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels, holds each against its plain PyTorch version at the main path's
shapes, drives the device-routed ComplEx KGE training step through the
parameter manager at full width, and checks a small replica run against
the CPU.

    python3 chip_smoke.py [--json PATH]

Phases (any failure raises and exits non-zero):
  1. card name + power limit; build the kernels (nvcc, sm_90a).
  2. each kernel vs its plain version at the main path's shapes
     (K1 routed_gather: 143,360 rows of 512 f32, both forms, bitwise;
     K3 ordered_scatter_add: the same rows with zipf duplicates, bitwise
     and deterministic over two runs; K2 adagrad_update: [143,360, 256]
     within tolerance), with CUDA-event times of kernel, plain version
     and one library call, and the least time the card could take.
  3. the main path: setup(201,000 keys, 512) on cuda, slab fill, a
     DeviceRoutedRunner for ComplEx with on-device negatives (B=4096,
     N=32), warmup, then 32 steps of intent -> step -> sync round ->
     advance_clock; launch counts of every kernel over the main path.
  4. replica phase: 2 virtual shards, two workers with competing
     intents (the replica step variant, K1's cache+delta form, K3 in the
     sync merge), the same fused steps on cuda and on cpu within
     tolerance, then an add-only push/pull/set/sync sequence on both,
     bitwise.
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


def cuda_ms(fn, reps=10, warmup=2):
    """Mean milliseconds of fn() over `reps` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    rec["routed_gather"] = dict(
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
    rec["ordered_scatter_add"] = dict(
        max_abs_err=err3,
        ms=cuda_ms(lambda: K.ordered_scatter_add(scratch, o_sh, o_sl, vals)),
        plain_ms=cuda_ms(lambda: K.ordered_scatter_add_plain(
            scratch, o_sh, o_sl, vals), reps=2, warmup=1),
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
    rec["adagrad_update"] = dict(
        max_abs_err=float((got2 - ref2).abs().max()),
        ms=cuda_ms(lambda: K.adagrad_update(g, acc, 0.1, 1e-10)),
        plain_ms=cuda_ms(lambda: K.adagrad_update_plain(g, acc, 0.1, 1e-10)),
        library_ms=lib_ms, bound=bound(k2_bytes, ROWS * Dh * 7))
    del main, vals, g, rows
    torch.cuda.empty_cache()
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
    check(all(v > 0 for v in used.values()),
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
        print(f"phase 2: {name}: {r['ms']:.4f} ms (bound {r['bound'][0]:.4f} "
              f"ms, {r['bound'][1]}), plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']} ms, max_abs_err {r['max_abs_err']}",
              flush=True)
    K.reset_launches()
    mp = phase_main_path(at, K, dev, rng)
    launches = dict(K.LAUNCHES)
    print(f"phase 3: fill {mp['fill_s']:.1f} s, {mp['ms_per_step']:.3f} "
          f"ms/step, {mp['triples_per_s']:.0f} triples/s, loss "
          f"{mp['first_loss']:.5f} -> {mp['last_loss']:.5f}, launches "
          f"{launches} (per step {mp['per_step']}), peak "
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
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    used = phase_replicas(at, K, dev)
    print(f"phase 4: replica phase launches {used}; cuda and cpu agree",
          flush=True)
    sources = {"routed_gather": ("adapm_tpu_torch/csrc/routed_gather.cu",
                                 "adapm_tpu/ops/pallas_kernels.py:36"),
               "adagrad_update": ("adapm_tpu_torch/csrc/adagrad.cu",
                                  "adapm_tpu/ops/pallas_kernels.py:76"),
               "ordered_scatter_add": ("adapm_tpu_torch/csrc/"
                                       "ordered_scatter.cu",
                                       "adapm_tpu/device/jaxport.py:95")}
    kernels = [dict(name=n, route="cuda", source=sources[n][0],
                    replaces=sources[n][1], launches=launches[n],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                    bound_by=r["bound"][1], library_ms=r["library_ms"])
               for n, r in rec.items()]
    if json_path:
        os.makedirs(os.path.dirname(os.path.abspath(json_path)),
                    exist_ok=True)
        with open(json_path, "w") as f:
            json.dump({"card": smi, "kernels": kernels, "main_path": mp,
                       "replica_launches": used, "build_s": build_s}, f,
                      indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
