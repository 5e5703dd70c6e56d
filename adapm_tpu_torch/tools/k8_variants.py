"""Time variants of the K8 kernel (adapm_tpu_torch/csrc/gather_pool.cu) on
one CUDA card, at chip_smoke.py's phase-2 shapes: bag batches of 8 and
64 requests of the DLRM-DCNv2 traffic over the 7,116,632-key table (rows
of 256 f32), every member owner-served (S=1) and a quarter
replica-served (S=2), sum pooling (and mean where S=1), as the serving
path plans and pads them; and each batch re-planned into bags of equal
length.

Each variant is the current source with a few text edits (or another
file, `--extra NAME=PATH`, e.g. an earlier tree's source), built and
swapped in by tools/variants.py into build/k8_variants/, so the public
wrapper runs it. Every variant's output must be bitwise the plain
version's. Printed per variant: ptxas registers and spills, and the
kernel's device time in the profiler trace (median [min, max] of 20
launches, and any launch whose record the trace lost), with the card's
SM clock and power beside each round.

    python -m adapm_tpu_torch.tools.k8_variants [--only NAME,...]
        [--extra NAME=PATH ...]
"""
import os
import sys

import numpy as np
import torch

from adapm_tpu_torch.ops import kernels as K
from adapm_tpu_torch.tools.variants import ROOT, build, card, clocks, \
    const, edit, source

OUT = os.path.join(ROOT, "build", "k8_variants")
SRC = source("gather_pool.cu")

LOOP = ("  for (long long item = (long long)blockIdx.x * kWarps + wid;\n"
        "       item < a.items;\n"
        "       item = a.slot >= 0 ? nwarps + take(a.slot, lane) : item + "
        "nwarps) {\n")
KERNEL = ("template <typename T, int kCold>\n"
          "__global__ void __launch_bounds__")
SLOT = ("  a.slot = a.items > (long long)blocks * kWarps ? "
        "stream_slot(stream) : -1;\n")
# a span is long when its last bag starts in it and runs at least kLong
# positions past its end: its stream is the longest of the batch
LONG = """constexpr int kLong = 32;

__device__ __forceinline__ bool long_item(const Args& a, long long item) {
  if (item >= a.span_items) return false;
  const long long s0 = item / a.slices * kSpan, e = s0 + kSpan - 1;
  if (e + kLong >= a.n) return false;
  const int b = __ldg(a.seg + e);
  return b >= 0 && b < a.nbags && __ldg(a.seg + e + kLong) == b &&
         (s0 == 0 || __ldg(a.seg + s0 - 1) != b);
}

"""
PASSES = "  for (int pass = 0; pass < 2; ++pass)\n"
SKIP = "    if ((pass == 0) != long_item(a, item)) continue;\n"
# every item by stride (no counter)
STRIDE = [(SLOT, "  a.slot = -1;\n")]
# every item from the counter, the first wave too
COUNTER = [(SLOT, "  a.slot = stream_slot(stream);\n"),
           (LOOP, "  for (long long item = take(a.slot, lane); "
                  "item < a.items;\n       item = take(a.slot, lane)) {\n")]
# long spans first: a pass over the items for them, then one for the
# rest; by stride, or from a counter per pass
LONG_FIRST = STRIDE + [(KERNEL, LONG + KERNEL),
                       (LOOP, PASSES + LOOP + SKIP)]
COUNTER_LONG_FIRST = [
    (SLOT, "  a.slot = stream_slot(stream);\n"), (KERNEL, LONG + KERNEL),
    ("    g_next[a.slot] = 0;",
     "    g_next[a.slot] = g_next[a.slot + 1] = 0;"),
    (LOOP, PASSES + "  for (long long item = take(a.slot + pass, lane); "
                    "item < a.items;\n"
                    "       item = take(a.slot + pass, lane)) {\n" + SKIP)]
# every bag in f32 lanes: 8 slices of 32 columns a span at L=256 (4x the
# warps on a long stream), each lane `depth` members in flight
F32 = ("  const int W = vec ? L / 4 : L;", "  vec = 0;\n  const int W = L;")


def f32(depth):
    return [F32, const("kDepth", 4, depth)]


VARIANTS = {
    "adopted": SRC,
    "stride": edit(SRC, STRIDE),
    "counter": edit(SRC, COUNTER),
    "long_first": edit(SRC, LONG_FIRST),
    "counter_long_first": edit(SRC, COUNTER_LONG_FIRST),
    "f32_depth8": edit(SRC, f32(8)),
    "f32_depth16": edit(SRC, f32(16)),
    # the ring's depth, the span of an item, the warps of a CTA
    "depth2": edit(SRC, [const("kDepth", 4, 2)]),
    "depth8": edit(SRC, [const("kDepth", 4, 8)]),
    "span32": edit(SRC, [const("kSpan", 64, 32)]),
    "span128": edit(SRC, [const("kSpan", 64, 128)]),
    "warps8": edit(SRC, [const("kWarps", 4, 8)]),
}


def cases(dev):
    """(label, args, pooling, out, plain result) for each timed batch
    and form."""
    import chip_smoke as cs
    from adapm_tpu_torch.core.store import OOB, bucket_size, pad_bucket
    rng = np.random.default_rng(0)
    caps, offs = cs.dlrm_table()
    nkeys = int(caps.sum())
    slots = -8 * (-int(np.ceil(nkeys * 1.25)) // 8)
    main = torch.randn((1, slots, cs.L_DLRM), device=dev)
    main2 = main.view(2, slots // 2, cs.L_DLRM)
    cslots = 65_536
    cache1 = torch.zeros((1, 8, cs.L_DLRM), device=dev)
    cache2 = torch.randn((2, cslots, cs.L_DLRM), device=dev)
    delta2 = torch.randn((2, cslots, cs.L_DLRM), device=dev)
    out = []
    for nreq in (cs.BAG_CLIENTS, cs.K8_REQUESTS):
        keys, seg, nbags = cs.k8_batch(rng, nreq, caps, offs)
        n = len(keys)
        nb = bucket_size(nbags)

        def cols(*arrays_and_fills, n=n):
            return [torch.as_tensor(a, device=dev)
                    for a in pad_bucket(n, *arrays_and_fills)]

        z = np.zeros(n, np.int32)
        use_c = rng.random(n) < 0.25
        c_sl = rng.integers(0, cslots, n).astype(np.int32)
        o_sl2 = np.where(use_c, OOB, keys // 2).astype(np.int32)
        s1 = (main, cache1, cache1, *cols(
            (z, 0), (keys.astype(np.int32), OOB), (z, 0),
            (np.full(n, OOB, np.int32), OOB), (z > 0, False)))
        s2 = (main2, cache2, delta2, *cols(
            ((keys % 2).astype(np.int32), 0), (o_sl2, OOB), (z, 0),
            (c_sl, OOB), (use_c, False)))
        sizes = np.full(nbags, n // nbags)
        sizes[:n % nbags] += 1
        segs = {"planned": cols((seg, OOB))[0],
                "equal": cols((np.repeat(np.arange(nbags), sizes)
                               .astype(np.int32), OOB))[0]}
        for form, args, sname, pooling in (
                ("S=1", s1, "planned", "sum"), ("S=1", s1, "equal", "sum"),
                ("S=2", s2, "planned", "sum"), ("S=1", s1, "planned", "mean")):
            ref = K.gather_pool_plain(
                *args, segs[sname], torch.zeros((nb, cs.L_DLRM), device=dev),
                pooling)
            out.append((f"{nreq} req {form} {sname} {pooling}",
                        args + (segs[sname],), pooling,
                        torch.zeros((nb, cs.L_DLRM), device=dev), ref))
    return out


REPS = 20


def trace_ms(fn):
    """The kernel's device ms in the profiler trace of REPS calls of fn()
    (median, min, max), and how many launches the trace recorded. A
    trace can lose launches' records (seen: one, and all 20): one short
    of them is taken again, up to twice, and the fullest is kept."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    best = np.zeros(0)
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        t = np.array([e.self_device_time_total for e in prof.events()
                      if "gather_pool_kernel" in e.name]) / 1e3
        if len(t) > len(best):
            best = t
        if len(best) == REPS:
            break
    if not len(best):
        return (float("nan"),) * 3, 0
    return (float(np.median(best)), float(best.min()),
            float(best.max())), len(best)


def main(argv):
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("k8_variants: needs a CUDA card", file=sys.stderr)
        return 2
    for a in argv[argv.index("--extra") + 1:] if "--extra" in argv else ():
        if a.startswith("--"):
            break
        name, path = a.split("=", 1)
        with open(path) as fh:
            VARIANTS[name] = fh.read()
    if "--only" in argv:
        keep = argv[argv.index("--only") + 1].split(",")
        for name in list(VARIANTS):
            if name not in keep:
                del VARIANTS[name]
    print(card(), flush=True)
    libs = build("gather_pool", VARIANTS, OUT)
    work = cases(torch.device("cuda"))
    for rnd in range(3):
        for name in VARIANTS:
            K._libs["gather_pool"] = libs[name]
            line = []
            for label, args, pooling, out, ref in work:
                def run(o, args=args, pooling=pooling):
                    # apm-lint: disable=APM001 a standalone timing harness:
                    # one thread, no server, no other launch domain
                    return K.gather_pool(*args, o, pooling, sorted_seg=True)

                got = run(torch.zeros_like(out))
                same = torch.equal(got.view(torch.int32),
                                   ref.view(torch.int32))
                t, got = trace_ms(lambda: run(out))
                lost = "" if got == REPS else f" ({REPS - got} records lost)"
                line.append(f"{label} {cs.fmt_s(*t)} ms{lost} "
                            f"bitwise={same}")
            print(f"round {rnd} {name}: " + " | ".join(line) +
                  f" | {clocks()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
