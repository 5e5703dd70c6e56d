"""Time variants of the K4 kernel (adapm_tpu_torch/csrc/pool_eval_counts.cu)
on one CUDA card, at chip_smoke.py's phase-2 shape: 200,000 candidates
in 65,536-key chunks of a pool with rows of 512 f32, ComplEx K=256 and
RESCAL K=128, at B=64 and B=36, on integer-valued data (every variant
must stay exact against the plain version, except the one that skips
its copies on purpose).

Each variant is the current source with a few text edits, built and
swapped in by tools/variants.py into build/k4_variants/, so that the
public wrapper (with its launch plan) runs it. Also printed: ptxas
registers and spills per entry, the SASS opcode counts of the TQ=4
16-byte entry (cuobjdump), and the SM clock and power beside each round.

    python -m adapm_tpu_torch.tools.k4_variants
"""
import collections
import os
import re
import subprocess
import sys

import numpy as np
import torch

from adapm_tpu_torch.ops import kernels as K
from adapm_tpu_torch.tools.variants import ROOT, build, card, clocks, edit, \
    source

OUT = os.path.join(ROOT, "build", "k4_variants")
SRC = source("pool_eval_counts.cu")
CUDA = "/usr/local/cuda/bin"


# the ring: 32-column chunks, 4 stages (the plan must follow: see run())
RING32 = [("constexpr int kKC = 64;", "constexpr int kKC = 32;"),
          ("constexpr int kStages = 2;", "constexpr int kStages = 4;")]
# warps as 8 candidate lanes x 4 query groups (candidates cw + tx + 8j,
# queries ty + 16i): 8 distinct candidate rows and 4 distinct query words
# per read, one wavefront each
LANES8 = [
    ("  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  const int tx = lane & 7, cw = 64 * (warp & 1);\n"
     "  const int ty = (lane >> 3) + 4 * (warp >> 1);"),
    ("ring + slot * kCt * kPitch + tx * kPitch;",
     "ring + slot * kCt * kPitch + (tx + cw) * kPitch;"),
    ("cr + 16 * j * kPitch + 4 * kg)", "cr + 8 * j * kPitch + 4 * kg)"),
    ("const int o = 4 * (kg * Bq + TQ * ty + i);",
     "const int o = 4 * (kg * Bq + ty + 16 * i);"),
    ("const int cl = tx + 16 * j;", "const int cl = tx + cw + 8 * j;"),
    ("for (int off = 8; off > 0; off >>= 1)",
     "for (int off = 4; off > 0; off >>= 1)")]
QUERY8 = ("const int qb = q0 + TQ * ty + i;", "const int qb = q0 + ty + 16 * i;")
# no candidate copies after the prologue: the FMA loop's ceiling (counts
# are wrong on purpose)
NOLOAD = [("          const int bytes = p != nullptr && c0 + cc < a.K ? 16 : 0;",
           "          if (s >= kStages - 1) continue;\n"
           "          const int bytes = p != nullptr && c0 + cc < a.K ? 16 : 0;")]
L2HINT = [("cp.async.cg.shared.global [%0], [%1], 16, %2;",
           "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;")]


def unroll(n):
    return [("#pragma unroll 4  // 4 of the 16", f"#pragma unroll {n}  // of the 16")]


def lanes8(s):
    return edit(s, LANES8).replace(*QUERY8)


VARIANTS = {
    "adopted": (SRC, 64),
    "lanes8": (lanes8(SRC), 64),
    "ring32": (edit(SRC, RING32), 32),
    "lanes8_ring32": (edit(lanes8(SRC), RING32), 32),
    "noload": (edit(SRC, NOLOAD), 64),
    "unroll16": (edit(SRC, unroll(16)), 64),
    "unroll8": (edit(SRC, unroll(8)), 64),
    "unroll2": (edit(SRC, unroll(2)), 64),
    "l2hint": (edit(SRC, L2HINT), 64),
}


def sass_counts(name):
    sass = subprocess.run([os.path.join(CUDA, "cuobjdump"), "-sass",
                           os.path.join(OUT, f"lib{name}.so")],
                          capture_output=True, text=True).stdout
    for fn in sass.split("Function : ")[1:]:
        if "kernelILi4ELb1E" in fn.split("\n")[0]:
            ops = collections.Counter(re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", fn))
            return sum(ops.values()), ops.most_common(12)
    return None


def cuda_ms(fn, reps=30):
    for _ in range(3):
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


def cases(dev):
    rng = np.random.default_rng(0)
    E, nk, L, C = 200_000, 201_000, 512, 65_536
    slots = -8 * (-int(np.ceil(nk * 1.25)) // 8)
    owner = torch.zeros(nk, dtype=torch.int32, device=dev)
    slot = torch.as_tensor(rng.permutation(slots)[:nk].astype(np.int32),
                           device=dev)
    pad = np.zeros(4 * C, np.int32)
    pad[:E] = rng.permutation(E)
    pad[E:] = pad[0]
    keys = torch.as_tensor(pad.reshape(4, C), device=dev)
    pool = torch.randint(-4, 5, (1, slots, L), device=dev).float()
    okey = torch.as_tensor(rng.integers(0, E, 64).astype(np.int32), device=dev)
    skey = torch.as_tensor(rng.integers(0, E, 64).astype(np.int32), device=dev)
    out = []
    for kd in (256, 128):
        q_o = torch.randint(-3, 4, (64, kd), device=dev).float()
        q_s = torch.randint(-3, 4, (64, kd), device=dev).float()
        true = (q_o * pool[0, slot[okey.long()], :kd]).sum(1)
        for b in (64, 36):
            args = (pool, owner, slot, keys, E, q_o[:b].contiguous(),
                    q_s[:b].contiguous(), true[:b].contiguous(),
                    okey[:b].contiguous(), skey[:b].contiguous())
            out.append((kd, b, 4 * b * E * kd, args,
                        K.pool_eval_counts_plain(*args)))
    return out


def run():
    if not torch.cuda.is_available():
        print("k4_variants: needs a CUDA card", file=sys.stderr)
        return 2
    print(card(), flush=True)
    libs = build("pool_eval_counts",
                 {name: text for name, (text, _) in VARIANTS.items()}, OUT)
    for name in ("adopted", "unroll16"):
        print(f"{name}: SASS of the TQ=4 16-byte entry (total, top) "
              f"{sass_counts(name)}", flush=True)
    work = cases(torch.device("cuda"))
    for rnd in range(2):
        for name, (_, chunk) in VARIANTS.items():
            K._libs["pool_eval_counts"] = libs[name]
            # the plan's shared-memory layout follows the ring's geometry
            K.K4_CHUNK, K.K4_STAGES = chunk, (2 if chunk == 64 else 4)
            line = []
            for kd, b, flops, args, ref in work:
                got = K.pool_eval_counts(*args)
                exact = all(torch.equal(x, y) for x, y in zip(got, ref))
                t = cuda_ms(lambda: K.pool_eval_counts(*args))
                line.append(f"K={kd} B={b} {t[0]:.4f} [{t[1]:.4f}, "
                            f"{t[2]:.4f}] ms {flops / t[0] / 1e9:.1f} TFLOP/s "
                            f"exact={exact}")
            print(f"round {rnd} {name}: " + " | ".join(line) + f" | {clocks()}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
