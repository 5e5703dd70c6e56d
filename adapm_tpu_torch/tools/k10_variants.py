"""Time variants of the K10 kernel (gather_pool.cu instantiated with a
cold source) on one CUDA card, at chip_smoke.py's phase-2 shapes: the bag
path's batch of 8 requests (and a full one of 64) of the DLRM-DCNv2
traffic over the tiered table, 1,048,576 hot rows of 256 f32 and the
other members int8 wire rows staged per member, as phase 2 builds them.

Forms of one batch, each held bitwise to its plain version: int8 as
planned (sum; mean); the same members in bags of equal length; the same
members with fp32 wire rows (16-byte copies and no scale); every member
hot, through K10 and through K8 (whose own number this is); and the
64-request batch. Variants: the current source and text edits of the
ring depth (kDepth) and span (kSpan), built and swapped in by
tools/variants.py into build/k10_variants/, so the public wrappers run
them; `--extra NAME=PATH` adds another file (an earlier tree's source).
Printed per variant: ptxas registers and spills of every instantiation,
and the kernel's device time in the profiler trace (median [min, max] of
20 launches), with the card's SM clock and power beside each round.

    python -m adapm_tpu_torch.tools.k10_variants [--only NAME,...]
        [--extra NAME=PATH ...]
"""
import os
import sys

import numpy as np
import torch

from adapm_tpu_torch.ops import kernels as K
from adapm_tpu_torch.tools.k8_variants import REPS, trace_ms
from adapm_tpu_torch.tools.variants import ROOT, build, card, clocks, \
    const, edit, source

OUT = os.path.join(ROOT, "build", "k10_variants")
SRC = source("gather_pool.cu")


NO_COPIES = ("""        if (m.bag >= 0 && col) {""", """        if (false) {""")
# a span shorter than a warp: only its own positions may start a bag
IN_SPAN = ("      const bool in = j <= a.n;",
           "      const bool in = h + lane < kSpan && j <= a.n;")


def ring(depth=4, span=64):
    """The ring's depth and the span of an item (K8's instantiation
    shares both: its forms change with them)."""
    return [const("kDepth", 4, depth), const("kSpan", 64, span)] + (
        [IN_SPAN] if span < 32 else [])


VARIANTS = {
    "current": SRC,
    "depth2": edit(SRC, ring(depth=2)),
    "depth8": edit(SRC, ring(depth=8)),
    "span32": edit(SRC, ring(span=32)),
    "span128": edit(SRC, ring(span=128)),
    "span16": edit(SRC, ring(span=16)),
    # an ablation (timing only; not bitwise): K10's fold with no copies
    "no_copies": edit(SRC, [NO_COPIES]),
}


def cases(dev):
    """(label, call(out), out, plain result) for each timed form."""
    import chip_smoke as cs
    from adapm_tpu_torch.core.store import OOB, bucket_size, pad_bucket
    rng = np.random.default_rng(0)
    caps, offs = cs.dlrm_table()
    hot_row = cs.dlrm_hot_rows(caps, offs)
    H, L = cs.TIER_BAG_HOT, cs.L_DLRM
    main = torch.randn((1, H, L), device=dev) * 0.01
    cache = torch.zeros((1, 8, L), device=dev)
    out = []
    for nreq in (cs.BAG_CLIENTS, cs.K8_REQUESTS):
        keys, seg, nbags = cs.k8_batch(rng, nreq, caps, offs)
        n = len(keys)
        nb = bucket_size(nbags)
        hr = hot_row[keys]
        cold = hr < 0
        z = np.zeros(n, np.int32)

        def cols(o_row, use_cold, seg):
            return [torch.as_tensor(x, device=dev) for x in pad_bucket(
                n, (z, 0), (o_row.astype(np.int32), OOB), (z, 0),
                (np.full(n, OOB, np.int32), OOB), (z > 0, False),
                (use_cold, False), (seg, OOB))]

        sizes = np.full(nbags, n // nbags)
        sizes[:n % nbags] += 1
        equal = np.repeat(np.arange(nbags), sizes).astype(np.int32)
        planned = cols(np.where(cold, OOB, hr), cold, seg)
        # every member hot: a cold member reads a random hot row instead
        all_hot = cols(np.where(cold, keys % H, hr), z > 0, seg)
        b = planned[0].numel()
        vals = np.zeros((b, L), np.float32)
        vals[:n][cold] = cs.grid_rows(rng, int(cold.sum()), L, 2.0 ** -12)
        wire = {m: cs.wire_of(m, vals, dev)[:2] for m in ("int8", "fp32")}
        forms = [("int8 sum", planned, "int8", "sum", K.gather_pool_cold),
                 ("int8 mean", planned, "int8", "mean", K.gather_pool_cold),
                 ("int8 equal bags", cols(np.where(cold, OOB, hr), cold,
                                          equal), "int8", "sum",
                  K.gather_pool_cold),
                 ("fp32 wire", planned, "fp32", "sum", K.gather_pool_cold),
                 ("all hot K10", all_hot, "int8", "sum", K.gather_pool_cold),
                 ("all hot K8", all_hot, None, "sum", K.gather_pool)]
        if nreq != cs.BAG_CLIENTS:
            forms = forms[:1]
        for label, c, mode, pooling, fn in forms:
            o_sh, o_r, c_sh, c_sl, use_c, use_cold, seg_t = c
            if mode is None:
                args = (main, cache, cache, o_sh, o_r, c_sh, c_sl, use_c,
                        seg_t)
                plain = K.gather_pool_plain
            else:
                q, s = wire[mode]
                args = (main, cache, cache, o_sh, o_r, c_sh, c_sl, use_c,
                        mode, q, s, use_cold, seg_t)
                plain = K.gather_pool_cold_plain
            ref = plain(*args, torch.zeros((nb, L), device=dev), pooling)

            def call(o, fn=fn, args=args, pooling=pooling):
                return fn(*args, o, pooling, sorted_seg=True)

            out.append((f"{nreq} req {label}", call,
                        torch.zeros((nb, L), device=dev), ref))
    return out


def main(argv):
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("k10_variants: needs a CUDA card", file=sys.stderr)
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
            for label, call, out, ref in work:
                same = torch.equal(call(torch.zeros_like(out)).view(
                    torch.int32), ref.view(torch.int32))
                t, got = trace_ms(lambda: call(out))
                lost = "" if got == REPS else f" ({REPS - got} records lost)"
                line.append(f"{label} {cs.fmt_s(*t)} ms{lost} "
                            f"bitwise={same}")
            print(f"round {rnd} {name}: " + " | ".join(line) +
                  f" | {clocks()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
