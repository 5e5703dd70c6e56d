"""The traced slice's card-idle time split by the program's spans.

Each run is a `--trace 1` run of the cell (benchmark.run's `run_cell`);
the profiler events of its traced slice, which benchmark/trace.py reads,
are also handed to `split`: every idle interval of the traced window
goes, by overlap, to the innermost `adapm.<span>` range (the program's
spans, adapm_tpu_torch/obs/spans.py) open on the thread that ran the
units, and to `outside` where none is open. One JSON line a run: the
split in ms a unit beside the reading's own idle ms a unit, the traced
ms a unit, and the run's per-layer metrics.

    python3 -m benchmark.tools.program_idle --workload <cell> \\
        --seeds 1,2 [--seconds 5] [--ranges 1,0]

Each seed runs once for each entry of `--ranges`, in that order; `0`
turns the program's profiler ranges off for the run (its slice then has
no program range, and its traced ms a unit is the on-cost's base)."""
import argparse
import bisect
import json
import sys

import torch

from .. import run, trace

PREFIX = "adapm."


def split(events) -> dict:
    """{span name: idle seconds, ..., "outside": idle seconds} over the
    traced window of `events` (profiler FunctionEvents); {} where the
    window holds no program range on the units' thread."""
    cuda = torch.autograd.DeviceType.CUDA
    win, dev, ranges = None, [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not e.name.startswith(("bench.", PREFIX)):
                dev.append([a, b])
        elif e.name == trace.WINDOW:
            win = (a, b, e.thread)
        elif e.name.startswith(PREFIX):
            ranges.append((e.thread, e.name[len(PREFIX):], a, b))
    if win is None:
        return {}
    w0, w1, thread = win
    ranges = [(n, a, b) for t, n, a, b in ranges if t == thread]
    if not ranges:
        return {}
    out = dict.fromkeys(sorted({n for n, _, _ in ranges}), 0.0)
    out["outside"] = 0.0
    busy = trace._union([[max(a, w0), min(b, w1)] for a, b in dev
                         if b > w0 and a < w1])
    cuts = sorted({x for _, a, b in ranges for x in (a, b)})
    prev = w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            i = bisect.bisect_right(cuts, prev)
            pts = [prev] + cuts[i:bisect.bisect_left(cuts, a)] + [a]
            for p, q in zip(pts, pts[1:]):
                m = (p + q) / 2
                inner = [(re - rs, n) for n, rs, re in ranges
                         if rs <= m <= re]
                out[min(inner)[1] if inner else "outside"] += (q - p) / 1e6
        prev = max(prev, b)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--ranges", default="1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("program_idle: the traced slice needs a CUDA device",
              file=sys.stderr)
        return 3
    run._caches()
    from adapm_tpu_torch.obs import spans
    dev = torch.device("cuda", 0)
    read, seen = trace.read, []

    def reading(events, names, launched):
        events = list(events)
        rec = read(events, names, launched)
        seen.append((rec, split(events),
                     sum(e.device_type == torch.autograd.DeviceType.CUDA
                         and e.name.startswith(PREFIX) for e in events)))
        return rec

    trace.read = reading
    profiling = spans.profiling
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            for on in (int(x) for x in args.ranges.split(",")):
                spans.profiling = profiling if on else (lambda: False)
                seen.clear()
                out = run.run_cell(args.workload, seed, args.seconds, True,
                                   dev)
                rec, parts, mirrors = seen[-1]
                per = 1e3 / rec["units"]
                line = json.dumps({
                    "workload": args.workload, "seed": seed, "ranges": on,
                    "correct": out["correct"], "lost": rec["lost"],
                    "units": rec["units"],
                    "traced_ms_a_unit": rec["wall_s"] * per,
                    "idle_ms_a_unit": (rec["window_s"] - rec["busy_s"]) * per,
                    "split_ms_a_unit": {k: v * per for k, v in parts.items()},
                    "device_records_of_ranges": mirrors,
                    "device_ops": [n for n, _ in
                                   trace.breakdown(rec)["device_ops"]],
                    "metrics": {k: v["value"]
                                for k, v in out["metrics"].items()},
                    "device": torch.cuda.get_device_name(dev)})
                print(line, flush=True)
    finally:
        trace.read, spans.profiling = read, profiling
    return 0


if __name__ == "__main__":
    sys.exit(main())
