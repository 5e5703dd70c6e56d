"""What the program's spans cost when on.

Two readings, one JSON line each:

- `enter_exit_us`: a span's enter and exit through
  adapm_tpu_torch/obs/spans.py `span`, in us, the median of `--reps`
  timed blocks of `--calls` spans each: with no sink, with a span
  tracer, under torch.profiler (CPU and, where present, CUDA
  activities, as benchmark/trace.py records), and with both;
- with `--workload`, the Chrome-export path: for each seed the cell's
  untraced run (benchmark.run's `run_cell`) with its eval program built
  as the benchmark builds it, then built with a `SpanTracer` (the
  tracer `--sys.trace.spans 1` gives a server), its rate, the spans the
  tracer recorded and the seconds their export takes.

    python3 -m benchmark.tools.span_cost [--calls 10000] [--reps 9] \\
        [--workload <cell> --seeds 1,2 [--seconds 10]]

The traced slice's batch time with the program's profiler ranges on and
off is benchmark/tools/program_idle.py's `--ranges 1,0`."""
import argparse
import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

import torch

from .. import run

SINKS = ("none", "tracer", "profiler", "both")


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def enter_exit_us(calls: int, reps: int) -> dict:
    """{sink: us a span's enter and exit} for each of SINKS."""
    from adapm_tpu_torch.obs import SpanTracer, span

    def block(t):
        t0 = time.perf_counter()
        for _ in range(calls):
            with span(t, "eval.k4"):
                pass
        return (time.perf_counter() - t0) / calls * 1e6

    out = {}
    for sink in SINKS:
        t = SpanTracer() if sink in ("tracer", "both") else None
        prof = _profiler() if sink in ("profiler", "both") \
            else contextlib.nullcontext()
        with prof:
            out[sink] = statistics.median(block(t) for _ in range(reps))
    return out


def export_run(workload: str, seed: int, seconds: float, tracer, dev):
    """The cell's untraced run, its eval program given `tracer` (None:
    as the benchmark builds it): (rate, spans, export seconds)."""
    from adapm_tpu_torch.models import kge
    built = kge.make_pool_eval_counts

    def with_tracer(*a, **kw):
        return built(*a, tracer=tracer, **kw)

    kge.make_pool_eval_counts = with_tracer
    try:
        out = run.run_cell(workload, seed, seconds, False, dev)
    finally:
        kge.make_pool_eval_counts = built
    rate = out["metrics"]["eval_triples_per_s"]["value"]
    if tracer is None:
        return out["correct"], rate, 0, None
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        tracer.export(os.path.join(d, "spans.json"))
        export_s = time.perf_counter() - t0
    return out["correct"], rate, tracer.stats()["events"], export_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=10000)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--workload", default=None)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    cuda = torch.cuda.is_available()
    device = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(json.dumps({"enter_exit_us": enter_exit_us(args.calls, args.reps),
                      "calls": args.calls, "reps": args.reps,
                      "device": device}), flush=True)
    if args.workload is None:
        return 0
    if not cuda:
        print("span_cost: the cell's runs need a CUDA device",
              file=sys.stderr)
        return 3
    run._caches()
    from adapm_tpu_torch.obs import SpanTracer
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        for tracer in (None, SpanTracer()):
            correct, rate, spans, export_s = export_run(
                args.workload, seed, args.seconds, tracer, dev)
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "tracer": tracer is not None, "correct": correct,
                "eval_triples_per_s": rate, "spans": spans,
                "export_s": export_s, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
