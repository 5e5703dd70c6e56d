"""One run of one benchmark cell of the PyTorch/CUDA port:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. It
prints set-up's parts and the run's notes on standard error, then the
numbers it compared beside their limits as its last lines there, and as
the last line of standard output one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device, with --trace 1 a breakdown, and last the
compared numbers (`checks`). Without the cards the cell asks for, or
with JAX or the JAX package loaded, it prints no result and exits with
a code other than 0."""
import argparse
import importlib
import json
import os
import sys
import time

T_TOP = time.perf_counter()

from . import common, compare  # noqa: E402
from .drivers import kge_pm  # noqa: E402


def _caches() -> None:
    """Every build cache of the program at a fixed path in the checkout."""
    build = os.path.join(common.ROOT, "build")
    os.environ["ADAPM_TORCH_KERNEL_DIR"] = os.path.join(build, "kernels")
    os.environ["ADAPM_TORCH_NATIVE_CACHE"] = os.path.join(build, "native")


def run_cell(name: str, seed: int, seconds: float, trace: bool, dev,
             man: dict = None, overrides: dict = None,
             clock: kge_pm.SetupClock = None) -> dict:
    """Drive cell `name` once on `dev` and return the result line's
    object. `overrides` (for tests) replaces the cell's configuration,
    traffic or limits: {"config": {...}, "traffic": {...}, "limits":
    {...}}. `clock` is set-up's clock as far as the caller took it."""
    man = man or common.manifest()
    c = common.cell(name, man)
    ov = overrides or {}
    c["config_data"] = ov.get("config", c["config_data"])
    c["traffic_data"] = ov.get("traffic", c["traffic_data"])
    lim = ov.get("limits") or compare.limits(name)
    if clock is None:
        clock = kge_pm.SetupClock(T_TOP, 0.0)
        clock.lap("imports")
    driver = importlib.import_module(
        f"{__package__}.drivers.{c['traffic_data']['kind']}")
    run = driver.run(c, seed, seconds, trace, dev, clock)
    metrics = {}
    for m in common.metrics_of(name, man, trace):
        v = common.load_file("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct, checks = compare.judge(run.numbers, lim)
    out = {"correct": bool(correct), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics,
           "device": dict(run.device)}
    if trace and run.trace is not None:
        from . import trace as tracing
        out["device"].update(busy_s=run.trace["busy_s"],
                             window_s=run.trace["window_s"])
        out["breakdown"] = tracing.breakdown(run.trace)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the process's age when this module started
    age0 = max(0.0, common.process_age_s() - (time.perf_counter() - T_TOP))
    clock = kge_pm.SetupClock(T_TOP, age0)
    clock.lap("imports (torch, numpy)")
    man = common.manifest()
    chips = common.cell(args.workload, man)["chips"]
    _caches()
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"benchmark: cell {args.workload} needs {chips} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.empty(0, device=dev)
    clock.lap("the card's context")
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   dev, man, clock=clock)
    bad = common.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}: the port must not import "
              "JAX or the JAX package", file=sys.stderr)
        return 4
    # read after the window, so that nvidia-smi's seconds stay out of set-up
    print(f"benchmark: {args.workload} seed {args.seed} on "
          f"{common.power_limit()}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
