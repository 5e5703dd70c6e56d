"""The readings a cell's limits are set from, other than the program's
own (which every run prints): the control, the reference computed in
TF32 put in the program's place, and the faults a cell can have,
planted in the reference put in the program's place. Each seed's
numbers come out as one JSON line.

    python3 -m benchmark.tools.readings --workload <cell> --seeds 1,2,3

The cell's driver (drivers/<traffic kind>.py) computes them in its
`readings(cell, seed, device)`."""
import argparse
import importlib
import json
import os
import sys
import time

import torch

from .. import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    c = common.cell(args.workload)
    driver = importlib.import_module(
        f"benchmark.drivers.{c['traffic_data']['kind']}")
    dev = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = {"workload": args.workload, "seed": seed,
               "readings": driver.readings(c, seed, dev),
               "seconds": time.perf_counter() - t0,
               "device": str(dev) if dev.type == "cpu"
               else torch.cuda.get_device_name(dev)}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
