"""Smoke-test app (reference apps/simple.cc:36-67), the JAX package's
`apps/simple.py`: every worker repeatedly declares intent on a key, pushes
{1, 2}, advances its clock, and pulls — asserting at the end that the
aggregate value equals the total pushed. Runs on `cuda` unless `device`
says otherwise.

Run: python -m adapm_tpu_torch.apps.simple [--iterations 10]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils import alog
from .common import add_common_arguments, make_server


def run(args, device=None) -> bool:
    num_keys = 32
    srv = make_server(args, num_keys, value_lengths=2,
                      num_workers=args.num_workers or None, device=device)
    workers = [srv.make_worker(i)
               for i in range(args.num_workers or srv.num_shards)]

    key = np.array([7], dtype=np.int64)
    per_iter = np.array([1.0, 2.0], dtype=np.float32)
    for it in range(args.iterations):
        for w in workers:
            w.intent(key, w.current_clock, w.current_clock + 2)
            w.push(key, per_iter)
            w.advance_clock()
        srv.sync.run_round(force_intents=True, all_channels=True)
    for w in workers:
        w.wait_all()
    srv.quiesce()

    expect = per_iter * args.iterations * len(workers)
    vals = [w.pull_sync(key)[0] for w in workers]
    main = srv.read_main(key)
    ok = all(np.allclose(v, expect) for v in vals) and \
        np.allclose(main, expect)
    alog(f"[simple] expect={expect.tolist()} main={main.tolist()} "
         f"{'PASSED' if ok else 'FAILED'}")
    srv.shutdown()
    return ok


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--iterations", type=int, default=10)
    add_common_arguments(parser)
    args = parser.parse_args(argv)
    return 0 if run(args, device=device) else 1


if __name__ == "__main__":
    sys.exit(main())
