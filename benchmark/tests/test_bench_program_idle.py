"""The split of the traced slice's idle time by the program's spans
(tools/program_idle.py) on synthetic profiler events, the trace reading
with program ranges in the events, and the split of a real CPU profile
of the eval program."""
import types

import numpy as np
import pytest
import torch

from benchmark import trace
from benchmark.tools.program_idle import split

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
NAMES = {"pool_eval_counts": "pool_eval_counts_kernel",
         "routed_gather": "routed_gather_kernel"}


def ev(name, a, b, dev=CUDA, thread=1):
    return types.SimpleNamespace(name=name, device_type=dev, thread=thread,
                                 time_range=types.SimpleNamespace(start=a,
                                                                  end=b))


# one unit: window [0, 100]; device busy [10, 20] (K1) and [50, 90] (K4)
BASE = [ev(trace.WINDOW, 0, 100, CPU),
        ev("bench.dispatch", 0, 95, CPU),
        ev("bench.dispatch", 0, 95),                 # its device mirror
        ev("void routed_gather_kernel<4>", 10, 20),
        ev("void pool_eval_counts_kernel<2>", 50, 90)]
PROGRAM = [ev("adapm.eval.rows", 2, 30, CPU),
           ev("adapm.kv.pull", 5, 12, CPU),          # nested in eval.rows
           ev("adapm.eval.queries", 30, 40, CPU),
           ev("adapm.eval.k4", 40, 60, CPU),
           ev("adapm.sync.round", 0, 100, CPU, thread=2)]   # another thread
LAUNCHED = {"routed_gather": 1, "pool_eval_counts": 1}


def test_program_ranges_leave_the_reading_unchanged():
    a = trace.read(BASE, NAMES, LAUNCHED)
    b = trace.read(BASE + PROGRAM, NAMES, LAUNCHED)
    for k in ("window_s", "busy_s", "gaps", "kernels", "mismatch", "lost"):
        assert a[k] == b[k], k
    assert not any(n.startswith("adapm.")
                   for n, _ in trace.breakdown(b)["device_ops"])


def test_idle_split_by_overlap_to_the_innermost_range():
    got = split(BASE + PROGRAM)
    # idle: [0, 10] [20, 50] [90, 100]
    want = {"outside": 2 + 10, "kv.pull": 5, "eval.rows": 3 + 10,
            "eval.queries": 10, "eval.k4": 10}
    assert set(got) == set(want) and "sync.round" not in got
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-6, abs=1e-12), k
    rec = trace.read(BASE + PROGRAM, NAMES, LAUNCHED)
    assert sum(got.values()) == pytest.approx(
        rec["window_s"] - rec["busy_s"], abs=1e-12)


@pytest.mark.parametrize("extra", [[], PROGRAM[-1:]],
                         ids=["no ranges", "another thread only"])
def test_no_program_range_reads_nothing(extra):
    assert split(BASE + extra) == {}


def test_split_of_the_eval_program_under_the_cpu_profiler():
    """The eval program's own ranges, from torch's CPU profiler: no device
    rows, so the window is idle throughout and the split covers it."""
    from adapm_tpu_torch.models import kge
    E, R, L, chunk = 40, 3, 16, 16
    rng = np.random.default_rng(0)
    main = torch.from_numpy(rng.normal(size=(1, E + R, L)).astype(np.float32))
    tables = (torch.zeros(E + R, dtype=torch.int32),
              torch.arange(E + R, dtype=torch.int32), None)
    keys = torch.arange(48, dtype=torch.int32).remainder(E).reshape(3, 16)
    q = [torch.tensor(x, dtype=torch.int32) for x in ([1, 2], [E, E + 1],
                                                      [3, 4])]
    fn = kge.make_pool_eval_counts("complex", 8, 8, chunk, shared_pool=True)
    with torch.autograd.profiler.profile() as prof:
        with torch.autograd.profiler.record_function(trace.WINDOW):
            fn(main, tables, keys, E, *q)
    got = split(prof.function_events)
    assert set(got) == {"eval.rows", "eval.queries", "eval.k4", "outside"}
    assert all(v > 0 for v in got.values())
    win, = [e for e in prof.function_events if e.name == trace.WINDOW]
    assert sum(got.values()) == pytest.approx(
        (win.time_range.end - win.time_range.start) / 1e6, rel=1e-9)
