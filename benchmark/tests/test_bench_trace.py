"""The trace reading on synthetic profiler events."""
import types

import torch

from benchmark import trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def ev(name, a, b, dev=CUDA):
    return types.SimpleNamespace(name=name, device_type=dev,
                                 time_range=types.SimpleNamespace(start=a,
                                                                  end=b))


NAMES = {"routed_gather": "routed_gather_kernel",
         "complex_step": "complex_step_kernel"}


def test_busy_gaps_and_records():
    events = [ev(trace.WINDOW, 0, 100, CPU),
              ev("bench.intent", 0, 40, CPU),
              ev("bench.run_scan", 40, 100, CPU),
              ev("bench.run_scan", 40, 100),        # its device mirror
              ev("void routed_gather_kernel<4>", 10, 30),
              ev("void complex_step_kernel<4>", 20, 50),
              ev("memset32", 70, 80)]
    rec = trace.read(events, NAMES, {"routed_gather": 1, "complex_step": 1})
    assert rec["window_s"] == 100e-6
    assert abs(rec["busy_s"] - 50e-6) < 1e-12      # [10, 50] and [70, 80]
    assert not rec["lost"] and rec["mismatch"] == {}
    gaps = rec["gaps"]      # [0, 10] intent, [50, 70] and [80, 100] run_scan
    assert abs(gaps["intent"] - 10e-6) < 1e-12
    assert abs(gaps["run_scan"] - 40e-6) < 1e-12
    assert trace.kernel_s(rec, "complex_step_kernel") == (1, 30e-6)
    b = trace.breakdown(rec)
    assert b["device_ops"][0][0] == "void complex_step_kernel<4>"
    assert [g for g, _ in b["idle_gaps"]] == ["run_scan", "intent"]


def test_lost_records_are_marked():
    events = [ev(trace.WINDOW, 0, 100, CPU),
              ev("void routed_gather_kernel<4>", 10, 30)]
    rec = trace.read(events, NAMES, {"routed_gather": 2})
    assert rec["lost"] and rec["mismatch"] == {"routed_gather": (2, 1)}
