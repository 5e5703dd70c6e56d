"""The whole run of each cell at toy sizes on the CPU, the program's
plain kernels against the plain reference: correct, the result line's
schema, and `correct` false with the control in the program's place
and with each fault the eval cell can have planted in the program."""
import numpy as np
import pytest
import torch

from benchmark import common, compare
from benchmark.drivers import eval_batches
from benchmark.tests.toy import CELLS, run_toy, toy_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", CELLS)
def test_toy_run_is_correct(cell):
    out = run_toy(cell)
    assert set(out) == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    man = common.manifest()
    want = {m["name"]: m["unit"] for m in common.metrics_of(cell, man, False)}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    assert all(np.isfinite(v["value"]) and v["value"] > 0
               for v in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == set(compare.limits(cell))


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_eval_faults_fail(fault, monkeypatch):
    from adapm_tpu_torch.models import kge
    make = kge.make_pool_eval_counts

    def broken(*a, **kw):
        fn = make(*a, **kw)

        def counts(*args, **kwargs):
            g_o, g_s, t = fn(*args, **kwargs)
            if fault == "half":
                h = g_o.shape[0] // 2
                g_o, g_s = g_o.clone(), g_s.clone()
                g_o[h:] = 0
                g_s[h:] = 0
            else:
                g_o, g_s = g_o.roll(1), g_s.roll(1)
            return g_o, g_s, t
        return counts

    monkeypatch.setattr(kge, "make_pool_eval_counts", broken)
    out = run_toy("complex_wd5m.eval_b64")
    assert out["correct"] is False, out["checks"]


def test_eval_control_fails():
    """The TF32 control at 1,200,000 entities of the configuration's width
    (at toy sizes too few entities lie near a true score to move)."""
    dim = common.cell("complex_wd5m.eval_b64")["config_data"]["dim"]
    c = toy_cell("complex_wd5m.eval_b64", entities=1_200_000, dim=dim)
    c["traffic_data"].update(batch=64, ring_batches=1)
    nums = eval_batches.readings(c, 7, torch.device("cpu"))
    for name in ("control", "half", "altered"):
        ok, _ = compare.judge(dict(nums[name], repeat_gap=0.0),
                              compare.limits("complex_wd5m.eval_b64"))
        assert not ok, (name, nums[name])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_toy_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run_toy(cell, device="cuda", trace=True, seconds=1.0)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] > 0
