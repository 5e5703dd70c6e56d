"""The RotatE cell (rotate_wd5m.eval_b64): its whole run at toy sizes on
the CPU with each fault its limits are set against planted in the
program (`correct` false), the TF32 control failing at a size where
near-ties show, K17's cost counted by hand, and K17's roofline reader."""
import types

import pytest
import torch

from benchmark import common, compare, costs
from benchmark.reference import rank_dist
from benchmark.tests.toy import run_toy

CELL = "rotate_wd5m.eval_b64"


def _squared(x, y):
    """The squared Euclidean distance of [..., 2d] rows ([re | im]) in
    place of sum_i |x_i - y_i|."""
    d = x.shape[-1] // 2
    dr, di = x[..., :d] - y[..., :d], x[..., d:] - y[..., d:]
    return (dr * dr + di * di).sum(-1)


@pytest.mark.parametrize("fault", ["half", "altered", "squared",
                                   "no_rotation"])
def test_rotate_faults_fail(fault, monkeypatch):
    from adapm_tpu_torch.models import kge
    from adapm_tpu_torch.ops import kernels
    if fault == "squared":
        monkeypatch.setattr(kernels, "_complex_distance",
                            lambda q, rows: _squared(q[:, None], rows[None]))
        monkeypatch.setattr(kge, "rotate_distance", _squared)
    elif fault == "no_rotation":
        monkeypatch.setattr(kge, "_rotation", lambda r: (
            torch.ones_like(r[..., :r.shape[-1] // 2]),
            torch.zeros_like(r[..., :r.shape[-1] // 2])))
    else:
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
    out = run_toy(CELL)
    assert out["correct"] is False, out["checks"]


def test_rotate_control_fails():
    """The TF32 control at 2,000,000 entities of the configuration's width,
    one judged query both sides (at toy sizes too few entities lie near
    a true distance to move)."""
    cfg = dict(common.cell(CELL)["config_data"], entities=2_000_000)
    keys = ([1_234_567], [cfg["entities"] + 5], [76_543])
    dev = torch.device("cpu")
    truth = rank_dist.counts(cfg, 7, *keys, dev)
    ctl = rank_dist.counts(cfg, 7, *keys, dev, control=True)
    ok, checks = compare.judge(
        dict(compare.eval_numbers(ctl, truth), repeat_gap=0.0),
        compare.limits(CELL))
    assert not ok, checks


def test_k17_hand_count():
    # B=2 queries, E=3 candidates, K=4 (d=2 components): 2 sides x 2 x 3
    # x 2 = 24 moduli, 6 operations and one root each; bytes: 3 rows of
    # 16, 3 keys and owner/slot pairs of 12, 2 x 2 query rows of 16, and
    # per query the true distance, two keys and two counts (20)
    flops, roots, nbytes = costs.load("k17").cost(2, 3, 4)
    assert (flops, roots) == (6 * 24, 24)
    assert nbytes == 3 * 16 + 3 * 12 + 2 * 2 * 16 + 2 * 20
    k17 = costs.load("k17")
    assert k17.SFU_PER_S == 132 * 16 * 1.98e9
    t, by = k17.bound_s(*k17.cost(64, 4_594_485, 512))
    assert by == "roots" and t == pytest.approx(0.0360, abs=5e-5)


def test_k17_roofline_reads_k17_records_only():
    """A slice with K17 records reads the bound over the device time a
    launch; a program without K17 (no such record) reads nothing."""
    read = common.load_file("metrics", "k17_roofline.eval").read
    cost = costs.load("k17").cost(64, 4_594_485, 512)
    rec = {"lost": False, "kernels": {
        "void (anonymous namespace)::pool_eval_dist_kernel<8, true>(Args)":
            [2, 0.096]}}
    run = types.SimpleNamespace(trace=rec, k17_cost=cost)
    assert read(run) == pytest.approx(100 * 0.036002 / 0.048, rel=1e-4)
    rec["kernels"] = {"pair_pool_eval_counts_kernel": [2, 0.03]}
    assert read(run) is None
    assert read(types.SimpleNamespace(trace=None, k17_cost=cost)) is None


def test_rotate_run_loads_no_jax():
    """The RotatE cell's traced toy run, in a process of its own, loads no
    module named jax, jaxlib, flax or adapm_tpu. (test_bench_imports.py's
    test over every cell runs without this directory's conftest, which
    registers the cell's toy traffic; that test fails on this cell until
    tests/toy.py's TOY_TRAFFIC holds it.)"""
    import json
    import os
    import subprocess
    import sys
    code = ("import json\n"
            "import benchmark.tests.conftest\n"
            "from benchmark.tests.toy import run_toy\n"
            f"out = run_toy({CELL!r}, trace=True)\n"
            "from benchmark.common import forbidden_modules\n"
            "print(json.dumps([out['correct'], forbidden_modules()]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [True, []]
