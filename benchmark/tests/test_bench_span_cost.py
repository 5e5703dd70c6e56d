"""The on-cost tool of the program's spans (tools/span_cost.py) on the
CPU: a reading for every sink, and no cell run without a CUDA device."""
import json

import pytest
import torch

from adapm_tpu_torch.obs.spans import profiling
from benchmark.tools import span_cost


def test_enter_exit_reads_every_sink(capsys):
    assert span_cost.main(["--calls", "50", "--reps", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["enter_exit_us"]) == set(span_cost.SINKS)
    assert all(v > 0 for v in line["enter_exit_us"].values())
    assert not profiling()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_cell_run_without_a_card():
    assert span_cost.main(["--calls", "5", "--reps", "1", "--workload",
                           "complex_wd5m.eval_b64", "--seeds", "1"]) == 3
