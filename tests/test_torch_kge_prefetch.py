"""The port's KGE app with the prefetch pipeline on (the default) at one
shard: delegated planner rounds, the runner's registered mirror refresh
and, on the device-routed per-step path, keys pre-uploaded as
`StagedKeys` on the prepare path.

At one shard every key is owned by the worker's shard, so the planner
moves nothing and the pipeline may change no bit: epoch losses and the
final table must be bitwise those of `--sys.prefetch 0`. Against the
JAX app with its pipeline on (host routes: the same numpy PullSample
negatives on both packages) the epoch losses hold to rtol 1e-4, the
tolerance of tests/test_torch_kge_app.py."""
import numpy as np
import pytest

from adapm_tpu.apps import knowledge_graph_embeddings as jk
from adapm_tpu_torch.apps import knowledge_graph_embeddings as tk

BASE = ["--dim", "8", "--neg_ratio", "2", "--synthetic_entities", "60",
        "--synthetic_relations", "4", "--synthetic_triples", "400",
        "--epochs", "3", "--batch_size", "32", "--lr", "0.2",
        "--eval_every", "3", "--eval_triples", "60", "--num_shards", "1",
        "--sys.sync.max_per_sec", "0"]
OFF = ["--sys.prefetch", "0"]


def _port(argv):
    return tk.run_app(tk.build_parser().parse_args(argv), device="cpu")


@pytest.mark.parametrize("route", [
    [], ["--scan_steps", "4"], ["--no-device_routes"]],
    ids=["device", "device-scan4", "host"])
def test_pipeline_on_is_bitwise_pipeline_off(route):
    on = _port(BASE + route)
    off = _port(BASE + route + OFF)
    assert len(on["epoch_losses"]) == 3
    assert np.array_equal(np.float64(on["epoch_losses"]),
                          np.float64(off["epoch_losses"]))
    assert on["mrr"] == off["mrr"] and on["ent_norm"] == off["ent_norm"]
    assert off["staged_steps"] == 0
    if route == []:
        # the per-step device path pre-uploads every prepared batch
        assert on["staged_steps"] > 0
    else:
        assert on["staged_steps"] == 0


def test_pipeline_on_matches_jax_app(monkeypatch):
    argv = BASE + ["--no-device_routes"]
    losses = []
    monkeypatch.setattr(jk, "epoch_report",
                        lambda name, ep, loss, watch, extra="":
                        losses.append(loss))
    rj = jk.run_app(jk.build_parser().parse_args(argv))
    rt = _port(argv)
    np.testing.assert_allclose(rt["epoch_losses"], losses, rtol=1e-4)
    assert abs(rt["mrr"] - rj["mrr"]) <= 0.02, (rt["mrr"], rj["mrr"])
