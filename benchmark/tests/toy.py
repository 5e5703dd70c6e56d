"""Toy sizes of the benchmark's cells for tests on the CPU (and on a
card, where the tests marked `gpu` find one)."""
import torch

from benchmark import common, run

TOY_CONFIG = dict(entities=3000, relations=12, dim=8)
TOY_TRAFFIC = {"eval_batches": dict(batch=16, ring_batches=6, chunk=512,
                                    trace_batches=4)}
CELLS = tuple(w["name"] for w in common.manifest()["workloads"])


def toy_cell(name: str, **config) -> dict:
    """The cell's entry with toy configuration and traffic."""
    c = common.cell(name)
    c["config_data"] = dict(c["config_data"], **dict(TOY_CONFIG, **config))
    tr = c["traffic_data"]
    c["traffic_data"] = dict(tr, **TOY_TRAFFIC[tr["kind"]])
    return c


def run_toy(name: str, device="cpu", seed: int = 2**31 + 12345,
            trace: bool = False, seconds: float = 0.3) -> dict:
    c = toy_cell(name)
    return run.run_cell(name, seed, seconds, trace, torch.device(device),
                        overrides={"config": c["config_data"],
                                   "traffic": c["traffic_data"]})
