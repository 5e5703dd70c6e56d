"""What the KGE drivers share: the set-up clock, the program's server
built from a configuration, and the benchmark's rows handed to it."""
import sys
import time
import types

import numpy as np

from .. import inputs
from ..inputs import ENTITY as ENT, RELATION as REL
from ..reference import model


class SetupClock:
    """Set-up's parts, each printed on its own line as it ends; `total`
    counts from the process's start."""

    def __init__(self, t_top: float, age0: float):
        self.t_top, self.age0 = t_top, age0
        self.t = t_top
        self.parts = {}
        print(f"setup: interpreter start {age0:.3f} s", file=sys.stderr,
              flush=True)

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now
        print(f"setup: {name} {self.parts[name]:.3f} s", file=sys.stderr,
              flush=True)

    def total(self, now: float) -> float:
        return self.age0 + (now - self.t_top)


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def imports(dev, clock: SetupClock):
    """The port's modules the drivers use; on the card its kernel
    libraries and native router, built into the checkout's build/ on the
    first run and found there after."""
    import adapm_tpu_torch
    from adapm_tpu_torch.config import SystemOptions
    from adapm_tpu_torch.models import kge
    from adapm_tpu_torch.ops import fused, kernels
    clock.lap("import")
    if dev.type == "cuda":
        from adapm_tpu_torch import native
        kernels.build()
        native.get_lib()
        clock.lap("kernel build")
    return types.SimpleNamespace(pm=adapm_tpu_torch, kge=kge, fused=fused,
                                 SystemOptions=SystemOptions)


def widths(cfg: dict) -> tuple:
    """(entity, relation) embedding widths; a stored row is twice its
    embedding, [emb | AdaGrad state]."""
    m, d = model(cfg["model"]), cfg["dim"]
    return m.entity_emb(d), m.relation_emb(d)


def build_server(P, cfg: dict, dev):
    """The program's server: one pool of [emb | AdaGrad state] rows for
    entities and relations alike."""
    ew, rw = widths(cfg)
    if ew != rw:
        raise ValueError(f"model {cfg['model']}: entity and relation rows "
                         "differ in width; the drivers hold one pool")
    return P.pm.setup(cfg["entities"] + cfg["relations"], 2 * ew,
                      opts=P.SystemOptions(**cfg["sys_opts"]),
                      num_shards=cfg["shards"], device=dev)


def fill(srv, cfg: dict, seed: int) -> None:
    """The benchmark's initial rows (benchmark.inputs) written into the
    program's pools at the slots its address book gave the keys, slab by
    slab on the device: a group's keys must sit in consecutive slots of
    shard 0, as a fresh one-shard server places them."""
    import torch
    from adapm_tpu_torch.exec import dispatch_gate
    E, R = cfg["entities"], cfg["relations"]
    ew, rw = widths(cfg)
    scale, st = cfg["init_scale"], cfg["optimizer"]["state_init"]
    ab = srv.ab
    with torch.no_grad(), dispatch_gate():
        for grp, k0, n, emb in ((ENT, 0, E, ew), (REL, E, R, rw)):
            keys = np.arange(k0, k0 + n)
            main = srv.stores[int(ab.key_class[k0])].main
            s0 = int(ab.slot[k0])
            if not ((ab.owner[keys] == 0).all() and np.array_equal(
                    ab.slot[keys], np.arange(s0, s0 + n))):
                raise RuntimeError("the program placed a group's keys "
                                   "other than in consecutive slots of "
                                   "shard 0")
            for lo, hi, rows in inputs.slabs(seed, grp, n, emb, scale,
                                             main.device):
                main[0, s0 + lo:s0 + hi, :emb] = rows
                main[0, s0 + lo:s0 + hi, emb:] = st
    srv.block()


def collect() -> None:
    """Give the program's memory back once the caller has shut its server
    down and dropped it (the server and its runner hold each other)."""
    import gc
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
