"""TorchDevicePort (adapm_tpu_torch/device/torchport.py) against the JAX
package's pure-NumPy reference port, bitwise at every op index.

A seeded storm drives both ports with the same program mix the
port-differential check of the JAX package exercises at the store
level — pushes (scatter-add), pulls (routed gather), sets, replica
creation, sync rounds (plain and thresholded), relocation, row reads,
replica installs/refreshes and row clears — over padded index batches
carrying OOB padding, out-of-range shards, negative slots and heavy
duplicates. After every op, every pool and every read must be
bit-identical between the two ports."""
import numpy as np
import pytest
import torch

from adapm_tpu.device.refport import OOB, NumpyRefPort
from adapm_tpu_torch.device.torchport import TorchDevicePort

S, R, C, L = 8, 32, 16, 8
OPS = ("push", "pull", "set", "replica", "sync", "sync_thr", "relocate",
       "read", "install", "refresh", "clear")


def _coords(rng, n, slots):
    sh = rng.integers(0, S, n).astype(np.int32)
    sl = rng.integers(0, min(slots, 6), n).astype(np.int32)  # duplicates
    u = rng.random(n)
    sl[u < 0.15] = OOB
    sl[(u >= 0.15) & (u < 0.2)] = -2
    sh[(u >= 0.2) & (u < 0.25)] = S + 1
    return sh, sl


def _vals(rng, n):
    v = rng.normal(size=(n, L)).astype(np.float32)
    v[rng.random(n) < 0.1] = -0.0
    return v


def _storm(seed, n_ops):
    rng = np.random.default_rng(seed)
    init = [rng.normal(size=(S, k, L)).astype(np.float32)
            for k in (R, C, C)]
    ref = [a.copy() for a in init]
    tor = [torch.from_numpy(a.copy()) for a in init]
    rp, tp = NumpyRefPort(), TorchDevicePort()
    for i in range(n_ops):
        op = OPS[i % len(OPS)]
        n = int(rng.integers(1, 24))
        a_sh, a_sl = _coords(rng, n, R)
        b_sh, b_sl = _coords(rng, n, C)
        v, v2 = _vals(rng, n), _vals(rng, n)
        use_c = rng.random(n) < 0.5
        out_r = out_t = None
        if op == "push":
            ref[0], ref[2] = rp.scatter_add(ref[0], ref[2], a_sh, a_sl,
                                            b_sh, b_sl, v)
            tor[0], tor[2] = tp.scatter_add(tor[0], tor[2], a_sh, a_sl,
                                            b_sh, b_sl, v)
        elif op == "pull":
            out_r = rp.gather(*ref, a_sh, a_sl, b_sh, b_sl, use_c)
            out_t = tp.gather(*tor, a_sh, a_sl, b_sh, b_sl, use_c)
        elif op == "set":
            ref = list(rp.set_rows(*ref, a_sh, a_sl, v, b_sh, b_sl))
            tor = list(tp.set_rows(*tor, a_sh, a_sl, v, b_sh, b_sl))
        elif op == "replica":
            ref[1], ref[2] = rp.replica_create(*ref, a_sh, a_sl, b_sh, b_sl)
            tor[1], tor[2] = tp.replica_create(*tor, a_sh, a_sl, b_sh, b_sl)
        elif op in ("sync", "sync_thr"):
            thr = 0.0 if op == "sync" else 0.8
            ref = list(rp.sync_replicas(*ref, b_sh, b_sl, a_sh, a_sl,
                                        threshold=thr))
            tor = list(tp.sync_replicas(*tor, b_sh, b_sl, a_sh, a_sl,
                                        threshold=thr))
        elif op == "relocate":
            n_sh, n_sl = _coords(rng, n, R)
            ref[0], ref[2] = rp.relocate(ref[0], ref[2], a_sh, a_sl, n_sh,
                                         n_sl, b_sh, b_sl)
            tor[0], tor[2] = tp.relocate(tor[0], tor[2], a_sh, a_sl, n_sh,
                                         n_sl, b_sh, b_sl)
        elif op == "read":
            out_r = rp.read_rows_at(ref[2], b_sh, b_sl)
            out_t = tp.read_rows_at(tor[2], b_sh, b_sl)
        elif op == "install":
            ref[1], ref[2] = rp.install_rows(ref[1], ref[2], b_sh, b_sl, v)
            tor[1], tor[2] = tp.install_rows(tor[1], tor[2], b_sh, b_sl, v)
        elif op == "refresh":
            ref[1], ref[2] = rp.refresh_after_sync(ref[1], ref[2], b_sh,
                                                   b_sl, v, v2)
            tor[1], tor[2] = tp.refresh_after_sync(tor[1], tor[2], b_sh,
                                                   b_sl, v, v2)
        else:
            ref[0] = rp.clear_rows(ref[0], a_sh, a_sl)
            tor[0] = tp.clear_rows(tor[0], a_sh, a_sl)
        yield i, op, ref, tor, out_r, out_t


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_port_matches_numpy_ref_port_bitwise_every_op(seed):
    for i, op, ref, tor, out_r, out_t in _storm(seed, 110):
        for name, a, b in zip(("main", "cache", "delta"), ref, tor):
            assert np.array_equal(_bits(a), _bits(b.numpy())), \
                f"op {i} ({op}): {name} pool differs"
        if out_r is not None:
            assert np.array_equal(_bits(out_r), _bits(out_t.numpy())), \
                f"op {i} ({op}): read differs"


def test_unported_port_methods_name_their_roadmap_item():
    tp = TorchDevicePort()
    with pytest.raises(NotImplementedError, match="B7"):
        tp.gather_pool()
    with pytest.raises(NotImplementedError, match="B8"):
        tp.gather_cold()
    with pytest.raises(NotImplementedError, match="B10"):
        tp.compile_collective(None, None, None, None)
    pools = [torch.zeros(S, k, L) for k in (R, C, C)]
    z = np.zeros(1, np.int32)
    with pytest.raises(NotImplementedError, match="B8"):
        tp.sync_replicas(*pools, z, z, z, z, compress="fp16")
