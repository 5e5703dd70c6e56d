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
    """`compile` names where the port's programs live; the collective
    construction point (B10) builds the exchange over a process list
    (the plain version for a CPU context) and refuses any program but
    the all-to-all; the tiered cold path and wire ingest (B8) run,
    bitwise NumpyRefPort's, in every wire format."""
    from adapm_tpu_torch.parallel.exchange import SlabExchange
    from adapm_tpu_torch.parallel.mesh import process_mesh
    tp = TorchDevicePort()
    mesh = process_mesh(0, 2, "cpu")
    xchg = tp.compile_collective("all_to_all", mesh, "p", "p")
    assert isinstance(xchg, SlabExchange) and not xchg.cuda
    assert (xchg.pid, xchg.P) == (0, 2)
    xchg.close()      # no slab was made: nothing to release
    with pytest.raises(ValueError, match="all-to-all"):
        tp.compile_collective("psum", mesh, "p", "p")
    with pytest.raises(NotImplementedError,
                       match="DeviceRoutedRunner.run_scan"):
        tp.compile(None)
    from adapm_tpu.tier.quant import quantize_rows
    ref = NumpyRefPort()
    rng = np.random.default_rng(3)
    n = 16
    pools = [rng.normal(size=(S, k, L)).astype(np.float32)
             for k in (R, C, C)]
    o_sh, o_row = _coords(rng, n, R)
    c_sh, c_sl = _coords(rng, n, C)
    use_c = rng.random(n) < 0.3
    use_cold = (rng.random(n) < 0.5) & ~use_c
    seg = np.sort(rng.integers(0, 6, n)).astype(np.int32)
    out = np.zeros((8, L), np.float32)
    co = (o_sh, o_row, c_sh, c_sl, use_c)

    def same(a, b):
        a = [a] if not isinstance(a, tuple) else a
        b = [b] if not isinstance(b, tuple) else b
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x).view(np.uint32),
                                  np.asarray(y).view(np.uint32))

    tpools = lambda: [torch.from_numpy(p.copy()) for p in pools]  # noqa
    vals = _vals(rng, n)
    same(ref.gather_cold(*pools, *co, vals, use_cold),
         tp.gather_cold(*tpools(), *co, vals, use_cold))
    same(ref.gather_pool_cold(*pools, *co, vals, use_cold, seg, out),
         tp.gather_pool_cold(*tpools(), *co, vals, use_cold, seg, out))
    same(ref.write_main_rows(pools[0].copy(), o_sh, o_row, vals),
         tp.write_main_rows(tpools()[0], o_sh, o_row, vals))
    same(ref.install_cache_rows(pools[1].copy(), pools[2].copy(), c_sh,
                                c_sl, vals, resid=vals * 0.5),
         tp.install_cache_rows(*tpools()[1:], c_sh, c_sl, vals,
                               resid=vals * 0.5))
    for mode in ("fp16", "int8"):
        q, sc = quantize_rows(mode, vals)
        same(ref.gather_cold_wire(mode, *pools, *co, q, sc, use_cold),
             tp.gather_cold_wire(mode, *tpools(), *co, q, sc, use_cold))
        same(ref.gather_pool_cold_wire(mode, *pools, *co, q, sc, use_cold,
                                       seg, out, pooling="mean"),
             tp.gather_pool_cold_wire(mode, *tpools(), *co, q, sc,
                                      use_cold, seg, out, pooling="mean"))
        same(ref.write_main_rows_wire(mode, pools[0].copy(), o_sh, o_row,
                                      q, sc),
             tp.write_main_rows_wire(mode, tpools()[0], o_sh, o_row, q,
                                     sc))
        same(ref.sync_replicas(*[p.copy() for p in pools], c_sh, c_sl,
                               o_sh, o_row, threshold=0.5, compress=mode),
             tp.sync_replicas(*tpools(), c_sh, c_sl, o_sh, o_row,
                              threshold=0.5, compress=mode))
    assert tp.wire_ingest_rows == ref.wire_ingest_rows > 0


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """A grep of every source of the port and of chip_smoke.py: no
    import of jax (or jaxlib) and none of the JAX package `adapm_tpu`
    (tier/quant.py included: the port keeps its own copy)."""
    import os
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|adapm_tpu)\b(?!_torch)",
                     re.M)
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "adapm_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    hits = [(f, m.group(0).strip()) for f in files
            for m in bad.finditer(open(f).read())]
    assert not hits, hits
