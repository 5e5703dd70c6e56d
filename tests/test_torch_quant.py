"""The compression plane of the port against the JAX package's: the
host twins of tier/quant.py, the plain versions of K9-K12
(ops/kernels.py, run here on the CPU) against the jitted XLA programs
they replace (device/jaxport.py), and test_quant.py's QuantCold and
compressed-sync scenarios on both packages.

Everything is held bitwise (the wire formats are exact by contract:
IEEE f32 division and multiplication, f16 round-to-nearest-even,
round-half-to-even), except where the JAX test holds a bound: the
quantized storm's reads stay within two grid steps of an fp32 shadow,
and the post-quiesce exact flush within rtol/atol 1e-6 of it.
"""
import tracemalloc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adapm_tpu
import adapm_tpu_torch
from adapm_tpu.device import jaxport as J
from adapm_tpu.tier import quant as jq
from adapm_tpu_torch.device.torchport import TorchDevicePort
from adapm_tpu_torch.ops import kernels as K
from adapm_tpu_torch.tier import quant as tq

E = 384
L = 8
OOB = int(J.OOB)


def _special_rows(rng, n=64, width=L):
    """Seeded rows with the edge cases: -0.0, values beyond +-65504,
    rows already on the fp16 grid and on an int8 grid, all-zero rows,
    ties for round-half-to-even."""
    rows = (rng.normal(size=(n, width)) *
            rng.choice([1e-3, 0.1, 1.0, 100.0, 1e5], size=(n, 1))
            ).astype(np.float32)
    rows[0] = -0.0
    rows[1] = 0.0
    rows[2, ::2] = -0.0
    rows[3] = np.float32(1e9) * np.sign(rows[3])
    rows[4] = rng.normal(size=width).astype(np.float16).astype(np.float32)
    rows[5] = np.arange(-width // 2, width - width // 2, dtype=np.float32) \
        * np.float32(0.25)
    rows[6] = np.float32(127.0) * np.linspace(-1, 1, width,
                                              dtype=np.float32)
    rows[7, :] = np.float32(0.5)          # x/s lands on a .5 tie
    rows[7, 0] = np.float32(127.0)
    rows[8] = np.float32(70000.0)
    return rows


# ---------------------------------------------------------------------------
# host twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fp32", "fp16", "int8"])
def test_host_twins_bitwise(mode):
    rows = _special_rows(np.random.default_rng(1))
    qa, sa = jq.quantize_rows(mode, rows)
    qb, sb = tq.quantize_rows(mode, rows)
    assert qa.dtype == qb.dtype and np.array_equal(
        qa.view(np.uint8), qb.view(np.uint8))
    if sa is None:
        assert sb is None
    else:
        assert np.array_equal(sa.view(np.uint32), sb.view(np.uint32))
    da, db = jq.dequantize_rows(mode, qa, sa), tq.dequantize_rows(mode, qb, sb)
    assert np.array_equal(da.view(np.uint32), db.view(np.uint32))
    if mode != "fp32":
        for a, b in zip(jq.compress_delta(mode, rows),
                        tq.compress_delta(mode, rows)):
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
        assert np.array_equal(jq.grid_step(mode, rows),
                              tq.grid_step(mode, rows))
        assert np.array_equal(jq.int8_scale(rows).view(np.uint32),
                              tq.int8_scale(rows).view(np.uint32))
    assert jq.wire_bytes_per_row(mode, L) == tq.wire_bytes_per_row(mode, L)
    assert jq.F16_MAX == tq.F16_MAX == K.F16_MAX


# ---------------------------------------------------------------------------
# the plain versions of K9-K12 vs the XLA programs
# ---------------------------------------------------------------------------


def _pools(rng, S=3, R=16, C=8):
    main = rng.normal(size=(S, R, L)).astype(np.float32)
    main[0, 0] = -0.0
    cache = rng.normal(size=(S, C, L)).astype(np.float32)
    delta = rng.normal(size=(S, C, L)).astype(np.float32)
    return main, cache, delta


def _coords(rng, n, S=3, R=16, C=8):
    o_sh = rng.integers(0, S, n).astype(np.int32)
    o_row = rng.integers(0, R, n).astype(np.int32)
    o_row[::7] = OOB
    c_sh = rng.integers(0, S, n).astype(np.int32)
    c_sl = rng.integers(0, C, n).astype(np.int32)
    use_c = rng.random(n) < 0.3
    c_sl[~use_c] = OOB
    use_cold = (rng.random(n) < 0.5) & ~use_c
    use_cold[-1] = True
    return o_sh, o_row, c_sh, c_sl, use_c, use_cold


def _wire(mode, rows):
    q, s = tq.quantize_rows(mode, rows)
    return q, (np.zeros(len(rows), np.float32) if s is None else s)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("mode", ["fp32", "fp16", "int8"])
def test_k9_plain_bitwise_gather_cold(mode):
    rng = np.random.default_rng(2)
    main, cache, delta = _pools(rng)
    n = 40
    co = _coords(rng, n)
    q, s = _wire(mode, _special_rows(rng, n))
    if mode == "fp32":
        want = J._gather_cold(main, cache, delta, *co[:5], q, co[5])
    elif mode == "fp16":
        want = J._gather_cold_fp16(main, cache, delta, *co[:5], q, co[5])
    else:
        want = J._gather_cold_int8(main, cache, delta, *co[:5], q, s,
                                   co[5])
    got = K.gather_cold(_t(main), _t(cache), _t(delta),
                        *[_t(x) for x in co[:5]], mode, _t(q),
                        _t(s) if mode == "int8" else None, _t(co[5]))
    assert np.array_equal(np.asarray(want).view(np.uint32),
                          got.numpy().view(np.uint32))


@pytest.mark.parametrize("mode", ["fp32", "fp16", "int8"])
@pytest.mark.parametrize("pooling", ["sum", "mean"])
def test_k10_plain_bitwise_gather_pool_cold(mode, pooling):
    rng = np.random.default_rng(3)
    main, cache, delta = _pools(rng)
    n, nb = 48, 16
    co = _coords(rng, n)
    q, s = _wire(mode, _special_rows(rng, n))
    seg = rng.integers(0, nb, n).astype(np.int32)   # unsorted
    seg[::9] = OOB
    out = rng.normal(size=(nb, L)).astype(np.float32)
    if mode == "fp32":
        want = J._gather_pool_cold(main, cache, delta, *co[:5], q, co[5],
                                   seg, out, pooling=pooling)
    elif mode == "fp16":
        want = J._gather_pool_cold_fp16(main, cache, delta, *co[:5], q,
                                        co[5], seg, out, pooling=pooling)
    else:
        want = J._gather_pool_cold_int8(main, cache, delta, *co[:5], q, s,
                                        co[5], seg, out, pooling=pooling)
    got = K.gather_pool_cold(
        _t(main), _t(cache), _t(delta), *[_t(x) for x in co[:5]], mode,
        _t(q), _t(s) if mode == "int8" else None, _t(co[5]), _t(seg),
        _t(out.copy()), pooling)
    assert np.array_equal(np.asarray(want).view(np.uint32),
                          got.numpy().view(np.uint32))


@pytest.mark.parametrize("mode", ["fp32", "fp16", "int8"])
def test_k11_plain_bitwise_write_main_rows(mode):
    rng = np.random.default_rng(4)
    main, _, _ = _pools(rng)
    b = 24
    sh = rng.integers(0, 3, b).astype(np.int32)
    row = rng.integers(0, 16, b).astype(np.int32)
    row[[3, 9]] = row[[2, 8]]      # duplicates: the last wins
    sh[[3, 9]] = sh[[2, 8]]
    row[-4:] = OOB                 # bucket padding drops
    q, s = _wire(mode, _special_rows(rng, b))
    if mode == "fp32":
        want = J._write_main_rows(jnp.asarray(main.copy()), sh, row, q)
    elif mode == "fp16":
        want = J._write_main_rows_fp16(jnp.asarray(main.copy()), sh, row, q)
    else:
        want = J._write_main_rows_int8(jnp.asarray(main.copy()), sh, row, q,
                                       s)
    got = K.write_main_rows(_t(main.copy()), _t(sh), _t(row), mode, _t(q),
                            _t(s) if mode == "int8" else None)
    assert np.array_equal(np.asarray(want).view(np.uint32),
                          got.numpy().view(np.uint32))


@pytest.mark.parametrize("mode", ["fp16", "int8"])
@pytest.mark.parametrize("threshold", [0.0, 1.0])
def test_k12_plain_bitwise_sync_replicas_compressed(mode, threshold):
    """The port's whole compressed round (K12's plain version, then K3,
    K1 and the sets) against _sync_replicas_compressed: the pools and
    the returned residual norm, bitwise."""
    rng = np.random.default_rng(5)
    S, R, C, n = 2, 16, 32, 24
    main = rng.normal(size=(S, R, L)).astype(np.float32)
    cache = rng.normal(size=(S, C, L)).astype(np.float32)
    delta = np.zeros((S, C, L), np.float32)
    r_sh = rng.integers(0, S, n).astype(np.int32)
    r_cs = rng.permutation(C)[:n].astype(np.int32)
    d = _special_rows(rng, n)
    d[n // 2:] *= np.float32(1e-3)          # about half held at 1.0
    delta[r_sh, r_cs] = d
    o_sh = rng.integers(0, S, n).astype(np.int32)
    o_sl = rng.integers(0, R, n).astype(np.int32)
    o_sl[[1, 5]] = o_sl[[0, 4]]             # two replicas of one key
    o_sh[[1, 5]] = o_sh[[0, 4]]
    r_cs[-3:] = OOB                         # bucket padding
    o_sl[-3:] = OOB
    want = J._sync_replicas_compressed(
        jnp.asarray(main.copy()), jnp.asarray(cache.copy()),
        jnp.asarray(delta.copy()), r_sh, r_cs, o_sh, o_sl,
        jnp.float32(threshold), mode=mode)
    port = TorchDevicePort()
    got = port.sync_replicas(_t(main.copy()), _t(cache.copy()),
                             _t(delta.copy()), r_sh, r_cs, o_sh, o_sl,
                             threshold=threshold, compress=mode)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a).view(np.uint32),
                              np.asarray(b).view(np.uint32))
    # K12's own outputs against the host twin, row by row
    shipped, new_delta, ship, norm = K.sync_compress(
        _t(delta), _t(r_sh), _t(r_cs), mode, threshold)
    live = r_cs != OOB
    hs, hr = tq.compress_delta(mode, d[live])
    assert np.array_equal(shipped.numpy()[live].view(np.uint32),
                          hs.view(np.uint32))
    nd = np.where(ship.numpy()[live][:, None], hr, d[live])
    assert np.array_equal(new_delta.numpy()[live].view(np.uint32),
                          nd.view(np.uint32))


# ---------------------------------------------------------------------------
# test_quant.py's scenarios on both packages
# ---------------------------------------------------------------------------


class Pkg:
    def __init__(self, mod):
        self.mod = mod
        self.is_jax = mod is adapm_tpu
        self.SystemOptions = mod.SystemOptions
        base = __import__(f"{mod.__name__}.base", fromlist=["x"])
        self.CLOCK_MAX = base.CLOCK_MAX
        self.MgmtTechniques = base.MgmtTechniques
        self.quant = jq if self.is_jax else tq

    def setup(self, num_keys, vlen, opts):
        if self.is_jax:
            return adapm_tpu.setup(num_keys, vlen, opts=opts)
        return adapm_tpu_torch.setup(num_keys, vlen, opts=opts,
                                     num_shards=8, device="cpu")

    def mk(self, tier, hot_rows=16, **kw):
        return self.setup(E, L, self.SystemOptions(
            sync_max_per_sec=0, prefetch=False, tier=tier,
            tier_hot_rows=hot_rows, **kw))


PKGS = [Pkg(adapm_tpu), Pkg(adapm_tpu_torch)]
IDS = ["jax", "port"]


def _read_all(srv):
    return np.asarray(srv.read_main(np.arange(E)))


def _grid_tol(mode, rows):
    return 2.0 * tq.grid_step(mode, rows) + 1e-6


@pytest.mark.parametrize("P", PKGS, ids=IDS)
def test_quantcold_mechanics(P):
    """test_quant.py's QuantCold cases: sub-grid adds land through the
    residual, in-batch duplicates accumulate in batch order, the
    residual cap evicts and counts."""
    rng = np.random.default_rng(0)
    QC = P.quant.QuantCold
    qc = QC(1, 4, L, mode="int8")
    qc.set_at(np.array([0]), np.array([1]), np.full((1, L), 100.0,
                                                   np.float32))
    for _ in range(40):
        qc.add_at(np.array([0]), np.array([1]),
                  np.full((1, L), 0.1, np.float32))
    true = 100.0 + 40 * 0.1
    vis = qc.read(np.array([0]), np.array([1]))[0]
    assert np.abs(vis - true).max() <= true / 127.0 + 1e-5
    assert np.abs(qc.take_true(np.array([0]), np.array([1]))[0]
                  - true).max() <= 1e-3
    sh, sl = np.array([0, 0, 0, 0]), np.array([2, 3, 2, 2])
    rows = rng.normal(size=(4, L)).astype(np.float32) * 100
    for mode in ("fp32", "fp16", "int8"):
        qc = QC(1, 4, L, mode=mode)
        qc.add_at(sh, sl, rows)
        want2 = rows[0] + rows[2] + rows[3]
        got2 = qc.take_true(np.array([0]), np.array([2]))[0]
        if mode == "fp32":
            assert np.array_equal(got2, want2)
        else:
            tol = _grid_tol("int8" if mode == "int8" else "fp16",
                            want2[None])[0]
            assert np.abs(got2 - want2).max() <= tol + 1e-4
    qc = QC(1, 64, L, mode="int8", resid_cap=8)
    qc.set_at(np.zeros(32, np.int64), np.arange(32),
              rng.normal(size=(32, L)).astype(np.float32) * 3.14159)
    assert qc.resid_rows() <= 8 and qc.ef_evicted > 0
    assert qc.nbytes() >= qc.q.nbytes + qc.scale.nbytes
    return qc.q.copy(), qc.scale.copy()


def test_quantcold_same_bits_both_packages():
    a, b = (test_quantcold_mechanics(P) for P in PKGS)
    for x, y in zip(a, b):
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8))


@pytest.mark.parametrize("mode", ["fp16", "int8"])
@pytest.mark.parametrize("P", PKGS, ids=IDS)
def test_quant_storm_drift_bounded(P, mode):
    """test_quant.py's quantized storm: a tiered fp16/int8 server with
    compressed sync beside an untiered fp32 shadow, every read within
    two grid steps at every step and after quiesce."""
    rng = np.random.default_rng(0)
    srv = P.mk(True, hot_rows=16, tier_cold_dtype=mode, sync_compress=mode)
    ref = P.mk(False)
    w, wr = srv.make_worker(0), ref.make_worker(0)
    vals = rng.normal(size=(E, L)).astype(np.float32)
    for ww in (w, wr):
        ww.set(np.arange(E), vals)
    keys = np.arange(E)
    for step in range(40):
        op = rng.integers(0, 7)
        if op == 0:
            ks = rng.integers(0, E, 24)
            v = rng.normal(size=(24, L)).astype(np.float32)
            w.push(ks, v)
            wr.push(ks, v)
        elif op == 1:
            ks = rng.choice(E, 16, replace=False)
            v = rng.normal(size=(16, L)).astype(np.float32)
            w.set(ks, v)
            wr.set(ks, v)
        elif op == 2:
            ks = rng.choice(E, 12, replace=False)
            dest = int(rng.integers(0, srv.num_shards))
            srv._relocate_to(ks, dest)
            ref._relocate_to(ks, dest)
        elif op == 3:
            ks = rng.choice(keys[srv.ab.owner[keys] != w.shard], 16,
                            replace=False)
            end = int(w.current_clock + rng.integers(1, 4))
            w.intent(ks, w.current_clock, end)
            wr.intent(ks, wr.current_clock, end)
            srv.sync.run_round(force_intents=True, all_channels=True)
            ref.sync.run_round(force_intents=True, all_channels=True)
        elif op == 4:
            srv.sync.run_round(force_intents=True, all_channels=True)
            ref.sync.run_round(force_intents=True, all_channels=True)
        elif op == 5:
            srv.tier.promote_keys(rng.choice(E, 32, replace=False))
        else:
            srv.tier.demote_keys(rng.choice(E, 32, replace=False))
            srv.tier.maintain()
        if rng.integers(0, 3) == 0:
            w.advance_clock()
            wr.advance_clock()
        a = _read_all(srv).reshape(E, L)
        b = _read_all(ref).reshape(E, L)
        assert (np.abs(a - b).max(axis=1) <= _grid_tol(mode, b)).all(), \
            f"step {step} (op {op}): drift beyond the {mode} contract"
    srv.quiesce()
    ref.quiesce()
    a = _read_all(srv).reshape(E, L)
    b = _read_all(ref).reshape(E, L)
    assert (np.abs(a - b).max(axis=1) <= _grid_tol(mode, b)).all()
    assert sum(st.coldq.ef_evicted for st in srv.stores) == 0
    srv.shutdown()
    ref.shutdown()


@pytest.mark.parametrize("P", PKGS, ids=IDS)
def test_fp16_exact_values_survive_cycles_bitwise(P):
    rng = np.random.default_rng(0)
    srv = P.mk(True, hot_rows=16, tier_cold_dtype="fp16")
    ref = P.mk(False)
    w, wr = srv.make_worker(0), ref.make_worker(0)
    vals = rng.normal(size=(E, L)).astype(np.float16).astype(np.float32)
    for ww in (w, wr):
        ww.set(np.arange(E), vals)
    for step in range(12):
        srv.tier.promote_keys(rng.choice(E, 48, replace=False))
        srv.tier.demote_keys(rng.choice(E, 48, replace=False))
        srv.tier.maintain()
        ks = rng.choice(E, 12, replace=False)
        dest = int(rng.integers(0, srv.num_shards))
        srv._relocate_to(ks, dest)
        ref._relocate_to(ks, dest)
        assert np.array_equal(_read_all(srv), _read_all(ref)), step
        pk = rng.integers(0, E, 20)
        assert np.array_equal(np.asarray(w.pull_sync(pk)),
                              np.asarray(wr.pull_sync(pk)))
    assert sum(st.coldq.resid_rows() for st in srv.stores) == 0
    srv.shutdown()
    ref.shutdown()


def _replicate(srv, w, P, n=48):
    keys = np.arange(E)
    ks = keys[srv.ab.owner[keys] != w.shard][:n]
    w.intent(ks, 0, P.CLOCK_MAX)
    srv.sync.run_round(force_intents=True, all_channels=True)
    assert (srv.ab.cache_slot[w.shard, ks] >= 0).all()
    return ks


def sc_sync_compress(P, mode):
    rng = np.random.default_rng(0)
    opts = dict(sync_max_per_sec=0, prefetch=False,
                techniques=P.MgmtTechniques.REPLICATION_ONLY,
                cache_slots_per_shard=64)
    srv = P.setup(E, L, P.SystemOptions(sync_compress=mode, **opts))
    ref = P.setup(E, L, P.SystemOptions(**opts))
    w, wr = srv.make_worker(0), ref.make_worker(0)
    vals = rng.normal(size=(E, L)).astype(np.float32)
    w.set(np.arange(E), vals)
    wr.set(np.arange(E), vals)
    ks = _replicate(srv, w, P)
    assert np.array_equal(ks, _replicate(ref, wr, P))
    b0s = sum(st.sync_bytes_shipped for st in srv.stores)
    b0f = sum(st.sync_bytes_full for st in srv.stores)
    reads = []
    for _ in range(6):
        v = rng.normal(size=(len(ks), L)).astype(np.float32)
        w.push(ks, v)
        wr.push(ks, v)
        srv.sync.run_round(force_intents=True, all_channels=True)
        ref.sync.run_round(force_intents=True, all_channels=True)
        a = np.asarray(w.pull_sync(ks))
        b = np.asarray(wr.pull_sync(ks))
        tol = _grid_tol(mode, b.reshape(len(ks), L))
        assert (np.abs(a - b).reshape(len(ks), L).max(axis=1)
                <= tol).all()
        reads.append(a)
    shipped = sum(st.sync_bytes_shipped for st in srv.stores) - b0s
    full = sum(st.sync_bytes_full for st in srv.stores) - b0f
    assert full > 0
    want = P.quant.wire_bytes_per_row(mode, L) / (4 * L)
    assert abs(shipped / full - want) < 1e-6
    norm = max(st.ef_residual_norm() for st in srv.stores)
    assert norm > 0.0
    snap = srv.metrics_snapshot()["sync"]
    assert snap["bytes_per_round"] > 0 and snap["ef_residual_norm"] > 0.0
    srv.quiesce()
    ref.quiesce()
    a, b = _read_all(srv), _read_all(ref)
    assert np.allclose(a, b, rtol=1e-6, atol=1e-6)
    srv.shutdown()
    ref.shutdown()
    return reads + [a, np.float32(norm)]


@pytest.mark.parametrize("mode", ["fp16", "int8"])
def test_sync_compress_bytes_and_quiesce_exactness(mode):
    """test_quant.py's compressed-sync scenario on both packages: bytes
    a half / a quarter, replica reads within a grid step, the residual
    gauge, the exact flush at quiesce — and every read and the residual
    norm bitwise across the packages."""
    a, b = (sc_sync_compress(P, mode) for P in PKGS)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("P", PKGS, ids=IDS)
def test_sync_compress_off_and_drop_flush(P):
    """Compression off keeps full-width rows and no residual; a replica
    dropped after compressed rounds flushes its residual exactly."""
    rng = np.random.default_rng(0)
    srv = P.mk(False, techniques=P.MgmtTechniques.REPLICATION_ONLY,
               cache_slots_per_shard=64)
    w = srv.make_worker(0)
    w.set(np.arange(E), rng.normal(size=(E, L)).astype(np.float32))
    ks = _replicate(srv, w, P)
    w.push(ks, np.ones((len(ks), L), np.float32))
    srv.sync.run_round(force_intents=True, all_channels=True)
    st = srv.stores[0]
    assert st._ef_resid_dev is None and st.ef_residual_norm() == 0.0
    assert st.sync_bytes_shipped == st.sync_bytes_full > 0
    assert srv.metrics_snapshot()["sync"]["ef_residual_norm"] == 0.0
    srv.shutdown()
    srv = P.setup(E, L, P.SystemOptions(
        sync_max_per_sec=0, prefetch=False, sync_compress="int8",
        techniques=P.MgmtTechniques.REPLICATION_ONLY,
        cache_slots_per_shard=64))
    w = srv.make_worker(0)
    w.set(np.arange(E), np.zeros((E, L), np.float32))
    keys = np.arange(E)
    k = keys[srv.ab.owner[keys] != w.shard][:1]
    w.intent(k, 0, 3)
    srv.sync.run_round(force_intents=True, all_channels=True)
    v = np.full((1, L), 100.0, np.float32)
    v[0, 0] = 100.05
    w.push(k, v)
    srv.sync.run_round(force_intents=True, all_channels=True)
    for _ in range(8):
        w.advance_clock()
        srv.sync.run_round(force_intents=True, all_channels=True)
    assert srv.ab.cache_slot[w.shard, k[0]] < 0
    got = np.asarray(srv.read_main(k)).reshape(L)
    assert np.abs(got - v[0]).max() < 1e-4
    srv.shutdown()


@pytest.mark.parametrize("mode", ["fp32", "fp16"])
def test_read_owned_bulk_no_second_full_table_copy(mode):
    """The port's tiered bulk read fancy-indexes the requested rows out
    of the cold store: no second full f32 table on the host (the JAX
    test's budget), and the rows equal the JAX package's."""
    outs = []
    for P in PKGS:
        rng = np.random.default_rng(0)
        E_big, L_big = 6000, 64
        srv = P.setup(E_big, L_big, P.SystemOptions(
            sync_max_per_sec=0, prefetch=False, tier=True,
            tier_hot_rows=64, tier_cold_dtype=mode))
        # no background promotion: which rows are hot (exact) and which
        # read dequantized must not depend on the worker's timing
        srv.tier.engine.kick = lambda: None
        w = srv.make_worker(0)
        for lo in range(0, E_big, 2000):
            w.set(np.arange(lo, lo + 2000),
                  rng.normal(size=(2000, L_big)).astype(np.float32))
        srv.tier.promote_keys(np.arange(0, 256))
        srv.block()
        table_bytes = E_big * L_big * 4
        tracemalloc.start()
        out = srv._read_owned_bulk(np.arange(E_big))
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        budget = (2.75 if mode == "fp32" else 3.25) * table_bytes
        assert peak < budget, peak / table_bytes
        assert out.shape == (E_big * L_big,)
        outs.append(out)
        srv.shutdown()
    assert np.array_equal(outs[0], outs[1])
