"""K14 `drop_set` and K15 `sync_round` on the CPU: their plain versions
(adapm_tpu_torch/ops/kernels.py), and the port's set, replica, install,
relocate, clear and sync programs that run on them
(adapm_tpu_torch/device/torchport.py), bitwise (`.view(np.uint32)`, so
-0.0 counts) the jitted XLA programs they replace
(adapm_tpu/device/jaxport.py `_set_rows`, `_replica_create`,
`_install_rows`, `_relocate`, `_clear_rows`,
`_install_cache_rows{,_resid}`, `_sync_replicas`,
`_sync_replicas_thresholded`) and the JAX package's NumpyRefPort.

Inputs come from a numpy seed: duplicate targets (the last in batch
order wins a set), OOB padding and shards past the pool (dropped),
-0.0 rows, owners repeated within a sync round at S=4 (their folds in
batch order: (main + d1) + d2), one owner row named by 1, 2, 33 and 100
replicas among singletons, and a threshold with rows on both sides of
it; K3's plain version at rows of 32,768 f32 against the XLA scatter. XLA wraps a negative index where the port drops it
(device/port.py), so the cases with negative coordinates are held to
NumpyRefPort alone. The card kernels are held to these plain versions
by tests/test_torch_gpu.py and chip_smoke.py phase 2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapm_tpu.device import jaxport as J
from adapm_tpu.device.refport import NumpyRefPort
from adapm_tpu_torch.device.torchport import TorchDevicePort
from adapm_tpu_torch.ops import kernels as K

OOB = int(J.OOB)
L = 8
SEEDS = [0, 1, 2]


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _same(got, want, what):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert np.array_equal(_bits(g), _bits(w)), f"{what}: output {i}"


def _pools(rng, S, R, C):
    out = [rng.normal(size=(S, k, L)).astype(np.float32) for k in (R, C, C)]
    for p in out:
        p[:, :2, ::3] = -0.0
    return out


def _coords(rng, n, S, slots, negative):
    """Duplicate-heavy coordinates with OOB padding and shards past the
    pool; with `negative`, negative slots and shards too."""
    sh = rng.integers(0, S, n).astype(np.int32)
    sl = rng.integers(0, min(slots, 6), n).astype(np.int32)
    u = rng.random(n)
    sl[u < 0.15] = OOB
    sh[(u >= 0.15) & (u < 0.2)] = S + 1
    if negative:
        sl[(u >= 0.2) & (u < 0.25)] = -2
        sh[(u >= 0.25) & (u < 0.3)] = -1
    return sh, sl


def _vals(rng, n):
    v = rng.normal(size=(n, L)).astype(np.float32)
    v[rng.random(n) < 0.2] = -0.0
    return v


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(np.array(a)) for a in arrays]


# -- K14's plain forms against the XLA set programs -------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("negative", [False, True])
def test_drop_set_forms_bitwise(seed, negative):
    """Each K14 form: the set, the install form from rows (with and
    without a residual, and read from another pool) and the zero form,
    against the XLA programs that compute each (without negative
    coordinates) and NumpyRefPort's programs."""
    rng = np.random.default_rng(seed)
    S, R, C = 4, 24, 12
    main, cache, delta = _pools(rng, S, R, C)
    n = 40
    o_sh, o_sl = _coords(rng, n, S, R, negative)
    c_sh, c_sl = _coords(rng, n, S, C, negative)
    v, resid = _vals(rng, n), _vals(rng, n)
    ref = NumpyRefPort()
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731

    # set_rows = the set form (main) + the install form from rows
    m, c, d = _t(main, cache, delta)
    K.drop_set(m, i32(o_sh), i32(o_sl), torch.from_numpy(v))
    K.drop_set_install(c, d, i32(c_sh), i32(c_sl), rows=torch.from_numpy(v))
    want = ref.set_rows(main.copy(), cache.copy(), delta.copy(), o_sh, o_sl,
                        v, c_sh, c_sl)
    _same((m, c, d), want, "set_rows (NumpyRefPort)")
    if not negative:
        _same((m, c, d), J._set_rows(*_j(main, cache, delta), o_sh, o_sl, v,
                                     c_sh, c_sl), "set_rows (XLA)")

    # replica_create = the install form read from the main pool
    m, c, d = _t(main, cache, delta)
    K.drop_set_install(c, d, i32(c_sh), i32(c_sl),
                       src=(m, i32(o_sh), i32(o_sl)))
    want = ref.replica_create(main.copy(), cache.copy(), delta.copy(), o_sh,
                              o_sl, c_sh, c_sl)
    _same((c, d), want, "replica_create (NumpyRefPort)")
    if not negative:
        _same((c, d), J._replica_create(*_j(main, cache, delta), o_sh, o_sl,
                                        c_sh, c_sl), "replica_create (XLA)")

    # install_cache_rows{,_resid} = the install form, zeros or a residual
    for r in (None, resid):
        c, d = _t(cache, delta)
        K.drop_set_install(c, d, i32(c_sh), i32(c_sl),
                           rows=torch.from_numpy(v),
                           resid=None if r is None else torch.from_numpy(r))
        want = ref.install_cache_rows(cache.copy(), delta.copy(), c_sh,
                                      c_sl, v, resid=r)
        _same((c, d), want, f"install_cache_rows resid={r is not None}")
        if not negative:
            jx = J._install_cache_rows(*_j(cache, delta), c_sh, c_sl, v) \
                if r is None else J._install_cache_rows_resid(
                    *_j(cache, delta), c_sh, c_sl, v, r)
            _same((c, d), jx, f"install_cache_rows (XLA) resid="
                  f"{r is not None}")

    # clear_rows = the zero form
    (m,) = _t(main)
    K.drop_set_zero(m, i32(o_sh), i32(o_sl))
    _same(m, ref.clear_rows(main.copy(), o_sh, o_sl), "clear_rows")
    if not negative:
        _same(m, J._clear_rows(*_j(main), o_sh, o_sl), "clear_rows (XLA)")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("negative", [False, True])
def test_port_set_programs_bitwise(seed, negative):
    """The port's programs that now run on K14 (set_rows,
    replica_create, install_rows, relocate, clear_rows,
    install_cache_rows with and without a residual) against
    NumpyRefPort and, without negative coordinates, the XLA programs."""
    rng = np.random.default_rng(100 + seed)
    S, R, C = 4, 24, 12
    main, cache, delta = _pools(rng, S, R, C)
    n = 32
    a_sh, a_sl = _coords(rng, n, S, R, negative)
    b_sh, b_sl = _coords(rng, n, S, C, negative)
    n_sh, n_sl = _coords(rng, n, S, R, negative)
    v, resid = _vals(rng, n), _vals(rng, n)
    tp, ref = TorchDevicePort(), NumpyRefPort()
    cases = {
        "set_rows": (lambda P, m, c, d: P.set_rows(
            m, c, d, a_sh, a_sl, v, b_sh, b_sl),
            lambda m, c, d: J._set_rows(m, c, d, a_sh, a_sl, v, b_sh, b_sl)),
        "replica_create": (lambda P, m, c, d: P.replica_create(
            m, c, d, a_sh, a_sl, b_sh, b_sl),
            lambda m, c, d: J._replica_create(m, c, d, a_sh, a_sl, b_sh,
                                              b_sl)),
        "install_rows": (lambda P, m, c, d: P.install_rows(
            c, d, b_sh, b_sl, v),
            lambda m, c, d: J._install_rows(c, d, b_sh, b_sl, v)),
        "relocate": (lambda P, m, c, d: P.relocate(
            m, d, a_sh, a_sl, n_sh, n_sl, b_sh, b_sl),
            lambda m, c, d: J._relocate(m, d, a_sh, a_sl, n_sh, n_sl, b_sh,
                                        b_sl)),
        "clear_rows": (lambda P, m, c, d: P.clear_rows(d, b_sh, b_sl),
                       lambda m, c, d: J._clear_rows(d, b_sh, b_sl)),
        "install_cache_rows": (lambda P, m, c, d: P.install_cache_rows(
            c, d, b_sh, b_sl, v),
            lambda m, c, d: J._install_cache_rows(c, d, b_sh, b_sl, v)),
        "install_cache_rows_resid": (lambda P, m, c, d: P.install_cache_rows(
            c, d, b_sh, b_sl, v, resid=resid),
            lambda m, c, d: J._install_cache_rows_resid(c, d, b_sh, b_sl, v,
                                                        resid)),
    }
    for name, (port_fn, jax_fn) in cases.items():
        got = port_fn(tp, *_t(main, cache, delta))
        want = port_fn(ref, main.copy(), cache.copy(), delta.copy())
        _same(got, want, f"{name} (NumpyRefPort)")
        if not negative:
            _same(got, jax_fn(*_j(main, cache, delta)), f"{name} (XLA)")


def test_drop_set_last_wins_and_keeps_negative_zero():
    """Five entries name one row: the fifth's bits land, -0.0 included;
    every dropped entry leaves its row as it was."""
    pool = np.ones((2, 8, L), np.float32)
    sh = np.array([1, 1, 0, 1, 1, 1, 2, 0], np.int32)
    sl = np.array([3, 3, OOB, 3, 3, 3, 1, -1], np.int32)
    v = np.arange(8 * L, dtype=np.float32).reshape(8, L)
    v[5] = -0.0
    (t,) = _t(pool)
    K.drop_set(t, *map(torch.from_numpy, (sh, sl, v)))
    want = pool.copy()
    want[1, 3] = -0.0
    _same(t, want, "five entries, the last -0.0")


# -- K15's plain version against the XLA sync programs ----------------------


def _round(rng, S, R, C, n, repeat_owners, negative):
    """A sync round's coordinates: replicas (duplicates among them) of
    owners that repeat within the round when `repeat_owners` (a key
    replicated on several shards folds each delta into one owner row),
    with OOB and out-of-range entries."""
    r_sh, r_cs = _coords(rng, n, S, C, negative)
    if repeat_owners:
        owners = rng.integers(0, R, max(2, n // 4))
        o_sl = owners[rng.integers(0, len(owners), n)].astype(np.int32)
        o_sh = (o_sl % S).astype(np.int32)
    else:
        o_sh, o_sl = _coords(rng, n, S, R, negative)
    o_sl[rng.random(n) < 0.1] = OOB
    return r_sh, r_cs, o_sh, o_sl


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("threshold", [0.0, 0.6])
def test_sync_round_bitwise_xla_and_refport(seed, S, threshold):
    """K15's plain version and the port's sync_replicas (which runs on
    it) against _sync_replicas / _sync_replicas_thresholded and
    NumpyRefPort: at S=4 owners repeat within the round, so the fold's
    batch order shows; half the deltas sit below the threshold."""
    rng = np.random.default_rng(1000 * S + seed)
    R, C, n = 24, 16, 48
    main, cache, delta = _pools(rng, S, R, C)
    delta[:, ::2] *= 0.1                # rows on both sides of 0.6
    r_sh, r_cs, o_sh, o_sl = _round(rng, S, R, C, n, S == 4, False)
    want = NumpyRefPort().sync_replicas(main.copy(), cache.copy(),
                                        delta.copy(), r_sh, r_cs, o_sh, o_sl,
                                        threshold=threshold)
    jx = J._sync_replicas(*_j(main, cache, delta), r_sh, r_cs, o_sh, o_sl) \
        if threshold == 0.0 else J._sync_replicas_thresholded(
            *_j(main, cache, delta), r_sh, r_cs, o_sh, o_sl,
            np.float32(threshold))
    _same(jx, want, "XLA against NumpyRefPort")
    m, c, d = _t(main, cache, delta)
    K.sync_round(m, c, d, *_t(r_sh, r_cs, o_sh, o_sl), threshold=threshold)
    _same((m, c, d), want, "sync_round (plain)")
    got = TorchDevicePort().sync_replicas(*_t(main, cache, delta), r_sh,
                                          r_cs, o_sh, o_sl,
                                          threshold=threshold)
    _same(got, want, "TorchDevicePort.sync_replicas")
    if threshold > 0.0:
        shipped = np.abs(delta[np.clip(r_sh, 0, S - 1),
                               np.clip(r_cs, 0, C - 1)]).max(axis=1)
        assert (shipped >= threshold).any() and (shipped < threshold).any()


@pytest.mark.parametrize("threshold", [0.0, 0.6])
def test_sync_round_negative_coordinates_as_refport(threshold):
    rng = np.random.default_rng(77)
    S, R, C, n = 4, 24, 16, 48
    main, cache, delta = _pools(rng, S, R, C)
    delta[:, ::2] *= 0.1
    co = _round(rng, S, R, C, n, True, True)
    want = NumpyRefPort().sync_replicas(main.copy(), cache.copy(),
                                        delta.copy(), *co,
                                        threshold=threshold)
    m, c, d = _t(main, cache, delta)
    K.sync_round(m, c, d, *_t(*co), threshold=threshold)
    _same((m, c, d), want, "sync_round with negative coordinates")


def test_sync_round_folds_in_batch_order():
    """Two replicas of one owner in a round: the owner becomes
    (main + d1) + d2 — the values are chosen so that main + (d1 + d2)
    rounds differently — and both replicas' bases are the fresh row."""
    main = np.zeros((2, 4, L), np.float32)
    cache = np.zeros((2, 4, L), np.float32)
    delta = np.zeros((2, 4, L), np.float32)
    main[0, 1] = 1.0
    delta[1, 0] = 2.0 ** -24
    delta[1, 2] = 2.0 ** -24
    co = [np.array(a, np.int32) for a in ([1, 1], [0, 2], [0, 0], [1, 1])]
    m, c, d = _t(main, cache, delta)
    K.sync_round(m, c, d, *_t(*co))
    seq = (np.float32(1.0) + np.float32(2.0 ** -24)) + np.float32(2.0 ** -24)
    assert seq != np.float32(1.0) + np.float32(2.0 ** -23)
    assert np.all(m.numpy()[0, 1] == seq)
    assert np.all(c.numpy()[1, [0, 2]] == seq)
    assert not d.numpy().any()
    _same((m, c, d), J._sync_replicas(*_j(main, cache, delta), *co),
          "the fold's order (XLA)")


def _heavy_round(rng, S, R, C, n, k, negative):
    """n entries with distinct owner and replica rows (OOB, shards past
    the pool and, with `negative`, negative coordinates among them) and
    k more naming owner row (0, 1), a -0.0 row, from replica rows drawn
    with repeats, in a shuffled batch order."""
    o = rng.permutation(S * R)[:n]
    r = rng.permutation(S * C)[:n]
    o_sh, o_sl, r_sh, r_cs = o // R, o % R, r // C, r % C
    u = rng.random(n)
    o_sl[u < 0.1] = OOB
    r_cs[(u >= 0.1) & (u < 0.2)] = OOB
    o_sh[(u >= 0.2) & (u < 0.25)] = -1 if negative else S + 1
    r_cs[(u >= 0.25) & (u < 0.3)] = -2 if negative else C
    hot = rng.integers(0, S * C, k)
    order = rng.permutation(n + k)
    return [np.concatenate([a, b])[order].astype(np.int32) for a, b in
            ((r_sh, hot // C), (r_cs, hot % C), (o_sh, np.zeros(k)),
             (o_sl, np.ones(k)))]


@pytest.mark.parametrize("k", [1, 2, 33, 100])
@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("threshold", [0.0, 0.6])
def test_sync_round_one_owner_named_many_times(k, negative, threshold):
    """K15's plain version where one owner row is named by k replicas
    (the fold's cases on the card: one entry, a list sorted in the warp,
    lists past 32) among singletons, held rows, OOB and out-of-range
    coordinates and -0.0, against NumpyRefPort and, without negative
    coordinates, _sync_replicas / _sync_replicas_thresholded."""
    rng = np.random.default_rng(500 + 10 * k + negative)
    S, R, C, n = 4, 24, 64, 40
    main, cache, delta = _pools(rng, S, R, C)
    delta[:, ::2] *= 0.1                # rows on both sides of 0.6
    co = _heavy_round(rng, S, R, C, n, k, negative)
    want = NumpyRefPort().sync_replicas(main.copy(), cache.copy(),
                                        delta.copy(), *co,
                                        threshold=threshold)
    m, c, d = _t(main, cache, delta)
    K.sync_round(m, c, d, *_t(*co), threshold=threshold)
    _same((m, c, d), want, f"sync_round, owner named {k} times")
    if not negative:
        jx = J._sync_replicas(*_j(main, cache, delta), *co) \
            if threshold == 0.0 else J._sync_replicas_thresholded(
                *_j(main, cache, delta), *co, np.float32(threshold))
        _same((m, c, d), jx, f"sync_round (XLA), owner named {k} times")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordered_scatter_plain_wide_rows_bitwise_xla(seed):
    """K3's plain version at RESCAL's relation rows (32,768 f32): a few
    dozen entries in runs of 1-8 on distinct rows, shuffled, some OOB,
    values over seven decades with -0.0 rows, against the XLA scatter
    (_scatter_add, its delta half all dropped)."""
    rng = np.random.default_rng(seed)
    S, R, W = 2, 12, 32_768
    main = rng.normal(size=(S, R, W)).astype(np.float32)
    main[0, :2, ::3] = -0.0
    flat = np.repeat(rng.permutation(S * R)[:8], rng.integers(1, 9, 8))
    flat = flat[rng.permutation(len(flat))]
    n = len(flat)
    sh, sl = (flat // R).astype(np.int32), (flat % R).astype(np.int32)
    sl[rng.random(n) < 0.1] = OOB
    vals = (rng.normal(size=(n, W)) * 10.0 ** rng.integers(
        -3, 4, (n, 1))).astype(np.float32)
    vals[::5] = -0.0
    (m,) = _t(main)
    K.ordered_scatter_add(m, *_t(sh, sl, vals))
    delta = np.zeros((S, 1, W), np.float32)
    oob = np.full(n, OOB, np.int32)
    want, _ = J._scatter_add(*_j(main, delta), sh, sl, sh, oob, vals)
    _same(m, want, "ordered_scatter_add at rows of 32,768 f32 (XLA)")


def test_sync_round_scratch_grows_only_outside_a_capture(monkeypatch):
    """K15's per-call scratch (kernels._entry_scratch): reused while it is
    large enough, grown (the outgrown one kept referenced, as a captured
    graph may hold its address) outside a capture, refused inside one;
    its claim scratch is made all -1 and refused inside a capture too."""
    class Stream:
        cuda_stream = 12345

    pool = torch.zeros(2, 3, 4)
    kept = len(K._entries_outgrown)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    try:
        a = K._entry_scratch("test_k15", pool, Stream(), 10)
        assert K._entry_scratch("test_k15", pool, Stream(), 7) is a
        b = K._entry_scratch("test_k15", pool, Stream(), 11)
        assert b.numel() == 20 and K._entries_outgrown[-1] is a
        claims = K._claim_scratch("test_k15", pool, Stream(), 9)
        assert claims.numel() == 9 and bool((claims == -1).all())
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        assert K._entry_scratch("test_k15", pool, Stream(), 20) is b
        with pytest.raises(ValueError, match="before a CUDA graph capture"):
            K._entry_scratch("test_k15", pool, Stream(), 21)
        with pytest.raises(ValueError, match="before a CUDA graph capture"):
            K._claim_scratch("test_k15", pool, Stream(), 10)
    finally:
        K._entries.pop(("test_k15", pool.device, Stream.cuda_stream), None)
        K._claims.pop(K._claim_key("test_k15", pool, Stream(), 9), None)
        del K._entries_outgrown[kept:]
