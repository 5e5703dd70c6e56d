"""Checkpoints of the port (adapm_tpu_torch/utils/checkpoint.py and
fault/ckpt.py) against the JAX package's, scenario by scenario.

The seven scenarios of tests/test_checkpoint.py run on both packages
(8 shards: `adapm_tpu.setup` on the 8-device CPU mesh beside
`adapm_tpu_torch.setup(..., num_shards=8, device="cpu")`) with the same
data; each keeps the JAX test's own checks on each package and returns
what it read, and the reads are compared bitwise across packages. The
formats are the carry function: a `save_server` `.npz` and an
incremental chain written by either package restore into the other with
every pool, table, clock and allocator bitwise, and a corrupted,
truncated, missing or spliced link fails with the same error class on
both. The JAX side runs exactly as tests/test_checkpoint.py runs it.
"""
import json
import os

import numpy as np
import pytest

import adapm_tpu
import adapm_tpu_torch

E = 32
L = 4


class Pkg:
    def __init__(self, mod):
        self.mod = mod
        self.is_jax = mod is adapm_tpu
        self.SystemOptions = mod.SystemOptions
        self.CLOCK_MAX = __import__(f"{mod.__name__}.base",
                                    fromlist=["x"]).CLOCK_MAX
        ck = __import__(f"{mod.__name__}.utils.checkpoint",
                        fromlist=["x"])
        self.save_server = ck.save_server
        self.restore_server = ck.restore_server
        self.fault = __import__(f"{mod.__name__}.fault", fromlist=["x"])

    def setup(self, num_keys, vlen, opts):
        if self.is_jax:
            return adapm_tpu.setup(num_keys, vlen, opts=opts)
        return adapm_tpu_torch.setup(num_keys, vlen, opts=opts,
                                     num_shards=8, device="cpu")

    def mk(self, num_keys=E):
        return self.setup(num_keys, L, self.SystemOptions(
            sync_max_per_sec=0, cache_slots_per_shard=16))


JAX, PORT = Pkg(adapm_tpu), Pkg(adapm_tpu_torch)


def _read(srv, n=E):
    return np.asarray(srv.read_main(np.arange(n)))


def _adapted_server(P):
    """test_checkpoint.py's adapted placement: replicas from competing
    intents, a relocation from an exclusive one, pending replica
    deltas."""
    srv = P.mk()
    w0, w1 = srv.make_worker(0), srv.make_worker(1)
    rng = np.random.default_rng(0)
    w0.set(np.arange(E), rng.normal(size=(E, L)).astype(np.float32))
    shared = np.array([5, 9, 13])
    w0.intent(shared, 0, P.CLOCK_MAX)
    w1.intent(shared, 0, P.CLOCK_MAX)
    own = np.array([k for k in range(E)
                    if srv.ab.owner[k] not in (0,)][:2])
    w0.intent(own, 0, P.CLOCK_MAX)
    srv.wait_sync()
    w0.push(shared, np.ones((3, L), np.float32))
    srv.block()
    return srv, (w0, w1)


def _state(srv):
    """Every table, clock, allocator and pool of a server, on the host
    (the bitwise carry check)."""
    ab = srv.ab
    out = {"owner": ab.owner, "slot": ab.slot,
           "cache_slot": ab.cache_slot,
           "relocation_counter": ab.relocation_counter,
           "replica_count": ab.replica_count,
           "intent_end": srv.sync.intent_end, "clocks": srv._clocks}
    for cid, st in enumerate(srv.stores):
        out[f"main_{cid}"] = st.main_host()
        for name in ("cache", "delta"):
            pool = getattr(st, name)
            out[f"{name}_{cid}"] = pool.cpu().numpy() \
                if hasattr(pool, "cpu") else np.asarray(pool)
        for kind, allocs in (("main", ab.main_alloc),
                             ("cache", ab.cache_alloc)):
            out[f"free_{kind}_{cid}"] = np.array(
                [allocs[cid].num_free(s) for s in range(srv.num_shards)])
    return {k: np.array(v) for k, v in out.items()}


def _same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        # bitwise: -0.0 and NaN payloads included
        assert a[k].tobytes() == b[k].astype(a[k].dtype).tobytes(), k


def _same_reads(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(np.asarray(x), np.asarray(y)), \
            f"read {i} differs across packages"


# -- test_checkpoint.py's scenarios -------------------------------------------


def sc_roundtrip_exact(P, tmp):
    srv, _ = _adapted_server(P)
    path = str(tmp / "ck.npz")
    P.save_server(srv, path)
    before_main = _read(srv)
    before_owner = srv.ab.owner.copy()
    before_cache = srv.ab.cache_slot.copy()
    srv.shutdown()
    srv2 = P.mk()
    w0b, w1b = srv2.make_worker(0), srv2.make_worker(1)
    P.restore_server(srv2, path)
    assert (srv2.ab.owner == before_owner).all()
    assert (srv2.ab.cache_slot == before_cache).all()
    got_main = _read(srv2)
    assert np.allclose(got_main, before_main)
    got = np.asarray(w0b.pull_sync(np.array([5])))
    assert np.isfinite(got).all()
    srv2.quiesce()
    after = np.asarray(srv2.read_main(np.array([5, 9, 13])))
    assert np.isfinite(after).all()
    free_keys = np.array([k for k in range(E)
                          if srv2.ab.owner[k] != 0][:2])
    w0b.intent(free_keys, w0b.current_clock, P.CLOCK_MAX)
    w1b.intent(free_keys, w1b.current_clock, P.CLOCK_MAX)
    srv2.wait_sync()
    out = [before_main, got_main, got, after, _read(srv2),
           srv2.ab.owner.copy(), srv2.ab.cache_slot.copy()]
    srv2.shutdown()
    return out


def sc_restore_rejects_mismatch(P, tmp):
    srv, _ = _adapted_server(P)
    path = str(tmp / "ck.npz")
    P.save_server(srv, path)
    srv.shutdown()
    other = P.setup(16, L, P.SystemOptions(sync_max_per_sec=0))
    with pytest.raises(AssertionError, match="mismatch"):
        P.restore_server(other, path)
    other.shutdown()
    return []


def sc_restore_reseeds_worker_clocks(P, tmp):
    srv, (w0, w1) = _adapted_server(P)
    for _ in range(7):
        w0.advance_clock()
    for _ in range(3):
        w1.advance_clock()
    path = str(tmp / "ck.npz")
    P.save_server(srv, path)
    srv.shutdown()
    srv2 = P.mk()
    w0b, w1b = srv2.make_worker(0), srv2.make_worker(1)
    P.restore_server(srv2, path)
    assert w0b.current_clock == 7 and w1b.current_clock == 3
    assert w0b.advance_clock() == 8
    assert (srv2._clocks[:2] == [8, 3]).all()
    clocks = srv2._clocks.copy()
    srv2.shutdown()
    srv3 = P.mk()
    P.restore_server(srv3, path)
    w0c = srv3.make_worker(0)
    assert w0c.current_clock == 7
    assert w0c.advance_clock() == 8
    srv3.shutdown()
    return [clocks]


def _chain_with_live_server(P, tmp):
    srv, (w0, _) = _adapted_server(P)
    path = str(tmp / "chain")
    ck = P.fault.IncrementalCheckpointer(srv, path)
    ck.save()
    w0.push(np.arange(4), np.ones((4, L), np.float32))
    ck.save()
    w0.push(np.arange(8, 12), np.ones((4, L), np.float32))
    ck.save()
    return srv, path


def _assert_untouched_and_live(srv, before):
    assert np.array_equal(_read(srv), before)
    assert not srv.degraded
    srv.quiesce()
    assert np.isfinite(_read(srv)).all()


def _break_truncate(path):
    f = os.path.join(path, "delta-000001.npz")
    data = open(f, "rb").read()
    with open(f, "wb") as fh:
        fh.write(data[: len(data) // 2])
    return "CheckpointCorruptError", "delta-000001"


def _break_flip(path):
    f = os.path.join(path, "base-000000.npz")
    data = bytearray(open(f, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with open(f, "wb") as fh:
        fh.write(bytes(data))
    return "CheckpointCorruptError", "checksum"


def _break_missing(path):
    os.remove(os.path.join(path, "delta-000001.npz"))
    return "CheckpointChainError", "missing chain link delta-000001"


def _break_splice(path):
    mp = os.path.join(path, "chain.json")
    m = json.load(open(mp))
    del m["entries"][1]
    with open(mp, "w") as fh:
        json.dump(m, fh)
    return "CheckpointChainError", None


def _broken_chain(P, tmp, breaker):
    srv, path = _chain_with_live_server(P, tmp)
    try:
        before = _read(srv)
        cls_name, match = breaker(path)
        with pytest.raises(getattr(P.fault, cls_name), match=match):
            P.fault.restore_chain(srv, path)
        _assert_untouched_and_live(srv, before)
        return [before, _read(srv)]
    finally:
        srv.shutdown()


def sc_chain_truncated(P, tmp):
    return _broken_chain(P, tmp, _break_truncate)


def sc_chain_flipped(P, tmp):
    return _broken_chain(P, tmp, _break_flip)


def sc_chain_missing(P, tmp):
    return _broken_chain(P, tmp, _break_missing)


def sc_chain_spliced(P, tmp):
    return _broken_chain(P, tmp, _break_splice)


@pytest.mark.parametrize("scenario", [
    sc_roundtrip_exact, sc_restore_rejects_mismatch,
    sc_restore_reseeds_worker_clocks, sc_chain_truncated,
    sc_chain_flipped, sc_chain_missing, sc_chain_spliced],
    ids=lambda f: f.__name__[3:])
def test_checkpoint_scenario_both_packages(scenario, tmp_path):
    out = []
    for P in (JAX, PORT):
        d = tmp_path / ("jax" if P.is_jax else "port")
        d.mkdir()
        out.append(scenario(P, d))
    _same_reads(*out)


# -- the formats carry state across packages ----------------------------------


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_save_server_file_restores_across_packages(writer, reader,
                                                   tmp_path):
    """A `save_server` .npz of either package restores into the other
    with every pool, table, clock and allocator bitwise; both restored
    servers then keep working identically."""
    srv, _ = _adapted_server(writer)
    path = str(tmp_path / "ck.npz")
    writer.save_server(srv, path)
    want = _state(srv)
    srv.shutdown()
    outs = []
    for P in (writer, reader):
        dst = P.mk()
        w = dst.make_worker(0)
        P.restore_server(dst, path)
        _same_state(_state(dst), want)
        pulled = np.asarray(w.pull_sync(np.arange(E)))
        dst.quiesce()
        outs.append([pulled, _read(dst)])
        dst.shutdown()
    _same_reads(outs[0], outs[1])


def _chain_state(P, tmp):
    """A three-link chain with a trickle, replica churn and a dirty
    (unshipped) replica delta (test_fault.py's _chained_state)."""
    srv = P.mk()
    w0, w1 = srv.make_worker(0), srv.make_worker(1)
    w0.set(np.arange(E), np.random.default_rng(1).normal(
        size=(E, L)).astype(np.float32))
    path = str(tmp / "chain")
    ck = P.fault.IncrementalCheckpointer(srv, path)
    ck.save()
    w0.push(np.arange(7), np.ones((7, L), np.float32))
    ck.save()
    shared = np.array([5, 9, 13])
    w0.intent(shared, 0, P.CLOCK_MAX)
    w1.intent(shared, 0, P.CLOCK_MAX)
    srv.wait_sync()
    w0.push(shared, np.full((3, L), 0.25, np.float32))
    srv.block()
    ck.save()
    return srv, path


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_chain_restores_across_packages(writer, reader, tmp_path):
    """An incremental chain of either package restores into the other:
    the restored state is bitwise the restored state of the writing
    package (and both are the writer's read_main and pulls at the last
    save); the links carry dirty replica rows."""
    srv, path = _chain_state(writer, tmp_path)
    want_main = _read(srv)
    want_pull = np.asarray(srv._workers[0].pull_sync(np.arange(E)))
    srv.shutdown()
    last = json.load(open(os.path.join(path, "chain.json")))["entries"]
    assert [e["kind"] for e in last] == ["base", "delta", "delta"]
    with np.load(os.path.join(path, last[-1]["file"])) as z:
        assert len(z["rsh_0"]) > 0, "no dirty replica rows in the link"
    states = []
    for P in (writer, reader):
        dst = P.mk()
        w = dst.make_worker(0)
        rec = P.fault.restore_chain(dst, path)
        assert rec > 0 and not dst.degraded
        assert np.array_equal(_read(dst), want_main)
        assert np.array_equal(np.asarray(w.pull_sync(np.arange(E))),
                              want_pull)
        states.append(_state(dst))
        dst.shutdown()
    _same_state(states[0], states[1])


@pytest.mark.parametrize("breaker", [_break_truncate, _break_flip,
                                     _break_missing, _break_splice],
                         ids=["truncated", "flipped", "missing",
                              "spliced"])
def test_damaged_chain_same_error_class_on_both(breaker, tmp_path):
    """A chain written by one package and damaged fails with the same
    error class (and message) when either package restores it, before
    the live server changes."""
    srv, path = _chain_with_live_server(PORT, tmp_path)
    srv.shutdown()
    cls_name, match = breaker(path)
    for P in (JAX, PORT):
        live = P.mk()
        before = _read(live)
        with pytest.raises(getattr(P.fault, cls_name), match=match) as ei:
            P.fault.restore_chain(live, path)
        assert type(ei.value).__name__ == cls_name
        _assert_untouched_and_live(live, before)
        live.shutdown()


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_chain_carries_stream_cursor(writer, reader, tmp_path):
    """A chain whose server had a streaming plane carries its acked-event
    cursor (`aux_stream_cursor`); a restore keeps it on the server as
    `_restored_stream_cursor` in either package."""
    from types import SimpleNamespace
    srv, _ = _adapted_server(writer)
    srv.stream = SimpleNamespace(cursor=np.array([41], dtype=np.int64))
    ck = writer.fault.IncrementalCheckpointer(srv, str(tmp_path / "c"))
    ck.save()
    srv.stream.cursor[0] = 57
    ck.save()
    srv.stream = None
    srv.shutdown()
    for P in (writer, reader):
        dst = P.mk()
        P.fault.restore_chain(dst, str(tmp_path / "c"))
        assert dst._restored_stream_cursor == 57
        dst.shutdown()
