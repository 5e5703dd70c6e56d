"""Whole-manager checkpoint/restore: the port of the JAX package's
`utils/checkpoint.py`, in its file format.

The whole manager state is a handful of arrays, so a checkpoint captures
it exactly: pools (main/cache/delta per length class), addressbook
tables, registered intent horizons, and worker clocks. Restore rebuilds
the free-list allocators and the sync manager's replica registry from
the tables, so an adapted placement survives a restart.

The file is the JAX package's format v3, array for array (the same
names, dtypes and geometry), so a `.npz` written by either package
restores bitwise into the other.

Multi-process: each rank writes `<path>.rank<r>.npz` with its local
pools, tables and cross-process metadata (owner hints, relocation
counters, interest bitmasks), bracketed by the quiesce protocol
(WaitSync -> Barrier -> WaitSync) so the shards are mutually
consistent; rank 0 also writes `<path>.manifest.npz` pinning the
topology. Restore asserts the process count and loads each rank's own
shard into a freshly launched job of the same shape — the adapted
placement (cross-process relocations and replicas included) survives.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

# v3: pool slot counts are 8-aligned (core/store.py _round8). The JAX
# package's version number: the two packages read each other's files.
FORMAT_VERSION = 3

def rank_path(path: str, rank: int) -> str:
    return f"{path}.rank{rank}.npz"


def manifest_path(path: str) -> str:
    return f"{path}.manifest.npz"


def _savez(path: str, **arrs) -> None:
    """`np.savez_compressed(path, **arrs)`'s archive (and its rule of
    appending `.npz`), each large member deflated in parallel chunks
    (fault/ckpt.py _npz_bytes), written atomically."""
    from ..fault.ckpt import _npz_bytes
    from . import write_atomic
    if not path.endswith(".npz"):
        path += ".npz"
    write_atomic(path, _npz_bytes(arrs))


def _host(t) -> np.ndarray:
    """An owned host copy of a pool tensor (on the CPU `.cpu()` would be
    the live pool, which a concurrent write could change under the
    serializer)."""
    return t.detach().to("cpu", copy=True).numpy()


def save_server(server, path: str) -> None:
    """Write the full manager state (one process: one `.npz` at `path`;
    multi-process: per-rank shards + manifest, globally quiesced)."""
    if server.fault is not None:
        # injection point (shared with the incremental chain): fires
        # before any I/O, so a failed save leaves the previous
        # checkpoint intact
        server.fault.fire("ckpt.save")
    if server.glob is not None:
        # quiesce so every delta is merged and every base is fresh
        server.wait_sync()
        server.barrier()
        server.wait_sync()
        server.barrier()
    server.block()
    with server._lock:
        arrs: Dict[str, np.ndarray] = {
            "format_version": np.int64(FORMAT_VERSION),
            "num_keys": np.int64(server.num_keys),
            "num_shards": np.int64(server.num_shards),
            "num_procs": np.int64(server.num_procs),
            "pid": np.int64(server.pid),
            "value_lengths": server.value_lengths,
            "owner": server.ab.owner,
            "slot": server.ab.slot,
            "cache_slot": server.ab.cache_slot,
            "relocation_counter": server.ab.relocation_counter,
            "intent_end": server.sync.intent_end,
            "clocks": server._clocks,
        }
        if server.glob is not None:
            arrs["owner_hint"] = server.glob.owner_hint
            arrs["reloc"] = server.glob.reloc
            arrs["interest"] = server.glob.interest
        for cid, st in enumerate(server.stores):
            # main_host() is the authoritative full-size main table
            # whether or not the store is tiered, so checkpoints restore
            # across tier configurations (residency is not saved)
            arrs[f"main_{cid}"] = st.main_host()
            arrs[f"cache_{cid}"] = _host(st.cache)
            arrs[f"delta_{cid}"] = _host(st.delta)
        # the tables are serialized after the lock releases: copies
        for k in ("value_lengths", "owner", "slot", "cache_slot",
                  "relocation_counter", "intent_end", "clocks",
                  "owner_hint", "reloc", "interest"):
            if k in arrs:
                arrs[k] = np.array(arrs[k])
    if server.glob is None:
        _savez(path, **arrs)
        return
    _savez(rank_path(path, server.pid), **arrs)
    if server.pid == 0:
        _savez(manifest_path(path),
                            format_version=np.int64(FORMAT_VERSION),
                            num_procs=np.int64(server.num_procs),
                            num_shards=np.int64(server.num_shards),
                            num_keys=np.int64(server.num_keys))
    server.barrier()  # checkpoint complete on every rank


def restore_server(server, path: str) -> None:
    """Restore state saved by save_server (by either package) into a
    compatibly-constructed Server (same num_keys, value_lengths, shard
    count, pool geometry; multi-process: the same process count — each
    rank reads its own shard)."""
    if server.fault is not None:
        # fires before any mutation: a failed restore leaves the live
        # server serving its current state
        server.fault.fire("ckpt.restore")
    if server.glob is not None:
        mf = np.load(manifest_path(path))
        assert int(mf["num_procs"]) == server.num_procs, \
            "process count mismatch (elastic restore is not supported)"
        ck = np.load(rank_path(path, server.pid))
        assert int(ck["pid"]) == server.pid
    else:
        ck = np.load(path if os.path.exists(path) else rank_path(path, 0))
        assert int(ck["num_procs"]) == 1, (
            "this is one rank shard of a multi-process checkpoint; "
            "restore it under a launcher with the same process count")
    got = int(ck["format_version"])
    if got != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format v{got} is incompatible with this build "
            f"(expects v{FORMAT_VERSION}; v2->v3 changed pool geometry to "
            f"8-aligned slot counts) — re-export from the writing version")
    assert int(ck["num_keys"]) == server.num_keys, "key count mismatch"
    assert int(ck["num_shards"]) == server.num_shards, "shard mismatch"
    assert (ck["value_lengths"] == server.value_lengths).all(), \
        "value-length layout mismatch"
    # geometry is checked for every pool before anything is written
    for cid, st in enumerate(server.stores):
        for name, want in (("main", st.main_shape_full),
                           ("cache", tuple(st.cache.shape)),
                           ("delta", tuple(st.delta.shape))):
            got_shape = ck[f"{name}_{cid}"].shape
            assert got_shape == tuple(want), (
                f"pool {name}_{cid} geometry mismatch: checkpoint "
                f"{got_shape} vs server {tuple(want)}")
    # the whole addressbook is rewritten below (direct table writes):
    # under the topology-mutation discipline, with a leading manual bump
    # so any concurrently-planned optimistic route fails revalidation
    # instead of dispatching pre-restore coordinates
    with server._lock, server._topology_mutation():
        server.topology_version += 1
        ab = server.ab
        ab.owner[:] = ck["owner"]
        ab.slot[:] = ck["slot"]
        ab.cache_slot[:] = ck["cache_slot"]
        ab.relocation_counter[:] = ck["relocation_counter"]
        ab.replica_count[:] = (ab.cache_slot >= 0).sum(axis=0)
        server.sync.intent_end[:] = ck["intent_end"]
        server._clocks[:] = ck["clocks"]
        # workers registered before the restore carry their own clock
        # and write it back on advance_clock: re-seed them
        for wid, w in server._workers.items():
            w._clock = int(server._clocks[wid])
        for cid, st in enumerate(server.stores):
            # untiered: the pool, in place; tiered: the cold store, with
            # residency reset (everything cold, promoted again lazily)
            st.install_main_full(ck[f"main_{cid}"])
            st.install_replica_pools(ck[f"cache_{cid}"],
                                     ck[f"delta_{cid}"])
        _rebuild_allocators_and_replicas(server)
        if server.glob is not None:
            server.glob.owner_hint[:] = ck["owner_hint"]
            server.glob.reloc[:] = ck["reloc"]
            server.glob.interest[:] = ck["interest"]
    if server.prefetch is not None:
        # staged pull buffers predate the restore
        server.prefetch.invalidate_all()
    server.block()
    if server.glob is not None:
        server.barrier()  # all ranks restored before traffic resumes


def _rebuild_allocators_and_replicas(server) -> None:
    """Free lists from table occupancy, the sync manager's replica
    registry from the cache map, and write tracking reset: the restored
    replica bases may predate their main rows, so everything starts
    dirty and the first sync round re-ships every live replica once.
    Caller holds the server lock inside a topology mutation."""
    ab = server.ab
    for cid in range(len(server.stores)):
        class_keys = np.nonzero(ab.key_class == cid)[0]
        _rebuild_alloc(ab.main_alloc[cid],
                       ab.owner[class_keys], ab.slot[class_keys])
        used_by_shard = [
            ab.cache_slot[s, class_keys] for s in range(server.num_shards)]
        _rebuild_cache_alloc(ab.cache_alloc[cid], used_by_shard)
    server.sync.replica_clear()
    shards, keys = np.nonzero(ab.cache_slot >= 0)
    server.sync.replica_add(keys.astype(np.int64),
                            shards.astype(np.int32))
    for st in server.stores:
        st.reset_write_tracking()


def _rebuild_alloc(alloc, owners: np.ndarray, slots: np.ndarray) -> None:
    for s in range(alloc.num_shards):
        alloc.set_used(s, slots[owners == s])


def _rebuild_cache_alloc(alloc, used_by_shard) -> None:
    for s in range(alloc.num_shards):
        row = np.asarray(used_by_shard[s])
        alloc.set_used(s, row[row >= 0])
