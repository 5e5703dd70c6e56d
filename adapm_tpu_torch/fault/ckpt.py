"""Incremental dirty-slot checkpoint chains: the port of the JAX
package's `fault/ckpt.py`, in its on-disk format.

`utils/checkpoint.py` snapshots the WHOLE manager every time; the stores'
write-epoch tracking already knows which slots changed, so a chain ships
only those:

  - a **chain** lives in one directory: `base-000000.npz` (the full
    authoritative main tables + placement tables) followed by
    `delta-NNNNNN.npz` files, each holding only the main-row slots whose
    write epoch advanced since the previous link plus the
    currently-dirty replicas' (cache, delta) rows, plus any placement
    table that changed (skipped when byte-identical);
  - every link is written **atomically** (tmp + fsync + rename) and
    carries a sha256 over its bytes; `chain.json` (also atomic) lists
    the links with their checksums AND each link's predecessor digest,
    so a truncated, bit-flipped, missing or spliced link fails
    verification by name (`CheckpointCorruptError` /
    `CheckpointChainError`) — never a half-restore;
  - **restore** verifies and loads the ENTIRE chain into host memory
    first (the live server is untouched by any failure up to that
    point), then replays base + deltas under one topology-mutation
    critical section, rebuilds allocators and the replica registry like
    `utils.checkpoint.restore_server`, and resets write tracking. While
    the apply runs the server is DEGRADED (`Server.begin_degraded`): the
    serve plane sheds with `ServeDegradedError` instead of risking a
    read that mixes pre- and post-restore bits.

The links, the manifest and the digests are the JAX package's, byte
format for byte format (the same array names, `kind` as uint8 bytes,
`FORMAT_VERSION`, `MANIFEST_FORMAT`, `_AUX_KEYS`), so a chain written by
either package restores bitwise into the other.

Exactness: every path that can change a main row's VALUE bumps its
`main_epoch` cell under the server lock before the device work is
enqueued (core/store.py), and the capture runs under that same lock with
a device readback (K1 through `ShardedStore.read_rows`; the base link's
whole-pool copy) that synchronizes with everything enqueued — so each
link captures exactly the cells changed since the previous link, with
their save-time bits. A CLEAN replica (per `Server._dirty_replica_mask`)
is bitwise `cache == main row, delta == 0`, so restore rebuilds clean
replicas from the replayed mains and overlays only the last link's
captured dirty (cache, delta) rows.

Periodic operation: `--sys.checkpoint.every S --sys.checkpoint.path D`
runs `save()` as a self-rescheduling program on the executor's `ckpt`
stream. `Server.shutdown()` closes the checkpointer BEFORE pool teardown
and drains the `ckpt` stream. The chain is single-process; the port's
multi-process layer is ROADMAP queue A, item 11.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import threading
import time
from typing import Dict, List, Tuple

import numpy as np

from ..utils import write_atomic as _write_atomic

MANIFEST_FORMAT = 1
FORMAT_VERSION = 1
MANIFEST_NAME = "chain.json"

# placement/meta tables captured per link iff changed since the previous
# link (byte-identical tables are skipped)
_AUX_KEYS = ("owner", "slot", "cache_slot", "relocation_counter",
             "intent_end", "clocks")

_MULTI_PROCESS = ("incremental checkpoint chains are single-process; the "
                  "multi-process layer is not ported yet (ROADMAP queue "
                  "A, item 11)")


class CheckpointCorruptError(RuntimeError):
    """A chain link's bytes do not match its recorded sha256 (truncated
    write, bit flip, unreadable archive). Raised during verification,
    BEFORE any server mutation."""


class CheckpointChainError(RuntimeError):
    """The chain itself is broken: missing manifest, missing/spliced
    link, non-contiguous sequence, predecessor-digest mismatch, or a
    geometry/format incompatibility with the restoring server. Raised
    during verification, BEFORE any server mutation."""


# deflate chunk of a link member: members above it deflate in parallel
# chunks (a save of a full-width table is host zlib work)
_DEFLATE_CHUNK = 8 << 20


def _deflate(raw: memoryview) -> bytes:
    """One raw deflate stream of `raw`, compressed in independent
    chunks on a thread pool (zlib releases the interpreter lock): each
    chunk ends byte-aligned (a sync flush), the last one finishes the
    stream — pigz's scheme, without dictionary priming."""
    import zlib
    n = max(1, -(-len(raw) // _DEFLATE_CHUNK))

    def one(i):
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        out = c.compress(raw[i * _DEFLATE_CHUNK:(i + 1) * _DEFLATE_CHUNK])
        return out + c.flush(zlib.Z_FINISH if i == n - 1
                             else zlib.Z_SYNC_FLUSH)

    if n == 1:
        return one(0)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(min(n, os.cpu_count() or 1)) as ex:
        return b"".join(ex.map(one, range(n)))


def _npz_bytes(arrs: Dict[str, np.ndarray]) -> bytes:
    """The archive `np.savez_compressed` writes (one deflated `.npy`
    member per array, zip64 records), with each large member deflated
    in parallel chunks. Any zip reader (`np.load`, in either package)
    reads it."""
    import struct
    import zlib
    buf = io.BytesIO()
    central = []
    for key, arr in arrs.items():
        npy = io.BytesIO()
        np.lib.format.write_array(npy, np.asanyarray(arr),
                                  allow_pickle=False)
        raw = npy.getbuffer()
        crc = zlib.crc32(raw)
        comp = _deflate(raw)
        name = f"{key}.npy".encode()
        off = buf.tell()
        # local header: version 4.5, deflate, 1980-01-01, sizes in the
        # zip64 extra field
        buf.write(struct.pack("<IHHHHHIIIHH", 0x04034B50, 45, 0, 8, 0,
                              33, crc, 0xFFFFFFFF, 0xFFFFFFFF, len(name),
                              20))
        buf.write(name)
        buf.write(struct.pack("<HHQQ", 1, 16, len(raw), len(comp)))
        buf.write(comp)
        central.append(struct.pack(
            "<IHHHHHHIIIHHHHHII", 0x02014B50, 45, 45, 0, 8, 0, 33, crc,
            0xFFFFFFFF, 0xFFFFFFFF, len(name), 28, 0, 0, 0, 0o600 << 16,
            0xFFFFFFFF) + name + struct.pack("<HHQQQ", 1, 24, len(raw),
                                              len(comp), off))
    cd_off = buf.tell()
    for c in central:
        buf.write(c)
    cd_size = buf.tell() - cd_off
    z64 = buf.tell()
    n = len(central)
    buf.write(struct.pack("<IQHHIIQQQQ", 0x06064B50, 44, 45, 45, 0, 0, n,
                          n, cd_size, cd_off))
    buf.write(struct.pack("<IIQI", 0x07064B50, 0, z64, 1))
    buf.write(struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, min(n, 0xFFFF),
                          min(n, 0xFFFF), min(cd_size, 0xFFFFFFFF),
                          min(cd_off, 0xFFFFFFFF), 0))
    return buf.getvalue()


class IncrementalCheckpointer:
    """Owns one checkpoint chain for one Server. The first `save()`
    writes the base; every later one a delta. Constructing a
    checkpointer on a directory STARTS A NEW CHAIN (existing links are
    superseded by the fresh manifest) — the resume workflow is
    restore_chain() first, then a new checkpointer."""

    def __init__(self, server, path: str):
        if server.glob is not None:
            raise NotImplementedError(_MULTI_PROCESS)
        if not path:
            raise ValueError("--sys.checkpoint.path is required for "
                             "incremental checkpoints")
        self.server = server
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.chain_id = os.urandom(8).hex()
        self._entries: List[Dict] = []
        self._marks: List[int] = [0] * len(server.stores)
        self._aux_last: Dict[str, np.ndarray] = {}
        self._seq = 0
        self._save_lock = threading.Lock()
        self._stop = False
        self._closed = False
        self._every_s = 0.0
        self._token = None
        # accounting (the snapshot's `ckpt` section)
        self.saves_total = 0
        self.bases_total = 0
        self.deltas_total = 0
        self.bytes_total = 0
        self.last_bytes = 0
        self.last_slots = 0
        self.last_kind = ""
        self.last_save_s = 0.0

    # -- capture -------------------------------------------------------------

    def _aux_arrays(self) -> Dict[str, np.ndarray]:
        srv = self.server
        ab = srv.ab
        out = {"owner": ab.owner, "slot": ab.slot,
               "cache_slot": ab.cache_slot,
               "relocation_counter": ab.relocation_counter,
               "intent_end": srv.sync.intent_end,
               "clocks": srv._clocks}
        # the streaming plane's acked-event cursor rides the chain when a
        # plane exists (optional: never in _AUX_KEYS' mandatory set)
        if getattr(srv, "stream", None) is not None:
            out["stream_cursor"] = srv.stream.cursor
        return out

    def _capture_locked(self, kind: str):
        """Assemble one link's arrays (caller holds the server lock).
        Returns (arrs, new_marks, new_aux, slots_captured); the caller
        commits marks/aux only after the link is durably written."""
        srv = self.server
        ab = srv.ab
        arrs: Dict[str, np.ndarray] = {
            "format_version": np.int64(FORMAT_VERSION),
            "kind": np.frombuffer(kind.encode(), dtype=np.uint8).copy(),
            "num_keys": np.int64(srv.num_keys),
            "num_shards": np.int64(srv.num_shards),
        }
        if kind == "base":
            # compat metadata rides the base only
            arrs["value_lengths"] = np.array(srv.value_lengths)
        slots = 0
        new_marks = list(self._marks)
        for cid, st in enumerate(srv.stores):
            if kind == "base":
                arrs[f"main_{cid}"] = st.main_host()
                slots += int(st.main_shape_full[0] *
                             st.main_shape_full[1])
            else:
                sh, sl = np.nonzero(st.main_epoch > self._marks[cid])
                arrs[f"dsh_{cid}"] = sh.astype(np.int32)
                arrs[f"dsl_{cid}"] = sl.astype(np.int32)
                arrs[f"drows_{cid}"] = (
                    st.read_rows("main", sh.astype(np.int32),
                                 sl.astype(np.int32))
                    if len(sh) else
                    np.empty((0, st.value_length), dtype=np.float32))
                slots += len(sh)
            # the readback above synchronized with every enqueued
            # program; under the lock nothing new can land, so the
            # store's CURRENT epoch is the watermark this link covers
            new_marks[cid] = st._epoch
        # currently-dirty replicas: the restore rebuilds clean ones from
        # the replayed mains, so only these ship their (cache, delta)
        shards, keys = np.nonzero(ab.cache_slot >= 0)
        if len(keys):
            keys = keys.astype(np.int64)
            shards = shards.astype(np.int32)
            dirty = srv._dirty_replica_mask(keys, shards)
            dk, ds = keys[dirty], shards[dirty]
        else:
            dk = np.empty(0, dtype=np.int64)
            ds = np.empty(0, dtype=np.int32)
        for cid, st in enumerate(srv.stores):
            if len(dk):
                in_cls = ab.key_class[dk] == cid
                ck, cs_sh = dk[in_cls], ds[in_cls]
            else:
                ck = np.empty(0, dtype=np.int64)
                cs_sh = np.empty(0, dtype=np.int32)
            cs = ab.cache_slot[cs_sh, ck].astype(np.int32) if len(ck) \
                else np.empty(0, dtype=np.int32)
            arrs[f"rsh_{cid}"] = cs_sh
            arrs[f"rcs_{cid}"] = cs
            if len(ck):
                arrs[f"rcache_{cid}"] = st.read_rows("cache", cs_sh, cs)
                arrs[f"rdelta_{cid}"] = st.read_rows("delta", cs_sh, cs)
            else:
                empty = np.empty((0, st.value_length), dtype=np.float32)
                arrs[f"rcache_{cid}"] = empty
                arrs[f"rdelta_{cid}"] = empty
        # placement/meta tables, skipped when byte-identical to the
        # previous link. Serialize the COPY taken under the lock, never
        # the live table: serialization happens after the lock releases
        new_aux: Dict[str, np.ndarray] = {}
        for name, arr in self._aux_arrays().items():
            prev = self._aux_last.get(name)
            if prev is None or not np.array_equal(prev, arr):
                snap = np.array(arr)
                arrs[f"aux_{name}"] = snap
                new_aux[name] = snap
        return arrs, new_marks, new_aux, slots

    # -- save ----------------------------------------------------------------

    def save(self) -> Dict:
        """Write the next chain link (base first, deltas after): capture
        under the server lock, serialize, write atomically, then extend
        the manifest. Returns the manifest entry. A failure anywhere
        leaves the previous chain fully restorable."""
        srv = self.server
        f = srv.fault
        if f is not None:
            f.fire("ckpt.save")
        with self._save_lock:
            t0 = time.perf_counter()
            kind = "base" if not self._entries else "delta"
            with srv._lock:
                arrs, new_marks, new_aux, slots = \
                    self._capture_locked(kind)
            blob = _npz_bytes(arrs)
            fname = f"{kind}-{self._seq:06d}.npz"
            _write_atomic(os.path.join(self.path, fname), blob)
            entry = {
                "seq": self._seq,
                "kind": kind,
                "file": fname,
                "bytes": len(blob),
                "slots": int(slots),
                "sha256": hashlib.sha256(blob).hexdigest(),
                "prev_sha256": (self._entries[-1]["sha256"]
                                if self._entries else ""),
                "wall_time": time.time(),
            }
            self._entries.append(entry)
            manifest = {"format": MANIFEST_FORMAT,
                        "chain_id": self.chain_id,
                        "entries": self._entries}
            _write_atomic(os.path.join(self.path, MANIFEST_NAME),
                          json.dumps(manifest, indent=1).encode())
            # commit the watermarks only now: had the write failed, the
            # next save would re-capture these slots (never lose them)
            self._marks = new_marks
            self._aux_last.update(new_aux)
            self._seq += 1
            self.saves_total += 1
            if kind == "base":
                self.bases_total += 1
            else:
                self.deltas_total += 1
            self.bytes_total += len(blob)
            self.last_bytes = len(blob)
            self.last_slots = int(slots)
            self.last_kind = kind
            self.last_save_s = time.perf_counter() - t0
            return entry

    # -- periodic operation (the `ckpt` executor stream) ---------------------

    def start_periodic(self, every_s: float) -> None:
        """Schedule `save()` every `every_s` seconds as a
        self-rescheduling delayed program on the `ckpt` stream. A failed
        save is logged and the cadence continues — the chain stays
        restorable to its last good link."""
        assert every_s > 0
        self._every_s = float(every_s)
        token = object()
        self._token = token

        def tick():
            from ..utils import alog
            if self._stop or self._token is not token:
                return
            try:
                self.save()
            except Exception as e:  # noqa: BLE001 — the cadence
                # survives one failed save (injected or real I/O)
                f = self.server.fault
                if f is not None:
                    f.c_loop_retries.inc()
                alog(f"[ckpt] periodic save failed: "
                     f"{type(e).__name__}: {e}")
            if not self._stop and self._token is token:
                self.server.exec.submit("ckpt", tick, label="ckpt.save",
                                        coalesce_key="ckpt.save",
                                        delay=self._every_s)

        self.server.exec.submit("ckpt", tick, label="ckpt.save",
                                coalesce_key="ckpt.save",
                                delay=self._every_s)

    def close(self) -> None:
        """Stop the periodic program and drain the `ckpt` stream
        (idempotent). A save in flight reads through the pools, so
        Server.shutdown() calls this BEFORE pool teardown; a save that
        cannot drain fail-stops loudly."""
        if self._closed:
            return
        self._closed = True
        self._stop = True
        ex = self.server.exec
        if self._token is not None and not ex.closed:
            # the next periodic tick sits queued with its delay: a
            # coalesced submit pulls it forward to now, so it observes
            # the stop flag at once (else the drain below would wait out
            # the period, and fail past 60 s)
            ex.submit("ckpt", lambda: None, label="ckpt.save",
                      coalesce_key="ckpt.save")
        if not ex.closed and not ex.drain("ckpt", timeout=60):
            from ..utils import alog
            alog("[ckpt] checkpoint program failed to drain within 60s "
                 "of close — wedged mid-save")
            raise RuntimeError(
                "checkpoint program wedged: did not drain within 60s "
                "of close; refusing to proceed into pool teardown "
                "under a live reader")

    def stats(self) -> Dict:
        return {"saves_total": self.saves_total,
                "bases_total": self.bases_total,
                "deltas_total": self.deltas_total,
                "bytes_total": self.bytes_total,
                "last_bytes": self.last_bytes,
                "last_slots": self.last_slots,
                "last_kind": self.last_kind,
                "last_save_s": self.last_save_s,
                "chain_len": len(self._entries),
                "periodic_every_s": self._every_s}


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def _load_manifest(path: str) -> Dict:
    mp = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mp):
        raise CheckpointChainError(
            f"no checkpoint chain manifest at {mp}")
    try:
        with open(mp, "rb") as f:
            m = json.loads(f.read().decode())
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"chain manifest {mp} is unreadable: {e}") from e
    if m.get("format") != MANIFEST_FORMAT:
        raise CheckpointChainError(
            f"chain manifest format {m.get('format')!r} is "
            f"incompatible (expects {MANIFEST_FORMAT})")
    entries = m.get("entries") or []
    if not entries:
        raise CheckpointChainError(
            f"chain manifest {mp} lists no checkpoints")
    if entries[0].get("kind") != "base":
        raise CheckpointChainError(
            "chain does not start with a base checkpoint")
    for i, e in enumerate(entries):
        if e.get("seq") != i:
            raise CheckpointChainError(
                f"chain sequence broken at position {i}: manifest "
                f"lists seq {e.get('seq')!r} (a link is missing or "
                f"the manifest was edited)")
        if i > 0 and e.get("kind") != "delta":
            raise CheckpointChainError(
                f"unexpected {e.get('kind')!r} link at seq {i} "
                f"(only link 0 may be a base)")
    return m


def _load_verified_chain(path: str) -> List[Tuple[Dict, Dict]]:
    """Verify and load the whole chain into host memory. Every failure
    mode raises a NAMED error here, before the caller touches any
    server state."""
    m = _load_manifest(path)
    entries = m["entries"]
    # the links are read, hashed and inflated in parallel (each is its
    # own archive); their errors are raised below in chain order, as a
    # sequential walk would raise them
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(min(len(entries), os.cpu_count() or 1)) as ex:
        links = list(ex.map(lambda e: _read_link(path, e), entries))
    out: List[Tuple[Dict, Dict]] = []
    prev_sha = ""
    for e, (pre, sha, post, arrs) in zip(entries, links):
        if pre is not None:
            raise pre
        if e.get("prev_sha256", "") != prev_sha:
            raise CheckpointChainError(
                f"chain link {e['file']} (seq {e['seq']}) does not "
                f"chain to its predecessor (manifest edited or links "
                f"spliced from different chains)")
        prev_sha = sha
        if post is not None:
            raise post
        out.append((e, arrs))
    return out


def _read_link(path: str, e: Dict):
    """One link's (error before the predecessor check, sha256, error
    after it, arrays): a missing or checksum-failing file fails before
    the chain's digest check, an unreadable archive or a wrong format
    after it."""
    fp = os.path.join(path, e["file"])
    if not os.path.exists(fp):
        return (CheckpointChainError(
            f"missing chain link {e['file']} (seq {e['seq']}): the "
            f"manifest names it but the file is gone"), "", None, None)
    with open(fp, "rb") as f:
        data = f.read()
    sha = hashlib.sha256(data).hexdigest()
    if sha != e.get("sha256"):
        return (CheckpointCorruptError(
            f"chain link {e['file']} (seq {e['seq']}) failed its "
            f"checksum ({len(data)} bytes on disk): truncated or "
            f"corrupt — refusing a half-restore"), sha, None, None)
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as z:
            arrs = {k: z[k] for k in z.files}
    except Exception as e2:  # noqa: BLE001 — the checksum passed but
        # the archive is unreadable: still a corrupt link
        err = CheckpointCorruptError(
            f"chain link {e['file']} is not a readable archive: {e2}")
        err.__cause__ = e2
        return None, sha, err, None
    if int(arrs["format_version"]) != FORMAT_VERSION:
        return None, sha, CheckpointChainError(
            f"chain link {e['file']} has format "
            f"v{int(arrs['format_version'])} (expects "
            f"v{FORMAT_VERSION})"), None
    return None, sha, None, arrs


def _check_compat(server, chain: List[Tuple[Dict, Dict]]) -> None:
    _, base = chain[0]
    if int(base["num_keys"]) != server.num_keys:
        raise CheckpointChainError(
            f"key count mismatch: chain has {int(base['num_keys'])}, "
            f"server has {server.num_keys}")
    if int(base["num_shards"]) != server.num_shards:
        raise CheckpointChainError(
            f"shard count mismatch: chain has "
            f"{int(base['num_shards'])}, server has "
            f"{server.num_shards}")
    if not (base["value_lengths"] == server.value_lengths).all():
        raise CheckpointChainError("value-length layout mismatch")
    for cid, st in enumerate(server.stores):
        got = base[f"main_{cid}"].shape
        if got != st.main_shape_full:
            raise CheckpointChainError(
                f"pool main_{cid} geometry mismatch: chain "
                f"{got} vs server {st.main_shape_full}")


def restore_chain(server, path: str,
                  hold_degraded_s: float = 0.0) -> float:
    """Verify + replay a checkpoint chain (written by either package)
    into a compatibly-constructed Server. Returns the recovery wall time
    in seconds (also the snapshot's `ckpt.recovery_s`).

    Every verification error raises BEFORE any server mutation. During
    the apply the server is DEGRADED: serve lookups shed with
    `ServeDegradedError`; on success the flag clears, on an apply
    failure it stays set (the state is indeterminate — fail-stop).
    `hold_degraded_s` keeps the degraded state up that much longer after
    a successful apply (drills; deployments whose health probe needs an
    observation window)."""
    if server.glob is not None:
        raise NotImplementedError(_MULTI_PROCESS)
    f = server.fault
    if f is not None:
        f.fire("ckpt.restore")
    t0 = time.perf_counter()
    chain = _load_verified_chain(path)
    _check_compat(server, chain)
    server.begin_degraded(
        f"checkpoint restore in progress ({path}, "
        f"{len(chain)} links)")
    _apply_chain(server, chain)
    recovery_s = time.perf_counter() - t0
    server._last_recovery_s = recovery_s
    if hold_degraded_s > 0:
        time.sleep(hold_degraded_s)
    server.end_degraded()
    return recovery_s


def _apply_chain(server, chain: List[Tuple[Dict, Dict]]) -> None:
    from ..utils.checkpoint import _rebuild_allocators_and_replicas
    # latest version of each aux table across the chain (links skip
    # unchanged tables)
    aux: Dict[str, np.ndarray] = {}
    for _, arrs in chain:
        for name in _AUX_KEYS:
            k = f"aux_{name}"
            if k in arrs:
                aux[name] = arrs[k]
        if "aux_stream_cursor" in arrs:
            aux["stream_cursor"] = arrs["aux_stream_cursor"]
    missing = [n for n in _AUX_KEYS if n not in aux]
    if missing:
        raise CheckpointChainError(
            f"chain never captured table(s) {missing} (base link "
            f"incomplete)")
    _, final = chain[-1]
    with server._lock, server._topology_mutation():
        # leading bump: any concurrently-planned optimistic route fails
        # revalidation instead of dispatching pre-restore coordinates
        server.topology_version += 1
        ab = server.ab
        ab.owner[:] = aux["owner"]
        ab.slot[:] = aux["slot"]
        ab.cache_slot[:] = aux["cache_slot"]
        ab.relocation_counter[:] = aux["relocation_counter"]
        ab.replica_count[:] = (ab.cache_slot >= 0).sum(axis=0)
        server.sync.intent_end[:] = aux["intent_end"]
        server._clocks[:] = aux["clocks"]
        for wid, w in server._workers.items():
            w._clock = int(server._clocks[wid])
        if "stream_cursor" in aux:
            # the acked-event horizon: kept on the server (the streaming
            # plane itself is ROADMAP queue A, item 11)
            cur = int(np.asarray(aux["stream_cursor"]).reshape(-1)[0])
            server._restored_stream_cursor = cur
            if getattr(server, "stream", None) is not None:
                server.stream.cursor[0] = cur

        rep_sh, rep_k = np.nonzero(ab.cache_slot >= 0)
        for cid, st in enumerate(server.stores):
            # replay: base table, then cell-wise last-writer deltas
            full = np.array(chain[0][1][f"main_{cid}"])
            for _, arrs in chain[1:]:
                dsh, dsl = arrs[f"dsh_{cid}"], arrs[f"dsl_{cid}"]
                if len(dsh):
                    full[dsh, dsl] = arrs[f"drows_{cid}"]
            st.install_main_full(full)
            # replicas: clean ones are bitwise cache==main, delta==0;
            # the final link's captured dirty rows overlay that
            S = st.ctx.num_shards
            cache_host = np.zeros((S, st.cache_slots, st.value_length),
                                  dtype=full.dtype)
            delta_host = np.zeros_like(cache_host)
            if len(rep_k):
                in_cls = ab.key_class[rep_k] == cid
                ck, csh = rep_k[in_cls], rep_sh[in_cls]
                if len(ck):
                    cs = ab.cache_slot[csh, ck]
                    cache_host[csh, cs] = full[ab.owner[ck],
                                               ab.slot[ck]]
            rsh, rcs = final[f"rsh_{cid}"], final[f"rcs_{cid}"]
            if len(rsh):
                cache_host[rsh, rcs] = final[f"rcache_{cid}"]
                delta_host[rsh, rcs] = final[f"rdelta_{cid}"]
            st.install_replica_pools(cache_host, delta_host)
        _rebuild_allocators_and_replicas(server)
    if server.prefetch is not None:
        server.prefetch.invalidate_all()
    server.block()
