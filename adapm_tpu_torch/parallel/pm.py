"""GlobalPM: the cross-process parameter manager (the JAX package's
`parallel/pm.py`).

This wires a NetNode's channel (the DCN channel, parallel/dcn.py, in a
launched run; the loopback fabric, net/loopback.py, in one process) into
the Server so that N processes form ONE parameter manager, the way the
reference's nodes do (SURVEY.md §1):

  - The key space is partitioned over `P * S_local` global shards
    (Addressbook multi-process init); keys whose home lands on another
    process carry `owner == REMOTE` locally.
  - Pull/Push/Set of remotely-owned keys ride `DcnChannel.request` to the
    owner process. Where the reference *forwards* server-side when the
    target no longer owns a key (coloc_kv_server.h:455-476), here the
    server replies with a redirect hint and the REQUESTER retries — same
    number of network hops, but handler threads never issue nested
    requests, so two processes serving each other can never deadlock on
    their per-peer channel locks.
  - Every reply carries the authoritative owner per served key, feeding
    per-process **location caches** (reference addressbook.h:114-133;
    `NOT_CACHED` sentinel; honored `--sys.location_caches`): with caches
    on, the second access to a relocated key takes one hop; with caches
    off, requests route via the key's manager (home process) every time.
  - Intent on a remote key asks the owner to decide **relocate vs
    replicate** (reference sync_manager.h:624-644): relocate iff no *other*
    process and no owner-local worker holds interest; the owner tracks
    interest as a per-key bitmask of subscribed processes (the reference's
    per-sender node_intent sets, sync_manager.h:182, 571, 644).
  - Ownership transfers carry **relocation counters**; the key's manager
    accepts owner updates only with a newer counter, rejecting stale moves
    (reference addressbook.h:92-102).
  - Cross-process replicas live in the local cache/delta pools like local
    ones; sync rounds extract delta rows, ship them to the owner, and
    install the returned fresh value as the new base while subtracting
    exactly the shipped delta — a local read observes base+delta
    throughout, so a worker's own pushes never transiently vanish (the
    reference keeps `val` intact and advances `sync_state`,
    handle.h:601-662).

Locking discipline: device/table mutations happen under `server._lock`;
DCN round-trips NEVER happen while holding it (a peer's handler needs its
own lock to serve us). Handler threads take only `server._lock` and issue
no blocking requests (the manager notification is dispatched to the
executor), so the request graph is acyclic.

Device work on handler threads: a served read gathers through K1 on the
server's stream and returns host rows (`.cpu()` synchronizes), so every
reply's rows are complete before its frame is encoded; a served write
enqueues K3 under the lock, ordered on the stream before any later
gather. With --sys.collective_sync the replica deltas of remote keys
ride the BSP collective exchange instead (`collective_sync`,
`collective_pull`, `collective_push`; parallel/collective.py over K13).
"""
from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import NOT_CACHED, MgmtTechniques
from ..utils.log import alog

# client-side redirect-retry budget: transient misses (a request racing an
# ownership transfer) resolve within a hop or two once the adoption lands;
# later tries back off to give it time
MAX_TRIES = 64


def executor_widths(opts) -> Tuple[int, int]:
    """(read-pool, write-pool) worker counts from --sys.dcn_threads
    (reference --sys.zmq_threads analog): pulls may block on write futures,
    so writes get a separate, never-starved pool."""
    nt = max(1, int(opts.dcn_threads))
    return nt, max(2, nt // 2)


def _offsets(lens: np.ndarray) -> np.ndarray:
    offs = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    return offs


def _uniform(lens: np.ndarray) -> Optional[int]:
    return int(lens[0]) if len(lens) and (lens == lens[0]).all() else None


def _ragged_arange(lens: np.ndarray) -> np.ndarray:
    """concat([arange(l) for l in lens]) without the Python loop."""
    offs = _offsets(lens)
    return np.arange(offs[-1]) - np.repeat(offs[:-1], lens)


def _select_flat(flat: np.ndarray, offs: np.ndarray, lens: np.ndarray,
                 pos: np.ndarray) -> np.ndarray:
    """Extract the value segments of key positions `pos` from a flat concat
    buffer over the full key batch."""
    if len(pos) == 0:
        return np.empty(0, dtype=np.float32)
    u = _uniform(lens)
    if u is not None:
        return np.ascontiguousarray(flat.reshape(-1, u)[pos]).ravel()
    # mixed lengths: one repeat-based index build, no per-key loop
    sub = lens[pos]
    idx = np.repeat(offs[pos], sub) + _ragged_arange(sub)
    return flat[idx]


def _fill_flat(out: np.ndarray, offs: np.ndarray, lens: np.ndarray,
               pos: np.ndarray, part: np.ndarray) -> None:
    """Write `part` (flat concat for positions `pos`) into the right
    segments of `out` (flat concat for the full batch)."""
    if len(pos) == 0:
        return
    u = _uniform(lens)
    if u is not None:
        out.reshape(-1, u)[pos] = part.reshape(len(pos), u)
        return
    sub = lens[pos]
    idx = np.repeat(offs[pos], sub) + _ragged_arange(sub)
    out[idx] = part


class GlobalPM:
    """One per Server of a run of more than one process (or node)."""

    def __init__(self, server, node=None):
        self.server = server
        # The node abstraction (net/port.py NetNode): identity, channel
        # factory, barriers, liveness. Default DcnNode = a launched run;
        # a LoopbackNode runs the SAME code paths fully in-process
        # (tests, storms, failover drills).
        if node is None:
            from ..net.port import DcnNode
            node = DcnNode(server.opts)
        if server.opts.collective_sync and node.kind != "dcn":
            # before any channel or pool starts: nothing to tear down
            raise ValueError(
                "--sys.collective_sync requires the dcn backend (device "
                "collectives are meaningless on the in-process "
                f"{node.kind!r} fabric)")
        self.node = node
        self.pid = node.pid
        self.num_procs = node.num_procs
        assert self.num_procs <= 64, \
            "interest bitmask is uint64 (one bit per process)"
        self._gs = server.num_shards * self.num_procs
        K = server.num_keys

        home = self.home_proc(np.arange(K, dtype=np.int64))
        # owner_hint[k]: authoritative current owner for keys managed here
        # (home == pid; maintained via counter-checked owner updates and our
        # own transfers); elsewhere a location-cache hint, NOT_CACHED when
        # caches are off or nothing has been learned yet
        if server.opts.location_caches:
            self.owner_hint = home.astype(np.int32)  # initially owner==home
        else:
            self.owner_hint = np.where(home == self.pid, home,
                                       NOT_CACHED).astype(np.int32)
        # dual-role relocation counters (reference addressbook.h:92-102):
        # at the key's owner, the current counter (travels with ownership);
        # at its manager, the newest counter seen (staleness filter)
        self.reloc = np.zeros(K, dtype=np.int32)
        # at the owner: bit p set = process p holds a replica of the key
        self.interest = np.zeros(K, dtype=np.uint64)

        self.stats = {"pulls_in": 0, "pushes_in": 0, "redirects": 0,
                      "intents_in": 0, "relocations_out": 0,
                      "relocations_in": 0, "replicas_granted": 0,
                      "syncs_in": 0, "keys_synced_out": 0}
        # registry counters (obs): ownership transfers the manager
        # ACCEPTED vs REJECTED as stale by relocation counter — the
        # per-round planner-churn signal metrics_snapshot()'s pm section
        # carries alongside the relocations/replications counts above
        self._c_ou_acc = server.obs.counter("pm.owner_updates_accepted")
        self._c_ou_stale = server.obs.counter(
            "pm.owner_updates_rejected_stale")
        # hop histogram: keys SERVED at try 1 / 2 / 3+ of the redirect-
        # retry loop (the reference prints a refresh hop histogram,
        # sync_manager.h:504-519; hops==1 means the location cache or
        # manager pointed straight at the owner)
        self.hops = np.zeros(3, dtype=np.int64)
        # guards hops/stats increments from concurrent _drive invocations
        # (_exec_r threads) and serve-pool handlers: numpy/int in-place
        # adds are not atomic, so unguarded counts silently undercount
        import threading as _threading
        self._stats_lock = _threading.Lock()

        # Serializes "delta in flight" windows: a cross-process sync round
        # holds its keys' locks across extract -> ship -> refresh;
        # anything that CONSUMES a replica's pending delta (adoption's
        # replica->owner upgrade, Set's replica invalidation) must take
        # them first — otherwise the consumed delta double-applies when
        # the in-flight round lands at the (possibly now-local) owner.
        # ONE LOCK PER SYNC CHANNEL (keys partition by the Knuth hash),
        # so per-channel sync rounds overlap their DCN round-trips
        # (the reference runs C sync threads concurrently,
        # coloc_kv_server.h:100-105). Lock order: delta
        # locks in CHANNEL ORDER, all BEFORE server._lock; handler
        # threads never take them.
        import threading
        self._delta_locks = [threading.Lock()
                             for _ in range(server.opts.channels)]
        self._all_channels = tuple(range(server.opts.channels))

        # separate pools: pull tasks may block on write futures, so writes
        # must never queue behind blocked pulls. Widths follow
        # --sys.dcn_threads (reference --sys.zmq_threads analog), which
        # also sizes the channel's serve pool (handler concurrency)
        nr, nw = executor_widths(server.opts)
        self.chan = node.make_channel(self._handle, serve_threads=nr)
        self.chan.start()
        self._exec_r = ThreadPoolExecutor(max_workers=nr,
                                          thread_name_prefix="adapm-pm-r")
        self._exec_w = ThreadPoolExecutor(max_workers=nw,
                                          thread_name_prefix="adapm-pm-w")
        # fan-out pool for _drive's concurrent per-destination round trips.
        # Dedicated (never _exec_r/_exec_w): its tasks only block on
        # channel futures and never submit back into it, so it cannot
        # deadlock even when _drive itself runs on _exec_r
        self._exec_fan = ThreadPoolExecutor(max_workers=max(2, nr),
                                            thread_name_prefix="adapm-pm-f")
        # BSP collective sync engine (--sys.collective_sync): replica
        # delta/fresh rows ride the collective exchange at WaitSync/
        # quiesce points and cadence boundaries instead of DCN RPC
        # (parallel/collective.py)
        self.coll = None
        if server.opts.collective_sync:
            from .collective import CollectiveSync
            self.coll = CollectiveSync(self, server.opts.collective_bucket)
        node.barrier("pm-up")

    @contextmanager
    def delta_window(self, channels=None):
        """Context manager holding the delta-in-flight locks for the given
        channel ids (None = all), acquired in channel order."""
        cs = self._all_channels if channels is None \
            else sorted(set(int(c) for c in channels))
        held = []
        try:
            for c in cs:
                lk = self._delta_locks[c]
                lk.acquire()
                held.append(lk)
            yield
        finally:
            for lk in reversed(held):
                lk.release()

    def delta_window_for(self, keys: np.ndarray):
        """delta_window over exactly the channels the keys hash to
        (core.sync.key_channel — the partition the sync rounds use)."""
        from ..core.sync import key_channel
        if len(keys) == 0:
            return self.delta_window(())
        return self.delta_window(
            np.unique(key_channel(np.asarray(keys, dtype=np.int64),
                                  len(self._delta_locks))))

    # -- partition helpers ---------------------------------------------------

    def home_proc(self, keys: np.ndarray) -> np.ndarray:
        """Manager process of each key: global home shard // S_local
        (reference manager = key % num_servers, addressbook.h:110-112)."""
        return (keys % self._gs) // self.server.num_shards

    def _route_dest(self, keys: np.ndarray) -> np.ndarray:
        """Best-known destination process per key: location hint if cached,
        else the manager (which redirects to the owner it has on record).
        dest == self is legitimate: a key may have been adopted locally
        after the caller classified it as remote — _drive serves those
        through the local handler, which owns the truth."""
        hint = self.owner_hint[keys]
        home = self.home_proc(keys)
        return np.where(hint >= 0, hint, home).astype(np.int64)

    def _learn(self, keys: np.ndarray, owners: np.ndarray) -> None:
        """Update location caches from reply traffic (reference
        addressbook.h:114-133, coloc_kv_worker.h:880-884). Manager entries
        are authoritative and only move via counter-checked owner updates."""
        if not self.server.opts.location_caches or len(keys) == 0:
            return
        mask = self.home_proc(keys) != self.pid
        self.owner_hint[keys[mask]] = owners[mask]

    def _hint_for(self, keys: np.ndarray) -> np.ndarray:
        """Redirect hints for keys we do not own: our best owner knowledge
        (authoritative for keys managed here), NOT_CACHED when unknown."""
        h = self.owner_hint[keys].copy()
        return np.where(h == self.pid, NOT_CACHED, h).astype(np.int32)

    # -- the redirect-retry loop --------------------------------------------

    def _drive(self, keys: np.ndarray,
               make_msg: Callable[[np.ndarray, np.ndarray], tuple],
               serve_local: Callable[[tuple], tuple],
               merge: Callable[[tuple, np.ndarray], np.ndarray],
               what: str) -> None:
        """Send per-destination requests for `keys`, retrying unserved keys
        at the redirect hint (or their manager). `make_msg(ks, pos)` builds
        the request for a destination (pos = positions into `keys`);
        `serve_local(msg)` handles the dest==self case; `merge(reply, pos)`
        consumes a reply and returns the per-key owner/hint array (>= 0 and
        served, or a hint/NOT_CACHED for unserved keys — unserved is
        signaled by reply[0], the served mask)."""
        pending = np.arange(len(keys), dtype=np.int64)
        dest = self._route_dest(keys)
        tries = 0
        while len(pending):
            tries += 1
            if tries > MAX_TRIES:
                raise RuntimeError(
                    f"{what}: ownership metadata did not converge for keys "
                    f"{keys[pending][:5].tolist()}...")
            if tries > 2:
                with self._stats_lock:
                    self.stats["redirects"] += len(pending)
                time.sleep(min(0.002 * tries, 0.1))
            still: List[np.ndarray] = []
            # freeze this round's grouping: redirect handling below mutates
            # `dest`, and re-evaluating dest[pending] mid-loop would let a
            # key redirected out of an earlier group be served by a later
            # group in the SAME round and then retried next round — a
            # double apply
            dcur = dest[pending].copy()
            groups = [(int(d), pending[dcur == d]) for d in np.unique(dcur)]
            # fan out: all remote destinations' round-trips overlap (the
            # channel demuxes by request id; reference SyncManager
            # channels run in C parallel threads, coloc_kv_server.h:
            # 100-105). Merging stays on this thread: merge() writes
            # shared buffers.
            futs = {}
            n_remote_groups = sum(1 for d, _ in groups if d != self.pid)
            if n_remote_groups > 1:  # single dest: no pool hop needed
                for d, pos in groups:
                    if d != self.pid:
                        futs[d] = self._exec_fan.submit(
                            self.chan.request, d, make_msg(keys[pos], pos))
            try:
                for d, pos in groups:
                    if d in futs:
                        reply = futs.pop(d).result()
                    else:
                        msg = make_msg(keys[pos], pos)
                        reply = serve_local(msg) if d == self.pid \
                            else self.chan.request(d, msg)
                    served = reply[0].astype(bool)
                    owners = merge(reply, pos)
                    with self._stats_lock:
                        self.hops[min(tries, 3) - 1] += int(served.sum())
                    self._learn(keys[pos][served], owners[served])
                    uns = pos[~served]
                    if len(uns):
                        hint = owners[~served]
                        home = self.home_proc(keys[uns])
                        # hint == self means an adoption by our own
                        # planner is in flight; keep routing to the local
                        # handler until it lands (the retry backoff gives
                        # it time)
                        dest[uns] = np.where(hint >= 0, hint, home)
                        still.append(uns)
            except BaseException:
                # A failed destination must not leave sibling in-flight
                # requests half-done: they were already SERVED remotely
                # (deltas merged at owners, intents registered), so drain
                # their replies before propagating — the caller sees one
                # failure, not silent remote/local divergence. Replies
                # drained here are discarded; _drive failures are fatal
                # to the op, and the retry path re-resolves ownership.
                for d, f in futs.items():
                    try:
                        f.result(timeout=30.0)
                        alog(f"pm{self.pid}: {what}: drained reply from "
                             f"{d} after sibling failure (discarded)")
                    except Exception as e2:
                        alog(f"pm{self.pid}: {what}: drain of {d} also "
                             f"failed: {e2!r}")
                raise
            pending = np.concatenate(still) if still \
                else np.empty(0, dtype=np.int64)

    # -- inbound dispatch ----------------------------------------------------

    def _handle(self, msg):
        op = msg[0]
        if op == "pull":
            return self._serve_pull(msg)
        if op in ("push", "set"):
            return self._serve_write(msg)
        if op == "intent":
            return self._serve_intent(msg)
        if op == "sync":
            return self._serve_sync(msg)
        if op == "unsub":
            return self._serve_unsub(msg)
        if op == "owner_update":
            return self._serve_owner_update(msg)
        raise ValueError(f"unknown DCN op {op!r}")

    # -- pull ---------------------------------------------------------------

    def _serve_pull(self, msg):
        """Serve the keys we own; hint the rest. Reply:
        (served u8[n], vals f32 flat[n], owners i32[n])."""
        _, keys = msg
        srv = self.server
        keys = np.asarray(keys, dtype=np.int64)
        lens = srv.value_lengths[keys]
        offs = _offsets(lens)
        out = np.zeros(offs[-1], dtype=np.float32)
        owners = np.empty(len(keys), dtype=np.int32)
        with self._stats_lock:
            self.stats["pulls_in"] += len(keys)
        with srv._lock:
            owned = srv.ab.owner[keys] >= 0
            pos = np.nonzero(owned)[0]
            if len(pos):
                _fill_flat(out, offs, lens, pos,
                           srv._read_owned_flat(keys[pos]))
                owners[pos] = self.pid
        rem = np.nonzero(~owned)[0]
        if len(rem):
            owners[rem] = self._hint_for(keys[rem])
        return owned.astype(np.uint8), out, owners

    def request_pull(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Fetch current values of remotely-owned keys (synchronous).
        Returns (flat values, owners)."""
        lens = self.server.value_lengths[keys]
        offs = _offsets(lens)
        out = np.empty(offs[-1], dtype=np.float32)
        owners = np.empty(len(keys), dtype=np.int32)

        def merge(reply, pos):
            served, vals, own = reply[0].astype(bool), reply[1], reply[2]
            sub_lens = lens[pos]
            sub_offs = _offsets(sub_lens)
            spos = np.nonzero(served)[0]
            _fill_flat(out, offs, lens, pos[spos],
                       _select_flat(vals, sub_offs, sub_lens, spos))
            owners[pos[spos]] = own[spos]
            return own

        self._drive(keys, lambda ks, pos: ("pull", ks),
                    self._serve_pull, merge, "pull")
        return out, owners

    def pull_async(self, keys: np.ndarray,
                   after: Sequence[Future] = ()) -> Future:
        """Async pull of remote keys; `after` futures (this worker's
        outstanding remote writes) complete first, preserving
        read-your-writes across the channel."""
        after = list(after)

        def task():
            for f in after:
                f.result()
            flat, _ = self.request_pull(keys)
            return flat

        return self._exec_r.submit(task)

    # -- push / set ---------------------------------------------------------

    def _serve_write(self, msg):
        """Apply push/set to keys we own; hint the rest. Reply:
        (served u8[n], owners i32[n])."""
        op, keys, flat = msg
        is_set = op == "set"
        srv = self.server
        keys = np.asarray(keys, dtype=np.int64)
        lens = srv.value_lengths[keys]
        offs = _offsets(lens)
        owners = np.empty(len(keys), dtype=np.int32)
        with self._stats_lock:
            self.stats["pushes_in"] += len(keys)
        with srv._lock:
            owned = srv.ab.owner[keys] >= 0
            pos = np.nonzero(owned)[0]
            if len(pos):
                part = _select_flat(flat, offs, lens, pos)
                srv._apply_remote_write(keys[pos], part, is_set)
                owners[pos] = self.pid
        rem = np.nonzero(~owned)[0]
        if len(rem):
            owners[rem] = self._hint_for(keys[rem])
        return owned.astype(np.uint8), owners

    def request_write(self, keys: np.ndarray, flat: np.ndarray,
                      is_set: bool) -> None:
        lens = self.server.value_lengths[keys]
        offs = _offsets(lens)
        op = "set" if is_set else "push"

        def make(ks, pos):
            return (op, ks, _select_flat(flat, offs, lens, pos))

        self._drive(keys, make, self._serve_write,
                    lambda reply, pos: reply[1], op)

    def write_async(self, keys: np.ndarray, flat: np.ndarray,
                    is_set: bool, after: Sequence[Future] = ()) -> Future:
        """Async remote write. `after` = the issuing worker's earlier write
        futures: chaining preserves per-worker write order (push-then-set
        must land in that order at the owner). Waiting inside the pool is
        safe: FIFO scheduling means a task only ever waits on
        earlier-submitted tasks, which are running or done."""
        keys = keys.copy()
        flat = np.ascontiguousarray(flat)
        after = list(after)

        def task():
            for f in after:
                f.result()
            self.request_write(keys, flat, is_set)

        return self._exec_w.submit(task)

    # -- intent: the relocate-vs-replicate decision --------------------------

    def _serve_intent(self, msg):
        """Owner side (reference ProcessSyncMessage request branch,
        sync_manager.h:553-739): per key decide relocation vs replication,
        transfer or register, and return current values. Reply:
        (served u8, actions u8, vals f32 flat, counters i32, owners i32)."""
        _, keys, end, req = msg
        srv = self.server
        keys = np.asarray(keys, dtype=np.int64)
        lens = srv.value_lengths[keys]
        offs = _offsets(lens)
        n = len(keys)
        actions = np.zeros(n, dtype=np.uint8)   # 0=replicated, 1=relocated
        out = np.zeros(offs[-1], dtype=np.float32)
        counters = np.zeros(n, dtype=np.int32)
        owners = np.empty(n, dtype=np.int32)
        with self._stats_lock:
            self.stats["intents_in"] += n
        bit = np.uint64(1) << np.uint64(req)
        rel_keys = np.empty(0, dtype=np.int64)
        with srv._lock:
            ab = srv.ab
            owned = ab.owner[keys] >= 0
            pos = np.nonzero(owned)[0]
            if len(pos):
                ko = keys[pos]
                tech = srv.opts.techniques
                if tech == MgmtTechniques.REPLICATION_ONLY:
                    rel_mask = np.zeros(len(ko), dtype=bool)
                elif tech == MgmtTechniques.RELOCATION_ONLY:
                    rel_mask = np.ones(len(ko), dtype=bool)
                else:
                    # relocate iff no OTHER process subscribed and no
                    # owner-local worker interest (active intent or local
                    # replica) — sync_manager.h:624-644
                    other = (self.interest[ko] & ~bit) != 0
                    clocks = srv.shard_min_clocks()
                    ie = srv.sync.intent_end
                    local_act = (ie[:, ko] >= clocks[:, None]).any(axis=0)
                    has_rep = ab.replica_count[ko] > 0
                    rel_mask = ~other & ~local_act & ~has_rep
                rel_keys = ko[rel_mask]
                # forced relocation may move keys that still have local
                # replicas: flush + drop them first so no delta is lost
                if len(rel_keys) and (ab.replica_count[rel_keys] > 0).any():
                    srv._flush_drop_local_replicas(rel_keys)
                _fill_flat(out, offs, lens, pos, srv._read_owned_flat(ko))
                ctr = self.reloc[ko].copy()
                ctr[rel_mask] += 1
                counters[pos] = ctr
                actions[pos] = rel_mask.astype(np.uint8)
                owners[pos] = np.where(rel_mask, req, self.pid)
                if len(rel_keys):
                    with srv._topology_mutation():
                        self.reloc[rel_keys] = ctr[rel_mask]
                        for cid, cpos in srv._group_by_class(rel_keys):
                            if srv.tier is not None:
                                # release the abandoned slots' residency
                                # (hot rows freed without copy-back: the
                                # authoritative values were read into
                                # `out` above) BEFORE the slots return
                                # to the allocator
                                from ..tier.promote import release_rows
                                ks = rel_keys[cpos]
                                release_rows(srv.stores[cid],
                                             ab.owner[ks], ab.slot[ks])
                            ab.abandon_batch(rel_keys[cpos])
                        self.owner_hint[rel_keys] = req
                        self.interest[rel_keys] = 0
                        self.stats["relocations_out"] += len(rel_keys)
                rep_keys = ko[~rel_mask]
                if len(rep_keys):
                    self.interest[rep_keys] |= bit
                    self.stats["replicas_granted"] += len(rep_keys)
        # notify managers of the transfers — from the executor, not this
        # handler thread (handlers must never block on requests); the
        # counter check makes late arrival harmless
        if len(rel_keys):
            mgr = self.home_proc(rel_keys)
            ctr_rel = self.reloc[rel_keys]
            for d in np.unique(mgr):
                if d in (self.pid, req):
                    continue  # both already hold the new owner
                m = mgr == d
                self._exec_w.submit(self._notify_manager, int(d),
                                    rel_keys[m], req, ctr_rel[m])
        rem = np.nonzero(~owned)[0]
        if len(rem):
            owners[rem] = self._hint_for(keys[rem])
        return owned.astype(np.uint8), actions, out, counters, owners

    def _notify_manager(self, dest: int, keys, new_owner, counters):
        try:
            self.chan.request(dest, ("owner_update", keys, new_owner,
                                     counters))
        except Exception:  # noqa: BLE001 — counters make retries optional
            from ..utils import alog
            alog(f"[pm] owner_update to {dest} failed "
                 f"({len(keys)} keys); manager hint remains stale")

    def intent_remote(self, keys: np.ndarray, shard: int, end: int) -> None:
        """Requester side: act on an intent for remotely-owned keys — ask
        each owner to relocate or replicate, then install the outcome
        locally. Called from the planner (SyncManager._register) and the
        miss path (Server.ensure_local)."""
        with self.delta_window_for(keys):  # adoption consumes deltas
            self._intent_remote_locked(keys, shard, end)

    def _intent_remote_locked(self, keys, shard, end) -> None:
        srv = self.server
        # writes completed before this point are applied at their owners,
        # so the owner's base snapshot during this RPC will include them;
        # anything still pending (or submitted during the RPC) stays in
        # _rw_pending and blocks installation of that key's replica below
        with srv._lock:
            srv._prune_rw_pending()
        lens = srv.value_lengths[keys]

        def merge(reply, pos):
            # each reply's keys install as it lands, not once the whole
            # batch converged: a key relocated to this node is owned by
            # nobody until its adoption, and a peer whose own intent
            # waits on it may hold (in its own unfinished batch) a key
            # this batch waits on — installing late would make the two
            # batches wait on each other until the retry budget ran out
            served = reply[0].astype(bool)
            act, vals, ctr, own = reply[1], reply[2], reply[3], reply[4]
            sub_lens = lens[pos]
            sub_offs = _offsets(sub_lens)
            spos = np.nonzero(served)[0]
            if len(spos):
                landed = pos[spos]
                l_lens = lens[landed]
                l_offs = _offsets(l_lens)
                l_flat = _select_flat(vals, sub_offs, sub_lens, spos)
                a = act[spos]
                rel = np.nonzero(a == 1)[0]
                rep = np.nonzero(a == 0)[0]
                if len(rel):
                    self._adopt(keys[landed[rel]],
                                _select_flat(l_flat, l_offs, l_lens, rel),
                                ctr[spos][rel], shard)
                if len(rep):
                    self._install_replicas(
                        keys[landed[rep]],
                        _select_flat(l_flat, l_offs, l_lens, rep), shard)
            return own

        self._drive(keys, lambda ks, pos: ("intent", ks, end, self.pid),
                    self._serve_intent, merge, "intent")

    def _adopt(self, keys: np.ndarray, flat: np.ndarray,
               counters: np.ndarray, shard: int) -> None:
        """Take ownership of relocated keys: merge any pending local replica
        deltas (replica -> owner upgrade, reference
        refreshUpgradeReplicaUnsafe handle.h:776-840), then install the rows
        as main copies on `shard`."""
        srv = self.server
        from ..core.store import OOB
        lens = srv.value_lengths[keys]
        offs = _offsets(lens)
        with srv._lock, srv._topology_mutation():
            self.reloc[keys] = counters
            self.owner_hint[keys] = self.pid
            ab = srv.ab
            for cid, pos in srv._group_by_class(keys):
                ks = keys[pos]
                L = srv.class_lengths[cid]
                rows = np.array(
                    _select_flat(flat, offs, lens, pos).reshape(-1, L))
                for s in range(srv.num_shards):
                    cs = ab.cache_slot[s, ks]
                    has = cs >= 0
                    if not has.any():
                        continue
                    d = srv.stores[cid].read_rows(
                        "delta", np.full(int(has.sum()), s, np.int32),
                        cs[has].astype(np.int32))
                    rows[has] += d
                    dropped = ks[has]
                    srv.sync.replica_discard(dropped, s)
                    ab.drop_replicas(dropped, s)
                shards, slots = ab.adopt_batch(ks, shard)
                nk = len(ks)
                srv.stores[cid].set_rows(
                    shards.astype(np.int32), slots.astype(np.int32),
                    rows, np.zeros(nk, np.int32), np.full(nk, OOB, np.int32))
            self.stats["relocations_in"] += len(keys)
            srv.sync.stats.add(relocations=len(keys))
            if srv.tracer is not None:
                from ..utils.stats import RELOCATE
                srv.tracer.record(keys, RELOCATE, shard)

    def _install_replicas(self, keys: np.ndarray, flat: np.ndarray,
                          shard: int) -> None:
        """Install replicas of remote-owned keys on local `shard` with the
        owner-provided base values."""
        srv = self.server
        lens = srv.value_lengths[keys]
        offs = _offsets(lens)
        surplus: List[np.ndarray] = []
        with srv._lock:
            ab = srv.ab
            # keys with an in-flight remote write: the owner's base
            # snapshot may predate the write landing, so installing it
            # would let a local read miss the worker's own push. Defer —
            # the key stays remote and a later intent drain retries.
            blocked = srv._rw_blocked_keys()
            with srv._topology_mutation() as tm:
                installed = 0
                for cid, pos in srv._group_by_class(keys):
                    ks = keys[pos]
                    # an earlier entry in the same drain may have
                    # replicated (or adopted) some of these already
                    fresh = (ab.cache_slot[shard, ks] < 0) & \
                        (ab.owner[ks] < 0)
                    if blocked is not None:
                        bl = np.isin(ks, blocked)
                        # only keys that WOULD have been installed are
                        # deferred + unsubscribed; keys already
                        # replicated/adopted keep their registration
                        # (unsub would orphan them)
                        skipped = ks[fresh & bl]
                        if len(skipped):
                            surplus.append(skipped)
                        fresh &= ~bl
                    ks, pos = ks[fresh], pos[fresh]
                    if len(ks) == 0:
                        continue
                    L = srv.class_lengths[cid]
                    cs = ab.add_replicas(ks, shard)
                    took = ks[: len(cs)]
                    if len(took):
                        installed += len(took)
                        rows = _select_flat(flat, offs, lens,
                                            pos[: len(cs)]).reshape(-1, L)
                        srv.stores[cid].install_replica_rows(
                            np.full(len(took), shard, np.int32),
                            cs.astype(np.int32), rows)
                        srv.sync.replica_add(took, shard)
                        srv.sync.stats.add(replicas_created=len(took))
                        if srv.tracer is not None:
                            from ..utils.stats import REPLICA_SETUP
                            srv.tracer.record(took, REPLICA_SETUP, shard)
                    if len(cs) < len(ks):  # cache pool full
                        surplus.append(ks[len(cs):])
                if installed == 0:
                    tm.cancel()  # everything deferred or pool-full
        if surplus:
            # the owner registered our interest for keys we could not host:
            # unsubscribe so they stay relocatable
            self.unsub(np.concatenate(surplus))

    def failover_dead_peer(self, dead: int):
        """Dead-peer failover (net/membership.py drives this exactly
        once per death): promote every LOCAL replica of a key the dead
        rank owned to a main copy via the same replica->owner upgrade
        relocation uses (_adopt — pending sync deltas merge, counters
        bump, addressbook adopts under _topology_mutation). Keys the
        corpse owned with no replica here are LOST: their owner hint
        keeps pointing at the corpse, so reads fail fast with
        NetPeerDeadError instead of hanging. Returns (promoted, lost).

        Lock order: delta locks (channel order) -> server._lock, same
        as every other delta consumer — the beat thread that calls this
        holds nothing else, so the sentinel stays green."""
        srv = self.server
        keys_all = np.arange(srv.num_keys, dtype=np.int64)
        home = self.home_proc(keys_all)
        # believed owned by the corpse: an explicit hint, or unlearned
        # keys whose manager is the corpse (hint still at NOT_CACHED)
        dead_owned = (self.owner_hint == dead) | \
            ((self.owner_hint == NOT_CACHED) & (home == dead))
        promoted = 0
        with srv._lock:
            # stop sync rounds from shipping deltas at the corpse
            self.interest &= ~np.uint64(1 << dead)
            ab = srv.ab
            cand = keys_all[dead_owned & (ab.owner[keys_all] < 0)]
            # shard hosting each candidate's replica (-1 = none = lost)
            rep_shard = np.full(len(cand), -1, np.int32)
            for s in range(srv.num_shards):
                has = (rep_shard < 0) & (ab.cache_slot[s, cand] >= 0)
                rep_shard[has] = s
        for s in range(srv.num_shards):
            keys = cand[rep_shard == s]
            if len(keys) == 0:
                continue
            lens = srv.value_lengths[keys]
            offs = _offsets(lens)
            flat = np.zeros(offs[-1], dtype=np.float32)
            with self.delta_window_for(keys):
                # replica BASE rows under the delta window: an in-flight
                # refresh (which holds these locks across its round
                # trip) can never land between this read and the adopt
                with srv._lock:
                    for cid, pos in srv._group_by_class(keys):
                        ks = keys[pos]
                        cs = ab.cache_slot[s, ks]
                        live = cs >= 0
                        if not live.any():
                            continue
                        rows = srv.stores[cid].read_rows(
                            "cache", np.full(int(live.sum()), s,
                                             np.int32),
                            cs[live].astype(np.int32))
                        _fill_flat(flat, offs, lens, pos[live],
                                   rows.ravel())
                self._adopt(keys, flat, self.reloc[keys] + 1, int(s))
            promoted += len(keys)
        lost = int((rep_shard < 0).sum())
        return promoted, lost

    # -- cross-process sync rounds ------------------------------------------

    def _serve_sync(self, msg):
        """Owner side of a replica refresh: merge shipped deltas into the
        main copies, return fresh values (reference owner branch of
        ProcessSyncMessage, sync_manager.h:553-739). Reply:
        (served u8, vals f32 flat, owners i32)."""
        _, keys, flat, req = msg
        srv = self.server
        keys = np.asarray(keys, dtype=np.int64)
        lens = srv.value_lengths[keys]
        offs = _offsets(lens)
        out = np.zeros(offs[-1], dtype=np.float32)
        owners = np.empty(len(keys), dtype=np.int32)
        with self._stats_lock:
            self.stats["syncs_in"] += len(keys)
        bit = np.uint64(1) << np.uint64(req)
        with srv._lock:
            owned = srv.ab.owner[keys] >= 0
            pos = np.nonzero(owned)[0]
            if len(pos):
                ko = keys[pos]
                srv._apply_remote_write(
                    ko, _select_flat(flat, offs, lens, pos), is_set=False)
                _fill_flat(out, offs, lens, pos, srv._read_owned_flat(ko))
                owners[pos] = self.pid
                self.interest[ko] |= bit  # defensive (e.g. after restore)
        rem = np.nonzero(~owned)[0]
        if len(rem):
            owners[rem] = self._hint_for(keys[rem])
        return owned.astype(np.uint8), out, owners

    def _request_sync(self, keys: np.ndarray,
                      flat: np.ndarray) -> np.ndarray:
        """Ship deltas to owners, return fresh values (synchronous)."""
        lens = self.server.value_lengths[keys]
        offs = _offsets(lens)
        fresh = np.empty(offs[-1], dtype=np.float32)

        def make(ks, pos):
            return ("sync", ks, _select_flat(flat, offs, lens, pos),
                    self.pid)

        def merge(reply, pos):
            served, vals, own = reply[0].astype(bool), reply[1], reply[2]
            sub_lens = lens[pos]
            sub_offs = _offsets(sub_lens)
            spos = np.nonzero(served)[0]
            _fill_flat(fresh, offs, lens, pos[spos],
                       _select_flat(vals, sub_offs, sub_lens, spos))
            return own

        self._drive(keys, make, self._serve_sync, merge, "sync")
        return fresh

    def sync_replicas(self, keys: np.ndarray, shards: np.ndarray) -> None:
        """One cross-process sync round over local replicas of remote keys
        (parallel key / holder-shard arrays): extract pending deltas,
        ship to owners, install fresh bases. Requester side of the
        reference's startSync/response branch (sync_manager.h:291-382,
        740-799)."""
        with self.delta_window_for(np.asarray(keys, np.int64)):
            self._sync_replicas_locked(keys, shards)

    def _extract_deltas(self, keys: np.ndarray, shards: np.ndarray):
        """Snapshot live replica pairs + their pending delta rows; returns
        None when nothing is live, else the state _install_fresh needs."""
        srv = self.server
        karr = np.ascontiguousarray(keys, dtype=np.int64)
        sarr = np.ascontiguousarray(shards, dtype=np.int32)
        class_rows: Dict[int, tuple] = {}
        with srv._lock:
            # skip replicas dropped/upgraded since the caller's snapshot
            # (a -1 slot would wrap in the device gather)
            ok = srv.ab.cache_slot[sarr, karr] >= 0
            karr, sarr = karr[ok], sarr[ok]
            if len(karr) == 0:
                return None
            lens = srv.value_lengths[karr]
            offs = _offsets(lens)
            shipped = np.empty(offs[-1], dtype=np.float32)
            cs_all = srv.ab.cache_slot[sarr, karr].astype(np.int32)
            for cid, pos in srv._group_by_class(karr):
                rows = srv.stores[cid].read_rows("delta", sarr[pos],
                                                 cs_all[pos])
                class_rows[cid] = (pos, rows)
                _fill_flat(shipped, offs, lens, pos, rows.ravel())
        return karr, sarr, cs_all, class_rows, lens, offs, shipped

    def _install_fresh(self, karr, sarr, cs_all, class_rows, lens, offs,
                       fresh) -> None:
        """Install owner-fresh values as the new replica bases, subtracting
        exactly the shipped deltas (refresh_after_sync)."""
        srv = self.server
        with srv._lock:
            ab = srv.ab
            # the refresh replaces replica bases with owner-fresh values:
            # staged prefetch buffers of these keys go stale
            srv._prefetch_note(karr)
            for cid, (pos, rows) in class_rows.items():
                # replicas may have been dropped/upgraded while the round
                # was in flight; refresh only still-live ones
                cs_now = ab.cache_slot[sarr[pos], karr[pos]].astype(np.int32)
                live = cs_now == cs_all[pos]
                if not live.any():
                    continue
                L = srv.class_lengths[cid]
                srv.stores[cid].refresh_after_sync(
                    sarr[pos][live], cs_now[live],
                    _select_flat(fresh, offs, lens,
                                 pos[live]).reshape(-1, L),
                    rows[live])

    def _sync_replicas_locked(self, keys: np.ndarray,
                              shards: np.ndarray) -> None:
        ext = self._extract_deltas(keys, shards)
        if ext is None:
            return
        karr, sarr, cs_all, class_rows, lens, offs, shipped = ext
        fresh = self._request_sync(karr, shipped)
        self._install_fresh(karr, sarr, cs_all, class_rows, lens, offs,
                            fresh)
        with self._stats_lock:
            self.stats["keys_synced_out"] += len(keys)

    def collective_sync(self, keys: np.ndarray, shards: np.ndarray,
                        quiescing: bool = True) -> bool:
        """BSP replica refresh over the collective exchange
        (parallel/collective.py): same contract as sync_replicas, but
        EVERY process must call this together (the WaitSync/quiesce
        protocol, or a --sys.collective_cadence clock boundary) — `keys`
        may be empty and the process still joins each exchange. Enabled
        by --sys.collective_sync. Returns True iff every process entered
        this exchange with quiescing=True (the cadence flag loop's
        termination test, core/sync.py)."""
        assert self.coll is not None, "--sys.collective_sync is off"
        with self.delta_window():
            ext = self._extract_deltas(keys, shards)
            if ext is None:
                empty = np.empty(0, dtype=np.int64)
                _, all_q = self.coll.request_sync(
                    empty, np.empty(0, np.float32), empty,
                    quiescing=quiescing)
                return all_q
            karr, sarr, cs_all, class_rows, lens, offs, shipped = ext
            fresh, all_q = self.coll.request_sync(karr, shipped, lens,
                                                  quiescing=quiescing)
            self._install_fresh(karr, sarr, cs_all, class_rows, lens,
                                offs, fresh)
            with self._stats_lock:
                self.stats["keys_synced_out"] += len(karr)
            return all_q

    def collective_pull(self, keys) -> np.ndarray:
        """BSP pull over the collective exchange. EVERY process must call
        this together (keys MAY be empty); request keys travel to their
        owners with a ZERO delta (the owner-side merge is a no-op) and
        the owners' current values ride the return exchange. Returns the
        flat value buffer for `keys`.

        Contract differences from Worker.pull, by design: values are the
        OWNER's (a local replica's pending delta is not folded in), and
        the owner records requester interest for the pulled keys as it
        does for replica syncs. Requires --sys.collective_sync.

        Ordering rule (every collective_* entry point): synchronous RPC
        data ops (read_main, remote Pull/Push/Set) are separated from
        the NEXT exchange by a Server.barrier(), as in the JAX package,
        so no rank enters an exchange while a peer still waits on its
        RPC reply."""
        assert self.coll is not None, "--sys.collective_sync is off"
        keys = np.asarray(keys, dtype=np.int64)
        lens = self.server.value_lengths[keys] if len(keys) \
            else np.empty(0, dtype=np.int64)
        zeros = np.zeros(int(lens.sum()), dtype=np.float32)
        # the sync manager's _coll_lock serializes ALL of this process's
        # exchange joins (cadence boundaries, quiesce flag loops, these
        # entry points): two local threads in request_sync at once would
        # interleave their exchanges against the peers' single sequence
        with self.server.sync._coll_lock:
            fresh, _ = self.coll.request_sync(keys, zeros, lens,
                                              quiescing=False)
        return fresh

    def collective_push(self, keys, vals) -> None:
        """BSP additive push over the collective exchange: the delta rows
        travel to their owners and merge there — the owner-side apply of
        a remote Push, with the transport swapped. Same collective
        contract as collective_pull (every process joins; keys MAY be
        empty)."""
        assert self.coll is not None, "--sys.collective_sync is off"
        keys = np.asarray(keys, dtype=np.int64)
        lens = self.server.value_lengths[keys] if len(keys) \
            else np.empty(0, dtype=np.int64)
        flat = np.ascontiguousarray(vals, dtype=np.float32).ravel()
        assert flat.size == int(lens.sum()), \
            f"vals size {flat.size} != keys' total length {lens.sum()}"
        with self.server.sync._coll_lock:  # see collective_pull
            self.coll.request_sync(keys, flat, lens, quiescing=False)

    def drop_replicas(self, keys: np.ndarray, shards: np.ndarray) -> None:
        """Drop local replicas of remote-owned keys (parallel key /
        holder-shard arrays): ship the final delta with the
        unsubscription, then free the slots. Any pushes that land
        between extraction and the free are re-shipped as plain remote
        pushes, so no update is ever lost."""
        with self.delta_window_for(np.asarray(keys, np.int64)):
            self._drop_replicas_locked(keys, shards)

    def _drop_replicas_locked(self, keys: np.ndarray,
                              shards: np.ndarray) -> None:
        srv = self.server
        karr = np.ascontiguousarray(keys, dtype=np.int64)
        sarr = np.ascontiguousarray(shards, dtype=np.int32)
        req_k, req_s = karr, sarr  # the full request (channel discard)
        class_rows: Dict[int, tuple] = {}
        with srv._lock:
            ok = srv.ab.cache_slot[sarr, karr] >= 0
            karr, sarr = karr[ok], sarr[ok]
            if len(karr) == 0:
                return
            lens = srv.value_lengths[karr]
            offs = _offsets(lens)
            shipped = np.empty(offs[-1], dtype=np.float32)
            cs_all = srv.ab.cache_slot[sarr, karr].astype(np.int32)
            for cid, pos in srv._group_by_class(karr):
                rows = srv.stores[cid].read_rows("delta", sarr[pos],
                                                 cs_all[pos])
                class_rows[cid] = (pos, rows)
                _fill_flat(shipped, offs, lens, pos, rows.ravel())
        self.unsub(karr, shipped)
        residue_keys: List[np.ndarray] = []
        residue_flat: List[np.ndarray] = []
        with srv._lock, srv._topology_mutation() as tm:
            dropped_any = False
            ab = srv.ab
            for cid, (pos, rows) in class_rows.items():
                # only replicas whose slot is unchanged since extraction:
                # a concurrent drop/upgrade (e.g. a Set invalidation)
                # already accounted for its own delta
                cs_now = ab.cache_slot[sarr[pos], karr[pos]].astype(np.int32)
                live = cs_now == cs_all[pos]
                pos, rows = pos[live], rows[live]
                if len(pos) == 0:
                    continue
                now = srv.stores[cid].read_rows("delta", sarr[pos],
                                                cs_all[pos])
                rem = now - rows
                nz = np.abs(rem).max(axis=1) > 0
                if nz.any():
                    residue_keys.append(karr[pos][nz])
                    residue_flat.append(rem[nz].ravel())
                for s in np.unique(sarr[pos]):
                    m = sarr[pos] == s
                    ab.drop_replicas(karr[pos][m], int(s))
                    dropped_any = True
                    if srv.tracer is not None:
                        from ..utils.stats import REPLICA_DROP
                        srv.tracer.record(karr[pos][m], REPLICA_DROP,
                                          int(s))
            srv.sync.replica_discard(req_k, req_s)
            if not dropped_any:
                tm.cancel()  # every replica was already dropped/upgraded
        if residue_keys:
            self.request_write(np.concatenate(residue_keys),
                               np.concatenate(residue_flat), is_set=False)

    def unsub(self, keys: np.ndarray,
              flat: Optional[np.ndarray] = None) -> None:
        """Tell owners this process no longer holds replicas of `keys`
        (optionally shipping final deltas)."""
        lens = self.server.value_lengths[keys]
        offs = _offsets(lens)
        if flat is None:
            flat = np.zeros(offs[-1], dtype=np.float32)

        def make(ks, pos):
            return ("unsub", ks, _select_flat(flat, offs, lens, pos),
                    self.pid)

        self._drive(keys, make, self._serve_unsub,
                    lambda reply, pos: reply[1], "unsub")

    def unsub_async(self, keys: np.ndarray,
                    after: Sequence[Future] = ()) -> Future:
        keys = keys.copy()
        after = list(after)

        def task():
            for f in after:
                f.result()
            self.unsub(keys)

        return self._exec_w.submit(task)

    def _serve_unsub(self, msg):
        """Reply: (served u8, owners i32)."""
        _, keys, flat, req = msg
        srv = self.server
        keys = np.asarray(keys, dtype=np.int64)
        lens = srv.value_lengths[keys]
        offs = _offsets(lens)
        owners = np.empty(len(keys), dtype=np.int32)
        bit = np.uint64(1) << np.uint64(req)
        with srv._lock:
            owned = srv.ab.owner[keys] >= 0
            pos = np.nonzero(owned)[0]
            if len(pos):
                ko = keys[pos]
                part = _select_flat(flat, offs, lens, pos)
                if len(part) and np.abs(part).max() > 0:
                    srv._apply_remote_write(ko, part, is_set=False)
                self.interest[ko] &= ~bit
                owners[pos] = self.pid
        rem = np.nonzero(~owned)[0]
        if len(rem):
            owners[rem] = self._hint_for(keys[rem])
        return owned.astype(np.uint8), owners

    # -- manager metadata ----------------------------------------------------

    def _serve_owner_update(self, msg):
        """Manager side: record an ownership transfer, rejecting stale
        updates by relocation counter (reference addressbook.h:92-102)."""
        _, keys, new_owner, counters = msg
        keys = np.asarray(keys, dtype=np.int64)
        assert (self.home_proc(keys) == self.pid).all(), \
            "owner_update sent to a non-manager"
        with self.server._lock:
            newer = counters > self.reloc[keys]
            ks = keys[newer]
            self.owner_hint[ks] = new_owner
            self.reloc[ks] = counters[newer]
        self._c_ou_acc.inc(int(newer.sum()))
        self._c_ou_stale.inc(int(len(keys) - newer.sum()))
        return ("ok",)

    # -- lifecycle -----------------------------------------------------------

    def report(self) -> str:
        s = self.stats
        h = self.hops
        return (f"pm: pulls_in={s['pulls_in']} pushes_in={s['pushes_in']} "
                f"redirects={s['redirects']} intents_in={s['intents_in']} "
                f"reloc_out={s['relocations_out']} "
                f"reloc_in={s['relocations_in']} "
                f"rep_granted={s['replicas_granted']} "
                f"synced_out={s['keys_synced_out']} "
                f"hops(1/2/3+)={h[0]}/{h[1]}/{h[2]}")

    def shutdown(self) -> None:
        # Three-step leave-together protocol:
        # 1. pre-down barrier: every rank's planner (sync thread) is
        #    stopped before Server.shutdown reaches here, and a peer's
        #    in-flight request completes before that peer can enter the
        #    barrier — so afterwards no NEW inbound work (and no handler
        #    submits to our executors) can appear.
        # 2. drain our own outbound executors: peers still serve, their
        #    channels stay open until step 3.
        # 3. down barrier, then close the channel.
        # Step 0 (loopback): announce a graceful leave FIRST, so peers'
        # membership planes mark this rank `left` — its beats stopping
        # during teardown must never read as a death (no-op on DCN).
        self.node.pre_down()
        self.node.barrier("pm-pre-down")
        self._exec_r.shutdown(wait=True)
        self._exec_w.shutdown(wait=True)
        self._exec_fan.shutdown(wait=True)
        if self.coll is not None:
            # every rank is past its last exchange: unmap, meet, free
            self.coll.close()
        self.node.barrier("pm-down")
        self.chan.shutdown()
