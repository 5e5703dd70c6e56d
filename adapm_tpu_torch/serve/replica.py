"""Read-only serve replica: the serving plane's lock-free hot-row fast
path (the port of the JAX package's `serve/replica.py`).

Every locked serve lookup gathers under the same server lock that
training pushes and sync rounds take. This module keeps an
**epoch-versioned snapshot** of the hottest rows: a lookup whose union
the snapshot fully covers is served from it WITHOUT the server lock;
anything else falls back to the locked path.

Why the lock-free read is bit-identical to `Worker.pull` at the same
dispatch point:

  - the snapshot holds only locally-owned keys with zero replicas
    anywhere (`ab.replica_count == 0`): a thresholded sync round merges
    deltas into replica-holding owner rows without an epoch bump, and
    replica creation, drop and relocation all bump `topology_version`;
  - at refresh time, under the server lock, the rows' write epochs
    (`ShardedStore.export_epochs`) and `topology_version` are recorded
    before the K1 gather that fills the snapshot is enqueued;
  - at serve time the lookup revalidates, lock-free: `topology_version`
    unchanged AND every covered row's epoch still equal to the recorded
    one (`epochs_unchanged`). Every write path bumps its rows' epochs
    under the lock BEFORE it enqueues its program, so a push, set, sync
    or relocation that completed before the lookup is always seen
    (read-your-writes).

A failed validation is a fallback, never an error: the batcher takes
the locked path and the replica queues a coalesced refresh on the
executor's `serve_refresh` stream (throttled by
`--sys.serve.replica_refresh_ms`). The snapshot is one K1 gather per
length class, copied to the host once per refresh; a hit then costs one
numpy fancy-index, no device work and no lock. Rows are chosen by the
replica's own per-key serve-load counters, halved about once a second.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

import numpy as np


class _Snapshot:
    """One immutable refresh result. `keys` sorted; parallel arrays map
    each key to its length class, row in that class's value matrix, and
    the (shard, slot, epoch) triple the validation re-checks."""

    __slots__ = ("keys", "cid", "row", "o_sh", "o_sl", "epochs", "vals",
                 "dev", "topo", "t_enqueued", "version")

    def __init__(self, keys, cid, row, o_sh, o_sl, epochs, vals, dev,
                 topo, t_enqueued, version):
        self.keys = keys
        self.cid = cid
        self.row = row
        self.o_sh = o_sh
        self.o_sl = o_sl
        self.epochs = epochs
        self.vals = vals          # host mirrors, one [n, L] per class
        self.dev = dev            # the gather outputs on the card
        self.topo = topo
        self.t_enqueued = t_enqueued
        self.version = version


class ServeReplica:
    """Owned by a ServePlane when `--sys.serve.replica_rows > 0`; the
    LookupBatcher consults it per union batch (see module docstring)."""

    def __init__(self, server, opts, registry=None):
        self.server = server
        self.rows = int(opts.serve_replica_rows)
        self.refresh_s = float(opts.serve_replica_refresh_ms) * 1e-3
        # per-key serve-load score (bumped lock-free per union batch,
        # halved each refresh — the same decayed-counter CLOCK variant
        # the tier plane uses)
        self._score = np.zeros(server.num_keys, dtype=np.int64)
        self._snap: Optional[_Snapshot] = None
        self._version = 0
        self._closed = False
        # serializes refresh bodies (the coalesced executor stream
        # already does; this guards direct refresh_now() callers too)
        self._refresh_lock = threading.Lock()
        # wall time of the last score decay: halving is TIME-based
        # (~1 Hz), never per-refresh — under load the refresh throttle
        # fires every refresh_s, and halving that often would collapse
        # every score to 0/1 and churn the selection into noise
        self._last_decay = time.monotonic()
        from ..obs.metrics import Counter
        reg = registry
        if reg is not None and reg.enabled:
            self.c_refreshes = reg.counter("serve.replica_refreshes_total",
                                           shared=True)
            self.c_stale = reg.counter(
                "serve.replica_stale_fallbacks_total", shared=True)
            reg.gauge("serve.replica_rows", shared=True,
                      fn=lambda: 0 if self._snap is None
                      else len(self._snap.keys))
        else:
            self.c_refreshes = Counter("serve.replica_refreshes_total")
            self.c_stale = Counter("serve.replica_stale_fallbacks_total")

    # -- the lock-free fast path ---------------------------------------------

    def try_serve(self, union: np.ndarray) \
            -> Optional[Tuple[np.ndarray, float]]:
        """Serve the (unique, sorted) union from the snapshot if fully
        covered and still valid; returns (flat values, the snapshot's
        under-lock enqueue stamp — the freshness probe's read-order
        cutoff) or None (caller takes the exact locked path). Bumps the
        serve-load scores either way and queues a throttled refresh on
        a miss. NEVER takes the server lock."""
        np.add.at(self._score, union, 1)
        snap = self._snap
        srv = self.server
        if snap is None or len(snap.keys) == 0:
            self.kick()
            return None
        if srv.topology_version != snap.topo:
            # placement moved (relocation / replica churn / adoption):
            # the owner-coordinate and replica-free facts are stale
            self.c_stale.inc()
            self.kick()
            return None
        pos = np.searchsorted(snap.keys, union)
        pos[pos >= len(snap.keys)] = 0
        if not np.array_equal(snap.keys[pos], union):
            self.kick()  # partial coverage: all-or-nothing fallback
            return None
        # read-your-writes / staleness guard: every covered row's main
        # epoch must still equal the snapshot-time export
        if len(srv.stores) == 1:
            if not srv.stores[0].epochs_unchanged(
                    snap.o_sh[pos], snap.o_sl[pos], snap.epochs[pos]):
                self.c_stale.inc()
                self.kick()
                return None
        else:
            cids = snap.cid[pos]
            for cid in np.unique(cids):
                m = cids == cid
                if not srv.stores[cid].epochs_unchanged(
                        snap.o_sh[pos[m]], snap.o_sl[pos[m]],
                        snap.epochs[pos[m]]):
                    self.c_stale.inc()
                    self.kick()
                    return None
        # assemble the flat union result from the host mirror (same
        # bits the locked gather would return — pinned by the storm)
        if len(srv.stores) == 1:
            flat = np.ascontiguousarray(
                snap.vals[0][snap.row[pos]]).ravel()
        else:
            from ..core.kv import _fill_flat, _offsets
            lens = srv.value_lengths[union]
            offs = _offsets(lens)
            flat = np.empty(offs[-1], dtype=np.float32)
            cids = snap.cid[pos]
            for cid in np.unique(cids):
                m = np.nonzero(cids == cid)[0]
                _fill_flat(flat, offs, lens, m,
                           snap.vals[cid][snap.row[pos[m]]].ravel())
        return flat, snap.t_enqueued

    # -- refresh -------------------------------------------------------------

    def kick(self) -> None:
        """Queue one coalesced refresh program on the `serve_refresh`
        stream, at most one per refresh interval (the coalesce key
        absorbs kick storms; the delay is the throttle)."""
        if self._closed:
            return
        self.server.exec.submit("serve_refresh", self._refresh,
                                label="serve.replica.refresh",
                                coalesce_key="serve.replica.refresh",
                                delay=self.refresh_s)

    def refresh_now(self) -> int:
        """Synchronous refresh (tests / the guard scripts: snapshot
        coverage without thread timing). Returns rows snapshotted."""
        self._refresh()
        snap = self._snap
        return 0 if snap is None else len(snap.keys)

    def _select(self) -> np.ndarray:
        """Top-`rows` keys by serve-load score (fused with the tier
        plane's residency scores where one exists; host, lock-free).
        Decays the serve counters
        about once a second so the hot set tracks shifting traffic
        without collapsing under a fast refresh cadence."""
        srv = self.server
        score = self._score
        if srv.tier is not None:
            score = score + srv.tier.export_serve_scores()
        else:
            score = score.copy()
        now = time.monotonic()
        if now - self._last_decay >= 1.0:
            self._last_decay = now
            self._score >>= 1
        live = int(np.count_nonzero(score))
        k = min(self.rows, live)
        if k == 0:
            return np.empty(0, dtype=np.int64)
        cand = np.argpartition(score, -k)[-k:]
        cand = cand[score[cand] > 0]
        cand.sort()
        return cand.astype(np.int64)

    def _refresh(self) -> None:
        """One snapshot rebuild: select candidates, then under the
        server lock filter to owned replica-free keys, record epochs +
        topology_version, and enqueue one device gather per length
        class; materialize the host mirror outside the lock and swap
        the snapshot reference atomically."""
        if self._closed:
            return
        with self._refresh_lock:
            self._refresh_locked()

    def _refresh_locked(self) -> None:
        from ..core.store import OOB
        srv = self.server
        cand = self._select()
        if len(cand) == 0:
            return
        per_class: List = []
        with srv._lock:
            ab = srv.ab
            # replica-free, locally-owned keys only (module docstring:
            # thresholded syncs merge into replica-holding owner rows
            # without an epoch bump; replica churn bumps
            # topology_version, keeping this filter sound between
            # refreshes)
            ok = (ab.owner[cand] >= 0) & (ab.replica_count[cand] == 0)
            keys = cand[ok]
            if len(keys) == 0:
                return
            topo = srv.topology_version
            kcid = np.zeros(len(keys), dtype=np.int32)
            krow = np.zeros(len(keys), dtype=np.int32)
            o_sh = np.zeros(len(keys), dtype=np.int32)
            o_sl = np.zeros(len(keys), dtype=np.int32)
            epochs = np.zeros(len(keys), dtype=np.int64)
            for cid, pos in srv._group_by_class(keys):
                ks = keys[pos]
                st = srv.stores[cid]
                sh = ab.owner[ks].astype(np.int32)
                sl = ab.slot[ks].astype(np.int32)
                kcid[pos] = cid
                krow[pos] = np.arange(len(ks), dtype=np.int32)
                o_sh[pos], o_sl[pos] = sh, sl
                # epochs recorded BEFORE the gather enqueue, both under
                # the lock: any write enqueued earlier has already
                # bumped its cell (and the gather reads its value); any
                # later write bumps after, failing validation
                epochs[pos] = st.export_epochs(sh, sl)
                n = len(ks)
                dev = st.gather(sh, sl, np.zeros(n, np.int32),
                                np.full(n, OOB, np.int32),
                                np.zeros(n, bool))
                per_class.append((cid, pos, dev, n))
            t_enqueued = time.perf_counter()
        # device -> host mirror outside the lock (the gather output is
        # a fresh tensor; blocking here stalls only the refresh stream,
        # never a client)
        nclasses = len(srv.stores)
        vals: List = [None] * nclasses
        devs: List = [None] * nclasses
        for cid, pos, dev, n in per_class:
            vals[cid] = dev[:n].cpu().numpy()
            devs[cid] = dev
        self._version += 1
        self._snap = _Snapshot(keys, kcid, krow, o_sh, o_sl, epochs,
                               vals, devs, topo, t_enqueued,
                               self._version)
        self.c_refreshes.inc()

    # -- lifecycle -----------------------------------------------------------

    @property
    def version(self) -> int:
        return self._version

    def close(self) -> None:
        """Stop refreshing and drain the `serve_refresh` stream (a
        queued refresh sees `_closed` and exits; a RUNNING one reads
        through the pools, so teardown must wait for it). Idempotent."""
        self._closed = True
        ex = self.server.exec
        if not ex.closed and not ex.drain("serve_refresh", timeout=30):
            from ..utils import alog
            alog("[serve] replica refresh failed to drain within 30s — "
                 "wedged mid-gather")
            raise RuntimeError(
                "serve replica refresh wedged: did not drain within "
                "30s of close; refusing to proceed into pool teardown "
                "under a live reader")
        self._snap = None
