"""BSP cross-process sync data plane over the collective exchange (the
JAX package's `parallel/collective.py`).

The default cross-process transport (parallel/dcn.py) is host TCP — the
reference's ZMQ van as data plane (include/zmq_van.h:124-220). This
module carries the SYNC traffic on the device instead (SURVEY.md:
"sync-manager traffic -> asynchronous ICI collectives"): every process
contributes its outgoing replica-delta rows to an all-to-all, owners
merge (K3) and re-gather (K1), and the fresh values ride the return
exchange. The exchange is parallel/exchange.py SlabExchange, built by
`device/torchport.py compile_collective`: on the card one K13 launch
puts every destination's bucket HBM to HBM into the peers' receive
slabs through CUDA IPC; on the CPU the same put protocol runs over
shared memory.

Execution model: the exchange is SPMD — every process must enter the
same exchange the same number of times. The PM's asynchronous
per-request traffic (pull/push misses, intent decisions, replica drops)
therefore stays on the DCN channel, and the BULK flow — replica delta
ship + fresh-value refresh — runs as bulk-synchronous rounds at the
points the API already requires every process to reach together:
WaitSync and quiesce (the WaitSync -> Barrier -> WaitSync protocol),
and each --sys.collective_cadence clock boundary. Enable with
--sys.collective_sync; --sys.collective_bucket fixes the round geometry
(rows per peer per exchange).

Within a round the item count per destination varies per process; the
loop iterates while the GLOBAL backlog (control.allreduce, itself a
collective every process calls) is nonzero, so all processes run
identical iteration counts with padded buckets where they have nothing
to send.
"""
from __future__ import annotations

import threading
import time
from typing import List, Tuple

import numpy as np

from . import control

NO_KEY = np.int64(-1)  # bucket padding
MAX_ROUNDS = 64        # tries an item may take, mirrors pm.MAX_TRIES


class _JoinWatchdog:
    """Logs while a process sits at a collective join point.

    The collective contract is stricter than the reference's WaitSync —
    EVERY process must reach the exchange together — so a unilateral
    Server.wait_sync() on one rank only blocks forever here. With this,
    the stuck rank says what it is waiting for every `warn_after`
    seconds instead of hanging bare."""

    def __init__(self, pid: int, what: str, warn_after: float = 20.0):
        self._msg = (f"pm{pid}: collective sync point ({what}): still "
                     f"waiting for peers after %.0fs — with "
                     f"--sys.collective_sync EVERY process must reach "
                     f"WaitSync/quiesce together; an asymmetric "
                     f"wait_sync hangs here")
        self._warn_after = warn_after
        self._stop = threading.Event()
        # a liveness watchdog for an exchange that may be stuck waiting
        # on peers: it must report even when every executor worker is
        # parked inside that exchange
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="adapm-coll-watchdog")

    def _run(self):
        from ..utils.log import alog
        t0 = time.monotonic()
        while not self._stop.wait(self._warn_after):
            alog(self._msg % (time.monotonic() - t0))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        return False


class CollectiveSync:
    """The exchange engine: one exchange over the process list, its
    receive slabs made per leaf layout at first use."""

    def __init__(self, pm, bucket: int):
        from ..device import default_port
        from .mesh import process_mesh
        self.pm = pm
        self.bucket = int(bucket)
        self._P = P = pm.num_procs
        mesh = process_mesh(pm.pid, P, pm.server.ctx.device)
        self._xchg = default_port().compile_collective(
            "all_to_all", mesh, in_specs=mesh.axis, out_specs=mesh.axis)
        self._first_exchange = True
        self.stats = {"rounds": 0, "iterations": 0, "rows_out": 0,
                      "rows_in": 0}
        # obs: wall time of each exchange (upload + put + barrier +
        # readback) — the wait the BSP sync path spends per iteration
        self._h_xchg = pm.server.obs.histogram("collective.exchange_s")

    @property
    def bytes_put(self) -> int:
        return self._xchg.bytes_put

    def close(self) -> None:
        """Release the receive slabs (collective: every process closes
        together, at GlobalPM shutdown)."""
        self._xchg.close()

    # -- the exchange primitive ---------------------------------------------

    def exchange(self, local_tree):
        """All-to-all a tuple of [P, B, ...] buffers (leaf[d] = payload
        for process d). Returns same-shaped leaves with leaf[s] = payload
        process s sent here. EVERY process must call this together."""
        from ..obs.metrics import timed
        with timed(self._h_xchg):
            return tuple(self._xchg(list(local_tree)))

    # -- the sync protocol --------------------------------------------------

    def request_sync(self, karr: np.ndarray, flat: np.ndarray,
                     lens: np.ndarray,
                     quiescing: bool = True) -> Tuple[np.ndarray, bool]:
        """BSP twin of GlobalPM._request_sync: ship delta rows to owners,
        return `(fresh values for every key, all_quiescing)`. `karr` MAY
        be empty — the process still joins every exchange iteration
        (collective contract). Iterates per length class in globally
        agreed order.

        `quiescing` rides the up-front allreduce: True when this process
        is at a WaitSync/quiesce point, False for a cadence exchange
        (--sys.collective_cadence). `all_quiescing` tells a waiting
        process whether every peer has reached its wait point — the
        termination test of the quiesce-time flag loop that absorbs
        skewed per-process cadence counts (core/sync.py)."""
        pm = self.pm
        from .pm import _offsets
        offs = _offsets(lens)
        fresh = np.empty(offs[-1], dtype=np.float32)
        self.stats["rounds"] += 1
        with pm.server._span("collective.bsp_round"), \
                _JoinWatchdog(pm.pid, "request_sync"):
            if self._first_exchange:
                # align ranks before the first exchange (its slabs are
                # made and traded there); inside the watchdog: an
                # asymmetric first join must log, not hang bare
                control.barrier("adapm-coll-init")
                self._first_exchange = False
            return self._request_sync_inner(karr, flat, lens, offs, fresh,
                                            quiescing)

    def _request_sync_inner(self, karr, flat, lens, offs, fresh,
                            quiescing):
        pm = self.pm
        from .pm import _select_flat
        # one up-front allreduce of per-class counts (+ the quiescing
        # flag in the last slot): classes nobody has items for are
        # skipped entirely (a WaitSync point with nothing to ship costs
        # one tiny collective, not 2 exchanges per class)
        ncls = len(pm.server.class_lengths)
        my_counts = np.zeros(ncls + 1, dtype=np.float64)
        cls_pos = []
        for cid in range(ncls):
            pos = np.nonzero(pm.server.ab.key_class[karr] == cid)[0] \
                if len(karr) else np.empty(0, dtype=np.int64)
            cls_pos.append(pos)
            my_counts[cid] = len(pos)
        my_counts[ncls] = 1.0 if quiescing else 0.0
        # own collective site: the exchange may be driven from a sync
        # thread while the app thread runs its own "ar"-site allreduces
        # — distinct sites pair independently per rank
        global_counts = control.allreduce(my_counts, "sum",
                                          site="coll-counts")
        all_quiescing = bool(global_counts[ncls] >= self._P)
        for cid, L in enumerate(pm.server.class_lengths):
            if global_counts[cid] == 0:
                continue
            pos = cls_pos[cid]
            rows = _select_flat(flat, offs, lens, pos).reshape(-1, L)
            self._class_loop(cid, L, karr[pos] if len(karr) else
                             np.empty(0, np.int64), rows, pos, fresh,
                             offs, lens)
        return fresh, all_quiescing

    def _class_loop(self, cid: int, L: int, keys: np.ndarray,
                    rows: np.ndarray, pos: np.ndarray, fresh: np.ndarray,
                    offs: np.ndarray, lens: np.ndarray) -> None:
        """One class's bucket loop. keys/rows are this process's items
        (possibly empty); pos maps them into the caller's flat layout."""
        pm = self.pm
        from .pm import _fill_flat
        P, B = self._P, self.bucket

        def install(sel: np.ndarray, vals: np.ndarray,
                    owners: np.ndarray) -> None:
            _fill_flat(fresh, offs, lens, pos[sel], vals.ravel())
            pm._learn(keys[sel], owners)

        pend = np.arange(len(keys), dtype=np.int64)
        # tries per item (sent, or served inline, and not served): the
        # convergence bound is per item, as the RPC retry loop's MAX_TRIES
        # is. A bound on the loop's iterations (the JAX package's) would
        # also stop a backlog that merely needs more than MAX_ROUNDS
        # buckets to drain while every iteration makes progress.
        tries = np.zeros(len(keys), dtype=np.int64)
        it = 0
        # per-item destination override from redirect hints (kept OFF
        # the shared location caches, which _learn updates under its
        # own --sys.location_caches gate)
        redirect = np.full(len(keys), -1, dtype=np.int64)

        def route(p):
            if not len(p):
                return np.empty(0, dtype=np.int64)
            d = pm._route_dest(keys[p])
            return np.where(redirect[p] >= 0, redirect[p], d)

        while True:
            # items routed to SELF serve inline (a key may have been
            # adopted locally since it was classified remote)
            dest = route(pend)
            own = dest == pm.pid
            if own.any():
                mine = pend[own]
                reply = pm._serve_sync(
                    ("sync", keys[mine], rows[mine].ravel(), pm.pid))
                served = reply[0].astype(bool)
                vals = np.asarray(reply[1], np.float32).reshape(-1, L)
                if served.any():
                    install(mine[served], vals[served],
                            np.asarray(reply[2])[served])
                # unserved self-routed items retry (hint or manager next)
                bad = mine[~served]
                tries[bad] += 1
                if len(bad):
                    hints = np.asarray(reply[2])[~served]
                    redirect[bad] = np.where(
                        hints >= 0, hints, pm.home_proc(keys[bad]))
                pend = np.concatenate([pend[~own], bad])
                dest = route(pend)
            # fill outgoing buckets (up to B per destination); the rest
            # stays pending for the next iteration
            out_k = np.full((P, B), NO_KEY, dtype=np.int64)
            out_r = np.zeros((P, B, L), dtype=np.float32)
            sent: List[np.ndarray] = [np.empty(0, np.int64)
                                      for _ in range(P)]
            taken = np.zeros(len(pend), dtype=bool)
            for d in range(P):
                if d == pm.pid:
                    continue
                where = np.nonzero(dest == d)[0][:B]
                sel = pend[where]
                sent[d] = sel
                taken[where] = True
                out_k[d, : len(sel)] = keys[sel]
                out_r[d, : len(sel)] = rows[sel]
            self.stats["rows_out"] += int(taken.sum())
            # X1: deltas travel to their owners
            in_k, in_r = self.exchange((out_k, out_r))
            # owner side: serve each source's bucket like a sync message
            rep_served = np.zeros((P, B), dtype=np.int32)
            rep_vals = np.zeros((P, B, L), dtype=np.float32)
            rep_own = np.full((P, B), -1, dtype=np.int32)
            for src in range(P):
                if src == pm.pid:
                    continue
                n = int((in_k[src] >= 0).sum())  # valid prefix (packed)
                if n == 0:
                    continue
                self.stats["rows_in"] += n
                reply = pm._serve_sync(
                    ("sync", in_k[src, :n], in_r[src, :n].ravel(), src))
                rep_served[src, :n] = reply[0].astype(np.int32)
                rep_vals[src, :n] = np.asarray(
                    reply[1], np.float32).reshape(n, L)
                rep_own[src, :n] = reply[2]
            # X2: replies ride back
            r_served, r_vals, r_own = self.exchange(
                (rep_served, rep_vals, rep_own))
            # requester side: install fresh values; unserved keys learn
            # the redirect hint and retry (the _drive retry loop,
            # BSP-shaped)
            still: List[np.ndarray] = [pend[~taken]]
            for d in range(P):
                sel = sent[d]
                if len(sel) == 0:
                    continue
                m = r_served[d, : len(sel)].astype(bool)
                if m.any():
                    install(sel[m], r_vals[d, : len(sel)][m],
                            r_own[d, : len(sel)][m])
                if (~m).any():
                    bad = sel[~m]
                    tries[bad] += 1
                    hints = r_own[d, : len(sel)][~m]
                    redirect[bad] = np.where(
                        hints >= 0, hints, pm.home_proc(keys[bad]))
                    still.append(bad)
            pend = np.concatenate(still)
            self.stats["iterations"] += 1
            it += 1
            if it > 4 and len(pend):
                time.sleep(0.002)  # give in-flight adoptions time to land
            # globally agreed termination: every process sees the same
            # sums (the backlog, and the items past their try budget)
            stuck = int((tries[pend] > MAX_ROUNDS).sum()) if len(pend) \
                else 0
            backlog, stuck_all = control.allreduce(
                [float(len(pend)), float(stuck)], "sum",
                site="coll-backlog")
            if backlog == 0.0:
                return
            if stuck_all > 0:
                # the RPC retry loop's convergence bound (_drive's
                # MAX_TRIES): the global count is identical on all
                # processes, so everyone raises together instead of
                # livelocking the exchange loop
                bad = pend[tries[pend] > MAX_ROUNDS]
                raise RuntimeError(
                    f"collective sync: ownership metadata did not "
                    f"converge after {it} rounds ({int(stuck_all)} items "
                    f"past {MAX_ROUNDS} tries, global backlog "
                    f"{int(backlog)}, e.g. keys {keys[bad[:5]].tolist()})")
