"""Client-facing serving API: `ServeSession.lookup(keys, deadline_ms)`
and `ServeSession.lookup_bags(tables, bags, pooling)` (the port of the
JAX package's `serve/session.py`).

A session is a lightweight per-client handle onto a ServePlane, one per
client thread, as a `Worker` is. `lookup` submits into the admission
queue (raising `ServeOverloadError` under backpressure) and blocks until
the coalescing dispatcher delivers the values or the deadline sheds the
request.

Tenancy: a session made with `tenant=` (a name) and optionally
`priority=` stamps every lookup with that tenant's admission state: its
token bucket gates submit, its priority class decides who sheds first
under pressure and whom the batch budget favours (serve/admission.py).
A session naming an unconfigured tenant gets an unthrottled priority-0
default; with no tenant a request is untenanted priority 0.

Read-your-writes: in one process nothing is needed. A push lands its
device program under the server lock before the lookup's gather is
dispatched, and dispatch order serializes programs on the pools.

Deadlines are checked at dispatcher take time (an expired queued
request is shed with `DeadlineExceededError`) and while the client
waits (on timeout the client sheds the request itself if no micro-batch
claimed it yet). A request already CLAIMED completes and returns its
values; a dispatcher that cannot deliver a claimed request within
`_CLAIMED_GRACE_S` is wedged and the lookup raises instead of hanging.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .admission import (DeadlineExceededError, LookupRequest,
                        ServeDegradedError)

# bounded grace for a CLAIMED request's in-flight delivery: a device
# gather is milliseconds; a dispatcher that cannot deliver within this
# is wedged and the lookup fail-stops instead of hanging
_CLAIMED_GRACE_S = 30.0


class ServeSession:
    """One client's handle; obtained from `ServePlane.session()`."""

    def __init__(self, plane, worker=None, tenant=None, priority=None):
        self.plane = plane
        self.server = plane.server
        self.worker = worker
        self.tenant = plane.queue.tenant(tenant) \
            if tenant is not None else None
        # explicit priority overrides the tenant's class; None defers
        # to the tenant's CURRENT priority at each lookup, so a live
        # configure_tenant() re-class reaches existing sessions
        # (untenanted default: 0, the pre-tenancy behavior)
        self._priority = None if priority is None else int(priority)

    @property
    def priority(self) -> int:
        if self._priority is not None:
            return self._priority
        return self.tenant.priority if self.tenant is not None else 0

    def lookup(self, keys, deadline_ms: Optional[float] = None,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """Coalesced, snapshot-consistent read of `keys` (any shape;
        duplicates allowed — values come back per input position).
        Returns [B, L] when the batch is uniform-length, else the flat
        per-key concat (the `Worker.pull_sync` shapes). `deadline_ms`
        defaults to `--sys.serve.deadline_ms` (0 = no deadline).

        Raises `ServeOverloadError` (queue full — backpressure),
        `DeadlineExceededError` (shed), `ServeDegradedError` (the
        server is restoring/degraded — retry once readiness recovers),
        or `RuntimeError` (plane closed / dispatcher wedged). Never
        hangs."""
        keys = np.ascontiguousarray(
            np.asarray(keys, dtype=np.int64).ravel())
        srv = self.server
        if len(keys) == 0:
            return np.empty(0, dtype=np.float32)
        # validate at the session boundary: an out-of-range key must
        # fail ITS client loudly, not poison the co-batched requests of
        # other clients inside the dispatcher
        from ..base import check_key_range
        check_key_range(keys, srv.num_keys)
        # degraded window (Server.begin_degraded): shed at the door with
        # the distinct error, before the request touches the queue
        reason = srv._degraded_reason
        if reason is not None:
            self.plane.queue.c_degraded.inc()
            raise ServeDegradedError(
                f"serve degraded: {reason} — lookup shed (retry once "
                f"readiness recovers)")
        lens = srv.value_lengths[keys]
        if deadline_ms is None:
            deadline_ms = self.plane.opts.serve_deadline_ms
        wt = srv.wtrace  # workload trace capture (keys, tenant,
        # priority, deadline)
        if wt is not None:
            wt.record_serve(
                keys,
                self.tenant.name if self.tenant is not None else None,
                self.priority, deadline_ms or 0.0)
        deadline_s = None if not deadline_ms else deadline_ms * 1e-3
        after = ()
        if self.worker is not None and srv.glob is not None:
            after = tuple(self.worker._live_write_futs())
        # request-flight tracing: the per-request trace id is minted
        # here, rides the queue entry and closes at reply time
        fl = srv.flight
        tr = fl.mint() if fl is not None else None
        req = LookupRequest(keys, after=after, deadline_s=deadline_s,
                            trace=tr, tenant=self.tenant,
                            priority=self.priority,
                            lane=self.plane.batcher.assign_lane(keys))
        flat = self._submit_and_wait(req, deadline_s, deadline_ms,
                                     fl, tr)
        if out is not None:
            # reshape(-1) on a non-contiguous view would COPY and the
            # caller's buffer would silently stay unfilled; a too-small
            # buffer would fail with an opaque broadcast error
            if not out.flags["C_CONTIGUOUS"]:
                raise ValueError(
                    "lookup out= buffer must be C-contiguous (got a "
                    "strided view; pass np.ascontiguousarray(out))")
            if out.size < len(flat):
                raise ValueError(
                    f"lookup out= buffer too small: {out.size} < "
                    f"{len(flat)} values for this key batch")
            np.copyto(out.reshape(-1)[: len(flat)], flat)
        if len(np.unique(lens)) == 1:
            return flat.reshape(len(keys), int(lens[0]))
        return flat

    def _submit_and_wait(self, req, deadline_s, deadline_ms, fl, tr):
        """The submit/wait/shed/grace dance shared by `lookup` and
        `lookup_bags`: submit into the admission queue, wait out the
        deadline, shed if still unclaimed, bounded grace if claimed.
        Returns the delivered flat result; closes the flight trace on
        any failure so no trace dangles."""
        try:
            self.plane.queue.submit(req)  # may raise ServeOverloadError
            if not req.wait(deadline_s):
                # deadline passed while we waited: shed if still
                # unclaimed
                if req.try_shed():
                    self.plane.queue.c_shed.inc()
                    if self.tenant is not None:
                        self.tenant.c_shed.inc()
                    raise DeadlineExceededError(
                        f"lookup deadline ({deadline_ms} ms) expired "
                        f"before a micro-batch claimed the request "
                        f"(queue depth {self.plane.queue.depth()})")
                # claimed: an in-flight batch will deliver — bounded
                # grace
                if not req.wait(_CLAIMED_GRACE_S):
                    raise RuntimeError(
                        "serve dispatcher failed to deliver a claimed "
                        f"request within {_CLAIMED_GRACE_S}s — wedged "
                        "dispatcher (fail-stop)")
            flat = req.take_result()  # raises the shed/close error
        except BaseException:
            if fl is not None:
                # shed/overload/close: a terminal lookup slice records
                # the abandoned flight so no trace dangles silently
                fl.finish_lookup(tr, ok=False)
            raise
        if fl is not None:
            fl.finish_lookup(tr, ok=True)
        return flat

    def lookup_bags(self, tables, bags, pooling: str = "sum",
                    deadline_ms: Optional[float] = None):
        """Fused embedding-bag read: for each table `t`,
        `bags[t]` is a non-decreasing offsets array `[0, ..., n_t]`
        partitioning that table's member keys `tables[t]` into bags;
        the reply is one `[n_bags_t, L_t]` matrix of `pooling`-pooled
        ("sum" or "mean") vectors per table — only the POOLED vectors
        leave the card on the fused path (one K8 launch per length
        class and pooling), and every serving path returns
        bit-identical values to host-pooling `lookup` of the same
        member keys (serve/bags.py docstring; empty bags pool to
        zeros). Each table's members must share one length class —
        split mixed-length features into separate tables. Duplicated
        members accumulate per position, like an embedding bag.

        Same admission/deadline/error semantics as `lookup`."""
        if pooling not in ("sum", "mean"):
            raise ValueError("lookup_bags pooling must be 'sum' or "
                             f"'mean' (got {pooling!r})")
        if not len(tables) or len(tables) != len(bags):
            raise ValueError(
                "lookup_bags needs parallel, non-empty tables/bags "
                f"lists (got {len(tables)} tables, {len(bags)} bag "
                "offset arrays)")
        srv = self.server
        from ..base import check_key_range
        tks, tbg, lens_t = [], [], []
        for t, (ks, bg) in enumerate(zip(tables, bags)):
            ks = np.ascontiguousarray(
                np.asarray(ks, dtype=np.int64).ravel())
            bg = np.asarray(bg, dtype=np.int64).ravel()
            if len(ks) == 0:
                raise ValueError(
                    f"lookup_bags table {t}: needs >= 1 member key "
                    "(an all-empty table has no length class to pool "
                    "in)")
            if (len(bg) < 2 or bg[0] != 0 or bg[-1] != len(ks)
                    or np.any(np.diff(bg) < 0)):
                raise ValueError(
                    f"lookup_bags table {t}: bags must be "
                    "non-decreasing offsets starting at 0 and ending "
                    f"at n_members={len(ks)} (got {bg!r})")
            check_key_range(ks, srv.num_keys)
            if len(np.unique(srv.ab.key_class[ks])) != 1:
                raise ValueError(
                    f"lookup_bags table {t}: member keys span multiple "
                    "length classes — a pooled vector needs one row "
                    "width; split mixed-length features into separate "
                    "tables")
            tks.append(ks)
            tbg.append(bg)
            lens_t.append(int(srv.value_lengths[ks[0]]))
        reason = srv._degraded_reason
        if reason is not None:
            self.plane.queue.c_degraded.inc()
            raise ServeDegradedError(
                f"serve degraded: {reason} — lookup_bags shed (retry "
                f"once readiness recovers)")
        allk = np.concatenate(tks) if len(tks) > 1 else tks[0]
        if deadline_ms is None:
            deadline_ms = self.plane.opts.serve_deadline_ms
        wt = srv.wtrace
        if wt is not None:
            # the serve half of the op stream sees the MEMBER keys —
            # replay reproduces the same union/access pattern
            wt.record_serve(
                allk,
                self.tenant.name if self.tenant is not None else None,
                self.priority, deadline_ms or 0.0)
        deadline_s = None if not deadline_ms else deadline_ms * 1e-3
        after = ()
        if self.worker is not None and srv.glob is not None:
            after = tuple(self.worker._live_write_futs())
        fl = srv.flight
        tr = fl.mint() if fl is not None else None
        from .bags import BagLookupRequest
        req = BagLookupRequest(
            tks, tbg, pooling, allk, after=after, deadline_s=deadline_s,
            trace=tr, tenant=self.tenant, priority=self.priority,
            lane=self.plane.batcher.assign_lane(allk))
        flat = self._submit_and_wait(req, deadline_s, deadline_ms,
                                     fl, tr)
        out, off = [], 0
        for bg, L in zip(tbg, lens_t):
            nb = len(bg) - 1
            out.append(flat[off:off + nb * L].reshape(nb, L))
            off += nb * L
        return out
