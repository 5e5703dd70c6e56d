"""Admission control for the serving plane: bounded lanes, deadlines,
tenant quotas and priority classes. Shed, never hang.

The port of the JAX package's `serve/admission.py`, line for line in its
logic. An overloaded or expired request is rejected loudly: `submit`
raises `ServeOverloadError` the instant the bounded queue is full
(backpressure the caller can act on), and a request whose deadline
passes before a micro-batch claims it is shed with
`DeadlineExceededError`. The dispatcher checks deadlines at take time,
the client while it waits, and the two sides arbitrate through a small
claim/shed state machine, so a request is served exactly once or shed
exactly once:

    PENDING --try_claim()--> CLAIMED --deliver()/fail()--> done
       \\--try_shed()--> SHED (fail(DeadlineExceededError))

`try_claim` (a dispatcher) and `try_shed` (client timeout, the take-time
expiry sweep, or a priority preemption) race under the request's lock;
whoever flips the state first wins. A CLAIMED request is part of an
in-flight micro-batch and will be delivered. Any number of concurrent
`take` callers claim disjoint request sets, which is what lets N
dispatchers drain one queue.

All of the following are inert until configured:

  - **Lanes** (`lanes=N`, `--sys.serve.dispatchers`): N FIFOs sharing
    ONE bound, each drained by its own dispatcher stream, so a long-row
    length class cannot head-of-line-block short ones.
  - **Tenants** (`configure_tenant`): per-tenant token-bucket quotas
    (rejected at submit when the bucket is dry) and priority classes,
    with per-tenant served / shed / rejected counters under
    `serve.tenant.<name>.*`.
  - **Priority under pressure**: at a full queue a submission may
    preempt (shed loudly) a strictly-lower-priority pending request.
    Batch formation takes the highest priority first, then round-robin
    across tenants within a class, then FIFO. With no tenant and only
    default priorities, `take` is a plain FIFO.

With `--sys.lint.lockorder` the admission condition variable's lock
joins the lock-order sentinel's graph (lint/lockorder.py).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class ServeOverloadError(RuntimeError):
    """The bounded admission queue (or a tenant's quota bucket) is
    full/dry — backpressure, not a bug.

    Raised synchronously by `AdmissionQueue.submit`, and delivered to a
    pending low-priority request preempted by a higher-priority
    submission under pressure; the caller decides whether to retry,
    drop, or surface the overload. Counted in `serve.rejected_total`
    (submit-side) / `serve.shed_total` (preemption-side)."""


class DeadlineExceededError(TimeoutError):
    """A lookup's deadline passed before it was served. Counted in
    `serve.shed_total`."""


class ServeDegradedError(RuntimeError):
    """The server is DEGRADED (a checkpoint-chain restore is applying —
    fault/ckpt.py restore_chain — or an operator opened a maintenance
    window with `Server.begin_degraded`): lookups are shed loudly with
    this distinct error instead of risking a read that mixes pre- and
    post-restore bits. Checked at session submit (fast rejection at
    the door) AND at dispatcher batch-serve time (requests already
    queued when the window opened). Counted in
    `serve.degraded_shed_total`: a degraded server never returns a torn
    or stale value, it returns THIS error."""


_PENDING, _CLAIMED, _SHED = 0, 1, 2


class TenantState:
    """One tenant's admission policy + accounting: a token bucket
    (qps/burst; qps=0 = unthrottled) and a priority class. Owned by the
    AdmissionQueue; sessions bind to it by name."""

    __slots__ = ("name", "priority", "rate", "burst", "_tokens",
                 "_t_last", "_lock", "c_served", "c_shed", "c_rejected")

    def __init__(self, name: str, priority: int = 0, qps: float = 0.0,
                 burst: Optional[float] = None, registry=None):
        self.name = name
        self.priority = int(priority)
        self.rate = float(qps)
        self.burst = float(burst) if burst is not None \
            else max(1.0, self.rate)
        self._tokens = self.burst
        self._t_last = time.monotonic()
        self._lock = threading.Lock()
        from ..obs.metrics import Counter
        if registry is not None and registry.enabled:
            def mk(leaf):
                return registry.counter(f"serve.tenant.{name}.{leaf}",
                                        shared=True)
        else:
            def mk(leaf):
                return Counter(f"serve.tenant.{name}.{leaf}")
        self.c_served = mk("served_total")
        self.c_shed = mk("shed_total")
        self.c_rejected = mk("rejected_total")

    def configure(self, priority: int = 0, qps: float = 0.0,
                  burst: Optional[float] = None) -> None:
        with self._lock:
            self.priority = int(priority)
            self.rate = float(qps)
            self.burst = float(burst) if burst is not None \
                else max(1.0, self.rate)
            self._tokens = min(self._tokens, self.burst)

    def try_admit(self) -> bool:
        """Consume one quota token; True when admitted (qps=0 always
        admits). Standard lazily-refilled token bucket."""
        if self.rate <= 0:
            return True
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst,
                self._tokens + (now - self._t_last) * self.rate)
            self._t_last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def refund(self) -> None:
        """Return a consumed token (a submit that passed the bucket but
        was then rejected at the queue bound must not burn quota — the
        tenant was never served; without the refund a saturated queue
        double-punishes it with overload AND a drained bucket)."""
        if self.rate <= 0:
            return
        with self._lock:
            self._tokens = min(self.burst, self._tokens + 1.0)


class LookupRequest:
    """One client lookup: the key batch, optional read-your-writes
    ordering futures, a deadline, tenancy, and the delivery
    rendezvous."""

    __slots__ = ("keys", "after", "deadline", "t0", "result", "error",
                 "trace", "tenant", "priority", "lane", "_state",
                 "_lock", "_done")

    def __init__(self, keys: np.ndarray, after: Sequence = (),
                 deadline_s: Optional[float] = None, trace=None,
                 tenant: Optional[TenantState] = None,
                 priority: int = 0, lane: int = 0):
        self.keys = keys
        # request-flight trace context (obs/flight.py FlightTrace),
        # minted by the session when --sys.trace.flight is on; None —
        # the common case — costs nothing anywhere below
        self.trace = trace
        # outstanding cross-process write futures of the client's worker:
        # the coalesced pull is ordered after them, so a client that also
        # pushes reads its own writes (same `after` contract as
        # Worker.pull; single-process ordering needs nothing — a push
        # lands under the server lock before the lookup's gather is
        # dispatched)
        self.after: Tuple = tuple(after)
        self.deadline = None if deadline_s is None \
            else time.monotonic() + deadline_s
        self.t0 = time.perf_counter()   # serve.latency_s start
        self.tenant = tenant
        self.priority = int(priority)
        self.lane = int(lane)
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self._state = _PENDING
        self._lock = threading.Lock()
        self._done = threading.Event()

    # -- state machine -------------------------------------------------------

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (time.monotonic() if now is None else now) >= self.deadline

    def try_claim(self) -> bool:
        """Dispatcher side: move PENDING -> CLAIMED."""
        with self._lock:
            if self._state != _PENDING:
                return False
            self._state = _CLAIMED
            if self.trace is not None:
                # end of queue residence: the flight's queue_s segment
                # closes here, batch_wait_s starts
                self.trace.t_claim = time.perf_counter()
            return True

    def try_shed(self) -> bool:
        """Shed side (client timeout / take-time expiry sweep /
        priority preemption): move PENDING -> SHED. False means a
        micro-batch already claimed it."""
        with self._lock:
            if self._state != _PENDING:
                return False
            self._state = _SHED
            return True

    @property
    def claimed(self) -> bool:
        return self._state == _CLAIMED

    # -- delivery ------------------------------------------------------------

    def deliver(self, flat: np.ndarray) -> None:
        self.result = flat
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        self.error = exc
        self._done.set()

    def wait(self, timeout: Optional[float]) -> bool:
        return self._done.wait(timeout)

    def take_result(self) -> np.ndarray:
        if self.error is not None:
            raise self.error
        return self.result


class AdmissionQueue:
    """Bounded lanes of LookupRequests with dispatcher-side micro-batch
    take (see module docstring). `submit` never blocks: a full queue
    raises ServeOverloadError immediately — after attempting a
    priority preemption when the submission outranks a pending request
    — and a dry tenant bucket rejects before touching the bound.
    `take(lane=i)` blocks until at least one live request exists in
    lane i, then lingers up to `max_wait_s` to coalesce more — the
    micro-batch window.

    Metrics (registered in the server's registry, `shared=True` so a
    plane torn down and rebuilt on the same server reuses them):
    `serve.queue_depth` gauge, per-lane `serve.lane_depth.<i>` gauges,
    `serve.rejected_total` / `serve.shed_total` counters, and the
    per-tenant `serve.tenant.<name>.*` counters."""

    def __init__(self, bound: int, registry=None, lanes: int = 1,
                 lockorder: bool = False):
        assert bound >= 1, "admission queue bound must be >= 1"
        self.bound = int(bound)
        self.lanes = max(1, int(lanes))
        self._lanes: List["collections.deque[LookupRequest]"] = [
            collections.deque() for _ in range(self.lanes)]
        if lockorder:
            # the runtime lock-order sentinel (--sys.lint.lockorder): the
            # admission condvar's lock joins the process-wide acquisition
            # graph; off, a plain Condition with no wrapper
            from ..lint.lockorder import SentinelLock
            self._cond = threading.Condition(
                SentinelLock("serve_admission"))
        else:
            self._cond = threading.Condition()
        self._closed = False
        self._registry = registry
        self._tenants: Dict[str, TenantState] = {}
        # QoS selection engages only once a tenant exists or a
        # non-default priority has been submitted; before that the take
        # path is a plain FIFO
        self._has_qos = False
        # dispatcher kick: the LookupBatcher registers a callback that
        # queues a drain program on the lane's executor stream —
        # event-driven dispatch instead of a thread parked in take()
        self._kick = None
        from ..obs.metrics import Counter
        if registry is not None and registry.enabled:
            self.c_rejected = registry.counter("serve.rejected_total",
                                               shared=True)
            self.c_shed = registry.counter("serve.shed_total", shared=True)
            self.c_degraded = registry.counter(
                "serve.degraded_shed_total", shared=True)
            registry.gauge("serve.queue_depth", fn=self.depth,
                           shared=True)
            for i in range(self.lanes):
                registry.gauge(f"serve.lane_depth.{i}", shared=True,
                               fn=lambda i=i: self.lane_depth(i))
        else:
            # standalone counters: shed/reject accounting survives
            # --sys.metrics 0 (the session reads c_shed for its own
            # bookkeeping either way)
            self.c_rejected = Counter("serve.rejected_total")
            self.c_shed = Counter("serve.shed_total")
            self.c_degraded = Counter("serve.degraded_shed_total")

    # -- tenancy -------------------------------------------------------------

    def configure_tenant(self, name: str, priority: int = 0,
                         qps: float = 0.0,
                         burst: Optional[float] = None) -> TenantState:
        """Create or update a tenant's admission policy. Tenant names
        must be metric-name safe (no dots/spaces — they become the
        `serve.tenant.<name>.*` namespace)."""
        if not name or any(c in name for c in ". \t\n"):
            raise ValueError(
                f"tenant name {name!r} must be non-empty and contain "
                f"no dots or whitespace (it names the "
                f"serve.tenant.<name>.* metrics)")
        with self._cond:
            ts = self._tenants.get(name)
            if ts is None:
                ts = self._tenants[name] = TenantState(
                    name, priority=priority, qps=qps, burst=burst,
                    registry=self._registry)
            else:
                ts.configure(priority=priority, qps=qps, burst=burst)
            self._has_qos = True
            return ts

    def tenant(self, name: str) -> TenantState:
        """The tenant's state, auto-created unthrottled at priority 0
        when never configured (sessions may name tenants first; the
        operator's configure_tenant tightens policy later)."""
        with self._cond:
            ts = self._tenants.get(name)
            if ts is None:
                ts = self._tenants[name] = TenantState(
                    name, registry=self._registry)
                self._has_qos = True
            return ts

    def tenants(self) -> Dict[str, TenantState]:
        with self._cond:
            return dict(self._tenants)

    # -- depth accounting ----------------------------------------------------

    def depth(self) -> int:
        """LIVE (still-pending) requests queued across all lanes — the
        number that counts against the bound. Client-shed corpses
        linger in the deques until a take or an at-bound submit
        compacts them; counting them here would let readiness report a
        saturated queue that the very next submit would admit into.
        Under the lock — iterating a deque while a dispatcher poplefts
        would raise 'deque mutated during iteration'. O(queue bound),
        probe-frequency only."""
        with self._cond:
            return sum(1 for dq in self._lanes for r in dq
                       if r._state == _PENDING)

    def lane_depth(self, lane: int) -> int:
        """Live requests pending in one lane (the per-dispatcher depth
        gauge, schema v8)."""
        if not (0 <= lane < self.lanes):
            return 0
        with self._cond:
            return sum(1 for r in self._lanes[lane]
                       if r._state == _PENDING)

    def _compact_locked(self) -> None:
        """Drop non-pending corpses from every lane (caller holds
        _cond). Exact: a request is removed only once it can never be
        claimed again, so bound accounting never double-counts and
        never loses a live request — pinned by the compaction-race
        test."""
        for i, dq in enumerate(self._lanes):
            if any(r._state != _PENDING for r in dq):
                self._lanes[i] = collections.deque(
                    r for r in dq if r._state == _PENDING)

    # -- producer (client sessions) ------------------------------------------

    def submit(self, req: LookupRequest) -> None:
        lane = req.lane % self.lanes
        req.lane = lane
        with self._cond:
            if self._closed:
                raise RuntimeError("serve plane is closed")
            if req.priority != 0:
                self._has_qos = True
            tn = req.tenant
            if tn is not None and not tn.try_admit():
                tn.c_rejected.inc()
                self.c_rejected.inc()
                raise ServeOverloadError(
                    f"tenant {tn.name!r} quota exceeded "
                    f"({tn.rate:g} qps, burst {tn.burst:g}): "
                    f"backpressure — slow down or raise the quota")
            # O(lanes) raw-length check on the common path; the
            # O(queued) corpse scan happens only at the bound
            if sum(len(dq) for dq in self._lanes) >= self.bound:
                # client-shed requests linger in the deques until a take
                # skips them; they must not count against the bound
                # (only LIVE requests are backpressure), so compact
                # before rejecting (post-compaction, raw length == live
                # count — every surviving entry was PENDING)
                self._compact_locked()
            if sum(len(dq) for dq in self._lanes) >= self.bound:
                # priority preemption: under pressure the LOWEST
                # priority class sheds first — a submission that
                # strictly outranks some pending request takes its slot
                victim = self._preempt_victim_locked(req.priority)
                if victim is None:
                    if tn is not None:
                        tn.refund()  # never served: the token goes back
                        tn.c_rejected.inc()
                    self.c_rejected.inc()
                    raise ServeOverloadError(
                        f"serve admission queue full ({self.bound} "
                        f"pending): backpressure — retry later, shed "
                        f"load, or raise --sys.serve.queue")
                self.c_shed.inc()
                if victim.tenant is not None:
                    victim.tenant.c_shed.inc()
                victim.fail(ServeOverloadError(
                    f"shed under pressure: preempted by a priority-"
                    f"{req.priority} submission (this request's "
                    f"priority: {victim.priority})"))
                self._compact_locked()
            self._lanes[lane].append(req)
            self._cond.notify_all()
            kick = self._kick
        if kick is not None:
            # outside the queue lock: the kick enqueues an executor
            # program (leaf lock), and a submit that loses the race with
            # a running drain still queues the NEXT drain — no lost
            # wakeup (the drain re-checks the queue before exiting
            # either way, but the invariant is: every admitted request
            # has a drain program submitted after it)
            kick(lane)

    def _preempt_victim_locked(self, priority: int) \
            -> Optional[LookupRequest]:
        """Shed candidate for an at-bound submission: the most recently
        queued PENDING request of the lowest priority class strictly
        below `priority` (newest-first within the class — it has waited
        least). Returns the request already moved to SHED, or None.
        Caller holds _cond and fails/compacts the victim."""
        best = None
        for dq in self._lanes:
            for r in reversed(dq):
                if r._state != _PENDING or r.priority >= priority:
                    continue
                if best is None or r.priority < best.priority:
                    best = r
        if best is not None and best.try_shed():
            return best
        return None

    def set_kick(self, fn) -> None:
        """Register (or clear, fn=None) the dispatcher kick called with
        the admitted request's lane after every successful submit."""
        with self._cond:
            self._kick = fn

    # -- consumer (the LookupBatcher drain programs) -------------------------

    def _pop_live_locked(self, dq) -> Optional[LookupRequest]:
        """Next claimable request from `dq` in FIFO order; sheds
        expired ones on the way (the take-time deadline check). Caller
        holds the condition lock."""
        while dq:
            r = dq.popleft()
            if r.expired():
                if r.try_shed():
                    self.c_shed.inc()
                    if r.tenant is not None:
                        r.tenant.c_shed.inc()
                    r.fail(DeadlineExceededError(
                        "lookup deadline expired before dispatch "
                        "(queue wait exceeded deadline_ms)"))
                continue
            if r.try_claim():
                return r
            # client shed it while queued: already failed, skip
        return None

    def _claim_next_locked(self, dq, taken,
                           prio: Optional[int] = None) \
            -> Optional[LookupRequest]:
        """One claim for the forming micro-batch. FIFO when no QoS
        state exists (a plain FIFO); otherwise fair-share
        selection: highest priority first, then the tenant with the
        fewest requests already in THIS batch (`taken` counts them;
        round-robin across tenants within a priority class), then
        FIFO. `prio` (set after a batch's first claim) keeps batches
        PRIORITY-PURE: a high-priority batch never unions low-priority
        keys into its gather, so the low class cannot drag the high
        class's tail through the locked path — the latency-isolation
        half of the QoS contract (the next drain iteration serves the
        lower class). Caller holds _cond."""
        if not self._has_qos:
            return self._pop_live_locked(dq)
        now = time.monotonic()
        best = None
        for r in dq:
            if r._state != _PENDING:
                continue
            if r.expired(now):
                if r.try_shed():
                    self.c_shed.inc()
                    if r.tenant is not None:
                        r.tenant.c_shed.inc()
                    r.fail(DeadlineExceededError(
                        "lookup deadline expired before dispatch "
                        "(queue wait exceeded deadline_ms)"))
                continue
            if prio is not None and r.priority != prio:
                continue
            if best is None:
                best = r
                continue
            if r.priority != best.priority:
                if r.priority > best.priority:
                    best = r
                continue
            # same priority: fair-share — fewer batch slots used by
            # this request's tenant wins; FIFO breaks the tie (deque
            # iteration order is arrival order, so `best` is earlier)
            rt = r.tenant.name if r.tenant is not None else ""
            bt = best.tenant.name if best.tenant is not None else ""
            if taken.get(rt, 0) < taken.get(bt, 0):
                best = r
        if best is not None and best.try_claim():
            tname = best.tenant.name if best.tenant is not None else ""
            taken[tname] = taken.get(tname, 0) + 1
            # leave the claimed corpse in place; the periodic
            # compaction (and FIFO popleft skip) removes it
            return best
        if best is not None:
            # lost the race to a concurrent shed — rescan
            return self._claim_next_locked(dq, taken, prio=prio)
        return None

    def take(self, max_batch: int, max_wait_s: float,
             block: bool = True, lane: int = 0,
             wait_s_by_prio: Optional[Dict[int, float]] = None):
        """Claim up to `max_batch` live requests from `lane`: wait for
        the first (`block=False` — the executor-driven drain — returns
        [] immediately instead, since a kick already guarantees a
        follow-up drain for any later submit), then linger up to
        `max_wait_s` to coalesce more (the micro-batch window). Safe
        for N concurrent callers (disjoint claims by the state
        machine). Returns [] when there is nothing to claim (closed
        queue, or empty with block=False).

        `wait_s_by_prio` (per-class SLO targets) overrides the linger
        window per priority CLASS: batches are
        priority-pure (the `prio` pin below), so once the first claim
        fixes the batch's class, that class's window — walked
        independently by the SLO controller — replaces `max_wait_s`.
        Classes without an override keep the base window; None (the
        default, and the only value without `--sys.serve.slo_ms`
        class overrides) leaves this path byte-identical."""
        dq = self._lanes[lane % self.lanes]
        taken: Dict[str, int] = {}
        with self._cond:
            while True:
                first = self._claim_next_locked(dq, taken)
                if first is not None:
                    break
                if self._closed or not block:
                    return []
                self._cond.wait()
            out = [first]
            prio = first.priority if self._has_qos else None
            if wait_s_by_prio is not None and prio is not None:
                max_wait_s = wait_s_by_prio.get(prio, max_wait_s)
            if max_wait_s > 0 and len(out) < max_batch:
                limit = time.monotonic() + max_wait_s
                while len(out) < max_batch and not self._closed:
                    nxt = self._claim_next_locked(dq, taken, prio=prio)
                    if nxt is not None:
                        out.append(nxt)
                        continue
                    rem = limit - time.monotonic()
                    if rem <= 0:
                        break
                    self._cond.wait(rem)
            else:
                # zero-wait window: drain whatever is already queued
                while len(out) < max_batch:
                    nxt = self._claim_next_locked(dq, taken, prio=prio)
                    if nxt is None:
                        break
                    out.append(nxt)
            if self._has_qos:
                # QoS claims leave corpses in place; compact so the
                # bound reflects live work only
                self._compact_locked()
            return out

    def close(self) -> None:
        """Stop admitting, wake the dispatchers, and fail-stop every
        still-pending request (never leave a waiter hanging)."""
        with self._cond:
            self._closed = True
            pending = [r for dq in self._lanes for r in dq]
            for dq in self._lanes:
                dq.clear()
            self._cond.notify_all()
        for r in pending:
            if r.try_shed():
                r.fail(RuntimeError("serve plane closed while the "
                                    "request was queued"))
