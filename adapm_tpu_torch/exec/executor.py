"""The device-program executor: ordered streams over a small worker
pool, plus the process-wide sharded-dispatch gate.

Model (docs/EXECUTOR.md):

  - A **stream** is a named FIFO: programs submitted to it execute one
    at a time, in submission order. Distinct streams interleave freely
    on the worker pool — that interleaving is where transfer/compute
    overlap comes from (GraphVite's episodic overlap, PAPERS.md).
  - A **program** is a host callable that typically ENQUEUES device
    work (JAX dispatch is asynchronous): snapshot under the server
    lock, revalidate coordinates, dispatch under the gate, release.
    Programs may also be pure host work (classification, batch prep).
  - **Edges**: `submit(..., after=[completion, ...])` orders a program
    behind programs on OTHER streams without any lock held across
    dispatch. Within a stream, FIFO is the edge.
  - The **dispatch gate** is one process-wide reentrant mutex around
    every device-program dispatch. Pool updates run in place, so two
    lock domains enqueueing concurrently could interleave the kernels
    of one logical program; funneling every dispatch through the gate
    gives one global enqueue order. The gate brackets only the enqueue
    (microseconds), never device execution.

Threading: workers are spawned lazily on first submission and park on
the executor's condvar when idle — an idle executor dispatches zero
device programs and burns zero CPU (pinned by
scripts/exec_overlap_check.py's idle guard).

Metrics (`exec.*`, schema_version 5; docs/OBSERVABILITY.md): per-stream
queue-depth gauges, an enqueue->dispatch latency histogram, program
counters, and the overlap_fraction gauge (fraction of busy wall time
where >= 2 streams were simultaneously active).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional

# ---------------------------------------------------------------------------
# the sharded-dispatch gate (the process-wide "collective stream")
# ---------------------------------------------------------------------------

# One gate per process, shared by every Server/store/runner regardless
# of which device context it was built on: every server in the process
# enqueues onto the same CUDA streams, so one gate fixes one enqueue
# order for all of them. Reentrant: store ops nest and a caller already
# holding the gate must not self-deadlock.
_DISPATCH_GATE = threading.RLock()


def dispatch_gate():
    """The process-wide sharded-dispatch mutex. Every site that
    dispatches a sharded device program acquires it around the dispatch
    (enqueue) itself — `with dispatch_gate(): self.main = _prog(...)`.
    Held for the enqueue only; never across device execution, network
    waits, or the server lock (it is a LEAF lock — mechanically
    enforced by adapm-lint APM001/APM002 and, at runtime, by the
    --sys.lint.lockorder sentinel; docs/INVARIANTS.md)."""
    return _DISPATCH_GATE


# ---------------------------------------------------------------------------
# completions + programs
# ---------------------------------------------------------------------------


class Completion:
    """Handle for one submitted program: wait / result / error. Stream
    edges are expressed by passing completions as `after=`."""

    __slots__ = ("label", "_event", "_result", "error", "cancelled")

    def __init__(self, label: str = ""):
        self.label = label
        self._event = threading.Event()
        self._result = None
        self.error: Optional[BaseException] = None
        self.cancelled = False

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"program {self.label!r} did not "
                               f"complete within {timeout}s")
        if self.error is not None:
            raise self.error
        return self._result

    def _finish(self, result=None, error: Optional[BaseException] = None,
                cancelled: bool = False) -> None:
        self._result = result
        self.error = error
        self.cancelled = cancelled
        self._event.set()


def _done_completion(label: str = "") -> Completion:
    c = Completion(label)
    c._finish(cancelled=True)
    return c


class _Program:
    __slots__ = ("fn", "label", "coalesce_key", "after", "not_before",
                 "t_submit", "completion", "attempts")

    def __init__(self, fn, label, coalesce_key, after, not_before):
        self.fn = fn
        self.label = label
        self.coalesce_key = coalesce_key
        self.after = tuple(after)
        self.not_before = not_before
        self.t_submit = time.monotonic()
        self.completion = Completion(label)
        # transient-failure retries consumed so far (fault/policy.py):
        # the SAME program object re-queues at its stream head, so the
        # completion stays open until the final outcome
        self.attempts = 0

    def ready(self, now: float) -> bool:
        if self.not_before > now:
            return False
        return all(c.done() for c in self.after)


class _Stream:
    __slots__ = ("name", "q", "active", "busy_since", "busy_label")

    def __init__(self, name: str):
        self.name = name
        self.q: "collections.deque[_Program]" = collections.deque()
        # active > 0 while a program of this stream executes (queued
        # ones hold exactly 1; inline `track` sections add theirs)
        self.active = 0
        # wall-clock start + label of the QUEUED program currently
        # executing (None = none). Written by the owning worker under
        # _cond; the watchdog probe (wedged_streams) reads it to flag
        # a program busy past --sys.fault.watchdog_s without ever
        # blocking behind it.
        self.busy_since = None
        self.busy_label = None


# ---------------------------------------------------------------------------


class AsyncExecutor:
    """Ordered-stream program executor over a bounded worker pool (see
    module docstring; one per Server, `Server.exec`).

    `single_stream=True` is the serialized fallback (--sys.exec.
    single_stream): the worker pool shrinks to ONE thread, so
    background programs execute strictly one at a time (oldest
    submission first — global FIFO whenever programs are eligible) and
    cross-stream overlap is zero. Streams KEEP their identity: per-
    subsystem drains still drain just that subsystem, and a delayed
    program (e.g. the prefetch window poll) blocks only its own stream,
    never an admitted serve drain behind it. This is the baseline the
    bench's `exec` phase and exec_overlap_check.py compare the
    overlapped default against, and the conservative escape hatch.
    """

    def __init__(self, registry=None, workers: int = 4,
                 single_stream: bool = False, name: str = "exec",
                 recorder=None, retry_policy=None, fault=None):
        self.name = name
        # optional flight recorder (obs/flight.py, rides
        # --sys.crash_dumps): one ring append + pwrite per PROGRAM —
        # never per Pull/Push op, so the hot path never sees it
        self.recorder = recorder
        # executor error policy: transient
        # program failures re-queue at the head of their stream with
        # bounded exponential backoff instead of killing the waiter /
        # the subsystem's self-rescheduling loop. None (or the default
        # classifier with nothing raising TransientFaultError) is
        # byte-for-byte the pre-policy behavior.
        self.retry_policy = retry_policy
        # optional fault-injection plane (fault/inject.py): fires the
        # exec.dispatch (retry-safe, before the program runs) and
        # exec.complete (FATAL — the work already happened) points.
        # None costs one attribute check per program, never per op.
        self.fault = fault
        # streams currently flagged wedged by the watchdog probe (the
        # flip counter increments on the not-wedged -> wedged edge)
        self._wedged_known: set = set()
        self.max_workers = 1 if single_stream else max(1, int(workers))
        self.single_stream = bool(single_stream)
        self._cond = threading.Condition()
        self._streams: Dict[str, _Stream] = {}
        self._threads: List[threading.Thread] = []
        self._closed = False
        self._idle_workers = 0
        # ---- accounting (all under _cond) ----
        self._n_active_streams = 0
        self._acct_t = time.monotonic()
        # busy-wall-time buckets keyed by concurrent-stream count:
        # [idle, single, overlap(>=2)]
        self._t_buckets = [0.0, 0.0, 0.0]
        self._started = 0
        self._finished = 0
        # ---- metrics (exec.* section, docs/OBSERVABILITY.md) ----
        self._registry = registry
        from ..obs.metrics import Counter, Histogram
        use_reg = registry is not None and registry.enabled
        if use_reg:
            self._c_programs = registry.counter("exec.programs_total")
            self._h_wait = registry.histogram("exec.dispatch_wait_s")
            registry.gauge("exec.overlap_fraction",
                           fn=self.overlap_fraction)
            registry.gauge("exec.queue_depth", fn=self.queue_depth)
            registry.gauge("exec.streams", fn=lambda: len(self._streams))
            registry.gauge("exec.workers", fn=lambda: len(self._threads))
            registry.gauge("exec.inflight",
                           fn=lambda: self._started - self._finished)
        else:
            self._c_programs = Counter("exec.programs_total")
            self._h_wait = Histogram("exec.dispatch_wait_s")
        # watchdog flip counter: standalone on purpose — it reaches the
        # snapshot through stats()/the fault section, and the registry
        # must hold zero fault.* names when injection is off
        self._c_wedge_flips = Counter("exec.wedge_flips")

    # -- accounting ----------------------------------------------------------

    def _account(self) -> None:
        """Fold elapsed wall time into the bucket of the CURRENT
        concurrent-stream count; callers mutate the count right after.
        Caller holds _cond."""
        now = time.monotonic()
        n = self._n_active_streams
        self._t_buckets[2 if n >= 2 else n] += now - self._acct_t
        self._acct_t = now

    def _stream_enter(self, st: _Stream) -> None:
        if st.active == 0:
            self._account()
            self._n_active_streams += 1
        st.active += 1

    def _stream_exit(self, st: _Stream) -> None:
        st.active -= 1
        if st.active == 0:
            self._account()
            self._n_active_streams -= 1

    def overlap_fraction(self) -> float:
        """Fraction of BUSY executor wall time where >= 2 streams were
        simultaneously active (the GraphVite-style overlap measure: >0
        means host prep / staging genuinely ran while another stream's
        device program was in flight)."""
        with self._cond:
            self._account()
            single, over = self._t_buckets[1], self._t_buckets[2]
        busy = single + over
        return over / busy if busy else 0.0

    def queue_depth(self, stream: Optional[str] = None) -> int:
        with self._cond:
            if stream is not None:
                st = self._streams.get(stream)
                return len(st.q) if st is not None else 0
            return sum(len(s.q) for s in self._streams.values())

    def stats(self) -> Dict[str, float]:
        with self._cond:
            self._account()
            idle, single, over = self._t_buckets
            return {"programs_started": self._started,
                    "programs_finished": self._finished,
                    "queued": sum(len(s.q) for s in self._streams.values()),
                    "streams": len(self._streams),
                    "workers": len(self._threads),
                    "busy_s": single + over,
                    "overlap_s": over,
                    "overlap_fraction": over / (single + over)
                    if (single + over) else 0.0,
                    "retries": int(self.retry_policy.c_retries.value)
                    if self.retry_policy is not None else 0,
                    "wedge_flips": int(self._c_wedge_flips.value)}

    def wedged_streams(self, bound_s: float,
                       exclude=()) -> List[Dict]:
        """Streams whose CURRENT program has been executing longer than
        `bound_s` — the per-program watchdog: a wedged
        program cannot be interrupted (its thread is stuck inside the
        callable), but it can be NAMED, so readiness flips and waiters
        fail-stop on their own bounds instead of the whole process
        hanging silently. Reads the busy stamps under the executor
        condvar (brief; the wedged program holds no executor lock while
        running, so this probe never blocks behind it). Each
        not-wedged -> wedged edge counts one wedge flip. `exclude`
        names streams whose programs are LEGITIMATELY long-running
        loops with their own finer-grained liveness probe (the serve
        drains: one program serves batches until its lane empties, and
        LookupBatcher.wedged_dispatchers bounds each BATCH instead)."""
        now = time.monotonic()
        out: List[Dict] = []
        skip = set(exclude)
        with self._cond:
            for st in self._streams.values():
                if st.name in skip:
                    continue
                t = st.busy_since
                if t is not None and now - t > bound_s:
                    out.append({"stream": st.name,
                                "label": st.busy_label,
                                "busy_s": now - t})
                    if st.name not in self._wedged_known:
                        self._wedged_known.add(st.name)
                        self._c_wedge_flips.inc()
                elif st.name in self._wedged_known and (
                        t is None or now - t <= bound_s):
                    self._wedged_known.discard(st.name)
        return out

    def fault_stats(self) -> Dict[str, float]:
        """The executor's half of the `fault` snapshot section:
        retry/backoff totals (fault/policy.py) + watchdog flips."""
        out: Dict[str, float] = {
            "wedge_flips": int(self._c_wedge_flips.value)}
        if self.retry_policy is not None:
            out.update(self.retry_policy.stats())
        return out

    # -- submission ----------------------------------------------------------

    def _get_stream(self, name: str) -> _Stream:
        st = self._streams.get(name)
        if st is None:
            st = self._streams[name] = _Stream(name)
            reg = self._registry
            if reg is not None and reg.enabled:
                reg.gauge(f"exec.queue_depth.{name}", shared=True,
                          fn=lambda n=name: self.queue_depth(n))
        return st

    def submit(self, stream: str, fn: Callable[[], object],
               label: Optional[str] = None, coalesce_key: Optional[str]
               = None, delay: float = 0.0, after=()) -> Completion:
        """Enqueue `fn` on `stream`. FIFO within the stream; `after`
        completions (from any stream) must be done before it starts;
        `delay` postpones eligibility (timer work without a sleeping
        thread). `coalesce_key`: if a not-yet-started program with the
        same key is already queued on the stream, no new program is
        added — the existing completion is returned with its
        eligibility tightened to min(existing, now+delay). Safe to call
        under subsystem locks (the executor lock is a leaf).

        After close(): returns an already-completed (cancelled)
        completion — late kicks during teardown are no-ops, never
        crashes."""
        nb = time.monotonic() + max(0.0, delay)
        with self._cond:
            if self._closed:
                return _done_completion(label or "closed")
            st = self._get_stream(stream)
            if coalesce_key is not None:
                for p in st.q:
                    if p.coalesce_key == coalesce_key:
                        if nb < p.not_before:
                            p.not_before = nb
                            self._cond.notify_all()
                        return p.completion
            prog = _Program(fn, label or getattr(fn, "__name__", "?"),
                            coalesce_key, after, nb)
            st.q.append(prog)
            self._ensure_worker()
            self._cond.notify_all()
            return prog.completion

    def track(self, stream: str):
        """Accounting-only context for INLINE dispatch (fused steps and
        other caller-thread programs): marks `stream` active for the
        overlap/occupancy gauges while the caller dispatches. No FIFO
        claim — inline callers serialize through the server lock, and
        their sharded dispatch goes through the gate like everything
        else."""
        return _InlineTrack(self, stream)

    # -- draining / lifecycle ------------------------------------------------

    def drain(self, stream: Optional[str] = None,
              timeout: Optional[float] = None) -> bool:
        """Block until `stream` (or every stream) has no queued and no
        executing program. Returns False on timeout. Does NOT prevent
        new submissions — callers stop their producers first."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        name = stream
        with self._cond:
            while True:
                if name is None:
                    idle = all(len(s.q) == 0 and s.active == 0
                               for s in self._streams.values())
                else:
                    st = self._streams.get(name)
                    idle = st is None or (len(st.q) == 0
                                          and st.active == 0)
                if idle:
                    return True
                if deadline is None:
                    self._cond.wait(0.5)
                else:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        return False
                    self._cond.wait(min(rem, 0.5))

    def drain_streams(self, streams, timeout: Optional[float] = None) \
            -> bool:
        """Drain several streams under ONE shared deadline (the serve
        plane's N dispatcher streams must all quiesce within the same
        bound at stop time — N sequential per-stream timeouts would
        multiply the worst-case teardown wait). Returns False when the
        deadline expires with any stream still busy."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        for name in streams:
            rem = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            if not self.drain(name, timeout=rem):
                return False
        return True

    def close(self, timeout: float = 30.0) -> None:
        """Idempotent shutdown: cancel not-yet-started programs (their
        completions finish cancelled — no waiter hangs), let running
        ones finish, join the workers. Server.shutdown() calls this
        LAST, after every producer subsystem has been stopped, so a
        well-ordered teardown cancels nothing."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            for st in self._streams.values():
                while st.q:
                    st.q.popleft().completion._finish(cancelled=True)
            self._cond.notify_all()
            threads = list(self._threads)
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        alive = [t.name for t in threads if t.is_alive()]
        if alive:
            from ..utils import alog
            alog(f"[exec] workers failed to exit within {timeout}s: "
                 f"{alive} — a program is wedged mid-dispatch")

    @property
    def closed(self) -> bool:
        return self._closed

    def live_streams(self) -> List[str]:
        """Streams with queued or executing programs (empty after a
        clean close — the 'no orphaned streams' shutdown assertion)."""
        with self._cond:
            return sorted(s.name for s in self._streams.values()
                          if s.q or s.active)

    # -- workers -------------------------------------------------------------

    def _ensure_worker(self) -> None:
        """Spawn a worker if every existing one is busy and we are under
        the cap (caller holds _cond). Lazy: an executor that is never
        submitted to owns zero threads."""
        if self._idle_workers == 0 and \
                len(self._threads) < self.max_workers:
            t = threading.Thread(
                target=self._worker, daemon=True,
                name=f"adapm-{self.name}-{len(self._threads)}")
            self._threads.append(t)
            t.start()

    def _pick_locked(self, now: float):
        """(program, stream) of the oldest eligible head-of-stream, or
        (None, soonest_not_before). FIFO per stream: only each stream's
        HEAD is a candidate, and a head blocked on `after`/`not_before`
        blocks its whole stream (that is what 'ordered' means)."""
        best = None
        best_stream = None
        soonest = None
        for st in self._streams.values():
            if st.active or not st.q:
                continue
            head = st.q[0]
            if head.not_before > now:
                soonest = head.not_before if soonest is None else \
                    min(soonest, head.not_before)
                continue
            if not all(c.done() for c in head.after):
                # dep from another executor/track would not notify us:
                # poll soon rather than parking forever
                soonest = now + 0.05 if soonest is None else \
                    min(soonest, now + 0.05)
                continue
            if best is None or head.t_submit < best.t_submit:
                best, best_stream = head, st
        return (best, best_stream) if best is not None else (None, soonest)

    def _worker(self) -> None:
        from ..utils import alog
        while True:
            with self._cond:
                while True:
                    if self._closed:
                        return
                    now = time.monotonic()
                    prog, st_or_soonest = self._pick_locked(now)
                    if prog is not None:
                        st = st_or_soonest
                        break
                    self._idle_workers += 1
                    try:
                        # park on the condvar: None timeout unless a
                        # delayed program needs a timed wake
                        soonest = st_or_soonest
                        self._cond.wait(
                            None if soonest is None
                            else max(0.0, soonest - now))
                    finally:
                        self._idle_workers -= 1
                st.q.popleft()
                self._stream_enter(st)
                self._started += 1
                st.busy_since = time.monotonic()
                st.busy_label = prog.label
            self._c_programs.inc()
            t_run = time.monotonic()
            wait_s = t_run - prog.t_submit
            self._h_wait.observe(wait_s)
            result = None
            error = None
            try:
                f = self.fault
                if f is not None:
                    # retry-safe point: fires BEFORE the program runs,
                    # so a retried attempt re-executes from scratch
                    f.fire("exec.dispatch")
                result = prog.fn()
                if f is not None:
                    # completion-side point: the work already happened,
                    # only the completion is lost — FATAL by
                    # construction (a retry would double-execute)
                    f.fire("exec.complete", transient=False)
            except BaseException as e:  # noqa: BLE001 — the pool must
                # outlive any one program; the error reaches waiters
                # via the completion and the log
                error = e
                alog(f"[exec] program {prog.label!r} on stream "
                     f"{st.name!r} failed: {type(e).__name__}: {e}")
            rec = self.recorder
            if rec is not None:
                rec.record(st.name, prog.label, prog.coalesce_key,
                           wait_s, time.monotonic() - t_run,
                           failed=error is not None)
            # error policy (fault/policy.py): a TRANSIENT failure with
            # budget left re-queues the SAME program at its stream head
            # (FIFO preserved) after an exponential backoff; the
            # completion stays open until the final outcome
            pol = self.retry_policy
            if (error is not None and pol is not None
                    and prog.attempts < pol.max_retries
                    and pol.classify(error)):
                prog.attempts += 1
                delay = pol.backoff_s(prog.attempts)
                pol.c_retries.inc()
                pol.c_backoff_s.inc(delay)
                alog(f"[exec] retrying {prog.label!r} on stream "
                     f"{st.name!r} (attempt {prog.attempts}/"
                     f"{pol.max_retries}, backoff {delay * 1e3:.0f} ms)")
                with self._cond:
                    self._stream_exit(st)
                    self._finished += 1
                    st.busy_since = None
                    st.busy_label = None
                    if self._closed:
                        # teardown won the race: finish cancelled, no
                        # waiter hangs on a retry that can never run
                        prog.completion._finish(cancelled=True)
                    else:
                        prog.not_before = time.monotonic() + delay
                        st.q.appendleft(prog)
                    self._cond.notify_all()
                continue
            with self._cond:
                self._stream_exit(st)
                self._finished += 1
                st.busy_since = None
                st.busy_label = None
                self._cond.notify_all()
            prog.completion._finish(result, error)


class _InlineTrack:
    __slots__ = ("ex", "name", "_st")

    def __init__(self, ex: AsyncExecutor, name: str):
        self.ex = ex
        self.name = name
        self._st = None

    def __enter__(self):
        ex = self.ex
        with ex._cond:
            if not ex._closed:
                self._st = ex._get_stream(self.name)
                ex._stream_enter(self._st)
        return self

    def __exit__(self, *exc):
        ex = self.ex
        with ex._cond:
            if self._st is not None:
                ex._stream_exit(self._st)
                ex._cond.notify_all()
        return False
