"""Event ingest (the JAX package's `stream/ingest.py`): a seeded
click-event source + the micro-batching StreamTrainer that turns events
into fused additive Push steps (K3 on the card) while the serve plane
reads.

Event lifecycle and the exactly-once contract:

  1. **Generated** — event `i` is a pure function of `(seed, i)`
     (`EventLog.event`): a skewed key set plus a per-key gradient row.
     Nothing is ever buffered durably; any index can be regenerated,
     so replay after a crash needs no retained queue — the log is
     bounded by construction.
  2. **Applied** — the trainer fuses `--sys.stream.batch` events into
     ONE additive `Worker.push`. Inside a single (reentrant) server-
     lock bracket the push's scatter is enqueued — which is also where
     the FreshnessProbe's `push_visible` stamp lands — and the
     plane's acked-event cursor advances to the batch end. Enqueue
     order is this codebase's read-visibility order, so at that point
     the events are servable-ordered: that is the ACK.
  3. **Checkpointed** — the cursor rides every checkpoint link as the
     `stream_cursor` aux array (fault/ckpt.py), captured under the
     SAME lock hold as the row bits. A restored chain therefore lands
     on a state where events `[0, cursor)` are applied exactly once
     and nothing after the cursor is applied at all.
  4. **Replayed** — after a mid-stream kill + restore, a new trainer
     resumes from the restored cursor and `replay_tail(acked)`
     re-applies the tail up to the pre-kill ack watermark, counting
     each into `stream.replayed_events_total` (loud, not silent).
     Because the cursor only moves at batch boundaries, the replayed
     batches are the SAME batches an unkilled shadow applied — same
     grouping, same order, so the additive scatter sums are bitwise
     identical (pinned by tests/test_torch_stream.py).

The pump runs as a self-rescheduling program on the executor's
`stream` stream (pacing via `delay=`, never a sleeping worker); `--sys.stream.rate` bounds events/s.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, Optional, Tuple

import numpy as np


class EventLog:
    """Seeded, bounded click-event source. Event `i` is a pure
    function of `(seed, i)`: `keys_per_event` keys drawn with a hot
    head (power-law-ish: serve traffic and pushes contest the same hot
    rows, the access shape the DLRM bag papers model) and one gradient
    row per key. A bounded memo ring caches recently materialized
    events; anything evicted is regenerated bit-identically on demand
    — the property the kill/restore replay leans on."""

    def __init__(self, num_keys: int, seed: int = 0,
                 keys_per_event: int = 8, skew: float = 3.0,
                 scale: float = 0.01, bound: int = 4096):
        assert num_keys > 0 and keys_per_event > 0
        self.num_keys = int(num_keys)
        self.seed = int(seed)
        self.keys_per_event = int(keys_per_event)
        self.skew = float(skew)
        self.scale = float(scale)
        self._bound = max(1, int(bound))
        self._memo: "collections.OrderedDict" = collections.OrderedDict()

    def keys(self, i: int) -> np.ndarray:
        """The event's key set (sorted, may repeat across events but
        unique within one — duplicates inside one additive scatter
        would make the fused batch order-sensitive)."""
        rng = np.random.default_rng((self.seed, int(i)))
        # u**skew concentrates mass near 0: a hot head without the
        # unbounded tail of a true zipf draw
        u = rng.random(4 * self.keys_per_event)
        k = np.unique((u ** self.skew * self.num_keys).astype(np.int64))
        k = np.minimum(k, self.num_keys - 1)
        return k[:self.keys_per_event]

    def event(self, i: int, value_lengths: np.ndarray) \
            -> Tuple[np.ndarray, np.ndarray]:
        """(keys, flat gradient buffer) for event `i`. The gradient is
        drawn from the event's own generator AFTER the key draw, so it
        is deterministic given (seed, i) alone."""
        i = int(i)
        hit = self._memo.get(i)
        if hit is not None:
            self._memo.move_to_end(i)
            return hit
        rng = np.random.default_rng((self.seed, i))
        u = rng.random(4 * self.keys_per_event)
        k = np.unique((u ** self.skew * self.num_keys).astype(np.int64))
        k = np.minimum(k, self.num_keys - 1)[:self.keys_per_event]
        total = int(np.sum(value_lengths[k]))
        vals = (rng.standard_normal(total) * self.scale).astype(
            np.float32)
        out = (k, vals)
        self._memo[i] = out
        if len(self._memo) > self._bound:
            self._memo.popitem(last=False)
        return out


class StreamTrainer:
    """Micro-batching ingest: fuses `batch` events into one additive
    Push per step, advancing the stream plane's acked-event cursor
    under the same server-lock hold as the push enqueue (module
    docstring). Requires the stream plane (`--sys.stream.batch` or
    another --sys.stream.* knob) — no plane, no trainer, no stream.*
    names.

    Two drive modes, freely mixable:
      - `step()` / `run_until(n)` — inline on the caller's thread
        (deterministic; what the drill tests and the shadow use);
      - `start()` — the executor pump on the `stream` stream, paced by
        `--sys.stream.rate` via `delay=` rescheduling.
    """

    def __init__(self, server, log: EventLog, worker=None,
                 batch: Optional[int] = None,
                 rate: Optional[float] = None):
        plane = getattr(server, "stream", None)
        if plane is None:
            raise RuntimeError(
                "StreamTrainer needs the stream plane: set "
                "--sys.stream.batch (or another --sys.stream.* knob) "
                "so the Server builds one — the acked-event cursor "
                "lives there and rides the checkpoint chain")
        self.server = server
        self.plane = plane
        self.log = log
        self.batch = int(batch if batch is not None
                         else server.opts.stream_batch)
        if self.batch < 1:
            raise ValueError(
                f"stream micro-batch must be >= 1 (got {self.batch}; "
                f"set --sys.stream.batch or pass batch=)")
        self.rate = float(rate if rate is not None
                          else server.opts.stream_rate)
        self.worker = worker if worker is not None \
            else server.make_worker()
        self.resumed_from = int(plane.cursor[0])
        self._closed = False
        self._target: Optional[int] = None  # pump stop horizon
        self._due = 0.0  # monotonic schedule base for rate pacing
        self._release = 0.0  # when the queued pump program may run
        # host seconds by part, summed over steps (the pump's are also
        # split by where it waited): `paced_s` the delays the rate
        # pacing asked for, `queue_s` the executor's wait past a pump's
        # release time, `events_s` materializing the micro-batch,
        # `lock_s` waiting for the server lock, `push_s` the push under
        # it, `cpu_s` this thread's CPU time over the steps (wall minus
        # it is time the step waited: the GIL, the lock, the card)
        self.parts_s = dict.fromkeys(
            ("paced_s", "queue_s", "events_s", "lock_s", "push_s",
             "cpu_s"), 0.0)
        plane.trainer = self

    # -- accounting ----------------------------------------------------------

    @property
    def cursor(self) -> int:
        """Acked-event horizon: events [0, cursor) are applied exactly
        once in the live state (and in any checkpoint whose link
        captured this cursor value)."""
        return int(self.plane.cursor[0])

    def stats(self) -> Dict:
        return {"cursor": self.cursor,
                "resumed_from": self.resumed_from,
                "batch": self.batch, "rate": self.rate,
                "closed": self._closed}

    # -- inline drive (deterministic; drills and shadows) --------------------

    def step(self, replayed: bool = False) -> int:
        """Apply ONE micro-batch inline. Returns the new cursor."""
        plane = self.plane
        srv = self.server
        t0, c0 = time.perf_counter(), time.thread_time()
        start = int(plane.cursor[0])
        end = start + self.batch
        vlen = srv.value_lengths
        parts_k, parts_v = [], []
        for i in range(start, end):
            k, v = self.log.event(i, vlen)
            parts_k.append(k)
            parts_v.append(v)
        keys = np.concatenate(parts_k)
        vals = np.concatenate(parts_v)
        t1 = time.perf_counter()
        # one reentrant bracket (the server lock is an RLock): the
        # push's own under-lock scatter enqueue — where push_visible
        # stamps the freshness probe, the ACK point — and the cursor
        # bump commit atomically against checkpoint capture, which
        # snapshots rows AND the cursor under the same lock. A capture
        # therefore never sees the push without the cursor bump or
        # vice versa — the exactly-once seam of the kill/restore drill.
        with srv._lock:
            t2 = time.perf_counter()
            self.worker.push(keys, vals)
            plane.cursor[0] = end
        parts = self.parts_s
        parts["events_s"] += t1 - t0
        parts["lock_s"] += t2 - t1
        parts["push_s"] += time.perf_counter() - t2
        parts["cpu_s"] += time.thread_time() - c0
        plane.c_events.inc(self.batch)
        plane.c_batches.inc()
        plane.c_acked.inc(self.batch)
        if replayed:
            plane.c_replayed.inc(self.batch)
        return end

    def run_until(self, n_events: int) -> int:
        """Step inline until the cursor reaches (at least) `n_events`.
        Returns the cursor."""
        while int(self.plane.cursor[0]) < int(n_events):
            self.step()
        return self.cursor

    def replay_tail(self, acked_watermark: int) -> int:
        """Post-restore: re-apply the tail between the RESTORED cursor
        and the pre-kill ack watermark (module docstring step 4). The
        re-applied events are counted loudly into
        stream.replayed_events_total. Returns how many were replayed."""
        replayed = 0
        while int(self.plane.cursor[0]) < int(acked_watermark):
            before = int(self.plane.cursor[0])
            self.step(replayed=True)
            replayed += int(self.plane.cursor[0]) - before
        return replayed

    # -- executor pump -------------------------------------------------------

    def start(self, target_events: Optional[int] = None) -> None:
        """Run the pump on the executor's `stream` stream until
        `target_events` (None = until close())."""
        self._target = None if target_events is None \
            else int(target_events)
        self._due = time.monotonic()
        self._resubmit(0.0)

    def _resubmit(self, delay: float) -> None:
        if self._closed:
            return
        self.parts_s["paced_s"] += delay
        self._release = time.monotonic() + delay
        self.server.exec.submit(
            "stream", self._pump, label="stream.ingest",
            coalesce_key=f"stream.ingest.{id(self)}", delay=delay)

    def _pump(self) -> None:
        if self._closed or self.server.exec.closed:
            return
        self.parts_s["queue_s"] += max(0.0,
                                       time.monotonic() - self._release)
        tgt = self._target
        if tgt is not None and int(self.plane.cursor[0]) >= tgt:
            return  # target reached: park (start() re-arms)
        try:
            self.step()
        finally:
            if self.rate > 0:
                # fixed-cadence schedule: each batch is due batch/rate
                # after the previous DUE time (not after it finished),
                # so transient slow batches don't permanently lower
                # the achieved rate
                self._due = max(self._due + self.batch / self.rate,
                                time.monotonic() - 1.0)
                delay = max(0.0, self._due - time.monotonic())
            else:
                delay = 0.0
            self._resubmit(delay)

    def close(self, timeout: float = 30.0) -> None:
        """Stop the pump and drain any queued ingest program. Called
        by StreamPlane.close() during Server.shutdown BEFORE the
        executor closes (the pump pushes through the live pools)."""
        if self._closed:
            return
        self._closed = True
        ex = self.server.exec
        if not ex.closed and not ex.drain("stream", timeout=timeout):
            from ..utils import alog
            alog("[stream] ingest pump failed to drain within "
                 f"{timeout:.0f}s — wedged mid-push?")
            raise RuntimeError(
                "stream ingest pump wedged: did not drain within "
                f"{timeout:.0f}s of close; refusing to proceed into "
                "pool teardown under a live pusher")
