"""Streaming plane (the JAX package's `stream/`): the PM as a
continuously-trained online service — train-while-serve as a
first-class subsystem.

Three pieces:

  - `ingest`    — `EventLog` (seeded, bounded, regenerable-by-index
    click events) + `StreamTrainer` (micro-batched fused Push steps on
    the executor's `stream` stream, with the acked-event cursor
    committed under the same lock hold as each push's enqueue — the
    exactly-once seam the kill/restore drill proves);
  - `freshness` — `FreshnessSLO`, the closed loop over
    event-to-servable staleness: the obs/slo.py control law
    re-targeted at `flight.freshness_s`, walking the effective sync
    rate and the serve-replica refresh window against
    `--sys.stream.freshness_slo_ms`;
  - `scenario`  — the north-star harness (chip_smoke.py phase 18):
    continuous ingest + multi-tenant `lookup_bags` serving + periodic
    incremental checkpoints + a mid-stream kill/restore drill + a
    captured `.wtrace`, emitting events/s, served P99, freshness P99,
    and recovery_s on one artifact.

Default off: with no `--sys.stream.*` knob set the Server holds
`stream = None`, every integration site pays one `is None` check, and
the registry holds zero `stream.*` names.

Quickstart::

    opts = SystemOptions(stream_batch=32, stream_rate=2000,
                         stream_freshness_slo_ms=400,
                         trace_flight=True)
    server = adapm_tpu_torch.setup(num_keys, value_lengths, opts=opts)
    log = EventLog(num_keys, seed=7)
    trainer = StreamTrainer(server, log)
    trainer.start()                     # executor pump
    ...serve reads, checkpoints...
    server.shutdown()                   # closes the plane
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .freshness import FreshnessSLO  # noqa: F401
from .ingest import EventLog, StreamTrainer  # noqa: F401


class StreamPlane:
    """Owned by the Server when any `--sys.stream.*` knob is set:
    holds the acked-event cursor (the array the checkpoint chain
    captures as `aux_stream_cursor`), the ingest accounting counters,
    and — with `--sys.stream.freshness_slo_ms` — the FreshnessSLO
    controller. Built after the sync manager (the controller's first
    lever) and closed by `Server.shutdown()` BEFORE the executor."""

    def __init__(self, server):
        opts = server.opts
        self.server = server
        # acked-event horizon: events [0, cursor) are applied exactly
        # once. An int64 ARRAY cell (not a plain int) so checkpoint
        # capture snapshots it with np.array_equal/copy like every
        # other aux table, and restore writes it back in place.
        self.cursor = np.zeros(1, dtype=np.int64)
        self.trainer = None  # attached by StreamTrainer.__init__
        reg = server.obs
        self.c_events = reg.counter("stream.events_total", shared=True)
        self.c_batches = reg.counter("stream.batches_total",
                                     shared=True)
        self.c_acked = reg.counter("stream.acked_events_total",
                                   shared=True)
        self.c_replayed = reg.counter("stream.replayed_events_total",
                                      shared=True)
        if reg.enabled:
            reg.gauge("stream.cursor", shared=True,
                      fn=lambda: int(self.cursor[0]))
        self.freshness = None
        base = float(opts.stream_freshness_slo_ms)
        if base > 0:
            from ..config import parse_class_targets
            cls = parse_class_targets(
                base, opts.stream_freshness_slo_class,
                flag="--sys.stream.freshness_slo_ms")
            self.freshness = FreshnessSLO(server, base,
                                          class_targets=cls)

    def start(self) -> None:
        if self.freshness is not None:
            self.freshness.start()

    def close(self) -> None:
        """Idempotent; called by Server.shutdown() before the executor
        closes (the trainer pump pushes through the live pools)."""
        t = self.trainer
        if t is not None:
            t.close()
        if self.freshness is not None:
            self.freshness.close()

    def stats(self) -> Dict:
        """The `stream` snapshot section (present when the plane is
        on)."""
        out: Dict = {"cursor": int(self.cursor[0]),
                     "events_total": int(self.c_events.value),
                     "batches_total": int(self.c_batches.value),
                     "acked_events_total": int(self.c_acked.value),
                     "replayed_events_total":
                         int(self.c_replayed.value)}
        t = self.trainer
        if t is not None:
            out["trainer"] = t.stats()
        if self.freshness is not None:
            out["freshness"] = self.freshness.report()
        return out
