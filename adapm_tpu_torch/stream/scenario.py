"""North-star scenario (the JAX package's `stream/scenario.py`;
chip_smoke.py phase 18 runs it on the card): the whole system story on one artifact — a PM that trains
CONTINUOUSLY from a click-event stream while serving multi-tenant
embedding-bag reads, checkpoints incrementally, survives a mid-stream
kill/restore, and captures a `.wtrace` of the run.

One `run_northstar()` call drives, in order:

  1. **segment A** — executor-pumped ingest (`StreamTrainer.start`)
     + inline multi-tenant `lookup_bags` load (gold: hot bags at
     priority 1; bronze: uniform bags on a short deadline) + periodic
     incremental checkpoints (`IncrementalCheckpointer.start_periodic`
     on the `ckpt` stream) + workload-trace capture;
  2. **kill** — the server is shut down mid-stream (the last
     checkpoint link deliberately LAGS the live acked cursor);
  3. **restore** — a fresh server restores the chain
     (`restore_chain`; wall time = the artifact's `recovery_s`), a
     resumed trainer `replay_tail`s the gap between the restored
     cursor and the pre-kill ack watermark (counted loudly into
     `stream.replayed_events_total` — the at-least-once half of the
     drill; tests/test_torch_stream.py pins the exactly-once half
     bitwise, and `on_replayed` lets a caller hold the replayed table
     to an unkilled shadow);
  4. **segment B** — ingest + serve resume on the restored state; the
     FreshnessSLO controller walks its levers the whole time and the
     TRAILING window of `flight.freshness_s` scores the closed loop
     (`freshness.p99_ms`).

Threading discipline: ingest, checkpoints, and the freshness
controller all run as executor programs (`stream` / `ckpt` /
`stream.slo` streams); the serve load is driven INLINE from the
caller's thread — package code spawns no raw threads, and parking a load loop on the shared executor pool would starve the very
programs it measures.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs.metrics import hist_percentile
from .ingest import EventLog, StreamTrainer

# the deliberately-lazy static knobs segment A/B start from: the
# controller (not the operator) is what tightens the loop
_STATIC_SYNC_RATE = 2.0
_STATIC_REFRESH_MS = 250.0


def _opts(batch: int, rate: float, slo_ms: float,
          wtrace_path: Optional[str]):
    from ..config import SystemOptions
    return SystemOptions(
        sync_max_per_sec=_STATIC_SYNC_RATE,
        prefetch=False,
        metrics=True,
        trace_flight=True,
        serve_replica_rows=1024,
        serve_replica_refresh_ms=_STATIC_REFRESH_MS,
        serve_max_wait_us=200,
        stream_batch=batch,
        stream_rate=rate,
        stream_freshness_slo_ms=slo_ms,
        trace_workload=wtrace_path,
        trace_workload_keys=256)


def _build(num_keys: int, vlen: int, opts, hot: np.ndarray, device=None):
    """Server (on `device`, default the card) + warmed serve plane +
    tenant sessions. Returns (server, plane, {tenant: session})."""
    import adapm_tpu_torch
    from ..serve import ServePlane

    srv = adapm_tpu_torch.setup(num_keys, vlen, opts=opts, num_workers=4,
                                device=device)
    w = srv.make_worker(0)
    rng = np.random.default_rng(3)
    slab = 4096
    for lo in range(0, num_keys, slab):
        hi = min(lo + slab, num_keys)
        w.set(np.arange(lo, hi),
              rng.normal(size=(hi - lo, vlen)).astype(np.float32))
    srv.block()
    plane = ServePlane(srv)
    plane.configure_tenant("gold", priority=1)
    plane.configure_tenant("bronze", priority=0)
    sessions = {"gold": plane.session(tenant="gold"),
                "bronze": plane.session(tenant="bronze")}
    # score the hot working set into the replica and snapshot it once,
    # so segment reads start on the lock-free path (the refresh lever
    # then governs how stale that path is allowed to run)
    sessions["gold"].lookup(hot)
    if plane.replica is not None:
        plane.replica.refresh_now()
    return srv, plane, sessions


def _serve_segment(srv, sessions, num_keys: int, hot: np.ndarray,
                   seconds: float, seed: int,
                   trailing_s: float = 0.0):
    """Inline multi-tenant bag load for `seconds`. Returns
    (gold_latencies_s, sheds, freshness_snap_at_trailing_mark) — the
    mark is the cumulative `flight.freshness_s` snapshot taken
    `trailing_s` before the segment end (None when trailing_s == 0),
    so the caller can window the tail of the segment."""
    from ..serve import DeadlineExceededError, ServeOverloadError

    rng = np.random.default_rng(seed)
    h_fresh = srv.flight.freshness.h_freshness
    lat: List[float] = []
    sheds = 0
    mark = None
    i = 0
    t_end = time.monotonic() + seconds
    while time.monotonic() < t_end:
        # gold: 16 bags x 4 members from the hot head (replica-covered)
        members = rng.choice(hot, 64).astype(np.int64)
        offs = np.arange(0, 65, 4, dtype=np.int64)
        t0 = time.perf_counter()
        sessions["gold"].lookup_bags([members], [offs])
        lat.append(time.perf_counter() - t0)
        if i % 3 == 0:
            # bronze: uniform members, short deadline — sheds loudly
            # under pressure instead of dragging gold's lane
            mem_b = rng.integers(0, num_keys, 32).astype(np.int64)
            offs_b = np.arange(0, 33, 8, dtype=np.int64)
            try:
                sessions["bronze"].lookup_bags([mem_b], [offs_b],
                                               deadline_ms=25.0)
            except (DeadlineExceededError, ServeOverloadError):
                sheds += 1
        if mark is None and trailing_s > 0 and \
                time.monotonic() >= t_end - trailing_s:
            mark = h_fresh.snap()
        i += 1
    return lat, sheds, mark


def _window(end: Dict, start: Optional[Dict]) -> Optional[Dict]:
    """The samples a cumulative histogram gained since the snapshot
    `start`, as a histogram snapshot (None when there are none)."""
    if start is None or end["count"] - start["count"] <= 0:
        return None
    return {"count": end["count"] - start["count"],
            "bounds": end["bounds"],
            "buckets": [a - b for a, b in zip(end["buckets"],
                                              start["buckets"])]}


def _pctl(sorted_lat: List[float], q: float) -> Optional[float]:
    if not sorted_lat:
        return None
    return sorted_lat[min(len(sorted_lat) - 1,
                          int(q * len(sorted_lat)))]


def run_northstar(num_keys: int = 8192, vlen: int = 16,
                  batch: int = 32, rate: float = 2000.0,
                  freshness_slo_ms: float = 400.0,
                  segment_s: float = 3.0, ckpt_every_s: float = 0.75,
                  trailing_s: float = 1.5, seed: int = 7,
                  workdir: Optional[str] = None, device=None,
                  on_replayed: Optional[Callable] = None,
                  segment_b_s: Optional[float] = None) -> Dict:
    """Run the full scenario (module docstring) on `device` (default:
    the card); segment B lasts `segment_b_s` (default `segment_s`).
    `workdir` (a fresh directory; a tempdir when None)
    receives the checkpoint chain and the captured `northstar.wtrace`;
    the returned artifact carries `wtrace_path` so the caller can
    replay it (chip_smoke.py phase 18 holds the reads digest stable
    across two replays). `on_replayed(server)`, when given, runs right
    after `replay_tail`, before segment B writes: where a caller reads
    the restored-and-replayed table."""
    import tempfile

    from ..fault.ckpt import IncrementalCheckpointer, restore_chain

    own_tmp = None
    if workdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="adapm_northstar_")
        workdir = own_tmp.name
    chain_dir = os.path.join(workdir, "chain")
    wtrace_path = os.path.join(workdir, "northstar.wtrace")
    hot = np.arange(512, dtype=np.int64)
    log = EventLog(num_keys, seed=seed, keys_per_event=8)
    if segment_b_s is None:
        segment_b_s = segment_s
    trailing_s = min(trailing_s, segment_b_s)
    try:
        # -- segment A: ingest + serve + periodic checkpoints ---------
        opts = _opts(batch, rate, freshness_slo_ms, wtrace_path)
        srv, plane, sessions = _build(num_keys, vlen, opts, hot, device)
        trainer = StreamTrainer(srv, log)
        ck = IncrementalCheckpointer(srv, chain_dir)
        ck.save()                       # base link before the stream
        ck.start_periodic(ckpt_every_s)
        trainer.start()
        t0 = time.perf_counter()
        lat_a, sheds_a, _ = _serve_segment(
            srv, sessions, num_keys, hot, segment_s, seed + 1)
        wall_a = time.perf_counter() - t0
        events_a = int(srv.stream.c_events.value)
        parts_a = dict(trainer.parts_s)
        # -- kill (mid-stream: the chain's cursor lags the live one) --
        # stop the periodic SAVER only (no final flush — the restore
        # below must land BEHIND the live acked cursor, that is the
        # drill); the trainer keeps pumping until shutdown drains it
        ck.close()
        srv.shutdown()
        acked = int(srv.stream.cursor[0])
        # -- restore + replay the acked tail --------------------------
        opts_b = _opts(batch, rate, freshness_slo_ms, None)
        srv2, plane2, sessions2 = _build(num_keys, vlen, opts_b, hot,
                                         device)
        recovery_s = restore_chain(srv2, chain_dir)
        restored = int(srv2.stream.cursor[0])
        trainer2 = StreamTrainer(srv2, log)
        replayed = trainer2.replay_tail(acked)
        if int(srv2.stream.cursor[0]) != acked:
            raise RuntimeError(
                f"replay_tail stopped at cursor "
                f"{int(srv2.stream.cursor[0])} != acked watermark "
                f"{acked} — the at-least-once contract is broken")
        if on_replayed is not None:
            on_replayed(srv2)
        # -- segment B: resume on the restored state ------------------
        ck2 = IncrementalCheckpointer(srv2, chain_dir)
        ck2.start_periodic(ckpt_every_s)
        fl = srv2.flight   # _opts sets trace_flight — the sensor is on
        fresh_b0 = fl.freshness.h_freshness.snap()
        parts_b0 = dict(trainer2.parts_s)   # replay_tail's steps
        events_b0 = int(srv2.stream.c_events.value)
        trainer2.start()
        t0 = time.perf_counter()
        lat_b, sheds_b, mark = _serve_segment(
            srv2, sessions2, num_keys, hot, segment_b_s, seed + 2,
            trailing_s=trailing_s)
        wall_b = time.perf_counter() - t0
        fresh_end = fl.freshness.h_freshness.snap()
        events_b = int(srv2.stream.c_events.value) - events_b0
        parts_b = {k: v - parts_b0[k]
                   for k, v in trainer2.parts_s.items()}
        slo_rep = (srv2.stream.freshness.report()
                   if srv2.stream.freshness is not None else None)
        snap = srv2.metrics_snapshot()
        ck2.close()
        srv2.shutdown()
        # trailing freshness window: cumulative histogram diffed
        # against the mark taken `trailing_s` before segment B's end —
        # the controller has had the whole run to walk its levers
        win = _window(fresh_end, mark)
        seg_b = _window(fresh_end, fresh_b0)
        lat = sorted(lat_a + lat_b)
        p50 = _pctl(lat, 0.50)
        p99 = _pctl(lat, 0.99)
        return {
            "num_keys": num_keys, "vlen": vlen,
            "stream_batch": batch, "stream_rate": rate,
            "freshness_slo_ms": freshness_slo_ms,
            "events_per_sec": round(
                (events_a + events_b) / (wall_a + wall_b), 1),
            "events_applied": events_a + events_b,
            # where the pump's host seconds went in each segment
            # (StreamTrainer.parts_s), beside the segment's wall time
            "ingest": {"A": dict(parts_a, wall_s=wall_a, events=events_a),
                       "B": dict(parts_b, wall_s=wall_b, events=events_b)},
            "served_lookups": len(lat),
            "served_p50_ms": round(1e3 * p50, 3) if p50 else None,
            "served_p99_ms": round(1e3 * p99, 3) if p99 else None,
            "bronze_sheds": sheds_a + sheds_b,
            "freshness": {
                "target_ms": freshness_slo_ms,
                "trailing_window_s": trailing_s,
                "samples": int(win["count"]) if win else 0,
                "p50_ms": round(1e3 * hist_percentile(win, 0.50), 3)
                if win else None,
                "p99_ms": round(1e3 * hist_percentile(win, 0.99), 3)
                if win else None,
                "segment_b_samples": int(seg_b["count"]) if seg_b else 0,
                "segment_b_p99_ms": round(
                    1e3 * hist_percentile(seg_b, 0.99), 3)
                if seg_b else None,
                "cumulative_samples": int(fresh_end["count"]),
                "cumulative_p99_ms": round(
                    1e3 * hist_percentile(fresh_end, 0.99), 3)
                if fresh_end["count"] else None},
            "freshness_slo": slo_rep,
            "drill": {
                "acked_at_kill": acked,
                "restored_cursor": restored,
                "replayed_events": replayed,
                "recovery_s": round(recovery_s, 3)},
            "stream_section": snap["stream"],
            "wtrace_path": (wtrace_path
                            if os.path.exists(wtrace_path) and
                            own_tmp is None else None),
        }
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()
