"""Workload trace capture: the semantic op stream, recorded once and
replayable (the JAX package's `obs/wtrace.py`, on the port's Server).

With `--sys.trace.workload PATH` (default off) the
`WorkloadTraceRecorder` records the workload's op stream — pull, push
and set key batches, intent windows, clock advances, serve lookups with
tenant, priority and deadline, PrepareSample/PullSample, sync rounds,
quiesces, and the relocation and promotion decisions as they landed —
into a versioned, checksummed `.wtrace` file. The replay engine
(`adapm_tpu_torch/replay`) re-drives it against a fresh server under
candidate knob overrides.

The file format is the JAX package's, byte for byte in its layout: the
same format name and version, the one-line JSON header (format,
version, body sha256, body byte count) and the compact JSON body. A
trace captured by either package loads and replays in the other.

  - Default off: `Server.wtrace is None`, every instrumented site pays
    one `is None` check, and the registry holds no `wtrace.*` name.
  - Lossless or loudly sampled: key batches up to
    `--sys.trace.workload_keys` record their exact keys; larger batches
    record an evenly strided sample, the true count and a `sampled`
    marker (`wtrace.sampled_batches_total`). Events beyond the buffer's
    bounds are counted in `wtrace.dropped_total` and logged once.
  - Both clock domains: every event carries the logical clock, `wall`
    (`time.time()`) and `mono` (`time.monotonic()`).
  - Atomic, checksummed file: `flush()` writes through
    `utils.write_atomic` (tmp + fsync + rename); `load_wtrace` checks
    format, version, length and digest before it parses the body, and
    raises `WorkloadTraceError` on a truncated or flipped file.

Event kinds (`kind`): `pull` / `push` / `set` (wid, clock, keys),
`intent` (keys, start, end), `clock`, `serve` (keys, tenant, priority,
deadline_ms), `prep_sample` / `pull_sample` / `finish_sample` (handle,
n, window), `sync` (forced, all, wire bytes), `quiesce`, and the
observed decisions `reloc` / `promote`.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import zlib
from typing import Dict, List, Optional

import numpy as np

from ..utils import write_atomic as _write_atomic

WTRACE_FORMAT = "adapm-wtrace"
WTRACE_VERSION = 1

# bounds on the buffered stream (a loud drop counter beyond either); the
# byte bound is an approximate host-memory guard
DEFAULT_MAX_EVENTS = 1_000_000
DEFAULT_MAX_BYTES = 256 * 1024 * 1024


class WorkloadTraceError(RuntimeError):
    """The `.wtrace` file is unreadable: wrong format or version,
    truncated body, checksum mismatch, or malformed JSON. Raised by
    `load_wtrace` before any replay server exists."""


# ---------------------------------------------------------------------------
# shared trace-file machinery: the decision trace (obs/decisions.py) and
# the policy artifact (policy/model.py) write and verify through it too
# ---------------------------------------------------------------------------


def write_trace_file(path: str, doc: Dict, fmt: str,
                     version: int) -> int:
    """Serialize `doc` and write it atomically as a one-line JSON
    header (format, version, body sha256, body byte count) + JSON
    body. Returns the total bytes written."""
    body = json.dumps(doc, separators=(",", ":")).encode()
    header = json.dumps(
        {"format": fmt, "version": version,
         "body_sha256": hashlib.sha256(body).hexdigest(),
         "body_bytes": len(body)}).encode()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    _write_atomic(path, header + b"\n" + body)
    return len(header) + 1 + len(body)


def load_trace_doc(path: str, fmt: str, version: int, err_cls,
                   noun: str) -> Dict:
    """Read and verify one header-lined trace file; returns the parsed
    body dict. Format, version, length and sha256 are checked before the
    body is parsed; any failure raises the caller's `err_cls`."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise err_cls(f"cannot read {noun} {path!r}: {e}") from e
    nl = raw.find(b"\n")
    if nl < 0:
        raise err_cls(f"{noun} {path!r}: missing header line "
                      f"(truncated or not a {fmt} file)")
    try:
        header = json.loads(raw[:nl])
    except ValueError as e:
        raise err_cls(f"{noun} {path!r}: unparseable header: {e}") from e
    if header.get("format") != fmt:
        raise err_cls(f"{noun} {path!r}: format "
                      f"{header.get('format')!r} is not {fmt!r}")
    if header.get("version") != version:
        raise err_cls(f"{noun} {path!r}: version "
                      f"{header.get('version')!r} unsupported (this "
                      f"build reads v{version})")
    body = raw[nl + 1:]
    want_bytes = header.get("body_bytes")
    if want_bytes != len(body):
        raise err_cls(f"{noun} {path!r}: body is {len(body)} bytes, "
                      f"header promised {want_bytes} (truncated "
                      f"write?)")
    if hashlib.sha256(body).hexdigest() != header.get("body_sha256"):
        raise err_cls(f"{noun} {path!r}: body sha256 mismatch "
                      f"(bit flip / partial overwrite) — refusing to "
                      f"load")
    try:
        return json.loads(body)
    except ValueError as e:
        raise err_cls(f"{noun} {path!r}: checksummed body failed to "
                      f"parse ({e}) — file written by an incompatible "
                      f"recorder?") from e


def options_doc(opts) -> Dict:
    """The server's SystemOptions as plain JSON values (enums by value):
    the `knobs` block of a trace's meta."""
    import dataclasses
    import enum
    return {k: v.value if isinstance(v, enum.Enum) else v
            for k, v in dataclasses.asdict(opts).items()}


class WorkloadTraceRecorder:
    """One per Server when `--sys.trace.workload` names a path; owned
    and closed by the server (shutdown, after every producer stopped).
    Thread-safe: client threads, executor programs and sync rounds
    record concurrently under one small lock (append and counter bumps
    only — never a device wait, never the server lock)."""

    def __init__(self, server, path: str, key_budget: int = 4096,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        from .metrics import Counter, Gauge
        if not path:
            raise ValueError("workload trace capture needs a path "
                             "(--sys.trace.workload)")
        self._server = server
        self.path = path
        self.key_budget = max(1, int(key_budget))
        self.max_events = int(max_events)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        # serializes snapshot -> serialize -> rename, so a mid-run flush
        # racing close() cannot publish an older snapshot over a newer one
        self._flush_lock = threading.Lock()
        self._events: List[Dict] = []
        self._approx_bytes = 0
        self._seq = 0
        self._closed = False
        self._flushes = 0
        self._warned_drop = False
        self.wall_t0 = time.time()
        self.mono_t0 = time.monotonic()
        reg = server.obs
        if reg is not None and reg.enabled:
            self.c_events = reg.counter("wtrace.events_total")
            self.c_dropped = reg.counter("wtrace.dropped_total")
            self.c_sampled = reg.counter("wtrace.sampled_batches_total")
            self.g_bytes = reg.gauge("wtrace.bytes_written")
        else:  # capture works with --sys.metrics 0 (standalone tallies)
            self.c_events = Counter("wtrace.events_total")
            self.c_dropped = Counter("wtrace.dropped_total")
            self.c_sampled = Counter("wtrace.sampled_batches_total")
            self.g_bytes = Gauge("wtrace.bytes_written")

    # -- recording -----------------------------------------------------------

    def _server_clock(self) -> int:
        c = self._server._clocks
        return int(c.max()) if len(c) else 0

    def _key_fields(self, keys: np.ndarray) -> Dict:
        """Exact keys up to the budget; an evenly strided sample plus the
        true count beyond it (counted, never a silent truncation)."""
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        n = len(keys)
        out: Dict = {"n": int(n), "fp": int(zlib.crc32(keys.tobytes()))}
        if n <= self.key_budget:
            out["keys"] = keys.tolist()
        else:
            stride = -(-n // self.key_budget)  # ceil: <= budget samples
            out["sample"] = keys[::stride].tolist()
            out["sampled"] = True
            self.c_sampled.inc()
        return out

    def _append(self, ev: Dict) -> None:
        # approximate resident cost: fixed stamps + the boxed key ints
        cost = 96 + 8 * (len(ev.get("keys", ())) +
                         len(ev.get("sample", ())))
        with self._lock:
            if self._closed:
                return
            if len(self._events) >= self.max_events or \
                    self._approx_bytes + cost > self.max_bytes:
                self.c_dropped.inc()
                if not self._warned_drop:
                    self._warned_drop = True
                    from ..utils import alog
                    alog(f"[wtrace] event buffer full "
                         f"({len(self._events)} events, "
                         f"~{self._approx_bytes >> 20} MiB); further "
                         f"events are DROPPED (counted in "
                         f"wtrace.dropped_total) — the captured trace "
                         f"is a loud prefix")
                return
            ev["seq"] = self._seq
            self._seq += 1
            self._events.append(ev)
            self._approx_bytes += cost
        self.c_events.inc()

    def _base(self, kind: str, clock: int,
              wid: Optional[int] = None) -> Dict:
        ev: Dict = {"kind": kind, "clock": int(clock),
                    "wall": time.time(), "mono": time.monotonic()}
        if wid is not None:
            ev["wid"] = int(wid)
        return ev

    def record_kv(self, op: str, wid: int, clock: int,
                  keys: np.ndarray) -> None:
        """A worker data-plane op: op in {"pull", "push", "set"}."""
        ev = self._base(op, clock, wid)
        ev.update(self._key_fields(keys))
        self._append(ev)

    def record_intent(self, wid: int, clock: int, keys: np.ndarray,
                      start: int, end: int) -> None:
        ev = self._base("intent", clock, wid)
        ev.update(self._key_fields(keys))
        ev["start"] = int(start)
        ev["end"] = min(int(end), 2**62)  # CLOCK_MAX stays JSON-safe
        self._append(ev)

    def record_clock(self, wid: int, clock: int) -> None:
        self._append(self._base("clock", clock, wid))

    def record_serve(self, keys: np.ndarray, tenant: Optional[str],
                     priority: int, deadline_ms: float) -> None:
        ev = self._base("serve", self._server_clock())
        ev.update(self._key_fields(keys))
        ev["tenant"] = tenant
        ev["priority"] = int(priority)
        ev["deadline_ms"] = float(deadline_ms or 0.0)
        self._append(ev)

    def record_sample(self, op: str, wid: int, clock: int, handle: int,
                      n: Optional[int], start: Optional[int] = None,
                      end: Optional[int] = None) -> None:
        """Managed-sampling lifecycle: op in {"prep_sample",
        "pull_sample", "finish_sample"}."""
        ev = self._base(op, clock, wid)
        ev["handle"] = int(handle)
        if n is not None:
            ev["n"] = int(n)
        if start is not None:
            ev["start"] = int(start)
        if end is not None:
            ev["end"] = int(end)
        self._append(ev)

    def record_sync(self, forced: bool, all_channels: bool,
                    bytes_shipped: int) -> None:
        """A completed sync round: replay re-drives these where the
        workload put them, instead of running a timer-driven loop."""
        ev = self._base("sync", self._server_clock())
        ev["forced"] = bool(forced)
        ev["all"] = bool(all_channels)
        ev["bytes"] = int(bytes_shipped)
        self._append(ev)

    def record_quiesce(self) -> None:
        self._append(self._base("quiesce", self._server_clock()))

    def record_decision(self, kind: str, n: int, **fields) -> None:
        """A management decision as it landed (kind in {"reloc",
        "promote"}): observational — replay lets the candidate policy
        re-decide."""
        ev = self._base(kind, self._server_clock())
        ev["n"] = int(n)
        ev.update(fields)
        self._append(ev)

    # -- meta / stats --------------------------------------------------------

    def _meta(self) -> Dict:
        srv = self._server
        lens = srv.value_lengths
        uniform = len(np.unique(lens)) == 1
        return {"num_keys": int(srv.num_keys),
                "value_lengths": (int(lens[0]) if uniform
                                  else [int(x) for x in lens]),
                "num_shards": int(srv.ctx.num_shards),
                "rank": int(srv.pid),
                "key_budget": self.key_budget,
                "wall_t0": self.wall_t0,
                "mono_t0": self.mono_t0,
                "knobs": options_doc(srv.opts)}

    def stats(self) -> Dict:
        """Plain values for `metrics_snapshot()["wtrace"]` (the registry's
        wtrace.* counters land in the same section)."""
        with self._lock:
            n = len(self._events)
        return {"path": self.path, "events_buffered": n,
                "flushes": self._flushes, "closed": self._closed}

    # -- flush / close -------------------------------------------------------

    def flush(self) -> str:
        """Write the full trace (header line + checksummed JSON body)
        atomically; returns the path. Safe mid-run: concurrent flushes
        serialize, so the file on disk is always some complete snapshot
        and snapshots publish in order."""
        with self._flush_lock:
            with self._lock:
                doc = {"meta": self._meta(),
                       "events": list(self._events),
                       "dropped": int(self.c_dropped.value)}
            nbytes = write_trace_file(self.path, doc, WTRACE_FORMAT,
                                      WTRACE_VERSION)
            with self._lock:
                self._flushes += 1
            self.g_bytes.set(float(nbytes))
        return self.path

    def close(self) -> None:
        """Final flush and seal (idempotent); events recorded after close
        are ignored."""
        with self._lock:
            if self._closed:
                return
        self.flush()
        with self._lock:
            self._closed = True


# ---------------------------------------------------------------------------
# loading (the replay engine and tooling)
# ---------------------------------------------------------------------------


class WorkloadTrace:
    """A verified, parsed `.wtrace`: `meta` dict + `events` list (seq
    order). Construction from `load_wtrace` implies the checksum
    passed."""

    __slots__ = ("path", "meta", "events", "dropped")

    def __init__(self, path: str, meta: Dict, events: List[Dict],
                 dropped: int):
        self.path = path
        self.meta = meta
        self.events = events
        self.dropped = dropped

    @property
    def value_lengths(self):
        return self.meta["value_lengths"]

    def max_worker_id(self) -> int:
        return max((ev.get("wid", 0) for ev in self.events), default=0)

    def kinds(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            out[ev["kind"]] = out.get(ev["kind"], 0) + 1
        return out


def event_keys(ev: Dict, rng: Optional[np.random.Generator] = None,
               ) -> np.ndarray:
    """The event's key batch. Exact events return their recorded keys;
    sampled events draw a batch of the true size from the recorded
    sample with the caller's seeded `rng` (required for them)."""
    if "keys" in ev:
        return np.asarray(ev["keys"], dtype=np.int64)
    sample = np.asarray(ev["sample"], dtype=np.int64)
    if rng is None:
        raise ValueError(
            f"event seq={ev.get('seq')} was key-sampled at capture "
            f"(n={ev['n']} > budget); reconstructing its batch needs "
            f"a seeded rng")
    return rng.choice(sample, size=int(ev["n"]), replace=True)


def load_wtrace(path: str) -> WorkloadTrace:
    """Read and verify a `.wtrace` file. Raises `WorkloadTraceError` on a
    missing, truncated, corrupt or incompatible file."""
    doc = load_trace_doc(path, WTRACE_FORMAT, WTRACE_VERSION,
                         WorkloadTraceError, "workload trace")
    try:
        meta = doc["meta"]
        events = doc["events"]
    except (KeyError, TypeError) as e:
        raise WorkloadTraceError(
            f"workload trace {path!r}: checksummed body failed to "
            f"parse ({e}) — file written by an incompatible "
            f"recorder?") from e
    return WorkloadTrace(path, meta, events, int(doc.get("dropped", 0)))
