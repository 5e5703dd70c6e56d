"""Span tracer: begin/end events for named phases, Perfetto-loadable.

`SpanTracer.span(name)` brackets a phase; completed spans are stored as
(thread, name, start_us, dur_us) tuples and exported as Chrome
trace-event JSON (`ph: "X"` complete events + thread-name metadata),
which chrome://tracing and https://ui.perfetto.dev load directly.

Off by default (`--sys.trace.spans`); when off the Server holds no
tracer and instrumented sites pay one `is None` check (or enter
`NULL_SPAN`, a shared no-op context manager).

Crash breadcrumb: when given a breadcrumb path, the
tracer overwrites a small fixed-size file with the span name + wall time
at every span BEGIN (one `pwrite`, no seek state). After a hard abort
the file names the phase the process died inside.

Memory is bounded: beyond `max_events` spans
(`--sys.trace.spans.max_events`, validated >= 1000 in config.py), new
ones are counted as dropped instead of stored — loudly: one warning
log on the first drop plus the `spans.dropped` registry counter,
and the exported trace states the truncation.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

_BREADCRUMB_WIDTH = 256


class _NullSpan:
    """Shared no-op context manager for disabled tracing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "t0")

    def __init__(self, tracer: "SpanTracer", name: str):
        self.tracer = tracer
        self.name = name
        self.t0 = 0.0

    def __enter__(self):
        # apm-lint: disable=APM003 a _Span is only ever constructed BY
        # a live SpanTracer (disabled tracing hands out NULL_SPAN), so
        # this tracer attribute is never the optional server handle
        self.t0 = self.tracer.begin(self.name)
        return self

    def __exit__(self, *exc):
        # apm-lint: disable=APM003 same invariant as __enter__ above
        self.tracer.end(self.name, self.t0)
        return False


class SpanTracer:
    def __init__(self, rank: int = 0, max_events: int = 1_000_000,
                 breadcrumb_path: Optional[str] = None, registry=None):
        self.rank = rank
        self.max_events = max_events
        self.dropped = 0
        # overflow drops are loud: a registry
        # counter when the server's registry is live, else the plain
        # `dropped` tally alone (spans.* names exist only while a
        # tracer does — the skip-wrapper naming discipline)
        self._c_dropped = None
        if registry is not None and registry.enabled:
            self._c_dropped = registry.counter("spans.dropped")
        self._warned_drop = False
        # (tid, name, t0_us, dur_us); list.append is atomic under the GIL
        self._events: List[Tuple[int, str, float, float]] = []
        self._t0 = time.perf_counter()
        self._bc_fd = None
        self._bc_path = breadcrumb_path
        if breadcrumb_path:
            self._bc_fd = os.open(breadcrumb_path,
                                  os.O_CREAT | os.O_WRONLY, 0o644)

    # -- recording -----------------------------------------------------------

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def begin(self, name: str) -> float:
        if self._bc_fd is not None:
            line = (f"{name} thread={threading.current_thread().name} "
                    f"wall={time.time():.3f}\n").encode()
            os.pwrite(self._bc_fd, line.ljust(_BREADCRUMB_WIDTH), 0)
        return time.perf_counter()

    def end(self, name: str, t0: float) -> None:
        t1 = time.perf_counter()
        if len(self._events) >= self.max_events:
            self.dropped += 1
            if self._c_dropped is not None:
                self._c_dropped.inc()
            if not self._warned_drop:
                self._warned_drop = True
                from ..utils import alog
                alog(f"[spans] event buffer full ({self.max_events} "
                     f"spans; --sys.trace.spans.max_events); further "
                     f"spans are DROPPED (counted in spans.dropped) — "
                     f"the exported trace is a loud prefix, not a "
                     f"silent lie")
            return
        self._events.append((threading.get_ident(), name,
                             (t0 - self._t0) * 1e6, (t1 - t0) * 1e6))

    # -- export --------------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        return {"events": len(self._events), "dropped": self.dropped}

    def export(self, path: str) -> str:
        """Write Chrome trace-event JSON; returns the path."""
        events = list(self._events)
        tids: Dict[int, int] = {}
        names: Dict[int, str] = {t.ident: t.name
                                 for t in threading.enumerate()
                                 if t.ident is not None}
        out = []
        for ident, name, ts, dur in events:
            tid = tids.setdefault(ident, len(tids))
            out.append({"name": name, "cat": "adapm", "ph": "X",
                        "ts": round(ts, 3), "dur": round(dur, 3),
                        "pid": self.rank, "tid": tid})
        meta = [{"name": "thread_name", "ph": "M", "pid": self.rank,
                 "tid": tid,
                 "args": {"name": names.get(ident, f"thread-{ident}")}}
                for ident, tid in tids.items()]
        meta.append({"name": "process_name", "ph": "M", "pid": self.rank,
                     "args": {"name": f"adapm rank {self.rank}"}})
        doc = {"traceEvents": meta + out, "displayTimeUnit": "ms"}
        if self.dropped:
            doc["adapm_dropped_events"] = self.dropped
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def close(self) -> None:
        if self._bc_fd is not None:
            os.close(self._bc_fd)
            self._bc_fd = None
