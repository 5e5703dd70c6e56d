"""Cumulative stopwatch (reference util::Stopwatch, include/utils.h:17-98):
start/stop accumulate elapsed time across multiple intervals; resume-able.

Thread-safe for concurrent readers: the metrics
reporter thread snapshots `elapsed_s` while a worker thread is inside
start/stop (e.g. RuntimeGuard's watch). A single lock guards the
(_elapsed, _t0) pair so a reader can never observe a half-updated state
(interval counted twice or dropped)."""
from __future__ import annotations

import threading
import time


class Stopwatch:
    def __init__(self, start: bool = False):
        self._lock = threading.Lock()
        self._elapsed = 0.0
        self._t0 = None
        if start:
            self.start()

    def start(self) -> "Stopwatch":
        with self._lock:
            if self._t0 is None:
                self._t0 = time.perf_counter()
        return self

    def stop(self) -> "Stopwatch":
        with self._lock:
            if self._t0 is not None:
                self._elapsed += time.perf_counter() - self._t0
                self._t0 = None
        return self

    def resume(self) -> "Stopwatch":
        return self.start()

    def reset(self) -> "Stopwatch":
        with self._lock:
            self._elapsed = 0.0
            self._t0 = None
        return self

    @property
    def elapsed_s(self) -> float:
        with self._lock:
            running = (time.perf_counter() - self._t0) \
                if self._t0 is not None else 0.0
            return self._elapsed + running

    def __str__(self) -> str:
        return f"{self.elapsed_s:.3f}s"
