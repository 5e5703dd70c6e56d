"""Crash breadcrumbs for hard aborts (segfault / SIGABRT): the port of
the JAX package's `obs/crash.py`.

A native abort (in a CUDA extension, a driver call, the interpreter)
prints no Python traceback, so with `--sys.crash_dumps` (default on):

  - `faulthandler` is enabled with a PER-RANK dump file: the
    native-signal handler writes every thread's Python stack into the
    file as the process dies;
  - span begins overwrite a last-open-span breadcrumb file
    (obs/spans.py) when `--sys.trace.spans` is on, naming the phase the
    process died inside;
  - the executor flight-recorder ring (obs/flight.py FlightRecorder)
    mirrors the last executor programs into a fixed-size ring file next
    to the dump, one `pwrite` per PROGRAM.

Dump files go to `--sys.stats.out` when set, else the system temp dir;
they are tiny, overwritten per process, and cost nothing until a crash.
Re-enabling (a second Server in one process) repoints the handler.
"""
from __future__ import annotations

import faulthandler
import os
import tempfile
from typing import Optional, Tuple

_dump_file = None  # keep the handle alive: faulthandler writes by fd


def crash_dir(stats_out: Optional[str]) -> str:
    d = stats_out if stats_out else tempfile.gettempdir()
    os.makedirs(d, exist_ok=True)
    return d


def enable_crash_dumps(rank: int,
                       stats_out: Optional[str]) -> Tuple[str, str, str]:
    """Enable faulthandler into a per-rank dump file; returns
    (dump_path, breadcrumb_path, flight_ring_path). The breadcrumb file
    is only written when span tracing is on (SpanTracer owns that fd);
    the flight-ring file is written by the executor's FlightRecorder."""
    global _dump_file
    d = crash_dir(stats_out)
    dump_path = os.path.join(d, f"adapm_crash.{rank}.{os.getpid()}.log")
    bc_path = os.path.join(d, f"adapm_breadcrumb.{rank}.{os.getpid()}.txt")
    ring_path = os.path.join(d, f"adapm_flightring.{rank}.{os.getpid()}.log")
    if _dump_file is not None:
        try:
            _dump_file.close()
        except OSError:
            pass
    _dump_file = open(dump_path, "w")
    faulthandler.enable(file=_dump_file, all_threads=True)
    return dump_path, bc_path, ring_path
