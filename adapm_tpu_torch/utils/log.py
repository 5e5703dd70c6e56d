"""Atomic timestamped logging (reference ALOG macro, dmlc/logging.h:129-143):
one writev-ish print per call so concurrent worker threads don't interleave,
prefixed with wall time since process start."""
from __future__ import annotations

import os
import sys
import threading
import time

_T0 = time.monotonic()
_LOCK = threading.Lock()


def alog(*parts, file=None) -> None:
    msg = " ".join(str(p) for p in parts)
    line = f"[{time.monotonic() - _T0:10.3f}] {msg}\n"
    with _LOCK:
        (file or sys.stdout).write(line)
        (file or sys.stdout).flush()


def verbose_level() -> int:
    """PS_VERBOSE-gated logging (reference PS_VLOG, postoffice.h:268)."""
    return int(os.environ.get("PS_VERBOSE", "0") or 0)
