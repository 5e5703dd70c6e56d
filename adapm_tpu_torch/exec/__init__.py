"""Async executor: ordered program streams over a small worker pool, and
the process-wide dispatch gate (see executor.py)."""
from .executor import (AsyncExecutor, Completion,  # noqa: F401
                       dispatch_gate)
