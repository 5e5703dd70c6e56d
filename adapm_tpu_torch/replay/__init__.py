"""Deterministic trace replay: the offline policy lab and capacity
simulator (the JAX package's `replay/`).

A workload captured once with `--sys.trace.workload` (obs/wtrace.py) is
re-driven against a fresh server under candidate knob overrides — on
the card unless the caller passes `device="cpu"` — and scored from its
metrics snapshot; `rank_candidates` sweeps overrides over one trace.
Same trace + same seed + same knobs => bit-identical replayed reads,
and the same `reads_digest` as the JAX package's replay of that trace.
`dataset.py` joins a capture run's `.dtrace` with its `.wtrace` into
the labeled table the policy trainer reads.
"""
from __future__ import annotations

from ..obs.decisions import (DecisionTrace,  # noqa: F401
                             DecisionTraceError, load_dtrace)
from ..obs.wtrace import (WorkloadTrace, WorkloadTraceError,  # noqa: F401
                          load_wtrace)
from .dataset import dataset_bytes, export_dataset  # noqa: F401
from .engine import (OBJECTIVES, ReplayEngine,  # noqa: F401
                     extract_scores, per_shard_hot_rows, rank_candidates,
                     replay_trace)
