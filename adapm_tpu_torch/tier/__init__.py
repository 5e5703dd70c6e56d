"""Tiered parameter storage: device-hot / host-cold main-row residency
with intent-driven promotion (the port of the JAX package's `tier/`).

    quant.py     — the cold store's wire formats (fp32/fp16/int8 with
                   error feedback) and their host transforms
    residency.py — per-row tier + clock/frequency score fused with
                   intent liveness; the TierManager coordinator
    promote.py   — batched promotion/demotion + the maintenance worker
    coldpath.py  — the tier-aware store operations

Enable with --sys.tier (plus --sys.tier.{hot_rows,cold_dtype,pin_intent,
demote_batch}); docs/MEMORY.md is the design doc. Every Pull/Push/serve
lookup on a tiered store with fp32 cold rows is bit-identical to the
untiered store — residency moves values, never changes them.
"""
from __future__ import annotations

from .promote import (PromotionEngine, demote_rows, ensure_hot_rows,  # noqa: F401
                      promote_rows, release_rows)
from .residency import Residency, TierManager  # noqa: F401
