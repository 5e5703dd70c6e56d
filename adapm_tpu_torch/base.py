"""Core type aliases, sentinels and enums.

Analog of the reference's include/ps/base.h (Key/Clock/sentinels,
MgmtTechniques) — see SURVEY.md §2.2.
"""
from __future__ import annotations

import enum

import numpy as np

# Keys are int64 (reference base.h: Key = uint64_t by default; bindings require
# int64_t). numpy/JAX index arrays use int32 on device where key counts permit.
Key = np.int64
Clock = int

# Sentinels (reference include/ps/base.h)
CLOCK_MAX: Clock = 2**31 - 1          # "forever" intent end
WORKER_FINISHED: Clock = CLOCK_MAX    # worker clock value after Finalize
LOCAL = -1                            # op timestamp: answered entirely locally

# Addressbook sentinels
NOT_CACHED = -2                       # location cache: no cached location
NO_SLOT = -1                          # key has no slot in a pool
# owner sentinel: main copy lives on another process
REMOTE = -1


def check_key_range(keys, num_keys: int, what: str = "key") -> None:
    """Raise IndexError if any key is outside [0, num_keys). One shared
    guard so every host path (routing, intents, stats, fused runners)
    reports the same way — negative keys would otherwise silently wrap via
    numpy indexing, and device indexing would fault or wrap."""
    keys = np.asarray(keys)
    if keys.size and (int(keys.min()) < 0 or int(keys.max()) >= num_keys):
        bad = keys[(keys < 0) | (keys >= num_keys)].ravel()[0]
        raise IndexError(
            f"{what} {bad} is outside the key range [0, {num_keys})")


class MgmtTechniques(enum.Enum):
    """Which adaptive management actions the planner may take.

    Mirrors the reference `--sys.techniques
    {all,replication_only,relocation_only}`
    (coloc_kv_server.h:209, sync_manager.h:624-644).
    """

    ALL = "all"
    REPLICATION_ONLY = "replication_only"
    RELOCATION_ONLY = "relocation_only"
