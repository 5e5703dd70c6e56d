"""The one feature extractor of the decision planes (the JAX package's
`policy/features.py`).

Capture (`obs/decisions.py DecisionRecorder`) stamps every decision's
`features` dict through `core_features()`, and runtime inference
(`policy/runtime.py PolicyPlane`) builds the model input through the
same `core_features()` + `vectorize()`, so a feature a model was fit on
is computed the same way at the live site. `PLANE_FEATURES` is the
ordered per-plane input spec: training selects exactly these columns
from the dataset's `f.*` fields, and `vectorize` lays the live dict out
in the same order. Fields known only after a decision (`n_shipped`,
`n_beat`) stay in the dataset for analysis and never reach a model.

numpy only: `obs/decisions.py` imports this module at its top level.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# the feature keys every decision event carries; planes add their own
CORE_FEATURES = ("clock", "replicas_live", "dirty_fraction",
                 "hot_free_rows", "hot_total_rows", "batch_n")

# ordered model-input spec per plane: CORE_FEATURES plus the plane's
# fields known BEFORE the action at the live hook site
PLANE_FEATURES: Dict[str, Tuple[str, ...]] = {
    # kv._relocate_to: the batch about to move (nothing demoted yet)
    "reloc": CORE_FEATURES + ("n_moved", "n_demoted"),
    # tier ensure_hot_rows, background path: the pin split
    "tier": CORE_FEATURES + ("n_pinned", "n_unpinned"),
    # sync_channel ship/hold: the dirty count as the heuristic saw it
    # (-1 = dirty filter off, unknown at decision time)
    "sync": CORE_FEATURES + ("n_dirty",),
    # obs/slo.py _control: the proposed window move and its tail
    "serve": CORE_FEATURES + ("old_us", "new_us", "p99_ms",
                              "target_ms"),
}


def core_features(server, batch_n: int) -> Dict:
    """The CORE_FEATURES context at decision time: lock-free host reads
    only (the dirty fraction is the sync plane's gauge read; hot-pool
    occupancy the allocator's free count). Never takes the server lock,
    never waits on the device."""
    sync = server.sync
    c = server._clocks
    out = {"clock": int(c.max()) if len(c) else 0,
           "replicas_live": int(sum(len(t) for t in sync.replicas)),
           "dirty_fraction": round(float(sync._dirty_fraction(None)), 6),
           "hot_free_rows": 0, "hot_total_rows": 0,
           "batch_n": int(batch_n)}
    if server.tier is not None:
        free = total = 0
        for st in server.stores:
            res = getattr(st, "res", None)
            if res is None:
                continue
            total += int(res.hot_rows) * int(res.num_shards)
            free += int(sum(res.alloc.num_free(s)
                            for s in range(res.num_shards)))
        out["hot_free_rows"] = free
        out["hot_total_rows"] = total
    return out


def vectorize(plane: str, features: Dict) -> np.ndarray:
    """The plane's ordered float64 model-input vector (missing fields are
    0.0). KeyError for a plane the spec does not define."""
    spec = PLANE_FEATURES[plane]
    return np.array([float(features.get(k, 0.0)) for k in spec],
                    dtype=np.float64)
