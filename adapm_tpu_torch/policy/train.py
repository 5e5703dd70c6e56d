"""Offline policy training: fit the per-plane regret scorers from a
capture run's traces (the JAX package's `policy/train.py`).

    python -m adapm_tpu_torch.policy.train run.dtrace run.wtrace -o p.json

`replay/dataset.py export_dataset` joins the `.dtrace` (and optionally
the `.wtrace`) into the labeled table; per plane, the rows whose action
matches the plane's live hook site (reloc `move`, tier `promote`, sync
`ship`/`hold`, serve `shrink`/`grow`) train `model.fit_logistic` over
exactly the `PLANE_FEATURES` columns, with the plane's own regret
verdict as the label.

  - Unresolved rows (`regret: null`) are not labels and are skipped.
  - Rows whose window `close()` forced at shutdown (`truncated: true`)
    are weighted by `--truncated-weight` (default 0.0: excluded) and
    counted (`policy.train.truncated_rows`, and per plane in the
    artifact's `train` meta).
  - A plane with too few usable rows, or one label class, gets the
    base-rate constant model.

No RNG is consumed and no timestamp minted: the same traces train to a
byte-identical artifact, in this package and in the JAX package alike.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .features import PLANE_FEATURES, vectorize
from .model import PlaneModel, PolicyBundle, fit_logistic

# dataset actions whose pre-decision features match each plane's live
# hook site; the planes' other actions (reloc `classify`, tier
# `demote`) are analysis-only
PLANE_ACTIONS: Dict[str, tuple] = {
    "reloc": ("move",),
    "tier": ("promote",),
    "sync": ("ship", "hold"),
    "serve": ("shrink", "grow"),
}

# below this many usable rows a gradient fit is noise: constant model
MIN_FIT_ROWS = 8


def _plane_rows(rows: List[Dict], plane: str):
    """(features-dict, label, truncated) for one plane's trainable rows:
    resolved, labeled, action-matched."""
    out = []
    acts = PLANE_ACTIONS[plane]
    for r in rows:
        if r.get("plane") != plane or r.get("action") not in acts:
            continue
        regret = r.get("regret")
        if not r.get("resolved") or regret is None:
            continue  # no verdict: not a label
        f = {k[2:]: v for k, v in r.items() if k.startswith("f.")}
        out.append((f, bool(regret), bool(r.get("truncated"))))
    return out


def train_policy(dtrace: str, wtrace: Optional[str] = None,
                 out_path: Optional[str] = None, seed: int = 0,
                 horizon_clocks: int = 4,
                 truncated_weight: float = 0.0) -> PolicyBundle:
    """Fit the four plane models from a capture run's traces; returns
    the bundle (written to `out_path` when given)."""
    if not (0.0 <= truncated_weight <= 1.0):
        raise ValueError(f"truncated_weight must be in [0, 1] "
                         f"(got {truncated_weight}): forced-close "
                         f"rows may be down-weighted, never "
                         f"up-weighted — they are not labels")
    from ..replay.dataset import export_dataset
    ds = export_dataset(dtrace, wtrace, horizon_clocks=horizon_clocks)
    planes: Dict[str, PlaneModel] = {}
    train_meta: Dict[str, Dict] = {}
    total_truncated = 0
    for plane in sorted(PLANE_FEATURES):
        triples = _plane_rows(ds["rows"], plane)
        n_trunc = sum(1 for _, _, t in triples if t)
        total_truncated += n_trunc
        if truncated_weight == 0.0:
            kept = [(f, y, 1.0) for f, y, t in triples if not t]
        else:
            kept = [(f, y, truncated_weight if t else 1.0)
                    for f, y, t in triples]
        n_pos = sum(1 for _, y, _ in kept if y)
        meta = {"rows": len(triples), "truncated_rows": n_trunc,
                "used": len(kept), "pos": n_pos}
        if len(kept) < MIN_FIT_ROWS or n_pos in (0, len(kept)):
            rate = n_pos / len(kept) if kept else 0.0
            planes[plane] = PlaneModel.constant(
                plane, rate, n_rows=len(kept), n_pos=n_pos)
            meta["fit"] = "constant"
        else:
            X = np.stack([vectorize(plane, f) for f, _, _ in kept])
            y = np.array([1.0 if lab else 0.0 for _, lab, _ in kept])
            w = np.array([wt for _, _, wt in kept])
            mean, scale, beta, bias = fit_logistic(X, y, w)
            planes[plane] = PlaneModel(plane, mean, scale, beta, bias,
                                       n_rows=len(kept), n_pos=n_pos)
            meta["fit"] = "logistic"
        train_meta[plane] = meta
    bundle = PolicyBundle(
        {"seed": int(seed), "horizon_clocks": int(horizon_clocks),
         "truncated_weight": float(truncated_weight),
         "dtrace": dtrace, "wtrace": wtrace,
         "dataset_rows": int(ds["n_rows"]),
         "truncated_rows": int(total_truncated),
         "train": train_meta}, planes)
    if out_path:
        bundle.save(out_path)
    return bundle


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m adapm_tpu_torch.policy.train",
        description="Fit the per-plane learned policies from a capture "
                    "run's decision (+ workload) traces.")
    p.add_argument("dtrace", help=".dtrace from --sys.trace.decisions")
    p.add_argument("wtrace", nargs="?", default=None,
                   help="optional .wtrace from the SAME run")
    p.add_argument("-o", "--out", required=True,
                   help="policy artifact path (written atomically)")
    p.add_argument("--seed", type=int, default=0,
                   help="provenance seed recorded in the artifact "
                        "(the fit itself consumes no RNG)")
    p.add_argument("--horizon", type=int, default=4,
                   help="w.* label window in logical clocks (default 4)")
    p.add_argument("--truncated-weight", type=float, default=0.0,
                   help="sample weight for forced-close rows "
                        "(default 0.0 = excluded)")
    a = p.parse_args(argv)
    b = train_policy(a.dtrace, a.wtrace, out_path=a.out, seed=a.seed,
                     horizon_clocks=a.horizon,
                     truncated_weight=a.truncated_weight)
    t = b.meta["train"]
    for plane in sorted(t):
        m = t[plane]
        print(f"{plane}: {m['fit']} fit from {m['used']}/{m['rows']} "
              f"rows ({m['pos']} regretted, "
              f"{m['truncated_rows']} truncated)")
    print(f"policy.train.truncated_rows={b.meta['truncated_rows']} "
          f"(weight {b.meta['truncated_weight']}) -> {a.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
