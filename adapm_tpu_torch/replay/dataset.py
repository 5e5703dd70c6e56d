"""Labeled decision dataset: join a `.dtrace` with its `.wtrace` (the
JAX package's `replay/dataset.py`).

A capture run with both `--sys.trace.decisions` and
`--sys.trace.workload` yields two verified traces over one logical
clock. `export_dataset` joins them into one flat (features, decision,
outcome) table for the policy lab:

  - one row per decision, sorted by `seq`; columns with stable
    prefixes: `f.*` the features at decision time, `d.*` plane fields,
    `o.*` outcome-probe fields, `w.*` workload context (ops, reads and
    writes within `horizon_clocks` logical clocks after the decision);
  - `regret` / `truncated` / `outcome_latency_s` from the attribution
    window, None where a plane records no verdict; `truncated=true`
    rows are forced verdicts (the trainer excludes them by default);
  - deterministic bytes: sorted keys, fixed separators, no timestamp
    minted at export, so the same inputs give the same bytes in this
    package and in the JAX package.

Offline: no server and no device; both loaders verify before parsing.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Union

from ..obs.decisions import DecisionTrace, load_dtrace
from ..obs.wtrace import WorkloadTrace, load_wtrace

DATASET_FORMAT = "adapm-decision-dataset"
DATASET_VERSION = 1

# event keys consumed by the row skeleton itself; everything else is a
# plane-specific extra and lands under the d./o. prefix
_BASE_DECISION = frozenset(("kind", "plane", "seq", "clock", "wall",
                            "mono", "action", "features"))
_BASE_OUTCOME = frozenset(("kind", "plane", "seq", "clock", "wall",
                           "mono", "ref", "truncated", "regret"))

# wtrace kinds that count as demand (reads) vs mutation (writes) when
# labeling the post-decision window
_READ_KINDS = frozenset(("pull", "serve"))
_WRITE_KINDS = frozenset(("push", "set"))


def _workload_labels(wt: WorkloadTrace, clock: int,
                     horizon: int) -> Dict[str, int]:
    """Aggregate the op stream over logical clocks
    (clock, clock + horizon]: what the workload did AFTER this decision
    was taken."""
    lo, hi = clock, clock + horizon
    events = reads = writes = 0
    for ev in wt.events:
        c = ev.get("clock")
        if c is None or not (lo < c <= hi):
            continue
        events += 1
        n = int(ev.get("n", 0))
        if ev["kind"] in _READ_KINDS:
            reads += n
        elif ev["kind"] in _WRITE_KINDS:
            writes += n
    return {"w.events_after": events, "w.keys_read_after": reads,
            "w.keys_written_after": writes}


def export_dataset(dtrace: Union[str, DecisionTrace],
                   wtrace: Union[str, WorkloadTrace, None] = None,
                   out_path: Optional[str] = None,
                   horizon_clocks: int = 4) -> Dict:
    """Build (and optionally write) the labeled decision dataset.

    `dtrace` is a path or a loaded `DecisionTrace`; `wtrace` optionally
    adds the `w.*` workload-context columns from the SAME capture run.
    With `out_path` the artifact is written atomically; the bytes are
    deterministic for fixed inputs. Returns the artifact dict."""
    if horizon_clocks < 1:
        raise ValueError(
            f"horizon_clocks must be >= 1 (got {horizon_clocks})")
    tr = dtrace if isinstance(dtrace, DecisionTrace) \
        else load_dtrace(dtrace)
    wt = None
    if wtrace is not None:
        wt = wtrace if isinstance(wtrace, WorkloadTrace) \
            else load_wtrace(wtrace)

    outcomes = tr.outcomes()
    rows: List[Dict] = []
    n_unresolved = n_regretted = n_truncated = 0
    for d in sorted(tr.decisions(), key=lambda e: e["seq"]):
        row: Dict = {"seq": d["seq"], "clock": d["clock"],
                     "plane": d["plane"], "action": d["action"]}
        for k, v in d.get("features", {}).items():
            row[f"f.{k}"] = v
        for k, v in d.items():
            if k not in _BASE_DECISION:
                row[f"d.{k}"] = v
        oc = outcomes.get(d["seq"])
        if oc is None:
            # dropped under the event budget, or the run died before
            # close() forced the window — labeled, not silently skipped
            n_unresolved += 1
            row["resolved"] = False
            row["regret"] = None
            row["truncated"] = None
        else:
            row["resolved"] = True
            row["regret"] = oc.get("regret")
            row["truncated"] = bool(oc.get("truncated", False))
            if row["truncated"]:
                n_truncated += 1
            row["outcome_clock"] = oc["clock"]
            row["outcome_latency_s"] = round(oc["mono"] - d["mono"], 6)
            if row["regret"]:
                n_regretted += 1
            for k, v in oc.items():
                if k not in _BASE_OUTCOME:
                    row[f"o.{k}"] = v
        if wt is not None:
            row.update(_workload_labels(wt, d["clock"], horizon_clocks))
        rows.append(row)

    columns = sorted({k for r in rows for k in r})
    artifact = {
        "format": DATASET_FORMAT,
        "version": DATASET_VERSION,
        "source": {"dtrace": tr.path,
                   "wtrace": wt.path if wt is not None else None},
        "capture": dict(tr.meta),
        "horizon_clocks": int(horizon_clocks),
        "planes": tr.planes(),
        "n_rows": len(rows),
        "n_unresolved": n_unresolved,
        "n_regretted": n_regretted,
        "n_truncated": n_truncated,
        "events_dropped_at_capture": int(tr.dropped),
        "columns": columns,
        "rows": rows,
    }
    if out_path:
        from ..utils import write_atomic
        write_atomic(out_path, dataset_bytes(artifact))
    return artifact


def dataset_bytes(artifact: Dict) -> bytes:
    """Canonical serialization: sorted keys, fixed separators — the
    determinism contract is over THESE bytes."""
    return json.dumps(artifact, sort_keys=True,
                      separators=(",", ":"), default=float).encode()


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m adapm_tpu_torch.replay.dataset",
        description="Export the labeled (features, decision, outcome) "
                    "dataset from a capture run's traces.")
    p.add_argument("dtrace", help=".dtrace from --sys.trace.decisions")
    p.add_argument("wtrace", nargs="?", default=None,
                   help="optional .wtrace from the SAME run "
                        "(adds w.* workload-context columns)")
    p.add_argument("-o", "--out", required=True,
                   help="output JSON path (written atomically)")
    p.add_argument("--horizon", type=int, default=4,
                   help="w.* label window in logical clocks "
                        "(default 4)")
    a = p.parse_args(argv)
    art = export_dataset(a.dtrace, a.wtrace, out_path=a.out,
                         horizon_clocks=a.horizon)
    print(f"{art['n_rows']} rows ({art['n_unresolved']} unresolved, "
          f"{art['n_regretted']} regretted, "
          f"{art['n_truncated']} truncated) x "
          f"{len(art['columns'])} columns -> {a.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
