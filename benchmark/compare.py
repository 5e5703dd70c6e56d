"""The comparison that decides `correct`: the numbers a cell compares,
each against the limit its file under limits/ gives.

The eval cell compares:
- count_gap: the widest gap of a raw rank count, over the ring's
  queries and both sides, from the float64 reference's;
- repeat_gap: answers of the window that differ from the first answer
  to the same query batch."""
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def limits(cell: str) -> dict:
    with open(os.path.join(HERE, "limits", cell + ".json")) as f:
        return json.load(f)["limits"]


def eval_numbers(prog, ref) -> dict:
    """prog, ref: (object-side, subject-side) count arrays."""
    gap = max(int(np.max(np.abs(np.asarray(a, np.int64)
                                - np.asarray(b, np.int64))))
              for a, b in zip(prog, ref))
    return {"count_gap": float(gap)}


def judge(numbers: dict, lim: dict) -> tuple:
    """(correct, {name: {value, limit}}): correct when every number is
    finite and at or under its limit, and every limited number was
    read."""
    checks = {k: {"value": numbers.get(k), "limit": v}
              for k, v in lim.items()}
    ok = all(c["value"] is not None and np.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
