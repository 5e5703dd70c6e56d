"""Per-plane decision models: deterministic regret scorers (the JAX
package's `policy/model.py`).

One logistic scorer per decision plane, fit by `policy/train.py` from
the labeled (features, decision, outcome) dataset. A model predicts the
probability that the heuristic's action at a decision point will be
regretted (the plane's own verdict from obs/decisions.py); the runtime
(`policy/runtime.py`) uses it as a veto score and never proposes an
action the heuristic would not take.

The scorer stays numpy float64 on the host, on purpose: it is one
fixed-order dot product over about ten features, called once per
decision. A device launch per decision would cost more than the dot,
and a host float64 computation in the same order as the JAX package's
is what makes a trained artifact byte-identical across the two
packages and its scores equal.

  - inference: a fixed-order dot over `PLANE_FEATURES` — no RNG, no
    wall clock;
  - training: zero-initialized full-batch gradient descent for a fixed
    number of iterations;
  - serialization: weights rounded to `_ROUND` decimals, written through
    `obs/wtrace.py write_trace_file` (versioned, checksummed, atomic);
    `load_policy` verifies before it parses and raises `PolicyError`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from .features import PLANE_FEATURES, vectorize

POLICY_FORMAT = "adapm-policy"
POLICY_VERSION = 1

# serialization rounding: enough precision that re-loading cannot flip a
# verdict, few enough digits that the JSON bytes are stable
_ROUND = 10


class PolicyError(RuntimeError):
    """The policy artifact is unusable: wrong format or version,
    truncated body, checksum mismatch, malformed model block, or a plane
    or feature spec this build does not know. Raised before anything
    consults the policy."""


def _sigmoid(z: np.ndarray) -> np.ndarray:
    # piecewise-stable: never overflows exp for large |z|
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out


def fit_logistic(X: np.ndarray, y: np.ndarray,
                 sample_weight: Optional[np.ndarray] = None,
                 iters: int = 400, lr: float = 0.5,
                 l2: float = 1e-3):
    """Weighted logistic regression by zero-initialized full-batch
    gradient descent on standardized inputs; deterministic for fixed
    inputs. Returns (mean, scale, weights, bias): score(x) =
    sigmoid(w . ((x - mean) / scale) + b)."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    w = np.ones(len(y)) if sample_weight is None \
        else np.asarray(sample_weight, dtype=np.float64)
    wsum = float(w.sum())
    mean = (X * w[:, None]).sum(axis=0) / wsum
    var = ((X - mean) ** 2 * w[:, None]).sum(axis=0) / wsum
    scale = np.sqrt(np.maximum(var, 1e-12))
    scale[scale < 1e-6] = 1.0  # constant column: center only
    Z = (X - mean) / scale
    beta = np.zeros(X.shape[1], dtype=np.float64)
    bias = 0.0
    for _ in range(int(iters)):
        p = _sigmoid(Z @ beta + bias)
        err = (p - y) * w
        beta -= lr * ((Z.T @ err) / wsum + l2 * beta)
        bias -= lr * float(err.sum() / wsum)
    return mean, scale, beta, bias


def _spec(plane: str):
    spec = PLANE_FEATURES.get(plane)
    if spec is None:
        raise PolicyError(f"unknown policy plane {plane!r} (this build "
                          f"knows {'/'.join(sorted(PLANE_FEATURES))})")
    return spec


class PlaneModel:
    """One plane's regret scorer: logistic over the plane's ordered
    feature spec (policy/features.py PLANE_FEATURES)."""

    __slots__ = ("plane", "features", "mean", "scale", "weights",
                 "bias", "threshold", "n_rows", "n_pos")

    def __init__(self, plane: str, mean, scale, weights, bias: float,
                 threshold: float = 0.5, n_rows: int = 0,
                 n_pos: int = 0):
        spec = _spec(plane)
        self.plane = plane
        self.features = spec
        self.mean = np.asarray(mean, dtype=np.float64)
        self.scale = np.asarray(scale, dtype=np.float64)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.bias = float(bias)
        self.threshold = float(threshold)
        self.n_rows = int(n_rows)
        self.n_pos = int(n_pos)
        for name, arr in (("mean", self.mean), ("scale", self.scale),
                          ("weights", self.weights)):
            if arr.shape != (len(spec),):
                raise PolicyError(
                    f"plane {plane!r} {name} has {arr.shape} entries; "
                    f"the {plane} feature spec has {len(spec)} — the "
                    f"artifact was trained against a different "
                    f"PLANE_FEATURES contract")

    @classmethod
    def constant(cls, plane: str, pos_rate: float, n_rows: int = 0,
                 n_pos: int = 0) -> "PlaneModel":
        """Degenerate fit (too few rows, or one label class): zero
        weights, bias at the clipped log-odds of the positive rate."""
        p = min(max(float(pos_rate), 1e-3), 1.0 - 1e-3)
        k = len(_spec(plane))
        return cls(plane, np.zeros(k), np.ones(k), np.zeros(k),
                   math.log(p / (1.0 - p)), n_rows=n_rows, n_pos=n_pos)

    def score(self, features: Dict) -> float:
        """Predicted probability that the heuristic's action here will be
        regretted."""
        z = (vectorize(self.plane, features) - self.mean) / self.scale
        return float(_sigmoid(np.array([z @ self.weights + self.bias]))
                     [0])

    def veto(self, features: Dict) -> bool:
        """True = the learned policy would HOLD the heuristic's action
        (predicted regret crosses the threshold)."""
        return self.score(features) >= self.threshold

    def to_dict(self) -> Dict:
        return {"kind": "logistic", "plane": self.plane,
                "features": list(self.features),
                "mean": [round(float(v), _ROUND) for v in self.mean],
                "scale": [round(float(v), _ROUND) for v in self.scale],
                "weights": [round(float(v), _ROUND)
                            for v in self.weights],
                "bias": round(float(self.bias), _ROUND),
                "threshold": round(float(self.threshold), _ROUND),
                "n_rows": self.n_rows, "n_pos": self.n_pos}

    @classmethod
    def from_dict(cls, d: Dict) -> "PlaneModel":
        if d.get("kind") != "logistic":
            raise PolicyError(f"unknown model kind {d.get('kind')!r} "
                              f"for plane {d.get('plane')!r} (this "
                              f"build reads 'logistic')")
        m = cls(d["plane"], d["mean"], d["scale"], d["weights"],
                d["bias"], d.get("threshold", 0.5),
                d.get("n_rows", 0), d.get("n_pos", 0))
        if list(m.features) != list(d.get("features", [])):
            raise PolicyError(
                f"plane {m.plane!r} artifact feature order "
                f"{d.get('features')} does not match this build's "
                f"spec {list(m.features)} — retrain against this "
                f"build (the shared features.py contract)")
        return m


class PolicyBundle:
    """A verified set of per-plane models plus training provenance."""

    __slots__ = ("path", "meta", "planes")

    def __init__(self, meta: Dict, planes: Dict[str, PlaneModel],
                 path: Optional[str] = None):
        self.path = path
        self.meta = meta
        self.planes = planes

    def to_doc(self) -> Dict:
        return {"meta": self.meta,
                "planes": {p: m.to_dict()
                           for p, m in sorted(self.planes.items())}}

    def save(self, path: str) -> int:
        """Write the artifact atomically (one-line verified header + JSON
        body); returns the bytes written, deterministic for a fixed
        bundle."""
        from ..obs.wtrace import write_trace_file
        n = write_trace_file(path, self.to_doc(), POLICY_FORMAT,
                             POLICY_VERSION)
        self.path = path
        return n


def load_policy(path: str) -> PolicyBundle:
    """Read and verify a policy artifact; `PolicyError` on a missing,
    truncated, corrupt or incompatible file."""
    from ..obs.wtrace import load_trace_doc
    doc = load_trace_doc(path, POLICY_FORMAT, POLICY_VERSION,
                         PolicyError, "policy artifact")
    raw = doc.get("planes")
    if not isinstance(raw, dict) or not raw:
        raise PolicyError(f"policy artifact {path!r} has no plane "
                          f"models — nothing to consult")
    planes: Dict[str, PlaneModel] = {}
    for p, d in raw.items():
        try:
            planes[p] = PlaneModel.from_dict(d)
        except PolicyError:
            raise
        except Exception as e:
            raise PolicyError(f"policy artifact {path!r} plane {p!r} "
                              f"is malformed: {e}") from e
    return PolicyBundle(doc.get("meta", {}), planes, path=path)


def plane_names() -> List[str]:
    return sorted(PLANE_FEATURES)
