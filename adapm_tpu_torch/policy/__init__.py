"""The learned adaptive-policy plane: offline-trained relocate, tier,
sync and serve-window policies, replay-gated, with live shadow scoring
(the JAX package's `policy/`).

  features.py  the shared feature extractor and per-plane input specs
  model.py     deterministic numpy per-plane regret scorers and their
               versioned, checksummed artifact
  train.py     `python -m adapm_tpu_torch.policy.train`
  runtime.py   `PolicyPlane`, the veto/shadow hooks behind
               `--sys.policy.*` (built by core/kv.py)
"""
from .features import CORE_FEATURES, PLANE_FEATURES, core_features, \
    vectorize
from .model import POLICY_FORMAT, POLICY_VERSION, PlaneModel, \
    PolicyBundle, PolicyError, load_policy
from .runtime import PLANE_KNOBS, POLICY_MODES, PolicyPlane
from .train import train_policy

__all__ = [
    "CORE_FEATURES", "PLANE_FEATURES", "core_features", "vectorize",
    "POLICY_FORMAT", "POLICY_VERSION", "PlaneModel", "PolicyBundle",
    "PolicyError", "load_policy", "PLANE_KNOBS", "POLICY_MODES",
    "PolicyPlane", "train_policy",
]
