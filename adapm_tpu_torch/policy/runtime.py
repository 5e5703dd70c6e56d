"""The live policy plane: learned-mode vetoes and shadow scoring (the
JAX package's `policy/runtime.py`).

One `PolicyPlane` per Server when `--sys.policy.file` names a trained
artifact (policy/train.py); default off — `Server.policy is None`,
every hook site pays one `is None` check, and the registry holds no
`policy.*` name. Per plane, `--sys.policy.<plane>` selects:

  `heuristic`  (default) the hand-tuned law decides. With
               `--sys.policy.shadow 1` the model is also scored at each
               decision (`policy.shadow_agree` / `_disagree`) and never
               applied.
  `learned`    the model's regret prediction may VETO the heuristic's
               action (hold a background promotion, a landed move, a
               clean ship, a serve window move). A veto is the only
               power the policy has, and each hook site applies it
               through a value-preservation guard (core/kv.py,
               tier/promote.py, core/sync.py, obs/slo.py): a policy
               changes what and when, never values.
               `policy.guard_vetoes_total` counts verdicts a guard
               refused.

Hook sites consult concurrently; tallies fold under one small lock
(never a device wait, never the server lock).
"""
from __future__ import annotations

import threading
from typing import Dict

from .features import core_features
from .model import PolicyBundle, load_policy

PLANE_KNOBS = ("reloc", "tier", "sync", "serve")
POLICY_MODES = ("heuristic", "learned")


class PolicyPlane:
    """Built by the Server (core/kv.py) when `--sys.policy.file` is set;
    the models are immutable after load, only tallies change."""

    def __init__(self, server, opts=None):
        from ..obs.metrics import Counter
        o = opts if opts is not None else server.opts
        self._server = server
        self.modes: Dict[str, str] = {
            "reloc": o.policy_reloc, "tier": o.policy_tier,
            "sync": o.policy_sync, "serve": o.policy_serve}
        self.shadow = bool(o.policy_shadow)
        self.file = o.policy_file
        self.bundle: PolicyBundle = load_policy(o.policy_file)
        # planes worth the feature read: learned mode or shadow scoring,
        # and only when the artifact shipped a model for the plane
        self._active = frozenset(
            p for p in PLANE_KNOBS if p in self.bundle.planes and
            (self.modes[p] == "learned" or self.shadow))
        self._lock = threading.Lock()
        z = {"consults": 0, "vetoes": 0, "applied": 0,
             "guard_blocked": 0, "agree": 0, "disagree": 0}
        self._tallies = {p: dict(z) for p in PLANE_KNOBS}
        # how the live serve batch windows close (serve/batcher.py)
        self._batch_window_limited = 0
        self._batch_size_limited = 0
        reg = server.obs
        if reg is not None and reg.enabled:
            self.c_consults = reg.counter("policy.consults_total")
            self.c_applied = reg.counter("policy.applied_total")
            self.c_guard = reg.counter("policy.guard_vetoes_total")
            self.c_agree = reg.counter("policy.shadow_agree")
            self.c_disagree = reg.counter("policy.shadow_disagree")
        else:  # works with --sys.metrics 0 (standalone tallies)
            self.c_consults = Counter("policy.consults_total")
            self.c_applied = Counter("policy.applied_total")
            self.c_guard = Counter("policy.guard_vetoes_total")
            self.c_agree = Counter("policy.shadow_agree")
            self.c_disagree = Counter("policy.shadow_disagree")

    # -- hook-site API -------------------------------------------------------

    def active(self, plane: str) -> bool:
        """Is there anything to score at this plane's sites? False for a
        heuristic plane with shadow off."""
        return plane in self._active

    def consult(self, plane: str, extras: Dict, batch_n: int) -> bool:
        """Score the plane's model on the live features. Learned mode:
        the veto verdict (True = hold, subject to the site's guard).
        Shadow mode: the verdict feeds agree/disagree and the return is
        False."""
        if plane not in self._active:
            return False
        m = self.bundle.planes[plane]
        f = core_features(self._server, batch_n)
        f.update(extras)
        verdict = m.veto(f)
        self.c_consults.inc()
        learned = self.modes[plane] == "learned"
        with self._lock:
            t = self._tallies[plane]
            t["consults"] += 1
            if learned:
                if verdict:
                    t["vetoes"] += 1
            elif verdict:
                t["disagree"] += 1
            else:
                t["agree"] += 1
        if not learned:  # shadow: scored, never applied
            (self.c_disagree if verdict else self.c_agree).inc()
            return False
        return verdict

    def applied(self, plane: str) -> None:
        """The site's guard admitted the veto: the action was held."""
        self.c_applied.inc()
        with self._lock:
            self._tallies[plane]["applied"] += 1

    def guard_blocked(self, plane: str) -> None:
        """The guard refused the veto (holding could have changed read
        values): the heuristic's action proceeded."""
        self.c_guard.inc()
        with self._lock:
            self._tallies[plane]["guard_blocked"] += 1

    def note_batch(self, window_limited: bool) -> None:
        """serve/batcher.py per-batch close reason: the window expired,
        or the batch filled first."""
        with self._lock:
            if window_limited:
                self._batch_window_limited += 1
            else:
                self._batch_size_limited += 1

    # -- snapshot ------------------------------------------------------------

    def stats(self) -> Dict:
        """Plain values for `metrics_snapshot()["policy"]`."""
        with self._lock:
            out: Dict = {"file": self.file, "shadow": self.shadow,
                         "planes_loaded": sorted(self.bundle.planes),
                         "batch_window_limited":
                             self._batch_window_limited,
                         "batch_size_limited": self._batch_size_limited}
            for p in PLANE_KNOBS:
                out[f"mode.{p}"] = self.modes[p]
                t = self._tallies[p]
                out[f"consults.{p}"] = t["consults"]
                out[f"vetoes.{p}"] = t["vetoes"]
                out[f"applied.{p}"] = t["applied"]
                out[f"guard_blocked.{p}"] = t["guard_blocked"]
                out[f"shadow_agree.{p}"] = t["agree"]
                out[f"shadow_disagree.{p}"] = t["disagree"]
        return out
