"""The port's lint plane (adapm_tpu_torch/lint/): the twin of
tests/test_lint.py.

Three layers:

  1. the fixture corpus: one known-bad and one known-good file per rule
     — every rule must FIRE on its bad fixture and stay quiet on its good
     one (rules run in isolation). The retargeted rules (APM001 gate
     coverage over the port's kernel wrappers, APM005 in-place reread,
     APM008 the CUDA APIs) read tests/torch_lint_fixtures/; the others
     read the JAX package's tests/lint_fixtures/, unchanged;
  2. the engine: suppression round-trip (trailing and comment-block
     forms), unused-suppression failure, malformed-suppression failure,
     byte-identical JSON determinism;
  3. the port's tree: it lints clean with no baseline (the check
     `python -m adapm_tpu_torch.lint` runs), its intentional-exception
     suppressions are USED, the metrics the catalog names are registered
     (beside the JAX package's), and the runtime lock-order sentinel's
     unit behaviour (cycle, gate-leaf, reentrancy, condvar release, the
     skip-wrapper shape of the port's Server).
"""
import glob
import inspect
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import adapm_tpu
import adapm_tpu_torch
from adapm_tpu.parallel.mesh import make_mesh
from adapm_tpu_torch.device.context import make_context
from adapm_tpu_torch.lint import Analyzer, default_rules, lockorder
from adapm_tpu_torch.lint.rules import (INPLACE_ARGS, KERNEL_DISPATCH_SITES,
                                        DeviceApiConfinementRule,
                                        GateCoverageRule, InPlaceRereadRule,
                                        MetricCatalogRule,
                                        NoBlockingUnderLockRule,
                                        RawThreadBanRule,
                                        RevalidateBeforeEnqueueRule,
                                        SkipWrapperRule)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIXTURES = os.path.join(ROOT, "tests", "lint_fixtures")
PORT_FIXTURES = os.path.join(ROOT, "tests", "torch_lint_fixtures")
FIXTURE_CATALOG = os.path.join(JAX_FIXTURES, "apm007_catalog.md")

_RULE_BY_ID = {
    "APM001": GateCoverageRule,
    "APM002": NoBlockingUnderLockRule,
    "APM003": SkipWrapperRule,
    "APM004": RawThreadBanRule,
    "APM005": InPlaceRereadRule,
    "APM006": RevalidateBeforeEnqueueRule,
    "APM007": MetricCatalogRule,
    "APM008": DeviceApiConfinementRule,
}
# the rules retargeted to the port read the port's own fixtures
_RETARGETED = ("APM001", "APM005", "APM008")


def _fixture(rule_id, kind):
    d = PORT_FIXTURES if rule_id in _RETARGETED else JAX_FIXTURES
    return os.path.join(d, f"{rule_id.lower()}_{kind}.py")


def _analyze(paths, rules=None, docs=None):
    return Analyzer(ROOT, rules=rules, paths=paths,
                    docs=docs if docs is not None else {}).run()


@pytest.fixture
def port_sentinel():
    """A fresh port sentinel, torn down after the test (the shared
    conftest tears down only the JAX package's)."""
    lockorder.disable_sentinel()
    sen = lockorder.enable_sentinel()
    yield sen
    lockorder.disable_sentinel()


# ---------------------------------------------------------------------------
# 1. fixture corpus: every rule fires on bad, stays quiet on good
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule_id", sorted(_RULE_BY_ID))
def test_rule_fires_on_bad_fixture(rule_id):
    bad = _fixture(rule_id, "bad")
    docs = {"observability": FIXTURE_CATALOG} if rule_id == "APM007" \
        else {}
    rep = _analyze([bad], rules=[_RULE_BY_ID[rule_id]()], docs=docs)
    fired = [f for f in rep.findings if f.rule == rule_id]
    assert fired, f"{rule_id} did not fire on its known-bad fixture"
    assert all(f.path.endswith(f"{rule_id.lower()}_bad.py")
               or f.path.endswith(".md") for f in fired)


@pytest.mark.parametrize("rule_id", sorted(_RULE_BY_ID))
def test_rule_quiet_on_good_fixture(rule_id):
    good = _fixture(rule_id, "good")
    docs = {"observability": FIXTURE_CATALOG} if rule_id == "APM007" \
        else {}
    rep = _analyze([good], rules=[_RULE_BY_ID[rule_id]()], docs=docs)
    # APM007's fixture catalog carries one doc->code drift row on purpose
    # (`kv.ghost_total`): findings anchored in the GOOD .py must be zero
    code_findings = [f for f in rep.findings
                     if f.path.endswith("_good.py")]
    assert not code_findings, \
        f"{rule_id} false-positived on its known-good fixture: " \
        f"{[f.format() for f in code_findings]}"


def test_apm007_doc_to_code_direction_fires():
    """The fixture catalog's `kv.ghost_total` row has no registration
    anywhere — the rule must flag the DOC side too."""
    rep = _analyze([_fixture("APM007", "good")], rules=[MetricCatalogRule()],
                   docs={"observability": FIXTURE_CATALOG})
    doc_findings = [f for f in rep.findings if f.path.endswith(".md")]
    assert any("kv.ghost_total" in f.message for f in doc_findings)
    assert not any("local_answer_frac" in f.message
                   for f in rep.findings)


def test_apm001_catches_each_ungated_wrapper_call():
    """APM001's bad fixture calls a port kernel wrapper outside the gate
    twice (a bare name and a module attribute): both are caught, on
    their own lines."""
    rep = _analyze([_fixture("APM001", "bad")], rules=[GateCoverageRule()])
    assert sorted((f.line, f.message.split("()")[0].split()[-1])
                  for f in rep.findings) == [(11, "drop_set"),
                                             (17, "sync_round")]


# ---------------------------------------------------------------------------
# 2. engine: suppressions + determinism
# ---------------------------------------------------------------------------


def test_suppression_round_trip_both_forms():
    rep = _analyze([os.path.join(JAX_FIXTURES, "suppressed.py")])
    assert not rep.findings, [f.format() for f in rep.findings]
    assert len(rep.suppressions_used) == 2
    assert all(s.justification for s in rep.suppressions_used)


def test_unused_suppression_fails():
    rep = _analyze([os.path.join(JAX_FIXTURES, "unused_suppression.py")])
    assert [f.rule for f in rep.findings] == ["APM000"]
    assert "unused suppression" in rep.findings[0].message


def test_suppression_without_justification_fails():
    """A bare `disable=APM004` is APM000 AND does not suppress."""
    rep = _analyze([os.path.join(JAX_FIXTURES, "bad_suppression.py")])
    assert sorted(f.rule for f in rep.findings) == ["APM000", "APM004"]


def test_suppression_in_string_literal_is_inert():
    """Suppressions are COMMENT tokens: the analyzer's own source (its
    docstring example, its regex) lints clean."""
    path = os.path.join(ROOT, "adapm_tpu_torch", "lint", "analyzer.py")
    rep = _analyze([path])
    assert not [f for f in rep.findings if f.rule == "APM000"], \
        [f.format() for f in rep.findings]


def test_json_report_deterministic():
    paths = sorted(glob.glob(os.path.join(JAX_FIXTURES, "apm00*_bad.py"))
                   + glob.glob(os.path.join(PORT_FIXTURES, "apm00*_bad.py")))
    docs = {"observability": FIXTURE_CATALOG}
    a = Analyzer(ROOT, paths=paths, docs=docs).run().to_json()
    b = Analyzer(ROOT, paths=paths, docs=docs).run().to_json()
    assert a == b and a.encode() == b.encode()
    assert "\\\\" not in a, "paths must be posix, not os-native"


# ---------------------------------------------------------------------------
# 3. the port's tree: clean, suppressions used, manifests honest
# ---------------------------------------------------------------------------


def _run_tree():
    return Analyzer(ROOT).run()


def test_port_lints_clean():
    """Zero unsuppressed findings and zero unused or unjustified
    suppressions over adapm_tpu_torch/, every rule on, no baseline; the
    module entry point agrees (exit 0)."""
    rep = _run_tree()
    assert rep.ok(), "\n" + rep.to_text()
    assert sorted(rep.rules) == sorted(_RULE_BY_ID)
    assert rep.files_scanned > 100
    assert all(f.startswith("adapm_tpu_torch/") for f in
               {s.path for s in rep.suppressions_used})
    assert not os.environ.get("ADAPM_LINT_BASELINE")
    out = subprocess.run([sys.executable, "-m", "adapm_tpu_torch.lint"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[lint] OK" in out.stdout


def test_apm002_server_block_suppression_used():
    rep = _run_tree()
    assert any(s.path == "adapm_tpu_torch/core/kv.py" and "APM002" in s.rules
               for s in rep.suppressions_used)


def test_apm003_kv_fused_and_app_bind_their_handles():
    """The skip-wrapper fixes: the stream plane and the tier manager are
    bound once (or handed in by the guarded caller), so no unguarded call
    through an optional handle survives in these modules."""
    paths = [os.path.join(ROOT, "adapm_tpu_torch", *p) for p in (
        ("core", "kv.py"), ("ops", "fused.py"),
        ("apps", "knowledge_graph_embeddings.py"))]
    rep = _analyze(paths, rules=[SkipWrapperRule()])
    assert not [f for f in rep.findings if f.rule == "APM003"], \
        [f.format() for f in rep.findings]


def test_apm004_parallel_thread_suppressions_used():
    rep = _run_tree()
    used = {s.path for s in rep.suppressions_used if "APM004" in s.rules}
    assert "adapm_tpu_torch/parallel/collective.py" in used
    assert "adapm_tpu_torch/parallel/control.py" in used


def test_apm008_device_api_confined_and_routed():
    """No CUDA stream/graph/device API outside the device plane: the
    fused step, the store, the server and the process mesh reach the
    card through device/cuda.py (no finding, no suppression), and the
    one intentional exception (the host router's ctypes load) carries a
    used suppression."""
    rep = _run_tree()
    assert not [f for f in rep.findings if f.rule == "APM008"]
    used = {s.path for s in rep.suppressions_used if "APM008" in s.rules}
    assert used == {"adapm_tpu_torch/native/__init__.py"}
    paths = [os.path.join(ROOT, "adapm_tpu_torch", *p) for p in (
        ("core", "store.py"), ("core", "kv.py"), ("ops", "fused.py"),
        ("parallel", "mesh.py"))]
    rep = _analyze(paths, rules=[DeviceApiConfinementRule()])
    assert not [f for f in rep.findings if f.rule == "APM008"]
    assert not rep.suppressions_used


def test_apm007_catalog_in_sync():
    rep = _run_tree()
    assert not [f for f in rep.findings if f.rule == "APM007"], \
        "\n" + rep.to_text()


def test_manifests_name_real_wrappers():
    """APM001's sites and APM005's in-place arguments name functions the
    port defines, and each in-place index is a positional parameter."""
    from adapm_tpu_torch.device import torchport
    from adapm_tpu_torch.ops import kernels
    for name in KERNEL_DISPATCH_SITES:
        assert callable(getattr(kernels, name, None)
                        or getattr(torchport, name, None)), name
    for name, idx in INPLACE_ARGS.items():
        params = list(inspect.signature(getattr(kernels, name)).parameters)
        assert max(idx) < len(params), (name, params)
    assert set(INPLACE_ARGS) >= {"drop_set", "sync_round",
                                 "ordered_scatter_add"}


def test_metrics_catalog_rows_registered_beside_jax():
    """The catalog rows the port's lint found unregistered are registered
    now, under the JAX package's names: `device.wire_ingest_rows_total`
    and the `fused` section's locstat drain counter and interval, present
    in both packages' metrics_snapshot() after one device-routed step; a
    read of the port's locality counts is a drain."""
    from adapm_tpu.models import make_kge_loss as jax_loss
    from adapm_tpu.ops import DeviceRoutedRunner as JaxRunner
    from adapm_tpu_torch.models import make_kge_loss as torch_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner as TorchRunner
    E, R, d, B = 24, 4, 2, 6
    opts = dict(sync_max_per_sec=0, prefetch=False)
    j = adapm_tpu.Server(E + R, 4 * d, ctx=make_mesh(2),
                         opts=adapm_tpu.SystemOptions(**opts))
    t = adapm_tpu_torch.Server(E + R, 4 * d, ctx=make_context(2, "cpu"),
                               opts=adapm_tpu_torch.SystemOptions(**opts))
    try:
        rng = np.random.default_rng(0)
        vals = rng.normal(size=(E + R, 4 * d)).astype(np.float32) * 0.1
        batch = {"s": rng.integers(0, E, B), "r": rng.integers(E, E + R, B),
                 "o": rng.integers(0, E, B),
                 "neg": rng.integers(0, E, (B, 3))}
        rc, rd = dict.fromkeys(batch, 0), dict.fromkeys(batch, 2 * d)
        for srv, runner_cls, loss in ((j, JaxRunner, jax_loss),
                                      (t, TorchRunner, torch_loss)):
            w = srv.make_worker(0)
            w.wait(w.set(np.arange(E + R), vals))
            runner = runner_cls(srv, loss("complex"), role_class=rc,
                                role_dim=rd)
            runner(batch, None, 0.1)
        snaps = [srv.metrics_snapshot() for srv in (j, t)]
        for snap in snaps:
            assert "wire_ingest_rows_total" in snap["device"]
            assert {"locstat_drains", "locstat_drain_every"} <= \
                set(snap["fused"])
            assert snap["fused"]["locstat_drain_every"] >= 1
        before = snaps[1]["fused"]["locstat_drains"]
        t.locality_summary()
        assert t.metrics_snapshot()["fused"]["locstat_drains"] > before
    finally:
        j.shutdown()
        t.shutdown()


# ---------------------------------------------------------------------------
# runtime lock-order sentinel (lint/lockorder.py)
# ---------------------------------------------------------------------------


def test_lockorder_cycle_detected(port_sentinel):
    a = lockorder.SentinelLock("lock_a")
    b = lockorder.SentinelLock("lock_b")
    with a:
        with b:
            pass  # records a -> b
    with b:
        with pytest.raises(lockorder.LockOrderError, match="cycle"):
            a.acquire()  # b -> a inverts the recorded order
    assert port_sentinel.violations == 1


def test_lockorder_gate_is_leaf(port_sentinel):
    """The port's dispatch gate is a SentinelLock reporting to the port's
    sentinel: server -> gate is sanctioned, anything taken under the
    gate raises."""
    from adapm_tpu_torch.exec import dispatch_gate
    assert isinstance(dispatch_gate(), lockorder.SentinelLock)
    other = lockorder.SentinelLock("server")
    with other:
        with dispatch_gate():
            pass
    with dispatch_gate():
        with pytest.raises(lockorder.LockOrderError, match="LEAF"):
            other.acquire()
    assert port_sentinel.violations == 1


def test_lockorder_gate_leaf_survives_reentrant_hold_above(port_sentinel):
    from adapm_tpu_torch.exec import dispatch_gate
    server = lockorder.SentinelLock("server")
    reg = lockorder.SentinelLock("metrics_registry")
    with server:
        with dispatch_gate():
            with server:  # reentrant: pushes 'server' above the gate
                with pytest.raises(lockorder.LockOrderError,
                                   match="LEAF"):
                    reg.acquire()
    assert port_sentinel.violations == 1


def test_lockorder_same_name_distinct_locks_not_conflated(port_sentinel):
    a = lockorder.SentinelLock("server")
    b = lockorder.SentinelLock("server")
    with a:
        with b:
            pass
    with b:
        with pytest.raises(lockorder.LockOrderError, match="cycle"):
            a.acquire()
    assert port_sentinel.violations == 1


def test_lockorder_reentrant_and_condvar(port_sentinel):
    lk = lockorder.SentinelLock("reentrant")
    with lk:
        with lk:
            pass
    cv = threading.Condition(lockorder.SentinelLock("cv"))
    hit = []

    def waker():
        with cv:
            hit.append(1)
            cv.notify()

    with cv:
        t = threading.Thread(target=waker)
        t.start()
        cv.wait(timeout=5)
    t.join(5)
    assert hit == [1]
    port_sentinel.assert_clean()


def test_lockorder_skip_wrapper_shape():
    """--sys.lint.lockorder off (default): the port's Server builds PLAIN
    RLocks and no sentinel exists; on: SentinelLock wrappers, the
    process sentinel installed, and a set and a pull record the server
    -> gate edge with no violation. The serving plane's admission lock
    follows the same knob."""
    from adapm_tpu_torch.serve.admission import AdmissionQueue
    lockorder.disable_sentinel()
    srv = adapm_tpu_torch.setup(16, 4, device="cpu",
                                opts=adapm_tpu_torch.SystemOptions(
                                    sync_max_per_sec=0))
    try:
        assert not isinstance(srv._lock, lockorder.SentinelLock)
        assert lockorder.get_sentinel() is None
        assert not isinstance(AdmissionQueue(4)._cond._lock,
                              lockorder.SentinelLock)
    finally:
        srv.shutdown()
    srv = adapm_tpu_torch.setup(16, 4, device="cpu",
                                opts=adapm_tpu_torch.SystemOptions(
                                    sync_max_per_sec=0,
                                    lint_lockorder=True))
    try:
        assert isinstance(srv._lock, lockorder.SentinelLock)
        sen = lockorder.get_sentinel()
        assert sen is not None
        w = srv.make_worker(0)
        w.set(np.arange(16), np.ones((16, 4), np.float32))
        w.pull_sync(np.arange(4))
        assert ("server", "dispatch_gate") in sen.edges()
        assert isinstance(AdmissionQueue(4, lockorder=True)._cond._lock,
                          lockorder.SentinelLock)
        sen.assert_clean()
    finally:
        srv.shutdown()
        lockorder.disable_sentinel()


def test_default_rules_cover_every_id():
    assert [r.id for r in default_rules()] == sorted(_RULE_BY_ID)
