"""The learned policy plane on the port (adapm_tpu_torch/policy/ and its
replay gate) against the JAX package's.

The seven tests of tests/test_policy.py run on the port at the same size
(NK=256, VL=4, 8 CPU shards, `device="cpu"`), with the JAX test's own
checks. The live-server twin drives its tier consults deterministically:
each step ends with a synchronous maintenance pass
(`srv.tier.maintain()`), which drains every promotion want queued so
far, so the consults do not depend on a background pass's timing.

Across packages: `train_policy` on the same `.dtrace` and `.wtrace`
files writes byte-identical artifacts in both packages, and an artifact
from either package loads in the other and scores the same feature dict
to the same float64.
"""
import numpy as np
import pytest

import adapm_tpu
from adapm_tpu_torch import Server, SystemOptions, make_context
from adapm_tpu_torch.policy import (PLANE_FEATURES, PlaneModel,
                                    PolicyError, load_policy,
                                    train_policy)
from adapm_tpu_torch.replay import ReplayEngine, load_wtrace, \
    rank_candidates

NK = 256
VL = 4
CPU = "cpu"


@pytest.fixture(scope="module")
def ctx():
    return make_context(8, CPU)


def _drive(srv, steps):
    """test_policy.py's seeded zipf storm against a starved hot pool."""
    w0, w1 = srv.make_worker(0), srv.make_worker(1)
    w0.wait(w0.set(np.arange(NK), np.ones((NK, VL), np.float32)))
    rng = np.random.default_rng(17)
    for i in range(steps):
        w = w0 if i % 2 == 0 else w1
        ks = np.unique((NK * rng.random(16) ** 6.0)
                       .astype(np.int64).clip(0, NK - 1))
        w.pull_sync(ks)
        w.wait(w.push(ks, np.ones((len(ks), VL), np.float32)))
        if i % 4 == 0:
            w.intent(ks, w.current_clock, w.current_clock + 4)
            w.advance_clock()
        srv.wait_sync()
    srv.shutdown()


def _storm(ctx, out_dir, tag, steps=40, tier_rows=8):
    dpath = str(out_dir / f"{tag}.dtrace")
    wpath = str(out_dir / f"{tag}.wtrace")
    opts = SystemOptions(sync_max_per_sec=0, prefetch=False,
                         tier=True, tier_hot_rows=tier_rows,
                         trace_decisions=dpath, trace_workload=wpath)
    _drive(Server(NK, VL, opts=opts, ctx=ctx, num_workers=2), steps)
    return dpath, wpath


@pytest.fixture(scope="module")
def trained(ctx, tmp_path_factory):
    """One storm and one training on the port, shared by the replay and
    load tests: (dtrace, wtrace, policy_path, bundle)."""
    out = tmp_path_factory.mktemp("policy")
    dpath, wpath = _storm(ctx, out, "cap")
    ppath = str(out / "policy.json")
    bundle = train_policy(dpath, wpath, out_path=ppath)
    return dpath, wpath, ppath, bundle


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """The same storm captured and trained by the JAX package."""
    from adapm_tpu.policy import train_policy as jax_train_policy
    out = tmp_path_factory.mktemp("jax_policy")
    dpath = str(out / "cap.dtrace")
    wpath = str(out / "cap.wtrace")
    opts = adapm_tpu.SystemOptions(
        sync_max_per_sec=0, prefetch=False, tier=True, tier_hot_rows=8,
        trace_decisions=dpath, trace_workload=wpath)
    _drive(adapm_tpu.Server(NK, VL, opts=opts, ctx=adapm_tpu.make_mesh(8),
                            num_workers=2), 40)
    ppath = str(out / "policy.json")
    jax_train_policy(dpath, wpath, out_path=ppath)
    return dpath, wpath, ppath


# ---------------------------------------------------------------------------
# the off pin
# ---------------------------------------------------------------------------


def test_policy_off_pin(ctx):
    srv = Server(NK, VL, opts=SystemOptions(sync_max_per_sec=0), ctx=ctx)
    w = srv.make_worker(0)
    w.wait(w.set(np.arange(NK), np.ones((NK, VL), np.float32)))
    w.pull_sync(np.arange(8))
    assert srv.policy is None
    assert not [n for n in srv.obs.names() if n.startswith("policy.")]
    snap = srv.metrics_snapshot()
    assert snap["schema_version"] == 3
    assert snap["policy"] == {}
    srv.shutdown()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_train_is_byte_deterministic(trained, tmp_path):
    dpath, wpath, ppath, bundle = trained
    p2 = str(tmp_path / "again.json")
    train_policy(dpath, wpath, out_path=p2)
    with open(ppath, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()
    tm = bundle.meta["train"]
    assert set(tm) == set(PLANE_FEATURES)
    assert tm["tier"]["fit"] == "logistic", tm
    assert bundle.meta["truncated_weight"] == 0.0
    for plane in tm:
        assert tm[plane]["truncated_rows"] >= 0
    assert bundle.meta["truncated_rows"] == sum(
        tm[p]["truncated_rows"] for p in tm)
    with pytest.raises(ValueError, match="truncated_weight"):
        train_policy(dpath, wpath, truncated_weight=1.5)


# ---------------------------------------------------------------------------
# artifact hygiene
# ---------------------------------------------------------------------------


def test_artifact_corruption_raises_named_error(trained, tmp_path):
    dpath, _, ppath, _ = trained
    with pytest.raises(PolicyError):
        load_policy(str(tmp_path / "nope.json"))
    with open(ppath, "rb") as f:
        raw = bytearray(f.read())
    raw[-10] ^= 0x40
    bad = tmp_path / "flipped.json"
    bad.write_bytes(bytes(raw))
    with pytest.raises(PolicyError):
        load_policy(str(bad))
    with pytest.raises(PolicyError):
        load_policy(dpath)


def test_feature_spec_mismatch_rejected(trained):
    _, _, ppath, _ = trained
    d = load_policy(ppath).planes["tier"].to_dict()
    d["features"] = list(reversed(d["features"]))
    with pytest.raises(PolicyError, match="feature"):
        PlaneModel.from_dict(d)
    with pytest.raises(PolicyError):
        PlaneModel("tier", [0.0], [1.0], [0.0], 0.0)
    with pytest.raises(PolicyError, match="plane"):
        PlaneModel.constant("parking", 0.5)


# ---------------------------------------------------------------------------
# observer-effect and value-preservation pins
# ---------------------------------------------------------------------------


def test_shadow_mode_scores_without_steering(trained):
    _, wpath, ppath, _ = trained
    tr = load_wtrace(wpath)
    base = ReplayEngine(tr, seed=3, speed=100.0, device=CPU).run()
    sh = ReplayEngine(tr, overrides={"policy_file": ppath,
                                     "policy_shadow": True},
                      seed=3, speed=100.0,
                      device=CPU).run(include_snapshot=True)
    assert sh["reads_digest"] == base["reads_digest"]
    pol = sh["snapshot"]["policy"]
    assert pol["shadow"] is True
    consults = pol["shadow_agree"] + pol["shadow_disagree"]
    assert consults > 0 and pol["consults_total"] == consults
    assert pol["applied_total"] == 0


def test_learned_policy_preserves_reads_and_ranks_on_regret(trained):
    _, wpath, ppath, _ = trained
    tr = load_wtrace(wpath)
    art = rank_candidates(
        tr,
        {"heuristic": {},
         "learned": {"policy_tier": "learned", "policy_file": ppath}},
        objective="regret_rate_tier", seed=5, speed=100.0,
        score_decisions=True, device=CPU)
    heur = art["candidates"]["heuristic"]
    lrn = art["candidates"]["learned"]
    assert lrn["reads_digest"] == heur["reads_digest"]
    r_h = heur["score"]["regret_rate_tier"]
    r_l = lrn["score"]["regret_rate_tier"]
    assert r_h is not None and r_l is not None
    assert r_l <= r_h, (r_l, r_h)
    redo = ReplayEngine(tr, overrides={"policy_tier": "learned",
                                       "policy_file": ppath},
                        seed=5, speed=100.0, score_decisions=True,
                        device=CPU).run(include_snapshot=True)
    assert redo["reads_digest"] == lrn["reads_digest"]
    pol = redo["snapshot"]["policy"]
    assert pol["mode.tier"] == "learned"
    assert pol["consults.tier"] > 0
    assert pol["applied_total"] + pol["guard_vetoes_total"] > 0


# ---------------------------------------------------------------------------
# live mechanics
# ---------------------------------------------------------------------------


def test_live_server_consults_policy_and_snapshots(ctx, trained):
    """A live server with --sys.policy.file + learned tier consults the
    model at the real decision sites (each step's synchronous
    maintenance pass drains the promotion wants), registers the policy.*
    counters, and carries the plane detail in its snapshot."""
    _, _, ppath, bundle = trained
    opts = SystemOptions(sync_max_per_sec=0, prefetch=False,
                         tier=True, tier_hot_rows=8,
                         policy_file=ppath, policy_tier="learned")
    srv = Server(NK, VL, opts=opts, ctx=ctx, num_workers=1)
    assert srv.policy is not None
    assert srv.policy.active("tier")
    assert not srv.policy.active("serve")
    w = srv.make_worker(0)
    w.wait(w.set(np.arange(NK), np.ones((NK, VL), np.float32)))
    rng = np.random.default_rng(23)
    for i in range(12):
        ks = np.unique((NK * rng.random(16) ** 6.0)
                       .astype(np.int64).clip(0, NK - 1))
        w.pull_sync(ks)
        w.wait(w.push(ks, np.ones((len(ks), VL), np.float32)))
        w.advance_clock()
        srv.wait_sync()
        srv.tier.maintain()
    assert [n for n in srv.obs.names() if n.startswith("policy.")]
    pol = srv.metrics_snapshot()["policy"]
    assert pol["file"] == ppath
    assert pol["mode.tier"] == "learned"
    assert pol["planes_loaded"] == sorted(bundle.planes)
    assert pol["consults.tier"] > 0
    assert pol["consults_total"] >= pol["consults.tier"]
    assert np.isfinite(w.pull_sync(np.arange(NK))).all()
    srv.shutdown()


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capturer", ["jax", "port"])
def test_train_byte_identical_across_packages(trained, jax_trained,
                                              tmp_path, capturer):
    """`train_policy` on the same trace files writes the same bytes in
    both packages."""
    from adapm_tpu.policy import train_policy as jax_train_policy
    dpath, wpath = (jax_trained if capturer == "jax" else trained)[:2]
    pj, pp = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jax_train_policy(dpath, wpath, out_path=pj)
    train_policy(dpath, wpath, out_path=pp)
    with open(pj, "rb") as a, open(pp, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("trainer", ["jax", "port"])
def test_artifact_scores_the_same_across_packages(trained, jax_trained,
                                                  trainer):
    """An artifact from either package loads in the other, and each
    plane model scores the same seeded feature dicts to the same
    float64 and the same veto."""
    from adapm_tpu.policy import load_policy as jax_load_policy
    ppath = (jax_trained if trainer == "jax" else trained)[2]
    jb, pb = jax_load_policy(ppath), load_policy(ppath)
    assert sorted(jb.planes) == sorted(pb.planes) == sorted(PLANE_FEATURES)
    assert jb.meta == pb.meta
    rng = np.random.default_rng(31)
    for plane, spec in PLANE_FEATURES.items():
        for _ in range(8):
            f = {k: float(v) for k, v in
                 zip(spec, rng.normal(size=len(spec)) * 50)}
            a = jb.planes[plane].score(f)
            b = pb.planes[plane].score(f)
            assert np.float64(a).tobytes() == np.float64(b).tobytes()
            assert jb.planes[plane].veto(f) == pb.planes[plane].veto(f)
        assert jb.planes[plane].to_dict() == pb.planes[plane].to_dict()
