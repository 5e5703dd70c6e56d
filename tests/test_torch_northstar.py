"""The port's north-star runs (adapm_tpu_torch/northstar.py) against the
JAX package's `scripts/northstar.py`, on the CPU at toy sizes.

The JAX script is loaded by path (it is a script, not a package module)
and left as it is. Both packages run on 8 shards, as the JAX suite's
8-device CPU mesh: the JAX table after its bulk_device_init is carried
into the port with weights.from_jax_arrays, and negatives come as an
ordinary role on both (jax threefry and torch Philox are different
streams; tests/test_torch_fused.py does the same). Then a few pm_loop
steps of each model: losses within rtol 1e-5, pools within rtol 1e-5 /
atol 1e-6 (float32 model math that XLA and PyTorch round differently in
the last bits), address books equal (routing, placement and the planner
rounds are exact). The shared-pool eval counts are equal exactly on
integer-valued tables, where every summation order gives the same f32
sums. Every run_* runs at the ADAPM_NS_SMOKE sizes, tiered too (mf,
whose smoke size neither package can run tiered, at four times its
keys), and prints the JAX script's metric names and keys, and the
device. pm_loop's warmup is the one place the port departs from the
script: it warms every batch, where the script's warmup left the tiered
slope negative.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import adapm_tpu
import adapm_tpu_torch
from adapm_tpu.models import make_kge_loss as jax_kge_loss
from adapm_tpu.models import make_mf_loss as jax_mf_loss
from adapm_tpu.models.kge import make_pool_eval_counts as jax_eval_counts
from adapm_tpu.models.sgns import sgns_loss as jax_sgns_loss
from adapm_tpu.ops import DeviceRoutedRunner as JaxRunner
from adapm_tpu.ops import DeviceRouter as JaxRouter
from adapm_tpu_torch import northstar as ns
from adapm_tpu_torch.models import make_kge_loss as torch_kge_loss
from adapm_tpu_torch.models import make_mf_loss as torch_mf_loss
from adapm_tpu_torch.models.sgns import sgns_loss as torch_sgns_loss
from adapm_tpu_torch.ops.fused import DeviceRoutedRunner as TorchRunner
from adapm_tpu_torch.weights import from_jax_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, E, R, d, B, N = 8, 2_000, 16, 8, 64, 4
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def nsj():
    """The JAX package's scripts/northstar.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "northstar_jax", os.path.join(ROOT, "scripts", "northstar.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# each model as the runs build it, at toy size: keys, row width, the
# embedding columns bulk_device_init fills (and its scale), lr, the
# roles and their width, and the batches (negatives as a role)
def _kge_batches(rng):
    return [dict(ns._kge_batch(rng, E, R, B),
                 neg=ns.skewed(rng, E, (B, N))) for _ in range(4)], None


def _sgns_batches(rng):
    return [{"center": 2 * ns.skewed(rng, E, B),
             "ctx": 2 * ns.skewed(rng, E, B) + 1,
             "neg": 2 * ns.skewed(rng, E, (B, N)) + 1}
            for _ in range(4)], None


def _mf_batches(rng):
    users = E - 500
    return ([{"w": ns.skewed(rng, users, B),
              "h": users + ns.skewed(rng, 500, B)} for _ in range(4)],
            [rng.random(B).astype(np.float32) * 4 + 1 for _ in range(4)])


MODELS = {
    "complex": dict(keys=E + R, width=4 * d, emb=2 * d, scale=0.1, lr=0.1,
                    roles=("s", "r", "o", "neg"), dim=2 * d,
                    over=dict(main_over_alloc=1.02), batches=_kge_batches,
                    losses=(jax_kge_loss("complex"),
                            torch_kge_loss("complex"))),
    "sgns": dict(keys=2 * E, width=2 * d, emb=d, scale=0.05, lr=0.05,
                 roles=("center", "ctx", "neg"), dim=d, over={},
                 batches=_sgns_batches,
                 losses=(jax_sgns_loss, torch_sgns_loss)),
    "mf": dict(keys=E, width=2 * d, emb=d, scale=0.1, lr=0.05,
               roles=("w", "h"), dim=d, over={}, batches=_mf_batches,
               losses=(jax_mf_loss(l2=0.01), torch_mf_loss(l2=0.01))),
}


def _servers(nsj, m, seed):
    """A JAX server after the JAX script's bulk_device_init and the port
    server carrying its table and placement, both on 8 shards, the
    runs' options with the pipeline off (delegated rounds would make
    placement depend on timing)."""
    j = adapm_tpu.setup(m["keys"], m["width"], opts=nsj._sys_opts(
        m["keys"], prefetch=False, **m["over"]))
    nsj.bulk_device_init(j.stores[0], m["emb"], m["scale"], seed)
    t = adapm_tpu_torch.setup(
        m["keys"], m["width"], num_shards=S, device="cpu",
        opts=ns._sys_opts(m["keys"], prefetch=False, **m["over"]))
    from_jax_arrays(t, [tuple(np.asarray(p) for p in
                              (st.main, st.cache, st.delta))
                        for st in j.stores],
                    j.ab.owner, j.ab.slot, j.ab.cache_slot)
    return j, t


def _recording(runner, losses):
    def step(role_keys, aux, lr):
        losses.append(runner(role_keys, aux, lr))
        return losses[-1]
    return step


def _check_pools(j, t):
    for sj, st in zip(j.stores, t.stores):
        for name in ("main", "cache", "delta"):
            np.testing.assert_allclose(
                getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_pm_loop_matches_jax(nsj, model):
    """pm_loop (intent for the next batch, the device-routed step, a
    planner round, a clock tick) on both packages from the same table:
    the same losses, pools and placement after slope timing (1 + 1 + 4
    steps), the planner having relocated keys."""
    m = MODELS[model]
    j, t = _servers(nsj, m, seed=3)
    try:
        owner0 = t.ab.owner.copy()
        rc = dict.fromkeys(m["roles"], 0)
        rd = dict.fromkeys(m["roles"], m["dim"])
        lj, lt = [], []
        rj = _recording(JaxRunner(j, m["losses"][0], role_class=rc,
                                  role_dim=rd), lj)
        rt = _recording(TorchRunner(t, m["losses"][1], role_class=rc,
                                    role_dim=rd), lt)
        batches, aux = m["batches"](np.random.default_rng(4))
        wj, wt = j.make_worker(0), t.make_worker(0)
        # no warmup: the JAX script's repeats batch 0, the port's trains
        # the batches in turn (test_pm_loop_warms_every_batch_...)
        nsj.pm_loop(j, wj, rj, batches, aux, m["lr"], 4, warmup=0)
        ns.pm_loop(t, wt, rt, batches, aux, m["lr"], 4, warmup=0)
        assert len(lt) == len(lj) == 6
        np.testing.assert_allclose([float(x) for x in lt],
                                   [float(x) for x in lj], rtol=RTOL)
        _check_pools(j, t)
        for name in ("owner", "slot", "cache_slot"):
            np.testing.assert_array_equal(getattr(t.ab, name),
                                          np.asarray(getattr(j.ab, name)),
                                          err_msg=name)
        assert (t.ab.owner != owner0).any(), "no key relocated"
        assert wt.current_clock == wj.current_clock == 6
    finally:
        j.shutdown()
        t.shutdown()


@pytest.mark.parametrize("chunk", [512, ns.EVAL_CHUNK])
def test_eval_counts_equal_jax_on_integer_table(nsj, chunk):
    """eval_program's shared-pool counts (K4's plain version here) equal
    the JAX package's make_pool_eval_counts(shared_pool=True) over the
    same 8-shard pool, exactly: integer-valued rows in [-3, 3], queries
    at B=64 with zipf entities, over 4 chunks of 512 and one of 65,536
    (the runs' chunk)."""
    m = MODELS["complex"]
    j, t = _servers(nsj, m, seed=5)
    try:
        vals = np.random.default_rng(6).integers(
            -3, 4, (m["keys"], m["width"])).astype(np.float32)
        w = j.make_worker(0)
        w.wait(w.set(np.arange(m["keys"]), vals))
        from_jax_arrays(t, [tuple(np.asarray(p) for p in
                                  (st.main, st.cache, st.delta))
                            for st in j.stores],
                        j.ab.owner, j.ab.slot, j.ab.cache_slot)
        rng = np.random.default_rng(7)
        q = [ns.skewed(rng, E, 64), rng.integers(E, E + R, 64),
             ns.skewed(rng, E, 64)]
        nch = -(-E // chunk)
        pad = np.zeros(nch * chunk, dtype=np.int64)
        pad[:E] = np.arange(E)
        put = j.ctx.put_replicated
        want = jax_eval_counts("complex", 2 * d, 2 * d, chunk,
                               shared_pool=True)(
            j.stores[0].main, JaxRouter(j, 0).tables(),
            put(pad.reshape(nch, chunk)), np.int32(E), *map(put, q))
        fn, tables, ent_keys = ns.eval_program(t, E, d, chunk)
        assert tuple(ent_keys.shape) == (nch, chunk)
        got = fn(t.stores[0].main, tables, ent_keys, E,
                 *map(torch.as_tensor, q))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        assert int(got[0].sum()) > 0 and int(got[1].sum()) > 0
    finally:
        j.shutdown()
        t.shutdown()


def _store(tier, keys=3_000, width=24):
    srv = adapm_tpu_torch.setup(
        keys, width, num_shards=2, device="cpu",
        opts=ns._sys_opts(keys, tier=tier, prefetch=False))
    return srv, srv.stores[0]


def test_bulk_init_untiered_fills_every_slot():
    """Untiered: every slot of every shard filled over several slabs (the
    last one short), optimizer columns exactly f32 1e-6, the embedding
    columns' mean within 0.01 and std within 2% of normal(0, 0.1) over
    ~36,000 draws, the same seed giving the same bytes twice and another
    seed others."""
    srv, st = _store(False)
    try:
        ns_slab = ns.SLAB
        ns.SLAB = 1_000          # 1,880 slots a shard: two slabs, one short
        try:
            fills = []
            for seed in (11, 11, 12):
                st.main.fill_(float("nan"))
                ns.bulk_device_init(st, 12, 0.1, seed)
                fills.append(st.main.clone())
        finally:
            ns.SLAB = ns_slab
        main = fills[0]
        assert st.main_slots > 1_000 and main.shape[1] == st.main_slots
        assert not torch.isnan(main).any()
        assert bool((main[:, :, 12:] == torch.tensor(1e-6)).all())
        emb = main[:, :, :12].double()
        assert abs(float(emb.mean())) < 0.01
        assert abs(float(emb.std()) / 0.1 - 1) < 0.02
        assert torch.equal(main.view(torch.int32), fills[1].view(torch.int32))
        assert not torch.equal(main, fills[2])
    finally:
        srv.shutdown()


def test_bulk_init_tiered_is_the_jax_scripts_host_fill(nsj):
    """Tiered (the JAX script's --tier): the host cold store filled in
    place, byte for byte the JAX script's fill of a JAX tiered store of
    the same geometry (8 shards; the cold store's shape does not depend
    on how many rows are hot), optimizer
    columns exactly 1e-6, every slot filled, residency reset (nothing
    hot); the same seed twice gives the same bytes."""
    from adapm_tpu.tier.coldpath import main_full_host as jax_full
    from adapm_tpu_torch.tier.coldpath import main_full_host
    keys, width = 3_000, 24
    nsj.TIER = True
    try:
        j = adapm_tpu.setup(keys, width, opts=nsj._sys_opts(
            keys, prefetch=False))
    finally:
        nsj.TIER = False
    t = adapm_tpu_torch.setup(keys, width, num_shards=S, device="cpu",
                              opts=ns._sys_opts(keys, tier=True,
                                                prefetch=False))
    try:
        nsj.bulk_device_init(j.stores[0], 12, 0.1, seed=8)
        st = t.stores[0]
        st.coldq.q.fill(np.nan)
        ns.bulk_device_init(st, 12, 0.1, seed=8)
        got, want = main_full_host(st), jax_full(j.stores[0])
        assert got.shape == want.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert not np.isnan(got).any()
        assert (got[:, :, 12:] == np.float32(1e-6)).all()
        assert (st.res.dev_row < 0).all()
        ns.bulk_device_init(st, 12, 0.1, seed=8)
        assert np.array_equal(main_full_host(st).view(np.uint32),
                              got.view(np.uint32))
    finally:
        j.shutdown()
        t.shutdown()


class _Promoting:
    """Server, worker and runner of a store that promotes a batch's rows
    at the batch's first step: that step takes FIRST seconds, every later
    one THEN (the tiered north-star runs on the card)."""

    FIRST, THEN = 0.05, 0.002

    def __init__(self):
        self.seen = set()
        self.current_clock = 0
        self.sync = self

    def intent(self, keys, start, end):
        pass

    def run_round(self):
        pass

    def advance_clock(self):
        self.current_clock += 1

    def __call__(self, batch, aux, lr):
        k = int(batch["k"][0])
        time.sleep(self.THEN if k in self.seen else self.FIRST)
        self.seen.add(k)
        return torch.ones(())


def test_pm_loop_warms_every_batch_before_timing(nsj):
    """The JAX script's warmup trains batch 0 only, so the short timed
    loop pays the other batches' first steps and the slope comes out
    negative (the tiered kge run on an H100 read -39.37 ms/step); the
    port's warmup trains each batch once, its slope is the steady step,
    and a slope over steps not yet steady raises instead of reporting."""
    batches = [{"k": np.array([i])} for i in range(4)]
    st = _Promoting()
    assert nsj.pm_loop(st, st, st, batches, None, 0.1, 16, warmup=3) < 0
    st = _Promoting()
    dt = ns.pm_loop(st, st, st, batches, None, 0.1, 16,
                    warmup=len(batches))
    assert _Promoting.THEN * 0.5 < dt < _Promoting.THEN * 5
    st = _Promoting()
    with pytest.raises(RuntimeError, match="not in a steady state"):
        ns.pm_loop(st, st, st, batches, None, 0.1, 16, warmup=0)


def test_slope_time_needs_four_steps():
    with pytest.raises(ValueError, match="steps >= 4"):
        ns.slope_time(lambda i: torch.zeros(()), 3)
    calls = []

    def step(i):
        calls.append(i)
        time.sleep(0.002)
        return torch.ones(())

    dt = ns.slope_time(step, 4)
    assert len(calls) == 1 + 1 + 4 and 0.001 < dt < 0.05


# the JAX script's keys of each workload's JSON line
# (scripts/northstar.py:188-193, :220, :259-262, :291-293, :334-337,
# :362-366); the port adds "device"
JAX_KEYS = {
    "kge": {"metric", "entities", "relations", "dim", "ms_per_step",
            "triples_per_sec", "derived_epoch_s_20.6M_triples"},
    "kge_epoch": {"measured_epoch_s"},
    "kge_eval": {f"{k}{b}" for b in (64, 512) for k in (
        "eval_ms_per_batch", "eval_triples_per_sec_b",
        "derived_eval_s_per_10k_triples_b")},
    "w2v": {"metric", "vocab", "dim", "ms_per_step", "pairs_per_sec"},
    "w2v_app": {"metric", "vocab", "corpus_tokens", "pairs", "epoch_s",
                "pairs_per_sec_app_loop"},
    "mf": {"metric", "users", "movies", "rank", "ms_per_step",
           "ratings_per_sec", "derived_epoch_s_25M_ratings"},
}
METRICS = {"kge": "northstar_kge_wikidata5m_scale",
           "w2v": "northstar_w2v_1bwords_scale",
           "w2v_app": "northstar_w2v_app_loop",
           "mf": "northstar_mf_movielens25m_scale"}


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def test_jax_keys_are_the_jax_scripts(nsj):
    """JAX_KEYS against the JAX script's own lines for its two cheapest
    workloads at their smoke sizes (the others only add keys the
    script's source spells out)."""
    for name, out in (("mf", nsj.run_mf(users=2_000, movies=1_000, rank=8,
                                         B=1024, steps=4)),
                      ("w2v", nsj.run_w2v(V=5_000, d=16, B=512, N=3,
                                          steps=4))):
        assert set(out) == JAX_KEYS[name] and out["metric"] == METRICS[name]


def _check_line(out, name):
    want = JAX_KEYS[name] | {"device"}
    if name == "kge":
        want |= JAX_KEYS["kge_epoch"] | JAX_KEYS["kge_eval"]
    assert out["metric"] == METRICS[name] and set(out) == want, name
    assert out["device"] == "cpu"
    rates = [v for k, v in out.items() if "per_sec" in k]
    assert rates and all(np.isfinite(v) and v > 0 for v in rates), name


def test_every_run_at_smoke_size(monkeypatch, capsys, tmp_path):
    """main() at the ADAPM_NS_SMOKE sizes on the CPU: kge with --epoch
    and --eval, w2v, w2v_app and mf; one JSON line each, in order, with
    the JAX script's metric name and keys plus the device, finite and
    positive rates."""
    monkeypatch.setenv("ADAPM_NS_SMOKE", "1")
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    names = ["kge", "w2v", "w2v_app", "mf"]
    assert ns.main(names + ["--epoch", "--eval"], device="cpu") == 0
    lines = _lines(capsys)
    assert len(lines) == len(names)
    for name, out in zip(names, lines):
        _check_line(out, name)
    assert lines[0]["entities"] == ns.SMOKE["kge"]["E"]


def test_every_run_tiered(monkeypatch, capsys):
    """--tier on the CPU: kge (--epoch, --eval) and w2v at the
    ADAPM_NS_SMOKE sizes print their lines; mf at its smoke size stops
    as the JAX script's tiered mf does there (a quarter of its 3,000
    keys hot is fewer rows than one step of 1,024 ratings touches: the
    tier refuses the step, naming the hot pool), and runs at four times
    the keys."""
    monkeypatch.setenv("ADAPM_NS_SMOKE", "1")
    assert ns.main(["kge", "w2v", "--tier", "--epoch", "--eval"],
                   device="cpu") == 0
    lines = _lines(capsys)
    assert len(lines) == 2
    for name, out in zip(("kge", "w2v"), lines):
        _check_line(out, name)
    with pytest.raises(RuntimeError, match="tier hot pool exhausted"):
        ns.main(["mf", "--tier"], device="cpu")
    _check_line(ns.run_mf(**dict(ns.SMOKE["mf"], users=8_000, movies=4_000),
                          tier=True, device="cpu"), "mf")


def test_w2v_app_counts_the_jax_apps_pairs(monkeypatch, capsys, tmp_path,
                                           nsj):
    """run_w2v_app's corpus and pair count are the JAX app's: the same
    generated corpus, vocabulary and tokens, and the JAX app's
    _pairs_for over it sums to the port's `pairs`."""
    from adapm_tpu.apps import word2vec as jax_w2v
    from adapm_tpu.io import text as jax_text
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    out = ns.run_w2v_app(device="cpu", **ns.SMOKE["w2v_app"])
    path = os.path.join(str(tmp_path), f"ns_w2v_{ns.SMOKE['w2v_app']['V']}"
                        ".txt")
    words, counts, vocab = jax_text.build_vocab(path, 1)
    total = int(counts.sum())
    args = jax_w2v.build_parser().parse_args(["--data", path])
    pairs = sum(len(jax_w2v._pairs_for(s, i, 5, args.seed, counts, total,
                                       args.sample)[0])
                for i, s in enumerate(jax_text.sentences(path, vocab)))
    assert (out["vocab"], out["corpus_tokens"], out["pairs"]) == \
        (len(words), total, pairs)


def test_cli_imports_no_jax_and_needs_the_card():
    """Imported and run (mf at its smoke size on the CPU), the module
    loads neither jax nor the JAX package; `python -m
    adapm_tpu_torch.northstar` on a host without a card exits non-zero
    naming the missing card and prints no result; an unknown workload
    is refused by name."""
    env = dict(os.environ, ADAPM_NS_SMOKE="1", PYTHONPATH=ROOT)
    code = ("import sys\n"
            "from adapm_tpu_torch import northstar\n"
            "northstar.main(['mf'], device='cpu')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'adapm_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.splitlines()[-1])["device"] == "cpu"
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "-m",
                            "adapm_tpu_torch.northstar", "mf"], env=env,
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode != 0 and "no CUDA device" in r.stderr
        assert not r.stdout.strip()
    with pytest.raises(SystemExit, match="unknown workload"):
        ns.main(["kg"], device="cpu")
