"""Sampling schemes of the port (adapm_tpu_torch/core/sampling.py) against
the JAX package's: the test_sampling.py scenarios run on both packages
with the same seeds, and every sampled key, every sampled value and the
placement after every phase must be equal, bitwise. The schemes draw on
the host from numpy Generators, so equal seeds and equal placement must
give equal keys."""
import numpy as np
import pytest

import adapm_tpu
import adapm_tpu_torch
from adapm_tpu.parallel.mesh import make_mesh
from adapm_tpu_torch.device.context import make_context

NK, S = 100, 4
SCHEMES = ["naive", "preloc", "pool", "local"]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(S)


def _server(pkg, ctx, scheme, with_replacement):
    opts = pkg.SystemOptions(sampling_scheme=scheme,
                             sampling_with_replacement=with_replacement,
                             sync_max_per_sec=0, prefetch=False)
    s = pkg.Server(NK, 2, opts=opts, ctx=ctx, num_workers=4)
    ws = [s.make_worker(i) for i in range(4)]
    # values = key id, so sampled pulls are checkable
    keys = np.arange(NK)
    vals = np.repeat(keys.astype(np.float32)[:, None], 2, axis=1)
    ws[0].wait(ws[0].set(keys, vals))
    s.quiesce()
    s.enable_sampling_support(lambda n, rng: rng.integers(0, NK, size=n))
    return s, ws


def _scenario(s, ws, scheme):
    """Prepare/pull (whole and partial), a placement change by intents,
    then more pulls; returns everything sampled and read, in order."""
    out = []
    for i, w in enumerate(ws):
        h = w.prepare_sample(20 + i)
        if scheme == "preloc":
            s.wait_sync()  # act on the intent the scheme signalled
        k1, v1 = w.pull_sample(h, 7)
        k2, v2 = w.pull_sample(h)
        np.testing.assert_array_equal(v2[:, 0], k2.astype(np.float32))
        out += [k1, v1, k2, v2]
        w.finish_sample(h)
    # worker 3 claims every other key: relocations change what is local
    ws[3].intent(np.arange(0, NK, 2), 0, 1000)
    s.wait_sync()
    for w in ws:
        for n in (40, 5):
            h = w.prepare_sample(n)
            out.append(w.pull_sample_keys(h))
            w.finish_sample(h)
    out.append(np.array([s.sampling.stats[k] for k in
                         ("prepared", "pulled", "pulled_local")]))
    return out


@pytest.mark.parametrize("with_replacement", [True, False],
                         ids=["wr", "wor"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_sampled_keys_match_jax(mesh, scheme, with_replacement):
    sj, wj = _server(adapm_tpu, mesh, scheme, with_replacement)
    st, wt = _server(adapm_tpu_torch, make_context(S, "cpu"), scheme,
                     with_replacement)
    oj, ot = _scenario(sj, wj, scheme), _scenario(st, wt, scheme)
    assert len(oj) == len(ot)
    for i, (a, b) in enumerate(zip(oj, ot)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), i
    for name in ("owner", "slot", "cache_slot"):
        np.testing.assert_array_equal(getattr(st.ab, name),
                                      getattr(sj.ab, name))
    if not with_replacement:
        assert len(np.unique(ot[2])) == len(ot[2]), "WOR duplicates"
    sj.shutdown()
    st.shutdown()


def test_partial_pull_over_budget_raises():
    s, ws = _server(adapm_tpu_torch, make_context(S, "cpu"), "naive", True)
    h = ws[0].prepare_sample(10)
    assert len(ws[0].pull_sample(h, 4)[0]) == 4
    assert len(ws[0].pull_sample(h, 6)[0]) == 6
    with pytest.raises(ValueError):
        ws[0].pull_sample(h, 1)


def test_local_scheme_stays_local():
    """The Local scheme never leaves the worker's shard."""
    s, ws = _server(adapm_tpu_torch, make_context(S, "cpu"), "local", True)
    w = ws[3]
    before = dict(w.stats)
    h = w.prepare_sample(50)
    keys, _ = w.pull_sample(h)
    assert s.ab.is_local(keys, w.shard).all()
    assert w.stats["pull_params_local"] - before["pull_params_local"] == 50


def test_distribution_sanity():
    s, ws = _server(adapm_tpu_torch, make_context(S, "cpu"), "naive", True)
    h = ws[0].prepare_sample(4000)
    keys, _ = ws[0].pull_sample(h)
    counts = np.bincount(keys, minlength=NK)
    assert counts.min() > 5 and counts.max() < 120
