"""The port's CUDA kernels on the card, against their plain PyTorch
versions (adapm_tpu_torch/ops/kernels.py) — bitwise for K1 and K3 (their
multi-segment forms, K1 at RESCAL's 32,768-f32 rows in column slabs
and in a captured graph, K3's long runs and chunk-crossing runs included,
deterministic over two runs), within
rtol 1e-5 for K2 (CUDA's rsqrt vs the CPU's 1/sqrt), K4's counts equal on
integer-valued data (every summation order gives the same f32 sums) and
within the near-tie rule on random data, its pair form's bitwise its
one-CTA-a-block form's and one trace record a launch, K5 within rtol 1e-5 / atol 1e-6
(its sums run in another order than the plain version's) and bitwise
over two runs, its epilogue bitwise K2; K6, K7 and K16 the same way
(K16 also at an odd width, with one negative, and in RESCAL's graph
windows against sequential steps, bitwise) — plus
a small fused step on cuda against the same step on cpu, and run_scan's
CUDA graph against sequential steps, bitwise (ComplEx, a K2 loss with
aux, SGNS with alias-drawn negatives, MF with its ratings as aux); and
the prefetch pipeline and the background planner on the card: a staged
pull bitwise the plain pull, one graph capture across windows while
delegated rounds relocate keys, the planner converging to the exact
sum under concurrent pushes; K10 on long bags with cold members and
K11's last-wins and drop cases, bitwise their plain versions; K14's
three forms and K15 (owners repeated within a round, held rows) bitwise
theirs, and the device port's sets and syncs on the card bitwise the
same programs on the CPU; an
incremental checkpoint chain saved on the card restored bitwise into a
fresh server on the card and into one on the CPU, and a flight-traced
lookup whose device slice is above zero; K4's multi-process form
(queries from rows, owned candidates) equal to its plain version on
integer rows and within the near-tie rule on random ComplEx rows, its
program spans on the profiler's host rows only, and
two loopback nodes with their pools on the card bitwise a shadow; K17
(RotatE's count by distance) within the near-tie rule of its plain
version over every query block and copy width, equal over two runs, one
trace record a launch, and RotatE's eval programs taking it with their
spans; K13
into raw-cudaMalloc slabs bitwise its plain version at both parities,
its alignment checks, and two launched ranks on the card exchanging
through K13 over CUDA IPC, their collective pull and push bitwise a
shadow; K1, K3, K14 and K15 naming the top rows of a 9 GB pool, past
f32 element 2^31, bitwise their plain versions; and the north-star
runs' bulk_device_init leaving no slot of a pool on the card unwritten.

Every case needs a CUDA device and skips without one. This file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from adapm_tpu_torch.ops import kernels as K

OOB = 2**31 - 2
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


def _coords(rng, n, shards, slots):
    sh = rng.integers(0, shards, n).astype(np.int32)
    sl = rng.integers(0, slots, n).astype(np.int32)
    u = rng.random(n)
    sl[u < 0.1] = OOB
    sl[(u >= 0.1) & (u < 0.15)] = -3
    sh[(u >= 0.15) & (u < 0.2)] = shards
    return torch.from_numpy(sh), torch.from_numpy(sl)


def _heavy_coords(rng, n, shards, slots, distinct=6):
    """n coordinates naming `distinct` rows, each ~n / distinct times,
    with _coords' out-of-range and negative ones."""
    pick = torch.from_numpy(rng.integers(0, distinct, n))
    sh, sl = _coords(rng, n, shards, slots)
    ok = (sl >= 0) & (sl < slots) & (sh < shards)
    sh = torch.where(ok, (pick % shards).int(), sh)
    sl = torch.where(ok, (pick // shards % slots).int(), sl)
    return sh, sl


@pytest.mark.parametrize("L", [12, 64, 7, 32_768, 32_766])
def test_routed_gather_both_forms_bitwise(cuda, L):
    """Both forms on a uniform batch and on a heavy-repeat one (256 rows
    from 6 distinct slots); at 32,768 and 32,766 f32 the pools' rows
    overflow half of L2, so K1 walks column slabs (RESCAL's relation
    rows)."""
    rng = np.random.default_rng(L)
    S, R, C = 3, 80, 40
    main, cache, delta = (torch.randn(S, k, L) for k in (R, C, C))
    main[0, :3] = -0.0
    for n, coords in ((500, _coords), (256, _heavy_coords)):
        assert (K._k1_slab(n, L, S * R, L % 4 == 0) < L) == (L > 512)
        o = coords(rng, n, S, R)
        c = coords(rng, n, S, C)
        use_c = torch.from_numpy(rng.random(n) < 0.5)
        for args in ((main, None, None) + o,
                     (main, cache, delta) + o + c + (use_c,)):
            ref = K.routed_gather(*args)
            got = K.routed_gather(*[a if a is None else a.to(cuda)
                                    for a in args])
            assert torch.equal(_bits(got), _bits(ref)), (n, len(args))


def _shifted(p, cuda, shift):
    """p copied to the card `shift` floats past a 16-byte boundary."""
    store = torch.zeros(p.numel() + shift, device=cuda)
    return store[shift:].view(p.shape).copy_(p)


@pytest.mark.parametrize("L", [12, 7, 600, 1_028, 1_030, 32_768, 32_766])
def test_routed_gather_slabs_of_every_width_bitwise(cuda, L, monkeypatch):
    """K1 with its L2 budget at 0, so every row wider than 512 f32 is
    walked in column slabs of one block (a last slab cut short at 600,
    1,028 and 1,030 f32), both forms, aligned and misaligned pools (the
    4-byte form), bitwise its plain version."""
    monkeypatch.setattr(K, "K1_L2_BYTES", 0)
    rng = np.random.default_rng(L + 7)
    S, R, C, n = 3, 40, 20, 300
    main, cache, delta = (torch.randn(S, k, L) for k in (R, C, C))
    main[0, :3] = -0.0
    o = _heavy_coords(rng, n, S, R, distinct=20)
    c = _coords(rng, n, S, C)
    use_c = torch.from_numpy(rng.random(n) < 0.5)
    assert (K._k1_slab(n, L, S * R, True) < L) == (L > 512)
    for args in ((main, None, None, o),
                 (main, cache, delta, o + c + (use_c,))):
        ref = K.routed_gather_segments(*args[:3], [args[3]])
        seg = [tuple(t.to(cuda) for t in args[3])]
        for shift in (0, 1):
            dev = [None if p is None else _shifted(p, cuda, shift)
                   for p in args[:3]]
            got = K.routed_gather_segments(*dev, seg)
            assert torch.equal(_bits(got), _bits(ref)), shift


def test_routed_gather_wide_form_in_a_captured_graph(cuda):
    """K1's column-slab form at 32,768 f32 captured in a CUDA graph: each
    replay on fresh pool contents is bitwise the plain version on them."""
    rng = np.random.default_rng(11)
    S, R, C, n, L = 2, 80, 40, 400, 32_768
    main, cache, delta = (torch.randn(S, k, L).to(cuda) for k in (R, C, C))
    o = [t.to(cuda) for t in _heavy_coords(rng, n, S, R, distinct=30)]
    c = [t.to(cuda) for t in _coords(rng, n, S, C)]
    use_c = torch.from_numpy(rng.random(n) < 0.5).to(cuda)
    seg = [tuple(o) + tuple(c) + (use_c,)]
    assert K._k1_slab(n, L, S * R + 2 * S * C, True) < L
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        K.routed_gather_segments(main, cache, delta, seg)
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = K.routed_gather_segments(main, cache, delta, seg)
    for seed in range(3):
        # fresh contents from a generator of the test's own (the capture
        # takes no part of the default CUDA generator's state)
        gen = torch.Generator().manual_seed(seed)
        for p in (main, cache, delta):
            p.copy_(torch.randn(p.shape, generator=gen))
        main[0, :2] = -0.0
        graph.replay()
        torch.cuda.synchronize()
        ref = K.routed_gather_segments_plain(main, cache, delta, seg)
        assert torch.equal(_bits(out), _bits(ref)), seed


@pytest.mark.parametrize("L", [16, 5, 32_768, 32_766])
def test_ordered_scatter_add_bitwise_and_deterministic(cuda, L):
    rng = np.random.default_rng(L)
    S, R, n = 2, 30, 3000
    base = torch.randn(S, R, L)
    sh, sl = _coords(rng, n, S, 6)              # heavy duplicates
    vals = torch.from_numpy((rng.normal(size=(n, L)) * 10.0 ** rng.integers(
        -3, 4, (n, 1))).astype(np.float32))
    ref = base.clone()
    K.ordered_scatter_add(ref, sh, sl, vals)
    outs = []
    for _ in range(2):
        pool = base.clone().to(cuda)
        K.ordered_scatter_add(pool, sh.to(cuda), sl.to(cuda), vals.to(cuda))
        outs.append(pool)
    assert torch.equal(_bits(outs[0]), _bits(ref))
    assert torch.equal(_bits(outs[1]), _bits(ref))


def _scatter_twice(cuda, base, segs, vals):
    """K3 on the card twice from one base: both results, on the host."""
    outs = []
    for _ in range(2):
        pool = base.clone().to(cuda)
        K.ordered_scatter_add_segments(
            pool, [(a.to(cuda), b.to(cuda)) for a, b in segs], vals.to(cuda))
        outs.append(pool)
    torch.cuda.synchronize()
    return [_bits(o) for o in outs]


def _scatter_case(rng, S, R, L, sh, sl, sizes):
    base = torch.randn(S, R, L)
    base[0, :2] = -0.0
    n = len(sh)
    vals = torch.from_numpy((rng.normal(size=(n, L)) * 10.0 ** rng.integers(
        -3, 4, (n, 1))).astype(np.float32))
    vals[::5] = -0.0
    cuts = np.cumsum(sizes)[:-1]
    segs = [(torch.from_numpy(np.ascontiguousarray(a)),
             torch.from_numpy(np.ascontiguousarray(b)))
            for a, b in zip(np.split(sh.astype(np.int32), cuts),
                            np.split(sl.astype(np.int32), cuts))]
    ref = base.clone()
    for (a, b), v in zip(segs, torch.split(vals, list(sizes))):
        K.ordered_scatter_add(ref, a, b, v.contiguous())
    return base, segs, vals, _bits(ref)


@pytest.mark.parametrize("L", [5, 12, 512, 600, 1030, 32_768, 32_766])
def test_ordered_scatter_long_runs_and_chunk_boundaries(cuda, L):
    """One target repeated 1,000 times (a run far longer than the ring),
    runs of every length crossing the 32-entry chunks, out-of-range
    entries, and several segments with an empty one: bitwise equal to
    sequential plain calls and deterministic. L=600 and L=1030 loop
    over column blocks (vector and scalar elements); L=32,768 and 32,766
    spread them over column slabs (vector and scalar elements)."""
    rng = np.random.default_rng(L)
    S, R = 2, 64
    hot = np.zeros(1000, np.int64)                       # row (0, 0)
    runs = np.repeat(np.arange(1, 60), np.arange(1, 60) % 37 + 1)
    tail = rng.integers(0, S * R, 700)
    flat = np.concatenate([hot, runs, tail])
    order = rng.permutation(len(flat))
    flat = flat[order]
    sh, sl = flat // R, flat % R
    u = rng.random(len(flat))
    sl[u < 0.05] = OOB
    sh[(u >= 0.05) & (u < 0.08)] = -1
    n = len(flat)
    sizes = (n // 3, 0, n // 3, n - 2 * (n // 3))
    base, segs, vals, ref = _scatter_case(rng, S, R, L, sh, sl, sizes)
    a, b = _scatter_twice(cuda, base, segs, vals)
    assert torch.equal(a, ref) and torch.equal(b, ref)


def test_ordered_scatter_all_oob_empty_and_unaligned(cuda):
    rng = np.random.default_rng(3)
    S, R, L = 2, 16, 12
    sh = np.zeros(300, np.int64)
    sl = np.full(300, OOB, np.int64)
    sl[::3] = -5
    base, segs, vals, ref = _scatter_case(rng, S, R, L, sh, sl, (300,))
    a, b = _scatter_twice(cuda, base, segs, vals)
    assert torch.equal(a, ref) and torch.equal(b, ref)
    assert torch.equal(a, _bits(base))                   # nothing lands
    empty = torch.zeros(0, dtype=torch.int32)
    a, _ = _scatter_twice(cuda, base, [(empty, empty)], torch.zeros(0, L))
    assert torch.equal(a, _bits(base))
    # an unaligned pool: L % 4 == 0 but the rows are not 16-byte aligned
    sh, sl = _coords(rng, 400, S, 6)
    vals = torch.randn(400, L)
    ref = base.clone()
    K.ordered_scatter_add(ref, sh, sl, vals)
    store = torch.zeros(S * R * L + 1, device=cuda)
    pool = store[1:].view(S, R, L)
    pool.copy_(base.to(cuda))
    assert pool.data_ptr() % 16 != 0
    K.ordered_scatter_add(pool, sh.to(cuda), sl.to(cuda), vals.to(cuda))
    assert torch.equal(_bits(pool), _bits(ref))


@pytest.mark.parametrize("L", [5, 12, 512, 600, 32_768, 32_766])
def test_routed_gather_segments_bitwise(cuda, L):
    """Multi-segment K1, both forms, with an empty segment, a heavy-repeat
    segment (48 rows from 6 distinct slots) and more segments than one
    launch takes: equal to per-segment plain calls (column slabs at
    32,768 and 32,766 f32)."""
    rng = np.random.default_rng(L + 1)
    S, R, C = 3, 80, 40
    main, cache, delta = (torch.randn(S, k, L) for k in (R, C, C))
    main[0, :3] = -0.0
    sizes = [70, 0, 33, 1, 300, 48] + [5] * (K.MAX_SEGMENTS)
    segs_m, segs_f = [], []
    for n in sizes:
        coords = _heavy_coords if n == 48 else _coords
        o = coords(rng, n, S, R)
        c = coords(rng, n, S, C)
        use_c = torch.from_numpy(rng.random(n) < 0.5)
        segs_m.append(o)
        segs_f.append(o + c + (use_c,))
    for pools, segs in (((main, None, None), segs_m),
                        ((main, cache, delta), segs_f)):
        ref = torch.cat([K.routed_gather(*pools, *s) for s in segs])
        dp = [None if p is None else p.to(cuda) for p in pools]
        ds = [tuple(t.to(cuda) for t in s) for s in segs]
        outs = [K.routed_gather_segments(*dp, ds) for _ in range(2)]
        for o in outs:
            assert torch.equal(_bits(o), _bits(ref))


def test_adagrad_both_forms(cuda):
    g = torch.randn(300, 16)
    rows = torch.rand(300, 32)
    ref = K.adagrad_update(g, rows[:, 16:], 0.1, 1e-10)
    got = K.adagrad_update(g.to(cuda), rows.to(cuda)[:, 16:], 0.1, 1e-10)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-7)
    assert torch.equal(_bits(got[:, 16:]), _bits(ref[:, 16:]))
    # into a row slice of a larger update buffer, as the step writes it
    buf = torch.full((310, 32), 7.0, device=cuda)
    K.adagrad_update(g.to(cuda), rows.to(cuda)[:, 16:], 0.1, 1e-10,
                     out=buf[5:305])
    assert torch.equal(_bits(buf[5:305]), _bits(got))
    assert bool((buf[:5] == 7).all() and (buf[305:] == 7).all())
    emb, acc = rows[:, :16].contiguous(), rows[:, 16:].contiguous()
    re, ra = K.adagrad_apply(g, emb, acc, 0.1, 1e-10)
    ge, ga = K.adagrad_apply(g.to(cuda), emb.to(cuda), acc.to(cuda), 0.1,
                             1e-10)
    torch.testing.assert_close(ga.cpu(), ra, rtol=1e-5, atol=0)
    torch.testing.assert_close(ge.cpu(), re, rtol=1e-4, atol=1e-6)


def _k4_case(rng, dev, B, Kd, L, E=700, C=256, integer=False, oob=False,
             S=2, R=400):
    nk = E + 10
    flat = rng.permutation(S * R)[:nk]
    owner = torch.from_numpy((flat // R).astype(np.int32))
    slot = torch.from_numpy((flat % R).astype(np.int32))
    if oob:  # keys whose coordinates lie outside the pool read zero rows
        bad = rng.permutation(nk)[:nk // 10]
        owner[bad[::3]] = S
        slot[bad[1::3]] = -1
        slot[bad[2::3]] = OOB
    if integer:
        pool = torch.from_numpy(rng.integers(-4, 5, (S, R, L))).float()
        q_o, q_s = (torch.from_numpy(rng.integers(-3, 4, (B, Kd))).float()
                    for _ in range(2))
    else:
        pool = torch.randn(S, R, L)
        q_o, q_s = torch.randn(B, Kd), torch.randn(B, Kd)
    nch = -(-E // C)
    pad = np.zeros(nch * C, np.int32)
    pad[:E] = rng.permutation(E)
    keys = torch.from_numpy(pad.reshape(nch, C))
    okey = torch.from_numpy(rng.integers(0, E, B).astype(np.int32))
    skey = torch.from_numpy(rng.integers(0, E, B).astype(np.int32))
    # true scores of real candidates (the true key is a candidate): exact
    # ties on integer data
    rows = K._fill_gather_plain(pool, owner[okey.long()],
                                slot[okey.long()])[:, :Kd]
    true = (q_o * rows).sum(1)
    args = [pool, owner, slot, keys, E, q_o, q_s, true, okey, skey]
    return args, [a.to(dev) if torch.is_tensor(a) else a for a in args]


def _k4_twice(dev_args, **kw):
    """K4 on the card twice: the counts of both runs, on the host."""
    outs = [K.pool_eval_counts(*dev_args, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    return [tuple(t.cpu() for t in o) for o in outs]


@pytest.mark.parametrize("B,Kd,L", [(64, 256, 512), (150, 16, 32),
                                    (37, 7, 9), (5, 130, 130)])
def test_pool_eval_counts_exact_on_integers(cuda, B, Kd, L):
    """Vector and scalar copies, several query blocks, K not a multiple
    of the 32-column chunk, a padded candidate tail."""
    rng = np.random.default_rng(Kd)
    ref_args, dev_args = _k4_case(rng, cuda, B, Kd, L, integer=True)
    ref = K.pool_eval_counts(*ref_args)
    got = K.pool_eval_counts(*dev_args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
    assert int(ref[0].sum()) > 0


def test_pool_eval_counts_near_ties(cuda):
    rng = np.random.default_rng(1)
    ref_args, dev_args = _k4_case(rng, cuda, 64, 256, 512)
    g_o, g_s = K.pool_eval_counts(*dev_args, parts=2)
    p_o, p_s, t_o, t_s = K.pool_eval_counts_plain(*ref_args, parts=2,
                                                  ties=True)
    assert ((g_o.cpu() - p_o).abs() <= t_o).all()
    assert ((g_s.cpu() - p_s).abs() <= t_s).all()


# the row length per K: K=7 and K=128 take unaligned rows (4-byte copies)
K4_L = {7: 9, 128: 130, 256: 512, 512: 512}


@pytest.mark.parametrize("Kd", [7, 128, 256, 512])
@pytest.mark.parametrize("B", [1, 36, 64, 65, 150])
def test_pool_eval_counts_plans_exact_and_near_ties(cuda, B, Kd):
    """Every query-block size of the launch plan (B=1: 16, 36: 48, 64:
    64, 65: two of 48, 150: three of 64; K=512 shrinks them) on 700
    candidates: fewer tiles than CTAs, a partial last tile, a padded key
    tail, OOB owner/slot coordinates, the true key among the candidates.
    Integer data: equal to the plain version and over two runs; random
    data: within the near-tie rule."""
    rng = np.random.default_rng(B * 1000 + Kd)
    ref_args, dev_args = _k4_case(rng, cuda, B, Kd, K4_L[Kd], integer=True,
                                  oob=True)
    ref = K.pool_eval_counts(*ref_args)
    a, b = _k4_twice(dev_args)
    assert all(torch.equal(x, y) for x, y in zip(a, ref))
    assert all(torch.equal(x, y) for x, y in zip(b, ref))
    assert int(ref[0].sum()) > 0
    ref_args, dev_args = _k4_case(rng, cuda, B, Kd, K4_L[Kd], oob=True)
    g_o, g_s = K.pool_eval_counts(*dev_args)
    p_o, p_s, t_o, t_s = K.pool_eval_counts_plain(*ref_args, ties=True)
    assert ((g_o.cpu() - p_o).abs() <= t_o).all()
    assert ((g_s.cpu() - p_s).abs() <= t_s).all()


@pytest.mark.parametrize("Kd,L", [(7, 9), (128, 130), (256, 512)])
def test_pool_eval_counts_unaligned_pool(cuda, Kd, L):
    """Rows that are not 16-byte aligned: L % 4 != 0, and a pool whose
    base lies 4 bytes past an aligned address."""
    rng = np.random.default_rng(Kd + 7)
    ref_args, dev_args = _k4_case(rng, cuda, 36, Kd, L, integer=True)
    pool = dev_args[0]
    store = torch.zeros(pool.numel() + 1, device=cuda)
    shifted = store[1:].view(pool.shape)
    shifted.copy_(pool)
    assert shifted.data_ptr() % 16 != 0
    dev_args[0] = shifted
    ref = K.pool_eval_counts(*ref_args)
    for got in _k4_twice(dev_args):
        assert all(torch.equal(x, y) for x, y in zip(got, ref))


@pytest.mark.parametrize("Kd,E", [(32, 150_000), (256, 150_000),
                                  (1536, 2_000)])
def test_pool_eval_counts_many_tiles_and_streamed_queries(cuda, Kd, E):
    """Many tiles per CTA (the pointer pipeline wraps its 8 tile slots
    many times; K=32 is one chunk per tile) and a K too wide for a
    resident query block (queries stream through the ring): exact on
    integer data against the plain version on the card."""
    rng = np.random.default_rng(Kd)
    S, R = 1, E + 64
    _, dev_args = _k4_case(rng, cuda, 64, Kd, Kd, E=E, C=65_536,
                           integer=True, oob=True, S=S, R=R)
    plan = K._k4_plan(64, Kd, Kd, E, K._sms(dev_args[0].device))
    assert plan.resident == (Kd < 1536)
    ref = K.pool_eval_counts_plain(*dev_args)
    for got in _k4_twice(dev_args):
        assert all(torch.equal(x, y.cpu()) for x, y in zip(got, ref))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("B,Kd,L,E", [(64, 512, 1024, 9_000),
                                      (36, 512, 1024, 9_000),
                                      (64, 420, 512, 9_000),
                                      (64, 512, 1024, 150_000)])
def test_pool_eval_counts_pair_bitwise_the_block_form(cuda, B, Kd, L, E,
                                                      integer):
    """K4's pair form (two CTAs a candidate slice, one a side) against the
    one-CTA-a-block form's resident plan through the C entry (Bq=32 x 2,
    the wrapper's plan at K=512 before the pair form): counts bitwise
    equal at the eval cell's width and at K=420 (a partial last chunk),
    over 9,000 candidates (not a multiple of the 256-row tile) and
    150,000 (many tiles a cluster), with rows outside the pool, keys
    outside the table, and the true key among the candidates on each
    side; two runs identical; on integer data equal to the plain
    version too. The wrapper takes the pair form and counts it."""
    rng = np.random.default_rng(B * 7 + Kd + E)
    ref_args, dev_args = _k4_case(rng, cuda, B, Kd, L, E=E, C=4096,
                                  integer=integer, oob=True, S=2,
                                  R=E // 2 + 64)
    sms = K._sms(cuda)
    block = K._k4_block_plan(32, True, B, Kd, E, sms, True)
    pair = K._k4_plan(B, Kd, L, E, sms)
    assert pair.pair and not block.pair and block.grid[1] == 2
    if integer:   # the plain version indexes the tables by every key
        ref = K.pool_eval_counts(*ref_args)
        got = K._k4_launch(pair, *dev_args)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))
    keys = dev_args[3].view(-1)
    out = torch.from_numpy(rng.permutation(E)[:E // 50]).to(cuda)
    keys[out[::2]] = E + 64 * 2      # past the owner/slot tables
    keys[out[1::2]] = -5
    dev_args[9][::3] = dev_args[8][::3]  # some queries' keys equal a side
    want = [t.cpu() for t in K._k4_launch(block, *dev_args)]
    runs = [[t.cpu() for t in K._k4_launch(pair, *dev_args)]
            for _ in range(2)]
    for got in runs:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(want[0].sum()) > 0 and int(want[1].sum()) > 0
    K.reset_launches()
    got = K.pool_eval_counts(*dev_args)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert K.K4_FORMS == {"resident": 0, "streamed": 0, "pair": 1}
    assert K.LAUNCHES["pool_eval_counts"] == 1


def test_pool_eval_counts_pair_one_record_a_launch(cuda):
    """A launch of the pair form is one device record whose name holds
    `pool_eval_counts_kernel`, as the benchmark's trace check counts."""
    from torch.profiler import ProfilerActivity, profile
    _, dev_args = _k4_case(np.random.default_rng(3), cuda, 64, 512, 1024,
                           E=3_000, S=1, R=3_100)
    K.pool_eval_counts(*dev_args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            K.pool_eval_counts(*dev_args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "pool_eval_counts_kernel" in e.name]
    assert len(names) == 3 and all("pair" in n for n in names)


def _k4_mp_case(rng, dev, B, model, d, integer, E=900, nown=500,
                C=256, L=None):
    """K4 in its multi-process form (models/kge.py
    make_pool_eval_counts_mp): the rank owns `nown` of E entities (a
    padded key tile), the queries come as rows. Returns the entry and its
    arguments on the CPU and on `dev`."""
    from adapm_tpu_torch.models import kge
    kd = 2 * d if model == "complex" else d
    rd = kd if model == "complex" else d * d
    L = L or max(kd, 8) + 3
    S, R = 2, E
    flat = rng.permutation(S * R)[:E]
    owner = torch.from_numpy((flat // R).astype(np.int32))
    slot = torch.from_numpy((flat % R).astype(np.int32))
    if integer:
        pool = torch.from_numpy(rng.integers(-3, 4, (S, R, L))).float()
        se, oe = (torch.from_numpy(rng.integers(-3, 4, (B, kd))).float()
                  for _ in range(2))
        re_ = torch.from_numpy(rng.integers(-2, 3, (B, rd))).float()
    else:
        pool = torch.randn(S, R, L)
        se, re_, oe = torch.randn(B, kd), torch.randn(B, rd), \
            torch.randn(B, kd)
    owned = rng.permutation(E)[:nown].astype(np.int32)
    nch = -(-nown // C)
    pad = np.full(nch * C, owned[0], np.int32)
    pad[:nown] = owned
    keys = torch.from_numpy(pad.reshape(nch, C))
    okey = torch.from_numpy(rng.integers(0, E, B).astype(np.int32))
    skey = torch.from_numpy(rng.integers(0, E, B).astype(np.int32))
    if model == "complex":
        a, b, _, _ = kge._complex_queries(se, re_, oe)
        q_o = torch.cat([a, b], -1)
    else:
        q_o, _ = kge._rescal_queries(se, re_, oe)
    # true scores of real owned candidates: exact ties on integer data
    idx = torch.from_numpy(owned[np.arange(B) % nown]).long()
    rows = K._fill_gather_plain(pool, owner[idx], slot[idx])[:, :kd]
    true = (q_o * rows).sum(1)
    args = [pool, (owner, slot, None), keys, nown, se, re_, oe, skey, okey,
            true]

    def to(a):
        if isinstance(a, tuple):
            return tuple(to(x) for x in a)
        return a.to(dev) if torch.is_tensor(a) else a

    fn = kge.make_pool_eval_counts_mp(model, kd, rd, C)
    return fn, args, [to(a) for a in args]


def test_eval_spans_have_no_device_records(cuda):
    """The eval program's spans (obs/spans.py) under torch.profiler with
    CUDA activity: `adapm.eval.queries` and `adapm.eval.k4` once each on
    the host rows, no record of either on the device rows (only kernels
    and copies are there, K4 among them)."""
    from torch.profiler import ProfilerActivity, profile
    dev_t = torch.autograd.DeviceType.CUDA
    fn, _, dev_args = _k4_mp_case(np.random.default_rng(5), cuda, 36,
                                  "complex", 128, False)
    fn(*dev_args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*dev_args)
        torch.cuda.synchronize()
    evs = prof.events()
    ours = [e for e in evs if e.name.startswith("adapm.")]
    assert sorted(e.name for e in ours) == ["adapm.eval.k4",
                                            "adapm.eval.queries"]
    assert all(e.device_type != dev_t for e in ours)
    assert any(e.device_type == dev_t and "pool_eval_counts" in e.name
               for e in evs)


@pytest.mark.parametrize("model,d", [("complex", 128), ("complex", 3),
                                     ("rescal", 16), ("rescal", 7)])
@pytest.mark.parametrize("B", [1, 36, 64, 150])
def test_pool_eval_counts_mp_exact_and_near_ties(cuda, model, d, B):
    """K4 in its multi-process form, the queries formed from rows by the
    models' own helpers: equal to the plain version (on the CPU) on
    integer rows and over two runs; on random rows, ComplEx and RESCAL
    alike, within the near-tie rule of the plain version run on the card
    with the same queries."""
    rng = np.random.default_rng(B * 100 + d)
    fn, ref_args, dev_args = _k4_mp_case(rng, cuda, B, model, d, True)
    ref = fn(*ref_args)
    for _ in range(2):
        got = fn(*dev_args)
        torch.cuda.synchronize()
        assert all(torch.equal(x.cpu(), y) for x, y in zip(got, ref))
    assert int(ref[0].sum()) > 0
    fn, _, dev_args = _k4_mp_case(rng, cuda, B, model, d, False)
    g_o, g_s = fn(*dev_args)
    p_o, p_s, t_o, t_s = fn(*dev_args, ties=True)
    assert ((g_o - p_o).abs() <= t_o).all()
    assert ((g_s - p_s).abs() <= t_s).all()


def test_pool_eval_counts_mp_owns_nothing_and_raises(cuda):
    rng = np.random.default_rng(3)
    fn, _, dev_args = _k4_mp_case(rng, cuda, 8, "complex", 4, True)
    dev_args[3] = 0
    g_o, g_s = fn(*dev_args)
    assert not g_o.any() and not g_s.any()
    dev_args[3] = 5
    bad = list(dev_args)
    bad[2] = bad[2][:, :-1].contiguous()        # tiles narrower than C
    with pytest.raises(ValueError):
        fn(*bad)


def _k17_case(rng, dev, B, d, L, E=700, C=256, oob=False, S=2, R=400):
    """K17's arguments on the CPU and on `dev`: a pool of [re d | im d]
    rows (stride L), RotatE query rows from the model's own helpers, the
    true distances of each query's true key (a real candidate, so the
    true key's exclusion matters) and some side keys equal."""
    from adapm_tpu_torch.models import kge
    nk = E + 10
    flat = rng.permutation(S * R)[:nk]
    owner = torch.from_numpy((flat // R).astype(np.int32))
    slot = torch.from_numpy((flat % R).astype(np.int32))
    if oob:
        bad = rng.permutation(nk)[:nk // 10]
        owner[bad[::3]] = S
        slot[bad[1::3]] = -1
        slot[bad[2::3]] = OOB
    pool = torch.randn(S, R, L) * 0.1
    se, oe = torch.randn(B, 2 * d) * 0.1, torch.randn(B, 2 * d) * 0.1
    re_ = torch.randn(B, 2 * d) * np.pi
    q_o, q_s = kge._rotate_queries(se, re_, oe)
    nch = -(-E // C)
    pad = np.zeros(nch * C, np.int32)
    pad[:E] = rng.permutation(E)
    keys = torch.from_numpy(pad.reshape(nch, C))
    okey = torch.from_numpy(rng.integers(0, E, B).astype(np.int32))
    skey = torch.from_numpy(rng.integers(0, E, B).astype(np.int32))
    skey[::3] = okey[::3]
    rows = K._fill_gather_plain(pool, owner[okey.long()],
                                slot[okey.long()])[:, :2 * d]
    d_true = K._complex_distance(q_o, rows).diagonal().contiguous()
    args = [pool, owner, slot, keys, E, q_o.contiguous(), q_s.contiguous(),
            d_true, okey, skey]
    return args, [a.to(dev) if torch.is_tensor(a) else a for a in args]


def _within_near_ties(got, dev_args):
    """K17's counts against its plain version run on the card with the
    same inputs: each count within the plain version's near-tie count."""
    p_o, p_s, t_o, t_s = K.pool_eval_dist_plain(*dev_args, ties=True)
    g_o, g_s = got
    assert ((g_o - p_o).abs() <= t_o).all()
    assert ((g_s - p_s).abs() <= t_s).all()
    assert int(p_o.sum()) > 0 and int(p_s.sum()) > 0


@pytest.mark.parametrize("B,d,L,E", [(64, 256, 1024, 9_000),
                                     (36, 256, 512, 700),
                                     (1, 8, 16, 700), (150, 16, 40, 700),
                                     (65, 300, 600, 700), (5, 130, 262, 700),
                                     (64, 7, 15, 700),
                                     (64, 256, 1024, 150_000)])
def test_pool_eval_dist_within_near_ties_and_repeatable(cuda, B, d, L, E):
    """K17 against its plain version: every query block of the plan (B=1:
    8, 36 and 64: 64, 65 at d=300: three blocks of 32, 150: three of
    64),
    16-byte and 4-byte copies (d or L not a multiple of 4), d not a
    multiple of the 16-component stage, a partial last tile, a padded key
    tail, OOB owner/slot coordinates, the true key among the candidates,
    many tiles a CTA at 150,000 candidates: within the near-tie rule, and
    two runs equal."""
    rng = np.random.default_rng(B * 1000 + d + E)
    _, dev_args = _k17_case(rng, cuda, B, d, L, E=E, C=4096, oob=True,
                            R=E // 2 + 64)
    plan = K._k17_plan(B, d, L, E, K._sms(cuda))
    assert plan.vec == (d % 4 == 0 and L % 4 == 0)
    runs = [K.pool_eval_dist(*dev_args) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    _within_near_ties(runs[0], dev_args)


def test_pool_eval_dist_unaligned_pool(cuda):
    """Rows that start 4 bytes past a 16-byte boundary take the 4-byte
    copies and count as the aligned pool does."""
    rng = np.random.default_rng(17)
    _, dev_args = _k17_case(rng, cuda, 36, 64, 128)
    want = K.pool_eval_dist(*dev_args)
    pool = dev_args[0]
    store = torch.zeros(pool.numel() + 1, device=cuda)
    shifted = store[1:].view(pool.shape)
    shifted.copy_(pool)
    assert shifted.data_ptr() % 16 != 0
    dev_args[0] = shifted
    got = K.pool_eval_dist(*dev_args)
    _within_near_ties(got, dev_args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_pool_eval_dist_one_record_a_launch(cuda):
    """A K17 launch is one device record whose name holds
    `pool_eval_dist_kernel` and not K4's `pool_eval_counts_kernel`, and
    LAUNCHES counts it."""
    from torch.profiler import ProfilerActivity, profile
    _, dev_args = _k17_case(np.random.default_rng(3), cuda, 64, 256, 1024,
                            E=3_000, S=1, R=3_100)
    K.pool_eval_dist(*dev_args)
    torch.cuda.synchronize()
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            K.pool_eval_dist(*dev_args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "pool_eval" in e.name]
    assert len(names) == 3 and all("pool_eval_dist_kernel" in n
                                   and "pool_eval_counts_kernel" not in n
                                   for n in names)
    assert K.LAUNCHES["pool_eval_dist"] == 3
    assert K.LAUNCHES["pool_eval_counts"] == 0


@pytest.mark.parametrize("mp", [False, True], ids=["one", "mp"])
def test_rotate_eval_programs_take_k17(cuda, mp):
    """RotatE's eval programs (models/kge.py make_pool_eval_counts and its
    multi-process form) on the card: one K17 launch a call and no K4, the
    spans eval.rows (one process), eval.queries and eval.k17 on the host
    rows, counts within the near-tie rule of the program's plain form."""
    from torch.profiler import ProfilerActivity, profile
    from adapm_tpu_torch.models import kge
    rng = np.random.default_rng(23 + mp)
    d, E, C, B = 32, 2_000, 512, 36
    S, R = 2, 1_200
    nk = E + 20
    flat = rng.permutation(S * R)[:nk]
    owner = torch.from_numpy((flat // R).astype(np.int32)).to(cuda)
    slot = torch.from_numpy((flat % R).astype(np.int32)).to(cuda)
    pool = (torch.randn(S, R, 4 * d) * 0.1).to(cuda)
    rel = slice(E, nk)         # relation rows: phases in the first d
    pool[owner[rel].long(), slot[rel].long(), :d] = \
        torch.randn(nk - E, d, device=cuda) * np.pi
    nch = -(-E // C)
    pad = np.zeros(nch * C, np.int32)
    pad[:E] = rng.permutation(E)
    keys = torch.from_numpy(pad.reshape(nch, C)).to(cuda)
    tables = (owner, slot, None)
    s, o = (torch.from_numpy(rng.integers(0, E, B).astype(np.int32))
            .to(cuda) for _ in range(2))
    r = torch.from_numpy(rng.integers(E, nk, B).astype(np.int32)).to(cuda)
    if mp:
        fn = kge.make_pool_eval_counts_mp("rotate", 2 * d, 2 * d, C)
        rows = [K._fill_gather_plain(pool, owner[k.long()],
                                     slot[k.long()]) for k in (s, r, o)]
        true = kge.make_true_score("rotate")(*(x[:, :2 * d] for x in rows))
        args = (pool, tables, keys, E, *rows, s, o, true)
    else:
        fn = kge.make_pool_eval_counts("rotate", 2 * d, 2 * d, C,
                                       shared_pool=True)
        args = (pool, tables, keys, E, s, r, o)
    fn(*args)
    torch.cuda.synchronize()
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = fn(*args)
        torch.cuda.synchronize()
    assert K.LAUNCHES["pool_eval_dist"] == 1
    assert K.LAUNCHES["pool_eval_counts"] == 0
    spans = sorted(e.name for e in prof.events()
                   if e.name.startswith("adapm."))
    want = ["adapm.eval.k17", "adapm.eval.queries"]
    assert spans == (want if mp else want + ["adapm.eval.rows"])
    plain = fn(*args, ties=True)
    if not mp:
        plain = plain[:2] + plain[3:]
    p_o, p_s, t_o, t_s = plain
    assert ((got[0] - p_o).abs() <= t_o).all()
    assert ((got[1] - p_s).abs() <= t_s).all()
    assert int(p_o.sum()) > 0


def test_loopback_cluster_on_the_card(cuda):
    """Two loopback nodes with their pools on the card: pulls, pushes and
    sets across nodes, an exclusive intent (relocation) and a competing
    one (replication), integer-valued, bitwise the NumPy shadow after
    the quiesce protocol, and K4's multi-process form launched by the
    candidate-partitioned eval's counts on each node."""
    from adapm_tpu_torch.base import CLOCK_MAX
    from adapm_tpu_torch.config import SystemOptions
    from adapm_tpu_torch.net import LoopbackCluster
    cl = LoopbackCluster(2, num_keys=96, value_lengths=8, device=cuda,
                         opts_factory=lambda r: SystemOptions(
                             sync_max_per_sec=0, prefetch=False))
    try:
        keys = np.arange(96, dtype=np.int64)
        base = np.arange(96 * 8, dtype=np.float32).reshape(96, 8)

        def scenario(rank, srv):
            w = srv.make_worker(0)
            if rank == 0:
                w.wait(w.set(keys, base))
            srv.barrier()
            if rank == 1:
                w.intent(keys[:48], 0, CLOCK_MAX)
                srv.wait_sync()
            srv.barrier()
            if rank == 0:
                w.intent(keys[:24], 0, CLOCK_MAX)
                srv.wait_sync()
            srv.barrier()
            w.wait(w.push(keys, np.full((96, 8), rank + 1.0, np.float32)))
            srv.wait_sync()
            srv.barrier()
            srv.wait_sync()
            srv.barrier()
            return w.pull_sync(keys), srv.read_main(keys).reshape(96, 8)

        outs = cl.run(scenario)
        for pulled, main in outs:
            assert np.array_equal(pulled, base + 3)
            assert np.array_equal(main, base + 3)
        st = [s.glob.stats for s in cl.servers]
        assert sum(x["relocations_in"] for x in st) > 0
        assert sum(x["replicas_granted"] for x in st) > 0
    finally:
        cl.shutdown()


def test_wrappers_raise_on_bad_cuda_input(cuda):
    pool = torch.zeros(2, 4, 8, device=cuda)
    idx = torch.zeros(3, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        K.routed_gather(pool, None, None, idx, idx)       # int64 coords
    with pytest.raises(ValueError):
        K.ordered_scatter_add(pool.double(), idx.int(), idx.int(),
                              torch.zeros(3, 8, device=cuda))
    q = torch.zeros(2, 8, device=cuda)
    with pytest.raises(ValueError):                       # int64 keys
        K.pool_eval_counts(pool, idx.int(), idx.int(), idx.view(1, 3), 3,
                           q, q, q[:, 0].contiguous(), idx.int()[:2],
                           idx.int()[:2])
    with pytest.raises(ValueError):                       # int64 coords
        K.write_main_rows(pool, idx, idx, "fp32",
                          torch.zeros(3, 8, device=cuda))


def test_small_fused_steps_cuda_match_cpu(cuda):
    import adapm_tpu_torch as at
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    roles = ("s", "r", "o", "neg")
    pools = []
    for dev in (cuda, "cpu"):
        rng = np.random.default_rng(0)
        srv = at.setup(300, 32, num_shards=2, num_workers=2, device=dev,
                       opts=at.SystemOptions(sync_max_per_sec=0))
        w0, w1 = srv.make_worker(0), srv.make_worker(1)
        vals = rng.normal(size=(300, 32)).astype(np.float32) * 0.1
        vals[:, 16:] = 1e-6                    # AdaGrad accumulators
        w0.wait(w0.set(np.arange(300), vals))
        w1.intent(np.arange(0, 300, 2), 0, 100)
        srv.wait_sync()
        w0.intent(np.arange(0, 300, 2), 0, 100)
        srv.wait_sync()
        runner = DeviceRoutedRunner(
            srv, make_kge_loss("complex"),
            role_class=dict.fromkeys(roles, 0),
            role_dim=dict.fromkeys(roles, 16))
        for _ in range(4):
            runner({"s": rng.integers(0, 280, 32),
                    "r": rng.integers(280, 300, 32),
                    "o": rng.integers(0, 280, 32),
                    "neg": rng.integers(0, 280, (32, 3))}, None, 0.1)
            srv.sync.run_round(all_channels=True)
        assert runner._shard_has_replicas()
        pools.append([t.cpu() for t in (srv.stores[0].main,
                                        srv.stores[0].cache,
                                        srv.stores[0].delta)])
    for a, b in zip(*pools):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _k5_rows(rng, B, N, d, dev, stride=None):
    """s, r, o [B, 4d] and neg [B, N, 4d] as row views of one buffer (as
    K1 writes the step's rows), rows `stride` floats apart; each
    triple's first negative repeats its subject row."""
    L = 4 * d
    W = stride or L
    n = 3 * B + B * N
    buf = rng.normal(size=(n, W)).astype(np.float32) * 0.3
    buf[:, 2 * d:L] = rng.random((n, 2 * d)).astype(np.float32) * 0.01 \
        + 1e-6
    buf[3 * B::N] = buf[:B]
    t = torch.from_numpy(buf).to(dev)[:, :L]
    return t[:B], t[B:2 * B], t[2 * B:3 * B], t[3 * B:].reshape(B, N, L)


def _k5_run(rows, lr_eps, T, l2, frozen=()):
    s = rows[0]
    B, L = s.shape
    N = rows[3].shape[1]
    n = {"s": B, "r": B, "o": B, "neg": B * N}
    out = {k: torch.full((n[k], L), float("nan"), device=s.device)
           for k in n if k not in frozen}
    grad = {k: torch.empty(n[k], L // 2, device=s.device) for k in n}
    per = K.complex_step(*rows, lr_eps, T, l2, out=out, grad_out=grad)
    return per, out, grad


@pytest.mark.parametrize("B,N,d,stride,T,l2", [
    (64, 8, 16, None, 0.0, 0.0), (64, 8, 16, None, 1.0, 0.1),
    (33, 5, 7, None, 1.0, 0.0), (40, 3, 8, 35, 0.0, 0.1),
    (17, 40, 128, 520, 1.0, 0.1)])
def test_complex_step_matches_plain(cuda, B, N, d, stride, T, l2):
    rng = np.random.default_rng(B + N + d)
    rows = _k5_rows(rng, B, N, d, cuda, stride)
    lr_eps = torch.tensor([0.1, 1e-10], device=cuda)
    pc, oc, gc = _k5_run([x.cpu() for x in rows], lr_eps.cpu(), T, l2)
    runs = [_k5_run(rows, lr_eps, T, l2) for _ in range(2)]
    _, of, _ = _k5_run(rows, lr_eps, T, l2, frozen=("r", "neg"))
    torch.cuda.synchronize()
    per, out, grad = runs[0]
    torch.testing.assert_close(per.cpu(), pc, rtol=1e-5, atol=1e-6)
    for k in oc:
        torch.testing.assert_close(out[k].cpu(), oc[k], rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(grad[k].cpu(), gc[k], rtol=1e-5,
                                   atol=1e-6)
        # deterministic, and the epilogue is K2's arithmetic
        assert torch.equal(_bits(out[k]), _bits(runs[1][1][k])), k
        flat = {"s": rows[0], "r": rows[1], "o": rows[2],
                "neg": rows[3].reshape(-1, 4 * d)}[k]
        k2 = K.adagrad_update(grad[k], flat[:, 2 * d:], 0.1, 1e-10)
        assert torch.equal(_bits(k2), _bits(out[k])), k
    assert torch.equal(_bits(per), _bits(runs[1][0]))
    assert set(of) == {"s", "o"}
    for k in of:                       # freezing a role changes no other
        assert torch.equal(_bits(of[k]), _bits(out[k])), k


def test_complex_step_rejects_what_it_cannot_run(cuda):
    rows = _k5_rows(np.random.default_rng(0), 4, 2, 8, cuda)
    lr_eps = torch.tensor([0.1, 1e-10], device=cuda)
    with pytest.raises(ValueError, match="lr_eps"):
        K.complex_step(*rows, lr_eps.double())
    with pytest.raises(ValueError, match="output"):
        K.complex_step(*rows, lr_eps, out={"s": torch.empty(
            4, 31, device=cuda)})
    big = _k5_rows(np.random.default_rng(0), 2, 120, 128, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        K.complex_step(*big, lr_eps)


def _k16_rows(rng, B, N, d, dev, stride=None):
    """s, o [B, 2d] and neg [B, N, 2d] as row views of one entity buffer,
    r [B, 2d^2] of a relation buffer (as K1 writes a class's rows), the
    entity rows `stride` floats apart; each triple's first negative
    repeats its subject row, triples 0 and 1 share a relation row, and
    some entries are -0.0."""
    L, W = 2 * d, stride or 2 * d
    n = 2 * B + B * N
    ent = rng.normal(size=(n, W)).astype(np.float32) * 0.3
    ent[:, d:L] = rng.random((n, d)).astype(np.float32) * 0.01 + 1e-6
    ent[2 * B::N] = ent[:B]
    ent[:, 0] = -0.0
    rel = rng.normal(size=(B, 2 * d * d)).astype(np.float32) * 0.3
    rel[:, d * d:] = rng.random((B, d * d)).astype(np.float32) * 0.01 \
        + 1e-6
    rel[1] = rel[0]
    e = torch.from_numpy(ent).to(dev)[:, :L]
    return (e[:B], torch.from_numpy(rel).to(dev), e[B:2 * B],
            e[2 * B:].reshape(B, N, L))


def _k16_run(rows, lr_eps, T, l2, frozen=()):
    s = rows[0]
    B, L = s.shape
    N, d = rows[3].shape[1], L // 2
    n = {"s": B, "r": B, "o": B, "neg": B * N}
    wd = {"s": d, "r": d * d, "o": d, "neg": d}
    out = {k: torch.full((n[k], 2 * wd[k]), float("nan"), device=s.device)
           for k in n if k not in frozen}
    grad = {k: torch.empty(n[k], wd[k], device=s.device) for k in n}
    per = K.rescal_step(*rows, lr_eps, T, l2, out=out, grad_out=grad)
    return per, out, grad


@pytest.mark.parametrize("B,N,d,stride,T,l2", [
    (64, 8, 8, None, 0.0, 0.0), (64, 8, 8, None, 1.0, 0.0),
    (64, 8, 8, None, 0.0, 0.1), (64, 8, 8, None, 1.0, 0.1),
    (33, 5, 7, None, 1.0, 0.1), (40, 1, 8, None, 0.0, 0.1),
    (40, 3, 8, 18, 1.0, 0.0), (17, 40, 128, 260, 1.0, 0.1)])
def test_rescal_step_matches_plain(cuda, B, N, d, stride, T, l2):
    rng = np.random.default_rng(B + N + d)
    rows = _k16_rows(rng, B, N, d, cuda, stride)
    lr_eps = torch.tensor([0.1, 1e-10], device=cuda)
    pc, oc, gc = _k16_run([x.cpu() for x in rows], lr_eps.cpu(), T, l2)
    runs = [_k16_run(rows, lr_eps, T, l2) for _ in range(2)]
    _, of, _ = _k16_run(rows, lr_eps, T, l2, frozen=("r", "neg"))
    torch.cuda.synchronize()
    per, out, grad = runs[0]
    torch.testing.assert_close(per.cpu(), pc, rtol=1e-5, atol=1e-6)
    for k in oc:
        torch.testing.assert_close(out[k].cpu(), oc[k], rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(grad[k].cpu(), gc[k], rtol=1e-5,
                                   atol=1e-6)
        # deterministic, and the epilogue is K2's arithmetic
        assert torch.equal(_bits(out[k]), _bits(runs[1][1][k])), k
        flat = {"s": rows[0], "r": rows[1], "o": rows[2],
                "neg": rows[3].reshape(-1, 2 * d)}[k]
        D = flat.shape[1] // 2
        k2 = K.adagrad_update(grad[k], flat[:, D:], 0.1, 1e-10)
        assert torch.equal(_bits(k2), _bits(out[k])), k
    assert torch.equal(_bits(per), _bits(runs[1][0]))
    assert set(of) == {"s", "o"}
    for k in of:                       # freezing a role changes no other
        assert torch.equal(_bits(of[k]), _bits(out[k])), k


def test_rescal_step_rejects_what_it_cannot_run(cuda):
    rows = _k16_rows(np.random.default_rng(0), 4, 2, 8, cuda)
    lr_eps = torch.tensor([0.1, 1e-10], device=cuda)
    with pytest.raises(ValueError, match="lr_eps"):
        K.rescal_step(*rows, lr_eps.double())
    with pytest.raises(ValueError, match="output"):
        K.rescal_step(*rows, lr_eps, out={"r": torch.empty(
            4, 16, device=cuda)})
    with pytest.raises(ValueError, match="r \\[B, 2d\\^2\\]"):
        K.rescal_step(rows[0], rows[0], rows[2], rows[3], lr_eps)
    big = _k16_rows(np.random.default_rng(0), 2, 1, 240, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        K.rescal_step(*big, lr_eps)


def test_rescal_graph_windows_match_sequential_bitwise(cuda):
    """RESCAL's two classes (entity rows of 2d, relation rows of 2d^2)
    through the device-routed runner: two windows of 4 steps against 8
    sequential steps, device-drawn negatives, bitwise losses and pools;
    every step launches K16 and no K2."""
    import adapm_tpu_torch as at
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    E, R, d, B, N = 300, 12, 8, 64, 4
    vl = np.array([2 * d] * E + [2 * d * d] * R)
    res = []
    for mode in ("sequential", "scan"):
        rng = np.random.default_rng(0)
        srv = at.setup(E + R, vl, device=cuda,
                       opts=at.SystemOptions(sync_max_per_sec=0))
        w = srv.make_worker(0)
        for keys, D in ((np.arange(E), d), (np.arange(E, E + R), d * d)):
            vals = rng.normal(size=(len(keys), 2 * D)).astype(np.float32)
            vals *= 0.1
            vals[:, D:] = 1e-6
            w.wait(w.set(keys, vals))
        ec, rc = int(srv.ab.key_class[0]), int(srv.ab.key_class[E])
        run = DeviceRoutedRunner(
            srv, make_kge_loss("rescal", 1.0, 0.01),
            role_class={"s": ec, "r": rc, "o": ec, "neg": ec},
            role_dim={"s": d, "r": d * d, "o": d, "neg": d},
            neg_role="neg", neg_shape=(B, N), neg_population=np.arange(E),
            seed=3)
        batches = [{"s": rng.integers(0, E, B), "r": rng.integers(E, E + R, B),
                    "o": rng.integers(0, E, B)} for _ in range(8)]
        K.reset_launches()
        if mode == "sequential":
            losses = torch.stack([run(b, None, 0.1) for b in batches])
        else:
            losses = torch.cat([run.run_scan(batches[i:i + 4], None, 0.1)
                                for i in (0, 4)])
        torch.cuda.synchronize()
        res.append((losses.cpu(), [st.main.cpu() for st in srv.stores],
                    {k: K.LAUNCHES[k] + K.REPLAYED[k] for k in K.LAUNCHES}))
        srv.shutdown()
    (la, pa, ka), (lb, pb, kb) = res
    assert torch.equal(_bits(la), _bits(lb))
    for a, b in zip(pa, pb):
        assert torch.equal(_bits(a), _bits(b))
    assert ka == kb and ka["rescal_step"] == 8 and ka["adagrad_update"] == 0


def _aux_loss(embs, aux):
    pos = (embs["s"] * embs["o"]).sum(-1)
    neg = (embs["s"][:, None, :] * embs["neg"]).sum(-1)
    return (aux * torch.nn.functional.softplus(-pos)
            + torch.nn.functional.softplus(neg).sum(-1)).mean()


@pytest.mark.parametrize("loss", ["complex", "aux"])
def test_run_scan_graph_matches_sequential_bitwise(cuda, loss):
    """Four windows of 4 steps (device-drawn negatives; the aux loss
    takes a per-step aux and K2) against 16 sequential steps: equal
    losses, pools and locality, and the sequential steps' launches equal
    the windows' eager and replayed ones. The lr changes at the second
    window (K5 and K2 read it from the device: no new capture) and the
    owner table is replaced by a new tensor before the fourth (a capture
    holds its address: captured again, in place of the old graph; a
    refresh copies into the same tensors, as
    test_graph_captured_once_with_pipeline_relocating holds)."""
    import adapm_tpu_torch as at
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    roles = ("s", "r", "o", "neg") if loss == "complex" else \
        ("s", "o", "neg")
    res = []
    for mode in ("sequential", "scan"):
        rng = np.random.default_rng(0)
        srv = at.setup(400, 64, device=cuda,
                       opts=at.SystemOptions(sync_max_per_sec=0))
        w = srv.make_worker(0)
        vals = rng.normal(size=(400, 64)).astype(np.float32) * 0.1
        vals[:, 32:] = 1e-6
        w.wait(w.set(np.arange(400), vals))
        fn = make_kge_loss("complex", 1.0, 0.01) if loss == "complex" \
            else _aux_loss
        run = DeviceRoutedRunner(
            srv, fn, role_class=dict.fromkeys(roles, 0),
            role_dim=dict.fromkeys(roles, 32), neg_role="neg",
            neg_shape=(64, 4), neg_population=np.arange(380), seed=3)
        batches = [{r: rng.integers(380, 400, 64) if r == "r"
                    else rng.integers(0, 380, 64) for r in roles
                    if r != "neg"} for _ in range(16)]
        auxes = [torch.full((64,), 0.5 + i / 8, device=cuda)
                 for i in range(16)]
        lrs = [0.1] * 4 + [0.05] * 12
        K.reset_launches()
        losses = []
        for i in range(0, 16, 4):
            if i == 12:
                run.router.owner = run.router.owner.clone()  # new address
            if mode == "sequential":
                losses += [run(batches[j], auxes[j] if loss == "aux"
                               else None, lrs[j]) for j in range(i, i + 4)]
            else:
                losses.append(run.run_scan(
                    batches[i:i + 4], auxes[i:i + 4] if loss == "aux"
                    else None, lrs[i]))
        torch.cuda.synchronize()
        res.append((torch.cat([x.reshape(-1) for x in losses]).cpu(),
                    srv.stores[0].main.cpu(), run.locality_counts(),
                    {k: K.LAUNCHES[k] + K.REPLAYED[k] for k in K.LAUNCHES},
                    dict(K.REPLAYED), run.graph_captures, len(run._graphs)))
        srv.shutdown()
    (la, pa, ca, ka, ra, _, _), (lb, pb, cb, kb, rb, captures, graphs) = res
    assert torch.equal(_bits(la), _bits(lb))
    assert torch.equal(_bits(pa), _bits(pb))
    assert ca == cb and ka == kb, (ca, cb, ka, kb)
    assert captures == 2 and graphs == 1
    assert ka["complex_step"] == (16 if loss == "complex" else 0)
    # the first window runs eagerly, windows 2 and 3 replay, the fourth
    # captures again and runs eagerly
    assert not any(ra.values())
    assert rb["routed_gather"] == 8, rb


def _k67_rows(rng, n, d, dev, stride=None, dup_every=None):
    """n rows [emb d | acc d] as row views of one buffer (as K1 writes
    the step's rows), `stride` floats apart."""
    W = stride or 2 * d
    buf = rng.normal(size=(n, W)).astype(np.float32) * 0.4
    buf[:, d:2 * d] = rng.random((n, d)).astype(np.float32) * 0.01 + 1e-6
    if dup_every:
        buf[::dup_every] = buf[0]
    return torch.from_numpy(buf).to(dev)[:, :2 * d]


def _k67_check(run, plain, outs, rows, d):
    """Kernel against plain within rtol 1e-5 / atol 1e-6, bitwise over
    two runs, and K2 on the kernel's gradients bitwise its update rows."""
    per_p, out_p, grad_p = plain
    (per, out, grad), (per2, out2, _) = run
    torch.cuda.synchronize()
    torch.testing.assert_close(per.cpu(), per_p, rtol=1e-5, atol=1e-6)
    assert torch.equal(_bits(per), _bits(per2))
    for k in outs:
        torch.testing.assert_close(out[k].cpu(), out_p[k], rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(grad[k].cpu(), grad_p[k], rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(_bits(out[k]), _bits(out2[k])), k
        k2 = K.adagrad_update(grad[k], rows[k].reshape(-1, 2 * d)[:, d:],
                              0.1, 1e-10)
        assert torch.equal(_bits(k2), _bits(out[k])), k


@pytest.mark.parametrize("B,N,d,stride", [
    (64, 5, 128, None), (33, 3, 8, None), (40, 4, 7, None),
    (17, 6, 12, 30), (9, 2, 300, None)])
def test_sgns_step_matches_plain(cuda, B, N, d, stride):
    rng = np.random.default_rng(B + N + d)
    flat = _k67_rows(rng, 2 * B + B * N, d, cuda, stride, dup_every=7)
    rows = {"center": flat[:B], "ctx": flat[B:2 * B],
            "neg": flat[2 * B:].reshape(B, N, 2 * d)}
    lr_eps = torch.tensor([0.1, 1e-10], device=cuda)
    n = {"center": B, "ctx": B, "neg": B * N}

    def go(rs, dev, frozen=()):
        out = {k: torch.full((n[k], 2 * d), float("nan"), device=dev)
               for k in n if k not in frozen}
        grad = {k: torch.empty(n[k], d, device=dev) for k in n}
        per = K.sgns_step(rs["center"], rs["ctx"], rs["neg"],
                          lr_eps.to(dev), out=out, grad_out=grad)
        return per, out, grad
    plain = go({k: v.cpu() for k, v in rows.items()}, "cpu")
    _k67_check([go(rows, cuda), go(rows, cuda)], plain, n, rows, d)
    per_f, out_f, _ = go(rows, cuda, frozen=("neg",))
    ref = go(rows, cuda)
    assert set(out_f) == {"center", "ctx"}
    for k in out_f:                   # freezing a role changes no other
        assert torch.equal(_bits(out_f[k]), _bits(ref[1][k])), k


@pytest.mark.parametrize("B,d,stride,l2", [
    (8192, 128, None, 0.0), (8192, 128, None, 0.01), (37, 5, None, 0.01),
    (50, 16, 40, 0.0), (20, 260, None, 0.01)])
def test_mf_step_matches_plain(cuda, B, d, stride, l2):
    rng = np.random.default_rng(B + d)
    flat = _k67_rows(rng, 2 * B, d, cuda, stride, dup_every=5)
    rows = {"w": flat[:B], "h": flat[B:]}
    x = torch.from_numpy(rng.normal(size=B).astype(np.float32)).to(cuda)
    lr_eps = torch.tensor([0.1, 1e-10], device=cuda)

    def go(rs, xx, dev):
        out = {k: torch.full((B, 2 * d), float("nan"), device=dev)
               for k in rs}
        grad = {k: torch.empty(B, d, device=dev) for k in rs}
        per = K.mf_step(rs["w"], rs["h"], xx, lr_eps.to(dev), l2, out=out,
                        grad_out=grad)
        return per, out, grad
    plain = go({k: v.cpu() for k, v in rows.items()}, x.cpu(), "cpu")
    _k67_check([go(rows, x, cuda), go(rows, x, cuda)], plain, rows, rows, d)


def test_k6_k7_reject_what_they_cannot_run(cuda):
    lr_eps = torch.tensor([0.1, 1e-10], device=cuda)
    r = torch.zeros(4, 16, device=cuda)
    with pytest.raises(ValueError, match="lr_eps"):
        K.sgns_step(r, r, r.reshape(4, 1, 16), lr_eps.double())
    with pytest.raises(ValueError, match="ratings"):
        K.mf_step(r, r, torch.zeros(4, device=cuda, dtype=torch.float64),
                  lr_eps)
    with pytest.raises(ValueError, match="shared memory"):
        K.sgns_step(r, r, torch.zeros(4, 2000, 16, device=cuda), lr_eps)


@pytest.mark.parametrize("loss", ["mf", "sgns"])
def test_k6_k7_graph_windows_match_sequential_bitwise(cuda, loss):
    """MF with its ratings as per-step aux (numpy arrays, as the app
    passes them) and SGNS with alias-drawn negatives: four windows of 4
    against 16 sequential steps, the lr changing after the first window
    (the bold driver: no new capture). Equal losses, pools and launches;
    one capture; K6 or K7 once per step and no K2."""
    import adapm_tpu_torch as at
    from adapm_tpu_torch.models import sgns
    from adapm_tpu_torch.models.mf import make_mf_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    res = []
    for mode in ("sequential", "scan"):
        rng = np.random.default_rng(0)
        srv = at.setup(400, 32, device=cuda,
                       opts=at.SystemOptions(sync_max_per_sec=0))
        w = srv.make_worker(0)
        vals = rng.normal(size=(400, 32)).astype(np.float32) * 0.1
        vals[:, 16:] = 1e-6
        w.wait(w.set(np.arange(400), vals))
        if loss == "mf":
            rc = {"w": 0, "h": 0}
            run = DeviceRoutedRunner(srv, make_mf_loss(0.01), rc,
                                     dict.fromkeys(rc, 16))
            batches = [{"w": rng.integers(0, 250, 64),
                        "h": rng.integers(250, 400, 64)} for _ in range(16)]
            auxes = [rng.normal(size=64).astype(np.float32)
                     for _ in range(16)]
        else:
            rc = {"center": 0, "ctx": 0, "neg": 0}
            run = DeviceRoutedRunner(
                srv, sgns.sgns_loss, rc, dict.fromkeys(rc, 16),
                neg_role="neg", neg_shape=(64, 5),
                neg_population=sgns.syn1_key(np.arange(200)),
                neg_alias=sgns.build_alias_table(
                    1.0 / (np.arange(200) + 10.0)), seed=3)
            batches = [{"center": 2 * rng.integers(0, 200, 64),
                        "ctx": 2 * rng.integers(0, 200, 64) + 1}
                       for _ in range(16)]
            auxes = [None] * 16
        lrs = [0.1] * 4 + [0.05] * 12
        K.reset_launches()
        losses = []
        for i in range(0, 16, 4):
            if mode == "sequential":
                losses += [run(batches[j], auxes[j], lrs[j])
                           for j in range(i, i + 4)]
            else:
                losses.append(run.run_scan(
                    batches[i:i + 4], None if loss == "sgns"
                    else auxes[i:i + 4], lrs[i]))
        torch.cuda.synchronize()
        res.append((torch.cat([x.reshape(-1) for x in losses]).cpu(),
                    srv.stores[0].main.cpu(), run.locality_counts(),
                    {k: K.LAUNCHES[k] + K.REPLAYED[k] for k in K.LAUNCHES},
                    run.graph_captures))
        srv.shutdown()
    (la, pa, ca, ka, _), (lb, pb, cb, kb, captures) = res
    assert torch.equal(_bits(la), _bits(lb))
    assert torch.equal(_bits(pa), _bits(pb))
    assert ca == cb and ka == kb, (ca, cb, ka, kb)
    assert captures == 1
    kern = "mf_step" if loss == "mf" else "sgns_step"
    assert ka[kern] == 16 and ka["adagrad_update"] == 0, ka


@pytest.mark.parametrize("L", [256, 7, 600])
@pytest.mark.parametrize("pooling", ["sum", "mean"])
def test_gather_pool_bitwise_both_forms_sorted_and_not(cuda, L, pooling):
    """K8 against its plain version, bitwise: every member owner-served
    and a quarter replica-served, sorted seg (the serving path's, with
    OOB padding and empty bags) and an unsorted one (ordered by K3's
    ordering pass first), random starting values with -0.0 among them
    (an empty bag keeps its own under sum), long bags; deterministic
    over two runs."""
    rng = np.random.default_rng(L)
    S, R, C, n, nb = 2, 40, 20, 3000, 300
    main, cache, delta = (torch.randn(S, k, L) for k in (R, C, C))
    main[0, :3] = -0.0
    o = _coords(rng, n, S, R)
    c = _coords(rng, n, S, C)
    use_c = torch.from_numpy(rng.random(n) < 0.25)
    sizes = rng.integers(0, 30, nb)
    sizes[5] = 700                                # a long bag
    seg = np.repeat(np.arange(nb), sizes)[:n - 40].astype(np.int32)
    seg = np.concatenate([seg, np.full(n - len(seg), OOB, np.int32)])
    out0 = torch.randn(nb + 8, L)
    out0[:4] = -0.0
    perm = torch.from_numpy(rng.permutation(n))
    for args in ((main, cache, delta) + o + c + (torch.zeros_like(use_c),),
                 (main, cache, delta) + o + c + (use_c,)):
        for order in ("sorted", "unsorted"):
            s = torch.from_numpy(seg)
            a = list(args)
            if order == "unsorted":
                a = [x if x.dim() == 3 else x[perm] for x in a]
                s = s[perm]
            ref = K.gather_pool(*a, s, out0.clone(), pooling)
            got = [K.gather_pool(*[x.to(cuda) for x in a], s.to(cuda),
                                 out0.clone().to(cuda), pooling,
                                 sorted_seg=order == "sorted")
                   for _ in range(2)]
            assert torch.equal(_bits(got[0]), _bits(ref)), order
            assert torch.equal(_bits(got[1]), _bits(got[0]))


def test_gather_pool_through_the_port_and_the_store(cuda):
    """TorchDevicePort.gather_pool and ShardedStore.gather_pool on the
    card against the same calls on the CPU, bitwise; the store path
    launches K8 once per call with seg checked sorted on the host."""
    from adapm_tpu_torch.core.store import ShardedStore
    from adapm_tpu_torch.device.context import make_context
    rng = np.random.default_rng(1)
    L, nk = 256, 500
    stores = [ShardedStore(nk, L, make_context(2, d)) for d in ("cpu",
                                                                cuda)]
    sh = (np.arange(nk) % 2).astype(np.int32)
    sl = (np.arange(nk) // 2).astype(np.int32)
    vals = rng.normal(size=(nk, L)).astype(np.float32)
    z = np.zeros(nk, np.int32)
    m = 4000
    pick = rng.integers(0, nk, m)
    seg = np.sort(rng.integers(0, 700, m)).astype(np.int32)
    args = (sh[pick], sl[pick], np.zeros(m, np.int32),
            np.full(m, OOB, np.int32), np.zeros(m, bool), seg, 700)
    for pooling in ("sum", "mean"):
        got = []
        for st in stores:
            st.set_rows(sh, sl, vals, z, np.full(nk, OOB, np.int32))
            before = K.LAUNCHES["gather_pool"]
            got.append(st.gather_pool(*args, pooling=pooling))
            assert K.LAUNCHES["gather_pool"] - before == \
                (1 if st.main.is_cuda else 0)
        assert torch.equal(_bits(got[1]), _bits(got[0]))


def _stress_case(rng, L, S):
    """Bags of very different lengths, as K8's work items see them: one
    bag of 5,000 members among singletons and a few longer bags, empty
    bags in the middle (a run of 200 among them), a last bag of 37
    members that runs up to the bucket's OOB padding, and empty padding
    bags after it."""
    R, C = 300, 40
    sizes = np.ones(3000, np.int64)
    sizes[1200] = 5000
    sizes[[7, 300, 301, 2999 - 5]] = [100, 27, 12, 0]
    sizes[[10, 11, 500, 2000]] = 0
    sizes[2100:2300] = 0              # empty bags over whole chunks
    sizes[-1] = 37
    seg = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    m = len(seg)
    n = 1 << int(np.ceil(np.log2(m)))            # the store's bucket
    seg = np.concatenate([seg, np.full(n - m, OOB, np.int32)])
    main, cache, delta = (torch.randn(S, k, L) for k in (R, C, C))
    main[0, :3] = -0.0
    o = _coords(rng, n, S, R)
    c = _coords(rng, n, S, C)
    use_c = torch.from_numpy(rng.random(n) < (0.25 if S == 2 else 0.0))
    nb = 1 << int(np.ceil(np.log2(len(sizes))))
    out0 = torch.randn(nb, L)
    out0[:4] = -0.0
    return (main, cache, delta) + o + c + (use_c,), seg, out0


@pytest.mark.parametrize("L", [256, 6])
@pytest.mark.parametrize("pooling", ["sum", "mean"])
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("order", ["sorted", "unsorted"])
def test_gather_pool_bag_length_stress(cuda, L, pooling, S, order):
    """K8 bitwise its plain version and over two runs where one bag is
    5,000 members long among singletons (it spans many work items),
    with empty bags in the middle (one run of 200) and at the end and a
    last bag that runs up to the OOB padding; owner-served (S=1) and a
    quarter replica-served (S=2)."""
    rng = np.random.default_rng(L + 10 * S)
    args, seg, out0 = _stress_case(rng, L, S)
    s = torch.from_numpy(seg)
    a = list(args)
    if order == "unsorted":
        perm = torch.from_numpy(rng.permutation(len(seg)))
        a = [x if x.dim() == 3 else x[perm] for x in a]
        s = s[perm]
    ref = K.gather_pool(*a, s, out0.clone(), pooling)
    got = [K.gather_pool(*[x.to(cuda) for x in a], s.to(cuda),
                         out0.clone().to(cuda), pooling,
                         sorted_seg=order == "sorted") for _ in range(2)]
    assert torch.equal(_bits(got[0]), _bits(ref))
    assert torch.equal(_bits(got[1]), _bits(got[0]))


@pytest.mark.parametrize("L", [256, 6])
@pytest.mark.parametrize("pooling", ["sum", "mean"])
def test_gather_pool_items_past_the_first_wave(cuda, L, pooling):
    """K8 on a batch with more work items than its persistent grid has
    warps (about 600,000 members in bags of the DLRM-DCNv2 multi-hot
    sizes, a few empty), where the items past the first wave come from
    the launch stream's counter: bitwise the plain version over
    repeated launches (each must leave its counter reset for the next)
    on the default stream and on a second one, and with two launches
    running at once on the two streams (each stream has its own
    counter)."""
    rng = np.random.default_rng(L)
    hots = np.array([3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1,
                     1, 12, 100, 27, 10, 3, 1, 1])
    sizes = np.tile(hots, 2800)
    sizes[rng.choice(len(sizes), 100, replace=False)] = 0
    seg = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    n = 1 << int(np.ceil(np.log2(len(seg))))             # the store's bucket
    seg = np.concatenate([seg, np.full(n - len(seg), OOB, np.int32)])
    S, R, C = 2, 5000, 1000
    main, cache, delta = (torch.randn(S, k, L, device=cuda)
                          for k in (R, C, C))
    args = [t.to(cuda) for t in _coords(rng, n, S, R) + _coords(rng, n, S, C)
            + (torch.from_numpy(rng.random(n) < 0.25),)]
    s = torch.from_numpy(seg).to(cuda)
    out0 = torch.randn(1 << int(np.ceil(np.log2(len(sizes)))), L,
                       device=cuda)
    ref = K.gather_pool_plain(main, cache, delta, *args, s, out0.clone(),
                              pooling)
    here, side = torch.cuda.current_stream(cuda), torch.cuda.Stream(cuda)

    def launch(stream, out):
        with torch.cuda.stream(stream):
            K.gather_pool(main, cache, delta, *args, s, out, pooling,
                          sorted_seg=True)
        return out

    outs = []
    for stream in (here, side, here, side):      # one after another
        out = out0.clone()
        stream.wait_stream(here)
        outs.append(launch(stream, out))
        here.wait_stream(stream)
    pair = [out0.clone(), out0.clone()]
    side.wait_stream(here)
    outs += [launch(here, pair[0]), launch(side, pair[1])]   # at once
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(_bits(got), _bits(ref))


def _wire(mode, rows):
    """(wire rows, scale or None) of f32 `rows` in a cold format."""
    from adapm_tpu_torch.tier.quant import quantize_rows
    q, sc = quantize_rows(mode, rows.numpy())
    return torch.from_numpy(q), None if sc is None else torch.from_numpy(sc)


@pytest.mark.parametrize("L", [256, 6, 600])
@pytest.mark.parametrize("pooling", ["sum", "mean"])
@pytest.mark.parametrize("mode", ["fp32", "fp16", "int8"])
def test_gather_pool_cold_long_bags(cuda, L, pooling, mode):
    """K10 bitwise its plain version and over two runs on K8's stress
    batch (a 5,000-member bag among singletons, empty bags, OOB
    padding), half of the members cold (wire rows staged per member)
    and a quarter of the rest replica-served."""
    rng = np.random.default_rng(L + len(mode))
    args, seg, out0 = _stress_case(rng, L, 2)
    n = len(seg)
    use_cold = torch.from_numpy(rng.random(n) < 0.5) & ~args[-1]
    q, sc = _wire(mode, torch.randn(n, L))
    a = list(args[:-1]) + [args[-1], mode, q, sc, use_cold,
                           torch.from_numpy(seg)]
    ref = K.gather_pool_cold(*a, out0.clone(), pooling)
    dev = [x.to(cuda) if isinstance(x, torch.Tensor) else x for x in a]
    got = [K.gather_pool_cold(*dev, out0.clone().to(cuda), pooling,
                              sorted_seg=True) for _ in range(2)]
    assert torch.equal(_bits(got[0]), _bits(ref))
    assert torch.equal(_bits(got[1]), _bits(got[0]))


def _k11_batches(rng, S, R):
    """(name, sh, row) of K11's hard cases: many entries naming few
    rows (a row named up to ~10 times), OOB padding, negative rows,
    sh >= S; all out of range; one entry; distinct rows (promotion)."""
    n = 2000
    sh = rng.integers(0, S, n).astype(np.int32)
    row = rng.integers(0, R // 2, n).astype(np.int32)
    u = rng.random(n)
    row[u < 0.05] = -1 - rng.integers(0, R, int((u < 0.05).sum()))
    sh[(u >= 0.05) & (u < 0.1)] = S
    row[-100:] = OOB
    return [("duplicates", sh, row),
            ("all_oob", np.zeros(40, np.int32), np.full(40, OOB, np.int32)),
            ("single", np.array([S - 1], np.int32),
             np.array([R - 1], np.int32)),
            ("distinct", np.zeros(R // 2, np.int32),
             rng.permutation(R)[:R // 2].astype(np.int32))]


@pytest.mark.parametrize("L", [512, 7])
@pytest.mark.parametrize("mode", ["fp32", "fp16", "int8"])
def test_write_main_rows_last_wins_and_drops(cuda, L, mode):
    """K11 bitwise its plain version (the last entry naming a row wins,
    out-of-range entries drop, -0.0 survives) and over two runs, on the
    default stream and on a second one; its claim scratch is all -1
    after every call."""
    rng = np.random.default_rng(L)
    S, R = 2, 300
    main = torch.randn(S, R, L)
    main[0, :3] = -0.0
    side = torch.cuda.Stream(cuda)
    for name, sh, row in _k11_batches(rng, S, R):
        vals = torch.randn(len(sh), L)
        vals[::3, ::2] = -0.0
        q, sc = _wire(mode, vals)
        a = (torch.from_numpy(sh), torch.from_numpy(row), mode, q, sc)
        ref = K.write_main_rows(main.clone(), *a)
        dev = [x.to(cuda) if isinstance(x, torch.Tensor) else x for x in a]
        for stream in (torch.cuda.current_stream(cuda), side, None):
            if stream is None:
                got = K.write_main_rows(main.clone().to(cuda), *dev)
            else:
                stream.wait_stream(torch.cuda.current_stream(cuda))
                with torch.cuda.stream(stream):
                    got = K.write_main_rows(main.clone().to(cuda), *dev)
                torch.cuda.current_stream(cuda).wait_stream(stream)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), _bits(ref)), name
            for claim in K._claims.values():
                assert bool((claim == -1).all()), name


def _k14_sources(rng, m, L, S, R):
    rows = torch.randn(m, L)
    rows[::3, ::2] = -0.0
    resid = torch.randn(m, L)
    resid[1::4] = -0.0
    src = torch.randn(S + 1, R + 5, L)
    src[0, :4] = -0.0
    return rows, resid, (src, *_coords(rng, m, S + 1, R + 5))


def _on(cuda, *xs):
    return [x.to(cuda) if isinstance(x, torch.Tensor) else
            tuple(_on(cuda, *x)) if isinstance(x, tuple) else x for x in xs]


@pytest.mark.parametrize("L", [512, 7])
def test_drop_set_forms_last_wins_and_drops(cuda, L):
    """K14's three forms bitwise their plain versions (the last entry
    naming a row wins, out-of-range entries drop, -0.0 survives) and over
    two runs, on the default stream and on a second one; the install form
    from source rows, with and without a residual, and read from another
    pool; the claim scratch all -1 after every call."""
    rng = np.random.default_rng(L)
    S, R = 2, 300
    pool = torch.randn(S, R, L)
    pool[0, :3] = -0.0
    side = torch.cuda.Stream(cuda)
    for name, sh, sl in _k11_batches(rng, S, R):
        sh, sl = torch.from_numpy(sh), torch.from_numpy(sl)
        rows, resid, src = _k14_sources(rng, len(sh), L, S, R)
        cases = {
            "rows": (K.drop_set, (sh, sl, rows), 1),
            "zero": (K.drop_set_zero, (sh, sl), 1),
            "install": (K.drop_set_install, (sh, sl, rows), 2),
            "install_resid": (lambda c, d, *a: K.drop_set_install(
                c, d, *a[:3], resid=a[3]), (sh, sl, rows, resid), 2),
            "install_src": (lambda c, d, *a: K.drop_set_install(
                c, d, a[0], a[1], src=a[2]), (sh, sl, src), 2),
        }
        for form, (fn, args, npools) in cases.items():
            pools = [pool.clone() for _ in range(npools)]
            fn(*pools, *args)
            for stream in (torch.cuda.current_stream(cuda), side, None):
                got = [p.clone().to(cuda) for p in
                       [pool] * npools]
                if stream is None:
                    fn(*got, *_on(cuda, *args))
                else:
                    stream.wait_stream(torch.cuda.current_stream(cuda))
                    with torch.cuda.stream(stream):
                        fn(*got, *_on(cuda, *args))
                    torch.cuda.current_stream(cuda).wait_stream(stream)
                torch.cuda.synchronize()
                for g, r in zip(got, pools):
                    assert torch.equal(_bits(g), _bits(r)), (name, form)
                for claim in K._claims.values():
                    assert bool((claim == -1).all()), (name, form)


def _sync_case(rng, S, L, n, C=64, R=40):
    main = torch.randn(S, R, L)
    cache = torch.randn(S, C, L)
    delta = torch.randn(S, C, L)
    delta[:, ::2] *= 1e-3                  # half of the rows held
    delta[0, :3] = -0.0
    main[:, :2] = -0.0
    r_sh = rng.integers(0, S, n).astype(np.int32)
    r_cs = rng.integers(0, C, n).astype(np.int32)
    o_sh = rng.integers(0, S, n).astype(np.int32)
    # few owners: several replicas fold into one owner row in a round
    o_sl = rng.integers(0, 6, n).astype(np.int32)
    u = rng.random(n)
    r_cs[u < 0.05] = OOB
    o_sl[(u >= 0.05) & (u < 0.1)] = OOB
    r_sh[(u >= 0.1) & (u < 0.12)] = -1
    o_sh[(u >= 0.12) & (u < 0.14)] = S
    return [main, cache, delta] + [torch.from_numpy(a) for a in
                                   (r_sh, r_cs, o_sh, o_sl)]


def _heavy_sync_case(rng, S, L, k, dup, C=700, R=40):
    """A round in which owner row (0, 1) is named by k replicas, among
    250 entries of _sync_case (singletons, held rows, OOB and negative
    coordinates, -0.0), in a shuffled batch order; its k replica rows are
    distinct, or with `dup` a third of them repeat an earlier one."""
    base = _sync_case(rng, S, L, 250, C, R)
    rows = rng.permutation(S * C)[:k]
    if dup:
        rows[2::3] = rows[rng.integers(0, max(1, k // 3), len(rows[2::3]))]
    extra = [rows // C, rows % C, np.zeros(k), np.ones(k)]
    order = rng.permutation(250 + k)
    coords = [torch.from_numpy(np.concatenate([a.numpy(), b.astype(np.int32)])
                               [order]) for a, b in zip(base[3:], extra)]
    return base[:3] + coords


@pytest.mark.parametrize("L", [512, 7])
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_sync_round_bitwise_plain(cuda, L, S, threshold):
    """K15 bitwise its plain version and over two runs: owners repeated
    within a round (their folds in batch order), held rows below the
    threshold, duplicate replicas, OOB and negative coordinates, -0.0;
    then rounds in which one owner row is named 2, 32, 33 and 1,000 times
    (lists sorted in the warp, and past it in memory), with
    distinct and with repeated replica rows; every claim scratch (K15's
    and K14's) all -1 after each call."""
    rng = np.random.default_rng(S * 100 + L)
    cases = [_sync_case(rng, S, L, n) for n in (1, 37, 3000)]
    cases += [_heavy_sync_case(rng, S, L, k, dup) for k in (2, 32, 33, 1000)
              for dup in (False, True)]
    for args in cases:
        n = len(args[3])
        ref = [t.clone() for t in args[:3]]
        K.sync_round_plain(*ref, *args[3:], threshold=threshold)
        outs = []
        for _ in range(2):
            got = _on(cuda, *[t.clone() for t in args])
            K.sync_round(*got, threshold=threshold)
            torch.cuda.synchronize()
            outs.append(got[:3])
        for name, a, b, r in zip(("main", "cache", "delta"), *outs, ref):
            assert torch.equal(_bits(a), _bits(b)), (n, name)
            assert torch.equal(_bits(a), _bits(r)), (n, name)
        for claim in K._claims.values():
            assert bool((claim == -1).all()), n


def _captured(graph, stream, fn):
    """Bytes the capture of fn() into `graph` on `stream` allocated."""
    before = torch.cuda.memory_allocated()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    return torch.cuda.memory_allocated() - before


def test_sync_round_in_a_captured_graph(cuda):
    """K15 captured in a CUDA graph (its scratch made by a round on the
    capture stream first) allocates no more during the capture than an
    empty capture does (the capture's own RNG state), and each replay on
    fresh inputs is bitwise the eager round on the same inputs,
    threshold 0 and half held. While any captured graph lives, the CUDA
    generator keeps its graph-safe RNG state (two 8-byte tensors, 1,024
    bytes of blocks), made at the start of a capture when no live graph
    holds it and freed with the last such graph: each threshold's graph
    is released before the next threshold's captures, so the empty
    capture and K15's start from the same state."""
    rng = np.random.default_rng(9)
    for threshold in (0.0, 0.5):
        args = _on(cuda, *_heavy_sync_case(rng, 4, 512, 40, False))
        side = torch.cuda.Stream(cuda)
        side.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(side):
            pools = [t.clone() for t in args[:3]]
            K.sync_round(*pools, *args[3:], threshold=threshold)
        torch.cuda.current_stream(cuda).wait_stream(side)
        torch.cuda.synchronize()
        pools = [t.clone() for t in args[:3]]
        # the process's first capture may set up state of its own
        _captured(torch.cuda.CUDAGraph(), side, lambda: None)
        empty = _captured(torch.cuda.CUDAGraph(), side, lambda: None)
        graph = torch.cuda.CUDAGraph()
        used = _captured(graph, side, lambda: K.sync_round(
            *pools, *args[3:], threshold=threshold))
        assert used == empty, (used, empty)
        for seed in range(3):
            fresh = _on(cuda, *_sync_case(np.random.default_rng(seed), 4,
                                          512, 1, C=700)[:3])
            for p, f in zip(pools, fresh):
                p.copy_(f)
            graph.replay()
            torch.cuda.synchronize()
            ref = [f.clone() for f in fresh]
            K.sync_round(*ref, *args[3:], threshold=threshold)
            torch.cuda.synchronize()
            for name, a, b in zip(("main", "cache", "delta"), pools, ref):
                assert torch.equal(_bits(a), _bits(b)), (threshold, seed,
                                                          name)
        for claim in K._claims.values():
            assert bool((claim == -1).all()), threshold
        del graph


def test_port_sets_and_syncs_on_card_bitwise_cpu(cuda):
    """The device port's set, replica, sync (plain, thresholded and
    compressed), relocate, install and clear programs on the card bitwise
    the same programs on the CPU, op after op, with K14 and K15 launched."""
    from adapm_tpu_torch.device.torchport import TorchDevicePort
    rng = np.random.default_rng(5)
    S, R, C, L = 4, 48, 24, 16
    init = [torch.randn(S, k, L) for k in (R, C, C)]
    cpu = [t.clone() for t in init]
    gpu = [t.to(cuda) for t in init]
    pc, pg = TorchDevicePort(), TorchDevicePort()
    K.reset_launches()
    for i in range(60):
        n = int(rng.integers(1, 40))
        a_sh, a_sl = _coords(rng, n, S, R)
        b_sh, b_sl = _coords(rng, n, S, C)
        v = rng.normal(size=(n, L)).astype(np.float32)
        op = i % 6
        for port, pools in ((pc, cpu), (pg, gpu)):
            if op == 0:
                pools[:] = port.set_rows(*pools, a_sh, a_sl, v, b_sh, b_sl)
            elif op == 1:
                pools[1:] = port.replica_create(*pools, a_sh, a_sl, b_sh,
                                                b_sl)
            elif op == 2:
                thr = (0.0, 0.8)[i % 2]
                pools[:] = port.sync_replicas(*pools, b_sh, b_sl, a_sh,
                                              a_sl, threshold=thr)
            elif op == 3:
                n_sh, n_sl = _coords(rng, n, S, R) if port is pc else \
                    (n_sh, n_sl)
                pools[0], pools[2] = port.relocate(
                    pools[0], pools[2], a_sh, a_sl, n_sh, n_sl, b_sh, b_sl)
            elif op == 4:
                pools[1:] = port.install_cache_rows(
                    pools[1], pools[2], b_sh, b_sl, v,
                    resid=v * 0.5 if i % 2 else None)
                pools[0] = port.clear_rows(pools[0], a_sh, a_sl)
            else:
                out = port.sync_replicas(*pools, b_sh, b_sl, a_sh, a_sl,
                                         threshold=0.3, compress="int8")
                pools[:] = out[:3]
        for name, a, b in zip(("main", "cache", "delta"), cpu, gpu):
            assert torch.equal(_bits(a), _bits(b)), (i, op, name)
    assert K.LAUNCHES["drop_set"] > 0 and K.LAUNCHES["sync_round"] > 0


# -- the prefetch pipeline and the background planner on the card ----------


def test_staged_pull_bitwise_plain_pull(cuda):
    """A pull served from a buffer the prefetch pipeline staged on the
    card (K1 on an executor thread) is bitwise the plain pull, and a
    push between staging and pull is seen."""
    import adapm_tpu_torch as at
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(400, 64)).astype(np.float32)
    reads = []
    for prefetch in (True, False):
        srv = at.setup(400, 64, num_shards=2, device=cuda,
                       opts=at.SystemOptions(sync_max_per_sec=0,
                                             prefetch=prefetch,
                                             prefetch_pull="always"))
        w = srv.make_worker(0)
        w.wait(w.set(np.arange(400), vals))
        keys = np.unique(rng.integers(0, 400, 150)) if not reads else \
            reads[0][0]
        w.intent(keys, w.current_clock, w.current_clock + 10)
        if prefetch:
            srv.prefetch.flush()
            assert srv.prefetch.report()["live"] == 1
        first = w.pull_sync(keys)
        w.intent(keys, w.current_clock, w.current_clock + 10)
        if prefetch:
            srv.prefetch.flush()
        w.wait(w.push(keys[::3], np.ones((len(keys[::3]), 64), np.float32)))
        second = w.pull_sync(keys)
        if prefetch:
            assert srv.prefetch.stats["hits"] >= 1
            assert srv.prefetch.stats["invalidated_write"] >= 1
            assert srv.prefetch.failures == 0
        reads.append((keys, first, second))
        srv.shutdown()
    (_, a1, a2), (_, b1, b2) = reads
    assert np.array_equal(a1.view(np.uint32), b1.view(np.uint32))
    assert np.array_equal(a2.view(np.uint32), b2.view(np.uint32))
    assert not np.array_equal(a1, a2)


def test_graph_captured_once_with_pipeline_relocating(cuda):
    """run_scan windows with the pipeline on while delegated rounds
    relocate keys between windows: the router mirrors refresh in place,
    so one capture serves every window; losses and the main pool are
    bitwise those of the same calls with inline rounds."""
    import adapm_tpu_torch as at
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner
    roles = ("s", "r", "o", "neg")
    out = []
    for prefetch in (True, False):
        rng = np.random.default_rng(1)
        srv = at.setup(300, 32, num_shards=2, num_workers=2, device=cuda,
                       opts=at.SystemOptions(
                           sync_max_per_sec=0, prefetch=prefetch,
                           techniques=at.MgmtTechniques.RELOCATION_ONLY))
        w = srv.make_worker(0)
        vals = rng.normal(size=(300, 32)).astype(np.float32) * 0.1
        vals[:, 16:] = 1e-6
        w.wait(w.set(np.arange(300), vals))
        run = DeviceRoutedRunner(
            srv, make_kge_loss("complex"), role_class=dict.fromkeys(roles, 0),
            role_dim=dict.fromkeys(roles, 16), shard=0)
        losses, v0 = [], srv.topology_version
        for win in range(4):
            batches = [{"s": rng.integers(0, 280, 32),
                        "r": rng.integers(280, 300, 32),
                        "o": rng.integers(0, 280, 32),
                        "neg": rng.integers(0, 280, (32, 3))}
                       for _ in range(4)]
            losses.append(run.run_scan(batches, None, 0.1))
            # 8 keys of shard 1 the next window moves to the worker's
            # shard (within its free main slots: no move demoted to a
            # replica)
            w.intent(np.arange(win * 16 + 1, win * 16 + 17, 2),
                     w.current_clock, w.current_clock + 100)
            srv.drive_rounds(4)
            if prefetch:
                srv.prefetch.flush()
            for _ in range(4):
                w.advance_clock()
        assert srv.topology_version > v0, "no relocation happened"
        assert not run._shard_has_replicas(), "a move became a replica"
        assert run.graph_captures == 1, run.graph_captures
        if prefetch:
            assert srv.prefetch.stats["rounds_driven"] >= 4
            assert srv.prefetch.failures == 0
        out.append((torch.cat(losses).cpu(), srv.stores[0].main.cpu()))
        srv.shutdown()
    (l1, m1), (l2, m2) = out
    assert torch.equal(_bits(l1), _bits(l2))
    assert torch.equal(_bits(m1), _bits(m2))


def test_background_planner_converges_on_card(cuda):
    """Two worker threads push integer values under competing intents
    while start_sync_thread runs the rounds on the card: after
    stop_sync_thread and quiesce every row is the sequential sum,
    bitwise, and no background round failed."""
    import threading

    import adapm_tpu_torch as at
    n, L = 200, 16
    srv = at.setup(n, L, num_shards=2, num_workers=2, device=cuda,
                   opts=at.SystemOptions(sync_max_per_sec=1000.0,
                                         cache_slots_per_shard=128,
                                         sync_report_s=0))
    ws = [srv.make_worker(i) for i in range(2)]
    init = np.random.default_rng(2).integers(-3, 4, (n, L)).astype(np.float32)
    ws[0].wait(ws[0].set(np.arange(n), init))
    hot = np.arange(0, n, 2)
    sums = [np.zeros((n, L)) for _ in ws]

    def run(w):
        rng = np.random.default_rng(10 + w.worker_id)
        for i in range(150):
            if i % 20 == 0:
                w.intent(hot, w.current_clock, w.current_clock + 30)
            k = rng.choice(hot, 16)
            v = rng.integers(-2, 3, (16, L)).astype(np.float32)
            w.push(k, v)
            np.add.at(sums[w.worker_id], k, v)
            w.advance_clock()
        w.wait_all()

    srv.start_sync_thread()
    ts = [threading.Thread(target=run, args=(w,)) for w in ws]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    srv.wait_sync()
    srv.stop_sync_thread()
    srv.quiesce()
    got = srv.read_main(np.arange(n)).reshape(n, L)
    want = (init + sums[0] + sums[1]).astype(np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert srv.sync.stats.rounds > 0 and srv.sync.stats.replicas_created > 0
    assert srv.sync_loop_failures == 0
    assert srv.exec.stats()["programs_failed"] == 0
    srv.shutdown()


def test_staged_keys_ring_bitwise_plain_upload(cuda):
    """Steps whose keys came through prefetch_keys' pinned ring, staged
    three steps ahead, over more uploads than the ring has slots and with
    a batch size that grows midway (each slot's buffer is replaced): the
    losses and the main pool are bitwise those of the same steps with
    keys uploaded in the dispatch; a batch that is not the staged one is
    refused."""
    import adapm_tpu_torch as at
    from adapm_tpu_torch.models import make_kge_loss
    from adapm_tpu_torch.ops.fused import DeviceRoutedRunner, _PinnedRing
    roles = ("s", "r", "o", "neg")
    rng = np.random.default_rng(4)
    vals = rng.normal(size=(300, 32)).astype(np.float32) * 0.1
    vals[:, 16:] = 1e-6
    n_steps = 2 * _PinnedRing.SLOTS + 4
    batches = [{"s": rng.integers(0, 280, n), "r": rng.integers(280, 300, n),
                "o": rng.integers(0, 280, n),
                "neg": rng.integers(0, 280, (n, 3))}
               for n in [32] * 10 + [96] * (n_steps - 10)]
    out = []
    for staging in (True, False):
        srv = at.setup(300, 32, device=cuda,
                       opts=at.SystemOptions(sync_max_per_sec=0))
        w = srv.make_worker(0)
        w.wait(w.set(np.arange(300), vals))
        run = DeviceRoutedRunner(
            srv, make_kge_loss("complex"), role_class=dict.fromkeys(roles, 0),
            role_dim=dict.fromkeys(roles, 16), shard=0)
        staged = {i: run.prefetch_keys(batches[i]) for i in range(3)} \
            if staging else {}
        losses = []
        for i, b in enumerate(batches):
            if staging and i + 3 < n_steps:
                staged[i + 3] = run.prefetch_keys(batches[i + 3])
            losses.append(run(b, None, 0.1, staged=staged.pop(i, None)))
        if staging:
            assert run.staged_steps == n_steps
            nxt = run.prefetch_keys(batches[0])
            with pytest.raises(ValueError):
                run(batches[1], None, 0.1, staged=nxt)
        out.append((torch.stack(losses).cpu(), srv.stores[0].main.cpu()))
        srv.shutdown()
    (l1, m1), (l2, m2) = out
    assert torch.equal(_bits(l1), _bits(l2))
    assert torch.equal(_bits(m1), _bits(m2))


def test_checkpoint_chain_round_trip_on_card(cuda, tmp_path):
    """A base + two deltas saved from a server on the card (replicas
    with unshipped deltas included) restore bitwise into a fresh server
    on the card and into one on the CPU; the delta links' main rows are
    read back through K1."""
    import adapm_tpu_torch as at
    from adapm_tpu_torch.base import CLOCK_MAX
    from adapm_tpu_torch.fault import IncrementalCheckpointer, restore_chain
    E, L = 512, 64

    def mk(dev):
        return at.setup(E, L, num_shards=2, device=dev,
                        opts=at.SystemOptions(sync_max_per_sec=0,
                                              cache_slots_per_shard=64))

    rng = np.random.default_rng(6)
    srv = mk(cuda)
    w0, w1 = srv.make_worker(0), srv.make_worker(1)
    w0.set(np.arange(E), rng.normal(size=(E, L)).astype(np.float32))
    ck = IncrementalCheckpointer(srv, str(tmp_path / "chain"))
    ck.save()
    w0.push(rng.integers(0, E, 200),
            rng.normal(size=(200, L)).astype(np.float32))
    n0 = K.LAUNCHES["routed_gather"]
    d1 = ck.save()
    assert d1["kind"] == "delta" and d1["slots"] > 0
    assert K.LAUNCHES["routed_gather"] > n0
    shared = np.arange(0, 64)
    w0.intent(shared, 0, CLOCK_MAX)
    w1.intent(shared, 0, CLOCK_MAX)
    srv.wait_sync()
    w0.push(shared, np.full((64, L), 0.5, np.float32))
    srv.block()
    ck.save()
    want_main = srv.read_main(np.arange(E))
    want_pull = w0.pull_sync(np.arange(E))
    srv.shutdown()
    for dev in (cuda, "cpu"):
        dst = mk(dev)
        w = dst.make_worker(0)
        assert restore_chain(dst, str(tmp_path / "chain")) > 0
        assert np.array_equal(dst.read_main(np.arange(E)), want_main)
        assert np.array_equal(w.pull_sync(np.arange(E)), want_pull)
        dst.shutdown()


def test_flight_device_slice_after_readback(cuda, tmp_path):
    """A traced lookup on the card: the device slice ends after the
    synchronizing readback, so `flight.device_s` is above zero and no
    longer than its program slice."""
    import json
    import adapm_tpu_torch as at
    from adapm_tpu_torch.serve import ServePlane
    E, L = 100_000, 512
    srv = at.setup(E, L, device=cuda, opts=at.SystemOptions(
        sync_max_per_sec=0, trace_flight=True, stats_out=str(tmp_path)))
    w = srv.make_worker(0)
    w.set(np.arange(E), np.ones((E, L), np.float32))
    with ServePlane(srv) as plane:
        sess = plane.session()
        for _ in range(4):
            sess.lookup(np.arange(0, E, 7))
    snap = srv.metrics_snapshot()["flight"]["device_s"]
    assert snap["count"] == 4 and snap["sum"] > 0
    doc = json.load(open(srv.write_flight_trace()))
    srv.shutdown()
    dev = [e for e in doc["traceEvents"]
           if e.get("ph") == "X" and e["name"] == "flight.device"]
    prog = [e for e in doc["traceEvents"]
            if e.get("ph") == "X" and e["name"] == "flight.program"]
    assert len(dev) == len(prog) == 4
    for d, p in zip(dev, prog):
        assert d["dur"] > 0
        assert d["dur"] <= p["dur"] + 1e-3


def _slabs(nbytes, P, cuda):
    ptrs = [K.slab_alloc(nbytes)[0] for _ in range(P)]
    return ptrs, [K.slab_view(p, nbytes) for p in ptrs]


@pytest.mark.parametrize("P,T", [(2, 16), (3, 2_105_360), (4, 4_112)])
def test_alltoall_put_bitwise_plain(cuda, P, T):
    """K13 into P raw-cudaMalloc slabs (a launch cannot tell a local slab
    from an IPC-mapped one), every source at both parities: bitwise the
    plain version's copy_ into torch tensors, with and without a given
    pointer table."""
    nbytes = 2 * P * T
    ptrs, slabs = _slabs(nbytes, P, cuda)
    try:
        plain = [torch.zeros(nbytes, dtype=torch.uint8, device=cuda)
                 for _ in range(P)]
        table = torch.tensor(ptrs, dtype=torch.int64, device=cuda)
        g = torch.Generator(device="cpu").manual_seed(P)
        for parity in (0, 1):
            for s in range(P):
                src = torch.randint(0, 256, (P, T), dtype=torch.uint8,
                                    generator=g).to(cuda)
                off = parity * P * T + s * T
                K.alltoall_put(src, slabs, off,
                               table if s % 2 == 0 else None)
                K.alltoall_put_plain(src, plain, off)
        torch.cuda.synchronize()
        for a, b in zip(slabs, plain):
            assert torch.equal(a, b)
    finally:
        torch.cuda.synchronize()
        for p in ptrs:
            K.slab_free(p)


def test_alltoall_put_rejects_misaligned(cuda):
    ptrs, slabs = _slabs(256, 2, cuda)
    try:
        with pytest.raises(ValueError, match="16-byte"):
            K.alltoall_put(torch.zeros((2, 24), dtype=torch.uint8,
                                       device=cuda), slabs, 0)
        with pytest.raises(ValueError, match="16-byte"):
            K.alltoall_put(torch.zeros((2, 32), dtype=torch.uint8,
                                       device=cuda), slabs, 8)
        with pytest.raises(ValueError, match="span devices"):
            K.alltoall_put(torch.zeros((2, 32), dtype=torch.uint8),
                           slabs, 0)
    finally:
        for p in ptrs:
            K.slab_free(p)


def test_collective_exchange_across_processes_on_card(cuda, tmp_path):
    """Two launched ranks with their pools on the card exchange through
    K13 over CUDA IPC: the collective pull and push of
    tests/test_torch_collective.py bitwise its shadow."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_collective as tc
    tc.run_mp(2, "pullpush", tmp_path, timeout=240, device="cuda")
    want = (tc._base(tc.E_PP, 4) + 3.0).astype(np.float32)
    for r in range(2):
        for tag in ("c", "m"):
            assert np.load(tmp_path / f"{tag}{r}.npy").tobytes() == \
                want.tobytes()


# a pool whose rows pass f32 element 2^31: 4,400,000 rows of 512 f32
# (9.0 GB), the north-star KGE table's scale; rows from BIG_LO on lie
# past that element
BIG_R, BIG_L = 4_400_000, 512
BIG_LO = 2**31 // BIG_L


def _top_rows(rng, n, lo, R):
    """n int32 slots over rows [lo, R): repeats (every fourth names the
    one before it), slots past the pool and negative ones among them."""
    sl = rng.integers(lo, R, n)
    sl[1::4] = sl[0::4]
    sl[::97] = R
    sl[1::101] = -1
    return sl.astype(np.int32)


def test_kernels_on_rows_past_element_2_31(cuda):
    """K1, K3, K14 and K15 naming the top rows of a pool of 4,400,000
    rows of 512 f32 (from a little below the row holding element 2^31
    to the last, where a flat f32 offset needs 64 bits) bitwise their
    plain versions on a copy of the whole pool; each check leaves both
    pools equal for the next."""
    rng = np.random.default_rng(31)
    pool = torch.randn(1, BIG_R, BIG_L, device=cuda)
    n = 4096
    sh = torch.zeros(n, dtype=torch.int32, device=cuda)
    sl = torch.as_tensor(_top_rows(rng, n, BIG_LO - 1024, BIG_R),
                         device=cuda)
    assert int((sl.long() >= BIG_LO).sum()) > n // 2

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    assert same(K.routed_gather(pool, None, None, sh, sl),
                K.routed_gather_plain(pool, None, None, sh, sl))
    vals = torch.randn(n, BIG_L, device=cuda)
    ref = pool.clone()
    K.ordered_scatter_add_plain(ref, sh, sl, vals)
    K.ordered_scatter_add(pool, sh, sl, vals)
    assert same(pool, ref), "K3"
    K.drop_set_plain(ref, sh, sl, vals)
    K.drop_set(pool, sh, sl, vals)
    assert same(pool, ref), "K14"
    # K15: 4,096 replicas of one shard's cache, their owners the top rows
    C = 4096
    cache = torch.randn(1, C, BIG_L, device=cuda)
    delta = torch.randn(1, C, BIG_L, device=cuda) * 1e-3
    r_cs = torch.as_tensor(rng.permutation(C).astype(np.int32),
                           device=cuda)
    caches = [(cache.clone(), delta.clone()) for _ in range(2)]
    K.sync_round_plain(ref, *caches[0], sh, r_cs, sh, sl)
    K.sync_round(pool, *caches[1], sh, r_cs, sh, sl)
    torch.cuda.synchronize()
    assert same(pool, ref), "K15 main"
    for a, b in zip(*caches):
        assert same(a, b), "K15 cache/delta"
    del pool, ref
    torch.cuda.empty_cache()


def test_bulk_device_init_fills_every_slot_on_card(cuda):
    """northstar.bulk_device_init on a server's pool on the card (300,000
    keys of 512 f32: 375,000 slots, two slabs, the last short): no slot
    left unwritten (the pool filled with NaN first), optimizer columns
    exactly f32 1e-6, the embedding columns' mean within 0.001 and std
    within 0.5% of normal(0, 0.1), the same seed the same bytes twice."""
    import adapm_tpu_torch
    from adapm_tpu_torch import northstar as ns
    keys = 300_000
    srv = adapm_tpu_torch.setup(keys, BIG_L, opts=ns._sys_opts(keys),
                                device=cuda)
    try:
        st = srv.stores[0]
        fills = []
        for _ in range(2):
            st.main.fill_(float("nan"))
            ns.bulk_device_init(st, BIG_L // 2, 0.1, seed=0)
            fills.append(st.main.clone())
        main = fills[0]
        assert main.shape[1] > ns.SLAB
        assert not bool(torch.isnan(main).any())
        assert bool((main[:, :, BIG_L // 2:] == torch.tensor(
            1e-6, device=cuda)).all())
        emb = main[:, :, :BIG_L // 2].double()
        assert abs(float(emb.mean())) < 0.001
        assert abs(float(emb.std()) / 0.1 - 1) < 0.005
        assert torch.equal(main.view(torch.int32),
                           fills[1].view(torch.int32))
    finally:
        srv.shutdown()
