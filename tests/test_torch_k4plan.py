"""K4's launch plan (ops/kernels.py _k4_plan), which runs here on the CPU.

Over a sweep of batch sizes, widths, row lengths, candidate counts and
SM counts, the plan's grid and query blocks, walked the way the kernel
walks them, must cover every (query, side, candidate) triple exactly
once: a one-CTA-a-block form's CTA (x, y) takes candidate tiles x,
x + gx, ... of 128 rows and queries y*Bq .. y*Bq + Bq - 1 of both sides;
the pair form's CTA (x, y) takes tiles x, x + gx, ... of 256 rows and
all queries of side y. Its shared memory must
fit one H100 CTA and equal the kernel's layout; a wider K must never
take a larger resident query block; and the pair form is taken exactly
where no resident block holds all B queries and one side's fit it."""
import itertools

import numpy as np
import pytest

from adapm_tpu_torch.ops import kernels as K

SWEEP = list(itertools.product((1, 36, 64, 65, 150), (7, 256, 512, 2048),
                               (1, 700, 20_000)))
# the pair form's sweep: rows aligned, widths above the one-block form's
PAIR_SWEEP = list(itertools.product((17, 36, 64), (260, 400, 480, 512),
                                    (1, 700, 20_000)))


def _coverage(plan, B, nvalid):
    """How often each (side, query, candidate) triple is visited by the
    kernel's walk of the plan."""
    gx, gy = plan.grid
    ntiles = -(-nvalid // plan.Ct)
    seen = np.zeros((2, B, nvalid), np.int32)
    if plan.pair:
        for x, y in itertools.product(range(gx), range(gy)):
            for t in range(x, ntiles, gx):
                c = np.arange(t * plan.Ct, min((t + 1) * plan.Ct, nvalid))
                seen[y][:, c] += 1
        return seen
    for y in range(gy):
        q = np.arange(y * plan.Bq, min((y + 1) * plan.Bq, B))
        for x in range(gx):
            for t in range(x, ntiles, gx):
                c = np.arange(t * plan.Ct, min((t + 1) * plan.Ct, nvalid))
                seen[np.ix_([0, 1], q, c)] += 1
    return seen


def _fits(plan, B, Kd, L, nvalid, sms):
    """The plan's shape checks, for either form."""
    assert plan.Bq in K.K4_BQ and plan.stages == K.K4_STAGES
    assert plan.smem_bytes <= K.K4_SMEM_MAX
    gx, gy = plan.grid
    if plan.pair:
        assert plan.smem_bytes == K._k4_pair_smem(Kd)
        assert (plan.Bq, plan.Ct, gy) == (K.K4_PAIR_Q, K.K4_PAIR_TILE, 2)
        assert plan.resident and plan.vec and B <= plan.Bq
        assert 1 <= gx <= -(-nvalid // plan.Ct)     # no CTA without a tile
        assert 2 * gx <= max(sms, 2)                # about one CTA per SM
    else:
        assert plan.smem_bytes == K._k4_smem(plan.Bq, Kd, plan.resident)
        assert plan.vec == (L % 4 == 0 and Kd % 4 == 0)
        assert gy == -(-B // plan.Bq)
        assert 1 <= gx <= -(-nvalid // plan.Ct)     # no CTA without a tile
        assert gx * gy <= max(sms, gy)              # about one CTA per SM
    assert (_coverage(plan, B, nvalid) == 1).all()


@pytest.mark.parametrize("sms", [8, 132])
@pytest.mark.parametrize("B,Kd,nvalid", SWEEP)
def test_plan_covers_every_pair_once_and_fits(B, Kd, nvalid, sms):
    L = Kd + (Kd % 3)
    plan = K._k4_plan(B, Kd, L, nvalid, sms)
    _fits(plan, B, Kd, L, nvalid, sms)


@pytest.mark.parametrize("sms", [7, 8, 132])
@pytest.mark.parametrize("B,Kd,nvalid", PAIR_SWEEP)
def test_pair_plan_covers_every_query_side_candidate_once(B, Kd, nvalid,
                                                          sms):
    """Aligned rows at widths where no resident block holds B=64 (B=36
    from K=388 on): the pair form, each (query, side, candidate) once;
    B=17 keeps a resident block of 48."""
    plan = K._k4_plan(B, Kd, 2 * Kd, nvalid, sms)
    assert plan.pair == (B == 64 or (B == 36 and Kd > 384))
    _fits(plan, B, Kd, 2 * Kd, nvalid, sms)
    ntiles = -(-nvalid // K.K4_PAIR_TILE)
    if plan.pair:   # the tiles spread evenly: every slice the same rounds
        rounds = -(-ntiles // plan.grid[0])
        assert plan.grid[0] == -(-ntiles // rounds)


def _pair_rule(B, Kd, L, aligned):
    """Where the pair form belongs, from the layouts alone: no resident
    block of the one-CTA-a-block form holds all B queries, B is at most
    one side's 64, rows and queries take 16-byte copies, and one side's
    queries fit beside the pair form's ring."""
    kp64 = -(-Kd // 64) * 64
    held = any(bq >= B and 12 * 1024 + (2 * 128 * 68 + 2 * kp64 * bq) * 4
               <= K.K4_SMEM_MAX for bq in (16, 48, 32, 64))
    ct, kc = K.K4_PAIR_TILE, K.K4_PAIR_CHUNK
    kp = -(-Kd // kc) * kc
    fits = K.K4_PAIR_SLOTS * ct * 12 + 2 * 64 * 4 + \
        (2 * ct * (kc + 4) + 64 * kp) * 4 <= K.K4_SMEM_MAX
    return not held and B <= 64 and aligned and Kd % 4 == 0 \
        and L % 4 == 0 and fits


@pytest.mark.parametrize("B", [1, 16, 17, 36, 48, 49, 64, 65, 150, 512])
@pytest.mark.parametrize("aligned", [True, False])
def test_pair_form_exactly_where_the_rule_says(B, aligned):
    for kd in range(2, 1200, 2):
        for L in (kd, kd + 2, 2 * kd):
            plan = K._k4_plan(B, kd, L, 100_000, 132, aligned)
            assert plan.pair == _pair_rule(B, kd, L, aligned), (B, kd, L)


def test_no_pair_form_at_the_repos_narrow_shapes():
    """K <= 256 (the app's d=128 at both models, the multi-process form,
    northstar's eval): the one-CTA-a-block form as before, B <= 64 in one
    resident block, B=512 at K=256 in eight of 64."""
    for kd in (8, 128, 256):
        for nb in range(1, 65):
            plan = K._k4_plan(nb, kd, 2 * kd, 4_594_485, 132)
            assert not plan.pair and plan.resident and plan.grid[1] == 1
    wide = K._k4_plan(512, 256, 512, 4_594_485, 132)
    assert (wide.form, wide.Bq, wide.grid[1]) == ("resident", 64, 8)


@pytest.mark.parametrize("B", [1, 36, 64, 65, 150])
def test_plan_shrinks_the_query_block_as_K_grows(B):
    plans = [K._k4_plan(B, kd, kd, 200_000, 132)
             for kd in range(4, 4096, 4)]
    resident = [p for p in plans if p.resident and not p.pair]
    assert resident and resident[-1].Bq < resident[0].Bq or B <= 16
    assert all(a.Bq >= b.Bq for a, b in zip(resident, resident[1:]))
    # once no block fits resident, no wider K does either
    first_streamed = next(i for i, p in enumerate(plans) if not p.resident)
    assert all(not p.resident for p in plans[first_streamed:])


def test_plan_at_the_apps_shapes():
    """The eval's batches at the chip_smoke shape: 64 queries take one
    block of 64, the tail batch of 36 one block of 48, on one CTA per SM
    with resident queries (ComplEx K=256 and RESCAL K=128). At K=512 (the
    benchmark's ComplEx at GraphVite's width) no resident block holds 64
    queries: the pair form, one CTA a side over half the SMs each, at
    200,000 candidates and at Wikidata5M's 4,594,485."""
    for kd in (256, 128):
        full = K._k4_plan(64, kd, 512, 200_000, 132)
        tail = K._k4_plan(36, kd, 512, 200_000, 132)
        assert (full.Bq, tail.Bq) == (64, 48)
        for p in (full, tail):
            assert p.form == "resident" and p.vec and p.grid[1] == 1
            assert 120 <= p.grid[0] <= 132
    for nvalid in (200_000, 4_594_485):
        for nb in (64, 36):
            p = K._k4_plan(nb, 512, 1024, nvalid, 132)
            assert (p.form, p.Bq, p.Ct, p.grid) == ("pair", 64, 256, (66, 2))
    # rows or queries off 16 bytes: the one-CTA-a-block form, split
    p = K._k4_plan(64, 512, 1024, 200_000, 132, aligned=False)
    assert (p.form, p.Bq, p.grid[1], p.vec) == ("resident", 32, 2, False)


def test_k4_forms_reset_with_the_launches():
    K.K4_FORMS["pair"] += 3
    K.LAUNCHES["pool_eval_counts"] += 3
    K.reset_launches()
    assert set(K.K4_FORMS) == {"resident", "streamed", "pair"}
    assert not any(K.K4_FORMS.values())
    assert "pair" not in K.LAUNCHES and K.LAUNCHES["pool_eval_counts"] == 0
