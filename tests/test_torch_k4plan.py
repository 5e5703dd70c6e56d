"""K4's launch plan (ops/kernels.py _k4_plan), which runs here on the CPU.

Over a sweep of batch sizes, widths, row lengths, candidate counts and
SM counts, the plan's grid and query blocks, walked the way the kernel
walks them (CTA (x, y) takes candidate tiles x, x + gx, ... of 128 rows
and queries y*Bq .. y*Bq + Bq - 1), must cover every (query, candidate)
pair exactly once; its shared memory must fit one H100 CTA and equal the
kernel's layout; and a wider K must never take a larger resident query
block."""
import itertools

import numpy as np
import pytest

from adapm_tpu_torch.ops import kernels as K

SWEEP = list(itertools.product((1, 36, 64, 65, 150), (7, 256, 512, 2048),
                               (1, 700, 20_000)))


def _coverage(plan, B, nvalid):
    """How often each (query, candidate) pair is visited by the kernel's
    walk of the plan."""
    gx, gy = plan.grid
    ntiles = -(-nvalid // plan.Ct)
    seen = np.zeros((B, nvalid), np.int32)
    for y in range(gy):
        q = np.arange(y * plan.Bq, min((y + 1) * plan.Bq, B))
        for x in range(gx):
            for t in range(x, ntiles, gx):
                c = np.arange(t * plan.Ct, min((t + 1) * plan.Ct, nvalid))
                seen[np.ix_(q, c)] += 1
    return seen


@pytest.mark.parametrize("sms", [8, 132])
@pytest.mark.parametrize("B,Kd,nvalid", SWEEP)
def test_plan_covers_every_pair_once_and_fits(B, Kd, nvalid, sms):
    L = Kd + (Kd % 3)
    plan = K._k4_plan(B, Kd, L, nvalid, sms)
    assert plan.Bq in K.K4_BQ and plan.stages == K.K4_STAGES
    assert plan.smem_bytes == K._k4_smem(plan.Bq, Kd, plan.resident)
    assert plan.smem_bytes <= K.K4_SMEM_MAX
    assert plan.vec == (L % 4 == 0 and Kd % 4 == 0)
    gx, gy = plan.grid
    assert gy == -(-B // plan.Bq)
    assert 1 <= gx <= -(-nvalid // plan.Ct)         # no CTA without a tile
    assert gx * gy <= max(sms, gy)                  # about one CTA per SM
    assert (_coverage(plan, B, nvalid) == 1).all()


@pytest.mark.parametrize("B", [1, 36, 64, 65, 150])
def test_plan_shrinks_the_query_block_as_K_grows(B):
    plans = [K._k4_plan(B, kd, kd, 200_000, 132)
             for kd in range(4, 4096, 4)]
    resident = [p for p in plans if p.resident]
    assert resident and resident[-1].Bq < resident[0].Bq or B <= 16
    assert all(a.Bq >= b.Bq for a, b in zip(resident, resident[1:]))
    # once no block fits resident, no wider K does either
    first_streamed = next(i for i, p in enumerate(plans) if not p.resident)
    assert all(not p.resident for p in plans[first_streamed:])


def test_plan_at_the_apps_shapes():
    """The eval's batches at the chip_smoke shape: 64 queries take one
    block of 64, the tail batch of 36 one block of 48, on one CTA per SM
    with resident queries (ComplEx K=256 and RESCAL K=128)."""
    for kd in (256, 128):
        full = K._k4_plan(64, kd, 512, 200_000, 132)
        tail = K._k4_plan(36, kd, 512, 200_000, 132)
        assert (full.Bq, tail.Bq) == (64, 48)
        for p in (full, tail):
            assert p.resident and p.vec and p.grid[1] == 1
            assert 120 <= p.grid[0] <= 132
    assert K._k4_plan(64, 512, 512, 200_000, 132).Bq == 32
