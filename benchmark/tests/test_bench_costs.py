"""The cost functions at small shapes against counts made by hand."""
import pytest

from benchmark import costs
from benchmark.costs import peaks


def test_k4_hand_count():
    # B=2 queries, E=3 candidates, K=4: 2 sides x 2 x 3 dots of 4
    # multiply-adds = 96 operations; bytes: 3 rows of 16, 3 keys, 2 x 2
    # query rows of 16, 2 x (true score, 2 keys, 1 count... ) 16 a query
    flops, nbytes = costs.load("k4").cost(2, 3, 4)
    assert flops == 2 * 2 * 2 * 3 * 4
    assert nbytes == 3 * 16 + 3 * 4 + 2 * 2 * 16 + 2 * 16


@pytest.mark.parametrize("flops,nbytes,which", [
    (67e12, 1.0, "operations"), (1.0, 3.35e12, "bytes")])
def test_bound_takes_the_larger(flops, nbytes, which):
    t, by = costs.bound_s(flops, nbytes)
    assert by == which and t == pytest.approx(1.0)
    assert peaks.F32_FLOPS == 67e12 and peaks.HBM_BYTES_PER_S == 3.35e12
