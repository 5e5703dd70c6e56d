"""K17 (csrc/pool_eval_dist.cu): for B queries, both sides, the distance
sum_i |q_i - e_i| over the d complex components of each of E candidate
rows, a compare and a count. A component takes 6 f32 operations (two
subtractions, a square, a multiply-add as 2, an add) and one square root
on the special-function unit. Reads each candidate's 2d floats, its key
and its owner and slot once, the 2 x B query rows once; per query the
true distance and both side keys in, two counts out.

The SFU's peak is not among peaks.py's: 16 results a clock an SM (CUDA
C++ Programming Guide, arithmetic instruction throughput, compute
capability 9.0) on the H100 SXM's 132 SMs at its 1.98 GHz boost clock."""
from .peaks import F32_FLOPS, HBM_BYTES_PER_S

SFU_PER_S = 132 * 16 * 1.98e9


def cost(B: int, E: int, K: int) -> tuple:
    """(f32 operations, square roots, bytes) of one launch at row width
    K = 2d."""
    n = 2 * B * E * (K // 2)
    return 6 * n, n, E * K * 4 + E * 12 + 2 * B * K * 4 + B * 20


def bound_s(flops: float, roots: float, nbytes: float) -> tuple:
    """(the least seconds the card needs, "operations", "roots" or
    "bytes": the bound that decides)."""
    return max((flops / F32_FLOPS, "operations"), (roots / SFU_PER_S, "roots"),
               (nbytes / HBM_BYTES_PER_S, "bytes"))
