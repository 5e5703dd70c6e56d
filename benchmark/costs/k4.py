"""K4 (csrc/pool_eval_counts.cu): for B queries, both sides, one K-float
dot product with every one of E candidate rows (2 operations a
multiply-add), a compare and a count. Reads each candidate's K floats
and its key once, the 2 x B query rows once."""


def cost(B: int, E: int, K: int) -> tuple:
    """(flops, bytes)"""
    return 2 * 2 * B * E * K, E * K * 4 + E * 4 + 2 * B * K * 4 + B * 16
