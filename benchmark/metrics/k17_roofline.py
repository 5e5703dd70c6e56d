"""k17_roofline.<kind of cell>: K17's bound (costs/k17: the square roots
on the special-function unit at the cell's shape) over its device time a
launch in the trace, in %. Nothing where the run made no K17 cost, the
trace lost records, or it holds no K17 record (a program without K17)."""
from benchmark.costs import k17
from benchmark.trace import kernel_s


def read(run):
    rec, cost = run.trace, getattr(run, "k17_cost", None)
    if rec is None or rec["lost"] or cost is None:
        return None
    n, t = kernel_s(rec, "pool_eval_dist_kernel")
    if not n or t <= 0:
        return None
    return 100.0 * k17.bound_s(*cost)[0] / (t / n)
