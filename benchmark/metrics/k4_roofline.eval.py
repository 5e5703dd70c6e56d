"""k4_roofline.eval: K4's operations bound (costs/k4) over its device
time a launch in the trace, in %. Nothing where the trace lost
records."""
from benchmark import costs
from benchmark.trace import kernel_s


def read(run):
    rec = run.trace
    if rec is None or rec["lost"]:
        return None
    n, t = kernel_s(rec, "pool_eval_counts_kernel")
    if not n or t <= 0:
        return None
    return 100.0 * costs.bound_s(*run.k4_cost)[0] / (t / n)
