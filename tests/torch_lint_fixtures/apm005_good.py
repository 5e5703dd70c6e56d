"""APM005 fixture (good): the pool itself read after the call (it holds
the new rows, as meant), a clone taken before the call, a gathered copy
(an index that is not a slice), a view bound again after the call, and
a view of an argument the call does not update."""
from adapm_tpu_torch.ops.kernels import drop_set, ordered_scatter_add


def set_and_read(pool, sh, sl, vals):
    drop_set(pool, sh, sl, vals)
    return pool[0].sum()


def set_and_diff(pool, sh, sl, vals):
    before = pool[0].clone()
    drop_set(pool, sh, sl, vals)
    return pool[0] - before


def gathered(pool, sh, sl, vals, idx):
    rows = pool[idx]
    ordered_scatter_add(pool, sh, sl, vals)
    return rows


def rebound(pool, sh, sl, vals):
    head = pool[0]
    drop_set(pool, sh, sl, vals)
    head = pool[0]
    return head


def other_argument(pool, sh, sl, vals):
    v = vals[0]
    drop_set(pool, sh, sl, vals)
    return v
