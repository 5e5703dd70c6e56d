"""APM005 fixture (bad): a view of a pool taken before an in-place
kernel call, read after it as if it held the old rows."""
from adapm_tpu_torch.ops import kernels
from adapm_tpu_torch.ops.kernels import drop_set


def set_and_diff(pool, sh, sl, vals):
    before = pool[0]                  # a view: it sees the set
    drop_set(pool, sh, sl, vals)
    return pool[0] - before           # BAD: read as the old rows


def merge_and_compare(store, sh, sl, vals):
    old = store.main.view(-1, 8)
    kernels.ordered_scatter_add(store.main, sh, sl, vals)
    return old.sum()                  # BAD: `old` holds the new rows
