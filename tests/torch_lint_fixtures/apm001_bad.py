"""APM001 fixture (bad, the port's form): a kernel wrapper that writes a
pool launched outside the dispatch gate."""
from adapm_tpu_torch.exec import dispatch_gate
from adapm_tpu_torch.ops import kernels
from adapm_tpu_torch.ops.kernels import drop_set

_GATE = dispatch_gate()


def install(store, sh, sl, vals):
    drop_set(store.main, sh, sl, vals)  # BAD: no gate


def sync(store, r, o):
    with _GATE:
        pass
    kernels.sync_round(store.main, store.cache, store.delta, *r, *o)  # BAD
