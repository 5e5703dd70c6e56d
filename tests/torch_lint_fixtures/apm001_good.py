"""APM001 fixture (good, the port's form): every launch under the gate
(bare and combined with-items, the dispatch_gate() call form), a wrapper
composing another inside its own body, and method calls through the
port, which are not wrapper calls."""
from adapm_tpu_torch.exec import dispatch_gate
from adapm_tpu_torch.ops import kernels
from adapm_tpu_torch.ops.kernels import drop_set, routed_gather

_GATE = dispatch_gate()


def install(store, sh, sl, vals):
    with _GATE:
        drop_set(store.main, sh, sl, vals)


def install_tracked(store, srv, sh, sl, vals):
    with srv.exec.track("tier"), _GATE:
        drop_set(store.main, sh, sl, vals)


def sync_call_form(store, r, o):
    with dispatch_gate():
        kernels.sync_round(store.main, store.cache, store.delta, *r, *o)


def fill_gather(pool, sh, sl):
    # a site's own body: it runs under its caller's gate
    return routed_gather(pool, None, None, sh, sl)


def through_the_port(store, *a):
    return store.port.gather(store.main, store.cache, store.delta, *a)
