"""The fused training steps: the port's hot path.

Every reference app's inner loop is the same triad: Pull a handful of rows,
run a small dense compute + AdaGrad, Push additive updates (mf/update.h:32-70,
word2vec.cc:718-743, kge.cc:415-530). Here the triad over a *batch* of data
points is one step on the device:

    route -> gather rows (K1) -> model loss, gradient and AdaGrad
    transform -> ordered scatter-add (K3)

Updates remain additive deltas, so the parameter-manager semantics hold
(pushes merge at the main copy; replica writes land in the delta pool and
flow back through sync rounds): the step is a batched Push in PM terms.
Value rows are [emb (D) | adagrad acc (D)]
(matrix_factorization.cc:695-697). The roles of one length class share
their launches: one K1 gathers them all, the model math writes each
trainable role's delta rows into one update buffer, one K3 per pool
(main, then delta) adds it.

The loss chooses the model math, on both routing modes: a loss with a
fused form (`loss_fn.fused_update`: a ComplEx KgeLoss in models/kge.py
runs the hand-written kernel K5, models/sgns.py SgnsLoss K6,
models/mf.py MfLoss K7: loss, gradient and AdaGrad rows in one launch)
runs it; any other loss (RESCAL, a caller's own) runs as PyTorch
autograd, then K2 per trainable role.
Both read lr and eps from one 2-float device tensor, so a captured
graph follows them. On the CPU both take the kernels' plain versions.

Two routing modes, as in the JAX package's `ops/fused.py`:
  host routes (build_routes, FusedStepRunner): the host resolves every
      key through the Addressbook and ships five index tensors per role.
  device routes (DeviceRouter, DeviceRoutedRunner): mirrors of the
      Addressbook tables (owner, slot, this shard's cache slot) live on
      the device, re-uploaded when the planner changes placement
      (topology_version); per step the host ships only raw keys.
      Negatives for `neg_role` are drawn on the device from a
      `torch.Generator` seeded with the runner's `seed`: uniformly from
      the locally-resident keys (the Local sampling scheme), or from an
      alias table (`neg_alias`) snapped to the nearest locally-resident
      key.

The device-routed runner has both variants (with replicas, and the
replica-free main-only variant), and `run_scan`: K steps per dispatch
with placement frozen for the window (make_device_routed_scan). On the
CPU it is a plain loop over the step; on the card the window is a
captured CUDA graph, replayed per window (DeviceRoutedRunner.run_scan
says what it captures and when it captures again).

With the prefetch pipeline on (SystemOptions.prefetch, core/intent.py)
the runner registers its mirror refresh with the pipeline, which runs it
after delegated planner rounds, and `prefetch_keys` uploads a future
step's keys ahead of its dispatch (`StagedKeys`, the `staged=` argument
of `__call__`). Every fused step notes its writes with the pipeline, so
staged pull buffers of trained keys are dropped.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.store import OOB, bucket_size
from ..exec import dispatch_gate
from . import kernels
from .kernels import (adagrad_update, ordered_scatter_add_segments,
                      routed_gather, routed_gather_segments)

_GATE = dispatch_gate()


def _key_dtype(num_keys: int):
    """Key-upload dtype: int32 while every key fits."""
    return np.int32 if num_keys <= 2**31 else np.int64


@contextlib.contextmanager
def _step_lock(server, shard: int, role_keys):
    """Hold the server lock for a step with every key of `role_keys`
    servable on `shard`. One process: just the lock. Multi-process: the
    keys are localized first, OUTSIDE the lock (Server.ensure_local makes
    round trips, and a peer's handler may need this lock to serve them),
    then the lock is taken and the placement checked; a key a peer's
    intent relocated away in between is localized again. A step (or a
    captured run_scan window) therefore never routes to a REMOTE slot."""
    if server.glob is None:
        with server._lock:
            yield
        return
    keys = np.unique(np.concatenate(
        [np.asarray(k, dtype=np.int64).ravel()
         for k in role_keys.values()]))
    for _ in range(50):
        server.ensure_local(keys, shard)
        server._lock.acquire()
        if server.all_local(keys, shard):
            break
        server._lock.release()
    else:
        raise RuntimeError(f"{len(keys)} step keys could not be held "
                           f"local on shard {shard}")
    try:
        yield
    finally:
        server._lock.release()


def _window_keys(batches, roles) -> Dict[str, np.ndarray]:
    """Role -> the keys of every batch of a window, joined."""
    return {r: np.concatenate([np.asarray(b[r], np.int64).ravel()
                               for b in batches]) for r in roles}


def _mark_fused_writes(server, shard: int, role_class, role_keys,
                       skip_roles=(), sampled: bool = False) -> None:
    """A fused step is a batched Push (caller holds the server lock).
    Dirty-delta write tracking for its host-known roles: resolve each
    role's keys through the addressbook — the tables the step routes
    with — and record the scatter in the stores' write epochs, or the
    planner would skip shipping the trained replicas. And the prefetch
    pipeline drops the staged pull buffers the step writes: those of
    every role's keys, frozen ones too as in the JAX package, or all of
    them when the step draws negatives on the device (`sampled`)."""
    if server.prefetch is not None:
        server.prefetch.note_step_writes(role_keys.values(), sampled)
    ab = server.ab
    for r, keys in role_keys.items():
        if r in skip_roles:
            continue
        k = np.asarray(keys, dtype=np.int64).ravel()
        server.stores[role_class[r]].mark_routed_writes(
            shard, ab.cache_slot[shard, k], ab.owner[k], ab.slot[k])


class Routes:
    """Device index tensors routing one role's key batch to pool rows.

    gather:  main[g_sh, g_sl] for owner-served keys, (cache+delta)[c_sh, c_sl]
             for replica-served keys (use_c mask).
    scatter: the owner path drops replica positions (g_sl is OOB there),
             the delta path drops owner positions (c_sl is OOB there),
             mirroring Server._push.
    """

    __slots__ = ("g_sh", "g_sl", "c_sh", "c_sl", "use_c", "n_remote")

    def __init__(self, g_sh, g_sl, c_sh, c_sl, use_c, n_remote: int):
        self.g_sh, self.g_sl = g_sh, g_sl
        self.c_sh, self.c_sl = c_sh, c_sl
        self.use_c = use_c
        self.n_remote = n_remote

    def as_tuple(self):
        return (self.g_sh, self.g_sl, self.c_sh, self.c_sl, self.use_c)


def build_routes(server, keys: np.ndarray, shard: int,
                 expect_class: int = None) -> Routes:
    """Resolve keys (any shape) to pool coordinates for a worker on `shard`,
    via the one shared routing policy (Server._route: prefer a local replica,
    else the owner row). All keys must share a length class; pass
    `expect_class` to fail fast on a wrong role->class mapping (slots are
    per-class row indices, so a mismatch would corrupt another pool's rows).
    """
    keys = np.asarray(keys, dtype=np.int64)
    if expect_class is not None:
        kc = server.ab.key_class[keys]
        if not (kc == expect_class).all():
            raise ValueError(f"keys span length classes {np.unique(kc)} but "
                             f"role is mapped to class {expect_class}")
    server.ensure_local(keys, shard)
    o_sh, o_sl, c_sh, c_sl, use_c, n_remote, _ = server._route(keys, shard)
    g_sl = np.where(use_c, OOB, o_sl).astype(np.int32)
    if server.tier is not None:
        # tiered storage: the step indexes the DEVICE hot pool, so every
        # owner-served key must be hot before dispatch. The runners pin
        # their whole batch as one union first (pin_step_keys); the
        # forced ensure here only runs for rows still cold (direct
        # build_routes callers that skipped the union pin)
        cid = expect_class if expect_class is not None else \
            int(server.ab.key_class[keys.ravel()[0]])
        res = server.stores[cid].res
        slot_flat = g_sl.ravel()            # slots; OOB where replica-served
        o_flat = np.asarray(o_sh).ravel()
        m = slot_flat != OOB
        row = slot_flat.copy()
        row[m] = res.dev_row[o_flat[m], slot_flat[m]]
        if (row[m] < 0).any():
            server.tier.ensure_hot(cid, o_flat[m], slot_flat[m],
                                   pin_end=server.tier.step_pin_end(),
                                   force=True)
            row[m] = res.dev_row[o_flat[m], slot_flat[m]]
        g_sl = np.where(row < 0, OOB, row).reshape(
            g_sl.shape).astype(np.int32)
    put = server.ctx.put_replicated
    return Routes(put(o_sh), put(g_sl), put(c_sh), put(c_sl), put(use_c),
                  n_remote)


def _class_roles(role_class: Dict[str, int],
                 roles: Sequence[str]) -> Dict[int, list]:
    """Class -> its roles among `roles`, each list in sorted() order: the
    order of the role segments in one class's gather and scatter."""
    out: Dict[int, list] = {}
    for r in sorted(roles):
        out.setdefault(role_class[r], []).append(r)
    return out


def _spans(roles, shapes) -> Dict[str, tuple]:
    """Role -> (row offset, row count) of each role's rows in one class's
    [sum n, L] buffer, segment after segment."""
    spans, off = {}, 0
    for r in roles:
        n = int(np.prod(shapes[r], dtype=np.int64))
        spans[r] = (off, n)
        off += n
    return spans


def _role_views(flat, spans, shapes) -> Dict[str, torch.Tensor]:
    """Each role's rows as a view of the class buffer, shaped like the
    role's keys plus the row length."""
    return {r: flat[o:o + n].reshape(tuple(shapes[r]) + (flat.shape[-1],))
            for r, (o, n) in spans.items()}


def _update_buffers(rows, train_classes):
    """Per class, one [sum n, L] buffer for its trainable roles' delta
    rows (sorted() role order), and each role's row slice of it."""
    bufs, slices = {}, {}
    for c, rs in train_classes.items():
        L = rows[rs[0]].shape[-1]
        n = [rows[r].numel() // L for r in rs]
        buf = torch.empty((sum(n), L), dtype=rows[rs[0]].dtype,
                          device=rows[rs[0]].device)
        off = 0
        for r, k in zip(rs, n):
            slices[r] = buf[off:off + k]
            off += k
        bufs[c] = buf
    return bufs, slices


def _loss_and_updates(loss_fn, rows, role_dim, roles, train_classes, aux,
                      lr_eps):
    """Loss over the gathered rows and, per class, one [sum n, 2D] buffer
    of its trainable roles' AdaGrad delta rows; `lr_eps` is (lr, eps) as
    a 2-float tensor on the rows' device. A loss with a fused form runs
    it (`loss_fn.fused_update(rows, slices, lr_eps, aux)`: K5 for
    ComplEx, K6 for SGNS, K7 for MF) where its `fused_fits(rows)`, if it
    has one, accepts the rows' shapes; any other as autograd, each role's
    embedding half its own leaf (a duplicated key gets one gradient per
    occurrence), then K2 per trainable role."""
    bufs, slices = _update_buffers(rows, train_classes)
    fused_update = getattr(loss_fn, "fused_update", None)
    fits = getattr(loss_fn, "fused_fits", None)
    if fused_update is not None and (fits is None or fits(rows)):
        for r in roles:
            _require_row(rows[r], role_dim[r])
        return fused_update(rows, slices, lr_eps, aux), bufs
    trainable = [r for rs in train_classes.values() for r in rs]
    embs = {r: rows[r][..., : role_dim[r]] for r in roles}
    leaves = {r: embs[r].detach().requires_grad_() for r in trainable}
    with torch.enable_grad():
        merged = dict(embs)
        merged.update(leaves)
        loss = loss_fn(merged, aux)
        grads = dict(zip(trainable, torch.autograd.grad(
            loss, [leaves[r] for r in trainable])))
    for r in trainable:
        D = role_dim[r]
        adagrad_update(grads[r].reshape(-1, D).contiguous(),
                       rows[r].reshape(-1, rows[r].shape[-1])[:, D:],
                       out=slices[r], lr_eps=lr_eps)
    return loss.detach(), bufs


def _require_row(rows, dim: int) -> None:
    if rows.shape[-1] != 2 * dim:
        raise ValueError(f"value rows of {rows.shape[-1]} floats, expected "
                         f"[emb {dim} | acc {dim}]")


def make_fused_adagrad_step(loss_fn: Callable[..., torch.Tensor],
                            role_class: Dict[str, int],
                            role_dim: Dict[str, int],
                            frozen_roles: Sequence[str] = ()):
    """The host-routed fused step:

        step(pools, routes, aux, lr_eps) -> loss

      pools   tuple per class of (main, cache, delta), UPDATED IN PLACE
      routes  dict role -> Routes.as_tuple()
      aux     handed to loss_fn (labels, weights)
      lr_eps  (lr, eps) as a 2-float tensor on the pools' device

    loss_fn(embs: dict role -> [..., D_role] tensor, aux) is the scalar
    mean loss; role rows are [emb | acc] of length 2*D; frozen roles are
    gathered for the forward pass and never updated. Every role is
    gathered before the first scatter. Per class, one K1 launch gathers
    all its roles (segments in sorted() role order); one K3 launch adds
    its trainable roles' updates into main (the owner path: g_sl is OOB
    at replica positions), then one into delta (the replica path: c_sl
    is OOB at owner positions). Main and delta are distinct tensors, so
    this equals the per-role main-then-delta order bit for bit."""
    roles = sorted(role_class)
    classes = _class_roles(role_class, roles)
    train_classes = _class_roles(
        role_class, [r for r in roles if r not in frozen_roles])

    def step(pools, routes, aux, lr_eps):
        shapes = {r: tuple(routes[r][0].shape) for r in roles}
        flat_routes = {r: tuple(t.reshape(-1) for t in routes[r])
                       for r in roles}
        rows = {}
        for c, rs in classes.items():
            main, cache, delta = pools[c]
            flat = routed_gather_segments(main, cache, delta,
                                          [flat_routes[r] for r in rs])
            rows.update(_role_views(flat, _spans(rs, shapes), shapes))
        loss, upds = _loss_and_updates(loss_fn, rows, role_dim, roles,
                                       train_classes, aux, lr_eps)
        for c, rs in train_classes.items():
            main, _, delta = pools[c]
            fr = [flat_routes[r] for r in rs]
            ordered_scatter_add_segments(main, [t[:2] for t in fr], upds[c])
            ordered_scatter_add_segments(delta, [t[2:4] for t in fr],
                                         upds[c])
        return loss

    return step


class DeviceRouter:
    """Device mirrors of the Addressbook tables for one worker shard,
    refreshed lazily on placement changes: keyed on (topology_version,
    the tier's residency epoch). On a tiered server the slot mirror
    carries hot-pool ROWS (TierManager.compose_slot_table; OOB while
    cold) — the step indexes the device hot pool, and the runners pin
    their batches hot before reading the mirror.

    A refresh after the first upload copies the tables into the same
    tensors (stream-ordered after the steps already enqueued, under the
    dispatch gate), so their addresses never change: a captured
    run_scan graph reads the mirrors by address and stays valid across
    refreshes, whether the training thread or the prefetch pipeline
    ran them."""

    def __init__(self, server, shard: int):
        self.server = server
        self.shard = shard
        self._version = None
        self.owner = None      # [num_keys] int32
        self.slot = None       # [num_keys] int32
        self.cache_row = None  # [num_keys] int32 (this shard's replica slots)

    def refresh(self):
        srv = self.server
        ver = (srv.topology_version,
               srv.tier.epoch if srv.tier is not None else -1)
        if self._version == ver and self.owner is not None:
            return
        ab = srv.ab
        slot = ab.slot if srv.tier is None else \
            srv.tier.compose_slot_table()
        host = (ab.owner, slot, ab.cache_slot[self.shard])
        with _GATE:
            if self.owner is None:
                put = srv.ctx.put_replicated
                self.owner, self.slot, self.cache_row = \
                    (put(np.ascontiguousarray(h)) for h in host)
            else:
                for t, h in zip((self.owner, self.slot, self.cache_row),
                                host):
                    t.copy_(torch.from_numpy(np.ascontiguousarray(h)))
        self._version = ver

    def tables(self):
        self.refresh()
        return self.owner, self.slot, self.cache_row


def _route_on_device(tables, keys: torch.Tensor, shard: int):
    """Route resolution on the device: the twin of Server._route. `keys`
    is a flat int tensor; returns int32 (o_sh, g_sl, c_sh, c_sl) and the
    bool use_c mask, each [n]."""
    owner, slot, cache_row = tables
    o_sh = owner.index_select(0, keys)
    cs = cache_row.index_select(0, keys)
    use_c = cs >= 0
    oob = torch.full_like(cs, int(OOB))
    g_sl = torch.where(use_c, oob, slot.index_select(0, keys))
    c_sh = torch.full_like(o_sh, shard)
    c_sl = torch.where(use_c, cs, oob)
    return o_sh, g_sl, c_sh, c_sl, use_c


def _draw_negatives(neg_shape, local_index, alias, generator):
    """The device draw of a negative role's keys. Uniform: positions into
    the local index (the Local sampling scheme). Alias (`alias` = prob,
    alias, key table): a Vose draw over the app's population, then each
    candidate SNAPS to the nearest locally-resident key by searchsorted
    (the device twin of LocalSampling._snap); the padded index is sorted
    with a dtype-max tail, so the probe lands in [0, count] and wraps
    (sampling.h:494)."""
    if alias is not None:
        prob, alias_t, key_table = alias
        u = torch.randint(0, prob.shape[0], neg_shape, generator=generator,
                          device=prob.device)
        v = torch.rand(neg_shape, generator=generator, device=prob.device)
        cand = key_table[torch.where(v < prob[u], u, alias_t[u].long())]
        if local_index is not None:
            idx, count = local_index
            pos = torch.searchsorted(idx, cand)
            pos = torch.where(pos >= count, torch.zeros_like(pos), pos)
            cand = idx[pos]
        return cand
    idx, count = local_index
    pos = torch.randint(0, count, neg_shape, generator=generator,
                        device=idx.device)
    return idx.index_select(0, pos.reshape(-1)).reshape(neg_shape)


def make_device_routed_step(loss_fn: Callable[..., torch.Tensor],
                            role_class: Dict[str, int],
                            role_dim: Dict[str, int],
                            shard: int,
                            frozen_roles: Sequence[str] = (),
                            neg_role: str = None,
                            neg_shape: Tuple[int, ...] = None,
                            no_replicas: bool = False,
                            neg_alias: bool = False):
    """The fused step that resolves routing from device table mirrors:

        step(pools, locstat, tables, keys, local_index, alias, generator,
             aux, lr_eps) -> loss

      pools       tuple per class of (main, cache, delta), UPDATED IN PLACE
      locstat     int64 [4] device accumulator (params seen / params local /
                  steps / all-local steps), updated in place
      tables      (owner, slot, cache_row) device mirrors
      keys        dict role -> device int tensor of raw PM keys
      local_index (padded index tensor, valid count) of locally-resident
                  keys for the device draw of `neg_role`, or None
      alias       (prob, alias, key table) device tensors when
                  `neg_alias` (models/sgns.py build_alias_table), else None
      generator   torch.Generator on the pools' device
      lr_eps      (lr, eps) as a 2-float tensor on the pools' device

    `neg_role`'s keys are drawn on the device unless `keys` already holds
    them (run_scan on the card draws them before its graph replays).
    Per class, the roles' keys are joined in sorted() role order, routed
    once and gathered by one K1 launch; every class is gathered before
    the first scatter. Each role's rows are its own autograd leaf (a
    duplicated key gets one gradient per occurrence, and the AdaGrad
    updates fold additively in batch order). Per class, one K3 launch
    adds the trainable roles' updates into main, then (replica variant)
    one into delta: the per-role main-then-delta order, bit for bit,
    since main and delta are distinct tensors. Frozen roles are gathered
    and never scattered.
    `no_replicas=True` is the replica-free variant: reads touch only the
    main pool and updates scatter only into main — legal exactly while the
    shard holds no replicas (the runner re-checks per step)."""
    roles = sorted(role_class)
    classes = _class_roles(role_class, roles)
    train_classes = _class_roles(
        role_class, [r for r in roles if r not in frozen_roles])

    def step(pools, locstat, tables, keys, local_index, alias, generator,
             aux, lr_eps):
        keys = dict(keys)
        if neg_role is not None and neg_role not in keys and (
                neg_alias or local_index is not None):
            keys[neg_role] = _draw_negatives(
                neg_shape, local_index, alias if neg_alias else None,
                generator)
        shapes = {r: tuple(keys[r].shape) for r in roles}
        rows, routes, spans = {}, {}, {}
        n_total = 0
        n_local = torch.zeros((), dtype=torch.int64,
                              device=locstat.device)
        for c, rs in classes.items():
            main, cache, delta = pools[c]
            k = torch.cat([keys[r].reshape(-1) for r in rs]) \
                if len(rs) > 1 else keys[rs[0]].reshape(-1)
            n_total += k.numel()
            if no_replicas:
                owner, slot, _ = tables
                o_sh, o_sl = owner.index_select(0, k), slot.index_select(0, k)
                routes[c] = (o_sh, o_sl)
                flat = routed_gather(main, None, None, o_sh, o_sl)
                n_local += (o_sh == shard).sum()
            else:
                routes[c] = _route_on_device(tables, k, shard)
                flat = routed_gather(main, cache, delta, *routes[c])
                o_sh, use_c = routes[c][0], routes[c][4]
                n_local += (use_c | (o_sh == shard)).sum()
            spans[c] = _spans(rs, shapes)
            rows.update(_role_views(flat, spans[c], shapes))
        # one step = one batched pull + one push of the same keys; the op
        # counts local iff every key it touched was local (fills, not
        # host copies: the step runs inside a captured graph too)
        locstat += torch.stack([
            torch.full_like(n_local, n_total), n_local,
            torch.ones_like(n_local), (n_local == n_total).to(torch.int64)])
        loss, upds = _loss_and_updates(loss_fn, rows, role_dim, roles,
                                       train_classes, aux, lr_eps)
        for c, rs in train_classes.items():
            main, _, delta = pools[c]
            rt = routes[c]
            if rs == classes[c]:         # every role trains: one segment
                parts = [slice(None)]
            else:
                parts = [slice(o, o + n) for o, n in
                         (spans[c][r] for r in rs)]
            ordered_scatter_add_segments(
                main, [(rt[0][p], rt[1][p]) for p in parts], upds[c])
            if not no_replicas:
                ordered_scatter_add_segments(
                    delta, [(rt[2][p], rt[3][p]) for p in parts], upds[c])
        return loss

    return step


def make_device_routed_scan(loss_fn: Callable[..., torch.Tensor],
                            role_class: Dict[str, int],
                            role_dim: Dict[str, int],
                            shard: int,
                            frozen_roles: Sequence[str] = (),
                            neg_role: str = None,
                            neg_shape: Tuple[int, ...] = None,
                            no_replicas: bool = False,
                            neg_alias: bool = False):
    """K device-routed steps over stacked batches (the JAX package's
    lax.scan window):

        scan(pools, locstat, tables, keys, local_index, alias, generator,
             auxes, lr_eps) -> losses [K]

      keys   dict role -> [K, ...] device int tensor (step k reads [k])
      auxes  K per-step aux values (a list, or a [K, ...] tensor), or None

    Placement is frozen for the window: every step routes with the same
    tables, and negatives are drawn from the generator step after step,
    in the order K sequential steps draw them. The other arguments are
    the step's (make_device_routed_step)."""
    step = make_device_routed_step(loss_fn, role_class, role_dim, shard,
                                   frozen_roles, neg_role, neg_shape,
                                   no_replicas, neg_alias)

    def scan(pools, locstat, tables, keys, local_index, alias, generator,
             auxes, lr_eps):
        K = next(iter(keys.values())).shape[0]
        return torch.stack([
            step(pools, locstat, tables, {r: t[k] for r, t in keys.items()},
                 local_index, alias, generator,
                 None if auxes is None else auxes[k], lr_eps)
            for k in range(K)])

    return scan


class _LrEps:
    """(lr, eps) as a 2-float tensor on the runner's device, refilled in
    place (two fills, no host copy) only when they change: K5 and K2
    read it, and a captured graph follows it from replay to replay."""

    def __init__(self, device):
        self.t = torch.zeros(2, dtype=torch.float32, device=device)
        self.val = None

    def __call__(self, lr: float, eps: float) -> torch.Tensor:
        v = (float(lr), float(eps))
        if v != self.val:
            self.t[0].fill_(v[0])
            self.t[1].fill_(v[1])
            self.val = v
        return self.t


class StagedKeys:
    """A step's key batch pre-staged on the device
    (DeviceRoutedRunner.prefetch_keys): the host-to-device upload ran at
    prepare/intent time instead of inside the dispatch. Valid across
    topology changes — these are raw keys, not routes.

    On the card the keys are copied from the runner's ring of pinned
    host buffers (_PinnedRing) with `non_blocking=True`, so the upload
    is queued on the stream and the host does not wait for it (a
    pageable source would make it synchronous). `dev` maps each role to
    a view of one joined device tensor, as the step's own upload does.
    `host` holds the keys prefetch_keys checked: a batch that `matches`
    them passes the step's checks too."""

    __slots__ = ("host", "dev")

    def __init__(self, host: Dict[str, np.ndarray],
                 dev: Dict[str, torch.Tensor]):
        self.host = host
        self.dev = dev

    def matches(self, role_keys: Dict[str, np.ndarray]) -> bool:
        """The same roles and the same keys by value (compared in their
        own dtypes, so no key wraps around into another)."""
        if set(self.host) != set(role_keys):
            return False
        return all(np.array_equal(self.host[r], np.asarray(k))
                   for r, k in role_keys.items())


class _PinnedRing:
    """Pinned host buffers for StagedKeys' uploads, used in turn. A slot
    is refilled only after the event recorded behind its last copy has
    passed, which is long before in practice: the ring is SLOTS uploads
    deep. Callers hold the dispatch gate."""

    SLOTS = 8

    def __init__(self, slots: int = SLOTS):
        self.bufs = [None] * slots
        self.events = [None] * slots
        self.next = 0

    def upload(self, arrs, device) -> torch.Tensor:
        """The flattened arrays (of one dtype), joined, on `device`."""
        dtype = torch.from_numpy(arrs[0][:0]).dtype
        i = self.next
        self.next = (i + 1) % len(self.bufs)
        if self.events[i] is None:
            self.events[i] = torch.cuda.Event()
        else:
            self.events[i].synchronize()
        n = sum(a.size for a in arrs)
        buf = self.bufs[i]
        if buf is None or buf.numel() < n or buf.dtype != dtype:
            buf = self.bufs[i] = torch.empty(bucket_size(n), dtype=dtype,
                                             pin_memory=True)
        view = buf[:n]
        np.concatenate([a.reshape(-1) for a in arrs], out=view.numpy())
        out = view.to(device, non_blocking=True)
        self.events[i].record()
        return out


class _ScanGraph:
    """One captured run_scan window: the CUDA graph, its static inputs
    (the window's keys, aux) and output (the [K] losses), the addresses
    of the tensors it reads and writes in place, and the kernel launches
    of one replay."""

    __slots__ = ("graph", "keys", "joined", "aux", "losses", "ptrs",
                 "launches")

    def __init__(self, keys, joined, aux):
        self.graph = None
        self.keys, self.joined, self.aux = keys, joined, aux
        self.losses = None
        self.ptrs = None
        self.launches = None


class DeviceRoutedRunner:
    """Binds the device-routed step to a Server. Per step the host ships
    only the raw key batch; table mirrors refresh lazily when the planner
    moves parameters. Locality is recorded by a 4-counter device
    accumulator read back at `locality_counts()` (Server.locality_summary
    calls it)."""

    def __init__(self, server, loss_fn, role_class: Dict[str, int],
                 role_dim: Dict[str, int], shard: int = 0,
                 frozen_roles: Sequence[str] = (), neg_role: str = None,
                 neg_shape: Tuple[int, ...] = None,
                 neg_population=None, neg_alias=None, seed: int = 0):
        """`neg_alias=(prob, alias)` (models/sgns.py build_alias_table)
        switches the device draw to the app's non-uniform distribution over
        `neg_population` (position i of the population is drawn with
        probability ~ weight i), snapped to locally-resident keys."""
        self.server = server
        self.shard = shard
        self.role_class = role_class
        self.frozen_roles = frozenset(frozen_roles)
        self.router = DeviceRouter(server, shard)
        self.neg_role = neg_role
        self._li_fallback = False
        self._neg_shape = neg_shape
        dev = server.ctx.device
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(int(seed))
        self._alias = None
        if neg_alias is not None:
            if neg_role is None or neg_population is None:
                raise ValueError("neg_alias needs neg_role and "
                                 "neg_population")
            prob, alias = neg_alias
            key_table = np.asarray(neg_population,
                                   dtype=_key_dtype(server.num_keys))
            if len(prob) != len(key_table):
                raise ValueError("alias table must cover the population")
            put = server.ctx.put_replicated
            self._alias = (put(np.asarray(prob, np.float32)),
                           put(np.asarray(alias, np.int32)), put(key_table))
        # population the device sampler may draw from (Local scheme: the
        # locally-resident slice of the allowed keys); None -> all keys
        self._neg_population = None if neg_population is None else \
            np.unique(np.asarray(neg_population, dtype=np.int64))
        if self._neg_population is not None and neg_role is not None:
            kc = server.ab.key_class[self._neg_population]
            if not (kc == role_class[neg_role]).all():
                raise ValueError(
                    f"neg_population spans length classes {np.unique(kc)} "
                    f"but role {neg_role} is class {role_class[neg_role]}")
        self._local_index = None
        self._li_version = None
        self._locstat = torch.zeros(4, dtype=torch.int64, device=dev)
        self._lr_eps = _LrEps(dev)
        server._locality_sources.append(self.locality_counts)
        self._mk = dict(loss_fn=loss_fn, role_class=role_class,
                        role_dim=role_dim, shard=shard,
                        frozen_roles=frozen_roles, neg_role=neg_role,
                        neg_shape=neg_shape,
                        neg_alias=self._alias is not None)
        self.step_fn = make_device_routed_step(no_replicas=False, **self._mk)
        self._step_fn_norep = make_device_routed_step(no_replicas=True,
                                                      **self._mk)
        self._scan_fns: Dict[bool, Callable] = {}
        self._graphs: Dict[tuple, _ScanGraph] = {}
        self.graph_captures = 0
        self._rep_version = -1
        self._has_replicas = True
        self.steps = 0
        self.staged_steps = 0  # steps whose keys came as StagedKeys
        self._ring = None      # pinned buffers of prefetch_keys' uploads
        if server.prefetch is not None:
            server.prefetch.register_refresher(self._prefetch_refresh)

    def _prefetch_refresh(self) -> None:
        """Called by the prefetch pipeline (under the server lock) after
        planner rounds: refresh the device table mirrors (in place), the
        local sampling index and the replica-presence flag as soon as
        the topology settles, so the next dispatch finds them fresh."""
        with _GATE:
            self.router.refresh()
            if self.neg_role is not None:
                self._local_neg_index()
        self._shard_has_replicas()

    def _note_step_writes(self, role_keys) -> None:
        _mark_fused_writes(self.server, self.shard, self.role_class,
                           role_keys, skip_roles=self.frozen_roles,
                           sampled=self.neg_role is not None)

    def _mark_neg_writes(self) -> None:
        """Write tracking for device-drawn negatives: their rows are not
        enumerable on the host, so the negative class's whole shard counts
        as written — every shard when the draw falls back to the full
        population."""
        if self.neg_role is None:
            return
        st = self.server.stores[self.role_class[self.neg_role]]
        shards = range(self.server.num_shards) if self._li_fallback \
            else (self.shard,)
        for s in shards:
            st.mark_shard_written(s)

    def locality_counts(self) -> Dict[str, int]:
        """Cumulative step access counts, host-side (the device-routed
        analog of Worker.stats)."""
        with self.server._lock:
            p, pl, o, ol = (int(v) for v in self._locstat.cpu())
        return {"params": p, "params_local": pl, "ops": o, "ops_local": ol}

    def _shard_has_replicas(self) -> bool:
        srv = self.server
        if self._rep_version != srv.topology_version:
            self._has_replicas = bool(
                (srv.ab.cache_slot[self.shard] >= 0).any())
            self._rep_version = srv.topology_version
        return self._has_replicas

    def _local_neg_index(self):
        """(padded index tensor, valid count) of locally-resident keys of
        the population, padded to a power-of-two capacity with the dtype
        max; rebuilt when the topology or the residency changes. On a
        tiered server the population is restricted to hot-owned or
        replicated keys: device-drawn negatives read and scatter main
        rows in the step, which only works for device-resident rows."""
        srv = self.server
        li_ver = (srv.topology_version,
                  srv.tier.epoch if srv.tier is not None else -1)
        if self._li_version == li_ver and self._local_index is not None:
            return self._local_index
        ab = srv.ab
        pop = self._neg_population if self._neg_population is not None \
            else np.arange(srv.num_keys, dtype=np.int64)
        from ..base import NO_SLOT
        replicated = ab.cache_slot[self.shard, pop] != NO_SLOT
        if srv.tier is None:
            local = (ab.owner[pop] == self.shard) | replicated
        else:
            res = srv.stores[self.role_class[self.neg_role]].res
            o_sh, o_sl = ab.owner[pop], ab.slot[pop]
            local = replicated.copy()
            m = (o_sh == self.shard) & (o_sl >= 0)
            if m.any():
                local[m] |= res.dev_row[o_sh[m], o_sl[m]] >= 0
        idx = pop[local]
        self._li_fallback = len(idx) == 0
        if len(idx) == 0 and srv.tier is not None:
            # the untiered fallback (the full population) would draw cold
            # keys, whose mirror rows are OOB: promote a bounded slice of
            # the population and draw from its device-resident part
            idx = self._tiered_neg_fallback(pop)
        elif len(idx) == 0:
            idx = pop  # nothing local: draw from the full population
        kdt = _key_dtype(srv.num_keys)
        padded = np.full(bucket_size(len(idx), minimum=64),
                         np.iinfo(kdt).max, dtype=kdt)
        padded[: len(idx)] = idx
        self._local_index = (srv.ctx.put_replicated(padded), len(idx))
        self._li_version = li_ver
        return self._local_index

    def _tiered_neg_fallback(self, pop: np.ndarray) -> np.ndarray:
        """The device-resident keys of the population after promoting its
        first 4,096 (wherever they are owned); raises if none is."""
        srv = self.server
        ab = srv.ab
        cid = self.role_class[self.neg_role]
        res = srv.stores[cid].res
        take = pop[:4096]
        srv.tier.ensure_hot(cid, ab.owner[take], ab.slot[take])
        o_sh, o_sl = ab.owner[pop], ab.slot[pop]
        ok = o_sl >= 0
        resident = np.zeros(len(pop), dtype=bool)
        resident[ok] = res.dev_row[o_sh[ok], o_sl[ok]] >= 0
        idx = pop[resident]
        if len(idx) == 0:
            raise RuntimeError(
                "tiered negative sampling: no device-resident key in the "
                "population and promotion could not produce one (hot pool "
                "full of pinned rows?) — raise --sys.tier.hot_rows or "
                "signal intent on the sampling population")
        return idx

    def _check_batch(self, role_keys: Dict[str, np.ndarray]) -> None:
        srv = self.server
        if self.neg_role is not None and self.neg_role in role_keys:
            raise ValueError(
                f"role {self.neg_role!r} is sampled on device; caller-"
                "supplied keys for it would be silently discarded — drop "
                "them or build the runner without neg_role")
        from ..base import check_key_range
        for r, k in role_keys.items():
            k64 = np.asarray(k, dtype=np.int64)
            check_key_range(k64, srv.num_keys, f"role {r} key")
            kc = srv.ab.key_class[k64]
            if not (kc == self.role_class[r]).all():
                raise ValueError(
                    f"role {r}: keys span length classes {np.unique(kc)} "
                    f"but role is mapped to class {self.role_class[r]}")

    def _put_keys(self, role_keys, pinned: bool = False
                  ) -> Dict[str, torch.Tensor]:
        """The batch's keys on the device in one copy: role -> a view of
        one joined key tensor, shaped like the role's keys. `pinned`
        copies through the runner's pinned ring without waiting
        (StagedKeys)."""
        srv = self.server
        kdtype = _key_dtype(srv.num_keys)
        names = sorted(role_keys)
        arrs = [np.asarray(role_keys[r], dtype=kdtype) for r in names]
        if not arrs:
            return {}
        dev = srv.ctx.device
        if pinned and dev.type == "cuda":
            if self._ring is None:
                self._ring = _PinnedRing()
            joined = self._ring.upload(arrs, dev)
        else:
            joined = srv.ctx.put_replicated(
                np.concatenate([a.reshape(-1) for a in arrs]))
        keys, off = {}, 0
        for r, a in zip(names, arrs):
            keys[r] = joined[off:off + a.size].reshape(a.shape)
            off += a.size
        return keys

    def prefetch_keys(self, role_keys: Dict[str, np.ndarray]) -> StagedKeys:
        """Pre-stage a future step's key batch on the device: the upload
        runs now — on the app's intent/prepare path — instead of inside
        the next dispatch. Returns the handle for __call__'s `staged`
        parameter."""
        self._check_batch(role_keys)
        host = {r: np.array(k) for r, k in role_keys.items()}
        with _GATE:
            dev = self._put_keys(host, pinned=True)
        return StagedKeys(host, dev)

    def __call__(self, role_keys: Dict[str, np.ndarray], aux, lr: float,
                 eps: float = 1e-10,
                 staged: Optional[StagedKeys] = None) -> torch.Tensor:
        """One training step; returns the loss (a device scalar).
        `staged` is the handle `prefetch_keys` returned for this very
        batch: its keys are already on the device."""
        srv = self.server
        if staged is None:
            self._check_batch(role_keys)
        elif not staged.matches(role_keys):
            raise ValueError(
                "staged keys differ from the step's batch — pass the "
                "handle prefetch_keys returned for THIS batch")
        with _step_lock(srv, self.shard, role_keys):
            if srv.tier is not None:
                # the step reads main rows through the hot pool: promote
                # and pin the batch before the route mirror is read
                # (ensure_hot bumps the residency epoch, which
                # router.tables() below picks up)
                srv.tier.pin_step_keys(self.role_class, role_keys)
            self._note_step_writes(role_keys)
            tables = self.router.tables()
            local_index = self._local_neg_index() \
                if self.neg_role is not None else None
            self._mark_neg_writes()
            if staged is not None:
                keys = staged.dev
                self.staged_steps += 1
            else:
                keys = self._put_keys(role_keys)
            pools = tuple((s.main, s.cache, s.delta) for s in srv.stores)
            fn = self.step_fn if self._shard_has_replicas() \
                else self._step_fn_norep
            with srv.exec.track("main"), _GATE:
                loss = fn(pools, self._locstat, tables, keys, local_index,
                          self._alias, self._gen, aux, self._lr_eps(lr, eps))
            self.steps += 1
        return loss

    def _scan_fn(self, no_replicas: bool):
        fn = self._scan_fns.get(no_replicas)
        if fn is None:
            fn = self._scan_fns[no_replicas] = make_device_routed_scan(
                no_replicas=no_replicas, **self._mk)
        return fn

    def run_scan(self, batches: Sequence[Dict[str, np.ndarray]], auxes,
                 lr: float, eps: float = 1e-10) -> torch.Tensor:
        """Train K steps in one dispatch (the JAX package's run_scan);
        returns the [K] per-step losses (a device tensor) and adds K to
        `steps`. The batches share roles and shapes; `auxes` is a list of
        K per-step aux values (tensors or arrays of one shape), or None.
        Placement freezes for the window: the routing tables are read
        once and no planner round runs inside it; the write tracking
        sees every batch; device-drawn negatives come in the order K
        sequential calls draw them. So the pools, losses
        and locality counts equal those of K sequential __call__s.

        On the CPU the window is a loop over the step. On the card it is
        a CUDA graph, captured once per (K, variant, shapes, aux shape)
        and replayed per window (_graph_window)."""
        srv = self.server
        K = len(batches)
        if K < 1:
            raise ValueError("run_scan: empty window")
        roles = sorted(batches[0])
        shapes = {r: np.shape(batches[0][r]) for r in roles}
        for b in batches:
            self._check_batch(b)
            if sorted(b) != roles or any(np.shape(b[r]) != shapes[r]
                                         for r in roles):
                raise ValueError("run_scan: the window's batches must "
                                 "share roles and shapes")
        if auxes is not None and len(auxes) != K:
            raise ValueError("run_scan: one aux per batch")
        # every key of the window is localized before the tables are read
        # (and a graph captured): the window never routes to a REMOTE slot
        union = _window_keys(batches, roles)
        with _step_lock(srv, self.shard, union):
            if srv.tier is not None:
                # the mirror is read once for the window, so all its rows
                # must be hot at once: pin the UNION (per-batch pins would
                # let a later batch's forced eviction take an earlier one's)
                srv.tier.pin_step_keys(self.role_class, union)
            for b in batches:
                self._note_step_writes(b)
            tables = self.router.tables()
            local_index = self._local_neg_index() \
                if self.neg_role is not None else None
            self._mark_neg_writes()
            pools = tuple((st.main, st.cache, st.delta) for st in srv.stores)
            no_rep = not self._shard_has_replicas()
            lr_eps = self._lr_eps(lr, eps)
            kdtype = _key_dtype(srv.num_keys)
            stacked = {r: np.stack([np.asarray(b[r], dtype=kdtype)
                                    for b in batches]) for r in roles}
            with srv.exec.track("main"), _GATE:
                if self._locstat.device.type == "cuda":
                    losses = self._graph_window(no_rep, pools, tables,
                                                stacked, local_index, auxes)
                else:
                    losses = self._scan_fn(no_rep)(
                        pools, self._locstat, tables, self._put_keys(stacked),
                        local_index, self._alias, self._gen, auxes, lr_eps)
            self.steps += K
        return losses

    def _graph_window(self, no_rep, pools, tables, stacked, local_index,
                      auxes) -> torch.Tensor:
        """One run_scan window on the card as a CUDA graph (caller holds
        the server lock). The window's keys and aux are copied into static
        buffers, and the negatives drawn into them eagerly, K draws in
        sequence from the runner's generator: the graph holds no random
        state, and the local index and its count stay out of it. The
        first window of a signature runs eagerly on a side stream (the
        warm-up PyTorch's graph capture asks for, and the window's real
        steps), then the graph is captured; later windows replay it. A
        capture holds the addresses of the pools, the routing tables, the
        locality counters and (lr, eps): the planner may replace the
        tables (DeviceRouter.refresh on a topology change), so a window
        whose addresses differ captures again (`graph_captures` counts
        captures; a new capture replaces the old one of its signature).
        Capturing launches nothing, so the wrappers' launch counts
        (kernels.LAUNCHES) are restored after it; each replay adds the
        launches recorded at capture to kernels.REPLAYED. Intermediate
        tensors live in the graph's pool; the result is a copy of its
        static output.

        The side stream runs concurrently with whatever else is queued
        on the default stream, so nothing else may be enqueued while it
        runs: run_scan holds the dispatch gate (and the server lock)
        from before `side.wait_stream(cur)` until after
        `cur.wait_stream(side)` and the capture, and every device
        enqueue of the prefetch pipeline and the background planner
        takes the gate (core/intent.py PrefetchScheduler). A delegated
        round or a mirror refresh therefore lands before or after the
        window, never inside it; refreshes copy in place, so replays
        keep matching `ptrs`."""
        dev = self._locstat.device
        K = len(next(iter(stacked.values())))
        aux = None if auxes is None else torch.stack(
            [torch.as_tensor(x, device=dev) for x in auxes])
        sig = (K, no_rep, tuple((r, a.shape) for r, a in stacked.items()),
               None if aux is None else (tuple(aux.shape), aux.dtype))
        entry = self._graphs.get(sig)
        if entry is None:
            names = sorted(stacked)
            parts = [(r, stacked[r].shape) for r in names]
            if self.neg_role is not None:
                parts.append((self.neg_role, (K,) + tuple(self._neg_shape)))
            total = sum(int(np.prod(sh)) for _, sh in parts)
            joined = torch.empty(total, device=dev, dtype=torch.as_tensor(
                stacked[names[0]][:0]).dtype)
            keys, off = {}, 0
            for r, sh in parts:
                n = int(np.prod(sh))
                keys[r] = joined[off:off + n].view(sh)
                off += n
            entry = self._graphs[sig] = _ScanGraph(
                keys, joined, None if aux is None else torch.empty_like(aux))
        host = np.concatenate([stacked[r].reshape(-1)
                               for r in sorted(stacked)])
        entry.joined[:host.size].copy_(torch.from_numpy(host))
        if self.neg_role is not None:
            torch.stack([_draw_negatives(self._neg_shape, local_index,
                                         self._alias, self._gen)
                         for _ in range(K)], out=entry.keys[self.neg_role])
        if aux is not None:
            entry.aux.copy_(aux)
        ptrs = tuple(t.data_ptr() for t in
                     [x for p in pools for x in p] + list(tables)
                     + [self._locstat, self._lr_eps.t] if t is not None)
        if entry.graph is not None and entry.ptrs == ptrs:
            entry.graph.replay()
            for k, v in entry.launches.items():
                kernels.REPLAYED[k] += v
            return entry.losses.clone()
        fn = self._scan_fn(no_rep)
        args = (pools, self._locstat, tables, entry.keys, None, None, None,
                entry.aux, self._lr_eps.t)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*args).clone()
        cur.wait_stream(side)
        out.record_stream(cur)
        entry.graph = None                      # release an older capture
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                entry.losses = fn(*args)
            entry.launches = {k: kernels.LAUNCHES[k] - before[k]
                              for k in before}
        finally:
            kernels.LAUNCHES.update(before)
        entry.graph, entry.ptrs = graph, ptrs
        self.graph_captures += 1
        return out


class FusedStepRunner:
    """Binds the host-routed fused step to a Server: the step updates the
    ShardedStores' pools in place, so the PM view (Pull/Push/sync rounds)
    and the fused hot loop always see the same tensors."""

    def __init__(self, server, loss_fn, role_class: Dict[str, int],
                 role_dim: Dict[str, int], frozen_roles: Sequence[str] = ()):
        self.server = server
        self.role_class = role_class
        self.frozen_roles = frozenset(frozen_roles)
        self.step_fn = make_fused_adagrad_step(
            loss_fn, role_class, role_dim, frozen_roles)
        self._lr_eps = _LrEps(server.ctx.device)
        self.n_remote = 0
        self.steps = 0

    def routes_for(self, role_keys: Dict[str, np.ndarray],
                   shard: int) -> Dict[str, tuple]:
        out = {}
        for r, keys in role_keys.items():
            rt = build_routes(self.server, keys, shard,
                              expect_class=self.role_class[r])
            self.n_remote += rt.n_remote
            out[r] = rt.as_tuple()
        return out

    def __call__(self, role_keys: Dict[str, np.ndarray], aux, lr: float,
                 eps: float = 1e-10, shard: int = 0) -> torch.Tensor:
        """One training step; returns the loss (a device scalar)."""
        srv = self.server
        # localized before the lock (and before pin_step_keys, which
        # skips slot < 0 entries)
        with _step_lock(srv, shard, role_keys):
            if srv.tier is not None:
                # pin the whole batch hot as ONE union before any role's
                # routes are translated: a later role's forced eviction
                # must never take an earlier role's translated rows
                srv.tier.pin_step_keys(self.role_class, role_keys)
            routes = self.routes_for(role_keys, shard)
            # all roles are host-provided here: the written key set is
            # exact
            _mark_fused_writes(srv, shard, self.role_class, role_keys,
                               skip_roles=self.frozen_roles)
            pools = tuple((s.main, s.cache, s.delta) for s in srv.stores)
            with srv.exec.track("main"), _GATE:
                loss = self.step_fn(pools, routes, aux,
                                    self._lr_eps(lr, eps))
        self.steps += 1
        return loss
