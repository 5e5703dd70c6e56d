"""The fused training steps: the port's hot path.

Every reference app's inner loop is the same triad: Pull a handful of rows,
run a small dense compute + AdaGrad, Push additive updates (mf/update.h:32-70,
word2vec.cc:718-743, kge.cc:415-530). Here the triad over a *batch* of data
points is one step on the device:

    route -> gather rows (K1) -> model loss -> autograd ->
    AdaGrad transform (K2) -> ordered scatter-add (K3)

Updates remain additive deltas, so the parameter-manager semantics hold
(pushes merge at the main copy; replica writes land in the delta pool and
flow back through sync rounds): the step is a batched Push in PM terms.
Value rows are [emb (D) | adagrad acc (D)]
(matrix_factorization.cc:695-697).

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
replica-free main-only variant). The K-step `run_scan` is not ported yet
(ROADMAP queue A, item 4).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.store import OOB, bucket_size
from ..exec import dispatch_gate
from .kernels import adagrad_update, ordered_scatter_add, routed_gather

_GATE = dispatch_gate()


def _key_dtype(num_keys: int):
    """Key-upload dtype: int32 while every key fits."""
    return np.int32 if num_keys <= 2**31 else np.int64


def _mark_fused_writes(server, shard: int, role_class, role_keys,
                       skip_roles=()) -> None:
    """Dirty-delta write tracking for a fused step's host-known roles
    (caller holds the server lock): resolve each role's keys through the
    addressbook — the tables the step routes with — and record the
    scatter in the stores' write epochs."""
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
    put = server.ctx.put_replicated
    return Routes(put(o_sh), put(g_sl), put(c_sh), put(c_sl), put(use_c),
                  n_remote)


def _read_rows(main, cache, delta, route) -> torch.Tensor:
    """The routed fill-gather of one role (K1, cache+delta form): rows
    shaped like the role's keys plus the row length."""
    g_sh, g_sl, c_sh, c_sl, use_c = route
    flat = routed_gather(main, cache, delta, g_sh.reshape(-1),
                         g_sl.reshape(-1), c_sh.reshape(-1),
                         c_sl.reshape(-1), use_c.reshape(-1))
    return flat.reshape(tuple(g_sh.shape) + (flat.shape[-1],))


def _scatter_update(main, delta, route, upd) -> None:
    """In place: the owner path adds into main (g_sl is OOB at replica
    positions), then the replica path into delta (c_sl is OOB at owner
    positions); K3 folds duplicates in batch order."""
    g_sh, g_sl, c_sh, c_sl, _ = route
    ordered_scatter_add(main, g_sh.reshape(-1), g_sl.reshape(-1), upd)
    ordered_scatter_add(delta, c_sh.reshape(-1), c_sl.reshape(-1), upd)


def _loss_and_updates(loss_fn, rows, role_dim, roles, trainable, aux, lr,
                      eps):
    """Loss over the gathered rows and each trainable role's AdaGrad delta
    rows [n, 2D] (K2). Each role's embedding half is its own autograd leaf,
    so a duplicated key gets one gradient per occurrence."""
    embs = {r: rows[r][..., : role_dim[r]] for r in roles}
    leaves = {r: embs[r].detach().requires_grad_() for r in trainable}
    with torch.enable_grad():
        merged = dict(embs)
        merged.update(leaves)
        loss = loss_fn(merged, aux)
        grads = torch.autograd.grad(loss, [leaves[r] for r in trainable])
    upds = {}
    for r, g in zip(trainable, grads):
        D = role_dim[r]
        flat_rows = rows[r].reshape(-1, rows[r].shape[-1])
        upds[r] = adagrad_update(g.reshape(-1, D).contiguous(),
                                 flat_rows[:, D:], lr, eps)
    return loss.detach(), upds


def make_fused_adagrad_step(loss_fn: Callable[..., torch.Tensor],
                            role_class: Dict[str, int],
                            role_dim: Dict[str, int],
                            frozen_roles: Sequence[str] = ()):
    """The host-routed fused step:

        step(pools, routes, aux, lr, eps) -> loss

      pools   tuple per class of (main, cache, delta), UPDATED IN PLACE
      routes  dict role -> Routes.as_tuple()
      aux     handed to loss_fn (labels, weights)

    loss_fn(embs: dict role -> [..., D_role] tensor, aux) is the scalar
    mean loss; role rows are [emb | acc] of length 2*D; frozen roles are
    gathered for the forward pass and never updated. Every role is
    gathered before the first scatter; roles scatter in sorted() order,
    main then delta."""
    roles = sorted(role_class)
    trainable = [r for r in roles if r not in frozen_roles]

    def step(pools, routes, aux, lr, eps):
        rows = {}
        for r in roles:
            main, cache, delta = pools[role_class[r]]
            rows[r] = _read_rows(main, cache, delta, routes[r])
        loss, upds = _loss_and_updates(loss_fn, rows, role_dim, roles,
                                       trainable, aux, lr, eps)
        for r in trainable:
            main, _, delta = pools[role_class[r]]
            _scatter_update(main, delta, routes[r], upds[r])
        return loss

    return step


class DeviceRouter:
    """Device mirrors of the Addressbook tables for one worker shard,
    refreshed lazily on placement changes (Server.topology_version)."""

    def __init__(self, server, shard: int):
        self.server = server
        self.shard = shard
        self._version = None
        self.owner = None      # [num_keys] int32
        self.slot = None       # [num_keys] int32
        self.cache_row = None  # [num_keys] int32 (this shard's replica slots)

    def refresh(self):
        srv = self.server
        if self._version == srv.topology_version and self.owner is not None:
            return
        ab = srv.ab
        put = srv.ctx.put_replicated
        self.owner = put(ab.owner)
        self.slot = put(ab.slot)
        self.cache_row = put(ab.cache_slot[self.shard])
        self._version = srv.topology_version

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
             aux, lr, eps) -> loss

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

    Every role's rows are gathered before the first scatter, each role's
    rows are its own autograd leaf (a duplicated key gets one gradient per
    occurrence, and the AdaGrad updates fold additively in batch order),
    and roles scatter in sorted() order, main then delta.
    `no_replicas=True` is the replica-free variant: reads touch only the
    main pool and updates scatter only into main — legal exactly while the
    shard holds no replicas (the runner re-checks per step)."""
    roles = sorted(role_class)
    trainable = [r for r in roles if r not in frozen_roles]

    def step(pools, locstat, tables, keys, local_index, alias, generator,
             aux, lr, eps):
        keys = dict(keys)
        if neg_role is not None and (neg_alias or local_index is not None):
            keys[neg_role] = _draw_negatives(
                neg_shape, local_index, alias if neg_alias else None,
                generator)
        rows, routes = {}, {}
        n_total = 0
        n_local = torch.zeros((), dtype=torch.int64,
                              device=locstat.device)
        for r in roles:
            main, cache, delta = pools[role_class[r]]
            k = keys[r].reshape(-1)
            n_total += k.numel()
            if no_replicas:
                owner, slot, _ = tables
                o_sh, o_sl = owner.index_select(0, k), slot.index_select(0, k)
                routes[r] = (o_sh, o_sl)
                flat = routed_gather(main, None, None, o_sh, o_sl)
                n_local += (o_sh == shard).sum()
            else:
                routes[r] = _route_on_device(tables, k, shard)
                flat = routed_gather(main, cache, delta, *routes[r])
                o_sh, use_c = routes[r][0], routes[r][4]
                n_local += (use_c | (o_sh == shard)).sum()
            rows[r] = flat.reshape(keys[r].shape + (flat.shape[-1],))
        # one step = one batched pull + one push of the same keys; the op
        # counts local iff every key it touched was local
        locstat += torch.stack([
            torch.tensor(n_total, device=locstat.device), n_local,
            torch.ones((), dtype=torch.int64, device=locstat.device),
            (n_local == n_total).to(torch.int64)])
        loss, upds = _loss_and_updates(loss_fn, rows, role_dim, roles,
                                       trainable, aux, lr, eps)
        for r in trainable:
            main, _, delta = pools[role_class[r]]
            if no_replicas:
                o_sh, o_sl = routes[r]
                ordered_scatter_add(main, o_sh, o_sl, upds[r])
            else:
                _scatter_update(main, delta, routes[r], upds[r])
        return loss

    return step


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
        self._li_version = -1
        self._locstat = torch.zeros(4, dtype=torch.int64, device=dev)
        server._locality_sources.append(self.locality_counts)
        mk = dict(loss_fn=loss_fn, role_class=role_class,
                  role_dim=role_dim, shard=shard,
                  frozen_roles=frozen_roles, neg_role=neg_role,
                  neg_shape=neg_shape, neg_alias=self._alias is not None)
        self.step_fn = make_device_routed_step(no_replicas=False, **mk)
        self._step_fn_norep = make_device_routed_step(no_replicas=True,
                                                      **mk)
        self._rep_version = -1
        self._has_replicas = True
        self.steps = 0

    def _note_step_writes(self, role_keys) -> None:
        """The fused step is a batched Push: the stores' dirty-delta
        tracking must see its scatter, or the planner would skip shipping
        the trained replicas (caller holds the server lock)."""
        _mark_fused_writes(self.server, self.shard, self.role_class,
                           role_keys, skip_roles=self.frozen_roles)

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
        max; rebuilt when the topology changes."""
        srv = self.server
        if self._li_version == srv.topology_version and \
                self._local_index is not None:
            return self._local_index
        ab = srv.ab
        pop = self._neg_population if self._neg_population is not None \
            else np.arange(srv.num_keys, dtype=np.int64)
        from ..base import NO_SLOT
        local = (ab.owner[pop] == self.shard) | (
            ab.cache_slot[self.shard, pop] != NO_SLOT)
        idx = pop[local]
        self._li_fallback = len(idx) == 0
        if len(idx) == 0:
            idx = pop  # nothing local: draw from the full population
        kdt = _key_dtype(srv.num_keys)
        padded = np.full(bucket_size(len(idx), minimum=64),
                         np.iinfo(kdt).max, dtype=kdt)
        padded[: len(idx)] = idx
        self._local_index = (srv.ctx.put_replicated(padded), len(idx))
        self._li_version = srv.topology_version
        return self._local_index

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

    def __call__(self, role_keys: Dict[str, np.ndarray], aux, lr: float,
                 eps: float = 1e-10) -> torch.Tensor:
        """One training step; returns the loss (a device scalar)."""
        srv = self.server
        self._check_batch(role_keys)
        with srv._lock:
            self._note_step_writes(role_keys)
            tables = self.router.tables()
            local_index = self._local_neg_index() \
                if self.neg_role is not None else None
            self._mark_neg_writes()
            kdtype = _key_dtype(srv.num_keys)
            put = srv.ctx.put_replicated
            keys = {r: put(np.asarray(k, dtype=kdtype))
                    for r, k in role_keys.items()}
            pools = tuple((s.main, s.cache, s.delta) for s in srv.stores)
            fn = self.step_fn if self._shard_has_replicas() \
                else self._step_fn_norep
            with srv.exec.track("main"), _GATE:
                loss = fn(pools, self._locstat, tables, keys, local_index,
                          self._alias, self._gen, aux, float(lr),
                          float(eps))
            self.steps += 1
        return loss


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
        with srv._lock:
            routes = self.routes_for(role_keys, shard)
            # the step is a batched Push: the stores' dirty-delta
            # tracking must see its scatter
            _mark_fused_writes(srv, shard, self.role_class, role_keys,
                               skip_roles=self.frozen_roles)
            pools = tuple((s.main, s.cache, s.delta) for s in srv.stores)
            with srv.exec.track("main"), _GATE:
                loss = self.step_fn(pools, routes, aux, float(lr),
                                    float(eps))
        self.steps += 1
        return loss
