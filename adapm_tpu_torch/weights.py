"""Load parameter-manager state exported from the JAX package.

`from_jax_arrays(server, pools, owner, slot, cache_slot)` installs a JAX
server's per-class `(main, cache, delta)` numpy arrays and its addressbook
placement (`owner`, `slot`, `cache_slot`) into a port Server built with
the same keys, value lengths, shard count and pool sizes. Slot
allocators, the replica registry and the write-tracking epochs are
rebuilt from the placement, so both servers then compute the same thing:
pulls, pushes and sync rounds agree bitwise.

A tiered server (--sys.tier) also takes `tiers`, one dict per length
class of the JAX store's residency and cold store as numpy:

    dev_row, row_slot, score, pin_until   tier/residency.py Residency
    q, scale, resid                        tier/quant.py QuantCold: the
                                           wire rows, the int8 scales
                                           (None otherwise) and the
                                           residual map {(shard, slot):
                                           f32 row}

(`main` is then the hot pool). The hot-row allocator is rebuilt from
`row_slot`; the residual map keeps its order (its eviction order).
"""
from __future__ import annotations

import numpy as np


def from_jax_arrays(server, pools, owner, slot, cache_slot,
                    tiers=None) -> None:
    """Install exported state into `server` (see module docstring).
    `pools` is a sequence over length classes of (main, cache, delta)
    arrays shaped like the server's own pools; `tiers` the tiered
    stores' residency and cold state."""
    owner = np.asarray(owner, dtype=np.int32)
    slot = np.asarray(slot, dtype=np.int32)
    cache_slot = np.asarray(cache_slot, dtype=np.int32)
    ab = server.ab
    if owner.shape != ab.owner.shape or cache_slot.shape != \
            ab.cache_slot.shape:
        raise ValueError("placement tables do not match the server's "
                         "key count / shard count")
    if len(pools) != len(server.stores):
        raise ValueError(f"{len(pools)} pool triples for "
                         f"{len(server.stores)} length classes")
    if (tiers is None) != (server.tier is None) or \
            (tiers is not None and len(tiers) != len(server.stores)):
        raise ValueError("tier state must be given exactly for a tiered "
                         "server, one dict per length class")
    for st, (m, c, d) in zip(server.stores, pools):
        for name, arr in (("main", m), ("cache", c), ("delta", d)):
            if tuple(np.shape(arr)) != tuple(getattr(st, name).shape):
                raise ValueError(f"{name} pool shape {np.shape(arr)} != "
                                 f"{tuple(getattr(st, name).shape)}")
    port = server.stores[0].port
    dev = server.ctx.device
    with server._topology_mutation():
        ab.owner[:] = owner
        ab.slot[:] = slot
        ab.cache_slot[:] = cache_slot
        ab.replica_count[:] = (cache_slot >= 0).sum(axis=0)
        ab.mutations += 1
        server.sync.replica_clear()
        for cid, st in enumerate(server.stores):
            in_class = ab.key_class == cid
            for s in range(server.num_shards):
                ab.main_alloc[cid].set_used(
                    s, slot[in_class & (owner == s)])
                ab.cache_alloc[cid].set_used(
                    s, cache_slot[s][in_class & (cache_slot[s] >= 0)])
            m, c, d = pools[cid]
            st.main = port.install_pool(m, dev)
            st.cache = port.install_pool(c, dev)
            st.delta = port.install_pool(d, dev)
            st.reset_write_tracking()
            if tiers is not None:
                _install_tier(st, tiers[cid])
        sh, k = np.nonzero(cache_slot >= 0)
        server.sync.replica_add(k.astype(np.int64), sh.astype(np.int32))


def _install_tier(st, t) -> None:
    """One class's residency maps and cold store (module docstring)."""
    from collections import OrderedDict

    from .core.addressbook import SlotAllocator
    res, cold = st.res, st.coldq
    for name in ("dev_row", "row_slot", "score", "pin_until"):
        arr = getattr(res, name)
        src = np.asarray(t[name])
        if src.shape != arr.shape:
            raise ValueError(f"{name} shape {src.shape} != {arr.shape}")
        arr[:] = src
    res.alloc = SlotAllocator(res.num_shards, res.hot_rows)
    for s in range(res.num_shards):
        res.alloc.set_used(s, np.nonzero(res.row_slot[s] >= 0)[0])
    res.take_wants()
    res.epoch += 1
    q = np.asarray(t["q"])
    if q.shape != cold.q.shape or q.dtype != cold.q.dtype:
        raise ValueError(f"cold rows {q.dtype}{q.shape} != "
                         f"{cold.q.dtype}{cold.q.shape}")
    cold.q[:] = q
    if cold.scale is not None:
        cold.scale[:] = np.asarray(t["scale"])
    cold.resid = OrderedDict(((int(a), int(b)), np.array(r, np.float32))
                             for (a, b), r in t["resid"].items())
