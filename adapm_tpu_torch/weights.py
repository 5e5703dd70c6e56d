"""Load parameter-manager state exported from the JAX package.

`from_jax_arrays(server, pools, owner, slot, cache_slot)` installs a JAX
server's per-class `(main, cache, delta)` numpy arrays and its addressbook
placement (`owner`, `slot`, `cache_slot`) into a port Server built with
the same keys, value lengths, shard count and pool sizes. Slot
allocators, the replica registry and the write-tracking epochs are
rebuilt from the placement, so both servers then compute the same thing:
pulls, pushes and sync rounds agree bitwise.
"""
from __future__ import annotations

import numpy as np


def from_jax_arrays(server, pools, owner, slot, cache_slot) -> None:
    """Install exported state into `server` (see module docstring).
    `pools` is a sequence over length classes of (main, cache, delta)
    arrays shaped like the server's own pools."""
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
        sh, k = np.nonzero(cache_slot >= 0)
        server.sync.replica_add(k.astype(np.int64), sh.astype(np.int32))
