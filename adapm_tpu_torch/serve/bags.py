"""Embedding-bag serving: the request type, the batch planner, and the
host pooling twin (the port of the JAX package's `serve/bags.py`).

A *bag read* asks for POOLED vectors: per table, `bags` offsets
partition that table's member keys into segments, and the reply is one
sum- or mean-pooled vector per segment (`ServeSession.lookup_bags`).
Pooling on the host after a flat gather ships every member row off the
card only to reduce it at once, so the fused path dispatches
`ShardedStore.gather_pool` (K8: gather and segment sum in one launch
per length class and pooling), and only the pooled vectors cross.

Bit-identity: K8 accumulates member rows in batch order, and
`pool_bags_host` below accumulates with `np.add.at` in the same member
order, so the two are bit-identical for every batch. That lets the
batcher pick per dispatch (replica snapshot → host pool; locked path →
K8; `--sys.serve.bags 0` → flat union gather + host pool) without the
choice ever showing in the returned bits.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .admission import LookupRequest


class BagLookupRequest(LookupRequest):
    """One client bag lookup riding the same admission queue / claim
    machinery as a flat `LookupRequest`. `keys` is the flat concat of
    every table's member keys (what admission, lane assignment, and
    union dedup see); `tables`/`bags` keep the per-table structure the
    pooling needs. Delivery carries the flat concat of the per-table
    pooled matrices (`[nbags_t, L_t]` row-major, tables in order) —
    the session reshapes."""

    __slots__ = ("tables", "bags", "pooling")

    def __init__(self, tables: Sequence[np.ndarray],
                 bags: Sequence[np.ndarray], pooling: str,
                 keys: np.ndarray, **kw):
        super().__init__(keys, **kw)
        self.tables = list(tables)
        self.bags = list(bags)
        self.pooling = pooling


def pool_bags_host(rows: np.ndarray, seg: np.ndarray, nbags: int,
                   pooling: str) -> np.ndarray:
    """Pool member `rows` [n, L] into [nbags, L] on the host — the
    bit-identical twin of the device program (module docstring):
    batch-order `np.add.at` sum, then for mean ONE division per bag
    (empty bags pool to exact zeros, matching the device masked
    divide)."""
    rows = np.asarray(rows)
    seg = np.asarray(seg)
    out = np.zeros((int(nbags), rows.shape[1]), dtype=rows.dtype)
    np.add.at(out, seg, rows)
    if pooling == "sum":
        return out
    cnt = np.zeros(int(nbags), dtype=rows.dtype)
    np.add.at(cnt, seg, rows.dtype.type(1))
    denom = np.where(cnt > 0, cnt, rows.dtype.type(1))[:, None]
    return np.where(cnt[:, None] > 0, out / denom, np.zeros_like(out))


# a group key is (length-class id, pooling) — one device program (or
# one host pool) per group serves every request's tables in that group
GroupKey = Tuple[int, str]


def plan_bag_batch(reqs: List[BagLookupRequest], key_class: np.ndarray):
    """Coalesce a batch of bag requests into per-(class, pooling)
    groups. Returns `(groups, slices)`:

      groups[gkey] = {"keys": member keys (concat, REQUEST ORDER —
                      the order the pooling accumulates in), "seg":
                      int32 global bag index per member, "nbags": int}
      slices[i]    = [(gkey, bag_start, nbags_t), ...] per request i's
                     tables, in table order — slice the group's pooled
                     matrix `[bag_start : bag_start + nbags_t]` to get
                     that table's reply.

    Member DUPLICATES are preserved (each member position is one
    accumulation entry — dedup here would change the pooled sums);
    union dedup for replica-coverage/metrics happens on the caller's
    side over `req.keys`."""
    groups: Dict[GroupKey, dict] = {}
    slices: List[list] = []
    for r in reqs:
        rs = []
        for ks, bg in zip(r.tables, r.bags):
            gkey = (int(key_class[ks[0]]), r.pooling)
            g = groups.setdefault(gkey,
                                  {"keys": [], "seg": [], "nbags": 0})
            nb = len(bg) - 1
            seg = (np.repeat(np.arange(nb, dtype=np.int64),
                             np.diff(bg)).astype(np.int32) + g["nbags"])
            g["keys"].append(ks)
            g["seg"].append(seg)
            rs.append((gkey, g["nbags"], nb))
            g["nbags"] += nb
        slices.append(rs)
    for g in groups.values():
        g["keys"] = np.concatenate(g["keys"])
        g["seg"] = np.concatenate(g["seg"]).astype(np.int32) \
            if g["seg"] else np.empty(0, np.int32)
    return groups, slices
