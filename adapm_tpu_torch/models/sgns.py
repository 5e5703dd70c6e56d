"""Skip-gram negative sampling (word2vec) helpers: for now only the alias
table of the noise distribution, which the KGE app's `--neg_sampling freq`
draws from on the device (ops/fused.py). This is `build_alias_table` of
the JAX package's `models/sgns.py`; the SGNS model itself is ROADMAP
queue A, item 6.
"""
from __future__ import annotations

import numpy as np


def build_alias_table(counts: np.ndarray, power: float = 0.75):
    """Vose alias table for the unigram^power noise distribution — the
    device-sampler form of the reference's pre-materialized 1e8-entry
    unigram table (word2vec.cc:125-144): two O(V) arrays on the device
    instead of a 400MB table, sampled with two uniform draws.
    Returns (prob float32[V], alias int32[V])."""
    p = counts.astype(np.float64) ** power
    p /= p.sum()
    V = len(p)
    prob = np.zeros(V, dtype=np.float32)
    alias = np.zeros(V, dtype=np.int32)
    scaled = p * V
    small = [i for i in range(V) if scaled[i] < 1.0]
    large = [i for i in range(V) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    for i in small + large:
        prob[i] = 1.0
    return prob, alias
