"""Skip-gram negative-sampling word2vec (SGNS), as in the JAX package's
`models/sgns.py`.

Reference apps/word2vec.cc (Google-C w2v ported to the PM): two keys per
word — syn0 (input embedding) = 2w, syn1 (output embedding) = 2w+1
(word2vec.cc:83-105); unigram^0.75 negative table (:125-144), on the
device as a Vose alias table (`build_alias_table`, which the KGE app's
`--neg_sampling freq` also draws from); AdaGrad update (:718-743). One
fused step trains a whole batch of (center, context) pairs with N
negatives per pair. The loss runs its step as the hand-written kernel
K6 (`SgnsLoss.fused_update`, ops/kernels.py sgns_step).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import _softplus, sgns_step


def syn0_key(word: np.ndarray):
    """Input-embedding key for word id(s) (word2vec.cc:83-105)."""
    return 2 * np.asarray(word, dtype=np.int64)


def syn1_key(word: np.ndarray):
    """Output-embedding key for word id(s)."""
    return 2 * np.asarray(word, dtype=np.int64) + 1


class SgnsLoss:
    """loss_fn(embs, aux) for ops/fused.py. Roles: center [B, d] (syn0),
    ctx [B, d] (syn1), neg [B, N, d] (syn1); aux is unused.
    loss = mean_b(softplus(-c.x) + sum_n softplus(c.n_n)), i.e.
    -log sig(u.v) - sum log sig(-u.v_neg).

    `fused_update` is the loss's fused form: the fused step runs it (the
    hand-written kernel K6) in place of autograd and K2."""

    def __call__(self, embs, aux):
        center, ctx, neg = embs["center"], embs["ctx"], embs["neg"]
        pos = (center * ctx).sum(-1)
        negs = (center[:, None, :] * neg).sum(-1)
        return (_softplus(-pos) + _softplus(negs).sum(-1)).mean()

    def fused_update(self, rows, out, lr_eps, aux) -> torch.Tensor:
        """The SGNS loss, its gradient and the AdaGrad delta rows in one
        K6 launch: `rows` maps center, ctx, neg to gathered [emb | acc]
        rows, `out` each trainable role to its delta rows (a frozen role
        is missing), `lr_eps` is (lr, eps) on the rows' device. Returns
        the mean loss."""
        if sorted(rows) != ["center", "ctx", "neg"]:
            raise ValueError(f"SgnsLoss: roles {sorted(rows)}, expected "
                             "center, ctx, neg")
        return sgns_step(rows["center"], rows["ctx"], rows["neg"], lr_eps,
                         out=out).mean()


sgns_loss = SgnsLoss()


def build_unigram_table(counts: np.ndarray, power: float = 0.75):
    """Noise distribution over words: count^0.75 / Z (word2vec.cc:125-144).
    Returns a sampler closure `fn(n, rng) -> word ids` suitable for
    Server.enable_sampling_support (drawing *syn1 keys* is the caller's
    concern via syn1_key)."""
    p = counts.astype(np.float64) ** power
    p /= p.sum()

    def sample(n: int, rng: np.random.Generator) -> np.ndarray:
        return rng.choice(len(p), size=n, p=p).astype(np.int64)

    return sample


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


def subsample_mask(word_counts: np.ndarray, words: np.ndarray,
                   total: int, t: float, rng) -> np.ndarray:
    """Frequent-word subsampling keep-mask, word2vec.c's keep probability
    sqrt(t/f) + t/f for a word with corpus frequency f (word2vec.cc applies
    this while filling its sentence buffer)."""
    f = word_counts[words] / max(total, 1)
    keep_p = np.minimum(1.0, np.sqrt(t / np.maximum(f, 1e-12))
                        + t / np.maximum(f, 1e-12))
    return rng.random(len(words)) < keep_p
