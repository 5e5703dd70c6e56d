"""Knowledge-graph embedding models: ComplEx and RESCAL, as PyTorch
functions on batches of gathered rows (the JAX package's `models/kge.py`;
reference apps/knowledge_graph_embeddings.cc: ComplEx :832-858, RESCAL
:860-907).

Embedding layout: an entity row holds a complex vector of dimension `dim`
as [re | im] (2*dim floats); ComplEx relations are the same; RESCAL
relations are a real dim x dim matrix (dim^2 floats). The stored value
row additionally carries the AdaGrad accumulator ([emb | acc],
ops/fused.py). The gradient is plain autograd over the gathered rows.
The all-entity eval programs are not ported (ROADMAP queue B, B9).
"""
from __future__ import annotations

import torch


def complex_score(s: torch.Tensor, r: torch.Tensor,
                  o: torch.Tensor) -> torch.Tensor:
    """Re(<s, r, conj(o)>) for [..., 2d] embeddings (kge.cc ComplEx)."""
    d = s.shape[-1] // 2
    sr, si = s[..., :d], s[..., d:]
    rr, ri = r[..., :d], r[..., d:]
    orr, oi = o[..., :d], o[..., d:]
    return (sr * rr * orr + si * rr * oi
            + sr * ri * oi - si * ri * orr).sum(-1)


def rescal_score(s: torch.Tensor, r: torch.Tensor,
                 o: torch.Tensor) -> torch.Tensor:
    """s^T R o with R = r reshaped to [d, d] (kge.cc RESCAL)."""
    d = s.shape[-1]
    R = r.reshape(r.shape[:-1] + (d, d))
    return torch.einsum("...i,...ij,...j->...", s, R, o)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) as logaddexp(x, 0): the JAX package's jax.nn.softplus
    return torch.logaddexp(x, torch.zeros_like(x))


def _nll_loss(pos: torch.Tensor, neg_s: torch.Tensor, neg_o: torch.Tensor,
              self_adv_temp: float = 0.0) -> torch.Tensor:
    """Negative-sampling logistic loss: -log sig(pos) - sum log sig(-neg)
    (kge.cc train loop :437-531). self_adv_temp > 0 weights each negative
    by softmax(temp * score) with a stopped gradient (self-adversarial
    sampling, Sun et al. 2019, RotatE eq. 5)."""
    pos_l = _softplus(-pos)
    if self_adv_temp > 0.0:
        ws = torch.softmax(self_adv_temp * neg_s.detach(), dim=-1)
        wo = torch.softmax(self_adv_temp * neg_o.detach(), dim=-1)
        neg_l = (ws * _softplus(neg_s)).sum(-1) \
            + (wo * _softplus(neg_o)).sum(-1)
    else:
        neg_l = _softplus(neg_s).sum(-1) + _softplus(neg_o).sum(-1)
    return (pos_l + neg_l).mean()


def make_kge_loss(model: str = "complex", self_adv_temp: float = 0.0,
                  l2: float = 0.0):
    """loss_fn(embs, aux) for ops/fused.py. Roles: s, r, o [B, *]; neg
    [B, N] entity embeddings corrupting both the subject and the object
    side. `l2` > 0 adds per-batch (lazy) L2 on the positive triple's
    rows."""
    score = {"complex": complex_score, "rescal": rescal_score}[model]

    def loss_fn(embs, aux):
        s, r, o, neg = embs["s"], embs["r"], embs["o"], embs["neg"]
        pos = score(s, r, o)
        neg_s = score(neg, r[:, None, :], o[:, None, :])
        neg_o = score(s[:, None, :], r[:, None, :], neg)
        loss = _nll_loss(pos, neg_s, neg_o, self_adv_temp)
        if l2 > 0.0:
            loss = loss + l2 * ((s * s).sum(-1) + (r * r).sum(-1)
                                + (o * o).sum(-1)).mean()
        return loss

    return loss_fn
