"""ComplEx (Trouillon et al., ICML 2016) in plain PyTorch: an entity or
relation embedding of dimension d is a complex vector stored as
[re | im] (2d floats), and score(s, r, o) = Re(<s, r, conj(o)>)."""
import torch


def entity_emb(d: int) -> int:
    return 2 * d


def relation_emb(d: int) -> int:
    return 2 * d


def _parts(x):
    h = x.shape[-1] // 2
    return x[..., :h], x[..., h:]


def score(s, r, o):
    sr, si = _parts(s)
    rr, ri = _parts(r)
    orr, oi = _parts(o)
    return (sr * rr * orr + si * rr * oi + sr * ri * oi
            - si * ri * orr).sum(-1)


def object_query(s, r):
    """q with score(s, r, e) = q . e for every entity row e."""
    sr, si = _parts(s)
    rr, ri = _parts(r)
    return torch.cat([sr * rr - si * ri, si * rr + sr * ri], -1)


def subject_query(r, o):
    """q with score(e, r, o) = q . e for every entity row e."""
    rr, ri = _parts(r)
    orr, oi = _parts(o)
    return torch.cat([rr * orr + ri * oi, rr * oi - ri * orr], -1)

