"""RotatE (Sun, Deng, Nie, Tang, ICLR 2019, arXiv:1902.10197) in plain
PyTorch, in complex arithmetic: an entity of dimension d is a complex
vector h in C^d, stored as [re | im] (2d floats); a relation is d phases
theta (radians), r = e^{i theta}, so |r_i| = 1; and

    distance(h, r, t) = sum_i |h_i r_i - t_i|,  score = gamma - distance.

Storage (the port's, as the benchmark fills it): a relation row has the
entities' width, 2d floats, the phases in its first d columns and a
second half that nothing reads. Ranking counts candidates by distance,
so gamma drops out of every rank."""
import torch


def entity_emb(d: int) -> int:
    return 2 * d


def relation_emb(d: int) -> int:
    return 2 * d


def complex_rows(x: torch.Tensor, dtype=torch.complex128) -> torch.Tensor:
    """[..., 2d] rows as [..., d] complex numbers (re, im = halves)."""
    h = x.shape[-1] // 2
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    return torch.complex(x[..., :h].to(real), x[..., h:].to(real))


def rotation(r: torch.Tensor, dtype=torch.complex128) -> torch.Tensor:
    """[..., 2d] relation rows as [..., d] unit complex numbers e^{i theta}
    (theta the first d columns)."""
    h = r.shape[-1] // 2
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    th = r[..., :h].to(real)
    return torch.complex(torch.cos(th), torch.sin(th))


def distance(h, rot, t) -> torch.Tensor:
    """sum_i |h_i rot_i - t_i| over the last axis, in the inputs' complex
    type (broadcasting)."""
    return (h * rot - t).abs().sum(-1)


def score(s, r, o, gamma: float = 12.0) -> torch.Tensor:
    """gamma - distance for [..., 2d] real rows, in float64."""
    return gamma - distance(complex_rows(s), rotation(r), complex_rows(o))
