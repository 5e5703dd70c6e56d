"""Plain full-entity ranking by distance, for a model whose score is
gamma - distance (RotatE, reference/rotate.py): for each test triple
(s, r, o), the number of entities e != o with distance(s, r, e) <
distance(s, r, o) (object side) and of entities e != s with
distance(e, r, o) < distance(s, r, o) (subject side), over all E
entities: the raw counts the eval program returns. Both sides follow the
published formula, |h r - t| with the candidate in h or in t.

The reference works in complex128 from the f32 rows; the control in
complex64 (f32 arithmetic) with every operand, the rows and the rotation's
cosines and sines, rounded to TF32. `variant` plants a fault for the
limits' readings: "squared" ranks by sum_i |h_i r_i - t_i|^2 (the squared
Euclidean distance), "no_rotation" by sum_i |h_i - t_i| (r = 1)."""
import numpy as np
import torch

from .. import inputs
from ..inputs import ENTITY as ENT, RELATION as REL
from . import model, precision

Q_BLOCK, E_BLOCK = 4, 65_536


def counts(cfg: dict, seed: int, s, r, o, device, control: bool = False,
           variant: str = None):
    """(object-side counts [Q], subject-side counts [Q]) as int64 host
    arrays for PM keys s, r, o (host arrays of [Q])."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m, d = model(cfg["model"]), cfg["dim"]
    E, R = cfg["entities"], cfg["relations"]
    ent = inputs.table(seed, ENT, E, m.entity_emb(d), cfg["init_scale"],
                       device)
    rel = inputs.table(seed, REL, R, m.relation_emb(d), cfg["phase_scale"],
                       device)
    ctype = torch.complex64 if control else torch.complex128
    p = precision.tf32 if control else precision.exact
    s = torch.as_tensor(np.asarray(s), device=device)
    o = torch.as_tensor(np.asarray(o), device=device)
    ri = torch.as_tensor(np.asarray(r), device=device) - E
    se, oe = (m.complex_rows(p(ent[x]), ctype) for x in (s, o))
    rot = m.rotation(rel[ri], ctype)
    rot = torch.complex(p(rot.real), p(rot.imag))
    if variant == "no_rotation":
        rot = torch.ones_like(rot)

    def dist(h, rt, t):
        if variant == "squared":
            return ((h * rt - t).abs() ** 2).sum(-1)
        return m.distance(h, rt, t)

    true = dist(se, rot, oe)
    out_o = torch.zeros(len(s), dtype=torch.int64, device=device)
    out_s = torch.zeros_like(out_o)
    for lo in range(0, E, E_BLOCK):
        cand = m.complex_rows(p(ent[lo:lo + E_BLOCK]), ctype)[None]
        keys = torch.arange(lo, lo + cand.shape[1], device=device)
        for a in range(0, len(s), Q_BLOCK):
            b = slice(a, a + Q_BLOCK)
            t = true[b, None]
            d_o = dist(se[b, None], rot[b, None], cand)
            d_s = dist(cand, rot[b, None], oe[b, None])
            for dd, own, out in ((d_o, o, out_o), (d_s, s, out_s)):
                below = (dd < t) & (keys[None, :] != own[b, None])
                out[b] += below.sum(1)
        del cand
    return out_o.cpu().numpy(), out_s.cpu().numpy()
