"""Plain full-entity ranking: for each test triple (s, r, o), the number
of entities e != o with score(s, r, e) > score(s, r, o) (object side)
and of entities e != s with score(e, r, o) > score(s, r, o) (subject
side), over all E entities: the raw counts the eval program returns.

The reference scores in float64 from the f32 rows; the control scores
in f32 with every product's operands rounded to TF32."""
import numpy as np
import torch

from .. import inputs
from ..inputs import ENTITY as ENT, RELATION as REL
from . import model, precision

Q_BLOCK, E_BLOCK = 1024, 131_072


def counts(cfg: dict, seed: int, s, r, o, device, control: bool = False):
    """(object-side counts [Q], subject-side counts [Q]) as int64 host
    arrays for PM keys s, r, o (host arrays of [Q])."""
    torch.backends.cuda.matmul.allow_tf32 = False
    m, d = model(cfg["model"]), cfg["dim"]
    E, R = cfg["entities"], cfg["relations"]
    scale = cfg["init_scale"]
    ent = inputs.table(seed, ENT, E, m.entity_emb(d), scale, device)
    rel = inputs.table(seed, REL, R, m.relation_emb(d), scale, device)
    dt = torch.float32 if control else torch.float64
    p = precision.tf32 if control else precision.exact
    s = torch.as_tensor(np.asarray(s), device=device)
    o = torch.as_tensor(np.asarray(o), device=device)
    ri = torch.as_tensor(np.asarray(r), device=device) - E
    se, re_, oe = (p(x).to(dt) for x in (ent[s], rel[ri], ent[o]))
    true = m.score(se, re_, oe)
    q_o, q_s = p(m.object_query(se, re_)), p(m.subject_query(re_, oe))
    out_o = torch.zeros(len(s), dtype=torch.int64, device=device)
    out_s = torch.zeros_like(out_o)
    for lo in range(0, E, E_BLOCK):
        cand = p(ent[lo:lo + E_BLOCK]).to(dt)
        keys = torch.arange(lo, lo + cand.shape[0], device=device)
        for a in range(0, len(s), Q_BLOCK):
            b = slice(a, a + Q_BLOCK)
            t = true[b, None]
            for q, own, out in ((q_o, o, out_o), (q_s, s, out_s)):
                above = (q[b] @ cand.T) > t
                above &= keys[None, :] != own[b, None]
                out[b] += above.sum(1)
        del cand
    return out_o.cpu().numpy(), out_s.cpu().numpy()
