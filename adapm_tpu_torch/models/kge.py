"""Knowledge-graph embedding models: ComplEx, RESCAL and RotatE, as
PyTorch functions on batches of gathered rows (the JAX package's
`models/kge.py`, which has ComplEx and RESCAL; reference
apps/knowledge_graph_embeddings.cc: ComplEx :832-858, RESCAL :860-907;
RotatE: Sun et al., ICLR 2019, arXiv:1902.10197).

Embedding layout: an entity row holds a complex vector of dimension `dim`
as [re | im] (2*dim floats); ComplEx relations are the same; RESCAL
relations are a real dim x dim matrix (dim^2 floats). A RotatE relation
is `dim` phases theta (radians), r = e^{i theta}; as a storage choice its
row keeps the entities' width, 2*dim floats, so relations share the
entities' length class and pool: the phases sit in the first `dim`
columns, the second half is held and never read (its gradient is zero).
The stored value row additionally carries the AdaGrad accumulator
([emb | acc], ops/fused.py). ComplEx and RESCAL run their step as a
hand-written kernel (KgeLoss.fused_update): ComplEx as K5 (ops/kernels.py
complex_step), RESCAL as K16 (rescal_step); RotatE, and a batch of
negatives shared by the triples ([N] rather than [B, N]), run as
autograd over the gathered rows.

The eval programs rank every entity for both sides of a triple:
`make_eval_scores` against a dense entity matrix, and
`make_pool_eval_counts`, which counts the candidates ranked above the
true triple straight from the main pool through a hand-written kernel:
ComplEx and RESCAL through K4 (ops/kernels.py pool_eval_counts, scores
as dot products), RotatE through K17 (pool_eval_dist, by distance).
`make_pool_eval_counts_mp` is its multi-process form, the same kernels
with query rows in, only the rank's owned entities as candidates and the
true score an input. Both open the program spans `eval.rows` (the query
rows' K1 gathers), `eval.queries` (the true score and the kernel's query
rows) and `eval.k4` or `eval.k17` (the kernel's call) back to back
(obs/spans.py span: the span tracer they are built with, and
torch.profiler's trace while one records).

RotatE ranks by score = gamma - distance; the eval programs and
`score_numpy` use gamma = 0 (the rank score -distance), since gamma drops
out of every rank.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..exec import dispatch_gate
from ..obs.spans import span
from ..ops.kernels import (_complex_distance, complex_step,
                           pool_eval_counts,
                           pool_eval_counts_plain, pool_eval_dist,
                           pool_eval_dist_plain, rescal_step,
                           routed_gather)


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


def _rotation(r: torch.Tensor):
    """(cos, sin) of a RotatE relation row's phases, its first d of 2d
    columns."""
    th = r[..., :r.shape[-1] // 2]
    return torch.cos(th), torch.sin(th)


def _rotate(x: torch.Tensor, c: torch.Tensor, n: torch.Tensor):
    """x o e^{i theta} for [..., 2d] complex rows [re | im], given cos c and
    sin n of theta."""
    d = x.shape[-1] // 2
    xr, xi = x[..., :d], x[..., d:]
    return torch.cat([xr * c - xi * n, xr * n + xi * c], -1)


def rotate_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_i |x_i - y_i| over the complex components of [..., 2d] rows."""
    d = x.shape[-1] // 2
    dr = x[..., :d] - y[..., :d]
    di = x[..., d:] - y[..., d:]
    return torch.sqrt(dr * dr + di * di).sum(-1)


def rotate_score(s: torch.Tensor, r: torch.Tensor, o: torch.Tensor,
                 margin: float = 0.0) -> torch.Tensor:
    """gamma - sum_i |s_i r_i - o_i| (RotatE, gamma = `margin`) for
    [..., 2d] entity rows and relation rows of phases."""
    return margin - rotate_distance(_rotate(s, *_rotation(r)), o)


def _rotate_queries(s, r, o):
    """RotatE's all-entity query rows: object side a = s o r, subject side
    b = o o conj(r), so that the candidate e's distance is |a - e| on the
    object side and |b - e| on the subject side. The subject side uses
    |e o r - o| = |e - o o conj(r)|, true because |r_i| = 1: the one
    departure from the published formula, exact in exact arithmetic."""
    c, n = _rotation(r)
    return _rotate(s, c, n), _rotate(o, c, -n)


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


class KgeLoss:
    """loss_fn(embs, aux) for ops/fused.py. Roles: s, r, o [B, *]; neg
    [B, N] entity embeddings corrupting both the subject and the object
    side. `l2` > 0 adds per-batch (lazy) L2 on the positive triple's
    rows.

    `fused_update` is the loss's fused form: the fused step runs it in
    place of autograd and K2 where `fused_fits(rows)` holds. ComplEx's
    is the hand-written kernel K5 (ops/kernels.py complex_step),
    RESCAL's K16 (rescal_step). RotatE has none (`fused_update` is None):
    its self-adversarial loss (RotatE eq. 5) is this loss with
    score = gamma - distance, gamma = `margin`, through autograd + K2."""

    def __init__(self, model: str = "complex", self_adv_temp: float = 0.0,
                 l2: float = 0.0, margin: float = 0.0):
        self.score = {"complex": complex_score, "rescal": rescal_score,
                      "rotate": partial(rotate_score,
                                        margin=float(margin))}[model]
        self.model = model
        self.self_adv_temp = float(self_adv_temp)
        self.l2 = float(l2)
        self.fused_update = {"complex": self._complex_update,
                             "rescal": self._rescal_update}.get(model)

    def fused_fits(self, rows) -> bool:
        """Whether the model's kernel takes these gathered rows: s, o
        [B, 2e] and neg [B, N, 2e] (e the entity width), r [B, 2e] for
        ComplEx (K5) or [B, 2e^2] for RESCAL (K16). The loss itself also
        takes a neg role of other shapes (a [N] batch of negatives is
        broadcast over the triples, as in the JAX package); those run as
        autograd + K2."""
        s, r, o, neg = rows["s"], rows["r"], rows["o"], rows["neg"]
        if not (s.dim() == 2 and o.shape == s.shape and neg.dim() == 3
                and neg.shape[0] == s.shape[0] and neg.shape[2] == s.shape[1]
                and r.dim() == 2 and r.shape[0] == s.shape[0]):
            return False
        if self.model == "complex":
            return r.shape == s.shape
        return r.shape[1] == 2 * (s.shape[1] // 2) ** 2

    def __call__(self, embs, aux):
        s, r, o, neg = embs["s"], embs["r"], embs["o"], embs["neg"]
        pos = self.score(s, r, o)
        neg_s = self.score(neg, r[:, None, :], o[:, None, :])
        neg_o = self.score(s[:, None, :], r[:, None, :], neg)
        loss = _nll_loss(pos, neg_s, neg_o, self.self_adv_temp)
        if self.l2 > 0.0:
            loss = loss + self.l2 * ((s * s).sum(-1) + (r * r).sum(-1)
                                     + (o * o).sum(-1)).mean()
        return loss

    def _complex_update(self, rows, out, lr_eps, aux) -> torch.Tensor:
        """The ComplEx loss, its gradient and the AdaGrad delta rows in
        one K5 launch: `rows` maps s, r, o, neg to gathered [emb | acc]
        rows, `out` each trainable role to its delta rows (a frozen role
        is missing), `lr_eps` is (lr, eps) on the rows' device; `aux` is
        unused. Returns the mean loss."""
        return self._fused(complex_step, rows, out, lr_eps)

    def _rescal_update(self, rows, out, lr_eps, aux) -> torch.Tensor:
        """The RESCAL loss, its gradient and the AdaGrad delta rows in
        one K16 launch; arguments and result as _complex_update."""
        return self._fused(rescal_step, rows, out, lr_eps)

    def _fused(self, kernel, rows, out, lr_eps) -> torch.Tensor:
        if sorted(rows) != ["neg", "o", "r", "s"]:
            raise ValueError(f"KgeLoss: roles {sorted(rows)}, expected "
                             "s, r, o, neg")
        per = kernel(rows["s"], rows["r"], rows["o"], rows["neg"], lr_eps,
                     self.self_adv_temp, self.l2, out=out)
        return per.sum() / per.shape[0]


def make_kge_loss(model: str = "complex", self_adv_temp: float = 0.0,
                  l2: float = 0.0, margin: float = 0.0) -> KgeLoss:
    return KgeLoss(model, self_adv_temp, l2, margin)


def _complex_queries(s, r, o):
    """Coefficients of the all-entity ComplEx scores: object prediction
    Re(<s, r, conj(e)>) = a.e_re + b.e_im, subject prediction
    Re(<e, r, conj(o)>) = c.e_re + dcoef.e_im."""
    d = s.shape[-1] // 2
    sr, si = s[..., :d], s[..., d:]
    rr, ri = r[..., :d], r[..., d:]
    orr, oi = o[..., :d], o[..., d:]
    a = sr * rr - si * ri
    b = sr * ri + si * rr
    c = rr * orr + ri * oi
    dcoef = rr * oi - ri * orr
    return a, b, c, dcoef


def _rescal_queries(s, r, o):
    """RESCAL's all-entity query rows: s^T R (object side), R o (subject
    side)."""
    d = s.shape[-1]
    R = r.reshape(r.shape[:-1] + (d, d))
    return torch.einsum("bi,bij->bj", s, R), torch.einsum("bij,bj->bi", R, o)


def complex_eval_scores(ent: torch.Tensor, rel, s: torch.Tensor,
                        r: torch.Tensor, o: torch.Tensor):
    """All-entity scores for filtered-MRR eval (kge.cc Evaluator
    :544-775): given the entity matrix [E, 2d] and a triple batch, return
    (scores_o [B, E] for object prediction, scores_s [B, E] for subject),
    one pair of matmuls per side."""
    d = ent.shape[-1] // 2
    er, ei = ent[..., :d], ent[..., d:]
    a, b, c, dcoef = _complex_queries(s, r, o)
    return a @ er.T + b @ ei.T, c @ er.T + dcoef @ ei.T


def rescal_eval_scores(ent: torch.Tensor, rel, s: torch.Tensor,
                       r: torch.Tensor, o: torch.Tensor):
    """All-entity RESCAL scores s^T R e (object side) and e^T R o (subject
    side) as two matmuls against the entity matrix [E, d]."""
    sR, Ro = _rescal_queries(s, r, o)
    return sR @ ent.T, Ro @ ent.T


def rotate_eval_scores(ent: torch.Tensor, rel, s: torch.Tensor,
                       r: torch.Tensor, o: torch.Tensor):
    """All-entity RotatE rank scores, -distance (gamma drops out of every
    rank): -|a - e| (object side) and -|b - e| (subject side) against the
    entity matrix [E, 2d], by K17's plain distance (ops/kernels.py
    _complex_distance, in blocks of entities)."""
    a, b = _rotate_queries(s, r, o)
    return -_complex_distance(a, ent), -_complex_distance(b, ent)


def make_eval_scores(model: str):
    return {"complex": complex_eval_scores,
            "rescal": rescal_eval_scores,
            "rotate": rotate_eval_scores}[model]


def score_numpy(model: str, s, r, o):
    """Host-side scoring of a handful of (s, r, o) rows in float64 — used
    for the filtered-rank correction, whose per-batch filter sets are
    tiny."""
    s, r, o = (np.asarray(x, dtype=np.float64) for x in (s, r, o))
    if model == "rotate":   # the rank score -sum_i |s_i r_i - o_i|
        d = s.shape[-1] // 2
        th = r[..., :d]
        sr = s[..., :d] * np.cos(th) - s[..., d:] * np.sin(th)
        si = s[..., :d] * np.sin(th) + s[..., d:] * np.cos(th)
        return -np.hypot(sr - o[..., :d], si - o[..., d:]).sum(-1)
    if model == "complex":
        d = s.shape[-1] // 2
        sr, si = s[..., :d], s[..., d:]
        rr, ri = r[..., :d], r[..., d:]
        orr, oi = o[..., :d], o[..., d:]
        return (sr * rr * orr + si * rr * oi
                + sr * ri * oi - si * ri * orr).sum(-1)
    d = s.shape[-1]
    R = r.reshape(r.shape[:-1] + (d, d))
    return np.einsum("...i,...ij,...j->...", s, R, o)


_RANK_SCORE = {"complex": complex_score, "rescal": rescal_score,
               "rotate": rotate_score}


def make_true_score(model: str):
    """True-triple scores from query ROWS: fn(se, re_, oe) -> [B] (RotatE:
    the rank score -distance)."""
    score = _RANK_SCORE[model]

    def fn(se, re_, oe):
        return score(se, re_, oe)

    return fn


def _pool_rows(pool, owner, slot, keys, dim):
    """The first `dim` columns of the main-pool rows of `keys` (K1)."""
    k = keys.long()
    with dispatch_gate():
        rows = routed_gather(pool, None, None, owner.index_select(0, k),
                             slot.index_select(0, k))
    return rows[:, :dim]


def _k4_counts(model, ent_main, owner, slot, ent_keys, nvalid, se, re_,
               oe, true_sc, skeys, okeys, ties, tracer=None, score=None):
    """K4 over the first `nvalid` candidates of `ent_keys` for the query
    rows se/re_/oe: ((g_o, g_s), or with `ties` K4's plain version's
    (g_o, g_s, t_o, t_s); true_sc), in the spans `eval.queries` and
    `eval.k4`. Given `score`, the true scores are score(se, re_, oe),
    one a triple for both sides, computed in `eval.queries`."""
    with span(tracer, "eval.queries"):
        if score is not None:
            true_sc = score(se, re_, oe)
        if model == "complex":
            a, b, c, dcoef = _complex_queries(se, re_, oe)
            q_o, q_s = torch.cat([a, b], -1), torch.cat([c, dcoef], -1)
        else:
            q_o, q_s = _rescal_queries(se, re_, oe)
        args = (ent_main, owner, slot, ent_keys, int(nvalid),
                q_o.contiguous(), q_s.contiguous(), true_sc.contiguous(),
                okeys.to(torch.int32), skeys.to(torch.int32))
    with span(tracer, "eval.k4"):
        parts = 2 if model == "complex" else 1
        if ties:
            out = pool_eval_counts_plain(*args, parts=parts, ties=True)
        else:
            out = pool_eval_counts(*args, parts=parts)
    return out, true_sc


def _k17_counts(model, ent_main, owner, slot, ent_keys, nvalid, se, re_,
                oe, true_sc, skeys, okeys, ties, tracer=None, score=None):
    """K17 over the first `nvalid` candidates of `ent_keys` for RotatE's
    query rows: as _k4_counts, with the rank score -distance, so K17
    counts the candidates nearer than the true distance -true_sc. In the
    spans `eval.queries` and `eval.k17`."""
    with span(tracer, "eval.queries"):
        if score is not None:
            true_sc = score(se, re_, oe)
        q_o, q_s = _rotate_queries(se, re_, oe)
        args = (ent_main, owner, slot, ent_keys, int(nvalid),
                q_o.contiguous(), q_s.contiguous(),
                (-true_sc).contiguous(), okeys.to(torch.int32),
                skeys.to(torch.int32))
    with span(tracer, "eval.k17"):
        if ties:
            out = pool_eval_dist_plain(*args, ties=True)
        else:
            out = pool_eval_dist(*args)
    return out, true_sc


def make_pool_eval_counts(model: str, ent_dim: int, rel_dim: int,
                          chunk: int, shared_pool: bool = False,
                          tracer=None):
    """Full-entity eval without materializing the entity matrix: candidate
    rows are read straight from the main POOL (the JAX package's
    make_pool_eval_counts, a lax.scan over [B, chunk] tiles there; here
    a hand-written kernel over the whole padded key table: K4 for
    ComplEx and RESCAL, K17 for RotatE, which ranks by distance and
    returns the rank score -distance as its true score).

    Returns fn(ent_main, rel_main, tables, ent_keys [nch, chunk] int32
    (padded with a real key), nE, skeys [B], rkeys [B], okeys [B]) ->
    (greater_o [B], greater_s [B], true_sc [B]): for each side, the
    number of real candidates scoring strictly above the true triple,
    the true entity excluded by key (the candidate dot rounds differently
    from the direct true score, so it could otherwise count itself by an
    ulp). Filtered-rank correction happens on the host over the (tiny)
    per-triple filter sets (apps/knowledge_graph_embeddings.py).

    shared_pool=True drops the rel_main parameter and reads relation rows
    from ent_main (entities and relations in one length class).

    `ties=True` (for checks) computes the counts with the kernel's plain
    version instead and also returns the per-side near-tie counts
    (ops/kernels.py pool_eval_counts_plain, pool_eval_dist_plain).

    `tracer` (obs/spans.py SpanTracer, or None) records the program's
    spans; torch.profiler sees them without one."""
    score = _RANK_SCORE[model]
    kernel_counts = _k17_counts if model == "rotate" else _k4_counts

    def counts(ent_main, rel_main, tables, ent_keys, nE, skeys, rkeys,
               okeys, ties=False):
        if ent_keys.shape[1] != chunk:
            raise ValueError(f"key tiles are {ent_keys.shape[1]} wide, the "
                             f"program was built for chunk {chunk}")
        owner, slot, _ = tables
        with span(tracer, "eval.rows"):
            se = _pool_rows(ent_main, owner, slot, skeys, ent_dim)
            oe = _pool_rows(ent_main, owner, slot, okeys, ent_dim)
            rpool = ent_main if shared_pool else rel_main
            re_ = _pool_rows(rpool, owner, slot, rkeys, rel_dim)
        out, true_sc = kernel_counts(model, ent_main, owner, slot,
                                     ent_keys, nE, se, re_, oe, None, skeys,
                                     okeys, ties, tracer, score)
        return out[:2] + (true_sc,) + out[2:]

    if shared_pool:
        def counts_shared(ent_main, tables, ent_keys, nE, skeys, rkeys,
                          okeys, ties=False):
            return counts(ent_main, None, tables, ent_keys, nE, skeys,
                          rkeys, okeys, ties=ties)
        return counts_shared
    return counts


def make_pool_eval_counts_mp(model: str, ent_dim: int, rel_dim: int,
                             chunk: int, tracer=None):
    """Candidate-partitioned twin of make_pool_eval_counts (the JAX
    package's make_pool_eval_counts_mp, the multi-process chunked eval):

      - the query embeddings arrive as ROWS (se/re_/oe, fetched through
        Server.read_main, which resolves remote owners over the channel)
        instead of keys, so only CANDIDATE rows are gathered — exactly
        this rank's owned entities, always in the local pool;
      - `ent_keys` tiles cover the rank's OWNED entities only, padded at
        the tail (`nvalid` masks the padding); each entity has exactly
        one owner, so N ranks partition the candidate set exactly and
        the per-rank greater-counts sum to the global counts (reference
        distributed Evaluator, kge.cc:544-775);
      - the true score is an INPUT (make_true_score), the same bytes on
        every rank.

    fn(ent_main, tables, ent_keys [nch, chunk] int32, nvalid, se, re_,
       oe, skeys [B], okeys [B], true_sc [B]) -> (greater_o [B],
       greater_s [B]), through the model's kernel itself (K4,
    ops/kernels.py pool_eval_counts; RotatE's K17, pool_eval_dist, with
    true_sc the rank score -distance) over the owned tiles, its queries
    formed as make_pool_eval_counts forms them. `ties=True`
    (for checks) counts with its plain version and also returns the
    per-side near-tie counts. `tracer` as in make_pool_eval_counts (the
    spans `eval.queries` and `eval.k4` or `eval.k17`)."""
    kernel_counts = _k17_counts if model == "rotate" else _k4_counts

    def counts(ent_main, tables, ent_keys, nvalid, se, re_, oe, skeys,
               okeys, true_sc, ties=False):
        if ent_keys.shape[1] != chunk:
            raise ValueError(f"key tiles are {ent_keys.shape[1]} wide, the "
                             f"program was built for chunk {chunk}")
        owner, slot, _ = tables
        return kernel_counts(model, ent_main, owner, slot, ent_keys, nvalid,
                             se[:, :ent_dim], re_[:, :rel_dim],
                             oe[:, :ent_dim], true_sc, skeys, okeys, ties,
                             tracer)[0]

    return counts
