"""Knowledge-graph triple IO (reference apps/knowledge_graph_embeddings.cc
dataset loading + filtered-eval index construction, kge.cc:544-775): the
JAX package's `io/kge.py`, whose host paths it repeats draw for draw, so
equal seeds give bitwise equal datasets. The device path of
`generate_lowrank` runs in torch (see its docstring).

Triple files are whitespace-separated integer id lines "s r o" (the
reference's del format). Filters map (s, r) -> {o} and (r, o) -> {s} over
all splits, for filtered MRR / Hits@k.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Optional, Set, Tuple

import numpy as np


@dataclasses.dataclass
class TripleDataset:
    num_entities: int
    num_relations: int
    train: np.ndarray            # [N, 3] int64 (s, r, o)
    valid: Optional[np.ndarray] = None
    test: Optional[np.ndarray] = None
    # per-side generating-model ceilings (lowrank synthetic only)
    truth_mrr_o: Optional[float] = None
    truth_mrr_s: Optional[float] = None

    def filters(self) -> Tuple[Dict, Dict]:
        """(s,r)->set(o), (r,o)->set(s) over all splits (filtered eval
        excludes *known true* triples from the ranking, kge.cc Evaluator)."""
        sr_o: Dict[Tuple[int, int], Set[int]] = defaultdict(set)
        ro_s: Dict[Tuple[int, int], Set[int]] = defaultdict(set)
        for split in (self.train, self.valid, self.test):
            if split is None:
                continue
            for s, r, o in split:
                sr_o[(int(s), int(r))].add(int(o))
                ro_s[(int(r), int(o))].add(int(s))
        return dict(sr_o), dict(ro_s)


def read_triples(path: str) -> np.ndarray:
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                out.append((int(parts[0]), int(parts[1]), int(parts[2])))
    return np.asarray(out, dtype=np.int64).reshape(-1, 3)


def load_dataset(train_path: str, valid_path: Optional[str] = None,
                 test_path: Optional[str] = None,
                 num_entities: Optional[int] = None,
                 num_relations: Optional[int] = None) -> TripleDataset:
    train = read_triples(train_path)
    valid = read_triples(valid_path) if valid_path else None
    test = read_triples(test_path) if test_path else None
    splits = [t for t in (train, valid, test) if t is not None and len(t)]
    all_t = np.concatenate(splits) if splits else train
    E = num_entities or int(max(all_t[:, 0].max(), all_t[:, 2].max())) + 1
    R = num_relations or int(all_t[:, 1].max()) + 1
    return TripleDataset(E, R, train, valid, test)


def generate_synthetic(num_entities: int = 120, num_relations: int = 8,
                       n_train: int = 1500, n_valid: int = 100,
                       n_test: int = 100, seed: int = 0) -> TripleDataset:
    """Random KG with learnable structure: each relation r is a fixed
    permutation + small cluster noise, so (s, r) largely determines o and
    embeddings can reach good filtered MRR."""
    rng = np.random.default_rng(seed)
    perms = [rng.permutation(num_entities) for _ in range(num_relations)]

    def draw(n):
        s = rng.integers(0, num_entities, n)
        r = rng.integers(0, num_relations, n)
        o = np.array([perms[ri][si] for si, ri in zip(s, r)])
        # noise: a few percent of objects are random
        noise = rng.random(n) < 0.05
        o[noise] = rng.integers(0, num_entities, int(noise.sum()))
        return np.stack([s, r, o], axis=1).astype(np.int64)

    return TripleDataset(num_entities, num_relations,
                         draw(n_train), draw(n_valid), draw(n_test))


def generate_lowrank(num_entities: int = 120, num_relations: int = 8,
                     n_train: int = 1500, n_valid: int = 100,
                     n_test: int = 100, dim_truth: int = 16,
                     temperature: float = 0.25,
                     seed: int = 0,
                     device: Optional[bool] = None,
                     torch_device="cuda"
                     ) -> Tuple[TripleDataset, float]:
    """KG drawn from a GROUND-TRUTH ComplEx model: for a random (s, r),
    o is sampled from softmax(z / temperature) where z is the true
    bilinear score (row-normalized). Unlike `generate_synthetic`'s random
    permutations (full-rank, adversarial for bilinear models), this graph
    IS low-rank by construction, so a trained ComplEx of dim >= dim_truth
    can approach the GENERATING model's own filtered MRR — which is the
    right ceiling, returned as the second element: sampling at finite
    temperature means even the truth cannot rank every sampled object
    first. The mid-scale quality harness asserts trained-MRR as a
    fraction of truth-MRR (docs/PERF.md).

    `device` moves the per-chunk score matmul + Gumbel-max onto the torch
    device `torch_device` (auto at num_entities >= 20000): the
    [chunk, E] score matrix is matmul+argmax work a GPU does in
    milliseconds, while the host numpy path needs minutes per chunk at
    E=50k — hours for an MRR@scale dataset. The truth MODEL (ent/rel)
    and the (s, r) draws come from the same numpy stream either way; the
    object draws use a torch.Generator on the device path, so its
    datasets differ from the host path's at equal seeds, and from the
    JAX package's device path too (whose draws come from JAX's PRNG),
    just as the JAX package's own two paths differ.

    RNG-stream break (round 5, ADVICE r5 #3): the HOST path's object
    draw switched from `rng.gumbel` (float64) to a float32
    inverse-transform (`-log(-log(rng.random(float32)))`), which changes
    how the generator consumes the numpy bit stream. Host-path datasets
    at a given seed therefore differ from those generated by pre-r5
    builds — numbers pinned against older datasets (docs/PERF.md) are
    not bit-reproducible across that boundary, though the ratio-based
    tests tolerate it. Within any post-r5 build the host stream is
    deterministic as usual."""
    if device is None:
        device = num_entities >= 20_000
    if device:
        return _generate_lowrank_device(num_entities, num_relations,
                                        n_train, n_valid, n_test,
                                        dim_truth, temperature, seed,
                                        torch_device)
    rng = np.random.default_rng(seed)
    d = dim_truth
    ent = rng.normal(size=(num_entities, d)) + \
        1j * rng.normal(size=(num_entities, d))
    rel = rng.normal(size=(num_relations, d)) + \
        1j * rng.normal(size=(num_relations, d))

    def zscores(s, r):
        q = ent[s] * rel[r]                            # [c, d] complex
        sc = np.real(q @ ent.conj().T)                 # [c, E]
        sc -= sc.mean(axis=1, keepdims=True)
        sc /= sc.std(axis=1, keepdims=True)
        return sc

    def draw(n):
        s = rng.integers(0, num_entities, n)
        r = rng.integers(0, num_relations, n)
        o = np.empty(n, dtype=np.int64)
        for lo in range(0, n, 4096):  # bound the [chunk, E] score matrix
            hi = min(lo + 4096, n)
            z = (zscores(s[lo:hi], r[lo:hi]) / temperature).astype(
                np.float32)
            # Gumbel-max trick; drawn in float32 (rng.gumbel is
            # float64-only and dominates generation time at E >= 50k)
            u = rng.random(size=z.shape, dtype=np.float32)
            np.clip(u, np.float32(1e-12), None, out=u)
            g = -np.log(-np.log(u))
            o[lo:hi] = (z + g).argmax(axis=1)
        return np.stack([s, r, o], axis=1).astype(np.int64)

    tr, va, te = draw(n_train), draw(n_valid), draw(n_test)
    ds = TripleDataset(num_entities, num_relations, tr, va, te)

    # the ceiling: the truth model's own filtered MRR on test, BOTH sides
    # (the app's evaluate() corrupts subject and object alike). Note the
    # subject side is intrinsically weak for this generator — s is drawn
    # uniformly, so even the truth ranks it poorly at large E.
    sr_o, ro_s = ds.filters()

    def zscores_s(r, o):  # score of every candidate subject
        q = rel[r] * ent[o].conj()
        sc = np.real(ent @ q.T).T                      # [c, E]
        sc -= sc.mean(axis=1, keepdims=True)
        sc /= sc.std(axis=1, keepdims=True)
        return sc

    rr_o: list = []
    rr_s: list = []
    for lo in range(0, len(te), 4096):
        chunk = te[lo:lo + 4096]
        _truth_rr_chunk(chunk, zscores(chunk[:, 0], chunk[:, 1]),
                        zscores_s(chunk[:, 1], chunk[:, 2]),
                        sr_o, ro_s, rr_o, rr_s)
    # per-side ceilings ride as attributes: the subject side is
    # information-free by construction at large E (s ~ uniform), so
    # mid-scale quality is judged against the OBJECT ceiling
    # (apps/.. result["mrr_o"] vs ds.truth_mrr_o)
    ds.truth_mrr_o = float(np.mean(rr_o))
    ds.truth_mrr_s = float(np.mean(rr_s))
    return ds, float(np.mean(rr_o + rr_s))


def _truth_rr_chunk(chunk: np.ndarray, zo: np.ndarray, zs: np.ndarray,
                    sr_o: Dict, ro_s: Dict, rr_o: list, rr_s: list) -> None:
    """Filtered reciprocal ranks of the TRUTH model for one test chunk,
    both sides — shared by the host and device generator paths so the
    rank rule (strict `>` + known-true exclusion) cannot diverge
    between the ceilings tests compare against."""
    for i, (s, r, o) in enumerate(chunk):
        for z, true_e, flt, acc in (
                (zo[i], int(o), sr_o.get((int(s), int(r)), ()), rr_o),
                (zs[i], int(s), ro_s.get((int(r), int(o)), ()), rr_s)):
            better = int((z > z[true_e]).sum()) - sum(
                1 for e in flt if e != true_e and z[e] > z[true_e])
            acc.append(1.0 / (1 + better))


def _generate_lowrank_device(num_entities: int, num_relations: int,
                             n_train: int, n_valid: int, n_test: int,
                             dim_truth: int, temperature: float, seed: int,
                             torch_device) -> Tuple[TripleDataset, float]:
    """Device path of generate_lowrank (see its docstring): the truth
    model's complex bilinear scores as two real f32 matmuls on
    `torch_device` and a Gumbel-max object draw from a torch.Generator
    seeded per split, in chunks of 4096 (s, r) pairs."""
    import torch

    E, R, d, T = num_entities, num_relations, dim_truth, temperature
    dev = torch.device(torch_device)
    rng = np.random.default_rng(seed)
    # same numpy draws as the host path (model identity is shared)
    entc = rng.normal(size=(E, d)) + 1j * rng.normal(size=(E, d))
    relc = rng.normal(size=(R, d)) + 1j * rng.normal(size=(R, d))

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=dev)

    er, ei, rr, ri = put(entc.real), put(entc.imag), put(relc.real), \
        put(relc.imag)
    C = 4096

    def _norm(sc):
        sc = sc - sc.mean(dim=1, keepdim=True)
        return sc / sc.std(dim=1, correction=0, keepdim=True)

    def z_o(s, r):
        # Re(<s, r, conj(e)>) for all e: q = ent[s] * rel[r];
        # Re(q @ conj(ent).T) = qr @ er.T + qi @ ei.T
        qr = er[s] * rr[r] - ei[s] * ri[r]
        qi = er[s] * ri[r] + ei[s] * rr[r]
        return _norm(qr @ er.T + qi @ ei.T)

    def z_s(r, o):
        # candidate-subject scores: q = rel[r] * conj(ent[o]);
        # Re(ent @ q.T) = er @ qr.T - ei @ qi.T, transposed to [c, E]
        qr = rr[r] * er[o] + ri[r] * ei[o]
        qi = ri[r] * er[o] - rr[r] * ei[o]
        return _norm(qr @ er.T - qi @ ei.T)

    def draw(n, split_id):
        s = rng.integers(0, E, n)
        r = rng.integers(0, R, n)
        o = np.empty(n, dtype=np.int64)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 3 + split_id)
        for lo in range(0, n, C):
            hi = min(lo + C, n)
            st = torch.as_tensor(s[lo:hi], device=dev)
            rt = torch.as_tensor(r[lo:hi], device=dev)
            z = z_o(st, rt) / T
            # Gumbel-max: -log(-log(u)), u clipped away from 0 as on the
            # host path
            u = torch.rand(z.shape, generator=gen, device=dev)
            z += -torch.log(-torch.log(u.clamp_(min=1e-12)))
            o[lo:hi] = z.argmax(dim=1).cpu().numpy()
        return np.stack([s, r, o], axis=1).astype(np.int64)

    tr, va, te = draw(n_train, 0), draw(n_valid, 1), draw(n_test, 2)
    ds = TripleDataset(E, R, tr, va, te)

    # truth ceilings: scores for the (small) test split come back to the
    # host in [<=256, E] slabs for the filtered correction
    sr_o, ro_s = ds.filters()
    rr_acc: list = []
    rs_acc: list = []
    for lo in range(0, len(te), 256):
        chunk = te[lo:lo + 256]
        c = torch.as_tensor(chunk, device=dev)
        _truth_rr_chunk(chunk, z_o(c[:, 0], c[:, 1]).cpu().numpy(),
                        z_s(c[:, 1], c[:, 2]).cpu().numpy(),
                        sr_o, ro_s, rr_acc, rs_acc)
    ds.truth_mrr_o = float(np.mean(rr_acc))
    ds.truth_mrr_s = float(np.mean(rs_acc))
    return ds, float(np.mean(rr_acc + rs_acc))
