"""The benchmark's inputs, made from `--seed` alone: the tables' initial
rows, the traffic's key batches and the query batches. Both the program
and the reference get them from here, so the reference takes nothing
the program made.

A table's rows come in slabs of SLAB rows, each slab drawn by a
`torch.Generator` of its own on the card, seeded from (seed, group,
slab): the fill is a few large calls on the device, and the reference
draws any slab again, bit for bit, without holding the rest."""
import numpy as np
import torch

SLAB = 262_144
ENTITY, RELATION = 0, 1          # the two groups of keys


def seed_int(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of the run's inputs."""
    ss = np.random.SeedSequence([int(seed) % 2**64, *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, *tags: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_int(seed, *tags))
    return g


def slab_rows(seed: int, group: int, j: int, n: int, emb: int, scale: float,
              device) -> torch.Tensor:
    """Embedding columns [n, emb] of slab j of a group: normal(0, scale)."""
    out = torch.empty((n, emb), dtype=torch.float32, device=device)
    return out.normal_(0.0, scale, generator=generator(device, seed, 7,
                                                       group, j))


def slabs(seed: int, group: int, n_rows: int, emb: int, scale: float,
          device):
    """(lo, hi, embedding columns) of every slab of a group of n_rows."""
    for j, lo in enumerate(range(0, n_rows, SLAB)):
        hi = min(lo + SLAB, n_rows)
        yield lo, hi, slab_rows(seed, group, j, hi - lo, emb, scale, device)


def table(seed: int, group: int, n_rows: int, emb: int, scale: float,
          device) -> torch.Tensor:
    """A group's whole embedding table [n_rows, emb]."""
    out = torch.empty((n_rows, emb), dtype=torch.float32, device=device)
    for lo, hi, rows in slabs(seed, group, n_rows, emb, scale, device):
        out[lo:hi] = rows
    return out


def skewed(rng: np.random.Generator, n: int, size, power: float):
    """Keys in [0, n) drawn as n * u^power: key 0 the hottest (the
    north-star runs' skew, scripts/northstar.py `skewed`, power 3)."""
    return (n * rng.random(size) ** power).astype(np.int64).clip(0, n - 1)


def triples(rng, E: int, R: int, B: int, power: float):
    """B (s, r, o) triples as PM keys: entities 0..E-1, skewed; relations
    E..E+R-1, uniform."""
    return {"s": skewed(rng, E, B, power),
            "r": E + rng.integers(0, R, B).astype(np.int64),
            "o": skewed(rng, E, B, power)}
