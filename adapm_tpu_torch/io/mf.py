"""Matrix-factorization data IO (reference apps/mf/io.h:125-266).

Supports MatrixMarket coordinate files (the reference's `.mma`/`.mmc`
format), plain "i j v" text, and synthetic low-rank generation. Data points
are partitioned into per-worker row blocks and, for DSGD, column blocks with
a worker x subepoch schedule (reference apps/mf/data.h:182-210).
The port's own copy of the JAX package's `io/mf.py` (pure numpy), so
both produce the same data, partitions and schedules.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def read_coo(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Read a sparse matrix in MatrixMarket coordinate format (or bare
    "i j v" lines, 1-based like MM). Returns (rows, cols, vals, m, n)."""
    rows, cols, vals = [], [], []
    m = n = 0
    # only a %%MatrixMarket banner makes the first non-comment line a size
    # line; bare "i j v" files (even with integer values) are all data
    is_mm = False
    size_pending = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("%"):
                if line.startswith("%%MatrixMarket"):
                    is_mm = True
                    size_pending = True
                continue
            parts = line.split()
            if is_mm and size_pending:
                m, n = int(parts[0]), int(parts[1])
                size_pending = False
                continue
            i, j = int(parts[0]) - 1, int(parts[1]) - 1
            v = float(parts[2]) if len(parts) > 2 else 1.0
            rows.append(i)
            cols.append(j)
            vals.append(v)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float32)
    m = max(m, int(rows.max()) + 1 if len(rows) else 0)
    n = max(n, int(cols.max()) + 1 if len(cols) else 0)
    return rows, cols, vals, m, n


def write_dense(path: str, M: np.ndarray) -> None:
    """Write a dense factor matrix in MatrixMarket array format (the
    reference dumps W.mma / H.mma, matrix_factorization.cc:233-355)."""
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix array real general\n")
        f.write(f"{M.shape[0]} {M.shape[1]}\n")
        for v in M.T.ravel():  # MM array format is column-major
            f.write(f"{v}\n")


def read_dense(path: str) -> np.ndarray:
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("%")]
    m, n = (int(x) for x in lines[0].split())
    vals = np.asarray([float(x) for x in lines[1:1 + m * n]], dtype=np.float32)
    return vals.reshape(n, m).T  # column-major -> [m, n]


def generate_synthetic(m: int, n: int, rank: int, nnz: int,
                       seed: int = 0, noise: float = 0.01):
    """Low-rank + noise observations; returns (rows, cols, vals, W, H)."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(m, rank)).astype(np.float32) / np.sqrt(rank)
    H = rng.normal(size=(n, rank)).astype(np.float32) / np.sqrt(rank)
    rows = rng.integers(0, m, nnz).astype(np.int64)
    cols = rng.integers(0, n, nnz).astype(np.int64)
    vals = ((W[rows] * H[cols]).sum(-1)
            + noise * rng.normal(size=nnz)).astype(np.float32)
    return rows, cols, vals, W, H


def partition_points(rows: np.ndarray, num_parts: int, m: int) -> np.ndarray:
    """Assign each data point to a worker by contiguous row block (reference
    partitions training points by row ranges per process, mf/io.h:125+).
    Returns per-point part ids."""
    block = (m + num_parts - 1) // num_parts
    return np.minimum(rows // block, num_parts - 1).astype(np.int32)


def column_block(cols: np.ndarray, num_blocks: int, n: int) -> np.ndarray:
    block = (n + num_blocks - 1) // num_blocks
    return np.minimum(cols // block, num_blocks - 1).astype(np.int32)


def dsgd_schedule(num_workers: int, epoch: int, seed: int = 7) -> np.ndarray:
    """DSGD block schedule: schedule[subepoch, worker] = column block, a
    random derangement-free permutation per subepoch such that within each
    subepoch all workers touch disjoint column blocks (reference WOR schedule,
    apps/mf/data.h:182-210). Returns [num_workers, num_workers]."""
    rng = np.random.default_rng(seed + epoch)
    base = rng.permutation(num_workers)
    out = np.empty((num_workers, num_workers), dtype=np.int64)
    for s in range(num_workers):
        out[s] = (base + s) % num_workers
    return out
