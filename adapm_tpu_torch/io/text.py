"""Word2vec corpus IO (reference apps/word2vec.cc:83-144, 445-491):
vocabulary building with min-count pruning, sentence iteration as word-id
arrays, and a synthetic Zipf corpus generator for tests/smoke runs.
The port's own copy of the JAX package's `io/text.py` (pure numpy), so
both produce the same corpora and pairs byte for byte.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Iterator, List, Tuple

import numpy as np

MAX_SENTENCE_LEN = 1000  # reference word2vec.cc sentence chunking


def build_vocab(path: str, min_count: int = 5
                ) -> Tuple[List[str], np.ndarray, Dict[str, int]]:
    """Scan the corpus; return (words, counts, word->id). Words below
    min_count are dropped (reference vocab pruning); ids are ordered by
    descending count (w2v convention)."""
    counter: Counter = Counter()
    with open(path) as f:
        for line in f:
            counter.update(line.split())
    items = [(w, c) for w, c in counter.items() if c >= min_count]
    items.sort(key=lambda wc: (-wc[1], wc[0]))
    words = [w for w, _ in items]
    counts = np.asarray([c for _, c in items], dtype=np.int64)
    vocab = {w: i for i, w in enumerate(words)}
    return words, counts, vocab


def sentences(path: str, vocab: Dict[str, int],
              max_len: int = MAX_SENTENCE_LEN) -> Iterator[np.ndarray]:
    """Yield sentences as int64 word-id arrays; out-of-vocab words are
    skipped; long lines are chunked at max_len (reference behavior)."""
    with open(path) as f:
        for line in f:
            ids = [vocab[w] for w in line.split() if w in vocab]
            for i in range(0, len(ids), max_len):
                chunk = ids[i:i + max_len]
                if chunk:
                    yield np.asarray(chunk, dtype=np.int64)


def generate_synthetic_corpus(path: str, vocab_size: int = 200,
                              num_sentences: int = 500,
                              sentence_len: int = 20, seed: int = 0,
                              zipf_a: float = 1.2) -> None:
    """Zipf-distributed token stream with local co-occurrence structure
    (nearby tokens correlate), so SGNS has signal to learn."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(num_sentences):
            base = rng.zipf(zipf_a, size=sentence_len) % vocab_size
            # co-occurrence: every other token echoes its neighborhood
            for i in range(1, sentence_len, 3):
                base[i] = (base[i - 1] + 1) % vocab_size
            f.write(" ".join(f"w{t}" for t in base) + "\n")


def skipgram_pairs(sent: np.ndarray, window: int,
                   rng: np.random.Generator
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(center, context) pairs with per-position random window shrink
    b ~ U[1, window] (reference PeekableRandom pre-computes these window
    draws, word2vec.cc:445-491). Returns (centers, contexts), in the
    order of a per-pair loop (ascending j per center), built as one
    [n, 2*window] mask."""
    n = len(sent)
    if n < 2:
        return (np.empty(0, dtype=np.int64),) * 2
    b = rng.integers(1, window + 1, size=n)
    offs = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
    i = np.arange(n)
    J = i[:, None] + offs[None, :]                       # [n, 2W]
    valid = (np.abs(offs)[None, :] <= b[:, None]) & (J >= 0) & (J < n)
    centers = sent[np.broadcast_to(i[:, None], J.shape)[valid]]
    contexts = sent[J[valid]]
    return (centers.astype(np.int64), contexts.astype(np.int64))
