"""Sampling access management: PrepareSample / PullSample / FinishSample.

Reference include/ps/sampling.h — the PM manages negative-sampling access so
it can exploit locality (NuPS heritage). Four schemes (sampling.h:180-525):

  naive   draw keys at prepare time, plain Pull at pull time
  preloc  naive + Intent on the drawn keys at prepare time
  pool    shared pool of samples, refreshed with a reuse factor
  local   (default) draw from the app distribution, then snap to a key that
          is *locally available* — trades exact distribution for locality
          (documented distortion, sampling.h:361-365)

The Local scheme keeps a sorted array of locally-resident keys per shard
and snaps with np.searchsorted (binary search) instead of the reference's
linear key probe (sampling.h:476-505), refreshed lazily when the
placement topology changes.

This is the JAX package's `core/sampling.py`. The schemes draw on the
host from numpy Generators and consume the numpy stream in the same
order as there, so the same seed and the same placement give the same
sampled keys.

The app supplies `sample_key_fn(n, rng) -> keys` (reference `Key
sample_key()`), e.g. unigram^0.75 for word2vec.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..base import NO_SLOT


class _Handle:
    __slots__ = ("n", "start", "end", "keys", "pos", "seen")

    def __init__(self, n: int, start: int, end: int):
        self.n = n
        self.start = start
        self.end = end
        self.keys: Optional[np.ndarray] = None  # pre-drawn (naive/preloc)
        self.pos = 0
        self.seen: set = set()                  # without-replacement dedup


class SamplingBase:
    def __init__(self, server, sample_key_fn, min_key: int, max_key: int,
                 allowed_keys: Optional[np.ndarray] = None, seed: int = 42):
        self.server = server
        self.sample_key_fn = sample_key_fn
        self.min_key = min_key
        self.max_key = max_key
        # Local scheme: the population a drawn key may snap to. The reference
        # expresses this as the contiguous [min_key, max_key) sampling range
        # (sampling.h:476-505); with enforce_random_keys the eligible keys
        # (e.g. entities, syn1 rows) are scattered, so an explicit key set is
        # needed to keep snapping inside the sampled population.
        self.allowed_keys = None if allowed_keys is None else \
            np.unique(np.asarray(allowed_keys, dtype=np.int64))
        self.opts = server.opts
        self._rngs: Dict[int, np.random.Generator] = {}
        self._handles: Dict[Tuple[int, int], _Handle] = {}
        self._next_id: Dict[int, int] = {}
        self._seed = seed
        # RNG batching (--sampling.batch_size, reference sampling.h:394-405):
        # per-worker buffer of pre-drawn keys so small draws (WOR probes draw
        # one key at a time) amortize the app sample_key_fn call
        self._draw_buf: Dict[int, Tuple[np.ndarray, int]] = {}
        # per-scheme access stats (reference sampling.h:85-97)
        self.stats = {"prepared": 0, "pulled": 0, "pulled_local": 0}

    def _rng(self, worker) -> np.random.Generator:
        wid = worker.worker_id
        if wid not in self._rngs:
            self._rngs[wid] = np.random.default_rng(self._seed + wid)
        return self._rngs[wid]

    def _draw(self, n: int, worker) -> np.ndarray:
        bs = self.opts.sampling_batch_size
        if bs <= 1 or n >= bs:
            return np.asarray(self.sample_key_fn(n, self._rng(worker)),
                              dtype=np.int64)
        wid = worker.worker_id
        buf, pos = self._draw_buf.get(wid, (None, 0))
        if buf is None or pos + n > len(buf):
            buf = np.asarray(self.sample_key_fn(bs, self._rng(worker)),
                             dtype=np.int64)
            pos = 0
        out = buf[pos:pos + n]
        self._draw_buf[wid] = (buf, pos + n)
        return out

    def _draw_wor(self, n: int, worker, seen: set) -> np.ndarray:
        """Draw without replacement against `seen` (rejection sampling,
        reference draw_samples WOR, sampling.h:142-160). Batched: each
        round draws all still-needed keys at once and filters collisions
        vectorized (np.isin + first-occurrence), instead of the per-key
        Python probe the reference's C++ can afford."""
        out = np.empty(n, dtype=np.int64)
        got = 0
        seen_arr = np.fromiter(seen, np.int64, len(seen)) if seen else \
            np.empty(0, dtype=np.int64)
        for _ in range(200):
            if got >= n:
                break
            cand = self._draw(n - got, worker)
            # accept first occurrences not in seen (vectorized)
            _, first = np.unique(cand, return_index=True)
            ok = np.zeros(len(cand), dtype=bool)
            ok[first] = True
            ok &= ~np.isin(cand, seen_arr)
            acc = cand[ok]
            out[got:got + len(acc)] = acc
            got += len(acc)
            seen_arr = np.concatenate([seen_arr, acc])
        if got < n:
            raise RuntimeError("WOR sampling could not find enough keys")
        seen.update(out.tolist())
        return out

    # -- public (called via Worker) -----------------------------------------

    def prepare(self, worker, n: int, start: int, end: int) -> int:
        wid = worker.worker_id
        hid = self._next_id.get(wid, 0)
        self._next_id[wid] = hid + 1
        h = _Handle(n, start, end)
        self._handles[(wid, hid)] = h
        self._prepare(worker, h)
        self.stats["prepared"] += n
        return hid

    def pull(self, worker, hid: int, n: Optional[int] = None):
        keys = self.pull_keys(worker, hid, n)
        return keys, worker.pull_sync(keys)

    def pull_keys(self, worker, hid: int, n: Optional[int] = None):
        """Like pull() but returns only the sampled keys, skipping the value
        fetch — for callers that gather values themselves inside a fused step
        (ops/fused.py). Locality behavior per scheme is identical."""
        h = self._handles[(worker.worker_id, hid)]
        n = h.n - h.pos if n is None else n
        if h.pos + n > h.n:
            raise ValueError("pulling more samples than prepared")
        keys = self._pull_keys(worker, h, n)
        h.pos += n
        self.stats["pulled"] += n
        if self.server.locality is not None:
            self.server.locality.record_sampling(keys)
        return keys

    def finish(self, worker, hid: int) -> None:
        self._handles.pop((worker.worker_id, hid), None)

    # -- scheme hooks --------------------------------------------------------

    def _prepare(self, worker, h: _Handle) -> None:
        pass

    def _pull_keys(self, worker, h: _Handle, n: int) -> np.ndarray:
        raise NotImplementedError


class NaiveSampling(SamplingBase):
    """Draw at prepare, plain Pull at pull time (sampling.h:180-241)."""

    def _prepare(self, worker, h: _Handle) -> None:
        if self.opts.sampling_with_replacement:
            h.keys = self._draw(h.n, worker)
        else:
            h.keys = self._draw_wor(h.n, worker, h.seen)

    def _pull_keys(self, worker, h: _Handle, n: int) -> np.ndarray:
        return h.keys[h.pos:h.pos + n]


class PrelocSampling(NaiveSampling):
    """Naive + Intent on the drawn keys (sampling.h:248-280), so by pull time
    the planner has replicated/relocated them."""

    def _prepare(self, worker, h: _Handle) -> None:
        super()._prepare(worker, h)
        worker.intent(h.keys, h.start, h.end)


class PoolSampling(SamplingBase):
    """Shared pool of samples with bounded reuse (sampling.h:288-357): the
    pool is filled from the app distribution, every entry is used at most
    `reuse` times before being redrawn, and pool entries carry intent so the
    planner keeps them local."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        size = self.opts.sampling_pool_size or 4096
        self.pool = np.zeros(size, dtype=np.int64)
        self.uses = np.full(size, 2**31 - 1, dtype=np.int64)  # force refill
        self.reuse = max(1, self.opts.sampling_reuse_factor)
        self._cursor = 0

    def _refill(self, worker, idx: np.ndarray) -> None:
        fresh = self._draw(len(idx), worker)
        self.pool[idx] = fresh
        self.uses[idx] = 0
        clock = worker.current_clock
        worker.intent(fresh, clock, clock + self.reuse)

    def _pull_keys(self, worker, h: _Handle, n: int) -> np.ndarray:
        size = len(self.pool)
        idx = (self._cursor + np.arange(n)) % size
        self._cursor = int((self._cursor + n) % size)
        stale = idx[self.uses[idx] >= self.reuse]
        if len(stale):
            self._refill(worker, stale)
        self.uses[idx] += 1
        keys = self.pool[idx].copy()
        if not self.opts.sampling_with_replacement:
            # dedup within the handle: accept first occurrences not yet
            # seen (one vectorized pass), redraw the collisions in one
            # batched WOR call
            seen_arr = np.fromiter(h.seen, np.int64, len(h.seen)) \
                if h.seen else np.empty(0, dtype=np.int64)
            _, first = np.unique(keys, return_index=True)
            ok = np.zeros(len(keys), dtype=bool)
            ok[first] = True
            ok &= ~np.isin(keys, seen_arr)
            h.seen.update(keys[ok].tolist())
            bad = np.nonzero(~ok)[0]
            if len(bad):
                keys[bad] = self._draw_wor(len(bad), worker, h.seen)
        return keys


class LocalSampling(SamplingBase):
    """Default scheme (sampling.h:366-525): snap each drawn key to one that
    is locally available on the worker's shard, so sampled pulls never leave
    the device. Uses a sorted local-key index + binary search instead of the
    reference's linear probe."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._local_keys: Dict[int, np.ndarray] = {}
        self._topo_version = -1

    def _local_index(self, shard: int) -> np.ndarray:
        srv = self.server
        v = srv.topology_version
        if v != self._topo_version:
            self._local_keys.clear()
            self._topo_version = v
        if shard not in self._local_keys:
            ab = srv.ab
            rng = self.allowed_keys if self.allowed_keys is not None else \
                np.arange(self.min_key, self.max_key, dtype=np.int64)
            local = (ab.owner[rng] == shard) | (
                ab.cache_slot[shard, rng] != NO_SLOT)
            self._local_keys[shard] = rng[local]
        return self._local_keys[shard]

    def _snap(self, keys: np.ndarray, shard: int) -> np.ndarray:
        local = self._local_index(shard)
        if len(local) == 0:
            return keys  # nothing local; fall back to the raw draw
        pos = np.searchsorted(local, keys)
        pos = np.where(pos >= len(local), 0, pos)  # wrap (sampling.h:494)
        return local[pos]

    def _pull_keys(self, worker, h: _Handle, n: int) -> np.ndarray:
        if self.opts.sampling_with_replacement:
            keys = self._snap(self._draw(n, worker), worker.shard)
            self.stats["pulled_local"] += n
            return keys
        # WOR: batched draw+snap, then collisions probe FORWARD through
        # the local index — all rounds vectorized (the reference probes
        # per sample in C++, sampling.h:437-460; a Python per-sample loop
        # is exactly what kills w2v-at-scale prepare/pull)
        local = self._local_index(worker.shard)
        out = np.empty(n, dtype=np.int64)
        got = 0
        if len(local):
            seen_arr = np.fromiter(h.seen, np.int64, len(h.seen)) \
                if h.seen else np.empty(0, dtype=np.int64)
            # position of each pending sample's probe in the local index
            probe = np.searchsorted(local, self._snap(
                self._draw(n, worker), worker.shard))
            probe = np.where(probe >= len(local), 0, probe)
            for _ in range(len(local) + 1):
                if got >= n:
                    break
                cand = local[probe]
                _, first = np.unique(cand, return_index=True)
                ok = np.zeros(len(cand), dtype=bool)
                ok[first] = True
                ok &= ~np.isin(cand, seen_arr)
                acc = cand[ok]
                out[got:got + len(acc)] = acc
                got += len(acc)
                seen_arr = np.concatenate([seen_arr, acc])
                probe = (probe[~ok] + 1) % len(local)
            h.seen.update(out[:got].tolist())
        if got < n:
            # local population exhausted: global WOR draws (keys may be
            # remote — slower, never wrong)
            out[got:] = self._draw_wor(n - got, worker, h.seen)
        self.stats["pulled_local"] += n
        return out


def make_sampling(server, sample_key_fn, min_key: int, max_key: int,
                  allowed_keys=None):
    scheme = server.opts.sampling_scheme
    cls = {"naive": NaiveSampling, "preloc": PrelocSampling,
           "pool": PoolSampling, "local": LocalSampling}[scheme]
    return cls(server, sample_key_fn, min_key, max_key,
               allowed_keys=allowed_keys)
