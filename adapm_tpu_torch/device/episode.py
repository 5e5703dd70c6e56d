"""Episodic execution (GraphVite, PAPERS.md): the port of the JAX
package's `device/episode.py`.

GraphVite's CPU-GPU hybrid structure applied to the PM's fused-step
path: the step stream is partitioned into **episodes** — consecutive
windows of step batches whose union working set is pinned device-hot as
a unit — and host-side preparation of episode N+1 overlaps device
compute of episode N:

    episode stream (`episode`, host prep, the caller thread):
        - resolve episode N+1's per-class key unions,
        - pin + promote its hot set through the TierManager's promotion
          path (intent-pinned rows first, then by decayed access score;
          cold rows upload in the cold store's wire format through K11
          `write_main_rows`),
        - pre-stage each batch's key upload (`prefetch_keys`);
    commit stream (`episode_commit`, an executor program):
        - run episode N's fused steps, in submission order, exactly as
          a sequential caller would.

At most ONE commit is in flight: the driver submits commit N, preps
N+1 on its own thread (tracked as `episode`-stream occupancy for the
exec.overlap_fraction gauge), then joins commit N before submitting
N+1 — so nothing runs unboundedly ahead and the step order is the
SEQUENTIAL order.

Bit-identity: episodic execution changes WHEN values move — promotions
are bit-exact residency moves, key staging uploads raw keys, and the
runner's own generator is consumed in step order because commits never
overlap each other — never WHAT a read returns. A server without the
tier (or a serialized/closing executor) degrades to inline prep +
inline commit: same results, no overlap.

Anti-thrash: prep promotes with `force=False`, so episode N+1's working
set can never evict episode N's still-pinned rows; when the hot pool
cannot hold both episodes the surplus stays cold and the step's own
forced pin covers it — slower, never wrong.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Dict, List, Optional, Sequence

import numpy as np


class Episode:
    """One episode: a window of step batches + its staged state."""

    __slots__ = ("index", "batches", "auxes")

    def __init__(self, index: int, batches, auxes):
        self.index = index
        self.batches = batches
        self.auxes = auxes


def plan_episodes(batches: Sequence[Dict[str, np.ndarray]],
                  auxes, episode_batches: int) -> List[Episode]:
    """Partition the step stream into consecutive windows of
    `episode_batches` batches. Order is preserved — the partition
    changes staging/pinning granularity, never step order."""
    if episode_batches < 1:
        raise ValueError("episode_batches must be >= 1")
    out = []
    for i, lo in enumerate(range(0, len(batches), episode_batches)):
        hi = lo + episode_batches
        out.append(Episode(i, list(batches[lo:hi]),
                           None if auxes is None else list(auxes[lo:hi])))
    return out


class EpisodicRunner:
    """Drives a fused-step runner (ops/fused.py DeviceRoutedRunner or
    FusedStepRunner) episodically. `run(batches, auxes, lr)` returns
    the per-step losses in step order, bit-identical to calling the
    runner sequentially on the same batches."""

    _COMMIT_TIMEOUT_S = 600.0

    def __init__(self, runner, episode_batches: Optional[int] = None):
        self.runner = runner
        self.server = runner.server
        srv = self.server
        eb = episode_batches or srv.opts.episode_batches
        # measured prep sizing (ops/costs.py): with an
        # attached kernel cost table and no explicit override, size the
        # window from the per-class measured gather costs — slow/wide
        # classes prep shorter episodes so host prep cannot outrun the
        # overlapped commit. An explicit episode_batches (arg or a
        # table-less server) keeps the static knob untouched.
        if episode_batches is None and getattr(srv, "costs",
                                               None) is not None:
            eb = srv.costs.suggest_episode_batches(
                eb, [st.value_length for st in srv.stores])
        self.episode_batches = int(eb)
        assert self.episode_batches >= 1
        # key staging is a DeviceRoutedRunner capability; the host-routed
        # FusedStepRunner still gets episodic pin/promote prep
        self._stage = getattr(runner, "prefetch_keys", None)
        self._staged_ok = self._stage is not None
        reg = srv.obs
        # shared=True: several runners may drive one server
        self._c_episodes = reg.counter("episode.episodes_total",
                                       shared=True)
        self._c_staged = reg.counter("episode.staged_batches_total",
                                     shared=True)
        self._c_pinned = reg.counter("episode.pinned_rows_total",
                                     shared=True)
        self._h_prep = reg.histogram("episode.prep_s", shared=True)
        self._h_commit = reg.histogram("episode.commit_s", shared=True)

    # -- prep (the `episode` stream) -----------------------------------------

    def _class_unions(self, ep: Episode) -> Dict[int, np.ndarray]:
        """Per-length-class union of the episode's keys (the episode's
        working set), via the runner's role->class map."""
        role_class = self.runner.role_class
        by_cid: Dict[int, list] = {}
        for b in ep.batches:
            for r, keys in b.items():
                k = np.asarray(keys, dtype=np.int64).ravel()
                if len(k):
                    by_cid.setdefault(role_class[r], []).append(k)
        return {cid: np.unique(np.concatenate(parts))
                for cid, parts in by_cid.items()}

    def _prep(self, ep: Episode):
        """Stage episode `ep` ahead of its commit: promote + pin its
        hot set (tiered servers) and pre-upload its key batches.
        Runs on the CALLER thread, tracked as `episode`-stream
        occupancy; takes the server lock only around the promotion
        enqueues (the lock-narrowing rule)."""
        srv = self.server
        t0 = time.perf_counter()
        with srv.exec.track("episode"):
            tier = srv.tier
            if tier is not None:
                end = tier.step_pin_end() + 1  # cover the whole window
                for cid, keys in self._class_unions(ep).items():
                    o_sh = srv.ab.owner[keys]
                    o_sl = srv.ab.slot[keys]
                    res = srv.stores[cid].res
                    m = o_sl >= 0  # process-local owners only
                    if not m.any():
                        continue
                    sh, sl = o_sh[m], o_sl[m]
                    # intent-pinned rows outrank score: promote them
                    # first so capacity bounding lands on the scored
                    # tail, not the declared-intent head (the
                    # residency.py replacement signal)
                    live = res.pin_until[sh, sl] >= \
                        tier._min_active_clock()
                    with srv._lock:
                        n = 0
                        if live.any():
                            n += tier.ensure_hot(cid, sh[live],
                                                 sl[live], pin_end=end)
                        rest = ~live
                        if rest.any():
                            order = np.argsort(
                                -res.score[sh[rest], sl[rest]],
                                kind="stable")
                            n += tier.ensure_hot(cid, sh[rest][order],
                                                 sl[rest][order],
                                                 pin_end=end)
                    if n:
                        self._c_pinned.inc(n)
            staged = None
            if self._staged_ok:
                staged = [self._stage(b) for b in ep.batches]
                self._c_staged.inc(len(staged))
        self._h_prep.observe(time.perf_counter() - t0)
        return staged

    # -- commit (the `episode_commit` stream) --------------------------------

    def _commit(self, ep: Episode, staged, lr: float, eps: float):
        """Run the episode's steps in order — exactly what a sequential
        caller would execute, staged key uploads aside."""
        t0 = time.perf_counter()
        losses = []
        for i, b in enumerate(ep.batches):
            aux = None if ep.auxes is None else ep.auxes[i]
            if staged is not None:
                losses.append(self.runner(b, aux, lr, eps,
                                          staged=staged[i]))
            else:
                losses.append(self.runner(b, aux, lr, eps))
        self._c_episodes.inc()
        self._h_commit.observe(time.perf_counter() - t0)
        return losses

    # -- the double-buffered driver ------------------------------------------

    def run(self, batches: Sequence[Dict[str, np.ndarray]], auxes=None,
            lr: float = 0.1, eps: float = 1e-10) -> list:
        """Train `batches` episodically. Returns the per-step losses
        (device scalars, step order). `auxes` is one aux per batch or
        None."""
        if auxes is not None:
            assert len(auxes) == len(batches), "one aux per batch"
        episodes = plan_episodes(batches, auxes, self.episode_batches)
        if not episodes:
            return []
        srv = self.server
        ex = srv.exec
        # the double-buffering precondition: a second worker must be
        # able to run the commit while this thread preps the next
        # episode; otherwise degrade to inline prep+commit (same
        # results, no overlap)
        pipelined = (not ex.single_stream and not ex.closed
                     and ex.max_workers >= 2)
        losses: list = []
        staged = self._prep(episodes[0])
        for i, ep in enumerate(episodes):
            cur = None
            if pipelined:
                cur = ex.submit("episode_commit",
                                partial(self._commit, ep, staged, lr,
                                        eps),
                                label="episode.commit")
            else:
                losses.extend(self._commit(ep, staged, lr, eps))
            # host prep of episode N+1 overlaps commit N's device work
            staged = self._prep(episodes[i + 1]) \
                if i + 1 < len(episodes) else None
            if cur is not None:
                got = cur.result(timeout=self._COMMIT_TIMEOUT_S)
                if got is None:  # cancelled by a racing executor close
                    raise RuntimeError(
                        "episodic commit cancelled: the executor closed "
                        "mid-run (server shutdown during training?)")
                losses.extend(got)
        return losses
