"""Knowledge-graph embedding app: ComplEx, RESCAL & RotatE with AdaGrad,
filtered MRR/Hits@k eval, checkpoints (reference
apps/knowledge_graph_embeddings.cc; RotatE, which the reference and the
JAX app lack: Sun et al., ICLR 2019).

Pipeline parity (kge.cc:1059-1122): for each future triple batch the worker
signals `Intent({s, r, o})` and `PrepareSample(2*neg_ratio*B)` at the future
clock; negatives arrive via PullSample (managed sampling). Clock advances per
batch. Loss and eval statistics aggregate through PS keys — the reference's
`ps_allreduce` / eval_key idiom (utils.h:163-197, kge.cc:544-775) — a loss
key (length 1) and an eval key (length 8) live at the end of the key space.

Key layout (kge.cc:1296-1306): entities [0, E) with embedding length 2*dim
(ComplEx and RotatE re|im) or dim (RESCAL); relations [E, E+R) length 2*dim
(ComplEx; RotatE: dim phases, then dim columns held and never read) or
dim^2 (RESCAL); stored rows carry AdaGrad inline: [emb | acc]. RotatE's
phases start uniform on [-pi, pi) (the authors' code), its entities as
--init_scheme says; --margin is its gamma.

Eval (kge.cc Evaluator :544-775): filtered MRR and Hits@{1,10}, ranking all
entities for both subject and object replacement: by default the pool-gather
count kernel, K4 (K17 for RotatE; models/kge.py make_pool_eval_counts), with
`--eval_chunk 0` full-entity scores against a dense entity matrix.

This is the JAX package's app with identical flags, plus `--model rotate`
and `--margin`. It runs on `cuda`;
`run_app(args, device="cpu")` runs the same code on the CPU, where every
kernel takes its plain version. `--scan_steps K` (device routes) trains
K batches per DeviceRoutedRunner.run_scan window: a CUDA graph replay on
the card, a loop over the step on the CPU. Under the launcher
(`python -m adapm_tpu_torch.launcher -n P -- python -m
adapm_tpu_torch.apps.knowledge_graph_embeddings ...`) the processes train
data-parallel through one parameter manager, and the pool eval is
candidate-partitioned: each rank counts over the entities it owns
through K4's multi-process form, and one allreduce merges the counts.

Run: python -m adapm_tpu_torch.apps.knowledge_graph_embeddings --model complex ...
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..io import kge as kgeio
from ..models.kge import make_eval_scores, make_kge_loss
from ..ops.fused import DeviceRoutedRunner, DeviceRouter, FusedStepRunner
from ..utils import Stopwatch, alog
from .common import (KeyMapper, RuntimeGuard, ScanWindow,
                     add_common_arguments, enforce_full_replication,
                     epoch_report, global_worker_slices, make_server,
                     wrap_batches, worker0_init)

# eval stats layout: [0:4] object side (mrr_sum, h1, h10, count),
# [4:8] subject side — separated because the generators/datasets can have
# asymmetric sides (the lowrank synthetic's subject is information-free);
# reported combined plus per-side (reference eval_key len 20)
EVAL_LEN = 8


class KgeRun:
    """Holds the server, key layout, and fused runner for one training run."""

    def __init__(self, args, ds: kgeio.TripleDataset, device=None):
        self.args = args
        self.ds = ds
        d = args.dim
        E, R = ds.num_entities, ds.num_relations
        self.ent_dim = d if args.model == "rescal" else 2 * d
        self.rel_dim = d * d if args.model == "rescal" else 2 * d
        self.E, self.R = E, R
        self.loss_key_l = E + R          # logical loss key (kge.cc idiom)
        self.eval_key_l = E + R + 1
        num_keys = E + R + 2

        value_lengths = np.empty(num_keys, dtype=np.int64)
        value_lengths[:E] = 2 * self.ent_dim          # [emb | acc]
        value_lengths[E:E + R] = 2 * self.rel_dim
        value_lengths[self.loss_key_l] = 1
        value_lengths[self.eval_key_l] = EVAL_LEN

        # enforce_random_keys shuffles *within* each population: entities
        # among [0, E), relations among [E, E+R). A joint shuffle would map
        # entity keys onto relation-width rows (different value lengths);
        # aux keys keep their identity.
        self.ent_map = KeyMapper(E, args.enforce_random_keys, seed=args.seed)
        self.rel_map = KeyMapper(R, args.enforce_random_keys,
                                 seed=args.seed + 1)
        self.srv = make_server(args, num_keys, value_lengths,
                               num_workers=args.num_workers or None,
                               device=device)
        self.device = self.srv.ctx.device
        self.num_workers = args.num_workers or self.srv.num_shards
        self.workers = [self.srv.make_worker(i)
                        for i in range(self.num_workers)]

        ab = self.srv.ab
        self.ent_class = int(ab.key_class[0])
        self.rel_class = int(ab.key_class[E])
        self._pool_eval = None       # chunked pool-gather eval program
        self._pool_eval_chunk = 0
        self._pool_eval_keys = None  # staged padded entity-key tiles
        self._pool_eval_router = None
        # a tiered server's slot mirror, clamped as the JAX eval reads it
        self._pool_eval_clamped = None
        self._pool_eval_clamped_ver = None
        # the multi-process eval: its count program, the true-score
        # function, and the owned-candidate tiles with their count and
        # the topology version they were built at
        self._pool_eval_mp = None
        self._true_score = None
        self._pool_eval_topo = -1
        self._pool_eval_n = 0
        self.runner = FusedStepRunner(
            self.srv, make_kge_loss(args.model, args.self_adv_temp,
                                    args.l2, args.margin),
            role_class={"s": self.ent_class, "r": self.rel_class,
                        "o": self.ent_class, "neg": self.ent_class},
            role_dim={"s": self.ent_dim, "r": self.rel_dim,
                      "o": self.ent_dim, "neg": self.ent_dim})

    # -- key helpers ---------------------------------------------------------

    def ekey(self, e):   # entity logical -> physical
        return self.ent_map(np.asarray(e, dtype=np.int64))

    def rkey(self, r):   # relation logical -> physical
        return self.rel_map(np.asarray(r, dtype=np.int64)) + self.E

    # -- init / checkpoint ---------------------------------------------------

    def init_model(self) -> None:
        a = self.args
        rng = np.random.default_rng(a.seed)
        if a.init_from:
            ck = np.load(a.init_from)
            ent_rows = np.concatenate([ck["ent"], ck["ent_acc"]], axis=1)
            rel_rows = np.concatenate([ck["rel"], ck["rel_acc"]], axis=1)
            alog(f"[kge] initialized from checkpoint {a.init_from}")
        else:
            scale = a.init_scale
            if a.init_scheme == "uniform":
                ent = (rng.random((self.E, self.ent_dim)) - 0.5) * 2 * scale
                rel = (rng.random((self.R, self.rel_dim)) - 0.5) * 2 * scale
            else:  # normal (kge.cc init none/uniform/normal :988-1018)
                ent = rng.normal(0, scale, (self.E, self.ent_dim))
                rel = rng.normal(0, scale, (self.R, self.rel_dim))
            if a.model == "rotate":   # phases, then the unread half
                d = self.rel_dim // 2
                rel = np.zeros((self.R, self.rel_dim))
                rel[:, :d] = rng.uniform(-np.pi, np.pi, (self.R, d))
            ent_rows = np.concatenate(
                [ent, np.full_like(ent, a.adagrad_init)], axis=1)
            rel_rows = np.concatenate(
                [rel, np.full_like(rel, a.adagrad_init)], axis=1)
        worker0_init(self.workers, self.ekey(np.arange(self.E)),
                     ent_rows.astype(np.float32))
        from ..parallel import control
        w0 = self.workers[0]
        w0.begin_setup()
        if control.process_id() == 0:  # worker-0-of-process-0 initializes
            w0.set(self.rkey(np.arange(self.R)),
                   rel_rows.astype(np.float32))
            w0.set(np.array([self.loss_key_l]), np.zeros(1, np.float32))
            w0.set(np.array([self.eval_key_l]),
                   np.zeros(EVAL_LEN, np.float32))
            w0.wait_all()  # cross-process Sets land before the barrier
        w0.end_setup()

    def current_model(self):
        ent = self.srv.read_main(self.ekey(np.arange(self.E))).reshape(
            self.E, 2 * self.ent_dim)
        rel = self.srv.read_main(self.rkey(np.arange(self.R))).reshape(
            self.R, 2 * self.rel_dim)
        return (ent[:, :self.ent_dim], ent[:, self.ent_dim:],
                rel[:, :self.rel_dim], rel[:, self.rel_dim:])

    def checkpoint(self, path: str) -> None:
        ent, ent_acc, rel, rel_acc = self.current_model()
        np.savez(path, ent=ent, ent_acc=ent_acc, rel=rel, rel_acc=rel_acc)
        alog(f"[kge] wrote checkpoint {path}")

    # -- PS-key aggregation (reference ps_allreduce, utils.h:163-197) --------

    def allreduce(self, key_l: int, contribution: np.ndarray) -> np.ndarray:
        """Each process's worker 0 pushes its contribution; after the
        flush + barrier the key's main copy holds the global sum
        (reference ps_allreduce: push -> barrier -> pull,
        utils.h:163-197)."""
        w0 = self.workers[0]
        w0.wait(w0.push(np.array([key_l]),
                        contribution.astype(np.float32)))
        self.srv.quiesce()
        self.srv.barrier()
        out = self.srv.read_main(np.array([key_l]))
        self.srv.barrier()  # all reads done before anyone resets
        return out

    def reset_key(self, key_l: int, length: int) -> None:
        from ..parallel import control
        if control.process_id() == 0:
            w0 = self.workers[0]
            w0.wait(w0.set(np.array([key_l]),
                           np.zeros(length, np.float32)))
        self.srv.barrier()


def _flt_pairs(ab_pairs, flt: dict):
    """Flatten per-triple filter sets into (triple_idx, entity) arrays."""
    fi: list = []
    fe: list = []
    for i, key in enumerate(ab_pairs):
        f = flt.get(key)
        if f:
            fi.extend([i] * len(f))
            fe.extend(f)
    return (np.asarray(fi, dtype=np.int64),
            np.asarray(fe, dtype=np.int64))


def _side_stats(sc: np.ndarray, true_e: np.ndarray, fi: np.ndarray,
                fe: np.ndarray) -> np.ndarray:
    """Filtered ranks for one side, fully batched: rank = 1 + #{better
    candidates} - #{better FILTERED candidates} (the filtered set never
    contains the true entity's own contribution), in place of the
    reference's per-triple/per-candidate loop."""
    B = len(true_e)
    true_sc = sc[np.arange(B), true_e]
    greater = (sc > true_sc[:, None]).sum(axis=1).astype(np.int64)
    if len(fi):
        contrib = (sc[fi, fe] > true_sc[fi]) & (fe != true_e[fi])
        np.subtract.at(greater, fi, contrib.astype(np.int64))
    rank = 1 + greater
    return np.array([(1.0 / rank).sum(), (rank <= 1).sum(),
                     (rank <= 10).sum(), B], dtype=np.float64)


def evaluate(run: KgeRun, triples: np.ndarray, batch: int = 64):
    """Filtered MRR / Hits@{1,10} over `triples`, both-side ranking.

    Production path (--eval_chunk > 0): the count kernel reads candidate
    rows straight from the POOL and only [B] rank counts return to the
    host — no dense entity matrix anywhere (make_pool_eval_counts over
    all entities in one process; make_pool_eval_counts_mp over each
    rank's owned entities in several). --eval_chunk 0 takes the
    dense-matrix path, in torch on the run's device."""
    if run.args.eval_chunk > 0:
        if run.srv.glob is not None:
            return _evaluate_pool_mp(run, triples, batch)
        return _evaluate_pool(run, triples, batch)
    ent, _, rel, _ = run.current_model()
    ent_j = torch.as_tensor(ent, device=run.device)
    rel_j = torch.as_tensor(rel, device=run.device)
    scores_fn = make_eval_scores(run.args.model)
    sr_o, ro_s = run.ds.filters()

    stats = np.zeros(EVAL_LEN, dtype=np.float64)  # mrr, h1, h10, count
    for lo in range(0, len(triples), batch):
        t = triples[lo:lo + batch]
        s, r, o = t[:, 0], t[:, 1], t[:, 2]
        so, ss = scores_fn(ent_j, rel_j, ent_j[s], rel_j[r], ent_j[o])
        so, ss = so.cpu().numpy(), ss.cpu().numpy()
        fi_o, fe_o = _flt_pairs(list(zip(s.tolist(), r.tolist())), sr_o)
        fi_s, fe_s = _flt_pairs(list(zip(r.tolist(), o.tolist())), ro_s)
        stats[:4] += _side_stats(so, o, fi_o, fe_o)
        stats[4:] += _side_stats(ss, s, fi_s, fe_s)
    return stats


def _rank_side_stats(greater: np.ndarray) -> np.ndarray:
    rank = 1 + greater
    return np.array([(1.0 / rank).sum(), (rank <= 1).sum(),
                     (rank <= 10).sum(), len(rank)], dtype=np.float64)


def _pool_counts(run: KgeRun, s, r, o, ties: bool = False):
    """Device rank counts of one triple batch (logical ids): for each side
    the number of entities scoring strictly above the true triple, the
    true entity excluded, and the true scores — all as host arrays. The
    count program and the padded full-entity key tiles are built once per
    (E, chunk). `ties=True` counts with the plain version and adds the
    per-side near-tie counts (for checks)."""
    from ..models.kge import make_pool_eval_counts
    srv = run.srv
    C = min(run.args.eval_chunk, max(run.E, 8))
    put = srv.ctx.put_replicated
    shared = run.ent_class == run.rel_class
    if run._pool_eval is None or run._pool_eval_chunk != C:
        run._pool_eval = make_pool_eval_counts(
            run.args.model, run.ent_dim, run.rel_dim, C,
            shared_pool=shared, tracer=srv.spans)
        run._pool_eval_chunk = C
        ekeys = run.ekey(np.arange(run.E)).astype(np.int64)
        nch = -(-run.E // C)
        pad = np.full(nch * C, ekeys[0], dtype=np.int32)
        pad[: run.E] = ekeys
        run._pool_eval_keys = put(pad.reshape(nch, C))
        run._pool_eval_router = DeviceRouter(srv, 0)
    kdt = np.int32

    def keys(x):
        return put(np.asarray(x, dtype=kdt))

    with srv._lock:
        tables = run._pool_eval_router.tables()
        pools = (srv.stores[run.ent_class].main,) if shared else \
            (srv.stores[run.ent_class].main,
             srv.stores[run.rel_class].main)
        if srv.tier is not None:
            tables = _clamped_tier_tables(run, srv.tier, tables)
        out = run._pool_eval(
            *pools, tables, run._pool_eval_keys, run.E,
            keys(run.ekey(s)), keys(run.rkey(r)), keys(run.ekey(o)),
            ties=ties)
    g_o, g_s, true_sc = out[:3]
    host = (g_o.cpu().numpy().astype(np.int64),
            g_s.cpu().numpy().astype(np.int64), true_sc.cpu().numpy())
    return host + tuple(t.cpu().numpy().astype(np.int64)
                        for t in out[3:])


def _clamped_tier_tables(run: KgeRun, tier, tables):
    """The eval's routing tables on a tiered server, as the JAX package's
    eval program reads them. Its tiered slot mirror maps a cold key to
    OOB, and an XLA gather CLAMPS an out-of-range index: a cold key (a
    cold candidate, or a cold s/r/o of the triple) reads the last row of
    its owner shard's hot pool, not a zero row. K4 reads OOB as a zero
    row (the data plane's fill rule), so the slot mirror handed to it is
    clamped here the same way (`tier` is the server's TierManager).
    Cached per routing version."""
    router = run._pool_eval_router
    if run._pool_eval_clamped_ver != router._version:
        srv = run.srv
        slot = tier.compose_slot_table()
        last = np.array([st.main.shape[1] - 1 for st in srv.stores],
                        dtype=np.int64)[srv.ab.key_class]
        clamped = np.minimum(slot.astype(np.int64), last).astype(np.int32)
        run._pool_eval_clamped = srv.ctx.put_replicated(clamped)
        run._pool_eval_clamped_ver = router._version
    return tables[0], run._pool_eval_clamped, tables[2]


def _evaluate_pool(run: KgeRun, triples: np.ndarray, batch: int):
    """Pool-gather eval: device counts + host filter correction."""
    srv = run.srv
    sr_o, ro_s = run.ds.filters()

    def emb_rows(keys, dim):
        rows = np.asarray(srv.read_main(keys)).reshape(len(keys), -1)
        return rows[:, :dim]

    stats = np.zeros(EVAL_LEN, dtype=np.float64)
    for lo in range(0, len(triples), batch):
        t = triples[lo:lo + batch]
        s, r, o = t[:, 0], t[:, 1], t[:, 2]
        g_o, g_s, true_sc = _pool_counts(run, s, r, o)
        _filter_correct(run, emb_rows, s, r, o, g_o, g_s, true_sc,
                        sr_o, ro_s)
        stats[:4] += _rank_side_stats(g_o)
        stats[4:] += _rank_side_stats(g_s)
    return stats


def _owned_tiles(run: KgeRun, C: int):
    """This rank's owned entity keys as padded [nch, C] int32 tiles on
    the device (None when it owns none) and their count; rebuilt when
    the topology moved since the last eval (the owned set follows
    relocations)."""
    srv = run.srv
    topo = srv.topology_version
    if run._pool_eval_topo != topo:
        ekeys = run.ekey(np.arange(run.E)).astype(np.int64)
        with srv._lock:
            owned = ekeys[srv.ab.owner[ekeys] >= 0]
        nown = len(owned)
        if nown:
            nch = -(-nown // C)
            pad = np.full(nch * C, owned[0], dtype=np.int32)
            pad[:nown] = owned
            run._pool_eval_keys = srv.ctx.put_replicated(
                pad.reshape(nch, C))
        else:  # a rank may own no entity; it still joins the merge
            run._pool_eval_keys = None
        run._pool_eval_n = nown
        run._pool_eval_topo = topo
    return run._pool_eval_keys, run._pool_eval_n


def _evaluate_pool_mp(run: KgeRun, triples: np.ndarray, batch: int):
    """Candidate-partitioned pool eval across processes. Every rank walks
    the SAME full triple set; each scores only the entities it OWNS,
    gathered from its local pool (each entity has exactly one owner, so
    the per-rank greater-counts sum to exactly the global counts —
    reference distributed Evaluator, kge.cc:544-775). Query rows come
    through Server.read_main (remote owners answer over the channel),
    the true score is computed by one function of the same shapes on
    every rank, so its bytes match, and ONE barrier + allreduce per
    evaluate() call merges the counts. No dense entity matrix, no remote
    candidate-row fetches. Contract: all ranks call evaluate() together
    with identical `triples`, with no training in flight."""
    from ..models.kge import make_pool_eval_counts_mp, make_true_score
    from ..parallel import control
    srv = run.srv
    C = min(run.args.eval_chunk, max(run.E, 8))
    put = srv.ctx.put_replicated
    if run._pool_eval_mp is None or run._pool_eval_chunk != C:
        run._pool_eval_mp = make_pool_eval_counts_mp(
            run.args.model, run.ent_dim, run.rel_dim, C, tracer=srv.spans)
        run._true_score = make_true_score(run.args.model)
        run._pool_eval_chunk = C
        run._pool_eval_topo = -1
        run._pool_eval_router = DeviceRouter(srv, 0)
    tiles, nown = _owned_tiles(run, C)
    counts_fn = run._pool_eval_mp
    router = run._pool_eval_router
    sr_o, ro_s = run.ds.filters()

    def emb_rows(keys, dim):
        rows = np.asarray(srv.read_main(keys)).reshape(len(keys), -1)
        return rows[:, :dim]

    T = len(triples)
    G_o = np.zeros(T, dtype=np.int64)
    G_s = np.zeros(T, dtype=np.int64)
    true_all = np.zeros(T, dtype=np.float32)
    for lo in range(0, T, batch):
        t = triples[lo:lo + batch]
        s, r, o = t[:, 0], t[:, 1], t[:, 2]
        se = put(np.ascontiguousarray(emb_rows(run.ekey(s), run.ent_dim)))
        re_ = put(np.ascontiguousarray(emb_rows(run.rkey(r), run.rel_dim)))
        oe = put(np.ascontiguousarray(emb_rows(run.ekey(o), run.ent_dim)))
        t_sc = run._true_score(se, re_, oe)
        true_all[lo:lo + len(t)] = t_sc.cpu().numpy()
        if nown:
            with srv._lock:
                tables = router.tables()
                if srv.tier is not None:
                    tables = _clamped_tier_tables(run, srv.tier, tables)
                g_o, g_s = counts_fn(
                    srv.stores[run.ent_class].main, tables, tiles, nown,
                    se, re_, oe, put(run.ekey(s).astype(np.int32)),
                    put(run.ekey(o).astype(np.int32)), t_sc)
            G_o[lo:lo + len(t)] = g_o.cpu().numpy()
            G_s[lo:lo + len(t)] = g_s.cpu().numpy()
    # merge the candidate partitions: ONE barrier + allreduce per call
    control.barrier("adapm-eval-merge")
    gg = control.allreduce(
        np.concatenate([G_o, G_s]).astype(np.float64), "sum",
        site="eval-merge")
    G_o = gg[:T].astype(np.int64)
    G_s = gg[T:].astype(np.int64)

    # correction + stats over GLOBAL counts, identical on every rank
    stats = np.zeros(EVAL_LEN, dtype=np.float64)
    for lo in range(0, T, batch):
        t = triples[lo:lo + batch]
        s, r, o = t[:, 0], t[:, 1], t[:, 2]
        g_o = G_o[lo:lo + len(t)]
        g_s = G_s[lo:lo + len(t)]
        _filter_correct(run, emb_rows, s, r, o, g_o, g_s,
                        true_all[lo:lo + len(t)], sr_o, ro_s)
        stats[:4] += _rank_side_stats(g_o)
        stats[4:] += _rank_side_stats(g_s)
    return stats


def _filter_correct(run, emb_rows, s, r, o, g_o, g_s, true_sc,
                    sr_o, ro_s) -> None:
    """Filtered-rank correction (in place on g_o/g_s): subtract the
    (tiny) per-triple filter sets' contributions, scored on host from a
    handful of pool rows."""
    from ..models.kge import score_numpy
    for g, fi, fe, true_e, q in (
            (g_o, *_flt_pairs(list(zip(s.tolist(), r.tolist())), sr_o),
             o, "o"),
            (g_s, *_flt_pairs(list(zip(r.tolist(), o.tolist())), ro_s),
             s, "s")):
        if not len(fi):
            continue
        fe_rows = emb_rows(run.ekey(fe), run.ent_dim)
        r_rows = emb_rows(run.rkey(r[fi]), run.rel_dim)
        if q == "o":
            sc_f = score_numpy(run.args.model,
                               emb_rows(run.ekey(s[fi]), run.ent_dim),
                               r_rows, fe_rows)
        else:
            sc_f = score_numpy(run.args.model, fe_rows, r_rows,
                               emb_rows(run.ekey(o[fi]), run.ent_dim))
        contrib = (sc_f > true_sc[fi]) & (fe != true_e[fi])
        np.subtract.at(g, fi, contrib.astype(np.int64))
        # host f64 vs device f32 can disagree by an ulp at a tie: a
        # filter entity the device never counted must not push the
        # count negative (rank 0 -> infinite MRR)
        np.maximum(g, 0, out=g)


def _eval_global(run: KgeRun, triples: np.ndarray) -> np.ndarray:
    """Global filtered-eval stats across processes. Pool path
    (--eval_chunk > 0) multi-process: candidate-partitioned — every rank
    walks the full triple set and the counts merge INSIDE evaluate(), so
    its return is already global (identical on all ranks). Dense path /
    single process: triples split over ranks, partial stats merged by
    the PS-key allreduce (reference distributed Evaluator idiom)."""
    from ..parallel import control
    P = control.num_processes()
    if P > 1 and run.args.eval_chunk > 0:
        return evaluate(run, triples)
    part = np.array_split(triples, P)[control.process_id()]
    stats = evaluate(run, part)
    if P == 1:
        return np.asarray(stats, dtype=np.float64)
    agg = np.asarray(run.allreduce(run.eval_key_l, stats),
                     dtype=np.float64)
    run.reset_key(run.eval_key_l, EVAL_LEN)
    return agg


def run_app(args, device=None) -> dict:
    """Train, evaluate and checkpoint as the CLI says, on `device`
    (default cuda). Returns the result dict of the JAX app, plus
    `epoch_losses` (one mean loss per epoch) and host-clock seconds:
    `gen_s` (dataset), `epoch_s` (each epoch's training, up to its loss
    on the host) and `eval_s` (each evaluation), and `staged_steps`
    (device-routed steps whose keys were pre-uploaded by the prefetch
    pipeline's prepare path)."""
    dev = torch.device("cuda" if device is None else device)
    t_gen = time.perf_counter()
    truth_mrr = None
    if args.train:
        ds = kgeio.load_dataset(args.train, args.valid, args.test,
                                args.num_entities or None,
                                args.num_relations or None)
    elif args.synthetic_mode == "lowrank":
        ds, truth_mrr = kgeio.generate_lowrank(
            num_entities=args.synthetic_entities,
            num_relations=args.synthetic_relations,
            n_train=args.synthetic_triples, seed=args.seed,
            dim_truth=args.gen_dim_truth, temperature=args.gen_temperature,
            torch_device=dev)
        alog(f"[kge] lowrank synthetic: generating-model filtered "
             f"MRR ceiling = {truth_mrr:.4f} (o={ds.truth_mrr_o:.4f} "
             f"s={ds.truth_mrr_s:.4f})")
    else:
        ds = kgeio.generate_synthetic(
            num_entities=args.synthetic_entities,
            num_relations=args.synthetic_relations,
            n_train=args.synthetic_triples, seed=args.seed)
    gen_s = time.perf_counter() - t_gen
    run = KgeRun(args, ds, device=dev)
    run.init_model()
    if args.enforce_full_replication:
        enforce_full_replication(run.workers, run.E + run.R)

    B, N = args.batch_size, args.neg_ratio
    srv, workers = run.srv, run.workers
    # negative sampling over entities. uniform = the reference's scheme
    # (kge.cc draws uniform entities); freq = unigram^pow over the
    # training-triple entity frequencies (word2vec's noise distribution
    # applied to KGE — hits the populated region of the entity space,
    # part of the mid-scale fix alongside --self_adv_temp). The Local
    # scheme may only snap within the entity key population.
    neg_alias = None
    if args.neg_sampling == "freq":
        from ..models.sgns import build_alias_table
        counts = (np.bincount(ds.train[:, 0], minlength=run.E)
                  + np.bincount(ds.train[:, 2], minlength=run.E)
                  + 1.0)
        neg_alias = build_alias_table(counts, power=args.neg_freq_pow)

        def host_neg(n, r):
            prob, alias = neg_alias
            u = r.integers(0, run.E, n)
            keep = r.random(n) < prob[u]
            return run.ekey(np.where(keep, u, alias[u]))

        srv.enable_sampling_support(
            host_neg, allowed_keys=run.ekey(np.arange(run.E)))
    else:
        srv.enable_sampling_support(
            lambda n, r: run.ekey(r.integers(0, run.E, n)),
            allowed_keys=run.ekey(np.arange(run.E)))

    # --device_routes: the production hot path — routing tables and
    # negative sampling (Local scheme, uniform or alias-table freq) live
    # on device; one runner per worker shard
    dev_runners = {}

    def device_runner(shard: int) -> DeviceRoutedRunner:
        if shard not in dev_runners:
            dev_runners[shard] = DeviceRoutedRunner(
                srv, make_kge_loss(args.model, args.self_adv_temp,
                                   args.l2, args.margin),
                role_class={"s": run.ent_class, "r": run.rel_class,
                            "o": run.ent_class, "neg": run.ent_class},
                role_dim={"s": run.ent_dim, "r": run.rel_dim,
                          "o": run.ent_dim, "neg": run.ent_dim},
                shard=shard, neg_role="neg", neg_shape=(B, N),
                neg_population=run.ekey(np.arange(run.E)),
                neg_alias=neg_alias, seed=args.seed + shard)
        return dev_runners[shard]

    train = ds.train
    # data parallelism over ALL workers of ALL processes (kge.cc:968-970)
    parts = global_worker_slices(len(train), run.num_workers)
    rng = np.random.default_rng(args.seed)
    guard = RuntimeGuard(args.max_runtime)
    watch = Stopwatch(start=True)
    result = {"epoch_losses": [], "gen_s": gen_s, "epoch_s": [],
              "eval_s": []}
    if truth_mrr is not None:
        result["truth_mrr"] = truth_mrr
        result["truth_mrr_o"] = ds.truth_mrr_o
        result["truth_mrr_s"] = ds.truth_mrr_s

    for epoch in range(args.epochs):
        # per-epoch step size: AdaGrad already decays effective rates, but
        # an explicit multiplicative schedule helps late-stage ranking
        # quality on the lowrank harness;
        # --lr_decay 1.0 = the reference's constant-lr behavior
        lr_epoch = args.lr * (args.lr_decay ** epoch)
        t_epoch = time.perf_counter()
        # losses stay device scalars until epoch end: a float() per step
        # would serialize host and device
        epoch_losses = []
        for wi, w in enumerate(workers):
            mine = parts[wi]
            batches = [mine[idx] for idx in
                       wrap_batches(len(mine), B, rng)]
            handles = {}
            staged = {}  # bi -> (roles, StagedKeys) pre-uploaded batches
            prepared_hi = -1  # highest batch index already prepared

            def triple_roles(t):
                # the ONE logical->physical role mapping for a triple
                # batch (prepare, the staged-miss fallback and both step
                # paths must agree)
                return {"s": run.ekey(t[:, 0]), "r": run.rkey(t[:, 1]),
                        "o": run.ekey(t[:, 2])}

            def prepare(bi: int, ahead: int) -> None:
                nonlocal prepared_hi
                if bi <= prepared_hi:
                    return
                prepared_hi = bi
                t = train[batches[bi]]
                roles = triple_roles(t)
                ks = np.unique(np.concatenate(
                    [roles["s"], roles["r"], roles["o"]]))
                fut = w.current_clock + ahead
                w.intent(ks, fut, fut + 1)
                if not args.device_routes:
                    handles[bi] = w.prepare_sample(B * N, fut, fut + 1)
                elif srv.prefetch is not None and K == 1:
                    # prefetch pipeline on: the batch's key upload rides
                    # the prepare path (DeviceRoutedRunner.prefetch_keys)
                    # instead of the dispatch
                    staged[bi] = (roles, device_runner(w.shard)
                                  .prefetch_keys(roles))

            K = max(1, args.scan_steps) if args.device_routes else 1
            for bi in range(min(max(args.lookahead, K), len(batches))):
                prepare(bi, ahead=bi)
            tail_start = len(batches) - len(batches) % K if K > 1 else 0
            if K > 1:
                # K-step windows (runner.run_scan): one dispatch trains K
                # batches; intents run a window ahead, and the K planner
                # rounds and clock ticks follow the window. The tail short
                # of K batches runs per step below.
                look = max(args.lookahead, K)
                window = ScanWindow(srv, K, args.sync_rounds_per_step,
                                    on_loss=epoch_losses.append)
                for lo in range(0, tail_start, K):
                    for bi in range(lo + look,
                                    min(lo + look + K, len(batches))):
                        prepare(bi, ahead=bi - lo)
                    for j in range(K):
                        window.add(device_runner(w.shard),
                                   triple_roles(train[batches[lo + j]]),
                                   None, lr_epoch)
                    for _ in range(K):
                        w.advance_clock()
            for bi in range(tail_start, len(batches)):
                idx = batches[bi]
                if bi + args.lookahead < len(batches):
                    prepare(bi + args.lookahead, ahead=args.lookahead)
                if args.device_routes:
                    pre = staged.pop(bi, None)
                    if pre is not None:  # keys already on the device
                        roles, stg = pre
                        loss = device_runner(w.shard)(roles, None,
                                                      lr_epoch, staged=stg)
                    else:
                        loss = device_runner(w.shard)(
                            triple_roles(train[idx]), None, lr_epoch)
                else:
                    roles = triple_roles(train[idx])
                    neg = np.asarray(
                        w.pull_sample_keys(handles[bi], B * N)).reshape(B, N)
                    w.finish_sample(handles.pop(bi))
                    roles["neg"] = neg
                    loss = run.runner(roles, None, lr_epoch,
                                      shard=w.shard)
                epoch_losses.append(loss)
                srv.drive_rounds(args.sync_rounds_per_step)
                w.advance_clock()
        srv.quiesce()

        # one device-to-host copy per epoch; the JAX app's float32 sums:
        # each window's [K] losses, then pairwise over windows and steps
        step_losses = torch.cat([x.reshape(-1) for x in epoch_losses]) \
            .cpu().numpy() if epoch_losses else np.zeros(0, np.float32)
        sizes = [x.numel() for x in epoch_losses]
        epoch_loss = float(np.sum(
            [g.sum() for g in np.split(step_losses, np.cumsum(sizes)[:-1])]))
        nbatches = len(step_losses)
        result["epoch_s"].append(time.perf_counter() - t_epoch)
        # loss aggregation through the PS loss key (ps_allreduce idiom)
        total = run.allreduce(run.loss_key_l,
                              np.array([epoch_loss / max(nbatches, 1)]))
        run.reset_key(run.loss_key_l, 1)
        epoch_report("kge", epoch, float(total[0]), watch)
        result["loss"] = float(total[0])
        result["epoch_losses"].append(float(total[0]))

        if args.eval_every and (epoch + 1) % args.eval_every == 0 and \
                ds.valid is not None and len(ds.valid):
            t_eval = time.perf_counter()
            agg = _eval_global(run, ds.valid[:args.eval_triples])
            result["eval_s"].append(time.perf_counter() - t_eval)
            cnt = max(float(agg[3]) + float(agg[7]), 1.0)
            result.update(
                mrr=(float(agg[0]) + float(agg[4])) / cnt,
                hits1=(float(agg[1]) + float(agg[5])) / cnt,
                hits10=(float(agg[2]) + float(agg[6])) / cnt,
                mrr_o=float(agg[0]) / max(float(agg[3]), 1.0),
                mrr_s=float(agg[4]) / max(float(agg[7]), 1.0))
            alog(f"[kge] epoch {epoch}: filtered MRR={result['mrr']:.4f} "
                 f"(o={result['mrr_o']:.4f} s={result['mrr_s']:.4f}) "
                 f"Hits@1={result['hits1']:.4f} "
                 f"Hits@10={result['hits10']:.4f}")
        if args.checkpoint_every and \
                (epoch + 1) % args.checkpoint_every == 0:
            from .common import is_rank0
            if is_rank0():
                os.makedirs(args.checkpoint_dir, exist_ok=True)
                run.checkpoint(os.path.join(
                    args.checkpoint_dir, f"kge_epoch{epoch}.npz"))
        if guard.expired():
            alog("[kge] max_runtime reached")
            break

    if ds.test is not None and len(ds.test) and args.eval_every:
        t_eval = time.perf_counter()
        agg = _eval_global(run, ds.test[:args.eval_triples])
        result["eval_s"].append(time.perf_counter() - t_eval)
        cnt = max(float(agg[3]) + float(agg[7]), 1.0)
        result.update(
            test_mrr=(float(agg[0]) + float(agg[4])) / cnt,
            test_hits10=(float(agg[2]) + float(agg[6])) / cnt,
            test_mrr_o=float(agg[0]) / max(float(agg[3]), 1.0),
            test_mrr_s=float(agg[4]) / max(float(agg[7]), 1.0))
        alog(f"[kge] TEST filtered MRR={result['test_mrr']:.4f} "
             f"(o={result['test_mrr_o']:.4f} s={result['test_mrr_s']:.4f}) "
             f"Hits@10={result['test_hits10']:.4f}")
    # mean entity-row L2 norm: regularization evidence (--l2 must shrink
    # it; tests/test_apps.py test_kge_l2_regularizer_shrinks_norms)
    result["replicas_created"] = int(srv.sync.stats.replicas_created)
    result["staged_steps"] = sum(r.staged_steps
                                 for r in dev_runners.values())
    if srv.tier is not None:
        # the tier section's gauges and counters, and the fullest shard's
        # hot rows (each shard holds at most --sys.tier.hot_rows)
        snap = srv.metrics_snapshot()["tier"]
        result["tier"] = {k: v for k, v in snap.items()
                          if not isinstance(v, dict)}
        result["tier"]["hot_rows_per_shard_max"] = max(
            st.res.hot_count(s) for st in srv.stores
            for s in range(st.res.num_shards))
    ent = srv.read_main(run.ekey(np.arange(min(run.E, 2048)))).reshape(
        -1, 2 * run.ent_dim)[:, : run.ent_dim]
    result["ent_norm"] = float(np.sqrt((ent * ent).sum(axis=1)).mean())
    alog("[kge]", srv.sync.report())
    srv.shutdown()
    return result


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", default="complex",
                        choices=["complex", "rescal", "rotate"])
    parser.add_argument("--dim", type=int, default=16)
    parser.add_argument("--neg_ratio", type=int, default=4)
    parser.add_argument("--train", default=None, help="triples file (s r o)")
    parser.add_argument("--valid", default=None)
    parser.add_argument("--test", default=None)
    parser.add_argument("--num_entities", type=int, default=0)
    parser.add_argument("--num_relations", type=int, default=0)
    parser.add_argument("--synthetic_entities", type=int, default=120)
    parser.add_argument("--synthetic_relations", type=int, default=8)
    parser.add_argument("--synthetic_triples", type=int, default=1500)
    parser.add_argument("--synthetic_mode", default="permutation",
                        choices=["permutation", "lowrank"],
                        help="lowrank = drawn from a ground-truth ComplEx "
                             "model (learnable by construction)")
    parser.add_argument("--gen_dim_truth", type=int, default=16,
                        help="lowrank generator: rank of the ground-truth "
                             "ComplEx model")
    parser.add_argument("--gen_temperature", type=float, default=0.25,
                        help="lowrank generator: softmax temperature for "
                             "object sampling (higher = flatter object "
                             "marginal, lower truth ceiling)")
    parser.add_argument("--lookahead", type=int, default=4,
                        help="intent/sample batches ahead (kge.cc :1059)")
    parser.add_argument("--lr_decay", type=float, default=1.0,
                        help="multiplicative per-epoch lr decay "
                             "(1.0 = constant, the reference behavior)")
    parser.add_argument("--scan_steps", type=int, default=1,
                        help="K>1: train K batches per device dispatch "
                             "(runner.run_scan: one CUDA graph replay per "
                             "window on the card, a loop on the CPU; "
                             "device routing only)")
    parser.add_argument("--device_routes",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="device-routed fused step + on-device "
                             "negative sampling (the hot path; default on,"
                             " --no-device_routes for host routing)")
    parser.add_argument("--neg_sampling", default="uniform",
                        choices=["uniform", "freq"],
                        help="negative entity distribution: uniform "
                             "(kge.cc) or unigram^pow over train-triple "
                             "frequencies (mid-scale fix, docs/PERF.md)")
    parser.add_argument("--neg_freq_pow", type=float, default=0.75,
                        help="power for --neg_sampling freq")
    parser.add_argument("--self_adv_temp", type=float, default=0.0,
                        help="self-adversarial negative weighting "
                             "temperature (RotatE eq. 5; 0 = off)")
    parser.add_argument("--margin", type=float, default=12.0,
                        help="RotatE's gamma: score = gamma - distance "
                             "(the authors' default; ranks do not depend "
                             "on it)")
    parser.add_argument("--l2", type=float, default=0.0,
                        help="lazy L2 on the positive triple's embedding "
                             "rows (ComplEx-paper regularizer; 0 = the "
                             "reference's unregularized loss)")
    parser.add_argument("--init_scheme", default="normal",
                        choices=["normal", "uniform"])
    parser.add_argument("--init_scale", type=float, default=0.1)
    parser.add_argument("--init_from", default=None,
                        help="checkpoint .npz to resume from")
    parser.add_argument("--adagrad_init", type=float, default=1e-6)
    parser.add_argument("--eval_every", type=int, default=2)
    parser.add_argument("--eval_triples", type=int, default=500)
    parser.add_argument("--eval_chunk", type=int, default=65536,
                        help="candidate-chunk size for pool-gather eval "
                             "(padded key tiles of the count kernel; 0 = "
                             "dense-matrix path)")
    parser.add_argument("--checkpoint_every", type=int, default=0)
    parser.add_argument("--checkpoint_dir", default="/tmp/adapm_kge_ckpt")
    add_common_arguments(parser)
    return parser


def main(argv=None, device=None) -> int:
    run_app(build_parser().parse_args(argv), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
