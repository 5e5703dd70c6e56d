"""Measured kernel cost table (the port of the JAX package's
`ops/costs.py`).

The serving plane's choice between the fused gather + pool (K8) and the
flat gather + host pool for bag reads (serve/bags.py) is a *measured*
question: the answer depends on the card, the row width, the batch size
and the dtype, and hard-coding one preference bakes in whatever machine
the code was written on. This module measures each variant on
the live store and persists the result as a small versioned JSON
table:

    {"version": 1, "backend": "...", "entries": {
        "<variant>|<L>|<bucket>|<dtype>|<pooling>": <median µs>, ...}}

Variants probed by `calibrate_store`:

  - `gather`         — the flat row gather, K1 `routed_gather`
                       (readback included);
  - `gather_pool`    — the fused gather + segment pool, K8 `gather_pool`
                       (pooled readback only);
  - `gather_hostpool`— K1's flat gather + `pool_bags_host` on the host
                       (the same bits, the reduction on the host).

The table also sizes episodic prep windows (`suggest_episode_batches`,
device/episode.py). (The JAX package also probes its Pallas block
gather, `pallas_gather`, and the tiered cold wire; the port's gather
kernel is K1, timed as `gather`.)

Dispatch-time consult: `prefer_fused(L, n, dtype, pooling)` compares
the measured fused vs host-pool entries at the nearest calibrated
bucket — `None` (no data) leaves the caller's default choice alone, so
a missing or stale table can never change behavior, only a measured
one can. The choice moves WHERE the pooling runs, never what it
returns (the bit-identity contract, serve/bags.py).

Keyed by the PADDED bucket size (`core.store.bucket_size`): the store
pads every batch to it, so costs are a property of the padded shape,
not the raw batch length.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Optional

import numpy as np

COSTS_SCHEMA_VERSION = 1

# prep-window budget for `suggest_episode_batches`: one episode's host
# prep should stage about this much measured gather work — windows
# scale down on slow/wide classes and up on fast/narrow ones
_PREP_BUDGET_US = 4000.0


def dtype_name(store) -> str:
    """A store's element type as the table keys it ("float32")."""
    return str(store.dtype).replace("torch.", "")


def _median_us(samples: List[float]) -> float:
    samples = sorted(samples)
    return samples[len(samples) // 2] * 1e6


class KernelCostTable:
    """Measured per-(variant, L, bucket, dtype, pooling) dispatch costs
    in microseconds. Plain counters by default; `bind_metrics` swaps in
    registry-backed ones (the serve/replica registration discipline)."""

    def __init__(self, backend: str = "unknown"):
        self.backend = backend
        self._us: Dict[str, float] = {}
        from ..obs.metrics import Counter
        self.c_consults = Counter("device.costs_consults_total")
        self.c_overrides = Counter("device.costs_overrides_total")
        self.c_calibrations = Counter("device.costs_calibrations_total")

    def bind_metrics(self, reg) -> None:
        """Re-home the counters (and an entry-count gauge) in a metrics
        registry — `device.costs_*`. Counts accumulated
        before the bind (a calibration pass runs first) carry over."""
        if reg is None or not reg.enabled:
            return
        self._rebind("c_consults",
                     reg.counter("device.costs_consults_total",
                                 shared=True))
        self._rebind("c_overrides",
                     reg.counter("device.costs_overrides_total",
                                 shared=True))
        self._rebind("c_calibrations",
                     reg.counter("device.costs_calibrations_total",
                                 shared=True))
        reg.gauge("device.costs_entries", shared=True,
                  fn=lambda: float(len(self._us)))

    def _rebind(self, attr: str, c) -> None:
        pre = int(getattr(self, attr).value)
        if pre:
            c.inc(pre)
        setattr(self, attr, c)

    # -- entries -------------------------------------------------------------

    @staticmethod
    def _key(variant: str, L: int, bucket: int, dtype: str,
             pooling: str) -> str:
        return f"{variant}|{int(L)}|{int(bucket)}|{dtype}|{pooling}"

    def record(self, variant: str, L: int, bucket: int, dtype: str,
               pooling: str, cost_us: float) -> None:
        self._us[self._key(variant, L, bucket, dtype,
                           pooling)] = float(cost_us)

    def cost_us(self, variant: str, L: int, bucket: int, dtype: str,
                pooling: str) -> Optional[float]:
        return self._us.get(self._key(variant, L, bucket, dtype,
                                      pooling))

    def __len__(self) -> int:
        return len(self._us)

    def entries(self) -> Dict[str, float]:
        """Copy of the measured entries (key -> median microseconds),
        sorted by key — the bench artifact's cost-table snapshot."""
        return dict(sorted(self._us.items()))

    def _nearest_bucket(self, variant: str, L: int, n: int, dtype: str,
                        pooling: str) -> Optional[int]:
        """The calibrated bucket closest (log-scale) to batch size `n`
        for this (variant, L, dtype, pooling) — costs are per compiled
        shape, so consult the nearest measured shape."""
        cands = []
        for k in self._us:
            v, kl, kb, kd, kp = k.split("|")
            if (v == variant and int(kl) == int(L) and kd == dtype
                    and kp == pooling):
                cands.append(int(kb))
        if not cands:
            return None
        n = max(1, int(n))
        return min(cands, key=lambda b: abs(np.log2(b) - np.log2(n)))

    # -- dispatch-time consult (serve/batcher.py) ---------------------------

    def prefer_fused(self, L: int, n: int, dtype: str,
                     pooling: str) -> Optional[bool]:
        """Measured verdict for a bag dispatch of `n` member rows of
        width `L`: True = the fused gather+pool is cheaper, False = the
        flat gather + host pool is, None = no measurement for this
        shape (caller keeps its default). Counts every consult; the
        caller counts overrides."""
        self.c_consults.inc()
        b = self._nearest_bucket("gather_pool", L, n, dtype, pooling)
        if b is None:
            return None
        fused = self.cost_us("gather_pool", L, b, dtype, pooling)
        host = self.cost_us("gather_hostpool", L, b, dtype, pooling)
        if fused is None or host is None:
            return None
        return fused <= host

    def suggest_episode_batches(self, default: int,
                                lengths: Iterable[int],
                                dtype: str = "float32") -> int:
        """Size the episodic prep window from the measured per-class
        `gather` costs: one episode's prep should stage about
        `_PREP_BUDGET_US` of gather work, so slow/wide classes get
        shorter windows (prep must not outrun the overlapped commit)
        and fast/narrow ones longer, clamped to [1, 4*default]. With
        no relevant entries the `default` is returned untouched."""
        worst = 0.0
        for L in lengths:
            b = self._nearest_bucket("gather", int(L), 512, dtype, "sum")
            if b is None:
                continue
            c = self.cost_us("gather", int(L), b, dtype, "sum")
            if c is not None:
                worst = max(worst, c)
        if worst <= 0.0:
            return int(default)
        return int(np.clip(round(_PREP_BUDGET_US / worst), 1,
                           4 * max(1, int(default))))

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the versioned JSON (atomic rename — a crashed
        calibration never leaves a torn table)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"version": COSTS_SCHEMA_VERSION,
                       "backend": self.backend,
                       "entries": self._us}, f, indent=1,
                      sort_keys=True)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "KernelCostTable":
        """Load a persisted table; ValueError on a version mismatch
        (recalibrate — entry semantics may have changed), the usual
        OSError family when the file is missing/unreadable."""
        with open(path) as f:
            doc = json.load(f)
        ver = doc.get("version")
        if ver != COSTS_SCHEMA_VERSION:
            raise ValueError(
                f"cost table {path!r} has schema version {ver!r}, "
                f"expected {COSTS_SCHEMA_VERSION} — recalibrate "
                f"(--sys.costs.calibrate)")
        t = cls(backend=str(doc.get("backend", "unknown")))
        for k, v in doc.get("entries", {}).items():
            t._us[str(k)] = float(v)
        return t


# -- calibration -------------------------------------------------------------


def _time_median(fn, repeats: int) -> float:
    """Median wall-clock of `repeats` calls, in µs (one warmup call —
    the first call of a process builds the kernels)."""
    fn()
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return _median_us(samples)


def calibrate_store(store, table: KernelCostTable,
                    buckets: Iterable[int] = (64, 512),
                    poolings: Iterable[str] = ("sum", "mean"),
                    repeats: int = 5,
                    rng: Optional[np.random.Generator] = None) -> None:
    """Measure every variant on one live ShardedStore and record the
    results into `table`. Deterministic member indices (seeded rng);
    every probe includes the host readback — the cost a dispatch site
    actually pays."""
    from ..core.store import OOB, bucket_size
    from ..serve.bags import pool_bags_host
    rng = rng or np.random.default_rng(0)
    L = int(store.value_length)
    dtype = dtype_name(store)
    S = store.ctx.num_shards
    for n in buckets:
        n = int(n)
        b = bucket_size(n, store.bucket_min)
        o_sh = rng.integers(0, S, size=n).astype(np.int32)
        o_sl = rng.integers(0, store.main_slots,
                            size=n).astype(np.int32)
        c_sh = np.zeros(n, np.int32)
        c_sl = np.full(n, OOB, np.int32)
        use_c = np.zeros(n, bool)
        nbags = max(1, n // 8)
        seg = np.minimum(np.arange(n, dtype=np.int64) // 8,
                         nbags - 1).astype(np.int32)

        def _flat_gather():
            return store.gather(o_sh, o_sl, c_sh, c_sl,
                                use_c)[:n].cpu().numpy()

        table.record("gather", L, b, dtype, "sum",
                     _time_median(_flat_gather, repeats))
        for pooling in poolings:
            table.record(
                "gather_pool", L, b, dtype, pooling,
                _time_median(
                    lambda: store.gather_pool(
                        o_sh, o_sl, c_sh, c_sl, use_c, seg, nbags,
                        pooling=pooling)[:nbags].cpu().numpy(),
                    repeats))
            table.record(
                "gather_hostpool", L, b, dtype, pooling,
                _time_median(
                    lambda: pool_bags_host(_flat_gather(), seg,
                                           nbags, pooling),
                    repeats))


def calibrate_server(server, buckets: Iterable[int] = (64, 512),
                     repeats: int = 5) -> KernelCostTable:
    """One calibration pass over every length class of a live Server.
    Returns the populated table (caller persists via `table.save`)."""
    table = KernelCostTable(
        backend=getattr(server.stores[0].port, "name", "unknown")
        if server.stores else "unknown")
    rng = np.random.default_rng(0)
    for st in server.stores:
        calibrate_store(st, table, buckets=buckets, repeats=repeats,
                        rng=rng)
    table.c_calibrations.inc()
    return table
