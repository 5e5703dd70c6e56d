"""Process-wide metrics registry: counters, gauges, bounded histograms.

Design goals:

  - **Lock-cheap on the hot path.** A Counter/Histogram increment touches
    only a per-thread cell (one dict lookup on `threading.local` + a
    float add); shards are merged under a lock only at snapshot time.
    Worker threads, the prefetch thread, sync threads, and DCN handler
    threads all report without contending.
  - **Bounded memory.** Histograms have a fixed geometric bucket ladder
    (`LATENCY_BOUNDS_S`: 1 µs .. ~17 s, 14 buckets) — never per-value
    storage.
  - **One namespace.** Metric names are dotted (`section.name`); the
    first segment groups the snapshot (`kv.pull_s` lands in
    `snapshot()["kv"]["pull_s"]`). Registering the same name twice
    raises unless the caller declares the metric `shared` (several
    DeviceRoutedRunners legitimately feed one `fused.*` counter) — the
    duplicate-name check that keeps two subsystems from silently
    splitting one counter.
  - **Free when off.** A disabled registry hands out null metric
    singletons whose ops are no-ops and whose snapshot is empty;
    callers that want to skip even the `perf_counter()` bracketing
    check `registry.enabled` once and cache the decision.

The registry is owned by the Server (`Server.obs`). Module-level
`set_global_registry`/`observe_global` exist for call sites with no
server handle (parallel/control.py barrier/allreduce waits): the most
recently constructed live Server registers itself, held weakly.
"""
from __future__ import annotations

import bisect
import threading
import weakref
from typing import Callable, Dict, List, Optional

# default latency ladder, seconds: geometric x4 from 1 µs; the +inf
# overflow bucket is implicit (len(bounds) + 1 buckets total)
LATENCY_BOUNDS_S = tuple(1e-6 * 4 ** i for i in range(13))

# serving-path latency ladder: geometric x2 from 20 µs to ~2.6 s. The
# serve plane reports P50/P99 through `hist_percentile`, whose in-bucket
# interpolation error is bounded by the bucket ratio — x2 halves the
# worst-case error of the x4 default where the latency SLO lives
# (adapm_tpu/serve; docs/SERVING.md "Tuning").
SERVE_LATENCY_BOUNDS_S = tuple(2e-5 * 2 ** i for i in range(18))

# micro-batch size ladder (requests per coalesced batch): powers of two
# up to 1024 — `serve.batch_size` is a count histogram, not a latency
BATCH_SIZE_BOUNDS = tuple(float(2 ** i) for i in range(11))


class Counter:
    """Monotonic float counter, per-thread sharded."""

    kind = "counter"

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self._local = threading.local()
        self._cells: List[List[float]] = []
        self._lock = threading.Lock()

    def _cell(self) -> List[float]:
        c = getattr(self._local, "c", None)
        if c is None:
            c = self._local.c = [0.0]
            with self._lock:
                self._cells.append(c)
        return c

    def inc(self, n: float = 1) -> None:
        self._cell()[0] += n

    @property
    def value(self) -> float:
        with self._lock:
            return sum(c[0] for c in self._cells)

    def snap(self):
        v = self.value
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Last-writer-wins value, or a callable evaluated at snapshot time
    (zero hot-path cost: occupancy/version gauges read live structures
    only when someone asks)."""

    kind = "gauge"

    def __init__(self, name: str, unit: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.unit = unit
        self._fn = fn
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = v

    @property
    def value(self):
        if self._fn is not None:
            return self._fn()
        return self._value

    def snap(self):
        return self.value


class Histogram:
    """Bounded-bucket histogram, per-thread sharded.

    Each thread owns [bucket_counts..., count, sum, max]; `observe` is a
    bisect + three adds on the thread's own cell. Merge happens at
    snapshot time under the cell-list lock.
    """

    kind = "histogram"

    def __init__(self, name: str, unit: str = "s",
                 bounds=LATENCY_BOUNDS_S):
        self.name = name
        self.unit = unit
        self.bounds = tuple(float(b) for b in bounds)
        self._nb = len(self.bounds) + 1  # + overflow
        self._local = threading.local()
        self._cells: List[List[float]] = []
        self._lock = threading.Lock()

    def _cell(self) -> List[float]:
        c = getattr(self._local, "c", None)
        if c is None:
            c = self._local.c = [0.0] * (self._nb + 3)
            with self._lock:
                self._cells.append(c)
        return c

    def observe(self, v: float) -> None:
        c = self._cell()
        c[bisect.bisect_left(self.bounds, v)] += 1
        c[self._nb] += 1
        c[self._nb + 1] += v
        if v > c[self._nb + 2]:
            c[self._nb + 2] = v

    def snap(self) -> Dict:
        with self._lock:
            cells = [list(c) for c in self._cells]
        buckets = [0] * self._nb
        count = 0
        total = 0.0
        mx = 0.0
        for c in cells:
            for i in range(self._nb):
                buckets[i] += int(c[i])
            count += int(c[self._nb])
            total += c[self._nb + 1]
            mx = max(mx, c[self._nb + 2])
        return {"count": count, "sum": total,
                "avg": (total / count) if count else 0.0,
                "max": mx, "bounds": list(self.bounds),
                "buckets": buckets}

    @property
    def count(self) -> int:
        with self._lock:
            return int(sum(c[self._nb] for c in self._cells))


class _NullMetric:
    """Shared no-op stand-in handed out by a disabled registry."""

    name = "<disabled>"
    unit = ""
    value = 0
    count = 0

    def inc(self, n: float = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def snap(self):
        return 0


_NULL = _NullMetric()


class MetricsRegistry:
    """One namespace of metrics; see module docstring. `--sys.metrics 0`
    constructs it disabled: every factory returns the null metric and
    `snapshot()` is `{}` — subsystems keep their wiring, the process
    pays nothing."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    # -- factories -----------------------------------------------------------

    def _register(self, name: str, kind: str, make, shared: bool):
        if not self.enabled:
            return _NULL
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not shared or m.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} (declare shared=True only for a "
                        f"metric several reporters legitimately feed)")
                return m
            m = make()
            self._metrics[name] = m
            return m

    def counter(self, name: str, unit: str = "",
                shared: bool = False) -> Counter:
        return self._register(name, "counter",
                              lambda: Counter(name, unit), shared)

    def gauge(self, name: str, unit: str = "", fn=None,
              shared: bool = False) -> Gauge:
        g = self._register(name, "gauge",
                           lambda: Gauge(name, unit, fn=fn), shared)
        if shared and fn is not None and isinstance(g, Gauge):
            # a shared gauge rebinds to the LATEST provider: a subsystem
            # torn down and rebuilt on the same server (e.g. a second
            # ServePlane after close()) must not leave the gauge reading
            # the dead instance's structures
            g._fn = fn
        return g

    def histogram(self, name: str, unit: str = "s",
                  bounds=LATENCY_BOUNDS_S,
                  shared: bool = False) -> Histogram:
        return self._register(
            name, "histogram",
            lambda: Histogram(name, unit, bounds=bounds), shared)

    def find(self, name: str):
        """Existing metric or None (never creates)."""
        with self._lock:
            return self._metrics.get(name)

    # -- snapshot ------------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict]:
        """{section: {metric: value}} — section is the first dotted
        segment of the name; histogram values are dicts (count / sum /
        avg / max / bounds / buckets). Empty when disabled."""
        if not self.enabled:
            return {}
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Dict] = {}
        for name, m in items:
            sec, _, rest = name.partition(".")
            out.setdefault(sec, {})[rest or name] = m.snap()
        return out

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)


class CounterGroup:
    """Dict-like view over a fixed set of registry counters
    (`prefix.key`) — how the pre-existing ad-hoc stat dicts
    (PrefetchScheduler.stats) fold into the registry while their old
    read accessors (`stats["hits"]`, `dict(stats)`) keep working. When
    the registry is off, standalone counters back the view so the
    subsystem's own accounting survives `--sys.metrics 0`."""

    def __init__(self, registry: Optional[MetricsRegistry], prefix: str,
                 keys, unit: str = ""):
        use_reg = registry is not None and registry.enabled
        self._counters: Dict[str, Counter] = {
            k: (registry.counter(f"{prefix}.{k}", unit) if use_reg
                else Counter(f"{prefix}.{k}", unit))
            for k in keys}

    def inc(self, key: str, n: float = 1) -> None:
        self._counters[key].inc(n)

    def __getitem__(self, key: str):
        return self._counters[key].snap()

    def __setitem__(self, key: str, v) -> None:
        # legacy `stats[k] += n` support: apply the delta
        c = self._counters[key]
        c.inc(v - c.value)

    def __contains__(self, key: str) -> bool:
        return key in self._counters

    def __iter__(self):
        return iter(self._counters)

    def keys(self):
        return self._counters.keys()

    def items(self):
        return ((k, c.snap()) for k, c in self._counters.items())

    def as_dict(self) -> Dict[str, float]:
        return {k: c.snap() for k, c in self._counters.items()}


def hist_percentile(snap: Dict, q: float) -> float:
    """Approximate quantile `q` (0..1) from a `Histogram.snap()` dict by
    linear interpolation inside the containing bucket — the consumer-side
    P50/P90 extraction for bounded-bucket histograms (bench.py `mgmt`
    phase, staleness reporting). Observations in the +inf overflow bucket
    clamp to the last finite bound; an empty histogram returns 0."""
    count = snap.get("count", 0)
    if not count:
        return 0.0
    bounds = snap["bounds"]
    buckets = snap["buckets"]
    target = q * count
    acc = 0.0
    for i, b in enumerate(buckets):
        below = acc
        acc += b
        if acc >= target:
            if i >= len(bounds):
                return float(bounds[-1])
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            hi = float(bounds[i])
            frac = (target - below) / b if b else 0.0
            return lo + frac * (hi - lo)
    return float(bounds[-1])


# -- global hook (call sites with no Server handle) --------------------------

_global_ref: Optional["weakref.ref"] = None


def set_global_registry(reg: Optional[MetricsRegistry]) -> None:
    """Register `reg` as the process default (weakly held; the most
    recently constructed live Server wins). Pass None to clear."""
    global _global_ref
    _global_ref = weakref.ref(reg) if reg is not None else None


def clear_global_registry(reg: MetricsRegistry) -> None:
    """Clear the process default iff it is still `reg` (a later Server
    may have replaced it; its registration must survive our shutdown)."""
    global _global_ref
    if _global_ref is not None and _global_ref() is reg:
        _global_ref = None


def get_global_registry() -> Optional[MetricsRegistry]:
    ref = _global_ref
    if ref is None:
        return None
    reg = ref()
    return reg if reg is not None and reg.enabled else None


def observe_global(name: str, value: float) -> None:
    """Record into a pre-registered histogram of the process-default
    registry; silently a no-op when no enabled registry is live or the
    metric was never created (the Server registers the collective.*
    histograms at construction)."""
    reg = get_global_registry()
    if reg is None:
        return
    h = reg.find(name)
    if h is not None:
        h.observe(value)


class timed:
    """THE wall-time histogram bracket (one implementation, not a
    per-site perf_counter/try-finally copy): observes elapsed seconds
    into `target` on exit — a Histogram (or the null metric), or a
    metric NAME resolved through the process-default registry at exit
    (observe_global semantics, for call sites with no server handle)."""

    __slots__ = ("target", "_t0")

    def __init__(self, target):
        self.target = target
        self._t0 = 0.0

    def __enter__(self):
        import time
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time
        dt = time.perf_counter() - self._t0
        if isinstance(self.target, str):
            observe_global(self.target, dt)
        else:
            self.target.observe(dt)
        return False
