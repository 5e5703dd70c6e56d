"""Periodic one-line metrics report (`--sys.metrics.report N` seconds):
the port of the JAX package's `obs/reporter.py`, with its line format.

This module is imported ONLY when the reporter is enabled (Server checks
`opts.metrics and opts.metrics_report_s > 0` before importing) — with
`--sys.metrics 0` it never loads, which tests assert. Keep it free of
side effects at import time.

The report reads the REGISTRY only (no device sync): a line every N
seconds must not force device readbacks the way a full
`Server.metrics_snapshot()` may.

Line format (stable; tests pin it): space-separated `field=value`
groups, each emitted only when its subsystem has activity, always in
this order:

    pull=<n> avg=<ms>ms  push=<n> avg=<ms>ms   kv op counts + mean
    staged_hit=<ratio>                         prefetch hit rate
    plan_hit=<ratio>                           plan-cache hit rate
    rounds=<n> reloc=<n> repl=<n>              sync activity
    serve=<n> p50=<ms>ms p99=<ms>ms            lookups + latency tail
    overlap=<ratio>                            exec overlap_fraction
    hot_hit=<ratio>                            tier hot-hit rate
    fresh=<ms>ms                               push-to-servable P99
                                               (flight.freshness_s)
    regret=<ratio>                             worst per-plane decision
                                               regret rate
    policy=<applied>/<consults>                learned-policy verdicts
                                               (+ `shadow_dis=<n>`)
    net=<msgs>/<bytes> peers=<live>/<total>    transport-plane frames

The transport plane is not ported yet; its section stays empty on the
port and contributes nothing. Ratios are 2-decimal, latencies
2-decimal milliseconds."""
from __future__ import annotations

import threading
from typing import Optional

from .metrics import hist_percentile


def _fmt(snap: dict) -> str:
    """Compress a registry snapshot into one line of the load-bearing
    numbers (format contract in the module docstring); unknown sections
    degrade to counts, never crash."""
    parts = []
    kv = snap.get("kv", {})
    for h in ("pull_s", "push_s"):
        d = kv.get(h)
        if isinstance(d, dict) and d.get("count"):
            parts.append(f"{h[:-2]}={d['count']} "
                         f"avg={d['avg'] * 1e3:.2f}ms")
    pf = snap.get("prefetch", {})
    if pf.get("staged"):
        tot = pf.get("hits", 0) + pf.get("expired", 0) or 1
        parts.append(f"staged_hit={pf.get('hits', 0) / tot:.2f}")
    pc = snap.get("plan_cache", {})
    att = pc.get("hits", 0) + pc.get("misses", 0) + pc.get("stale", 0)
    if att:
        parts.append(f"plan_hit={pc.get('hits', 0) / att:.2f}")
    sy = snap.get("sync", {})
    if sy.get("rounds"):
        parts.append(f"rounds={sy['rounds']} "
                     f"reloc={sy.get('relocations', 0)} "
                     f"repl={sy.get('replicas_created', 0)}")
    # serving plane: lookup count + the latency tail the SLO lives on
    sv = snap.get("serve", {})
    lat = sv.get("latency_s")
    if isinstance(lat, dict) and lat.get("count"):
        parts.append(
            f"serve={sv.get('lookups_total', lat['count'])} "
            f"p50={hist_percentile(lat, 0.50) * 1e3:.2f}ms "
            f"p99={hist_percentile(lat, 0.99) * 1e3:.2f}ms")
    # executor: cross-stream overlap once any program has run
    ex = snap.get("exec", {})
    if ex.get("programs_total"):
        parts.append(f"overlap={ex.get('overlap_fraction', 0.0):.2f}")
    # tiered storage: hot-hit rate once any tiered gather ran
    tr = snap.get("tier", {})
    if tr.get("hot_hits", 0) or tr.get("cold_hits", 0):
        parts.append(f"hot_hit={tr.get('hot_hit_rate', 0.0):.2f}")
    # push-to-servable freshness tail (flight probe) once it has samples
    fr = snap.get("flight", {}).get("freshness_s")
    if isinstance(fr, dict) and fr.get("count"):
        parts.append(f"fresh={hist_percentile(fr, 0.99) * 1e3:.2f}ms")
    # decision telemetry: the worst per-plane regret rate once any
    # outcome window resolved
    dc = snap.get("decision", {})
    rates = [v for k, v in dc.items() if k.startswith("regret_rate.")
             and isinstance(v, (int, float))]
    if dc.get("events_total") and rates:
        parts.append(f"regret={max(rates):.2f}")
    # learned-policy plane: verdicts applied vs consults once any
    # decision site consulted a model; absent by default —
    # the policy counters only register when a policy file is loaded
    po = snap.get("policy", {})
    if po.get("consults_total"):
        parts.append(f"policy={po.get('applied_total', 0)}"
                     f"/{po['consults_total']}")
        if po.get("shadow_disagree"):
            parts.append(f"shadow_dis={po['shadow_disagree']}")
    # transport plane: frames sent + peer liveness once a NetPort is
    # attached; absent by default — the net.* names only
    # register when a membership plane exists (loopback/tcp node)
    nt = snap.get("net", {})
    if nt.get("msgs_out") or nt.get("msgs_in"):
        parts.append(f"net={nt.get('msgs_out', 0)}"
                     f"/{nt.get('bytes_out', 0)} "
                     f"peers={nt.get('peers_live', 0)}"
                     f"/{nt.get('peers_total', 0)}")
    return " ".join(parts) or "no activity yet"


class Reporter:
    """Background thread logging `_fmt(registry.snapshot())` every
    `interval_s`. Daemon; `stop()` joins it."""

    def __init__(self, registry, interval_s: float, rank: int = 0):
        self.registry = registry
        self.interval_s = interval_s
        self.rank = rank
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="adapm-metrics-report")
        self._thread.start()

    def _loop(self) -> None:
        from ..utils.log import alog
        while not self._stop.wait(self.interval_s):
            alog(f"[metrics r{self.rank}] "
                 f"{_fmt(self.registry.snapshot())}")

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None
