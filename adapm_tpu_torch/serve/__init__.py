"""The online serving plane: the parameter manager as a query-servable
store (the port of the JAX package's `serve/`).

Training builds the table; this layer reads it under load:

  - `admission` — bounded request lanes with backpressure and deadlines
    (reject loudly, never hang), per-tenant token-bucket quotas and
    priority classes;
  - `batcher`   — the micro-batching coalescer: concurrent lookups merge
    into one deduplicated key batch, one K1 gather per length class,
    and bag reads into one K8 `gather_pool` launch per length class and
    pooling, on `--sys.serve.dispatchers` executor streams;
  - `replica`   — the lock-free hot-row snapshot, bit-identical by
    write-epoch validation (`--sys.serve.replica_rows`);
  - `session`   — the client API: `ServeSession.lookup(keys,
    deadline_ms)` and `lookup_bags(tables, bags, pooling)`, each
    bit-identical to a plain `Worker.pull` (and `pool_bags_host` over
    it) of the same keys;
  - `bags`      — the bag request, its batch planner and the host twin
    of K8's pooling;
  - `health`    — liveness/readiness, folded into `metrics_snapshot()`.

Quickstart (a Server on the card; `device="cpu"` for the CPU)::

    import adapm_tpu_torch as at
    from adapm_tpu_torch.serve import ServePlane
    srv = at.setup(num_keys, value_length)
    plane = ServePlane(srv)                # knobs from srv.opts
    sess = plane.session()                 # one per client thread
    vals = sess.lookup(keys, deadline_ms=50)
    (pooled,) = sess.lookup_bags([members], [offsets], pooling="sum")
    plane.close()                          # or srv.shutdown()
"""
from __future__ import annotations

from .admission import (AdmissionQueue, DeadlineExceededError,  # noqa: F401
                        LookupRequest, ServeDegradedError,
                        ServeOverloadError, TenantState)
from .batcher import LookupBatcher  # noqa: F401
from .health import HealthMonitor  # noqa: F401
from .replica import ServeReplica  # noqa: F401
from .session import ServeSession  # noqa: F401


class ServePlane:
    """Assembles lanes + batcher + replica + health over one Server and
    owns their lifecycle. One live plane per Server (a plane closed and
    rebuilt on the same server reuses the serve.* metrics; gauges rebind
    to the new plane)."""

    def __init__(self, server, opts=None, shard: int = 0,
                 start: bool = True, dead_nodes_fn=None,
                 dead_node_max_age_s: float = 10.0):
        opts = opts if opts is not None else server.opts
        opts.validate_serve()  # bad knobs fail loudly, parsed or not
        if server._serve_plane is not None:
            raise RuntimeError(
                "one live ServePlane per Server: close() the existing "
                "plane first")
        self.server = server
        self.opts = opts
        self.queue = AdmissionQueue(opts.serve_queue, registry=server.obs,
                                    lanes=max(1, opts.serve_dispatchers),
                                    lockorder=opts.lint_lockorder)
        self.batcher = LookupBatcher(server, opts, self.queue, shard=shard)
        # the read-only replica exists only with rows budgeted
        self.replica = None
        if opts.serve_replica_rows > 0:
            self.replica = ServeReplica(server, opts, registry=server.obs)
            self.batcher.replica = self.replica
        self.health = HealthMonitor(self, max_age_s=dead_node_max_age_s,
                                    dead_nodes_fn=dead_nodes_fn)
        # the SLO autopilot (obs/slo.py) exists only with a target set
        self.slo = None
        if opts.serve_slo_ms > 0:
            from ..config import parse_class_targets
            from ..obs.slo import SLOController
            cls = parse_class_targets(opts.serve_slo_ms,
                                      opts.serve_slo_class,
                                      flag="--sys.serve.slo_ms")
            self.slo = SLOController(server, self.batcher,
                                     target_ms=opts.serve_slo_ms,
                                     class_targets=cls)
        server._serve_plane = self
        if start:
            self.start()

    def start(self) -> None:
        self.batcher.start()
        if self.slo is not None:
            self.slo.start()

    def configure_tenant(self, name: str, priority: int = 0,
                         qps: float = 0.0, burst=None) -> TenantState:
        """Create or update a tenant's admission policy (token-bucket
        quota + priority class). Reconfiguring a live tenant adjusts its
        policy in place."""
        return self.queue.configure_tenant(name, priority=priority,
                                           qps=qps, burst=burst)

    def session(self, worker=None, tenant=None,
                priority=None) -> ServeSession:
        """A client handle (one per client thread; cheap); `tenant` and
        `priority` bind it to an admission class."""
        return ServeSession(self, worker=worker, tenant=tenant,
                            priority=priority)

    def close(self) -> None:
        """Stop the dispatchers and fail-stop queued requests.
        Idempotent; also called by `Server.shutdown()`."""
        if self.slo is not None:
            self.slo.close()
        if self.replica is not None:
            # the refresh program reads the pools like a drain: quiesce
            # it before teardown proceeds
            self.replica.close()
        self.batcher.stop()
        if self.server._serve_plane is self:
            self.server._serve_plane = None

    def __enter__(self) -> "ServePlane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
