"""Runtime telemetry: the metrics registry and the span tracer."""
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, get_global_registry,
                      observe_global, set_global_registry)
from .spans import NULL_SPAN, SpanTracer, span  # noqa: F401
