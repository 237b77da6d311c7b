"""The port's telemetry (the part of `tpu_ir/obs` the serving tier
needs): spans and the ring of finished request trees (trace.py), whose
durations feed latency histograms (histogram.py), the process-wide
registry of counters and histograms (registry.py), distributed request
tracing and the SLO burn-rate windows (disttrace.py), the span spool
(aggregate.py), and the embedded server's `/rpc`, `/healthz`, `/slo` and
`/trace` (server.py). `TPU_IR_TRACE=0` turns spans and every latency
histogram off; counters stay on. Not ported: Prometheus text, flight
dumps, the query log, progress jobs, the cumulative telemetry spool and
the rest of the metrics server."""

from .histogram import LatencyHistogram
from .registry import TelemetryRegistry, get_registry
from .trace import (
    Span,
    attach,
    clear_traces,
    configure,
    current_root,
    current_span,
    enabled,
    kernel_annotation,
    recent_traces,
    record_span,
    trace,
)
from . import disttrace  # noqa: E402 — registers the root-close hook


def reset_all() -> None:
    """Zero the registry, empty the trace ring, drop the distributed-trace
    store and the SLO windows (the tests' isolation hook)."""
    get_registry().reset()
    clear_traces()
    disttrace.reset()


__all__ = ["LatencyHistogram", "TelemetryRegistry", "get_registry",
           "Span", "attach", "clear_traces", "configure", "current_root",
           "current_span", "enabled", "kernel_annotation", "recent_traces",
           "record_span", "trace", "disttrace", "reset_all"]
