"""The port's telemetry (the part of `tpu_ir/obs` the serving tier
needs): spans (trace.py) whose durations feed latency histograms
(histogram.py), and the process-wide registry of counters and histograms
(registry.py), the SLO burn-rate windows (disttrace.py), and the
embedded server's `/rpc` and `/healthz` (server.py). `TPU_IR_TRACE=0`
turns spans and every latency histogram off; counters stay on. Not
ported: Prometheus text, the trace ring and its flight dumps, trace
contexts and their stitching, the query log, progress jobs and the rest
of the metrics server."""

from . import disttrace
from .histogram import LatencyHistogram
from .registry import TelemetryRegistry, get_registry
from .trace import (
    Span,
    attach,
    configure,
    current_span,
    enabled,
    kernel_annotation,
    trace,
)


def reset_all() -> None:
    """Zero the registry and drop the SLO windows (the tests' isolation
    hook)."""
    get_registry().reset()
    disttrace.reset()


__all__ = ["LatencyHistogram", "TelemetryRegistry", "get_registry",
           "Span", "attach", "configure", "current_span", "enabled",
           "kernel_annotation", "trace", "reset_all"]
