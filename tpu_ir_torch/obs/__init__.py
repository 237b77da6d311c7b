"""The port's telemetry (the part of `tpu_ir/obs` the serving tier
needs): spans (trace.py) whose durations feed latency histograms
(histogram.py), and the process-wide registry of counters and histograms
(registry.py). `TPU_IR_TRACE=0` turns spans and every latency histogram
off; counters stay on. Not ported: Prometheus text, the trace ring and its
flight dumps, distributed tracing, the query log, progress jobs and the
metrics server."""

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
    """Zero the registry (the tests' isolation hook)."""
    get_registry().reset()


__all__ = ["LatencyHistogram", "TelemetryRegistry", "get_registry",
           "Span", "attach", "configure", "current_span", "enabled",
           "kernel_annotation", "trace", "reset_all"]
