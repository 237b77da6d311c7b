"""The port's telemetry (`tpu_ir/obs`): spans and the ring of finished
request trees (trace.py),
whose durations feed latency histograms (histogram.py), the process-wide
registry of counters, gauges and histograms with its Prometheus text
(registry.py), the device-cost profiler's cold calls, dispatch split and
memory gauges (profiling.py), the flight recorder's failure artifacts
(recorder.py), progress jobs (progress.py), the query log and the
slow-query trap (querylog.py), distributed request tracing and the SLO
burn-rate windows (disttrace.py), the telemetry time machine's windowed
history, anomaly detector and diurnal forecaster (timeseries.py), the
cumulative snapshots' cluster merge and the span spool (aggregate.py),
and the embedded server's `/rpc`, `/healthz`, `/metrics`,
`/metrics.json`, `/profile`, `/doctor`, `/jobs`, `/querylog`, `/flight`,
`/slo`, `/trace`, `/timeseries` and `/cluster` (server.py).
`TPU_IR_TRACE=0` turns spans and every latency histogram off; counters
stay on. `TPU_IR_PROFILE=0` turns the profiler off, `TPU_IR_TIMESERIES=0`
the time machine."""

from . import profiling, progress
from .histogram import LatencyHistogram
from .progress import current_job, report_progress, start_job
from .recorder import flight_dir, flight_dump, reset_rate_limit
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
from . import querylog  # noqa: E402 — after recorder, which it imports
from . import disttrace  # noqa: E402 — registers the root-close hook
from . import timeseries  # noqa: E402


def reset_all() -> None:
    """Zero the registry, empty the trace ring, forget the jobs, the query
    log and the flight recorder's rate limit, drop the distributed-trace
    store and the SLO windows, the profiler's ledger and recompile window,
    and the time series' history and baselines (the tests' isolation
    hook; a running sampler keeps running)."""
    get_registry().reset()
    profiling.reset_profile()
    clear_traces()
    progress.clear_jobs()
    reset_rate_limit()
    querylog.clear()
    disttrace.reset()
    timeseries.reset()


__all__ = ["LatencyHistogram", "TelemetryRegistry", "get_registry",
           "flight_dir", "flight_dump", "reset_rate_limit", "progress",
           "start_job", "report_progress", "current_job",
           "querylog", "profiling", "timeseries",
           "Span", "attach", "clear_traces", "configure", "current_root",
           "current_span", "enabled", "kernel_annotation", "recent_traces",
           "record_span", "trace", "disttrace", "reset_all"]
