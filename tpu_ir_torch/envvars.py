"""The environment knobs the port reads, with the JAX package's names,
defaults and rules (`tpu_ir/utils/envvars.py`): an unset or empty variable
means its default, a number below its minimum reads as the minimum, and
a choice outside its set raises.

    TPU_IR_BLOCKMAX          auto | 0 | 1: block-max pruning of the tiered
                             hot stage (0 disables; results are bitwise the
                             same either way)
    TPU_IR_BLOCKMAX_WIDTH    doc-axis block width of the bounds artifact
                             (default 512, at least 64; fixed per artifact
                             when it is written)
    TPU_IR_BLOCKMAX_BLOCKS   doc blocks one block-max dispatch scores
                             exactly (0: sized from k, the width and the
                             doc axis)
    TPU_IR_QUARANTINE_KEEP   corrupt artifacts kept in .quarantine/
                             (default 8)
    TPU_IR_FAULTS            fault-injection plan (faults.py grammar:
                             site[@match]:rule entries, seed=N); unset
                             injects nothing
    TPU_IR_TRACE             0 turns spans and every latency histogram off
                             (default 1; counters stay on)
    TPU_IR_TRACE_SAMPLE      keep every N-th finished root span in the
                             recent-traces ring, and every N-th minted trace
                             the tail rule does not keep (default 1)
    TPU_IR_TRACE_RING        capacity of the recent-traces ring (default 64)
    TPU_IR_DISTTRACE         0 turns distributed request tracing off: no
                             trace context is minted, adopted or sent, no
                             span record is stored, exported or stitched
                             (obs/disttrace.py; default 1)
    TPU_IR_TRACE_TAIL        0 stops force-keeping slow, partial, degraded,
                             hedged, shed and failed traces: they fall to
                             the 1-in-TPU_IR_TRACE_SAMPLE dice as well
                             (default 1)
    TPU_IR_TELEMETRY_DIR     the telemetry spool directory: kept traces
                             spool there as span batches, which `trace`
                             stitches after the processes are gone, and a
                             process serving a MetricsServer refreshes its
                             cumulative snapshot and its time-series store
                             there (obs/aggregate.py's SpoolWriter), which
                             `stats --cluster`, `metrics --cluster`,
                             `/cluster` and `/timeseries?cluster=1` merge
                             (unset: no spool)
    TPU_IR_SPOOL_INTERVAL    seconds between two refreshes of the spool
                             (default 5.0, at least 0.1)
    TPU_IR_TIMESERIES        0 turns the telemetry time machine off: no
                             history store, no background sampler,
                             /timeseries reports it disabled, the anomaly
                             detector and the forecast go dark
                             (obs/timeseries.py; default 1)
    TPU_IR_TS_SAMPLE_S       seconds between two samples of the registry:
                             the tier-0 window, and with the tier factors
                             (x1, x6, x60) the whole retention ladder
                             (default 10.0: 1 h, 4 h, 24 h; at least 0.05)
    TPU_IR_TS_ANOMALY_Z      the robust (MAD) z-score above which a curated
                             series' newest point is an anomaly (the
                             timeseries.anomaly counter and a rate-limited
                             `anomaly` flight record); 0 turns the
                             detector off (default 8.0)
    TPU_IR_BATCH_LADDER      the coalescer's batch-size rungs (default
                             1,4,16: the JAX package's 1,4,16,64 less the
                             64 rung, which pays off only where a padded
                             row rides free, as on a TPU's matrix unit; on
                             the card a padded row costs a full top-k row
                             over D+1 columns, and the top-k is most of
                             the tiered path's device time. Results are
                             bitwise the same at any ladder)
    TPU_IR_BATCH_WAIT_MS     how long a promoted batch leader may wait for
                             its batch to fill (default 0)
    TPU_IR_BATCH_WIDTH       the query-width floor of a coalesced batch
                             (default 8, at least 1)
    TPU_IR_CACHE_RESULTS     entries of the serving frontend's exact-hit
                             result cache (default 0: off)
    TPU_IR_COMPRESS          0 | 1: 1 rewrites a finished build's parts as
                             compressed (v3) arenas before the bounds and
                             the checksums are recorded (default 0)
    TPU_IR_RADIX_BUCKETS     radix buckets of the streaming build's pass-1
                             pair spills (default 16; 0 is the per-batch
                             pass-2 combine; the artifacts are the same
                             bytes either way)
    TPU_IR_TOKENIZE_PROCS    worker processes of the pure-Python tokenizer
                             (default 1: in-process; its spills are the
                             same bytes at any count)
    TPU_IR_PIPE_DEPTH        items the host prepares ahead of the device in
                             the streaming build (default 2; 1: lockstep)
    TPU_IR_FORMAT_VERSION    1 | 2: the part format both builds and the
                             merge write (default 2, raw arenas; 1 is the npz
                             rollback pin; anything else raises)
    TPU_IR_CACHE_REVALIDATE  stat | crc: how a serving-cache hit is
                             revalidated (default stat: unchanged part
                             names, sizes and mtimes; crc streams every
                             part's CRC on each load)
    TPU_IR_RADIX_PARTS       1 writes bucket-segmented parts straight from
                             the pass-2 buckets (skips pass 3's sort; the
                             parts' bytes differ from the canonical layout,
                             every reader accepts both; default 0)
    TPU_IR_INGEST_BUFFER_DOCS  buffered documents (and pending tombstones)
                             that auto-flush the IngestWriter into one
                             delta segment (default 1000, at least 1)
    TPU_IR_INGEST_KEEP_GENERATIONS  generation manifests gc() keeps;
                             segment dirs no kept manifest names are
                             deleted (default 8, at least 1)
    TPU_IR_MERGE_FACTOR      segments in one size tier that make a tiered
                             merge step due (default 4, at least 2)
    TPU_IR_MERGE_TIER_RATIO  doc-count ratio between merge tiers (default
                             8.0, at least 2.0)
    TPU_IR_MERGE_AUTO        0 stops the IngestWriter from running the
                             tiered merge policy after each flush; merges
                             then wait for `compact` (default 1)
    TPU_IR_WAL               0 turns off the ingest write-ahead log and
                             the writer lease: a crash loses every
                             buffered write (default 1)
    TPU_IR_WAL_FSYNC_DOCS    appended WAL records between fsyncs (default
                             32, at least 1)
    TPU_IR_WAL_FSYNC_MS      most milliseconds an appended record waits for
                             its fsync (default 50.0, at least 0)
    TPU_IR_WAL_LEASE_TTL_S   writer-lease heartbeat TTL: an older
                             heartbeat, or a dead holder, is taken over at
                             the next writer open (default 10.0, at least
                             0.5)
    TPU_IR_H2D_CHUNK_BYTES   bytes of one chunk of a host-to-device upload
                             (utils/transfer.py::stream_to_device; default
                             64 MiB, at least 1); on the card each of the
                             two pinned staging buffers has this size
    TPU_IR_HOT_RESIDENCY     auto | 0 | 1: pre-build a shard worker's
                             hot-postings state (the weighted strips and
                             block-max tables, or the dense tf matrix) at
                             load; auto engages when the top-df decile
                             holds at least half the postings
    TPU_IR_ROUTER_DEADLINE_MS  a routed request's per-shard deadline: a
                             shard no replica answers within it ships the
                             answer partial (default 500.0, at least 1.0)
    TPU_IR_ROUTER_HEDGE_MS   the hedge delay's floor: a second replica is
                             asked once the first has taken max(this, the
                             shard's trailing p99); 0 turns hedging off
                             (default 25.0)
    TPU_IR_ROUTER_CONNECT_MS the TCP connect timeout of one worker RPC
                             attempt and of a health poll (default 250.0,
                             at least 1.0)
    TPU_IR_ROUTER_HEALTH_TTL_S  most seconds the router's aggregated
                             /healthz reuses its workers' polled payloads
                             (default 2.0)
    TPU_IR_WORKLOAD          uniform | zipf: the soaks' and serve-bench's
                             traffic (serving/workload.py; default uniform)
    TPU_IR_WORKLOAD_SKEW     the Zipf exponent of --workload zipf (default
                             1.1; 0 draws uniformly)
    TPU_IR_WORKLOAD_BURST    the diurnal amplitude of the arrival pacing
                             (default 0: flat)
    TPU_IR_AUTOSCALE         1 runs the autoscaler over the shard fleet
                             (serving/autoscale.py): sustained admission
                             pressure adds a warm replica a shard,
                             sustained idleness drains one away, its
                             in-flight requests finished first (default 0)
    TPU_IR_SCALE_MIN_REPLICAS  replicas a shard the autoscaler never
                             drains below (default 1, at least 1)
    TPU_IR_SCALE_MAX_REPLICAS  replicas a shard the autoscaler never grows
                             past (default 4, at least 1)
    TPU_IR_SCALE_COOLDOWN_S  least seconds between two membership changes
                             of the autoscaler; decisions inside it count
                             scale.cooldown_skipped (default 5.0)
    TPU_IR_SCALE_LEAD_S      the forecast horizon: the diurnal fit
                             (obs/timeseries.py's Forecaster) publishes the
                             occupancy it predicts this many seconds ahead
                             as the forecast_occupancy gauge, the
                             autoscaler's third scale-up signal, so growth
                             starts before a burst (default 30.0)
    TPU_IR_SLO_P99_MS        the latency SLO: a served request slower than
                             this is a bad one for the burn-rate windows
                             (obs/disttrace.py; default 250.0, at least
                             1.0)
    TPU_IR_FLIGHT_DIR        where flight records are written (obs/
                             recorder.py; unset: tpu_ir_flight under the
                             system temp dir)
    TPU_IR_FLIGHT_INTERVAL   least seconds between two flight records of
                             one reason, unless forced (default 30.0)
    TPU_IR_JOB_HISTORY       jobs kept for /jobs, running or finished
                             (obs/progress.py; default 16, at least 1)
    TPU_IR_QUERYLOG          0 turns the query log and the slow-query trap
                             off (obs/querylog.py; default 1)
    TPU_IR_QUERYLOG_RING     entries the query log's ring holds (default
                             256, at least 1)
    TPU_IR_QUERYLOG_SAMPLE   keep every N-th entry in the ring; a slow one
                             is always kept (default 1)
    TPU_IR_QUERYLOG_REDACT   1 keeps only the hash of a query's analyzed
                             terms, not the terms (default 0)
    TPU_IR_QUERYLOG_SLOW_KEEP  slow-query captures kept (default 16, at
                             least 1)
    TPU_IR_SLOW_QUERY_MS     a query at or above this many ms is captured
                             with its span tree, an explain of its top hit
                             and a flight record; 0 turns the trap off
                             (default 0.0)
    TPU_IR_PROFILE           0 turns the device-cost profiler off: a
                             profiled entry point is one flag test and the
                             raw call (obs/profiling.py; default 1)
    TPU_IR_PROFILE_COST      0 leaves a signature's bytes and operations
                             uncounted (default 1)
    TPU_IR_PROFILE_RECOMPILE_LIMIT  unwarmed dispatches of one shape
                             before a recompile-storm flight record
                             (default 3, at least 1)
"""

from __future__ import annotations

import os

# name: (default, minimum)
_INTS = {"TPU_IR_BLOCKMAX_WIDTH": (512, 64),
         "TPU_IR_BLOCKMAX_BLOCKS": (0, 0),
         "TPU_IR_QUARANTINE_KEEP": (8, 0),
         "TPU_IR_BATCH_WIDTH": (8, 1),
         "TPU_IR_CACHE_RESULTS": (0, 0),
         "TPU_IR_RADIX_BUCKETS": (16, 0),
         "TPU_IR_TOKENIZE_PROCS": (1, 1),
         "TPU_IR_PIPE_DEPTH": (2, 1),
         "TPU_IR_FORMAT_VERSION": (2, 1),
         "TPU_IR_INGEST_BUFFER_DOCS": (1000, 1),
         "TPU_IR_INGEST_KEEP_GENERATIONS": (8, 1),
         "TPU_IR_MERGE_FACTOR": (4, 2),
         "TPU_IR_WAL_FSYNC_DOCS": (32, 1),
         "TPU_IR_H2D_CHUNK_BYTES": (64 << 20, 1),
         "TPU_IR_SCALE_MIN_REPLICAS": (1, 1),
         "TPU_IR_SCALE_MAX_REPLICAS": (4, 1),
         "TPU_IR_TRACE_SAMPLE": (1, 1),
         "TPU_IR_TRACE_RING": (64, 1),
         "TPU_IR_JOB_HISTORY": (16, 1),
         "TPU_IR_QUERYLOG_RING": (256, 1),
         "TPU_IR_QUERYLOG_SAMPLE": (1, 1),
         "TPU_IR_QUERYLOG_SLOW_KEEP": (16, 1),
         "TPU_IR_PROFILE_RECOMPILE_LIMIT": (3, 1)}
# name: the only values an int knob may take
_INT_CHOICES = {"TPU_IR_FORMAT_VERSION": (1, 2)}
_FLOATS = {"TPU_IR_BATCH_WAIT_MS": (0.0, 0.0),
           "TPU_IR_MERGE_TIER_RATIO": (8.0, 2.0),
           "TPU_IR_WAL_FSYNC_MS": (50.0, 0.0),
           "TPU_IR_WAL_LEASE_TTL_S": (10.0, 0.5),
           "TPU_IR_ROUTER_DEADLINE_MS": (500.0, 1.0),
           "TPU_IR_ROUTER_HEDGE_MS": (25.0, 0.0),
           "TPU_IR_ROUTER_CONNECT_MS": (250.0, 1.0),
           "TPU_IR_ROUTER_HEALTH_TTL_S": (2.0, 0.0),
           "TPU_IR_WORKLOAD_SKEW": (1.1, 0.0),
           "TPU_IR_WORKLOAD_BURST": (0.0, 0.0),
           "TPU_IR_SCALE_COOLDOWN_S": (5.0, 0.0),
           "TPU_IR_SCALE_LEAD_S": (30.0, 0.0),
           "TPU_IR_SLO_P99_MS": (250.0, 1.0),
           "TPU_IR_FLIGHT_INTERVAL": (30.0, 0.0),
           "TPU_IR_SPOOL_INTERVAL": (5.0, 0.1),
           "TPU_IR_TS_SAMPLE_S": (10.0, 0.05),
           "TPU_IR_TS_ANOMALY_Z": (8.0, 0.0),
           "TPU_IR_SLOW_QUERY_MS": (0.0, 0.0)}
# name: default (None: unset)
_STRS = {"TPU_IR_FAULTS": None,
         "TPU_IR_BATCH_LADDER": "1,4,16",
         "TPU_IR_TELEMETRY_DIR": None,
         "TPU_IR_FLIGHT_DIR": None}
_BOOLS = {"TPU_IR_TRACE": True, "TPU_IR_RADIX_PARTS": False,
          "TPU_IR_MERGE_AUTO": True, "TPU_IR_WAL": True,
          "TPU_IR_AUTOSCALE": False, "TPU_IR_DISTTRACE": True,
          "TPU_IR_TRACE_TAIL": True, "TPU_IR_QUERYLOG": True,
          "TPU_IR_QUERYLOG_REDACT": False, "TPU_IR_PROFILE": True,
          "TPU_IR_PROFILE_COST": True, "TPU_IR_TIMESERIES": True}
# name: (default, choices)
_CHOICES = {"TPU_IR_BLOCKMAX": ("auto", ("auto", "0", "1")),
            "TPU_IR_COMPRESS": ("0", ("0", "1")),
            "TPU_IR_CACHE_REVALIDATE": ("stat", ("stat", "crc")),
            "TPU_IR_HOT_RESIDENCY": ("auto", ("auto", "0", "1")),
            "TPU_IR_WORKLOAD": ("uniform", ("uniform", "zipf"))}


def _raw(name: str) -> str | None:
    """The variable's value; unset and empty both mean the default."""
    return os.environ.get(name) or None


def get_int(name: str) -> int:
    default, minimum = _INTS[name]
    v = _raw(name)
    if v is None:
        return default
    try:
        out = int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: expected an integer") from None
    if name in _INT_CHOICES and out not in _INT_CHOICES[name]:
        raise ValueError(f"{name}={v!r}: expected one of "
                         f"{_INT_CHOICES[name]}")
    return max(out, minimum)


def get_float(name: str) -> float:
    default, minimum = _FLOATS[name]
    v = _raw(name)
    if v is None:
        return default
    try:
        out = float(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: expected a number") from None
    return max(out, minimum)


def get_str(name: str) -> str | None:
    default = _STRS[name]
    v = _raw(name)
    return default if v is None else v


def get_bool(name: str) -> bool:
    """The JAX package's 0/1 convention: for a flag that defaults on,
    exactly "0" turns it off; for one that defaults off, any value but
    0/false turns it on."""
    default = _BOOLS[name]
    v = _raw(name)
    if v is None:
        return default
    if default:
        return v != "0"
    return v not in ("0", "false", "False")


def get_choice(name: str) -> str:
    default, choices = _CHOICES[name]
    v = (_raw(name) or "").strip().lower()
    if not v:
        return default
    if v not in choices:
        raise ValueError(f"{name}={v!r}: expected one of {choices}")
    return v
