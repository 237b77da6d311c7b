"""The process-wide home of the serving tier's counters, gauges and
latency histograms (the port of `tpu_ir/obs/registry.py`).

Every counter lives under a dotted namespace (`recovery.*`, `serving.*`,
`fault.*`, `batch.*`, `cache.*`, `dispatch.*`, `compile.*`, `decode.*`,
`blockmax.*`, `ingest.*`, `merge.*`, `generation.*`, `load.*`,
`router.*`, `scale.*`, `disttrace.*`, `slo.*`, `timeseries.*`,
`forecast.*`, `querylog.*`), every latency histogram under its span or stage name, and
every gauge (`device.*`, `host.*`, `compile.signatures`, the live
index's and the fleet's levels) carries `tpu_ir`'s merge policy
(GAUGE_MERGE). The declared names are registered at zero, so a report
always shows them, observed or not. `hist_state()` and `delta_summary()`
give one run's percentiles without a reset of the process's state;
`reset()` zeroes everything (the tests' isolation hook);
`reset_counters(prefix)` zeroes one namespace; `snapshot(reset=)` is all
of it in `tpu_ir`'s shape, `collect_state(reset=)` the raw form that
crosses processes (bucket counts, not summaries, and only the gauges a
caller set: obs/aggregate.py spools and merges it, obs/timeseries.py
diffs it) and `prometheus_text(reset=)` `tpu_ir`'s text exposition, each
a read-and-zero under one lock hold with `reset=True`.
"""

from __future__ import annotations

import threading
import uuid

from .histogram import LatencyHistogram, summary_from_counts

# the version of snapshot()'s shape
SNAPSHOT_SCHEMA = 1

# fault-injection sites threaded through the port: the score dispatch,
# and every declared death point of the live index's write path (the
# SIGKILL crash matrix kills a child at each ingest.* site)
FAULT_SITES = (
    "score.hang",             # search/scorer.py: hung device dispatch
    "score.device_loss",      # search/scorer.py: device lost mid-dispatch
    "ingest.wal_append",      # index/wal.py: death before a record is framed
    "ingest.wal_torn",        # index/wal.py: death mid-append (torn tail)
    "ingest.wal_retire",      # index/wal.py: death mid WAL-segment retirement
    "ingest.flush_build",     # index/ingest.py: death mid delta-segment build
    "ingest.commit_between",  # index/segments.py: between the manifest
    #                           write and the CURRENT rename
    "ingest.merge",           # index/segments.py: death mid-merge
)

# serving-stage span names: request -> (ladder, admission_wait, breaker,
# dispatch -> kernel*, fallback)
REQUEST_STAGES = ("admission_wait", "ladder", "breaker", "dispatch",
                  "kernel", "fallback")

# the degradation ladder's levels; each has a request.<level> histogram
SERVICE_LEVELS = ("full", "no_rerank", "hot_only", "shed")

# recovery events (utils/report.recovery_counters()), the JAX names
RECOVERY_COUNTER_NAMES = ("degraded_batches", "deadline_expired",
                          "device_loss", "forced_host_batches")

# serving-frontend events (utils/report.serving_counters()), the JAX names
SERVING_COUNTER_NAMES = (
    "submitted", "degraded", "breaker_opened", "breaker_probes",
    "served_breaker_host", "served_full", "served_no_rerank",
    "served_hot_only", "served_cache", "shed_level", "shed_queue_full",
    "shed_queue_timeout", "level_step_down", "level_step_up",
    "generation_swap")

# the coalescer's batches: shared by >1 query, or flushed alone
BATCH_COUNTER_NAMES = ("batch.coalesced", "batch.solo_flush")

# the exact-hit result cache (serving/result_cache.py)
CACHE_COUNTER_NAMES = ("cache.hit", "cache.miss", "cache.evict",
                       "cache.stale_generation")

# a coalesced dispatch outside the shapes the coalescer warmed: the
# counterpart of the JAX package's compile.recompiles (nothing compiles
# per shape here; the first dispatch of a shape pays the allocator and
# the kernels' first load)
DISPATCH_COUNTER_NAMES = ("dispatch.unwarmed",)

# the device-cost profiler (obs/profiling.py), the JAX names: compile.count
# one cold call (the first call of an abstract signature in a process,
# which pays the lazy library load, the allocator's growth and each op's
# first use: the port's counterpart of a compile); compile.recompiles one
# dispatch.unwarmed event seen by the profiler
COMPILE_COUNTER_NAMES = ("compile.count", "compile.recompiles")

# the compressed codec's shard decodes (index/compress.py), the JAX names:
# posting groups unpacked and skipped (a doc-range read skips the groups
# outside its range), and the payload bytes behind each
DECODE_COUNTER_NAMES = ("decode.blocks_decoded", "decode.blocks_skipped",
                        "decode.bytes", "decode.bytes_skipped")

# block-max pruning's mask ledger (search/scorer.py), the JAX names: doc
# block lanes considered and masked, dispatches whose bounds let the
# pruned hot stage run (saved) and those that fell back to the full stage
BLOCKMAX_COUNTER_NAMES = (
    "blockmax.blocks_considered", "blockmax.blocks_masked",
    "blockmax.saved_dispatches", "blockmax.fallback_dispatches")

# the live index (index/segments.py, wal.py, ingest.py), the JAX names:
# docs_* count API mutations; flushes/segments_built the delta commits;
# merge.runs one compaction step, merge.segments_merged its inputs,
# merge.docs_dropped the tombstones applied; generation.commits every
# manifest + CURRENT flip; wal_appends one per acknowledged mutation,
# wal_fsyncs the batched fsyncs paid, wal_torn_tail_truncated the torn
# tails cut on reopen, wal_segments_retired the log segments a watermark
# covered; replayed the records re-applied on a writer open;
# lease_acquired / lease_takeovers / lease_conflicts the single-writer
# lease's verdicts; wal_bytes (the port's own) the framed bytes appended
INGEST_COUNTER_NAMES = (
    "ingest.docs_added", "ingest.docs_updated", "ingest.docs_deleted",
    "ingest.flushes", "ingest.segments_built",
    "merge.runs", "merge.segments_merged", "merge.docs_dropped",
    "generation.commits",
    "ingest.wal_appends", "ingest.wal_fsyncs",
    "ingest.wal_torn_tail_truncated", "ingest.wal_segments_retired",
    "ingest.replayed",
    "ingest.lease_acquired", "ingest.lease_takeovers",
    "ingest.lease_conflicts", "ingest.wal_bytes",
)

# load-time uploads (utils/transfer.py::stream_to_device): the bytes
# that crossed the host-to-device link
LOAD_COUNTER_NAMES = ("load.h2d_bytes",)

# the scatter-gather router (serving/router.py), the JAX names: requests
# and served_* / shed follow the frontend's taxonomy at the router's
# scope (a routed answer is full, degraded or partial, or it is shed);
# hedge_fired / hedge_won count the hedged attempts and those that
# answered first; replica_failed one failed replica attempt, shard_lost
# a shard missing from an answer; breaker_opened a per-replica breaker's
# opening; worker_respawn a worker ShardSet.respawn brought back;
# mixed_generation a fan-out whose answers named more than one index
# generation (only the winning generation's are merged)
ROUTER_COUNTER_NAMES = (
    "router.requests", "router.served_full", "router.served_degraded",
    "router.served_partial", "router.shed",
    "router.hedge_fired", "router.hedge_won",
    "router.replica_failed", "router.shard_lost",
    "router.breaker_opened", "router.worker_respawn",
    "router.mixed_generation",
)

# the elastic fleet (serving/autoscale.py, shardset.py), the JAX names:
# scale.up / scale.down one replica that entered / left the dispatch grid
# (a grow over S shards counts S); scale.drain_inflight the peak admitted
# requests a draining replica was seen finishing; scale.cooldown_skipped
# a decision the autoscaler wanted and held back inside its cooldown
SCALE_COUNTER_NAMES = ("scale.up", "scale.down", "scale.drain_inflight",
                       "scale.cooldown_skipped")

# the SLO burn-rate windows (obs/disttrace.py): every finished routed
# request is good or bad; slo.burn_breach counts the trips of the
# two-window breach rule
SLO_COUNTER_NAMES = ("slo.good", "slo.bad", "slo.burn_breach")

# distributed request tracing (obs/disttrace.py), the JAX names: minted
# the trace contexts born here (router admission, or a frontend that is
# its own edge); adopted those read off an incoming traceparent (a
# worker: an adopted trace always exports, the minter keeps or drops);
# spans_exported span records shipped off the process (an RPC answer's
# piggyback or the spool); spans_dropped records a full trace could not
# hold; kept_tail roots the tail rule kept (slow, partial, degraded,
# hedged, shed, failed), kept_sampled those the 1-in-N dice kept,
# dropped_sampled those it dropped; stitched whole traces assembled
DISTTRACE_COUNTER_NAMES = (
    "disttrace.minted", "disttrace.adopted", "disttrace.spans_exported",
    "disttrace.spans_dropped", "disttrace.kept_tail",
    "disttrace.kept_sampled", "disttrace.dropped_sampled",
    "disttrace.stitched")

# the query log (obs/querylog.py), the JAX names: entries kept in its
# ring, and the slow ones the trap captured
QUERYLOG_COUNTER_NAMES = ("querylog.recorded", "querylog.slow")

# the telemetry time machine (obs/timeseries.py), the JAX names:
# timeseries.samples one base-rate window taken off the registry,
# timeseries.rollups one exact fine-to-coarse tier merge,
# timeseries.anomaly one MAD z-score detection on a curated series (each
# also writes a rate-limited "anomaly" flight record); forecast.fits one
# sinusoid fit that passed the quality gate and published the
# forecast_occupancy gauge, forecast.scaleups one autoscaler scale-up
# whose deciding signal was that forecast
TIMESERIES_COUNTER_NAMES = (
    "timeseries.samples", "timeseries.rollups", "timeseries.anomaly",
    "forecast.fits", "forecast.scaleups",
)

# the gauges with the JAX package's merge policies ("last": the newest
# process's level wins a cluster merge, "max": the cluster's peak
# survives; obs/aggregate.py's merge and obs/timeseries.py's rollups
# apply them): the
# card's allocated bytes now and at their peak, the host's RSS now and at
# its peak, the distinct (function, signature) pairs profiled; the
# generation a commit or a swap made current, its segment count and its
# tombstones; the ingest soak's median flush-to-first-query lag; the SLO
# windows' burn multiples; the admission occupancy the autoscaler read on
# its last tick (the series the diurnal fit reads), and the forecast
# occupancy it reads beside it: the Forecaster (obs/timeseries.py)
# publishes the level it predicts forecast_lead_s ahead, which
# run_distributed_soak drives when the autoscaler's config arms the third
# signal
GAUGE_MERGE = {
    "device.bytes_in_use": "last",
    "device.peak_bytes": "max",
    "host.rss_bytes": "last",
    "host.peak_rss_bytes": "max",
    "compile.signatures": "last",
    "generation.current": "last",
    "generation.segments": "last",
    "generation.tombstones": "last",
    "ingest.freshness_lag_ms": "last",
    "slo.burn_fast": "last",
    "slo.burn_slow": "last",
    "router.occupancy": "last",
    "forecast_occupancy": "last",
}
DECLARED_GAUGES = tuple(sorted(GAUGE_MERGE))

DECLARED_COUNTERS = (
    tuple(f"fault.{s}" for s in FAULT_SITES)
    + tuple(f"recovery.{n}" for n in RECOVERY_COUNTER_NAMES)
    + tuple(f"serving.{n}" for n in SERVING_COUNTER_NAMES)
    + BATCH_COUNTER_NAMES + CACHE_COUNTER_NAMES + DISPATCH_COUNTER_NAMES
    + COMPILE_COUNTER_NAMES + DECODE_COUNTER_NAMES + BLOCKMAX_COUNTER_NAMES
    + INGEST_COUNTER_NAMES + LOAD_COUNTER_NAMES + ROUTER_COUNTER_NAMES
    + SCALE_COUNTER_NAMES + DISTTRACE_COUNTER_NAMES + SLO_COUNTER_NAMES
    + TIMESERIES_COUNTER_NAMES + QUERYLOG_COUNTER_NAMES)
# "request" (every level pooled) beside the per-level request.<level>;
# batch.precompile is one coalescer's rung-ladder warm-up, at the
# frontend's start and inside each generation swap; load.* are
# Scorer.load's stages (the metadata and side-file checks, the vocabulary
# and docnos, the part reads, the layout, the doc norms, the cache write,
# the strip build on the device) and load.h2d one streamed upload
LOAD_STAGES = ("load.meta", "load.vocab", "load.read", "load.layout",
               "load.norms", "load.cache_write", "load.strip", "load.h2d")
# the router's: a routed request end to end, one replica attempt's
# round trip (hedges too), and the host's exact merge
ROUTER_STAGES = ("router.request", "router.shard_rtt", "router.merge")
# the elastic fleet's: one drain (draining to the process's exit) and
# one grow (spawn, warm-up and publish), in seconds like every histogram
SCALE_STAGES = ("scale.drain_ms", "scale.warmup_ms")
# one whole-trace stitch (the live store, the spool walk, the tree)
DISTTRACE_STAGES = ("disttrace.stitch",)
# one slow-query capture (span tree, explain when admitted, flight record)
QUERYLOG_STAGES = ("querylog.slow_capture",)
# the dispatch's parts (obs/profiling.py, search/scorer.py): tracing
# (declared for the JAX names; nothing traces in the port, so it stays
# empty), a kernel library's build inside a call or a cold call, and one
# query block's wait for the card; compile.time one cold call's wall
DISPATCH_STAGES = ("dispatch.trace", "dispatch.compile", "dispatch.device")
# one compressed shard's decode (index/format.py), outside load.read
DECODE_STAGES = ("decode.block",)
DECLARED_HISTOGRAMS = (("request",) + REQUEST_STAGES
                       + tuple(f"request.{lv}" for lv in SERVICE_LEVELS)
                       + ("batch.occupancy", "batch.wait",
                          "batch.precompile", "cache.lookup",
                          "ingest.flush", "ingest.replay", "merge.run",
                          "generation.swap", "ingest.freshness")
                       + LOAD_STAGES + ROUTER_STAGES + SCALE_STAGES
                       + DISTTRACE_STAGES + QUERYLOG_STAGES
                       + DISPATCH_STAGES + ("compile.time",)
                       + DECODE_STAGES)


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


class TelemetryRegistry:
    """Process-wide counters, gauges and latency histograms; every
    method is thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {n: 0 for n in DECLARED_COUNTERS}
        self._gauges: dict[str, float] = {n: 0.0 for n in DECLARED_GAUGES}
        # the gauges a caller set since the last reset: only these cross
        # processes (collect_state), so an idle process's declared 0.0
        # cannot win a "last" merge over the cluster's real level
        self._gauges_set: set[str] = set()
        self._hists: dict[str, LatencyHistogram] = {
            n: LatencyHistogram() for n in DECLARED_HISTOGRAMS}
        self._seq = 0
        self._stamp = 0
        self.run_id = uuid.uuid4().hex

    @property
    def seq(self) -> int:
        """How many times this registry was reset (never zeroed): two
        reads with the same seq saw no reset between them."""
        with self._lock:
            return self._seq

    # -- counters ----------------------------------------------------------

    def incr(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + amount

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def counter_names(self) -> list[str]:
        with self._lock:
            return sorted(self._counters)

    def counters(self, prefix: str = "") -> dict[str, int]:
        """Counter snapshot; with a prefix, only the counters under it,
        the prefix stripped."""
        with self._lock:
            n = len(prefix)
            return {k[n:]: v for k, v in self._counters.items()
                    if k.startswith(prefix)}

    def reset_counters(self, prefix: str = "") -> None:
        """Zero the counters under `prefix` ('' for all): declared ones
        stay at 0, the others go. A reset like any other: the stamp and
        the reset count move in the same lock hold."""
        with self._lock:
            self._zero_counters(prefix)
            self._seq += 1
            self._stamp += 1

    def _zero_counters(self, prefix: str = "") -> None:
        for k in list(self._counters):
            if k.startswith(prefix):
                if k in DECLARED_COUNTERS:
                    self._counters[k] = 0
                else:
                    del self._counters[k]

    # -- gauges ------------------------------------------------------------

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)
            self._gauges_set.add(name)

    def update_gauge_max(self, name: str, value: float) -> None:
        """Raise a high-water gauge to `value` when it is higher: a level
        sample never walks a peak back down."""
        with self._lock:
            self._gauges_set.add(name)
            if float(value) > self._gauges.get(name, 0.0):
                self._gauges[name] = float(value)

    def get_gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0.0)

    def gauges(self) -> dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    # -- histograms --------------------------------------------------------

    def histogram(self, name: str) -> LatencyHistogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, LatencyHistogram())
        return h

    def observe(self, name: str, seconds: float) -> None:
        self.histogram(name).observe(seconds)

    def hist_state(self) -> dict[str, tuple[list[int], float]]:
        """{name: (bucket counts, total seconds)}: the before-image of a
        delta summary."""
        with self._lock:
            hists = dict(self._hists)
        return {n: h.state() for n, h in hists.items()}

    def delta_summary(self, before: dict, always: tuple = ()) -> dict:
        """Per-histogram summaries of the observations made since `before`
        (a hist_state() snapshot); names in `always` are reported even
        with none."""
        out = {}
        for name, (counts, sum_s) in self.hist_state().items():
            b_counts, b_sum = before.get(name, ([0] * len(counts), 0.0))
            d = [a - b for a, b in zip(counts, b_counts)]
            if sum(d) > 0 or name in always:
                out[name] = summary_from_counts(d, sum_s - b_sum)
        return out

    def _collect(self, reset: bool):
        """One read of everything: counters and gauges under one lock
        hold (zeroed in it with `reset`), histograms by state() or
        drain(). Returns (counters, gauges, the gauges set, histogram
        states, meta)."""
        with self._lock:
            self._stamp += 1
            if reset:
                self._seq += 1
            meta = {"schema": SNAPSHOT_SCHEMA, "seq": self._stamp,
                    "resets": self._seq, "run_id": self.run_id}
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            gauges_set = set(self._gauges_set)
            if reset:
                self._zero_counters()
                self._gauges = {n: 0.0 for n in DECLARED_GAUGES}
                self._gauges_set.clear()
            hists = dict(self._hists)
        states = {n: (h.drain() if reset else h.state())
                  for n, h in hists.items()}
        return counters, gauges, gauges_set, states, meta

    def collect_state(self, reset: bool = False) -> dict:
        """The raw snapshot that crosses processes (`tpu_ir`'s shape): the
        meta stamps, the counters, each histogram's bucket counts and
        seconds (summaries do not merge, bucket counts do), and only the
        gauges a caller set (an idle process's declared 0.0 must not win
        a "last" merge). obs/aggregate.py spools it and obs/timeseries.py
        diffs it."""
        counters, gauges, gauges_set, states, meta = self._collect(reset)
        return {**meta,
                "counters": counters,
                "gauges": {k: v for k, v in gauges.items()
                           if k in gauges_set},
                "histograms": {n: {"counts": list(c), "sum_s": s}
                               for n, (c, s) in states.items()}}

    def snapshot(self, reset: bool = False) -> dict:
        """Everything in one dict, `tpu_ir`'s shape (the flight record's
        telemetry line, `stats`, `metrics`, /metrics.json): the schema, a
        stamp bumped by every snapshot and reset, the reset count, this
        process's run id, the counters, the gauges and each histogram's
        summary. `reset=True` reads and zeroes in one step, so an event
        lands in exactly one scrape."""
        counters, gauges, _set, states, meta = self._collect(reset)
        return {**meta, "counters": counters, "gauges": gauges,
                "histograms": {n: summary_from_counts(c, s)
                               for n, (c, s) in states.items()}}

    def reset(self) -> None:
        """Zero every counter, gauge and histogram. Histograms are zeroed
        in place, never dropped: a span may hold one while it closes."""
        with self._lock:
            self._zero_counters()
            self._gauges = {n: 0.0 for n in DECLARED_GAUGES}
            self._gauges_set.clear()
            self._seq += 1
            self._stamp += 1
            hists = list(self._hists.values())
        for h in hists:
            h.reset()

    def prometheus_text(self, reset: bool = False) -> str:
        """`tpu_ir`'s Prometheus text exposition: the counters as one
        family labeled by name, the gauges as another, the histograms in
        cumulative-bucket form labeled by stage, each family with its
        HELP and TYPE lines. `reset=True` reads and zeroes as snapshot
        does."""
        from .histogram import BOUNDS

        counters, gauges, _set, states, _ = self._collect(reset)
        lines = [
            "# HELP tpu_ir_events_total Monotonic event counters; one "
            "series per declared dotted name (label \"name\"), zeroed "
            "only by an explicit reset.",
            "# TYPE tpu_ir_events_total counter",
        ]
        for name, v in sorted(counters.items()):
            lines.append(f'tpu_ir_events_total{{name="{name}"}} {v}')
        lines.append(
            "# HELP tpu_ir_gauge Point-in-time levels; one series per "
            "declared dotted name (label \"name\"), merge policy per "
            "GAUGE_MERGE.")
        lines.append("# TYPE tpu_ir_gauge gauge")
        for name, v in sorted(gauges.items()):
            lines.append(f'tpu_ir_gauge{{name="{name}"}} {v!r}')
        lines.append(
            "# HELP tpu_ir_stage_latency_seconds Stage wall time on "
            "fixed log2 buckets; one series set per declared histogram "
            "(label \"stage\"), cumulative le buckets.")
        lines.append("# TYPE tpu_ir_stage_latency_seconds histogram")
        for name in sorted(states):
            counts, sum_s = states[name]
            stage = _prom_name(name)
            cum = 0
            for i, c in enumerate(counts):
                cum += c
                le = repr(BOUNDS[i]) if i < len(BOUNDS) else "+Inf"
                lines.append(
                    f'tpu_ir_stage_latency_seconds_bucket'
                    f'{{stage="{stage}",le="{le}"}} {cum}')
            lines.append(
                f'tpu_ir_stage_latency_seconds_sum{{stage="{stage}"}} '
                f'{sum_s!r}')
            lines.append(
                f'tpu_ir_stage_latency_seconds_count{{stage="{stage}"}} '
                f'{cum}')
        return "\n".join(lines) + "\n"


_REGISTRY = TelemetryRegistry()


def get_registry() -> TelemetryRegistry:
    """The process-wide registry."""
    return _REGISTRY
