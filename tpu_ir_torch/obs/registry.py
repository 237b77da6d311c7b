"""The process-wide home of the serving tier's counters, gauges and
latency histograms (the part of `tpu_ir/obs/registry.py` serving needs).

Every counter lives under a dotted namespace (`recovery.*`, `serving.*`,
`fault.*`, `batch.*`, `cache.*`, `dispatch.*`), every latency histogram
under its span or stage name. The declared names are registered at zero,
so a report always shows them, observed or not. `hist_state()` and
`delta_summary()` give one run's percentiles without a reset of the
process's state; `reset()` zeroes everything (the tests' isolation hook).
"""

from __future__ import annotations

import threading

from .histogram import LatencyHistogram, summary_from_counts

# fault-injection sites threaded through the port's serving path
FAULT_SITES = ("score.hang", "score.device_loss")

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

DECLARED_COUNTERS = (
    tuple(f"fault.{s}" for s in FAULT_SITES)
    + tuple(f"recovery.{n}" for n in RECOVERY_COUNTER_NAMES)
    + tuple(f"serving.{n}" for n in SERVING_COUNTER_NAMES)
    + BATCH_COUNTER_NAMES + CACHE_COUNTER_NAMES + DISPATCH_COUNTER_NAMES)
# "request" (every level pooled) beside the per-level request.<level>
DECLARED_HISTOGRAMS = (("request",) + REQUEST_STAGES
                       + tuple(f"request.{lv}" for lv in SERVICE_LEVELS)
                       + ("batch.occupancy", "batch.wait", "cache.lookup"))


class TelemetryRegistry:
    """Process-wide counters, gauges and latency histograms; every
    method is thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {n: 0 for n in DECLARED_COUNTERS}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, LatencyHistogram] = {
            n: LatencyHistogram() for n in DECLARED_HISTOGRAMS}

    # -- counters ----------------------------------------------------------

    def incr(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + amount

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def counters(self, prefix: str = "") -> dict[str, int]:
        """Counter snapshot; with a prefix, only the counters under it,
        the prefix stripped."""
        with self._lock:
            n = len(prefix)
            return {k[n:]: v for k, v in self._counters.items()
                    if k.startswith(prefix)}

    # -- gauges ------------------------------------------------------------

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

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

    def reset(self) -> None:
        """Zero every counter, gauge and histogram. Histograms are zeroed
        in place, never dropped: a span may hold one while it closes."""
        with self._lock:
            for k in list(self._counters):
                if k in DECLARED_COUNTERS:
                    self._counters[k] = 0
                else:
                    del self._counters[k]
            self._gauges.clear()
            hists = list(self._hists.values())
        for h in hists:
            h.reset()


_REGISTRY = TelemetryRegistry()


def get_registry() -> TelemetryRegistry:
    """The process-wide registry."""
    return _REGISTRY
