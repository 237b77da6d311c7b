"""The serving tier over one loaded Scorer (the port of `tpu_ir.serving`'s
single-process half): admission control, the degradation ladder, the
circuit breaker, the coalescing scheduler, the exact-hit result cache,
and the soak and sweep that drive them (see frontend.py). Not ported: the
scatter-gather router and its shard workers, the autoscaler, generation
swaps of a live index, hot-residency prewarm and the Zipf workload."""

from .admission import AdmissionController, Overloaded
from .batching import BatchKey, CoalescingScheduler, batch_ladder
from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from .frontend import (
    LEVEL_FULL,
    LEVEL_HOT_ONLY,
    LEVEL_NO_RERANK,
    LEVEL_SHED,
    DegradationLadder,
    ServingConfig,
    ServingFrontend,
)
from .result_cache import ResultCache, cache_counters
from .soak import (
    DEFAULT_CHAOS_PLAN,
    make_queries,
    run_concurrency_sweep,
    run_soak,
)

__all__ = [
    "AdmissionController", "Overloaded",
    "CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN",
    "ServingFrontend", "ServingConfig", "DegradationLadder",
    "CoalescingScheduler", "BatchKey", "batch_ladder",
    "LEVEL_FULL", "LEVEL_NO_RERANK", "LEVEL_HOT_ONLY", "LEVEL_SHED",
    "ResultCache", "cache_counters",
    "run_soak", "make_queries", "run_concurrency_sweep",
    "DEFAULT_CHAOS_PLAN",
]
