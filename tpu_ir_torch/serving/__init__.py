"""The serving tier (the port of `tpu_ir.serving`): over one loaded
Scorer, admission control, the degradation ladder, the circuit breaker,
the coalescing scheduler, the exact-hit result cache, the swap to another
generation of a live index in one process
(`ServingFrontend.reload_generation`), and the soak and sweep that drive
them (see frontend.py); across processes, the doc-range shard workers and
their elastic ShardSet (shardset.py), the autoscaler that grows and
drains it (autoscale.py), the scatter-gather Router with its exact
merges (router.py), the rolling generation swap and the swap micro-bench
(generation.py), the hot-residency hint (residency.py), the Zipf
workload (workload.py), the distributed chaos soak and the ingest and
serve soak."""

from .admission import AdmissionController, Overloaded
from .autoscale import AutoscaleConfig, Autoscaler, autoscale_enabled
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
from .generation import rolling_swap, swap_microbench
from .residency import prewarm_hot_residency, residency_hint
from .result_cache import ResultCache, cache_counters
from .router import (
    Router,
    RouterConfig,
    merge_candidate_scores,
    merge_shard_topk,
)
from .shardset import (
    ShardSet,
    WorkerHandle,
    get_worker_health,
    rpc_post,
    serve_worker,
)
from .soak import (
    DEFAULT_CHAOS_PLAN,
    make_queries,
    run_concurrency_sweep,
    run_distributed_soak,
    run_ingest_soak,
    run_soak,
)
from .workload import Workload, resolve_workload

__all__ = [
    "AdmissionController", "Overloaded",
    "CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN",
    "ServingFrontend", "ServingConfig", "DegradationLadder",
    "CoalescingScheduler", "BatchKey", "batch_ladder",
    "LEVEL_FULL", "LEVEL_NO_RERANK", "LEVEL_HOT_ONLY", "LEVEL_SHED",
    "ResultCache", "cache_counters",
    "run_soak", "make_queries", "run_concurrency_sweep",
    "run_distributed_soak", "run_ingest_soak", "Workload",
    "resolve_workload",
    "Autoscaler", "AutoscaleConfig", "autoscale_enabled",
    "Router", "RouterConfig",
    "DEFAULT_CHAOS_PLAN",
    "ShardSet", "WorkerHandle", "serve_worker", "rpc_post",
    "get_worker_health", "merge_shard_topk", "merge_candidate_scores",
    "rolling_swap", "swap_microbench", "residency_hint",
    "prewarm_hot_residency",
]
