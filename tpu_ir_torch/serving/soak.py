"""The concurrent soak and the concurrency sweep through the ServingFrontend
(the single-process half of `tpu_ir/serving/soak.py`).

`run_soak` drives `threads` worker threads over a seeded mixed query set,
optionally under a fault plan, and reports the serving invariants a
single request cannot show:

- **no deadlock**: every request completes or is shed within the soak's
  wall-clock bound;
- **no cross-request corruption**: every response served at full level
  without degradation is bitwise a serial reference run of the same
  query (same docids, same float scores);
- **no silent degradation**: a response that differs from the reference
  carries a tag that says why (the degraded flag or a lower level);
- **conservation**: shed + served (+ errors, expected 0) == submitted.

`run_concurrency_sweep` measures closed-loop clients at each concurrency
level through the coalescing frontend: latency percentiles, q/s, batch
occupancy and the shapes dispatched outside the warmed set.

Not ported: the routed, distributed and ingest soaks, and the Zipf
workload (`workload=` other than None or "uniform" raises).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait

from .. import faults, obs
from ..utils.report import recovery_counters
from .admission import Overloaded
from .frontend import ServingConfig, ServingFrontend

logger = logging.getLogger(__name__)

# the chaos plan: hangs long enough to trip any sane deadline, and
# sporadic device losses, both at the per-block score dispatch, so
# concurrent requests race into them
DEFAULT_CHAOS_PLAN = ("score.hang:p=0.12:sleep=0.6,"
                      "score.device_loss:p=0.08,seed=1")


def _check_workload(workload) -> None:
    if workload not in (None, "uniform"):
        raise ValueError(f"workload {workload!r} is not ported yet (only "
                         "the uniform workload is)")


def make_queries(scorer, n: int, seed: int = 0,
                 workload=None) -> list[dict]:
    """The JAX package's seeded uniform workload over the index's own
    vocabulary: 1-3 term queries, a TF-IDF/BM25 split, ~25% asking for
    the two-stage rerank (25 candidates), k = 10."""
    _check_workload(workload)
    rng = random.Random(seed)
    terms = list(scorer.vocab.terms)
    if not terms:
        raise ValueError("scorer has an empty vocabulary")
    reqs = []
    for _ in range(n):
        text = " ".join(rng.choice(terms)
                        for _ in range(rng.randint(1, 3)))
        reqs.append({
            "text": text,
            "scoring": rng.choice(["tfidf", "bm25"]),
            "rerank": rng.choice([None, None, None, 25]),
            "k": 10,
        })
    return reqs


def _req_key(r: dict) -> tuple:
    return (r["text"], r["scoring"], r["rerank"], r["k"])


def _serial_reference(scorer, reqs: list[dict]) -> dict:
    """Full-level serial results of each distinct request, computed
    before any fault plan is installed (which also warms the kernels, so
    the concurrent phase measures serving)."""
    ref = {}
    for r in reqs:
        key = _req_key(r)
        if key in ref:
            continue
        res = scorer.search_batch([r["text"]], k=r["k"],
                                  scoring=r["scoring"],
                                  rerank=r["rerank"])[0]
        if res.degraded:
            raise RuntimeError("reference run degraded: clear the fault "
                               "plan before calling run_soak")
        ref[key] = list(res)
    return ref


def run_soak(scorer, *, threads: int = 8, queries: int = 240,
             seed: int = 0, fault_spec: str | None = DEFAULT_CHAOS_PLAN,
             config: ServingConfig | None = None,
             timeout_s: float = 120.0, pacing_s: float = 0.004,
             coalesce: bool = False, workload=None) -> dict:
    """Run the soak; returns the invariant report (no asserts: the
    callers decide what is fatal). `latency` holds per-stage percentiles
    of the concurrent phase alone (a registry delta). The fault plan
    `fault_spec` (None: no chaos) is installed around the concurrent
    phase only, and abandoned deadline threads are drained before this
    returns. `coalesce=True` serves through the coalescer; the report
    then carries its `batching` snapshot."""
    _check_workload(workload)
    if faults.active() is not None:
        raise RuntimeError("a fault plan is already installed")
    reqs = make_queries(scorer, queries, seed=seed)
    reference = _serial_reference(scorer, reqs)
    if config is None:
        cfg = ServingConfig(max_concurrency=4, max_queue=8,
                            deadline_s=0.25, breaker_threshold=4,
                            breaker_cooldown_s=0.2, coalesce=coalesce)
    elif coalesce and not config.coalesce:
        from dataclasses import replace

        cfg = replace(config, coalesce=True)
    else:
        cfg = config
    frontend = ServingFrontend(scorer, cfg)
    recovery_before = recovery_counters().snapshot()
    hist_before = obs.get_registry().hist_state()
    results: list = [None] * len(reqs)

    def worker(i: int, r: dict) -> None:
        if pacing_s:
            # seeded jitter spreads arrivals: submitting the whole load
            # at once is a thundering herd the ladder answers by shedding
            # everything, and the soak must exercise recovery too
            time.sleep(random.Random(seed * 1_000_003 + i).random()
                       * pacing_s * threads)
        try:
            results[i] = ("ok", frontend.search(
                r["text"], k=r["k"], scoring=r["scoring"],
                rerank=r["rerank"]))
        except Overloaded as e:
            results[i] = ("shed", e)
        except BaseException as e:  # invariant: structured or nothing
            results[i] = ("error", e)

    if fault_spec:
        faults.install(faults.parse_plan(fault_spec))
    t0 = time.perf_counter()
    wall_s = 0.0
    deadlocked = 0
    pool = ThreadPoolExecutor(max_workers=threads,
                              thread_name_prefix="soak-worker")
    try:
        futs = [pool.submit(worker, i, r) for i, r in enumerate(reqs)]
        _, not_done = wait(futs, timeout=timeout_s,
                           return_when=FIRST_EXCEPTION)
        wall_s = time.perf_counter() - t0
        deadlocked = len(not_done)
        for f in not_done:
            f.cancel()
    finally:
        # a hung worker must show as `deadlocked`, not hang the teardown
        pool.shutdown(wait=deadlocked == 0, cancel_futures=True)
        faults.clear()
        # abandoned deadline dispatches may still sleep in an injected
        # hang (or wait on the device): drain them before returning
        faults.drain_abandoned(timeout_s=10.0)

    # one snapshot of the outcomes: an entry still None is a deadlock
    outcomes = list(results)
    deadlocked = sum(1 for o in outcomes if o is None)
    served = shed = errors = degraded = 0
    levels: dict[str, int] = {}
    full_bitident = tagged_divergent = untagged_mismatches = 0
    error_reprs: list[str] = []
    for out, r in zip(outcomes, reqs):
        if out is None:
            continue
        state, payload = out
        if state == "shed":
            shed += 1
            continue
        if state == "error":
            errors += 1
            if len(error_reprs) < 5:
                error_reprs.append(repr(payload))
            continue
        served += 1
        res = payload
        levels[res.level] = levels.get(res.level, 0) + 1
        degraded += bool(res.degraded)
        matches = list(res) == reference[_req_key(r)]
        if res.level == "full" and not res.degraded:
            if matches:
                full_bitident += 1
            else:
                # the cross-request corruption this soak exists to catch
                untagged_mismatches += 1
        elif not matches:
            tagged_divergent += 1

    recovery_delta = {
        k: v - recovery_before.get(k, 0)
        for k, v in recovery_counters().snapshot().items()
        if v != recovery_before.get(k, 0)}
    report = {
        "submitted": len(reqs),
        "threads": threads,
        "served": served,
        "shed": shed,
        "errors": errors,
        "error_samples": error_reprs,
        "deadlocked": deadlocked,
        "degraded": degraded,
        "levels": levels,
        "full_bitidentical": full_bitident,
        "tagged_divergent": tagged_divergent,
        "untagged_mismatches": untagged_mismatches,
        "wall_s": round(wall_s, 3),
        "fault_spec": fault_spec,
        "frontend": frontend.stats(),
        "recovery_delta": recovery_delta,
        "latency": obs.get_registry().delta_summary(
            hist_before, always=("admission_wait", "dispatch", "kernel",
                                 "fallback")),
    }
    if frontend.batcher is not None:
        report["batching"] = frontend.batcher.snapshot()
    return report


def _sweep_queries(scorer, n: int, seed: int) -> list[str]:
    """Seeded 1-3 term query texts over the index's own vocabulary: one
    scoring model, no rerank, so every request shares one BatchKey and
    the sweep measures coalescing, not key fragmentation."""
    rng = random.Random(seed)
    terms = list(scorer.vocab.terms)
    if not terms:
        raise ValueError("scorer has an empty vocabulary")
    return [" ".join(rng.choice(terms)
                     for _ in range(rng.randint(1, 3)))
            for _ in range(n)]


def run_concurrency_sweep(scorer, *, levels=(1, 4, 16),
                          queries_per_level: int = 192, seed: int = 0,
                          k: int = 10, scoring: str = "bm25",
                          coalesce: bool = True,
                          deadline_s: float | None = None,
                          wait_ms: float | None = None) -> dict:
    """Closed-loop clients at each concurrency level through a (by
    default) coalescing frontend: p50/p95/p99 latency, q/s, the batch
    occupancy histogram and its exact mean, the per-slot coalescing wait,
    and `unwarmed`, the coalesced dispatches outside the warmed shapes
    (the counterpart of the JAX sweep's recompiles; 0 when the warm-up
    covers the serving shapes).

    `solo_rtt_ms` is the median of 20 single-query `search_batch` calls
    after every probe query was dispatched once: the round trip a lone
    caller pays, the yardstick for level 1."""
    reg = obs.get_registry()
    texts = _sweep_queries(scorer, max(queries_per_level, 64), seed)
    for t in texts[:20]:
        scorer.search_batch([t], k=k, scoring=scoring)
    rtts = []
    for t in texts[:20]:
        t0 = time.perf_counter()
        scorer.search_batch([t], k=k, scoring=scoring)
        rtts.append((time.perf_counter() - t0) * 1e3)
    solo_rtt_ms = sorted(rtts)[len(rtts) // 2]

    out_levels = []
    for level in levels:
        cfg = ServingConfig(
            max_concurrency=int(level),
            max_queue=max(int(level) * 2, 8),
            deadline_s=deadline_s, coalesce=coalesce,
            coalesce_wait_ms=wait_ms)
        frontend = ServingFrontend(scorer, cfg)
        per_client = max(1, queries_per_level // int(level))
        hist_before = reg.hist_state()
        counters_before = {n: reg.get(n) for n in
                           ("batch.coalesced", "batch.solo_flush",
                            "dispatch.unwarmed")}
        lat_ms: list = []
        shed = errors = 0
        lock = threading.Lock()

        def client(ci: int) -> None:
            nonlocal shed, errors
            rng = random.Random(seed * 7919 + ci)
            local: list = []
            for _ in range(per_client):
                text = texts[rng.randrange(len(texts))]
                t0 = time.perf_counter()
                try:
                    frontend.search(text, k=k, scoring=scoring)
                    local.append((time.perf_counter() - t0) * 1e3)
                except Overloaded:
                    with lock:
                        shed += 1
                except Exception:  # noqa: BLE001 — counted and reported
                    logger.exception("sweep request failed")
                    with lock:
                        errors += 1
            with lock:
                lat_ms.extend(local)

        t_start = time.perf_counter()
        pool = ThreadPoolExecutor(max_workers=int(level),
                                  thread_name_prefix="sweep-client")
        try:
            futs = [pool.submit(client, ci) for ci in range(int(level))]
            wait(futs)
            for f in futs:
                f.result()
        finally:
            pool.shutdown(wait=True)
        wall_s = time.perf_counter() - t_start

        lat_sorted = sorted(lat_ms)

        def pct(p: float) -> float:
            if not lat_sorted:
                return -1.0
            i = min(len(lat_sorted) - 1,
                    int(round(p / 100.0 * (len(lat_sorted) - 1))))
            return round(lat_sorted[i], 3)

        delta = reg.delta_summary(hist_before,
                                  always=("batch.occupancy", "batch.wait"))
        row = {
            "concurrency": int(level),
            "served": len(lat_ms),
            "shed": shed,
            "errors": errors,
            "wall_s": round(wall_s, 3),
            "qps": round(len(lat_ms) / wall_s, 1) if wall_s else -1.0,
            "p50_ms": pct(50), "p95_ms": pct(95), "p99_ms": pct(99),
            "occupancy": delta.get("batch.occupancy"),
            "coalesce_wait": delta.get("batch.wait"),
            "coalesced": reg.get("batch.coalesced")
            - counters_before["batch.coalesced"],
            "solo_flush": reg.get("batch.solo_flush")
            - counters_before["batch.solo_flush"],
            "unwarmed": reg.get("dispatch.unwarmed")
            - counters_before["dispatch.unwarmed"],
        }
        batches = row["coalesced"] + row["solo_flush"]
        # the exact mean (served / batches); the histogram's log-2
        # buckets are off by up to one bucket
        row["occupancy_mean"] = (round(len(lat_ms) / batches, 2)
                                 if batches else -1.0)
        out_levels.append(row)
    return {
        "solo_rtt_ms": round(solo_rtt_ms, 3),
        "coalesce": coalesce,
        "scoring": scoring,
        "k": k,
        "queries_per_level": queries_per_level,
        "seed": seed,
        "levels": out_levels,
    }
