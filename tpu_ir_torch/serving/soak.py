"""The soaks and the concurrency sweep (the port of
`tpu_ir/serving/soak.py`, less the ingest soak).

`run_soak` drives `threads` worker threads over a seeded mixed query set
through one ServingFrontend, optionally under a fault plan, and reports
the serving invariants a single request cannot show:

- **no deadlock**: every request completes or is shed within the soak's
  wall-clock bound;
- **no cross-request corruption**: every response served at full level
  without degradation is bitwise a serial reference run of the same
  query (same docids, same float scores);
- **no silent degradation**: a response that differs from the reference
  carries a tag that says why (the degraded flag or a lower level);
- **conservation**: shed + served (+ errors, expected 0) == submitted.

`run_distributed_soak` drives the same kind of traffic through a Router
over S x R shard worker subprocesses while a chaos controller SIGKILLs a
replica, then a whole shard, then respawns them (and, with `upgrade_at`,
rolls the fleet onto a new generation; with `autoscale` or `scale_plan`,
grows and drains it): the invariants then hold across processes and
membership changes, partial answers included.

`run_concurrency_sweep` measures closed-loop clients at each concurrency
level through the coalescing frontend: latency percentiles, q/s, batch
occupancy and the shapes dispatched outside the warmed set.

The traffic is `make_queries`' uniform draw or a serving/workload.py
model (`workload=`: "zipf", a spec dict or a Workload).

`run_ingest_soak` serves a live index while a child feeds it, SIGKILLs
the child mid-feed and lets a successor recover: no acknowledged write
lost, no stale answer. `ingest_feed_main` is that child (and the one the
live index's SIGKILL crash matrix spawns, `_spawn_feeder`): it feeds
`_feed_doc`s, or an ops file's adds, updates and deletes, through an
IngestWriter and dies by SIGKILL at a fault site.

Each soak and the sweep run as progress jobs (obs/progress.py), and an
invariant breach writes a forced flight record (obs/recorder.py), as in
`tpu_ir`. When the distributed soak's autoscaler arms the forecast signal
(`forecast_up > 0`), its controller also drives the telemetry time
machine's Forecaster (obs/timeseries.py), which publishes the
`forecast_occupancy` the autoscaler reads.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait

from .. import faults, obs
from ..obs import flight_dump, querylog
from ..obs.progress import report_progress, tracked
from ..utils.report import recovery_counters
from .admission import Overloaded
from .frontend import ServingConfig, ServingFrontend

logger = logging.getLogger(__name__)

# the share of the requests answered before the soak's autoscaler ticks:
# the first requests pay first-dispatch costs that inflate occupancy for a
# moment, which is not the pressure it should grow on
_SCALE_WARMUP_FRAC = 0.05

# the chaos plan: hangs long enough to trip any sane deadline, and
# sporadic device losses, both at the per-block score dispatch, so
# concurrent requests race into them
DEFAULT_CHAOS_PLAN = ("score.hang:p=0.12:sleep=0.6,"
                      "score.device_loss:p=0.08,seed=1")


def make_queries(scorer, n: int, seed: int = 0,
                 workload=None) -> list[dict]:
    """A seeded mixed request list over the index's own vocabulary. The
    uniform draw (the JAX package's): 1-3 term queries, a TF-IDF/BM25
    split, ~25% asking for the two-stage rerank (25 candidates), k = 10.
    `workload` (serving/workload.py) reshapes it: None defers to
    TPU_IR_WORKLOAD (uniform by default), "zipf", a spec dict or a
    Workload draws rank-skewed requests over the df-ordered vocabulary."""
    from .workload import resolve_workload

    wl = resolve_workload(scorer, workload, seed=seed)
    if wl is not None:
        return wl.make_queries(n, seed=seed)
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


def _p99_ms(vals: list) -> float:
    if not vals:
        return -1.0
    vs = sorted(vals)
    return round(vs[min(len(vs) - 1,
                        int(round(0.99 * (len(vs) - 1))))], 3)


def _cache_counters_now() -> dict:
    from ..obs.registry import CACHE_COUNTER_NAMES

    reg = obs.get_registry()
    return {n: reg.get(n) for n in CACHE_COUNTER_NAMES}


def _cache_delta(before: dict) -> dict:
    """This run's result-cache activity (a registry delta: soaks run one
    after another in a process must not bleed) and its hit fraction."""
    now = _cache_counters_now()
    out = {n.split(".", 1)[1]: now[n] - before.get(n, 0) for n in now}
    looked = out["hit"] + out["miss"]
    out["hit_fraction"] = (round(out["hit"] / looked, 4)
                           if looked else 0.0)
    return out


def _walk_spans(nodes):
    """Depth first over a stitched trace's span trees."""
    for n in nodes:
        yield n
        yield from _walk_spans(n.get("children", ()))


def _trace_shape_ok(st: dict, res) -> tuple[bool, str]:
    """Does one stitched trace explain the answer it belongs to? One root
    (the router's admission span); a verdict on every RPC attempt; at
    least as many hedged attempts as the answer counts (a hedge on a
    shard that then missed the deadline counts in the trace, not in the
    answer); for every shard that contributed, a winning `rpc.search`
    and that worker's own `request` span. Returns (ok, why not)."""
    if len(st["roots"]) != 1:
        return False, "multi_root"
    spans = list(_walk_spans(st["roots"]))
    rpc = [s for s in spans if s["name"].startswith("rpc.")]
    if any(not s.get("attrs", {}).get("outcome") for s in rpc):
        return False, "attempt_without_outcome"
    hedged = sum(1 for s in rpc if s.get("attrs", {}).get("hedge"))
    if hedged < int(res.hedges):
        return False, f"hedge_spans={hedged}<res.hedges={res.hedges}"
    won = {s["attrs"].get("shard") for s in rpc
           if s["name"] == "rpc.search"
           and s["attrs"].get("outcome") == "won"}
    if not set(res.shards_ok) <= won:
        return False, "contributing_shard_without_winning_attempt"
    worker_shards = set()
    for s in spans:
        svc = s.get("service", "")
        if s["name"] == "request" and svc.startswith("worker-s"):
            try:
                worker_shards.add(int(svc[8:].split("r", 1)[0]))
            except ValueError:
                pass
    if not set(res.shards_ok) <= worker_shards:
        return False, "contributing_shard_without_worker_spans"
    return True, ""


def _disttrace_eval(outcomes: list) -> dict:
    """The routed soak's trace join: every served answer with a trace id
    stitches to one trace of the right shape (`_trace_shape_ok`), and no
    partial, degraded or hedged answer's trace is missing. `violations`
    above 0 is a breach."""
    from ..obs import disttrace

    traced = untraced = stitch_missing = tail_missing = 0
    shape_bad = 0
    span_counts: list = []
    samples: list = []
    for out in outcomes:
        if out is None or out[0] != "ok":
            continue
        res = out[1]
        tid = getattr(res, "trace_id", None)
        if tid is None:
            # a cache hit answers ahead of admission: nothing minted
            untraced += 1
            continue
        traced += 1
        st = disttrace.stitch(tid)
        interesting = bool(res.partial or res.degraded or res.hedges)
        if st is None:
            stitch_missing += 1
            tail_missing += interesting
            if len(samples) < 5:
                samples.append({"trace_id": tid, "why": "no_stitch"})
            continue
        span_counts.append(st["span_count"])
        ok, why = _trace_shape_ok(st, res)
        if not ok:
            shape_bad += 1
            if len(samples) < 5:
                samples.append({"trace_id": tid, "why": why})
    return {
        "traced": traced,
        "untraced_served": untraced,
        "stitch_missing": stitch_missing,
        "tail_missing": tail_missing,
        "shape_violations": shape_bad,
        "violations": stitch_missing + shape_bad,
        "mean_spans": round(sum(span_counts) / len(span_counts), 2)
        if span_counts else 0.0,
        "violation_samples": samples,
    }


def _disttrace_overhead(mean_request_ms: float, n: int = 512) -> dict:
    """What a request's trace bookkeeping costs (a mint, its install, one
    attempt record and its verdict, an SLO record, the store's churn),
    timed over `n` rounds with tracing on and off, beside this run's mean
    served request."""
    from ..obs import disttrace

    def per_req_ms() -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            ctx = disttrace.mint()
            with disttrace.use(ctx):
                if ctx is not None:
                    c = disttrace.child(ctx)
                    sid = disttrace.add_span(
                        c.trace_id, "rpc.search", span_id=c.span_id,
                        parent_id=c.parent_id, attrs={"shard": 0})
                    disttrace.annotate(c.trace_id, sid, dur_ms=1.0,
                                       outcome="won")
                disttrace.slo_record("full", 1.0)
                if ctx is not None:
                    disttrace.drop(ctx.trace_id)
        return (time.perf_counter() - t0) * 1e3 / n

    was = disttrace.enabled()
    try:
        disttrace.configure(enabled=True)
        enabled_ms = per_req_ms()
        disttrace.configure(enabled=False)
        disabled_ms = per_req_ms()
    finally:
        disttrace.configure(enabled=was)
    base = max(mean_request_ms, 1e-6)
    return {
        "per_request_ms": round(enabled_ms, 6),
        "per_request_disabled_ms": round(disabled_ms, 6),
        "enabled_overhead_fraction": round(enabled_ms / base, 6),
        "disabled_overhead_fraction": round(disabled_ms / base, 6),
    }


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
        report_progress("reference", advance=1)
    return ref


def run_soak(scorer, *, threads: int = 8, queries: int = 240,
             seed: int = 0, fault_spec: str | None = DEFAULT_CHAOS_PLAN,
             config: ServingConfig | None = None,
             timeout_s: float = 120.0, pacing_s: float = 0.004,
             flight_dir: str | None = None,
             coalesce: bool = False, workload=None) -> dict:
    """Run the soak; returns the invariant report (no asserts: the
    callers decide what is fatal). `latency` holds per-stage percentiles
    of the concurrent phase alone (a registry delta). The fault plan
    `fault_spec` (None: no chaos) is installed around the concurrent
    phase only, and abandoned deadline threads are drained before this
    returns. `coalesce=True` serves through the coalescer; the report
    then carries its `batching` snapshot. `workload` (make_queries')
    shapes the requests, and a burst schedule their arrivals; the report
    carries its description and the run's result-cache activity.

    The run is a `soak` job (reference, then serve: /jobs shows it live).
    With the coalescer the report also carries `batch_mixed_degraded`,
    the shared batches of the query log whose entries disagree on
    `degraded` (0: a slot is never charged a batch-mate's deadline), and
    `batches_observed`. An invariant breach (an error, a deadlock, an
    untagged mismatch) writes a forced `soak_invariant_breach` flight
    record to `flight_dir` (default: obs.flight_dir()), whose path the
    report carries, and fails the job."""
    from .workload import resolve_workload

    if faults.active() is not None:
        raise RuntimeError("a fault plan is already installed")
    wl = resolve_workload(scorer, workload, seed=seed)
    reqs = make_queries(scorer, queries, seed=seed, workload=wl)
    with tracked("soak", f"soak-{queries}q-{threads}t",
                 phases=("reference", "serve"),
                 config={"threads": threads, "queries": queries,
                         "seed": seed, "fault_spec": fault_spec}) as job:
        report_progress("reference",
                        total=len({_req_key(r) for r in reqs}))
        reference = _serial_reference(scorer, reqs)
        report_progress("serve", total=len(reqs))
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
        cache_before = _cache_counters_now()
        results: list = [None] * len(reqs)

        def worker(i: int, r: dict) -> None:
            if pacing_s:
                # seeded jitter spreads arrivals: submitting the whole load
                # at once is a thundering herd the ladder answers by shedding
                # everything, and the soak must exercise recovery too; a
                # burst schedule widens or narrows each request's window
                scale = (wl.pacing_scale(i / max(len(reqs), 1))
                         if wl is not None else 1.0)
                time.sleep(random.Random(seed * 1_000_003 + i).random()
                           * pacing_s * threads * scale)
            try:
                results[i] = ("ok", frontend.search(
                    r["text"], k=r["k"], scoring=r["scoring"],
                    rerank=r["rerank"]))
                job.report("serve", advance=1, served=1)
            except Overloaded as e:
                results[i] = ("shed", e)
                job.report("serve", advance=1, shed=1)
            except BaseException as e:  # invariant: structured or nothing
                results[i] = ("error", e)
                job.report("serve", advance=1, errors=1)

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
        if wl is not None:
            report["workload"] = wl.describe()
        report["cache"] = _cache_delta(cache_before)
        if frontend.batcher is not None:
            report["batching"] = frontend.batcher.snapshot()
            # the shared dispatch's outcome is every slot's: entries that
            # shared a coalesced batch (joined on batch_id) carry one
            # degraded verdict (over the bounded query-log ring)
            by_batch: dict = {}
            for entry in querylog.recent():
                if entry.get("batch_size", 1) > 1 and "batch_id" in entry:
                    by_batch.setdefault(entry["batch_id"], set()).add(
                        bool(entry.get("degraded")))
            report["batch_mixed_degraded"] = sum(
                1 for flags in by_batch.values() if len(flags) > 1)
            report["batches_observed"] = len(by_batch)
        if errors or deadlocked or untagged_mismatches:
            # a breach is what the flight recorder is for: the offending
            # requests' trees are still in the ring; forced, never
            # rate-limited
            report["flight_record"] = flight_dump(
                "soak_invariant_breach",
                extra={k: report[k] for k in
                       ("submitted", "served", "shed", "errors",
                        "deadlocked", "untagged_mismatches",
                        "error_samples")},
                out_dir=flight_dir, force=True)
            job.finish(error=f"invariant breach: errors={errors} "
                             f"deadlocked={deadlocked} "
                             f"untagged={untagged_mismatches}")
    return report


def run_distributed_soak(index_dir: str, *, shards: int = 2,
                         replicas: int = 2, threads: int = 8,
                         queries: int = 160, seed: int = 0,
                         layout: str = "sparse",
                         worker_deadline_s: float = 1.0,
                         router_config=None,
                         kill_replica_at: float = 0.3,
                         kill_shard_at: float = 0.55,
                         respawn_at: float = 0.75,
                         chaos: bool = True,
                         upgrade_at: float | None = None,
                         upgrade_docs: int = 8,
                         timeout_s: float = 240.0,
                         pacing_s: float = 0.002,
                         rundir: str | None = None,
                         recovery_probes: int = 16,
                         recovery_timeout_s: float = 60.0,
                         workload=None,
                         cache_entries: int | None = None,
                         device=None,
                         autoscale=False,
                         scale_plan: dict | None = None,
                         flight_dir: str | None = None) -> dict:
    """The scatter-gather chaos soak: mixed traffic through a Router over
    S doc shards x R replica worker subprocesses on `device` (the card
    unless "cpu"), while a chaos controller SIGKILLs a replica, then a
    whole shard, then brings them back. Checked end to end across the
    processes:

    - conservation: shed + served == submitted, no unstructured error,
      no deadlock;
    - the taxonomy: every answer is one of full, degraded and partial
      (a shed raises Overloaded and counts as shed);
    - full answers are bitwise a serial reference in this process
      (docnos, float scores, tie order);
    - partial answers at full level and not degraded equal the exact
      merge of the answering shards' ranges, taken from an independent
      oracle (the whole positive ranking, filtered), not from the
      workers;
    - with a whole shard dead partial answers appear, and after the
      respawn the recovery probes come back full;
    - distributed traces (when on): every served answer that carries a
      `trace_id` stitches to one trace whose shape explains it (one root,
      a verdict on every attempt, at least as many hedged attempts as the
      answer counts, a winning attempt and the worker's `request` span
      for every shard that contributed), and no partial, degraded or
      hedged answer's trace is missing; the `disttrace` section holds the
      counts and the bookkeeping's cost beside a mean request, the `slo`
      section the SLO windows after the run.

    The schedule is in fractions of completed requests: `kill_replica_at`
    SIGKILLs replica 1 of shard 0 (failover hides it), `kill_shard_at`
    every replica of the last shard (answers go partial), `respawn_at`
    brings them back one after another. The report carries the counts
    and the checks; the caller asserts.

    `upgrade_at` (a live `index_dir`): generation B, A plus
    `upgrade_docs` seeded docs, is compacted before the fleet spawns on
    A; at that fraction `rolling_swap` walks the fleet onto B under the
    traffic. Every answer then names one generation and a full one is
    bitwise that generation's reference; no answer from A completes
    later than one wave of in-flight requests after the walk, and the
    recovery probes must all be on B.

    `autoscale` (True, or an AutoscaleConfig) runs an Autoscaler over the
    fleet from its own loop (True: from `replicas` to `replicas + 1`,
    cooldown 0.5 s, up at 0.6, down at 0.15, 3 and 25 ticks in a row,
    15 s drains), after `_SCALE_WARMUP_FRAC` of the traffic. `scale_plan`
    scripts it: {"up_at": f} grows one replica a shard (in a thread: the
    controller keeps ticking), {"down_at": f} retires each shard's
    highest active replica (never its last), with "kill_during_drain"
    SIGKILLing it while its drain runs. The report's `scale` section
    holds the membership log's length, the epoch, the lifecycle, the
    drains, the replicas provisioned against the demand seen, and with
    an autoscaler its snapshot and the first scale-up's time, reason and
    lead on the workload's first crest (`forecast_lead_s`, > 0: the
    fleet grew before the crest). An AutoscaleConfig with `forecast_up >
    0` arms the forecast: the controller then samples this process's
    timeseries store and refits obs/timeseries.py's Forecaster every
    `forecast_lead_s / 8` seconds after `_SCALE_WARMUP_FRAC` of the
    traffic, publishing `forecast_occupancy`.

    The run is a `soak` job (reference, serve, recovery). A breach of an
    invariant writes a forced `routed_soak_invariant_breach` flight record
    to `flight_dir` (default: obs.flight_dir()), whose path the report
    carries, and fails the job."""
    from ..index import segments as seg
    from ..obs import disttrace, get_registry
    from ..search.layout import shard_doc_ranges
    from ..search.scorer import Scorer
    from .router import Router, RouterConfig
    from .shardset import ShardSet
    from .workload import resolve_workload

    if faults.active() is not None:
        raise RuntimeError("a fault plan is already installed")
    if upgrade_at is not None and not seg.is_live(index_dir):
        raise ValueError("upgrade_at needs a LIVE index dir "
                         "(index/segments.py; `tpu-ir ingest --init`)")
    device = "cuda" if device is None else str(device)
    ref_scorer = Scorer.load_generation(index_dir, layout=layout,
                                        device=device)
    gen_a = ref_scorer.generation
    wl = resolve_workload(ref_scorer, workload, seed=seed)
    reqs = make_queries(ref_scorer, queries, seed=seed, workload=wl)

    # -- generation B: made before the fleet spawns, swapped in mid-soak
    gen_b = None
    ref_scorers = {gen_a: ref_scorer}
    if upgrade_at is not None:
        from ..index.ingest import IngestWriter

        rng_u = random.Random(seed * 31 + 7)
        terms = list(ref_scorer.vocab.terms)
        with IngestWriter(index_dir, auto_merge=False,
                          device=device) as w:
            for i in range(upgrade_docs):
                w.update(f"UPG-{i:04d}",
                         " ".join(rng_u.choice(terms)
                                  for _ in range(5)))
            w.compact_all(note="upgrade-mid-soak")
        gen_b = seg.LiveIndex.open(index_dir).current_gen()
        ref_scorers[gen_b] = Scorer.load_generation(
            index_dir, gen_b, layout=layout, device=device)

    ranges_by_gen = {g: shard_doc_ranges(sc.meta.num_docs, shards)
                     for g, sc in ref_scorers.items()}

    with tracked("soak", f"routed-soak-{queries}q-{shards}s{replicas}r",
                 phases=("reference", "serve", "recovery"),
                 config={"threads": threads, "queries": queries,
                         "seed": seed, "shards": shards,
                         "replicas": replicas, "chaos": chaos,
                         "upgrade_at": upgrade_at}) as job:
        # -- the oracles, in this process before any worker exists: per
        # generation a serial reference and the partial answers' oracle (an
        # answer is judged against the generation it names)
        distinct = list({_req_key(r): r for r in reqs}.values())
        report_progress("reference",
                        total=len(distinct) * len(ref_scorers))
        reference: dict = {g: {} for g in ref_scorers}
        full_rank: dict = {g: {} for g in ref_scorers}
        for g, sc in ref_scorers.items():
            oracle_k = min(sc.meta.num_docs, 1000)
            for r in distinct:
                key = _req_key(r)
                res = sc.search_batch(
                    [r["text"]], k=r["k"], scoring=r["scoring"],
                    rerank=r["rerank"])[0]
                if res.degraded:
                    raise RuntimeError("reference run degraded: clear the "
                                       "fault plan before the soak")
                reference[g][key] = list(res)
                if not r["rerank"]:
                    # the whole positive ranking by docno: a doc's score does
                    # not depend on the partition, so this list filtered to
                    # the answering shards' ranges is their exact merge
                    full_rank[g][key] = list(sc.search_batch(
                        [r["text"]], k=oracle_k, scoring=r["scoring"],
                        return_docids=False)[0])
                report_progress("reference", advance=1)

        reg = get_registry()
        # keep every trace of this run and hold them all: the join below
        # stitches each served answer's, which the 1-in-N dice and the store's
        # default 256 traces would make racy (obs.reset_all restores both)
        if disttrace.enabled():
            disttrace.configure(sample=1, max_traces=len(reqs) + 64)
        hist_before = reg.hist_state()
        cache_before = _cache_counters_now()
        report_progress("serve", total=len(reqs))
        results: list = [None] * len(reqs)
        latencies: list = [None] * len(reqs)  # served requests only, ms
        completion_order: list = [0] * len(reqs)
        completed = threading.Event()
        progress = [0]
        progress_lock = threading.Lock()

        with ShardSet(index_dir, shards=shards, replicas=replicas,
                      layout=layout, deadline_s=worker_deadline_s,
                      rundir=rundir,
                      index_generation=(gen_a if upgrade_at is not None
                                        else None),
                      device=device) as shardset:
            # a generous per-shard deadline: a dead worker fails at
            # connection-refused speed whatever it is, so it only spares
            # slow but live workers on a contended host
            cfg_r = router_config or RouterConfig(deadline_ms=3000.0)
            if cache_entries is not None \
                    and cfg_r.cache_entries != cache_entries:
                # an explicit soak-level cache size wins over the router's
                from dataclasses import replace as _replace

                cfg_r = _replace(cfg_r, cache_entries=cache_entries)
            router = Router(index_dir, shardset, cfg_r)
            counters_before = router.stats()
            scaler = None
            if autoscale:
                from .autoscale import AutoscaleConfig, Autoscaler

                a_cfg = (autoscale if isinstance(autoscale, AutoscaleConfig)
                         else AutoscaleConfig(
                             min_replicas=replicas, max_replicas=replicas + 1,
                             cooldown_s=0.5, up_occupancy=0.6,
                             down_occupancy=0.15, sustain_up=3,
                             sustain_down=25, drain_timeout_s=15.0))
                scaler = Autoscaler(shardset, router, a_cfg)
            # with the forecast signal armed, the controller also samples
            # the occupancy the scaler publishes and refits the diurnal
            # sinusoid over it, so forecast_occupancy leads the burst
            forecaster = None
            if scaler is not None and scaler.config.forecast_up > 0:
                from ..obs import timeseries

                if timeseries.enabled():
                    # refit at lead / 8 (live serving refits at lead / 4):
                    # the scripted wave is seconds long, and the fit must
                    # lock inside its first rising edge
                    forecaster = timeseries.Forecaster(
                        timeseries.get_store(),
                        lead_s=scaler.config.forecast_lead_s, sample=True)
                    forecaster.interval_s = max(
                        0.05, forecaster.lead_s / 8.0)
            try:
                # -- the chaos, upgrade and scale controller ---------------
                killed: list = []
                swap_state = {"done_at": None, "result": None}
                swap_complete = threading.Event()
                scale_state: dict = {"drains": [], "samples": [], "peaks": {}}
                side_threads: list = []
                # the pacing wave's crests (arrivals densest), as fractions of
                # the requests: where the trough-phased wave peaks
                crest_fracs: list = []
                if wl is not None and getattr(wl, "burst", 0.0) > 0:
                    from .workload import BURST_CYCLES

                    crest_fracs = [(k + 0.5) / BURST_CYCLES
                                   for k in range(int(BURST_CYCLES))]

                def retire(s_: int, r_: int) -> None:
                    try:
                        scale_state["drains"].append(shardset.retire_replica(
                            s_, r_, drain_timeout_s=15.0))
                    except Exception:  # noqa: BLE001 — a kill racing the
                        logger.exception("scale-down retire")  # retire

                def grow() -> None:
                    try:
                        for s_, r_ in shardset.grow():
                            # a reused slot starts with a clean breaker
                            router.reset_breaker(s_, r_)
                    except Exception:  # noqa: BLE001
                        logger.exception("scale-up grow")

                def scripted_scale(frac: float, fired: dict) -> None:
                    up_at = scale_plan.get("up_at")
                    down_at = scale_plan.get("down_at")
                    if up_at is not None and not fired["scale_up"] \
                            and frac >= up_at:
                        fired["scale_up"] = True
                        # a grow blocks on whole worker starts: in a thread,
                        # so down_at still fires while the traffic runs
                        th = threading.Thread(target=grow, name="soak-grow",
                                              daemon=True)
                        th.start()
                        side_threads.append(th)
                    if down_at is not None and not fired["scale_down"] \
                            and frac >= down_at:
                        fired["scale_down"] = True
                        for s_, states in enumerate(shardset.lifecycle()):
                            active_rs = [r for r, st in enumerate(states)
                                         if st == "active"]
                            if len(active_rs) < 2:
                                continue  # never drain a shard dark
                            r_ = active_rs[-1]
                            if not scale_plan.get("kill_during_drain"):
                                retire(s_, r_)
                                continue
                            # the worst race, scripted: SIGKILL the replica
                            # while its drain handshake runs
                            th = threading.Thread(target=retire, args=(s_, r_),
                                                  name="soak-drain",
                                                  daemon=True)
                            th.start()
                            side_threads.append(th)
                            for _ in range(200):
                                if shardset.lifecycle()[s_][r_] == "draining":
                                    break
                                time.sleep(0.005)
                            shardset.kill(s_, r_)

                def chaos_controller():
                    fired = {"replica": False, "shard": False,
                             "respawn": False, "upgrade": False,
                             "scale_up": False, "scale_down": False}
                    while not completed.is_set():
                        with progress_lock:
                            frac = progress[0] / max(len(reqs), 1)
                        try:
                            if chaos and not fired["replica"] \
                                    and frac >= kill_replica_at \
                                    and replicas > 1:
                                fired["replica"] = True
                                shardset.kill(0, 1)
                                killed.append((0, 1))
                            if chaos and not fired["shard"] \
                                    and frac >= kill_shard_at:
                                fired["shard"] = True
                                for rr in range(replicas):
                                    if (shards - 1, rr) not in killed:
                                        shardset.kill(shards - 1, rr)
                                        killed.append((shards - 1, rr))
                            if chaos and not fired["respawn"] \
                                    and frac >= respawn_at:
                                fired["respawn"] = True
                                for s_, r_ in list(killed):
                                    shardset.respawn(s_, r_)
                                killed.clear()
                            if upgrade_at is not None \
                                    and not fired["upgrade"] \
                                    and frac >= upgrade_at:
                                fired["upgrade"] = True
                                # roll the fleet onto B replica by replica
                                # while the traffic flows
                                from .generation import rolling_swap

                                try:
                                    out = rolling_swap(shardset,
                                                       generation=gen_b)
                                    # the cache's key space moves now, so a
                                    # head query cached on A cannot stretch
                                    # the mixed window
                                    router.note_generation(gen_b)
                                    with progress_lock:
                                        swap_state["done_at"] = progress[0]
                                    swap_state["result"] = out
                                finally:
                                    # even a failed walk releases the traffic
                                    # held back for after it
                                    swap_complete.set()
                            if scale_plan:
                                scripted_scale(frac, fired)
                            if forecaster is not None \
                                    and frac >= _SCALE_WARMUP_FRAC:
                                # fit over the windows after the opening
                                # transient only
                                forecaster.poll()
                            # the wall time each pacing crest was reached:
                            # what a scale-up's lead is measured against
                            peaks = scale_state["peaks"]
                            for pf in crest_fracs:
                                if frac >= pf and pf not in peaks:
                                    peaks[pf] = time.perf_counter()
                        except Exception:  # noqa: BLE001 — chaos must not
                            logger.exception("chaos controller")  # kill it
                        # the provisioned-against-demand series behind
                        # mean_replicas and overprovision_fraction
                        scale_state["samples"].append(
                            (shardset.active_replicas(),
                             router.admission.in_flight()))
                        completed.wait(0.02)
                    # whatever is still dead comes back for the recovery
                    for s_, r_ in list(killed):
                        try:
                            shardset.respawn(s_, r_)
                        except Exception:  # noqa: BLE001
                            logger.exception("post-soak respawn")

                def scaler_loop():
                    # its own loop: a scale-up blocks in grow() for whole
                    # worker starts, which must not stall the controller; the
                    # first up is stamped at the decision, not after the grow
                    while not completed.is_set():
                        with progress_lock:
                            frac = progress[0] / max(len(reqs), 1)
                        if frac < _SCALE_WARMUP_FRAC:
                            completed.wait(0.02)
                            continue
                        t_dec = time.perf_counter()
                        try:
                            dec = scaler.tick()
                            if dec["action"] == "up" \
                                    and "first_up" not in scale_state:
                                scale_state["first_up"] = (
                                    t_dec, dec["reason"], frac)
                        except Exception:  # noqa: BLE001 — a failed spawn
                            logger.exception("scaler tick")  # ends no loop
                        completed.wait(0.02)

                ctrl = threading.Thread(target=chaos_controller,
                                        name="soak-chaos", daemon=True)
                ctrl.start()
                if scaler is not None:
                    sctl = threading.Thread(target=scaler_loop,
                                            name="soak-scaler", daemon=True)
                    sctl.start()
                    side_threads.append(sctl)

                def worker(i: int, r: dict) -> None:
                    if pacing_s:
                        scale = (wl.pacing_scale(i / max(len(reqs), 1))
                                 if wl is not None else 1.0)
                        time.sleep(random.Random(
                            seed * 1_000_003 + i).random()
                            * pacing_s * threads * scale)
                    try:
                        t_req = time.perf_counter()
                        results[i] = ("ok", router.search(
                            r["text"], k=r["k"], scoring=r["scoring"],
                            rerank=r["rerank"]))
                        latencies[i] = (time.perf_counter() - t_req) * 1e3
                    except Overloaded as e:
                        results[i] = ("shed", e)
                    except BaseException as e:  # structured or nothing
                        results[i] = ("error", e)
                    with progress_lock:
                        progress[0] += 1
                        completion_order[i] = progress[0]
                    job.report("serve", advance=1)

                t0 = time.perf_counter()
                pool = ThreadPoolExecutor(max_workers=threads,
                                          thread_name_prefix="routed-soak")
                try:
                    # with an upgrade, the last tranche waits for the walk to
                    # confirm, so traffic lands on both sides of it however
                    # the wall clock races the reloads (the workers serve A
                    # throughout: nothing here waits on a dark fleet)
                    hold = 0
                    if upgrade_at is not None:
                        # leave enough traffic before the walk for `frac` to
                        # reach upgrade_at, and never more than the list
                        hold = min(max(len(reqs) // 4, threads),
                                   len(reqs) // 2,
                                   int(len(reqs) * (1.0 - upgrade_at)))
                        hold = max(hold, 0)
                    n_pre = len(reqs) - hold
                    futs = [pool.submit(worker, i, r)
                            for i, r in enumerate(reqs[:n_pre])]
                    if hold:
                        swap_complete.wait(min(timeout_s * 0.5, 120.0))
                        futs += [pool.submit(worker, n_pre + j, r)
                                 for j, r in enumerate(reqs[n_pre:])]
                    _, not_done = wait(futs, timeout=timeout_s)
                    for f in not_done:
                        f.cancel()
                finally:
                    completed.set()
                    pool.shutdown(wait=len(results) == len(
                        [o for o in results if o is not None]),
                        cancel_futures=True)
                    ctrl.join(timeout=120.0)
                    for th in side_threads:
                        # a drain must settle (clean or killed) before the
                        # invariants are judged
                        th.join(timeout=60.0)
                wall_s = time.perf_counter() - t0

                # -- the recovery probes (the fleet whole again): breakers
                # opened during the chaos need a success each to close and a
                # respawned worker may still be warming, so each probe retries
                # for a while before it counts as not recovered
                report_progress("recovery", total=recovery_probes)
                recovery_full = 0
                probe_reqs = reqs[:recovery_probes]
                # after an upgrade every probe must be on B and match B
                want_gen = gen_b if gen_b is not None else gen_a
                recovery_deadline = (time.monotonic()
                                     + max(recovery_timeout_s, 1.0))
                for r in probe_reqs:
                    while True:
                        try:
                            pres = router.search(r["text"], k=r["k"],
                                                 scoring=r["scoring"],
                                                 rerank=r["rerank"])
                            if Router.classify(pres) == "full" and \
                                    pres.generation == want_gen and \
                                    list(pres) == reference[want_gen][
                                        _req_key(r)]:
                                recovery_full += 1
                                break
                        except Overloaded:
                            pass
                        if time.monotonic() >= recovery_deadline:
                            break
                        time.sleep(0.2)
                    report_progress("recovery", advance=1)
            finally:
                router.close()

        # -- the invariants --------------------------------------------------
        outcomes = list(results)
        deadlocked = sum(1 for o in outcomes if o is None)
        served = shed = errors = 0
        classes = {"full": 0, "degraded": 0, "partial": 0}
        full_mismatches = partial_mismatches = 0
        partial_checked = tagged_divergent = 0
        hedged_requests = unknown_generation = late_old_generation = 0
        generations_served: dict = {}
        error_reprs: list = []
        swap_done_at = swap_state["done_at"] if upgrade_at is not None \
            else None
        for idx, (out, r) in enumerate(zip(outcomes, reqs)):
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
            cls = Router.classify(res)
            classes[cls] += 1
            hedged_requests += bool(res.hedges)
            gen = int(getattr(res, "generation", 0))
            generations_served[gen] = generations_served.get(gen, 0) + 1
            if gen not in reference:
                # an answer naming a generation no oracle knows is a fault
                unknown_generation += 1
                continue
            if swap_done_at is not None and gen != gen_b \
                    and completion_order[idx] > swap_done_at + threads:
                # the bounded mixed window: once the walk confirmed every
                # replica, only the <= `threads` requests in flight may still
                # answer from A
                late_old_generation += 1
            key = _req_key(r)
            if cls == "full":
                if list(res) != reference[gen][key]:
                    full_mismatches += 1
            elif cls == "partial" and not res.degraded \
                    and res.level == "full" and not r["rerank"]:
                # the oracle ranking of the generation that answered, filtered
                # to the shards that contributed
                g_ranges = ranges_by_gen[gen]
                ok_ranges = [g_ranges[s] for s in res.shards_ok]
                expect = [(d, s) for d, s in full_rank[gen][key]
                          if any(lo <= d <= hi
                                 for lo, hi in ok_ranges)][: r["k"]]
                mapping = ref_scorers[gen].mapping
                expect = [(mapping.get_docid(int(d)), float(s))
                          for d, s in expect]
                partial_checked += 1
                if list(res) != expect:
                    partial_mismatches += 1
            elif list(res) != reference[gen][key]:
                tagged_divergent += 1

        router_delta = {n: v - counters_before.get(n, 0)
                        for n, v in router.stats().items()}
        report = {
            "submitted": len(reqs),
            "served": served,
            "shed": shed,
            "errors": errors,
            "error_samples": error_reprs,
            "deadlocked": deadlocked,
            "classes": classes,
            "partial_fraction": round(
                classes["partial"] / max(served, 1), 4),
            "full_mismatches": full_mismatches,
            "partial_checked": partial_checked,
            "partial_mismatches": partial_mismatches,
            "tagged_divergent": tagged_divergent,
            "hedged_requests": hedged_requests,
            "recovery_probes": len(probe_reqs),
            "recovery_full": recovery_full,
            "wall_s": round(wall_s, 3),
            "shards": shards,
            "replicas": replicas,
            "chaos": chaos,
            "generations_served": {str(g): n for g, n in
                                   sorted(generations_served.items())},
            "unknown_generation": unknown_generation,
            "router": router_delta,
            # this run's routed stages (a registry delta): whole requests,
            # each replica round trip, the host's exact merge
            "latency": reg.delta_summary(
                hist_before, always=("router.request", "router.shard_rtt",
                                     "router.merge")),
            "cache": _cache_delta(cache_before),
        }
        # the trace join, the SLO windows as the run left them (read before
        # the overhead rounds, whose SLO records would pollute them), and the
        # bookkeeping's cost beside a mean served request
        if disttrace.enabled():
            report["disttrace"] = _disttrace_eval(outcomes)
            report["slo"] = disttrace.slo_snapshot()
            served_ms = [v for v in latencies if v is not None]
            report["disttrace"]["overhead"] = _disttrace_overhead(
                sum(served_ms) / len(served_ms) if served_ms else 0.0)
        if wl is not None:
            report["workload"] = wl.describe()
        # served latency in the workload's peak window (the whole run without
        # a burst schedule)
        served_lat = [v for v in latencies if v is not None]
        peak_lat = [latencies[i] for i in range(len(reqs))
                    if latencies[i] is not None and wl is not None
                    and wl.is_peak(i / len(reqs))]
        report["burst_p99_ms"] = _p99_ms(peak_lat or served_lat)
        if autoscale or scale_plan:
            report["scale"] = _scale_section(shardset, scaler, scale_state, t0)
        if upgrade_at is not None:
            report["upgrade"] = {
                "generation_a": gen_a,
                "generation_b": gen_b,
                "swap": swap_state["result"],
                "swap_done_at_request": swap_done_at,
                "late_old_generation": late_old_generation,
                "mixed_generation_requests": router_delta.get(
                    "router.mixed_generation", 0),
            }
        if (errors or deadlocked or full_mismatches or partial_mismatches
                or unknown_generation or late_old_generation
                or served + shed != len(reqs)
                or report.get("disttrace", {}).get("violations", 0)):
            report["flight_record"] = flight_dump(
                "routed_soak_invariant_breach",
                extra={k: report[k] for k in
                       ("submitted", "served", "shed", "errors",
                        "deadlocked", "full_mismatches",
                        "partial_mismatches", "error_samples")},
                out_dir=flight_dir, force=True)
            job.finish(error=f"invariant breach: errors={errors} "
                             f"deadlocked={deadlocked} "
                             f"full_mismatches={full_mismatches} "
                             f"partial_mismatches={partial_mismatches}")
    return report


def _scale_section(shardset, scaler, state: dict, t0: float) -> dict:
    """The distributed soak's `scale` report: the membership log's length,
    the epoch and lifecycle, the drains, the controller's samples through
    autoscale.utilization (a worker serves max_concurrency requests),
    and with an autoscaler its snapshot and the first scale-up's time,
    reason and request fraction, with its lead on the first pacing crest
    (> 0: the fleet grew before the crest)."""
    from .autoscale import utilization

    samples = state["samples"]
    mean_repl, over = utilization(samples, shardset.max_concurrency)
    drains = state["drains"]
    out = {
        "events": len(shardset.events()),
        "epoch": shardset.epoch(),
        "lifecycle": shardset.lifecycle(),
        "drains": drains,
        "drained_clean": sum(1 for d in drains if d.get("drained_clean")),
        "killed_mid_drain": sum(
            1 for d in drains if d.get("killed_mid_drain")),
        "mean_replicas": round(mean_repl, 3),
        "overprovision_fraction": round(over, 4),
        "ticks": len(samples),
    }
    if scaler is not None:
        out["autoscaler"] = scaler.snapshot()
    if state.get("first_up"):
        t_up, reason, frac = state["first_up"]
        out["first_up_s"] = round(t_up - t0, 3)
        out["first_up_reason"] = reason
        out["first_up_frac"] = round(frac, 4)
        if state["peaks"]:
            first_peak = min(state["peaks"].values())
            out["first_peak_s"] = round(first_peak - t0, 3)
            out["forecast_lead_s"] = round(first_peak - t_up, 3)
    return out


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
    covers the serving shapes), with the profiler's `recompiles` (the
    same events) and `compiles` (cold calls: 0 once the warm-up ran).

    `solo_rtt_ms` is the median of 20 single-query `search_batch` calls
    after every probe query was dispatched once: the round trip a lone
    caller pays, the yardstick for level 1. The levels run as one `sweep`
    job."""
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
    with tracked("sweep", f"sweep-{'x'.join(str(n) for n in levels)}",
                 phases=("sweep",),
                 config={"levels": list(levels), "scoring": scoring,
                         "k": k, "coalesce": coalesce,
                         "queries_per_level": queries_per_level}) as job:
        report_progress("sweep", total=len(levels) * queries_per_level)
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
                                "dispatch.unwarmed", "compile.count",
                                "compile.recompiles")}
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
                    job.report("sweep", advance=1)
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
                "recompiles": reg.get("compile.recompiles")
                - counters_before["compile.recompiles"],
                "compiles": reg.get("compile.count")
                - counters_before["compile.count"],
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


# ---------------------------------------------------------------------------
# the ingest child of the crash matrix
# ---------------------------------------------------------------------------

# the feed's deterministic vocabulary
_FEED_WORDS = ("harbor lantern orchid tundra velvet quartz meadow "
               "cinder falcon ripple anchor summit juniper marble "
               "ember willow".split())


def _feed_doc(i: int) -> tuple[str, str]:
    """Document i of the ingest feed: a child and the recovering parent
    must make the same text for the byte-identity check to mean
    anything."""
    text = " ".join(_FEED_WORDS[(i * 7 + j) % len(_FEED_WORDS)]
                    for j in range(5 + i % 7))
    return f"FEED-{i:06d}", text


def ingest_feed_main(argv=None) -> int:
    """The ingest child of the SIGKILL crash matrix: open an IngestWriter
    on `--live-dir` on `--device` and feed it ops: those of the `--ops`
    JSON file ([op, docid(, text)] lists, op add, update or delete) when
    it is given, else upserts of `_feed_doc(i)` for i in [--start,
    --end). Each op's docid is appended to `--ack` after the writer
    acknowledged it; the writer flushes and compacts every
    `--compact-every` ops and at the end. An InjectedCrash from the
    TPU_IR_FAULTS plan becomes a raw SIGKILL of this process: no atexit,
    no unwind, no lease release. Run as `python -c "from
    tpu_ir_torch.serving.soak import ingest_feed_main; raise
    SystemExit(ingest_feed_main())" ...`."""
    import argparse
    import json
    import signal
    import sys

    from ..index.ingest import IngestWriter

    p = argparse.ArgumentParser()
    p.add_argument("--live-dir", required=True)
    p.add_argument("--ack", required=True)
    p.add_argument("--ops", default=None)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=0)
    p.add_argument("--buffer-docs", type=int, default=8)
    p.add_argument("--compact-every", type=int, default=0)
    p.add_argument("--pause-s", type=float, default=0.0)
    p.add_argument("--device", required=True, choices=["cuda", "cpu"])
    a = p.parse_args(argv if argv is not None else sys.argv[1:])
    if a.ops is not None:
        with open(a.ops, encoding="utf-8") as f:
            ops = json.load(f)
    else:
        ops = [["update", *_feed_doc(i)] for i in range(a.start, a.end)]

    ack = open(a.ack, "a", buffering=1)
    try:
        w = IngestWriter(a.live_dir, buffer_docs=a.buffer_docs,
                         auto_merge=False, device=a.device)
        for n, op in enumerate(ops, 1):
            if op[0] == "delete":
                w.delete(op[1])
            elif op[0] == "add":
                w.add(op[1], op[2])
            else:
                w.update(op[1], op[2])
            # acknowledged after the writer returned: everything in this
            # file must survive any crash (the WAL holds it)
            ack.write(op[1] + "\n")
            if a.compact_every and n % a.compact_every == 0:
                w.flush()
                w.compact_all()
            if a.pause_s:
                time.sleep(a.pause_s)
        w.flush()
        w.compact_all()
        summary = {"acked": len(ops), "replayed": w.replayed,
                   "lease": getattr(w, "lease_info", None),
                   "generation": w.live.current_gen()}
        w.close()
        print(json.dumps(summary))
        return 0
    except faults.InjectedCrash:
        os.kill(os.getpid(), signal.SIGKILL)
        return 1   # unreachable
    finally:
        ack.close()


def _spawn_feeder(live_dir: str, ack_path: str, start: int = 0,
                  end: int = 0, *, device: str, ops_path: str | None = None,
                  buffer_docs: int = 8, compact_every: int = 0,
                  pause_s: float = 0.0, fault_plan: str | None = None):
    """Popen an ingest_feed_main child (fed `_feed_doc(i)` for i in
    [start, end), or the ops file `ops_path`) on `device` (the parent's: the
    child never picks one itself) in a fresh interpreter, never forked
    from a parent that may hold a CUDA context, with this package's
    parent dir on its PYTHONPATH so it imports the same port from any
    working dir. Its output goes to files, not pipes: the parent polls,
    and a full pipe would wedge the child. Returns (the Popen, the
    stdout path, the stderr path)."""
    import subprocess
    import sys

    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    if fault_plan is not None:
        env["TPU_IR_FAULTS"] = fault_plan
    else:
        env.pop("TPU_IR_FAULTS", None)
    cmd = [sys.executable, "-c",
           "from tpu_ir_torch.serving.soak import ingest_feed_main; "
           "raise SystemExit(ingest_feed_main())",
           "--live-dir", live_dir, "--ack", ack_path,
           "--start", str(start), "--end", str(end),
           "--buffer-docs", str(buffer_docs),
           "--compact-every", str(compact_every),
           "--pause-s", str(pause_s), "--device", device]
    if ops_path is not None:
        cmd += ["--ops", ops_path]
    out_path = ack_path + f".{start}.out"
    err_path = ack_path + f".{start}.err"
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, env=env, stdout=out, stderr=err)
    return proc, out_path, err_path


# ---------------------------------------------------------------------------
# the ingest and serve soak
# ---------------------------------------------------------------------------


def _flush_ancestor(live, gen: int) -> dict | None:
    """The nearest ancestor manifest of `gen` (itself included) whose
    commit carried mutations (note flush or close): its `created` stamp is
    when the docs a compacted generation serves became durable, the start
    of the freshness clock."""
    g = gen
    while g is not None:
        try:
            m = live.manifest(g)
        except (OSError, ValueError):
            return None
        if m.get("note") in ("flush", "close"):
            return m
        g = m.get("parent")
    return None


def run_ingest_soak(live_dir: str, *, docs: int = 48, base_docs: int = 12,
                    buffer_docs: int = 6, compact_every: int = 12,
                    kill_fraction: float = 0.5, num_shards: int = 2,
                    probe_threads: int = 2, timeout_s: float = 300.0,
                    device=None, flight_dir: str | None = None) -> dict:
    """Ingest and serve at once, with a SIGKILL of the ingest process in
    the middle of its feed and exactly-once recovery, on `device` (the
    card unless "cpu"; the feeder children run on it too).

    The parent seeds `base_docs` and compacts, then serves the live dir
    through a ServingFrontend (`probe_threads` threads of real queries,
    reloading onto each servable generation the children land) while a
    child feeds `docs` documents through an IngestWriter, flushing and
    compacting every `compact_every`, and appends each docid to an ack
    file after the writer acknowledged it. At `kill_fraction` of the feed
    (moved off a flush boundary, so the WAL holds a suffix) the parent
    SIGKILLs the child; a successor takes over the stale lease, replays
    the WAL and resumes after the last acknowledged doc (upserts make
    the overlap idempotent).

    Raises AssertionError on a breach of: no acknowledged write lost (each
    acked docid live in the final generation); conservation (shed +
    served + errors == submitted, errors 0); no stale answer (none from
    a generation older than the one adopted before the request began);
    the successor replayed (the kill landed mid-work). Reports
    `ingest_docs_per_s` (acked docs over the feed's wall, recovery
    included) and `freshness_lag_ms` (the median from a flush's commit to
    the first answer from a generation holding it; it also sets the
    `ingest.freshness_lag_ms` gauge /healthz reads). Beside `tpu_ir`'s
    keys, the frontend's kernel launches as a worker's /healthz gives
    them: `kernel_launches` from its load on, `warm_launches` those of
    its load and warm-up and of each reload (a probe served while a
    reload runs counts as the reload's, so the difference is a lower
    bound of the probes' launches). The run is an `ingest-soak` job
    (seed, feed, recover, verify); a breach writes a forced
    `ingest_soak_breach` flight record to `flight_dir` (default:
    obs.flight_dir()) and fails the job."""
    import json
    import signal

    import tpu_ir_torch

    from ..index.ingest import IngestWriter
    from ..index.segments import LiveIndex, is_live, latest_servable
    from ..search.scorer import Scorer
    from .shardset import WarmLaunches

    device = "cuda" if device is None else str(device)
    reg = obs.get_registry()
    t_start = time.time()
    with tracked("ingest-soak", f"ingest-soak-{docs}d",
                 phases=("seed", "feed", "recover", "verify"),
                 config={"docs": docs, "base_docs": base_docs,
                         "compact_every": compact_every,
                         "kill_fraction": kill_fraction}):
        report_progress("seed", total=base_docs)
        if not is_live(live_dir):
            # word-only: the soak measures durability and freshness, and
            # cheap compactions keep the kill inside the feed
            LiveIndex.create(live_dir, num_shards=num_shards, chargram_ks=())
        with IngestWriter(live_dir, auto_merge=False, device=device) as w:
            existing = w._docs()
            for i in range(base_docs):
                docid, text = _feed_doc(i)
                if docid not in existing:
                    w.update(docid, text)
            w.compact_all(note="ingest-soak base")
        live = LiveIndex.open(live_dir)

        warm = WarmLaunches()
        launches0 = tpu_ir_torch.kernel_launches()
        texts = [" ".join(_FEED_WORDS[j % len(_FEED_WORDS)]
                          for j in range(q, q + 2)) for q in range(6)]
        with warm.counting():
            scorer = Scorer.load_generation(live_dir, layout="sparse",
                                            device=device)
            frontend = ServingFrontend(scorer, ServingConfig(
                max_concurrency=4, max_queue=16))
            for t in texts:   # the probes' shapes warm before the clock runs
                frontend.search(t, k=5, scoring="bm25")
        served_gen = scorer.generation

        stop = threading.Event()
        lock = threading.Lock()
        counts = {"submitted": 0, "served": 0, "shed": 0, "errors": 0,
                  "stale": 0}
        gen_seen: set = {served_gen}
        adoptions: list[dict] = []   # {gen, flush_created, first_query}
        adopted = {"gen": served_gen}
        error_samples: list[str] = []

        def probe(tid: int) -> None:
            i = tid
            while not stop.is_set():
                with lock:
                    counts["submitted"] += 1
                    gen_before = adopted["gen"]
                try:
                    res = frontend.search(texts[i % len(texts)], k=5,
                                          scoring="bm25")
                    now = time.time()
                    with lock:
                        counts["served"] += 1
                        gen_seen.add(res.generation)
                        if res.generation < gen_before:
                            # older than the generation published before this
                            # request began
                            counts["stale"] += 1
                        for a in adoptions:
                            if (a["first_query"] is None
                                    and res.generation >= a["gen"]):
                                a["first_query"] = now
                except Overloaded:
                    with lock:
                        counts["shed"] += 1
                except Exception as e:  # noqa: BLE001 — counted
                    with lock:
                        counts["errors"] += 1
                        if len(error_samples) < 5:
                            error_samples.append(repr(e))
                i += probe_threads

        def adopt_new_generations() -> None:
            try:
                _path, g = latest_servable(live_dir)
            except (ValueError, OSError):
                return
            if g <= adopted["gen"]:
                return
            flush_m = _flush_ancestor(live, g)
            with lock:
                adoptions.append({
                    "gen": g, "flush_created": (flush_m or {}).get("created"),
                    "first_query": None})
            with warm.counting():
                frontend.reload_generation(generation=g)
            with lock:
                adopted["gen"] = g

        ack_path = os.path.join(live_dir, "ingest-soak.ack")
        open(ack_path, "w").close()

        def acked_now() -> list:
            with open(ack_path, encoding="utf-8") as f:
                return [ln.strip() for ln in f if ln.strip()]

        probes = [threading.Thread(target=probe, args=(t,),
                                   name=f"tpu-ir-ingest-soak-probe-{t}",
                                   daemon=True)
                  for t in range(probe_threads)]
        kills = 0
        child_summary = None
        feed_deadline = time.time() + timeout_s
        t_feed0 = time.time()
        try:
            for th in probes:
                th.start()
            report_progress("feed", total=docs)
            kill_off = max(1, int(docs * kill_fraction))
            # at an exact flush boundary the WAL suffix is empty and the
            # recovery has nothing to replay
            if buffer_docs > 1 and kill_off % buffer_docs == 0:
                kill_off += 1
            child, _out1, _err1 = _spawn_feeder(
                live_dir, ack_path, base_docs, base_docs + docs, device=device,
                buffer_docs=buffer_docs, compact_every=compact_every,
                pause_s=0.02)
            while child.poll() is None:
                # polled much faster than the child feeds (pause_s), so the
                # kill lands at most about one doc past kill_off
                if len(acked_now()) >= kill_off and kills == 0:
                    os.kill(child.pid, signal.SIGKILL)
                    child.wait(timeout=30.0)
                    kills += 1
                    break
                if time.time() > feed_deadline:
                    child.kill()
                    raise AssertionError("ingest soak: the feeder child "
                                         "outran the soak's timeout")
                adopt_new_generations()
                time.sleep(0.005)

            report_progress("recover")
            acked_mid = acked_now()
            if kills:
                # resume after the last acked doc; a doc the WAL held past it
                # is upserted again, which changes nothing
                resume_from = base_docs + len(acked_mid)
                child2, out2, err2 = _spawn_feeder(
                    live_dir, ack_path, resume_from, base_docs + docs,
                    device=device, buffer_docs=buffer_docs,
                    compact_every=compact_every)
                while child2.poll() is None:
                    if time.time() > feed_deadline:
                        child2.kill()
                        raise AssertionError("ingest soak: the recovery child "
                                             "outran the soak's timeout")
                    adopt_new_generations()
                    time.sleep(0.02)
                child2.wait()
                with open(err2, encoding="utf-8") as f:
                    err_text = f.read()
                assert child2.returncode == 0, (
                    f"recovery child failed rc={child2.returncode}: "
                    f"{err_text[-2000:]}")
                with open(out2, encoding="utf-8") as f:
                    child_summary = json.loads(
                        f.read().strip().splitlines()[-1])
            t_feed1 = time.time()
            # let the probes answer from the last generation
            for _ in range(100):
                adopt_new_generations()
                with lock:
                    last = adoptions[-1] if adoptions else None
                if last is None or last["first_query"] is not None:
                    break
                time.sleep(0.02)
        finally:
            stop.set()
            for th in probes:
                th.join(timeout=30.0)

        report_progress("verify")
        acked = acked_now()
        recovered = set(LiveIndex.open(live_dir).live_doc_map())
        lost = [d for d in acked if d not in recovered]
        expected = {_feed_doc(i)[0] for i in range(base_docs + docs)}
        unexpected = sorted(recovered - expected)
        with lock:
            snap = dict(counts)
            adopts = [dict(a) for a in adoptions]
            gens = sorted(gen_seen)
        lags = [(a["first_query"] - a["flush_created"]) * 1e3 for a in adopts
                if a["first_query"] is not None
                and a["flush_created"] is not None]
        for lag in lags:
            reg.observe("ingest.freshness", lag / 1e3)
        lags.sort()
        freshness_ms = lags[len(lags) // 2] if lags else -1.0
        if lags:
            reg.set_gauge("ingest.freshness_lag_ms", round(freshness_ms, 3))
        feed_wall = max(t_feed1 - t_feed0, 1e-9)
        split = warm.snapshot()
        report = {
            "docs": docs,
            "base_docs": base_docs,
            "acked": len(acked),
            "recovered_docs": len(recovered),
            "lost_acked": len(lost),
            "unexpected_docs": unexpected[:5],
            "kills": kills,
            "child_replayed": (child_summary or {}).get("replayed"),
            "lease_takeover": bool(((child_summary or {}).get("lease")
                                    or {}).get("taken_over")),
            "feed_wall_s": round(feed_wall, 3),
            "ingest_docs_per_s": round(len(acked) / feed_wall, 2),
            "freshness_lag_ms": round(freshness_ms, 3),
            "freshness_samples": len(lags),
            "swaps": len(adopts),
            "generations_seen": gens,
            **snap,
            "error_samples": error_samples,
            "wall_s": round(time.time() - t_start, 3),
            "kernel_launches": {n: v - launches0.get(n, 0) for n, v
                                in split["kernel_launches"].items()},
            "warm_launches": split["warm_launches"],
        }
        conserved = (snap["served"] + snap["shed"] + snap["errors"]
                     == snap["submitted"])
        if (lost or unexpected or not conserved or snap["errors"]
                or snap["stale"]
                or (kills and not (child_summary or {}).get("replayed"))):
            report["flight_record"] = flight_dump(
                "ingest_soak_breach",
                extra={k: report[k] for k in
                       ("acked", "lost_acked", "unexpected_docs", "kills",
                        "submitted", "served", "shed", "errors", "stale",
                        "child_replayed", "error_samples")},
                out_dir=flight_dir, force=True)
            raise AssertionError(
                f"ingest soak invariant breach: lost_acked={len(lost)} "
                f"unexpected={unexpected[:5]} conserved={conserved} "
                f"errors={snap['errors']} stale={snap['stale']} "
                f"replayed={(child_summary or {}).get('replayed')} "
                f"samples={error_samples} "
                f"(flight record: {report['flight_record']})")
    return report