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
rolls the fleet onto a new generation): the invariants then hold across
processes, partial answers included.

`run_concurrency_sweep` measures closed-loop clients at each concurrency
level through the coalescing frontend: latency percentiles, q/s, batch
occupancy and the shapes dispatched outside the warmed set.

The traffic is `make_queries`' uniform draw or a serving/workload.py
model (`workload=`: "zipf", a spec dict or a Workload).

`ingest_feed_main` is the ingest child that the live index's SIGKILL
crash matrix spawns (`_spawn_feeder`): it feeds `_feed_doc`s, or an ops
file's adds, updates and deletes, through an IngestWriter and dies by
SIGKILL at a fault site.

Not ported: `run_ingest_soak` (ROADMAP 6b-3), and the soaks' progress
jobs, flight records, distributed traces and SLO records (item 8).
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
    then carries its `batching` snapshot. `workload` (make_queries')
    shapes the requests, and a burst schedule their arrivals; the report
    carries its description and the run's result-cache activity."""
    from .workload import resolve_workload

    if faults.active() is not None:
        raise RuntimeError("a fault plan is already installed")
    wl = resolve_workload(scorer, workload, seed=seed)
    reqs = make_queries(scorer, queries, seed=seed, workload=wl)
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
    if wl is not None:
        report["workload"] = wl.describe()
    report["cache"] = _cache_delta(cache_before)
    if frontend.batcher is not None:
        report["batching"] = frontend.batcher.snapshot()
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
                         scale_plan: dict | None = None) -> dict:
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
      respawn the recovery probes come back full.

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

    `autoscale` and `scale_plan` (the elastic fleet) are not ported yet
    (ROADMAP 6b-3) and raise."""
    from ..index import segments as seg
    from ..obs import get_registry
    from ..search.layout import shard_doc_ranges
    from ..search.scorer import Scorer
    from .router import Router, RouterConfig
    from .shardset import ShardSet
    from .workload import resolve_workload

    if autoscale or scale_plan:
        raise ValueError("autoscale= and scale_plan= (the elastic fleet) "
                         "are not ported yet: ROADMAP item 6b-3")
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

    # -- the oracles, in this process before any worker exists: per
    # generation a serial reference and the partial answers' oracle (an
    # answer is judged against the generation it names)
    distinct = list({_req_key(r): r for r in reqs}.values())
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

    reg = get_registry()
    hist_before = reg.hist_state()
    cache_before = _cache_counters_now()
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
        try:
            # -- the chaos and upgrade controller --------------------------
            killed: list = []
            swap_state = {"done_at": None, "result": None}
            swap_complete = threading.Event()

            def chaos_controller():
                fired = {"replica": False, "shard": False,
                         "respawn": False, "upgrade": False}
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
                    except Exception:  # noqa: BLE001 — chaos must not
                        logger.exception("chaos controller")  # kill it
                    completed.wait(0.02)
                # whatever is still dead comes back for the recovery
                for s_, r_ in list(killed):
                    try:
                        shardset.respawn(s_, r_)
                    except Exception:  # noqa: BLE001
                        logger.exception("post-soak respawn")

            ctrl = threading.Thread(target=chaos_controller,
                                    name="soak-chaos", daemon=True)
            ctrl.start()

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
            wall_s = time.perf_counter() - t0

            # -- the recovery probes (the fleet whole again): breakers
            # opened during the chaos need a success each to close and a
            # respawned worker may still be warming, so each probe retries
            # for a while before it counts as not recovered
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
        finally:
            router.close()

    # -- the invariants ------------------------------------------------------
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
    if wl is not None:
        report["workload"] = wl.describe()
    # served latency in the workload's peak window (the whole run without
    # a burst schedule)
    served_lat = [v for v in latencies if v is not None]
    peak_lat = [latencies[i] for i in range(len(reqs))
                if latencies[i] is not None and wl is not None
                and wl.is_peak(i / len(reqs))]
    report["burst_p99_ms"] = _p99_ms(peak_lat or served_lat)
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
    import os
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
    import os
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
