"""The scatter-gather router: one logical index over S doc shards of R
replicas each (the port of `tpu_ir/serving/router.py`).

Each worker (serving/shardset.py) scores the whole index restricted to a
contiguous docid range (search/layout.py::shard_doc_ranges), so a doc's
score does not depend on the partition: the global top-k is the merge of
the shards' top-k lists, and the rerank's stage 2 takes each candidate's
cosine score from the shard that owns it. A request goes

    admission -> result cache -> fan-out (S shards x R replicas) -> merge
                                 | a deadline per shard          | partial
                                 | hedged attempts                | tags
                                 + a breaker per replica          +

- **Hedging.** Once a shard's first attempt has taken max(
  TPU_IR_ROUTER_HEDGE_MS, the shard's trailing p99), the same request
  goes to its next replica and the first answer wins.
- **Failover.** An attempt that fails (refused or reset, a 5xx, a shed:
  shardset.RPCError's kinds) goes at once to the next replica, within
  the shard's deadline.
- **Breakers.** A replica that failed `breaker_threshold` times in a row
  is tried last (breaker.py); after its cooldown one probe finds out
  whether it recovered.
- **Partial answers.** A shard no replica answered within the deadline
  is left out of the merge and named in `missing_shards`, the answer
  tagged `partial`. Every routed answer is one of full, degraded and
  partial, or it raises Overloaded (shed).
- **Generations.** Each answer names the index generation it came from;
  a fan-out whose answers name two merges only the winner's (most
  shards, ties to the newer) and counts `router.mixed_generation`.
- **The two-phase rerank.** `rerank=C`: BM25 top-C on every shard,
  merged to the global top-C; then `cosine_at` at those candidates on
  every shard that answered, each candidate scored by its owner, and the
  top-k in candidate order.
- **The result cache.** An exact-hit cache in front of admission: a hit
  dials no worker and arms no hedge timer.

- **Membership.** On a ShardSet the router dials `dispatchable()`, so a
  replica that is warming, draining or retired gets no new attempt; an
  answer from one that went draining mid-call is still used, but its
  round trip feeds no hedge estimate (a drain is a membership change,
  not a slow peer). `reset_breaker` clears a reused slot's breaker.

Telemetry: the `router.*` counters, the `router.request`,
`router.shard_rtt` and `router.merge` histograms (obs/registry.py), one
SLO record a finished request (obs/disttrace.py::slo_record: a cache hit,
either shed, a served answer), and the aggregated /healthz
(obs/server.py::register_router). Every request past the cache mints a
distributed trace at admission (obs/disttrace.py): its `request` root
holds `admission_wait`; each replica attempt is an `rpc.<path>` record
(shard, replica, addr, hedge) made at submit, which carries its own
context to the worker as `traceparent`, gets its true duration and ok or
error when the call returns, the worker's piggybacked records folded in
beside it, and one verdict at harvest: won, lost, failed, cancelled or
deadline. The answer's `trace_id` names the trace. Every finished
request, a cache hit too, leaves one query-log entry (obs/querylog.py)
with the routed taxonomy and the answer's `trace_id`.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass

from .. import envvars, obs
from ..obs import disttrace, get_registry, querylog
from ..obs import trace as obs_trace
from .admission import AdmissionController, Overloaded
from .breaker import CircuitBreaker

logger = logging.getLogger(__name__)

# service levels best first; a routed answer carries the worst level any
# contributing shard served at
_LEVEL_ORDER = ("full", "no_rerank", "hot_only")


@dataclass(frozen=True)
class RouterConfig:
    """The router's knobs; None reads the TPU_IR_ROUTER_* variable."""

    deadline_ms: float | None = None   # a shard's budget for one request
    hedge_ms: float | None = None      # hedge delay's floor; 0: no hedges
    connect_ms: float | None = None    # TCP connect timeout an attempt
    breaker_threshold: int = 3         # failures in a row that open
    breaker_cooldown_s: float = 1.0    # open time before a probe
    max_concurrency: int = 16          # routed requests running at once
    max_queue: int = 64                # routed requests allowed to wait
    rtt_window: int = 64               # trailing round trips a shard
    health_ttl_s: float | None = None  # age of the polled worker health
    # the exact-hit result cache's entries: None reads
    # TPU_IR_CACHE_RESULTS, 0 turns it off
    cache_entries: int | None = None


def merge_shard_topk(shard_hits, k: int) -> list:
    """The exact top-k of per-shard hit lists.

    `shard_hits`: per-shard [(docid, score), ...] lists in the shard's
    rank order (score desc, docid asc, the kernels' tie rule), ordered by
    ascending shard id. The shards are contiguous ascending docid ranges,
    so a stable sort on the score alone reproduces the single scorer's
    order, ties to the lower docid. Empty slots (docid <= 0 or score <=
    0) are dropped."""
    merged = [h for hits in shard_hits for h in hits
              if h[0] > 0 and h[1] > 0.0]
    merged.sort(key=lambda h: -h[1])  # stable
    return merged[:k]


def merge_candidate_scores(cand: list, per_shard: dict,
                           ranges: list, k: int) -> list:
    """The rerank's stage 2 across shards: each global candidate's cosine
    score comes from its owning shard's `cosine_at` answer (`per_shard`:
    shard id -> [C] scores aligned with `cand`; `ranges`: each shard's
    (lo, hi)), then the top-k in candidate order, ties to the earlier
    candidate, as the rerank in one process picks them. A candidate whose
    owner did not answer is dropped."""
    scored = []
    for pos, docid in enumerate(cand):
        if docid <= 0:
            continue
        owner = next((s for s, (lo, hi) in enumerate(ranges)
                      if lo <= docid <= hi), None)
        if owner is None or owner not in per_shard:
            continue
        scored.append((docid, per_shard[owner][pos]))
    scored.sort(key=lambda h: -h[1])
    return [(d, s) for d, s in scored[:k] if s > 0.0]


class _ShardStats:
    """A shard's trailing round trips (the hedge delay's source) and its
    round-robin cursor. One small lock, never held across IO."""

    def __init__(self, window: int):
        self._lock = threading.Lock()
        self._rtts: list = []
        self._window = window
        self._cursor = 0

    def observe(self, rtt_s: float) -> None:
        with self._lock:
            self._rtts.append(rtt_s)
            if len(self._rtts) > self._window:
                del self._rtts[: len(self._rtts) - self._window]

    def p99_s(self) -> float | None:
        with self._lock:
            if not self._rtts:
                return None
            s = sorted(self._rtts)
        return s[min(len(s) - 1, int(0.99 * (len(s) - 1)))]

    def next_cursor(self, n: int) -> int:
        with self._lock:
            self._cursor = (self._cursor + 1) % max(n, 1)
            return self._cursor


class Router:
    """The fleet's front door; thread-safe. Callers' threads run their own
    requests (admission bounds how many) and one owned pool runs the
    replica attempts, sized so a full house of admitted requests can fan
    out and hedge without queueing behind each other. `close()` (or the
    context manager) shuts the pool down.

    `topology` is a ShardSet (the router dials its `dispatchable()`
    grid, re-read each request, so a respawned worker's new port is
    picked up) or a static [shard][replica] address grid; a None slot
    has no worker."""

    def __init__(self, index_dir: str, topology,
                 config: RouterConfig | None = None):
        from ..index import format as fmt
        from ..index import segments as seg
        from ..search.layout import shard_doc_ranges
        from .result_cache import ResultCache, resolve_capacity

        self.index_dir = index_dir
        # a live index's docno space, doc partition and docno -> docid
        # mapping are per generation; a plain index dir is generation 0
        self._live_dir = index_dir if seg.is_live(index_dir) else None
        self._gen_infos: dict = {}
        self._gen_lock = threading.Lock()
        resolved_dir, self._gen0 = seg.resolve_serving(index_dir)
        self.config = cfg = config or RouterConfig()
        self._deadline_s = (cfg.deadline_ms if cfg.deadline_ms is not None
                            else envvars.get_float(
                                "TPU_IR_ROUTER_DEADLINE_MS")) / 1e3
        self._hedge_floor_s = (cfg.hedge_ms if cfg.hedge_ms is not None
                               else envvars.get_float(
                                   "TPU_IR_ROUTER_HEDGE_MS")) / 1e3
        self._connect_s = (cfg.connect_ms if cfg.connect_ms is not None
                           else envvars.get_float(
                               "TPU_IR_ROUTER_CONNECT_MS")) / 1e3
        self._health_ttl_s = (cfg.health_ttl_s
                              if cfg.health_ttl_s is not None
                              else envvars.get_float(
                                  "TPU_IR_ROUTER_HEALTH_TTL_S"))
        # the router dials the dispatchable grid; health reads every slot
        self._lifecycle_fn = getattr(topology, "lifecycle", None)
        self._epoch_fn = getattr(topology, "epoch", None)
        if hasattr(topology, "addresses"):
            self._topology = getattr(topology, "dispatchable",
                                     topology.addresses)
            self._full_topology = topology.addresses
        else:
            static = [list(row) for row in topology]
            self._topology = lambda: static
            self._full_topology = self._topology
        grid = self._full_topology()
        self.num_shards = len(grid)
        if self.num_shards < 1:
            raise ValueError("topology has no shards")
        meta = fmt.IndexMetadata.load(resolved_dir)
        self.num_docs = meta.num_docs
        self._ranges = shard_doc_ranges(meta.num_docs, self.num_shards)
        self._gen_infos[self._gen0] = {
            "dir": resolved_dir, "num_docs": meta.num_docs,
            "ranges": self._ranges, "mapping": None}
        self.admission = AdmissionController(cfg.max_concurrency,
                                             cfg.max_queue)
        # keyed by the newest generation this router has seen win a
        # merge: it starts at 0 and follows the answers (and
        # note_generation), never the newest manifest on disk, so a fleet
        # pinned to an older generation still caches
        cap = resolve_capacity(cfg.cache_entries)
        self.cache = ResultCache(cap, name="router") if cap > 0 else None
        self._breakers: dict = {}
        self._breakers_lock = threading.Lock()
        self._stats = [_ShardStats(cfg.rtt_window)
                       for _ in range(self.num_shards)]
        # sized for a full admission house fanning out and hedging: the
        # requests run on the callers' threads, only attempts run here
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, cfg.max_concurrency * self.num_shards * 2),
            thread_name_prefix="tpu-ir-router")
        self._closed = False
        self._health_lock = threading.Lock()
        self._health_cache: tuple | None = None  # (monotonic, payload)
        self._health_polling = False
        from ..obs.server import register_router

        register_router(self)
        disttrace.set_service("router")

    # -- plumbing ----------------------------------------------------------

    def _breaker(self, shard: int, replica: int) -> CircuitBreaker:
        key = (shard, replica)
        with self._breakers_lock:
            b = self._breakers.get(key)
            if b is None:
                b = self._breakers[key] = CircuitBreaker(
                    self.config.breaker_threshold,
                    self.config.breaker_cooldown_s)
            return b

    def _gen_info(self, gen: int) -> dict | None:
        """A generation's servable dir, doc count, doc-range partition and
        (lazily) docno -> docid mapping, or None when it cannot be
        resolved (its manifest was collected, or a worker named a
        generation this router's view of the disk lacks): the caller
        counts those answers as lost. Loaded once per generation, outside
        the lock."""
        with self._gen_lock:
            info = self._gen_infos.get(gen)
        if info is not None:
            return info
        from ..index import format as fmt
        from ..index import segments as seg
        from ..search.layout import shard_doc_ranges

        src = self._live_dir or self.index_dir
        try:
            resolved, _ = seg.resolve_serving(src, gen if self._live_dir
                                              else None)
            meta = fmt.IndexMetadata.load(resolved)
        except (OSError, ValueError) as e:
            logger.warning("cannot resolve index generation %s: %r",
                           gen, e)
            return None
        info = {"dir": resolved, "num_docs": meta.num_docs,
                "ranges": shard_doc_ranges(meta.num_docs,
                                           self.num_shards),
                "mapping": None}
        with self._gen_lock:
            return self._gen_infos.setdefault(gen, info)

    def _mapping_loaded(self, gen: int | None = None):
        info = self._gen_info(self._gen0 if gen is None else gen)
        if info is None:  # a winner is always resolved
            raise RuntimeError(f"generation {gen} is not resolvable")
        if info["mapping"] is None:
            from ..collection import DocnoMapping
            from ..index import format as fmt

            # two loaders may race: both read, the last reference wins
            info["mapping"] = DocnoMapping.load(
                os.path.join(info["dir"], fmt.DOCNOS))
        return info["mapping"]

    def _call_replica(self, shard: int, replica: int, addr: str,
                      path: str, payload: dict, timeout_s: float,
                      ctx=None):
        """One replica attempt through shardset.rpc_post, with its breaker
        verdict and round-trip sample. Returns (ok, answer or error).
        `ctx` is the attempt's trace context: it goes out as
        `traceparent`, the attempt's record (made at submit) gets the true
        duration and ok or error, and the worker's records on the answer
        (`_trace`) go into this process's store."""
        from .shardset import rpc_post

        breaker = self._breaker(shard, replica)
        allowed, is_probe = breaker.allow_device()
        if not allowed:
            if ctx is not None:
                disttrace.annotate(ctx.trace_id, ctx.span_id,
                                   ok=False, error="breaker_open")
            return False, "breaker_open"
        headers = ({"traceparent": ctx.to_header()}
                   if ctx is not None else None)
        t0 = time.perf_counter()
        try:
            data = rpc_post(addr, path, payload, timeout_s,
                            connect_timeout_s=self._connect_s,
                            headers=headers)
        except BaseException as e:  # noqa: BLE001 — every failure is the
            # replica's verdict (refused, reset, timeout, 5xx, shed)
            if breaker.record_failure(is_probe=is_probe):
                get_registry().incr("router.breaker_opened")
            get_registry().incr("router.replica_failed")
            if ctx is not None:
                disttrace.annotate(
                    ctx.trace_id, ctx.span_id,
                    dur_ms=(time.perf_counter() - t0) * 1e3,
                    ok=False, error=repr(e))
            return False, repr(e)
        rtt = time.perf_counter() - t0
        if ctx is not None:
            disttrace.annotate(ctx.trace_id, ctx.span_id,
                               dur_ms=rtt * 1e3, ok=True)
            if isinstance(data, dict):
                # live stitching: the worker's records join the store
                disttrace.ingest_remote(data.pop("_trace", None))
        breaker.record_success(is_probe=is_probe)
        # a replica that went draining while this call was in flight still
        # answers (drain-not-drop), but its round trip must not feed the
        # hedge estimate
        if not self._replica_draining(shard, replica):
            self._stats[shard].observe(rtt)
        if obs.enabled():
            get_registry().observe("router.shard_rtt", rtt)
        return True, data

    def _replica_draining(self, shard: int, replica: int) -> bool:
        if self._lifecycle_fn is None:
            return False
        try:
            return self._lifecycle_fn()[shard][replica] == "draining"
        except (IndexError, TypeError):
            return False

    def reset_breaker(self, shard: int, replica: int) -> None:
        """Forget one replica's breaker history: a grow that reuses a
        retired slot calls this, so the fresh worker does not inherit its
        predecessor's state (CircuitBreaker.reset, in place)."""
        with self._breakers_lock:
            b = self._breakers.get((shard, replica))
        if b is not None:
            b.reset()

    def _replica_order(self, shard: int, avail: list) -> list:
        """The try order over the addressed replicas (`avail`, grid
        indices): a round-robin start spreads the load, replicas whose
        breaker is not closed go last (still listed: with every breaker
        open, trying one is how a probe finds a recovered worker)."""
        if not avail:
            return []
        start = self._stats[shard].next_cursor(len(avail))
        order = [avail[(start + i) % len(avail)]
                 for i in range(len(avail))]
        open_state = []
        closed = []
        for r in order:
            b = self._breaker(shard, r)
            (closed if b.state == "closed" else open_state).append(r)
        return closed + open_state

    def _hedge_delay_s(self, shard: int) -> float:
        """This shard's hedge delay: max(floor, its trailing p99), at most
        the deadline. Per shard: one slow shard must not lift the delay
        of the fast ones."""
        if self._hedge_floor_s <= 0.0:
            return float("inf")  # hedging off
        p99 = self._stats[shard].p99_s()
        return min(max(self._hedge_floor_s, p99 or 0.0),
                   self._deadline_s)

    # -- the fan-out -------------------------------------------------------

    def _fanout(self, path: str, payload_of, shards: list) -> dict:
        """One RPC to every shard in `shards` at once, with failover and a
        hedge per shard. Returns {shard: (answer, hedges fired)} for the
        shards that answered within the deadline.

        Every attempt is submitted from this (the caller's) thread, never
        from a pool task, so a full pool delays but cannot deadlock."""
        grid = self._topology()
        deadline = time.monotonic() + self._deadline_s
        hedge_delay = {s: self._hedge_delay_s(s) for s in shards}
        # the request's trace, read on this (the caller's) thread: the
        # pool's threads never see it, so each attempt's context derives
        # from this handle
        ctx = disttrace.current()
        tid = ctx.trace_id if ctx is not None else None

        class _ShardJob:
            __slots__ = ("order", "next_i", "futs", "t0", "hedged",
                         "result", "hedges")

            def __init__(self):
                self.order: list = []
                self.next_i = 0
                # (replica, future, is_hedge, attempt span id)
                self.futs: list = []
                self.t0 = time.monotonic()
                self.hedged = False
                self.result = None
                self.hedges = 0

        jobs: dict[int, _ShardJob] = {}
        for s in shards:
            job = _ShardJob()
            row = grid[s] if s < len(grid) else []
            # grid indices of addressed replicas only: a None slot is
            # never dialed, and breaker and health numbering stay the
            # grid's
            avail = [i for i, a in enumerate(row) if a]
            job.order = self._replica_order(s, avail)
            jobs[s] = job
            self._submit_next(s, job, grid, path, payload_of(s),
                              deadline, is_hedge=False, ctx=ctx)

        while True:
            now = time.monotonic()
            pending = []
            for s, job in jobs.items():
                if job.result is not None:
                    continue
                # harvest: the first success wins; a failure moves on to
                # the next replica at once (failover, not the timed hedge)
                still = []
                for replica, fut, is_hedge, sid in job.futs:
                    if not fut.done():
                        still.append((replica, fut, is_hedge, sid))
                        continue
                    ok, data = fut.result()
                    if ok and job.result is None:
                        job.result = data
                        if is_hedge:
                            get_registry().incr("router.hedge_won")
                        disttrace.annotate(tid, sid, outcome="won",
                                           hedge=is_hedge)
                    elif ok:
                        # a correct answer after another attempt won
                        disttrace.annotate(tid, sid, outcome="lost",
                                           hedge=is_hedge)
                    else:
                        disttrace.annotate(tid, sid, outcome="failed",
                                           hedge=is_hedge)
                job.futs = still
                if job.result is not None:
                    continue
                if not job.futs and job.next_i < len(job.order):
                    # every attempt in flight failed: fail over now
                    self._submit_next(s, job, grid, path, payload_of(s),
                                      deadline, is_hedge=False, ctx=ctx)
                elif (not job.hedged and job.futs
                        and now - job.t0 >= hedge_delay[s]
                        and job.next_i < len(job.order)):
                    # the first attempt is slow, not dead: hedge to the
                    # next replica, the faster answer wins
                    job.hedged = True
                    job.hedges += 1
                    get_registry().incr("router.hedge_fired")
                    self._submit_next(s, job, grid, path, payload_of(s),
                                      deadline, is_hedge=True, ctx=ctx)
                pending.extend(f for _, f, _, _ in job.futs)
            unresolved = [s for s, j in jobs.items() if j.result is None]
            if not unresolved or now >= deadline:
                break
            if not pending:
                # nothing in flight and no replica left: the shard is lost
                # for this request
                if all(jobs[s].next_i >= len(jobs[s].order)
                       and not jobs[s].futs for s in unresolved):
                    break
                continue
            # wake at a completion, the earliest hedge due, or the deadline
            next_hedge = min(
                (jobs[s].t0 + hedge_delay[s] for s in unresolved
                 if not jobs[s].hedged
                 and jobs[s].next_i < len(jobs[s].order)),
                default=deadline)
            wait(pending, timeout=max(
                0.001, min(next_hedge, deadline) - time.monotonic()),
                return_when=FIRST_COMPLETED)
        if tid is not None:
            # attempts still in flight: a winner made them moot, or the
            # deadline passed under them (why the answer went partial)
            for s, job in jobs.items():
                for _, _, is_hedge, sid in job.futs:
                    disttrace.annotate(
                        tid, sid, hedge=is_hedge,
                        outcome=("cancelled" if job.result is not None
                                 else "deadline"))
        return {s: (j.result, j.hedges) for s, j in jobs.items()
                if j.result is not None}

    def _submit_next(self, shard: int, job, grid, path: str,
                     payload: dict, deadline: float, *,
                     is_hedge: bool, ctx=None) -> None:
        if job.next_i >= len(job.order):
            return
        replica = job.order[job.next_i]
        job.next_i += 1
        addr = grid[shard][replica]
        # the attempt's read budget: what is left of the deadline
        timeout_s = min(max(deadline - time.monotonic(), 1e-3),
                        self._deadline_s)
        # the attempt's record is made at submit (its duration and verdict
        # come later), so an attempt cancelled in flight still shows
        actx = disttrace.child(ctx)
        sid = None
        if actx is not None:
            sid = disttrace.add_span(
                actx.trace_id, f"rpc.{path}", span_id=actx.span_id,
                parent_id=actx.parent_id,
                attrs={"shard": shard, "replica": replica,
                       "addr": addr, "hedge": is_hedge})
        fut = self._pool.submit(self._call_replica, shard, replica,
                                addr, path, payload, timeout_s, actx)
        job.futs.append((replica, fut, is_hedge, sid))

    # -- the request path --------------------------------------------------

    def search(self, text: str, *, k: int = 10, scoring: str = "tfidf",
               rerank: int | None = None,
               return_docids: bool = True):
        """Serve one query across the fleet. Returns a SearchResult tagged
        with the routed taxonomy (level, degraded, partial, shards_ok,
        missing_shards, hedges, generation), or raises Overloaded (the
        router's admission shed it, or no shard answered). Phrase queries
        are scored on the host against positions the workers do not serve:
        send them to a single-process frontend."""
        if '"' in text:
            raise ValueError("phrase queries are not routable; serve "
                             "them through a single-process frontend")
        t0 = time.perf_counter()
        get_registry().incr("router.requests")
        # the cache sits before admission and the fan-out: a hit takes
        # no slot, dials no worker and arms no hedge timer, so the hedge
        # delay's trailing p99 sees only real round trips
        cache_key = self._cache_key(text, k=k, scoring=scoring,
                                    rerank=rerank)
        if cache_key is not None:
            t_lookup = time.perf_counter()
            entry = self.cache.get(cache_key)
            self._observe("cache.lookup", t_lookup)
            if entry is not None:
                res = self._from_cache(entry, return_docids=return_docids)
                self._observe("router.request", t0)
                self._count_served(res)
                disttrace.slo_record(
                    res.level, (time.perf_counter() - t0) * 1e3,
                    classification=self.classify(res))
                self._querylog(text, res, k=k, scoring=scoring,
                               rerank=rerank, t0=t0, cached=True)
                return res
        # the trace is minted here, at admission, the one process that
        # sees the whole request; installed on this thread, the attempts'
        # contexts and the root's keep-or-drop key off it
        ctx = disttrace.mint()
        with disttrace.use(ctx), \
                obs_trace("request", scoring=scoring, router=True) as root:
            try:
                admit = self.admission.admit(
                    queue_timeout_s=self._deadline_s)
                with obs_trace("admission_wait"):
                    admit.__enter__()
            except Overloaded:
                get_registry().incr("router.shed")
                self._observe("router.request", t0)
                root.set("shed", True)
                disttrace.slo_record(
                    "shed", (time.perf_counter() - t0) * 1e3,
                    ok=False, classification="shed")
                raise
            try:
                res = self._route(text, k=k, scoring=scoring,
                                  rerank=rerank)
            except Overloaded:
                # no shard answered: a shed like any other, counted so
                # requests == served_* + shed holds through an outage
                get_registry().incr("router.shed")
                self._observe("router.request", t0)
                root.set("shed", True)
                disttrace.slo_record(
                    "shed", (time.perf_counter() - t0) * 1e3,
                    ok=False, classification="shed")
                raise
            finally:
                admit.__exit__(None, None, None)
            root.set("partial", res.partial)
            root.set("level", res.level)
            root.set("degraded", bool(res.degraded))
            root.set("hedges", int(res.hedges))
        res.trace_id = ctx.trace_id if ctx is not None else None
        if self.cache is not None:
            # the newest generation to win a merge moves the key space
            self.cache.bump_generation(int(res.generation))
            if cache_key is not None and self.classify(res) == "full":
                # only clean full answers are kept, as raw docnos, so one
                # entry serves both docid flavors
                self.cache.put(
                    (cache_key[0], int(res.generation)) + cache_key[2:],
                    {"hits": tuple(res), "shards_ok": res.shards_ok,
                     "generation": int(res.generation),
                     "level": res.level},
                    generation=int(res.generation))
        if return_docids and len(res):
            # the mapping of the generation that answered: another
            # generation's would name the wrong documents
            mapping = self._mapping_loaded(res.generation)
            res[:] = [(mapping.get_docid(int(d)), s) for d, s in res]
        self._observe("router.request", t0)
        self._count_served(res)
        disttrace.slo_record(res.level, (time.perf_counter() - t0) * 1e3,
                             classification=self.classify(res))
        self._querylog(text, res, k=k, scoring=scoring, rerank=rerank,
                       t0=t0)
        return res

    def _cache_key(self, text: str, *, k: int, scoring: str,
                   rerank: int | None) -> tuple | None:
        """The router's exact-hit key, or None (cache off, or glob and
        fuzzy operators, whose expansion depends on the vocabulary). Slot
        1 is the newest generation this router has seen win."""
        from .result_cache import cacheable_text, normalize_terms

        if self.cache is None or not cacheable_text(text):
            return None
        return (normalize_terms(text), self.cache.generation(),
                int(k), scoring, rerank)

    def _from_cache(self, entry: dict, *, return_docids: bool):
        """A SearchResult from a stored full answer: bitwise the miss
        path's (the stored hits are a miss's merge, and a generation's
        docno -> docid mapping is fixed)."""
        from ..search.scorer import SearchResult

        res = SearchResult((int(d), float(s)) for d, s in entry["hits"])
        res.generation = entry["generation"]
        res.level = entry["level"]
        res.shards_ok = tuple(entry["shards_ok"])
        res.missing_shards = ()
        res.partial = False
        res.degraded = False
        res.hedges = 0
        if return_docids and len(res):
            mapping = self._mapping_loaded(res.generation)
            res[:] = [(mapping.get_docid(int(d)), s) for d, s in res]
        return res

    def note_generation(self, generation: int) -> int:
        """Tell the router a newer generation is rolled out (the swap's
        driver calls this once every replica confirmed): the cache's key
        space moves now, not when traffic first meets the new generation.
        Returns the purged entries; 0 without a cache."""
        if self.cache is None:
            return 0
        return self.cache.bump_generation(int(generation))

    def _winning_generation(self, got: dict) -> tuple[int, dict, bool]:
        """Split a fan-out's answers by the generation each named and pick
        the winner: most shards, ties to the newest. Docnos, ranges and
        scores compare only within one generation, so the losers are
        dropped (tagged missing). A generation this router cannot resolve
        is skipped the same way; with none resolvable the request sheds.
        Returns (generation, winning {shard: (answer, hedges)}, mixed)."""
        by_gen: dict[int, dict] = {}
        for s, (d, h) in got.items():
            by_gen.setdefault(int(d.get("generation", 0)), {})[s] = (d, h)
        mixed = len(by_gen) > 1
        for gen in sorted(by_gen, key=lambda g: (len(by_gen[g]), g),
                          reverse=True):
            if self._gen_info(gen) is not None:
                return gen, by_gen[gen], mixed
        raise Overloaded("no_resolvable_generation",
                         queue_depth=self.admission.queue_depth(),
                         level="shed")

    def _route(self, text: str, *, k: int, scoring: str,
               rerank: int | None):
        all_shards = list(range(self.num_shards))
        if rerank:
            return self._route_rerank(text, k=k, candidates=rerank,
                                      shards=all_shards)
        payload = {"text": text, "k": k, "scoring": scoring}
        got = self._fanout("search", lambda s: payload, all_shards)
        if not got:
            get_registry().incr("router.shard_lost", self.num_shards)
            raise Overloaded("no_healthy_shards",
                             queue_depth=self.admission.queue_depth(),
                             level="shed")
        gen, winners, mixed = self._winning_generation(got)
        if mixed:
            get_registry().incr("router.mixed_generation")
        t_merge = time.perf_counter()
        hits = merge_shard_topk(
            [winners[s][0]["hits"] for s in sorted(winners)], k)
        self._observe("router.merge", t_merge)
        return self._assemble(hits, winners, all_shards, gen=gen)

    def _route_rerank(self, text: str, *, k: int, candidates: int,
                      shards: list):
        """The two-phase rerank: BM25 top-C on each shard, the global
        top-C, `cosine_at` on every shard that answered phase 1, the
        top-k in candidate order."""
        p1 = {"text": text, "k": candidates, "scoring": "bm25"}
        got = self._fanout("search", lambda s: p1, shards)
        if not got:
            get_registry().incr("router.shard_lost", self.num_shards)
            raise Overloaded("no_healthy_shards",
                             queue_depth=self.admission.queue_depth(),
                             level="shed")
        gen, winners, mixed = self._winning_generation(got)
        cand_hits = merge_shard_topk(
            [winners[s][0]["hits"] for s in sorted(winners)], candidates)
        # the candidate matrix's width in one process: padded to C with
        # empty slots (docid 0)
        cand = [d for d, _ in cand_hits]
        cand += [0] * (candidates - len(cand))
        p2 = {"text": text, "cand": cand}
        got2 = self._fanout("cosine_at", lambda s: p2, sorted(winners))
        # phase 2 must answer from phase 1's generation: the candidates
        # are that generation's docnos
        got2 = {s: v for s, v in got2.items()
                if int(v[0].get("generation", 0)) == gen}
        if mixed:
            get_registry().incr("router.mixed_generation")
        if not got2:
            get_registry().incr("router.shard_lost", len(got))
            raise Overloaded("no_healthy_shards",
                             queue_depth=self.admission.queue_depth(),
                             level="shed")
        t_merge = time.perf_counter()
        hits = merge_candidate_scores(
            cand, {s: d["scores"] for s, (d, _) in got2.items()},
            self._gen_info(gen)["ranges"], k)
        self._observe("router.merge", t_merge)
        # a shard contributes only if it answered both phases
        merged_meta = {s: winners[s] for s in got2}
        res = self._assemble(hits, merged_meta, shards, gen=gen)
        res.hedges += sum(h for _, h in got2.values())
        return res

    def _assemble(self, hits: list, got: dict, shards: list,
                  gen: int | None = None):
        from ..search.scorer import SearchResult

        gen = self._gen0 if gen is None else gen
        ranges = self._gen_info(gen)["ranges"]
        res = SearchResult((int(d), float(s)) for d, s in hits)
        res.generation = gen
        ok = tuple(sorted(got))
        missing = tuple(s for s in shards if s not in got)
        # a trailing shard past num_docs owns an empty range: its absence
        # loses no document and must not tag the answer
        missing = tuple(s for s in missing
                        if ranges[s][0] <= ranges[s][1])
        res.shards_ok = ok
        res.missing_shards = missing
        res.partial = bool(missing)
        if missing:
            get_registry().incr("router.shard_lost", len(missing))
        res.hedges = sum(h for _, h in got.values())
        res.degraded = any(d.get("degraded") for d, _ in got.values())
        levels = [d.get("level", "full") for d, _ in got.values()]
        res.level = max(levels, key=lambda lv: _LEVEL_ORDER.index(lv)
                        if lv in _LEVEL_ORDER else len(_LEVEL_ORDER))
        return res

    # -- accounting and introspection --------------------------------------

    @staticmethod
    def classify(res) -> str:
        """The routed taxonomy, exactly one of: partial beats degraded
        beats full (a shed raises and never gets here)."""
        if res.partial:
            return "partial"
        if res.degraded or res.level != "full":
            return "degraded"
        return "full"

    def _count_served(self, res) -> None:
        get_registry().incr(f"router.served_{self.classify(res)}")

    @staticmethod
    def _observe(name: str, t0: float) -> None:
        if obs.enabled():
            get_registry().observe(name, time.perf_counter() - t0)

    @staticmethod
    def _querylog(text: str, res, *, k: int, scoring: str,
                  rerank: int | None, t0: float,
                  cached: bool = False) -> None:
        """The routed request's query-log entry (`tpu_ir`'s fields): the
        taxonomy, the whole request's latency, and the trace id that
        joins it to its stitched waterfall."""
        entry = {
            "router": True,
            "cached": cached,
            "query_hash": querylog.query_hash(text.split()),
            "k": k, "scoring": scoring, "rerank": rerank,
            "level": res.level, "degraded": bool(res.degraded),
            "generation": int(res.generation),
            "partial": bool(res.partial),
            "shards_ok": list(res.shards_ok),
            "missing_shards": list(res.missing_shards),
            "hedges": int(res.hedges),
            "total_ms": round((time.perf_counter() - t0) * 1e3, 3),
        }
        if res.trace_id:
            entry["trace_id"] = res.trace_id
        if not querylog.redacted():
            entry["text"] = text
        querylog.record(entry)

    def health_summary(self) -> dict:
        """The fleet view /healthz serves, polled at most once every
        TPU_IR_ROUTER_HEALTH_TTL_S: per shard, each replica's address,
        breaker, lifecycle state (warming, active, draining or retired)
        and its worker's own /healthz identity (shard, replica,
        generations, doc range, kernel launches; a retired replica reads
        down)."""
        with self._health_lock:
            cached = self._health_cache
            if (cached is not None
                    and time.monotonic() - cached[0] < self._health_ttl_s):
                return cached[1]
            if self._health_polling:
                # an in-process worker's /healthz comes back here through
                # the same process: answer shallow, do not recurse
                return {"num_shards": self.num_shards,
                        "in_progress": True}
            self._health_polling = True
        try:
            return self._health_sweep()
        finally:
            with self._health_lock:
                self._health_polling = False

    def _health_sweep(self) -> dict:
        grid = self._full_topology()
        life = None
        if self._lifecycle_fn is not None:
            try:
                life = self._lifecycle_fn()
            except Exception:  # noqa: BLE001 — health must not 500
                life = None
        shards = []
        for s in range(self.num_shards):
            row = grid[s] if s < len(grid) else []
            replicas = []
            for r, addr in enumerate(row):
                item = {"replica": r, "addr": addr,
                        "breaker": self._breaker(s, r).snapshot()}
                if life is not None and s < len(life) \
                        and r < len(life[s]):
                    item["lifecycle"] = life[s][r]
                item.update(self._poll_worker_health(addr))
                replicas.append(item)
            p99 = self._stats[s].p99_s()
            hedge = self._hedge_delay_s(s)
            shards.append({
                "shard": s,
                "doc_range": list(self._ranges[s]),
                "rtt_p99_ms": (round(p99 * 1e3, 3)
                               if p99 is not None else None),
                "hedge_delay_ms": (round(hedge * 1e3, 3)
                                   if hedge != float("inf") else None),
                "replicas": replicas,
            })
        with self._gen_lock:
            gens = sorted(self._gen_infos)
        payload = {"num_shards": self.num_shards,
                   "membership_epoch": (self._epoch_fn()
                                        if self._epoch_fn else None),
                   "hedge_floor_ms": round(self._hedge_floor_s * 1e3, 3),
                   "deadline_ms": round(self._deadline_s * 1e3, 3),
                   # generations seen answering (each worker's own rides
                   # in its replica entry)
                   "generations_seen": gens,
                   "shards": shards}
        if self.cache is not None:
            from .result_cache import cache_counters

            payload["cache"] = {**self.cache.snapshot(),
                                **cache_counters()}
        with self._health_lock:
            self._health_cache = (time.monotonic(), payload)
        return payload

    def _poll_worker_health(self, addr: str | None) -> dict:
        from .shardset import get_worker_health

        if not addr:
            return {"up": False, "error": "no address"}
        try:
            body = get_worker_health(addr, self._connect_s)
        except Exception as e:  # noqa: BLE001 — down is the answer
            return {"up": False, "error": repr(e)}
        return {"up": True,
                "worker": body.get("worker"),
                "ladder": body.get("ladder"),
                "breaker_worker": body.get("breaker"),
                "queue_depth": body.get("queue_depth")}

    def stats(self) -> dict:
        reg = get_registry()
        return {name: reg.get(name)
                for name in reg.counter_names()
                if name.startswith("router.")}

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
