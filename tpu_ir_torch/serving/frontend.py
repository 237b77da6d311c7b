"""The overload-resilient serving frontend: admission control, a
degradation ladder and a circuit breaker around one Scorer (the port of
`tpu_ir/serving/frontend.py`).

    request -> admission control -> degradation ladder -> breaker
               (bounded queue,       (what work this      (device or
                shed past it)         level still does)    host path)

- **Admission** (admission.py): `max_concurrency` running, `max_queue`
  waiting, every other request shed at once with a structured
  `Overloaded`.
- **Ladder**: under queue pressure or repeated dispatch failures the
  frontend steps down full -> no_rerank (the rerank dropped) -> hot_only
  (the tiered hot strip alone; not on the dense layout, which has no
  cheaper stage) -> shed. Each response is tagged with the level that
  produced it. Stepping up needs `recover_successes` calm observations
  in a row (hysteresis).
- **Breaker** (breaker.py): N consecutive device failures open it; while
  open, requests go to the host fallback with no dispatch and no
  deadline wait, with half-open probes to find recovery.
- **Coalescer** (batching.py; `ServingConfig.coalesce`): concurrent
  compatible requests share one padded dispatch, each tagged per slot.
- **Result cache** (result_cache.py; `cache_entries`): exact hits answer
  ahead of admission.

Thread-safe: one frontend is shared by many request threads, and owns
no threads of its own. Not ported here: the health-source registration
of the metrics server, the query log's request context and distributed
tracing (a response's `trace_id` stays None).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass

from .. import obs
from ..obs import trace as obs_trace
from ..utils.report import RecoveryCounters, serving_counters
from .admission import AdmissionController, Overloaded
from .breaker import CircuitBreaker

logger = logging.getLogger(__name__)

# the ladder, strictly decreasing work per request; "shed" stays last
LEVEL_FULL = "full"
LEVEL_NO_RERANK = "no_rerank"
LEVEL_HOT_ONLY = "hot_only"
LEVEL_SHED = "shed"


@dataclass(frozen=True)
class ServingConfig:
    """The frontend's knobs, with the JAX package's defaults."""

    max_concurrency: int = 4       # requests executing at once
    max_queue: int = 16            # requests allowed to wait for a slot
    deadline_s: float | None = None   # per-request device dispatch bound
    queue_timeout_s: float | None = None  # max slot wait (None: deadline_s)
    breaker_threshold: int = 5     # consecutive device failures to open
    breaker_cooldown_s: float = 1.0   # open time before a half-open probe
    step_down_pressure: float = 0.75  # queue occupancy that steps down
    step_up_pressure: float = 0.25    # calm threshold for recovery credit
    fail_threshold: int = 3        # consecutive failures that step down
    recover_successes: int = 16    # calm observations to step up one level
    down_cooldown_s: float = 0.05  # min time between two down-steps
    # the coalescer (batching.py); None defers to the TPU_IR_BATCH_*
    # variables when the frontend is built
    coalesce: bool = False            # coalesce concurrent queries
    coalesce_wait_ms: float | None = None  # promoted-leader linger bound
    batch_ladder: tuple | None = None      # batch-size rungs
    batch_width: int | None = None         # pinned analyzed query width
    precompile: bool = True           # warm the rung ladder at start
    precompile_ks: tuple = (10,)      # k depths the warm-up covers
    # exact-hit result cache entries (result_cache.py); None defers to
    # TPU_IR_CACHE_RESULTS, 0 disables
    cache_entries: int | None = None


class DegradationLadder:
    """Thread-safe service-level state machine with hysteresis.

    Down-steps are fast (pressure at or above `step_down_pressure`, or
    `fail_threshold` consecutive dispatch failures) but at most one per
    `down_cooldown_s`, so one burst cannot jump from full to shed before
    the cheaper levels had a chance. Up-steps need `recover_successes`
    consecutive calm observations (pressure at or below
    `step_up_pressure`, no failure) and move one level at a time."""

    def __init__(self, levels: tuple, cfg: ServingConfig, on_transition,
                 clock=time.monotonic):
        self._levels = tuple(levels)
        self._cfg = cfg
        self._on_transition = on_transition  # (direction, from, to)
        self._clock = clock
        self._lock = threading.Lock()
        self._idx = 0
        self._fails = 0
        self._successes = 0
        self._last_down = -float("inf")

    @property
    def levels(self) -> tuple:
        return self._levels

    def level(self) -> str:
        with self._lock:
            return self._levels[self._idx]

    def observe(self, *, pressure: float, failed: bool) -> None:
        """Feed one completed (or shed) request's signals: the queue
        pressure around it, and whether its dispatch failed (a deadline
        expiry or device loss; sheds and breaker-open host answers are
        not dispatch failures)."""
        cfg = self._cfg
        moved = None
        with self._lock:
            if failed:
                self._fails += 1
                self._successes = 0
            else:
                self._fails = 0
            if (pressure >= cfg.step_down_pressure
                    or self._fails >= cfg.fail_threshold):
                self._successes = 0
                now = self._clock()
                if (self._idx + 1 < len(self._levels)
                        and now - self._last_down >= cfg.down_cooldown_s):
                    moved = ("down", self._levels[self._idx],
                             self._levels[self._idx + 1])
                    self._idx += 1
                    self._fails = 0
                    self._last_down = now
            elif not failed and pressure <= cfg.step_up_pressure:
                self._successes += 1
                if (self._successes >= cfg.recover_successes
                        and self._idx > 0):
                    moved = ("up", self._levels[self._idx],
                             self._levels[self._idx - 1])
                    self._idx -= 1
                    self._successes = 0
        if moved is not None:
            self._on_transition(*moved)

    def snapshot(self) -> dict:
        with self._lock:
            return {"level": self._levels[self._idx],
                    "consecutive_failures": self._fails,
                    "recovery_credit": self._successes}


class ServingFrontend:
    """Thread-safe serving wrapper around one loaded Scorer (dense or
    tiered). Callers' threads run their own requests; concurrency is
    bounded by admission."""

    def __init__(self, scorer, config: ServingConfig | None = None):
        self.config = cfg = config or ServingConfig()
        self.admission = AdmissionController(cfg.max_concurrency,
                                             cfg.max_queue)
        self.breaker = CircuitBreaker(cfg.breaker_threshold,
                                      cfg.breaker_cooldown_s)
        # the dense layout has no hot tier, so no cheaper device stage:
        # its ladder goes from no_rerank straight to shed
        levels = ((LEVEL_FULL, LEVEL_NO_RERANK, LEVEL_HOT_ONLY, LEVEL_SHED)
                  if scorer.layout == "sparse"
                  else (LEVEL_FULL, LEVEL_NO_RERANK, LEVEL_SHED))
        self.ladder = DegradationLadder(levels, cfg, self._on_transition)
        # (scorer, batcher) are published together by one assignment: a
        # request reads the pair once, so a generation swap can never
        # tear it across two scorers
        self._serving = (scorer, self._make_batcher(scorer))
        from .result_cache import ResultCache, resolve_capacity

        cap = resolve_capacity(cfg.cache_entries)
        self.cache = (ResultCache(cap, name="frontend")
                      if cap > 0 else None)
        if self.cache is not None:
            self.cache.bump_generation(scorer.generation)
        self._counters = RecoveryCounters()

    def _make_batcher(self, scorer):
        """The coalescer of one scorer, its rung ladder warmed here, so
        no serving caller pays a shape's first dispatch."""
        cfg = self.config
        if not cfg.coalesce:
            return None
        from .batching import CoalescingScheduler

        batcher = CoalescingScheduler(
            scorer, deadline_s=cfg.deadline_s,
            wait_ms=cfg.coalesce_wait_ms, ladder=cfg.batch_ladder,
            width=cfg.batch_width)
        if cfg.precompile:
            t0 = time.perf_counter()
            batcher.precompile(ks=cfg.precompile_ks)
            obs.get_registry().observe("batch.precompile",
                                       time.perf_counter() - t0)
        return batcher

    @property
    def scorer(self):
        return self._serving[0]

    @property
    def batcher(self):
        return self._serving[1]

    def reload_generation(self, scorer=None, *,
                          generation: int | None = None):
        """Swap serving to a new index generation: take `scorer`, or load
        `generation` (None: the newest servable one) of the serving
        scorer's live dir with its load kwargs, build and warm its
        coalescer, then publish both by one assignment. The load and the
        warm-up run before the publish, outside any lock. Requests in
        flight finish on the scorer they entered with; later ones are
        tagged with the new generation. The result cache is purged of
        the old generation's entries. A scorer not loaded from a live
        dir raises ValueError (Scorer.reload_generation)."""
        t0 = time.perf_counter()
        if scorer is None:
            scorer = self.scorer.reload_generation(generation)
        batcher = self._make_batcher(scorer)
        self._serving = (scorer, batcher)   # the publish
        if self.cache is not None:
            self.cache.bump_generation(scorer.generation)
        self._count("generation_swap")
        reg = obs.get_registry()
        reg.set_gauge("generation.current", scorer.generation)
        reg.observe("generation.swap", time.perf_counter() - t0)
        logger.info("serving swapped to generation %s", scorer.generation)
        return scorer

    # -- accounting --------------------------------------------------------

    def _count(self, name: str, amount: int = 1) -> None:
        """Every event lands in this frontend's counters (the soak checks
        shed + served == submitted per instance) and the process-wide
        serving counters."""
        self._counters.incr(name, amount)
        serving_counters().incr(name, amount)

    def _on_transition(self, direction: str, frm: str, to: str) -> None:
        self._count(f"level_step_{direction}")
        logger.warning("degradation ladder stepped %s: %s -> %s",
                       direction, frm, to)

    @staticmethod
    def _observe_latency(name: str, t0: float) -> None:
        """Record one end-to-end latency; TPU_IR_TRACE=0 turns every
        latency histogram off (counters stay on)."""
        if obs.enabled():
            obs.get_registry().observe(name, time.perf_counter() - t0)

    def stats(self) -> dict:
        """This frontend's counters and control-plane state, one dict."""
        scorer, batcher = self._serving
        out = dict(self._counters.snapshot())
        out["ladder"] = self.ladder.snapshot()
        out["breaker"] = self.breaker.snapshot()
        out["queue_depth"] = self.admission.queue_depth()
        out["in_flight"] = self.admission.in_flight()
        out["generation"] = scorer.generation
        if batcher is not None:
            out["batching"] = batcher.snapshot()
        if self.cache is not None:
            from .result_cache import cache_counters

            out["cache"] = {**self.cache.snapshot(), **cache_counters()}
        return out

    # -- the request path --------------------------------------------------

    def search(self, text: str, *, k: int = 10, scoring: str = "tfidf",
               rerank: int | None = None, snippets: bool = False,
               explain_k: int = 0, return_docids: bool = True):
        """Serve one query. Returns a SearchResult tagged with the
        service level (`level`) and fallback flag (`degraded`) that
        produced it, or raises Overloaded (a structured shed: the request
        was not executed). `rerank`, `snippets` and `explain_k` are what
        the caller wants; the ladder decides what it gets: snippets
        (`SearchResult.snippets`, one a hit) come only at level full and
        on a result that is not degraded, and explain_k rides per slot in
        a coalesced batch. The whole call is one "request" span, and
        its latency lands in the `request.<level>` histogram, sheds
        included (`request.shed` is the time to reject)."""
        t0 = time.perf_counter()
        self._count("submitted")
        # one read of the (scorer, batcher) pair for the whole request
        scorer, batcher = self._serving
        with obs_trace("request", scoring=scoring) as root:
            with obs_trace("ladder") as lsp:
                level = self.ladder.level()
                lsp.set("level", level)
            root.set("level", level)
            if level == LEVEL_SHED:
                self._count("shed_level")
                # sheds are instant, so pressure falls while shedding:
                # these observations let the ladder earn its way back
                self.ladder.observe(pressure=self.admission.pressure(),
                                    failed=False)
                self._observe_latency("request.shed", t0)
                root.set("shed", True)
                raise Overloaded("shed_level",
                                 queue_depth=self.admission.queue_depth(),
                                 level=level)
            cache_key = self._cache_key(scorer, text, k=k,
                                        scoring=scoring, rerank=rerank,
                                        level=level, snippets=snippets,
                                        explain_k=explain_k,
                                        return_docids=return_docids)
            if cache_key is not None:
                t_lookup = time.perf_counter()
                hit = self.cache.get(cache_key)
                self._observe_latency("cache.lookup", t_lookup)
                if hit is not None:
                    from ..search.scorer import SearchResult

                    res = SearchResult(hit)
                    res.level = level
                    res.generation = scorer.generation
                    root.set("cached", True)
                    self._count("served_cache")
                    self._observe_latency(f"request.{level}", t0)
                    return res
            timeout = (self.config.queue_timeout_s
                       if self.config.queue_timeout_s is not None
                       else self.config.deadline_s)
            try:
                # the admission context is entered by hand, so the
                # admission_wait span times the slot wait alone
                admit_cm = self.admission.admit(queue_timeout_s=timeout)
                with obs_trace("admission_wait"):
                    admit_cm.__enter__()
                try:
                    res = self._serve(text, k=k, scoring=scoring,
                                      rerank=rerank, snippets=snippets,
                                      level=level, explain_k=explain_k,
                                      return_docids=return_docids,
                                      scorer=scorer, batcher=batcher)
                finally:
                    admit_cm.__exit__(None, None, None)
                if (cache_key is not None and not res.degraded
                        and not res.partial):
                    # only clean answers are kept; the key's level flags
                    # already limit an entry to requests routed the same
                    self.cache.put(cache_key, tuple(res),
                                   generation=res.generation)
                root.set("degraded", bool(res.degraded))
                self._observe_latency(f"request.{level}", t0)
                return res
            except Overloaded as e:
                # only admission sheds reach here (queue_full or
                # queue_timeout): the strongest pressure signal there is
                self._count(f"shed_{e.reason}")
                self.ladder.observe(pressure=1.0, failed=False)
                self._observe_latency("request.shed", t0)
                root.set("shed", True)
                raise

    def _cache_key(self, scorer, text: str, *, k: int, scoring: str,
                   rerank: int | None, level: str, snippets: bool,
                   explain_k: int, return_docids: bool) -> tuple | None:
        """The exact-hit key of one request, or None when it is not
        cacheable (cache off; phrase, glob or fuzzy text; an explain or
        snippet request, which attaches per-request output; raw docnos).
        The terms are the analyzed id sequence,
        order and repeats kept: the sums follow slot order, so a
        reordered query may have other bits."""
        from .result_cache import cacheable_text

        if (self.cache is None or snippets or explain_k
                or not return_docids or not cacheable_text(text)):
            return None
        row = scorer.analyze_queries([text])[0]
        terms = tuple(int(t) for t in row if t >= 0)
        use_rerank = rerank if level == LEVEL_FULL else None
        return (terms, int(k), scoring, use_rerank,
                level == LEVEL_HOT_ONLY, int(scorer.generation))

    def _serve(self, text: str, *, k: int, scoring: str,
               rerank: int | None, snippets: bool, level: str,
               explain_k: int, return_docids: bool, scorer, batcher):
        with obs_trace("breaker") as bsp:
            allowed, is_probe = self.breaker.allow_device()
            bsp.set("allowed", allowed)
            bsp.set("probe", is_probe)
        force_host = not allowed
        if is_probe:
            self._count("breaker_probes")
        use_rerank = rerank if level == LEVEL_FULL else None
        try:
            if batcher is not None and '"' not in text and return_docids:
                # this request may share a batch-mate's dispatch
                res = batcher.submit(
                    text, k=k, scoring=scoring, rerank=use_rerank,
                    hot_only=(level == LEVEL_HOT_ONLY),
                    force_host=force_host, explain_k=explain_k)
            else:
                res = scorer.search_batch(
                    [text], k=k, scoring=scoring, rerank=use_rerank,
                    deadline_s=self.config.deadline_s,
                    force_host=force_host,
                    hot_only=(level == LEVEL_HOT_ONLY),
                    explain_k=explain_k,
                    return_docids=return_docids)[0]
        except BaseException:
            # not a device verdict (a bad query, a program bug): release
            # any probe slot this request held, so the breaker cannot
            # wedge half-open, and let the error surface
            if not force_host:
                self.breaker.abort(is_probe=is_probe)
            raise
        res.level = level
        res.generation = scorer.generation
        dispatch_failed = False
        # in a coalesced batch one slot votes for the shared dispatch; a
        # probe always votes, to release its slot
        votes = getattr(res, "breaker_vote", True) or is_probe
        if force_host:
            self._count("served_breaker_host")
        else:
            # res.degraded is this request's own outcome: its dispatch
            # expired its deadline or lost the device
            dispatch_failed = res.degraded
            if dispatch_failed:
                if votes and self.breaker.record_failure(
                        is_probe=is_probe):
                    self._count("breaker_opened")
            elif votes:
                self.breaker.record_success(is_probe=is_probe)
        if res.degraded:
            self._count("degraded")
        self._count(f"served_{level}")
        if snippets and level == LEVEL_FULL and not res.degraded:
            res.snippets = [scorer.snippet(text, key,
                                           is_docid=return_docids)
                            for key, _ in res]
        self.ladder.observe(pressure=self.admission.pressure(),
                            failed=dispatch_failed)
        return res
