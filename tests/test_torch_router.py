"""The port's scatter-gather Router on the CPU.

Over in-process port workers (serve_worker behind the port's
MetricsServer) on a static address grid:

- routed top-10s, dense and tiered x TF-IDF and BM25, and the two-phase
  rerank are bitwise the port's single-process Scorer (docnos, float32
  score bits, tie order), and equal `tpu_ir`'s single-process Scorer in
  docnos with scores within rtol 1e-5;
- failover around a dead replica; a whole shard down gives a partial
  answer naming it, equal to the exact merge of the healthy ranges;
  every shard down sheds with Overloaded; a slow replica is beaten by a
  hedge; a breaker opens after `breaker_threshold` failures and probes
  after its cooldown; None slots are never dialed;
- two generations in one fan-out: the winner rule and
  `router.mixed_generation`; a router cache hit is bitwise the miss and
  arms no hedge timer;
- `health_summary()` and /healthz's router block have `tpu_ir`'s keys.

Then the distributed chaos soak over 2 x 2 subprocess workers with a
rolling upgrade (`tpu_ir`'s asserts, the distributed-trace and SLO ones
included), and `serve-bench --shards`: its validation and its JSON keys
against `tpu_ir`'s. The elastic soak (`autoscale=`, `scale_plan=`) is
tests/test_torch_autoscale.py's."""

import gc
import json
import random
import shutil
import socket
import time

import numpy as np
import pytest

from tpu_ir import cli as jax_cli
from tpu_ir.obs.server import health_snapshot as jax_health_snapshot
from tpu_ir.search.scorer import Scorer as JaxScorer
from tpu_ir.serving import Router as JaxRouter
from tpu_ir.serving import RouterConfig as JaxRouterConfig
from tpu_ir.serving import serve_worker as jax_serve_worker

from tpu_ir_torch import cli as port_cli
from tpu_ir_torch import faults, obs
from tpu_ir_torch.index import build_index
from tpu_ir_torch.index.ingest import IngestWriter
from tpu_ir_torch.index.segments import LiveIndex
from tpu_ir_torch.obs.server import MetricsServer, health_snapshot
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.search.layout import shard_doc_ranges
from tpu_ir_torch.serving import (
    Overloaded,
    Router,
    RouterConfig,
    run_distributed_soak,
    serve_worker,
)

RTOL = 1e-5
WORDS = ("salmon fishing river bears honey quick brown fox lazy dog "
         "market investor asset bond stock season rain forest".split())
QUERIES = ["salmon fishing", "bears honey market", "quick",
           "rain forest investor", "dog dog salmon", "nosuchterm",
           "fox market rain w17 w3", "w5 w42", "w101 salmon w7"]
N_DOCS = 600
N_SHARDS = 3
RERANK = 25
# tpu_ir's run_distributed_soak report without autoscaling, tracing on
SOAK_KEYS = {
    "submitted", "served", "shed", "errors", "error_samples", "deadlocked",
    "classes", "partial_fraction", "full_mismatches", "partial_checked",
    "partial_mismatches", "tagged_divergent", "hedged_requests",
    "recovery_probes", "recovery_full", "wall_s", "shards", "replicas",
    "chaos", "generations_served", "unknown_generation", "router",
    "latency", "cache", "burst_p99_ms", "disttrace", "slo"}


@pytest.fixture(autouse=True)
def _clean_port_state():
    faults.clear()
    obs.reset_all()
    yield
    # a closed router must not stay registered with /healthz
    gc.collect()
    faults.clear()
    obs.reset_all()


def _write_corpus(path: str, n: int, seed: int = 0) -> None:
    """Frequent words and a long tail: the tiered layout gets hot rows
    and several df tiers."""
    rng = random.Random(seed)
    with open(path, "w") as f:
        for i in range(n):
            toks = [rng.choice(WORDS) for _ in range(rng.randint(3, 9))]
            toks += [f"w{int(rng.paretovariate(0.8)) % 1500}"
                     for _ in range(rng.randint(1, 4))]
            f.write(f"<DOC>\n<DOCNO> D-{i:05d} </DOCNO>\n<TEXT>\n"
                    f"{' '.join(toks)}\n</TEXT>\n</DOC>\n")


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("router")
    corpus = str(tmp / "c.trec")
    _write_corpus(corpus, N_DOCS)
    out = str(tmp / "idx")
    build_index(corpus, out, num_shards=3, device="cpu")
    return out


@pytest.fixture(scope="module")
def twin_dir(index_dir, tmp_path_factory):
    """A copy without the port's serving cache, for `tpu_ir`."""
    twin = str(tmp_path_factory.mktemp("router_twin") / "idx")
    shutil.copytree(index_dir, twin,
                    ignore=shutil.ignore_patterns("serving-*"))
    return twin


_SCORERS: dict = {}


def _full(index_dir: str, layout: str) -> Scorer:
    key = (index_dir, layout)
    if key not in _SCORERS:
        _SCORERS[key] = Scorer.load(index_dir, layout=layout, device="cpu")
    return _SCORERS[key]


def _jax(twin_dir: str, layout: str) -> JaxScorer:
    key = ("jax", twin_dir, layout)
    if key not in _SCORERS:
        _SCORERS[key] = JaxScorer.load(twin_dir, layout=layout)
    return _SCORERS[key]


def _bits(hits) -> list:
    return [(d if isinstance(d, str) else int(d),
             np.float32(s).tobytes()) for d, s in hits]


def _dead_addr() -> str:
    """An address nothing listens on (a port bound and released)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    return addr


class _Workers:
    """N_SHARDS in-process port workers of one layout; `grid` is one
    replica a shard."""

    def __init__(self, index_dir: str, layout: str, shards: int = N_SHARDS,
                 **kw):
        self.started = [serve_worker(index_dir, s, shards, layout=layout,
                                     warm=False, device="cpu", **kw)
                        for s in range(shards)]
        self.addrs = [f"127.0.0.1:{srv.port}" for srv, _, _ in self.started]
        self.grid = [[a] for a in self.addrs]

    def stop(self) -> None:
        for srv, _, _ in self.started:
            srv.stop()


@pytest.fixture(params=["sparse", "dense"])
def workers(request, index_dir):
    w = _Workers(index_dir, request.param)
    w.layout = request.param
    yield w
    w.stop()


def _fake_worker(hits, sleep_s=0.0, generation=0):
    """A worker stub answering fixed hits, after `sleep_s`."""
    calls = []

    def search(payload):
        calls.append(payload)
        if sleep_s:
            time.sleep(sleep_s)
        return {"hits": hits, "level": "full", "degraded": False,
                "generation": generation}

    return MetricsServer(rpc_handlers={"search": search}).start(), calls


def _assert_same_ranking(want, got) -> None:
    """The same docnos, scores within RTOL; docnos inside a run of
    adjacent reference scores within RTOL compare as a set (the packages
    round such near-ties apart differently), and a run that reaches the
    k-th slot only by its length."""
    want_s = np.array([s for _, s in want], np.float64)
    want_d = [d for d, _ in want]
    got_d = [d for d, _ in got]
    assert len(got_d) == len(want_d)
    np.testing.assert_allclose([s for _, s in got], want_s, rtol=RTOL)
    i = 0
    while i < len(want_d):
        j = i + 1
        while j < len(want_d) and abs(want_s[j] - want_s[j - 1]) <= \
                RTOL * max(abs(want_s[j - 1]), 1e-30):
            j += 1
        if j < len(want_d) or j - i == 1:
            assert set(got_d[i:j]) == set(want_d[i:j]), (i, j)
        i = j


# -- routed answers: bitwise the port, close to tpu_ir ------------------------


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
def test_routed_top10_bitwise_the_port_scorer(index_dir, workers, scoring):
    full = _full(index_dir, workers.layout)
    with Router(index_dir, workers.grid,
                RouterConfig(deadline_ms=30000)) as router:
        for q in QUERIES:
            want = full.search_batch([q], k=10, scoring=scoring,
                                     return_docids=False)[0]
            got = router.search(q, k=10, scoring=scoring,
                                return_docids=False)
            assert Router.classify(got) == "full"
            assert got.shards_ok == tuple(range(N_SHARDS))
            assert got.missing_shards == () and got.generation == 0
            assert _bits(got) == _bits(want), q
            named = router.search(q, k=10, scoring=scoring)
            assert _bits(named) == _bits(full.search_batch(
                [q], k=10, scoring=scoring)[0])
        with pytest.raises(ValueError):
            router.search('"salmon fishing"')
    reg = obs.get_registry()
    assert reg.get("router.requests") == reg.get("router.served_full") \
        == 2 * len(QUERIES)


def test_routed_rerank_bitwise_the_port_scorer(index_dir, workers):
    full = _full(index_dir, workers.layout)
    with Router(index_dir, workers.grid,
                RouterConfig(deadline_ms=30000)) as router:
        for q in QUERIES:
            want = full.search_batch([q], k=10, rerank=RERANK,
                                     return_docids=False)[0]
            got = router.search(q, k=10, rerank=RERANK,
                                return_docids=False)
            assert Router.classify(got) == "full"
            assert _bits(got) == _bits(want), q


@pytest.mark.parametrize("scoring", ["tfidf", "bm25", "rerank"])
def test_routed_answers_equal_jax(index_dir, twin_dir, workers, scoring):
    jax_sc = _jax(twin_dir, workers.layout)
    kw = ({"rerank": RERANK} if scoring == "rerank"
          else {"scoring": scoring})
    with Router(index_dir, workers.grid,
                RouterConfig(deadline_ms=30000)) as router:
        for q in QUERIES:
            want = jax_sc.search_batch([q], k=10, **kw)[0]
            got = router.search(q, k=10, **kw)
            _assert_same_ranking(list(want), list(got))


# -- failures: failover, partial, shed, hedge, breaker, placeholders ----------


def test_failover_around_a_dead_replica(index_dir):
    w = _Workers(index_dir, "sparse")
    full = _full(index_dir, "sparse")
    grid = [[a] for a in w.addrs[:2]] + [[_dead_addr(), w.addrs[2]]]
    try:
        with Router(index_dir, grid,
                    RouterConfig(deadline_ms=30000)) as router:
            for q in QUERIES[:4]:
                # the dead replica first, until its breaker opens
                router._stats[2]._cursor = len(grid[2]) - 1
                got = router.search(q, k=10, scoring="bm25",
                                    return_docids=False)
                assert Router.classify(got) == "full", q
                assert _bits(got) == _bits(full.search_batch(
                    [q], k=10, scoring="bm25", return_docids=False)[0])
    finally:
        w.stop()
    reg = obs.get_registry()
    # the breaker opened at its third failure; then the dead replica
    # goes last and the live one answers first
    assert reg.get("router.replica_failed") == 3
    assert reg.get("router.breaker_opened") == 1
    assert reg.get("router.served_full") == 4


@pytest.mark.parametrize("lost", range(N_SHARDS))
def test_a_lost_shard_gives_the_healthy_ranges_merge(index_dir, lost):
    w = _Workers(index_dir, "sparse")
    full = _full(index_dir, "sparse")
    ranges = shard_doc_ranges(full.meta.num_docs, N_SHARDS)
    grid = [[_dead_addr()] if s == lost else row
            for s, row in enumerate(w.grid)]
    try:
        with Router(index_dir, grid,
                    RouterConfig(deadline_ms=30000)) as router:
            for q in QUERIES[:5]:
                got = router.search(q, k=10, scoring="bm25",
                                    return_docids=False)
                assert Router.classify(got) == "partial"
                assert got.missing_shards == (lost,)
                assert got.shards_ok == tuple(
                    s for s in range(N_SHARDS) if s != lost)
                rank = full.search_batch([q], k=full.meta.num_docs,
                                         scoring="bm25",
                                         return_docids=False)[0]
                ok = [rg for s, rg in enumerate(ranges) if s != lost]
                want = [(d, s) for d, s in rank
                        if any(lo <= d <= hi for lo, hi in ok)][:10]
                assert _bits(got) == _bits(want), q
    finally:
        w.stop()
    reg = obs.get_registry()
    assert reg.get("router.served_partial") == 5
    assert reg.get("router.shard_lost") == 5


def test_every_shard_down_sheds(index_dir):
    grid = [[_dead_addr()], [_dead_addr()]]
    with Router(index_dir, grid, RouterConfig(deadline_ms=2000)) as router:
        for _ in range(2):
            with pytest.raises(Overloaded) as ei:
                router.search("salmon", k=5)
            assert ei.value.reason == "no_healthy_shards"
    reg = obs.get_registry()
    assert reg.get("router.shed") == reg.get("router.requests") == 2
    assert reg.get("router.shard_lost") == 4


def test_a_hedge_beats_a_slow_replica(index_dir):
    slow, _ = _fake_worker([[1, 3.0]], sleep_s=1.5)
    fast, fast_calls = _fake_worker([[1, 3.0]])
    try:
        with Router(index_dir, [[f"127.0.0.1:{slow.port}",
                                 f"127.0.0.1:{fast.port}"]],
                    RouterConfig(deadline_ms=10000,
                                 hedge_ms=60.0)) as router:
            router._stats[0]._cursor = 1  # the slow replica goes first
            t0 = time.perf_counter()
            res = router.search("whatever", k=5, return_docids=False)
            elapsed = time.perf_counter() - t0
            assert list(res) == [(1, 3.0)]
            assert res.hedges == 1 and fast_calls
            assert elapsed < 1.2
    finally:
        slow.stop()
        fast.stop()
    reg = obs.get_registry()
    assert reg.get("router.hedge_fired") == reg.get("router.hedge_won") == 1


def test_a_breaker_opens_and_probes(index_dir):
    state = {"fail": True}

    def search(payload):
        if state["fail"]:
            raise RuntimeError("injected worker failure")
        return {"hits": [[2, 1.0]], "level": "full", "degraded": False}

    srv = MetricsServer(rpc_handlers={"search": search}).start()
    try:
        with Router(index_dir, [[f"127.0.0.1:{srv.port}"]],
                    RouterConfig(deadline_ms=2000, breaker_threshold=2,
                                 breaker_cooldown_s=0.5)) as router:
            for _ in range(3):
                with pytest.raises(Overloaded):
                    router.search("q", k=5)
            assert router._breaker(0, 0).state == "open"
            # while open and cooling down, the replica is not dialed
            assert obs.get_registry().get("router.replica_failed") == 2
            state["fail"] = False
            time.sleep(0.6)  # past the cooldown: the next try probes
            res = router.search("q", k=5, return_docids=False)
            assert list(res) == [(2, 1.0)]
            assert router._breaker(0, 0).state == "closed"
    finally:
        srv.stop()
    assert obs.get_registry().get("router.breaker_opened") == 1


def test_none_slots_are_never_dialed(index_dir):
    srv, calls = _fake_worker([[5, 2.0]])
    try:
        with Router(index_dir, [[None, f"127.0.0.1:{srv.port}", None]],
                    RouterConfig(deadline_ms=5000)) as router:
            for _ in range(3):
                res = router.search("q", k=5, return_docids=False)
                assert Router.classify(res) == "full"
                assert list(res) == [(5, 2.0)]
            assert len(calls) == 3
            h = router.health_summary()
            reps = h["shards"][0]["replicas"]
            assert [r["up"] for r in reps] == [False, True, False]
            assert reps[0]["error"] == "no address"
    finally:
        srv.stop()


@pytest.mark.parametrize("case", ["refused", "shed", "error", "route"])
def test_rpc_post_names_each_failure(case):
    """The one RPC client raises a class a failure: the connect refused,
    a shed (503 with its reason and level), another status."""
    from tpu_ir_torch.serving.shardset import (
        RPCConnectError,
        RPCShedError,
        RPCStatusError,
        rpc_post,
    )

    def search(payload):
        if case == "shed":
            raise Overloaded("queue_full", queue_depth=2, level="no_rerank")
        raise RuntimeError("injected worker failure")

    if case == "refused":
        with pytest.raises(RPCConnectError):
            rpc_post(_dead_addr(), "search", {}, 5.0, connect_timeout_s=0.5)
        return
    with MetricsServer(rpc_handlers={"search": search}) as srv:
        path = "nope" if case == "route" else "search"
        with pytest.raises(RPCStatusError) as ei:
            rpc_post(f"127.0.0.1:{srv.port}", path, {}, 5.0,
                     connect_timeout_s=0.5)
    err = ei.value
    assert err.status == {"shed": 503, "error": 500, "route": 404}[case]
    assert isinstance(err, RPCShedError) == (case == "shed")
    if case == "shed":
        assert (err.reason, err.level) == ("queue_full", "no_rerank")


# -- generations and the cache -----------------------------------------------


@pytest.mark.parametrize("gens,winner,missing", [
    ((5, 0, 0), 0, (0,)),          # most shards win
    ((5, 5, 0), 5, (2,)),
    ((3, 7, 3), 3, (1,)),
    ((2, 9), 9, (0,)),             # a tie goes to the newer generation
    ((4, 4, 4), 4, ()),            # one generation: not mixed
])
def test_the_winning_generation(index_dir, gens, winner, missing):
    fakes = [_fake_worker([[1 + s, 1.0 + s]], generation=g)
             for s, g in enumerate(gens)]
    try:
        with Router(index_dir, [[f"127.0.0.1:{srv.port}"]
                                for srv, _ in fakes],
                    RouterConfig(deadline_ms=5000)) as router:
            res = router.search("q", k=5, return_docids=False)
    finally:
        for srv, _ in fakes:
            srv.stop()
    assert res.generation == winner
    assert res.missing_shards == missing
    assert res.partial == bool(missing)
    assert sorted(d for d, _ in res) == [1 + s for s, g in enumerate(gens)
                                         if g == winner]
    assert obs.get_registry().get("router.mixed_generation") == int(
        len(set(gens)) > 1)


@pytest.fixture(scope="module")
def live_dir(tmp_path_factory):
    """Generation A (60 docs) and B (A with 5 replaced and 10 added)."""
    live = str(tmp_path_factory.mktemp("rlive") / "live")
    LiveIndex.create(live, num_shards=2, chargram_ks=())
    rng = random.Random(3)

    def text():
        return " ".join([rng.choice(WORDS) for _ in range(
            rng.randint(3, 7))] + [f"w{rng.randint(0, 30)}"])

    with IngestWriter(live, auto_merge=False, device="cpu") as w:
        for i in range(60):
            w.add(f"D-{i:03d}", text())
        w.compact_all()
    gen_a = LiveIndex.open(live).current_gen()
    with IngestWriter(live, auto_merge=False, device="cpu") as w:
        for i in range(5):
            w.update(f"D-{i:03d}", text())
        for i in range(10):
            w.add(f"N-{i:03d}", text())
        w.compact_all()
    gen_b = LiveIndex.open(live).current_gen()
    return live, gen_a, gen_b


def test_a_two_generation_fleet_merges_only_the_winner(live_dir):
    """Shard 0 on A, shard 1 on B: B wins the tie, shard 0 is missing,
    and the answer is B's exact merge of shard 1's range, named through
    B's docnos. An unresolvable generation is skipped; with none left the
    request sheds."""
    live, gen_a, gen_b = live_dir
    started = [serve_worker(live, s, 2, index_generation=g, warm=False,
                            device="cpu")
               for s, g in ((0, gen_a), (1, gen_b))]
    b = Scorer.load_generation(live, gen_b, layout="sparse", device="cpu")
    ranges_b = shard_doc_ranges(b.meta.num_docs, 2)
    grid = [[f"127.0.0.1:{srv.port}"] for srv, _, _ in started]
    try:
        with Router(live, grid, RouterConfig(deadline_ms=10000)) as router:
            for n, q in enumerate(["salmon fishing", "quick w3",
                                   "river bears"], 1):
                got = router.search(q, k=10, scoring="bm25")
                assert got.generation == gen_b and got.partial
                assert got.missing_shards == (0,)
                rank = b.search_batch([q], k=b.meta.num_docs,
                                      scoring="bm25",
                                      return_docids=False)[0]
                lo, hi = ranges_b[1]
                want = [(b.mapping.get_docid(int(d)), s) for d, s in rank
                        if lo <= d <= hi][:10]
                assert _bits(got) == _bits(want)
                assert obs.get_registry().get(
                    "router.mixed_generation") == n
    finally:
        for srv, _, _ in started:
            srv.stop()
    fake, _ = _fake_worker([[1, 1.0]], generation=10_000)
    try:
        with Router(live, [[f"127.0.0.1:{fake.port}"]],
                    RouterConfig(deadline_ms=5000)) as router:
            with pytest.raises(Overloaded) as ei:
                router.search("q", k=5)
            assert ei.value.reason == "no_resolvable_generation"
    finally:
        fake.stop()


def test_a_cache_hit_is_the_miss_and_arms_no_hedge(index_dir):
    slow, calls = _fake_worker([[3, 2.0], [1, 1.0]], sleep_s=0.4)
    fast, fast_calls = _fake_worker([[3, 2.0], [1, 1.0]])
    reg = obs.get_registry()
    try:
        with Router(index_dir, [[f"127.0.0.1:{slow.port}",
                                 f"127.0.0.1:{fast.port}"]],
                    RouterConfig(deadline_ms=10000, hedge_ms=50.0,
                                 cache_entries=16)) as router:
            router._stats[0]._cursor = 1  # the slow replica goes first
            miss = router.search("whatever  words", k=5,
                                 return_docids=False)
            assert reg.get("router.hedge_fired") == 1 and miss.hedges == 1
            dialed = len(calls) + len(fast_calls)
            hit = router.search("whatever words", k=5, return_docids=False)
            assert reg.get("router.hedge_fired") == 1 and hit.hedges == 0
            assert len(calls) + len(fast_calls) == dialed
            assert _bits(hit) == _bits(miss)
            assert reg.get("cache.hit") == 1 and reg.get("cache.miss") == 1
            assert reg.get("router.served_full") == 2
    finally:
        slow.stop()
        fast.stop()


def test_a_cache_hit_is_bitwise_the_miss_on_real_workers(index_dir):
    w = _Workers(index_dir, "dense")
    try:
        with Router(index_dir, w.grid,
                    RouterConfig(deadline_ms=30000,
                                 cache_entries=64)) as router:
            for q in QUERIES:
                for kw in ({"scoring": "tfidf"}, {"rerank": RERANK}):
                    miss = router.search(q, k=10, **kw)
                    hit = router.search(q, k=10, **kw)
                    raw = router.search(q, k=10, return_docids=False, **kw)
                    assert _bits(hit) == _bits(miss)
                    assert [s for _, s in raw] == [s for _, s in miss]
            assert obs.get_registry().get("cache.hit") == 4 * len(QUERIES)
            assert router.note_generation(1) == 2 * len(QUERIES)
            assert obs.get_registry().get("cache.stale_generation") == \
                2 * len(QUERIES)
    finally:
        w.stop()


# -- health ---------------------------------------------------------------


def _keys(d: dict) -> set:
    return set(d)


def test_health_keys_equal_jax(index_dir, twin_dir):
    """The router's health_summary, its shard and replica entries, and
    /healthz with a router and an autoscaler live, against `tpu_ir`'s
    over its own workers (the worker identity adds the port's
    kernel_launches and warm_launches)."""
    from tpu_ir.serving import Autoscaler as JaxAutoscaler
    from tpu_ir_torch.serving import Autoscaler

    port_w = _Workers(index_dir, "sparse", shards=2)
    jax_started = [jax_serve_worker(twin_dir, s, 2, layout="sparse",
                                    warm=False) for s in range(2)]
    jax_grid = [[f"127.0.0.1:{srv.port}"] for srv, _, _ in jax_started]
    try:
        with Router(index_dir, port_w.grid,
                    RouterConfig(deadline_ms=30000, cache_entries=8,
                                 health_ttl_s=0.0)) as router, \
                JaxRouter(twin_dir, jax_grid,
                          JaxRouterConfig(deadline_ms=30000, cache_entries=8,
                                          health_ttl_s=0.0)) as jrouter:
            router.search("salmon fishing", k=10)
            jrouter.search("salmon fishing", k=10)
            got, want = router.health_summary(), jrouter.health_summary()
            assert _keys(got) == _keys(want)
            assert got["num_shards"] == want["num_shards"] == 2
            assert got["generations_seen"] == want["generations_seen"]
            assert got["membership_epoch"] is want["membership_epoch"] \
                is None
            assert _keys(got["cache"]) == _keys(want["cache"])
            for gs, ws in zip(got["shards"], want["shards"]):
                assert _keys(gs) == _keys(ws)
                assert gs["doc_range"] == ws["doc_range"]
                for gr, wr in zip(gs["replicas"], ws["replicas"]):
                    assert _keys(gr) == _keys(wr)
                    assert gr["up"] is wr["up"] is True
                    assert _keys(gr["breaker"]) == _keys(wr["breaker"])
                    assert _keys(gr["worker"]) == _keys(wr["worker"]) | {
                        "kernel_launches", "warm_launches"}
            # an autoscaler over each router's static grid (no fleet to
            # grow: the section is what /healthz shows of one)
            fleet = _StaticFleet(port_w.grid)
            jfleet = _StaticFleet(jax_grid)
            scaler = Autoscaler(fleet, router)
            jscaler = JaxAutoscaler(jfleet, jrouter)
            scaler.tick()
            jscaler.tick()
            snap, jsnap = health_snapshot(), jax_health_snapshot()
            assert "shards" in snap and "shards" in jsnap
            assert _keys(snap["shards"]) == _keys(jsnap["shards"])
            assert _keys(snap) == _keys(jsnap)
            assert "autoscaler" in snap and "autoscaler" in jsnap
            assert _keys(snap["autoscaler"]) == _keys(jsnap["autoscaler"])
            assert _keys(snap["autoscaler"]["last_decision"]) == _keys(
                jsnap["autoscaler"]["last_decision"])
            assert snap["autoscaler"]["lifecycle"] == jsnap["autoscaler"][
                "lifecycle"] == [["active"], ["active"]]
            del scaler, jscaler
            assert set(router.stats()) == set(jrouter.stats())
    finally:
        port_w.stop()
        for srv, _, _ in jax_started:
            srv.stop()


class _StaticFleet:
    """A static grid's membership views, as an Autoscaler reads them."""

    max_concurrency = 4

    def __init__(self, grid):
        self._grid = grid

    def lifecycle(self):
        return [["active"] * len(row) for row in self._grid]

    def epoch(self):
        return 0

    def events(self):
        return []

    def active_replicas(self, shard=None):
        counts = [len(row) for row in self._grid]
        return counts[shard] if shard is not None else min(counts)


# -- the distributed chaos soak ----------------------------------------------


@pytest.fixture(scope="module")
def soak_live(tmp_path_factory):
    live = str(tmp_path_factory.mktemp("soak") / "live")
    LiveIndex.create(live, num_shards=2, chargram_ks=())
    rng = random.Random(2)
    with IngestWriter(live, auto_merge=False, device="cpu") as w:
        for i in range(80):
            toks = [rng.choice(WORDS) for _ in range(rng.randint(3, 7))]
            w.add(f"D-{i:03d}", " ".join(toks + [f"w{rng.randint(0, 40)}"]))
        w.compact_all()
    return live


def test_distributed_chaos_soak(soak_live, tmp_path):
    """tpu_ir's test_distributed_chaos_soak over 2 x 2 subprocess port
    workers, with a rolling upgrade to a generation B while the last
    shard is down (the walk skips the dead replicas, which respawn on
    B): conservation, the taxonomy, partial answers with no mismatch, no
    full mismatch, the kills respawned, every recovery probe full and on
    B, no answer from A late after the walk; every served answer's trace
    stitched in the right shape, none of the tail's missing, the trace
    bookkeeping within 5% of a mean request (1% with tracing off),
    every served request in the SLO windows; the router's query log an
    entry a served request with its answer's trace id, and the soak's
    job succeeded at 100%."""
    gen_a = LiveIndex.open(soak_live).current_gen()
    report = run_distributed_soak(
        soak_live, shards=2, replicas=2, threads=6, queries=100, seed=0,
        rundir=str(tmp_path / "run"), worker_deadline_s=3.0,
        router_config=RouterConfig(deadline_ms=8000.0, max_concurrency=16,
                                   max_queue=128),
        recovery_timeout_s=120.0, upgrade_at=0.6, device="cpu")
    assert set(report) == SOAK_KEYS | {"upgrade"}
    assert report["served"] + report["shed"] == report["submitted"]
    assert report["errors"] == 0, report["error_samples"]
    assert report["deadlocked"] == 0
    assert report["shed"] <= max(4, report["submitted"] // 8), report
    assert sum(report["classes"].values()) == report["served"]
    assert report["classes"]["partial"] > 0
    assert report["partial_fraction"] > 0
    assert report["partial_checked"] > 0
    assert report["partial_mismatches"] == 0
    assert report["classes"]["full"] > 0
    assert report["full_mismatches"] == 0
    assert report["router"]["router.worker_respawn"] >= 3
    assert report["recovery_full"] == report["recovery_probes"]
    assert report["latency"]["router.request"]["count"] > 0
    assert report["latency"]["router.shard_rtt"]["count"] > 0
    up = report["upgrade"]
    assert up["generation_a"] == gen_a and up["generation_b"] > gen_a
    assert up["late_old_generation"] == 0
    assert report["unknown_generation"] == 0
    assert up["swap"]["swapped"] and up["swap_done_at_request"] is not None
    assert set(report["generations_served"]) <= {str(gen_a),
                                                 str(up["generation_b"])}
    assert report["generations_served"].get(str(up["generation_b"]), 0) > 0
    dt = report["disttrace"]
    assert dt["traced"] > 0
    assert dt["violations"] == 0, dt["violation_samples"]
    assert dt["tail_missing"] == 0
    assert dt["mean_spans"] >= 3  # the root and an attempt a shard at least
    assert dt["overhead"]["enabled_overhead_fraction"] <= 0.05
    assert dt["overhead"]["disabled_overhead_fraction"] <= 0.01
    slo = report["slo"]
    assert slo["good"] + slo["bad"] >= report["served"]
    # the routed requests' entries come last, the recovery probes' too:
    # the ring (256) holds them all at this size
    routed = [e for e in obs.querylog.recent() if e.get("router")]
    assert len(routed) >= report["served"]
    tids = [e.get("trace_id") for e in routed]
    assert all(tids) and len(set(tids)) == len(tids)
    assert {e["level"] for e in routed} <= {"full", "no_rerank", "hot_only"}
    (job,) = [j.to_dict() for j in obs.progress.jobs() if j.kind == "soak"]
    assert job["name"] == "routed-soak-100q-2s2r"
    assert job["state"] == "succeeded" and job["percent"] == 100.0
    assert [p["phase"] for p in job["phases"]] == ["reference", "serve",
                                                   "recovery"]


# -- serve-bench --shards -----------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--shards", "0"], ["--shards", "2", "--replicas", "0"],
    ["--shards", "2", "--layout", "sharded"],
    ["--shards", "2", "--workload", "zipf", "--skew", "-1"],
    ["--shards", "2", "--workload", "zipf", "--skew", ","],
    ["--workload", "zipf", "--skew", "0,1.1"],
    ["--workload", "zipf", "--concurrency", "1,4"],
], ids=["shards0", "replicas0", "sharded", "skew-neg", "skew-empty",
        "multi-skew-single", "sweep-zipf"])
def test_serve_bench_validation_equals_jax(index_dir, twin_dir, argv,
                                           capsys):
    got = port_cli.main(["serve-bench", index_dir, "--device", "cpu",
                         *argv])
    got_err = capsys.readouterr().err
    want = jax_cli.main(["serve-bench", twin_dir, "--backend", "cpu",
                         *argv])
    want_err = capsys.readouterr().err
    assert got == want == 2
    assert got_err.strip() == want_err.strip()


def _canned_soak(calls: list, report: dict):
    def soak(index_dir, **kw):
        calls.append(kw)
        return json.loads(json.dumps(report))
    return soak


def test_serve_bench_shards_json_equals_jax(index_dir, twin_dir, capsys,
                                            monkeypatch):
    """One real routed serve-bench (2 x 1 workers, no chaos); then both
    packages' routed serve-bench over that report canned, one level and
    three: the same JSON keys, the same history row but its backend, and
    `history` null in the port."""
    import tpu_ir.obs.bench_check as jax_bench_check
    import tpu_ir.serving as jax_serving
    import tpu_ir_torch.serving as port_serving

    assert port_cli.main(["serve-bench", index_dir, "--device", "cpu",
                          "--shards", "2", "--queries", "24", "--threads",
                          "4"]) == 0
    real = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert real["history"] is None
    assert set(real) == SOAK_KEYS | {"history", "history_row"}
    assert real["served"] + real["shed"] == real["submitted"] == 24
    assert real["history_row"]["config"] == "serve_routed-24q-s2r1"
    assert real["history_row"]["backend"] == "cpu"
    report = {k: v for k, v in real.items()
              if k not in ("history", "history_row")}
    monkeypatch.setattr(jax_bench_check, "append_history_row",
                        lambda row: None)
    for extra in ([], ["--workload", "zipf", "--skew", "0,0.7,1.1",
                       "--chaos", "--cache", "8", "--replicas", "2"]):
        port_calls, jax_calls = [], []
        monkeypatch.setattr(port_serving, "run_distributed_soak",
                            _canned_soak(port_calls, report))
        monkeypatch.setattr(jax_serving, "run_distributed_soak",
                            _canned_soak(jax_calls, report))
        assert port_cli.main(["serve-bench", index_dir, "--device", "cpu",
                              "--shards", "2", *extra]) == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert jax_cli.main(["serve-bench", twin_dir, "--backend", "cpu",
                             "--shards", "2", *extra]) == 0
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(got) == set(want)
        runs = got.get("runs", [got])
        jruns = want.get("runs", [want])
        assert len(runs) == len(jruns) == (3 if extra else 1)
        assert got.get("levels") == want.get("levels")
        for g, w in zip(runs, jruns):
            assert g["history"] is None
            assert {k: v for k, v in g["history_row"].items()
                    if k != "backend"} == {
                k: v for k, v in w["history_row"].items() if k != "backend"}
        # each soak was asked for the same run, the port's on its device
        for pc, jc in zip(port_calls, jax_calls):
            assert pc.pop("device") == "cpu"
            assert pc["flight_dir"] is jc["flight_dir"] is None
            assert pc["autoscale"] is jc["autoscale"] is False
            assert pc == jc
