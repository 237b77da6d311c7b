"""The port's serving tier (tpu_ir_torch.serving, faults, obs) on the CPU:
admission control, the circuit breaker, the degradation ladder, the
frontend's level tagging, shedding and recovery, the open breaker's
speed against the deadline, the probe that closes it, the soaks with and
without chaos, and `serve-bench` through the CLI (soak and sweep), which
must leave BENCH_HISTORY.jsonl as it was.

Held against `tpu_ir` on the same index: the frontend at level full
(same doc ids, scores within rtol 1e-5), the host fallback `_topk_host`
(bitwise: both are numpy float32), the hot-only top-k (same doc sets,
rtol 1e-5) and `analyze_queries(width_floor=8)` (exact)."""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tpu_ir.lint import ordered_lock
from tpu_ir.search import Scorer as JaxScorer
from tpu_ir.serving import ServingConfig as JaxServingConfig
from tpu_ir.serving import ServingFrontend as JaxServingFrontend

import tpu_ir_torch.faults as faults
from tpu_ir_torch import obs
from tpu_ir_torch.index import build_index
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.serving import (
    LEVEL_FULL,
    LEVEL_HOT_ONLY,
    LEVEL_NO_RERANK,
    LEVEL_SHED,
    AdmissionController,
    CircuitBreaker,
    DegradationLadder,
    Overloaded,
    ServingConfig,
    ServingFrontend,
    run_soak,
)
from tpu_ir_torch.utils.report import recovery_counters, serving_counters

RTOL = 1e-5
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WORDS = ("salmon fishing river bears honey quick brown fox lazy dog "
         "market investor asset bond stock season rain forest".split())


@pytest.fixture(autouse=True)
def _clean_port_state():
    """The port's registry, counters and fault plan start and end clean
    (the suite's conftest resets only tpu_ir's)."""
    faults.clear()
    obs.reset_all()
    yield
    faults.clear()
    faults.drain_abandoned(timeout_s=10.0)
    obs.reset_all()


@pytest.fixture(autouse=True)
def _ordered_locks(monkeypatch):
    """Every lock the port creates during a test is an order-checked one:
    two locks ever taken in both orders fail the test."""
    graph = ordered_lock.install(monkeypatch, strict=True)
    yield
    assert not graph.inversions, "; ".join(graph.inversions)


def write_corpus(path, n_docs=120):
    """`n_docs` docs over WORDS; "common" in two docs of three is the
    hot strip's one row."""
    body = []
    for i in range(n_docs):
        text = ("common " if i % 3 else "") + " ".join(
            WORDS[(i + j) % len(WORDS)] for j in range(3 + (i % 7)))
        body.append(f"<DOC>\n<DOCNO> D-{i:04d} </DOCNO>\n<TEXT>\n"
                    f"{text}\n</TEXT>\n</DOC>\n")
    path.write_text("".join(body))
    return str(path)


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serving")
    corpus = write_corpus(tmp / "corpus.trec")
    out = str(tmp / "idx")
    build_index(corpus, out, num_shards=3, device="cpu")
    return out


@pytest.fixture(scope="module")
def scorer(index_dir):
    return Scorer.load(index_dir, layout="sparse", device="cpu")


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def test_admission_sheds_past_queue_capacity():
    adm = AdmissionController(max_concurrency=1, max_queue=1)
    release, holding, waiting = (threading.Event() for _ in range(3))

    def holder():
        with adm.admit():
            holding.set()
            release.wait(10)

    def waiter():
        waiting.set()
        with adm.admit(queue_timeout_s=10):
            pass

    threads = [threading.Thread(target=holder, daemon=True)]
    threads[0].start()
    assert holding.wait(5)
    threads.append(threading.Thread(target=waiter, daemon=True))
    threads[1].start()
    assert waiting.wait(5)
    deadline = time.monotonic() + 5
    while adm.queue_depth() < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert adm.queue_depth() == 1 and adm.pressure() == 1.0
    t0 = time.perf_counter()
    with pytest.raises(Overloaded) as ei:
        with adm.admit():
            pass
    assert time.perf_counter() - t0 < 0.5, "shed was not immediate"
    assert ei.value.reason == "queue_full" and ei.value.queue_depth == 1
    release.set()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert adm.queue_depth() == 0 and adm.pressure() == 0.0


def test_admission_zero_queue_executes_and_times_out():
    adm = AdmissionController(max_concurrency=2, max_queue=0)
    with adm.admit():
        assert adm.queue_depth() == 0 and adm.in_flight() == 1
        with adm.admit():
            with pytest.raises(Overloaded) as ei:
                with adm.admit():
                    pass
            assert ei.value.reason == "queue_full"
    adm = AdmissionController(max_concurrency=1, max_queue=4)
    with adm.admit():
        with pytest.raises(Overloaded) as ei:
            with adm.admit(queue_timeout_s=0.05):
                pass
        assert ei.value.reason == "queue_timeout"


# ---------------------------------------------------------------------------
# circuit breaker and degradation ladder
# ---------------------------------------------------------------------------


def test_breaker_state_machine_with_probes():
    clock = {"t": 0.0}
    br = CircuitBreaker(failure_threshold=3, cooldown_s=1.0,
                        clock=lambda: clock["t"])
    for _ in range(2):
        assert br.allow_device() == (True, False)
        assert not br.record_failure()
    assert br.record_failure() and br.state == "open"
    assert br.allow_device() == (False, False)
    clock["t"] = 1.5
    assert br.allow_device() == (True, True)
    assert br.state == "half_open"
    assert br.allow_device() == (False, False)   # one probe at a time
    br.record_success(is_probe=False)            # a stale verdict
    assert br.state == "half_open"
    assert br.record_failure(is_probe=True) and br.state == "open"
    clock["t"] = 3.0
    assert br.allow_device() == (True, True)
    br.abort(is_probe=True)                      # died without a verdict
    assert br.state == "open"
    clock["t"] = 4.5
    assert br.allow_device() == (True, True)
    br.record_success(is_probe=True)
    assert br.state == "closed" and br.allow_device() == (True, False)
    snap = br.snapshot()
    assert snap["opened_count"] == 2 and snap["probe_count"] == 3


def test_ladder_steps_down_up_with_hysteresis():
    clock = {"t": 0.0}
    moves = []
    cfg = ServingConfig(fail_threshold=2, recover_successes=3,
                        down_cooldown_s=1.0)
    ladder = DegradationLadder(("full", "no_rerank", "shed"), cfg,
                               lambda *m: moves.append(m),
                               clock=lambda: clock["t"])
    ladder.observe(pressure=0.0, failed=True)
    assert ladder.level() == "full"
    ladder.observe(pressure=0.0, failed=True)
    assert ladder.level() == "no_rerank"
    ladder.observe(pressure=1.0, failed=False)   # inside the cooldown
    assert ladder.level() == "no_rerank"
    clock["t"] = 2.0
    ladder.observe(pressure=1.0, failed=False)
    assert ladder.level() == "shed"
    for _ in range(3):
        ladder.observe(pressure=0.0, failed=False)
    assert ladder.level() == "no_rerank"
    ladder.observe(pressure=0.5, failed=False)   # no credit
    for _ in range(3):
        ladder.observe(pressure=0.0, failed=False)
    assert ladder.level() == "full"
    assert [m[0] for m in moves] == ["down", "down", "up", "up"]


# ---------------------------------------------------------------------------
# the fault plan and the deadline
# ---------------------------------------------------------------------------


def test_fault_plan_grammar_and_device_loss_tags(monkeypatch):
    plan = faults.parse_plan("score.hang:p=0.12:sleep=0.6,"
                             "score.device_loss:once@2,seed=7")
    assert plan.seed == 7
    (hang,), (loss,) = plan.specs["score.hang"], plan.specs[
        "score.device_loss"]
    assert (hang.mode, hang.arg, hang.sleep_s) == ("prob", 0.12, 0.6)
    assert (loss.mode, loss.arg) == ("once", 2.0)
    assert [plan.should_fire("score.device_loss") is not None
            for _ in range(3)] == [False, True, False]
    assert obs.get_registry().get("fault.score.device_loss") == 1
    monkeypatch.setenv("TPU_IR_FAULTS", "score.hang:sleep=0.01")
    faults.clear()
    assert faults.active().specs["score.hang"][0].mode == "always"
    assert faults.is_device_loss(faults.DeviceLoss("x"))
    assert faults.is_device_loss(RuntimeError("DEVICE_LOST: gone"))
    assert faults.is_device_loss(RuntimeError("cudaErrorNoDevice"))
    assert faults.is_device_loss(RuntimeError(
        "CUDA error: CUDA-capable device(s) is/are busy or unavailable"))
    for program_fault in ("cold_tier kernel launch failed: CUDA error 719",
                          "hot_stage kernel launch failed: CUDA error 46",
                          "dense_score kernel launch failed: CUDA error "
                          "100",
                          "CUDA error: an illegal memory access was "
                          "encountered (cudaErrorIllegalAddress, 700)",
                          "nvcc failed on csrc/hot_stage.cu (exit 1)",
                          "shape mismatch"):
        assert not faults.is_device_loss(RuntimeError(program_fault))


def test_run_with_deadline_abandons_and_caps():
    assert faults.run_with_deadline(lambda: 3, None) == 3
    assert faults.run_with_deadline(lambda: 4, 1.0) == 4
    with pytest.raises(ValueError):
        faults.run_with_deadline(lambda: int("x"), 1.0)
    release = threading.Event()
    for _ in range(faults._ABANDONED_CAP):
        with pytest.raises(faults.ScoreDeadlineExceeded):
            faults.run_with_deadline(lambda: release.wait(10), 0.01)
    t0 = time.perf_counter()
    with pytest.raises(faults.ScoreDeadlineExceeded):
        faults.run_with_deadline(lambda: 5, 1.0)   # capped: fails fast
    assert time.perf_counter() - t0 < 0.5
    release.set()
    assert faults.drain_abandoned(timeout_s=5.0) == 0
    assert faults.run_with_deadline(lambda: 6, 1.0) == 6


def test_deadline_worker_spans_join_the_request_tree():
    """run_with_deadline's worker thread adds its spans under the
    caller's open span (attach), and each span feeds its histogram."""
    with obs.trace("request") as root:
        faults.run_with_deadline(lambda: obs.trace("kernel").__enter__()
                                 .__exit__(None, None, None), 5.0)
    assert [c.name for c in root.children] == ["kernel"]
    state = obs.get_registry().hist_state()
    assert sum(state["kernel"][0]) == 1 and sum(state["request"][0]) == 1


def test_tracing_off_silences_latency_not_counters(scorer):
    """TPU_IR_TRACE=0: no span, no latency histogram; counters count."""
    obs.configure(enabled=False)
    try:
        assert not obs.enabled()
        fe = ServingFrontend(scorer)
        fe.search("salmon fishing", k=3)
        assert obs.trace("request").set("x", 1) is None
    finally:
        obs.configure(enabled=True)
    summary = obs.get_registry().delta_summary({}, always=("request",))
    assert summary["request"]["count"] == 0
    assert "request.full" not in summary
    assert serving_counters().get("served_full") == 1


# ---------------------------------------------------------------------------
# the scorer's serving surface against tpu_ir
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_scorer(index_dir):
    return JaxScorer.load(index_dir, layout="sparse")


TEXTS = ["salmon fishing", "stock market investor", "honey bears",
         "salmon salmon river", "zzznope", "", "quick brown fox lazy dog "
         "market investor asset bond stock"]


def test_analyze_width_floor_matches_jax(scorer, jax_scorer):
    for floor in (None, 8, 12):
        np.testing.assert_array_equal(
            scorer.analyze_queries(TEXTS, width_floor=floor),
            jax_scorer.analyze_queries(TEXTS, width_floor=floor))


def test_concurrent_analysis_matches_serial(scorer):
    """Many threads analyzing through one Scorer get the serial rows (the
    tag tokenizer keeps per-call state, so each thread has its own)."""
    texts = [f"salmon{i} fishing <b>river</b> bears honey-{i} quick "
             f"brown fox {WORDS[i % len(WORDS)]} {i}" for i in range(150)]
    want = [scorer.analyze_queries([t]) for t in texts]
    bad = []

    def run():
        for t, w in zip(texts, want):
            if not np.array_equal(scorer.analyze_queries([t]), w):
                bad.append(t)

    threads = [threading.Thread(target=run, daemon=True) for _ in range(16)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not bad


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
def test_topk_host_bitwise_jax(scorer, jax_scorer, scoring):
    q = scorer.analyze_queries(TEXTS)
    got = scorer._topk_host(q, 10, scoring)
    want = jax_scorer._topk_host(q, 10, scoring)
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])


def _assert_same_ranking(got, want):
    """Scores within RTOL; doc ids equal, except that a run of adjacent
    reference scores within RTOL (the two packages round sums in other
    orders) is compared as a set, and only by length where it reaches
    the k-th slot."""
    want_s = np.asarray([s for _, s in want], np.float64)
    np.testing.assert_allclose([s for _, s in got], want_s, rtol=RTOL)
    want_d, got_d = [d for d, _ in want], [d for d, _ in got]
    assert len(want_d) == len(got_d)
    i = 0
    while i < len(want_d):
        j = i + 1
        while j < len(want_d) and abs(want_s[j] - want_s[j - 1]) <= \
                RTOL * max(abs(want_s[j - 1]), 1e-30):
            j += 1
        if j < len(want_d) or j - i == 1:
            assert set(got_d[i:j]) == set(want_d[i:j]), (i, j)
        i = j


def _same_docs_close(got, want):
    assert {d for d, _ in got} == {d for d, _ in want}
    w = dict(want)
    for d, s in got:
        assert s == pytest.approx(w[d], rel=RTOL)


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
def test_hot_only_matches_jax(scorer, jax_scorer, scoring):
    hot = scorer.vocab.terms[int(np.nonzero(scorer._hot_rank_host >= 0)
                                 [0][0])]
    texts = TEXTS + [f"{hot} salmon", hot]
    got = scorer.search_batch(texts, k=200, scoring=scoring, hot_only=True)
    want = jax_scorer.search_batch(texts, k=200, scoring=scoring,
                                   hot_only=True)
    assert any(len(g) for g in got)
    for g, w in zip(got, want):
        _same_docs_close(g, w)
    # no cold stage: a query of cold terms alone finds nothing
    cold_term = scorer.vocab.terms[int(np.nonzero(
        (scorer._hot_rank_host < 0) & (scorer._df_host > 0))[0][0])]
    assert scorer.search_batch([cold_term], scoring=scoring)[0]
    assert not scorer.search_batch([cold_term], scoring=scoring,
                                   hot_only=True)[0]


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
def test_frontend_full_level_matches_jax(scorer, jax_scorer, scoring):
    fe = ServingFrontend(scorer, ServingConfig(deadline_s=5.0))
    jfe = JaxServingFrontend(jax_scorer, JaxServingConfig(deadline_s=5.0))
    for text in TEXTS:
        got = fe.search(text, k=10, scoring=scoring)
        want = jfe.search(text, k=10, scoring=scoring)
        assert got.level == want.level == LEVEL_FULL
        assert not got.degraded and not want.degraded
        _assert_same_ranking(got, want)
        assert list(got) == list(scorer.search_batch([text], k=10,
                                                     scoring=scoring)[0])
    st = fe.stats()
    assert st["submitted"] == st["served_full"] == len(TEXTS)
    assert st["generation"] == 0


def test_force_host_and_injected_loss_are_tagged(scorer):
    res = scorer.search_batch(["salmon fishing"], k=5, force_host=True)[0]
    assert res.degraded and res
    assert recovery_counters().get("forced_host_batches") == 1
    faults.install(faults.parse_plan("score.device_loss:once@1"))
    (res,) = scorer.search_batch(["salmon fishing"], k=5, scoring="bm25")
    assert res.degraded
    (again,) = scorer.search_batch(["salmon fishing"], k=5, scoring="bm25")
    assert not again.degraded
    assert [d for d, _ in res] == [d for d, _ in again]
    np.testing.assert_allclose([s for _, s in res], [s for _, s in again],
                               rtol=RTOL)
    assert recovery_counters().get("device_loss") == 1
    assert recovery_counters().get("degraded_batches") == 1


def test_program_errors_raise_not_degrade(scorer, monkeypatch):
    """A launch failure is a program fault: it raises under a deadline
    and a fault plan too, and nothing is counted as degraded; so does a
    wrapper's report of a lost-device code (46: another process holds
    the card in exclusive mode), which only the CUDA runtime's own error
    text may turn into a degraded answer."""
    faults.install(faults.FaultPlan())
    for code in (719, 46, 100, 214, 220, 802):
        def launch_failure(*a, code=code, **kw):
            raise RuntimeError(f"hot_stage kernel launch failed: CUDA "
                               f"error {code}")

        monkeypatch.setattr(scorer, "_topk_device", launch_failure)
        with pytest.raises(RuntimeError, match=f"CUDA error {code}$"):
            scorer.search_batch(["salmon"], deadline_s=1.0)
    assert recovery_counters().get("degraded_batches") == 0


def test_explain_and_phrase_still_raise(scorer):
    for kw in ({"explain_k": 2}, {"explain_ks": [1]}):
        with pytest.raises(ValueError, match="later slice"):
            scorer.search_batch(["salmon"], **kw)
    with pytest.raises(ValueError, match="phrase"):
        scorer.search_batch(['"salmon fishing"'])
    with pytest.raises(ValueError, match="explain_ks has 1 entries"):
        scorer.search_batch(["salmon", "river"], explain_ks=[0])


# ---------------------------------------------------------------------------
# frontend behaviour
# ---------------------------------------------------------------------------


def test_frontend_steps_down_and_tags_levels(scorer, index_dir):
    cfg = ServingConfig(deadline_s=1.0, fail_threshold=2,
                        down_cooldown_s=0.0, breaker_threshold=1000)
    fe = ServingFrontend(scorer, cfg)
    faults.install(faults.parse_plan("score.device_loss:first@4"))
    seen = []
    for _ in range(4):
        res = fe.search("salmon river", k=5, scoring="bm25", rerank=25)
        seen.append((res.level, res.degraded))
    assert seen[0] == (LEVEL_FULL, True) and seen[1] == (LEVEL_FULL, True)
    assert seen[2][0] == LEVEL_NO_RERANK
    assert fe.stats()["level_step_down"] >= 1
    assert fe.ladder.levels == ("full", "no_rerank", "hot_only", "shed")
    dense = Scorer.load(index_dir, layout="dense", device="cpu")
    assert ServingFrontend(dense).ladder.levels == ("full", "no_rerank",
                                                     "shed")


def test_frontend_shed_level_rejects_and_recovers(scorer):
    cfg = ServingConfig(deadline_s=1.0, fail_threshold=1,
                        down_cooldown_s=0.0, recover_successes=2,
                        breaker_threshold=1000)
    fe = ServingFrontend(scorer, cfg)
    faults.install(faults.parse_plan("score.device_loss:first@3"))
    levels = [fe.search("salmon fishing", k=3).level for _ in range(3)]
    faults.clear()
    assert levels == [LEVEL_FULL, LEVEL_NO_RERANK, LEVEL_HOT_ONLY]
    assert fe.ladder.level() == LEVEL_SHED
    with pytest.raises(Overloaded) as ei:
        fe.search("salmon fishing", k=3)
    assert ei.value.reason == "shed_level" and ei.value.level == LEVEL_SHED
    for _ in range(20):
        try:
            fe.search("salmon fishing", k=3)
        except Overloaded:
            continue
    assert fe.ladder.level() == LEVEL_FULL
    st = fe.stats()
    assert st["shed_level"] >= 1 and st["level_step_up"] >= 3
    assert st["submitted"] == st["shed_level"] + sum(
        v for key, v in st.items()
        if isinstance(v, int) and key.startswith("served_"))
    assert serving_counters().get("submitted") == st["submitted"]


def test_breaker_open_is_10x_faster_than_deadline_per_request(scorer):
    deadline = 0.25
    cfg = ServingConfig(deadline_s=deadline, breaker_threshold=2,
                        breaker_cooldown_s=300.0, fail_threshold=1000)
    fe = ServingFrontend(scorer, cfg)
    faults.install(faults.FaultPlan().add("score.hang", "always",
                                          sleep_s=1.0))
    t0 = time.perf_counter()
    r1 = fe.search("salmon fishing", k=5)
    closed_latency = time.perf_counter() - t0
    assert r1.degraded and closed_latency >= deadline * 0.8
    fe.search("stock market", k=5)               # second failure: opens
    assert fe.breaker.state == "open"
    lat = []
    for i in range(20):
        t0 = time.perf_counter()
        res = fe.search(f"salmon river {WORDS[i % len(WORDS)]}", k=5)
        lat.append(time.perf_counter() - t0)
        assert res.degraded, "breaker-open serving must stay tagged"
    steady = sum(lat) / len(lat)
    assert fe.stats()["served_breaker_host"] == 20
    assert steady * 10 <= deadline, steady


def test_breaker_probe_closes_on_recovery(scorer):
    cfg = ServingConfig(deadline_s=1.0, breaker_threshold=1,
                        breaker_cooldown_s=0.05, fail_threshold=1000)
    fe = ServingFrontend(scorer, cfg)
    faults.install(faults.parse_plan("score.device_loss:once@1"))
    r = fe.search("salmon fishing", k=5)
    assert r.degraded and fe.breaker.state == "open"
    time.sleep(0.08)
    r2 = fe.search("salmon fishing", k=5)        # the half-open probe
    assert not r2.degraded and r2.level == LEVEL_FULL
    assert fe.breaker.state == "closed"
    assert fe.stats()["breaker_probes"] == 1


def test_frontend_exception_releases_probe(scorer, monkeypatch):
    cfg = ServingConfig(deadline_s=1.0, breaker_threshold=1,
                        breaker_cooldown_s=0.0, fail_threshold=1000)
    fe = ServingFrontend(scorer, cfg)
    faults.install(faults.parse_plan("score.device_loss:once@1"))
    fe.search("salmon fishing", k=5)
    assert fe.breaker.state == "open"
    faults.clear()

    def boom(*a, **kw):
        raise RuntimeError("not a device verdict")

    with monkeypatch.context() as m:
        m.setattr(scorer, "search_batch", boom)
        with pytest.raises(RuntimeError):
            fe.search("salmon fishing", k=5)     # the probe, dying
    res = fe.search("salmon fishing", k=5)
    assert not res.degraded and fe.breaker.state == "closed"


def test_result_cache_hit_is_the_miss(scorer, index_dir):
    fe = ServingFrontend(scorer, ServingConfig(cache_entries=8))
    miss = fe.search("salmon fishing", k=5, scoring="bm25")
    hit = fe.search("salmon  fishing", k=5, scoring="bm25")
    assert list(hit) == list(miss) and hit.level == LEVEL_FULL
    assert fe.stats()["served_cache"] == 1
    assert obs.get_registry().get("cache.hit") == 1
    assert fe.search("fishing salmon", k=5, scoring="bm25") is not None
    assert obs.get_registry().get("cache.miss") == 2   # order is in the key
    with pytest.raises(ValueError, match="live index"):
        fe.reload_generation()
    nxt = Scorer.load(index_dir, layout="sparse", device="cpu")
    nxt.generation = 1
    assert fe.reload_generation(nxt) is nxt
    res = fe.search("salmon fishing", k=5, scoring="bm25")
    assert res.generation == 1 and list(res) == list(miss)
    assert obs.get_registry().get("cache.stale_generation") == 2
    assert obs.get_registry().gauges()["generation.current"] == 1
    assert fe.stats()["generation_swap"] == 1


# ---------------------------------------------------------------------------
# the soaks
# ---------------------------------------------------------------------------


def _assert_soak_invariants(report):
    assert report["deadlocked"] == 0
    assert report["errors"] == 0, report["error_samples"]
    assert report["untagged_mismatches"] == 0
    assert report["served"] + report["shed"] == report["submitted"]
    fe = report["frontend"]
    assert fe["submitted"] == report["submitted"]
    served_by_level = sum(v for k, v in fe.items()
                          if isinstance(v, int) and k.startswith("served_")
                          and k != "served_breaker_host")
    shed_total = sum(v for k, v in fe.items()
                     if isinstance(v, int) and k.startswith("shed_"))
    assert served_by_level == report["served"]
    assert shed_total == report["shed"]


def test_soak_without_faults_serves_everything_full(scorer):
    report = run_soak(scorer, threads=4, queries=60, seed=3,
                      fault_spec=None,
                      config=ServingConfig(max_concurrency=4, max_queue=16,
                                           deadline_s=5.0),
                      timeout_s=60.0)
    _assert_soak_invariants(report)
    assert report["shed"] == 0 and report["degraded"] == 0
    assert report["levels"] == {"full": 60}
    assert report["full_bitidentical"] == 60
    assert "forced_host_batches" not in report["recovery_delta"]
    assert report["latency"]["dispatch"]["count"] > 0


def test_soak_under_chaos(scorer):
    report = run_soak(
        scorer, threads=4, queries=96, seed=0,
        fault_spec=("score.hang:p=0.15:sleep=0.5,"
                    "score.device_loss:p=0.1,seed=2"),
        config=ServingConfig(max_concurrency=3, max_queue=4,
                             deadline_s=0.2, queue_timeout_s=0.15,
                             breaker_threshold=4, breaker_cooldown_s=0.2),
        timeout_s=90.0, pacing_s=0.002)
    _assert_soak_invariants(report)
    assert report["degraded"] > 0, "the chaos never bit"
    assert report["full_bitidentical"] > 0
    rec = report["recovery_delta"]
    assert (rec.get("degraded_batches", 0)
            + rec.get("forced_host_batches", 0)) == report["degraded"]
    for stage in ("admission_wait", "dispatch", "kernel", "fallback"):
        assert {"count", "p50_ms", "p99_ms"} <= set(report["latency"][stage])


# ---------------------------------------------------------------------------
# serve-bench through the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [[], ["--concurrency", "1,4"]],
                         ids=["soak", "sweep"])
def test_serve_bench_cli(index_dir, mode):
    history = os.path.join(ROOT, "BENCH_HISTORY.jsonl")
    before = open(history, "rb").read()
    r = subprocess.run(
        [sys.executable, "-m", "tpu_ir_torch.cli", "serve-bench", index_dir,
         "--device", "cpu", "--threads", "4", "--queries", "48", *mode],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    if mode:
        assert [lv["concurrency"] for lv in out["levels"]] == [1, 4]
        assert all(lv["unwarmed"] == 0 for lv in out["levels"])
        assert out["solo_rtt_ms"] > 0
    else:
        assert out["submitted"] == 48
        assert out["served"] + out["shed"] == 48
        assert out["deadlocked"] == 0 and out["untagged_mismatches"] == 0
    assert open(history, "rb").read() == before
