"""The port's coalescing scheduler (tpu_ir_torch.serving.batching) on the
CPU: a query in a rung-padded batch at width floor 8 returns the bits of
its solo dispatch, across the dense and tiered layouts, TF-IDF and BM25,
`hot_only`, prune off and the rerank; the scheduler coalesces concurrent
callers (occupancy > 1), never makes an idle solo caller wait, never
mixes incompatible keys in one batch, delivers a batch's error to every
caller and refuses phrase text; after the frontend's warm-up no
coalesced dispatch falls outside the warmed shapes (`unwarmed` == 0);
and under chaos a shared batch's slots carry one degraded verdict."""

import threading
import time

import numpy as np
import pytest

from tpu_ir.lint import ordered_lock

import tpu_ir_torch.faults as faults
from tpu_ir_torch import obs
from tpu_ir_torch.index import build_index
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.serving import (
    BatchKey,
    CoalescingScheduler,
    ServingConfig,
    ServingFrontend,
    batch_ladder,
    run_concurrency_sweep,
    run_soak,
)

WORDS = ("salmon fishing river bears honey quick brown fox lazy dog "
         "market investor asset bond stock season rain forest".split())

# hot and cold, cold only, repeats, unknown terms, empty, wide
QUERIES = [
    "common salmon",
    "salmon fishing river",
    "honey bears",
    "salmon salmon fishing",
    "zzznope salmon",
    "common",
    "stock market investor",
    "",
    "quick brown fox lazy dog market investor asset bond",
]

LADDER = (1, 4, 16)
WIDTH = 8


@pytest.fixture(autouse=True)
def _clean_port_state(monkeypatch):
    """The port's registry and fault plan start and end clean, and every
    lock the port creates during a test is order-checked."""
    faults.clear()
    obs.reset_all()
    graph = ordered_lock.install(monkeypatch, strict=True)
    yield
    assert not graph.inversions, "; ".join(graph.inversions)
    faults.clear()
    faults.drain_abandoned(timeout_s=10.0)
    obs.reset_all()


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("batching")
    body = []
    for i in range(150):
        # "common" in every doc: a hot-strip row
        text = "common " + " ".join(WORDS[(i + j) % len(WORDS)]
                                    for j in range(3 + i % 7))
        body.append(f"<DOC>\n<DOCNO> D-{i:04d} </DOCNO>\n<TEXT>\n"
                    f"{text}\n</TEXT>\n</DOC>\n")
    corpus = tmp / "corpus.trec"
    corpus.write_text("".join(body))
    out = str(tmp / "idx")
    build_index(str(corpus), out, num_shards=3, device="cpu")
    return out


@pytest.fixture(scope="module")
def scorers(index_dir):
    out = {layout: Scorer.load(index_dir, layout=layout, device="cpu")
           for layout in ("dense", "sparse")}
    assert (out["sparse"]._hot_rank_host >= 0).sum() >= 1
    return out


def _solo(scorer, text, **kw):
    kw.setdefault("k", 5)
    return scorer.search_batch([text], **kw)[0]


def _batched(scorer, texts, **kw):
    """The coalescer's dispatch shape: padded to the smallest rung, the
    pinned width, rung-padded MaxScore groups."""
    rung = next(r for r in LADDER if r >= len(texts))
    return scorer.search_batch(texts, k=5, pad_to=rung, width_floor=WIDTH,
                               rung_ladder=LADDER, **kw)


def _bits(res):
    return [(d, np.float32(s).view(np.int32)) for d, s in res]


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
@pytest.mark.parametrize("variant", ["full", "hot_only"])
def test_coalesced_batch_bitwise_solo(scorers, layout, scoring, variant):
    s = scorers[layout]
    kw = {"scoring": scoring, "hot_only": variant == "hot_only"}
    solo = [_solo(s, t, **kw) for t in QUERIES]
    for size in (1, 3, len(QUERIES)):
        batched = _batched(s, QUERIES[:size], **kw)
        assert len(batched) == size
        for got, want, text in zip(batched, solo, QUERIES):
            assert _bits(got) == _bits(want), (layout, scoring, text)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_coalesced_batch_bitwise_solo_rerank(scorers, layout):
    s = scorers[layout]
    solo = [_solo(s, t, rerank=25) for t in QUERIES]
    batched = _batched(s, QUERIES, rerank=25)
    for got, want, text in zip(batched, solo, QUERIES):
        assert _bits(got) == _bits(want), text


def test_coalesced_batch_bitwise_solo_prune_off(index_dir):
    s = Scorer.load(index_dir, layout="sparse", prune=False, device="cpu")
    solo = [_solo(s, t, scoring="bm25") for t in QUERIES]
    batched = _batched(s, QUERIES, scoring="bm25")
    for got, want, text in zip(batched, solo, QUERIES):
        assert _bits(got) == _bits(want), text


def test_hot_batch_skips_the_pad_only_dispatch(scorers):
    """A batch whose real queries are all hot pays no second dispatch to
    score its rung's pad rows."""
    s = scorers["sparse"]
    texts = ["common salmon", "common", "common river"]
    solo = [_solo(s, t, scoring="bm25") for t in texts]
    calls = []
    orig = s._topk_device

    def counting(q, k, scoring, **kw):
        calls.append((len(q), kw))
        return orig(q, k, scoring, **kw)

    s._topk_device = counting
    try:
        batched = _batched(s, texts, scoring="bm25")
    finally:
        del s._topk_device
    assert calls == [(4, {})]
    for got, want in zip(batched, solo):
        assert _bits(got) == _bits(want)


def test_batch_ladder_env(monkeypatch):
    monkeypatch.delenv("TPU_IR_BATCH_LADDER", raising=False)
    assert batch_ladder() == (1, 4, 16)          # the port's default
    monkeypatch.setenv("TPU_IR_BATCH_LADDER", "64,4,4,1")
    assert batch_ladder() == (1, 4, 64)          # an explicit ladder wins
    monkeypatch.setenv("TPU_IR_BATCH_LADDER", "1,x")
    with pytest.raises(ValueError):
        batch_ladder()


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


def _frontend(scorer, **kw):
    return ServingFrontend(scorer, ServingConfig(
        max_concurrency=8, max_queue=16, coalesce=True,
        batch_ladder=LADDER, batch_width=WIDTH, **kw))


def test_scheduler_coalesces_concurrent_callers(scorers):
    s = scorers["sparse"]
    fe = _frontend(s)
    solo = {t: _bits(_solo(s, t, scoring="bm25", k=10)) for t in QUERIES}
    errors = []
    barrier = threading.Barrier(8)

    def client(ci):
        try:
            barrier.wait(10)
            for i in range(12):
                t = QUERIES[(ci + i) % len(QUERIES)]
                res = fe.search(t, scoring="bm25")
                assert _bits(res) == solo[t], t
                assert res.level == "full" and not res.degraded
        except BaseException as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert not errors
    snap = fe.batcher.snapshot()
    assert snap["max_occupancy"] > 1, "coalescing never engaged"
    assert snap["coalesced"] + snap["solo_flush"] == snap["batches"]
    assert obs.get_registry().get("batch.coalesced") == snap["coalesced"]
    assert snap["queued"] == 0 and not snap["dispatching"]


def test_idle_solo_query_never_pays_the_wait(scorers):
    s = scorers["sparse"]
    fe = _frontend(s, coalesce_wait_ms=500.0)
    fe.search(QUERIES[0], scoring="bm25")
    t0 = time.perf_counter()
    fe.search(QUERIES[1], scoring="bm25")
    assert (time.perf_counter() - t0) * 1e3 < 400.0
    assert fe.batcher.snapshot()["solo_flush"] >= 2


def test_incompatible_keys_do_not_share_a_batch(scorers):
    s = scorers["sparse"]
    sched = CoalescingScheduler(s, ladder=LADDER, width=WIDTH)
    want = {sc: _bits(_solo(s, QUERIES[0], scoring=sc, k=10))
            for sc in ("tfidf", "bm25")}
    results = {}
    barrier = threading.Barrier(2)

    def go(scoring):
        barrier.wait(10)
        results[scoring] = sched.submit(
            QUERIES[0], k=10, scoring=scoring, rerank=None,
            hot_only=False, force_host=False)

    threads = [threading.Thread(target=go, args=(sc,), daemon=True)
               for sc in ("tfidf", "bm25")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert {sc: _bits(r) for sc, r in results.items()} == want
    snap = sched.snapshot()
    assert snap["batches"] == 2 and snap["max_occupancy"] == 1
    assert BatchKey(5, "tfidf", None, False, False) != \
        BatchKey(5, "bm25", None, False, False)


def test_batch_error_reaches_every_caller(scorers, monkeypatch):
    s = scorers["sparse"]
    sched = CoalescingScheduler(s, ladder=LADDER, width=WIDTH)

    def exploding(*a, **kw):
        raise RuntimeError("injected batch failure")

    monkeypatch.setattr(s, "search_batch", exploding)
    outcomes = []
    barrier = threading.Barrier(3)

    def go(i):
        barrier.wait(10)
        try:
            sched.submit(QUERIES[i], k=5, scoring="tfidf", rerank=None,
                         hot_only=False, force_host=False)
            outcomes.append("ok")
        except RuntimeError as e:
            outcomes.append(str(e))

    threads = [threading.Thread(target=go, args=(i,), daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert outcomes == ["injected batch failure"] * 3
    assert sched.snapshot()["queued"] == 0
    assert not sched.snapshot()["dispatching"]


def test_phrase_text_raises(scorers):
    sched = CoalescingScheduler(scorers["sparse"], ladder=LADDER,
                                width=WIDTH)
    with pytest.raises(ValueError, match="phrase"):
        sched.submit('"salmon fishing"', k=5, scoring="tfidf",
                     rerank=None, hot_only=False, force_host=False)


# ---------------------------------------------------------------------------
# the warmed shapes, the sweep and the coalesced chaos soak
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_precompile_covers_the_serving_shapes(index_dir, layout):
    s = Scorer.load(index_dir, layout=layout, device="cpu")
    fe = _frontend(s)
    variants = 3 if layout == "sparse" else 1
    assert len(s.warmed_shapes) == len(LADDER) * 2 * variants
    narrow = [t for t in QUERIES if len(t.split()) <= WIDTH]
    errors = []

    def client(ci):
        try:
            for i in range(10):
                fe.search(narrow[(ci + i) % len(narrow)],
                          scoring=("bm25" if i % 2 else "tfidf"))
        except BaseException as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors
    assert obs.get_registry().get("dispatch.unwarmed") == 0
    # a query wider than the pinned width is a shape outside the set
    fe.search(QUERIES[-1], scoring="bm25")
    assert obs.get_registry().get("dispatch.unwarmed") >= 1


def test_concurrency_sweep_reports(scorers):
    rep = run_concurrency_sweep(scorers["sparse"], levels=(1, 4),
                                queries_per_level=24, seed=1,
                                scoring="bm25")
    assert rep["solo_rtt_ms"] > 0
    assert [lv["concurrency"] for lv in rep["levels"]] == [1, 4]
    for lv in rep["levels"]:
        assert lv["errors"] == 0 and lv["served"] > 0 and lv["qps"] > 0
        assert lv["p99_ms"] >= lv["p50_ms"] > 0
        assert lv["unwarmed"] == 0
        assert lv["occupancy"]["count"] == lv["coalesced"] + lv["solo_flush"]
    assert rep["levels"][0]["occupancy_mean"] == 1.0


def test_coalesced_soak_under_chaos_keeps_batches_uniform(scorers,
                                                          monkeypatch):
    """The chaos soak through the coalescer: every invariant holds, and
    every shared batch's slots carry one degraded verdict (recorded by
    wrapping the scheduler's batch execution)."""
    batches = []
    orig = CoalescingScheduler._execute

    def recording(self, slots):
        orig(self, slots)
        if len(slots) > 1:
            batches.append({s.result.degraded for s in slots
                            if s.state == "done"})

    monkeypatch.setattr(CoalescingScheduler, "_execute", recording)
    report = run_soak(
        scorers["sparse"], threads=4, queries=96, seed=7,
        fault_spec=("score.hang:p=0.12:sleep=0.5,"
                    "score.device_loss:p=0.08,seed=9"),
        config=ServingConfig(max_concurrency=4, max_queue=8,
                             deadline_s=0.2, queue_timeout_s=0.15,
                             breaker_threshold=4, breaker_cooldown_s=0.2,
                             coalesce=True),
        timeout_s=120.0, pacing_s=0.002)
    assert report["deadlocked"] == 0 and report["errors"] == 0
    assert report["untagged_mismatches"] == 0
    assert report["served"] + report["shed"] == report["submitted"]
    assert report["degraded"] > 0, "the chaos never bit"
    assert report["batching"]["batches"] > 0
    assert batches, "no shared batch formed"
    assert all(len(flags) == 1 for flags in batches)
