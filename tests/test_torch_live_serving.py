"""Serving a live index's generations in the port on the CPU:
`Scorer.load_generation` / `reload_generation` against the JAX package's
on the same live dir (same doc ids, scores within rtol 1e-5), and (e)
the frontend's one-process swap under threaded traffic: every response
names exactly one generation and is bitwise that generation's solo
answer, with no error, and the result cache is purged of the old
generation (tests/test_generation.py's swap test, ported)."""

import random
import shutil
import threading
import time

import numpy as np
import pytest

from tpu_ir.search.scorer import Scorer as JaxScorer

from tpu_ir_torch import faults, obs
from tpu_ir_torch.index.ingest import IngestWriter
from tpu_ir_torch.index.segments import LiveIndex
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.serving import ServingConfig, ServingFrontend

RTOL = 1e-5
WORDS = ("salmon fishing river bears honey quick brown fox lazy dog "
         "market investor asset bond stock season rain forest".split())
QUERIES = ["salmon fishing", "bears honey market", "quick fox",
           "rain forest investor", "asset bond stock"]


@pytest.fixture(autouse=True)
def _clean_port_state():
    faults.clear()
    obs.reset_all()
    yield
    faults.clear()
    faults.drain_abandoned(timeout_s=10.0)
    obs.reset_all()


def _text(rng) -> str:
    return " ".join(rng.choice(WORDS) for _ in range(rng.randint(3, 7)))


@pytest.fixture(scope="module")
def live_dir(tmp_path_factory):
    """Generation A (40 docs) and generation B (A with 4 docs replaced
    and 4 added), both compacted, written by the port."""
    tmp = tmp_path_factory.mktemp("gen")
    live = str(tmp / "live")
    LiveIndex.create(live, num_shards=2)
    rng = random.Random(0)
    with IngestWriter(live, auto_merge=False, device="cpu") as w:
        for i in range(40):
            w.add(f"D-{i:03d}", _text(rng))
        w.compact_all(note="gen A")
    gen_a = LiveIndex.open(live).current_gen()
    with IngestWriter(live, auto_merge=False, device="cpu") as w:
        for i in range(4):
            w.update(f"D-{i:03d}", _text(rng))
        for i in range(4):
            w.update(f"N-{i:03d}", _text(rng))
        w.compact_all(note="gen B")
    gen_b = LiveIndex.open(live).current_gen()
    assert gen_b > gen_a
    return live, gen_a, gen_b


def test_scorer_load_and_reload_generation(live_dir, tmp_path):
    live, gen_a, gen_b = live_dir
    a = Scorer.load_generation(live, gen_a, layout="sparse", device="cpu")
    assert a.generation == gen_a and a.meta.num_docs == 40
    b = a.reload_generation()          # the newest servable: B
    assert b.generation == gen_b and b.meta.num_docs == 44
    assert b.device.type == "cpu" and b.layout == "sparse"  # replayed
    assert a.generation == gen_a       # the old scorer is untouched
    assert len(a.search_batch(["salmon"], k=3, scoring="bm25")[0]) > 0
    assert a.reload_generation(gen_a, layout="dense").layout == "dense"
    # a plain index's scorer has nothing to follow
    seg = LiveIndex.open(live).manifest(gen_b)["segments"][0]
    plain = Scorer.load(f"{live}/segments/{seg}", device="cpu")
    assert plain.generation == 0
    with pytest.raises(ValueError, match="not loaded from a live index"):
        plain.reload_generation()
    with pytest.raises(ValueError, match="not servable"):
        Scorer.load_generation(live, gen_b - 1, device="cpu")
    # against the JAX package's load_generation on a copy of the dir
    # (its serving cache carries its own doc norms)
    twin = str(tmp_path / "twin")
    shutil.copytree(live, twin,
                    ignore=shutil.ignore_patterns("serving-*"))
    for g, got_scorer in ((gen_a, a), (gen_b, b)):
        want_scorer = JaxScorer.load_generation(twin, g, layout="sparse")
        assert want_scorer.generation == got_scorer.generation == g
        for scoring in ("tfidf", "bm25"):
            got = got_scorer.search_batch(QUERIES, k=10, scoring=scoring)
            want = want_scorer.search_batch(QUERIES, k=10, scoring=scoring)
            for r_got, r_want in zip(got, want):
                assert [d for d, _ in r_got] == [d for d, _ in r_want]
                np.testing.assert_allclose([s for _, s in r_got],
                                           [s for _, s in r_want],
                                           rtol=RTOL)


def _bits(res) -> list:
    return [(d, np.float32(s).tobytes()) for d, s in res]


def _swap_under_traffic(live_dir, **config):
    """Threaded searchers across reload_generation(generation=) of a
    frontend built with `config`: nothing drops or errors, every response
    is bitwise the answer of the generation it is tagged with, and the
    result cache drops the old generation's entries. Returns the
    frontend."""
    live, gen_a, gen_b = live_dir
    ref = {}
    for g in (gen_a, gen_b):
        sc = Scorer.load_generation(live, g, layout="sparse", device="cpu")
        ref[g] = {q: _bits(sc.search_batch([q], k=5, scoring="bm25")[0])
                  for q in QUERIES}
    frontend = ServingFrontend(
        Scorer.load_generation(live, gen_a, layout="sparse", device="cpu"),
        ServingConfig(max_concurrency=4, max_queue=64, cache_entries=16,
                      **config))
    stop = threading.Event()
    outcomes: list = []
    errors: list = []
    lock = threading.Lock()

    def client(ci: int) -> None:
        rng = random.Random(ci)
        while not stop.is_set():
            q = QUERIES[rng.randrange(len(QUERIES))]
            try:
                res = frontend.search(q, k=5, scoring="bm25")
            except Exception as e:  # noqa: BLE001 — counted, must be none
                with lock:
                    errors.append(repr(e))
                continue
            with lock:
                outcomes.append((q, res.generation, _bits(res)))

    def wait_for(n: int) -> None:
        while True:
            with lock:
                if len(outcomes) >= n or errors:
                    return
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    try:
        wait_for(20)
        cached_a = len(frontend.cache._entries)
        frontend.reload_generation(generation=gen_b)
        with lock:
            baseline = len(outcomes)
        wait_for(baseline + 20)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not errors, errors[:3]
    assert frontend.scorer.generation == gen_b
    assert frontend.stats()["generation_swap"] == 1
    assert {g for _, g, _ in outcomes} == {gen_a, gen_b}
    for q, g, hits in outcomes:
        assert hits == ref[g][q], (q, g)
    assert cached_a > 0
    assert obs.get_registry().get("cache.stale_generation") >= cached_a
    assert obs.get_registry().gauges()["generation.current"] == gen_b
    return frontend


def test_frontend_swap_is_atomic_under_traffic(live_dir):
    assert _swap_under_traffic(live_dir).batcher is None


def test_coalesced_frontend_swap_is_atomic_under_traffic(live_dir):
    """The coalesced frontend: the swap builds and warms B's coalescer
    before it publishes, so B's every dispatch shape is warm when the
    first B-tagged response is served."""
    frontend = _swap_under_traffic(live_dir, coalesce=True,
                                   precompile_ks=(5,))
    batcher = frontend.batcher
    assert batcher is not None and batcher._scorer is frontend.scorer
    assert frontend.scorer.warmed_shapes
    # one warm-up at the frontend's start, one inside the swap
    hists = obs.get_registry().delta_summary({})
    assert hists["batch.precompile"]["count"] == 2
    assert obs.get_registry().get("dispatch.unwarmed") == 0


def test_frontend_reload_follows_the_newest_servable(live_dir, tmp_path):
    """reload_generation() with no scorer and no generation loads the
    newest servable generation of the serving scorer's live dir with its
    load kwargs; an uncompacted head after it is passed over, and asking
    for that head raises tpu_ir's error."""
    live, gen_a, gen_b = live_dir
    live = shutil.copytree(live, str(tmp_path / "live"),
                           ignore=shutil.ignore_patterns("serving-*"))
    frontend = ServingFrontend(
        Scorer.load_generation(live, gen_a, layout="dense", device="cpu"),
        ServingConfig(max_concurrency=2, max_queue=8))
    assert frontend.search("salmon fishing", k=5).generation == gen_a
    with IngestWriter(live, auto_merge=False, device="cpu") as w:
        w.update("D-005", "salmon fishing river")
    head = LiveIndex.open(live).current_gen()
    assert head > gen_b
    got = frontend.reload_generation()
    assert got is frontend.scorer and got.generation == gen_b
    assert got.layout == "dense" and got.device.type == "cpu"
    res = frontend.search("salmon fishing", k=5)
    assert res.generation == gen_b
    want = Scorer.load_generation(live, gen_b, layout="dense",
                                  device="cpu").search_batch(
        ["salmon fishing"], k=5)[0]
    assert _bits(res) == _bits(want)
    assert obs.get_registry().gauges()["generation.current"] == gen_b
    with pytest.raises(ValueError) as got_err:
        frontend.reload_generation(generation=head)
    with pytest.raises(ValueError) as want_err:
        JaxScorer.load_generation(live, head)
    assert str(got_err.value) == str(want_err.value)
    assert "not servable" in str(got_err.value)
    assert frontend.scorer is got


def test_no_cuda_means_no_silent_cpu(live_dir, monkeypatch):
    """Without CUDA, load_generation raises unless asked for the CPU, and
    a CPU scorer's reload replays its device."""
    import torch

    live, gen_a, _ = live_dir
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scorer.load_generation(live, gen_a)
    cpu = Scorer.load_generation(live, gen_a, device="cpu")
    assert cpu.reload_generation().device.type == "cpu"
