"""The port's Zipf workload against `tpu_ir`'s on the CPU.

On the same index, `Workload.from_scorer` ranks the same terms, draws the
same requests in the same order for the same seed, and its burst schedule
(`pacing_scale`, `is_peak`) gives the same numbers; `make_queries`,
`resolve_workload` and the TPU_IR_WORKLOAD* knobs (the router's
TPU_IR_ROUTER_* ones too) read the environment as `tpu_ir`'s do. Also
the counterparts of tests/test_cache_tier.py's workload tests, and
`run_soak` under a Zipf workload."""

import random
import shutil

import pytest

from tpu_ir.search.scorer import Scorer as JaxScorer
from tpu_ir.serving import soak as jax_soak
from tpu_ir.serving import workload as jax_workload
from tpu_ir.utils import envvars as jax_envvars

from tpu_ir_torch import envvars, faults, obs
from tpu_ir_torch.index import build_index
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.serving import (
    ServingConfig,
    Workload,
    make_queries,
    resolve_workload,
    run_soak,
)
from tpu_ir_torch.serving import workload as port_workload

WORDS = ("salmon fishing river bears honey quick brown fox lazy dog "
         "market investor asset bond stock season rain forest".split())
SKEWS = (0.0, 0.7, 1.1, 1.5)
KNOBS = ("TPU_IR_WORKLOAD", "TPU_IR_WORKLOAD_SKEW", "TPU_IR_WORKLOAD_BURST",
         "TPU_IR_ROUTER_DEADLINE_MS", "TPU_IR_ROUTER_HEDGE_MS",
         "TPU_IR_ROUTER_CONNECT_MS", "TPU_IR_ROUTER_HEALTH_TTL_S")


@pytest.fixture(autouse=True)
def _clean_port_state(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    faults.clear()
    obs.reset_all()
    yield
    faults.clear()
    obs.reset_all()


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    """A skewed vocabulary: a few frequent words and a long tail."""
    tmp = tmp_path_factory.mktemp("workload")
    corpus = str(tmp / "c.trec")
    rng = random.Random(4)
    with open(corpus, "w") as f:
        for i in range(300):
            toks = [rng.choice(WORDS) for _ in range(rng.randint(3, 8))]
            toks += [f"w{int(rng.paretovariate(0.9)) % 400}"
                     for _ in range(rng.randint(1, 3))]
            f.write(f"<DOC>\n<DOCNO> D-{i:04d} </DOCNO>\n<TEXT>\n"
                    f"{' '.join(toks)}\n</TEXT>\n</DOC>\n")
    out = str(tmp / "idx")
    build_index(corpus, out, num_shards=2, device="cpu")
    return out


@pytest.fixture(scope="module")
def scorers(index_dir, tmp_path_factory):
    """The port's scorer and `tpu_ir`'s on a copy without the port's
    serving cache."""
    twin = str(tmp_path_factory.mktemp("workload_twin") / "idx")
    shutil.copytree(index_dir, twin,
                    ignore=shutil.ignore_patterns("serving-*"))
    return (Scorer.load(index_dir, layout="sparse", device="cpu"),
            JaxScorer.load(twin, layout="sparse"))


@pytest.mark.parametrize("skew", SKEWS)
def test_zipf_draws_equal_jax(scorers, skew):
    port_sc, jax_sc = scorers
    for seed in (0, 7):
        got = Workload.from_scorer(port_sc, kind="zipf", skew=skew,
                                   seed=seed, burst=0.5)
        want = jax_workload.Workload.from_scorer(
            jax_sc, kind="zipf", skew=skew, seed=seed, burst=0.5)
        assert got.terms == want.terms
        assert got.describe() == want.describe()
        assert got.make_queries(120) == want.make_queries(120)
        assert got.make_queries(40, seed=3) == want.make_queries(40, seed=3)
        assert [got.query_for_rank(r) for r in (0, 1, 99_999)] == [
            want.query_for_rank(r) for r in (0, 1, 99_999)]


@pytest.mark.parametrize("burst", [0.0, 0.5, 1.0, 3.0])
def test_burst_schedule_equals_jax(burst):
    got = Workload(["a", "b", "c"], burst=burst)
    want = jax_workload.Workload(["a", "b", "c"], burst=burst)
    fracs = [f / 97.0 for f in range(98)]
    assert [got.pacing_scale(f) for f in fracs] == [
        want.pacing_scale(f) for f in fracs]
    assert [got.is_peak(f) for f in fracs] == [want.is_peak(f)
                                              for f in fracs]
    if burst:
        scales = [got.pacing_scale(f) for f in fracs]
        assert min(scales) < 1.0 < max(scales)
        assert any(got.is_peak(f) for f in fracs)
    else:
        assert not any(got.is_peak(f) for f in fracs)


@pytest.mark.parametrize("spec", [None, "uniform", "zipf",
                                  {"kind": "zipf", "skew": 0.9,
                                   "burst": 1.0},
                                  {"kind": "uniform"}],
                         ids=["none", "uniform", "zipf", "spec", "spec-u"])
def test_make_queries_equals_jax(scorers, spec):
    port_sc, jax_sc = scorers
    for seed in (0, 5):
        assert make_queries(port_sc, 60, seed=seed, workload=spec) == \
            jax_soak.make_queries(jax_sc, 60, seed=seed, workload=spec)


def test_a_workload_instance_passes_through(scorers):
    port_sc, jax_sc = scorers
    wl = Workload.from_scorer(port_sc, kind="zipf", skew=1.2, seed=2)
    jwl = jax_workload.Workload.from_scorer(jax_sc, kind="zipf", skew=1.2,
                                            seed=2)
    assert resolve_workload(port_sc, wl, seed=9) is wl
    assert make_queries(port_sc, 30, seed=2, workload=wl) == \
        jax_soak.make_queries(jax_sc, 30, seed=2, workload=jwl)


@pytest.mark.parametrize("env", [
    {},
    {"TPU_IR_WORKLOAD": "zipf"},
    {"TPU_IR_WORKLOAD": "ZIPF ", "TPU_IR_WORKLOAD_SKEW": "1.3",
     "TPU_IR_WORKLOAD_BURST": "0.5"},
    {"TPU_IR_WORKLOAD": "zipf", "TPU_IR_WORKLOAD_SKEW": "-2",
     "TPU_IR_WORKLOAD_BURST": "-1"},
    {"TPU_IR_WORKLOAD": "uniform", "TPU_IR_WORKLOAD_SKEW": "1.3"},
    {"TPU_IR_WORKLOAD": ""},
], ids=["unset", "zipf", "zipf-knobs", "below-minimum", "uniform", "empty"])
def test_env_workload_equals_jax(scorers, monkeypatch, env):
    port_sc, jax_sc = scorers
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = resolve_workload(port_sc, None, seed=4)
    want = jax_workload.resolve_workload(jax_sc, None, seed=4)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.describe() == want.describe()
    assert make_queries(port_sc, 40, seed=4) == \
        jax_soak.make_queries(jax_sc, 40, seed=4)


def test_a_bad_workload_choice_raises_as_jax(scorers, monkeypatch):
    port_sc, jax_sc = scorers
    monkeypatch.setenv("TPU_IR_WORKLOAD", "pareto")
    with pytest.raises(ValueError):
        resolve_workload(port_sc, None)
    with pytest.raises(ValueError):
        jax_workload.resolve_workload(jax_sc, None)


@pytest.mark.parametrize("name", KNOBS[1:])
@pytest.mark.parametrize("value", [None, "0", "-3", "7.5", "1e3"])
def test_float_knobs_read_as_jax(monkeypatch, name, value):
    if value is not None:
        monkeypatch.setenv(name, value)
    assert envvars.get_float(name) == jax_envvars.get_float(name)


def test_zipf_is_seeded_and_shaped(scorers):
    """The counterparts of test_cache_tier.py's: one seed replays, the
    request dicts have the uniform soak's shape, the uniform kind is
    None, the skew concentrates the draw and repeats requests."""
    sc = scorers[0]
    w1 = Workload.from_scorer(sc, kind="zipf", skew=1.1, seed=7)
    w2 = Workload.from_scorer(sc, kind="zipf", skew=1.1, seed=7)
    q1 = w1.make_queries(50)
    assert q1 == w2.make_queries(50)
    assert set(q1[0]) == {"text", "scoring", "rerank", "k"}
    assert all(1 <= len(r["text"].split()) <= 3 for r in q1)
    assert Workload.from_scorer(sc, kind="uniform") is None
    rng = random.Random(0)

    def head_share(skew):
        w = Workload.from_scorer(sc, kind="zipf", skew=skew, seed=0)
        counts: dict = {}
        for _ in range(2000):
            t = w.draw_term(rng)
            counts[t] = counts.get(t, 0) + 1
        return max(counts.values()) / 2000.0, len(counts)

    hot_share, hot_distinct = head_share(1.5)
    uni_share, uni_distinct = head_share(0.0)
    assert hot_share > 3 * uni_share
    assert hot_distinct <= uni_distinct
    texts = [r["text"] for r in Workload.from_scorer(
        sc, kind="zipf", skew=1.5, seed=0).make_queries(200)]
    assert len(set(texts)) < len(texts)
    # the head term is the most frequent document-frequency term
    df = port_workload._df_ranking(sc, len(sc.vocab.terms))
    assert w1.terms[0] == sc.vocab.terms[int(df.argmax())]


def test_run_soak_under_a_zipf_workload(scorers):
    """run_soak draws a Zipf workload and paces it by its bursts; its
    report keeps the invariants and carries the workload's description
    and the run's result-cache activity, as tpu_ir's does."""
    sc = scorers[0]
    spec = {"kind": "zipf", "skew": 1.3, "burst": 1.0}
    report = run_soak(sc, threads=4, queries=48, seed=1, fault_spec=None,
                      config=ServingConfig(max_concurrency=4, max_queue=64,
                                           deadline_s=5.0,
                                           cache_entries=64),
                      timeout_s=60.0, workload=spec)
    assert report["served"] + report["shed"] == report["submitted"] == 48
    assert report["errors"] == report["deadlocked"] == 0
    assert report["untagged_mismatches"] == 0
    assert report["workload"] == Workload.from_scorer(
        sc, seed=1, **spec).describe()
    cache = report["cache"]
    assert set(cache) == {"hit", "miss", "evict", "stale_generation",
                          "hit_fraction"}
    assert cache["hit"] > 0 and cache["hit"] + cache["miss"] > 0
