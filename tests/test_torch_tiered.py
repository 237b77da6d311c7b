"""The port's tiered sparse layout end to end against the JAX package's
exact tiered path (`Scorer.load(dir, layout="sparse", prune=False)`) on a
~300-doc index: TF-IDF, BM25 and compat_int_idf through `topk` and
`search_batch`, the numpy state hand-over of `convert`, the port's own
dense layout, and `search --layout sparse` through the CLI.

Scores agree within rtol 1e-5 (XLA and torch round logs, the BM25
quotient and the hot-strip product differently in the last place); where
two adjacent reference scores lie within that tolerance, the doc ids are
compared as a set."""

import numpy as np
import pytest

from tpu_ir.index import build_index as jax_build_index
from tpu_ir.search import Scorer as JaxScorer
from tpu_ir.search.layout import build_tiered_layout as jax_build_tiered

import tpu_ir_torch
from tpu_ir_torch.cli import main as cli_main
from tpu_ir_torch.convert import tiered_scorer_from_numpy
from tpu_ir_torch.corpus import make_corpus
from tpu_ir_torch.search import Scorer

RTOL = 1e-5


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    """One ~300-doc corpus indexed by the JAX package."""
    d = tmp_path_factory.mktemp("tiered")
    corpus = str(d / "corpus.trec")
    make_corpus(corpus, seed=6, n_docs=300, target_bytes=300_000,
                vocab_size=3_000)
    idx = str(d / "idx")
    jax_build_index(corpus, idx, num_shards=3, compute_chargrams=False)
    return idx


@pytest.fixture(scope="module")
def scorers(index_dir):
    return (JaxScorer.load(index_dir, layout="sparse", prune=False),
            Scorer.load(index_dir, layout="sparse", device="cpu"))


def _queries(scorer, n=40, seed=0):
    """Text queries of 1-4 vocabulary terms, hot ones included, plus
    edge cases."""
    rng = np.random.default_rng(seed)
    terms = scorer.vocab.terms
    hot = [terms[i] for i in np.nonzero(np.asarray(scorer.hot_rank) >= 0)[0]]
    out = [" ".join(terms[i] for i in rng.integers(0, len(terms),
                                                    rng.integers(1, 4)))
           for _ in range(n)]
    out += [f"{hot[i % len(hot)]} {terms[int(rng.integers(len(terms)))]}"
            for i in range(8)]
    return out + ["", "qqqqzzzz", f"{terms[5]} {terms[5]}",
                  f"{hot[0]} {hot[0]} {hot[-1]}"]


def _id_queries(v, seed=1, b=200):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, v, (b, 3)).astype(np.int32)
    q[5, 1:] = -1
    q[6] = -1
    q[7, 0] = v + 2                                 # out of vocabulary
    q[8, 1] = q[8, 0]                               # a duplicated term
    return q


def _assert_same_ranking(want_s, want_d, got_s, got_d):
    want_s, got_s = np.asarray(want_s, np.float64), np.asarray(got_s)
    np.testing.assert_allclose(got_s, want_s, rtol=RTOL, atol=1e-6)
    want_d, got_d = list(want_d), list(got_d)
    assert len(want_d) == len(got_d)
    # runs of adjacent reference scores within RTOL are compared as
    # sets; a run that reaches the k-th slot may continue past it, so
    # only its length is pinned
    i = 0
    while i < len(want_d):
        j = i + 1
        while j < len(want_d) and abs(want_s[j] - want_s[j - 1]) <= \
                RTOL * max(abs(want_s[j - 1]), 1e-30):
            j += 1
        if j < len(want_d) or j - i == 1:
            assert set(got_d[i:j]) == set(want_d[i:j]), (i, j)
        i = j


def _assert_same_results(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        _assert_same_ranking([s for _, s in w], [d for d, _ in w],
                             [s for _, s in g], [d for d, _ in g])


def test_layout_is_tiered_with_hot_terms(scorers):
    js, ts = scorers
    assert ts.layout == "sparse"
    assert ts.hot_tfs.shape == tuple(js.hot_tfs.shape)
    assert ts.hot_tfs.shape[0] > 1 and len(ts.cold_tiers) >= 3
    np.testing.assert_array_equal(ts.hot_tfs.numpy(), np.asarray(js.hot_tfs))
    assert len(ts.cold_tiers) == len(js.tier_docs)
    for a, b in zip(ts.cold_tiers.docs, js.tier_docs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_scorer_builds_the_tier_table_once(index_dir, monkeypatch):
    """The kernel's tier table is built when the Scorer loads, and every
    query block's cold stage is one call with that same table."""
    from tpu_ir_torch.ops import cold_tier
    from tpu_ir_torch.search import scorer as scorer_mod

    built, seen = [], []

    class Counted(cold_tier.TierTable):
        def __init__(self, *args):
            super().__init__(*args)
            built.append(self)

    stage = cold_tier.cold_stage

    def spy(scores, q_tier, q_rows, q_w, tiers, **kw):
        seen.append((scores.shape[0], tiers))
        stage(scores, q_tier, q_rows, q_w, tiers, **kw)

    monkeypatch.setattr(scorer_mod, "TierTable", Counted)
    monkeypatch.setattr(cold_tier, "cold_stage", spy)
    ts = Scorer.load(index_dir, layout="sparse", device="cpu")
    assert len(built) == 1 and ts.cold_tiers is built[0]
    ts.SCORE_BUDGET = 40 * (ts.meta.num_docs + 1)   # blocks of 40 queries
    q = _id_queries(ts.meta.vocab_size, b=100)
    for scoring in ("tfidf", "bm25"):
        ts.topk(q, scoring=scoring)
    assert len(built) == 1
    # the MaxScore schedule: the hot-free queries' blocks, then the rest
    _, n_free, mode = ts._skip_plan(q)
    assert mode == "split"
    blocks = [min(40, n_free - lo) for lo in range(0, n_free, 40)] + [
        min(40, 100 - n_free - lo) for lo in range(0, 100 - n_free, 40)]
    assert [n for n, _ in seen] == blocks * 2
    assert all(t is built[0] for _, t in seen)


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
def test_search_batch_matches_jax(scorers, scoring):
    js, ts = scorers
    qs = _queries(js)
    _assert_same_results(js.search_batch(qs, scoring=scoring),
                         ts.search_batch(qs, scoring=scoring))


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
def test_topk_id_batch_matches_jax(scorers, scoring):
    js, ts = scorers
    q = _id_queries(js.meta.vocab_size)
    tpu_ir_torch.reset_kernel_launches()
    ws, wd = js.topk(q, k=10, scoring=scoring)
    gs, gd = ts.topk(q, k=10, scoring=scoring)
    assert tpu_ir_torch.kernel_launches() == {"dense_score": 0,
                                              "dequant_score": 0,
                                              "cold_tier": 0,
                                              "hot_stage": 0}
    assert gs.shape == (len(q), 10) and gd.dtype == np.int32
    assert (gd[6] == 0).all()
    for i in range(len(q)):
        _assert_same_ranking(ws[i], wd[i], gs[i], gd[i])


def test_compat_int_idf_matches_jax(index_dir):
    js = JaxScorer.load(index_dir, layout="sparse", prune=False,
                        compat_int_idf=True)
    ts = Scorer.load(index_dir, layout="sparse", compat_int_idf=True,
                     device="cpu")
    qs = _queries(js, seed=3)
    _assert_same_results(js.search_batch(qs), ts.search_batch(qs))


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
def test_small_blocks_match_one_block(scorers, scoring, monkeypatch):
    _, ts = scorers
    q = _id_queries(ts.meta.vocab_size, seed=4)
    want = ts.topk(q, scoring=scoring)
    monkeypatch.setattr(Scorer, "SCORE_BUDGET", 7 * (ts.meta.num_docs + 1))
    assert ts._block_size() == 7
    gs, gd = ts.topk(q, scoring=scoring)
    # the same bits: the hot stage adds each cell in a fixed order,
    # whatever the batch
    np.testing.assert_array_equal(gs.view(np.int32),
                                  want[0].view(np.int32))
    np.testing.assert_array_equal(gd, want[1])


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
def test_weighted_strip_cache_is_bitwise(scorers, scoring, monkeypatch):
    from tpu_ir_torch.search import scorer as scorer_mod

    _, ts = scorers
    q = _id_queries(ts.meta.vocab_size, seed=5)
    cached = ts.topk(q, scoring=scoring)
    assert ts._hot_wstrip(scoring) is not None
    monkeypatch.setattr(scorer_mod, "HOT_BUDGET", 1)   # no cache
    assert ts._hot_wstrip(scoring) is None
    raw = ts.topk(q, scoring=scoring)
    np.testing.assert_array_equal(raw[0].view(np.int32),
                                  cached[0].view(np.int32))
    np.testing.assert_array_equal(raw[1], cached[1])


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
def test_tiered_matches_port_dense(index_dir, scorers, scoring):
    _, ts = scorers
    dense = Scorer.load(index_dir, layout="dense", device="cpu")
    q = _id_queries(ts.meta.vocab_size, seed=2)
    ws, wd = dense.topk(q, scoring=scoring)
    gs, gd = ts.topk(q, scoring=scoring)
    for i in range(len(q)):
        _assert_same_ranking(ws[i], wd[i], gs[i], gd[i])


def test_auto_picks_sparse_above_dense_budget(index_dir, monkeypatch):
    from tpu_ir_torch.search import scorer as scorer_mod

    monkeypatch.setattr(scorer_mod, "DENSE_BUDGET", 10)
    s = Scorer.load(index_dir, device="cpu")
    assert s.layout == "sparse" and s._pairs is None
    assert not hasattr(s, "doc_matrix")


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
def test_tiered_scorer_from_numpy_matches(scorers, scoring):
    js, ts = scorers
    _, pair_doc, pair_tf = js._pairs
    jt = jax_build_tiered(np.asarray(pair_doc), np.asarray(pair_tf),
                          np.asarray(js.df), num_docs=js.meta.num_docs)
    conv = tiered_scorer_from_numpy(
        js.vocab.terms, js.mapping.docids, np.asarray(js.df),
        np.asarray(js.doc_len), jt._asdict(), dict(js.meta.__dict__),
        device="cpu")
    assert conv.layout == "sparse" and conv._pairs is None
    qs = _queries(js, seed=7)
    got = conv.search_batch(qs, scoring=scoring)
    _assert_same_results(js.search_batch(qs, scoring=scoring), got)
    assert got == ts.search_batch(qs, scoring=scoring)


def test_serving_knobs_raise_on_sparse(scorers):
    """explain answers on the tiered layout as `tpu_ir`'s does (the same
    terms, tfs, dfs and placements; contributions within RTOL), each
    decomposition summing to the port's own score bit for bit; hot_only,
    ported with the serving tier, answers as `tpu_ir`'s hot-only path
    does."""
    js, ts = scorers
    qs = _queries(js, seed=9)[:12]
    got = ts.search_batch(qs, explain_k=2)
    want = js.search_batch(qs, explain_k=2)
    n = 0
    for g, w in zip(got, want):
        for (key, score), ge in zip(g, g.explain or []):
            assert ge["contribution_sum"] == ge["score"] == score
            we = next((e for e in w.explain or [] if e["docid"] == key),
                      None)
            if we is None:
                continue
            assert [(t["term"], t["tf"], t["df"], t["placement"])
                    for t in ge["terms"]] == \
                [(t["term"], t["tf"], t["df"], t["placement"])
                 for t in we["terms"]]
            np.testing.assert_allclose(
                [t["contribution"] for t in ge["terms"]],
                [t["contribution"] for t in we["terms"]], rtol=RTOL,
                atol=1e-6)
            n += 1
    assert n >= 10
    for scoring in ("tfidf", "bm25"):
        _assert_same_results(
            js.search_batch(qs, scoring=scoring, hot_only=True),
            ts.search_batch(qs, scoring=scoring, hot_only=True))


def test_cli_search_layout_sparse(index_dir, scorers, capsys):
    js, _ = scorers
    term = js.vocab.terms[int(np.argmax(np.asarray(js.df)))]
    assert cli_main(["search", index_dir, "-q", term, "--layout", "sparse",
                     "--scoring", "bm25", "--k", "3",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"query: {term}" and len(out) == 4
    (want,) = js.search_batch([term], k=3, scoring="bm25")
    assert [line.split()[1].split("\t")[0] for line in out[1:]] == \
        [d for d, _ in want]
    assert cli_main(["search", index_dir, "-q", term, "--layout",
                     "sharded", "--device", "cpu"]) == 1
    assert "later slice" in capsys.readouterr().err
