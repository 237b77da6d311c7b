"""The two-stage rerank (BM25 candidates, then cosine TF-IDF) in the port
against the JAX package on the same index and queries: the doc norms
within rtol 1e-6, the stage-1 candidates and the reranked top-k on the
dense and the tiered layout (docs, scores within rtol 1e-5), the port's
dense rerank against its tiered one, the stdlib MRR / NDCG@10 of the
rerank equal to `tpu_ir`'s, a compressed index's rerank bitwise the raw
index's, and `search --rerank N` through the CLI."""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from tpu_ir.index import build_index as jax_build_index
from tpu_ir.search import Scorer as JaxScorer
from tpu_ir.search import scorer as jscorer
from tpu_ir.search.evaluate import evaluate_run, read_qrels

from tpu_ir_torch.cli import main as cli_main
from tpu_ir_torch.corpus import make_corpus
from tpu_ir_torch.index import build_index
from tpu_ir_torch.index.migrate import migrate_index
from tpu_ir_torch.ops import scoring
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.search.scorer import _assemble_csr, compute_doc_norms

RTOL = 1e-5
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
STDLIB = os.path.join(ROOT, "data", "stdlib")


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("rerank")
    corpus = str(d / "corpus.trec")
    make_corpus(corpus, seed=12, n_docs=300, target_bytes=300_000,
                vocab_size=3_000)
    idx = str(d / "idx")
    build_index(corpus, idx, num_shards=3, device="cpu")
    return idx


def _id_queries(scorer, b=120, seed=1):
    rng = np.random.default_rng(seed)
    v = scorer.meta.vocab_size
    hot = np.nonzero(np.asarray(scorer.hot_rank) >= 0)[0] if hasattr(
        scorer, "hot_rank") else np.arange(8)
    q = rng.integers(0, v, (b, 3)).astype(np.int32)
    q[::3, 0] = rng.choice(hot, len(q[::3]))
    q[4, 1] = q[4, 0]                               # a repeated term
    q[5, 1:] = -1
    q[6] = -1                                       # an empty query
    q[7, 2] = v + 3                                 # out of vocabulary
    return q


def _assert_same_ranking(want_s, want_d, got_s, got_d, rtol=RTOL):
    want_s, got_s = np.asarray(want_s, np.float64), np.asarray(got_s)
    np.testing.assert_allclose(got_s, want_s, rtol=rtol, atol=1e-6)
    want_d, got_d = list(want_d), list(got_d)
    assert len(want_d) == len(got_d)
    # runs of adjacent reference scores within rtol compare as sets; a run
    # that reaches the k-th slot may continue past it
    i = 0
    while i < len(want_d):
        j = i + 1
        while j < len(want_d) and abs(want_s[j] - want_s[j - 1]) <= \
                rtol * max(abs(want_s[j - 1]), 1e-30):
            j += 1
        if j < len(want_d) or j - i == 1:
            assert set(got_d[i:j]) == set(want_d[i:j]), (i, j)
        i = j


def test_doc_norms_match_jax(index_dir):
    meta = Scorer.load(index_dir, device="cpu").meta
    df, pair_doc, pair_tf = _assemble_csr(index_dir, meta)
    n = meta.num_docs
    want = jscorer.compute_doc_norms(None, pair_doc, pair_tf, df, n)
    got = compute_doc_norms(None, pair_doc, pair_tf, df, n)
    assert got.dtype == np.float32 and got.shape == (n + 1,)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the same with the term column given
    pair_term = np.repeat(np.arange(len(df)), df)
    np.testing.assert_array_equal(
        compute_doc_norms(pair_term, pair_doc, pair_tf, df, n), got)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_rerank_matches_jax(index_dir, layout):
    js = JaxScorer.load(index_dir, layout=layout, prune=False)
    ts = Scorer.load(index_dir, layout=layout, device="cpu")
    q = _id_queries(ts)
    # stage 1: the BM25 candidates
    _, wc = js.topk(q, k=50, scoring="bm25")
    _, gc = ts.topk(q, k=50, scoring="bm25")
    assert (np.asarray(wc) == gc).mean() > 0.98
    ws, wd = js.rerank_topk(q, k=10, candidates=50)
    gs, gd = ts.rerank_topk(q, k=10, candidates=50)
    assert gs.shape == (len(q), 10) and gd.dtype == np.int32
    assert (gd[6] == 0).all() and gd.any()
    for i in range(len(q)):
        _assert_same_ranking(np.asarray(ws)[i], np.asarray(wd)[i], gs[i],
                             gd[i])


def test_dense_rerank_equals_tiered(index_dir):
    dense = Scorer.load(index_dir, layout="dense", device="cpu")
    tiered = Scorer.load(index_dir, layout="sparse", device="cpu")
    q = _id_queries(tiered, seed=2)
    a = dense.rerank_topk(q, k=10, candidates=80)
    b = tiered.rerank_topk(q, k=10, candidates=80)
    for i in range(len(q)):
        _assert_same_ranking(a[0][i], a[1][i], b[0][i], b[1][i], rtol=1e-6)
    # the rerank's stage 1 is the scorer's own BM25 top-N, pruned or not
    off = Scorer.load(index_dir, layout="sparse", device="cpu", prune=False)
    c = off.rerank_topk(q, k=10, candidates=80)
    assert b[0].tobytes() == c[0].tobytes() and np.array_equal(b[1], c[1])


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_compressed_rerank_is_bitwise_raw(index_dir, tmp_path, layout):
    # both copies without the serving cache the JAX package's loads write
    # into the shared fixture dir: a hit there would bring its doc norms,
    # which are the JAX package's, not the port's
    raw_dir, v3 = str(tmp_path / "raw"), str(tmp_path / "v3")
    for d in (raw_dir, v3):
        shutil.copytree(index_dir, d,
                        ignore=shutil.ignore_patterns("serving-*"))
    migrate_index(v3, to_version=3)
    raw = Scorer.load(raw_dir, layout=layout, device="cpu")
    comp = Scorer.load(v3, layout=layout, device="cpu")
    assert comp.tf_dtype == torch.bfloat16
    q = _id_queries(raw, seed=3)
    a = raw.rerank_topk(q, k=10, candidates=60)
    b = comp.rerank_topk(q, k=10, candidates=60)
    assert a[0].tobytes() == b[0].tobytes() and np.array_equal(a[1], b[1])


def test_topk_over_candidates_matches_jax():
    from tpu_ir.ops import scoring as jscoring
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    s = (rng.integers(0, 4, (16, 40)) * 0.5).astype(np.float32)
    c = rng.integers(0, 30, (16, 40)).astype(np.int32)
    c[3] = 0
    for k in (1, 10, 40, 50):
        ws, wd = jscoring._topk_over_candidates(jnp.asarray(s),
                                                jnp.asarray(c), k)
        gs, gd = scoring._topk_over_candidates(torch.from_numpy(s),
                                               torch.from_numpy(c), k)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def _topics():
    text = open(os.path.join(STDLIB, "topics.trec"), encoding="utf-8").read()
    nums = re.findall(r"<num>\s*(?:Number:)?\s*(\S+)", text)
    titles = [t.strip() for t in re.findall(r"<title>([^\n<]*)", text)]
    assert len(nums) == len(titles) == 80
    return nums, titles


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_stdlib_rerank_quality_equals_jax(tmp_path, layout):
    """MRR / NDCG@10 / MAP of the rerank over the 80 judged stdlib
    topics, abs 1e-12 against the JAX package's."""
    idx = str(tmp_path / "stdlib-idx")
    build_index(os.path.join(STDLIB, "corpus.trec"), idx, num_shards=2,
                device="cpu", compute_chargrams=False)
    jidx = str(tmp_path / "stdlib-jax")
    jax_build_index(os.path.join(STDLIB, "corpus.trec"), jidx,
                    num_shards=2, compute_chargrams=False)
    qids, titles = _topics()
    qrels = read_qrels(os.path.join(STDLIB, "qrels.txt"))
    evals = []
    for scorer in (JaxScorer.load(jidx, layout=layout, prune=False),
                   Scorer.load(idx, layout=layout, device="cpu")):
        res = scorer.search_batch(titles, k=10, rerank=50)
        run = {q: [d for d, _ in r] for q, r in zip(qids, res) if r}
        evals.append(evaluate_run(run, qrels, complete=True,
                                  exp_gains=True))
    assert evals[0]["queries"] == 80
    for key in ("mrr", "ndcg_at_10", "map"):
        assert evals[1][key] == pytest.approx(evals[0][key], abs=1e-12), key
    assert evals[1]["mrr"] > 0.5


def test_cli_search_rerank(index_dir, capsys):
    js = JaxScorer.load(index_dir, layout="dense")
    df = np.asarray(js.df)
    mid = np.nonzero((df >= 10) & (df <= 60))[0]
    query = f"{js.vocab.terms[mid[0]]} {js.vocab.terms[mid[-1]]}"
    assert cli_main(["search", index_dir, "-q", query, "--rerank", "40",
                     "--k", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"query: {query}" and len(out) == 4
    (want,) = js.search_batch([query], k=3, rerank=40)
    got = [line.split()[1:] for line in out[1:]]
    assert [d for d, _ in got] == [d for d, _ in want]
    np.testing.assert_allclose([float(s) for _, s in got],
                               [s for _, s in want], rtol=1e-5)
