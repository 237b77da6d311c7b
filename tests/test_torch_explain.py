"""Explain in the port: the exact per-term decomposition of a hit's score,
read out of the same score functions (and, on the card, the same
hand-written kernels) the production top-k ran.

Within the port, bitwise: for every explained hit, the float64 telescope
of the per-slot contributions equals the entry's score, which equals the
score `search_batch` returned, as float32 bits. Held on the dense and
tiered layouts, TF-IDF and BM25, raw and compressed (v3), compat_int_idf,
the rerank's cosine stage, the hot_only level, the MaxScore skip path and
prune off.

Against the JAX package, on the same index and the same (query, doc):
tf, df, placement, term ids and slot order are equal; idf, the
contributions and the scores within rtol 1e-5, atol 1e-6 (XLA and torch
round logs and sums differently in the last place). CPU only; the card's
version of the bitwise contract is in test_torch_cuda.py."""

import os
import shutil

import numpy as np
import pytest

from tpu_ir.search import Scorer as JaxScorer

from tpu_ir_torch import faults
from tpu_ir_torch.index import build_index
from tpu_ir_torch.index.migrate import migrate_index
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.search.explain import explain_hits

RTOL, ATOL = 1e-5, 1e-6

WORDS = ("salmon fishing river bears honey quick brown fox lazy dog "
         "market investor asset bond stock season rain forest".split())

# hot and cold, cold only (the skip path), a repeated slot, an unknown
# term, the hot term alone
QUERIES = ["common salmon", "salmon fishing river", "honey bears",
           "salmon salmon fishing", "zzznope salmon", "common",
           "bond stock common market", "fox dog lazy quick brown"]


@pytest.fixture(scope="module")
def index_dirs(tmp_path_factory):
    """(raw, v3) index dirs of a 150-doc corpus whose term "common" is in
    every doc (a hot-strip row on the tiered layout)."""
    tmp = tmp_path_factory.mktemp("explain")
    body = []
    for i in range(150):
        text = "common " + " ".join(WORDS[(i + j * (1 + i % 3)) % len(WORDS)]
                                    for j in range(3 + i % 7))
        body.append(f"<DOC>\n<DOCNO> D-{i:04d} </DOCNO>\n<TEXT>\n"
                    f"{text}\n</TEXT>\n</DOC>\n")
    corpus = tmp / "corpus.trec"
    corpus.write_text("".join(body))
    raw, v3 = str(tmp / "raw"), str(tmp / "v3")
    build_index(str(corpus), raw, num_shards=3, compute_chargrams=False,
                device="cpu")
    shutil.copytree(raw, v3)
    migrate_index(v3, to_version=3)
    return raw, v3


def check_hits(res, *, expect: int) -> list[dict]:
    """The contract: contribution_sum == score == the returned score, as
    float32 bits, for every explained hit, in the result's order."""
    entries = []
    for r in res:
        assert r.explain is not None or not r
        assert len(r.explain or []) == min(len(r), len(r.explain or []))
        for (key, score), e in zip(r, r.explain or []):
            assert e["docid"] == key
            assert np.float32(e["score"]).tobytes() == \
                np.float32(score).tobytes(), (key, e["score"], score)
            assert e["contribution_sum"] == e["score"] == score
            assert [t["slot"] for t in e["terms"]] == list(
                range(len(e["terms"])))
            entries.append(e)
    assert len(entries) >= expect
    return entries


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("scoring", ["tfidf", "bm25", "rerank"])
@pytest.mark.parametrize("variant", ["raw", "v3", "compat"])
def test_explain_bitwise_within_port(index_dirs, layout, scoring, variant):
    d = index_dirs[1] if variant == "v3" else index_dirs[0]
    s = Scorer.load(d, layout=layout, device="cpu",
                    compat_int_idf=variant == "compat")
    kw = {"rerank": 40} if scoring == "rerank" else {"scoring": scoring}
    res = s.search_batch(QUERIES, k=5, explain_k=4, **kw)
    entries = check_hits(res, expect=15)
    if scoring == "rerank":
        for e in entries:
            rr = e["rerank"]
            assert rr["in_candidates"] and rr["candidates"] == 40
            assert np.float64(rr["stage1_score"]) + np.float64(rr["delta"]) \
                == np.float64(e["score"])


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
@pytest.mark.parametrize("prune", [True, False])
def test_explain_skip_and_hot_only_paths(index_dirs, scoring, prune):
    """A hot-free query takes the skip path under the MaxScore schedule
    and explain follows it there; hot_only scores the strip alone and
    explain decomposes those partial scores."""
    s = Scorer.load(index_dirs[0], layout="sparse", device="cpu",
                    prune=prune)
    entries = check_hits(s.search_batch(QUERIES, k=5, scoring=scoring,
                                        explain_k=3), expect=15)
    skips = {e["query"]: e["dispatch"]["skip_hot"] for e in entries}
    assert skips["salmon fishing river"] is prune
    assert skips["common salmon"] is False
    res = s.search_batch(["common salmon", "bond stock common market"],
                         k=5, scoring="bm25", hot_only=True, explain_k=3)
    for e in check_hits(res, expect=2):
        assert e["dispatch"]["hot_only"] is True
        for t in e["terms"]:
            if t["placement"] != "hot":
                assert t["contribution"] == 0.0


def comparable(e):
    return [(t["slot"], t["term"], t["term_id"], t["df"], t["tf"],
             t["placement"]) for t in e["terms"]]


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("scoring", ["tfidf", "bm25", "rerank"])
def test_explain_matches_jax(index_dirs, layout, scoring):
    raw = index_dirs[0]
    s = Scorer.load(raw, layout=layout, device="cpu")
    js = JaxScorer.load(raw, layout=layout)
    rerank = 40 if scoring == "rerank" else None
    sc = "tfidf" if rerank else scoring
    n = 0
    for q in QUERIES:
        for key, _ in s.search_batch([q], k=4, scoring=sc,
                                     rerank=rerank)[0]:
            got = s.explain(q, key, scoring=sc, rerank=rerank)
            want = js.explain(q, key, scoring=sc, rerank=rerank)
            assert comparable(got) == comparable(want)
            assert got["dispatch"] == want["dispatch"]
            for f in ("docid", "docno", "scoring", "layout", "doc_len"):
                assert got[f] == want[f], f
            for f in ("score", "contribution_sum", "dl_norm", "doc_norm"):
                if f in want:
                    assert got[f] == pytest.approx(want[f], rel=RTOL,
                                                   abs=ATOL), f
            for g, w in zip(got["terms"], want["terms"]):
                assert g["idf"] == pytest.approx(w["idf"], rel=RTOL,
                                                 abs=ATOL)
                assert g["contribution"] == pytest.approx(
                    w["contribution"], rel=RTOL, abs=ATOL)
            n += 1
    assert n >= 20


def test_explain_api_edges_and_degraded(index_dirs):
    s = Scorer.load(index_dirs[0], layout="sparse", device="cpu")
    (res,) = s.search_batch(["honey bears"], k=1, scoring="bm25")
    key, score = res[0]
    e = s.explain("honey bears", key, scoring="bm25")
    assert e["contribution_sum"] == e["score"] == score
    assert e["k1"] == 0.9 and e["b"] == 0.4 and 0 < e["dl_norm"] < 3
    # no known term: an empty decomposition of score 0
    e0 = explain_hits(s, "zzznope qqqnope", [1], scoring="bm25")[0]
    assert e0["terms"] == [] and e0["score"] == e0["contribution_sum"] == 0
    # an out-of-range docno is an entry with an error, not a raise
    assert "error" in explain_hits(s, "honey", [10 ** 6])[0]
    # a rerank explain of a doc outside the candidates says so
    out = explain_hits(s, "honey bears", [s.meta.num_docs], rerank=5)[0]
    assert out["rerank"]["in_candidates"] in (True, False)
    # per-slot depths, and a degraded result carries none
    r = s.search_batch(["honey bears", "common salmon"], k=3,
                       explain_ks=[0, 2])
    assert r[0].explain is None and len(r[1].explain) == 2
    faults.install(faults.parse_plan("score.device_loss:first@1"))
    try:
        (bad,) = s.search_batch(["honey bears"], k=3, deadline_s=5.0,
                                explain_k=2)
    finally:
        faults.clear()
    assert bad.degraded and bad.explain is None
    assert os.path.isdir(index_dirs[0])
