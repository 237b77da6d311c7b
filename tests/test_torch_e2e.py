"""The port end to end against the JAX package on the same corpus:
identical index artifacts, the same top-10 from the same index, the same
results through the numpy state hand-over, and the same BM25 quality on
the in-repo stdlib collection.

Scores agree within rtol 1e-5 (XLA and torch round logs and sums
differently in the last place); where two adjacent reference scores lie
within that tolerance, the doc ids are compared as a set."""

import filecmp
import os
import re

import numpy as np
import pytest

from tpu_ir.index import build_index as jax_build_index
from tpu_ir.search import Scorer as JaxScorer
from tpu_ir.search import evaluate as jax_evaluate

from tpu_ir_torch.cli import main as cli_main
from tpu_ir_torch.convert import scorer_from_numpy
from tpu_ir_torch.corpus import make_corpus
from tpu_ir_torch.index import build_index
from tpu_ir_torch.index import format as fmt
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.search.evaluate import evaluate_run, read_qrels

RTOL = 1e-5
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
STDLIB = os.path.join(ROOT, "data", "stdlib")
SHARDS = 3


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """One ~300-doc corpus built by both packages."""
    d = tmp_path_factory.mktemp("e2e")
    corpus = str(d / "corpus.trec")
    make_corpus(corpus, seed=4, n_docs=300, target_bytes=300_000,
                vocab_size=3_000)
    jax_dir, port_dir = str(d / "jax"), str(d / "port")
    jax_build_index(corpus, jax_dir, num_shards=SHARDS,
                    compute_chargrams=False)
    build_index(corpus, port_dir, num_shards=SHARDS, device="cpu",
                compute_chargrams=False)
    return jax_dir, port_dir


@pytest.fixture(scope="module")
def scorers(built):
    jax_dir, _ = built
    return (JaxScorer.load(jax_dir, layout="dense"),
            Scorer.load(jax_dir, device="cpu"))


def _queries(scorer, n=40, seed=0):
    """Text queries of 1-3 vocabulary terms, plus edge cases."""
    rng = np.random.default_rng(seed)
    terms = scorer.vocab.terms
    out = [" ".join(terms[i] for i in rng.integers(0, len(terms),
                                                    rng.integers(1, 4)))
           for _ in range(n)]
    return out + ["", "qqqqzzzz", f"{terms[5]} {terms[5]}"]


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


def test_artifacts_byte_identical(built):
    jax_dir, port_dir = built
    names = ["vocab.txt", "docnos.txt", "doclen.npy", "dictionary.tsv"] + \
        [fmt.part_name(s) for s in range(SHARDS)]
    for n in names:
        assert filecmp.cmp(os.path.join(jax_dir, n),
                           os.path.join(port_dir, n), shallow=False), n


def test_metadata_matches_but_for_blockmax(built):
    """The whole metadata, the block-max bounds artifact's checksum
    included (the name dates from when the port wrote no bounds)."""
    jax_dir, port_dir = built
    jm, pm = (fmt.IndexMetadata.load(d) for d in built)
    assert jm.checksums["blockmax.arena"]
    assert pm == jm
    assert open(os.path.join(jax_dir, fmt.METADATA)).read() == open(
        os.path.join(port_dir, fmt.METADATA)).read()
    assert filecmp.cmp(os.path.join(jax_dir, "blockmax.arena"),
                       os.path.join(port_dir, "blockmax.arena"),
                       shallow=False)
    assert fmt.verify_checksums(port_dir, pm) == len(jm.checksums)


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
def test_search_batch_matches_jax(scorers, scoring):
    js, ts = scorers
    qs = _queries(js)
    want = js.search_batch(qs, scoring=scoring)
    got = ts.search_batch(qs, scoring=scoring)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        _assert_same_ranking([s for _, s in w], [d for d, _ in w],
                             [s for _, s in g], [d for d, _ in g])


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
def test_topk_id_batch_matches_jax(scorers, scoring):
    js, ts = scorers
    rng = np.random.default_rng(1)
    q = rng.integers(0, js.meta.vocab_size, (200, 2)).astype(np.int32)
    q[5, 1] = -1
    q[6] = -1
    q[7, 0] = js.meta.vocab_size + 2           # out of vocabulary
    ws, wd = js.topk(q, k=10, scoring=scoring)
    gs, gd = ts.topk(q, k=10, scoring=scoring)
    assert gs.shape == (200, 10) and gd.dtype == np.int32
    for i in range(len(q)):
        _assert_same_ranking(ws[i], wd[i], gs[i], gd[i])


def test_compat_int_idf_matches_jax(built):
    jax_dir, _ = built
    js = JaxScorer.load(jax_dir, layout="dense", compat_int_idf=True)
    ts = Scorer.load(jax_dir, compat_int_idf=True, device="cpu")
    qs = _queries(js, seed=3)
    for w, g in zip(js.search_batch(qs), ts.search_batch(qs)):
        _assert_same_ranking([s for _, s in w], [d for d, _ in w],
                             [s for _, s in g], [d for d, _ in g])


def test_port_built_index_serves_like_jax_built(built):
    jax_dir, port_dir = built
    a = Scorer.load(jax_dir, device="cpu")
    b = Scorer.load(port_dir, device="cpu")
    qs = _queries(a, seed=5)
    for scoring in ("tfidf", "bm25"):
        assert a.search_batch(qs, scoring=scoring) == \
            b.search_batch(qs, scoring=scoring)


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
def test_scorer_from_numpy_matches(scorers, scoring):
    js, ts = scorers
    pair_term, pair_doc, pair_tf = js._pairs
    conv = scorer_from_numpy(
        js.vocab.terms, js.mapping.docids, np.asarray(js.df),
        np.asarray(js.doc_len), pair_term, pair_doc, pair_tf,
        dict(js.meta.__dict__), device="cpu")
    qs = _queries(js, seed=7)
    want = js.search_batch(qs, scoring=scoring)
    got = conv.search_batch(qs, scoring=scoring)
    for w, g in zip(want, got):
        _assert_same_ranking([s for _, s in w], [d for d, _ in w],
                             [s for _, s in g], [d for d, _ in g])
    assert got == ts.search_batch(qs, scoring=scoring)


def _topics():
    text = open(os.path.join(STDLIB, "topics.trec"), encoding="utf-8").read()
    nums = re.findall(r"<num>\s*(?:Number:)?\s*(\S+)", text)
    titles = [t.strip() for t in re.findall(r"<title>([^\n<]*)", text)]
    assert len(nums) == len(titles) == 80
    return nums, titles


def test_stdlib_bm25_quality_equals_jax(tmp_path):
    """BM25 MRR / NDCG@10 over the 80 hand-judged stdlib topics, by the
    port's evaluate, which gives the JAX package's evaluate's numbers."""
    idx = str(tmp_path / "stdlib-idx")
    build_index(os.path.join(STDLIB, "corpus.trec"), idx, num_shards=2,
                device="cpu", compute_chargrams=False)
    jidx = str(tmp_path / "stdlib-jax")
    jax_build_index(os.path.join(STDLIB, "corpus.trec"), jidx,
                    num_shards=2, compute_chargrams=False)
    qids, titles = _topics()
    qrels = read_qrels(os.path.join(STDLIB, "qrels.txt"))
    assert qrels == jax_evaluate.read_qrels(os.path.join(STDLIB,
                                                         "qrels.txt"))
    evals = []
    for scorer in (JaxScorer.load(jidx, layout="dense"),
                   Scorer.load(idx, device="cpu")):
        res = scorer.search_batch(titles, k=10, scoring="bm25")
        run = {q: [d for d, _ in r] for q, r in zip(qids, res) if r}
        evals.append(evaluate_run(run, qrels, complete=True,
                                  exp_gains=True))
        for complete in (False, True):
            for exp_gains in (False, True):
                assert evaluate_run(run, qrels, complete, exp_gains) == \
                    jax_evaluate.evaluate_run(run, qrels, complete,
                                              exp_gains)
    assert evals[0]["queries"] == 80
    for key in ("mrr", "ndcg_at_10", "map"):
        assert evals[1][key] == pytest.approx(evals[0][key], abs=1e-12), key
    assert evals[1]["mrr"] >= 0.7


def test_load_rejects_a_corrupt_part(built, tmp_path):
    import shutil

    _, port_dir = built
    bad = str(tmp_path / "bad")
    shutil.copytree(port_dir, bad)
    part = os.path.join(bad, fmt.part_name(1))
    raw = bytearray(open(part, "rb").read())
    raw[-5] ^= 0xFF
    open(part, "wb").write(bytes(raw))
    with pytest.raises(fmt.IntegrityError, match="part-00001"):
        Scorer.load(bad, device="cpu")


@pytest.mark.parametrize("case", ["npz", "carena", "sparse", "sharded",
                                  "rerank", "phrase", "explain", "deadline",
                                  "k2", "chargrams", "positions", "prox"])
def test_later_slices_raise(built, tmp_path, capsys, case):
    import json

    jax_dir, port_dir = built
    if case in ("npz", "carena"):
        d = str(tmp_path / "idx")
        import shutil

        shutil.copytree(port_dir, d)
        if case == "carena":
            # compressed arenas are served now: a properly compressed
            # copy loads and answers as the raw index does
            from tpu_ir_torch.index.migrate import migrate_index

            migrate_index(d, to_version=fmt.COMPRESSED_FORMAT_VERSION)
            assert os.path.exists(os.path.join(d, "part-00000.carena"))
            s = Scorer.load(d, device="cpu")
            qs = _queries(s, seed=11)
            assert s.search_batch(qs) == Scorer.load(
                port_dir, device="cpu").search_batch(qs)
            return
        # v1 npz parts are served now: the rollback walk to npz gives
        # tpu_ir's parts, which load and answer as the raw index does; an
        # unknown format still raises
        from tpu_ir_torch.index.migrate import migrate_index

        migrate_index(d, to_version=fmt.FORMAT_VERSION)
        assert os.path.exists(os.path.join(d, "part-00000.npz"))
        s = Scorer.load(d, device="cpu")
        qs = _queries(s, seed=12)
        assert s.search_batch(qs) == Scorer.load(
            port_dir, device="cpu").search_batch(qs)
        meta = json.load(open(os.path.join(d, fmt.METADATA)))
        meta["format_version"] = 4
        json.dump(meta, open(os.path.join(d, fmt.METADATA), "w"))
        with pytest.raises(ValueError, match="unknown artifact format"):
            Scorer.load(d, device="cpu")
        return
    if case == "sharded":
        with pytest.raises(ValueError, match="later slice"):
            Scorer.load(port_dir, layout=case, device="cpu")
        return
    if case == "sparse":
        # the tiered layout serves, its hot_only knob too (the serving
        # tier), and explains its hot_only scores
        s = Scorer.load(port_dir, layout="sparse", device="cpu")
        assert s.layout == "sparse" and s.search_batch(["a"]) is not None
        assert s.search_batch(["a"], hot_only=True) is not None
        hot = [s.vocab.terms[i] for i in np.flatnonzero(
            s._hot_rank_host >= 0)[:8]]
        _assert_explained(s.search_batch(
            [f"{t} {u}" for t, u in zip(hot, _queries(s, seed=15))],
            hot_only=True, explain_k=2), least=len(hot))
        return
    if case == "chargrams":
        # char-gram indexes are built now, by default, byte-identical to
        # the JAX package's
        corpus = os.path.join(STDLIB, "corpus.trec")
        got, want = str(tmp_path / "port"), str(tmp_path / "jax")
        build_index(corpus, got, num_shards=2, device="cpu")
        jax_build_index(corpus, want, num_shards=2)
        for ck in (2, 3):
            name = f"chargram-k{ck}.npz"
            with open(os.path.join(got, name), "rb") as g, \
                    open(os.path.join(want, name), "rb") as w:
                assert g.read() == w.read(), name
        return
    if case == "k2":
        # k = 2 term-k-gram indexes are built now, byte-identical to the
        # JAX package's, the tokens.txt sidecar included
        corpus = os.path.join(STDLIB, "corpus.trec")
        got, want = str(tmp_path / "port"), str(tmp_path / "jax")
        build_index(corpus, got, k=2, num_shards=2, device="cpu")
        jax_build_index(corpus, want, k=2, num_shards=2)
        names = sorted(n for n in os.listdir(want) if n != "jobs")
        assert "tokens.txt" in names
        assert names == sorted(n for n in os.listdir(got) if n != "jobs")
        for n in names:
            assert filecmp.cmp(os.path.join(got, n), os.path.join(want, n),
                               shallow=False), n
        return
    if case in ("positions", "phrase"):
        # position runs are built now, byte-identical to the JAX
        # package's, and phrase queries answer over them with its results
        corpus = os.path.join(os.path.dirname(jax_dir), "corpus.trec")
        got, want = str(tmp_path / "port"), str(tmp_path / "jax")
        build_index(corpus, got, num_shards=SHARDS, device="cpu",
                    positions=True, compute_chargrams=False)
        jax_build_index(corpus, want, num_shards=SHARDS, positions=True,
                        compute_chargrams=False)
        names = sorted(n for n in os.listdir(want) if n != "jobs")
        assert "positions-00002.npz" in names
        for n in names:
            assert filecmp.cmp(os.path.join(got, n), os.path.join(want, n),
                               shallow=False), n
        if case == "phrase":
            s, js = Scorer.load(got, device="cpu"), JaxScorer.load(got)
            terms = js.vocab.terms
            qs = [f'"{terms[i]} {terms[i + 1]}" {terms[i + 7]}'
                  for i in range(0, 400, 20)]
            qs += [" ".join(f'"{t}"' for t in terms[i:i + 2])
                   for i in range(5, 400, 40)]
            for slop in (0, 3):
                assert [list(r) for r in s.search_batch(
                    qs, phrase_slop=slop)] == [list(r) for r in
                                                js.search_batch(
                                                    qs, phrase_slop=slop)]
        return
    if case == "prox":
        # the search flags of positions, phrases and snippets answer now;
        # on an index without positions or a store they fail as the JAX
        # package's command line does: the same exit code and message
        from tpu_ir.cli import main as jax_cli_main

        terms = Scorer.load(port_dir, device="cpu").vocab.terms
        for flag, rc in ((["--rerank", "20", "--prox"], 1),
                         (["--slop", "1"], 0), (["--show-matches"], 1),
                         (["--snippets"], 1)):
            argv = ["search", port_dir, "-q", " ".join(terms[7:10])] + flag
            assert cli_main(argv + ["--device", "cpu"]) == rc, flag
            got = capsys.readouterr()
            assert jax_cli_main(argv) == rc, flag
            want = capsys.readouterr()
            assert got.err.splitlines()[-1:] == want.err.splitlines()[-1:]
        return
    s = Scorer.load(port_dir, device="cpu")
    if case == "rerank":
        # the two-stage rerank answers now, as the JAX package's does
        js = JaxScorer.load(port_dir, layout="dense")
        qs = _queries(js, seed=13)
        got = s.search_batch(qs, rerank=100)
        want = js.search_batch(qs, rerank=100)
        for w, g in zip(want, got):
            _assert_same_ranking([x for _, x in w], [d for d, _ in w],
                                 [x for _, x in g], [d for d, _ in g])
        assert any(got)
        return
    if case == "deadline":
        # the per-batch deadline answers now (the serving tier): within
        # it, the same results, not degraded
        qs = _queries(s, seed=14)
        got = s.search_batch(qs, deadline_s=30.0)
        assert got == s.search_batch(qs)
        assert not any(r.degraded for r in got)
        return
    # explain answers now: each decomposition sums to its hit's score
    assert case == "explain"
    for scoring in ("tfidf", "bm25"):
        _assert_explained(s.search_batch(_queries(s, seed=16), k=5,
                                         scoring=scoring, explain_k=3))


def _assert_explained(results, least: int = 10) -> None:
    n = 0
    for res in results:
        for (key, score), e in zip(res, res.explain or []):
            assert e["docid"] == key
            assert e["contribution_sum"] == e["score"] == score
            n += 1
    assert n >= least


def test_auto_layout_above_dense_budget_raises(built, monkeypatch):
    """Above DENSE_BUDGET "auto" picks the tiered sparse layout; there the
    sharded layout still raises (a later slice)."""
    from tpu_ir_torch.search import scorer as scorer_mod

    _, port_dir = built
    monkeypatch.setattr(scorer_mod, "DENSE_BUDGET", 10)
    assert Scorer.load(port_dir, device="cpu").layout == "sparse"
    with pytest.raises(ValueError, match="later slice"):
        Scorer.load(port_dir, layout="sharded", device="cpu")


def test_cli_index_and_search(tmp_path, capsys, monkeypatch):
    idx = str(tmp_path / "idx")
    corpus = os.path.join(STDLIB, "corpus.trec")
    assert cli_main(["index", corpus, idx, "--shards", "2",
                     "--device", "cpu"]) == 0
    meta = capsys.readouterr().out
    assert '"num_docs": 144' in meta
    assert cli_main(["search", idx, "-q", "heap queue priority",
                     "--scoring", "bm25", "--k", "3",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "query: heap queue priority"
    assert len(out) == 4 and "PY-heapq" in "\n".join(out[1:])
    # without -q (or a queries file) search is the REPL over stdin
    import io

    monkeypatch.setattr("sys.stdin",
                        io.StringIO("heap queue priority\nexit\n"))
    assert cli_main(["search", idx, "--scoring", "bm25", "--k", "3",
                     "--device", "cpu"]) == 0
    repl = capsys.readouterr().out.splitlines()
    assert repl[0].startswith("tpu-ir: 144 docs") and repl[1:] == out
