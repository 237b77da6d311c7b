"""Phrase and proximity queries and snippets in the port, held against the
JAX package on one stdlib-corpus index built with positions and a
document store (144 documents; both packages build it byte for byte, see
test_torch_positions.py):

- phrase results (ids and the host float32 scores) equal the JAX
  package's bitwise, at slop 0 and 2, TF-IDF, BM25 and the host rerank;
- the proximity-boosted rerank equals the JAX package's ids, scores
  within rtol 1e-5 (the boost multiplies the device rerank's scores,
  which XLA and torch round differently in the last place);
- match_window equals a brute-force oracle over the analyzed token
  streams;
- `search --show-matches`, `--snippets` and the errors on an index
  without positions or a store print what the JAX package's command
  line prints.
Everything runs on the CPU."""

import io
import itertools
import os
import re

import numpy as np
import pytest

from tpu_ir.cli import main as jax_cli
from tpu_ir.search import Scorer as JaxScorer

from tpu_ir_torch.cli import main as port_cli
from tpu_ir_torch.index import build_index
from tpu_ir_torch.index.builder import analyze_corpus
from tpu_ir_torch.index.docstore import build_docstore
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.search.phrase import (
    PhraseIndex,
    cosine_score_host,
    split_phrases,
)
from tpu_ir_torch.search.snippets import make_snippet

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CORPUS = os.path.join(ROOT, "data", "stdlib", "corpus.trec")
RTOL = 1e-5


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(index dir with positions and a store, the index dir of a plain
    build, per-doc analyzed tokens by docno)."""
    d = tmp_path_factory.mktemp("phrase")
    idx, plain = str(d / "pos"), str(d / "plain")
    build_index(CORPUS, idx, num_shards=2, positions=True, device="cpu")
    build_docstore(CORPUS, idx)
    build_index(CORPUS, plain, num_shards=2, compute_chargrams=False,
                device="cpu")
    docids, toks = analyze_corpus([CORPUS])
    s = Scorer.load(idx, device="cpu")
    by_docno = {s.mapping.get_docno(i): t for i, t in zip(docids, toks)}
    return idx, plain, by_docno


@pytest.fixture(scope="module")
def scorers(built):
    idx = built[0]
    return Scorer.load(idx, device="cpu"), JaxScorer.load(idx,
                                                          layout="dense")


def phrase_texts(by_docno, n=40, seed=12):
    """Quoted windows of 2-3 consecutive analyzed tokens of random docs
    (so a doc matches), half of them with one free term added."""
    rng = np.random.default_rng(seed)
    docnos = sorted(by_docno)
    out = []
    while len(out) < n:
        toks = by_docno[docnos[rng.integers(len(docnos))]]
        m = int(rng.integers(2, 4))
        if len(toks) < m + 1:
            continue
        i = int(rng.integers(len(toks) - m + 1))
        text = '"' + " ".join(toks[i:i + m]) + '"'
        if len(out) % 2:
            text += " " + toks[int(rng.integers(len(toks)))]
        out.append(text)
    return out + ['"no such phrase qqzz"', '19" rack', '""', '"heap"']


@pytest.mark.parametrize("slop", [0, 2])
@pytest.mark.parametrize("mode", ["tfidf", "bm25", "rerank"])
def test_phrase_results_bitwise_jax(built, scorers, slop, mode):
    s, js = scorers
    texts = [t for t in phrase_texts(built[2]) if split_phrases(t)[1]
             and s._query_term_sequence(split_phrases(t)[1][0])]
    kw = ({"rerank": 50} if mode == "rerank" else {"scoring": mode})
    got = s.search_batch(texts, phrase_slop=slop, **kw)
    want = js.search_batch(texts, phrase_slop=slop, **kw)
    assert sum(map(len, got)) > len(texts)
    if mode != "rerank":
        assert [list(r) for r in got] == [list(r) for r in want]
        return
    # the host cosine divides by the doc norms, whose float32 idf each
    # package computes with its own log10 (XLA, torch): ids equal,
    # scores within RTOL; on the same norms the host cosine is bitwise
    for w, g in zip(want, got):
        assert_same_ranking(list(w), list(g))
    from tpu_ir.search.phrase import cosine_score_host as jax_cosine

    pidx = s._phrase_index()
    norms = js._doc_norms_host()
    for t in texts:
        terms = s._query_term_sequence(t.replace('"', " "))
        docs = sorted(pidx.doc_set(terms[0]).tolist())[:200]
        gd, gs = cosine_score_host(terms, docs, dictionary=pidx._dict,
                                   num_docs=s.meta.num_docs,
                                   doc_norms=norms)
        wd, ws = jax_cosine(terms, docs, dictionary=js._phrase_index()._dict,
                            num_docs=s.meta.num_docs, doc_norms=norms)
        assert gd.tolist() == wd.tolist()
        assert gs.tobytes() == ws.tobytes()


def assert_same_ranking(want, got):
    """Equal ids, scores within RTOL; a run of reference scores within
    RTOL of each other is compared as a set."""
    ws = np.array([x for _, x in want]); gs = np.array([x for _, x in got])
    assert len(ws) == len(gs)
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=1e-6)
    i = 0
    while i < len(want):
        j = i + 1
        while j < len(want) and abs(ws[j] - ws[j - 1]) <= RTOL * ws[j - 1]:
            j += 1
        if j < len(want):
            assert {d for d, _ in want[i:j]} == {d for d, _ in got[i:j]}
        i = j


def test_prox_rerank_equals_jax(built, scorers):
    s, js = scorers
    rng = np.random.default_rng(3)
    terms = s.vocab.terms
    texts = [" ".join(terms[i] for i in rng.integers(0, len(terms), 2))
             for _ in range(20)]
    texts += ["heap queue", "binary search tree", "regular expression"]
    texts += phrase_texts(built[2], n=6)
    got = s.search_batch(texts, rerank=100, prox=True)
    want = js.search_batch(texts, rerank=100, prox=True)
    for w, g in zip(want, got):
        assert_same_ranking(list(w), list(g))
    boosted = s.search_batch(["heap queue"], rerank=100, prox=True)[0]
    plain = s.search_batch(["heap queue"], rerank=100)[0]
    assert boosted[0][1] > plain[0][1]       # adjacency raises the score
    assert boosted.explain is None
    with pytest.raises(ValueError, match="rerank"):
        s.search_batch(["heap queue"], prox=True)


def oracle_window(tokens, terms, slop):
    """Whether `terms` occur as an ordered window with at most slop
    extra gaps, by trying every combination of positions."""
    pos = [[i for i, t in enumerate(tokens) if t == term] for term in terms]
    span = len(terms) - 1 + slop
    for combo in itertools.product(*pos):
        if all(a < b for a, b in zip(combo, combo[1:])) and \
                combo[-1] - combo[0] <= span:
            return True
    return False


@pytest.mark.parametrize("slop", [0, 1, 3])
def test_match_window_equals_brute_force(built, slop):
    idx, _, by_docno = built
    pidx = PhraseIndex(idx)
    rng = np.random.default_rng(100 + slop)
    docnos = sorted(by_docno)
    for _ in range(25):
        toks = by_docno[docnos[rng.integers(len(docnos))]]
        m = int(rng.integers(2, 4))
        if len(toks) < 6:
            continue
        # a window of the doc with one term swapped for another of the doc,
        # so some phrases match only with slop, some nowhere
        i = int(rng.integers(len(toks) - m + 1))
        terms = toks[i:i + m]
        if rng.random() < 0.5:
            terms = list(terms)
            terms[int(rng.integers(m))] = toks[int(rng.integers(len(toks)))]
        want = [d for d in docnos if oracle_window(by_docno[d], terms, slop)]
        assert pidx.match_window(list(terms), slop=slop) == want, terms


def run(cli, argv, capsys, monkeypatch=None, stdin=None):
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    rc = cli(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("flags", [
    ["--show-matches"],
    ["--show-matches", "--docnos", "--slop", "1"],
    ["--snippets"],
    ["--snippets", "--show-matches", "--scoring", "bm25", "--k", "3"]])
def test_search_cli_flags_print_what_jax_prints(built, capsys, flags):
    idx = built[0]
    hits = 0
    for q in ['"heap queue"', '"binary search" insort', '"sort" list',
              '"regular expression" pattern']:
        argv = ["search", idx, "-q", q] + flags
        got = run(port_cli, argv + ["--device", "cpu"], capsys)
        want = run(jax_cli, argv, capsys)
        assert got == want and got[0] == 0
        hits += got[1].count("  1. ")
    assert hits >= 3
    assert ("**" in got[1]) == ("--snippets" in flags)


def test_cli_refusals_print_what_jax_prints(built, capsys):
    """An index without positions refuses a phrase query and --prox, one
    without a store refuses --snippets: the same message and exit code.
    --prox with a rerank answers."""
    idx, plain, _ = built
    for argv in (["search", plain, "-q", '"heap queue"'],
                 ["search", plain, "-q", "heap queue", "--rerank", "10",
                  "--prox"],
                 ["search", plain, "-q", "heap", "--snippets"],
                 ["search", idx, "-q", "heap queue", "--prox"]):
        got = run(port_cli, argv + ["--device", "cpu"], capsys)
        want = run(jax_cli, argv, capsys)
        assert got[0] == want[0] == 1
        assert got[2].splitlines()[-1] == want[2].splitlines()[-1]
        assert got[2].startswith("error: ")
    rc, out, _ = run(port_cli, ["search", idx, "-q", "heap queue",
                                "--rerank", "10", "--prox", "--device",
                                "cpu"], capsys)
    assert rc == 0 and "PY-heapq" in out


def test_snippets_equal_jax(built, scorers):
    """Scorer.snippet equals the JAX package's for every hit, k-gram-free
    and quoted queries alike, and marks the analyzed query tokens."""
    s, js = scorers
    analyzer = s._analyzer()
    marked = 0
    for q in ["heap queue", '"binary search"', "Fishing sorting lists",
              "qqzz"]:
        toks = set(analyzer.analyze(q.replace('"', " ")))
        for key, _ in s.search_batch([q], k=5)[0]:
            got = s.snippet(q, key)
            assert got == js.snippet(q, key)
            for word in re.findall(r"\*\*(.+?)\*\*", got):
                assert toks & set(analyzer.analyze(word)), (q, word)
                marked += 1
    assert marked >= 10
    doc = "<DOC><DOCNO>X</DOCNO><TEXT>" + "word " * 5000 + \
        "salmon fishing</TEXT></DOC>"
    a = make_snippet(doc, {"salmon", "fish"}, s._analyzer())
    assert "**salmon**" in a and "**fishing**" in a


def test_frontend_snippets_equal_jax(scorers):
    """ServingFrontend.search(snippets=True) attaches one snippet a hit,
    the JAX frontend's; a snippet request bypasses the result cache, and
    a degraded answer carries none."""
    from tpu_ir.serving import ServingConfig as JaxConfig
    from tpu_ir.serving import ServingFrontend as JaxFrontend

    from tpu_ir_torch import faults
    from tpu_ir_torch.serving import ServingConfig, ServingFrontend

    s, js = scorers
    fe = ServingFrontend(s, ServingConfig(cache_entries=16))
    jfe = JaxFrontend(js, JaxConfig(cache_entries=16))
    for q in ["heap queue", "regular expression", '"heap queue"']:
        got = fe.search(q, k=4, snippets=True)
        want = jfe.search(q, k=4, snippets=True)
        assert got.snippets == want.snippets and len(got.snippets) == \
            len(got) > 0
        assert fe.search(q, k=4).snippets is None
    assert fe.stats()["cache"]["entries"] == 2    # the plain requests only
    faults.install(faults.parse_plan("score.device_loss:always"))
    try:
        bad = ServingFrontend(s, ServingConfig(deadline_s=5.0)).search(
            "heap queue", k=4, snippets=True)
    finally:
        faults.clear()
    assert bad.degraded and bad.snippets is None


def test_concurrent_snippets_and_phrases_equal_serial(scorers):
    """The document store and the phrase index are shared by the serving
    threads: snippets and phrase queries from 8 threads at once equal the
    serial ones."""
    import threading

    s, _ = scorers
    hits = [(q, key) for q in ("heap queue", "regular expression",
                               "sort list", "thread lock")
            for key, _ in s.search_batch([q], k=10)[0]]
    phrases = ['"heap queue"', '"regular expression" match',
               '"sort" list', '"binary search"']
    want_snip = [s.snippet(q, key) for q, key in hits]
    want_phrase = [list(s.search_batch([p])[0]) for p in phrases]
    errors = []

    def client(ci):
        try:
            for i in range(len(hits)):
                q, key = hits[(ci + i) % len(hits)]
                assert s.snippet(q, key) == want_snip[(ci + i) % len(hits)]
                j = (ci + i) % len(phrases)
                assert list(s.search_batch([phrases[j]])[0]) == \
                    want_phrase[j]
        except BaseException as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and len(hits) >= 20
