"""The port's text analysis and corpus generator against the JAX package's.

tpu_ir_torch keeps its own copy of the analyzer, the TREC reader and
bench.make_corpus; term-id parity between the two packages rests on these
being identical, so every comparison here is exact."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import bench  # noqa: E402
from tpu_ir.analysis import Analyzer as JaxAnalyzer  # noqa: E402
from tpu_ir.analysis.native import tokenize_corpus_native  # noqa: E402
from tpu_ir.collection import read_trec_corpus as jax_read  # noqa: E402

from tpu_ir_torch.analysis import Analyzer  # noqa: E402
from tpu_ir_torch.collection import read_trec_corpus  # noqa: E402
from tpu_ir_torch.corpus import make_corpus  # noqa: E402

STDLIB = os.path.join(ROOT, "data", "stdlib", "corpus.trec")

EDGE_TEXTS = [
    "<DOC><DOCNO> X-1 </DOCNO><TEXT>The U.S.A. isn't Ünïcödé; "
    "e-mail foo@bar.com, 3.14 and C++ &amp; HTML</TEXT></DOC>",
    "Running runners ran; generously GENERATIONS of   whitespace\t\n",
    "<script>var x = 1;</script><p>salmon fishing on the river?</p>",
    "",
    "the and of a an",  # stopwords only
    "naïve café résumé — ‘quotes’ “double” fish*",
]


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("corpus") / "small.trec")
    make_corpus(path, seed=3, n_docs=60, target_bytes=60_000,
                vocab_size=2_000)
    return path


def test_analyzer_matches_on_generated_corpus(small_corpus):
    ours, theirs = Analyzer(), JaxAnalyzer()
    docs = list(read_trec_corpus([small_corpus]))
    assert len(docs) == 60
    for d in docs:
        assert ours.analyze(d.content) == theirs.analyze(d.content)


def test_analyzer_matches_on_stdlib_corpus():
    ours, theirs = Analyzer(), JaxAnalyzer()
    ours_docs = list(read_trec_corpus([STDLIB]))
    theirs_docs = list(jax_read([STDLIB]))
    assert len(ours_docs) == len(theirs_docs) == 144
    for a, b in zip(ours_docs, theirs_docs):
        assert (a.offset, a.docid) == (b.offset, b.docid)
        assert ours.analyze(a.content) == theirs.analyze(b.content)


@pytest.mark.parametrize("text", EDGE_TEXTS)
def test_analyzer_matches_on_edge_text(text):
    assert Analyzer().analyze(text) == JaxAnalyzer().analyze(text)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_corpus_byte_identical_to_bench(tmp_path, seed):
    kw = dict(n_docs=40, target_bytes=40_000, vocab_size=1_500)
    a, b = tmp_path / "port.trec", tmp_path / "bench.trec"
    assert make_corpus(str(a), seed=seed, **kw) == \
        bench.make_corpus(str(b), seed=seed, **kw)
    assert a.read_bytes() == b.read_bytes()


def test_make_corpus_defaults_are_the_ref_configuration():
    from tpu_ir_torch import corpus

    assert (corpus.DOC_COUNT, corpus.TARGET_BYTES, corpus.VOCAB_SIZE) == \
        (bench.DOC_COUNT, bench.TARGET_BYTES, bench.VOCAB_SIZE)


@pytest.mark.parametrize("which", ["generated", "stdlib"])
def test_python_analyzer_matches_native_vocab_and_ids(small_corpus, which):
    """The JAX package's k=1 build tokenizes with its C++ analyzer; the
    port uses the Python one. Both must give the same sorted vocabulary
    and the same term id for every occurrence."""
    path = small_corpus if which == "generated" else STDLIB
    native = tokenize_corpus_native([path])
    assert native is not None, "the native tokenizer did not build"
    docids, temp_ids, lengths, vocab_list = native
    vocab_arr = np.array(vocab_list, dtype=np.str_)
    order = np.argsort(vocab_arr)
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    native_ids = rank[temp_ids]

    analyzer = Analyzer()
    docs = list(read_trec_corpus([path]))
    toks = [analyzer.analyze(d.content) for d in docs]
    flat = np.array([t for ts in toks for t in ts], dtype=np.str_)
    uniques, inverse = np.unique(flat, return_inverse=True)
    assert uniques.tolist() == vocab_arr[order].tolist()
    # the native reader routes non-ASCII records through Python and
    # merges them in, so documents are matched by docid, not position
    ends = np.cumsum(lengths)
    native_docs = {d: native_ids[e - n:e].tolist()
                   for d, e, n in zip(docids, ends, lengths)}
    ends = np.cumsum([len(t) for t in toks])
    inverse = inverse.reshape(-1)
    ours = {d.docid: inverse[e - len(t):e].tolist()
            for d, e, t in zip(docs, ends, toks)}
    assert ours == native_docs
