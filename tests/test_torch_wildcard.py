"""Wildcard and fuzzy search in the port against the JAX package, on the
in-repo stdlib corpus plus a few non-ASCII documents, built by both
packages at k = 1 and k = 2 with their default char-grams (k = 2, 3):

- `WildcardLookup.expand` and `fuzzy` return the JAX package's terms in
  its order (globs, '?', non-ASCII patterns, limits, edits 0-2);
- the Scorer consults the same char-gram k for a fuzzy token;
- `analyze_queries` gives the JAX package's int32 id array bitwise: the
  questions that raised before this slice, glob and fuzzy tokens mixed,
  and a pattern over the 64-term limit (k = 1 keeps the highest-df
  matches, k > 1 the lexicographically first);
- `search_batch` gives its top-10 ids, scores within rtol 1e-5, on the
  dense and tiered layouts under TF-IDF and BM25;
- `expand` prints what the JAX package's CLI prints;
- a wildcard query wider than the coalescer's pinned width is served
  whole, bitwise its solo dispatch, and counted as unwarmed.
"""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

from tpu_ir.cli import main as jax_cli
from tpu_ir.index import build_index as jax_build_index
from tpu_ir.search import Scorer as JaxScorer
from tpu_ir.search.wildcard import WildcardLookup as JaxLookup

from tpu_ir_torch import obs
from tpu_ir_torch.cli import main as port_cli
from tpu_ir_torch.index import build_index
from tpu_ir_torch.search import Scorer, WildcardLookup
from tpu_ir_torch.serving import CoalescingScheduler

RTOL = 1e-5
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
STDLIB = os.path.join(ROOT, "data", "stdlib", "corpus.trec")

EXTRA = ("<DOC>\n<DOCNO> X-cafe </DOCNO>\n<TEXT>\nthe café serves crème "
         "brûlée and naïve coffee to the caffe crowd\n</TEXT>\n</DOC>\n"
         "<DOC>\n<DOCNO> X-uber </DOCNO>\n<TEXT>\nüber fast café threads "
         "and über slow cafés\n</TEXT>\n</DOC>\n")

# the questions that raised before this slice, then glob and fuzzy mixes
QUERIES = [
    "how do I sort a list?", "thread*", "pythn~",
    "sort* lisst~ a?c", "heap queu~2", "fi*sh,", "salmon,fish* (qu*)",
    "r?ad~", "river?", "~5 5~10", "dict~0 jsn~3", "caf*", "cafe~",
    "co* ne*", "regular expr*", "binary search*", "sort~ list",
    "json~ documents", "command-line pars*", "heap* queue",
]
# over the 64-term limit alone, and beside a literal or a second glob
# (k > 1: the window's product under the per-slot budget)
WIDE = ["s*", "p*", "return s*", "p* object", "s* e*"]


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """{k: (JAX-built dir, port-built dir)} for k = 1, 2."""
    d = tmp_path_factory.mktemp("wildcard")
    extra = d / "extra.trec"
    extra.write_text(EXTRA, encoding="utf-8")
    corpus = [STDLIB, str(extra)]
    out = {}
    for k in (1, 2):
        jdir, pdir = str(d / f"jax{k}"), str(d / f"port{k}")
        jax_build_index(corpus, jdir, k=k, num_shards=2)
        build_index(corpus, pdir, k=k, num_shards=2, device="cpu")
        out[k] = (jdir, pdir)
    return out


@pytest.fixture(scope="module")
def dense(indexes):
    """{k: (JAX Scorer, port Scorer)} on the dense layout, each over its
    own package's build."""
    return {k: (JaxScorer.load(j, layout="dense"),
                Scorer.load(p, layout="dense", device="cpu"))
            for k, (j, p) in indexes.items()}


LOOKUP_CASES = [
    ("expand", "th*", {}), ("expand", "*ing", {}), ("expand", "s?rt*", {}),
    ("expand", "*", {}), ("expand", "a*b*c*", {}), ("expand", "caf*", {}),
    ("expand", "*ü*", {}), ("expand", "cr?me", {}),
    ("expand", "s*", {"limit": 5}), ("expand", "zzzq*", {}),
    ("fuzzy", "pythn", {"max_edits": 1}), ("fuzzy", "sort", {"max_edits": 2}),
    ("fuzzy", "list", {"max_edits": 0}), ("fuzzy", "cat", {"max_edits": 1}),
    ("fuzzy", "cafe", {"max_edits": 1}), ("fuzzy", "ubr", {"max_edits": 2}),
    ("fuzzy", "thred", {"max_edits": 2, "limit": 3}),
]


@pytest.mark.parametrize("index_k", [1, 2])
@pytest.mark.parametrize("op,arg,kw", LOOKUP_CASES,
                         ids=[f"{o}-{a}-{'-'.join(map(str, kw.values()))}"
                              for o, a, kw in LOOKUP_CASES])
def test_lookup_matches_jax(indexes, index_k, op, arg, kw):
    """Each char-gram k's expansion, in order, over the port's build
    against the JAX package's lookup over its own build."""
    jdir, pdir = indexes[index_k]
    for ck in (2, 3):
        want = getattr(JaxLookup.load(jdir, ck), op)(arg, **kw)
        got = getattr(WildcardLookup.load(pdir, ck), op)(arg, **kw)
        assert got == want, (ck, got, want)


@pytest.mark.parametrize("k", [1, 2])
def test_fuzzy_lookup_picks_the_jax_chargram_k(dense, k):
    js, ts = dense[k]
    for tok, d in (("cat", 1), ("cat", 2), ("python", 1), ("ab", 1),
                   ("sorted", 2), ("é", 1)):
        assert ts._fuzzy_lookup_for(tok, d).k == \
            js._fuzzy_lookup_for(tok, d).k, (tok, d)


@pytest.mark.parametrize("k", [1, 2])
def test_analyze_queries_bitwise_jax(dense, k):
    js, ts = dense[k]
    for qs in (QUERIES, WIDE, QUERIES + WIDE):
        want = js.analyze_queries(qs)
        got = ts.analyze_queries(qs)
        assert got.dtype == want.dtype == np.int32
        assert got.shape == want.shape, (got.shape, want.shape)
        assert np.array_equal(got, want)
    # the cases that decide the contract actually occur here
    rows = ts.analyze_queries(QUERIES + WIDE)
    hits = [int((r >= 0).sum()) for r in rows]
    if k == 1:
        assert all(hits[:3]) and hits[len(QUERIES)] == Scorer.WILDCARD_LIMIT
    else:
        assert sum(map(bool, hits)) >= 5 and max(hits[len(QUERIES):]) > 1


def _same_top(want, got):
    for w, g in zip(want, got):
        assert [d for d, _ in g] == [d for d, _ in w], (w, g)
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   rtol=RTOL)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_search_batch_matches_jax(indexes, dense, k, layout):
    if layout == "dense":
        js, ts = dense[k]
    else:
        jdir, pdir = indexes[k]
        js = JaxScorer.load(jdir, layout="sparse")
        ts = Scorer.load(pdir, layout="sparse", device="cpu")
    qs = QUERIES + WIDE
    for scoring in ("tfidf", "bm25"):
        got = ts.search_batch(qs, scoring=scoring)
        assert sum(bool(r) for r in got) >= (10 if k == 1 else 4)
        _same_top(js.search_batch(qs, scoring=scoring), got)


def _run(cli, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["th*"], ["*ing", "-n", "5"], ["caf*", "--chargram-k", "2"],
    ["pythn~"], ["sort~3"], ["list~0"], ["cafe~", "--chargram-k", "2"],
    ["s*", "-n", "70"]], ids=lambda a: "_".join(a))
def test_expand_cli_prints_what_jax_prints(indexes, argv):
    jdir, pdir = indexes[2]
    rc_j, want = _run(jax_cli, ["expand", jdir] + argv)
    rc_p, got = _run(port_cli, ["expand", pdir] + argv)
    assert rc_p == rc_j == 0
    assert got == want and got


def test_wide_wildcard_rides_the_coalescer_whole(dense):
    """A glob wider than the pinned width is neither cut nor refused: the
    batch takes its width (64 slots, not 8), its results are its solo
    dispatch's bits, and the dispatch counts as unwarmed."""
    _, ts = dense[1]
    obs.reset_all()
    sched = CoalescingScheduler(ts, ladder=(1, 4, 16), width=8)
    sched.precompile(("tfidf",), ks=(10,))
    solo = ts.search_batch(["s* heap"], k=10)[0]
    got = sched.submit("s* heap", k=10, scoring="tfidf", rerank=None,
                       hot_only=False, force_host=False)
    def bits(res):
        return [(d, np.float32(s).view(np.int32)) for d, s in res]

    assert bits(got) == bits(solo) and got
    assert ts.analyze_queries(["s* heap"], width_floor=8).shape[1] == 128
    assert obs.get_registry().get("dispatch.unwarmed") >= 1
    obs.reset_all()
