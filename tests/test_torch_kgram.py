"""Term-k-gram indexes (k > 1) and `search`'s batch surface in the port
against the JAX package, on the in-repo stdlib collection:

- k = 2 and k = 3 indexes built one-shot (char-grams over the token
  vocabulary, the `tokens.txt` sidecar) and streaming (radix, legacy,
  and the tokenizer pool; no char-grams, as in the JAX package) are
  byte-identical to the JAX package's;
- the port's Scorer answers a JAX-built k = 2 index with the JAX
  package's top-10 ids, scores within rtol 1e-5, dense and tiered,
  TF-IDF and BM25;
- `search --queries-file/--topics/--trec-run/--docnos/--compat`, the
  REPL, and `eval` over a run file print what the JAX package's CLI
  prints on the same index: the same lines, word for word, but a
  printed score may differ within rtol 1e-5 (XLA and torch round in
  the last place differently).
"""

import filecmp
import io
import os

import numpy as np
import pytest

from tpu_ir.cli import main as jax_cli
from tpu_ir.index import build_index as jax_build_index
from tpu_ir.index.streaming import build_index_streaming as jax_streaming
from tpu_ir.search import Scorer as JaxScorer

from tpu_ir_torch.cli import main as port_cli
from tpu_ir_torch.index import build_index, build_index_streaming

RTOL = 1e-5
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
STDLIB = os.path.join(ROOT, "data", "stdlib")
CORPUS = os.path.join(STDLIB, "corpus.trec")


def _same_tree(a: str, b: str) -> list[str]:
    """Every file of two index dirs but the job reports, compared byte
    for byte; returns the file names."""
    names = sorted(n for n in os.listdir(a) if n != "jobs")
    assert names == sorted(n for n in os.listdir(b) if n != "jobs")
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n
    return names


@pytest.mark.parametrize("k,mode", [
    (2, "oneshot"), (3, "oneshot"), (2, "radix"), (3, "radix"),
    (2, "legacy"), (2, "pool")])
def test_kgram_artifacts_byte_identical_to_jax(tmp_path, k, mode):
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    if mode == "oneshot":
        jax_build_index(CORPUS, want, k=k, num_shards=3)
        build_index(CORPUS, got, k=k, num_shards=3, device="cpu")
    else:
        kw = dict(k=k, num_shards=3, batch_docs=40,
                  radix_buckets=0 if mode == "legacy" else 4,
                  tokenize_procs=2 if mode == "pool" else 1)
        jax_streaming(CORPUS, want, **kw)
        build_index_streaming(CORPUS, got, device="cpu", **kw)
    names = _same_tree(want, got)
    has_grams = mode == "oneshot"
    assert ("tokens.txt" in names) == has_grams
    assert ("chargram-k2.npz" in names) == has_grams
    assert '"k": %d' % k in open(os.path.join(got, "metadata.json")).read()


@pytest.fixture(scope="module")
def jax_k2(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("k2") / "idx")
    jax_build_index(CORPUS, d, k=2, num_shards=2)
    return d


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_port_scorer_serves_a_jax_built_k2_index(jax_k2, layout):
    from tpu_ir_torch.search import Scorer

    js = JaxScorer.load(jax_k2, layout=layout)
    ts = Scorer.load(jax_k2, layout=layout, device="cpu")
    rng = np.random.default_rng(0)
    terms = js.vocab.terms
    # two- and three-token texts from the bigram vocabulary, so windows hit
    qs = [" ".join(terms[i].split() + terms[j].split()[:1])
          for i, j in rng.integers(0, len(terms), (24, 2))]
    qs += [terms[5], "binary search tree", "json"]
    for scoring in ("tfidf", "bm25"):
        want = js.search_batch(qs, scoring=scoring)
        got = ts.search_batch(qs, scoring=scoring)
        assert sum(bool(r) for r in got) >= 20
        for w, g in zip(want, got):
            assert [d for d, _ in g] == [d for d, _ in w], (w, g)
            np.testing.assert_allclose([s for _, s in g],
                                       [s for _, s in w], rtol=RTOL)


@pytest.fixture(scope="module")
def k1_index(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("k1") / "idx")
    jax_build_index(CORPUS, d, num_shards=2)
    return d


def _same_output(want: str, got: str) -> None:
    """The same lines and words; a word with a decimal point is a score,
    equal within RTOL."""
    wl, gl = want.splitlines(), got.splitlines()
    assert len(gl) == len(wl), (want, got)
    for w, g in zip(wl, gl):
        ww, gw = w.split(), g.split()
        assert len(ww) == len(gw), (w, g)
        for a, b in zip(ww, gw):
            if "." in a and a.replace(".", "", 1).isdigit():
                assert float(b) == pytest.approx(float(a), rel=RTOL,
                                                 abs=2e-6), (w, g)
            else:
                assert a == b, (w, g)


def _cli(cli, argv, capsys, monkeypatch, stdin=None) -> tuple[int, str]:
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    rc = cli(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def queries_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("q") / "queries.txt"
    p.write_text("heap queue\n\nsort a list?\nthread* pythn~\n"
                 "regular expression pattern matching\n")
    return str(p)


SEARCH_CASES = {
    "queries_file": ["--queries-file", "{qf}", "--k", "5"],
    "topics_trec_run": ["--topics", "{topics}", "--trec-run", "tag1",
                        "--scoring", "bm25"],
    "docnos": ["--queries-file", "{qf}", "--docnos", "--k", "3"],
    "compat": ["--queries-file", "{qf}", "--compat", "--k", "4"],
    "rerank": ["-q", "json encode*", "--rerank", "20", "--k", "4"],
    "repl": [],
    "repl_trec_run": ["--trec-run", "r"],
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_cli_prints_what_jax_prints(k1_index, queries_file, case,
                                           capsys, monkeypatch):
    args = [a.format(qf=queries_file,
                     topics=os.path.join(STDLIB, "topics.trec"))
            for a in SEARCH_CASES[case]]
    stdin = ("heap queue\n\nsort~ list\nexit\nnever read\n"
             if case.startswith("repl") else None)
    rc_j, want = _cli(jax_cli, ["search", k1_index] + args, capsys,
                      monkeypatch, stdin)
    rc_p, got = _cli(port_cli, ["search", k1_index, "--device", "cpu"]
                     + args, capsys, monkeypatch, stdin)
    assert rc_j == rc_p == 0 and got.strip()
    _same_output(want, got)
    if case == "compat":
        assert "compat mode: queries are limited to 1-2 words" in got
    if case.startswith("repl"):
        assert "never read" not in got


def test_eval_cli_prints_what_jax_prints(k1_index, tmp_path, capsys,
                                         monkeypatch):
    """A run from the port's `search --topics --trec-run`, scored by both
    packages' `eval` (and `--complete`); a run with no judged query
    exits 1 in both."""
    rc, run = _cli(port_cli, ["search", k1_index, "--device", "cpu",
                              "--topics", os.path.join(STDLIB, "topics.trec"),
                              "--trec-run", "t", "--scoring", "bm25"],
                   capsys, monkeypatch)
    assert rc == 0 and run.count("\n") >= 200
    path = tmp_path / "run.txt"
    path.write_text(run)
    qrels = os.path.join(STDLIB, "qrels.txt")
    for extra in ([], ["--complete"]):
        rc_j, want = _cli(jax_cli, ["eval", str(path), qrels] + extra,
                          capsys, monkeypatch)
        rc_p, got = _cli(port_cli, ["eval", str(path), qrels] + extra,
                         capsys, monkeypatch)
        assert rc_j == rc_p == 0 and got == want
        assert '"queries": 80' in got
    empty = tmp_path / "empty.txt"
    empty.write_text("999 Q0 nodoc 1 1.0 t\n")
    for cli in (jax_cli, port_cli):
        assert _cli(cli, ["eval", str(empty), qrels], capsys,
                    monkeypatch)[0] == 1
