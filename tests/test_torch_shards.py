"""Doc-range scorers in the port on the CPU (contracts (a) and (b) of the
shard worker tier).

(a) Within the port, bitwise: scorers restricted by
`shard_doc_ranges(D, S)` (S = 1, 2, 3, and an S whose trailing shard is
empty) merged by `merge_shard_topk` give the unrestricted scorer's
top-10 (docids, float32 score bits, tie order), on the dense and the
tiered layout, TF-IDF and BM25, raw and format v3 (whose doc-range load
decodes only the blocks the range touches); `merge_candidate_scores`
over the shards' `cosine_scores_at` gives the unrestricted rerank.

(b) Against `tpu_ir` on the same index: `shard_doc_ranges` and
`restrict_tiers` array for array and byte for byte, `decode_shard(
doc_range=)` array for array, a worker's top-10 the JAX worker's ids
with scores within rtol 1e-5 (ids inside a run of reference scores
within that tolerance compared as a set, as test_torch_tiered.py does),
and `doc_range` validation raising where the JAX package's raises.

Also: the host fallback's range mask (a degraded batch never holds
another shard's docs), `reload_generation` replaying a doc range
recomputed for a grown generation, and the residency hint's report
against the JAX package's, as a pure warm-up."""

import os
import random
import shutil

import numpy as np
import pytest

from tpu_ir.index import compress as jax_compress
from tpu_ir.search import layout as jax_layout
from tpu_ir.search.scorer import Scorer as JaxScorer
from tpu_ir.serving.residency import (
    prewarm_hot_residency as jax_prewarm_hot_residency,
)

from tpu_ir_torch import faults, obs
from tpu_ir_torch.index import build_index
from tpu_ir_torch.index import compress
from tpu_ir_torch.index import format as fmt
from tpu_ir_torch.index.ingest import IngestWriter
from tpu_ir_torch.index.migrate import migrate_index
from tpu_ir_torch.index.segments import LiveIndex
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.search.layout import (
    build_tiered_layout,
    restrict_tiers,
    shard_doc_ranges,
)
from tpu_ir_torch.search.scorer import _assemble_csr
from tpu_ir_torch.serving.residency import prewarm_hot_residency
from tpu_ir_torch.serving.router import (
    merge_candidate_scores,
    merge_shard_topk,
)

RTOL = 1e-5
WORDS = ("salmon fishing river bears honey quick brown fox lazy dog "
         "market investor asset bond stock season rain forest".split())
QUERIES = ["salmon fishing", "bears honey market", "quick",
           "rain forest investor", "asset bond stock season",
           "dog dog salmon", "nosuchterm", "fox market rain w17 w3",
           "w5 w42", "w101 salmon w7"]
N_DOCS = 1_200
# S with an empty trailing shard at N_DOCS: ceil(1200 / 41) = 30 docs a
# shard, so shards 0..39 hold all 1,200 and shard 40 holds none
EMPTY_TAIL = 41
SHARD_COUNTS = (1, 2, 3, EMPTY_TAIL)
RERANK = 25


@pytest.fixture(autouse=True)
def _clean_port_state():
    faults.clear()
    obs.reset_all()
    yield
    faults.clear()
    obs.reset_all()


def _write_corpus(path: str, n: int, seed: int = 0) -> None:
    """Frequent words and a long tail of rare ones: the tiered layout
    gets hot rows and several df tiers."""
    rng = random.Random(seed)
    with open(path, "w") as f:
        for i in range(n):
            toks = [rng.choice(WORDS) for _ in range(rng.randint(3, 9))]
            toks += [f"w{int(rng.paretovariate(0.8)) % 3000}"
                     for _ in range(rng.randint(1, 4))]
            f.write(f"<DOC>\n<DOCNO> D-{i:05d} </DOCNO>\n<TEXT>\n"
                    f"{' '.join(toks)}\n</TEXT>\n</DOC>\n")


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """The raw index the port built, and its format-v3 migration."""
    tmp = tmp_path_factory.mktemp("shards")
    corpus = str(tmp / "c.trec")
    _write_corpus(corpus, N_DOCS)
    raw = str(tmp / "raw")
    build_index(corpus, raw, num_shards=3, device="cpu")
    v3 = str(tmp / "v3")
    shutil.copytree(raw, v3)
    assert migrate_index(v3, to_version=3)["format_version"] == 3
    return {"raw": raw, "v3": v3}


_SCORERS: dict = {}


def _scorer(path: str, layout: str, doc_range=None) -> Scorer:
    key = (path, layout, doc_range)
    if key not in _SCORERS:
        _SCORERS[key] = Scorer.load(path, layout=layout, device="cpu",
                                    doc_range=doc_range)
    return _SCORERS[key]


def _bits(hits) -> list:
    return [(int(d), np.float32(s).tobytes()) for d, s in hits]


@pytest.mark.parametrize("shards", SHARD_COUNTS)
@pytest.mark.parametrize("form", ["raw", "v3"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_merged_shards_equal_the_whole_index(indexes, layout, form, shards):
    full = _scorer(indexes["raw"], layout)
    ranges = shard_doc_ranges(N_DOCS, shards)
    if shards == EMPTY_TAIL:
        assert ranges[-1][1] < ranges[-1][0]
    workers = [_scorer(indexes[form], layout, rg) for rg in ranges]
    if form == "v3":
        # the doc-range load decoded only the range's blocks, so it
        # wrote no serving cache
        assert not any(n.startswith("serving-")
                       for n in os.listdir(indexes["v3"]))
    for scoring in ("tfidf", "bm25"):
        want = full.search_batch(QUERIES, k=10, scoring=scoring,
                                 return_docids=False)
        per = [w.search_batch(QUERIES, k=10, scoring=scoring,
                              return_docids=False) for w in workers]
        for i, res in enumerate(want):
            got = merge_shard_topk([list(p[i]) for p in per], 10)
            assert _bits(got) == _bits(res), (scoring, QUERIES[i])
    # the rerank in two phases: the shards' BM25 top-C merged into the
    # candidates, then each candidate's cosine score from its owner
    for text in QUERIES:
        want = full.search_batch([text], k=10, rerank=RERANK,
                                 return_docids=False)[0]
        stage1 = [w.search_batch([text], k=RERANK, scoring="bm25",
                                 return_docids=False)[0] for w in workers]
        cand_hits = merge_shard_topk([list(h) for h in stage1], RERANK)
        cand = [d for d, _ in cand_hits]
        cand += [0] * (RERANK - len(cand))
        scores = {s: w.cosine_scores_at([text], cand)[0]
                  for s, w in enumerate(workers)}
        got = merge_candidate_scores(cand, scores, ranges, 10)
        assert _bits(got) == _bits(want), text
        # against the unrestricted scorer's stage 2 at the same candidates
        whole = full.cosine_scores_at([text], cand)[0]
        for s, (lo, hi) in enumerate(ranges):
            for pos, d in enumerate(cand):
                if lo <= d <= hi:
                    assert scores[s][pos].tobytes() == whole[pos].tobytes()


# -- against tpu_ir ----------------------------------------------------------


@pytest.mark.parametrize("num_docs,num_shards",
                         [(10, 3), (3, 5), (1, 1), (N_DOCS, 41), (0, 2),
                          (99_500, 2)])
def test_shard_doc_ranges_equal_jax(num_docs, num_shards):
    assert shard_doc_ranges(num_docs, num_shards) == \
        jax_layout.shard_doc_ranges(num_docs, num_shards)


def test_shard_doc_ranges_reject_zero_shards():
    for fn in (shard_doc_ranges, jax_layout.shard_doc_ranges):
        with pytest.raises(ValueError):
            fn(10, 0)


@pytest.mark.parametrize("rng_", [(1, 1_200), (1, 400), (401, 800),
                                  (801, 1_200), (300, 310), (1_201, 1_200)])
def test_restrict_tiers_equals_jax(indexes, monkeypatch, rng_):
    """The same layout restricted by both packages: every array, the
    block-max bounds at a block width that splits the doc axis
    included, byte for byte."""
    from tpu_ir.index import blockmax as jax_blockmax

    from tpu_ir_torch.index import blockmax

    monkeypatch.setenv("TPU_IR_BLOCKMAX_WIDTH", "64")
    meta = fmt.IndexMetadata.load(indexes["raw"])
    df, pair_doc, pair_tf = _assemble_csr(indexes["raw"], meta)
    tiers = build_tiered_layout(pair_doc, pair_tf, df,
                                num_docs=meta.num_docs)
    assert tiers.blockmax_width == 64 == blockmax.block_width() \
        == jax_blockmax.block_width()
    got = restrict_tiers(tiers, *rng_)
    want = jax_layout.restrict_tiers(jax_layout.TieredPostings(*tiers),
                                     *rng_)
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        if isinstance(a, tuple):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert np.asarray(x).dtype == np.asarray(y).dtype
                assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
        elif isinstance(a, np.ndarray):
            assert a.dtype == np.asarray(b).dtype, name
            assert a.tobytes() == np.asarray(b).tobytes(), name
        else:
            assert a == b, name
    # the geometry is shared, only tfs and bounds are copies
    assert got.hot_rank is tiers.hot_rank
    assert got.tier_docs is tiers.tier_docs


@pytest.mark.parametrize("doc_range", [None, (0, 64), (60, 130),
                                       (500, 900), (1_150, 1_201),
                                       (1_300, 1_400)])
def test_decode_shard_doc_range_equals_jax(indexes, doc_range):
    """A raw part encoded at a 64-doc block width decodes, under each
    half-open range, to the JAX package's arrays (dead slots where it
    skips a block)."""
    z = fmt.load_shard(indexes["raw"], 0)
    sections = compress.encode_shard(z, num_docs=N_DOCS, block_width=64)
    got = compress.decode_shard(sections, doc_range=doc_range)
    want = jax_compress.decode_shard(sections, doc_range=doc_range)
    assert sorted(got) == sorted(want)
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].tobytes() == want[name].tobytes(), name
    if doc_range is not None and doc_range[0] >= 500:
        assert (got["pair_doc"] == 0).any()    # some block was skipped


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_worker_top10_equals_jax_worker(indexes, tmp_path, layout):
    """A port worker and a JAX worker on the same shard of the same index
    (a copy without the port's serving cache): the same ids, scores
    within rtol 1e-5."""
    twin = str(tmp_path / "twin")
    shutil.copytree(indexes["raw"], twin,
                    ignore=shutil.ignore_patterns("serving-*"))
    for rg in shard_doc_ranges(N_DOCS, 3):
        port = _scorer(indexes["raw"], layout, rg)
        jax_w = JaxScorer.load(twin, layout=layout, doc_range=rg)
        for scoring in ("tfidf", "bm25"):
            got = port.search_batch(QUERIES, k=10, scoring=scoring,
                                    return_docids=False)
            want = jax_w.search_batch(QUERIES, k=10, scoring=scoring,
                                      return_docids=False)
            for g, w in zip(got, want):
                assert all(rg[0] <= d <= rg[1] for d, _ in g)
                _assert_same_ranking(w, g)


def _assert_same_ranking(want, got) -> None:
    """The same ids, scores within RTOL; ids are compared as a set inside
    a run of adjacent reference scores within RTOL (the two packages
    round such near-ties apart differently), and a run that reaches the
    k-th slot only by its length."""
    want_s = np.array([s for _, s in want], np.float64)
    want_d = [int(d) for d, _ in want]
    got_d = [int(d) for d, _ in got]
    assert len(got_d) == len(want_d)
    np.testing.assert_allclose([s for _, s in got], want_s, rtol=RTOL)
    i = 0
    while i < len(want_d):
        j = i + 1
        while j < len(want_d) and abs(want_s[j] - want_s[j - 1]) <= \
                RTOL * max(abs(want_s[j - 1]), 1e-30):
            j += 1
        if j < len(want_d) or j - i == 1:
            assert set(got_d[i:j]) == set(want_d[i:j]), (i, j)
        i = j


@pytest.mark.parametrize("doc_range", [(0, 10), (1, N_DOCS + 1), (-5, 3),
                                       (1, N_DOCS), (N_DOCS + 1, N_DOCS),
                                       (7, 3)])
def test_doc_range_validation_equals_jax(indexes, doc_range):
    def outcome(load):
        try:
            load()
        except ValueError as e:
            return ("ValueError", "outside the index's" in str(e))
        return ("ok", None)

    got = outcome(lambda: Scorer(
        **_ctor_args(indexes["raw"]), layout="sparse", device="cpu",
        doc_range=doc_range))
    want = outcome(lambda: JaxScorer.load(
        indexes["raw"], layout="sparse", doc_range=doc_range))
    assert got == want


def _ctor_args(index_dir: str) -> dict:
    """The constructor's arguments for an index (a direct construction
    validates doc_range before any upload)."""
    from tpu_ir_torch.collection import DocnoMapping, Vocab
    from tpu_ir_torch.ops.postings import pair_term_from_df

    meta = fmt.IndexMetadata.load(index_dir)
    df, pair_doc, pair_tf = _assemble_csr(index_dir, meta)
    return dict(vocab=Vocab.load(os.path.join(index_dir, fmt.VOCAB)),
                mapping=DocnoMapping.load(os.path.join(index_dir,
                                                       fmt.DOCNOS)),
                pair_term=pair_term_from_df(df), pair_doc=pair_doc,
                pair_tf=pair_tf, df=df,
                doc_len=np.load(os.path.join(index_dir, fmt.DOCLEN)),
                meta=meta)


# -- the host fallback, reload, residency -------------------------------------


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_host_fallback_keeps_to_the_range(indexes, layout):
    """A degraded (host) batch of a doc-range scorer ranks only its own
    docs: the unrestricted host ranking filtered to the range."""
    full = _scorer(indexes["raw"], layout)
    for rg in shard_doc_ranges(N_DOCS, 3):
        w = _scorer(indexes["raw"], layout, rg)
        got = w.search_batch(QUERIES, k=10, scoring="bm25",
                             return_docids=False, force_host=True)
        whole = full.search_batch(QUERIES, k=N_DOCS, scoring="bm25",
                                  return_docids=False, force_host=True)
        for g, h in zip(got, whole):
            assert g.degraded
            want = [(d, s) for d, s in h if rg[0] <= d <= rg[1]][:10]
            assert _bits(g) == _bits(want)


def test_reload_generation_replays_a_recomputed_doc_range(tmp_path):
    """A worker's scorer of generation A reloads generation B (grown) with
    the range recomputed for B's doc count, bitwise a fresh load of B
    with that range; without an override it replays A's range."""
    live = str(tmp_path / "live")
    LiveIndex.create(live, num_shards=2, chargram_ks=())
    rng = random.Random(3)

    def text():
        return " ".join(rng.choice(WORDS) for _ in range(rng.randint(3, 7)))

    with IngestWriter(live, auto_merge=False, device="cpu") as w:
        for i in range(40):
            w.add(f"D-{i:03d}", text())
        w.compact_all()
    gen_a = LiveIndex.open(live).current_gen()
    with IngestWriter(live, auto_merge=False, device="cpu") as w:
        for i in range(8):
            w.add(f"N-{i:03d}", text())
        w.compact_all()
    gen_b = LiveIndex.open(live).current_gen()
    ra, rb = shard_doc_ranges(40, 2)[1], shard_doc_ranges(48, 2)[1]
    assert (ra, rb) == ((21, 40), (25, 48))
    a = Scorer.load_generation(live, gen_a, layout="sparse", device="cpu",
                               doc_range=ra)
    b = a.reload_generation(doc_range=rb)
    assert (b.generation, b.doc_range, a.doc_range) == (gen_b, rb, ra)
    assert a.reload_generation().doc_range == ra     # replayed
    fresh = Scorer.load_generation(live, gen_b, layout="sparse",
                                   device="cpu", doc_range=rb)
    for scoring in ("tfidf", "bm25"):
        got = b.search_batch(QUERIES, k=10, scoring=scoring,
                             return_docids=False)
        want = fresh.search_batch(QUERIES, k=10, scoring=scoring,
                                  return_docids=False)
        assert [_bits(r) for r in got] == [_bits(r) for r in want]


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("mode", ["1", "0", "auto"])
def test_residency_report_equals_jax_and_changes_nothing(indexes, tmp_path,
                                                         layout, mode):
    twin = str(tmp_path / "twin")
    shutil.copytree(indexes["raw"], twin,
                    ignore=shutil.ignore_patterns("serving-*"))
    rg = shard_doc_ranges(N_DOCS, 2)[0]
    port = Scorer.load(indexes["raw"], layout=layout, device="cpu",
                       doc_range=rg)
    plain = _scorer(indexes["raw"], layout, rg)   # never prewarmed
    got = prewarm_hot_residency(port, mode=mode)
    want = jax_prewarm_hot_residency(
        JaxScorer.load(twin, layout=layout, doc_range=rg), mode=mode)
    assert sorted(got) == sorted(want)
    got.pop("warm_s", None)
    want.pop("warm_s", None)
    assert got == want
    for scoring in ("tfidf", "bm25"):
        got_r, want_r = (sc.search_batch(QUERIES, k=10, scoring=scoring,
                                         return_docids=False)
                         for sc in (port, plain))
        assert [_bits(r) for r in got_r] == [_bits(r) for r in want_r]
