"""Block-max pruning in the port against the JAX package on the same
inputs: the bounds artifact (`blockmax.arena`) and the metadata byte for
byte, the layout's bounds element- and dtype-exact, quarantine of a
corrupt artifact, `migrate-index --add-bounds`; and the scoring half,
held as the JAX package's own suite holds it (`tests/test_blockmax.py`):
the port's block-max top-k bitwise equal to the port's exact tiered
top-k across k, scoring and query regime, the pruned branch engaged, and
the exact path within rtol 1e-5 of `tpu_ir`'s exact tiered path (never
of `tpu_ir`'s block-max output, which fails its own bitwise pin on this
JAX). Through the Scorer: the MaxScore schedule and block-max on == off
bitwise in the caller's order, and `prune_diag` equal to `tpu_ir`'s."""

import filecmp
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpu_ir.index import blockmax as jbmx
from tpu_ir.index import build_index as jax_build_index
from tpu_ir.index.migrate import migrate_index as jax_migrate_index
from tpu_ir.ops import scoring as jscoring
from tpu_ir.search import Scorer as JaxScorer
from tpu_ir.search.layout import build_tiered_layout as jax_build_tiered

from tpu_ir_torch.cli import main as cli_main
from tpu_ir_torch.index import blockmax as bmx
from tpu_ir_torch.index import build_index
from tpu_ir_torch.index import format as fmt
from tpu_ir_torch.index.migrate import migrate_index
from tpu_ir_torch.ops import scoring
from tpu_ir_torch.ops.cold_tier import TierTable
from tpu_ir_torch.search import Scorer, layout

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
STDLIB = os.path.join(ROOT, "data", "stdlib", "corpus.trec")
NDOCS = 6000  # > 8 blocks at width 512, wide enough for k = 1000
RTOL = 1e-5


# -- the artifact --------------------------------------------------------


@pytest.fixture(scope="module")
def stdlib_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("bounds")
    jax_dir, port_dir = str(d / "jax"), str(d / "port")
    jax_build_index(STDLIB, jax_dir, num_shards=2, compute_chargrams=False)
    build_index(STDLIB, port_dir, num_shards=2, device="cpu",
                compute_chargrams=False)
    return jax_dir, port_dir


def _same_file(a, b):
    return filecmp.cmp(a, b, shallow=False)


def test_bounds_artifact_and_metadata_byte_identical(stdlib_dirs):
    jax_dir, port_dir = stdlib_dirs
    assert _same_file(os.path.join(jax_dir, bmx.BLOCKMAX_ARENA),
                      os.path.join(port_dir, bmx.BLOCKMAX_ARENA))
    assert _same_file(os.path.join(jax_dir, fmt.METADATA),
                      os.path.join(port_dir, fmt.METADATA))
    meta = fmt.IndexMetadata.load(port_dir)
    tids, max_tf, width = bmx.load_block_bounds(port_dir, meta)
    jt, jm, jw = jbmx.load_block_bounds(jax_dir,
                                        jbmx.fmt.IndexMetadata.load(jax_dir))
    assert width == jw == 512 and len(tids) > 0
    np.testing.assert_array_equal(tids, jt)
    np.testing.assert_array_equal(max_tf, jm)


def test_compressed_migration_writes_the_same_bounds(stdlib_dirs, tmp_path):
    jax_dir, port_dir = stdlib_dirs
    j, p = str(tmp_path / "j"), str(tmp_path / "p")
    shutil.copytree(jax_dir, j)
    shutil.copytree(port_dir, p)
    jax_migrate_index(j, to_version=3, tf_dtype="auto")
    migrate_index(p, to_version=3)
    for name in (bmx.BLOCKMAX_ARENA, fmt.METADATA):
        assert _same_file(os.path.join(j, name), os.path.join(p, name))


def test_width_knob_and_schema(stdlib_dirs, tmp_path, monkeypatch):
    """TPU_IR_BLOCKMAX_WIDTH as the JAX package reads it (a value below
    64 reads as 64); the artifact records its width."""
    _, port_dir = stdlib_dirs
    for value, width in (("128", 128), ("3", 64), ("", 512)):
        monkeypatch.setenv("TPU_IR_BLOCKMAX_WIDTH", value)
        assert bmx.block_width() == width == jbmx.block_width()
    monkeypatch.setenv("TPU_IR_BLOCKMAX_WIDTH", "128")
    p = str(tmp_path / "p")
    shutil.copytree(port_dir, p)
    info = migrate_index(p, add_bounds=True)
    assert info["width"] == 128 and info["ok"]
    meta = fmt.IndexMetadata.load(p)
    assert bmx.load_block_bounds(p, meta)[2] == 128
    assert fmt.verify_checksums(p, meta) == len(meta.checksums)


@pytest.mark.parametrize("source", ["artifact", "recomputed"])
def test_layout_bounds_match_jax(stdlib_dirs, source):
    """hot_blk_max and blockmax_width element- and dtype-exact against
    the JAX layout's, sliced from the artifact or computed from the
    postings."""
    jax_dir, port_dir = stdlib_dirs
    s = Scorer.load(port_dir, layout="sparse", device="cpu")
    js = JaxScorer.load(jax_dir, layout="sparse", prune=False)
    _, pair_doc, pair_tf = js._pairs
    df = np.asarray(js.df)
    meta = fmt.IndexMetadata.load(port_dir)
    bounds = (bmx.load_block_bounds(port_dir, meta)
              if source == "artifact" else None)
    jbounds = (jbmx.load_block_bounds(jax_dir) if source == "artifact"
               else None)
    got = layout.build_tiered_layout(np.asarray(pair_doc),
                                     np.asarray(pair_tf), df,
                                     num_docs=meta.num_docs,
                                     block_bounds=bounds)
    want = jax_build_tiered(np.asarray(pair_doc), np.asarray(pair_tf), df,
                            num_docs=meta.num_docs, block_bounds=jbounds)
    assert got.blockmax_width == want.blockmax_width == 512
    assert got.hot_blk_max.dtype == want.hot_blk_max.dtype == np.int32
    np.testing.assert_array_equal(got.hot_blk_max, want.hot_blk_max)
    np.testing.assert_array_equal(s._hot_blk_max, want.hot_blk_max)
    np.testing.assert_array_equal(
        bmx.coo_block_max(got.hot_rows, got.hot_docs, got.hot_vals,
                          num_rows=got.num_hot, num_docs=meta.num_docs,
                          width=512), got.hot_blk_max)


def test_corrupt_bounds_quarantined_and_served(stdlib_dirs, tmp_path):
    _, port_dir = stdlib_dirs
    idx = str(tmp_path / "corrupt")
    # without the serving cache an earlier load wrote: a cache hit reads
    # no bounds, and the load under test must build the layout
    shutil.copytree(port_dir, idx,
                    ignore=shutil.ignore_patterns("serving-*"))
    path = os.path.join(idx, bmx.BLOCKMAX_ARENA)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    meta = fmt.IndexMetadata.load(idx)
    with pytest.raises(fmt.IntegrityError, match="blockmax"):
        bmx.load_block_bounds(idx, meta)
    with pytest.raises(fmt.IntegrityError, match="blockmax"):
        fmt.verify_checksums(idx, meta)
    s = Scorer.load(idx, layout="sparse", device="cpu")  # quarantines
    assert not os.path.exists(path)
    assert os.listdir(os.path.join(idx, fmt.QUARANTINE_DIR)) == [
        bmx.BLOCKMAX_ARENA]
    good = Scorer.load(port_dir, layout="sparse", device="cpu")
    np.testing.assert_array_equal(s._hot_blk_max, good._hot_blk_max)
    q = _scorer_queries(good, rows=40)
    for scoring_name in ("tfidf", "bm25"):
        a = good.topk(q, k=10, scoring=scoring_name)
        b = s.topk(q, k=10, scoring=scoring_name)
        assert a[0].tobytes() == b[0].tobytes()
        assert np.array_equal(a[1], b[1])


def test_quarantine_keeps_the_newest(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_IR_QUARANTINE_KEEP", "2")
    for i in range(4):
        (tmp_path / f"a{i}").write_text(str(i))
        fmt.quarantine(str(tmp_path), f"a{i}")
        os.utime(tmp_path / fmt.QUARANTINE_DIR / f"a{i}", (i, i))
    assert sorted(os.listdir(tmp_path / fmt.QUARANTINE_DIR)) == ["a2", "a3"]


def test_migrate_add_bounds_round_trips(stdlib_dirs, tmp_path, capsys):
    """`migrate-index --add-bounds` on an index without bounds writes the
    bytes the build wrote and the JAX package's metadata; again, the same."""
    jax_dir, port_dir = stdlib_dirs
    want = open(os.path.join(port_dir, bmx.BLOCKMAX_ARENA), "rb").read()
    idx = str(tmp_path / "idx")
    shutil.copytree(port_dir, idx)
    os.unlink(os.path.join(idx, bmx.BLOCKMAX_ARENA))
    meta = fmt.IndexMetadata.load(idx)
    meta.save_with_checksums(idx, block_bounds=False)
    assert bmx.BLOCKMAX_ARENA not in fmt.IndexMetadata.load(idx).checksums
    for _ in range(2):
        assert cli_main(["migrate-index", idx, "--add-bounds"]) == 0
        out = capsys.readouterr().out
        assert '"add_bounds": true' in out and '"ok": true' in out
        assert open(os.path.join(idx, bmx.BLOCKMAX_ARENA), "rb").read() \
            == want
        assert _same_file(os.path.join(idx, fmt.METADATA),
                          os.path.join(jax_dir, fmt.METADATA))
    # a damaged part is read verify-while-read, never made into bounds
    part = os.path.join(idx, fmt.part_name(0))
    raw = bytearray(open(part, "rb").read())
    raw[-5] ^= 0xFF
    open(part, "wb").write(bytes(raw))
    with pytest.raises(fmt.IntegrityError):
        migrate_index(idx, add_bounds=True)


# -- the scoring half ----------------------------------------------------


def _zipf_pairs(vocab=2600, ndocs=NDOCS, n_occ=150_000, seed=7):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    t = rng.choice(vocab, n_occ, p=p).astype(np.int64)
    d = rng.integers(1, ndocs + 1, n_occ).astype(np.int64)
    key, tf = np.unique(t * (ndocs + 1) + d, return_counts=True)
    pair_term = (key // (ndocs + 1)).astype(np.int32)
    pair_doc = (key % (ndocs + 1)).astype(np.int32)
    df = np.bincount(pair_term, minlength=vocab).astype(np.int32)
    return pair_doc, tf.astype(np.int32), df


def _bound_table(lay, doc_len, scoring_name, *, k1=0.9, b=0.4):
    """tests/test_blockmax.py's bound table (the scorers' construction)."""
    max_tf = np.asarray(lay.hot_blk_max, np.float32)
    if scoring_name == "tfidf":
        return np.where(max_tf > 0, 1.0 + np.log(np.maximum(max_tf, 1.0)),
                        0.0).astype(np.float32)
    width = lay.blockmax_width
    nblk = max_tf.shape[1]
    dlf = doc_len.astype(np.float32)
    dl_norm = 1.0 - b + b * dlf / max(float(dlf.sum()) / NDOCS, 1e-9)
    padded = np.full(nblk * width, np.inf, np.float32)
    padded[1: NDOCS + 1] = dl_norm[1: NDOCS + 1]
    dl_min = padded.reshape(nblk, width).min(axis=1)
    dl_min = np.where(np.isfinite(dl_min), dl_min, 0.0)
    sat = max_tf * (k1 + 1.0) / np.maximum(max_tf + k1 * dl_min[None, :],
                                           1e-9)
    return np.where(max_tf > 0, sat, 0.0).astype(np.float32)


class _Kernels:
    """The port's exact and block-max top-k on one layout, and the JAX
    package's exact one."""

    def __init__(self, pair_doc, pair_tf, df):
        self.df = df
        self.lay = layout.build_tiered_layout(pair_doc, pair_tf, df,
                                              num_docs=NDOCS,
                                              hot_budget=16 * (NDOCS + 1))
        self.jlay = jax_build_tiered(pair_doc, pair_tf, df, num_docs=NDOCS,
                                     hot_budget=16 * (NDOCS + 1))
        self.doc_len = np.zeros(NDOCS + 1, np.int32)
        np.add.at(self.doc_len, pair_doc, pair_tf)
        cpu = torch.device("cpu")
        up = lambda a: layout.upload_index(a, cpu)  # noqa: E731
        self.args = (up(self.lay.hot_rank), self.lay.hot_device(cpu),
                     up(self.lay.tier_of), up(self.lay.row_of),
                     TierTable([up(a) for a in self.lay.tier_docs],
                               [up(a) for a in self.lay.tier_tfs]))
        self.jargs = (jnp.asarray(self.jlay.hot_rank),
                      self.jlay.hot_device(), jnp.asarray(self.jlay.tier_of),
                      jnp.asarray(self.jlay.row_of),
                      tuple(jnp.asarray(a) for a in self.jlay.tier_docs),
                      tuple(jnp.asarray(a) for a in self.jlay.tier_tfs))

    def exact(self, q, k, scoring_name):
        qt, dft = torch.from_numpy(q), torch.from_numpy(self.df)
        if scoring_name == "bm25":
            return scoring.bm25_topk_tiered(
                qt, *self.args, dft, torch.from_numpy(self.doc_len), NDOCS,
                k=k)
        return scoring.tfidf_topk_tiered(qt, *self.args, dft, NDOCS, k=k)

    def blockmax(self, q, k, scoring_name, cand_blocks=None):
        width = self.lay.blockmax_width
        cb = cand_blocks or scoring.blockmax_cand_blocks(k, NDOCS, width)
        bound = torch.from_numpy(_bound_table(self.lay, self.doc_len,
                                              scoring_name))
        qt, dft = torch.from_numpy(q), torch.from_numpy(self.df)
        if scoring_name == "bm25":
            return scoring.bm25_topk_blockmax(
                qt, *self.args, dft, torch.from_numpy(self.doc_len), NDOCS,
                bound, width=width, cand_blocks=cb, k=k)
        return scoring.tfidf_topk_blockmax(qt, *self.args, dft, NDOCS,
                                           bound, width=width,
                                           cand_blocks=cb, k=k)

    def jax_exact(self, q, k, scoring_name):
        n = jnp.int32(NDOCS)
        if scoring_name == "bm25":
            out = jscoring.bm25_topk_tiered(
                jnp.asarray(q), *self.jargs, jnp.asarray(self.df),
                jnp.asarray(self.doc_len), n, num_docs=NDOCS, k=k)
        else:
            out = jscoring.tfidf_topk_tiered(
                jnp.asarray(q), *self.jargs, jnp.asarray(self.df), n,
                num_docs=NDOCS, k=k)
        return tuple(np.asarray(a) for a in out)


@pytest.fixture(scope="module")
def kernels():
    return _Kernels(*_zipf_pairs())


def _queries(lay, df, kind, seed=3, rows=6):
    """tests/test_blockmax.py's regimes: `rare_hot` (one hot term and
    very rare cold terms: the pruned branch engages), `hot_only` (tau =
    0: the overflow fallback), `mixed`."""
    rng = np.random.default_rng(seed)
    hot = np.nonzero(lay.hot_rank >= 0)[0]
    rare = np.nonzero((lay.hot_rank < 0) & (df >= 2) & (df <= 8))[0]
    mid = np.nonzero((lay.hot_rank < 0) & (df >= 30) & (df <= 300))[0]
    out = []
    for _ in range(rows):
        if kind == "rare_hot":
            out.append([int(rng.choice(hot)), int(rng.choice(rare)),
                        int(rng.choice(rare)), int(rng.choice(rare))])
        elif kind == "hot_only":
            out.append([int(rng.choice(hot)), int(rng.choice(hot)), -1, -1])
        else:
            out.append([int(rng.choice(hot)), int(rng.choice(mid)),
                        int(rng.choice(rare)), -1])
    return np.array(out, np.int32)


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("scoring_name", ["tfidf", "bm25"])
@pytest.mark.parametrize("k", [10, 100, 1000])
def test_blockmax_bitwise_equals_port_exact(kernels, scoring_name, k):
    stats = []
    for kind in ("rare_hot", "hot_only", "mixed"):
        q = _queries(kernels.lay, kernels.df, kind)
        s_e, d_e = kernels.exact(q, k, scoring_name)
        s_b, d_b, st = kernels.blockmax(q, k, scoring_name)
        np.testing.assert_array_equal(_bits(s_b), _bits(s_e),
                                      err_msg=kind)
        np.testing.assert_array_equal(d_b.numpy(), d_e.numpy(),
                                      err_msg=kind)
        stats.append(st)
    # hot-only queries have no cold partial: every block survives
    assert stats[1].fallback == 1 and stats[1].masked == 0


@pytest.mark.parametrize("scoring_name", ["tfidf", "bm25"])
@pytest.mark.parametrize("k", [10, 100])
def test_port_exact_matches_jax_exact_tiered(kernels, scoring_name, k):
    """The port (block-max and exact) against `tpu_ir`'s exact tiered
    top-k: the same docs, scores within rtol 1e-5."""
    for kind in ("rare_hot", "hot_only", "mixed"):
        q = _queries(kernels.lay, kernels.df, kind, seed=11)
        ws, wd = kernels.jax_exact(q, k, scoring_name)
        gs, gd, _ = kernels.blockmax(q, k, scoring_name)
        np.testing.assert_allclose(gs.numpy(), ws, rtol=RTOL, atol=1e-6)
        assert (gd.numpy() == wd).mean() > 0.98, kind


@pytest.mark.parametrize("scoring_name", ["tfidf", "bm25"])
def test_pruned_branch_engages_and_masks(scoring_name, monkeypatch):
    """The masked branch must run (fallback 0) with a real skip
    fraction, at width 128, and still equal the exact path bitwise
    (tests/test_blockmax.py:155)."""
    monkeypatch.setenv("TPU_IR_BLOCKMAX_WIDTH", "128")
    kern = _Kernels(*_zipf_pairs())
    assert kern.lay.blockmax_width == 128
    hot = np.nonzero(kern.lay.hot_rank >= 0)[0]
    hottest = int(hot[np.argmax(kern.df[hot])])
    rare = np.nonzero((kern.lay.hot_rank < 0) & (kern.df >= 2)
                      & (kern.df <= 4))[0]
    rng = np.random.default_rng(9)
    engaged = masked_total = 0
    for _ in range(8):
        qb = np.array([[hottest, int(rng.choice(rare)),
                        int(rng.choice(rare)), -1]], np.int32)
        s_e, d_e = kern.exact(qb, 5, scoring_name)
        s_b, d_b, st = kern.blockmax(qb, 5, scoring_name)
        np.testing.assert_array_equal(_bits(s_b), _bits(s_e))
        np.testing.assert_array_equal(d_b.numpy(), d_e.numpy())
        assert st.considered == kern.lay.hot_blk_max.shape[1]
        if not st.fallback:
            engaged += 1
            masked_total += st.masked
    assert engaged > 0 and masked_total > 0


def test_cand_blocks_budget_matches_jax(monkeypatch):
    for k in (1, 10, 100, 1000, 5000):
        for n in (100, 6000, 100_000):
            for width in (64, 128, 512):
                assert scoring.blockmax_cand_blocks(k, n, width) == \
                    jscoring.blockmax_cand_blocks(k, n, width)
    monkeypatch.setenv("TPU_IR_BLOCKMAX_BLOCKS", "7")
    assert scoring.blockmax_cand_blocks(10, 6000, 128) == 7 == \
        jscoring.blockmax_cand_blocks(10, 6000, 128)


def test_k_past_the_budget_raises(kernels):
    q = _queries(kernels.lay, kernels.df, "mixed")
    with pytest.raises(ValueError, match="candidate budget"):
        kernels.blockmax(q, 2000, "tfidf", cand_blocks=2)


# -- through the Scorer --------------------------------------------------


@pytest.fixture(scope="module")
def zipf_index(tmp_path_factory):
    """A 6,000-doc index built by the port from Zipf postings' text."""
    from tpu_ir_torch.corpus import make_corpus

    d = tmp_path_factory.mktemp("zipf")
    corpus = str(d / "corpus.trec")
    make_corpus(corpus, seed=5, n_docs=NDOCS, target_bytes=2_400_000,
                vocab_size=6_000)
    idx = str(d / "idx")
    build_index(corpus, idx, num_shards=3, device="cpu")
    return idx


def _scorer_queries(scorer, rows=64, seed=2):
    """Hot-term traffic (one hot term and one of df 30-300), uniform
    queries, a repeated hot term, padding and an empty query."""
    rng = np.random.default_rng(seed)
    hot_rank = scorer._hot_rank_host
    df = scorer._df_host
    hot = np.nonzero(hot_rank >= 0)[0]
    mid = np.nonzero((hot_rank < 0) & (df >= 30) & (df <= 300))[0]
    if not len(mid):
        mid = np.nonzero((hot_rank < 0) & (df > 0))[0]
    q = rng.integers(0, len(df), (rows, 3)).astype(np.int32)
    q[: rows // 2, 0] = rng.choice(hot, rows // 2)
    q[: rows // 2, 1] = rng.choice(mid, rows // 2)
    q[3, 2] = q[3, 0]
    q[4, 1:] = -1
    q[5] = -1
    return q


@pytest.mark.parametrize("scoring_name", ["tfidf", "bm25"])
@pytest.mark.parametrize("k", [10, 100])
def test_scorer_prune_on_equals_off(zipf_index, scoring_name, k,
                                    monkeypatch):
    monkeypatch.setenv("TPU_IR_BLOCKMAX_WIDTH", "128")
    on = Scorer.load(zipf_index, layout="sparse", device="cpu")
    off = Scorer.load(zipf_index, layout="sparse", device="cpu",
                      prune=False)
    assert on._blockmax_width == 512        # the artifact's width wins
    q = _scorer_queries(on, rows=120)
    _, n_free, mode = on._skip_plan(q)
    assert mode == "split" and 0 < n_free < len(q)
    a = on.topk(q, k=k, scoring=scoring_name)
    b = off.topk(q, k=k, scoring=scoring_name)
    np.testing.assert_array_equal(_bits(a[0]), _bits(b[0]))
    np.testing.assert_array_equal(a[1], b[1])
    assert on.blockmax_stats["blocks_considered"] > 0
    assert off.blockmax_stats["blocks_considered"] == 0
    # small blocks and the knob: the same bits
    monkeypatch.setattr(Scorer, "SCORE_BUDGET", 13 * (NDOCS + 1))
    monkeypatch.setenv("TPU_IR_BLOCKMAX", "0")
    c = on.topk(q, k=k, scoring=scoring_name)
    np.testing.assert_array_equal(_bits(c[0]), _bits(a[0]))
    np.testing.assert_array_equal(c[1], a[1])


def test_scorer_matches_jax_exact_tiered(zipf_index):
    js = JaxScorer.load(zipf_index, layout="sparse", prune=False)
    ts = Scorer.load(zipf_index, layout="sparse", device="cpu")
    q = _scorer_queries(ts, rows=80, seed=4)
    for scoring_name in ("tfidf", "bm25"):
        ws, wd = js.topk(q, k=10, scoring=scoring_name)
        gs, gd = ts.topk(q, k=10, scoring=scoring_name)
        np.testing.assert_allclose(gs, np.asarray(ws), rtol=RTOL,
                                   atol=1e-6)
        assert (gd == np.asarray(wd)).mean() > 0.98


def test_prune_diag_equals_jax(zipf_index):
    js = JaxScorer.load(zipf_index, layout="sparse")
    ts = Scorer.load(zipf_index, layout="sparse", device="cpu")
    for rows, seed in ((120, 1), (20, 2), (300, 3)):
        q = _scorer_queries(ts, rows=rows, seed=seed)
        for qq in (q, q[rows // 2:], q[: rows // 2]):
            assert ts.prune_diag(qq) == js.prune_diag(qq)
    assert Scorer.load(zipf_index, layout="sparse", device="cpu",
                       prune=False).prune_diag(q) == {
        "prune_applicable": False}
    assert Scorer.load(zipf_index, layout="dense", device="cpu"
                       ).prune_diag(q) == {"prune_layout": "dense"}


@pytest.mark.parametrize("scoring_name", ["tfidf", "bm25"])
def test_scorer_bound_table_equals_jax(zipf_index, scoring_name):
    js = JaxScorer.load(zipf_index, layout="sparse")
    ts = Scorer.load(zipf_index, layout="sparse", device="cpu")
    np.testing.assert_array_equal(
        ts._blockmax_bound_table(scoring_name).numpy(),
        np.asarray(js._blockmax_bound_table(scoring_name)))
