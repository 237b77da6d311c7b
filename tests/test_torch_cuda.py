"""The port's CUDA paths on the card: the hand-written kernels against
their plain twins (bitwise), and the device pipeline against its own CPU
run, on the dense and the tiered layout, raw and compressed.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor the JAX package, so they also run on a host without JAX; there,
skip this suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import tpu_ir_torch
from tpu_ir_torch import faults
from tpu_ir_torch.corpus import make_corpus
from tpu_ir_torch.index import build_index
from tpu_ir_torch.index.migrate import migrate_index
from tpu_ir_torch.ops import (
    cold_tier,
    fused_scoring,
    hot_stage,
    postings,
    scoring,
)
from tpu_ir_torch.search import Scorer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _inputs(seed, vocab, width, batch, terms, dev):
    gen = torch.Generator().manual_seed(seed)
    matrix = torch.rand((vocab, width), generator=gen)
    matrix[torch.rand((vocab, width), generator=gen) < 0.7] = 0.0
    df = torch.randint(0, width, (vocab,), generator=gen, dtype=torch.int32)
    q = torch.randint(-1, vocab + 2, (batch, terms), generator=gen,
                      dtype=torch.int32)
    q[0] = -1
    q[1, :] = q[1, 0]
    idf = scoring.idf_weights(df, width - 1)
    return q.to(dev), idf.to(dev), matrix.to(dev)


@pytest.mark.parametrize("shape", [(50, 33, 17, 3), (300, 1025, 64, 2),
                                   (40, 7, 70_000, 2), (9, 258, 5, 9)])
def test_kernel_bitwise_equals_twin(cuda, shape):
    vocab, width, batch, terms = shape
    q, idf, matrix = _inputs(sum(shape), vocab, width, batch, terms,
                                  cuda)
    tpu_ir_torch.reset_kernel_launches()
    got = fused_scoring.dense_scores(q, idf, matrix)
    assert tpu_ir_torch.kernel_launches() == {"dense_score": 1,
                                              "dequant_score": 0,
                                              "cold_tier": 0,
                                              "hot_stage": 0}
    want = fused_scoring.dense_scores_plain(q, idf, matrix)
    torch.cuda.synchronize()
    assert got.shape == (batch, width) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got[0] == 0).all())


def test_kernel_matches_cpu_twin(cuda):
    q, idf, matrix = _inputs(3, 64, 130, 40, 3, torch.device("cpu"))
    want = fused_scoring.dense_scores(q, idf, matrix)
    got = fused_scoring.dense_scores(q.to(cuda), idf.to(cuda),
                                     matrix.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_kernel_rejects_mixed_devices(cuda):
    q, idf, matrix = _inputs(4, 20, 30, 8, 2, cuda)
    with pytest.raises(ValueError, match="must be on"):
        fused_scoring.dense_scores(q.cpu(), idf, matrix)


def test_empty_batch(cuda):
    q, idf, matrix = _inputs(5, 20, 30, 8, 2, cuda)
    out = fused_scoring.dense_scores(q[:0], idf, matrix)
    assert out.shape == (0, 30)


def _tf_inputs(seed, vocab, width, batch, terms, dev):
    """A bf16 raw-tf matrix (integer tfs 1..256, bf16-exact, in ~30% of the
    cells) with the float32 (1 + ln tf) matrix torch computes from it, and
    _inputs' queries and idf."""
    gen = torch.Generator().manual_seed(seed + 1000)
    tf = torch.randint(1, 257, (vocab, width), generator=gen)
    tf[torch.rand((vocab, width), generator=gen) < 0.7] = 0
    q, idf, _ = _inputs(seed, vocab, width, batch, terms, dev)
    tf16 = tf.to(torch.bfloat16).to(dev)
    return q, idf, tf16, scoring._lntf(tf16)


@pytest.mark.parametrize("shape", [(50, 33, 17, 3), (300, 1025, 64, 2),
                                   (40, 7, 70_000, 1), (9, 258, 5, 9),
                                   (120, 8_763, 300, 3)])
def test_dequant_kernel_bitwise_equals_twin_and_kernel1(cuda, shape):
    vocab, width, batch, terms = shape
    q, idf, tf16, matrix = _tf_inputs(sum(shape), vocab, width, batch,
                                      terms, cuda)
    tpu_ir_torch.reset_kernel_launches()
    got = fused_scoring.dense_scores_quantized(q, idf, tf16)
    assert tpu_ir_torch.kernel_launches() == {"dense_score": 0,
                                              "dequant_score": 1,
                                              "cold_tier": 0,
                                              "hot_stage": 0}
    want = fused_scoring.dense_scores_quantized_plain(q, idf, tf16)
    k1 = fused_scoring.dense_scores(q, idf, matrix)
    torch.cuda.synchronize()
    assert got.shape == (batch, width) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), k1.view(torch.int32))
    assert bool((got[0] == 0).all())


def test_dequant_kernel_matches_cpu_twin(cuda):
    q, idf, tf16, _ = _tf_inputs(3, 64, 130, 40, 3, torch.device("cpu"))
    want = fused_scoring.dense_scores_quantized(q, idf, tf16)
    got = fused_scoring.dense_scores_quantized(
        q.to(cuda), idf.to(cuda), tf16.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_dequant_kernel_rejects_mixed_devices_and_empty_batch(cuda):
    q, idf, tf16, matrix = _tf_inputs(4, 20, 30, 8, 2, cuda)
    with pytest.raises(ValueError, match="must be on"):
        fused_scoring.dense_scores_quantized(q.cpu(), idf, tf16)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_scoring.dense_scores_quantized(q, idf, matrix)
    tpu_ir_torch.reset_kernel_launches()
    out = fused_scoring.dense_scores_quantized(q[:0], idf, tf16)
    assert out.shape == (0, 30)
    assert tpu_ir_torch.kernel_launches()["dequant_score"] == 0


def _edge_inputs(seed, vocab, width, batch, terms, dev, dtype=np.int32):
    """Both dense kernels' inputs with the id edge cases: ids V-1 (the last
    row of the allocation), -1 pads, an empty query and ids past V; idf
    with zeros (df == 0 terms); a bf16 raw-tf matrix of integer tfs and
    the float32 (1 + ln tf) matrix torch computes from it."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-1, vocab + 2, (batch, terms)).astype(dtype)
    q[::3, 0] = vocab - 1
    if terms > 1:
        q[1::2, 1] = vocab + 5
    if batch > 1:
        q[1] = -1
    idf = rng.uniform(0.05, 3.0, vocab).astype(np.float32)
    idf[rng.random(vocab) < 0.2] = 0.0
    idf[vocab - 1] = 1.5
    tf = rng.integers(1, 257, (vocab, width))
    tf[rng.random((vocab, width)) < 0.7] = 0
    tf16 = torch.from_numpy(tf).to(torch.bfloat16).to(dev)
    return (torch.from_numpy(q).to(dev), torch.from_numpy(idf).to(dev),
            tf16, scoring._lntf(tf16))


def _both_kernels_bitwise(q, idf, tf16, matrix):
    """Both kernels, one launch each, bitwise against their twins and
    against each other."""
    tpu_ir_torch.reset_kernel_launches()
    got1 = fused_scoring.dense_scores(q, idf, matrix)
    got2 = fused_scoring.dense_scores_quantized(q, idf, tf16)
    assert tpu_ir_torch.kernel_launches() == {"dense_score": 1,
                                              "dequant_score": 1,
                                              "cold_tier": 0,
                                              "hot_stage": 0}
    want1 = fused_scoring.dense_scores_plain(q, idf, matrix)
    want2 = fused_scoring.dense_scores_quantized_plain(q, idf, tf16)
    torch.cuda.synchronize()
    assert got1.shape == (q.shape[0], matrix.shape[1])
    assert torch.equal(got1.view(torch.int32), want1.view(torch.int32))
    assert torch.equal(got2.view(torch.int32), want2.view(torch.int32))
    assert torch.equal(got2.view(torch.int32), got1.view(torch.int32))
    return got1


EDGE_WIDTHS = [1, 2, 3, 5] + list(range(8_761, 8_770))


@pytest.mark.parametrize("terms", [1, 2, 3, 9])
@pytest.mark.parametrize("width", EDGE_WIDTHS)
def test_dense_kernels_bitwise_at_edge_shapes(cuda, width, terms):
    """Every width residue mod 8 near the ref width and tiny widths, every
    group size of the kernels (L = 1, 2, 3, 9), B = 1 and a small batch."""
    for batch in (1, 37):
        got = _both_kernels_bitwise(*_edge_inputs(
            width * 10 + terms + batch, 50, width, batch, terms, cuda))
        if batch > 1:
            assert bool((got[1] == 0).all())         # the empty query


# The dense kernels' grid is at most SMs x kMinBlocks (4) blocks
# (csrc/dense_rows.cuh) and each query is at least one work item, so a
# batch of more than 4 x SMs queries makes every block walk several items.

def test_dense_kernels_bitwise_at_a_huge_batch(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 70_000 > 100 * 4 * sms           # each block walks many items
    _both_kernels_bitwise(*_edge_inputs(70, 300, 8_763, 70_000, 2, cuda))


def test_dense_kernels_walk_several_items_per_block(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 3_000 > 4 * 4 * sms
    _both_kernels_bitwise(*_edge_inputs(8, 120, 4_097, 3_000, 3, cuda))


def test_dense_kernels_take_int64_ids(cuda):
    q, idf, tf16, matrix = _edge_inputs(9, 60, 1_031, 200, 3, cuda,
                                        dtype=np.int64)
    q[0, 0] = 2 ** 32 + 3              # an int32 cast alone would make it 3
    q[2, 2] = -(2 ** 33)
    got = _both_kernels_bitwise(q, idf, tf16, matrix)
    q32 = q.clone()
    q32[0, 0], q32[2, 2] = -1, -1
    want = fused_scoring.dense_scores(q32.to(torch.int32), idf, matrix)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_dense_kernels_resolve_long_queries_in_stages(cuda):
    """A query longer than the kernels' shared-memory stage of terms
    (kStage = 256 in csrc/dense_rows.cuh) is resolved a stage at a time."""
    _both_kernels_bitwise(*_edge_inputs(10, 90, 8_763, 5, 300, cuda))


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_compressed_scorer_on_cuda_equals_cpu(cuda, tmp_path, layout):
    corpus = str(tmp_path / "c.trec")
    make_corpus(corpus, seed=5, n_docs=300, target_bytes=300_000,
                vocab_size=3_000)
    raw, v3 = str(tmp_path / "raw"), str(tmp_path / "v3")
    build_index(corpus, raw, num_shards=3, device=cuda)
    build_index(corpus, v3, num_shards=3, device=cuda)
    migrate_index(v3, to_version=3)
    g = Scorer.load(v3, layout=layout)
    c = Scorer.load(v3, layout=layout, device="cpu")
    r = Scorer.load(raw, layout=layout)
    assert g.tf_dtype == torch.bfloat16
    q = np.random.default_rng(6).integers(
        0, c.meta.vocab_size, (500, 3)).astype(np.int32)
    for scoring_name in ("tfidf", "bm25"):
        tpu_ir_torch.reset_kernel_launches()
        gs, gd = g.topk(q, scoring=scoring_name)
        launches = tpu_ir_torch.kernel_launches()
        if layout == "dense" and scoring_name == "tfidf":
            assert launches["dequant_score"] == 1
            assert launches["dense_score"] == 0
        cs, cd = c.topk(q, scoring=scoring_name)
        np.testing.assert_allclose(gs, cs, rtol=1e-5, atol=1e-6)
        assert (gd == cd).mean() > 0.99
        # on the card, too, compressed == raw bitwise
        rs, rd = r.topk(q, scoring=scoring_name)
        assert np.array_equal(gd, rd) and gs.tobytes() == rs.tobytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_postings_on_cuda_equal_cpu(cuda, seed):
    rng = np.random.default_rng(seed)
    term = rng.integers(0, 500, 20_000).astype(np.int32)
    term[rng.choice(20_000, 900, replace=False)] = postings.PAD_TERM
    doc = rng.integers(1, 300, 20_000).astype(np.int32)
    want = postings.build_postings(torch.from_numpy(term),
                                   torch.from_numpy(doc), vocab_size=500,
                                   num_docs=299)
    got = postings.build_postings(torch.from_numpy(term).to(cuda),
                                  torch.from_numpy(doc).to(cuda),
                                  vocab_size=500, num_docs=299)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_topk_on_cuda_equals_cpu(cuda):
    rng = np.random.default_rng(2)
    s = torch.from_numpy((rng.integers(0, 4, (64, 1000)) * 0.5).astype(
        np.float32))
    ws, wd = scoring._topk_from_scores(s, 10)
    gs, gd = scoring._topk_from_scores(s.to(cuda), 10)
    assert torch.equal(gs.cpu(), ws) and torch.equal(gd.cpu(), wd)


def _assert_same_artifacts(got_dir, want_dir):
    """Every artifact but the job reports (which hold timings) byte for
    byte."""
    names = sorted(n for n in os.listdir(want_dir) if n != "jobs")
    assert sorted(n for n in os.listdir(got_dir) if n != "jobs") == names
    for name in names:
        with open(os.path.join(want_dir, name), "rb") as a, \
                open(os.path.join(got_dir, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("buckets", [0, 3, 16])
def test_streaming_build_on_cuda_equals_cpu(cuda, tmp_path, buckets):
    """The streaming build's pass 2 and char-grams on the card: the same
    bytes as the CPU run and as the one-shot build, store included."""
    from tpu_ir_torch.index import build_index_streaming

    corpus = str(tmp_path / "c.trec")
    make_corpus(corpus, seed=5, n_docs=300, target_bytes=300_000,
                vocab_size=3_000)
    kw = dict(num_shards=4, batch_docs=60, radix_buckets=buckets,
              store=True)
    gpu_idx, cpu_idx = str(tmp_path / "gpu"), str(tmp_path / "cpu")
    build_index_streaming(corpus, gpu_idx, device=cuda, **kw)
    build_index_streaming(corpus, cpu_idx, device="cpu", **kw)
    _assert_same_artifacts(gpu_idx, cpu_idx)
    one = str(tmp_path / "one")
    build_index(corpus, one, num_shards=4, device=cuda)
    for name in os.listdir(one):
        if name != "jobs":
            with open(os.path.join(one, name), "rb") as a, \
                    open(os.path.join(gpu_idx, name), "rb") as b:
                assert a.read() == b.read(), name


def test_chargram_index_on_cuda_equals_cpu(cuda):
    from tpu_ir_torch.ops import chargram

    terms = sorted({"a", "heap", "heapq", "queue", "über", "naïve", "中文",
                    "aaaaaaaa"} | {f"t{i:05d}x" for i in range(5_000)})
    for k in (1, 2, 3):
        tb, tl = chargram.pack_term_bytes(terms, k)
        want = chargram.build_chargram_index(torch.from_numpy(tb),
                                             torch.from_numpy(tl), k=k)
        got = chargram.build_chargram_index(torch.from_numpy(tb).to(cuda),
                                            torch.from_numpy(tl).to(cuda),
                                            k=k)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), k


def test_fetch_narrow_on_cuda_keeps_uint16_values(cuda):
    from tpu_ir_torch.utils.transfer import fetch_narrow

    values = torch.tensor([0, 1, 32_767, 32_768, 40_000, 65_535, 7],
                          dtype=torch.int32)
    got = fetch_narrow(values.to(cuda), 6, np.uint16)
    assert got.dtype == np.uint16
    assert got.tolist() == [0, 1, 32_767, 32_768, 40_000, 65_535]


def test_scorer_on_cuda_equals_cpu(cuda, tmp_path):
    corpus = str(tmp_path / "c.trec")
    make_corpus(corpus, seed=2, n_docs=150, target_bytes=150_000,
                vocab_size=1_500)
    gpu_idx, cpu_idx = str(tmp_path / "gpu"), str(tmp_path / "cpu")
    build_index(corpus, gpu_idx, num_shards=4, device=cuda)
    build_index(corpus, cpu_idx, num_shards=4, device="cpu")
    _assert_same_artifacts(gpu_idx, cpu_idx)
    g, c = Scorer.load(gpu_idx), Scorer.load(cpu_idx, device="cpu")
    q = np.random.default_rng(3).integers(
        0, c.meta.vocab_size, (500, 2)).astype(np.int32)
    for scoring_name in ("tfidf", "bm25"):
        gs, gd = g.topk(q, scoring=scoring_name)
        cs, cd = c.topk(q, scoring=scoring_name)
        np.testing.assert_allclose(gs, cs, rtol=1e-5, atol=1e-6)
        assert (gd == cd).mean() > 0.99


TIER = 0    # a one-tier table


def _tier(seed, vocab_rows, cap, batch, terms, width, dev):
    """One tier ([V_t, cap] docs/tfs with distinct docs per row, pads at
    the end) and a query block with duplicated terms and empty rows."""
    gen = torch.Generator().manual_seed(seed)
    fill = torch.randint(0, min(cap, width - 1) + 1, (vocab_rows,),
                         generator=gen)
    fill[0] = 0                                     # an all-zero row
    docs = torch.zeros((vocab_rows, cap), dtype=torch.int32)
    tfs = torch.zeros((vocab_rows, cap), dtype=torch.int32)
    for r in range(vocab_rows):
        n = int(fill[r])
        docs[r, :n] = torch.randperm(width - 1, generator=gen)[:n].sort(
        ).values.to(torch.int32) + 1
        tfs[r, :n] = torch.randint(1, 40, (n,), generator=gen,
                                   dtype=torch.int32)
    rows = torch.randint(0, vocab_rows, (batch, terms), generator=gen,
                         dtype=torch.int32)
    rows[:, -1] = rows[:, 0]                        # a duplicated term
    # tier TIER is scored; the other terms sit in tier -1 or past the table
    q_tier = torch.randint(-1, 4, (batch, terms), generator=gen,
                           dtype=torch.int32)
    q_tier[torch.rand((batch, terms), generator=gen) < 0.8] = TIER
    q_tier[1] = 1                                   # a query not in the tier
    q_w = torch.rand((batch, terms), generator=gen) + 0.05
    dl_norm = torch.rand((width,), generator=gen) + 0.3
    return [t.to(dev) for t in (q_tier, rows, q_w)] + [
        cold_tier.TierTable([docs.to(dev)], [tfs.to(dev)]), dl_norm.to(dev)]


@pytest.mark.parametrize("bm25", [False, True])
@pytest.mark.parametrize("shape", [(40, 2, 300, 2, 1001),
                                   (9, 2048, 64, 3, 100_001),
                                   (30, 128, 2_499, 2, 5_001),
                                   (5, 300, 70, 5, 257)])
def test_cold_tier_bitwise_equals_twin(cuda, shape, bm25):
    vocab_rows, cap, batch, terms, width = shape
    q_tier, rows, q_w, tiers, dl_norm = _tier(
        sum(shape), vocab_rows, cap, batch, terms, width, cuda)
    kw = {"dl_norm": dl_norm, "k1": 0.9} if bm25 else {}
    start = torch.rand((batch, width), device=cuda)
    got, want = start.clone(), start.clone()
    tpu_ir_torch.reset_kernel_launches()
    cold_tier.cold_stage(got, q_tier, rows, q_w, tiers, **kw)
    assert tpu_ir_torch.kernel_launches()["cold_tier"] == 1
    cold_tier.cold_stage_plain(want, q_tier, rows, q_w, tiers, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got[1], start[1]) and not torch.equal(got, start)


def _cold_edge(cuda, seed, bm25, **case):
    """One of chip_smoke's cold-stage edge cases: the kernel (one launch,
    none for a table of zero tiers) bitwise against the whole-stage twin
    from random starting scores."""
    start, q_tier, rows, q_w, tiers, dl_norm = chip_smoke.cold_edge_case(
        seed, device=cuda, **case)
    kw = {"dl_norm": dl_norm, "k1": 0.9} if bm25 else {}
    got, want = start.clone(), start.clone()
    tpu_ir_torch.reset_kernel_launches()
    cold_tier.cold_stage(got, q_tier, rows, q_w, tiers, **kw)
    assert tpu_ir_torch.kernel_launches()["cold_tier"] == int(len(tiers) > 0)
    cold_tier.cold_stage_plain(want, q_tier, rows, q_w, tiers, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got, start) == (len(tiers) == 0)


@pytest.mark.parametrize("bm25", [False, True])
@pytest.mark.parametrize("terms", [1, 2, 3, 9, 40])
@pytest.mark.parametrize("batch", [1, 2_499, 70_000])
def test_cold_tier_edge_shapes(cuda, batch, terms, bm25):
    """B = 1, 2,499 and 70,000 by L = 1, 2, 3, 9 and 40 (more than a warp
    of terms) over caps 1 to 4,096 with an empty tier: terms in three
    tiers on one doc, all terms in one tier, rows past V_t and negative,
    docs past D, tf = 0 slots."""
    _cold_edge(cuda, batch + terms, bm25, batch=batch, terms=terms)


@pytest.mark.parametrize("bm25", [False, True])
@pytest.mark.parametrize("caps", list(chip_smoke.COLD_EDGE_ORDERS)
                         + [(), tuple(range(1, cold_tier.MAX_TIERS + 1))])
def test_cold_tier_edge_tables(cuda, caps, bm25):
    """A wide tier before a narrow one, an empty tier among the wide ones,
    a table of zero tiers and one of MAX_TIERS tiers; one more raises."""
    _cold_edge(cuda, len(caps), bm25, batch=2_499, terms=9, caps=caps)
    docs = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    over = cold_tier.MAX_TIERS + 1
    with pytest.raises(ValueError, match="at most"):
        cold_tier.TierTable([docs] * over, [docs] * over)


def test_cold_tier_matches_cpu_twin(cuda):
    args = _tier(11, 20, 32, 50, 3, 400, torch.device("cpu"))
    want = torch.zeros((50, 400))
    cold_tier.cold_stage(want, *args[:4], dl_norm=args[4])
    got = torch.zeros((50, 400), device=cuda)
    q_tier, rows, q_w = (a.to(cuda) for a in args[:3])
    tiers = cold_tier.TierTable([args[3].docs[0].to(cuda)],
                                [args[3].tfs[0].to(cuda)])
    cold_tier.cold_stage(got, q_tier, rows, q_w, tiers,
                         dl_norm=args[4].to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-7)


def test_cold_tier_rejects_mixed_devices(cuda):
    q_tier, rows, q_w, tiers, _ = _tier(12, 5, 8, 4, 2, 30, cuda)
    with pytest.raises(ValueError, match="must be on"):
        cold_tier.cold_stage(torch.zeros((4, 30), device=cuda), q_tier,
                             rows.cpu(), q_w, tiers)
    cpu_tiers = cold_tier.TierTable([tiers.docs[0].cpu()],
                                    [tiers.tfs[0].cpu()])
    with pytest.raises(ValueError, match="must be on"):
        cold_tier.cold_stage(torch.zeros((4, 30), device=cuda), q_tier,
                             rows, q_w, cpu_tiers)


def test_tiered_scorer_on_cuda_equals_cpu(cuda, tmp_path):
    corpus = str(tmp_path / "c.trec")
    make_corpus(corpus, seed=3, n_docs=300, target_bytes=300_000,
                vocab_size=3_000)
    idx = str(tmp_path / "idx")
    build_index(corpus, idx, num_shards=3, device=cuda)
    g = Scorer.load(idx, layout="sparse")
    c = Scorer.load(idx, layout="sparse", device="cpu")
    assert len(g.cold_tiers) >= 3 and g.hot_tfs.shape[0] > 1
    q = np.random.default_rng(4).integers(
        0, c.meta.vocab_size, (500, 3)).astype(np.int32)
    # the MaxScore schedule: the hot-free queries' block, then the rest
    _, _, mode = g._skip_plan(q)
    blocks = 2 if mode == "split" else 1
    for scoring_name in ("tfidf", "bm25"):
        tpu_ir_torch.reset_kernel_launches()
        gs, gd = g.topk(q, scoring=scoring_name)
        # one launch per query block: each group fits one block
        assert g._block_size() >= 500
        assert tpu_ir_torch.kernel_launches()["cold_tier"] == blocks
        cs, cd = c.topk(q, scoring=scoring_name)
        np.testing.assert_allclose(gs, cs, rtol=1e-5, atol=1e-6)
        assert (gd == cd).mean() > 0.99


def test_hot_stage_refuses_tf32(cuda):
    """The hot stage is no matrix product: with TF32 allowed for float32
    products it still adds in full float32, bitwise its twin (the name
    dates from the torch.matmul hot stage, which refused TF32)."""
    terms = scoring.TieredTerms(
        q_w=torch.ones((2, 1), device=cuda),
        rank=torch.zeros((2, 1), dtype=torch.int32, device=cuda),
        is_hot=torch.ones((2, 1), dtype=torch.bool, device=cuda),
        tier=torch.full((2, 1), -1, dtype=torch.int32, device=cuda),
        row=torch.zeros((2, 1), dtype=torch.int32, device=cuda))
    scores = torch.zeros((2, 5), device=cuda)
    strip = torch.rand((3, 5), device=cuda) + 1.0 / 3.0
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        scoring.hot_stage(scores, terms, strip)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    torch.testing.assert_close(scores, strip[0].expand(2, 5), rtol=0,
                               atol=0)


@pytest.mark.parametrize("width", [1, 4_097])
@pytest.mark.parametrize("terms", [1, 2, 3, 9, 40])
@pytest.mark.parametrize("batch", [1, 2_499, 70_000])
def test_hot_stage_edge_shapes(cuda, batch, terms, width):
    start, rows, w, strip = chip_smoke.hot_edge_case(
        batch * 100 + terms, batch, terms, width, cuda)
    got, want = start.clone(), start.clone()
    tpu_ir_torch.reset_kernel_launches()
    hot_stage.hot_stage(got, rows, w, strip)
    assert tpu_ir_torch.kernel_launches()["hot_stage"] == 1
    hot_stage.hot_stage_plain(want, rows, w, strip)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # a query with no hot slot keeps its bits, -0.0 included
    assert torch.equal(got[0].view(torch.int32), start[0].view(torch.int32))
    if batch > 1:
        assert not torch.equal(got[1], start[1])


@pytest.mark.parametrize("shape", [(2_499, 3, 100_001), (5, 300, 5_001),
                                   (600, 2, 257)])
def test_hot_stage_wide_and_long(cuda, shape):
    """The full wiki100k width, queries longer than the kernel's stage of
    256 slots, and a batch that needs column tiles."""
    batch, terms, width = shape
    start, rows, w, strip = chip_smoke.hot_edge_case(sum(shape), batch,
                                                     terms, width, cuda)
    got, want = start.clone(), start.clone()
    hot_stage.hot_stage(got, rows, w, strip)
    hot_stage.hot_stage_plain(want, rows, w, strip)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("terms", chip_smoke.WIDE_TERMS)
@pytest.mark.parametrize("kernel", ["dense", "cold_tier", "hot_stage"])
def test_kernels_bitwise_at_wide_queries(cuda, kernel, terms):
    """The widths a wildcard or fuzzy expansion gives (L = 33, 64, 128:
    one term past a warp, and the power-of-two buckets of up to 64 terms
    an expansion adds) for B = 1 and 2,499: the dense kernels (both, and
    against each other), the cold stage's second turn of its 32-lane term
    loop (TF-IDF and BM25), and the hot stage with repeated hot terms
    folded into their first slot."""
    for batch in (1, 2_499):
        seed = terms * 10 + batch
        if kernel == "dense":
            _both_kernels_bitwise(*_edge_inputs(seed, 300, 8_763, batch,
                                                terms, cuda))
        elif kernel == "cold_tier":
            for bm25 in (False, True):
                _cold_edge(cuda, seed, bm25, batch=batch, terms=terms)
        else:
            start, rows, w, strip = chip_smoke.hot_edge_case(
                seed, batch, terms, 4_097, cuda)
            got, want = start.clone(), start.clone()
            hot_stage.hot_stage(got, rows, w, strip)
            hot_stage.hot_stage_plain(want, rows, w, strip)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32))


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_wildcard_search_on_cuda_equals_cpu(cuda, tmp_path, layout):
    """Glob and fuzzy queries (rows up to 128 ids wide) through the
    Scorer on the card against the same Scorer on the CPU: the same
    expanded rows, the same top-10, scores within rtol 1e-5."""
    corpus = str(tmp_path / "c.trec")
    make_corpus(corpus, seed=5, n_docs=400, target_bytes=300_000,
                vocab_size=2_000)
    idx = str(tmp_path / "idx")
    build_index(corpus, idx, num_shards=3, device=cuda)
    g = Scorer.load(idx, layout=layout)
    c = Scorer.load(idx, layout=layout, device="cpu")
    terms = c.vocab.terms
    texts = [f"{t[:3]}* {terms[i]}" for i, t in enumerate(terms[:: 97])]
    texts += [f"{t}~ {t[:2]}*" for t in terms[5::131]]
    texts += ["a* b* c*", "how do I sort a list?"]
    q = c.analyze_queries(texts)
    assert q.shape[1] >= 64 and np.array_equal(g.analyze_queries(texts), q)
    for scoring_name in ("tfidf", "bm25"):
        gs, gd = g.topk(q, scoring=scoring_name)
        cs, cd = c.topk(q, scoring=scoring_name)
        np.testing.assert_allclose(gs, cs, rtol=1e-5, atol=1e-6)
        assert (gd == cd).mean() > 0.99


def test_hot_stage_matches_cpu_twin(cuda):
    start, rows, w, strip = chip_smoke.hot_edge_case(5, 64, 4, 300, "cpu")
    want = start.clone()
    hot_stage.hot_stage(want, rows, w, strip)
    got = start.to(cuda)
    hot_stage.hot_stage(got, rows.to(cuda), w.to(cuda), strip.to(cuda))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_hot_stage_rejects_bad_inputs(cuda):
    start, rows, w, strip = chip_smoke.hot_edge_case(6, 8, 2, 30, cuda)
    before = tpu_ir_torch.kernel_launches()["hot_stage"]
    bad = [(start, rows.cpu(), w, strip),                    # device
           (start, rows, w, strip.cpu()),
           (start, rows.long(), w, strip),                   # dtype
           (start, rows, w, strip.double()),
           (start.half(), rows, w, strip),
           (start, rows, w, strip[:, :29].contiguous()),     # shape
           (start, rows, w[:, :1].contiguous(), strip),
           (start[:7], rows, w, strip),
           (start, rows.t(), w.t(), strip),                  # layout
           (start, rows, w, strip.t().contiguous().t())]
    for args in bad:
        with pytest.raises(ValueError, match="hot_stage"):
            hot_stage.hot_stage(*args)
    assert tpu_ir_torch.kernel_launches()["hot_stage"] == before


def _blockmax_index(tmp_path, cuda):
    corpus = str(tmp_path / "c.trec")
    make_corpus(corpus, seed=8, n_docs=3_000, target_bytes=1_500_000,
                vocab_size=8_000)
    idx = str(tmp_path / "idx")
    build_index(corpus, idx, num_shards=3, device=cuda)
    return idx


def _hot_traffic(scorer, n, seed):
    """One hot term and one cold term of df 30-300 per query (the mixed
    regime of tests/test_blockmax.py), then as many uniform queries."""
    rng = np.random.default_rng(seed)
    hot_rank = scorer._hot_rank_host
    df = scorer.df.cpu().numpy()
    hot = np.nonzero(hot_rank >= 0)[0]
    mid = np.nonzero((hot_rank < 0) & (df >= 30) & (df <= 300))[0]
    q = np.stack([rng.choice(hot, n), rng.choice(mid, n)], 1)
    uniform = rng.integers(0, len(df), (n, 2))
    return np.concatenate([q, uniform]).astype(np.int32)


def test_blockmax_and_schedule_on_cuda_equal_cpu(cuda, tmp_path,
                                                  monkeypatch):
    """The MaxScore schedule and block-max on the card: bitwise equal to
    prune=False there, and to the CPU run within rtol 1e-5."""
    monkeypatch.setenv("TPU_IR_BLOCKMAX_WIDTH", "128")
    idx = _blockmax_index(tmp_path, cuda)
    g = Scorer.load(idx, layout="sparse")
    off = Scorer.load(idx, layout="sparse", prune=False)
    c = Scorer.load(idx, layout="sparse", device="cpu")
    assert g._blockmax_width == 128
    q = _hot_traffic(g, 300, 9)
    for scoring_name in ("tfidf", "bm25"):
        for k in (10, 100):
            tpu_ir_torch.reset_kernel_launches()
            gs, gd = g.topk(q, k=k, scoring=scoring_name)
            assert tpu_ir_torch.kernel_launches()["hot_stage"] >= 1
            os_, od = off.topk(q, k=k, scoring=scoring_name)
            assert np.array_equal(gd, od) and gs.tobytes() == os_.tobytes()
            cs, cd = c.topk(q, k=k, scoring=scoring_name)
            np.testing.assert_allclose(gs, cs, rtol=1e-5, atol=1e-6)
            assert (gd == cd).mean() > 0.99
    assert g.blockmax_stats["blocks_considered"] > 0
    assert off.blockmax_stats["blocks_considered"] == 0


def test_rerank_on_cuda_equals_cpu(cuda, tmp_path):
    """The two-stage rerank on the card: dense == tiered (docnos, scores
    rtol 1e-6), == the CPU run (rtol 1e-5), compressed == raw bitwise."""
    corpus = str(tmp_path / "c.trec")
    make_corpus(corpus, seed=9, n_docs=300, target_bytes=300_000,
                vocab_size=3_000)
    raw, v3 = str(tmp_path / "raw"), str(tmp_path / "v3")
    build_index(corpus, raw, num_shards=3, device=cuda)
    build_index(corpus, v3, num_shards=3, device=cuda)
    migrate_index(v3, to_version=3)
    q = np.random.default_rng(10).integers(
        0, Scorer.load(raw, device="cpu").meta.vocab_size,
        (200, 3)).astype(np.int32)
    runs = {}
    for name, d, layout, dev in (("dense", raw, "dense", None),
                                 ("tiered", raw, "sparse", None),
                                 ("cpu", raw, "dense", "cpu"),
                                 ("dense-v3", v3, "dense", None),
                                 ("tiered-v3", v3, "sparse", None)):
        s = Scorer.load(d, layout=layout, device=dev)
        runs[name] = s.rerank_topk(q, k=10, candidates=100)
    ds, dd = runs["dense"]
    for name in ("tiered", "cpu"):
        s, d = runs[name]
        np.testing.assert_allclose(s, ds, rtol=1e-6 if name == "tiered"
                                   else 1e-5, atol=1e-7)
        assert (d == dd).mean() > 0.99
    for name in ("dense", "tiered"):
        s, d = runs[f"{name}-v3"]
        rs, rd = runs[name]
        assert np.array_equal(d, rd) and s.tobytes() == rs.tobytes()


@pytest.fixture
def serving_index(cuda, tmp_path):
    corpus = str(tmp_path / "c.trec")
    make_corpus(corpus, seed=11, n_docs=400, target_bytes=300_000,
                vocab_size=3_000)
    idx = str(tmp_path / "idx")
    build_index(corpus, idx, num_shards=3, device=cuda)
    return idx


def _texts(scorer, n_terms, n, seed):
    rng = np.random.default_rng(seed)
    terms = scorer.vocab.terms
    return [" ".join(terms[int(t)] for t in rng.integers(0, len(terms),
                                                         n_terms))
            for _ in range(n)]


def _bits(res):
    return [(d, int(np.float32(s).view(np.int32))) for d, s in res]


@pytest.mark.parametrize("width", [2, 4, 8])
@pytest.mark.parametrize("rung", [1, 4, 16])
def test_coalesced_dense_bm25_equals_solo(serving_index, width, rung):
    """Dense BM25 on the card: a query in a batch padded to `rung` rows at
    width floor 8 has the bits of its solo dispatch at its own width."""
    s = Scorer.load(serving_index, layout="dense")
    texts = _texts(s, width, max(rung - 1, 1), seed=width * 100 + rung)
    solo = [_bits(s.search_batch([t], k=10, scoring="bm25")[0])
            for t in texts]
    got = s.search_batch(texts, k=10, scoring="bm25", pad_to=rung,
                         width_floor=8, rung_ladder=(1, 4, 16))
    assert [_bits(r) for r in got] == solo
    assert any(solo)


@pytest.mark.parametrize("scoring_name", ["tfidf", "bm25"])
def test_hot_only_equals_plain_twin(serving_index, scoring_name,
                                    monkeypatch):
    """hot_only on the tiered layout launches hot_stage alone and gives
    the bits of the same path with hot_stage's plain twin."""
    g = Scorer.load(serving_index, layout="sparse")
    hot = np.nonzero(g._hot_rank_host >= 0)[0]
    rng = np.random.default_rng(12)
    q = np.stack([rng.choice(hot, 64),
                  rng.integers(0, g.meta.vocab_size, 64)], 1).astype(
        np.int32)
    tpu_ir_torch.reset_kernel_launches()
    got = g.topk(q, k=10, scoring=scoring_name, hot_only=True)
    launches = tpu_ir_torch.kernel_launches()
    assert launches["hot_stage"] >= 1 and launches["cold_tier"] == 0
    monkeypatch.setattr(hot_stage, "hot_stage", hot_stage.hot_stage_plain)
    want = g.topk(q, k=10, scoring=scoring_name, hot_only=True)
    assert np.array_equal(got[1], want[1])
    assert got[0].tobytes() == want[0].tobytes()
    assert (got[1] > 0).any()


@pytest.mark.parametrize("name", sorted(faults._CUDA_LOST))
def test_device_loss_texts_are_the_runtimes(cuda, name):
    """Each lost-device error is known by the text the CUDA runtime gives
    its code (torch.cuda.CudaError asks cudaGetErrorString), so a torch
    runtime error for it degrades, while the kernel wrappers' own report
    of the same code raises."""
    code, text = faults._CUDA_LOST[name]
    err = torch.cuda.CudaError(code)
    assert text in str(err)
    assert faults.is_device_loss(err)
    assert not faults.is_device_loss(
        RuntimeError(f"hot_stage kernel launch failed: CUDA error {code}"))
