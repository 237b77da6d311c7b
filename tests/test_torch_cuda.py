"""The port's CUDA paths on the card: the hand-written kernel against its
plain twin (bitwise), and the device pipeline against its own CPU run.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor the JAX package, so they also run on a host without JAX; there,
skip this suite's conftest (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

import tpu_ir_torch
from tpu_ir_torch.corpus import make_corpus
from tpu_ir_torch.index import build_index
from tpu_ir_torch.ops import fused_scoring, postings, scoring
from tpu_ir_torch.search import Scorer

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
    assert tpu_ir_torch.kernel_launches() == {"dense_score": 1}
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


def test_scorer_on_cuda_equals_cpu(cuda, tmp_path):
    corpus = str(tmp_path / "c.trec")
    make_corpus(corpus, seed=2, n_docs=150, target_bytes=150_000,
                vocab_size=1_500)
    gpu_idx, cpu_idx = str(tmp_path / "gpu"), str(tmp_path / "cpu")
    build_index(corpus, gpu_idx, num_shards=4, device=cuda)
    build_index(corpus, cpu_idx, num_shards=4, device="cpu")
    for name in sorted(os.listdir(cpu_idx)):
        with open(os.path.join(cpu_idx, name), "rb") as a, \
                open(os.path.join(gpu_idx, name), "rb") as b:
            assert a.read() == b.read(), name
    g, c = Scorer.load(gpu_idx), Scorer.load(cpu_idx, device="cpu")
    q = np.random.default_rng(3).integers(
        0, c.meta.vocab_size, (500, 2)).astype(np.int32)
    for scoring_name in ("tfidf", "bm25"):
        gs, gd = g.topk(q, scoring=scoring_name)
        cs, cd = c.topk(q, scoring=scoring_name)
        np.testing.assert_allclose(gs, cs, rtol=1e-5, atol=1e-6)
        assert (gd == cd).mean() > 0.99
