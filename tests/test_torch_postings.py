"""The port's postings group-by against tpu_ir.ops.postings: an integer
pipeline, so every output array must be equal element for element."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ir.ops import postings as jp

from tpu_ir_torch.ops import postings as tp

SEEDS = [0, 1, 2, 3]


def _occurrences(seed, n_tok, vocab, ndocs, cap):
    rng = np.random.default_rng(seed)
    term = np.full(cap, jp.PAD_TERM, np.int32)
    doc = np.zeros(cap, np.int32)
    term[:n_tok] = rng.integers(0, vocab, n_tok)
    doc[:n_tok] = rng.integers(1, ndocs + 1, n_tok)
    # scatter some pads into the middle too, with junk doc values
    holes = rng.choice(n_tok, n_tok // 10, replace=False)
    term[holes] = jp.PAD_TERM
    doc[holes] = rng.integers(-5, 1000, len(holes))
    return term, doc


def _assert_postings_equal(got, want):
    for name in ("pair_term", "pair_doc", "pair_tf", "indptr", "df",
                 "doc_len"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)
        assert getattr(got, name).dtype == torch.int32, name
    assert int(got.num_pairs) == int(want.num_pairs)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(3000, 128, 127, 4096), (500, 7, 3, 512),
                                   (40, 1000, 50, 40)])
def test_build_postings_exact(seed, shape):
    n_tok, vocab, ndocs, cap = shape
    term, doc = _occurrences(seed, n_tok, vocab, ndocs, cap)
    want = jp.build_postings(jnp.asarray(term), jnp.asarray(doc),
                             vocab_size=vocab, num_docs=ndocs)
    got = tp.build_postings(torch.from_numpy(term), torch.from_numpy(doc),
                            vocab_size=vocab, num_docs=ndocs)
    _assert_postings_equal(got, want)


def test_build_postings_empty_input():
    z = np.zeros(0, np.int32)
    want = jp.build_postings(jnp.asarray(z), jnp.asarray(z), vocab_size=5,
                             num_docs=3)
    got = tp.build_postings(torch.from_numpy(z), torch.from_numpy(z),
                            vocab_size=5, num_docs=3)
    _assert_postings_equal(got, want)
    assert int(got.num_pairs) == 0


def test_build_postings_all_padding():
    term = np.full(64, jp.PAD_TERM, np.int32)
    doc = np.arange(64, dtype=np.int32)
    want = jp.build_postings(jnp.asarray(term), jnp.asarray(doc),
                             vocab_size=9, num_docs=4)
    got = tp.build_postings(torch.from_numpy(term), torch.from_numpy(doc),
                            vocab_size=9, num_docs=4)
    _assert_postings_equal(got, want)


def _packed_inputs(seed, vocab, ndocs, cap, use16):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 40, ndocs).astype(np.int32)
    lengths[2] = 0                                  # an empty document
    docnos = rng.permutation(np.arange(1, ndocs + 1)).astype(np.int32)
    total = int(lengths.sum())
    assert total <= cap
    pad = jp.PAD_TERM_U16 if use16 else jp.PAD_TERM
    term = np.full(cap, pad, np.uint16 if use16 else np.int32)
    term[:total] = rng.integers(0, vocab, total)
    return term, docnos, lengths


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("use16", [True, False])
def test_build_postings_packed_exact(seed, use16):
    vocab, ndocs, cap = 300, 60, 4096
    term, docnos, lengths = _packed_inputs(seed, vocab, ndocs, cap, use16)
    want = jp.build_postings_packed(jnp.asarray(term), jnp.asarray(docnos),
                                    jnp.asarray(lengths), vocab_size=vocab,
                                    num_docs=ndocs)
    got = tp.build_postings_packed(torch.from_numpy(term),
                                   torch.from_numpy(docnos),
                                   torch.from_numpy(lengths),
                                   vocab_size=vocab, num_docs=ndocs)
    _assert_postings_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_reduce_weighted_postings_exact(seed):
    rng = np.random.default_rng(100 + seed)
    c, vocab = 2000, 50
    term = rng.integers(0, vocab, c).astype(np.int32)
    doc = rng.integers(1, 40, c).astype(np.int32)
    tf = rng.integers(1, 9, c).astype(np.int32)
    term[rng.choice(c, 150, replace=False)] = jp.PAD_TERM
    want = jp.reduce_weighted_postings(jnp.asarray(term), jnp.asarray(doc),
                                       jnp.asarray(tf), vocab_size=vocab)
    got = tp.reduce_weighted_postings(torch.from_numpy(term),
                                      torch.from_numpy(doc),
                                      torch.from_numpy(tf), vocab_size=vocab)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_reduce_weighted_postings_narrow_dtypes():
    """Spill files keep narrowed wire dtypes; the arithmetic is int32."""
    term = np.array([3, 1, 3, 1, 2], np.int16)
    doc = np.array([2, 1, 2, 5, 1], np.uint8)
    tf = np.array([1, 4, 2, 1, 1], np.uint8)
    want = jp.reduce_weighted_postings(jnp.asarray(term), jnp.asarray(doc),
                                       jnp.asarray(tf), vocab_size=4)
    got = tp.reduce_weighted_postings(torch.from_numpy(term),
                                      torch.from_numpy(doc),
                                      torch.from_numpy(tf), vocab_size=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("seed", SEEDS)
def test_pair_term_from_df_matches(seed):
    df = np.random.default_rng(seed).integers(0, 5, 40).astype(np.int32)
    np.testing.assert_array_equal(tp.pair_term_from_df(df),
                                  jp.pair_term_from_df(df))
