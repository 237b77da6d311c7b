"""The hot-strip stage (ops/hot_stage.py) on the CPU: the plain twin the
wrapper runs here bitwise against a numpy float32 sum in the stated
order at the card tests' edge cases, the duplicate-term folding against
a plain loop, the stage against the JAX package's hot product
(`hot_matmul`, through `_tiered_scores(skip_cold=True)`), and the tiered
path's `skip_hot` against the JAX package's."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpu_ir.ops import scoring as jscoring
from tpu_ir.search.layout import build_tiered_layout as jax_build_tiered

import tpu_ir_torch
from tpu_ir_torch.ops import hot_stage, scoring
from tpu_ir_torch.ops.cold_tier import TierTable
from tpu_ir_torch.search import layout

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _numpy_stage(start, rows, w, strip):
    """scores + P with P summed from +0 in slot order, one float32
    multiply and one float32 add per live slot; a query with no slot in
    0..H-1 unchanged."""
    out = start.copy()
    h = strip.shape[0]
    for b in range(start.shape[0]):
        live = [(int(r), np.float32(x)) for r, x in zip(rows[b], w[b])
                if 0 <= r < h]
        if not live:
            continue
        acc = np.zeros(start.shape[1], np.float32)
        for r, x in live:
            acc = (acc + (strip[r] * x).astype(np.float32)).astype(
                np.float32)
        out[b] = (start[b] + acc).astype(np.float32)
    return out


@pytest.mark.parametrize("width", [1, 7, 4_097])
@pytest.mark.parametrize("terms", [1, 2, 3, 9, 40])
@pytest.mark.parametrize("batch", [1, 257])
def test_twin_matches_numpy_in_slot_order(batch, terms, width):
    start, rows, w, strip = chip_smoke.hot_edge_case(
        batch * 100 + terms, batch, terms, width, "cpu")
    want = _numpy_stage(start.numpy(), rows.numpy(), w.numpy(),
                        strip.numpy())
    got = start.clone()
    tpu_ir_torch.reset_kernel_launches()
    hot_stage.hot_stage(got, rows, w, strip)
    assert tpu_ir_torch.kernel_launches()["hot_stage"] == 0   # CPU: twin
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # query 0 holds no hot slot and keeps its -0.0 bits
    assert (got[0].numpy().view(np.int32) == np.int32(-2**31)).all()
    if batch > 1:
        assert not torch.equal(got[1], start[1])


def test_twin_is_batch_and_column_invariant():
    """A cell's bits do not depend on the batch it rides in nor on which
    columns are gathered: the property block-max == exact rests on."""
    start, rows, w, strip = chip_smoke.hot_edge_case(3, 64, 4, 900, "cpu")
    whole = start.clone()
    hot_stage.hot_stage(whole, rows, w, strip)
    for lo in range(0, 64, 7):
        part = start[lo:lo + 7].clone()
        hot_stage.hot_stage(part, rows[lo:lo + 7].contiguous(),
                            w[lo:lo + 7].contiguous(), strip)
        assert torch.equal(part.view(torch.int32),
                           whole[lo:lo + 7].view(torch.int32))
    cols = torch.tensor([0, 5, 6, 400, 899])
    sub = start[:, cols].contiguous()
    hot_stage.hot_stage(sub, rows, w, strip[:, cols].contiguous())
    assert torch.equal(sub.view(torch.int32),
                       whole[:, cols].view(torch.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hot_slots_fold_repeats_in_slot_order(seed):
    rng = np.random.default_rng(seed)
    b, terms = 50, 9
    rank = rng.integers(0, 4, (b, terms)).astype(np.int32)
    is_hot = rng.random((b, terms)) < 0.7
    q_w = rng.uniform(0.1, 3.0, (b, terms)).astype(np.float32)
    rows, w = hot_stage.hot_slots(torch.from_numpy(rank),
                                  torch.from_numpy(is_hot),
                                  torch.from_numpy(q_w))
    assert rows.dtype == torch.int32 and w.dtype == torch.float32
    for i in range(b):
        want_r = np.full(terms, -1, np.int32)
        want_w = np.zeros(terms, np.float32)
        first = {}
        for l in range(terms):
            if not is_hot[i, l]:
                continue
            if rank[i, l] in first:
                j = first[rank[i, l]]
                want_w[j] = np.float32(want_w[j] + q_w[i, l])
            else:
                first[rank[i, l]] = l
                want_r[l] = rank[i, l]
                want_w[l] = np.float32(np.float32(0) + q_w[i, l])
        np.testing.assert_array_equal(rows[i].numpy(), want_r)
        np.testing.assert_array_equal(w[i].numpy().view(np.int32),
                                      want_w.view(np.int32))


def _layout(seed=0, vocab=400, num_docs=300, n_tok=20_000):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    terms = rng.choice(vocab, n_tok, p=p / p.sum())
    docs = rng.integers(1, num_docs + 1, n_tok)
    key, tf = np.unique(terms.astype(np.int64) * (num_docs + 1) + docs,
                        return_counts=True)
    pair_doc = (key % (num_docs + 1)).astype(np.int32)
    df = np.bincount((key // (num_docs + 1)).astype(np.int32),
                     minlength=vocab).astype(np.int32)
    return pair_doc, tf.astype(np.int32), df, num_docs


def _port_args(lay):
    dev = torch.device("cpu")
    up = lambda a: layout.upload_index(a, dev)  # noqa: E731
    return (up(lay.hot_rank), lay.hot_device(dev), up(lay.tier_of),
            up(lay.row_of),
            TierTable([up(a) for a in lay.tier_docs],
                      [up(a) for a in lay.tier_tfs]))


def _jax_args(lay):
    return (jnp.asarray(lay.hot_rank), lay.hot_device(),
            jnp.asarray(lay.tier_of), jnp.asarray(lay.row_of),
            tuple(jnp.asarray(a) for a in lay.tier_docs),
            tuple(jnp.asarray(a) for a in lay.tier_tfs))


def _queries(lay, df, seed=4, b=120):
    rng = np.random.default_rng(seed)
    hot = np.nonzero(lay.hot_rank >= 0)[0]
    q = rng.integers(0, len(df), (b, 4)).astype(np.int32)
    q[::2, 0] = rng.choice(hot, len(q[::2]))
    q[1::4, 2] = q[1::4, 0] = rng.choice(hot, len(q[1::4]))  # repeats
    q[3, :] = -1
    q[5, 1] = len(df) + 4                           # out of vocabulary
    return q


def test_hot_stage_matches_jax_hot_product():
    """The JAX hot stage alone (`skip_cold=True`: s + w_hot @ (1 + ln tf
    strip) on zeros) against the port's, rtol 1e-5: the matmul sums each
    cell in another order."""
    pair_doc, pair_tf, df, d = _layout()
    lay = jax_build_tiered(pair_doc, pair_tf, df, num_docs=d)
    q = _queries(lay, df)
    idf = scoring.idf_weights(torch.from_numpy(df), d)
    want = np.asarray(jscoring._tiered_scores(
        jnp.asarray(q), *_jax_args(lay), jnp.asarray(idf.numpy()),
        num_docs=d, hot_weight_fn=jscoring._lntf,
        cold_weight_fn=lambda tfs, docs: jscoring._lntf(tfs),
        skip_cold=True))
    hot_rank, strip, tier_of, row_of, _ = _port_args(
        layout.build_tiered_layout(pair_doc, pair_tf, df, num_docs=d))
    terms = scoring.tiered_terms(torch.from_numpy(q), hot_rank, tier_of,
                                 row_of, idf)
    got = torch.zeros((len(q), d + 1))
    scoring.hot_stage(got, terms, scoring._lntf(strip))
    assert got.any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scoring_name", ["tfidf", "bm25"])
def test_skip_hot_matches_jax_cold_partial(scoring_name):
    """skip_hot scores the cold tiers only: the JAX package's `skip_hot`
    path within rtol 1e-5, and on hot-free queries bitwise the port's
    full path."""
    pair_doc, pair_tf, df, d = _layout(seed=1)
    lay = jax_build_tiered(pair_doc, pair_tf, df, num_docs=d)
    doc_len = np.zeros(d + 1, np.int32)
    np.add.at(doc_len, pair_doc, pair_tf)
    q = _queries(lay, df, seed=5)
    port = _port_args(
        layout.build_tiered_layout(pair_doc, pair_tf, df, num_docs=d))
    dft = torch.from_numpy(df)
    if scoring_name == "bm25":
        want = jscoring.bm25_topk_tiered(
            jnp.asarray(q), *_jax_args(lay), jnp.asarray(df),
            jnp.asarray(doc_len), jnp.int32(d), num_docs=d, k=10,
            skip_hot=True)
        got = scoring.bm25_topk_tiered(
            torch.from_numpy(q), *port, dft, torch.from_numpy(doc_len), d,
            k=10, skip_hot=True)
        full = scoring.bm25_topk_tiered
        extra = (torch.from_numpy(doc_len),)
    else:
        want = jscoring.tfidf_topk_tiered(
            jnp.asarray(q), *_jax_args(lay), jnp.asarray(df), jnp.int32(d),
            num_docs=d, k=10, skip_hot=True)
        got = scoring.tfidf_topk_tiered(torch.from_numpy(q), *port, dft, d,
                                        k=10, skip_hot=True)
        full = scoring.tfidf_topk_tiered
        extra = ()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    assert (got[1].numpy() == np.asarray(want[1])).mean() > 0.97
    free = ~((q >= 0) & (lay.hot_rank[np.clip(q, 0, len(df) - 1)] >= 0)
             ).any(axis=1)
    qf = torch.from_numpy(q[free])
    a = full(qf, *port, dft, *extra, d, k=10, skip_hot=True)
    b = full(qf, *port, dft, *extra, d, k=10)
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


def test_wrapper_rejects_bad_inputs():
    start, rows, w, strip = chip_smoke.hot_edge_case(6, 8, 2, 30, "cpu")
    bad = [(start, rows.long(), w, strip),
           (start, rows, w.double(), strip),
           (start, rows, w, strip[:, :29].contiguous()),
           (start[:7], rows, w, strip),
           (start, rows, w, strip.t().contiguous().t())]
    for args in bad:
        with pytest.raises(ValueError, match="hot_stage"):
            hot_stage.hot_stage(*args)
