"""The port's tiered-layout builder against the JAX package's: every field
of `TieredPostings` element- and dtype-exact (slim uint16 columns, the
dummy tier and the block-max bounds included); and the hot strip
densified on the device equal to the host densification."""

import numpy as np
import pytest
import torch

from tpu_ir.search import layout as jlayout

from tpu_ir_torch.search import layout

FIELDS = ("hot_rank", "hot_rows", "hot_docs", "hot_vals", "num_hot",
          "hot_width", "tier_of", "row_of")


def _postings(seed, vocab=400, num_docs=300, n_tok=20_000, zero_df=40,
              max_tf=None):
    """Global-CSR postings columns (term-major, docs ascending) of a
    Zipf-ish random corpus; the last `zero_df` terms have no postings."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab - zero_df + 1)
    terms = rng.choice(vocab - zero_df, n_tok, p=p / p.sum())
    docs = rng.integers(1, num_docs + 1, n_tok)
    key, tf = np.unique(terms.astype(np.int64) * (num_docs + 1) + docs,
                        return_counts=True)
    if max_tf is not None:
        tf = np.minimum(tf * max_tf // max(int(tf.max()), 1) + 1, max_tf)
    pair_term = (key // (num_docs + 1)).astype(np.int32)
    pair_doc = (key % (num_docs + 1)).astype(np.int32)
    df = np.bincount(pair_term, minlength=vocab).astype(np.int32)
    return pair_doc, tf.astype(np.int32), df, num_docs


def _assert_same(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f
    assert len(got.tier_docs) == len(want.tier_docs)
    for name in ("tier_docs", "tier_tfs"):
        for i, (g, w) in enumerate(zip(getattr(got, name),
                                       getattr(want, name))):
            assert g.dtype == w.dtype and g.shape == w.shape, (name, i)
            np.testing.assert_array_equal(g, w, err_msg=f"{name}[{i}]")
    assert got.blockmax_width == want.blockmax_width
    assert got.hot_blk_max.dtype == want.hot_blk_max.dtype
    np.testing.assert_array_equal(got.hot_blk_max, want.hot_blk_max)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plan_tiers_matches_jax(seed):
    _, _, df, d = _postings(seed)
    got = layout.plan_tiers(df, num_docs=d)
    want = jlayout.plan_tiers(df, num_docs=d)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert len(got[0]) > 0 and len(got[2]) >= 3   # hot terms, several tiers


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_build_tiered_layout_matches_jax(seed):
    pair_doc, pair_tf, df, d = _postings(seed)
    got = layout.build_tiered_layout(pair_doc, pair_tf, df, num_docs=d)
    want = jlayout.build_tiered_layout(pair_doc, pair_tf, df, num_docs=d)
    _assert_same(got, want)
    assert (got.tier_of[df == 0] == -1).all()
    assert got.hot_docs.dtype == np.uint16         # slim columns


def test_hot_budget_caps_the_strip():
    pair_doc, pair_tf, df, d = _postings(5)
    budget = 3 * (d + 1)                           # room for 3 hot rows
    got = layout.build_tiered_layout(pair_doc, pair_tf, df, num_docs=d,
                                     hot_budget=budget)
    want = jlayout.build_tiered_layout(pair_doc, pair_tf, df, num_docs=d,
                                       hot_budget=budget)
    _assert_same(got, want)
    assert got.num_hot == 3
    hot = np.nonzero(got.hot_rank >= 0)[0]
    cold = (got.hot_rank < 0) & (df > 0)
    assert df[hot].min() >= df[cold].max()         # largest dfs win


def test_wide_ids_stay_int32():
    # 70,000 docs and tfs up to 70,000: docnos and tfs need int32
    pair_doc, pair_tf, df, _ = _postings(6, num_docs=70_000,
                                         max_tf=70_000)
    got = layout.build_tiered_layout(pair_doc, pair_tf, df,
                                     num_docs=70_000)
    want = jlayout.build_tiered_layout(pair_doc, pair_tf, df,
                                       num_docs=70_000)
    _assert_same(got, want)
    assert got.tier_docs[0].dtype == np.int32
    assert got.tier_tfs[0].dtype == np.int32


@pytest.mark.parametrize("case", ["tiny", "tiny_capped", "no_postings"])
def test_small_layouts_match_jax(case):
    # a term is hot only above the p99 df, so the lowest df stays cold
    # unless no term has postings at all: then nothing is cold, and both
    # packages keep one all-zero dummy tier and one all-zero strip row
    pair_doc = np.array([1, 2, 3, 4, 1, 2, 3, 4, 5], np.int32)
    pair_tf = np.array([1, 2, 1, 3, 1, 1, 2, 1, 7], np.int32)
    df = np.array([4, 0, 5], np.int32)
    budget = 1 if case == "tiny_capped" else layout.HOT_BUDGET
    if case == "no_postings":
        pair_doc = pair_tf = np.zeros(0, np.int32)
        df = np.zeros(4, np.int32)
    got = layout.build_tiered_layout(pair_doc, pair_tf, df, num_docs=5,
                                     hot_budget=budget)
    want = jlayout.build_tiered_layout(pair_doc, pair_tf, df, num_docs=5,
                                       hot_budget=budget)
    _assert_same(got, want)
    assert got.num_hot == 1
    if case == "no_postings":
        assert got.tier_docs[0].shape == (1, 1)
        assert got.tier_docs[0].dtype == np.int32
        assert (got.tier_of == -1).all() and (got.hot_rank == -1).all()
        assert not got.hot_dense().any()


@pytest.mark.parametrize("seed", [0, 7])
def test_hot_device_equals_host_strip(seed):
    pair_doc, pair_tf, df, d = _postings(seed)
    tiers = layout.build_tiered_layout(pair_doc, pair_tf, df, num_docs=d)
    strip = tiers.hot_device("cpu")
    assert strip.dtype == torch.float32 and strip.shape == (tiers.num_hot,
                                                            d + 1)
    np.testing.assert_array_equal(strip.numpy(), tiers.hot_dense())
    want = jlayout.build_tiered_layout(pair_doc, pair_tf, df,
                                       num_docs=d).hot_dense()
    np.testing.assert_array_equal(strip.numpy(), want)


def test_upload_index_widens_uint16():
    a = np.array([0, 1, 65535, 40000], np.uint16)
    t = layout.upload_index(a, torch.device("cpu"))
    assert t.dtype == torch.int32
    assert t.tolist() == [0, 1, 65535, 40000]
