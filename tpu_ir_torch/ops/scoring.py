"""Batched ranked retrieval: TF-IDF / BM25 + top-k, dense and tiered.

The counterpart of `tpu_ir/ops/scoring.py` for the dense layout and the
exact (unpruned) tiered layout: score(d) = sum over query terms of
(1 + ln tf) * log10(N / df) for TF-IDF, Okapi BM25 otherwise, truncated
to the top k. Everything runs in float32.

- dense: a [V, D+1] term-by-doc matrix holds the weights; column 0
  (docno 0) is dead padding. Dense TF-IDF goes through a fused CUDA
  kernel (ops/fused_scoring.py): over the float32 (1 + ln tf) matrix, or,
  for a compressed index, over a bf16 raw-tf matrix that the kernel
  weights itself. Dense BM25 stays plain torch, as it is plain XLA in the
  JAX package, over a raw-tf matrix of either type.
- tiered (search/layout.py): the cold df tiers go through the cold-tier
  CUDA kernel (ops/cold_tier.py), one launch for all the tiers of a query
  block; the hot strip is one [B, H] @ [H, D+1] float32 product, last, as
  in the JAX package's cold-first accumulation order.

Quirk policy as in the JAX package: `compat_int_idf=True` reproduces the
reference's Java int division N/df; documents whose total score is
exactly 0 are not returned.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_cpu_math_ready = False


def _ready_cpu_math(t: torch.Tensor) -> None:
    """Initialise PyTorch's CPU log functions on the calling thread, once.

    In the MKL build of PyTorch, a process's first log/log10 call that is
    split across intra-op threads can come back with one thread's chunk
    off by ~2^-15 relative (seen as 1 + ln 3 = 2.0985837 instead of
    2.0986123), as if that thread raced the library's lazy set-up. One
    small call on one thread first sets it up for all later calls."""
    global _cpu_math_ready
    if t.device.type == "cpu" and not _cpu_math_ready:
        one = torch.ones(8, dtype=torch.float32)
        torch.log(one)
        torch.log10(one)
        _cpu_math_ready = True


def _lntf(tf: torch.Tensor) -> torch.Tensor:
    """The (1 + ln tf) weight curve; 0 for empty slots."""
    _ready_cpu_math(tf)
    tf = tf.to(torch.float32)
    return torch.where(tf > 0, 1.0 + torch.log(torch.clamp(tf, min=1.0)),
                       torch.zeros((), dtype=torch.float32,
                                   device=tf.device))


def idf_weights(df: torch.Tensor, num_docs: int,
                compat_int_idf: bool = False) -> torch.Tensor:
    """float32 log10(N/df) per term; df == 0 terms get weight 0."""
    _ready_cpu_math(df)
    if compat_int_idf:
        ratio = torch.div(torch.full_like(df, int(num_docs)),
                          torch.clamp(df, min=1),
                          rounding_mode="floor").to(torch.float32)
    else:
        ratio = float(num_docs) / torch.clamp(df.to(torch.float32), min=1.0)
    w = torch.log10(torch.clamp(ratio, min=1e-30))
    return torch.where(df > 0, w, torch.zeros((), dtype=torch.float32,
                                               device=df.device))


def bm25_idf_weights(df: torch.Tensor, num_docs: int) -> torch.Tensor:
    """Okapi idf log(1 + (N - df + 0.5)/(df + 0.5)); df == 0 terms get 0."""
    _ready_cpu_math(df)
    dff = df.to(torch.float32)
    n_f = torch.tensor(float(num_docs), dtype=torch.float32, device=df.device)
    w = torch.log(1.0 + (n_f - dff + 0.5) / (dff + 0.5))
    return torch.where(df > 0, w, torch.zeros((), dtype=torch.float32,
                                               device=df.device))


def bm25_saturation(tf: torch.Tensor, dl_norm: torch.Tensor, *,
                    k1: float) -> torch.Tensor:
    """tf*(k1+1)/(tf + k1*dl_norm), guarded: at b = 1 an empty doc has
    dl_norm 0 and a tf = 0 cell would divide 0/0, and the NaN would then
    outrank every real score."""
    tf = tf.to(torch.float32)
    return tf * (k1 + 1.0) / torch.clamp(tf + k1 * dl_norm, min=1e-9)


def bm25_dl_norm(doc_len: torch.Tensor, num_docs: int, b: float
                 ) -> torch.Tensor:
    """float32 [D+1] doc-length norm 1 - b + b * dl / avg_dl."""
    dl = doc_len.to(torch.float32)
    n_f = torch.tensor(float(num_docs), dtype=torch.float32,
                       device=dl.device)
    avg_dl = torch.sum(dl) / torch.clamp(n_f, min=1.0)
    return 1.0 - b + b * dl / torch.clamp(avg_dl, min=1e-9)


def _dense_scatter(pair_term: torch.Tensor, pair_doc: torch.Tensor,
                   values: torch.Tensor, *, vocab_size: int,
                   num_docs: int, dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """[V, D+1] matrix of `dtype` with `values` at (term, doc). The keys
    are unique after the postings group-by, so the accumulate is a plain
    store of each value into a zero cell and the result is deterministic;
    the values are cast to `dtype` before the store, so no matrix-sized
    temporary of another type is made."""
    width = num_docs + 1
    flat = torch.zeros(vocab_size * width, dtype=dtype, device=values.device)
    term = pair_term.to(torch.int64)
    keep = (term >= 0) & (term < vocab_size)
    idx = term * width + pair_doc.to(torch.int64)
    flat.index_put_((idx[keep],), values[keep].to(dtype), accumulate=True)
    return flat.view(vocab_size, width)


def dense_doc_matrix(pair_term, pair_doc, pair_tf, *, vocab_size: int,
                     num_docs: int) -> torch.Tensor:
    """[V, D+1] matrix of (1 + ln tf); column 0 (docno 0) is dead padding."""
    return _dense_scatter(pair_term, pair_doc, _lntf(pair_tf),
                          vocab_size=vocab_size, num_docs=num_docs)


def dense_tf_matrix(pair_term, pair_doc, pair_tf, *, vocab_size: int,
                    num_docs: int, dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """[V, D+1] matrix of raw tf, for BM25 saturation: float32, or bf16
    for a compressed index whose tfs bf16 holds exactly (the bf16 matrix
    is then also what the quantized TF-IDF kernel reads)."""
    return _dense_scatter(pair_term, pair_doc, pair_tf,
                          vocab_size=vocab_size, num_docs=num_docs,
                          dtype=dtype)


def tfidf_topk_dense(q_terms: torch.Tensor, doc_matrix: torch.Tensor,
                     df: torch.Tensor, num_docs: int, *, k: int = 10,
                     compat_int_idf: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched TF-IDF top-k through the fused kernel. Returns
    (scores [B, k] float32, docnos [B, k] int32); docno 0 marks an empty
    slot (fewer than k docs matched)."""
    from .fused_scoring import tfidf_scores

    scores = tfidf_scores(q_terms, doc_matrix, df, num_docs,
                          compat_int_idf=compat_int_idf)
    return _topk_from_scores(scores, k)


def tfidf_topk_dense_quantized(q_terms: torch.Tensor,
                               tf_matrix: torch.Tensor, df: torch.Tensor,
                               num_docs: int, *, k: int = 10,
                               compat_int_idf: bool = False
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """tfidf_topk_dense over a bf16 raw-tf matrix, through the quantized
    kernel: on bf16-exact tfs, bitwise the same result."""
    from .fused_scoring import tfidf_scores_quantized

    scores = tfidf_scores_quantized(q_terms, tf_matrix, df, num_docs,
                                    compat_int_idf=compat_int_idf)
    return _topk_from_scores(scores, k)


def _bm25_dense_scores(q_terms, tf_matrix, df, doc_len, num_docs: int,
                       k1: float, b: float) -> torch.Tensor:
    """[B, D+1] BM25 scores on the dense layout (plain torch, as the JAX
    package's is plain XLA: mul + reduce over the term axis). A bf16
    tf_matrix is widened at the saturation's entry, so bf16-exact tfs
    give the float32 matrix's bits."""
    vocab_size = tf_matrix.shape[0]
    idf = bm25_idf_weights(df, num_docs)
    dl_norm = bm25_dl_norm(doc_len, num_docs, b)

    q_valid = (q_terms >= 0) & (q_terms < vocab_size)
    safe_q = torch.where(q_valid, q_terms, 0).long()
    q_idf = torch.where(q_valid, idf[safe_q],
                        torch.zeros((), dtype=torch.float32,
                                    device=idf.device))        # [B, L]
    tf = tf_matrix[safe_q]                                      # [B, L, D+1]
    sat = bm25_saturation(tf, dl_norm[None, None, :], k1=k1)
    return torch.sum(sat * q_idf[:, :, None], dim=1)


def bm25_topk_dense(q_terms: torch.Tensor, tf_matrix: torch.Tensor,
                    df: torch.Tensor, doc_len: torch.Tensor, num_docs: int,
                    *, k: int = 10, k1: float = 0.9, b: float = 0.4
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched Okapi BM25 top-k on the dense layout."""
    scores = _bm25_dense_scores(q_terms, tf_matrix, df, doc_len, num_docs,
                                k1, b)
    return _topk_from_scores(scores, k)


def _order_key(scores: torch.Tensor) -> torch.Tensor:
    """int32 keys that sort like the float32 scores (IEEE bit trick:
    non-negative floats keep their bits, negative ones flip all but the
    sign bit)."""
    bits = scores.contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _topk_from_scores(scores: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k with `lax.top_k`'s order: higher score first, and on ties
    the lower doc index first. torch.topk promises no tie order, so the
    selection runs on unique int64 keys (score key << 32 | ~index); the
    dead column 0 and the `score > 0` mask follow `_topk_from_scores` of
    the JAX package. The scores are not copied: the dead column is masked
    in the keys, below every real score."""
    width = scores.shape[-1]
    kk = min(k, width)
    idx = torch.arange(width, dtype=torch.int64, device=scores.device)
    key = (_order_key(scores).to(torch.int64) << 32) | (0xFFFFFFFF - idx)
    key[:, 0] = (torch.iinfo(torch.int32).min << 32) | 0xFFFFFFFF
    top_key, _ = torch.topk(key, kk, dim=-1, largest=True, sorted=True)
    top_idx = 0xFFFFFFFF - (top_key & 0xFFFFFFFF)
    top_scores = torch.gather(scores, 1, top_idx)
    matched = (top_scores > 0.0) & (top_idx != 0)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    return (torch.where(matched, top_scores, zero),
            torch.where(matched, top_idx, 0).to(torch.int32))


# -- tiered sparse layout ---------------------------------------------------


class TieredTerms(NamedTuple):
    """Per-(b, l) state of a query block on the tiered layout. Every
    gather index is clamped first: torch gathers, unlike JAX's, do not
    clamp an out-of-range id (-1 pads, ids >= V)."""

    q_w: torch.Tensor      # float32 [B, L]: term weight, 0 where invalid
    rank: torch.Tensor     # [B, L]: hot-strip row, -1 for cold terms
    is_hot: torch.Tensor   # bool [B, L]
    tier: torch.Tensor     # int32 [B, L]: tier index, -1 unless a valid
                           # term outside the strip with df > 0
    row: torch.Tensor      # int32 [B, L]: row within the tier (0 likewise)


def tiered_terms(q_terms: torch.Tensor, hot_rank: torch.Tensor,
                 tier_of: torch.Tensor, row_of: torch.Tensor,
                 q_weight: torch.Tensor) -> TieredTerms:
    """The per-term lookups of `_tiered_scores` (ops/scoring.py:283-287,
    :333-334 of the JAX package) for an int [B, L] id block (-1 pads)."""
    vocab_size = hot_rank.shape[0]
    q_valid = (q_terms >= 0) & (q_terms < vocab_size)
    safe_q = torch.where(q_valid, q_terms, 0).long()
    q_w = torch.where(q_valid, q_weight[safe_q],
                      torch.zeros((), dtype=torch.float32,
                                  device=q_weight.device))
    rank = hot_rank[safe_q]
    is_hot = (rank >= 0) & q_valid
    cold = q_valid & ~is_hot
    tier = torch.where(cold, tier_of[safe_q], -1).to(torch.int32)
    row = torch.where(cold, row_of[safe_q], 0).to(torch.int32)
    return TieredTerms(q_w, rank, is_hot, tier, row)


def cold_stage(scores: torch.Tensor, terms: TieredTerms, tiers, *,
               dl_norm: torch.Tensor | None = None, k1: float = 0.9) -> None:
    """Add every cold tier's contributions into `scores` in place, in tier
    order: one call of the cold-tier kernel's wrapper (ops/cold_tier.py)
    for all the tiers of `tiers` (a TierTable), on the block's per-term
    arrays."""
    from .cold_tier import cold_stage as stage

    stage(scores, terms.tier, terms.row, terms.q_w, tiers, dl_norm=dl_norm,
          k1=k1)


def _require_fp32_matmul(t: torch.Tensor) -> None:
    """The hot-strip product is exact float32 in the JAX package; TF32
    would round its inputs to 10 mantissa bits and move rankings."""
    if t.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the tiered hot-strip product must run in full float32, but "
            "torch.backends.cuda.matmul.allow_tf32 is on")


def hot_stage(scores: torch.Tensor, terms: TieredTerms,
              weighted_strip: torch.Tensor) -> None:
    """scores += w_hot @ weighted_strip, in place: each query's hot term
    weights scattered into a [B, H] row (duplicate terms sum; other
    slots go to a dropped column H), then one float32 product."""
    b = scores.shape[0]
    h = weighted_strip.shape[0]
    w_hot = torch.zeros((b, h + 1), dtype=torch.float32,
                        device=scores.device)
    cols = torch.where(terms.is_hot, terms.rank, h).long()
    qb = torch.arange(b, device=scores.device)[:, None].expand_as(cols)
    w_hot.index_put_((qb, cols),
                     torch.where(terms.is_hot, terms.q_w,
                                 torch.zeros((), dtype=torch.float32,
                                             device=scores.device)),
                     accumulate=True)
    _require_fp32_matmul(scores)
    scores.add_(torch.matmul(w_hot[:, :h], weighted_strip))


def _tiered_scores(q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
                   q_weight, *, num_docs: int, hot_weight_fn,
                   dl_norm: torch.Tensor | None = None,
                   k1: float = 0.9) -> torch.Tensor:
    """[B, D+1] exact tiered accumulation (JAX `_tiered_scores` without
    pruning): a zero accumulator, the cold tiers in tier order through
    one kernel launch, then the hot strip last. `hot_weight_fn` maps the
    raw-tf strip to its per-cell weights; `dl_norm` selects BM25 cold
    cells."""
    terms = tiered_terms(q_terms, hot_rank, tier_of, row_of, q_weight)
    scores = torch.zeros((q_terms.shape[0], num_docs + 1),
                         dtype=torch.float32, device=hot_tfs.device)
    cold_stage(scores, terms, tiers, dl_norm=dl_norm, k1=k1)
    hot_stage(scores, terms, hot_weight_fn(hot_tfs))
    return scores


def _identity_weight(strip: torch.Tensor) -> torch.Tensor:
    return strip


def lntf_strip(hot_tfs: torch.Tensor) -> torch.Tensor:
    """(1 + ln tf) over the raw-tf hot strip: the TF-IDF hot weighting,
    materialized."""
    return _lntf(hot_tfs)


def bm25_strip(hot_tfs: torch.Tensor, doc_len: torch.Tensor,
               num_docs: int, *, k1: float = 0.9,
               b: float = 0.4) -> torch.Tensor:
    """BM25 saturation over the raw-tf hot strip with the doc-length norm
    broadcast: the tiered BM25 hot weighting, materialized."""
    dl_norm = bm25_dl_norm(doc_len, num_docs, b)
    return bm25_saturation(hot_tfs, dl_norm[None, :], k1=k1)


def _tfidf_tiered_scores(q_terms, hot_rank, hot_tfs, tier_of, row_of,
                         tiers, df, num_docs: int, *,
                         compat_int_idf: bool = False,
                         hot_preweighted: bool = False) -> torch.Tensor:
    """[B, D+1] tiered TF-IDF scores. `hot_preweighted` declares
    `hot_tfs` already weighted (lntf_strip): bitwise the same scores."""
    idf = idf_weights(df, num_docs, compat_int_idf)
    return _tiered_scores(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
        idf, num_docs=num_docs,
        hot_weight_fn=_identity_weight if hot_preweighted else _lntf)


def tfidf_topk_tiered(q_terms, hot_rank, hot_tfs, tier_of, row_of,
                      tiers, df, num_docs: int, *,
                      k: int = 10, compat_int_idf: bool = False,
                      hot_preweighted: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """TF-IDF top-k on the tiered sparse layout. q_terms int [B, L] (-1
    pads); hot_rank, tier_of, row_of int32 [V]; hot_tfs float32 [H, D+1]
    raw tf (or weighted, with `hot_preweighted`); tiers: the cold tiers'
    TierTable (ops/cold_tier.py), int32 [V_t, P_t] docs and tfs each.
    Returns (scores [B, k], docnos [B, k] int32)."""
    scores = _tfidf_tiered_scores(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
        df, num_docs, compat_int_idf=compat_int_idf,
        hot_preweighted=hot_preweighted)
    return _topk_from_scores(scores, k)


def _bm25_tiered_scores(q_terms, hot_rank, hot_tfs, tier_of, row_of,
                        tiers, df, doc_len, num_docs: int, *,
                        k1: float, b: float,
                        hot_preweighted: bool = False) -> torch.Tensor:
    """[B, D+1] tiered BM25 scores: saturation over the strip with the
    length norm broadcast (or `hot_preweighted`, bm25_strip), and per
    posting with the same norm gathered at its doc."""
    idf = bm25_idf_weights(df, num_docs)
    dl_norm = bm25_dl_norm(doc_len, num_docs, b)
    return _tiered_scores(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
        idf, num_docs=num_docs,
        hot_weight_fn=(_identity_weight if hot_preweighted else
                       lambda tf: bm25_saturation(tf, dl_norm[None, :],
                                                  k1=k1)),
        dl_norm=dl_norm, k1=k1)


def bm25_topk_tiered(q_terms, hot_rank, hot_tfs, tier_of, row_of,
                     tiers, df, doc_len, num_docs: int, *,
                     k: int = 10, k1: float = 0.9, b: float = 0.4,
                     hot_preweighted: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Okapi BM25 top-k on the tiered sparse layout (arguments as
    tfidf_topk_tiered, plus doc_len int32 [D+1])."""
    scores = _bm25_tiered_scores(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
        df, doc_len, num_docs, k1=k1, b=b, hot_preweighted=hot_preweighted)
    return _topk_from_scores(scores, k)
