"""Batched ranked retrieval: TF-IDF / BM25 + top-k, dense and tiered,
block-max pruning and the cosine rerank.

The counterpart of `tpu_ir/ops/scoring.py` for the dense layout, the
tiered layout (exact, MaxScore's hot-free blocks and block-max pruned) and
the two-stage rerank: score(d) = sum over query terms of (1 + ln tf) *
log10(N / df) for TF-IDF, Okapi BM25 otherwise, truncated to the top k.
Everything runs in float32.

- dense: a [V, D+1] term-by-doc matrix holds the weights; column 0
  (docno 0) is dead padding. Dense TF-IDF goes through a fused CUDA
  kernel (ops/fused_scoring.py): over the float32 (1 + ln tf) matrix, or,
  for a compressed index, over a bf16 raw-tf matrix that the kernel
  weights itself. Dense BM25 stays plain torch, as it is plain XLA in the
  JAX package, over a raw-tf matrix of either type.
- tiered (search/layout.py): the cold df tiers go through the cold-tier
  CUDA kernel (ops/cold_tier.py), one launch for all the tiers of a query
  block; the hot strip goes last, as in the JAX package's cold-first
  order, through the hot-stage CUDA kernel (ops/hot_stage.py), a gather
  of each query's hot rows with a fixed order per cell. `skip_hot` leaves
  the hot stage out for blocks with no hot term; block-max pruning runs
  it over the surviving doc blocks' columns only, bitwise the same.
- rerank: cosine-normalised TF-IDF over BM25's candidates, on either
  layout.
- explain: each top-k has a `*_scores_at_*` twin that calls the same
  score function and gathers the scores at requested docnos instead of
  selecting the top k, so a gathered score is bitwise the score the
  top-k ranked by (search/explain.py).

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


def _gather_at(scores: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """[B, C] scores at the docnos `cand` int [B, C]."""
    return torch.gather(scores, 1, cand.to(scores.device).long())


def tfidf_scores_at_dense(q_terms, doc_matrix, df, num_docs: int, cand, *,
                          compat_int_idf: bool = False) -> torch.Tensor:
    """Explain's twin of tfidf_topk_dense: the same kernel's scores,
    gathered at `cand` int [B, C] (`tpu_ir/ops/scoring.py::
    tfidf_scores_at_dense`)."""
    from .fused_scoring import tfidf_scores

    return _gather_at(tfidf_scores(q_terms, doc_matrix, df, num_docs,
                                   compat_int_idf=compat_int_idf), cand)


def tfidf_scores_at_dense_quantized(q_terms, tf_matrix, df, num_docs: int,
                                    cand, *, compat_int_idf: bool = False
                                    ) -> torch.Tensor:
    """Explain's twin of tfidf_topk_dense_quantized (the bf16 raw-tf
    matrix through the quantized kernel), gathered at `cand`."""
    from .fused_scoring import tfidf_scores_quantized

    return _gather_at(tfidf_scores_quantized(
        q_terms, tf_matrix, df, num_docs, compat_int_idf=compat_int_idf),
        cand)


def _bm25_dense_scores(q_terms, tf_matrix, df, doc_len, num_docs: int,
                       k1: float, b: float) -> torch.Tensor:
    """[B, D+1] BM25 scores on the dense layout (plain torch, as the JAX
    package's is plain XLA), summed over the term slots in order. A bf16
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
    # one rounded add a slot, in slot order from +0: a reduction over the
    # term axis could change its order with L or B, and a query must keep
    # its bits in a rung-padded batch at any width (a pad slot adds +0)
    scores = torch.zeros((q_terms.shape[0], tf_matrix.shape[1]),
                         dtype=torch.float32, device=tf_matrix.device)
    for slot in range(q_terms.shape[1]):
        sat = bm25_saturation(tf_matrix[safe_q[:, slot]], dl_norm[None, :],
                              k1=k1)                            # [B, D+1]
        scores = scores + sat * q_idf[:, slot, None]
    return scores


def bm25_topk_dense(q_terms: torch.Tensor, tf_matrix: torch.Tensor,
                    df: torch.Tensor, doc_len: torch.Tensor, num_docs: int,
                    *, k: int = 10, k1: float = 0.9, b: float = 0.4
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched Okapi BM25 top-k on the dense layout."""
    scores = _bm25_dense_scores(q_terms, tf_matrix, df, doc_len, num_docs,
                                k1, b)
    return _topk_from_scores(scores, k)


def bm25_scores_at_dense(q_terms, tf_matrix, df, doc_len, num_docs: int,
                         cand, *, k1: float = 0.9, b: float = 0.4
                         ) -> torch.Tensor:
    """Explain's twin of bm25_topk_dense, gathered at `cand`."""
    return _gather_at(_bm25_dense_scores(q_terms, tf_matrix, df, doc_len,
                                         num_docs, k1, b), cand)


def _order_key(scores: torch.Tensor) -> torch.Tensor:
    """int32 keys that sort like the float32 scores (IEEE bit trick:
    non-negative floats keep their bits, negative ones flip all but the
    sign bit)."""
    bits = scores.contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _topk_keys(scores: torch.Tensor, k: int, *, dead_column: bool
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(column indices [B, k'], their scores) of the top k per row, in
    `lax.top_k`'s order: higher score first, and on ties the lower column
    first. torch.topk promises no tie order, so the selection runs on
    unique int64 keys (score key << 32 | ~index). With `dead_column`,
    column 0 sorts below every real score, without a copy of the scores."""
    width = scores.shape[-1]
    idx = torch.arange(width, dtype=torch.int64, device=scores.device)
    key = (_order_key(scores).to(torch.int64) << 32) | (0xFFFFFFFF - idx)
    if dead_column:
        key[:, 0] = (torch.iinfo(torch.int32).min << 32) | 0xFFFFFFFF
    top_key, _ = torch.topk(key, min(k, width), dim=-1, largest=True,
                            sorted=True)
    top_idx = 0xFFFFFFFF - (top_key & 0xFFFFFFFF)
    return top_idx, torch.gather(scores, 1, top_idx)


def _matched(top_scores: torch.Tensor, docnos: torch.Tensor,
             matched: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    zero = torch.zeros((), dtype=top_scores.dtype, device=top_scores.device)
    return (torch.where(matched, top_scores, zero),
            torch.where(matched, docnos, 0).to(torch.int32))


def _topk_from_scores(scores: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over [B, D+1] doc scores as `_topk_from_scores` of the JAX
    package: the dead column 0 excluded, ties to the lower doc, and only
    scores > 0 returned (docno 0 and score 0 mark an empty slot)."""
    top_idx, top_scores = _topk_keys(scores, k, dead_column=True)
    return _matched(top_scores, top_idx,
                    (top_scores > 0.0) & (top_idx != 0))


def _topk_over_columns(cand: torch.Tensor, cols: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over [B, C] scores of the doc columns `cols` [C] (ascending,
    so ties still go to the lower doc); the dead and pad columns hold
    -inf already, so no column is masked here."""
    top_idx, top_scores = _topk_keys(cand, k, dead_column=False)
    return _matched(top_scores, cols[top_idx], top_scores > 0.0)


def _topk_over_candidates(cand_scores: torch.Tensor,
                          cand_docnos: torch.Tensor, k: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over per-candidate scores [B, C] (`tpu_ir/ops/scoring.py::
    _topk_over_candidates`): docno 0 marks an empty candidate, ties go to
    the earlier candidate."""
    cand = torch.where(cand_docnos > 0, cand_scores,
                       torch.full((), float("-inf"),
                                  device=cand_scores.device))
    top_idx, top_scores = _topk_keys(cand, k, dead_column=False)
    return _matched(top_scores, torch.gather(cand_docnos, 1, top_idx),
                    top_scores > 0.0)


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


def hot_stage(scores: torch.Tensor, terms: TieredTerms,
              weighted_strip: torch.Tensor) -> None:
    """scores += the hot strip's contributions, in place: each query's hot
    slots (duplicate terms folded into their first slot, weights summed)
    through the hot-stage kernel's wrapper (ops/hot_stage.py), over the
    float32 weighted strip [H, N]; a query with no hot term is left as it
    is."""
    from . import hot_stage as stage

    rows, w = stage.hot_slots(terms.rank, terms.is_hot, terms.q_w)
    stage.hot_stage(scores, rows, w, weighted_strip.contiguous())


def _tiered_scores(q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
                   q_weight, *, num_docs: int, hot_weight_fn,
                   dl_norm: torch.Tensor | None = None, k1: float = 0.9,
                   skip_hot: bool = False,
                   hot_only: bool = False) -> torch.Tensor:
    """[B, D+1] exact tiered accumulation (JAX `_tiered_scores` without
    the runtime-bounded prune): a zero accumulator, the cold tiers in tier
    order through one kernel launch, then the hot strip last through the
    hot-stage kernel. `hot_weight_fn` maps the raw-tf strip to its
    float32 per-cell weights; `dl_norm` selects BM25 cold cells.
    `skip_hot` leaves the hot stage out entirely (no weighting, no
    launch): exact when no query of the block holds a hot term, which the
    Scorer's MaxScore schedule certifies. `hot_only` (JAX `skip_cold`,
    the overloaded frontend's cheapest level) leaves the cold stage out
    instead: the hot stage alone on the zero accumulator, a lower bound
    of the full scores that the caller must tag."""
    if skip_hot and hot_only:
        raise ValueError("hot_only and skip_hot together score nothing")
    terms = tiered_terms(q_terms, hot_rank, tier_of, row_of, q_weight)
    scores = torch.zeros((q_terms.shape[0], num_docs + 1),
                         dtype=torch.float32, device=hot_tfs.device)
    if not hot_only:
        cold_stage(scores, terms, tiers, dl_norm=dl_norm, k1=k1)
    if not skip_hot:
        hot_stage(scores, terms, hot_weight_fn(hot_tfs))
    return scores


def _identity_weight(strip: torch.Tensor) -> torch.Tensor:
    return strip


def lntf_strip(hot_tfs: torch.Tensor) -> torch.Tensor:
    """(1 + ln tf) over the raw-tf hot strip: the TF-IDF (and cosine
    rerank) hot weighting, materialized."""
    return _lntf(hot_tfs)


def bm25_strip(hot_tfs: torch.Tensor, doc_len: torch.Tensor,
               num_docs: int, *, k1: float = 0.9,
               b: float = 0.4) -> torch.Tensor:
    """BM25 saturation over the raw-tf hot strip with the doc-length norm
    broadcast: the tiered BM25 hot weighting, materialized."""
    dl_norm = bm25_dl_norm(doc_len, num_docs, b)
    return bm25_saturation(hot_tfs, dl_norm[None, :], k1=k1)


def _tfidf_weights(hot_preweighted: bool):
    """(hot_weight_fn, hot_cell_fn) of TF-IDF: the whole strip's weights,
    and the weights of strip columns `cols` (the same elementwise curve,
    so a column's weights are bitwise the whole strip's)."""
    if hot_preweighted:
        return _identity_weight, lambda tfs, cols: tfs
    return _lntf, lambda tfs, cols: _lntf(tfs)


def _bm25_weights(dl_norm: torch.Tensor, k1: float, hot_preweighted: bool):
    """(hot_weight_fn, hot_cell_fn) of BM25, as _tfidf_weights: the
    saturation with the length norm broadcast over the strip, or gathered
    at the columns."""
    if hot_preweighted:
        return _identity_weight, lambda tfs, cols: tfs
    return (lambda tf: bm25_saturation(tf, dl_norm[None, :], k1=k1),
            lambda tfs, cols: bm25_saturation(tfs, dl_norm[cols][None, :],
                                              k1=k1))


def _tfidf_tiered_scores(q_terms, hot_rank, hot_tfs, tier_of, row_of,
                         tiers, df, num_docs: int, *,
                         compat_int_idf: bool = False,
                         hot_preweighted: bool = False,
                         skip_hot: bool = False,
                         hot_only: bool = False) -> torch.Tensor:
    """[B, D+1] tiered TF-IDF scores. `hot_preweighted` declares
    `hot_tfs` already weighted (lntf_strip): bitwise the same scores."""
    idf = idf_weights(df, num_docs, compat_int_idf)
    return _tiered_scores(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
        idf, num_docs=num_docs,
        hot_weight_fn=_tfidf_weights(hot_preweighted)[0],
        skip_hot=skip_hot, hot_only=hot_only)


def tfidf_topk_tiered(q_terms, hot_rank, hot_tfs, tier_of, row_of,
                      tiers, df, num_docs: int, *,
                      k: int = 10, compat_int_idf: bool = False,
                      hot_preweighted: bool = False, skip_hot: bool = False,
                      hot_only: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """TF-IDF top-k on the tiered sparse layout. q_terms int [B, L] (-1
    pads); hot_rank, tier_of, row_of int32 [V]; hot_tfs [H, D+1] raw tf
    (float32 or bf16), or float32 weights with `hot_preweighted`; tiers:
    the cold tiers' TierTable (ops/cold_tier.py). `skip_hot` omits the
    hot stage (exact only for a block with no hot term); `hot_only` omits
    the cold stage (partial scores, the hot strip's alone). Returns
    (scores [B, k], docnos [B, k] int32)."""
    scores = _tfidf_tiered_scores(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
        df, num_docs, compat_int_idf=compat_int_idf,
        hot_preweighted=hot_preweighted, skip_hot=skip_hot,
        hot_only=hot_only)
    return _topk_from_scores(scores, k)


def tfidf_scores_at_tiered(q_terms, hot_rank, hot_tfs, tier_of, row_of,
                           tiers, df, num_docs: int, cand, *,
                           compat_int_idf: bool = False,
                           hot_preweighted: bool = False,
                           skip_hot: bool = False,
                           hot_only: bool = False) -> torch.Tensor:
    """Explain's twin of tfidf_topk_tiered (the same cold-tier and
    hot-stage launches, the same flags), gathered at `cand`. Block-max
    has no twin: its scores are bitwise the exact path's."""
    return _gather_at(_tfidf_tiered_scores(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers, df, num_docs,
        compat_int_idf=compat_int_idf, hot_preweighted=hot_preweighted,
        skip_hot=skip_hot, hot_only=hot_only), cand)


def _bm25_tiered_scores(q_terms, hot_rank, hot_tfs, tier_of, row_of,
                        tiers, df, doc_len, num_docs: int, *,
                        k1: float, b: float, hot_preweighted: bool = False,
                        skip_hot: bool = False,
                        hot_only: bool = False) -> torch.Tensor:
    """[B, D+1] tiered BM25 scores: saturation over the strip with the
    length norm broadcast (or `hot_preweighted`, bm25_strip), and per
    posting with the same norm gathered at its doc."""
    idf = bm25_idf_weights(df, num_docs)
    dl_norm = bm25_dl_norm(doc_len, num_docs, b)
    return _tiered_scores(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
        idf, num_docs=num_docs,
        hot_weight_fn=_bm25_weights(dl_norm, k1, hot_preweighted)[0],
        dl_norm=dl_norm, k1=k1, skip_hot=skip_hot, hot_only=hot_only)


def bm25_topk_tiered(q_terms, hot_rank, hot_tfs, tier_of, row_of,
                     tiers, df, doc_len, num_docs: int, *,
                     k: int = 10, k1: float = 0.9, b: float = 0.4,
                     hot_preweighted: bool = False, skip_hot: bool = False,
                     hot_only: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Okapi BM25 top-k on the tiered sparse layout (arguments as
    tfidf_topk_tiered, plus doc_len int32 [D+1])."""
    scores = _bm25_tiered_scores(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
        df, doc_len, num_docs, k1=k1, b=b, hot_preweighted=hot_preweighted,
        skip_hot=skip_hot, hot_only=hot_only)
    return _topk_from_scores(scores, k)


def bm25_scores_at_tiered(q_terms, hot_rank, hot_tfs, tier_of, row_of,
                          tiers, df, doc_len, num_docs: int, cand, *,
                          k1: float = 0.9, b: float = 0.4,
                          hot_preweighted: bool = False,
                          skip_hot: bool = False,
                          hot_only: bool = False) -> torch.Tensor:
    """Explain's twin of bm25_topk_tiered, gathered at `cand`."""
    return _gather_at(_bm25_tiered_scores(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers, df, doc_len,
        num_docs, k1=k1, b=b, hot_preweighted=hot_preweighted,
        skip_hot=skip_hot, hot_only=hot_only), cand)


# -- block-max pruning -------------------------------------------------------
# The deep top-k path on the tiered layout (`tpu_ir/ops/scoring.py:432-
# 680`). The doc axis is cut into blocks of a fixed width; blockmax.arena
# (index/blockmax.py) bounds each (hot term, block)'s score. The cold tiers
# are scored exactly first; the k-th best partial score is a threshold, and
# every doc block whose best partial plus its summed hot bounds cannot
# reach it is masked. The hot stage then runs over the surviving blocks'
# columns only. The hot-stage kernel gives each column the bits the
# full-width stage gives it, masked docs cannot reach the top-k, and the
# kept columns stay doc-ascending, so the result is bitwise the exact
# path's. When the batch's surviving blocks overflow the budget, the exact
# full-width stage runs instead.

# the bound and the hot contributions are sums in different orders, so the
# mask compares a padded bound, as the JAX package does
BLOCKMAX_REL_MARGIN = 1.0001
BLOCKMAX_ABS_MARGIN = 1e-6


def blockmax_cand_blocks(k: int, num_docs: int, width: int) -> int:
    """The selected-block budget of one block-max dispatch: a quarter of
    the doc axis, at least enough blocks for 2k docs and at least 4.
    TPU_IR_BLOCKMAX_BLOCKS (when not 0) overrides it."""
    from .. import envvars

    nblk = -(-(num_docs + 1) // width)
    override = envvars.get_int("TPU_IR_BLOCKMAX_BLOCKS")
    if override:
        return min(nblk, override)
    need_k = -(-2 * k // width) + 1
    return min(nblk, max(nblk // 4, need_k, 4))


class BlockmaxStats(NamedTuple):
    """One block-max dispatch: block lanes ([query, block] pairs)
    considered and masked (0 when it fell back), and whether it fell back
    to the exact full-width stage."""

    considered: int
    masked: int
    fallback: int


def _blockmax_topk(q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
                   q_weight, hot_blk_bound, *, num_docs: int, k: int,
                   width: int, cand_blocks: int, hot_weight_fn, hot_cell_fn,
                   dl_norm: torch.Tensor | None = None, k1: float = 0.9):
    """Block-max top-k (the section comment; JAX `_blockmax_topk`).
    `hot_blk_bound` float32 [H, nblk] bounds each hot row's weight in each
    block (the Scorer builds it). Returns (scores [B, k], docnos [B, k],
    BlockmaxStats). One value is read back to choose the branch."""
    from . import hot_stage as stage

    b = q_terms.shape[0]
    d1 = num_docs + 1
    nblk = hot_blk_bound.shape[1]
    if k > cand_blocks * width or k > d1:
        raise ValueError(f"k={k} exceeds the block-max candidate budget "
                         f"({cand_blocks} blocks x {width}, doc axis "
                         f"{d1}); widen TPU_IR_BLOCKMAX_BLOCKS or "
                         "disable blockmax")
    dev = hot_tfs.device
    terms = tiered_terms(q_terms, hot_rank, tier_of, row_of, q_weight)
    partial = torch.zeros((b, d1), dtype=torch.float32, device=dev)
    cold_stage(partial, terms, tiers, dl_norm=dl_norm, k1=k1)
    # the dead slot, excluded as _topk_from_scores excludes it (in place:
    # the fallback's top-k masks column 0 whatever it holds)
    partial[:, 0] = float("-inf")
    tau = torch.topk(partial, k, dim=1).values.amin(dim=1)          # [B]

    # per-(query, block) hot bound: each hot slot's weighted block bound
    rows, w = stage.hot_slots(terms.rank, terms.is_hot, terms.q_w)
    safe_rows = torch.where(rows >= 0, rows, 0).long()
    ub = torch.zeros((b, nblk), dtype=torch.float32, device=dev)
    for l in range(rows.shape[1]):
        ub = ub + hot_blk_bound.index_select(0, safe_rows[:, l]) * w[:, l,
                                                                    None]
    full = d1 // width
    blk_pmax = torch.empty((b, nblk), dtype=torch.float32, device=dev)
    if full:
        blk_pmax[:, :full] = partial[:, : full * width].view(
            b, full, width).amax(dim=2)
    if full < nblk:
        blk_pmax[:, full] = partial[:, full * width:].amax(dim=1)
    # a lane survives iff a doc in it could still reach the top k; rows
    # with no valid term score nothing and must not force the fallback
    need = (blk_pmax + ub * BLOCKMAX_REL_MARGIN + BLOCKMAX_ABS_MARGIN
            >= tau[:, None])
    vocab_size = hot_rank.shape[0]
    has_terms = ((q_terms >= 0) & (q_terms < vocab_size)).any(dim=1)
    need &= has_terms[:, None]
    needed_any = need.any(dim=0)                                    # [nblk]
    n_needed, n_need = torch.stack([needed_any.sum(),
                                    need.sum()]).tolist()
    considered = b * nblk
    if n_needed > cand_blocks:
        # overflow: the exact kernel's hot stage over the full strip
        stage.hot_stage(partial, rows, w,
                        hot_weight_fn(hot_tfs).contiguous())
        s, d = _topk_from_scores(partial, k)
        return s, d, BlockmaxStats(considered, 0, 1)
    # the needed blocks, then the lowest others up to the budget, in
    # block order: the candidate columns stay doc-ascending
    sel = torch.argsort((~needed_any).to(torch.int8), stable=True)
    sel = sel[:cand_blocks].sort().values
    cols = (sel[:, None] * width + torch.arange(width, device=dev)
            ).reshape(-1)
    cols_c = cols.clamp(max=d1 - 1)
    cells = hot_cell_fn(hot_tfs.index_select(1, cols_c), cols_c)
    cand = torch.where((cols < d1)[None, :], partial.index_select(1, cols_c),
                       torch.full((), float("-inf"), device=dev))
    stage.hot_stage(cand, rows, w, cells.contiguous())
    s, d = _topk_over_columns(cand, cols, k)
    return s, d, BlockmaxStats(considered, considered - n_need, 0)


def tfidf_topk_blockmax(q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
                        df, num_docs: int, hot_blk_bound, *, width: int,
                        cand_blocks: int, k: int = 10,
                        compat_int_idf: bool = False,
                        hot_preweighted: bool = False):
    """Block-max TF-IDF top-k on the tiered layout (arguments as
    tfidf_topk_tiered, plus the [H, nblk] bound table, the block width and
    the selected-block budget). Returns (scores [B, k], docnos [B, k],
    BlockmaxStats); bitwise the scores and docnos of tfidf_topk_tiered."""
    weight_fn, cell_fn = _tfidf_weights(hot_preweighted)
    return _blockmax_topk(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
        idf_weights(df, num_docs, compat_int_idf), hot_blk_bound,
        num_docs=num_docs, k=k, width=width, cand_blocks=cand_blocks,
        hot_weight_fn=weight_fn, hot_cell_fn=cell_fn)


def bm25_topk_blockmax(q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
                       df, doc_len, num_docs: int, hot_blk_bound, *,
                       width: int, cand_blocks: int, k: int = 10,
                       k1: float = 0.9, b: float = 0.4,
                       hot_preweighted: bool = False):
    """Block-max BM25 top-k (as tfidf_topk_blockmax). The bound table must
    dominate the saturation weights: the Scorer folds each block's least
    doc-length norm into it."""
    dl_norm = bm25_dl_norm(doc_len, num_docs, b)
    weight_fn, cell_fn = _bm25_weights(dl_norm, k1, hot_preweighted)
    return _blockmax_topk(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers,
        bm25_idf_weights(df, num_docs), hot_blk_bound, num_docs=num_docs,
        k=k, width=width, cand_blocks=cand_blocks, hot_weight_fn=weight_fn,
        hot_cell_fn=cell_fn, dl_norm=dl_norm, k1=k1)


# -- cosine rerank -----------------------------------------------------------


def _cosine_dense_scores(q_terms, matrix, df, doc_norm, cand_docnos,
                         num_docs: int) -> torch.Tensor:
    """[B, C] cosine scores of the candidates on the dense layout: per
    query-term slot idf^2 * (1 + ln tf) at the candidates' cells, summed
    in slot order, over ||d||. `matrix` is the float32 (1 + ln tf) doc
    matrix, or a compressed index's bf16 raw-tf matrix, whose gathered
    cells are widened and weighted (bitwise the float32 matrix's)."""
    vocab_size = matrix.shape[0]
    idf = idf_weights(df, num_docs)
    q_valid = (q_terms >= 0) & (q_terms < vocab_size)
    safe_q = torch.where(q_valid, q_terms, 0).long()
    q_idf = torch.where(q_valid, idf[safe_q],
                        torch.zeros((), dtype=torch.float32,
                                    device=idf.device))
    w2 = q_idf * q_idf                                          # [B, L]
    cand = cand_docnos.long()
    scores = torch.zeros(cand.shape, dtype=torch.float32,
                         device=matrix.device)
    for l in range(q_terms.shape[1]):
        cells = matrix[safe_q[:, l, None], cand]                # [B, C]
        if cells.dtype != torch.float32:
            cells = _lntf(cells)
        scores = scores + cells * w2[:, l, None]
    return scores / torch.clamp(doc_norm[cand], min=1e-30)


def cosine_rerank_dense(q_terms, matrix, df, doc_norm, cand_docnos,
                        num_docs: int, *, k: int = 10
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 of the two-stage rerank (`tpu_ir/ops/scoring.py::
    cosine_rerank_dense`): cosine-normalised TF-IDF over the stage-1
    candidates cand_docnos int [B, C] (0 = empty), with doc_norm float32
    [D+1] the doc vectors' norms under (1 + ln tf) * idf. A repeated
    query term counts once per slot. Work is B*L*C cells, not B*L*D."""
    scores = _cosine_dense_scores(q_terms, matrix, df, doc_norm,
                                  cand_docnos, num_docs)
    return _topk_over_candidates(scores, cand_docnos, k)


def cosine_scores_at_dense(q_terms, matrix, df, doc_norm, cand_docnos,
                           num_docs: int) -> torch.Tensor:
    """Explain's twin of cosine_rerank_dense: the candidates' cosine
    scores in candidate order, no top-k. Pass the candidate matrix shape
    the rerank used."""
    return _cosine_dense_scores(q_terms, matrix, df, doc_norm, cand_docnos,
                                num_docs)


def _cosine_tiered_scores(q_terms, hot_rank, hot_tfs, tier_of, row_of,
                          tiers, df, doc_norm, num_docs: int, cand_docnos,
                          *, hot_preweighted: bool = False) -> torch.Tensor:
    """[B, C] cosine scores of the candidates on the tiered layout: the
    exact tiered accumulation with idf^2 weights over the whole doc axis
    (cold tiers, then the hot stage with the (1 + ln tf) strip), gathered
    at the candidates, then divided by their norms."""
    idf = idf_weights(df, num_docs)
    scores = _tiered_scores(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers, idf * idf,
        num_docs=num_docs,
        hot_weight_fn=_tfidf_weights(hot_preweighted)[0])
    cand = cand_docnos.long()
    return (torch.gather(scores, 1, cand)
            / torch.clamp(doc_norm[cand], min=1e-30))


def cosine_rerank_tiered(q_terms, hot_rank, hot_tfs, tier_of, row_of,
                         tiers, df, doc_norm, num_docs: int, cand_docnos,
                         *, k: int = 10, hot_preweighted: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """cosine_rerank_dense on the tiered layout. `hot_preweighted` takes
    the cached (1 + ln tf) strip (lntf_strip), the TF-IDF top-k's."""
    scores = _cosine_tiered_scores(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers, df, doc_norm,
        num_docs, cand_docnos, hot_preweighted=hot_preweighted)
    return _topk_over_candidates(scores, cand_docnos, k)


def cosine_scores_at_tiered(q_terms, hot_rank, hot_tfs, tier_of, row_of,
                            tiers, df, doc_norm, num_docs: int, cand_docnos,
                            *, hot_preweighted: bool = False
                            ) -> torch.Tensor:
    """Explain's twin of cosine_rerank_tiered, in candidate order."""
    return _cosine_tiered_scores(
        q_terms, hot_rank, hot_tfs, tier_of, row_of, tiers, df, doc_norm,
        num_docs, cand_docnos, hot_preweighted=hot_preweighted)
