"""Batched ranked retrieval on the dense layout: TF-IDF / BM25 + top-k.

The counterpart of `tpu_ir/ops/scoring.py` for the dense layout only:
score(d) = sum over query terms of (1 + ln tf) * log10(N / df) for TF-IDF,
Okapi BM25 otherwise, truncated to the top k. A [V, D+1] term-by-doc
matrix holds the weights; column 0 (docno 0) is dead padding.

Dense TF-IDF goes through the fused CUDA kernel (ops/fused_scoring.py).
Dense BM25 stays plain torch, as it is plain XLA in the JAX package: a
row gather, the saturation curve, then a multiply and a sum over the term
axis. Everything runs in float32.

Quirk policy as in the JAX package: `compat_int_idf=True` reproduces the
reference's Java int division N/df; documents whose total score is
exactly 0 are not returned.
"""

from __future__ import annotations

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


def _dense_scatter(pair_term: torch.Tensor, pair_doc: torch.Tensor,
                   values: torch.Tensor, *, vocab_size: int,
                   num_docs: int) -> torch.Tensor:
    """[V, D+1] float32 matrix with `values` at (term, doc). The keys are
    unique after the postings group-by, so the accumulate is a plain
    store of each value into a zero cell and the result is deterministic."""
    width = num_docs + 1
    flat = torch.zeros(vocab_size * width, dtype=torch.float32,
                       device=values.device)
    term = pair_term.to(torch.int64)
    keep = (term >= 0) & (term < vocab_size)
    idx = term * width + pair_doc.to(torch.int64)
    flat.index_put_((idx[keep],), values[keep], accumulate=True)
    return flat.view(vocab_size, width)


def dense_doc_matrix(pair_term, pair_doc, pair_tf, *, vocab_size: int,
                     num_docs: int) -> torch.Tensor:
    """[V, D+1] matrix of (1 + ln tf); column 0 (docno 0) is dead padding."""
    return _dense_scatter(pair_term, pair_doc, _lntf(pair_tf),
                          vocab_size=vocab_size, num_docs=num_docs)


def dense_tf_matrix(pair_term, pair_doc, pair_tf, *, vocab_size: int,
                    num_docs: int) -> torch.Tensor:
    """[V, D+1] matrix of raw tf (float32), for BM25 saturation."""
    return _dense_scatter(pair_term, pair_doc, pair_tf.to(torch.float32),
                          vocab_size=vocab_size, num_docs=num_docs)


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


def _bm25_dense_scores(q_terms, tf_matrix, df, doc_len, num_docs: int,
                       k1: float, b: float) -> torch.Tensor:
    """[B, D+1] BM25 scores on the dense layout (plain torch, as the JAX
    package's is plain XLA: mul + reduce over the term axis)."""
    vocab_size = tf_matrix.shape[0]
    idf = bm25_idf_weights(df, num_docs)
    dl = doc_len.to(torch.float32)
    n_f = torch.tensor(float(num_docs), dtype=torch.float32,
                       device=dl.device)
    avg_dl = torch.sum(dl) / torch.clamp(n_f, min=1.0)
    dl_norm = 1.0 - b + b * dl / torch.clamp(avg_dl, min=1e-9)

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
