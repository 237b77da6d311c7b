"""Device ops of the port: the postings group-by, dense and tiered
scoring, the fused dense-score kernels (float32 and bf16) and the
cold-tier kernel (see each module)."""

from .fused_scoring import (
    dense_scores,
    dense_scores_plain,
    dense_scores_quantized,
    dense_scores_quantized_plain,
    tfidf_scores,
    tfidf_scores_quantized,
)
from .postings import (
    PAD_TERM,
    PAD_TERM_U16,
    Postings,
    build_postings,
    build_postings_packed,
    pair_term_from_df,
    reduce_weighted_postings,
)
from .scoring import (
    bm25_idf_weights,
    bm25_saturation,
    bm25_topk_dense,
    bm25_topk_tiered,
    dense_doc_matrix,
    dense_tf_matrix,
    idf_weights,
    tfidf_topk_dense,
    tfidf_topk_dense_quantized,
    tfidf_topk_tiered,
)

__all__ = [
    "PAD_TERM",
    "PAD_TERM_U16",
    "Postings",
    "bm25_idf_weights",
    "bm25_saturation",
    "bm25_topk_dense",
    "bm25_topk_tiered",
    "build_postings",
    "build_postings_packed",
    "dense_doc_matrix",
    "dense_scores",
    "dense_scores_plain",
    "dense_scores_quantized",
    "dense_scores_quantized_plain",
    "dense_tf_matrix",
    "idf_weights",
    "pair_term_from_df",
    "reduce_weighted_postings",
    "tfidf_scores",
    "tfidf_scores_quantized",
    "tfidf_topk_dense",
    "tfidf_topk_dense_quantized",
    "tfidf_topk_tiered",
]
