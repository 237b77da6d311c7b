"""Fused dense TF-IDF scoring: the hand-written CUDA kernel and its plain twin.

This module takes the place of `tpu_ir/ops/pallas_scoring.py`. Its kernel,
`csrc/dense_score.cu`, ports the Pallas kernel `pallas_tfidf_scores`
(pallas_scoring.py:52): it streams one doc-matrix row per (query, term)
into a per-query score row, with no [B, L, D+1] intermediate. The TPU
package retired that kernel from serving in favour of XLA; here it is the
dense TF-IDF path of `Scorer.topk`.

`dense_scores` is the wrapper. On a CUDA tensor it launches the kernel (or
raises); on a CPU tensor it runs `dense_scores_plain`, the same arithmetic
in the same term order, which the CPU tests hold against the JAX package.
The two are bitwise equal on the card: each term is one rounded multiply
and one rounded add, in l order, in both.
"""

from __future__ import annotations

import ctypes

import torch

from .scoring import idf_weights

_launches = 0


def dense_score_launches() -> int:
    return _launches


def reset_dense_score_launches() -> None:
    global _launches
    _launches = 0


def query_weights(q_terms: torch.Tensor, idf: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(safe_q, q_w): term ids clamped to a valid row (0 where invalid)
    and the per-(b, l) idf weight, 0 for -1 padding and ids outside the
    vocabulary — what the JAX wrapper computes outside `pallas_call`
    (pallas_scoring.py:65-72)."""
    vocab_size = idf.shape[0]
    q_valid = (q_terms >= 0) & (q_terms < vocab_size)
    safe_q = torch.where(q_valid, q_terms, 0).to(torch.int32)
    q_w = torch.where(q_valid, idf[safe_q.long()],
                      torch.zeros((), dtype=idf.dtype, device=idf.device))
    return safe_q.contiguous(), q_w.to(torch.float32).contiguous()


def dense_scores_plain(q_terms: torch.Tensor, idf: torch.Tensor,
                       doc_matrix: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: [B, D+1] float32 scores."""
    _check(q_terms, idf, doc_matrix)
    safe_q, q_w = query_weights(q_terms, idf)
    b, num_terms = safe_q.shape
    acc = torch.zeros((b, doc_matrix.shape[1]), dtype=torch.float32,
                      device=doc_matrix.device)
    for l in range(num_terms):
        rows = doc_matrix.index_select(0, safe_q[:, l].long())
        acc = acc + rows * q_w[:, l, None]
    return acc


def _check(q_terms: torch.Tensor, idf: torch.Tensor,
           doc_matrix: torch.Tensor) -> None:
    dev = doc_matrix.device
    if q_terms.device != dev or idf.device != dev:
        raise ValueError("dense_scores: every tensor must be on "
                         f"{dev} (got {q_terms.device}, {idf.device})")
    if q_terms.dtype not in (torch.int32, torch.int64) \
            or idf.dtype != torch.float32 \
            or doc_matrix.dtype != torch.float32:
        raise ValueError("dense_scores: expected integer ids, float32 idf "
                         f"and matrix (got {q_terms.dtype}, {idf.dtype}, "
                         f"{doc_matrix.dtype})")
    if q_terms.dim() != 2 or doc_matrix.dim() != 2 \
            or idf.shape != doc_matrix.shape[:1]:
        raise ValueError("dense_scores: expected ids [B, L], idf [V] and a "
                         f"[V, D+1] matrix (got {tuple(q_terms.shape)}, "
                         f"{tuple(idf.shape)}, {tuple(doc_matrix.shape)})")
    if not doc_matrix.is_contiguous():
        raise ValueError("dense_scores: the matrix must be contiguous")


def dense_scores(q_terms: torch.Tensor, idf: torch.Tensor,
                 doc_matrix: torch.Tensor) -> torch.Tensor:
    """scores[b, d] = sum_l idf[q[b, l]] * doc_matrix[q[b, l], d], with -1
    pads and ids outside 0..V-1 weighing 0.

    q_terms int32/int64 [B, L]; idf float32 [V]; doc_matrix float32
    [V, D+1]. The ids are clamped to valid rows here, before the launch, so
    the kernel never reads outside the matrix. A CUDA input launches
    csrc/dense_score.cu on the current stream; a CPU input runs the plain
    twin."""
    global _launches
    _check(q_terms, idf, doc_matrix)
    if doc_matrix.device.type == "cpu":
        return dense_scores_plain(q_terms, idf, doc_matrix)
    if doc_matrix.device.type != "cuda":
        raise ValueError(f"dense_scores: unsupported device "
                         f"{doc_matrix.device}")
    from . import _build

    lib = _build.load("dense_score")
    fn = lib.tpu_ir_dense_score
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    safe_q, q_w = query_weights(q_terms, idf)
    b, num_terms = safe_q.shape
    width = doc_matrix.shape[1]
    out = torch.empty((b, width), dtype=torch.float32,
                      device=doc_matrix.device)
    if out.numel() == 0:
        return out                                   # nothing to launch
    with torch.cuda.device(doc_matrix.device):
        stream = torch.cuda.current_stream(doc_matrix.device).cuda_stream
        err = fn(safe_q.data_ptr(), q_w.data_ptr(), doc_matrix.data_ptr(),
                 out.data_ptr(), b, num_terms, width, stream)
    if err != 0:
        raise RuntimeError(f"dense_score kernel launch failed: CUDA error "
                           f"{err}")
    _launches += 1
    return out


def tfidf_scores(q_terms: torch.Tensor, doc_matrix: torch.Tensor,
                 df: torch.Tensor, num_docs: int, *,
                 compat_int_idf: bool = False) -> torch.Tensor:
    """[B, D+1] TF-IDF scores of an int32 [B, L] query batch (-1 pads):
    the counterpart of `pallas_tfidf_scores` and of the XLA dense path
    `_tfidf_dense_scores`, through the fused kernel."""
    return dense_scores(q_terms, idf_weights(df, num_docs, compat_int_idf),
                        doc_matrix)
