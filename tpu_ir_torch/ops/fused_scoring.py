"""Fused dense TF-IDF scoring: the hand-written CUDA kernels and their
plain twins.

This module takes the place of `tpu_ir/ops/pallas_scoring.py` and holds
the counterparts of its two Pallas kernels:

- `csrc/dense_score.cu` ports `pallas_tfidf_scores` (pallas_scoring.py:52):
  it streams one row of the float32 (1 + ln tf) doc matrix per (query,
  term) into a per-query score row, with no [B, L, D+1] intermediate.
- `csrc/dequant_score.cu` ports `pallas_tfidf_scores_quantized`
  (pallas_scoring.py:129): the same schedule over a bf16 raw-tf matrix
  (a compressed index's dense layout), widening each cell and applying
  1 + ln tf in the kernel, so no float32 matrix exists in device memory.

The TPU package retired the first from serving in favour of XLA and never
served the second; here they are the dense TF-IDF paths of `Scorer.topk`
for a float32 and a bf16 index.

Both kernels share one schedule, `csrc/dense_rows.cuh`: a grid of about
(SMs x resident blocks) walking (query, column tile) work items, with the
raw ids and the idf vector resolved inside the kernel. The C entry point
plans the grid for the device it runs on.

`dense_scores` and `dense_scores_quantized` are the wrappers. On a CUDA
tensor each allocates the scores and launches its kernel (or raises),
with no other device work for an int32 batch; on a CPU tensor it runs its
plain twin, the same arithmetic in the same term order, which the CPU
tests hold against the JAX package. Kernel and twin are bitwise equal on
the card: each term is one rounded multiply and one rounded add, in l
order, in both. On bf16-exact tfs the two kernels give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .scoring import _lntf, idf_weights

_launches = _build.LaunchCounter()
_dequant_launches = _build.LaunchCounter()


def dense_score_launches() -> int:
    return _launches.value


def reset_dense_score_launches() -> None:
    _launches.reset()


def dequant_score_launches() -> int:
    return _dequant_launches.value


def reset_dequant_score_launches() -> None:
    _dequant_launches.reset()


def query_weights(q_terms: torch.Tensor, idf: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(safe_q, q_w): term ids clamped to a valid row (0 where invalid)
    and the per-(b, l) idf weight, 0 for -1 padding and ids outside the
    vocabulary — what the JAX wrapper computes outside `pallas_call`
    (pallas_scoring.py:65-72). The plain twins use it; the kernels do the
    same inside (csrc/dense_rows.cuh)."""
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


def dense_scores_quantized_plain(q_terms: torch.Tensor, idf: torch.Tensor,
                                 tf_matrix: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the quantized kernel: [B, D+1] float32
    scores from a bf16 raw-tf matrix, each gathered row widened and
    weighted (1 + ln tf) before its term's multiply and add."""
    _check(q_terms, idf, tf_matrix, torch.bfloat16)
    safe_q, q_w = query_weights(q_terms, idf)
    b, num_terms = safe_q.shape
    acc = torch.zeros((b, tf_matrix.shape[1]), dtype=torch.float32,
                      device=tf_matrix.device)
    for l in range(num_terms):
        rows = tf_matrix.index_select(0, safe_q[:, l].long())
        acc = acc + _lntf(rows) * q_w[:, l, None]
    return acc


def _check(q_terms: torch.Tensor, idf: torch.Tensor, matrix: torch.Tensor,
           matrix_dtype: torch.dtype = torch.float32) -> None:
    name = ("dense_scores" if matrix_dtype == torch.float32
            else "dense_scores_quantized")
    dev = matrix.device
    if q_terms.device != dev or idf.device != dev:
        raise ValueError(f"{name}: every tensor must be on "
                         f"{dev} (got {q_terms.device}, {idf.device})")
    if q_terms.dtype not in (torch.int32, torch.int64) \
            or idf.dtype != torch.float32 or matrix.dtype != matrix_dtype:
        raise ValueError(f"{name}: expected integer ids, float32 idf and a "
                         f"{matrix_dtype} matrix (got {q_terms.dtype}, "
                         f"{idf.dtype}, {matrix.dtype})")
    if q_terms.dim() != 2 or matrix.dim() != 2 \
            or idf.shape != matrix.shape[:1]:
        raise ValueError(f"{name}: expected ids [B, L], idf [V] and a "
                         f"[V, D+1] matrix (got {tuple(q_terms.shape)}, "
                         f"{tuple(idf.shape)}, {tuple(matrix.shape)})")
    if not matrix.is_contiguous():
        raise ValueError(f"{name}: the matrix must be contiguous")


# the C entry points' parameters: q, idf, matrix, out; batch, num_terms,
# vocab, width; stream
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]


def _launch(symbol: str, q_terms: torch.Tensor, idf: torch.Tensor,
            matrix: torch.Tensor) -> torch.Tensor:
    """Allocate the scores and launch csrc/<symbol>.cu's kernel on the
    current stream; both kernels take the same arguments. The kernel
    resolves the raw ids and their idf weights itself."""
    fn = _build.entry(symbol, f"tpu_ir_{symbol}", ARGTYPES)
    vocab, width = matrix.shape
    b, num_terms = q_terms.shape
    if q_terms.dtype == torch.int64:
        # one cast to the kernel's int32; ids outside 0..V-1 stay outside
        q_terms = q_terms.clamp(-1, vocab).to(torch.int32)
    q_terms, idf = q_terms.contiguous(), idf.contiguous()
    out = torch.empty((b, width), dtype=torch.float32, device=matrix.device)
    if out.numel() == 0:
        return out                                   # nothing to launch
    with torch.cuda.device(matrix.device):
        stream = torch.cuda.current_stream(matrix.device).cuda_stream
        err = fn(q_terms.data_ptr(), idf.data_ptr(), matrix.data_ptr(),
                 out.data_ptr(), b, num_terms, vocab, width, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error "
                           f"{err}")
    return out


def dense_scores(q_terms: torch.Tensor, idf: torch.Tensor,
                 doc_matrix: torch.Tensor) -> torch.Tensor:
    """scores[b, d] = sum_l idf[q[b, l]] * doc_matrix[q[b, l], d], with -1
    pads and ids outside 0..V-1 weighing 0.

    q_terms int32/int64 [B, L]; idf float32 [V]; doc_matrix float32
    [V, D+1]. A CUDA input launches csrc/dense_score.cu on the current
    stream, which checks each id against V and gathers its idf weight
    itself, so the kernel never reads outside the matrix; a CPU input runs
    the plain twin."""
    _check(q_terms, idf, doc_matrix)
    if doc_matrix.device.type == "cpu":
        return dense_scores_plain(q_terms, idf, doc_matrix)
    if doc_matrix.device.type != "cuda":
        raise ValueError(f"dense_scores: unsupported device "
                         f"{doc_matrix.device}")
    out = _launch("dense_score", q_terms, idf, doc_matrix)
    if out.numel():
        _launches.add()
    return out


def dense_scores_quantized(q_terms: torch.Tensor, idf: torch.Tensor,
                           tf_matrix: torch.Tensor) -> torch.Tensor:
    """dense_scores over a bf16 raw-tf matrix: scores[b, d] = sum_l
    idf[q[b, l]] * w(tf[q[b, l], d]) with w(tf) = 1 + ln tf for tf > 0,
    else 0; pads and out-of-vocabulary ids weigh 0.

    q_terms int32/int64 [B, L]; idf float32 [V]; tf_matrix bfloat16
    [V, D+1]. A CUDA input launches csrc/dequant_score.cu on the current
    stream; a CPU input runs the plain twin."""
    _check(q_terms, idf, tf_matrix, torch.bfloat16)
    if tf_matrix.device.type == "cpu":
        return dense_scores_quantized_plain(q_terms, idf, tf_matrix)
    if tf_matrix.device.type != "cuda":
        raise ValueError(f"dense_scores_quantized: unsupported device "
                         f"{tf_matrix.device}")
    out = _launch("dequant_score", q_terms, idf, tf_matrix)
    if out.numel():
        _dequant_launches.add()
    return out


def tfidf_scores(q_terms: torch.Tensor, doc_matrix: torch.Tensor,
                 df: torch.Tensor, num_docs: int, *,
                 compat_int_idf: bool = False) -> torch.Tensor:
    """[B, D+1] TF-IDF scores of an int32 [B, L] query batch (-1 pads):
    the counterpart of `pallas_tfidf_scores` and of the XLA dense path
    `_tfidf_dense_scores`, through the fused kernel."""
    return dense_scores(q_terms, idf_weights(df, num_docs, compat_int_idf),
                        doc_matrix)


def tfidf_scores_quantized(q_terms: torch.Tensor, tf_matrix: torch.Tensor,
                           df: torch.Tensor, num_docs: int, *,
                           compat_int_idf: bool = False) -> torch.Tensor:
    """[B, D+1] TF-IDF scores over a bf16 raw-tf matrix: the counterpart
    of `pallas_tfidf_scores_quantized`, through the quantized kernel."""
    return dense_scores_quantized(
        q_terms, idf_weights(df, num_docs, compat_int_idf), tf_matrix)
