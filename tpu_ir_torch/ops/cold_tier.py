"""The cold stage of tiered scoring: the hand-written CUDA kernel and its
plain twin.

This module takes the place of `experiments/cold_tier_bench.py::
pallas_cold_tier` (the Pallas design of the stage) and of `do_tier` in
`tpu_ir/ops/scoring.py:343-353` (the XLA code serving runs). For one df
tier of the tiered layout it adds every in-tier query term's postings
into the [B, D+1] score accumulator, in place:

    scores[b, docs[r, p]] += cell(tfs[r, p]) * q_w[b, l]
        for each (b, l) with q_tier[b, l] == tier, r = q_rows[b, l], and
        slot p with tf > 0

with cell = 1 + ln tf (TF-IDF) or the BM25 saturation with the doc-length
norm gathered at the posting's doc (`dl_norm` given).

`cold_tier` is the wrapper. On a CUDA tensor it launches
`csrc/cold_tier.cu` (or raises); on a CPU tensor it runs `cold_tier_plain`.
The two are bitwise equal on the card: both add each cell in l order with
one rounded multiply and one rounded add, and neither reorders a sum.
"""

from __future__ import annotations

import ctypes

import torch

from .scoring import _lntf, bm25_saturation

_launches = 0
# the C entry point's parameters: q_tier, rows, weights, tdocs, ttfs,
# dl_norm, scores; tier; batch, num_terms, v_t, cap, width; k1, k1 + 1;
# stream
ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int32] + [ctypes.c_int64] * 5
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def cold_tier_launches() -> int:
    return _launches


def reset_cold_tier_launches() -> None:
    global _launches
    _launches = 0


def _check(scores, q_tier, q_rows, q_w, tdocs, ttfs, dl_norm) -> None:
    dev = scores.device
    tensors = [q_tier, q_rows, q_w, tdocs, ttfs] + (
        [] if dl_norm is None else [dl_norm])
    if any(t.device != dev for t in tensors):
        raise ValueError(f"cold_tier: every tensor must be on {dev}")
    if scores.dtype != torch.float32 or q_w.dtype != torch.float32 \
            or (dl_norm is not None and dl_norm.dtype != torch.float32):
        raise ValueError("cold_tier: scores, q_w and dl_norm must be "
                         "float32")
    if any(t.dtype != torch.int32 for t in (q_tier, q_rows, tdocs, ttfs)):
        raise ValueError("cold_tier: expected int32 term tiers and rows and "
                         "int32 tier arrays (got "
                         f"{q_tier.dtype}, {q_rows.dtype}, {tdocs.dtype}, "
                         f"{ttfs.dtype})")
    if scores.dim() != 2 or q_rows.dim() != 2 \
            or q_tier.shape != q_rows.shape or q_w.shape != q_rows.shape \
            or q_rows.shape[0] != scores.shape[0] \
            or tdocs.dim() != 2 or tdocs.shape != ttfs.shape \
            or (dl_norm is not None
                and dl_norm.shape != scores.shape[1:]):
        raise ValueError(
            "cold_tier: expected scores [B, D+1], tiers/rows/weights [B, L], "
            "tier arrays [V_t, P_t] and dl_norm [D+1] (got "
            f"{tuple(scores.shape)}, {tuple(q_tier.shape)}, "
            f"{tuple(q_rows.shape)}, {tuple(q_w.shape)}, "
            f"{tuple(tdocs.shape)}, {tuple(ttfs.shape)}, "
            f"{None if dl_norm is None else tuple(dl_norm.shape)})")
    if not all(t.is_contiguous() for t in tensors + [scores]):
        raise ValueError("cold_tier: every tensor must be contiguous")


def tier_rows_and_weights(q_tier: torch.Tensor, q_rows: torch.Tensor,
                          q_w: torch.Tensor, tier: int, num_rows: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, weights) of one tier: each (b, l)'s row, 0 where the term is
    not in the tier, and its weight, 0 there; what the Pallas wrapper
    computes outside its call (cold_tier_bench.py:53-54) and the kernel
    computes per term. Rows are also clamped to the tier's 0..num_rows-1,
    as the JAX gather clamps them."""
    in_tier = q_tier == tier
    rows = torch.where(in_tier, q_rows, 0).clamp(0, num_rows - 1)
    w = torch.where(in_tier, q_w, torch.zeros((), dtype=q_w.dtype,
                                              device=q_w.device))
    return rows, w


def cold_tier_plain(scores: torch.Tensor, q_tier: torch.Tensor,
                    q_rows: torch.Tensor, q_w: torch.Tensor, tier: int,
                    tdocs: torch.Tensor, ttfs: torch.Tensor, *,
                    dl_norm: torch.Tensor | None = None,
                    k1: float = 0.9) -> None:
    """Plain PyTorch twin of the kernel, in place on `scores`. Each term's
    cells are scatter-added into a [B, D+2] buffer whose last column takes
    the dropped slots (the JAX scatter's mode="drop"); a tier row's docs
    are distinct, so each real cell gets one add per term, in l order."""
    _check(scores, q_tier, q_rows, q_w, tdocs, ttfs, dl_norm)
    rows, w = tier_rows_and_weights(q_tier, q_rows, q_w, tier,
                                    tdocs.shape[0])
    b, width = scores.shape
    buf = torch.cat([scores, torch.zeros((b, 1), dtype=scores.dtype,
                                         device=scores.device)], dim=1)
    for l in range(rows.shape[1]):
        r = rows[:, l].long()
        docs = tdocs.index_select(0, r).long()             # [B, P_t]
        tfs = ttfs.index_select(0, r)
        if dl_norm is None:
            cell = _lntf(tfs)
        else:
            cell = bm25_saturation(
                tfs, dl_norm[docs.clamp(0, width - 1)], k1=k1)
        cell = torch.where(tfs > 0, cell, torch.zeros(
            (), dtype=torch.float32, device=cell.device)) * w[:, l, None]
        keep = (tfs > 0) & (docs >= 0) & (docs < width)
        buf.scatter_add_(1, torch.where(keep, docs, width), cell)
    scores.copy_(buf[:, :width])


def cold_tier(scores: torch.Tensor, q_tier: torch.Tensor,
              q_rows: torch.Tensor, q_w: torch.Tensor, tier: int,
              tdocs: torch.Tensor, ttfs: torch.Tensor, *,
              dl_norm: torch.Tensor | None = None, k1: float = 0.9) -> None:
    """Add tier `tier`'s cold contributions into `scores` [B, D+1] in place.

    q_tier int32 [B, L]: each term's tier index (-1 for none); q_rows int32
    [B, L]: its row there; q_w float32 [B, L]: its weight. A query block
    prepares these once for all its tiers. tdocs, ttfs int32 [V_t, P_t]:
    the tier's arrays; dl_norm float32 [D+1] selects BM25 (None: TF-IDF).
    A CUDA input launches csrc/cold_tier.cu on the current stream; a CPU
    input runs the plain twin."""
    global _launches
    _check(scores, q_tier, q_rows, q_w, tdocs, ttfs, dl_norm)
    if scores.device.type == "cpu":
        cold_tier_plain(scores, q_tier, q_rows, q_w, tier, tdocs, ttfs,
                        dl_norm=dl_norm, k1=k1)
        return
    if scores.device.type != "cuda":
        raise ValueError(f"cold_tier: unsupported device {scores.device}")
    from . import _build

    fn = _build.entry("cold_tier", "tpu_ir_cold_tier", ARGTYPES)
    b, num_terms = q_rows.shape
    v_t, cap = tdocs.shape
    if b == 0 or num_terms == 0 or v_t == 0 or cap == 0:
        return                                       # nothing to launch
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = fn(q_tier.data_ptr(), q_rows.data_ptr(), q_w.data_ptr(),
                 tdocs.data_ptr(), ttfs.data_ptr(),
                 None if dl_norm is None else dl_norm.data_ptr(),
                 scores.data_ptr(), tier, b, num_terms, v_t, cap,
                 scores.shape[1], k1, k1 + 1.0, stream)
    if err != 0:
        raise RuntimeError(f"cold_tier kernel launch failed: CUDA error "
                           f"{err}")
    _launches += 1
