"""The cold stage of tiered scoring: the hand-written CUDA kernel and its
plain twin.

This module takes the place of `experiments/cold_tier_bench.py::
pallas_cold_tier` (the Pallas design of the stage) and of `do_tier` in
`tpu_ir/ops/scoring.py:343-353` (the XLA code serving runs). For every df
tier of the tiered layout, in tier order, it adds every in-tier query
term's postings into the [B, D+1] score accumulator, in place:

    scores[b, docs_t[r, p]] += cell(tfs_t[r, p]) * q_w[b, l]
        for each (b, l) with q_tier[b, l] == t, r = q_rows[b, l], and
        slot p with tf > 0

with cell = 1 + ln tf (TF-IDF) or the BM25 saturation with the doc-length
norm gathered at the posting's doc (`dl_norm` given).

`TierTable` holds a layout's tiers and the host table the kernel reads;
build it once per loaded layout. `cold_stage` is the wrapper: on CUDA
tensors it launches `csrc/cold_tier.cu` once for the whole stage (or
raises); on CPU tensors it runs `cold_stage_plain`, which runs
`cold_tier_plain` tier by tier. The two are bitwise equal on the card: both
add each cell in tier order, then l order, with one rounded multiply and
one rounded add, and neither reorders a sum.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

from .scoring import _lntf, bm25_saturation

# csrc/cold_tier.cu kMaxTiers: 16 tiers of cap 2 * 4^t (search/layout.py)
# reach 2^31, past any int32 df
MAX_TIERS = 16

_launches = _build.LaunchCounter()
# the C entry point's parameters: q_tier, rows, weights, tier table;
# num_tiers; dl_norm, scores; batch, num_terms, width; k1, k1 + 1; stream
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int32]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 3
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def cold_tier_launches() -> int:
    return _launches.value


def reset_cold_tier_launches() -> None:
    _launches.reset()


class TierTable:
    """A layout's cold tiers in tier order: docs and tfs int32 [V_t, P_t]
    each, on one device, and the host int64 [T, 4] table of (docs pointer,
    tfs pointer, V_t, P_t) that the kernel takes by value. Checked and
    built once; the tensors are held, so the pointers stay valid."""

    def __init__(self, docs: Sequence[torch.Tensor],
                 tfs: Sequence[torch.Tensor]):
        self.docs, self.tfs = tuple(docs), tuple(tfs)
        if len(self.docs) != len(self.tfs):
            raise ValueError(f"cold_tier: {len(self.docs)} docs arrays but "
                             f"{len(self.tfs)} tfs arrays")
        if len(self.docs) > MAX_TIERS:
            raise ValueError(f"cold_tier: {len(self.docs)} tiers; the "
                             f"kernel takes at most {MAX_TIERS}")
        devices = {t.device for t in self.docs + self.tfs}
        if len(devices) > 1:
            raise ValueError(f"cold_tier: tier arrays on {devices}")
        self.device = devices.pop() if devices else None
        for d, f in zip(self.docs, self.tfs):
            if d.dtype != torch.int32 or f.dtype != torch.int32:
                raise ValueError("cold_tier: expected int32 tier arrays "
                                 f"(got {d.dtype}, {f.dtype})")
            if d.dim() != 2 or d.shape != f.shape:
                raise ValueError("cold_tier: expected tier arrays [V_t, P_t]"
                                 f" (got {tuple(d.shape)}, "
                                 f"{tuple(f.shape)})")
            if not (d.is_contiguous() and f.is_contiguous()):
                raise ValueError("cold_tier: tier arrays must be "
                                 "contiguous")
        self.c_table = (ctypes.c_int64 * (4 * len(self.docs)))(*[
            v for d, f in zip(self.docs, self.tfs)
            for v in (d.data_ptr(), f.data_ptr(), d.shape[0], d.shape[1])])

    def __len__(self) -> int:
        return len(self.docs)


def _check(scores, q_tier, q_rows, q_w, tiers: TierTable, dl_norm) -> None:
    dev = scores.device
    tensors = [q_tier, q_rows, q_w] + ([] if dl_norm is None else [dl_norm])
    if any(t.device != dev for t in tensors) or (
            tiers.device is not None and tiers.device != dev):
        raise ValueError(f"cold_tier: every tensor must be on {dev}")
    if scores.dtype != torch.float32 or q_w.dtype != torch.float32 \
            or (dl_norm is not None and dl_norm.dtype != torch.float32):
        raise ValueError("cold_tier: scores, q_w and dl_norm must be "
                         "float32")
    if q_tier.dtype != torch.int32 or q_rows.dtype != torch.int32:
        raise ValueError("cold_tier: expected int32 term tiers and rows "
                         f"(got {q_tier.dtype}, {q_rows.dtype})")
    if scores.dim() != 2 or q_rows.dim() != 2 \
            or q_tier.shape != q_rows.shape or q_w.shape != q_rows.shape \
            or q_rows.shape[0] != scores.shape[0] \
            or (dl_norm is not None
                and dl_norm.shape != scores.shape[1:]):
        raise ValueError(
            "cold_tier: expected scores [B, D+1], tiers/rows/weights [B, L] "
            "and dl_norm [D+1] (got "
            f"{tuple(scores.shape)}, {tuple(q_tier.shape)}, "
            f"{tuple(q_rows.shape)}, {tuple(q_w.shape)}, "
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
    """Plain PyTorch form of one tier's share of the kernel, in place on
    `scores`, for a non-empty tier. Each term's cells are scatter-added
    into a [B, D+2] buffer whose last column takes the dropped slots (the
    JAX scatter's mode="drop"); a tier row's docs are distinct, so each
    real cell gets one add per term, in l order."""
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


def cold_stage_plain(scores: torch.Tensor, q_tier: torch.Tensor,
                     q_rows: torch.Tensor, q_w: torch.Tensor,
                     tiers: TierTable, *,
                     dl_norm: torch.Tensor | None = None,
                     k1: float = 0.9) -> None:
    """Plain PyTorch twin of the kernel, in place on `scores`: the tiers in
    order through `cold_tier_plain`; an empty tier adds nothing."""
    _check(scores, q_tier, q_rows, q_w, tiers, dl_norm)
    for t, (tdocs, ttfs) in enumerate(zip(tiers.docs, tiers.tfs)):
        if tdocs.numel():
            cold_tier_plain(scores, q_tier, q_rows, q_w, t, tdocs, ttfs,
                            dl_norm=dl_norm, k1=k1)


def cold_stage(scores: torch.Tensor, q_tier: torch.Tensor,
               q_rows: torch.Tensor, q_w: torch.Tensor, tiers: TierTable, *,
               dl_norm: torch.Tensor | None = None, k1: float = 0.9) -> None:
    """Add every tier's cold contributions into `scores` [B, D+1] in place.

    q_tier int32 [B, L]: each term's tier index (-1 for none); q_rows int32
    [B, L]: its row there; q_w float32 [B, L]: its weight. tiers: the
    layout's TierTable; dl_norm float32 [D+1] selects BM25 (None: TF-IDF).
    CUDA inputs launch csrc/cold_tier.cu once on the current stream; CPU
    inputs run the plain twin."""
    _check(scores, q_tier, q_rows, q_w, tiers, dl_norm)
    if scores.device.type == "cpu":
        cold_stage_plain(scores, q_tier, q_rows, q_w, tiers,
                         dl_norm=dl_norm, k1=k1)
        return
    if scores.device.type != "cuda":
        raise ValueError(f"cold_tier: unsupported device {scores.device}")
    b, num_terms = q_rows.shape
    if b == 0 or num_terms == 0 or len(tiers) == 0:
        return                                       # nothing to launch
    fn = _build.entry("cold_tier", "tpu_ir_cold_tier", ARGTYPES)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = fn(q_tier.data_ptr(), q_rows.data_ptr(), q_w.data_ptr(),
                 tiers.c_table, len(tiers),
                 None if dl_norm is None else dl_norm.data_ptr(),
                 scores.data_ptr(), b, num_terms, scores.shape[1], k1,
                 k1 + 1.0, stream)
    if err != 0:
        raise RuntimeError(f"cold_tier kernel launch failed: CUDA error "
                           f"{err}")
    _launches.add()
