"""The hot-strip stage of tiered scoring: the hand-written CUDA kernel and
its plain twin.

This module takes the place of the hot-strip product of the JAX package's
tiered path, `hot_matmul` (`tpu_ir/ops/scoring.py:290-304`: the query
block's hot weights scattered into a [B, H] row, duplicate terms summed,
then s + w_hot @ strip) and the block-max pruned branch's product over
the surviving columns (:582-593). It adds, in place,

    scores[b, c] += P[b, c],   P[b, c] = sum_l w[b, l] * S[r[b, l], c]

over a float32 weighted strip S [H, N] (the whole strip, or the columns
block-max kept). `hot_slots` turns a block's per-term state into (r, w):
each hot slot's strip row with duplicate terms folded into their first
slot (weights summed in slot order), -1 for every other slot.

P starts at +0 and adds one rounded product per slot in slot order, then
scores gets one rounded add, and a query with no hot slot is left as it
is. So a cell's bits depend on neither N, nor the columns chosen, nor the
batch: block-max equals the exact path bitwise, and blocked runs equal
one block. `hot_stage` is the wrapper: on CUDA tensors it launches
`csrc/hot_stage.cu` (or raises); on CPU tensors it runs `hot_stage_plain`,
which adds in the same order with torch ops.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_launches = _build.LaunchCounter()
# the C entry point's parameters: rows, weights, strip, scores; batch,
# num_slots, num_rows, width; stream
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]


def hot_stage_launches() -> int:
    return _launches.value


def reset_hot_stage_launches() -> None:
    _launches.reset()


def hot_slots(rank: torch.Tensor, is_hot: torch.Tensor, q_w: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows int32 [B, L], weights float32 [B, L]) of a query block's hot
    slots: the strip row of each hot (b, l) and its weight, with a term
    that repeats in a query folded into its first slot (the weights of
    its slots summed in slot order from +0, the JAX `w_hot` row's sum),
    and -1 / 0 for every other slot."""
    zero = torch.zeros((), dtype=torch.float32, device=q_w.device)
    rows = torch.where(is_hot, rank, -1).to(torch.int32)
    w = torch.where(is_hot, q_w, zero)
    num_slots = rows.shape[1]
    if num_slots > 1:
        same = (rows[:, :, None] == rows[:, None, :]) & (rows[:, :, None]
                                                         >= 0)
        idx = torch.arange(num_slots, device=rows.device)
        later = idx[None, :] >= idx[:, None]           # [l, m]: m >= l
        repeat = (same & ~later[None]).any(dim=2)      # an earlier slot
        folded = torch.zeros_like(w)
        for m in range(num_slots):
            folded = folded + torch.where(same[:, :, m] & later[:, m],
                                          w[:, m:m + 1], zero)
        rows = torch.where(repeat, -1, rows)
        w = torch.where(repeat, zero, folded)
    return rows.contiguous(), w.contiguous()


def _check(scores, rows, weights, strip) -> None:
    dev = scores.device
    if any(t.device != dev for t in (rows, weights, strip)):
        raise ValueError(f"hot_stage: every tensor must be on {dev} (got "
                         f"{rows.device}, {weights.device}, {strip.device})")
    if scores.dtype != torch.float32 or weights.dtype != torch.float32 \
            or strip.dtype != torch.float32 or rows.dtype != torch.int32:
        raise ValueError("hot_stage: expected float32 scores, weights and "
                         "strip and int32 rows (got "
                         f"{scores.dtype}, {weights.dtype}, {strip.dtype}, "
                         f"{rows.dtype})")
    if scores.dim() != 2 or rows.dim() != 2 or strip.dim() != 2 \
            or weights.shape != rows.shape \
            or rows.shape[0] != scores.shape[0] \
            or strip.shape[1] != scores.shape[1]:
        raise ValueError(
            "hot_stage: expected scores [B, N], rows and weights [B, L] and "
            f"a strip [H, N] (got {tuple(scores.shape)}, "
            f"{tuple(rows.shape)}, {tuple(weights.shape)}, "
            f"{tuple(strip.shape)})")
    if not all(t.is_contiguous() for t in (scores, rows, weights, strip)):
        raise ValueError("hot_stage: every tensor must be contiguous")


def hot_stage_plain(scores: torch.Tensor, rows: torch.Tensor,
                    weights: torch.Tensor, strip: torch.Tensor) -> None:
    """Plain PyTorch twin of the kernel, in place on `scores`: P from +0,
    one multiply and one add per slot in slot order (a slot outside the
    strip adds +0), then scores + P where the query has a hot slot."""
    _check(scores, rows, weights, strip)
    num_rows = strip.shape[0]
    valid = (rows >= 0) & (rows < num_rows)
    safe = torch.where(valid, rows, 0).long()
    zero = torch.zeros((), dtype=torch.float32, device=scores.device)
    acc = torch.zeros_like(scores)
    for l in range(rows.shape[1]):
        cells = strip.index_select(0, safe[:, l]) * weights[:, l, None]
        acc = acc + torch.where(valid[:, l, None], cells, zero)
    scores.copy_(torch.where(valid.any(dim=1, keepdim=True), scores + acc,
                             scores))


def hot_stage(scores: torch.Tensor, rows: torch.Tensor,
              weights: torch.Tensor, strip: torch.Tensor) -> None:
    """scores[b, c] += sum_l weights[b, l] * strip[rows[b, l], c], in place,
    in slot order; rows outside 0..H-1 add nothing and a query with none
    inside is left alone.

    scores float32 [B, N]; rows int32 [B, L] (hot_slots: duplicates
    folded); weights float32 [B, L]; strip float32 [H, N] with finite
    cells. CUDA inputs launch csrc/hot_stage.cu once on the current
    stream; CPU inputs run the plain twin."""
    _check(scores, rows, weights, strip)
    if scores.device.type == "cpu":
        hot_stage_plain(scores, rows, weights, strip)
        return
    if scores.device.type != "cuda":
        raise ValueError(f"hot_stage: unsupported device {scores.device}")
    b, num_slots = rows.shape
    width = scores.shape[1]
    if b == 0 or num_slots == 0 or width == 0:
        return                                       # nothing to launch
    fn = _build.entry("hot_stage", "tpu_ir_hot_stage", ARGTYPES)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = fn(rows.data_ptr(), weights.data_ptr(), strip.data_ptr(),
                 scores.data_ptr(), b, num_slots, strip.shape[0], width,
                 stream)
    if err != 0:
        raise RuntimeError(f"hot_stage kernel launch failed: CUDA error "
                           f"{err}")
    _launches.add()
