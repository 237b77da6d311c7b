"""tpu_ir_torch: the PyTorch/CUDA port of tpu_ir.

The package mirrors `tpu_ir`'s layout (analysis/, collection/, index/,
ops/, search/, cli.py) so each module's counterpart is easy to find. It
imports torch and numpy, never jax and never the `tpu_ir` package.

Every entry point takes `device=` and defaults to CUDA. When CUDA is
missing, a call that did not ask for `device="cpu"` raises: nothing in
the port falls back to the CPU on its own.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "kernel_launches", "reset_kernel_launches"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `device`, or CUDA by default.

    Raises RuntimeError when a CUDA device is asked for (explicitly or
    by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def kernel_launches() -> dict[str, int]:
    """Launch counts of every hand-written kernel since the last reset.
    A wrapper counts a launch only where it launches its CUDA kernel,
    never when it runs the plain version on a CPU tensor."""
    from .ops import fused_scoring

    return {"dense_score": fused_scoring.dense_score_launches()}


def reset_kernel_launches() -> None:
    from .ops import fused_scoring

    fused_scoring.reset_dense_score_launches()
