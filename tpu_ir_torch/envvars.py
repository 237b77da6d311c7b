"""The environment knobs the port reads, with the JAX package's names,
defaults and rules (`tpu_ir/utils/envvars.py`): an unset or empty variable
means its default, an integer below its minimum reads as the minimum, and
a choice outside its set raises.

    TPU_IR_BLOCKMAX          auto | 0 | 1: block-max pruning of the tiered
                             hot stage (0 disables; results are bitwise the
                             same either way)
    TPU_IR_BLOCKMAX_WIDTH    doc-axis block width of the bounds artifact
                             (default 512, at least 64; fixed per artifact
                             when it is written)
    TPU_IR_BLOCKMAX_BLOCKS   doc blocks one block-max dispatch scores
                             exactly (0: sized from k, the width and the
                             doc axis)
    TPU_IR_QUARANTINE_KEEP   corrupt artifacts kept in .quarantine/
                             (default 8)
"""

from __future__ import annotations

import os

# name: (default, minimum)
_INTS = {"TPU_IR_BLOCKMAX_WIDTH": (512, 64),
         "TPU_IR_BLOCKMAX_BLOCKS": (0, 0),
         "TPU_IR_QUARANTINE_KEEP": (8, 0)}
# name: (default, choices)
_CHOICES = {"TPU_IR_BLOCKMAX": ("auto", ("auto", "0", "1"))}


def get_int(name: str) -> int:
    default, minimum = _INTS[name]
    v = os.environ.get(name)
    if not v:
        return default
    try:
        out = int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: expected an integer") from None
    return max(out, minimum)


def get_choice(name: str) -> str:
    default, choices = _CHOICES[name]
    v = (os.environ.get(name) or "").strip().lower()
    if not v:
        return default
    if v not in choices:
        raise ValueError(f"{name}={v!r}: expected one of {choices}")
    return v
