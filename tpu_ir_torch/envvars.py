"""The environment knobs the port reads, with the JAX package's names,
defaults and rules (`tpu_ir/utils/envvars.py`): an unset or empty variable
means its default, a number below its minimum reads as the minimum, and
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
    TPU_IR_FAULTS            fault-injection plan (faults.py grammar:
                             site[@match]:rule entries, seed=N); unset
                             injects nothing
    TPU_IR_TRACE             0 turns spans and every latency histogram off
                             (default 1; counters stay on)
    TPU_IR_BATCH_LADDER      the coalescer's batch-size rungs (default
                             1,4,16: the JAX package's 1,4,16,64 less the
                             64 rung, which pays off only where a padded
                             row rides free, as on a TPU's matrix unit; on
                             the card a padded row costs a full top-k row
                             over D+1 columns, and the top-k is most of
                             the tiered path's device time. Results are
                             bitwise the same at any ladder)
    TPU_IR_BATCH_WAIT_MS     how long a promoted batch leader may wait for
                             its batch to fill (default 0)
    TPU_IR_BATCH_WIDTH       the query-width floor of a coalesced batch
                             (default 8, at least 1)
    TPU_IR_CACHE_RESULTS     entries of the serving frontend's exact-hit
                             result cache (default 0: off)
    TPU_IR_COMPRESS          0 | 1: 1 rewrites a finished build's parts as
                             compressed (v3) arenas before the bounds and
                             the checksums are recorded (default 0)
    TPU_IR_RADIX_BUCKETS     radix buckets of the streaming build's pass-1
                             pair spills (default 16; 0 is the per-batch
                             pass-2 combine; the artifacts are the same
                             bytes either way)
    TPU_IR_TOKENIZE_PROCS    worker processes of the pure-Python tokenizer
                             (default 1: in-process; its spills are the
                             same bytes at any count)
    TPU_IR_PIPE_DEPTH        items the host prepares ahead of the device in
                             the streaming build (default 2; 1: lockstep)
    TPU_IR_RADIX_PARTS       1 writes bucket-segmented parts straight from
                             the pass-2 buckets (skips pass 3's sort; the
                             parts' bytes differ from the canonical layout,
                             every reader accepts both; default 0)
"""

from __future__ import annotations

import os

# name: (default, minimum)
_INTS = {"TPU_IR_BLOCKMAX_WIDTH": (512, 64),
         "TPU_IR_BLOCKMAX_BLOCKS": (0, 0),
         "TPU_IR_QUARANTINE_KEEP": (8, 0),
         "TPU_IR_BATCH_WIDTH": (8, 1),
         "TPU_IR_CACHE_RESULTS": (0, 0),
         "TPU_IR_RADIX_BUCKETS": (16, 0),
         "TPU_IR_TOKENIZE_PROCS": (1, 1),
         "TPU_IR_PIPE_DEPTH": (2, 1)}
_FLOATS = {"TPU_IR_BATCH_WAIT_MS": (0.0, 0.0)}
# name: default (None: unset)
_STRS = {"TPU_IR_FAULTS": None,
         "TPU_IR_BATCH_LADDER": "1,4,16"}
_BOOLS = {"TPU_IR_TRACE": True, "TPU_IR_RADIX_PARTS": False}
# name: (default, choices)
_CHOICES = {"TPU_IR_BLOCKMAX": ("auto", ("auto", "0", "1")),
            "TPU_IR_COMPRESS": ("0", ("0", "1"))}


def _raw(name: str) -> str | None:
    """The variable's value; unset and empty both mean the default."""
    return os.environ.get(name) or None


def get_int(name: str) -> int:
    default, minimum = _INTS[name]
    v = _raw(name)
    if v is None:
        return default
    try:
        out = int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: expected an integer") from None
    return max(out, minimum)


def get_float(name: str) -> float:
    default, minimum = _FLOATS[name]
    v = _raw(name)
    if v is None:
        return default
    try:
        out = float(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: expected a number") from None
    return max(out, minimum)


def get_str(name: str) -> str | None:
    default = _STRS[name]
    v = _raw(name)
    return default if v is None else v


def get_bool(name: str) -> bool:
    """The JAX package's 0/1 convention: for a flag that defaults on,
    exactly "0" turns it off; for one that defaults off, any value but
    0/false turns it on."""
    default = _BOOLS[name]
    v = _raw(name)
    if v is None:
        return default
    if default:
        return v != "0"
    return v not in ("0", "false", "False")


def get_choice(name: str) -> str:
    default, choices = _CHOICES[name]
    v = (_raw(name) or "").strip().lower()
    if not v:
        return default
    if v not in choices:
        raise ValueError(f"{name}={v!r}: expected one of {choices}")
    return v
