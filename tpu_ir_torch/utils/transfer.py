"""Host-device transfer helpers of the streaming build (the part of
`tpu_ir/utils/transfer.py` it needs).

- `pipeline_depth` / `prefetch_iter`: run a host producer (the tokenizer,
  a bucket's spill reads) on a thread a few items ahead of its consumer.
- `narrow_uint` / `shrink_pairs`: the valid prefix of a device result in
  the narrowest dtype that holds it, copied to the host. The dtype choice
  is the JAX package's, because the spills' bytes depend on it.
"""

from __future__ import annotations

import logging
import queue
import threading

import numpy as np
import torch

logger = logging.getLogger(__name__)


def pipeline_depth() -> int:
    """How many items a producer may run ahead of its consumer
    (TPU_IR_PIPE_DEPTH, default 2; 1 is strict lockstep)."""
    from .. import envvars

    return envvars.get_int("TPU_IR_PIPE_DEPTH")


_PREFETCH_STOP = object()


def prefetch_iter(it, depth: int | None = None, name: str = "prefetch"):
    """Run the iterator `it` on a background thread, `depth` items ahead.

    While the consumer works on item N (a device reduce and its copy
    back), the producer prepares items N+1..N+depth: file reads, zlib and
    numpy release the interpreter lock, so host IO overlaps the device.
    An exception in the producer (BaseException included: an injected
    crash propagates like a real death) is raised in the consumer where
    its item would have been yielded. Closing the generator stops the
    producer and waits for its thread to exit, so a caller may free what
    the producer reads (the tokenizer's native handle) right after.
    `build.radix.pipeline_stalls` counts the waits for an item in the
    middle of the stream."""
    if depth is None:
        depth = pipeline_depth()
    if depth <= 1:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def produce():
        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            for item in it:
                if not put((None, item)):
                    return
        except BaseException as e:  # re-raised on the consumer side
            put((e, None))
        else:
            put((None, _PREFETCH_STOP))

    t = threading.Thread(target=produce, daemon=True,
                         name=f"tpu-ir-torch-{name}")
    t.start()
    from ..obs import get_registry

    started = False
    try:
        while True:
            if started and q.empty() and t.is_alive():
                get_registry().incr("build.radix.pipeline_stalls")
            exc, item = q.get()
            if exc is not None:
                raise exc
            if item is _PREFETCH_STOP:
                break
            started = True
            yield item
        t.join()
    finally:
        stop.set()
        waited = 0.0
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.5)
            waited += 0.5
            if waited % 30.0 == 0.0:
                logger.warning("prefetch producer %r still draining after "
                               "%.0fs (slow source read?)", name, waited)


def narrow_uint(max_value: int):
    """Smallest of uint16/int32 that exactly holds values in [0, max_value]."""
    return np.uint16 if max_value < (1 << 16) else np.int32


def fetch_narrow(a: torch.Tensor, valid: int, dtype) -> np.ndarray:
    """The first `valid` entries of `a` (values in [0, 2**31)) as a host
    numpy array of `dtype` (np.uint16 or np.int32), narrowed on the device
    before the copy. uint16 crosses as int16 bits: the truncating cast
    keeps the low 16 bits, which are the uint16 value."""
    head = a[:valid]
    if np.dtype(dtype) == np.uint16:
        return head.to(torch.int16).cpu().numpy().view(np.uint16)
    return head.to(torch.int32).cpu().numpy()


def shrink_pairs(pair_doc: torch.Tensor, pair_tf: torch.Tensor,
                 num_pairs: int, *, num_docs: int, tf_max: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The valid prefix of the two posting pair columns on the host, the
    docnos and tfs each in the narrowest dtype that holds them."""
    return (fetch_narrow(pair_doc, num_pairs, narrow_uint(num_docs)),
            fetch_narrow(pair_tf, num_pairs, narrow_uint(tf_max)))
