"""Host-device transfers (the part of `tpu_ir/utils/transfer.py` the port
needs).

- `stream_to_device`: every load-time upload of an index array. On the
  card the host array is copied in chunks through two pinned staging
  buffers and sent by asynchronous copies on a side stream, so the
  kernels that serve queries on the default stream never queue behind a
  load's copies, and the next chunk's page-in and CRC fold overlap the
  copy in flight.
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
import zlib

import numpy as np
import torch

logger = logging.getLogger(__name__)

# the process's staging pool: per card, two pinned buffers of one chunk,
# the event of each buffer's last copy, and the side stream the copies
# run on. One upload at a time holds the pool.
_staging_lock = threading.Lock()
_staging: dict = {}


def stream_to_device(a, *, device, chunk_bytes: int | None = None,
                     expected_crc: str | None = None,
                     label: str | None = None) -> torch.Tensor:
    """The host array `a` (often a memory-mapped arena or serving-cache
    section) as a tensor on `device`, bit for bit, copied in chunks of
    `chunk_bytes` (TPU_IR_H2D_CHUNK_BYTES, 64 MiB by default). A uint16
    array comes back as int16 bits (torch has few uint16 operations;
    `search/layout.py::upload_index` widens it on the device).

    On the card each chunk is copied into one of two pinned staging
    buffers and sent by a non-blocking copy on a side stream; a buffer is
    refilled only after its previous copy ended, the side stream first
    waits for the caller's stream (the destination may be memory that
    work queued there has just freed), and the caller's stream waits for
    the last copy before this returns, so the tensor is ready for any
    work the caller queues next. On the CPU the same chunk loop fills a
    preallocated tensor.

    `expected_crc` ('crc32:XXXXXXXX') folds a CRC32 over the bytes as
    they stream and raises faults.IntegrityError naming `label` on a
    mismatch. Each call is one `load.h2d` span, adds its bytes to the
    `load.h2d_bytes` counter and samples the memory gauges. A pinned
    buffer that cannot be allocated raises: nothing falls back to a
    pageable copy."""
    from .. import envvars
    from ..obs import get_registry
    from ..obs import trace as obs_trace

    dev = torch.device(device)
    if chunk_bytes is None:
        chunk_bytes = envvars.get_int("TPU_IR_H2D_CHUNK_BYTES")
    chunk_bytes = max(int(chunk_bytes), 1)
    host = np.asarray(a)
    if host.dtype == np.uint16:
        host = host.view(np.int16)
    if not host.flags.c_contiguous:
        host = np.ascontiguousarray(host)
    with obs_trace("load.h2d", bytes=int(host.nbytes),
                   label=label or "<array>"):
        dtype = torch.from_numpy(np.empty(0, host.dtype)).dtype
        out = torch.empty(host.shape, dtype=dtype, device=dev)
        src = host.reshape(-1).view(np.uint8)
        dst = out.reshape(-1).view(torch.uint8)
        if dev.type == "cuda":
            crc = _chunks_cuda(src, dst, chunk_bytes, expected_crc is not None)
        else:
            crc = _chunks_cpu(src, dst.numpy(), chunk_bytes,
                              expected_crc is not None)
        if expected_crc is not None:
            got = f"crc32:{crc:08x}"
            if got != expected_crc:
                from ..faults import IntegrityError

                raise IntegrityError(
                    label or "<array>",
                    f"checksum mismatch during device upload (recorded "
                    f"{expected_crc}, found {got}); the artifact is corrupt")
    get_registry().incr("load.h2d_bytes", int(host.nbytes))
    # a memory sample after each upload: a load's growth on the card
    # shows in the gauges (obs/profiling.py, rate-limited)
    from ..obs import profiling

    profiling.sample_memory()
    return out


def _chunks_cpu(src: np.ndarray, dst: np.ndarray, step: int,
                fold: bool) -> int:
    crc = 0
    for lo in range(0, len(src), step):
        chunk = src[lo: lo + step]
        if fold:
            crc = zlib.crc32(chunk, crc)
        dst[lo: lo + len(chunk)] = chunk
    return crc


def _staging_for(dev: torch.device, step: int):
    """(buffers, events, side stream) of `dev`, under _staging_lock;
    buffers of another size are dropped once their copies ended."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    pool = _staging.get(key)
    if pool is None or pool[0][0].numel() != step:
        if pool is not None:
            for event in pool[1]:
                event.synchronize()
        bufs = tuple(torch.empty(step, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2))
        events = (torch.cuda.Event(), torch.cuda.Event())
        side = (pool[2] if pool is not None
                else torch.cuda.Stream(device=torch.device("cuda", key)))
        pool = _staging[key] = (bufs, events, side)
    return pool


def _chunks_cuda(src: np.ndarray, dst: torch.Tensor, step: int,
                 fold: bool) -> int:
    crc = 0
    with _staging_lock:
        bufs, events, side = _staging_for(dst.device, step)
        caller = torch.cuda.current_stream(dst.device)
        side.wait_stream(caller)
        try:
            for i, lo in enumerate(range(0, len(src), step)):
                chunk = src[lo: lo + step]
                n = len(chunk)
                buf, event = bufs[i % 2], events[i % 2]
                event.synchronize()            # its last copy has ended
                staged = buf.numpy()[:n]
                staged[:] = chunk              # the page-in happens here
                with torch.cuda.stream(side):
                    dst[lo: lo + n].copy_(buf[:n], non_blocking=True)
                event.record(side)
                if fold:                       # while the copy runs
                    crc = zlib.crc32(staged, crc)
        finally:
            done = torch.cuda.Event()
            done.record(side)
            caller.wait_event(done)
    return crc


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
