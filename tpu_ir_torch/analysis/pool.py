"""Process-pool analysis for the pure-Python tokenizer (the port's copy of
`tpu_ir/analysis/pool.py`).

The parent reads the records and decides the chunk boundaries (they
depend only on the raw documents); the workers analyze whole chunks and
return each document's term list; the parent collects the results in
submission order and interns the terms into the one vocabulary. The
temp ids, and every spill made from them, are therefore the serial
path's bytes at any TPU_IR_TOKENIZE_PROCS. Up to `procs` + the pipeline
depth chunks are in flight, so the parent's reads and spills overlap the
workers' analysis.

Workers start by `forkserver` where the platform has it, else `spawn`,
never `fork`: the parent may hold a CUDA context and torch's threads,
and a forked child of a threaded process can deadlock on a lock held
mid-fork (and cannot use CUDA at all). Each worker installs the parent's
TPU_IR_FAULTS plan; the `tokenize.pool` site fires in the worker, keyed
`chunk=<index>`, as an OSError that travels back to the parent.
"""

from __future__ import annotations

import collections
import multiprocessing

from .. import envvars, faults

_WORKER_ANALYZER = None


def tokenize_procs() -> int:
    """TPU_IR_TOKENIZE_PROCS (1 = serial, the default)."""
    return envvars.get_int("TPU_IR_TOKENIZE_PROCS")


def _pool_init(faults_spec: str | None) -> None:
    """Worker initializer: one Analyzer per process and the parent's
    fault plan."""
    global _WORKER_ANALYZER
    from .analyzer import Analyzer

    _WORKER_ANALYZER = Analyzer()
    if faults_spec:
        faults.install(faults.parse_plan(faults_spec))


def _analyze_chunk(payload) -> list[list[str]]:
    """Each document's term list for one chunk, its k-token windows when
    k > 1 (runs in a worker)."""
    chunk_idx, k, contents = payload
    if faults.should_fire("tokenize.pool", f"chunk={chunk_idx}") is not None:
        raise OSError(f"injected tokenizer pool failure (chunk={chunk_idx})")
    toks = [_WORKER_ANALYZER.analyze(c) for c in contents]
    if k > 1:
        from ..collection import kgram_terms

        toks = [kgram_terms(t, k) for t in toks]
    return toks


class AnalysisPool:
    """A bounded, order-keeping chunk pipeline over a process pool:
    submit() queues a chunk, collect() returns the oldest one's result."""

    def __init__(self, procs: int, *, k: int = 1, ahead: int | None = None):
        self._k = k
        self._ahead = ahead if ahead is not None else procs + 2
        methods = multiprocessing.get_all_start_methods()
        ctx = multiprocessing.get_context(
            "forkserver" if "forkserver" in methods else "spawn")
        self._pool = ctx.Pool(
            processes=procs, initializer=_pool_init,
            initargs=(envvars.get_str("TPU_IR_FAULTS"),))
        self._pending: collections.deque = collections.deque()
        self._next_idx = 0

    def submit(self, contents: list[str]) -> None:
        r = self._pool.apply_async(
            _analyze_chunk, ((self._next_idx, self._k, list(contents)),))
        self._next_idx += 1
        self._pending.append(r)
        from ..obs import get_registry

        get_registry().incr("build.tokenize.pool_chunks")

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    @property
    def ahead(self) -> int:
        return self._ahead

    def collect(self) -> list[list[str]]:
        """The oldest submitted chunk's result (blocks for it)."""
        return self._pending.popleft().get()

    def close(self) -> None:
        self._pool.terminate()
        self._pool.join()
