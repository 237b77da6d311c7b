"""Continuous micro-batching: concurrent queries coalesced into one padded
device dispatch (the port of `tpu_ir/serving/batching.py`).

    callers -> admission -> COALESCER -> one padded dispatch -> demux
               (frontend)   (this file)  (Scorer.search_batch)

**Leader-follower combining, no owned threads.** The first caller to
arrive while no dispatch is in flight becomes the leader: it drains every
compatible queued request into one batch, dispatches it, and hands each
follower its result through a per-slot event. Arrivals during a dispatch
queue, so under concurrency batches fill with no added wait, and an idle
arrival dispatches at once (`batch.solo_flush`). `TPU_IR_BATCH_WAIT_MS`
lets a promoted leader linger toward a fuller rung (default 0).

**The rung ladder.** A batch is padded with -1 query rows (an exact 0
score) to the smallest of a few batch sizes (`TPU_IR_BATCH_LADDER`) at
one query width (`TPU_IR_BATCH_WIDTH`), and the MaxScore groups inside
it are padded to rungs too, so the dispatch shapes form a closed set:
rungs x {skip, full, hot_only} x scorings x k. Nothing is compiled per
shape on the card, so `precompile()` warms that set instead: the first
dispatch of a shape loads the kernels' libraries and lets the caching
allocator hold the shape's buffers. It records the warmed shapes on the
Scorer, and a coalesced dispatch outside them counts `dispatch.unwarmed`.

**Per-request semantics survive a shared batch**: requests coalesce only
with an equal BatchKey (k, scoring, rerank, hot_only, force_host), while
service level, queue wait and occupancy are tagged per slot, and exactly
one slot of a batch carries the breaker's vote. A query's results in any
padded batch are the bits of its solo dispatch.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import numpy as np

from .. import envvars, obs
from ..obs import get_registry


class BatchKey(NamedTuple):
    """What must match for two requests to share one dispatch: k and
    scoring/rerank select the kernels, hot_only and force_host the
    serving route. A mismatched arrival stays queued for the next leader
    (FIFO: the next leader is the oldest queued slot)."""

    k: int
    scoring: str
    rerank: int | None
    hot_only: bool
    force_host: bool


class _Slot:
    """One queued request. `state` moves under the scheduler's lock: None
    (queued) -> "lead" (promoted to dispatcher) -> taken into a batch ->
    "done" / "error"; or None -> "abandoned" (timed out while queued).
    The leader writes the result before it sets the event."""

    __slots__ = ("text", "key", "explain_k", "t_enqueue", "event", "state",
                 "result", "error")

    def __init__(self, text: str, key: BatchKey, explain_k: int):
        self.text = text
        self.key = key
        self.explain_k = explain_k
        self.t_enqueue = time.perf_counter()
        self.event = threading.Event()
        self.state = None
        self.result = None
        self.error = None


def batch_ladder() -> tuple:
    """The batch-size rungs from TPU_IR_BATCH_LADDER (sorted, deduplicated,
    all >= 1; the default 1,4,16 is explained in envvars.py); a malformed
    spec raises."""
    spec = envvars.get_str("TPU_IR_BATCH_LADDER")
    try:
        rungs = sorted({max(1, int(p)) for p in spec.split(",") if p.strip()})
    except ValueError:
        raise ValueError(
            f"TPU_IR_BATCH_LADDER={spec!r}: expected comma-separated "
            "integers like '1,4,16,64'") from None
    if not rungs:
        raise ValueError("TPU_IR_BATCH_LADDER is empty")
    return tuple(rungs)


class CoalescingScheduler:
    """The coalescer between admission and the device dispatch; one per
    ServingFrontend, thread-safe, owns no threads."""

    # leader poll granularity while lingering toward a fuller rung
    _POLL_S = 0.0005

    def __init__(self, scorer, *, deadline_s: float | None = None,
                 wait_ms: float | None = None, ladder: tuple | None = None,
                 width: int | None = None):
        self._scorer = scorer
        self._deadline_s = deadline_s
        self._wait_s = (envvars.get_float("TPU_IR_BATCH_WAIT_MS")
                        if wait_ms is None else max(0.0, wait_ms)) / 1e3
        # a caller's ladder is normalized as the variable's is: the batch
        # take, the rung pick and the linger assume ascending rungs
        self._ladder = (tuple(sorted({max(1, int(r)) for r in ladder}))
                        if ladder else batch_ladder())
        width = (envvars.get_int("TPU_IR_BATCH_WIDTH")
                 if width is None else max(1, width))
        # the power-of-two bucket analyze_queries emits for this floor,
        # the width precompile must warm
        self._width = 1 << (int(width) - 1).bit_length()
        self._lock = threading.Lock()
        self._queue: list[_Slot] = []
        self._dispatching = False   # exactly one leader token
        self._batches = 0
        self._coalesced = 0
        self._solo = 0
        self._last_occupancy = 0
        self._max_occupancy = 0

    # -- the caller surface ------------------------------------------------

    def submit(self, text: str, *, k: int, scoring: str,
               rerank: int | None, hot_only: bool, force_host: bool,
               explain_k: int = 0):
        """Serve one query through the coalescer; returns its
        SearchResult (tagged per slot) or raises what the shared dispatch
        raised. Blocks the calling thread."""
        if '"' in text:
            raise ValueError("phrase queries cannot ride a coalesced "
                             "batch; route them solo")
        slot = _Slot(text, BatchKey(k, scoring, rerank, bool(hot_only),
                                    bool(force_host)),
                     explain_k)
        with self._lock:
            self._queue.append(slot)
            lead = not self._dispatching
            if lead:
                self._dispatching = True
        if lead:
            return self._lead(slot, promoted=False)
        return self._follow(slot)

    def _follow(self, slot: _Slot):
        """Wait for the leader to deliver, or for a promotion to leader
        when the batch before completes first."""
        base = self._deadline_s if self._deadline_s else 0.0
        timeout = max(base * 4.0, 30.0) + self._wait_s
        deadline = time.monotonic() + timeout
        promoted = False
        while True:
            slot.event.wait(min(5.0, max(0.05, deadline - time.monotonic())))
            with self._lock:
                if slot.state == "lead":
                    slot.event.clear()
                    slot.state = None
                    promoted = True
                    break  # lead outside the lock
                if slot.state in ("done", "error"):
                    break
                if time.monotonic() >= deadline:
                    if slot in self._queue:
                        # still queued: abandon it with an error, so the
                        # frontend's accounting still holds
                        self._queue.remove(slot)
                        slot.state = "abandoned"
                        raise RuntimeError(
                            "coalesced request timed out waiting for a "
                            f"dispatch slot after {timeout:.1f}s")
                    # taken into an executing batch: the leader will
                    # deliver, as a solo caller's own dispatch would
                    deadline = time.monotonic() + timeout
        if promoted:
            return self._lead(slot, promoted=True)
        if slot.error is not None:
            raise slot.error
        return slot.result

    # -- the leader --------------------------------------------------------

    def _lead(self, slot: _Slot, *, promoted: bool):
        """Run one batch as its dispatcher, then hand the token to the
        next queued slot or release it; one batch collects and dispatches
        at a time."""
        try:
            if promoted:
                self._linger(slot.key)
            with self._lock:
                batch = self._take_batch(slot)
            self._execute(batch)
        finally:
            with self._lock:
                nxt = self._queue[0] if self._queue else None
                if nxt is None:
                    self._dispatching = False
                else:
                    nxt.state = "lead"
                    nxt.event.set()
        if slot.error is not None:
            raise slot.error
        return slot.result

    def _linger(self, key: BatchKey) -> None:
        """The bounded coalescing wait of a promoted leader
        (TPU_IR_BATCH_WAIT_MS); an idle solo arrival never lingers."""
        if self._wait_s <= 0.0:
            return
        top = self._ladder[-1]
        deadline = time.perf_counter() + self._wait_s
        while time.perf_counter() < deadline:
            with self._lock:
                if sum(1 for s in self._queue if s.key == key) >= top:
                    return
            time.sleep(self._POLL_S)

    def _take_batch(self, lead_slot: _Slot) -> list[_Slot]:
        """Drain (under the lock) every queued slot with the leader's
        key, FIFO, up to the top rung."""
        top = self._ladder[-1]
        batch, rest = [], []
        for s in self._queue:
            if s.key == lead_slot.key and len(batch) < top:
                batch.append(s)
            else:
                rest.append(s)
        self._queue[:] = rest
        return batch

    def _rung(self, n: int) -> int:
        """Smallest ladder rung >= n (n never passes the top rung)."""
        for r in self._ladder:
            if r >= n:
                return r
        return self._ladder[-1]

    def _execute(self, slots: list[_Slot]) -> None:
        """One padded dispatch for the whole batch, demuxed per slot.
        Never raises: an error reaches every slot (the leader's own
        re-raises in _lead)."""
        t0 = time.perf_counter()
        b = len(slots)
        key = slots[0].key
        reg = get_registry()
        reg.incr("batch.coalesced" if b > 1 else "batch.solo_flush")
        if obs.enabled():
            # occupancy is a count on the histogram's bucket scale
            reg.observe("batch.occupancy", float(b))
            for s in slots:
                reg.observe("batch.wait", t0 - s.t_enqueue)
        try:
            results = self._scorer.search_batch(
                [s.text for s in slots], k=key.k, scoring=key.scoring,
                rerank=key.rerank, deadline_s=self._deadline_s,
                force_host=key.force_host, hot_only=key.hot_only,
                explain_ks=[s.explain_k for s in slots],
                pad_to=self._rung(b), width_floor=self._width,
                rung_ladder=self._ladder)
        except BaseException as e:  # delivered, not swallowed: every
            for s in slots:         # slot's caller re-raises it
                s.error = e
                s.state = "error"
                s.event.set()
            return
        with self._lock:
            self._batches += 1
            if b > 1:
                self._coalesced += 1
            else:
                self._solo += 1
            self._last_occupancy = b
            self._max_occupancy = max(self._max_occupancy, b)
        for i, (s, res) in enumerate(zip(slots, results)):
            # one vote a dispatch: the breaker counts consecutive failed
            # dispatches, and N slots echoing one failure would trip it
            res.breaker_vote = i == 0
            s.result = res
            s.state = "done"
            s.event.set()

    # -- warm-up and introspection -----------------------------------------

    def precompile(self, scorings=("tfidf", "bm25"), *,
                   ks: tuple = (10,)) -> int:
        """Warm every dispatch shape steady serving can send (the JAX
        package compiles the same closed set): rows at each rung capped
        at the scorer's block size (a larger rung runs in blocks of that
        size) x the variants of the layout ({skip, full, hot_only} on the
        tiered layout, {full} on the dense one) x `scorings` x `ks`, at
        the pinned width, each through the scorer's block dispatch on an
        all -1 batch and read back. Records each shape in
        `scorer.warmed_shapes`. The rerank's shapes are not warmed (its
        candidate count is the caller's). Returns the warm dispatches."""
        n = 0
        scorer = self._scorer
        variants = {"full": {}}
        if scorer.layout == "sparse":
            variants = {"skip": {"skip_hot": True}, "full": {},
                        "hot_only": {"hot_only": True}}
        block = max(1, scorer._block_size())
        for rows in sorted({min(rung, block) for rung in self._ladder}):
            q = np.full((rows, self._width), -1, np.int32)
            for scoring in scorings:
                for k in ks:
                    for variant, kw in variants.items():
                        s, d = scorer._topk_device(q, k, scoring, **kw)
                        s.cpu(), d.cpu()
                        scorer.warmed_shapes.add(
                            (rows, self._width, variant, scoring, k))
                        n += 1
        return n

    def snapshot(self) -> dict:
        """Control-plane state for the frontend's stats."""
        with self._lock:
            return {
                "wait_ms": round(self._wait_s * 1e3, 3),
                "ladder": list(self._ladder),
                "width": self._width,
                "queued": len(self._queue),
                "dispatching": self._dispatching,
                "batches": self._batches,
                "coalesced": self._coalesced,
                "solo_flush": self._solo,
                "last_occupancy": self._last_occupancy,
                "max_occupancy": self._max_occupancy,
            }
