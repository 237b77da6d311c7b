"""Admission control: a bounded request queue in front of the scorer (a
copy of `tpu_ir/serving/admission.py`; pure host logic).

The load-shedding half of "The Tail at Scale": a server melting down does
the most damage by QUEUING — every queued request still burns its full
deadline after minutes of waiting, so by the time it runs, its caller has
long since retried (adding more load). The admission controller bounds
both dimensions up front:

- `max_concurrency` requests execute at once (a semaphore);
- at most `max_queue` more may WAIT for a slot;
- anything past that is shed IMMEDIATELY with a structured `Overloaded`
  rejection — the caller learns in microseconds, not after a timeout;
- a waiter that cannot get a slot within `queue_timeout_s` is shed too
  (its remaining deadline budget would be garbage anyway).

Shedding is the cheapest thing a server can do per request, which is why
it must happen before any analysis/dispatch work, at the one place that
can see the whole queue.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class Overloaded(RuntimeError):
    """Structured admission rejection: the request was shed WITHOUT being
    executed. Carries why (`reason`: 'queue_full' | 'queue_timeout' |
    'shed_level'), the queue depth observed at rejection, and the service
    level the ladder was at — everything a client needs for retry policy
    (back off; these are never partial results)."""

    def __init__(self, reason: str, *, queue_depth: int = 0,
                 level: str = "shed"):
        self.reason = reason
        self.queue_depth = queue_depth
        self.level = level
        super().__init__(
            f"overloaded ({reason}): request shed at service level "
            f"{level!r} with {queue_depth} request(s) queued")


class AdmissionController:
    """Bounded concurrency + bounded wait queue; everything else sheds."""

    def __init__(self, max_concurrency: int = 4, max_queue: int = 16):
        if max_concurrency < 1:
            raise ValueError("max_concurrency must be >= 1")
        if max_queue < 0:
            raise ValueError("max_queue must be >= 0")
        self.max_concurrency = max_concurrency
        self.max_queue = max_queue
        self._slots = threading.Semaphore(max_concurrency)
        self._lock = threading.Lock()
        self._waiting = 0
        self._executing = 0

    def queue_depth(self) -> int:
        """Requests currently waiting for an execution slot."""
        with self._lock:
            return self._waiting

    def in_flight(self) -> int:
        """Requests currently executing (admitted, slot held)."""
        with self._lock:
            return self._executing

    def pressure(self) -> float:
        """Queue occupancy in [0, 1] — the degradation ladder's input
        signal. 0 = nothing waiting, 1 = the wait queue is full (the
        next arrival sheds)."""
        with self._lock:
            return (self._waiting / self.max_queue if self.max_queue
                    else float(self._waiting > 0))

    @contextmanager
    def admit(self, queue_timeout_s: float | None = None):
        """Admit one request: yields holding an execution slot, raises
        Overloaded when the wait queue is full or the slot did not free
        within `queue_timeout_s` (None = wait indefinitely).

        A free slot is taken WITHOUT touching the wait queue, so only
        requests that actually have to wait count toward queue depth /
        pressure — and `max_queue=0` means "execute, never queue", not
        "shed everything"."""
        got = self._slots.acquire(blocking=False)
        if not got:
            with self._lock:
                if self._waiting >= self.max_queue:
                    raise Overloaded("queue_full",
                                     queue_depth=self._waiting)
                self._waiting += 1
            try:
                got = (self._slots.acquire(timeout=queue_timeout_s)
                       if queue_timeout_s is not None
                       else self._slots.acquire())
            finally:
                with self._lock:
                    self._waiting -= 1
                    depth = self._waiting
            if not got:
                raise Overloaded("queue_timeout", queue_depth=depth)
        with self._lock:
            self._executing += 1
        try:
            yield
        finally:
            with self._lock:
                self._executing -= 1
            self._slots.release()
