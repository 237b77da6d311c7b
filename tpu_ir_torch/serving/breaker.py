"""Circuit breaker around the device dispatch path (a copy of
`tpu_ir/serving/breaker.py`; pure host logic).

The per-batch deadline (faults.run_with_deadline) bounds ONE request's
latency on a hung device — but with the device permanently down, every
request still pays the full deadline before falling back, and every
deadline burns an abandoned dispatch thread. The breaker makes the
failure diagnosis STICKY:

  closed     normal serving; consecutive device failures are counted.
  open       after `failure_threshold` consecutive failures: requests go
             straight to the host-CPU fallback (force_host) — no device
             dispatch, no deadline wait, no abandoned thread. Steady-state
             latency is the host scorer's, not deadline-per-request.
  half-open  after `cooldown_s` in open, ONE probe request is allowed
             through to the device. Success closes the breaker (full
             service resumes); failure re-opens it for another cooldown.

Its counts (opened, probes) show in the frontend's stats, so an operator
can see flapping. Thread-safe; the probe slot is exclusive so a
recovering device sees one probe at a time, not a thundering herd.
"""

from __future__ import annotations

import threading
import time

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 1.0,
                 clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._opened_count = 0
        self._probe_count = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow_device(self) -> tuple[bool, bool]:
        """(allowed, is_probe): may THIS request try the device path,
        and if so, was it admitted as the exclusive half-open probe?
        allowed=False means serve the host fallback directly. The facts
        are returned rather than re-read from `state` afterwards — a
        re-read races other threads' transitions. A request granted the
        probe slot MUST report back via record_success/record_failure,
        or abort() if it died without a device verdict."""
        with self._lock:
            if self._state == CLOSED:
                return True, False
            if self._probe_inflight:
                return False, False
            if (self._state == OPEN
                    and self._clock() - self._opened_at < self.cooldown_s):
                return False, False
            # cooldown elapsed (or already half-open with no probe out):
            # admit exactly one probe
            self._state = HALF_OPEN
            self._probe_inflight = True
            self._probe_count += 1
            return True, True

    def record_success(self, *, is_probe: bool = False) -> None:
        """Report a device success. `is_probe` is the token allow_device
        handed THIS request — verdicts are attributed by token, never by
        re-reading shared state: a stale success from a request admitted
        before the breaker opened must not close it (the device is still
        presumed down until the PROBE says otherwise), and must not
        consume another request's probe slot."""
        with self._lock:
            if is_probe:
                self._probe_inflight = False
                self._consecutive = 0
                self._state = CLOSED
            elif self._state == CLOSED:
                self._consecutive = 0

    def record_failure(self, *, is_probe: bool = False) -> bool:
        """Report a device failure; returns True when THIS call
        transitioned the breaker to open (so the caller can count the
        transition without a racy snapshot sandwich). A probe failure
        always re-opens; a non-probe failure only opens from closed at
        the threshold — stale failures from pre-open requests neither
        consume the probe slot nor push the open timestamp (which would
        starve the next probe)."""
        with self._lock:
            if is_probe:
                self._probe_inflight = False
                opened = self._state != OPEN
                if opened:
                    self._opened_count += 1
                self._state = OPEN
                self._opened_at = self._clock()
                return opened
            self._consecutive += 1
            if (self._state == CLOSED
                    and self._consecutive >= self.failure_threshold):
                self._opened_count += 1
                self._state = OPEN
                self._opened_at = self._clock()
                return True
            return False

    def abort(self, *, is_probe: bool = False) -> None:
        """The admitted request died without a device verdict (an
        exception unrelated to device health — bad query, program bug).
        Leaves failure counts alone; a dying PROBE re-opens the breaker
        and releases its exclusive slot so a later probe can run —
        otherwise the slot would leak and wedge all traffic onto the
        fallback forever."""
        with self._lock:
            if is_probe and self._probe_inflight:
                self._probe_inflight = False
                self._state = OPEN
                self._opened_at = self._clock()

    def reset(self) -> None:
        """Back to a pristine CLOSED: the hook a grow that reuses a
        retired slot calls, since the slot's new worker is another
        process on another port and must not inherit its predecessor's
        open state, failure run or probe slot. In place, so a request
        that resolved this breaker before the change still records its
        verdict where later requests read it; the opened and probe counts
        stay (they tell the slot's history)."""
        with self._lock:
            self._state = CLOSED
            self._consecutive = 0
            self._probe_inflight = False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "opened_count": self._opened_count,
                "probe_count": self._probe_count,
            }
