"""The serving and build halves of `tpu_ir/faults.py`: deterministic fault
injection, the degraded-serving triggers, the per-batch deadline, the
build's integrity errors and injected crashes, and supervised retry.

- **FaultPlan**: a process-wide, seeded, deterministic plan mapping named
  injection sites (the score dispatch's `score.hang` and
  `score.device_loss`) to firing rules. Set programmatically or from the
  `TPU_IR_FAULTS` variable. With no plan installed every site is one
  `is None` test.
- **DeviceLoss** and **ScoreDeadlineExceeded**: the two errors that send
  a dispatch down the tagged host fallback; `is_device_loss` tells a lost
  device (degrade) from a wrong program (raise).
- **run_with_deadline**: runs a device dispatch on a thread and abandons
  it past its deadline, so the caller falls back instead of hanging.
- **IntegrityError**, **InjectedCrash** and **maybe_crash**: a corrupt
  artifact, and a simulated process death at the streaming build's
  `crash.pass1/2/3` sites (what its resume is tested against).
- **run_with_retry** with **SPILL_RETRY**: the build's atomic spill and
  part writes retry an OSError a few times, then raise BuildError.

Spec grammar (the JAX package's): comma-separated `site[@match]:rule`
entries, plus an optional `seed=N`. Rules:

    once@K      fire exactly on the K-th hit of the site (1-based)
    first@N     fire on the first N hits
    p=F         fire each hit with probability F (seeded, deterministic)
    always      fire on every hit
    sleep=S     (modifier) sleep S seconds instead of raising, for hang sites

Example: `TPU_IR_FAULTS="score.hang:p=0.12:sleep=0.6,score.device_loss:p=0.08,seed=1"`.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)


class DeviceLoss(RuntimeError):
    """Simulated (or detected) loss of the scoring device mid-dispatch."""


class IntegrityError(AssertionError):
    """An artifact failed its integrity check (a checksum mismatch, a
    truncated or unreadable file), naming the offending path. An
    AssertionError, as in the JAX package: it is the byte-level sibling of
    verify_index's structural asserts."""

    def __init__(self, path: str, detail: str):
        self.path = path
        self.detail = detail
        super().__init__(f"artifact integrity failure: {path}: {detail}")
        from .utils.report import recovery_counters

        recovery_counters().incr("integrity_failures")


class BuildError(RuntimeError):
    """A build stage failed for good after its supervised retries."""

    def __init__(self, stage: str, attempts: int, cause: BaseException | str):
        self.stage = stage
        self.attempts = attempts
        self.cause = cause
        super().__init__(f"build stage {stage!r} failed after {attempts} "
                         f"attempt(s): {cause}")


class InjectedCrash(BaseException):
    """A simulated process death in the middle of a pass. Not an
    Exception, so no `except Exception` swallows it: resume is tested
    against what a real SIGKILL leaves."""


class ScoreDeadlineExceeded(RuntimeError):
    """A score dispatch exceeded its per-batch deadline."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        super().__init__(f"score dispatch exceeded {deadline_s}s deadline")


# the JAX package's tags for a lost or halted device
_JAX_TAGS = ("device_lost", "device lost", "data_loss", "device halted",
             "device unavailable")
# CUDA's errors (enum cudaError, CUDA 12.8 headers) for a device that is
# gone or cannot be used: name -> (code, cudaGetErrorString's text, which
# torch's runtime puts in its "CUDA error: ..." messages). Only the
# runtime's own wording counts: the port's kernel wrappers report a failed
# launch by its code alone ("kernel launch failed: CUDA error 46"), and a
# failed launch, an illegal address or a failed build is a program fault,
# so it raises, never degrades
_CUDA_LOST = {
    "cudaErrorDevicesUnavailable":
        (46, "CUDA-capable device(s) is/are busy or unavailable"),
    "cudaErrorNoDevice": (100, "no CUDA-capable device is detected"),
    "cudaErrorECCUncorrectable": (214, "uncorrectable ECC error encountered"),
    "cudaErrorNvlinkUncorrectable":
        (220, "uncorrectable NVLink error detected during the execution"),
    "cudaErrorSystemNotReady": (802, "system not yet initialized"),
}


def is_device_loss(exc: BaseException) -> bool:
    """Whether an exception from a device dispatch means the device is
    gone (degrade) rather than the program is wrong (raise). Only the
    injected marker, the JAX package's tags and the CUDA runtime's own
    errors for a lost or unavailable device (by name or by its text)
    qualify."""
    if isinstance(exc, DeviceLoss):
        return True
    msg = str(exc).lower()
    return any(tag in msg for tag in _JAX_TAGS) or any(
        name.lower() in msg or text.lower() in msg
        for name, (_, text) in _CUDA_LOST.items())


@dataclass
class FaultSpec:
    """Firing rule for one site (see the module docstring)."""

    mode: str                 # "once" | "first" | "prob" | "always"
    arg: float = 0.0          # K for once, N for first, F for prob
    match: str | None = None  # substring the site key must contain
    sleep_s: float = 0.0      # hang duration for sleep-modified sites
    hits: int = field(default=0, compare=False)

    def should_fire(self, key: str | None, rng: random.Random) -> bool:
        if self.match is not None and (key is None or self.match not in key):
            return False
        self.hits += 1
        if self.mode == "once":
            return self.hits == int(self.arg)
        if self.mode == "first":
            return self.hits <= int(self.arg)
        if self.mode == "prob":
            return rng.random() < self.arg
        return True  # always


class FaultPlan:
    """Process-wide deterministic fault plan: site name -> [FaultSpec]."""

    def __init__(self, seed: int = 0):
        self.specs: dict[str, list[FaultSpec]] = {}
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def add(self, site: str, rule: str = "always", *, match: str | None = None,
            sleep_s: float = 0.0) -> "FaultPlan":
        """Programmatic plan building: plan.add('score.hang', 'first@2')."""
        spec = _parse_rule(rule)
        spec.match = match
        spec.sleep_s = sleep_s
        self.specs.setdefault(site, []).append(spec)
        return self

    def should_fire(self, site: str, key: str | None = None) -> FaultSpec | None:
        """The spec that fired for this hit of `site`, or None. Hit counts
        and the seeded generator advance only for sites with specs."""
        specs = self.specs.get(site)
        if not specs:
            return None
        with self._lock:
            for spec in specs:
                if spec.should_fire(key, self._rng):
                    logger.warning("fault injected at site %r (key=%r)",
                                   site, key)
                    from .obs.registry import get_registry

                    get_registry().incr(f"fault.{site}")
                    return spec
        return None


def _parse_rule(rule: str) -> FaultSpec:
    rule = rule.strip()
    if rule == "always":
        return FaultSpec("always")
    if rule.startswith("once@"):
        return FaultSpec("once", float(rule[5:]))
    if rule.startswith("first@"):
        return FaultSpec("first", float(rule[6:]))
    if rule.startswith("p="):
        return FaultSpec("prob", float(rule[2:]))
    raise ValueError(f"unknown fault rule {rule!r} "
                     "(expected once@K / first@N / p=F / always)")


def parse_plan(text: str) -> FaultPlan:
    """Parse a TPU_IR_FAULTS spec string into a FaultPlan."""
    seed = 0
    entries = []
    for part in filter(None, (p.strip() for p in text.split(","))):
        if part.startswith("seed="):
            seed = int(part[5:])
        else:
            entries.append(part)
    plan = FaultPlan(seed=seed)
    for part in entries:
        head, _, tail = part.partition(":")
        rule = tail or "always"
        sleep_s = 0.0
        if rule.startswith("sleep="):       # bare modifier: rule = always
            sleep_s, rule = float(rule[6:]), "always"
        elif ":sleep=" in rule:             # rule:sleep=S
            rule, _, s = rule.partition(":sleep=")
            sleep_s = float(s)
        site, _, match = head.partition("@")
        plan.add(site, rule, match=match or None, sleep_s=sleep_s)
    return plan


# the installed plan; None disables every site (the production state)
_PLAN: FaultPlan | None = None
_ENV_CHECKED = False


def install(plan: FaultPlan | None) -> None:
    """Install (or with None, clear) the process-wide fault plan; an
    explicit install overrides TPU_IR_FAULTS."""
    global _PLAN, _ENV_CHECKED
    _PLAN = plan
    _ENV_CHECKED = True


def clear() -> None:
    """Drop the plan and read TPU_IR_FAULTS again on next use."""
    global _PLAN, _ENV_CHECKED
    _PLAN = None
    _ENV_CHECKED = False


def active() -> FaultPlan | None:
    """The installed plan, picking up TPU_IR_FAULTS on first use."""
    global _PLAN, _ENV_CHECKED
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        from . import envvars

        spec = envvars.get_str("TPU_IR_FAULTS")
        if spec:
            _PLAN = parse_plan(spec)
    return _PLAN


def should_fire(site: str, key: str | None = None) -> FaultSpec | None:
    """Hot-path probe: one attribute read and a None test when no plan
    is installed."""
    plan = _PLAN if _ENV_CHECKED else active()
    if plan is None:
        return None
    return plan.should_fire(site, key)


def maybe_crash(site: str, key: str | None = None) -> None:
    """Injection point for a simulated death in the middle of a pass."""
    if should_fire(site, key) is not None:
        raise InjectedCrash(f"injected crash at {site}")


def maybe_hang(site: str, key: str | None = None) -> None:
    """Injection point for slow or hung dispatches: sleeps the spec's
    `sleep_s` (default 30 s, past any sane deadline)."""
    spec = should_fire(site, key)
    if spec is not None:
        time.sleep(spec.sleep_s or 30.0)


@dataclass(frozen=True)
class RetryPolicy:
    """Attempt-capped exponential backoff with seeded jitter."""

    max_attempts: int = 4
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    jitter: float = 0.25      # +/- fraction of the delay
    seed: int = 0

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        d = self.base_delay_s * (self.multiplier ** (attempt - 1))
        return max(0.0, d * (1.0 + self.jitter * (2 * rng.random() - 1)))


# transient host-filesystem writes (spill and part files)
SPILL_RETRY = RetryPolicy(max_attempts=4, base_delay_s=0.02)


def run_with_retry(fn, *, stage: str, policy: RetryPolicy = SPILL_RETRY):
    """Run `fn()` under the policy and return its value. Only an OSError
    is retried (an InjectedCrash always propagates); each retry counts
    `recovery.retries`, and exhaustion writes a `build_error` flight
    record (rate-limited) and raises BuildError naming the stage and the
    last cause."""
    from .obs.recorder import flight_dump
    from .utils.report import recovery_counters

    rng = random.Random(policy.seed)
    last: BaseException | None = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn()
        except OSError as e:
            last = e
            if attempt == policy.max_attempts:
                break
            recovery_counters().incr("retries")
            logger.warning("stage %r attempt %d/%d failed (%s); retrying",
                           stage, attempt, policy.max_attempts, e)
            time.sleep(policy.delay_s(attempt, rng))
    recovery_counters().incr("retry_exhausted")
    flight_dump("build_error", extra={
        "stage": stage, "attempts": policy.max_attempts,
        "cause": repr(last)})
    raise BuildError(stage, policy.max_attempts, last) from last


# abandoned dispatch threads still inside a slow or hung dispatch; capped
# so a dead device under a steady query stream cannot grow threads without
# limit
_ABANDONED_CAP = 4
_abandoned: list[threading.Thread] = []
_abandoned_lock = threading.Lock()


def run_with_deadline(fn, deadline_s: float | None):
    """Run `fn()` with a wall-clock deadline; None runs it inline. On
    expiry the worker thread is abandoned (a daemon) and
    ScoreDeadlineExceeded raises, so the caller falls back.

    With `_ABANDONED_CAP` abandoned threads alive the device is presumed
    hung: further calls fail fast (no new thread, no wait) until one of
    them returns. On CUDA an abandoned thread may still be queueing work
    on the device's stream, and the next dispatch waits behind it; the
    cap bounds that. The abandoned call keeps its own tensors alive until
    it returns; its result is discarded, and any lazy state it fills (a
    Scorer's caches) is published by one assignment, so the cost is
    wasted work, not corruption."""
    if deadline_s is None:
        return fn()
    with _abandoned_lock:
        _abandoned[:] = [t for t in _abandoned if t.is_alive()]
        if len(_abandoned) >= _ABANDONED_CAP:
            raise ScoreDeadlineExceeded(deadline_s)
    box: dict = {}
    # the worker's spans join the caller's open span, not new roots
    from .obs.trace import attach, current_span

    parent_span = current_span()

    def run():
        try:
            with attach(parent_span):
                box["r"] = fn()
        except BaseException as e:  # delivered to the caller below
            box["e"] = e

    t = threading.Thread(target=run, daemon=True,
                         name="tpu-ir-torch-score-dispatch")
    t.start()
    t.join(deadline_s)
    if t.is_alive():
        with _abandoned_lock:
            _abandoned.append(t)
        raise ScoreDeadlineExceeded(deadline_s)
    if "e" in box:
        raise box["e"]
    return box["r"]


def drain_abandoned(timeout_s: float = 5.0) -> int:
    """Join abandoned dispatch threads for at most `timeout_s`; returns
    how many are still alive. Soaks and tests call it before they return,
    so no thread is left inside a device dispatch at interpreter exit."""
    deadline = time.monotonic() + timeout_s
    with _abandoned_lock:
        threads = list(_abandoned)
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    with _abandoned_lock:
        _abandoned[:] = [t for t in _abandoned if t.is_alive()]
        return len(_abandoned)
