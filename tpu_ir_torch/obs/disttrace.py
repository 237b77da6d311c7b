"""The process's service identity and the SLO burn-rate windows (the
parts of `tpu_ir/obs/disttrace.py` the shard worker tier and the
autoscaler need).

A worker names itself once (`set_service("worker-s0r1")`) and every span
it opens carries the name.

Every finished routed request is classified (`slo_record`): good iff it
was served at full quality within TPU_IR_SLO_P99_MS. Two sliding windows
(60 s and 300 s) keep the good/bad split; a window's burn multiple is its
bad share over the error budget (1 - the 0.99 target). The fast window's
burn is the autoscaler's second scale-up signal (`slo_burn_signal`), and
a breach (both windows at 10x, the fast one holding at least 20
requests) counts `slo.burn_breach` once a trip and logs one warning with
the record's fields (`tpu_ir` writes a flight record there; the port has
no flight recorder yet). Trace contexts, their propagation and stitching
are not ported yet."""

from __future__ import annotations

import collections
import logging
import threading
import time

from .. import envvars
from .registry import get_registry

logger = logging.getLogger(__name__)

_SERVICE = "proc"


def set_service(name: str) -> None:
    """Label this process's spans (router, worker-s0r1, ...)."""
    global _SERVICE
    _SERVICE = str(name)


def service() -> str:
    """This process's service name ("proc" until one is set)."""
    return _SERVICE


# -- the SLO burn-rate tracker ---------------------------------------------

_SLO_MS = envvars.get_float("TPU_IR_SLO_P99_MS")
_SLO_TARGET = 0.99       # availability target: a 1% error budget
_BURN_THRESHOLD = 10.0   # the burn multiple that, in both windows, breaches
_MIN_SAMPLES = 20        # the fast window's floor before a breach can fire
_SLO_EVENT_CAP = 100_000


class _Window:
    """One sliding good/bad window: append, then evict what aged out."""

    __slots__ = ("horizon", "events", "bad")

    def __init__(self, horizon: float):
        self.horizon = horizon
        self.events: collections.deque = collections.deque()
        self.bad = 0

    def add(self, t: float, good: bool) -> None:
        self.events.append((t, good))
        if not good:
            self.bad += 1
        while len(self.events) > _SLO_EVENT_CAP:
            self._pop()
        self.evict(t)

    def _pop(self) -> None:
        _, g = self.events.popleft()
        if not g:
            self.bad -= 1

    def evict(self, now: float) -> None:
        cutoff = now - self.horizon
        while self.events and self.events[0][0] < cutoff:
            self._pop()

    def stats(self, now: float):
        self.evict(now)
        return len(self.events), self.bad


_slo_lock = threading.Lock()
_fast = _Window(60.0)
_slow = _Window(300.0)
_slo_levels: dict = {}
_breached = False


def _burn(n: int, bad: int) -> float:
    if not n:
        return 0.0
    budget = max(1e-9, 1.0 - _SLO_TARGET)
    return (bad / n) / budget


def slo_record(level: str, total_ms: float, ok: bool = True,
               classification: str = "full") -> bool:
    """Classify one finished request: good iff it was served at full
    quality within TPU_IR_SLO_P99_MS (a shed, errored, partial or
    degraded answer burns budget however fast it was). Returns the
    verdict. On the not-breached -> breached transition (both windows
    past the threshold) counts `slo.burn_breach` and logs the snapshot."""
    good = (bool(ok) and classification == "full"
            and float(total_ms) <= _SLO_MS)
    reg = get_registry()
    reg.incr("slo.good" if good else "slo.bad")
    now = time.monotonic()
    global _breached
    fire = False
    with _slo_lock:
        _fast.add(now, good)
        _slow.add(now, good)
        g, b = _slo_levels.get(level, (0, 0))
        _slo_levels[level] = (g + int(good), b + int(not good))
        fn, fb = _fast.stats(now)
        sn, sb = _slow.stats(now)
        burn_fast, burn_slow = _burn(fn, fb), _burn(sn, sb)
        breach = (fn >= _MIN_SAMPLES and burn_fast >= _BURN_THRESHOLD
                  and burn_slow >= _BURN_THRESHOLD)
        if breach and not _breached:
            _breached = True
            fire = True
        elif not breach:
            _breached = False
    reg.set_gauge("slo.burn_fast", round(burn_fast, 4))
    reg.set_gauge("slo.burn_slow", round(burn_slow, 4))
    if fire:
        reg.incr("slo.burn_breach")
        logger.warning("slo burn breach: %s", slo_snapshot())
    return good


def slo_burn_signal() -> float:
    """The fast window's burn multiple now: the autoscaler's second
    signal (at or above its slo_burn_up it arms a scale-up as sustained
    occupancy does)."""
    with _slo_lock:
        n, bad = _fast.stats(time.monotonic())
        return round(_burn(n, bad), 4)


def slo_snapshot() -> dict:
    """The SLO state (`tpu_ir`'s /slo payload): the config, both windows'
    good/bad split and burn multiples, each level's lifetime split, the
    breach state."""
    reg = get_registry()
    now = time.monotonic()
    with _slo_lock:
        fn, fb = _fast.stats(now)
        sn, sb = _slow.stats(now)
        levels = {lv: {"good": g, "bad": b}
                  for lv, (g, b) in sorted(_slo_levels.items())}
        breached = _breached
        fast_h, slow_h = _fast.horizon, _slow.horizon
    return {
        "slo_p99_ms": _SLO_MS,
        "target": _SLO_TARGET,
        "error_budget": round(1.0 - _SLO_TARGET, 6),
        "burn_threshold": _BURN_THRESHOLD,
        "breached": breached,
        "windows": {
            "fast": {"horizon_s": fast_h, "total": fn, "bad": fb,
                     "bad_fraction": round(fb / fn, 4) if fn else 0.0,
                     "burn": round(_burn(fn, fb), 4)},
            "slow": {"horizon_s": slow_h, "total": sn, "bad": sb,
                     "bad_fraction": round(sb / sn, 4) if sn else 0.0,
                     "burn": round(_burn(sn, sb), 4)},
        },
        "levels": levels,
        "good": reg.get("slo.good"),
        "bad": reg.get("slo.bad"),
        "breaches": reg.get("slo.burn_breach"),
    }


def reset() -> None:
    """Drop both SLO windows and restore the env-derived config (the
    tests' isolation, through obs.reset_all)."""
    global _SLO_MS, _SLO_TARGET, _BURN_THRESHOLD, _MIN_SAMPLES, _breached
    with _slo_lock:
        _fast.events.clear()
        _fast.bad = 0
        _fast.horizon = 60.0
        _slow.events.clear()
        _slow.bad = 0
        _slow.horizon = 300.0
        _slo_levels.clear()
        _breached = False
    _SLO_MS = envvars.get_float("TPU_IR_SLO_P99_MS")
    _SLO_TARGET = 0.99
    _BURN_THRESHOLD = 10.0
    _MIN_SAMPLES = 20
