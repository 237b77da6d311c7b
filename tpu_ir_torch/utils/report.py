"""Named-counter ledgers of the serving tier (the part of
`tpu_ir/utils/report.py` serving needs), with the JAX package's counter
names.

`RecoveryCounters` is a standalone ledger (each ServingFrontend keeps
one). `recovery_counters()` and `serving_counters()` are the process-wide
ledgers, views over the registry's `recovery.` and `serving.` namespaces.
"""

from __future__ import annotations

import threading

from ..obs.registry import get_registry


class RecoveryCounters:
    """A thread-safe named-counter ledger: every degradation, shed and
    control-plane transition increments a counter, so a test can assert
    that a recovery happened rather than infer it from silence."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}

    def incr(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + amount

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)


class _RegistryCounters(RecoveryCounters):
    """A RecoveryCounters view over one registry namespace: incr("x") on
    the "recovery." view is the registry's "recovery.x"."""

    def __init__(self, prefix: str):
        self._prefix = prefix

    def incr(self, name: str, amount: int = 1) -> None:
        get_registry().incr(self._prefix + name, amount)

    def get(self, name: str) -> int:
        return get_registry().get(self._prefix + name)

    def snapshot(self) -> dict[str, int]:
        return get_registry().counters(self._prefix)


_RECOVERY = _RegistryCounters("recovery.")
_SERVING = _RegistryCounters("serving.")


def recovery_counters() -> RecoveryCounters:
    """The process-wide recovery counters: degraded_batches,
    deadline_expired, device_loss, forced_host_batches."""
    return _RECOVERY


def serving_counters() -> RecoveryCounters:
    """The process-wide serving-frontend counters: submitted,
    served_<level>, served_breaker_host, served_cache, degraded,
    shed_<reason>, breaker_opened, breaker_probes, level_step_<dir>,
    generation_swap."""
    return _SERVING
