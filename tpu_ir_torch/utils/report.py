"""Named-counter ledgers of the serving tier and the build's job reports
(the parts of `tpu_ir/utils/report.py` the port needs), with the JAX
package's counter names.

`JobReport` is one build job's phase timings and counters, saved as
`jobs/<job>.json` in the index dir (what the build's progress job,
obs/progress.py, shows live is written here once, at the job's end).

`RecoveryCounters` is a standalone ledger (each ServingFrontend keeps
one). `recovery_counters()` and `serving_counters()` are the process-wide
ledgers, views over the registry's `recovery.` and `serving.` namespaces.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

from ..obs.registry import get_registry


class JobReport:
    """One job's counters, phase timings (seconds, summed over repeated
    phases) and config."""

    def __init__(self, job: str, config: dict | None = None,
                 suffix: str = ""):
        self.job = job
        self.config = dict(config or {})
        self.suffix = suffix
        self.counters: dict[str, int] = {}
        self.timings_s: dict[str, float] = {}
        self._t0 = time.perf_counter()

    def incr(self, name: str, amount: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + amount

    def set_counter(self, name: str, value: int) -> None:
        self.counters[name] = int(value)

    @contextmanager
    def phase(self, name: str):
        """Time one phase; under torch.profiler it is also the region
        `tpu_ir_torch.build.<name>`, so a trace can attribute the device
        time of a phase (chip_smoke's pass-2 device time)."""
        import torch

        t = time.perf_counter()
        try:
            with torch.profiler.record_function(f"tpu_ir_torch.build.{name}"):
                yield self
        finally:
            self.timings_s[name] = (self.timings_s.get(name, 0.0)
                                    + time.perf_counter() - t)

    def record_peaks(self, device) -> None:
        """The process's peak host RSS so far (`peak_host_rss_bytes`,
        ru_maxrss) and, on a CUDA device, torch's peak allocated bytes
        (`peak_device_bytes`)."""
        import resource

        import torch

        self.set_counter("peak_host_rss_bytes", resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024)
        if torch.device(device).type == "cuda":
            self.set_counter("peak_device_bytes",
                             torch.cuda.max_memory_allocated(device))

    def save(self, jobs_dir: str | os.PathLike) -> str:
        os.makedirs(jobs_dir, exist_ok=True)
        out = {"job": self.job,
               "wall_s": time.perf_counter() - self._t0,
               "counters": self.counters,
               "timings_s": dict(self.timings_s),
               "config": self.config,
               "finished_at": time.strftime("%Y-%m-%dT%H:%M:%S")}
        path = os.path.join(os.fspath(jobs_dir),
                            f"{self.job}{self.suffix}.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
        return path


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
