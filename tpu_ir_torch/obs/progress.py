"""Jobs: what each long operation of this process is doing (the port of
`tpu_ir/obs/progress.py`).

`start_job(kind, name, phases=...)` registers a Job with an ordered list
of phases; each phase holds `done`/`total` task counts and free-form
counters (docs parsed, requests served). `report_progress(phase, ...)` is
the hook the builders and the soaks call: it targets the newest running
job and is a no-op when none runs, so library code calls it
unconditionally. `tracked(...)` wraps a block in a job that ends
`succeeded`, or `failed` with the exception that escaped.

A job's percent is the mean over its phases (a phase before the current
one counts whole, the current one done/total) and never falls over the
job's life, so a poller plots it as it reads it. The ETA is the current
phase's remaining tasks at its observed rate. The last TPU_IR_JOB_HISTORY
jobs, running or finished, stay readable (`jobs()`, the server's `/jobs`).
Everything here is thread-safe.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

from .. import envvars

# the version of Job.to_dict()'s shape (the /jobs payload)
JOB_SCHEMA = 1

_lock = threading.Lock()
_jobs: collections.deque = collections.deque(
    maxlen=envvars.get_int("TPU_IR_JOB_HISTORY"))
_ids = itertools.count(1)


def _new_phase() -> dict:
    return {"done": 0, "total": None, "counters": {}, "started": None,
            "unit": None}


class Job:
    """One tracked operation. Every change goes through report() or
    finish() under the job's lock and bumps `seq`, so a poller sees a
    change by comparing one number."""

    def __init__(self, kind: str, name: str, phases=(), config=None):
        self.job_id = next(_ids)
        self.kind = kind
        self.name = name
        self.config = dict(config or {})
        self.state = "running"
        self.error: str | None = None
        self.started = time.time()
        self.finished_at: float | None = None
        self.seq = 0
        self._lock = threading.Lock()
        self._phases: dict[str, dict] = {p: _new_phase() for p in phases}
        self._current: str | None = None
        self._max_percent = 0.0

    def report(self, phase: str | None, advance: int = 0,
               total: int | None = None, unit: str | None = None,
               **counters) -> None:
        """Progress on `phase` (made on first mention, and made current;
        None means the current phase): `advance` adds to its done count,
        `total` sets its task count, `unit` names what a task is, and
        keyword counters add into its counter table."""
        with self._lock:
            if phase is None:
                phase = self._current or "main"
            st = self._phases.get(phase)
            if st is None:
                st = self._phases[phase] = _new_phase()
            if st["started"] is None:
                st["started"] = time.time()
            # entering a later phase closes the earlier ones for the
            # percent (phases run in the order they are declared)
            self._current = phase
            if total is not None:
                st["total"] = int(total)
            if unit is not None:
                st["unit"] = unit
            if advance:
                st["done"] += int(advance)
            for k, v in counters.items():
                st["counters"][k] = st["counters"].get(k, 0) + v
            self.seq += 1

    def finish(self, error: str | None = None) -> None:
        """End the job, `failed` with `error` or `succeeded`; a second
        call does nothing."""
        with self._lock:
            if self.state != "running":
                return
            self.state = "failed" if error else "succeeded"
            self.error = error
            self.finished_at = time.time()
            self.seq += 1

    def _percent_locked(self) -> float:
        if self.state == "succeeded":
            return 100.0
        names = list(self._phases)
        if not names:
            return 0.0
        cur = names.index(self._current) if self._current in names else -1
        frac = 0.0
        for i, n in enumerate(names):
            st = self._phases[n]
            if i < cur:
                frac += 1.0
            elif i == cur and st["total"]:
                frac += min(st["done"] / st["total"], 1.0)
        # a total raised late (a resume finding more batches) must not
        # move the needle back
        self._max_percent = max(self._max_percent,
                                100.0 * frac / len(names))
        return round(self._max_percent, 2)

    def _eta_locked(self) -> float | None:
        """Seconds to the current phase's end at its observed rate."""
        if self.state != "running" or self._current is None:
            return None
        st = self._phases.get(self._current)
        if not st or not st["total"] or not st["done"]:
            return None
        elapsed = time.time() - (st["started"] or self.started)
        if elapsed <= 0:
            return None
        rate = st["done"] / elapsed
        remaining = max(st["total"] - st["done"], 0)
        return round(remaining / rate, 1) if rate > 0 else None

    def to_dict(self) -> dict:
        with self._lock:
            phases = []
            for name, st in self._phases.items():
                row = {"phase": name, "done": st["done"],
                       "total": st["total"],
                       "counters": dict(st["counters"])}
                if st["unit"]:
                    row["unit"] = st["unit"]
                if st["total"]:
                    row["percent"] = round(
                        100.0 * min(st["done"] / st["total"], 1.0), 2)
                phases.append(row)
            out = {
                "schema": JOB_SCHEMA,
                "job_id": self.job_id,
                "kind": self.kind,
                "name": self.name,
                "state": self.state,
                "seq": self.seq,
                "started": time.strftime(
                    "%Y-%m-%dT%H:%M:%S", time.localtime(self.started)),
                "elapsed_s": round(
                    (self.finished_at or time.time()) - self.started, 3),
                "percent": self._percent_locked(),
                "current_phase": self._current,
                "phases": phases,
                "config": dict(self.config),
            }
            eta = self._eta_locked()
            if eta is not None:
                out["eta_s"] = eta
            if self.error:
                out["error"] = self.error
            return out


def start_job(kind: str, name: str, *, phases=(), config=None) -> Job:
    """Register a running Job (the report_progress target from now on);
    the caller finishes it, failed on its error path."""
    job = Job(kind, name, phases=phases, config=config)
    with _lock:
        _jobs.append(job)
    return job


def current_job() -> Job | None:
    """The newest running job (None when none runs)."""
    with _lock:
        for job in reversed(_jobs):
            if job.state == "running":
                return job
    return None


def report_progress(phase: str | None, advance: int = 0,
                    total: int | None = None, unit: str | None = None,
                    **counters) -> None:
    """Job.report on the current job; nothing when no job runs."""
    job = current_job()
    if job is not None:
        job.report(phase, advance=advance, total=total, unit=unit,
                   **counters)


@contextlib.contextmanager
def tracked(kind: str, name: str, *, phases=(), config=None):
    """A job for the length of a `with` block: `succeeded` when it ends
    cleanly (unless the block finished the job itself), `failed` with
    the exception's repr when one escapes."""
    job = start_job(kind, name, phases=phases, config=config)
    try:
        yield job
    except BaseException as e:
        job.finish(error=repr(e))
        raise
    job.finish()


def jobs() -> list:
    """The job history, oldest first, running jobs included."""
    with _lock:
        return list(_jobs)


def get_job(job_id: int) -> Job | None:
    with _lock:
        for job in _jobs:
            if job.job_id == job_id:
                return job
    return None


def clear_jobs() -> None:
    """Forget every job (obs.reset_all)."""
    with _lock:
        _jobs.clear()
