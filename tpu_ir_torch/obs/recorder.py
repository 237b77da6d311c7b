"""The flight recorder: recent traces and the telemetry, frozen to a file
when something fails (the port of `tpu_ir/obs/recorder.py`).

On a soak's invariant breach, a breaker opening, an SLO burn breach, a
build stage out of retries, a WAL's torn tail, a slow query or an
anomaly in the time series, `flight_dump()` writes one JSONL artifact:

  1. a header line: reason, wall time, pid, sequence number, the host's
     and the card's memory, the profiler's compile-cache totals, the last
     slow-query entries, the open request's trace id and root span, the
     time series' lead-up (obs/timeseries.py's last tier-0 points of each
     curated series), and the caller's context (`extra`);
  2. one line per finished request tree in the trace ring (obs/trace.py);
  3. one snapshot of the registry's counters, gauges and histograms.

Dumps are rate-limited per reason (TPU_IR_FLIGHT_INTERVAL seconds) so a
flapping breaker cannot fill a disk; an invariant breach passes
`force=True`, since a correctness breach is never dropped. Artifacts land
in TPU_IR_FLIGHT_DIR (unset: `tpu_ir_flight` under the system temp dir)
unless the caller names a directory. File names and line shapes are
`tpu_ir`'s, so either package's `recent_headers` reads the other's
directory.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

from .. import envvars
from .registry import get_registry
from .trace import current_root, recent_traces

# the version of the artifact's header and record shapes
FLIGHT_SCHEMA = 1

_lock = threading.Lock()
_last_dump: dict[str, float] = {}
_seq = 0


def _next_seq() -> int:
    """The process's artifact sequence number, in the header and in the
    file name: two dumps within one wall-clock second still order."""
    global _seq
    with _lock:
        _seq += 1
        return _seq


def flight_dir() -> str:
    return (envvars.get_str("TPU_IR_FLIGHT_DIR")
            or os.path.join(tempfile.gettempdir(), "tpu_ir_flight"))


def reset_rate_limit() -> None:
    """Forget when each reason last dumped (obs.reset_all)."""
    with _lock:
        _last_dump.clear()


def _open_request() -> dict:
    """The trace id of the request open on this thread, and its root
    span: read from the live context, not from the ring, which may have
    dropped the very request whose failure triggered the dump."""
    from . import disttrace  # disttrace imports this module at its top

    tid = disttrace.current_trace_id()
    if tid is None:
        return {}
    out = {"trace_id": tid}
    root = current_root()
    if root is not None:
        out["open_root"] = {"name": root.name, "attrs": dict(root.attrs)}
    return out


def artifact_lines(reason: str, extra=None,
                   seq: int | None = None) -> list[str]:
    """The artifact, one JSON string a line: the header, one trace record
    a ring entry, then the registry's snapshot. flight_dump and the
    `trace-dump` command both write this. `extra` may be a callable
    returning the dict: flight_dump defers costly context (the slow-query
    trap's explain dispatch) behind its rate gate that way."""
    from .querylog import slow_header_entries  # querylog imports us

    header = {
        "record": "header",
        "schema": FLIGHT_SCHEMA,
        "seq": _next_seq() if seq is None else seq,
        "reason": reason,
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "pid": os.getpid(),
    }
    try:
        # memory and the compile cache at the moment of failure (profiling
        # imports this module for its storm records)
        from .profiling import compile_cache_snapshot, memory_snapshot

        header["memory"] = memory_snapshot()
        header["compile_cache"] = compile_cache_snapshot()
    except Exception:  # noqa: BLE001 — the header must always write
        pass
    try:
        header["slow_queries"] = slow_header_entries()
        header.update(_open_request())
    except Exception:  # noqa: BLE001 — the header must always write
        pass
    try:
        # the lead-up: the last retained windows of every curated series
        # (timeseries imports this module for its anomaly records)
        from .timeseries import header_window

        hw = header_window()
        if hw is not None:
            header["timeseries"] = hw
    except Exception:  # noqa: BLE001 — the header must always write
        pass
    if callable(extra):
        try:
            extra = extra()
        except Exception:  # noqa: BLE001 — deferred context must not
            extra = None   # kill the artifact that reports the failure
    if extra:
        header["extra"] = extra
    lines = [json.dumps(header, default=repr)]
    for span in recent_traces():
        lines.append(json.dumps({"record": "trace",
                                 "trace": span.to_dict()}, default=repr))
    lines.append(json.dumps({"record": "telemetry",
                             "telemetry": get_registry().snapshot()},
                            default=repr))
    return lines


def flight_dump(reason: str, extra=None, out_dir: str | None = None,
                force: bool = False) -> str | None:
    """Write one artifact and return its path; None when rate-limited
    (this reason dumped within the interval and the dump is not forced)
    or when the write failed. Never raises: it runs inside failure
    paths, where a full disk must not turn a degraded request into a
    crashed one."""
    global _seq
    now = time.monotonic()
    with _lock:
        if not force and now - _last_dump.get(
                reason, -1e18) < envvars.get_float("TPU_IR_FLIGHT_INTERVAL"):
            return None
        _last_dump[reason] = now
        _seq += 1
        seq = _seq
    try:
        d = out_dir or flight_dir()
        os.makedirs(d, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in reason)
        path = os.path.join(
            d, f"flight-{time.strftime('%Y%m%dT%H%M%S')}-"
               f"{os.getpid()}-{seq:03d}-{safe}.jsonl")
        with open(path, "w") as f:
            f.write("\n".join(artifact_lines(reason, extra, seq=seq))
                    + "\n")
        return path
    except Exception:  # noqa: BLE001 — see the docstring
        return None


def recent_headers(out_dir: str | None = None, limit: int = 32) -> list:
    """The header lines of the newest artifacts in `out_dir` (default:
    flight_dir()), newest first, each with its file's path: the `/flight`
    index. Unreadable or foreign files are skipped, never raised."""
    d = out_dir or flight_dir()
    try:
        names = [n for n in os.listdir(d)
                 if n.startswith("flight-") and n.endswith(".jsonl")]
    except OSError:
        return []

    def _mtime(p: str) -> float:
        try:
            return os.path.getmtime(p)
        except OSError:  # deleted between the listing and the stat
            return 0.0

    paths = sorted((os.path.join(d, n) for n in names), key=_mtime,
                   reverse=True)
    out = []
    for path in paths[:limit]:
        try:
            with open(path) as f:
                header = json.loads(f.readline())
        except (OSError, ValueError):
            continue
        if isinstance(header, dict) and header.get("record") == "header":
            header["path"] = path
            out.append(header)
    return out
