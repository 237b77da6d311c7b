"""The query log and the slow-query trap (the port of
`tpu_ir/obs/querylog.py`).

- **The ring.** Every query the Scorer answers leaves one entry: its
  analyzed terms (or only their hash when redacted), service level, the
  batch's stage split, batch id (the join key inside a shared batch), the
  top hits with their scores, and the MaxScore skip decision.
  TPU_IR_QUERYLOG_RING bounds it; TPU_IR_QUERYLOG_SAMPLE=N keeps every
  N-th entry (a slow one is always kept).
- **Redaction.** With TPU_IR_QUERYLOG_REDACT=1 an entry carries only
  `query_hash` (a CRC over the analyzed terms, the same as `tpu_ir`'s),
  enough to join repeats and flight records; the hash is always there.
- **The slow-query trap.** A query at or above TPU_IR_SLOW_QUERY_MS is
  captured: its span tree (from the request still open on this thread,
  else the ring's newest tree), an explain of its top hit and a
  `slow_query` flight record. The explain is a debug dispatch through the
  kernels, so it runs only when the flight recorder's rate gate admits
  the dump: a storm of slow queries must not double the load. The last
  TPU_IR_QUERYLOG_SLOW_KEEP captures stay readable (`querylog` command,
  `/querylog`), and a compact stamp of each rides every flight header.

The log is host code: it adds no kernel, no synchronize and no device
read-back to the serving path. Its counters (`querylog.recorded`,
`querylog.slow`) and the `querylog.slow_capture` histogram are declared
in obs/registry.py.
"""

from __future__ import annotations

import collections
import threading
import time
import zlib

from .. import envvars
from . import disttrace
from .recorder import flight_dump
from .registry import get_registry
from .trace import current_root, recent_traces

_lock = threading.Lock()
_tls = threading.local()

_ENABLED = envvars.get_bool("TPU_IR_QUERYLOG")
_SAMPLE_N = envvars.get_int("TPU_IR_QUERYLOG_SAMPLE")
_REDACT = envvars.get_bool("TPU_IR_QUERYLOG_REDACT")
_SLOW_MS = envvars.get_float("TPU_IR_SLOW_QUERY_MS")
_RING = collections.deque(maxlen=envvars.get_int("TPU_IR_QUERYLOG_RING"))
_SLOW = collections.deque(
    maxlen=envvars.get_int("TPU_IR_QUERYLOG_SLOW_KEEP"))
_seq = 0
_batch_seq = 0
_slow_times: collections.deque = collections.deque(maxlen=1024)
# the compact stamps of slow offenders for flight headers: appended before
# the dump (so the artifact reporting a slow query lists it) and never
# changed after; a full capture reaches _SLOW only once complete, because
# scrapes serialize published dicts while other threads run
_slow_headers: collections.deque = collections.deque(maxlen=64)

_HEADER_KEYS = ("query_hash", "level", "total_ms", "analyze_ms",
                "dispatch_ms", "time", "batch_id", "queue_wait_ms",
                "batch_occupancy", "trace_id")


def configure(enabled: bool | None = None, sample: int | None = None,
              ring_capacity: int | None = None,
              redact: bool | None = None, slow_ms: float | None = None,
              slow_keep: int | None = None) -> None:
    """Runtime overrides of the TPU_IR_QUERYLOG* knobs and
    TPU_IR_SLOW_QUERY_MS (tests, chip runs)."""
    global _ENABLED, _SAMPLE_N, _REDACT, _SLOW_MS, _RING, _SLOW
    if enabled is not None:
        _ENABLED = enabled
    if sample is not None:
        _SAMPLE_N = max(1, sample)
    if redact is not None:
        _REDACT = redact
    if slow_ms is not None:
        _SLOW_MS = max(0.0, slow_ms)
    with _lock:
        if ring_capacity is not None:
            _RING = collections.deque(_RING, maxlen=max(1, ring_capacity))
        if slow_keep is not None:
            _SLOW = collections.deque(_SLOW, maxlen=max(1, slow_keep))


def enabled() -> bool:
    return _ENABLED


def slow_query_ms() -> float:
    """The trap's threshold in ms; 0 turns it off."""
    return _SLOW_MS


def redacted() -> bool:
    return _REDACT


def next_batch_id() -> int:
    """The process's id for one search_batch dispatch, stamped on each of
    its entries."""
    global _batch_seq
    with _lock:
        _batch_seq += 1
        return _batch_seq


def query_hash(terms) -> str:
    """The stable hex CRC over the analyzed term sequence."""
    blob = "\x1f".join(str(t) for t in terms).encode("utf-8")
    return f"{zlib.crc32(blob) & 0xFFFFFFFF:08x}"


class request_context:
    """Fields stamped on every entry recorded on this thread inside the
    block: the ServingFrontend wraps its scorer call so an entry carries
    the ladder's service level (the scorer knows only its flags)."""

    __slots__ = ("_fields", "_saved")

    def __init__(self, **fields):
        self._fields = fields
        self._saved = None

    def __enter__(self):
        self._saved = getattr(_tls, "fields", None)
        _tls.fields = self._fields
        return self

    def __exit__(self, *exc):
        _tls.fields = self._saved
        return False


def context_fields() -> dict:
    return getattr(_tls, "fields", None) or {}


def record(entry: dict, explain_fn=None) -> dict:
    """Record one query's entry and return it, stamped with `seq`, `time`
    and `slow`. The ring keeps every N-th entry; a slow one is always
    kept and captured (span tree, the explain when the dump is admitted,
    a flight record). `explain_fn` runs only inside an admitted dump."""
    if not _ENABLED:
        return entry
    global _seq
    reg = get_registry()
    entry.setdefault("time", time.strftime("%Y-%m-%dT%H:%M:%S"))
    entry.update(context_fields())
    if entry.get("trace_id") is None:
        # a coalesced follower's id comes in through slot_meta (its entry
        # is recorded on the leader's thread); the rest take this
        # thread's context, and no context means no key
        tid = disttrace.current_trace_id()
        if tid is not None:
            entry["trace_id"] = tid
        else:
            entry.pop("trace_id", None)
    slow = _SLOW_MS > 0.0 and float(entry.get("total_ms", 0.0)) >= _SLOW_MS
    if slow:
        # before the ring append: a published entry never changes again
        entry["slow"] = True
    with _lock:
        _seq += 1
        entry["seq"] = _seq
        keep = slow or _seq % _SAMPLE_N == 0
        if keep:
            _RING.append(entry)
    if keep:
        # kept entries only: what a scrape can read back
        reg.incr("querylog.recorded")
    if slow:
        reg.incr("querylog.slow")
        with _lock:
            _slow_times.append(time.monotonic())
        _capture_slow(entry, explain_fn)
    return entry


def _capture_slow(entry: dict, explain_fn) -> None:
    """Capture a slow offender: span tree, the explain (rate-gated) and a
    flight record. Never raises: the trap runs on the serving path."""
    t0 = time.perf_counter()
    capture = dict(entry)
    try:
        root = current_root()
        if root is not None:
            # the ServingFrontend's request root, still open here
            capture["span_tree"] = root.to_dict()
        else:
            # a plain Scorer call records after its dispatch's root closed
            # into the ring: take the newest tree (under concurrency it
            # may be a neighbour's)
            ring = recent_traces()
            if ring:
                capture["span_tree"] = ring[-1].to_dict()
                capture["span_tree_source"] = "ring"
    except Exception:  # noqa: BLE001 — the trap must not fail a request
        pass
    with _lock:
        _slow_headers.append({k: capture[k] for k in _HEADER_KEYS
                              if k in capture})

    def extra():
        # called by flight_dump only when the rate gate admits the dump
        if explain_fn is not None:
            try:
                capture["explain"] = explain_fn()
            except Exception as e:  # noqa: BLE001
                capture["explain_error"] = repr(e)
        return {"slow_query": capture}

    capture["flight_record"] = flight_dump("slow_query", extra=extra)
    with _lock:
        _SLOW.append(capture)
    get_registry().observe("querylog.slow_capture",
                           time.perf_counter() - t0)


def recent(n: int | None = None) -> list[dict]:
    """The ring, oldest first (the newest `n` when given)."""
    with _lock:
        out = list(_RING)
    return out[-n:] if n else out


def slow_recent(n: int | None = None) -> list[dict]:
    """The slow captures, oldest first (the newest `n` when given)."""
    with _lock:
        out = list(_SLOW)
    return out[-n:] if n else out


def slow_header_entries(limit: int = 8) -> list[dict]:
    """The last slow offenders' compact stamps, for flight headers."""
    with _lock:
        out = list(_slow_headers)
    return out[-limit:]


def slow_last_60s() -> int:
    """Slow queries trapped in the last minute (/healthz)."""
    cutoff = time.monotonic() - 60.0
    with _lock:
        return sum(1 for t in _slow_times if t >= cutoff)


def summary() -> dict:
    """The settings and the counts (the entries come from recent() and
    slow_recent())."""
    reg = get_registry()
    with _lock:
        ring_len, slow_len = len(_RING), len(_SLOW)
        ring_cap, slow_cap = _RING.maxlen, _SLOW.maxlen
    return {
        "enabled": _ENABLED,
        "sample": _SAMPLE_N,
        "redact": _REDACT,
        "slow_query_ms": _SLOW_MS,
        "ring": {"entries": ring_len, "capacity": ring_cap},
        "slow": {"entries": slow_len, "capacity": slow_cap,
                 "last_60s": slow_last_60s()},
        "recorded": reg.get("querylog.recorded"),
        "slow_trapped": reg.get("querylog.slow"),
    }


def clear() -> None:
    """Drop the entries and the captures (obs.reset_all)."""
    global _seq
    with _lock:
        _RING.clear()
        _SLOW.clear()
        _slow_headers.clear()
        _slow_times.clear()
        _seq = 0
