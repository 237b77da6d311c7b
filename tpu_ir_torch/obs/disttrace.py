"""Distributed request tracing and the SLO burn-rate windows (the port of
`tpu_ir/obs/disttrace.py`).

A routed request crosses processes: the router fans it out to shard
workers (hedges and failovers included), and a worker's coalescer may
dispatch it in another request's batch. Each hop builds its own span tree
(obs/trace.py); this module joins them.

- **Context** (`TraceContext`): a W3C-traceparent-style trace id (32
  hex), span id (16 hex) and flags byte, minted at the router's admission
  (`mint`), sent as `traceparent: 00-<trace>-<span>-<flags>` with each
  replica attempt (`child` gives the attempt its own span id, so the
  worker's spans parent under the attempt that carried them), and adopted
  by the worker's `/rpc/<name>` handler (`adopt`). `use(ctx)` installs a
  context on this thread.
- **Records**: flat span dicts {trace_id, span_id, parent_id, name,
  service, host, pid, start_ms, dur_ms, attrs[, error]} in a bounded
  store a trace. A root-close hook (`_on_root_close`) flattens each
  finished local tree under the installed context; `add_span` records
  regions timed elsewhere (the router's attempts, the coalescer's shared
  dispatch under each member's trace) and `annotate` binds their verdict
  later; `ingest_remote` folds the records a worker piggybacked on its
  answer (`_trace`).
- **Keep or drop**, at root close, by the process that minted the trace:
  slow (>= TPU_IR_SLO_P99_MS), partial, degraded, hedged, shed or failed
  roots are always kept (TPU_IR_TRACE_TAIL), the rest 1 in
  TPU_IR_TRACE_SAMPLE. An adopted trace is always kept and exported: the
  verdict is the minter's.
- **Export and stitch**: kept traces spool their local records
  (obs/aggregate.py, TPU_IR_TELEMETRY_DIR); `stitch` builds one trace's
  tree from the store and the spool, deduplicated by span id.
- **SLO windows**: every finished routed request is classified
  (`slo_record`): good iff served at full quality within
  TPU_IR_SLO_P99_MS. Two sliding windows (60 s and 300 s) keep the
  good/bad split; a window's burn multiple is its bad share over the
  error budget (1 - the 0.99 target). The fast window's burn is the
  autoscaler's second scale-up signal (`slo_burn_signal`), and a breach
  (both windows at 10x, the fast one holding at least 20 requests) counts
  `slo.burn_breach` once a trip and writes one `slo_burn_breach` flight
  record holding the SLO snapshot (obs/recorder.py).

TPU_IR_DISTTRACE=0 turns the tracing half into flag tests that return
None or do nothing. Trace and span ids come from os.urandom.
"""

from __future__ import annotations

import collections
import os
import socket
import threading
import time

from .. import envvars
from .recorder import flight_dump
from .registry import get_registry
from .trace import add_root_hook as _add_root_hook


_lock = threading.Lock()
_tls = threading.local()
_HOST = socket.gethostname()

_ENABLED = envvars.get_bool("TPU_IR_DISTTRACE")
_TAIL = envvars.get_bool("TPU_IR_TRACE_TAIL")
_SAMPLE_N = envvars.get_int("TPU_IR_TRACE_SAMPLE")
_SLO_MS = envvars.get_float("TPU_IR_SLO_P99_MS")

# the store's bounds: past _MAX_TRACES the oldest trace goes whole; past
# _MAX_SPANS_PER_TRACE a record counts disttrace.spans_dropped
_MAX_TRACES = 256
_MAX_SPANS_PER_TRACE = 512

_SERVICE = "proc"
_root_seq = 0

# trace_id -> {"spans": [record], "local": [bool], "exported": int},
# oldest first
_STORE: "collections.OrderedDict[str, dict]" = collections.OrderedDict()


def enabled() -> bool:
    return _ENABLED


def set_service(name: str) -> None:
    """Name this process in its span records (router, worker-s0r1, ...):
    the waterfall's lanes."""
    global _SERVICE
    _SERVICE = str(name)


def configure(enabled: bool | None = None, tail: bool | None = None,
              sample: int | None = None, slo_ms: float | None = None,
              slo_target: float | None = None,
              burn_threshold: float | None = None,
              min_samples: int | None = None,
              fast_window_s: float | None = None,
              slow_window_s: float | None = None,
              max_traces: int | None = None) -> None:
    """Runtime overrides of the env knobs and the SLO constants (tests,
    soaks); `reset()` restores them."""
    global _ENABLED, _TAIL, _SAMPLE_N, _SLO_MS, _MAX_TRACES
    global _SLO_TARGET, _BURN_THRESHOLD, _MIN_SAMPLES
    if enabled is not None:
        _ENABLED = enabled
    if tail is not None:
        _TAIL = tail
    if sample is not None:
        _SAMPLE_N = max(1, sample)
    if slo_ms is not None:
        _SLO_MS = max(1.0, slo_ms)
    if slo_target is not None:
        _SLO_TARGET = min(max(slo_target, 0.0), 0.99999)
    if burn_threshold is not None:
        _BURN_THRESHOLD = max(0.0, burn_threshold)
    if min_samples is not None:
        _MIN_SAMPLES = max(1, min_samples)
    if fast_window_s is not None:
        _fast.horizon = max(0.001, fast_window_s)
    if slow_window_s is not None:
        _slow.horizon = max(0.001, slow_window_s)
    if max_traces is not None:
        _MAX_TRACES = max(1, max_traces)


# -- the context -----------------------------------------------------------


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def new_span_id() -> str:
    """A fresh 8-byte span id, for a record that appears under one id in
    several traces (the coalescer's shared dispatch)."""
    return _new_id(8)


class TraceContext:
    """One hop's place in a distributed trace: the trace, the span the
    next records parent under, the flags byte, and (adopted) the remote
    span the local root links back to."""

    __slots__ = ("trace_id", "span_id", "parent_id", "flags", "adopted")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: str | None = None, flags: int = 1,
                 adopted: bool = False):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.flags = flags
        self.adopted = adopted

    def to_header(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"

    def __repr__(self) -> str:
        return (f"TraceContext({self.to_header()!r}"
                f"{', adopted' if self.adopted else ''})")


def mint() -> TraceContext | None:
    """A trace born here (router admission, or a frontend that is its own
    edge); None when tracing is off."""
    if not _ENABLED:
        return None
    get_registry().incr("disttrace.minted")
    return TraceContext(_new_id(16), _new_id(8))


def parse_traceparent(value: str | None):
    """(trace_id, span_id, flags) of a traceparent header, or None for
    anything malformed: a bad header makes the request untraced, never a
    failed one."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4 or parts[0] != "00":
        return None
    tid, sid, fl = parts[1], parts[2], parts[3]
    if len(tid) != 32 or len(sid) != 16 or len(fl) != 2:
        return None
    try:
        int(tid, 16)
        int(sid, 16)
        flags = int(fl, 16)
    except ValueError:
        return None
    if tid == "0" * 32 or sid == "0" * 16:
        return None
    return tid, sid, flags


def adopt(header: str | None) -> TraceContext | None:
    """Join a trace minted elsewhere: the header's span becomes the local
    root's parent, and the root gets a fresh span id."""
    if not _ENABLED:
        return None
    parsed = parse_traceparent(header)
    if parsed is None:
        return None
    tid, parent, flags = parsed
    get_registry().incr("disttrace.adopted")
    return TraceContext(tid, _new_id(8), parent_id=parent, flags=flags,
                        adopted=True)


def child(ctx: TraceContext | None) -> TraceContext | None:
    """One attempt's context: the same trace, a fresh span id, parented
    under `ctx`."""
    if ctx is None:
        return None
    return TraceContext(ctx.trace_id, _new_id(8),
                        parent_id=ctx.span_id, flags=ctx.flags,
                        adopted=ctx.adopted)


class use:
    """Install `ctx` as this thread's current context for the block (None
    installs nothing, so callers need no branch when tracing is off)."""

    __slots__ = ("_ctx", "_saved")

    def __init__(self, ctx: TraceContext | None):
        self._ctx = ctx
        self._saved = None

    def __enter__(self) -> TraceContext | None:
        if self._ctx is not None:
            self._saved = getattr(_tls, "ctx", None)
            _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc) -> bool:
        if self._ctx is not None:
            _tls.ctx = self._saved
        return False


def current() -> TraceContext | None:
    return getattr(_tls, "ctx", None)


def current_trace_id() -> str | None:
    """The trace id of the request open on this thread, or None."""
    ctx = getattr(_tls, "ctx", None)
    return ctx.trace_id if ctx is not None else None


# -- the span store --------------------------------------------------------


def _store_add(trace_id: str, rec: dict, local: bool) -> bool:
    dropped = False
    with _lock:
        entry = _STORE.get(trace_id)
        if entry is None:
            while len(_STORE) >= _MAX_TRACES:
                _STORE.popitem(last=False)
            entry = _STORE[trace_id] = {"spans": [], "local": [],
                                        "exported": 0}
        if len(entry["spans"]) >= _MAX_SPANS_PER_TRACE:
            dropped = True
        else:
            entry["spans"].append(rec)
            entry["local"].append(bool(local))
    if dropped:
        get_registry().incr("disttrace.spans_dropped")
    return not dropped


def add_span(trace_id: str | None, name: str, *,
             span_id: str | None = None, parent_id: str | None = None,
             start_ms: float | None = None, dur_ms: float = 0.0,
             attrs: dict | None = None, error: str | None = None,
             local: bool = True) -> str | None:
    """Record one region timed elsewhere. Returns its span id (for a later
    `annotate`), or None when tracing is off or there is no trace."""
    if not _ENABLED or not trace_id:
        return None
    sid = span_id or _new_id(8)
    rec = {"trace_id": trace_id, "span_id": sid, "parent_id": parent_id,
           "name": name, "service": _SERVICE, "host": _HOST,
           "pid": os.getpid(),
           "start_ms": float(start_ms if start_ms is not None
                             else time.time() * 1000.0),
           "dur_ms": round(float(dur_ms), 3),
           "attrs": dict(attrs or {})}
    if error:
        rec["error"] = error
    _store_add(trace_id, rec, local)
    return sid


def annotate(trace_id: str | None, span_id: str | None,
             dur_ms: float | None = None, **attrs) -> None:
    """Bind attrs (and the true duration) to a stored record after it was
    added: an attempt is recorded at submit, its verdict known at harvest.
    An unknown trace or span is a no-op."""
    if not _ENABLED or not trace_id or not span_id:
        return
    with _lock:
        entry = _STORE.get(trace_id)
        if entry is None:
            return
        for rec in entry["spans"]:
            if rec["span_id"] == span_id:
                if dur_ms is not None:
                    rec["dur_ms"] = round(float(dur_ms), 3)
                rec["attrs"].update(attrs)
                return


def ingest_remote(spans) -> None:
    """Fold another process's records (an RPC answer's `_trace`) into the
    store, as remote records: this process never exports them again."""
    if not _ENABLED or not spans:
        return
    for rec in spans:
        if isinstance(rec, dict) and rec.get("trace_id"):
            _store_add(rec["trace_id"], dict(rec), local=False)


def spans_for(trace_id: str, local_only: bool = False) -> list:
    """Copies of one trace's stored records (their attrs copied too:
    `annotate` writes in place while readers serialize)."""
    with _lock:
        entry = _STORE.get(trace_id)
        if entry is None:
            return []
        pairs = list(zip(entry["spans"], entry["local"]))
    return [dict(r, attrs=dict(r["attrs"])) for r, loc in pairs
            if loc or not local_only]


def trace_ids() -> list:
    """The stored trace ids, oldest first."""
    with _lock:
        return list(_STORE)


def drop(trace_id: str) -> None:
    with _lock:
        _STORE.pop(trace_id, None)


def piggyback(trace_id: str | None) -> list | None:
    """A worker's export: this process's own records of one trace, sent
    on its RPC answer (`_trace`); remote records stay out."""
    if not _ENABLED or not trace_id:
        return None
    batch = spans_for(trace_id, local_only=True)
    if not batch:
        return None
    get_registry().incr("disttrace.spans_exported", len(batch))
    return batch


def _export_spool(trace_id: str) -> None:
    """Spool this trace's local records not spooled yet. Remote records
    stay out: the process that made them spools them."""
    with _lock:
        entry = _STORE.get(trace_id)
        if entry is None:
            return
        local = [dict(r, attrs=dict(r["attrs"]))
                 for r, loc in zip(entry["spans"], entry["local"]) if loc]
        batch = local[entry["exported"]:]
        entry["exported"] = len(local)
    if not batch:
        return
    from .aggregate import span_spool_write

    if span_spool_write(batch) is not None:
        get_registry().incr("disttrace.spans_exported", len(batch))


# -- the root-close hook (obs/trace.py -> records) -------------------------


def _flatten(root, ctx: TraceContext) -> list:
    """One finished local span tree as records under `ctx`: the root takes
    the context's own span id (remote children already parent under it)
    and links to the remote parent when adopted; the rest get fresh ids."""
    root_wall_ms = (root.wall_time or time.time()
                    - root.dur_ns / 1e9) * 1000.0
    out = []

    def walk(span, parent_id, sid):
        rec = {"trace_id": ctx.trace_id, "span_id": sid,
               "parent_id": parent_id, "name": span.name,
               "service": _SERVICE, "host": _HOST, "pid": os.getpid(),
               "start_ms": round(root_wall_ms
                                 + (span.start_ns - root.start_ns) / 1e6,
                                 3),
               "dur_ms": round(span.dur_ns / 1e6, 3),
               "attrs": dict(span.attrs)}
        if span.error is not None:
            rec["error"] = span.error
        out.append(rec)
        for c in tuple(span.children):
            walk(c, sid, _new_id(8))

    walk(root, ctx.parent_id, ctx.span_id)
    return out


def _is_tail(root) -> bool:
    """The force-keep rule: a slow, failed, partial, degraded, hedged or
    shed root."""
    if root.dur_ns / 1e6 >= _SLO_MS or root.error is not None:
        return True
    a = root.attrs
    return bool(a.get("partial") or a.get("degraded") or a.get("hedges")
                or a.get("shed"))


def _on_root_close(root) -> None:
    """obs/trace.py's hook, fired with every finished root: under an
    installed context, flatten the tree into the store, then keep and
    export it (adopted; or minted and kept by the tail rule or the 1-in-N
    dice) or drop it."""
    if not _ENABLED:
        return
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return
    for rec in _flatten(root, ctx):
        _store_add(ctx.trace_id, rec, local=True)
    if ctx.adopted:
        _export_spool(ctx.trace_id)
        return
    reg = get_registry()
    if _TAIL and _is_tail(root):
        reg.incr("disttrace.kept_tail")
    else:
        global _root_seq
        with _lock:
            _root_seq += 1
            kept = _root_seq % max(1, _SAMPLE_N) == 0
        if not kept:
            reg.incr("disttrace.dropped_sampled")
            drop(ctx.trace_id)
            return
        reg.incr("disttrace.kept_sampled")
    _export_spool(ctx.trace_id)


# -- stitching -------------------------------------------------------------


def stitch(trace_id: str, include_spool: bool = True) -> dict | None:
    """One trace's waterfall: the store's records and the spool's, one a
    span id, built into trees by parent id (a record whose parent is
    missing is a root), children in start order. None for a trace neither
    holds."""
    t0 = time.perf_counter()
    spans = spans_for(trace_id)
    seen = {r["span_id"] for r in spans}
    if include_spool:
        from .aggregate import read_span_spool

        for rec in read_span_spool(trace_id=trace_id):
            sid = rec.get("span_id")
            if sid and sid not in seen:
                spans.append(rec)
                seen.add(sid)
    if not spans:
        return None
    by_id = {r["span_id"]: dict(r, children=[]) for r in spans}
    roots = []
    for node in by_id.values():
        p = node.get("parent_id")
        if p and p in by_id:
            by_id[p]["children"].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        node["children"].sort(key=lambda c: c.get("start_ms", 0.0))
    roots.sort(key=lambda r: r.get("start_ms", 0.0))
    start = min(r.get("start_ms", 0.0) for r in spans)
    end = max(r.get("start_ms", 0.0) + r.get("dur_ms", 0.0)
              for r in spans)
    reg = get_registry()
    reg.incr("disttrace.stitched")
    reg.observe("disttrace.stitch", time.perf_counter() - t0)
    return {"trace_id": trace_id, "span_count": len(spans),
            "start_ms": start, "dur_ms": round(end - start, 3),
            "services": sorted({r.get("service", "?") for r in spans}),
            "roots": roots}


# -- the SLO burn-rate tracker ---------------------------------------------

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
    past the threshold) counts `slo.burn_breach` and writes a flight
    record of the snapshot."""
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
        flight_dump("slo_burn_breach",
                    extra=lambda: {"slo": slo_snapshot()})
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


# -- lifecycle -------------------------------------------------------------


def reset() -> None:
    """Drop every trace and both SLO windows and restore the env-derived
    config (the tests' isolation, through obs.reset_all)."""
    global _ENABLED, _TAIL, _SAMPLE_N, _SLO_MS, _MAX_TRACES, _SERVICE
    global _SLO_TARGET, _BURN_THRESHOLD, _MIN_SAMPLES
    global _root_seq, _breached
    with _lock:
        _STORE.clear()
        _root_seq = 0
    with _slo_lock:
        _fast.events.clear()
        _fast.bad = 0
        _fast.horizon = 60.0
        _slow.events.clear()
        _slow.bad = 0
        _slow.horizon = 300.0
        _slo_levels.clear()
        _breached = False
    _ENABLED = envvars.get_bool("TPU_IR_DISTTRACE")
    _TAIL = envvars.get_bool("TPU_IR_TRACE_TAIL")
    _SAMPLE_N = envvars.get_int("TPU_IR_TRACE_SAMPLE")
    _SLO_MS = envvars.get_float("TPU_IR_SLO_P99_MS")
    _MAX_TRACES = 256
    _SERVICE = "proc"
    _SLO_TARGET = 0.99
    _BURN_THRESHOLD = 10.0
    _MIN_SAMPLES = 20


# every finished local root goes through _on_root_close (adding it twice
# adds it once; obs/__init__ imports this module for it)
_add_root_hook(_on_root_close)
