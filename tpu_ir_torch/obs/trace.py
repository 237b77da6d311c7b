"""Per-request span trees whose durations feed the latency histograms, and
a bounded ring of the latest finished trees (the port of
`tpu_ir/obs/trace.py`).

`trace(name, **attrs)` is a context manager recording one span: its
duration, attrs, the exception that escaped it, and its child spans. A
thread-local stack builds the tree; the serving path's is request ->
(ladder, admission_wait, breaker, dispatch -> kernel*, fallback). Every
span's duration also lands in the registry's histogram of the same name,
so spans and latency distributions are one instrument.

A finished ROOT span goes first to every root-close hook (`add_root_hook`:
obs/disttrace.py turns the tree into span records under the request's
trace context; a hook sees every root, before any sampling, and one that
raises never fails the request), then into the ring (`recent_traces`),
every TPU_IR_TRACE_SAMPLE-th root only (TPU_IR_TRACE_RING of them).

`TPU_IR_TRACE=0` turns `trace()` into one flag test returning a shared
no-op. `attach(parent)` makes a span of another thread the current one,
so run_with_deadline's worker thread adds its kernel spans to the
request's tree. `kernel_annotation(name)` is a named region in a
`torch.profiler` capture (`torch.profiler.record_function`).
"""

from __future__ import annotations

import collections
import threading
import time

import torch

from .. import envvars
from .registry import get_registry

_tls = threading.local()
_ring_lock = threading.Lock()

_ENABLED = envvars.get_bool("TPU_IR_TRACE")
_SAMPLE_N = envvars.get_int("TPU_IR_TRACE_SAMPLE")
_RING = collections.deque(maxlen=envvars.get_int("TPU_IR_TRACE_RING"))
_root_seq = 0
# fired with every finished root span, before the ring's sampling: a
# subscriber applies its own keep/drop rule to all of them
_root_hooks: list = []


def configure(enabled: bool | None = None, sample: int | None = None,
              ring_capacity: int | None = None) -> None:
    """Runtime overrides of TPU_IR_TRACE, TPU_IR_TRACE_SAMPLE and
    TPU_IR_TRACE_RING (tests)."""
    global _ENABLED, _SAMPLE_N, _RING
    if enabled is not None:
        _ENABLED = enabled
    if sample is not None:
        _SAMPLE_N = max(1, sample)
    if ring_capacity is not None:
        with _ring_lock:
            _RING = collections.deque(_RING, maxlen=max(1, ring_capacity))


def enabled() -> bool:
    return _ENABLED


class Span:
    """One timed region; also the context manager that records it."""

    __slots__ = ("name", "attrs", "start_ns", "dur_ns", "thread_id",
                 "thread_name", "wall_time", "children", "error",
                 "_is_root")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.start_ns = 0
        self.dur_ns = 0
        t = threading.current_thread()
        self.thread_id = t.ident or 0
        self.thread_name = t.name
        self.wall_time = 0.0
        self.children: list[Span] = []
        self.error: str | None = None
        self._is_root = False

    def set(self, key: str, value) -> None:
        """Annotate the span (service level, breaker state, ...)."""
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._is_root = not stack
        if self._is_root:
            self.wall_time = time.time()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.dur_ns = time.perf_counter_ns() - self.start_ns
        if exc is not None:
            self.error = repr(exc)
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        if stack:
            stack[-1].children.append(self)
        get_registry().observe(self.name, self.dur_ns / 1e9)
        if self._is_root:
            _push_root(self)
        return False

    def to_dict(self) -> dict:
        """The tree as JSON-ready dicts. The child and attr containers are
        copied first: an abandoned deadline thread may still append to a
        parent that is being serialized."""
        out = {
            "name": self.name,
            "start_ns": self.start_ns,
            "dur_us": round(self.dur_ns / 1e3, 3),
            "thread_id": self.thread_id,
            "thread": self.thread_name,
        }
        attrs = dict(self.attrs)
        if attrs:
            out["attrs"] = attrs
        if self.error is not None:
            out["error"] = self.error
        if self.wall_time:
            out["time"] = time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.localtime(self.wall_time))
        children = tuple(self.children)
        if children:
            out["children"] = [c.to_dict() for c in children]
        return out


class _NullSpan:
    """The disabled-tracing singleton: enter, exit and set do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):
        pass


_NULL = _NullSpan()


def trace(name: str, **attrs):
    """Open a span (a context manager); with tracing off, one flag test
    and a shared no-op."""
    if not _ENABLED:
        return _NULL
    return Span(name, attrs)


def record_span(name: str, dur_ns: int, **attrs) -> None:
    """Record a region timed elsewhere as a finished child of this
    thread's current span (a root of its own outside any), with the
    histogram observation of the same name; with tracing off, one flag
    test."""
    if not _ENABLED:
        return
    get_registry().observe(name, dur_ns / 1e9)
    span = Span(name, attrs)
    span.dur_ns = int(dur_ns)
    span.start_ns = time.perf_counter_ns() - span.dur_ns
    stack = getattr(_tls, "stack", None)
    if stack:
        stack[-1].children.append(span)
    else:
        _push_root(span)


def current_span() -> Span | None:
    """This thread's innermost open span (None outside any span): the
    handle `attach()` takes."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def current_root() -> Span | None:
    """This thread's outermost open span: the request still in flight."""
    stack = getattr(_tls, "stack", None)
    return stack[0] if stack else None


class _Attach:
    __slots__ = ("_parent", "_saved")

    def __init__(self, parent):
        self._parent = parent
        self._saved = None

    def __enter__(self):
        self._saved = getattr(_tls, "stack", None)
        _tls.stack = [self._parent] if self._parent is not None else []
        return self

    def __exit__(self, *exc):
        _tls.stack = self._saved if self._saved is not None else []
        return False


def attach(parent: Span | None):
    """Make `parent` (a span of another thread) the current span on this
    thread: spans opened inside become its children. attach(None) only
    isolates."""
    return _Attach(parent)


def add_root_hook(fn) -> None:
    """Call `fn(span)` with every finished root span, before the ring's
    sampling; adding the same callable twice adds it once."""
    if fn not in _root_hooks:
        _root_hooks.append(fn)


def remove_root_hook(fn) -> None:
    if fn in _root_hooks:
        _root_hooks.remove(fn)


def _push_root(span: Span) -> None:
    global _root_seq
    for hook in tuple(_root_hooks):
        try:
            hook(span)
        except Exception:  # noqa: BLE001 — a hook's fault must not fail
            pass           # the request whose root just closed
    with _ring_lock:
        _root_seq += 1
        if _root_seq % _SAMPLE_N == 0:
            _RING.append(span)


def recent_traces() -> list[Span]:
    """The ring's finished root spans, oldest first."""
    with _ring_lock:
        return list(_RING)


def clear_traces() -> None:
    with _ring_lock:
        _RING.clear()


def kernel_annotation(name: str):
    """A named region around a kernel dispatch in a torch.profiler
    capture (record_function costs next to nothing without a profiler)."""
    return torch.profiler.record_function(name)
