"""Per-request span trees whose durations feed the latency histograms (the
part of `tpu_ir/obs/trace.py` serving needs).

`trace(name, **attrs)` is a context manager recording one span: its
duration, attrs, the exception that escaped it, and its child spans. A
thread-local stack builds the tree; the serving path's is request ->
(ladder, admission_wait, breaker, dispatch -> kernel*, fallback). Every
span's duration also lands in the registry's histogram of the same name,
so spans and latency distributions are one instrument. The port keeps no
ring of recent traces (no flight recorder yet).

`TPU_IR_TRACE=0` turns `trace()` into one flag test returning a shared
no-op. `attach(parent)` makes a span of another thread the current one,
so run_with_deadline's worker thread adds its kernel spans to the
request's tree. `kernel_annotation(name)` is a named region in a
`torch.profiler` capture (`torch.profiler.record_function`).
"""

from __future__ import annotations

import threading
import time

import torch

from .. import envvars
from . import disttrace
from .registry import get_registry

_tls = threading.local()
_ENABLED = envvars.get_bool("TPU_IR_TRACE")


def configure(enabled: bool | None = None) -> None:
    """Runtime override of TPU_IR_TRACE (tests)."""
    global _ENABLED
    if enabled is not None:
        _ENABLED = enabled


def enabled() -> bool:
    return _ENABLED


class Span:
    """One timed region; also the context manager that records it."""

    __slots__ = ("name", "attrs", "start_ns", "dur_ns", "children", "error",
                 "service")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        # the process's service identity (disttrace.set_service)
        self.service = disttrace.service()
        self.start_ns = 0
        self.dur_ns = 0
        self.children: list[Span] = []
        self.error: str | None = None

    def set(self, key: str, value) -> None:
        """Annotate the span (service level, breaker state, ...)."""
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
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
        return False


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


def current_span() -> Span | None:
    """This thread's innermost open span (None outside any span): the
    handle `attach()` takes."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


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


def kernel_annotation(name: str):
    """A named region around a kernel dispatch in a torch.profiler
    capture (record_function costs next to nothing without a profiler)."""
    return torch.profiler.record_function(name)
