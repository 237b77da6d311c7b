"""Device-cost profiling: cold calls by signature, the dispatch split,
memory gauges (the port of `tpu_ir/obs/profiling.py`).

Three instruments, with `tpu_ir`'s public names and report shape:

- **Cold calls.** `profiled(label=)` wraps an entry point of the port
  (ops/scoring.py, ops/postings.py). Nothing in the port compiles per
  shape, so the first call of an abstract signature (each tensor's shape
  and dtype, the reprs of the statics) in a process takes a compile's
  place: it pays the kernel libraries' lazy load, the allocator's growth
  and each op's first use. It counts `compile.count`, puts its wall time
  into `compile.time` and a `dispatch.compile` span, and fills the
  per-signature ledger under `tpu_ir`'s keys (`compiles`,
  `total_compile_s`, `last_compile_s`, `trace_s`, `flops`,
  `bytes_accessed`). A kernel library built or loaded inside a profiled
  call (ops/_build.py) is that call's `dispatch.compile` span too. A
  profiled call made inside another is part of the outer one, as a jit
  called under a jit is in `tpu_ir`. With TPU_IR_PROFILE_COST, a
  label's cost function counts the signature's bytes and operations from
  its shapes alone (no device read); where the shapes do not fix the
  work it leaves None.
- **Recompiles.** A signature never compiles twice here; the port's
  recompile is `dispatch.unwarmed`, a coalesced dispatch outside the
  shapes the coalescer warmed (`note_unwarmed`). Those events feed
  `compile.recompiles`, `recompiles_last_60s` and the compile cache's
  `recompiles`; more than TPU_IR_PROFILE_RECOMPILE_LIMIT of one shape
  writes a rate-limited `recompile_storm` flight record.
- **Memory gauges.** `sample_memory()` reads the caching allocator's
  counters (`torch.cuda.memory_stats_as_nested_dict()`: allocated bytes
  now and at their peak) and the host RSS into the
  registry's gauges, after each dispatch and each upload, at most once
  per 50 ms. It reads the card only when CUDA is initialized already: a
  CLI process never initializes the card to report memory.

`dispatch.trace` is declared and stays empty: nothing traces in the
port. `TPU_IR_PROFILE=0` makes a profiled call one flag test and the raw
call.
"""

from __future__ import annotations

import collections
import functools
import sys
import threading
import time
import weakref

from .. import envvars
from .registry import get_registry
from .trace import record_span

_ENABLED = envvars.get_bool("TPU_IR_PROFILE")
_COST = envvars.get_bool("TPU_IR_PROFILE_COST")
_STORM_N = envvars.get_int("TPU_IR_PROFILE_RECOMPILE_LIMIT")


def configure(enabled: bool | None = None, cost: bool | None = None,
              recompile_limit: int | None = None) -> None:
    """Runtime overrides of the TPU_IR_PROFILE* variables."""
    global _ENABLED, _COST, _STORM_N
    if enabled is not None:
        _ENABLED = enabled
    if cost is not None:
        _COST = cost
    if recompile_limit is not None:
        _STORM_N = max(1, recompile_limit)


def enabled() -> bool:
    return _ENABLED


# -- signatures -------------------------------------------------------------


def _dtype_name(dtype) -> str:
    """numpy's and JAX's dtype names: 'float32', never 'torch.float32'."""
    name = str(dtype)
    return name[6:] if name.startswith("torch.") else name


def _sig_atom(a) -> tuple:
    shape = getattr(a, "shape", None)
    if shape is not None and hasattr(a, "dtype"):
        return ("arr", tuple(int(d) for d in shape), _dtype_name(a.dtype))
    atom = getattr(a, "signature_atom", None)
    if atom is not None:
        return atom            # a tensor bundle (ops/cold_tier.TierTable)
    if isinstance(a, (tuple, list)):
        return ("seq", tuple(_sig_atom(x) for x in a))
    return ("static", repr(a))


def signature_key(args: tuple, kwargs: dict) -> tuple:
    """The abstract signature of a call: (shape, dtype) of each array or
    tensor, a sequence's atoms in order, the repr of anything else.
    Hashable, and `tpu_ir`'s key on the same shapes and statics."""
    return (tuple(_sig_atom(a) for a in args),
            tuple((k, _sig_atom(kwargs[k])) for k in sorted(kwargs)))


def render_signature(sig: tuple) -> str:
    """A signature key as text ('float32[64,8], k=10')."""

    def one(atom) -> str:
        kind = atom[0]
        if kind == "arr":
            return f"{atom[2]}[{','.join(str(d) for d in atom[1])}]"
        if kind == "seq":
            return "(" + ", ".join(one(x) for x in atom[1]) + ")"
        return atom[1]

    args, kwargs = sig
    parts = [one(a) for a in args]
    parts += [f"{k}={one(v)}" for k, v in kwargs]
    return ", ".join(parts)


# -- the per-function ledger ------------------------------------------------

_tls = threading.local()
_store_lock = threading.Lock()
# label -> {"signatures": {sig_key: stats}, "compiles": n, "recompiles": n}
_functions: dict[str, dict] = {}
# monotonic times of recompile events (the /healthz 60 s window)
_recompile_ts: collections.deque = collections.deque(maxlen=4096)
# unwarmed dispatches by shape (rows, width, variant, scoring, k)
_unwarmed: dict[tuple, int] = {}
# every wrapper, so a reset forgets their signatures with the ledger
_wrappers: "weakref.WeakSet[Profiled]" = weakref.WeakSet()


def note_build(seconds: float) -> None:
    """A kernel library built or loaded on this thread (ops/_build.py):
    billed to the profiled call in flight, if there is one."""
    acc = getattr(_tls, "acc", None)
    if acc is not None:
        acc["build"] += seconds


def _record_cold(label: str, sig: tuple, wall_ns: int, build_s: float,
                 cost: dict | None) -> None:
    reg = get_registry()
    wall_s = wall_ns / 1e9
    record_span("dispatch.compile", wall_ns, fn=label, cold=True,
                build_s=round(build_s, 6))
    reg.incr("compile.count")
    reg.observe("compile.time", wall_s)
    with _store_lock:
        fn = _functions.setdefault(
            label, {"signatures": {}, "compiles": 0, "recompiles": 0})
        st = fn["signatures"].setdefault(sig, {
            "compiles": 0, "total_compile_s": 0.0, "last_compile_s": 0.0,
            "trace_s": 0.0, "flops": None, "bytes_accessed": None})
        st["compiles"] += 1
        st["total_compile_s"] = round(st["total_compile_s"] + wall_s, 6)
        st["last_compile_s"] = round(wall_s, 6)
        if cost:
            st.update(cost)
        fn["compiles"] += 1
        n_sigs = sum(len(f["signatures"]) for f in _functions.values())
    reg.set_gauge("compile.signatures", n_sigs)


def _record_build(label: str, build_s: float) -> None:
    """A library built or loaded inside a call of a signature seen
    before: its own compile span, and a compile.time observation."""
    record_span("dispatch.compile", int(build_s * 1e9), fn=label,
                cold=False, build_s=round(build_s, 6))
    get_registry().observe("compile.time", build_s)


class Profiled:
    """An entry point with cold-call observability; call it as the
    function it wraps. `cost(args, kwargs)` returns the signature's
    {"flops", "bytes_accessed"} (either None where the shapes do not fix
    it), or None."""

    def __init__(self, fn, label: str, cost=None):
        functools.update_wrapper(self, fn)
        self.label = label
        self._cost = cost
        self._seen: set = set()
        with _store_lock:
            _wrappers.add(self)

    def __call__(self, *args, **kwargs):
        if not _ENABLED or getattr(_tls, "acc", None) is not None:
            return self.__wrapped__(*args, **kwargs)
        # keyed once a call: an entry point takes a whole query block
        sig = signature_key(args, kwargs)
        _tls.acc = acc = {"build": 0.0}
        t0 = time.perf_counter_ns()
        try:
            out = self.__wrapped__(*args, **kwargs)
        finally:
            _tls.acc = None
        wall_ns = time.perf_counter_ns() - t0
        if sig in self._seen:
            if acc["build"]:
                _record_build(self.label, acc["build"])
            return out
        with _store_lock:
            first = sig not in self._seen
            self._seen.add(sig)
        if not first:                        # another thread's first call
            if acc["build"]:
                _record_build(self.label, acc["build"])
            return out
        cost = None
        if _COST and self._cost is not None:
            try:
                cost = self._cost(args, kwargs)
            except Exception:  # noqa: BLE001 — cost is garnish
                cost = None
        _record_cold(self.label, sig, wall_ns, acc["build"], cost)
        return out


def profiled(fn=None, *, label: str | None = None, cost=None):
    """Wrap an entry point with cold-call observability: `@profiled()`,
    `@profiled(label=..., cost=...)` or `profiled(fn)`. The label is
    `tpu_ir`'s name of the function (its `__name__` by default)."""
    if fn is None:
        return lambda f: profiled(f, label=label, cost=cost)
    return Profiled(fn, label or getattr(fn, "__name__", "<fn>"), cost)


# -- recompiles: the unwarmed dispatches ------------------------------------


def note_unwarmed(shape: tuple) -> None:
    """One coalesced dispatch outside the warmed shapes (`shape` = rows,
    width, variant, scoring, k): a recompile event. Past the limit for
    one shape, a rate-limited `recompile_storm` flight record."""
    if not _ENABLED:
        return
    with _store_lock:
        n = _unwarmed[shape] = _unwarmed.get(shape, 0) + 1
        _recompile_ts.append(time.monotonic())
    get_registry().incr("compile.recompiles")
    if n > _STORM_N:
        from .recorder import flight_dump

        rows, width, variant, scoring, k = shape
        flight_dump("recompile_storm", extra={
            "fn": "dispatch",
            "signature": f"int32[{rows},{width}], variant={variant!r}, "
                         f"scoring={scoring!r}, k={k}",
            "compiles": n,
            "limit": _STORM_N,
        })


# -- memory sampling --------------------------------------------------------


def _host_rss_bytes() -> int:
    """This process's resident set size from /proc, else the peak from
    getrusage (KiB on Linux, bytes on macOS)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak if sys.platform == "darwin" else peak * 1024
    except Exception:  # noqa: BLE001 — an exotic platform: no sample
        return 0


def _device_stats() -> dict | None:
    """(bytes allocated now, at their peak) on the current card, or None:
    on the CPU, and whenever CUDA is not initialized yet (reading the
    allocator must not bring the card up)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        # the allocator's counters as nested dicts: memory_stats() would
        # flatten and sort them in Python, most of a sample's time
        stats = torch.cuda.memory_stats_as_nested_dict()
        allocated = stats["allocated_bytes"]["all"]
    except Exception:  # noqa: BLE001 — stats are garnish
        return None
    return {"bytes_in_use": allocated.get("current", 0),
            "peak_bytes_in_use": allocated.get("peak", 0)}


_sample_lock = threading.Lock()
_last_sample = 0.0
SAMPLE_MIN_INTERVAL_S = 0.05


def sample_memory(min_interval_s: float | None = None) -> None:
    """One memory sample into the gauges (host.rss_bytes,
    host.peak_rss_bytes, device.bytes_in_use, device.peak_bytes), at most
    one per SAMPLE_MIN_INTERVAL_S (`min_interval_s=0` forces one). The
    card's peak is the allocator's own high-water mark, so a spike
    between samples still shows. A no-op with profiling off."""
    global _last_sample
    if not _ENABLED:
        return
    interval = (SAMPLE_MIN_INTERVAL_S if min_interval_s is None
                else min_interval_s)
    now = time.monotonic()
    with _sample_lock:
        if now - _last_sample < interval:
            return
        _last_sample = now
    reg = get_registry()
    rss = _host_rss_bytes()
    if rss:
        reg.set_gauge("host.rss_bytes", rss)
        reg.update_gauge_max("host.peak_rss_bytes", rss)
    stats = _device_stats()
    if stats is not None:
        reg.set_gauge("device.bytes_in_use", stats["bytes_in_use"])
        reg.update_gauge_max("device.peak_bytes", stats["peak_bytes_in_use"])


def memory_snapshot() -> dict:
    """Host RSS and the card's allocated bytes (None on the CPU or
    before CUDA is up): the flight header's and the report's `memory`."""
    return {"host_rss_bytes": _host_rss_bytes(), "device": _device_stats()}


# -- the report surfaces ----------------------------------------------------


def recompiles_last_60s(window_s: float = 60.0) -> int:
    """Recompile events in the trailing window (/healthz)."""
    cutoff = time.monotonic() - window_s
    with _store_lock:
        return sum(1 for ts in _recompile_ts if ts >= cutoff)


def compile_cache_snapshot() -> dict:
    """The ledger's totals for flight-record headers: functions,
    signatures, cold calls, recompiles (the unwarmed dispatches) and
    those of the last 60 s."""
    cutoff = time.monotonic() - 60.0
    with _store_lock:
        return {
            "functions": len(_functions),
            "signatures": sum(len(f["signatures"])
                              for f in _functions.values()),
            "compiles": sum(f["compiles"] for f in _functions.values()),
            "recompiles": sum(_unwarmed.values()),
            "recompiles_last_60s": sum(
                1 for ts in _recompile_ts if ts >= cutoff),
        }


def profile_report() -> dict:
    """The profiling view (`profile`, GET /profile), `tpu_ir`'s shape:
    each function's signatures with their cold calls and cost, the
    dispatch split's histograms (compile.time, dispatch.trace,
    dispatch.compile, dispatch.device, dispatch, kernel), the batching,
    pruning and cache sections, the gauges, the memory and the recompile
    window; plus `builds`, the kernel-build ledger (ops/_build.py).
    Per process: empty from a fresh command."""
    from ..ops._build import build_ledger

    reg = get_registry()
    snap = reg.snapshot()
    hists = snap.get("histograms", {})
    with _store_lock:
        functions = []
        for label in sorted(_functions):
            fn = _functions[label]
            sigs = [{"signature": render_signature(sig), **stats}
                    for sig, stats in fn["signatures"].items()]
            sigs.sort(key=lambda s: -s["total_compile_s"])
            functions.append({"name": label, "compiles": fn["compiles"],
                              "recompiles": fn["recompiles"],
                              "signatures": sigs})
    dispatch = {name: hists[name]
                for name in ("compile.time", "dispatch.trace",
                             "dispatch.compile", "dispatch.device",
                             "dispatch", "kernel")
                if name in hists}
    if "dispatch.trace" in dispatch:
        dispatch["dispatch.trace"] = dict(
            dispatch["dispatch.trace"],
            note="empty by design: nothing traces in the port")
    counters = snap["counters"]
    return {
        "enabled": _ENABLED,
        "functions": functions,
        "compile_counters": {
            "compile.count": counters.get("compile.count", 0),
            "compile.recompiles": counters.get("compile.recompiles", 0),
        },
        "recompiles_last_60s": recompiles_last_60s(),
        "dispatch": dispatch,
        "batching": {
            "batch.coalesced": counters.get("batch.coalesced", 0),
            "batch.solo_flush": counters.get("batch.solo_flush", 0),
            **{name: hists[name] for name in ("batch.occupancy",
                                              "batch.wait")
               if name in hists},
        },
        "pruning": {
            name: counters.get(name, 0)
            for name in ("prune.queries", "prune.queries_hot_free",
                         "prune.blocks_total", "prune.blocks_skip_hot",
                         "blockmax.blocks_considered",
                         "blockmax.blocks_masked",
                         "blockmax.saved_dispatches",
                         "blockmax.fallback_dispatches")
        },
        "cache": _cache_section(hists),
        "gauges": snap.get("gauges", {}),
        "memory": memory_snapshot(),
        "builds": build_ledger(),
    }


def _cache_section(hists: dict) -> dict:
    from ..serving.result_cache import cache_counters, live_caches

    out = dict(cache_counters())
    if "cache.lookup" in hists:
        out["cache.lookup"] = hists["cache.lookup"]
    out["caches"] = [c.snapshot() for c in live_caches()]
    return out


def reset_profile() -> None:
    """Forget the ledger, every wrapper's signatures, the unwarmed shapes
    and the recompile window (obs.reset_all): the ledger starts over, and
    the next call of each signature enters it as its first."""
    global _last_sample
    with _store_lock:
        _functions.clear()
        _recompile_ts.clear()
        _unwarmed.clear()
        for w in list(_wrappers):
            w._seen.clear()
    with _sample_lock:
        # the registry's reset zeroed the gauges: sample again at once
        _last_sample = 0.0
