"""The telemetry time machine: a fixed-memory, multi-resolution history
of the registry (the port of `tpu_ir/obs/timeseries.py`).

Every other telemetry surface is an instant or a delta: /metrics the
current cumulative state, /healthz a point in time, a bench report one
run's aggregate. Here a background sampler snapshots the registry every
TPU_IR_TS_SAMPLE_S seconds and keeps the window deltas in ring tiers, so
"what did the routed p99, the occupancy or the cache-hit rate look like
over the last hour, and is now anomalous?" has an answer whose memory is
bounded however long the process lives.

- **A window holds raw materials, never derived values**: counter
  deltas, gauge levels, histogram bucket deltas. Rates and percentiles
  are read from the raw window, so downsampling is exact: merging K fine
  windows equals sampling the coarse window directly.
- **Two merge directions**: in time (a fine tier into a coarse one, one
  process) the durations add; across processes (the spool's cluster
  view) the same wall window's deltas add and the duration is the
  longest, so cluster throughput is the sum of the processes' rates.
- **Fixed memory**: only the curated series (CURATED) are kept, each
  tier is a bounded deque, the rollup staging is bounded by the tier
  factors; `ring_limits()` states the bound.

Two consumers ride on the store. `detect_anomalies()` scores each
curated series' newest point against its history with a robust MAD
z-score and writes a rate-limited `anomaly` flight record. `Forecaster`
fits a sinusoid (a period scan, then a linear phase and offset solve)
over the occupancy series and publishes `forecast_occupancy`, the level
it predicts TPU_IR_SCALE_LEAD_S ahead: the autoscaler's third scale-up
signal (serving/autoscale.py), which run_distributed_soak drives when
its autoscaler's config arms it.

The arithmetic is `tpu_ir`'s, in its order (the left fold of a
histogram's seconds in `_merge`, the sums of `fit_sinusoid` and
`_best_period`, the percentile read), so a window, a fit and a prediction
equal `tpu_ir`'s to the bit; the spool files are `tpu_ir`'s, so either
package's cluster view reads the other's.
"""

from __future__ import annotations

import json
import math
import os
import socket
import threading
import time
from collections import deque

from .. import envvars
from .histogram import NUM_BUCKETS, percentile_from_counts
from .registry import GAUGE_MERGE, get_registry

# ---------------------------------------------------------------------------
# curated series
# ---------------------------------------------------------------------------

# (label, kind, source, anomaly_floor) — kind selects the read-time
# conversion: "rate" = counter delta / window seconds, "gauge" = level,
# "p50"/"p95"/"p99" = percentile from the window's bucket deltas (ms).
# anomaly_floor is the minimum deviation scale the MAD z-score divides
# by, in the series' own units — it keeps a near-constant series (MAD
# ~= 0) from turning ordinary jitter into infinite z.
CURATED = (
    ("submitted_per_s", "rate", "serving.submitted", 1.0),
    ("routed_per_s", "rate", "router.requests", 1.0),
    ("shed_per_s", "rate", "router.shed", 1.0),
    ("cache_hit_per_s", "rate", "cache.hit", 1.0),
    ("request_p50_ms", "p50", "request", 2.0),
    ("request_p99_ms", "p99", "request", 5.0),
    ("routed_p99_ms", "p99", "router.request", 5.0),
    ("occupancy", "gauge", "router.occupancy", 0.1),
    ("forecast_occupancy", "gauge", "forecast_occupancy", 0.1),
    ("slo_burn_fast", "gauge", "slo.burn_fast", 0.25),
)

_WATCH_COUNTERS = tuple(sorted({s for _, k, s, _ in CURATED
                                if k == "rate"}))
_WATCH_GAUGES = tuple(sorted({s for _, k, s, _ in CURATED
                              if k == "gauge"}))
_WATCH_HISTS = tuple(sorted({s for _, k, s, _ in CURATED
                             if k in ("p50", "p95", "p99")}))

# tier i rolls up FACTORS[i] base samples per window and retains
# CAPACITIES[i] windows. At the default 10 s sample period that is
# 10s x 360 (1 h), 1m x 240 (4 h), 10m x 144 (24 h).
DEFAULT_TIERS = ((1, 360), (6, 240), (60, 144))

_MIN_ANOMALY_POINTS = 12


def _sample_s() -> float:
    return envvars.get_float("TPU_IR_TS_SAMPLE_S")


def enabled() -> bool:
    return envvars.get_bool("TPU_IR_TIMESERIES")


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------


def _merge(windows, *, across: bool):
    """Fold windows into one. across=False is temporal downsampling
    (durations sum); across=True is the cluster fold of the same wall
    window on N processes (duration is the max). Everything else is
    identical: counter deltas and bucket counts add, gauges fold by
    their declared GAUGE_MERGE policy in end-time order."""
    ws = sorted(windows, key=lambda w: w["t"])
    out = {"t": ws[-1]["t"],
           "dur_s": (max(w["dur_s"] for w in ws) if across
                     else sum(w["dur_s"] for w in ws)),
           "c": {}, "g": {}, "h": {}}
    for w in ws:
        for name, delta in w["c"].items():
            out["c"][name] = out["c"].get(name, 0) + delta
        for name, level in w["g"].items():
            if GAUGE_MERGE.get(name) == "max" and name in out["g"]:
                out["g"][name] = max(out["g"][name], level)
            else:
                out["g"][name] = level       # "last": newest wins
        for name, (counts, sum_s) in w["h"].items():
            if name in out["h"]:
                have, have_s = out["h"][name]
                out["h"][name] = ([a + b for a, b in zip(have, counts)],
                                  have_s + sum_s)
            else:
                out["h"][name] = (list(counts), sum_s)
    return out


def merge_windows(windows):
    """Downsample: merge consecutive fine-tier windows into one coarse
    window. Exact by construction — see the module docstring."""
    return _merge(windows, across=False)


def merge_windows_across(windows):
    """Cluster fold: merge the same wall window observed by N
    processes (deltas add, the duration does not)."""
    return _merge(windows, across=True)


def window_value(window, kind: str, source: str):
    """Read one curated value out of a raw window; None when the
    window never saw that series (absent gauge, empty histogram)."""
    if kind == "rate":
        dur = window["dur_s"]
        return window["c"].get(source, 0) / dur if dur > 0 else None
    if kind == "gauge":
        return window["g"].get(source)
    ent = window["h"].get(source)
    if ent is None or sum(ent[0]) == 0:
        return None
    q = {"p50": 0.50, "p95": 0.95, "p99": 0.99}[kind]
    sec = percentile_from_counts(list(ent[0]), q)
    return None if sec is None else sec * 1000.0


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


class TimeseriesStore:
    """Ring-tiered window store. add_window() appends one base-rate
    window to tier 0 and cascades exact rollups into the coarser
    tiers; sample() builds that window by diffing the registry's raw
    collect_state() against the previous sample."""

    def __init__(self, tiers=DEFAULT_TIERS, sample_s: float | None = None):
        factors = [int(f) for f, _ in tiers]
        if factors[0] != 1:
            raise ValueError("tier 0 must have factor 1")
        for a, b in zip(factors, factors[1:]):
            if b % a != 0 or b <= a:
                raise ValueError(f"tier factors must nest: {factors}")
        self._tiers = tuple((int(f), int(c)) for f, c in tiers)
        self._rings = [deque(maxlen=c) for _, c in self._tiers]
        # staging buffer feeding tier k+1: holds tier-k windows until
        # factor[k+1]/factor[k] of them merge into one coarse window
        self._pending = [[] for _ in self._tiers]
        self._sample_s = float(sample_s if sample_s is not None
                               else _sample_s())
        self._prev = None            # last raw collect_state
        self._prev_t = None
        self._lock = threading.Lock()
        self._anomalies = deque(maxlen=32)
        self.last_fit = None         # newest Forecaster fit, if any

    # -- ingest ------------------------------------------------------------

    def add_window(self, window) -> None:
        reg = get_registry()
        with self._lock:
            self._rings[0].append(window)
            carry = window
            for k in range(1, len(self._tiers)):
                self._pending[k].append(carry)
                need = self._tiers[k][0] // self._tiers[k - 1][0]
                if len(self._pending[k]) < need:
                    break
                carry = merge_windows(self._pending[k])
                self._pending[k] = []
                self._rings[k].append(carry)
                reg.incr("timeseries.rollups")
            else:
                return

    def sample(self, now: float | None = None) -> dict | None:
        """Take one base-rate window: diff the registry's raw state
        against the previous sample. The first sample (and any sample
        straddling a registry reset or a process restart) only
        re-baselines — a delta against a zeroed or foreign baseline
        would be garbage."""
        reg = get_registry()
        now = time.time() if now is None else now
        state = reg.collect_state(reset=False)
        with self._lock:
            prev, prev_t = self._prev, self._prev_t
            self._prev, self._prev_t = state, now
            rebase = (prev is None
                      or state["resets"] != prev["resets"]
                      or state["run_id"] != prev["run_id"])
        if rebase:
            return None
        window = {"t": now, "dur_s": max(now - prev_t, 1e-9),
                  "c": {}, "g": {}, "h": {}}
        pc = prev["counters"]
        for name in _WATCH_COUNTERS:
            delta = state["counters"].get(name, 0) - pc.get(name, 0)
            if delta > 0:
                window["c"][name] = delta
        for name in _WATCH_GAUGES:
            if name in state["gauges"]:
                window["g"][name] = state["gauges"][name]
        ph = prev["histograms"]
        for name in _WATCH_HISTS:
            ent = state["histograms"].get(name)
            if ent is None:
                continue
            was = ph.get(name, {"counts": [0] * NUM_BUCKETS, "sum_s": 0.0})
            counts = [max(a - b, 0) for a, b in
                      zip(ent["counts"], was["counts"])]
            if sum(counts) > 0:
                window["h"][name] = (counts,
                                     max(ent["sum_s"] - was["sum_s"], 0.0))
        self.add_window(window)
        reg.incr("timeseries.samples")
        return window

    def reset(self) -> None:
        with self._lock:
            for ring in self._rings:
                ring.clear()
            self._pending = [[] for _ in self._tiers]
            self._prev = self._prev_t = None
            self._anomalies.clear()
            self.last_fit = None

    # -- read --------------------------------------------------------------

    def windows(self, tier: int = 0):
        with self._lock:
            return list(self._rings[tier])

    def points(self, kind: str, source: str, tier: int = 0,
               since: float | None = None):
        """[(end_time, value)] for one curated series on one tier;
        windows that never saw the series are skipped."""
        out = []
        for w in self.windows(tier):
            if since is not None and w["t"] < since:
                continue
            v = window_value(w, kind, source)
            if v is not None:
                out.append((w["t"], v))
        return out

    def tier_layout(self):
        return [{"tier": i, "factor": f, "capacity": c,
                 "window_s": self._sample_s * f,
                 "len": len(self._rings[i])}
                for i, (f, c) in enumerate(self._tiers)]

    def ring_limits(self) -> dict:
        """The declared memory bound: total retained windows can never
        exceed sum(capacity) + sum(rollup staging), independent of how
        long the process has been alive."""
        factors = [f for f, _ in self._tiers]
        staging = sum(b // a - 1 for a, b in zip(factors, factors[1:]))
        return {"max_windows": sum(c for _, c in self._tiers) + staging,
                "tiers": len(self._tiers)}

    def state(self) -> dict:
        """Serializable form — the spool exchange unit and the
        footprint the bounded-memory test measures."""
        with self._lock:
            return {
                "sample_s": self._sample_s,
                "tiers": [[f, c] for f, c in self._tiers],
                "rings": [[_window_wire(w) for w in ring]
                          for ring in self._rings],
                "pending": [[_window_wire(w) for w in pend]
                            for pend in self._pending],
            }

    # -- anomaly + surfacing ----------------------------------------------

    def detect_anomalies(self, tier: int = 0, *, z_threshold=None,
                         flight: bool = True):
        """MAD z-score of each curated series' newest point against
        its same-tier history. Returns the detections; each one bumps
        ``timeseries.anomaly`` and (rate-limited per the recorder's
        per-reason interval) writes an ``anomaly`` flight record."""
        z_max = (envvars.get_float("TPU_IR_TS_ANOMALY_Z")
                 if z_threshold is None else float(z_threshold))
        if z_max <= 0:
            return []
        found = []
        for label, kind, source, floor in CURATED:
            pts = self.points(kind, source, tier)
            if len(pts) < _MIN_ANOMALY_POINTS:
                continue
            history = [v for _, v in pts[:-1]]
            t_last, latest = pts[-1]
            med = _median(history)
            mad = _median([abs(v - med) for v in history])
            # 0.6745 rescales MAD to a stddev-equivalent for a normal
            # population; the floor keeps a flat series from alarming
            scale = max(mad / 0.6745, 0.05 * abs(med), floor)
            z = (latest - med) / scale
            if abs(z) < z_max:
                continue
            rec = {"series": label, "tier": tier, "t": t_last,
                   "value": round(latest, 4), "median": round(med, 4),
                   "z": round(z, 2)}
            found.append(rec)
            get_registry().incr("timeseries.anomaly")
            with self._lock:
                self._anomalies.append(rec)
            if flight:
                from .recorder import flight_dump
                flight_dump("anomaly", extra={"anomaly": rec})
        return found

    def recent_anomalies(self):
        with self._lock:
            return list(self._anomalies)


def _window_wire(w):
    return {"t": w["t"], "dur_s": w["dur_s"], "c": dict(w["c"]),
            "g": dict(w["g"]),
            "h": {n: [list(c), s] for n, (c, s) in w["h"].items()}}


def _window_unwire(w):
    return {"t": w["t"], "dur_s": w["dur_s"], "c": dict(w["c"]),
            "g": dict(w["g"]),
            "h": {n: (list(ent[0]), ent[1])
                  for n, ent in w["h"].items()}}


def _median(values):
    vs = sorted(values)
    n = len(vs)
    mid = n // 2
    return vs[mid] if n % 2 else 0.5 * (vs[mid - 1] + vs[mid])


# ---------------------------------------------------------------------------
# the diurnal forecaster
# ---------------------------------------------------------------------------


class Forecaster:
    """Sinusoid phase/period fit over a gauge series, publishing the
    predicted level lead_s ahead as the ``forecast_occupancy`` gauge.

    The fit scans candidate periods and solves the linear
    [sin, cos, 1] least squares per candidate — amplitude, phase, and
    mean drop out of the best-residual winner. A quality gate (r2 and
    amplitude floors) keeps a flat or noisy series from publishing a
    confident forecast: below the gate the gauge falls back to the
    current level, which makes the forecast signal degrade to exactly
    the reactive signal, never something worse."""

    def __init__(self, store, lead_s: float | None = None,
                 interval_s: float | None = None,
                 series: str = "router.occupancy",
                 sample: bool = False):
        self.store = store
        self.lead_s = (envvars.get_float("TPU_IR_SCALE_LEAD_S")
                       if lead_s is None else float(lead_s))
        self.interval_s = (max(0.05, self.lead_s / 4.0)
                           if interval_s is None else float(interval_s))
        self.series = series
        self.sample = sample     # drive store.sample() from poll()
        self._t0 = None          # ignore windows older than first poll
        self._last = -1e18

    def poll(self, now: float | None = None) -> float | None:
        """Refit if due; returns the published forecast (None when not
        due or below the quality gate)."""
        now = time.time() if now is None else now
        if self._t0 is None:
            self._t0 = now
        if now - self._last < self.interval_s:
            return None
        self._last = now
        if self.sample:
            self.store.sample(now=now)
        pts = self.store.points("gauge", self.series, tier=0,
                                since=self._t0)
        fit = fit_sinusoid(pts)
        reg = get_registry()
        if fit is None:
            if pts:          # degrade to reactive: forecast = current
                reg.set_gauge("forecast_occupancy", pts[-1][1])
            return None
        value = max(0.0, predict(fit, now + self.lead_s))
        fit["lead_s"] = self.lead_s
        fit["forecast"] = round(value, 4)
        self.store.last_fit = fit
        reg.set_gauge("forecast_occupancy", value)
        reg.incr("forecast.fits")
        return value


def fit_sinusoid(points, min_r2: float = 0.25,
                 min_amplitude: float = 0.05) -> dict | None:
    """Least-squares sinusoid over [(t, v)]: scan candidate periods,
    solve mean + a sin(wt) + b cos(wt) per candidate, keep the lowest
    residual. Returns None below the quality gate (not enough points,
    weak fit, or negligible amplitude)."""
    if len(points) < 8:
        return None
    t0 = points[0][0]
    ts = [t - t0 for t, _ in points]
    vs = [v for _, v in points]
    span = ts[-1]
    if span <= 0:
        return None
    mean = sum(vs) / len(vs)
    var = sum((v - mean) ** 2 for v in vs)
    if var <= 0:
        return None
    dt = span / (len(ts) - 1)
    best = None
    # periods from a few samples up to 4x the observed span: less than
    # one full cycle of history still locks phase on a clean sinusoid.
    # Coarse geometric scan first, then a fine scan around the winner.
    p = max(4.0 * dt, 1e-6)
    periods = []
    while p <= span * 4.0:
        periods.append(p)
        p *= 1.25
    for refine in range(2):
        if refine:
            if best is None:
                return None
            center = best[1]
            periods = [center * (0.8 + 0.02 * i) for i in range(21)]
        best = _best_period(ts, vs, mean, periods, best)
    if best is None:
        return None
    resid, period, a, b = best
    r2 = 1.0 - resid / var
    amplitude = math.hypot(a, b)
    if r2 < min_r2 or amplitude < min_amplitude:
        return None
    return {"period_s": round(period, 4), "a": a, "b": b,
            "mean": mean, "t0": t0,
            "amplitude": round(amplitude, 4), "r2": round(r2, 4)}


def _best_period(ts, vs, mean, periods, best):
    for period in periods:
        w = 2.0 * math.pi / period
        sa = ca = saa = cca = sca = sv = cv = 0.0
        for t, v in zip(ts, vs):
            s, c = math.sin(w * t), math.cos(w * t)
            sa += s
            ca += c
            saa += s * s
            cca += c * c
            sca += s * c
            sv += s * (v - mean)
            cv += c * (v - mean)
        n = float(len(ts))
        # normal equations for v - mean ~= a*sin + b*cos (centered)
        m11, m12, m22 = saa - sa * sa / n, sca - sa * ca / n, \
            cca - ca * ca / n
        det = m11 * m22 - m12 * m12
        if abs(det) < 1e-12:
            continue
        r1 = sv - sa * sum(v - mean for v in vs) / n
        r2_ = cv - ca * sum(v - mean for v in vs) / n
        a = (r1 * m22 - r2_ * m12) / det
        b = (r2_ * m11 - r1 * m12) / det
        resid = sum((v - mean - a * math.sin(w * t)
                     - b * math.cos(w * t)) ** 2
                    for t, v in zip(ts, vs))
        if best is None or resid < best[0]:
            best = (resid, period, a, b)
    return best


def predict(fit: dict, t: float) -> float:
    w = 2.0 * math.pi / fit["period_s"]
    dt = t - fit["t0"]
    return (fit["mean"] + fit["a"] * math.sin(w * dt)
            + fit["b"] * math.cos(w * dt))


# ---------------------------------------------------------------------------
# the background sampler
# ---------------------------------------------------------------------------


class TimeseriesSampler:
    """The background sampler: one store.sample() and one anomaly sweep
    an interval, on a daemon thread named under the "tpu-ir-obs" prefix
    (aggregate.SpoolWriter's discipline); stop() wakes it at once and
    takes a last sample, so a shutdown never loses the last window."""

    def __init__(self, store=None, interval_s: float | None = None):
        self.store = store if store is not None else get_store()
        self.interval_s = float(interval_s if interval_s is not None
                                else _sample_s())
        self._stop = threading.Event()
        self._thread = None

    def start(self) -> "TimeseriesSampler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="tpu-ir-obs-timeseries",
                daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.store.sample()
                self.store.detect_anomalies()
            except Exception:  # noqa: BLE001 — sampling must not die
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self.store.sample()
        except Exception:  # noqa: BLE001
            pass


# ---------------------------------------------------------------------------
# process-global store + refcounted sampler (MetricsServer lifecycle)
# ---------------------------------------------------------------------------

_lock = threading.RLock()   # ensure_sampler -> get_store re-enters
_store: TimeseriesStore | None = None
_sampler: TimeseriesSampler | None = None
_sampler_refs = 0


def get_store() -> TimeseriesStore:
    global _store
    with _lock:
        if _store is None:
            _store = TimeseriesStore()
        return _store


def ensure_sampler() -> TimeseriesSampler | None:
    """Take one reference on the process's sampler, starting it on the
    first: each MetricsServer.start() holds one, and the thread stops
    when the last server releases its own. None (and no thread) when
    TPU_IR_TIMESERIES=0."""
    global _sampler, _sampler_refs
    if not enabled():
        return None
    with _lock:
        _sampler_refs += 1
        if _sampler is None:
            _sampler = TimeseriesSampler(store=None).start()
        return _sampler


def release_sampler() -> None:
    global _sampler, _sampler_refs
    with _lock:
        if _sampler_refs > 0:
            _sampler_refs -= 1
        sampler, done = _sampler, _sampler_refs == 0
        if done:
            _sampler = None
    if done and sampler is not None:
        sampler.stop()


def reset() -> None:
    """obs.reset_all()'s hook: drop the history and the baselines, and
    keep a running sampler (its servers own it)."""
    global _store
    with _lock:
        store = _store
    if store is not None:
        store.reset()


# ---------------------------------------------------------------------------
# surfaces: /timeseries payload, flight header, cluster spool
# ---------------------------------------------------------------------------


def payload(cluster: bool = False) -> dict:
    """The /timeseries JSON: tier layout, every curated series as
    [t, value] points per tier, recent anomalies, and the newest
    forecast fit. cluster=True folds the spooled per-process stores
    into the local one first (deltas add, durations don't)."""
    if not enabled():
        return {"enabled": False}
    store = get_store()
    rings = [store.windows(i) for i in range(len(store.tier_layout()))]
    sources = 1
    if cluster:
        rings, sources = _cluster_rings(store, rings)
    series = {}
    for label, kind, source, _ in CURATED:
        tiers = []
        for ring in rings:
            pts = []
            for w in ring:
                v = window_value(w, kind, source)
                if v is not None:
                    pts.append([round(w["t"], 3), round(v, 4)])
            tiers.append(pts)
        series[label] = {"kind": kind, "source": source, "tiers": tiers}
    return {"enabled": True,
            "cluster": bool(cluster), "sources": sources,
            "tiers": store.tier_layout(),
            "ring_limits": store.ring_limits(),
            "series": series,
            "anomalies": store.recent_anomalies(),
            "forecast": store.last_fit}


def header_window(limit: int = 32) -> dict | None:
    """The flight-record header section: the last-N tier-0 points per
    curated series, so every post-mortem ships its own lead-up."""
    if not enabled():
        return None
    store = get_store()
    out = {}
    for label, kind, source, _ in CURATED:
        pts = store.points(kind, source, tier=0)[-limit:]
        if pts:
            out[label] = [[round(t, 3), round(v, 4)] for t, v in pts]
    if not out:
        return None
    return {"window_s": store.tier_layout()[0]["window_s"],
            "series": out}


def _spool_path(out_dir: str) -> str:
    host = socket.gethostname().replace("/", "_") or "host"
    return os.path.join(out_dir, f"timeseries-{host}-{os.getpid()}.json")


def spool_write_store(out_dir: str | None = None) -> str | None:
    """This process's store as one spool file, overwritten each time
    (the newest state wins), beside the cumulative snapshots;
    aggregate.SpoolWriter calls it on the same cadence. Never raises."""
    from .aggregate import spool_dir
    d = out_dir or spool_dir()
    if d is None or not enabled():
        return None
    try:
        os.makedirs(d, exist_ok=True)
        path = _spool_path(d)
        doc = {"run_id": get_registry().run_id, "pid": os.getpid(),
               "host": socket.gethostname(), "time": time.time(),
               "store": get_store().state()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path
    except Exception:  # noqa: BLE001 — spooling is best-effort
        return None


def read_spool_stores(out_dir: str | None = None) -> list:
    from .aggregate import spool_dir
    d = out_dir or spool_dir()
    if d is None or not os.path.isdir(d):
        return []
    docs = []
    for name in sorted(os.listdir(d)):
        if not (name.startswith("timeseries-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                docs.append(json.load(f))
        except Exception:  # noqa: BLE001 — torn write mid-replace
            continue
    return docs


def _cluster_rings(store, rings):
    """Fold spooled per-process rings into the local ones: windows
    aligning on the same nominal wall bucket merge across processes."""
    my_run = get_registry().run_id
    layout = store.tier_layout()
    buckets = [dict() for _ in layout]
    sources = 1
    for tier, ring in enumerate(rings):
        win_s = max(layout[tier]["window_s"], 1e-9)
        for w in ring:
            buckets[tier].setdefault(round(w["t"] / win_s), []).append(w)
    for doc in read_spool_stores():
        if doc.get("run_id") == my_run:
            continue                      # the local store, spooled
        sources += 1
        for tier, ring in enumerate(doc.get("store", {}).get("rings", [])):
            if tier >= len(buckets):
                break
            win_s = max(layout[tier]["window_s"], 1e-9)
            for wire in ring:
                w = _window_unwire(wire)
                buckets[tier].setdefault(
                    round(w["t"] / win_s), []).append(w)
    merged = []
    for tier_buckets in buckets:
        merged.append([merge_windows_across(ws)
                       for _, ws in sorted(tier_buckets.items())])
    return merged, sources
