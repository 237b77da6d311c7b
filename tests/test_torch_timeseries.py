"""The port's telemetry time machine (tpu_ir_torch/obs/timeseries.py) held
against `tpu_ir`'s on the CPU, after tests/test_timeseries.py.

The same seeded windows go through both packages, and what comes out is
compared bitwise (dict equality of the same floats; no tolerance): the
time and cluster merges (seed 190's trial 1 included, where both folds
give 0.087 and Python 3.12's compensated `sum()` gives
0.08700000000000001), the tier cascade, the anomaly verdicts, the
sinusoid fit and its prediction, the Forecaster's gauge, the autoscaler's
forecast-driven decisions and the /timeseries payload. The rest is the
port on its own, as `tpu_ir`'s test holds it: the fixed footprint, the
rebase on a registry reset, the sampler's lifecycle and reference count
across nested servers, TPU_IR_TIMESERIES=0, and the declared names. No
worker process is spawned."""

import json
import math
import random
import threading
import time
import urllib.request

import pytest

from tpu_ir import obs as jax_obs
from tpu_ir.obs import registry as jax_registry
from tpu_ir.obs import timeseries as jax_ts
from tpu_ir.obs.server import MetricsServer as JaxMetricsServer
from tpu_ir.serving import autoscale as jax_autoscale

from tpu_ir_torch import obs
from tpu_ir_torch.obs import registry as port_registry
from tpu_ir_torch.obs import timeseries as ts
from tpu_ir_torch.obs.histogram import NUM_BUCKETS
from tpu_ir_torch.obs.server import MetricsServer
from tpu_ir_torch.serving import autoscale as port_autoscale

TIERS = ((1, 24), (6, 8), (12, 4))
PACKAGES = {"port": ts, "jax": jax_ts}
OBS = {"port": obs, "jax": jax_obs}
THREAD = "tpu-ir-obs-timeseries"


@pytest.fixture(autouse=True)
def _clean():
    for o in OBS.values():
        o.reset_all()
    yield
    for o in OBS.values():
        o.reset_all()


def _window(t, dur=1.0, c=None, g=None, h=None):
    return {"t": t, "dur_s": dur, "c": dict(c or {}), "g": dict(g or {}),
            "h": {k: (list(v[0]), v[1]) for k, v in (h or {}).items()}}


def _rand_window(rng, t):
    """tpu_ir's test window: counters, two gauges, a request histogram."""
    counts = [0] * NUM_BUCKETS
    for _ in range(rng.randrange(0, 6)):
        counts[rng.randrange(NUM_BUCKETS)] += rng.randrange(1, 4)
    return _window(
        t, dur=rng.choice([0.5, 1.0, 2.0]),
        c={"serving.submitted": rng.randrange(0, 50),
           "router.shed": rng.randrange(0, 5)},
        g={"router.occupancy": rng.random(),
           "slo.burn_fast": rng.random() * 4},
        h={"request": (counts, sum(counts) * 0.003)})


def _bits(obj) -> str:
    """A canonical text of a window or fit: floats by repr, so equal text
    is equal bits."""
    return json.dumps(obj, sort_keys=True, default=repr)


# -- the merges ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [190, 194, 195])
def test_merges_equal_tpu_ir_bitwise(seed):
    """merge_windows (durations add) and merge_windows_across (the
    longest) over 20 seeded groups, and every derived value read from
    them, equal tpu_ir's bit for bit: the histogram's seconds fold left
    to right as tpu_ir's do."""
    rng = random.Random(seed)
    for trial in range(20):
        k = rng.choice([2, 3, 6])
        fines = [_rand_window(rng, t=100.0 + i) for i in range(k)]
        for fn in ("merge_windows", "merge_windows_across"):
            got = getattr(ts, fn)(fines)
            want = getattr(jax_ts, fn)(fines)
            assert _bits(got) == _bits(want), (seed, trial, fn)
            for kind, src in (("rate", "serving.submitted"),
                              ("gauge", "router.occupancy"),
                              ("p99", "request"), ("p50", "request")):
                assert repr(ts.window_value(got, kind, src)) == \
                    repr(jax_ts.window_value(want, kind, src))
        merged = ts.merge_windows(fines)
        assert merged["dur_s"] == sum(w["dur_s"] for w in fines)
        assert merged["c"]["serving.submitted"] == sum(
            w["c"]["serving.submitted"] for w in fines)
        assert merged["g"] == fines[-1]["g"]
        assert merged["h"]["request"][0] == [
            sum(w["h"]["request"][0][b] for w in fines)
            for b in range(NUM_BUCKETS)]
        if (seed, trial) == (190, 1):
            # the left fold, not sum()'s compensated summation
            secs = [w["h"]["request"][1] for w in fines]
            assert merged["h"]["request"][1] == 0.087
            assert jax_ts.merge_windows(fines)["h"]["request"][1] == 0.087
            assert sum(secs) == 0.08700000000000001
            fold = 0.0
            for x in secs:
                fold += x
            assert fold == 0.087


def test_cluster_merge_sums_deltas_not_durations():
    a = _window(10.0, dur=1.0, c={"serving.submitted": 10},
                g={"router.occupancy": 0.2})
    b = _window(10.4, dur=1.0, c={"serving.submitted": 30},
                g={"router.occupancy": 0.9})
    m = ts.merge_windows_across([a, b])
    assert _bits(m) == _bits(jax_ts.merge_windows_across([a, b]))
    assert m["dur_s"] == 1.0 and m["c"]["serving.submitted"] == 40
    assert ts.window_value(m, "rate", "serving.submitted") == 40.0
    assert ts.merge_windows([a, b])["dur_s"] == 2.0


# -- the store ----------------------------------------------------------------


def test_store_rollup_equals_tpu_ir():
    """The tier cascade over 24 seeded windows: every tier's windows,
    the tier layout, the ring limits and the serialized state equal
    tpu_ir's; tier 1 is merge_windows of each group of 6."""
    rng = random.Random(191)
    wins = [_rand_window(rng, t=200.0 + i) for i in range(24)]
    stores = {p: m.TimeseriesStore(tiers=TIERS, sample_s=1.0)
              for p, m in PACKAGES.items()}
    for store in stores.values():
        for w in wins:
            store.add_window(w)
    port, jax = stores["port"], stores["jax"]
    for tier in range(len(TIERS)):
        assert _bits(port.windows(tier)) == _bits(jax.windows(tier))
    assert port.tier_layout() == jax.tier_layout()
    assert port.ring_limits() == jax.ring_limits()
    assert _bits(port.state()) == _bits(jax.state())
    t1 = port.windows(1)
    assert len(t1) == 4 and len(port.windows(2)) == 2
    for i, coarse in enumerate(t1):
        group = wins[i * 6:(i + 1) * 6]
        assert _bits(coarse) == _bits(ts.merge_windows(group))
    assert obs.get_registry().get("timeseries.rollups") == 6


def test_footprint_bounded_once_rings_full():
    rng = random.Random(192)
    store = ts.TimeseriesStore(tiers=TIERS, sample_s=1.0)
    full = store.ring_limits()["max_windows"] * max(f for f, _ in TIERS)
    for i in range(full):
        store.add_window(_rand_window(rng, t=300.0 + i))
    size_full = len(json.dumps(store.state()))
    for i in range(full):
        store.add_window(_rand_window(rng, t=300.0 + full + i))
    # the payloads are random: a few percent of jitter, no growth with the
    # second fill
    assert len(json.dumps(store.state())) <= size_full * 1.05
    for tier in store.tier_layout():
        assert tier["len"] <= tier["capacity"]
    held = sum(len(store.windows(i)) for i in range(len(TIERS)))
    assert held <= store.ring_limits()["max_windows"]


def test_sample_rebases_on_a_registry_reset():
    """The first sample and one across a reset only take the baseline;
    the next diffs the port's registry."""
    store = ts.TimeseriesStore(tiers=((1, 8),), sample_s=1.0)
    reg = obs.get_registry()
    assert store.sample(now=1.0) is None
    reg.incr("serving.submitted", 5)
    reg.set_gauge("router.occupancy", 0.5)
    reg.observe("request", 0.004)
    w = store.sample(now=2.0)
    assert w["c"] == {"serving.submitted": 5}
    assert w["g"] == {"router.occupancy": 0.5}
    assert sum(w["h"]["request"][0]) == 1 and w["dur_s"] == 1.0
    reg.reset()
    reg.incr("serving.submitted", 3)
    assert store.sample(now=3.0) is None
    reg.incr("serving.submitted", 2)
    assert store.sample(now=4.0)["c"]["serving.submitted"] == 2
    assert reg.get("timeseries.samples") == 1     # after the reset


def test_sample_cost_is_small():
    """A sample off a registry with every declared name (the sampler's
    whole cost an interval): far under 2% of the default 10 s."""
    store = ts.TimeseriesStore(tiers=TIERS, sample_s=1.0)
    reg = obs.get_registry()
    for _ in range(40):
        reg.incr("serving.submitted")
        reg.observe("request", 0.004)
    store.sample(now=1.0)
    t0 = time.perf_counter()
    for i in range(50):
        reg.incr("serving.submitted")
        store.sample(now=2.0 + i)
    assert (time.perf_counter() - t0) / 50 < 0.02


# -- anomalies ----------------------------------------------------------------


def _steady(module, n=20, rate=10):
    store = module.TimeseriesStore(tiers=((1, 32),), sample_s=1.0)
    for i in range(n):
        store.add_window(_window(400.0 + i, c={"serving.submitted": rate},
                                 g={"router.occupancy": 0.5}))
    return store


def test_anomaly_quiet_on_a_clean_history(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(tmp_path))
    for p, m in PACKAGES.items():
        assert _steady(m).detect_anomalies() == [], p
    assert list(tmp_path.iterdir()) == []
    assert obs.get_registry().get("timeseries.anomaly") == 0


def test_anomaly_loud_exactly_once_under_a_fault(tmp_path, monkeypatch):
    """A rate that jumps 50x: the same detection as tpu_ir's, one
    `anomaly` flight record whose header carries the lead-up; the
    sustained fault detects again and writes nothing more."""
    found = {}
    for p, m in PACKAGES.items():
        monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(tmp_path / p))
        store = _steady(m)
        store.add_window(_window(500.0, c={"serving.submitted": 500},
                                 g={"router.occupancy": 0.5}))
        found[p] = [store.detect_anomalies()]
        store.add_window(_window(501.0, c={"serving.submitted": 600},
                                 g={"router.occupancy": 0.5}))
        found[p].append(store.detect_anomalies())
        assert store.recent_anomalies()[-1]["series"] == "submitted_per_s"
    assert found["port"] == found["jax"]
    first, again = found["port"]
    assert [f["series"] for f in first] == ["submitted_per_s"]
    assert abs(first[0]["z"]) >= 8.0
    assert again and again[0]["series"] == "submitted_per_s"
    flights = list((tmp_path / "port").glob("*anomaly*"))
    assert len(flights) == 1, "the rate limit absorbed the repeat"
    header = json.loads(flights[0].read_text().splitlines()[0])
    assert header["reason"] == "anomaly"
    assert header["extra"]["anomaly"]["series"] == "submitted_per_s"
    assert obs.get_registry().get("timeseries.anomaly") == 2


def test_anomaly_floor_silences_a_flat_series(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(tmp_path))
    store = ts.TimeseriesStore(tiers=((1, 32),), sample_s=1.0)
    for i in range(20):
        store.add_window(_window(600.0 + i, g={"router.occupancy": 0.500}))
    store.add_window(_window(620.0, g={"router.occupancy": 0.52}))
    assert store.detect_anomalies() == []
    assert store.detect_anomalies(z_threshold=0) == []   # 0: off


# -- the forecaster and the autoscaler's third signal ------------------------


def _wave(t0, n, step, period=40.0, noise=0.0, seed=0):
    rng = random.Random(seed)
    return [(t0 + i * step,
             0.5 + 0.3 * math.sin(2 * math.pi * (t0 + i * step) / period)
             + noise * (rng.random() - 0.5))
            for i in range(n)]


@pytest.mark.parametrize("points", [
    _wave(50.0, 40, 2.0), _wave(10.0, 24, 0.7, period=9.0),
    _wave(0.0, 60, 0.25, period=6.0, noise=0.1, seed=3),
    _wave(5.0, 9, 1.0, period=30.0)], ids=["clean", "short", "noisy",
                                           "partial_cycle"])
def test_fit_and_predict_equal_tpu_ir_bitwise(points):
    got, want = ts.fit_sinusoid(points), jax_ts.fit_sinusoid(points)
    assert _bits(got) == _bits(want)
    assert got is not None
    for dt in (0.0, 1.0, 10.0, 37.5):
        t = points[-1][0] + dt
        assert repr(ts.predict(got, t)) == repr(jax_ts.predict(want, t))


def test_fit_recovers_the_period_and_predicts_ahead():
    pts = _wave(50.0, 40, 2.0)
    fit = ts.fit_sinusoid(pts)
    assert fit["r2"] > 0.9 and abs(fit["period_s"] - 40.0) < 4.0
    t = pts[-1][0] + 10.0
    truth = 0.5 + 0.3 * math.sin(2 * math.pi * t / 40.0)
    assert abs(ts.predict(fit, t) - truth) < 0.08


def test_fit_rejects_flat_and_noisy_series_as_tpu_ir_does():
    flat = [(float(i), 0.5) for i in range(20)]
    rng = random.Random(193)
    noise = [(float(i), rng.random()) for i in range(20)]
    few = _wave(0.0, 7, 1.0)
    for pts in (flat, noise, few):
        assert _bits(ts.fit_sinusoid(pts)) == _bits(jax_ts.fit_sinusoid(pts))
    assert ts.fit_sinusoid(flat) is None and ts.fit_sinusoid(few) is None
    fit = ts.fit_sinusoid(noise)
    assert fit is None or fit["r2"] < 0.9


def test_forecaster_publishes_its_gauge_and_degrades():
    """A sinusoidal occupancy history: each package's Forecaster
    publishes the same forecast_occupancy (bitwise) and fit, and counts
    forecast.fits; a flat history fails the gate and the gauge falls to
    the current level."""
    got = {}
    for p, m in PACKAGES.items():
        reg = OBS[p].get_registry()
        store = m.TimeseriesStore(tiers=((1, 64),), sample_s=1.0)
        for t, v in _wave(700.0, 30, 2.0):
            store.add_window(_window(t, g={"router.occupancy": v}))
        fc = m.Forecaster(store, lead_s=10.0, interval_s=0.0)
        fc._t0 = 700.0
        value = fc.poll(now=758.0)
        assert fc.poll(now=758.0) is not None    # interval 0: refits
        got[p] = (value, reg.gauges()["forecast_occupancy"],
                  _bits(store.last_fit), reg.get("forecast.fits"))
        store.reset()
        for i in range(20):
            store.add_window(_window(800.0 + i,
                                     g={"router.occupancy": 0.42}))
        fc2 = m.Forecaster(store, lead_s=10.0, interval_s=0.0)
        fc2._t0 = 800.0
        assert fc2.poll(now=820.0) is None
        assert reg.gauges()["forecast_occupancy"] == 0.42
    assert got["port"] == got["jax"]
    value = got["port"][0]
    truth = 0.5 + 0.3 * math.sin(2 * math.pi * 768.0 / 40.0)
    assert abs(value - truth) < 0.12 and got["port"][3] == 2
    assert json.loads(got["port"][2])["lead_s"] == 10.0


def test_forecaster_samples_the_store_when_asked():
    """sample=True: each due poll takes a window off the registry first
    (run_distributed_soak's arm), never more often than its interval."""
    store = ts.TimeseriesStore(tiers=((1, 64),), sample_s=1.0)
    fc = ts.Forecaster(store, lead_s=1.0, sample=True)
    assert fc.interval_s == 0.25                 # lead / 4
    reg = obs.get_registry()
    for i in range(12):
        reg.set_gauge("router.occupancy", 0.1 * (i % 4))
        fc.poll(now=100.0 + 0.125 * i)
    assert reg.get("timeseries.samples") == 5   # 6 polls due, 1 baseline
    assert len(store.points("gauge", "router.occupancy")) == 5


def test_autoscaler_forecast_decisions_equal_tpu_ir():
    """One fake fleet a package: the occupancy the router reports rides
    a wave the ticks publish, each package's Forecaster fits it and
    publishes forecast_occupancy, and its Autoscaler (forecast_up armed,
    occupancy under its own threshold) scales up on the reason
    "forecast": the decision records, the gauges and forecast.scaleups
    equal tpu_ir's."""
    from tests.test_torch_autoscale import _BASE, FakeFleet, FakeRouter

    cfg = dict(_BASE, sustain_up=2, forecast_up=0.6, forecast_lead_s=6.0,
               cooldown_s=100.0)
    out = {}
    for p, m in PACKAGES.items():
        reg = OBS[p].get_registry()
        auto = port_autoscale if p == "port" else jax_autoscale
        fleet, router = FakeFleet(), FakeRouter()
        scaler = auto.Autoscaler(fleet, router, auto.AutoscaleConfig(**cfg))
        store = m.TimeseriesStore(tiers=((1, 64),), sample_s=1.0)
        fc = m.Forecaster(store, lead_s=6.0, interval_s=0.0)
        fc._t0 = 0.0
        decisions = []
        for i in range(40):
            now = 0.5 * i
            occ = 0.35 + 0.3 * math.sin(2 * math.pi * now / 16.0)
            router.admission.inflight = int(round(occ * 10))
            d = scaler.tick(now=now)
            store.add_window(_window(now, g={
                "router.occupancy": reg.gauges()["router.occupancy"]}))
            fc.poll(now=now)
            decisions.append(d)
        out[p] = (decisions, reg.get("forecast.scaleups"),
                  reg.get("forecast.fits"), fleet.lifecycle(),
                  repr(reg.gauges()["forecast_occupancy"]))
    assert out["port"] == out["jax"]
    decisions, scaleups, fits = out["port"][:3]
    assert fits > 0 and scaleups == 1
    ups = [d for d in decisions if d["action"] == "up"]
    assert [d["reason"] for d in ups] == ["forecast"]
    assert ups[0]["occupancy"] < cfg["up_occupancy"]


# -- the sampler, the switch, the surfaces ------------------------------------


def test_sampler_thread_starts_and_stops():
    sampler = ts.TimeseriesSampler(
        store=ts.TimeseriesStore(tiers=((1, 8),), sample_s=1.0),
        interval_s=0.01)
    sampler.start()
    assert THREAD in [t.name for t in threading.enumerate()]
    time.sleep(0.05)
    sampler.stop()
    assert THREAD not in [t.name for t in threading.enumerate()]
    assert obs.get_registry().get("timeseries.samples") >= 1


def test_sampler_reference_count_across_nested_servers():
    """Each running MetricsServer holds one reference: the thread lives
    while any server runs and stops with the last; ensure_sampler hands
    out the one sampler."""
    def alive():
        return any(t.name == THREAD for t in threading.enumerate())

    assert not alive()
    with MetricsServer(port=0):
        assert alive()
        with MetricsServer(port=0):
            assert ts.ensure_sampler() is ts.ensure_sampler() is not None
            ts.release_sampler()
            ts.release_sampler()
        assert alive()
    assert not alive()


def test_disabled_flag_turns_everything_off(monkeypatch):
    monkeypatch.setenv("TPU_IR_TIMESERIES", "0")
    assert not ts.enabled()
    assert ts.ensure_sampler() is None
    assert ts.payload() == jax_ts.payload() == {"enabled": False}
    assert ts.header_window() is None
    assert ts.spool_write_store("/nonexistent-never-written") is None
    with MetricsServer(port=0) as srv:
        assert not any(t.name == THREAD for t in threading.enumerate())
        page = urllib.request.urlopen(f"{srv.url}/timeseries?format=html",
                                      timeout=5).read().decode()
        assert "disabled" in page


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return json.loads(r.read().decode())


def test_timeseries_endpoint_equals_tpu_ir():
    """The same windows in both stores (and a fit): /timeseries' JSON is
    tpu_ir's, its page draws the series, / lists the route, and /healthz
    has uptime_s, started_at and build_sha."""
    rng = random.Random(196)
    wins = [_rand_window(rng, t=1_000.0 + i) for i in range(9)]
    for p, m in PACKAGES.items():
        store = m.get_store()
        for w in wins:
            store.add_window(w)
        store.last_fit = m.fit_sinusoid(_wave(0.0, 30, 1.0, period=12.0))
    bodies = {}
    for p, server in (("port", MetricsServer), ("jax", JaxMetricsServer)):
        with server(port=0) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            bodies[p] = _get(f"{base}/timeseries")
            if p == "port":
                page = urllib.request.urlopen(
                    f"{base}/timeseries?format=html",
                    timeout=5).read().decode()
                assert "<svg" in page and "submitted_per_s" in page
                assert "/cluster" in page and "forecast: period" in page
                assert "/timeseries" in _get(f"{base}/")["endpoints"]
                hz = _get(f"{base}/healthz")
                assert hz["uptime_s"] > 0
                assert hz["started_at"].count(":") == 2
                assert "build_sha" in hz
    # the sampler both servers started may have added a window (its stop
    # takes a last sample): compare the seeded ones
    for body in bodies.values():
        for ent in body["series"].values():
            ent["tiers"] = [pts[:9] for pts in ent["tiers"]]
        for tier in body["tiers"]:
            tier["len"] = min(tier["len"], 9)
    assert bodies["port"] == bodies["jax"]
    body = bodies["port"]
    assert body["enabled"] and body["sources"] == 1
    assert set(body["series"]) == {label for label, *_ in ts.CURATED}
    assert body["series"]["submitted_per_s"]["tiers"][0]


def test_flight_header_carries_the_lead_up(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(tmp_path))
    from tpu_ir_torch.obs.recorder import flight_dump

    store = ts.get_store()
    store.sample(now=time.time() - 1.0)
    obs.get_registry().incr("serving.submitted", 3)
    store.sample(now=time.time())
    header = json.loads(open(flight_dump("test_leadup", force=True))
                        .readline())
    assert header["timeseries"]["window_s"] == \
        ts.get_store().tier_layout()[0]["window_s"]
    assert header["timeseries"]["series"]["submitted_per_s"]


def test_timeseries_names_are_declared():
    assert port_registry.TIMESERIES_COUNTER_NAMES == \
        jax_registry.TIMESERIES_COUNTER_NAMES
    assert set(port_registry.TIMESERIES_COUNTER_NAMES) <= set(
        port_registry.DECLARED_COUNTERS)
    for n in ("router.occupancy", "forecast_occupancy"):
        assert port_registry.GAUGE_MERGE[n] == jax_registry.GAUGE_MERGE[n] \
            == "last"
    assert ts.CURATED == jax_ts.CURATED
    assert ts.DEFAULT_TIERS == jax_ts.DEFAULT_TIERS
    serving = {f"serving.{n}" for n in port_registry.SERVING_COUNTER_NAMES}
    for _, kind, source, _ in ts.CURATED:
        if kind == "rate":
            assert source in set(port_registry.DECLARED_COUNTERS) | serving
        elif kind == "gauge":
            assert source in port_registry.DECLARED_GAUGES
        else:
            assert source in port_registry.DECLARED_HISTOGRAMS
