"""The port's elastic shard fleet on the CPU, held against `tpu_ir`.

- The control loop: one (occupancy, now) sequence through both packages'
  Autoscaler over the same in-memory fleet and router stand-ins
  (`tests/test_autoscale.py`'s FakeFleet / FakeRouter) gives equal
  decision records, counter deltas and fleet states: hysteresis,
  cooldown, the min/max clamps, the drain pick, a failed grow, the SLO
  burn arm, a set `forecast_occupancy` gauge; env resolution and its
  validation; the /healthz autoscaler section's keys.
- The SLO burn windows: one `slo_record` sequence through both trackers
  gives equal burns, snapshots and breach counts.
- The real fleet (CPU subprocess workers): a warm grow, a drain that
  leaves dispatch but not the address view, drain-not-drop under
  traffic, a reused slot's bumped spawn generation, `reset_breaker`, a
  draining replica's round trip left out of the hedge estimate, and
  rolling_swap's skip of draining and retired slots.
- `tpu_ir`'s acceptance soaks at their sizes: conservation across
  membership changes (a SIGKILL during a drain), the zero-stale swap
  during a scale-up, the closed loop growing under a burst; their
  `scale` report keys are `tpu_ir`'s.
- The command line: `scale` (with `--url`), `serve-bench --autoscale`
  (its refusals and its JSON against `tpu_ir`'s over one canned report).
"""

import dataclasses
import gc
import json
import os
import random
import threading
import time

import numpy as np
import pytest

from tpu_ir import cli as jax_cli
from tpu_ir import obs as jax_obs
from tpu_ir.obs import disttrace as jax_disttrace
from tpu_ir.obs import registry as jax_registry
from tpu_ir.obs.server import health_snapshot as jax_health_snapshot
from tpu_ir.serving import autoscale as jax_autoscale

from tpu_ir_torch import cli as port_cli
from tpu_ir_torch import faults, obs
from tpu_ir_torch.index import build_index
from tpu_ir_torch.index.ingest import IngestWriter
from tpu_ir_torch.index.segments import LiveIndex
from tpu_ir_torch.obs import disttrace
from tpu_ir_torch.obs import registry as port_registry
from tpu_ir_torch.obs.server import MetricsServer, health_snapshot
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.serving import (
    Autoscaler,
    AutoscaleConfig,
    Router,
    RouterConfig,
    ShardSet,
    autoscale_enabled,
    get_worker_health,
    rolling_swap,
    run_distributed_soak,
)

WORDS = ("salmon fishing river bears honey quick brown fox lazy dog "
         "market investor asset bond stock season rain forest".split())
QUERIES = ["salmon fishing", "bears honey market", "quick",
           "rain forest investor", "asset bond stock season",
           "dog dog salmon", "fox market rain"]
# tpu_ir's run_distributed_soak `scale` section with and without an
# autoscaler (its first_up_* and lead keys come with a scale-up the
# autoscaler made)
SCALE_KEYS = {"events", "epoch", "lifecycle", "drains", "drained_clean",
              "killed_mid_drain", "mean_replicas", "overprovision_fraction",
              "ticks"}
FIRST_UP_KEYS = {"first_up_s", "first_up_reason", "first_up_frac",
                 "first_peak_s", "forecast_lead_s"}
DRAIN_KEYS = {"shard", "replica", "drain_s", "inflight_peak",
              "drained_clean", "killed_mid_drain"}
SCALE_COUNTERS = ("scale.up", "scale.down", "scale.drain_inflight",
                  "scale.cooldown_skipped", "forecast.scaleups")


@pytest.fixture(autouse=True)
def _clean_port_state():
    faults.clear()
    obs.reset_all()
    yield
    gc.collect()  # a dead autoscaler or router leaves /healthz
    faults.clear()
    faults.drain_abandoned(timeout_s=10.0)
    obs.reset_all()


# -- the control loop against tpu_ir's ----------------------------------------


class FakeFleet:
    """A lifecycle-faithful in-memory ShardSet (tpu_ir's test fake)."""

    def __init__(self, shards=2, replicas=1):
        self._life = [["active"] * replicas for _ in range(shards)]
        self._epoch = 0
        self._events = []
        self.retired = []
        self.grow_raises = False
        self.max_concurrency = 4

    def lifecycle(self):
        return [list(row) for row in self._life]

    def epoch(self):
        return self._epoch

    def events(self):
        return list(self._events)

    def active_replicas(self, shard=None):
        counts = [sum(1 for st in row if st == "active")
                  for row in self._life]
        return counts[shard] if shard is not None else min(counts)

    def grow(self):
        if self.grow_raises:
            raise RuntimeError("spawn failed")
        added = []
        for s, row in enumerate(self._life):
            row.append("active")
            self._epoch += 1
            self._events.append(("up", s, len(row) - 1, self._epoch))
            added.append((s, len(row) - 1))
        return added

    def retire_replica(self, shard, replica, *, drain_timeout_s=30.0):
        self._life[shard][replica] = "retired"
        self._epoch += 1
        self._events.append(("down", shard, replica, self._epoch))
        self.retired.append((shard, replica))
        return {"shard": shard, "replica": replica, "drain_s": 0.0,
                "inflight_peak": 0, "drained_clean": True,
                "killed_mid_drain": False}


class FakeAdmission:
    def __init__(self):
        self.inflight = 0
        self.queued = 0
        self.max_concurrency = 10

    def in_flight(self):
        return self.inflight

    def queue_depth(self):
        return self.queued


class FakeRouter:
    def __init__(self):
        self.admission = FakeAdmission()
        self.resets = []

    def reset_breaker(self, shard, replica):
        self.resets.append((shard, replica))


_BASE = dict(min_replicas=1, max_replicas=3, cooldown_s=1.0,
             up_occupancy=0.8, down_occupancy=0.2, sustain_up=3,
             sustain_down=5)

# name: (fleet kwargs, config overrides, fleet set-up, steps); a step is
# (in flight, queued, now) or a dict of actions before the next tick:
# {"grow_raises": bool}, {"slo": [(level, ms, ok, classification)]},
# {"forecast": occupancy}
_SLOW_MS = 1_000_000.0
SCENARIOS = {
    "hysteresis": ({}, {}, None,
                   [(9, 0, 1.0), (9, 0, 2.0), (9, 0, 3.0), (9, 0, 3.1),
                    (5, 0, 3.2), (9, 1, 3.3)]),
    "cooldown": ({}, {"cooldown_s": 5.0}, None,
                 [(9, 0, 1.0), (9, 0, 2.0), (9, 0, 3.0), (9, 0, 3.2),
                  (9, 0, 3.4), (9, 0, 3.6), (9, 0, 9.0), (0, 0, 9.5)]),
    "clamp_max": ({"replicas": 3}, {"sustain_down": 3}, None,
                  [(9, 0, 1.0), (9, 0, 2.0), (9, 0, 3.0), (9, 0, 4.0)]),
    "clamp_min": ({"replicas": 1}, {"sustain_down": 3}, None,
                  [(0, 0, 11.0), (0, 0, 12.0), (0, 0, 13.0),
                   (0, 0, 14.0)]),
    "drain_pick": ({"replicas": 3}, {"sustain_down": 3, "cooldown_s": 0.1},
                   "retire_1_2",
                   [(0, 0, 1.0), (0, 0, 2.0), (0, 0, 3.0), (0, 0, 3.05),
                    (1, 0, 3.2), (0, 0, 3.3), (0, 0, 3.4), (0, 0, 3.5)]),
    "failed_grow": ({}, {}, None,
                    [{"grow_raises": True}, (9, 0, 1.0), (9, 0, 2.0),
                     (9, 0, 3.0), {"grow_raises": False}, (9, 0, 4.0)]),
    "steady_band": ({"replicas": 2}, {"sustain_down": 2}, None,
                    [(5, 0, 1.0), (0, 0, 2.0), (5, 0, 3.0), (0, 0, 4.0),
                     (0, 0, 5.0), (2, 0, 5.5)]),
    "slo_burn": ({}, {"slo_burn_up": 2.0}, None,
                 [{"slo": [("full", 5.0, True, "full")] * 6
                   + [("shed", 1.0, False, "shed")] * 3
                   + [("full", _SLOW_MS, True, "full")]},
                  (2, 0, 1.0), (2, 0, 2.0), (2, 0, 3.0), (0, 0, 4.0)]),
    "slo_burn_off": ({}, {"slo_burn_up": 0.0}, None,
                     [{"slo": [("partial", 5.0, True, "partial")] * 5},
                      (2, 0, 1.0), (2, 0, 2.0), (2, 0, 3.0)]),
    "forecast": ({}, {"forecast_up": 0.8}, None,
                 [{"forecast": 0.9}, (2, 0, 1.0), (2, 0, 2.0), (2, 0, 3.0),
                  {"forecast": 0.1}, (2, 0, 9.0)]),
}


def _drive(scaler_cls, cfg_cls, registry, slo_record, name):
    """One scenario through one package: the decision records, the scale
    counters' deltas, the fleet's end state, the breaker resets, the
    occupancy gauge and the utilization report of the ticks."""
    fleet_kw, over, setup, steps = SCENARIOS[name]
    fleet, router = FakeFleet(**fleet_kw), FakeRouter()
    if setup == "retire_1_2":
        fleet._life[1][2] = "retired"
    before = {n: registry.get(n) for n in SCALE_COUNTERS}
    a = scaler_cls(fleet, router, cfg_cls(**{**_BASE, **over}))
    decisions = []
    for step in steps:
        if isinstance(step, dict):
            if "grow_raises" in step:
                fleet.grow_raises = step["grow_raises"]
            for rec in step.get("slo", ()):
                slo_record(*rec)
            if "forecast" in step:
                registry.set_gauge("forecast_occupancy", step["forecast"])
            continue
        router.admission.inflight, router.admission.queued, now = step
        d = a.tick(now=now)
        if str(d["reason"]).startswith("up_failed"):
            d["reason"] = "up_failed"   # the message names its package
        decisions.append(d)
    deltas = {n: registry.get(n) - before[n] for n in SCALE_COUNTERS}
    gauge = registry.gauges()["router.occupancy"]
    return (decisions, deltas, fleet.lifecycle(), fleet.events(),
            fleet.retired, router.resets, gauge, a.utilization_report(),
            a.utilization_report(worker_concurrency=2))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_control_loop_equals_jax(name):
    got = _drive(Autoscaler, AutoscaleConfig, obs.get_registry(),
                 disttrace.slo_record, name)
    want = _drive(jax_autoscale.Autoscaler, jax_autoscale.AutoscaleConfig,
                  jax_obs.get_registry(), jax_disttrace.slo_record, name)
    assert got == want
    decisions = got[0]
    reasons = [d["reason"] for d in decisions]
    actions = [d["action"] for d in decisions]
    # what each scenario is for, beside the equality
    expect = {
        "hysteresis": "up" in actions and actions.index("up") == 2,
        "cooldown": "cooldown" in reasons and actions.count("up") == 2,
        "clamp_max": reasons[2:] == ["at_max_replicas"] * 2,
        "clamp_min": reasons[2:] == ["at_min_replicas"] * 2,
        "drain_pick": got[4][:2] == [(0, 2), (1, 1)],
        "failed_grow": reasons[2] == "up_failed" and actions[3] == "up",
        "steady_band": "down" in actions,
        "slo_burn": "slo_burn" in reasons,
        "slo_burn_off": actions == [None] * 3,
        "forecast": "forecast" in reasons and got[1]["forecast.scaleups"] == 1,
    }[name]
    assert expect, decisions


SLO_SEQUENCES = {
    "all_good": [("full", 5.0, True, "full")] * 30,
    "slow_and_shed": ([("full", 5.0, True, "full")] * 10
                      + [("full", _SLOW_MS, True, "full")] * 3
                      + [("shed", 2.0, False, "shed")] * 4
                      + [("no_rerank", 5.0, True, "degraded")] * 2),
    "breach": ([("full", 5.0, True, "full")] * 5
               + [("shed", 1.0, False, "shed")] * 25
               + [("full", 5.0, True, "full")] * 3),
}


@pytest.mark.parametrize("name", sorted(SLO_SEQUENCES))
def test_slo_windows_equal_jax(name, monkeypatch):
    # tpu_ir writes a flight record on a breach; the port counts and logs
    monkeypatch.setattr(jax_disttrace, "flight_dump", lambda *a, **k: None)
    got_v, want_v = [], []
    for rec in SLO_SEQUENCES[name]:
        got_v.append(disttrace.slo_record(*rec))
        want_v.append(jax_disttrace.slo_record(*rec))
    assert got_v == want_v
    assert disttrace.slo_burn_signal() == jax_disttrace.slo_burn_signal()
    got, want = disttrace.slo_snapshot(), jax_disttrace.slo_snapshot()
    assert got == want
    port_g, jax_g = obs.get_registry().gauges(), \
        jax_obs.get_registry().gauges()
    for g in ("slo.burn_fast", "slo.burn_slow"):
        assert port_g[g] == jax_g[g]
    assert got["breaches"] == (1 if name == "breach" else 0)
    assert got["breached"] is (name == "breach")


@pytest.mark.parametrize("env", [
    {},
    {"TPU_IR_SCALE_MIN_REPLICAS": "2", "TPU_IR_SCALE_MAX_REPLICAS": "7",
     "TPU_IR_SCALE_COOLDOWN_S": "2.5", "TPU_IR_SCALE_LEAD_S": "4"},
    {"TPU_IR_SCALE_MIN_REPLICAS": "0", "TPU_IR_SCALE_COOLDOWN_S": "-1",
     "TPU_IR_AUTOSCALE": "1"},
    {"TPU_IR_AUTOSCALE": "0", "TPU_IR_SCALE_MAX_REPLICAS": "1",
     "TPU_IR_SCALE_MIN_REPLICAS": "3"},
    {"TPU_IR_SCALE_MAX_REPLICAS": "many"},
], ids=["defaults", "set", "below-minimum", "max-below-min", "not-a-number"])
def test_env_resolution_and_validation_equal_jax(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def resolve(cfg_cls, scaler_cls, enabled):
        try:
            cfg = cfg_cls().resolved()
        except ValueError:
            return "ValueError"
        try:
            scaler_cls(FakeFleet(), FakeRouter(), cfg_cls())
            built = True
        except ValueError:
            built = "ValueError"
        return (dataclasses.asdict(cfg), enabled(), enabled(flag=False),
                enabled(flag=True), built)

    got = resolve(AutoscaleConfig, Autoscaler, autoscale_enabled)
    want = resolve(jax_autoscale.AutoscaleConfig, jax_autoscale.Autoscaler,
                   jax_autoscale.autoscale_enabled)
    assert got == want
    if env.get("TPU_IR_SCALE_MAX_REPLICAS") == "many":
        assert got == "ValueError"
    if "TPU_IR_SCALE_MIN_REPLICAS" in env and env.get(
            "TPU_IR_SCALE_MAX_REPLICAS") == "1":
        assert got[-1] == "ValueError"


def test_scale_names_are_jax_declared():
    assert port_registry.SCALE_COUNTER_NAMES \
        == jax_registry.SCALE_COUNTER_NAMES
    for n in (port_registry.SCALE_COUNTER_NAMES
              + port_registry.SLO_COUNTER_NAMES
              + port_registry.TIMESERIES_COUNTER_NAMES):
        assert n in port_registry.DECLARED_COUNTERS
        assert n in jax_registry.DECLARED_COUNTERS
    for n in ("scale.drain_ms", "scale.warmup_ms", "ingest.freshness"):
        assert n in port_registry.DECLARED_HISTOGRAMS
        assert n in jax_registry.DECLARED_HISTOGRAMS
    for n in ("slo.burn_fast", "slo.burn_slow", "router.occupancy",
              "forecast_occupancy", "ingest.freshness_lag_ms"):
        assert n in port_registry.DECLARED_GAUGES
        assert n in jax_registry.DECLARED_GAUGES
        assert obs.get_registry().gauges()[n] == 0.0


def test_healthz_autoscaler_section_equals_jax():
    fleet, jfleet = FakeFleet(), FakeFleet()
    router, jrouter = FakeRouter(), FakeRouter()
    a = Autoscaler(fleet, router, AutoscaleConfig(**_BASE))
    ja = jax_autoscale.Autoscaler(jfleet, jrouter,
                                  jax_autoscale.AutoscaleConfig(**_BASE))
    for r in (router, jrouter):
        r.admission.inflight = 9
    for now in (1.0, 2.0, 3.0):
        a.tick(now=now)
        ja.tick(now=now)
    got, want = health_snapshot()["autoscaler"], \
        jax_health_snapshot()["autoscaler"]
    got.pop("cooldown_remaining_s")
    want.pop("cooldown_remaining_s")
    assert got == want
    assert got["last_decision"]["action"] == "up"
    assert got["epoch"] == fleet.epoch() == 2
    assert a is not None and ja is not None  # alive to here


# -- the real fleet -------------------------------------------------------------


def _text(rng) -> str:
    toks = [rng.choice(WORDS) for _ in range(rng.randint(3, 7))]
    return " ".join(toks + [f"w{rng.randint(0, 40)}"])


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    """tpu_ir's fixture: 120 docs over WORDS, two shards."""
    tmp = tmp_path_factory.mktemp("autoscale")
    corpus = str(tmp / "c.trec")
    with open(corpus, "w") as f:
        for i in range(120):
            text = " ".join(WORDS[(i + j) % len(WORDS)]
                            for j in range(3 + (i % 7)))
            f.write(f"<DOC>\n<DOCNO> D-{i:04d} </DOCNO>\n<TEXT>\n"
                    f"{text}\n</TEXT>\n</DOC>\n")
    out = str(tmp / "idx")
    build_index(corpus, out, num_shards=2, device="cpu",
                compute_chargrams=False)
    return out


@pytest.fixture(scope="module")
def live_dir(tmp_path_factory):
    """Generation A (40 docs) and B (A with 4 replaced and 8 added)."""
    live = str(tmp_path_factory.mktemp("alive") / "live")
    LiveIndex.create(live, num_shards=2, chargram_ks=())
    rng = random.Random(2)
    with IngestWriter(live, auto_merge=False, device="cpu") as w:
        for i in range(40):
            w.add(f"D-{i:03d}", _text(rng))
        w.compact_all()
    gen_a = LiveIndex.open(live).current_gen()
    with IngestWriter(live, auto_merge=False, device="cpu") as w:
        for i in range(4):
            w.update(f"D-{i:03d}", _text(rng))
        for i in range(8):
            w.add(f"N-{i:03d}", _text(rng))
        w.compact_all()
    gen_b = LiveIndex.open(live).current_gen()
    return live, gen_a, gen_b


def _bits(hits) -> list:
    return [(d, np.float32(s).tobytes()) for d, s in hits]


def test_grow_is_warm_and_drain_never_drops(live_dir, tmp_path):
    """One elastic lifecycle on CPU subprocess workers over a live dir:
    grow() publishes a warm replica a shard (ready after its warm-up,
    the membership log and epoch moved, scale.up and scale.warmup_ms
    counted) that answers bitwise the single scorer; begin_drain leaves
    dispatchable() but not addresses(), and a draining replica's round
    trip feeds no hedge estimate; rolling_swap skips the draining slot;
    retiring under traffic drains clean with every request answered;
    rolling_swap skips retired slots; a reused slot comes back with its
    spawn generation bumped, on the pinned generation, its breaker
    cleared by reset_breaker."""
    live, gen_a, gen_b = live_dir
    reg = obs.get_registry()
    want = {g: Scorer.load_generation(live, g, layout="sparse",
                                      device="cpu") for g in (gen_a, gen_b)}
    ss = ShardSet(live, shards=2, replicas=1, index_generation=gen_a,
                  device="cpu", rundir=str(tmp_path / "run"),
                  deadline_s=30.0)
    pids = set()
    router = None
    try:
        ss.start()
        router = Router(live, ss, RouterConfig(deadline_ms=30000.0,
                                               max_queue=64))
        e0 = ss.epoch()
        added = ss.grow()
        assert added == [(0, 1), (1, 1)]
        assert ss.active_replicas() == 2 == ss.active_replicas(0)
        assert ss.epoch() == e0 + 4   # warming, then active, a slot
        assert [ev[0] for ev in ss.events()] == ["up", "up"]
        assert ss.dispatchable() == ss.addresses()
        assert ss.lifecycle() == [["active", "active"]] * 2
        assert reg.get("scale.up") == 2
        assert sum(reg.hist_state()["scale.warmup_ms"][0]) == 1
        pids |= {h.pid for row in ss.handles() for h in row}
        for s, r in added:
            w = get_worker_health(ss.addresses()[s][r], 10)["worker"]
            # ready after its warm-up: the launches split is there (the
            # kernels launch only on the card; here the twins run)
            assert w["in_flight"] == 0 and w["generation"] == 0
            assert w["index_generation"] == gen_a
            assert set(w["warm_launches"]) == set(w["kernel_launches"])
            assert w["residency"] is not None
        for q in QUERIES * 2:
            res = router.search(q, k=10, scoring="bm25")
            assert Router.classify(res) == "full"
            assert _bits(res) == _bits(want[gen_a].search_batch(
                [q], k=10, scoring="bm25")[0])
        assert reg.get("router.breaker_opened") == 0

        # out of dispatch, still addressed; its round trip is not sampled
        ss.begin_drain(0, 1)
        assert ss.lifecycle()[0][1] == "draining"
        assert router._replica_draining(0, 1)
        assert ss.dispatchable()[0][1] is None
        assert ss.addresses()[0][1] is not None
        n_rtts = len(router._stats[0]._rtts)
        ok, data = router._call_replica(
            0, 1, ss.addresses()[0][1], "search",
            {"text": "salmon", "k": 10, "scoring": "bm25"}, 30.0)
        assert ok and data["hits"]
        assert len(router._stats[0]._rtts) == n_rtts
        ok, _ = router._call_replica(
            0, 0, ss.addresses()[0][0], "search",
            {"text": "salmon", "k": 10, "scoring": "bm25"}, 30.0)
        assert ok and len(router._stats[0]._rtts) == n_rtts + 1

        # a rolling swap leaves the draining replica on A
        swap = rolling_swap(ss, gen_b)
        assert sorted((s, r) for s, r, _ in swap["swapped"]) == [
            (0, 0), (1, 0), (1, 1)]
        assert not swap["failed"]
        assert get_worker_health(ss.addresses()[0][1], 10)["worker"][
            "index_generation"] == gen_a
        router.note_generation(gen_b)

        # retire both grown replicas under traffic: nothing dropped
        results = []
        stop = threading.Event()

        def client(tid):
            i = tid
            while not stop.is_set():
                try:
                    res = router.search(QUERIES[i % len(QUERIES)], k=10,
                                        scoring="bm25")
                    results.append(Router.classify(res))
                except Exception as e:  # noqa: BLE001 — must be none
                    results.append(repr(e))
                i += 4

        threads = [threading.Thread(target=client, args=(t,), daemon=True)
                   for t in range(4)]
        for th in threads:
            th.start()
        time.sleep(0.2)
        drains = [ss.retire_replica(s, 1, drain_timeout_s=20.0)
                  for s in range(2)]
        time.sleep(0.2)
        stop.set()
        for th in threads:
            th.join(timeout=60)
        assert all(d["drained_clean"] for d in drains), drains
        assert not any(d["killed_mid_drain"] for d in drains)
        assert set(drains[0]) == DRAIN_KEYS
        assert reg.get("scale.down") == 2
        assert [ev[0] for ev in ss.events()] == ["up", "up", "down", "down"]
        assert ss.lifecycle() == [["active", "retired"]] * 2
        assert ss.active_replicas() == 1
        assert all(row[1] is None for row in ss.dispatchable())
        assert results and set(results) == {"full"}, results[:5]
        # the retired workers exited on SIGTERM
        assert [row[1].proc.returncode for row in ss.handles()] == [0, 0]

        # a swap walks no retired slot (their addresses are dead)
        swap = rolling_swap(ss, gen_b)
        assert sorted((s, r) for s, r, _ in swap["swapped"]) == [
            (0, 0), (1, 0)]
        assert not swap["failed"]

        # the reused slot: spawn generation 1, on the pinned B, its
        # breaker cleared
        b = router._breaker(0, 1)
        for _ in range(3):
            b.record_failure()
        assert b.state == "open"
        assert ss.grow() == [(0, 1), (1, 1)]
        router.reset_breaker(0, 1)
        assert b.state == "closed" and b.snapshot()["opened_count"] == 1
        for s in range(2):
            w = get_worker_health(ss.addresses()[s][1], 10)["worker"]
            assert (w["generation"], w["index_generation"]) == (1, gen_b)
        pids |= {h.pid for row in ss.handles() for h in row}
        for q in QUERIES:
            res = router.search(q, k=10, scoring="bm25")
            assert Router.classify(res) == "full" and res.generation == gen_b
            assert _bits(res) == _bits(want[gen_b].search_batch(
                [q], k=10, scoring="bm25")[0])
    finally:
        if router is not None:
            router.close()
        ss.stop()
    for p in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(p, 0)


def test_failed_grow_leaves_no_worker(index_dir, tmp_path, monkeypatch):
    """A grow whose spawn dies stops its siblings, marks their slots
    retired and raises; the fleet serves on."""
    ss = ShardSet(index_dir, shards=2, replicas=1, device="cpu",
                  rundir=str(tmp_path / "run"), spawn_timeout_s=120.0)
    try:
        ss.start()
        real_spawn = ss._spawn
        spawned = []

        def spawn(shard, replica, **kw):
            proc, ready = real_spawn(shard, replica, **kw)
            spawned.append(proc)
            if shard == 0:
                proc.kill()   # this one dies during its start
            return proc, ready

        monkeypatch.setattr(ss, "_spawn", spawn)
        with pytest.raises(RuntimeError, match="died during startup"):
            ss.grow()
        assert all(p.poll() is not None for p in spawned)
        assert ss.lifecycle() == [["active", "retired"]] * 2
        assert ss.active_replicas() == 1 and ss.events() == []
        with Router(index_dir, ss, RouterConfig(deadline_ms=30000.0)) as r:
            assert Router.classify(r.search("salmon fishing")) == "full"
    finally:
        ss.stop()


def _sleeper(seconds: float, **kw):
    import subprocess
    import sys

    return subprocess.Popen(
        [sys.executable, "-c", f"import time; time.sleep({seconds})"], **kw)


@pytest.mark.parametrize("exits", [True, False], ids=["exits", "stays"])
def test_retire_reads_a_failed_health_poll_by_the_exit(tmp_path,
                                                       monkeypatch, exits):
    """A failed /healthz read during a drain is a kill when the process
    exits within 2 s (`killed_mid_drain`), else the drain settles and the
    worker is stopped: the read is forced to fail while the process is
    still alive, so `h.alive` cannot decide it first."""
    from tpu_ir_torch.serving import shardset as shardset_mod
    from tpu_ir_torch.serving.shardset import WorkerHandle

    ss = ShardSet(str(tmp_path / "unused"), shards=1, replicas=1,
                  rundir=str(tmp_path / "run"), device="cpu")
    proc = _sleeper(0.5 if exits else 60)
    reads = []

    def failing_health(addr, timeout_s):
        reads.append(proc.poll())
        raise ConnectionRefusedError(addr)

    monkeypatch.setattr(shardset_mod, "get_worker_health", failing_health)
    ss._grid[0][0] = WorkerHandle(0, 0, 0, proc, "127.0.0.1", 9, proc.pid)
    ss._state[0][0] = "active"
    try:
        d = ss.retire_replica(0, 0, drain_timeout_s=10.0)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=10)
    assert reads == [None]         # one read, the process alive at it
    assert d["killed_mid_drain"] is exits
    assert d["drained_clean"] is (not exits)
    assert proc.returncode == (0 if exits else -15)   # else SIGTERMed
    assert ss.lifecycle() == [["retired"]]
    assert obs.get_registry().get("scale.down") == 1


def test_grown_worker_is_reniced_after_spawn_with_the_checkout_on_its_path(
        tmp_path, monkeypatch):
    """A grow's spawn runs at GROW_NICE, set by the parent after Popen (no
    pre-exec hook), and every worker's PYTHONPATH leads with the
    checkout, so a parent may run from any directory."""
    import subprocess

    from tpu_ir_torch.serving import shardset as shardset_mod

    popen_kw = []
    real_popen = subprocess.Popen

    def fake_popen(argv, **kw):
        popen_kw.append(kw)
        # the worker's place: a bare interpreter started elsewhere that
        # finds the package through the PYTHONPATH it was given (without
        # importing it, so torch stays out) and writes where to its log
        return real_popen(
            [argv[0], "-c",
             "import importlib.util as u, time; "
             "s = u.find_spec('tpu_ir_torch'); "
             "print(s and s.origin, flush=True); time.sleep(30)"],
            env=kw["env"], cwd=str(tmp_path), stdin=subprocess.DEVNULL,
            stdout=kw["stdout"], stderr=kw["stderr"])

    monkeypatch.setattr(shardset_mod.subprocess, "Popen", fake_popen)
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    ss = ShardSet(str(tmp_path / "unused"), shards=1, replicas=1,
                  rundir=str(tmp_path / "run"), device="cpu")
    procs = []
    try:
        for nice in (shardset_mod.GROW_NICE, 0):
            proc, _ = ss._spawn(0, 0, generation=len(procs), nice=nice)
            procs.append(proc)
            base = os.getpriority(os.PRIO_PROCESS, 0)
            assert os.getpriority(os.PRIO_PROCESS, proc.pid) == max(
                nice, base)
        for kw in popen_kw:
            assert "preexec_fn" not in kw
            path = kw["env"]["PYTHONPATH"].split(os.pathsep)
            assert path == [shardset_mod._PKG_PARENT, "/elsewhere"]
        log = ss.log_path(0, 0)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            with open(log, encoding="utf-8") as f:
                found = f.read().split()
            if len(found) == len(procs):
                break
            time.sleep(0.05)
        assert found == [os.path.join(shardset_mod._PKG_PARENT,
                                      "tpu_ir_torch", "__init__.py")] * 2
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)


def _scale_checks(report: dict) -> dict:
    sc = report["scale"]
    assert set(sc) - {"autoscaler"} - FIRST_UP_KEYS == SCALE_KEYS
    for d in sc["drains"]:
        assert set(d) == DRAIN_KEYS
    return sc


def test_conservation_across_membership_changes(index_dir, tmp_path):
    """tpu_ir's acceptance: a grow mid-soak, a drain mid-soak and a SIGKILL
    of the draining replica during its handshake, and still shed + served
    == submitted with no error, deadlock or mismatch."""
    report = run_distributed_soak(
        index_dir, shards=2, replicas=2, threads=6, queries=90, seed=2,
        chaos=False, device="cpu",
        scale_plan={"up_at": 0.2, "down_at": 0.5, "kill_during_drain": True},
        worker_deadline_s=3.0,
        router_config=RouterConfig(deadline_ms=8000.0, max_queue=128),
        rundir=str(tmp_path / "run"), recovery_timeout_s=120.0)
    assert report["served"] + report["shed"] == report["submitted"]
    assert report["errors"] == 0, report["error_samples"]
    assert report["deadlocked"] == 0
    assert report["full_mismatches"] == 0
    assert report["partial_mismatches"] == 0
    sc = _scale_checks(report)
    assert "autoscaler" not in sc
    assert sc["events"] >= 4               # 2 up and 2 down, at least
    assert len(sc["drains"]) == 2
    assert sc["killed_mid_drain"] + sc["drained_clean"] == 2
    assert sc["epoch"] > 0
    assert sc["mean_replicas"] > 0
    assert 0.0 <= sc["overprovision_fraction"] <= 1.0
    assert report["recovery_full"] == report["recovery_probes"]


def test_zero_stale_swap_during_scale(tmp_path):
    """tpu_ir's acceptance: a rolling swap while a scale-up grows the
    fleet; the walk also confirms the replica that joined mid-roll, so
    no old-generation answer comes after the roll, no unknown one, and
    the ledger balances."""
    live = str(tmp_path / "live")
    LiveIndex.create(live, num_shards=2, chargram_ks=())
    rng = random.Random(5)
    with IngestWriter(live, auto_merge=False, device="cpu") as w:
        for i in range(50):
            w.add(f"D-{i:03d}", " ".join(rng.choice(WORDS)
                                         for _ in range(rng.randint(3, 7))))
        w.compact_all(note="base")
    report = run_distributed_soak(
        live, shards=2, replicas=1, threads=6, queries=80, seed=3,
        chaos=False, upgrade_at=0.25, upgrade_docs=6, device="cpu",
        scale_plan={"up_at": 0.3}, worker_deadline_s=3.0,
        router_config=RouterConfig(deadline_ms=8000.0, max_queue=128),
        rundir=str(tmp_path / "run"), recovery_timeout_s=120.0)
    assert report["served"] + report["shed"] == report["submitted"]
    assert report["errors"] == 0, report["error_samples"]
    assert report["deadlocked"] == 0
    up = report["upgrade"]
    assert up["swap"] is not None and not up["swap"]["failed"]
    assert up["late_old_generation"] == 0
    assert report["unknown_generation"] == 0
    assert report["full_mismatches"] == 0
    assert report["partial_mismatches"] == 0
    assert report["generations_served"].get(str(up["generation_b"]), 0) > 0
    sc = _scale_checks(report)
    assert sc["events"] >= 2               # the mid-roll grow landed
    assert report["recovery_full"] == report["recovery_probes"]


def test_autoscaler_closed_loop_scales_up_under_burst(index_dir, tmp_path):
    """tpu_ir's acceptance: a burst through a router narrowed to two
    requests at once keeps occupancy over the threshold, the autoscaler
    grows the fleet mid-soak, and the soak still conserves."""
    report = run_distributed_soak(
        index_dir, shards=2, replicas=1, threads=8, queries=90, seed=4,
        chaos=False, autoscale=True, device="cpu",
        workload={"kind": "zipf", "skew": 0.8, "burst": 3.0},
        worker_deadline_s=3.0,
        router_config=RouterConfig(deadline_ms=8000.0, max_concurrency=2,
                                   max_queue=128),
        rundir=str(tmp_path / "run"), recovery_timeout_s=120.0)
    assert report["served"] + report["shed"] == report["submitted"]
    assert report["errors"] == 0, report["error_samples"]
    assert report["deadlocked"] == 0
    sc = _scale_checks(report)
    assert sc["autoscaler"]["enabled"] is True
    assert sc["events"] >= 2               # one replica a shard grew
    assert sc["first_up_reason"] in ("sustained_pressure", "slo_burn")
    assert set(sc) >= FIRST_UP_KEYS
    assert sc["mean_replicas"] >= 1.0
    assert report["burst_p99_ms"] > 0
    assert report["recovery_full"] == report["recovery_probes"]
    assert obs.get_registry().gauges()["router.occupancy"] >= 0.0


# -- the command line -----------------------------------------------------------


@pytest.mark.parametrize("env", [{}, {"TPU_IR_AUTOSCALE": "1",
                                      "TPU_IR_SCALE_MAX_REPLICAS": "6",
                                      "TPU_IR_SCALE_COOLDOWN_S": "0.5"}],
                         ids=["defaults", "set"])
def test_scale_json_equals_jax(env, monkeypatch, capsys):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert port_cli.main(["scale"]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(["scale"]) == 0
    want = capsys.readouterr().out
    assert json.loads(got) == json.loads(want)
    assert got.strip() == want.strip()


def test_scale_url_reads_the_live_autoscaler(capsys):
    fleet, router = FakeFleet(), FakeRouter()
    a = Autoscaler(fleet, router, AutoscaleConfig(**_BASE))
    router.admission.inflight = 9
    for now in (1.0, 2.0, 3.0):
        a.tick(now=now)
    with MetricsServer() as server:
        assert port_cli.main(["scale", "--url", server.url]) == 0
    out = json.loads(capsys.readouterr().out)
    jsnap = jax_autoscale.Autoscaler(
        FakeFleet(), FakeRouter(),
        jax_autoscale.AutoscaleConfig(**_BASE)).snapshot()
    assert set(out["live"]) == set(jsnap)
    assert out["live"]["last_decision"]["action"] == "up"
    assert out["live"]["lifecycle"] == fleet.lifecycle()
    # no server there: one error line, exit 1
    assert port_cli.main(["scale", "--url", "http://127.0.0.1:9"]) == 1
    assert capsys.readouterr().err.startswith("error: cannot read")


def test_serve_bench_autoscale_needs_shards_as_jax(index_dir, capsys):
    assert port_cli.main(["serve-bench", index_dir, "--autoscale",
                          "--device", "cpu"]) == 2
    got = capsys.readouterr().err
    assert jax_cli.main(["serve-bench", index_dir, "--autoscale",
                         "--backend", "cpu"]) == 2
    assert got.strip() == capsys.readouterr().err.strip()


@pytest.mark.parametrize("lead", [[], ["--lead", "2.5"]],
                         ids=["default", "set"])
def test_serve_bench_lead_runs_the_forecast_arm(index_dir, lead, capsys,
                                                monkeypatch):
    """`serve-bench --shards 2 --autoscale [--lead S]` runs the forecast
    arm between the reactive arm and the static control, in both
    packages: one AutoscaleConfig, the forecast arm's differing only by
    `forecast_up` (= `up_occupancy`) and `forecast_lead_s` (= `--lead`,
    default 1.0), and `forecast_arm` in the report."""
    import tpu_ir.obs.bench_check as jax_bench_check
    import tpu_ir.serving as jax_serving
    import tpu_ir_torch.serving as port_serving

    monkeypatch.setattr(jax_bench_check, "append_history_row",
                        lambda row: None)
    cfgs = {"port": [], "jax": []}

    def canned(key):
        def soak(index_dir, **kw):
            cfgs[key].append(kw.get("autoscale"))
            return _canned_report(kw["replicas"])
        return soak

    monkeypatch.setattr(port_serving, "run_distributed_soak",
                        canned("port"))
    monkeypatch.setattr(jax_serving, "run_distributed_soak", canned("jax"))
    argv = ["--shards", "2", "--autoscale", "--queries", "24", *lead]
    assert port_cli.main(["serve-bench", index_dir, "--device", "cpu",
                          *argv]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(["serve-bench", index_dir, "--backend", "cpu",
                         *argv]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["forecast_arm"] == want["forecast_arm"]
    assert got["forecast_arm"]["scale"]["forecast_lead_s"] == 0.75
    reactive, forecast, static = cfgs["port"]
    assert [dataclasses.asdict(c) for c in (reactive, forecast)] == \
        [dataclasses.asdict(c) for c in cfgs["jax"][:2]]
    assert not static and not cfgs["jax"][2]      # the static control
    assert forecast.forecast_up == reactive.up_occupancy > 0
    assert forecast.forecast_lead_s == (float(lead[1]) if lead else 1.0)
    assert dataclasses.replace(forecast, forecast_up=0.0,
                               forecast_lead_s=None) == reactive


def _canned_report(replicas: int) -> dict:
    """A routed soak report with the fields both CLIs read."""
    return {
        "submitted": 24, "served": 24, "shed": 0, "errors": 0,
        "error_samples": [], "deadlocked": 0,
        "classes": {"full": 24, "degraded": 0, "partial": 0},
        "partial_fraction": 0.0, "full_mismatches": 0,
        "partial_checked": 0, "partial_mismatches": 0,
        "tagged_divergent": 0, "hedged_requests": 0,
        "recovery_probes": 16, "recovery_full": 16, "wall_s": 2.5,
        "shards": 2, "replicas": replicas, "chaos": False,
        "generations_served": {"0": 24}, "unknown_generation": 0,
        "router": {"router.hedge_fired": 1},
        "latency": {"router.request": {"p99_ms": 12.5}},
        "cache": {"hit_fraction": 0.0}, "burst_p99_ms": 11.0,
        "scale": {"events": 3, "epoch": 6, "mean_replicas": 1.6,
                  "overprovision_fraction": 0.25, "drains": [],
                  "forecast_lead_s": 0.75, "first_up_s": 1.0,
                  "first_up_reason": "sustained_pressure"},
    }


def test_serve_bench_autoscale_json_equals_jax(index_dir, capsys,
                                               monkeypatch):
    """Both packages' `serve-bench --shards 2 --autoscale --pacing` over
    one canned soak report: the port runs the elastic arm, the forecast
    arm and the static control with the same AutoscaleConfigs and soak
    arguments as `tpu_ir`'s, and prints the same JSON and history row
    (`history` null: the port writes no row)."""
    import tpu_ir.obs.bench_check as jax_bench_check
    import tpu_ir.serving as jax_serving
    import tpu_ir_torch.serving as port_serving

    monkeypatch.setattr(jax_bench_check, "append_history_row",
                        lambda row: None)
    calls = {"port": [], "jax": []}

    def canned(key):
        def soak(index_dir, **kw):
            calls[key].append(kw)
            return _canned_report(kw["replicas"])
        return soak

    monkeypatch.setattr(port_serving, "run_distributed_soak",
                        canned("port"))
    monkeypatch.setattr(jax_serving, "run_distributed_soak", canned("jax"))
    argv = ["--shards", "2", "--autoscale", "--pacing", "0.01",
            "--queries", "24", "--threads", "4"]
    assert port_cli.main(["serve-bench", index_dir, "--device", "cpu",
                          *argv]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(["serve-bench", index_dir, "--backend", "cpu",
                         *argv]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert got["static_control"] == want["static_control"]
    assert got["forecast_arm"] == want["forecast_arm"]
    assert got["history"] is None
    row, jrow = got["history_row"], want["history_row"]
    assert set(row) == set(jrow)
    assert {k: v for k, v in row.items() if k != "backend"} == {
        k: jrow[k] for k in row if k != "backend"}
    assert row["config"].endswith("-autoscale")
    # the elastic arm, the forecast arm, then the control at the mean
    # replica count (2)
    port_calls, jax_calls = calls["port"], calls["jax"]
    assert len(port_calls) == len(jax_calls) == 3
    for c, j in zip(port_calls[:2], jax_calls[:2]):
        assert dataclasses.asdict(c.pop("autoscale")) == \
            dataclasses.asdict(j.pop("autoscale"))
    for c in port_calls:
        assert c.pop("device") == "cpu"
    reactive, forecast, static = jax_calls
    assert port_calls[2].pop("autoscale") is False
    # both CLIs thread --flight-dir (None here) into each soak
    assert port_calls == [reactive, forecast, static]
    assert static["replicas"] == 2
