"""The autoscaler of the shard fleet (the port of
`tpu_ir/serving/autoscale.py`).

An `Autoscaler` reads the serving tier's own telemetry and answers
through the ShardSet's membership protocol (serving/shardset.py):

- **scale up** on sustained pressure: one warm replica a shard
  (`ShardSet.grow`: spawn, warm-up and residency pre-warm, and only then
  the dispatch grid, so a burst never sends traffic to a cold worker);
- **scale down** on sustained idleness: `ShardSet.retire_replica`, drain
  not drop (the replica leaves the dispatch grid at once, finishes what
  it holds, then exits; shed + served == submitted holds throughout).

Pressure is the router's admission occupancy (executing + queued over
its capacity), or the SLO windows' fast burn (obs/disttrace.py), or the
`forecast_occupancy` gauge: the occupancy that obs/timeseries.py's
Forecaster predicts `forecast_lead_s` ahead from a sinusoid fit over the
`router.occupancy` series each tick publishes. run_distributed_soak
drives that Forecaster when the config arms the third signal
(`forecast_up > 0`); it stays off at the default `forecast_up = 0`, and a
scale-up it alone armed has the reason "forecast".

Two dampers keep a diurnal wave from making the fleet flap:

- **hysteresis**: a decision needs `sustain_up` / `sustain_down`
  consecutive ticks over or under its threshold, the thresholds far
  apart;
- **cooldown**: after a membership change, decisions wait `cooldown_s`
  (each held back counts `scale.cooldown_skipped`), so the fleet sees
  what its last change did before the next.

`tick()` is one synchronous decision (tests, the soak's scaler loop);
`run_in_thread()` runs a daemon poller. `snapshot()` is the `/healthz`
autoscaler section (obs/server.py::register_autoscaler).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass, replace

from .. import envvars
from ..obs import disttrace, get_registry

logger = logging.getLogger(__name__)


def utilization(samples, worker_concurrency: int) -> tuple[float, float]:
    """(mean_replicas, overprovision_fraction) of (least active replicas
    a shard, router in-flight) samples: the mean of the first, and the
    mean share of active replicas the in-flight load did not need
    (needed = ceil(in_flight / worker_concurrency), clamped to [1,
    active]; every routed request fans out to every shard, so the
    router's in-flight count is each shard's demand). (-1.0, 0.0) with
    no sample."""
    if not samples:
        return -1.0, 0.0
    wc = max(worker_concurrency, 1)
    over = 0.0
    for active, inflight in samples:
        if active > 0:
            needed = min(active, max(1, math.ceil(inflight / wc)))
            over += (active - needed) / active
    return (sum(a for a, _ in samples) / len(samples),
            over / len(samples))


@dataclass
class AutoscaleConfig:
    """The autoscaler's knobs; a None reads its TPU_IR_SCALE_* variable."""

    min_replicas: int | None = None    # per-shard floor (never drained)
    max_replicas: int | None = None    # per-shard ceiling
    cooldown_s: float | None = None    # least seconds between changes
    interval_s: float = 0.05           # thread mode's tick period
    up_occupancy: float = 0.75         # occupancy that arms a scale-up
    down_occupancy: float = 0.15       # occupancy that arms a drain
    sustain_up: int = 4                # ticks in a row to scale up
    sustain_down: int = 20             # ticks in a row to drain
    drain_timeout_s: float = 30.0      # the retire's bound on its drain
    slo_burn_up: float = 2.0           # fast-window burn that arms a
    #                                    scale-up (0 turns it off)
    forecast_up: float = 0.0           # forecast_occupancy that arms a
    #                                    scale-up (0 turns it off)
    forecast_lead_s: float | None = None  # the forecast's horizon; None
    #                                    reads TPU_IR_SCALE_LEAD_S

    def resolved(self) -> "AutoscaleConfig":
        """This config with every None read from its variable."""
        return replace(
            self,
            min_replicas=(self.min_replicas
                          if self.min_replicas is not None else
                          envvars.get_int("TPU_IR_SCALE_MIN_REPLICAS")),
            max_replicas=(self.max_replicas
                          if self.max_replicas is not None else
                          envvars.get_int("TPU_IR_SCALE_MAX_REPLICAS")),
            cooldown_s=(self.cooldown_s
                        if self.cooldown_s is not None else
                        envvars.get_float("TPU_IR_SCALE_COOLDOWN_S")),
            forecast_lead_s=(self.forecast_lead_s
                             if self.forecast_lead_s is not None else
                             envvars.get_float("TPU_IR_SCALE_LEAD_S")))


def autoscale_enabled(flag: bool | None = None) -> bool:
    """An explicit flag wins, else TPU_IR_AUTOSCALE."""
    return (envvars.get_bool("TPU_IR_AUTOSCALE")
            if flag is None else bool(flag))


class Autoscaler:
    """One control loop over (shardset, router); thread-safe: `tick()` may
    run from a caller or the owned poller while /healthz reads
    `snapshot()`."""

    def __init__(self, shardset, router,
                 config: AutoscaleConfig | None = None):
        self.shardset = shardset
        self.router = router
        self.config = (config or AutoscaleConfig()).resolved()
        if self.config.max_replicas < self.config.min_replicas:
            raise ValueError("TPU_IR_SCALE_MAX_REPLICAS < "
                             "TPU_IR_SCALE_MIN_REPLICAS")
        self._lock = threading.Lock()
        self._ticks_over = 0
        self._ticks_under = 0
        self._cooldown_until = 0.0
        self._last_decision = {"action": None, "reason": "never_ticked"}
        self._ticks = 0
        # (least active replicas, router in-flight) a tick: what
        # utilization_report integrates
        self._samples: list = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        from ..obs.server import register_autoscaler

        register_autoscaler(self)

    # -- the signal --------------------------------------------------------

    def occupancy(self) -> float:
        """The router's admitted requests (executing + queued) over its
        execution capacity: above 1 requests queue, near 0 the fleet
        idles. The router sees the whole fleet's demand in one number."""
        adm = self.router.admission
        return ((adm.in_flight() + adm.queue_depth())
                / max(adm.max_concurrency, 1))

    # -- the decision ------------------------------------------------------

    def tick(self, now: float | None = None) -> dict:
        """One decision: read the signals, move the hysteresis counters
        and, outside the cooldown, make at most one membership change.
        Returns the decision record."""
        cfg = self.config
        now = time.monotonic() if now is None else now
        occ = self.occupancy()
        # the second signal: requests going bad (slow, partial, shed)
        # even at modest occupancy
        burn = disttrace.slo_burn_signal()
        burning = cfg.slo_burn_up > 0 and burn >= cfg.slo_burn_up
        # the third: predicted occupancy forecast_lead_s ahead
        reg = get_registry()
        reg.set_gauge("router.occupancy", occ)
        fc = reg.gauges().get("forecast_occupancy", 0.0)
        forecasting = cfg.forecast_up > 0 and fc >= cfg.forecast_up
        active = self.shardset.active_replicas()
        with self._lock:
            self._ticks += 1
            if len(self._samples) < 200_000:
                self._samples.append((active, self.router.admission
                                      .in_flight()))
            if occ >= cfg.up_occupancy or burning or forecasting:
                self._ticks_over += 1
                self._ticks_under = 0
            elif occ <= cfg.down_occupancy:
                self._ticks_under += 1
                self._ticks_over = 0
            else:
                self._ticks_over = 0
                self._ticks_under = 0
            want = None
            if self._ticks_over >= cfg.sustain_up:
                want = "up"
            elif self._ticks_under >= cfg.sustain_down:
                want = "down"
            in_cooldown = now < self._cooldown_until
        decision = {"action": None, "reason": "steady",
                    "occupancy": round(occ, 3), "active": active,
                    "slo_burn": round(burn, 3),
                    "forecast": round(fc, 3), "tick": self._ticks}
        if want == "up":
            if active >= cfg.max_replicas:
                decision["reason"] = "at_max_replicas"
            elif in_cooldown:
                reg.incr("scale.cooldown_skipped")
                decision["reason"] = "cooldown"
            else:
                decision.update(self._scale_up(now))
                if decision["action"] == "up" and occ < cfg.up_occupancy:
                    # occupancy alone did not arm it: credit the forecast
                    # first, then the burn
                    if forecasting and not burning:
                        decision["reason"] = "forecast"
                        reg.incr("forecast.scaleups")
                    elif burning:
                        decision["reason"] = "slo_burn"
        elif want == "down":
            if active <= cfg.min_replicas:
                decision["reason"] = "at_min_replicas"
            elif in_cooldown:
                reg.incr("scale.cooldown_skipped")
                decision["reason"] = "cooldown"
            else:
                decision.update(self._scale_down(now))
        with self._lock:
            if decision["action"] is not None:
                self._ticks_over = 0
                self._ticks_under = 0
            self._last_decision = decision
        return decision

    def _scale_up(self, now: float) -> dict:
        try:
            added = self.shardset.grow()
        except Exception as e:  # noqa: BLE001 — a failed spawn must not
            # end the loop; the pressure arms the next attempt
            logger.exception("autoscaler scale-up failed")
            return {"action": None, "reason": f"up_failed: {e!r}"}
        # a grown slot may reuse a retired one: its new worker starts
        # with a clean breaker
        if hasattr(self.router, "reset_breaker"):
            for s, r in added:
                self.router.reset_breaker(s, r)
        with self._lock:
            self._cooldown_until = now + self.config.cooldown_s
        return {"action": "up", "reason": "sustained_pressure",
                "slots": added}

    def _scale_down(self, now: float) -> dict:
        # drain the highest active replica of every shard (grow's
        # inverse), picked from one lifecycle read so a concurrent kill
        # cannot split the pick
        life = self.shardset.lifecycle()
        picks = []
        for s, states in enumerate(life):
            active_rs = [r for r, st in enumerate(states)
                         if st == "active"]
            if len(active_rs) > self.config.min_replicas:
                picks.append((s, active_rs[-1]))
        if not picks:
            return {"action": None, "reason": "no_drainable_replica"}
        drains = []
        for s, r in picks:
            try:
                drains.append(self.shardset.retire_replica(
                    s, r, drain_timeout_s=self.config.drain_timeout_s))
            except Exception:  # noqa: BLE001 — a kill that raced the
                # pick leaves a dead slot, not a broken loop
                logger.exception("autoscaler drain failed")
        with self._lock:
            self._cooldown_until = now + self.config.cooldown_s
        return {"action": "down", "reason": "sustained_idleness",
                "drains": drains}

    # -- thread mode -------------------------------------------------------

    def run_in_thread(self) -> "Autoscaler":
        self._thread = threading.Thread(
            target=self._run, name="tpu-ir-autoscaler", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — one bad tick does not
                logger.exception("autoscaler tick")  # end the loop
            self._stop.wait(self.config.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None

    def __enter__(self) -> "Autoscaler":
        return self.run_in_thread()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- accounting and introspection --------------------------------------

    def utilization_report(self, worker_concurrency: int | None = None
                           ) -> dict:
        """The ticks integrated by `utilization` (a worker's concurrency
        defaults to the fleet's max_concurrency): `mean_replicas`,
        `overprovision_fraction` (both -1.0 before the first tick) and
        the tick count."""
        wc = (worker_concurrency
              or getattr(self.shardset, "max_concurrency", 1))
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return {"mean_replicas": -1.0,
                    "overprovision_fraction": -1.0, "ticks": 0}
        mean_repl, over = utilization(samples, wc)
        return {"mean_replicas": round(mean_repl, 3),
                "overprovision_fraction": round(over, 4),
                "ticks": len(samples)}

    def snapshot(self) -> dict:
        """The /healthz autoscaler section: the epoch, each replica's
        lifecycle, the hysteresis counters, the last decision and the
        config."""
        cfg = self.config
        with self._lock:
            last = dict(self._last_decision)
            over, under = self._ticks_over, self._ticks_under
            cooldown_left = max(0.0,
                                self._cooldown_until - time.monotonic())
        return {
            "enabled": True,
            "epoch": self.shardset.epoch(),
            "lifecycle": self.shardset.lifecycle(),
            "events": len(self.shardset.events()),
            "occupancy": round(self.occupancy(), 3),
            "ticks_over": over, "ticks_under": under,
            "cooldown_remaining_s": round(cooldown_left, 3),
            "last_decision": last,
            "config": {
                "min_replicas": cfg.min_replicas,
                "max_replicas": cfg.max_replicas,
                "cooldown_s": cfg.cooldown_s,
                "up_occupancy": cfg.up_occupancy,
                "down_occupancy": cfg.down_occupancy,
                "sustain_up": cfg.sustain_up,
                "sustain_down": cfg.sustain_down,
                "slo_burn_up": cfg.slo_burn_up,
                "forecast_up": cfg.forecast_up,
                "forecast_lead_s": cfg.forecast_lead_s,
            },
        }
