"""The port's cumulative cluster telemetry (tpu_ir_torch/obs/aggregate.py's
snapshots, their merge and spool, the SpoolWriter; the time series'
spool; `/cluster`, `stats --cluster`, `metrics --cluster` and `top`) held
against `tpu_ir`'s on the CPU, after tests/test_obs_cluster.py and
tests/test_timeseries.py.

Merges are compared exactly (the same JSON: counters and bucket counts
are integers, the seconds are added in the same order, gauges fold by
the same policy in the same order); a spool one package writes is merged
by the other, both ways. No worker process is spawned."""

import json
import os
import random
import threading
import time
import urllib.error
import urllib.request

import pytest

from tpu_ir import cli as jax_cli
from tpu_ir import obs as jax_obs
from tpu_ir.obs import aggregate as jax_agg
from tpu_ir.obs import timeseries as jax_ts
from tpu_ir.obs.registry import TelemetryRegistry as JaxRegistry
from tpu_ir.obs.server import MetricsServer as JaxMetricsServer

from tpu_ir_torch import cli as port_cli
from tpu_ir_torch import obs
from tpu_ir_torch.obs import aggregate as agg
from tpu_ir_torch.obs import timeseries as ts
from tpu_ir_torch.obs.histogram import NUM_BUCKETS
from tpu_ir_torch.obs.registry import TelemetryRegistry
from tpu_ir_torch.obs.server import MetricsServer

OBS = {"port": obs, "jax": jax_obs}
AGG = {"port": agg, "jax": jax_agg}
TS = {"port": ts, "jax": jax_ts}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("TPU_IR_TELEMETRY_DIR", raising=False)
    for o in OBS.values():
        o.reset_all()
    yield
    for o in OBS.values():
        o.reset_all()


def _random_registry(rng, cls=TelemetryRegistry):
    """tpu_ir's test registry: random counters (declared and not), a
    gauge of each policy, histograms of random latencies."""
    reg = cls()
    for _ in range(rng.randint(3, 12)):
        reg.incr(rng.choice(["serving.submitted", "serving.degraded",
                             "fault.score.hang", "test.other"]),
                 rng.randint(1, 7))
    for _ in range(rng.randint(10, 60)):
        reg.observe(rng.choice(["dispatch", "request.full", "build.spill"]),
                    rng.lognormvariate(-6.0, 2.0))
    reg.set_gauge("router.occupancy", rng.random())
    reg.update_gauge_max("device.peak_bytes", rng.randint(1, 1 << 30))
    return reg


def _snap(reg, i: int, t: str = "2026-01-01T00:00:00") -> dict:
    s = reg.collect_state()
    s.update(host="h", pid=1000 + i, time=t, process_index=0)
    return s


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=repr)


# -- the raw snapshot and its merge ----------------------------------------------


def test_collect_state_and_local_snapshot_shape_equal_tpu_ir():
    """The same events in both registries: the raw snapshot's keys and
    stamps, the counters and bucket counts of the names both declare,
    and only the gauges a caller set."""
    snaps = {}
    for p, o in OBS.items():
        reg = o.get_registry()
        reg.incr("serving.submitted", 3)
        reg.observe("request", 0.004)
        reg.set_gauge("router.occupancy", 0.25)
        snaps[p] = AGG[p].local_snapshot()
    port, jax = snaps["port"], snaps["jax"]
    assert set(port) == set(jax)
    assert set(port["histograms"]["request"]) == {"counts", "sum_s"}
    assert port["gauges"] == jax["gauges"] == {"router.occupancy": 0.25}
    assert port["histograms"]["request"] == jax["histograms"]["request"]
    shared = set(port["counters"]) & set(jax["counters"])
    assert "serving.submitted" in shared
    assert {k: port["counters"][k] for k in shared} == \
        {k: jax["counters"][k] for k in shared}
    assert port["process_index"] == 0 and port["pid"] == os.getpid()
    # a reset drains and re-baselines in the same step
    drained = obs.get_registry().collect_state(reset=True)
    assert drained["counters"]["serving.submitted"] == 3
    after = obs.get_registry().collect_state()
    assert after["resets"] == drained["resets"] and after["gauges"] == {}
    assert after["counters"]["serving.submitted"] == 0


@pytest.mark.parametrize("seed", [11, 23, 31])
def test_merge_snapshots_equals_tpu_ir(seed):
    """Five processes' snapshots (the port's registries, at the same wall
    second, so the gauges fold by seq and run id): the port's merge is
    tpu_ir's, in any order, and its counters and histogram counts are
    the processes' sums."""
    rng = random.Random(seed)
    snaps = [_snap(_random_registry(rng), i) for i in range(5)]
    merged = agg.merge_snapshots(snaps)
    assert _canon(merged) == _canon(jax_agg.merge_snapshots(snaps))
    back = agg.merge_snapshots(list(reversed(snaps)))
    assert back["counters"] == merged["counters"]
    assert back["histograms"] == merged["histograms"]
    assert back["gauges"] == merged["gauges"]
    assert merged["processes"] == 5
    for k in {k for s in snaps for k in s["counters"]}:
        assert merged["counters"][k] == sum(s["counters"].get(k, 0)
                                            for s in snaps)
    for name in {n for s in snaps for n in s["histograms"]}:
        assert merged["histograms"][name]["count"] == sum(
            sum(s["histograms"][name]["counts"]) for s in snaps
            if name in s["histograms"])
    assert merged["gauges"]["device.peak_bytes"] == max(
        s["gauges"]["device.peak_bytes"] for s in snaps)


def test_merge_rejects_a_newer_schema_and_foreign_buckets():
    good = TelemetryRegistry().collect_state()
    bad = json.loads(json.dumps(good))
    bad["histograms"]["dispatch"] = {"counts": [0] * (NUM_BUCKETS - 1),
                                     "sum_s": 0.0}
    for m in AGG.values():
        with pytest.raises(ValueError, match="newer"):
            m.merge_snapshots([good, {**good, "schema": 99}])
        with pytest.raises(ValueError, match="buckets"):
            m.merge_snapshots([bad])


def test_gather_cluster_is_this_process():
    obs.get_registry().incr("serving.submitted", 4)
    got = agg.gather_cluster()
    assert got["processes"] == 1
    assert got["counters"]["serving.submitted"] == 4
    assert set(got) == set(jax_agg.gather_cluster())
    assert agg.gather_cluster(reset=True)["counters"][
        "serving.submitted"] == 4
    assert obs.get_registry().get("serving.submitted") == 0


# -- the spool ------------------------------------------------------------------


def test_spool_roundtrip_keeps_the_newest_generation(tmp_path, monkeypatch):
    d = str(tmp_path / "spool")
    monkeypatch.setenv("TPU_IR_TELEMETRY_DIR", d)
    reg = obs.get_registry()
    reg.incr("serving.submitted", 3)
    assert agg.spool_write() is not None
    reg.incr("serving.submitted", 4)
    assert agg.spool_write() is not None
    snaps = agg.read_spool(d)
    assert len(snaps) == 1 and len(os.listdir(d)) == 1
    assert snaps[0]["counters"]["serving.submitted"] == 7
    other = json.loads(json.dumps(snaps[0]))
    other["run_id"], other["pid"] = "deadbeef", 999999
    (tmp_path / "spool" / "telemetry-otherhost-999999-000001.json"
     ).write_text(json.dumps(other))
    merged = agg.merge_snapshots(agg.read_spool(d))
    assert merged["processes"] == 2
    assert merged["counters"]["serving.submitted"] == 14


def test_merge_spool_counts_the_spooling_process_once(tmp_path,
                                                      monkeypatch):
    d = str(tmp_path / "spool")
    monkeypatch.setenv("TPU_IR_TELEMETRY_DIR", d)
    obs.get_registry().incr("serving.submitted", 8)
    assert agg.spool_write() is not None
    merged = agg.merge_spool(include_local=True)
    assert merged["processes"] == 1
    assert merged["counters"]["serving.submitted"] == 8
    other = TelemetryRegistry()
    other.incr("serving.submitted", 5)
    (tmp_path / "spool" / "telemetry-h-424242-000001.json").write_text(
        json.dumps(_snap(other, 424242 - 1000)))
    merged = agg.merge_spool(include_local=True)
    assert merged["processes"] == 2
    assert merged["counters"]["serving.submitted"] == 13
    # a fresh command (not include_local) reads the spool alone
    assert agg.merge_spool()["counters"]["serving.submitted"] == 13


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_a_spool_of_one_package_merges_in_the_other(tmp_path, monkeypatch,
                                                    writer, reader):
    """One package spools its snapshot and its time-series store; the
    other merges both as a second process's: the cumulative counters add,
    and /timeseries?cluster=1's rate is the two processes' sum over the
    same wall window."""
    d = tmp_path / "spool"
    monkeypatch.setenv("TPU_IR_TELEMETRY_DIR", str(d))
    now = 1_000 * round(time.time() / 1_000)     # a window boundary
    for p in (writer, reader):
        reg = OBS[p].get_registry()
        store = TS[p].get_store()
        store.sample(now=now - 10.0)
        reg.incr("serving.submitted", 10 if p == writer else 30)
        store.sample(now=now)
    assert AGG[writer].spool_write() is not None
    assert TS[writer].spool_write_store() is not None
    names = sorted(os.listdir(d))
    assert [n.split("-")[0] for n in names] == ["telemetry", "timeseries"]
    merged = AGG[reader].merge_spool(include_local=True)
    assert merged["processes"] == 2
    assert merged["counters"]["serving.submitted"] == 40
    docs = TS[reader].read_spool_stores()
    assert len(docs) == 1 and set(docs[0]) == {"run_id", "pid", "host",
                                               "time", "store"}
    body = TS[reader].payload(cluster=True)
    assert body["cluster"] and body["sources"] == 2
    pts = body["series"]["submitted_per_s"]["tiers"][0]
    assert pts[-1] == [round(now, 3), 4.0]       # (10 + 30) / 10 s


def test_spool_writer_refreshes_and_writes_its_last_record(tmp_path):
    d = str(tmp_path / "spool")
    w = agg.SpoolWriter(out_dir=d, interval_s=0.02).start()
    try:
        assert "tpu-ir-obs-spool" in [t.name for t in threading.enumerate()]
        obs.get_registry().incr("serving.submitted", 2)
        deadline = time.monotonic() + 10
        while not agg.read_spool(d) and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        obs.get_registry().incr("serving.submitted", 1)
        w.stop()
    assert "tpu-ir-obs-spool" not in [t.name for t in threading.enumerate()]
    snaps = agg.read_spool(d)
    assert len(snaps) == 1
    assert snaps[0]["counters"]["serving.submitted"] == 3   # the last one
    assert len(ts.read_spool_stores(d)) == 1
    # no dir: no thread
    idle = agg.SpoolWriter(out_dir=None).start()
    assert idle._thread is None


# -- the surfaces ---------------------------------------------------------------


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return json.loads(r.read().decode())


def test_cluster_endpoint_equals_tpu_ir(tmp_path, monkeypatch):
    """Two foreign processes in the spool and each server's own process:
    both servers' /cluster count three, the foreign counters once and
    their own once (the SpoolWriter's file displaced by the live
    snapshot); without a spool dir both answer 404 with one body."""
    d = tmp_path / "spool"
    d.mkdir()
    for i, n in enumerate((5, 11)):
        reg = TelemetryRegistry()
        reg.incr("serving.submitted", n)
        (d / f"telemetry-h-{1000 + i}-000001.json").write_text(
            json.dumps(_snap(reg, i)))
    bodies = {}
    for p, server in (("port", MetricsServer), ("jax", JaxMetricsServer)):
        OBS[p].get_registry().incr("serving.submitted", 2)
        missing = server(port=0, spool=False).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(f"{missing.url}/cluster")
            assert e.value.code == 404
            bodies[p, "404"] = json.loads(e.value.read())
        finally:
            missing.stop()
        monkeypatch.setenv("TPU_IR_TELEMETRY_DIR", str(d))
        with server(port=0) as srv:
            bodies[p] = _get(f"{srv.url}/cluster")
            page = urllib.request.urlopen(f"{srv.url}/cluster?format=html",
                                          timeout=5).read().decode()
            assert "tpu-ir cluster" in page
            if p == "port":
                assert "/cluster" in _get(f"{srv.url}/")["endpoints"]
        monkeypatch.delenv("TPU_IR_TELEMETRY_DIR")
        # the server's last spool write: this process's file, displaced
        # by the other package's snapshot in the next round
        for name in os.listdir(d):
            if f"-{os.getpid()}-" in name:
                os.unlink(d / name)
    assert bodies["port", "404"] == bodies["jax", "404"]
    for p in OBS:
        assert bodies[p]["processes"] == 3
        assert bodies[p]["counters"]["serving.submitted"] == 18
    assert set(bodies["port"]) == set(bodies["jax"])


def _feed_store(module, rng_seed=7):
    rng = random.Random(rng_seed)
    store = module.get_store()
    for i in range(12):
        store.add_window({
            "t": 5_000.0 + i, "dur_s": 1.0,
            "c": {"serving.submitted": rng.randrange(1, 50),
                  "router.requests": rng.randrange(1, 9)},
            "g": {"router.occupancy": rng.random()},
            "h": {"request": ([0] * 10 + [rng.randrange(1, 5)]
                              + [0] * (NUM_BUCKETS - 11), 0.01)}})


@pytest.mark.parametrize("json_flag", [True, False], ids=["json", "view"])
def test_top_equals_tpu_ir(capsys, json_flag):
    """`top --json` prints tpu_ir's payload for the same store, and the
    terminal view the same lines; `--url` reads a server's /timeseries."""
    outs = {}
    for p, cli in (("port", port_cli.main), ("jax", jax_cli.main)):
        _feed_store(TS[p])
        assert cli(["top"] + (["--json"] if json_flag else [])) == 0
        outs[p] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    if json_flag:
        body = json.loads(outs["port"])
        assert body["series"]["submitted_per_s"]["tiers"][0]
        with MetricsServer(port=0) as srv:
            assert port_cli.main(["top", "--json", "--url", srv.url]) == 0
            remote = json.loads(capsys.readouterr().out)
        assert remote["series"]["occupancy"]["tiers"][0][:12] == \
            body["series"]["occupancy"]["tiers"][0]
    else:
        assert "submitted_per_s" in outs["port"]
        assert port_cli.main(["top", "--tier", "7"]) == 2
        assert port_cli.main(["top", "--url", "http://127.0.0.1:9"]) == 1
