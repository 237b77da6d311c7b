"""The port's ingest and serve soak on the CPU, held against `tpu_ir`.

`run_ingest_soak` at `tpu_ir`'s tier-1 size (tests/test_wal.py): a
feeder child SIGKILLed mid-feed, its successor's lease takeover and WAL
replay, no acknowledged write lost, no stale answer, conservation; its
report has `tpu_ir`'s keys and the port's launch split, and its
freshness lag is the `ingest.freshness_lag_ms` gauge /healthz reads. `ingest --soak-bench`
prints `tpu_ir`'s JSON (over one canned report in both packages), and a
breach raises."""

import json
import threading

import pytest

from tpu_ir import cli as jax_cli

from tpu_ir_torch import cli as port_cli
from tpu_ir_torch import faults, obs
from tpu_ir_torch.index.segments import LiveIndex
from tpu_ir_torch.obs.server import health_snapshot
from tpu_ir_torch.serving import run_ingest_soak
from tpu_ir_torch.serving import soak as port_soak

# tpu_ir's run_ingest_soak report (a breach raises, so its flight_record
# key never reaches a caller)
REPORT_KEYS = {
    "docs", "base_docs", "acked", "recovered_docs", "lost_acked",
    "unexpected_docs", "kills", "child_replayed", "lease_takeover",
    "feed_wall_s", "ingest_docs_per_s", "freshness_lag_ms",
    "freshness_samples", "swaps", "generations_seen", "submitted",
    "served", "shed", "errors", "stale", "error_samples", "wall_s"}
# the port's own: its frontend's kernel launches, as a worker's /healthz
# splits them (nothing compiles per shape, so tpu_ir has no counterpart)
PORT_KEYS = {"kernel_launches", "warm_launches"}


@pytest.fixture(autouse=True)
def _clean_port_state():
    faults.clear()
    obs.reset_all()
    yield
    faults.clear()
    obs.reset_all()


def test_ingest_soak_survives_midstream_sigkill(tmp_path, monkeypatch):
    import tpu_ir_torch

    # the CPU launches no kernel: a stand-in counter takes one cold_tier
    # launch a search and one hot_stage launch a reload, so the report's
    # split shows where the soak counts its warm-ups
    counts = {"cold_tier": 0, "hot_stage": 0}
    count_lock = threading.Lock()
    monkeypatch.setattr(tpu_ir_torch, "kernel_launches",
                        lambda: dict(counts))
    frontend_cls = port_soak.ServingFrontend

    def counted(name, method):
        def wrapper(self, *args, **kwargs):
            with count_lock:
                counts[name] += 1
            return method(self, *args, **kwargs)
        return wrapper

    monkeypatch.setattr(frontend_cls, "search",
                        counted("cold_tier", frontend_cls.search))
    monkeypatch.setattr(frontend_cls, "reload_generation",
                        counted("hot_stage", frontend_cls.reload_generation))
    live = str(tmp_path / "live")
    report = run_ingest_soak(live, docs=16, base_docs=6, buffer_docs=4,
                             compact_every=8, timeout_s=150.0,
                             device="cpu")
    assert set(report) == REPORT_KEYS | PORT_KEYS
    total, warm = report["kernel_launches"], report["warm_launches"]
    # every search counted (a shed one too); the 6 warm-up searches and
    # every reload are warm-ups; a probe served during a reload counts as
    # the reload's
    assert total == {"cold_tier": 6 + report["submitted"],
                     "hot_stage": report["swaps"]}
    assert warm["hot_stage"] == report["swaps"]
    assert 6 <= warm["cold_tier"] < total["cold_tier"]
    assert report["kills"] == 1
    assert report["child_replayed"] >= 1      # the kill landed mid-work
    assert report["lease_takeover"]
    assert report["lost_acked"] == 0 and report["unexpected_docs"] == []
    assert report["stale"] == 0 and report["errors"] == 0
    assert report["served"] + report["shed"] == report["submitted"] > 0
    assert report["swaps"] >= 1 and report["freshness_samples"] >= 1
    assert report["ingest_docs_per_s"] > 0
    assert report["freshness_lag_ms"] > 0
    assert report["acked"] >= 16 and report["recovered_docs"] == 6 + 16
    assert set(LiveIndex.open(live).live_doc_map()) == {
        port_soak._feed_doc(i)[0] for i in range(22)}
    # the run's median lag is the gauge /healthz serves
    assert obs.get_registry().gauges()["ingest.freshness_lag_ms"] \
        == report["freshness_lag_ms"]
    assert health_snapshot()["ingest"]["freshness_lag_ms"] \
        == report["freshness_lag_ms"]
    hist = obs.get_registry().hist_state()["ingest.freshness"][0]
    assert sum(hist) == report["freshness_samples"]


def test_flush_ancestor_finds_the_durable_commit(tmp_path):
    """A compacted generation's freshness clock starts at its nearest
    ancestor whose commit carried mutations: the same manifest in both
    packages."""
    from tpu_ir.index.segments import LiveIndex as JaxLiveIndex
    from tpu_ir.serving.soak import _flush_ancestor as jax_flush_ancestor
    from tpu_ir_torch.index.ingest import IngestWriter

    live = str(tmp_path / "live")
    LiveIndex.create(live, num_shards=2, chargram_ks=())
    with IngestWriter(live, auto_merge=False, device="cpu") as w:
        for i in range(5):
            w.update(*port_soak._feed_doc(i))
        w.flush()
        w.compact_all()
    lv, jlv = LiveIndex.open(live), JaxLiveIndex.open(live)
    for g in range(1, lv.current_gen() + 1):
        got = port_soak._flush_ancestor(lv, g)
        want = jax_flush_ancestor(jlv, g)
        assert got == want
    top = port_soak._flush_ancestor(lv, lv.current_gen())
    assert top is not None and top["note"] in ("flush", "close")
    assert port_soak._flush_ancestor(lv, 10_000) is None


def test_soak_bench_json_equals_jax(tmp_path, capsys, monkeypatch):
    """Both packages' `ingest --soak-bench` over one canned soak report:
    the same JSON and history row but its backend, `history` null in the
    port, the soak asked for the port's device."""
    import tpu_ir.obs.bench_check as jax_bench_check
    import tpu_ir.serving.soak as jax_soak

    report = {k: 0 for k in REPORT_KEYS}
    report.update(docs=48, kills=1, swaps=3, ingest_docs_per_s=12.5,
                  freshness_lag_ms=40.25, generations_seen=[1, 3])
    calls = []

    def canned(live_dir, **kw):
        calls.append((live_dir, kw))
        return dict(report)

    monkeypatch.setattr(port_soak, "run_ingest_soak", canned)
    monkeypatch.setattr(jax_soak, "run_ingest_soak", canned)
    monkeypatch.setattr(jax_bench_check, "append_history_row",
                        lambda row: None)
    live = str(tmp_path / "live")
    assert port_cli.main(["ingest", live, "--soak-bench",
                          "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(["ingest", live, "--soak-bench"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) == REPORT_KEYS | {"history", "history_row"}
    assert got["history"] is None
    assert got["history_row"]["backend"] == "cpu"
    got["history_row"].pop("backend")
    want["history_row"].pop("backend")
    assert got["history_row"] == want["history_row"]
    assert {k: got[k] for k in REPORT_KEYS} == {k: want[k]
                                                for k in REPORT_KEYS}
    assert calls == [(live, {"device": "cpu"}), (live, {})]


def test_soak_breach_raises(tmp_path, monkeypatch):
    """An acknowledged doc missing from the final generation is a breach:
    the soak raises naming it. (Only the parent's final read loses it:
    the parent's writer opens before that doc exists.)"""
    real = LiveIndex.live_doc_map
    lost = port_soak._feed_doc(10)[0]

    def live_doc_map(self, gen=None):
        m = dict(real(self, gen))
        m.pop(lost, None)
        return m

    monkeypatch.setattr(LiveIndex, "live_doc_map", live_doc_map)
    with pytest.raises(AssertionError, match="lost_acked=1"):
        run_ingest_soak(str(tmp_path / "live"), docs=8, base_docs=4,
                        buffer_docs=3, compact_every=4, timeout_s=150.0,
                        device="cpu")
