"""The port's flight recorder (tpu_ir_torch/obs/recorder.py) and the
failure paths that write it, held against `tpu_ir`'s on the CPU, after
tests/test_obs.py and tests/test_disttrace.py.

Both packages dump the same scripted trace ring and counters; the
artifacts are compared line for line with the header's time, pid and seq,
the trees' clock fields and thread ids, the registry's run id and stamps
and the declared-name tables left out; the header's time-series lead-up
(two samples at fixed times) is compared whole, the memory readings by
their keys. Each package's `recent_headers` reads the other's
directory."""

import importlib
import json
import os
from pathlib import Path

import pytest

from tpu_ir import cli as jax_cli
from tpu_ir import obs as jax_obs
from tpu_ir.obs import disttrace as jax_dt
from tpu_ir.obs import recorder as jax_rec

from tpu_ir_torch import cli as port_cli
from tpu_ir_torch import faults
from tpu_ir_torch import obs as port_obs
from tpu_ir_torch.index import build_index
from tpu_ir_torch.obs import disttrace as port_dt
from tpu_ir_torch.obs import recorder as port_rec
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.serving import ServingConfig, ServingFrontend, run_soak

PACKAGES = {"port": (port_obs, port_rec, port_dt),
            "jax": (jax_obs, jax_rec, jax_dt)}
SPAN_CLOCK = {"start_ns", "dur_us", "thread_id", "thread", "time"}


@pytest.fixture(autouse=True)
def _clean_state():
    for o, _, _ in PACKAGES.values():
        o.reset_all()
    yield
    faults.clear()
    for o, _, _ in PACKAGES.values():
        o.reset_all()


def _script(o) -> None:
    """The same ring, counters and time series in one package."""
    store = o.timeseries.get_store()
    store.sample(now=1000.0)
    o.get_registry().incr("serving.submitted", 4)
    store.sample(now=1002.0)
    with o.trace("request", scoring="bm25"):
        with o.trace("dispatch", rows=2):
            with o.trace("kernel", layout="sparse"):
                pass
    with o.trace("build.parse", path="c.trec"):
        pass
    o.get_registry().incr("querylog.recorded", 3)
    o.get_registry().incr("slo.good", 2)


def _tree(span: dict) -> dict:
    out = {k: v for k, v in span.items() if k not in SPAN_CLOCK}
    if "children" in out:
        out["children"] = [_tree(c) for c in out["children"]]
    return out


def _lines(lines: list) -> list:
    return [json.loads(line) for line in lines]


def test_artifact_lines_match_tpu_ir():
    """Header, one trace line a ring entry, the telemetry line last: the
    same records, the header's keys and its time-series lead-up."""
    got = {}
    for p, (o, rec, _) in PACKAGES.items():
        _script(o)
        got[p] = _lines(rec.artifact_lines("unit_incident",
                                           extra={"k": 1}))
    port, jax = got["port"], got["jax"]
    assert len(port) == len(jax) == 4
    ph, jh = port[0], jax[0]
    assert set(ph) == set(jh)
    assert ph["timeseries"]["series"]["submitted_per_s"] == [[1002.0, 2.0]]
    volatile = {"time", "pid", "seq", "memory"}
    assert {k: v for k, v in ph.items() if k not in volatile} == \
        {k: v for k, v in jh.items() if k not in volatile}
    assert set(ph["memory"]) == set(jh["memory"])
    assert ph["schema"] == port_rec.FLIGHT_SCHEMA == jax_rec.FLIGHT_SCHEMA
    assert [r["record"] for r in port] == [r["record"] for r in jax] == [
        "header", "trace", "trace", "telemetry"]
    for a, b in zip(port[1:3], jax[1:3]):
        assert _tree(a["trace"]) == _tree(b["trace"])
    pt, jt = port[-1]["telemetry"], jax[-1]["telemetry"]
    assert set(pt) == set(jt)
    for name in ("querylog.recorded", "slo.good"):
        assert pt["counters"][name] == jt["counters"][name]
    for name in ("request", "dispatch", "kernel"):
        assert pt["histograms"][name]["count"] == \
            jt["histograms"][name]["count"] == 1
        assert set(pt["histograms"][name]) == set(jt["histograms"][name])


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_recent_headers_read_the_other_package(tmp_path, writer, reader):
    """File names and header lines are shared: each package lists the
    other's records, newest first."""
    _, wrec, _ = PACKAGES[writer]
    first = wrec.flight_dump("alpha", out_dir=str(tmp_path))
    second = wrec.flight_dump("beta", out_dir=str(tmp_path))
    os.utime(first, (1, 1))
    heads = PACKAGES[reader][1].recent_headers(str(tmp_path))
    assert [h["reason"] for h in heads] == ["beta", "alpha"]
    assert [h["path"] for h in heads] == [second, first]
    assert heads[0]["seq"] == heads[1]["seq"] + 1
    assert Path(second).name.endswith(f"-{heads[0]['seq']:03d}-beta.jsonl")


def test_rate_limit_and_force_match_tpu_ir(tmp_path):
    """Per reason: a second dump inside the interval is dropped unless
    forced; another reason is not limited; the sequence numbers."""
    got = {}
    for p, (_, rec, _) in PACKAGES.items():
        d = str(tmp_path / p)
        paths = [rec.flight_dump("breach", out_dir=d),
                 rec.flight_dump("breach", out_dir=d),
                 rec.flight_dump("breach", out_dir=d, force=True),
                 rec.flight_dump("other", out_dir=d)]
        rec.reset_rate_limit()
        paths.append(rec.flight_dump("breach", out_dir=d))
        # (sequence number less the first's, reason) a dump
        names = [None if x is None else Path(x).name.split("-", 3)[3]
                 for x in paths]
        seq0 = int(names[0].split("-")[0])
        got[p] = [None if n is None else
                  (int(n.split("-")[0]) - seq0, n.split("-", 1)[1])
                  for n in names]
    assert got["port"] == got["jax"] == [
        (0, "breach.jsonl"), None, (1, "breach.jsonl"),
        (2, "other.jsonl"), (3, "breach.jsonl")]


def test_unwritable_directory_returns_none(tmp_path):
    blocker = tmp_path / "a-file"
    blocker.write_text("x")
    for _, rec, _ in PACKAGES.values():
        assert rec.flight_dump("nowhere", out_dir=str(blocker / "d")) is None
    assert port_rec.recent_headers(str(blocker / "d")) == []


def test_header_reads_trace_id_from_the_live_context():
    """The header's trace id and open root come from the request open on
    this thread, not from the ring (sampled out here)."""
    for o, rec, dt in PACKAGES.values():
        dt.configure(sample=10_000)
        o.configure(sample=10_000)
        ctx = dt.mint()
        with dt.use(ctx), o.trace("request", scoring="bm25"):
            header = json.loads(rec.artifact_lines("unit_incident")[0])
        assert header["trace_id"] == ctx.trace_id
        assert header["open_root"] == {"name": "request",
                                       "attrs": {"scoring": "bm25"}}
        assert "trace_id" not in json.loads(rec.artifact_lines("x")[0])
        o.configure(sample=1)


def test_slo_breach_writes_once_a_transition(tmp_path, monkeypatch):
    got = {}
    for p, (o, rec, dt) in PACKAGES.items():
        d = tmp_path / p
        monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(d))
        dt.configure(slo_ms=100.0, burn_threshold=2.0, min_samples=5,
                     slo_target=0.9)
        for _ in range(10):
            dt.slo_record("full", 500.0)
        (hdr,) = rec.recent_headers(str(d))
        assert hdr["reason"] == "slo_burn_breach"
        assert hdr["extra"]["slo"]["breached"] is True
        assert o.get_registry().get("slo.burn_breach") == 1
        got[p] = sorted(hdr["extra"]["slo"])
    assert got["port"] == got["jax"]


def test_trace_dump_prints_the_same_shape(tmp_path, capsys):
    """`trace-dump` (stdout and --out) in both command lines."""
    shapes = {}
    for p, (o, _, _) in PACKAGES.items():
        cli = port_cli if p == "port" else jax_cli
        with o.trace("cli-root"):
            with o.trace("cli-child"):
                pass
        out_file = tmp_path / f"{p}.jsonl"
        assert cli.main(["trace-dump", "--out", str(out_file)]) == 0
        assert json.loads(capsys.readouterr().out) == {
            "traces": 1, "out": str(out_file)}
        recs = [json.loads(line) for line in out_file.open()]
        assert recs[0]["reason"] == "manual_trace_dump"
        assert recs[1]["trace"]["children"][0]["name"] == "cli-child"
        assert cli.main(["trace-dump"]) == 0
        lines = [json.loads(ln) for ln in
                 capsys.readouterr().out.strip().splitlines()]
        shapes[p] = ([r["record"] for r in lines],
                     sorted(lines[0]),
                     _tree(lines[1]["trace"]))
    assert shapes["port"][0] == shapes["jax"][0]
    assert shapes["port"][1] == shapes["jax"][1]
    assert shapes["port"][2] == shapes["jax"][2]


# ---------------------------------------------------------------------------
# the failure paths that write a record
# ---------------------------------------------------------------------------


WORDS = "salmon fishing river bears honey quick brown fox lazy dog".split()


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recorder")
    corpus = tmp / "c.trec"
    corpus.write_text("".join(
        f"<DOC>\n<DOCNO> R-{i:03d} </DOCNO>\n<TEXT>\n"
        f"{' '.join(WORDS[(i + j) % len(WORDS)] for j in range(4))}\n"
        "</TEXT>\n</DOC>\n" for i in range(60)))
    idx = str(tmp / "idx")
    build_index(str(corpus), idx, num_shards=2, compute_chargrams=False,
                device="cpu")
    return idx


@pytest.fixture(scope="module")
def scorer(index_dir):
    return Scorer.load(index_dir, layout="sparse", device="cpu")


def test_soak_breach_writes_a_forced_record_with_the_span_tree(scorer,
                                                               tmp_path):
    """An injected unstructured error breaks the soak's invariant: a
    forced `soak_invariant_breach` record under flight_dir holds the
    offending request's tree, and the soak's job fails."""
    orig = scorer.search_batch
    calls = {"n": 0}

    def flaky(texts, **kw):
        if "force_host" in kw:   # the frontend's calls, not the reference
            calls["n"] += 1
            if calls["n"] % 5 == 0:
                raise RuntimeError("injected unstructured boom")
        return orig(texts, **kw)

    scorer.search_batch = flaky
    try:
        report = run_soak(scorer, threads=4, queries=30, seed=1,
                          fault_spec=None, timeout_s=60.0,
                          config=ServingConfig(max_concurrency=4,
                                               max_queue=16, deadline_s=5.0),
                          flight_dir=str(tmp_path))
    finally:
        scorer.search_batch = orig
    assert report["errors"] > 0
    recs = [json.loads(line) for line in open(report["flight_record"])]
    assert recs[0]["reason"] == "soak_invariant_breach"
    assert recs[0]["extra"]["errors"] == report["errors"]
    assert recs[-1]["record"] == "telemetry"
    offenders = [r["trace"] for r in recs if r["record"] == "trace"
                 and "boom" in r["trace"].get("error", "")]
    assert offenders
    assert {"ladder", "admission_wait", "breaker"} <= {
        c["name"] for c in offenders[0]["children"]}
    (job,) = [j.to_dict() for j in port_obs.progress.jobs()]
    assert job["state"] == "failed" and "invariant breach" in job["error"]


def test_breaker_open_record_is_rate_limited(scorer, tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(tmp_path))
    fe = ServingFrontend(scorer, ServingConfig(breaker_threshold=2,
                                               breaker_cooldown_s=0.0,
                                               deadline_s=5.0))
    faults.install(faults.parse_plan("score.device_loss:first@8"))
    for _ in range(6):
        assert fe.search("salmon fishing", k=5).degraded
    faults.clear()
    assert fe.stats()["breaker_opened"] >= 2
    (path,) = tmp_path.glob("flight-*breaker_open.jsonl")
    header = json.loads(path.open().readline())
    assert header["extra"]["breaker"]["state"] == "open"
    assert set(header["extra"]) == {"breaker", "ladder"}


def test_wal_torn_tail_writes_one_record(tmp_path, monkeypatch):
    from tpu_ir_torch.index.wal import (
        WriteAheadLog,
        list_segments,
        read_records,
    )

    monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(tmp_path / "flight"))
    d = str(tmp_path / "live")
    os.makedirs(d)
    w = WriteAheadLog(d, fsync_docs=1)
    for i in range(3):
        w.append({"op": "add", "docid": f"D{i}", "text": "x"}, key=f"D{i}")
    w.close()
    seg = list_segments(d)[0][1]
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 5)
    read_records(d, truncate_torn=True)
    (hdr,) = port_rec.recent_headers(str(tmp_path / "flight"))
    assert hdr["reason"] == "wal_torn_tail"
    assert hdr["extra"]["last_good_seq"] == 2 and hdr["extra"]["path"] == seg


def test_build_error_writes_one_record(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(tmp_path))

    def always_fails():
        raise OSError("disk on fire")

    with pytest.raises(faults.BuildError):
        faults.run_with_retry(always_fails, stage="write:part-00000",
                              policy=faults.RetryPolicy(max_attempts=2,
                                                        base_delay_s=0.0))
    (hdr,) = port_rec.recent_headers(str(tmp_path))
    assert hdr["reason"] == "build_error"
    assert hdr["extra"]["stage"] == "write:part-00000"
    assert hdr["extra"]["attempts"] == 2
    assert "disk on fire" in hdr["extra"]["cause"]


def test_serve_bench_breach_writes_under_flight_dir(index_dir, tmp_path,
                                                    monkeypatch, capsys):
    """`serve-bench --flight-dir D`: a soak that breaks an invariant
    writes its record in D and exits 1."""
    orig = Scorer.search_batch

    def boom(self, texts, **kw):
        if "force_host" in kw:
            raise RuntimeError("injected boom")
        return orig(self, texts, **kw)

    monkeypatch.setattr(Scorer, "search_batch", boom)
    d = tmp_path / "fl"
    assert port_cli.main(["serve-bench", index_dir, "--device", "cpu",
                          "--threads", "2", "--queries", "6",
                          "--flight-dir", str(d)]) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["errors"] == 6
    (path,) = d.glob("flight-*soak_invariant_breach.jsonl")
    assert out["flight_record"] == str(path)


def test_recorder_modules_import_no_jax():
    mod = importlib.import_module("tpu_ir_torch.obs.recorder")
    src = Path(mod.__file__).read_text()
    assert "jax" not in src and "tpu_ir." not in src
