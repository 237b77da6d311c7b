"""The port's progress jobs (tpu_ir_torch/obs/progress.py), the builds'
jobs, `index --track` and the server's `/jobs`, `/jobs/<id>`, `/querylog`
and `/flight`, held against `tpu_ir`'s on the CPU, after
tests/test_obs_cluster.py. No worker process.

The same scripted reports go to both packages' jobs and their to_dict()
compared with the wall-clock fields (`started`, `elapsed_s`) and the job
id left out; the same corpus built by both packages' one-shot and
streaming builds registers jobs of the same phases and counters."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from tpu_ir import cli as jax_cli
from tpu_ir import obs as jax_obs
from tpu_ir.index import build_index as jax_build_index
from tpu_ir.index.streaming import build_index_streaming as jax_streaming
from tpu_ir.obs import progress as jax_progress

from tpu_ir_torch import cli as port_cli
from tpu_ir_torch import obs as port_obs
from tpu_ir_torch.index import build_index, build_index_streaming
from tpu_ir_torch.obs import progress as port_progress

PACKAGES = {"port": (port_obs, port_progress), "jax": (jax_obs, jax_progress)}
CLOCK = {"started", "elapsed_s", "job_id"}


@pytest.fixture(autouse=True)
def _clean_state():
    for o, _ in PACKAGES.values():
        o.reset_all()
    yield
    for o, _ in PACKAGES.values():
        o.reset_all()


def norm(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in CLOCK}


def scripted(pr) -> list:
    """One report sequence; the job's dict after each step."""
    out = []
    pr.report_progress("anywhere", advance=1)       # no job: nothing
    out.append(pr.current_job())
    job = pr.start_job("build", "unit", phases=("map", "reduce"),
                       config={"k": 1})
    job.report("map", advance=3, total=10, docs_parsed=120)
    out.append(norm(job.to_dict()))
    pr.report_progress("map", total=100)            # a late total: no fall
    out.append(norm(job.to_dict()))
    pr.report_progress("reduce", total=4, unit="shards")
    out.append(norm(job.to_dict()))
    pr.report_progress(None, advance=4, pairs=7)    # the current phase
    out.append(norm(job.to_dict()))
    pr.report_progress("extra", advance=1)          # made on first mention
    job.finish()
    job.finish(error="late")                        # a second finish: none
    out.append(norm(job.to_dict()))
    pr.report_progress("map", advance=5)            # finished: not a target
    out.append(norm(job.to_dict()))
    return out


def test_scripted_reports_give_tpu_ir_dicts():
    port, jax = scripted(port_progress), scripted(jax_progress)
    assert port == jax
    assert port[0] is None
    assert port[1]["percent"] == pytest.approx(15.0)
    assert port[2]["percent"] == port[1]["percent"]          # never falls
    assert port[3]["percent"] >= 50.0
    assert port[5]["state"] == "succeeded" and port[5]["percent"] == 100.0
    assert port[5]["schema"] == port_progress.JOB_SCHEMA == \
        jax_progress.JOB_SCHEMA


def test_eta_from_the_current_phase_throughput():
    etas = {}
    for p, (_, pr) in PACKAGES.items():
        job = pr.start_job("soak", "eta", phases=("serve",))
        job.report("serve", total=100)
        job._phases["serve"]["started"] = time.time() - 10.0
        job.report("serve", advance=50)               # 5 a second
        etas[p] = job.to_dict()["eta_s"]
    assert 7.0 < etas["port"] < 13.0 and 7.0 < etas["jax"] < 13.0


def test_tracked_failure_and_history_bound():
    got = {}
    for p, (_, pr) in PACKAGES.items():
        with pytest.raises(ValueError):
            with pr.tracked("build", "boom", phases=("a",)):
                pr.report_progress("a", advance=1)
                raise ValueError("boom")
        failed = pr.jobs()[-1].to_dict()
        for i in range(20):
            with pr.tracked("build", f"j{i}"):
                pass
        got[p] = (norm(failed), len(pr.jobs()),
                  [j.name for j in pr.jobs()][:2],
                  pr.get_job(pr.jobs()[-1].job_id) is pr.jobs()[-1],
                  pr.get_job(-1))
    assert got["port"] == got["jax"]
    failed, n, first, found, missing = got["port"]
    assert failed["state"] == "failed" and "boom" in failed["error"]
    assert n == 16 and first == ["j4", "j5"] and found and missing is None


# ---------------------------------------------------------------------------
# the builds' jobs
# ---------------------------------------------------------------------------


def _corpus(tmp_path, n=30):
    corpus = tmp_path / "c.trec"
    corpus.write_text("".join(
        f"<DOC>\n<DOCNO> J-{i:03d} </DOCNO>\n<TEXT>\nalpha beta g{i}\n"
        "</TEXT>\n</DOC>\n" for i in range(n)))
    return str(corpus)


def _build_job(o) -> dict:
    (job,) = [j for j in o.progress.jobs() if j.kind == "build"]
    return norm(job.to_dict())


def _phase_rows(d: dict) -> dict:
    return {p["phase"]: {k: v for k, v in p.items()} for p in d["phases"]}


@pytest.mark.parametrize("mode", ["oneshot", "streaming_legacy",
                                  "streaming_radix"])
def test_builds_register_tpu_ir_jobs(tmp_path, mode):
    """The same corpus through both packages' builds: jobs of the same
    name, phases, totals, done counts and counters (the one-shot build's
    `occurrences` and the radix spills' too)."""
    corpus = _corpus(tmp_path)
    got = {}
    for p, (o, _) in PACKAGES.items():
        out = str(tmp_path / p / "idx")
        if mode == "oneshot":
            kw = dict(num_shards=2, compute_chargrams=False)
            if p == "port":
                build_index(corpus, out, device="cpu", **kw)
            else:
                jax_build_index([corpus], out, **kw)
        else:
            kw = dict(k=1, num_shards=2, batch_docs=10, chargram_ks=[],
                      radix_buckets=0 if mode == "streaming_legacy" else 2)
            if p == "port":
                build_index_streaming([corpus], out, device="cpu", **kw)
            else:
                jax_streaming([corpus], out, **kw)
        got[p] = _build_job(o)
    port, jax = got["port"], got["jax"]
    assert port["state"] == "succeeded" and port["percent"] == 100.0
    assert port["name"] == jax["name"] and port["phases"] == jax["phases"]
    assert port["config"] == jax["config"]
    rows = _phase_rows(port)
    if mode == "oneshot":
        assert list(rows) == ["tokenize", "docno_mapping", "postings",
                              "write_shards", "dictionary"]
        assert rows["tokenize"]["counters"]["docs_parsed"] == 30
    else:
        assert list(rows)[:4] == ["pass1_tokenize", "pass2_combine",
                                  "pass3_reduce", "finalize"]
        assert rows["pass3_reduce"]["done"] == 2
        assert rows["pass2_combine"]["done"] == rows["pass2_combine"]["total"]


def test_failed_build_marks_its_job_failed(tmp_path):
    empty = tmp_path / "empty.trec"
    empty.write_text("no trec records here\n")
    for build in (lambda d: build_index_streaming([str(empty)], d,
                                                  num_shards=2, device="cpu"),
                  lambda d: build_index(str(empty), d, device="cpu")):
        port_obs.reset_all()
        with pytest.raises(ValueError):
            build(str(tmp_path / "idx"))
        (job,) = port_obs.progress.jobs()
        assert job.state == "failed" and "no <DOC>" in job.error


def test_index_track_serves_the_build_and_stops(tmp_path, capsys):
    """`index --track 0`: the build's job is readable while the server
    lives (announced on stderr, the same line as tpu_ir's), and the
    server is gone when the command returns."""
    corpus = _corpus(tmp_path, 12)
    before = {t.name for t in threading.enumerate()}
    assert port_cli.main(["index", corpus, str(tmp_path / "idx"),
                          "--no-chargrams", "--shards", "2", "--track", "0",
                          "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "tpu-ir: serving live telemetry on http://127.0.0.1:" in err
    url = err.split("serving live telemetry on ")[1].split()[0]
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"{url}/jobs", timeout=2)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("tpu-ir-obs") and t.name not in before]
    assert jax_cli.main(["index", corpus, str(tmp_path / "jidx"),
                         "--no-chargrams", "--shards", "2", "--track",
                         "0"]) == 0
    jerr = capsys.readouterr().err
    assert "tpu-ir: serving live telemetry on http://127.0.0.1:" in jerr


# ---------------------------------------------------------------------------
# the server's routes
# ---------------------------------------------------------------------------


def test_server_jobs_querylog_flight_routes(tmp_path, monkeypatch):
    from tpu_ir_torch.obs.server import MetricsServer

    monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(tmp_path))
    job = port_progress.start_job("build", "served", phases=("a", "b"))
    job.report("a", advance=1, total=2, docs_parsed=5)
    port_obs.flight_dump("unit_incident", extra={"k": 1})
    srv = MetricsServer().start()

    def get(path):
        with urllib.request.urlopen(f"{srv.url}{path}", timeout=10) as r:
            return r.read()

    try:
        jobs = json.loads(get("/jobs"))["jobs"]
        assert [j["name"] for j in jobs] == ["served"]
        one = json.loads(get(f"/jobs/{job.job_id}"))
        assert norm(one) == norm(job.to_dict()) and one["percent"] == 25.0
        page = get(f"/jobs/{job.job_id}?format=html").decode()
        assert "25.0% complete" in page and "docs_parsed=5" in page
        assert "/querylog?format=html" in get("/jobs?format=html").decode()
        for bad in ("/jobs/999", "/jobs/x"):
            with pytest.raises(urllib.error.HTTPError) as e:
                get(bad)
            assert e.value.code == 404
        assert "slow_entries" in json.loads(get("/querylog"))
        flights = json.loads(get("/flight"))["flight_records"]
        assert [f["reason"] for f in flights] == ["unit_incident"]
        health = json.loads(get("/healthz"))
        assert health["jobs_running"] == 1
        assert health["slow_queries_last_60s"] == 0
        job.finish()
        assert json.loads(get("/healthz"))["jobs_running"] == 0
    finally:
        srv.stop()
