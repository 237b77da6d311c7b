"""The port stands alone: importing it loads neither JAX nor the JAX
package (nor ml_dtypes), and no file of it (nor chip_smoke.py) imports
any of them — the card's host has none."""

import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PKG = os.path.join(ROOT, "tpu_ir_torch")

_IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|tpu_ir|bench|ml_dtypes)"
    r"(?:\.|\s|$)", re.M)


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PKG):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, tpu_ir_torch, tpu_ir_torch.search.scorer, "
            "tpu_ir_torch.index.builder, tpu_ir_torch.cli, "
            "tpu_ir_torch.convert, tpu_ir_torch.corpus, "
            "tpu_ir_torch.ops._build, tpu_ir_torch.ops.cold_tier, "
            "tpu_ir_torch.ops.hot_stage, tpu_ir_torch.envvars, "
            "tpu_ir_torch.search.layout, tpu_ir_torch.index.compress, "
            "tpu_ir_torch.index.blockmax, "
            "tpu_ir_torch.index.migrate, tpu_ir_torch.faults, "
            "tpu_ir_torch.obs, tpu_ir_torch.obs.histogram, "
            "tpu_ir_torch.obs.registry, tpu_ir_torch.obs.trace, "
            "tpu_ir_torch.utils.report, tpu_ir_torch.serving, "
            "tpu_ir_torch.serving.admission, tpu_ir_torch.serving.breaker, "
            "tpu_ir_torch.serving.batching, tpu_ir_torch.serving.frontend, "
            "tpu_ir_torch.serving.result_cache, tpu_ir_torch.serving.soak, "
            "tpu_ir_torch.analysis.native, tpu_ir_torch.analysis.pool, "
            "tpu_ir_torch.ops.chargram, tpu_ir_torch.index.streaming, "
            "tpu_ir_torch.index.docstore, tpu_ir_torch.index.dictionary, "
            "tpu_ir_torch.index.verify, tpu_ir_torch.utils.transfer, "
            "tpu_ir_torch.search.wildcard, tpu_ir_torch.search.evaluate, "
            "tpu_ir_torch.index.segments, tpu_ir_torch.index.wal, "
            "tpu_ir_torch.index.ingest, tpu_ir_torch.index.backup, "
            "tpu_ir_torch.index.doctor, tpu_ir_torch.serving.soak, "
            "tpu_ir_torch.obs.server, tpu_ir_torch.obs.disttrace, "
            "tpu_ir_torch.serving.shardset, tpu_ir_torch.serving.router, "
            "tpu_ir_torch.serving.generation, "
            "tpu_ir_torch.serving.residency, tpu_ir_torch.serving.workload, "
            "tpu_ir_torch.serving.autoscale, tpu_ir_torch.obs.recorder, "
            "tpu_ir_torch.obs.progress, tpu_ir_torch.obs.querylog, "
            "tpu_ir_torch.obs.profiling, tpu_ir_torch.obs.timeseries, "
            "tpu_ir_torch.obs.aggregate, "
            "chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpu_ir', 'bench', 'ml_dtypes'))\n"
            "assert not bad, bad\n"
            "print('clean')")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "clean"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_tpu_ir_import_in_source(path):
    src = open(path, encoding="utf-8").read()
    assert not _IMPORT_RE.search(src), path


@pytest.mark.parametrize("argv", [["querylog", "--slow"], ["trace-dump"]],
                         ids=lambda a: a[0])
def test_querylog_and_trace_dump_load_no_jax(argv):
    """The query-log and flight-record commands run and load no JAX."""
    code = ("import contextlib, io, json, sys\n"
            "from tpu_ir_torch import cli\n"
            "buf = io.StringIO()\n"
            "with contextlib.redirect_stdout(buf):\n"
            f"    assert cli.main({argv!r}) == 0\n"
            "lines = [json.loads(x) for x in buf.getvalue().splitlines()]\n"
            "assert lines\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpu_ir', 'bench', 'ml_dtypes'))\n"
            "assert not bad, bad\n"
            "print('clean')")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "clean"


def test_sampler_and_spool_writer_load_no_jax(tmp_path):
    """A MetricsServer with TPU_IR_TELEMETRY_DIR set runs the timeseries
    sampler and a SpoolWriter; both write, `top --json`, `stats
    --cluster` and `metrics --cluster` read what they wrote, and nothing
    loads JAX or the JAX package."""
    spool = str(tmp_path / "spool")
    code = ("import contextlib, io, json, os, sys, threading, time\n"
            "from tpu_ir_torch import cli, obs\n"
            "from tpu_ir_torch.obs.server import MetricsServer\n"
            "obs.get_registry().incr('serving.submitted', 3)\n"
            "with MetricsServer(port=0) as srv:\n"
            "    names = {t.name for t in threading.enumerate()}\n"
            "    assert {'tpu-ir-obs-timeseries', 'tpu-ir-obs-spool'} <= "
            "names, names\n"
            "    time.sleep(0.5)\n"
            "names = sorted(os.listdir(os.environ['TPU_IR_TELEMETRY_DIR']))\n"
            "assert [n.split('-')[0] for n in names] == "
            "['telemetry', 'timeseries'], names\n"
            "for argv in (['top', '--json'], ['stats', '--cluster'], "
            "['metrics', '--cluster']):\n"
            "    buf = io.StringIO()\n"
            "    with contextlib.redirect_stdout(buf):\n"
            "        assert cli.main(argv) == 0, argv\n"
            "    json.loads(buf.getvalue())\n"
            "assert obs.get_registry().get('timeseries.samples') >= 2\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tpu_ir', 'bench', 'ml_dtypes'))\n"
            "assert not bad, bad\n"
            "print('clean')")
    env = dict(os.environ, TPU_IR_TELEMETRY_DIR=spool,
               TPU_IR_TS_SAMPLE_S="0.05", TPU_IR_SPOOL_INTERVAL="0.1")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "clean"


def test_kernel_sources_are_listed():
    from tpu_ir_torch.ops import _build

    assert _build.kernel_sources() == ["cold_tier", "dense_score",
                                       "dequant_score", "hot_stage"]
    assert _build.BUILD_DIR.parts[-2:] == ("build", "tpu_ir_torch")
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert "build/" in ignored


def test_feeder_child_loads_no_jax(tmp_path):
    """The ingest feeder child of the crash matrix, run on the CPU over a
    small feed as `_spawn_feeder` runs it: it imports neither JAX nor the
    JAX package."""
    from tpu_ir_torch.index.segments import LiveIndex

    live = str(tmp_path / "live")
    LiveIndex.create(live, num_shards=2, chargram_ks=())
    ack = str(tmp_path / "ack")
    check = ("import atexit, sys\n"
             "def _check():\n"
             "    bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'tpu_ir', 'bench', 'ml_dtypes'))\n"
             "    print('loaded:', bad)\n"
             "atexit.register(_check)\n"
             "from tpu_ir_torch.serving.soak import ingest_feed_main\n"
             "raise SystemExit(ingest_feed_main())\n")
    r = subprocess.run([sys.executable, "-c", check, "--live-dir", live,
                        "--ack", ack, "--start", "0", "--end", "3",
                        "--buffer-docs", "2", "--device", "cpu"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "loaded: []"
    assert open(ack).read().split() == [f"FEED-{i:06d}" for i in range(3)]


def test_worker_subprocess_loads_no_jax(tmp_path):
    """A shard worker as ShardSet spawns it (`python -m
    tpu_ir_torch.serving.shardset <config>`), on the CPU over a small
    index, warmed, with TPU_IR_TELEMETRY_DIR set: it imports neither JAX
    nor the JAX package, serves /timeseries, exits 0 on SIGTERM and
    leaves its snapshot and its time-series store in the spool."""
    from tpu_ir_torch.index import build_index
    from tpu_ir_torch.serving import get_worker_health

    corpus = str(tmp_path / "c.trec")
    with open(corpus, "w") as f:
        for i in range(30):
            f.write(f"<DOC>\n<DOCNO> D-{i:03d} </DOCNO>\n<TEXT>\n"
                    f"salmon river w{i % 7} fox w{i % 3}\n</TEXT>\n</DOC>\n")
    index_dir = str(tmp_path / "idx")
    build_index(corpus, index_dir, num_shards=2, device="cpu")
    ready = str(tmp_path / "w.ready")
    cfg = str(tmp_path / "w.json")
    with open(cfg, "w") as f:
        json.dump({"index_dir": index_dir, "shard": 0, "num_shards": 2,
                   "ready_path": ready, "device": "cpu", "warm": True}, f)
    check = ("import atexit, runpy, sys\n"
             "def _check():\n"
             "    bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'tpu_ir', 'bench', 'ml_dtypes'))\n"
             "    print('loaded:', bad, flush=True)\n"
             "atexit.register(_check)\n"
             "runpy.run_module('tpu_ir_torch.serving.shardset', "
             "run_name='__main__')\n")
    out_path, err_path = str(tmp_path / "out"), str(tmp_path / "err")
    spool = str(tmp_path / "spool")
    env = dict(os.environ, TPU_IR_TELEMETRY_DIR=spool,
               TPU_IR_TS_SAMPLE_S="0.05")
    with open(out_path, "w") as out, open(err_path, "w") as err:
        # stdin stays open: the worker exits at once when it closes
        proc = subprocess.Popen([sys.executable, "-c", check, cfg],
                                cwd=ROOT, stdin=subprocess.PIPE, env=env,
                                stdout=out, stderr=err, text=True)
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(ready) and time.monotonic() < deadline:
            assert proc.poll() is None, open(err_path).read()[-2000:]
            time.sleep(0.05)
        with open(ready) as f:
            port = json.load(f)["port"]
        assert get_worker_health(f"127.0.0.1:{port}", 10)["worker"][
            "residency"]["mode"] == "auto"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/timeseries",
                                    timeout=10) as r:
            body = json.loads(r.read())
        assert body["enabled"] and body["tiers"][0]["window_s"] == 0.05
        proc.terminate()
        assert proc.wait(timeout=60) == 0, open(err_path).read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdin.close()
    lines = open(out_path).read().strip().splitlines()
    assert lines[-1] == "loaded: []"
    names = sorted(os.listdir(spool))
    assert [n.split("-")[0] for n in names] == ["telemetry", "timeseries"]
    with open(os.path.join(spool, names[0])) as f:
        assert json.load(f)["pid"] == proc.pid


def _mapped_files(pid: int) -> set:
    """The files a process has mapped (its loaded shared objects)."""
    with open(f"/proc/{pid}/maps") as f:
        return {line.split()[-1] for line in f
                if len(line.split()) >= 6 and line.split()[-1][:1] == "/"}


def test_grown_worker_loads_no_jax(tmp_path):
    """A worker ShardSet.grow spawns (niced, on the CPU over a small
    index) maps no JAX library (jaxlib's extension, XLA) and imports no
    module of the JAX package: its /healthz names the port's worker and
    its mapped files hold none of them."""
    from tpu_ir_torch.index import build_index
    from tpu_ir_torch.serving import ShardSet, get_worker_health

    corpus = str(tmp_path / "c.trec")
    with open(corpus, "w") as f:
        for i in range(30):
            f.write(f"<DOC>\n<DOCNO> D-{i:03d} </DOCNO>\n<TEXT>\n"
                    f"salmon river w{i % 7} fox w{i % 3}\n</TEXT>\n</DOC>\n")
    index_dir = str(tmp_path / "idx")
    build_index(corpus, index_dir, num_shards=2, device="cpu")
    ss = ShardSet(index_dir, shards=1, replicas=1, device="cpu",
                  rundir=str(tmp_path / "run"))
    try:
        ss.start()
        assert ss.grow() == [(0, 1)]
        h = ss.handles()[0][1]
        w = get_worker_health(h.addr, 10)["worker"]
        assert (w["shard"], w["replica"], w["pid"]) == (0, 1, h.pid)
        maps = _mapped_files(h.pid)
        assert any("torch" in m for m in maps)   # the check can see
        bad = sorted(m for m in maps
                     if re.search(r"jaxlib|xla_extension|/jax/|tpu_ir/", m))
        assert not bad, bad
        with open(f"/proc/{h.pid}/cmdline") as f:
            assert "tpu_ir_torch.serving.shardset" in f.read()
    finally:
        ss.stop()
