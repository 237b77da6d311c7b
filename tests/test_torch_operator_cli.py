"""The port's operator surfaces held against `tpu_ir`'s on the CPU, after
tests/test_obs.py, tests/test_serving.py and tests/test_cache_tier.py:
`stats`, `metrics` (JSON and `--prom`), `cache stats|clear`, read-and-
zero with `--reset`, `--cluster` (the spool's merge, either package's
files), the server's
`/metrics` (read-only: `?reset=1` is 403), `/metrics.json`, `/doctor` and
`/`, `serve-bench --metrics-port` on its three arms, and the counters
this slice adds: `decode.*` equal to `tpu_ir`'s on one v3 fixture with
and without a doc range, and `blockmax.*` equal to the Scorer's own
`blockmax_stats`. No worker process is spawned."""

import json
import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest

from tpu_ir import obs as jax_obs
from tpu_ir.cli import main as jax_cli
from tpu_ir.index import compress as jax_compress
from tpu_ir.obs.server import MetricsServer as JaxMetricsServer
from tpu_ir.serving.result_cache import ResultCache as JaxResultCache
from tpu_ir.utils import report as jax_report

from tpu_ir_torch import cli as port_cli_mod
from tpu_ir_torch import obs
from tpu_ir_torch.cli import main as port_cli
from tpu_ir_torch.corpus import make_corpus
from tpu_ir_torch.index import build_index
from tpu_ir_torch.index import compress, format as fmt
from tpu_ir_torch.index.migrate import migrate_index
from tpu_ir_torch.obs.server import MetricsServer
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.serving.result_cache import ResultCache, live_caches
from tpu_ir_torch.utils import report as port_report

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
STDLIB = os.path.join(ROOT, "data", "stdlib", "corpus.trec")
CLIS = {"port": port_cli, "jax": jax_cli}
OBS = {"port": obs, "jax": jax_obs}


@pytest.fixture(autouse=True)
def _clean():
    for o in OBS.values():
        o.reset_all()
    yield
    for o in OBS.values():
        o.reset_all()


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ops") / "idx")
    build_index(STDLIB, out, num_shards=2, device="cpu",
                compute_chargrams=False)
    return out


def _run(capsys, name: str, argv: list) -> tuple[int, str]:
    rc = CLIS[name](argv)
    return rc, capsys.readouterr().out


def _script(name: str) -> None:
    """The same events in one package's registry."""
    rec = (port_report if name == "port" else jax_report).recovery_counters()
    srv = (port_report if name == "port" else jax_report).serving_counters()
    rec.incr("degraded_batches", 2)
    srv.incr("submitted", 5)
    reg = OBS[name].get_registry()
    reg.incr("blockmax.blocks_considered", 7)
    reg.incr("fault.score.hang")
    with OBS[name].trace("dispatch"):
        pass


# -- stats, metrics -----------------------------------------------------------


def test_stats_prints_tpu_ir_shape(capsys):
    outs = {}
    for name in CLIS:
        _script(name)
        rc, text = _run(capsys, name, ["stats"])
        assert rc == 0
        outs[name] = json.loads(text)
    port, jax = outs["port"], outs["jax"]
    assert set(port) == set(jax) == {"recovery", "serving",
                                     "fault_injection", "pruning",
                                     "histograms"}
    for section in ("recovery", "serving"):
        shared = set(port[section]) & set(jax[section])
        assert {k: port[section][k] for k in shared} == \
            {k: jax[section][k] for k in shared}
    assert port["recovery"]["degraded_batches"] == 2
    assert port["serving"]["submitted"] == 5
    assert port["fault_injection"] == jax["fault_injection"] == {
        "score.hang": 1}
    assert port["pruning"]["blockmax.blocks_considered"] == \
        jax["pruning"]["blockmax.blocks_considered"] == 7
    assert port["histograms"]["dispatch"]["count"] == \
        jax["histograms"]["dispatch"]["count"] == 1
    assert set(port["histograms"]["dispatch"]) == \
        set(jax["histograms"]["dispatch"])


@pytest.mark.parametrize("command", ["stats", "metrics"])
def test_reset_reads_and_zeroes(capsys, command):
    for name in CLIS:
        _script(name)
        rc, text = _run(capsys, name, [command, "--reset"])
        first = json.loads(text)
        rc2, text2 = _run(capsys, name, [command])
        second = json.loads(text2)
        assert rc == rc2 == 0
        if command == "stats":
            assert first["serving"]["submitted"] == 5
            # tpu_ir declares no serving.* counter: a reset drops them
            assert second["serving"].get("submitted", 0) == 0
            assert second["histograms"]["dispatch"]["count"] == 0
        else:
            assert first["counters"]["serving.submitted"] == 5
            assert second["counters"].get("serving.submitted", 0) == 0
            assert second["resets"] > first["resets"] - 1
            assert second["histograms"]["dispatch"]["count"] == 0


def test_metrics_json_matches_tpu_ir_shape(capsys):
    outs = {}
    for name in CLIS:
        _script(name)
        outs[name] = json.loads(_run(capsys, name, ["metrics"])[1])
    port, jax = outs["port"], outs["jax"]
    assert set(port) == set(jax)
    assert set(port["gauges"]) == set(jax["gauges"])
    shared = set(port["counters"]) & set(jax["counters"])
    assert {"compile.count", "decode.bytes", "blockmax.blocks_masked",
            "serving.submitted"} <= shared
    assert {k: port["counters"][k] for k in shared} == \
        {k: jax["counters"][k] for k in shared}


def _prom(text: str) -> dict:
    """Exposition lines by family and label set, the metadata lines
    apart."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            out.setdefault("#", []).append(line)
        else:
            key, value = line.rsplit(" ", 1)
            out[key] = value
    return out


def test_metrics_prom_lines_match_for_shared_names(capsys):
    texts = {}
    for name in CLIS:
        _script(name)
        rc, texts[name] = _run(capsys, name, ["metrics", "--prom"])
        assert rc == 0
    port, jax = _prom(texts["port"]), _prom(texts["jax"])
    assert port["#"] == jax["#"]            # HELP and TYPE, line for line
    shared = set(port) & set(jax) - {"#"}
    assert 'tpu_ir_events_total{name="serving.submitted"}' in shared
    assert 'tpu_ir_gauge{name="device.peak_bytes"}' in shared
    assert 'tpu_ir_stage_latency_seconds_count{stage="dispatch_device"}' \
        in shared
    assert any(k.startswith('tpu_ir_stage_latency_seconds_bucket'
                            '{stage="dispatch",le=') for k in shared)
    for key in shared:
        if "_sum{" in key or "_bucket{" in key:
            continue                       # wall times differ
        assert port[key] == jax[key], key


@pytest.mark.parametrize("command", ["stats", "metrics"])
def test_cluster_merges_the_spool_as_tpu_ir_does(tmp_path, capsys,
                                                  monkeypatch, command):
    """`--cluster --telemetry-dir DIR` over a spool one package of each
    wrote (the same scripted events): both command lines print the same
    merge, every event counted once a process; with no spool, both exit
    1."""
    from tpu_ir.obs import aggregate as jax_agg
    from tpu_ir_torch.obs import aggregate as port_agg

    for name, agg in (("port", port_agg), ("jax", jax_agg)):
        _script(name)
        OBS[name].get_registry().set_gauge("router.occupancy", 0.25)
        # one spool file a process: each package writes its own dir, and
        # the files meet under names of two pids
        path = agg.spool_write(str(tmp_path / name))
        assert path is not None
        os.replace(path, tmp_path / os.path.basename(path).replace(
            f"-{os.getpid()}-", f"-{os.getpid()}{len(name)}-"))
    outs = {}
    for name in CLIS:
        rc, out = _run(capsys, name, [command, "--cluster",
                                      "--telemetry-dir", str(tmp_path)])
        assert rc == 0
        outs[name] = json.loads(out)
    assert outs["port"] == outs["jax"]
    merged = outs["port"]
    assert merged["processes"] == 2
    assert len(merged["per_process"]) == 2
    submitted = (merged["serving"]["submitted"] if command == "stats"
                 else merged["counters"]["serving.submitted"])
    assert submitted == 10
    if command == "metrics":
        assert merged["gauges"]["router.occupancy"] == 0.25
    monkeypatch.delenv("TPU_IR_TELEMETRY_DIR", raising=False)
    errs = {}
    for name, cli in CLIS.items():
        assert cli([command, "--cluster"]) == 1
        assert cli([command, "--cluster", "--telemetry-dir",
                    str(tmp_path / "empty")]) == 1
        errs[name] = capsys.readouterr().err
    assert errs["port"] == errs["jax"]
    assert errs["port"].count("error: ") == 2


# -- cache --------------------------------------------------------------------


def test_cache_stats_and_clear_match_tpu_ir(capsys):
    caches = {"port": ResultCache(16, name="frontend"),
              "jax": JaxResultCache(16, name="frontend")}
    for c in caches.values():
        c.put(("a",), "payload", generation=0)
        assert c.get(("a",)) == "payload"
        assert c.get(("b",)) is None
    outs = {}
    for name in CLIS:
        outs[name] = json.loads(_run(capsys, name, ["cache"])[1])
    assert set(outs["port"]) == set(outs["jax"]) == {"counters", "caches"}
    assert outs["port"]["counters"] == outs["jax"]["counters"]
    assert outs["port"]["counters"]["cache.hit"] == 1
    mine = [c for c in outs["port"]["caches"] if c["entries"] == 1]
    assert mine and set(mine[0]) <= set(outs["jax"]["caches"][-1]) | {
        "name"}
    cleared = {}
    for name in CLIS:
        cleared[name] = json.loads(_run(capsys, name, ["cache",
                                                       "clear"])[1])
    assert set(cleared["port"]) == set(cleared["jax"])
    assert cleared["port"]["cleared_entries"] >= 1
    assert cleared["port"]["counters_reset"] is True
    assert caches["port"].snapshot()["entries"] == 0
    assert obs.get_registry().get("cache.hit") == 0
    assert caches["port"] in live_caches()


def test_live_caches_are_held_weakly():
    import gc

    c = ResultCache(4, name="gone")
    assert c in live_caches()
    del c
    gc.collect()
    assert all(x.name != "gone" for x in live_caches())


# -- the server ---------------------------------------------------------------


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_metrics_reset_query_is_refused(package):
    server = MetricsServer if package == "port" else JaxMetricsServer
    reg = OBS[package].get_registry()
    reg.incr("serving.submitted", 3)
    with server(port=0) as srv:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(srv.url + "/metrics?reset=1")
        assert err.value.code == 403
        status, body = _get(srv.url + "/metrics")
        assert status == 200
        assert 'tpu_ir_events_total{name="serving.submitted"} 3' in \
            body.decode()
        snap = json.loads(_get(srv.url + "/metrics.json")[1])
        assert snap["counters"]["serving.submitted"] == 3
    assert reg.get("serving.submitted") == 3


def test_endpoint_index_and_doctor(index_dir, tmp_path):
    with MetricsServer(port=0) as srv, JaxMetricsServer(port=0) as jsrv:
        ends = json.loads(_get(srv.url + "/")[1])["endpoints"]
        jends = json.loads(_get(jsrv.url + "/")[1])["endpoints"]
        assert {"/metrics", "/metrics.json", "/profile", "/doctor"} <= \
            set(ends) <= set(jends)
        Scorer.load(index_dir, device="cpu")
        doc = json.loads(_get(srv.url + "/doctor")[1])
        report = doc["indexes"][os.path.abspath(index_dir)]
        assert report["index_dir"] == index_dir \
            or os.path.abspath(report["index_dir"]) == \
            os.path.abspath(index_dir)
        assert "warnings" in report and "docs" in report
        other = json.loads(_get(srv.url + "/doctor?index="
                                + str(tmp_path))[1])
        assert "not a registered index dir" in other["error"]
        page = _get(srv.url + "/doctor?format=html")[1].decode()
        assert "/profile" in page and "warnings" in page


# -- serve-bench --metrics-port ----------------------------------------------


class _Capture:
    """Records the MetricsServer serve-bench starts, and scrapes it from
    inside the patched runner while the command runs."""

    def __init__(self, monkeypatch):
        self.server = None
        self.scraped = {}
        real_start = MetricsServer.start

        def start(srv):
            self.server = srv
            return real_start(srv)

        monkeypatch.setattr(MetricsServer, "start", start)

    def scrape(self) -> None:
        base = self.server.url
        for route in ("/metrics", "/metrics.json", "/profile", "/doctor",
                      "/healthz"):
            status, body = _get(base + route)
            self.scraped[route] = (status, body)
        try:
            _get(base + "/metrics?reset=1")
            self.scraped["reset"] = 200
        except urllib.error.HTTPError as e:
            self.scraped["reset"] = e.code


@pytest.mark.parametrize("arm", ["soak", "sweep", "routed"])
def test_serve_bench_metrics_port_serves_the_routes(index_dir, capsys,
                                                    monkeypatch, arm):
    import tpu_ir_torch.serving as serving

    cap = _Capture(monkeypatch)
    canned = {"soak": {"errors": 0, "deadlocked": 0,
                       "untagged_mismatches": 0, "served": 1, "shed": 0,
                       "submitted": 1},
              "sweep": {"levels": [{"errors": 0}]}}

    def runner(*args, **kwargs):
        cap.scrape()
        if arm == "routed":
            raise RuntimeError("scraped")        # past the scrape: done
        return dict(canned[arm])

    name = {"soak": "run_soak", "sweep": "run_concurrency_sweep",
            "routed": "run_distributed_soak"}[arm]
    monkeypatch.setattr(serving, name, runner)
    argv = ["serve-bench", index_dir, "--device", "cpu",
            "--metrics-port", "0", "--queries", "4"]
    argv += {"soak": [], "sweep": ["--concurrency", "1,2"],
             "routed": ["--shards", "2"]}[arm]
    if arm == "routed":
        with pytest.raises(RuntimeError, match="scraped"):
            port_cli(argv)
    else:
        assert port_cli(argv) == 0
    assert "serving live telemetry on" in capsys.readouterr().err
    assert cap.scraped["reset"] == 403
    for route in ("/metrics", "/metrics.json", "/profile", "/doctor",
                  "/healthz"):
        assert cap.scraped[route][0] == 200
    assert b"# TYPE tpu_ir_events_total counter" in \
        cap.scraped["/metrics"][1]
    prof = json.loads(cap.scraped["/profile"][1])
    assert "builds" in prof
    if arm != "routed":                   # the CLI loaded the index
        doc = json.loads(cap.scraped["/doctor"][1])
        assert os.path.abspath(index_dir) in doc["indexes"]
    assert cap.server._thread is None     # stopped with the command


# -- the counters this slice adds --------------------------------------------


@pytest.fixture(scope="module")
def v3_dir(index_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("v3") / "idx")
    shutil.copytree(index_dir, out,
                    ignore=shutil.ignore_patterns("serving-*"))
    migrate_index(out, to_version=3)
    return out


DECODE = ("decode.blocks_decoded", "decode.blocks_skipped", "decode.bytes",
          "decode.bytes_skipped")


@pytest.mark.parametrize("doc_range", [None, (1, 100), (520, 700)])
def test_decode_counts_match_tpu_ir(v3_dir, doc_range):
    meta = fmt.IndexMetadata.load(v3_dir)
    for shard in range(meta.num_shards):
        sections = fmt.load_shard(v3_dir, shard)
        assert compress.is_compressed(sections)
        got = compress.decode_shard(sections, doc_range=doc_range)
        want = jax_compress.decode_shard(sections, doc_range=doc_range)
        for key in ("pair_doc", "pair_tf"):
            assert np.array_equal(got[key], want[key])
    port = obs.get_registry().counters("decode.")
    jax = jax_obs.get_registry().counters("decode.")
    assert port == jax
    if doc_range is None:
        assert port["blocks_decoded"] > 0
        assert port["blocks_skipped"] == port["bytes_skipped"] == 0
    elif doc_range == (520, 700):          # past the one 512-doc block
        assert port["blocks_skipped"] > 0


def test_decode_block_is_observed_outside_the_read(v3_dir):
    meta = fmt.IndexMetadata.load(v3_dir)
    Scorer.load(v3_dir, device="cpu")
    reg = obs.get_registry()
    assert reg.histogram("decode.block").state()[0] != [0] * 40
    assert sum(reg.histogram("decode.block").state()[0]) == meta.num_shards
    assert reg.get("decode.blocks_decoded") > 0


@pytest.fixture(scope="module")
def blockmax_dir(tmp_path_factory):
    """A 600-doc index with 64-doc bound blocks: ten blocks, a budget of
    four, so block-max engages on the tiered layout."""
    d = tmp_path_factory.mktemp("bmx")
    corpus = str(d / "c.trec")
    make_corpus(corpus, seed=7, n_docs=600, target_bytes=240_000,
                vocab_size=1_500)
    out = str(d / "idx")
    prev = os.environ.get("TPU_IR_BLOCKMAX_WIDTH")
    os.environ["TPU_IR_BLOCKMAX_WIDTH"] = "64"
    try:
        build_index(corpus, out, num_shards=2, device="cpu",
                    compute_chargrams=False)
    finally:
        if prev is None:
            os.environ.pop("TPU_IR_BLOCKMAX_WIDTH")
        else:
            os.environ["TPU_IR_BLOCKMAX_WIDTH"] = prev
    return out


@pytest.mark.parametrize("scoring_name", ["tfidf", "bm25"])
def test_blockmax_counters_equal_scorer_stats(blockmax_dir, scoring_name):
    s = Scorer.load(blockmax_dir, layout="sparse", device="cpu")
    assert s._blockmax_width == 64
    hot = np.nonzero(s._hot_rank_host >= 0)[0]
    rng = np.random.default_rng(3)
    q = rng.integers(0, len(s._df_host), (48, 3)).astype(np.int32)
    q[:, 0] = rng.choice(hot, len(q))
    s.topk(q, k=5, scoring=scoring_name)
    stats = s.blockmax_stats
    assert stats["blocks_considered"] > 0
    reg = obs.get_registry()
    assert reg.counters("blockmax.") == stats
    stats_stat = json.loads(_stats_json())["pruning"]
    assert {k.split(".", 1)[1]: v for k, v in stats_stat.items()} == stats


def _stats_json() -> str:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port_cli_mod.main(["stats"]) == 0
    return buf.getvalue()
