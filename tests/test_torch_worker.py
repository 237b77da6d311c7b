"""The port's shard worker tier on the CPU: contracts (d) and (e).

(d) The worker surface equals `tpu_ir`'s: the RPC routes and their
status codes (200, 400, 404, 500, 503 with reason and level), the
/healthz keys and the worker identity's (plus the port's
`kernel_launches` and `warm_launches`), the ready file's and `serve-worker`'s JSON keys, and
`swap_microbench`'s report keys. A ShardSet of two subprocess workers
starts, is killed and respawned, and leaves no worker pid alive after
`stop()`; a worker whose stdin closes exits. (That the worker process
imports no JAX is test_torch_isolation.py's.)

(e) The rolling swap: under threaded RPC traffic every answer names one
generation and its hits are bitwise that generation's answer for that
shard; after `rolling_swap` every worker's /healthz names B, and a
worker killed and respawned comes back on B.

Also the exact merge over HTTP (in-process workers, the dense and the
tiered layout, the rerank's two phases) against the single scorer, and
the command line: `ingest --swap-bench`, `serve-worker --run-for`, and
`ingest --soak-bench` refused with an error naming its slice (6b-3)."""

import contextlib
import http.client
import io
import json
import os
import random
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tpu_ir.cli import main as jax_cli_main
from tpu_ir.obs.server import MetricsServer as JaxMetricsServer
from tpu_ir.serving.admission import Overloaded as JaxOverloaded
from tpu_ir.serving.generation import swap_microbench as jax_swap_microbench
from tpu_ir.serving.shardset import serve_worker as jax_serve_worker

from tpu_ir_torch import faults, obs
from tpu_ir_torch.cli import main as cli_main
from tpu_ir_torch.index import build_index
from tpu_ir_torch.index.ingest import IngestWriter
from tpu_ir_torch.index.segments import LiveIndex
from tpu_ir_torch.obs.server import MetricsServer
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.search.layout import shard_doc_ranges
from tpu_ir_torch.serving import (
    Overloaded,
    ShardSet,
    get_worker_health,
    merge_candidate_scores,
    merge_shard_topk,
    rolling_swap,
    rpc_post,
    serve_worker,
    swap_microbench,
)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WORDS = ("salmon fishing river bears honey quick brown fox lazy dog "
         "market investor asset bond stock season rain forest".split())
QUERIES = ["salmon fishing", "bears honey market", "quick", "w3 rain",
           "rain forest investor", "dog dog salmon", "nosuchterm"]
# the ready file's keys (tpu_ir/serving/shardset.py::worker_main)
READY_KEYS = {"port", "pid", "shard", "replica", "generation"}
N_SHARDS = 3


@pytest.fixture(autouse=True)
def _clean_port_state():
    faults.clear()
    obs.reset_all()
    yield
    faults.clear()
    faults.drain_abandoned(timeout_s=10.0)
    obs.reset_all()


def _text(rng) -> str:
    toks = [rng.choice(WORDS) for _ in range(rng.randint(3, 7))]
    return " ".join(toks + [f"w{rng.randint(0, 40)}"])


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("worker")
    corpus = str(tmp / "c.trec")
    rng = random.Random(1)
    with open(corpus, "w") as f:
        for i in range(150):
            f.write(f"<DOC>\n<DOCNO> D-{i:04d} </DOCNO>\n<TEXT>\n"
                    f"{_text(rng)}\n</TEXT>\n</DOC>\n")
    out = str(tmp / "idx")
    build_index(corpus, out, num_shards=3, device="cpu")
    return out


@pytest.fixture(scope="module")
def live_dir(tmp_path_factory):
    """Generation A (40 docs) and B (A with 4 replaced and 8 added)."""
    live = str(tmp_path_factory.mktemp("wlive") / "live")
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
    return [(int(d), np.float32(s).tobytes()) for d, s in hits]


def _http(addr: str, method: str, path: str, body: bytes | None = None):
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


# -- (d) the surface against tpu_ir's -----------------------------------------

_CASES = [
    ("POST", "/rpc/search", b'{"text": "salmon fishing", "k": 5, '
                            b'"scoring": "bm25"}'),
    ("POST", "/rpc/cosine_at", b'{"text": "salmon", "cand": [1, 2, 3]}'),
    ("POST", "/rpc/nope", b"{}"),
    ("POST", "/other", b"{}"),
    ("POST", "/rpc/search", b"not json"),
    ("POST", "/rpc/search", b"{}"),
    ("GET", "/nope", None),
    ("GET", "/healthz", None),
]


def test_worker_surface_equals_jax(index_dir, tmp_path):
    """Each route's status and JSON keys equal the JAX worker's on a copy
    of the same index; the worker identity holds the JAX keys and the
    port's kernel_launches and warm_launches."""
    twin = str(tmp_path / "twin")
    shutil.copytree(index_dir, twin,
                    ignore=shutil.ignore_patterns("serving-*"))
    port_srv, _, _ = serve_worker(index_dir, 1, N_SHARDS, warm=False,
                                  device="cpu")
    jax_srv, _, _ = jax_serve_worker(twin, 1, N_SHARDS, warm=False)
    try:
        for method, path, body in _CASES:
            got = _http(f"127.0.0.1:{port_srv.port}", method, path, body)
            want = _http(f"127.0.0.1:{jax_srv.port}", method, path, body)
            assert got[0] == want[0], (method, path, body)
            assert sorted(got[1]) == sorted(want[1]), (method, path)
            if path == "/healthz":
                worker, jworker = got[1]["worker"], want[1]["worker"]
                assert set(worker) == set(jworker) | {"kernel_launches",
                                                      "warm_launches"}
                for key in ("shard", "replica", "num_shards", "doc_range",
                            "generation", "index_generation", "live",
                            "layout", "in_flight", "queued"):
                    assert worker[key] == jworker[key], key
                assert sorted(worker["compiles"]) == sorted(
                    jworker["compiles"])
            elif path == "/rpc/search" and got[0] == 200:
                assert [d for d, _ in got[1]["hits"]] == [
                    d for d, _ in want[1]["hits"]]
    finally:
        port_srv.stop()
        jax_srv.stop()


def test_worker_spans_carry_its_service_name(index_dir, tmp_path):
    """A worker names its process as the JAX worker does, and the record
    of every span the process opens after that, under a trace, carries
    the name."""
    from tpu_ir.obs import disttrace as jax_disttrace
    from tpu_ir_torch.obs import disttrace

    twin = str(tmp_path / "twin")
    shutil.copytree(index_dir, twin,
                    ignore=shutil.ignore_patterns("serving-*"))
    port_srv, _, _ = serve_worker(index_dir, 2, N_SHARDS, replica=1,
                                  warm=False, device="cpu")
    jax_srv, _, _ = jax_serve_worker(twin, 2, N_SHARDS, replica=1,
                                     warm=False)
    was = obs.enabled()
    obs.configure(enabled=True)
    try:
        ctx = disttrace.mint()
        with disttrace.use(ctx), obs.trace("probe"):
            with obs.trace("child"):
                pass
        recs = disttrace.spans_for(ctx.trace_id)
        assert [r["name"] for r in recs] == ["probe", "child"]
        assert {r["service"] for r in recs} == {jax_disttrace._SERVICE}
        assert jax_disttrace._SERVICE == "worker-s2r1"
    finally:
        obs.configure(enabled=was)
        port_srv.stop()
        jax_srv.stop()
        disttrace.set_service("proc")
        jax_disttrace.set_service("proc")


def test_warm_launches_split_the_warm_ups_from_the_traffic(monkeypatch):
    """/healthz's `kernel_launches` less `warm_launches` counts the
    launches outside the warm-ups; a warm-up under way counts every
    launch since it began, so a read in the middle of one never credits
    its launches to the traffic."""
    import tpu_ir_torch
    from tpu_ir_torch.serving.shardset import WarmLaunches

    counts = {"dense_score": 0, "cold_tier": 0}
    monkeypatch.setattr(tpu_ir_torch, "kernel_launches",
                        lambda: dict(counts))

    def traffic(split):
        snap = split.snapshot()
        return {n: snap["kernel_launches"][n] - snap["warm_launches"][n]
                for n in counts}

    split = WarmLaunches()
    with split.counting():
        counts["dense_score"] += 3
    counts["dense_score"] += 5              # routed requests
    counts["cold_tier"] += 2
    assert traffic(split) == {"dense_score": 5, "cold_tier": 2}
    with split.counting():                 # a reload's warm-up
        counts["dense_score"] += 3
        assert traffic(split) == {"dense_score": 5, "cold_tier": 2}
        with split.counting():             # another, overlapping it
            counts["cold_tier"] += 4
        assert traffic(split) == {"dense_score": 5, "cold_tier": 2}
    counts["dense_score"] += 1
    assert traffic(split) == {"dense_score": 6, "cold_tier": 2}
    assert split.snapshot()["warm_launches"] == {"dense_score": 6,
                                                 "cold_tier": 4}


def test_overloaded_is_503_with_reason_and_level():
    """A handler that sheds answers 503 with the Overloaded's reason and
    level, in both packages."""
    def shed(cls):
        def fn(payload):
            raise cls("queue_full", queue_depth=3, level="no_rerank")
        return fn

    out = []
    for server in (MetricsServer(rpc_handlers={"search": shed(Overloaded)}),
                   JaxMetricsServer(rpc_handlers={
                       "search": shed(JaxOverloaded)})):
        with server:
            out.append(_http(f"127.0.0.1:{server.port}", "POST",
                             "/rpc/search", b"{}"))
    assert out[0] == out[1] == (503, {"error": "overloaded",
                                      "reason": "queue_full",
                                      "level": "no_rerank"})


@pytest.mark.parametrize("layout", ["sparse", "dense"])
def test_http_workers_merge_to_the_single_scorer(index_dir, layout):
    """Three in-process workers over HTTP: the merged top-10 and the
    two-phase rerank are bitwise the single scorer's."""
    full = Scorer.load(index_dir, layout=layout, device="cpu")
    ranges = shard_doc_ranges(full.meta.num_docs, N_SHARDS)
    started = [serve_worker(index_dir, s, N_SHARDS, layout=layout,
                            warm=False, device="cpu")
               for s in range(N_SHARDS)]
    addrs = [f"127.0.0.1:{srv.port}" for srv, _, _ in started]
    try:
        for scoring in ("tfidf", "bm25"):
            for text in QUERIES:
                per = [rpc_post(a, "search", {"text": text, "k": 10,
                                              "scoring": scoring}, 30)
                       for a in addrs]
                assert {p["generation"] for p in per} == {0}
                got = merge_shard_topk(
                    [[tuple(h) for h in p["hits"]] for p in per], 10)
                want = full.search_batch([text], k=10, scoring=scoring,
                                         return_docids=False)[0]
                assert _bits(got) == _bits(want)
        c = 25
        for text in QUERIES:
            stage1 = [rpc_post(a, "search", {"text": text, "k": c,
                                             "scoring": "bm25"}, 30)
                      for a in addrs]
            cand = [d for d, _ in merge_shard_topk(
                [[tuple(h) for h in p["hits"]] for p in stage1], c)]
            cand += [0] * (c - len(cand))
            scores = {s: np.array(rpc_post(a, "cosine_at",
                                           {"text": text, "cand": cand},
                                           30)["scores"], np.float32)
                      for s, a in enumerate(addrs)}
            got = merge_candidate_scores(cand, scores, ranges, 10)
            want = full.search_batch([text], k=10, rerank=c,
                                     return_docids=False)[0]
            assert _bits(got) == _bits(want)
    finally:
        for srv, _, _ in started:
            srv.stop()


# -- (d) and (e): subprocess workers ------------------------------------------


def _expected(live: str, gen: int, texts: list[str]) -> dict:
    """{(shard, text index): bits} of one generation, from in-process
    doc-range scorers."""
    from tpu_ir_torch.index import format as fmt
    from tpu_ir_torch.index.segments import resolve_serving

    n = fmt.IndexMetadata.load(resolve_serving(live, gen)[0]).num_docs
    out = {}
    for s, rg in enumerate(shard_doc_ranges(n, 2)):
        sc = Scorer.load_generation(live, gen, layout="sparse",
                                    device="cpu", doc_range=rg)
        for i, res in enumerate(sc.search_batch(texts, k=10, scoring="bm25",
                                                return_docids=False)):
            out[(s, i)] = _bits(res)
    return out


def _pid_gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_shardset_rolling_swap_respawn_and_stop(live_dir, tmp_path):
    live, gen_a, gen_b = live_dir
    texts = QUERIES[:5]
    want = {gen_a: _expected(live, gen_a, texts),
            gen_b: _expected(live, gen_b, texts)}
    ss = ShardSet(live, shards=2, index_generation=gen_a, device="cpu",
                  rundir=str(tmp_path / "run"), spawn_timeout_s=120.0)
    pids = set()
    try:
        ss.start()
        assert ss.lifecycle() == [["active"], ["active"]]
        assert ss.epoch() == 2
        assert ss.dispatchable() == ss.addresses()
        for s in range(2):
            with open(ss._cfg_paths(s, 0, 0)[1]) as f:
                assert set(json.load(f)) == READY_KEYS
        addrs = [row[0] for row in ss.addresses()]
        pids |= {h[0].pid for h in ss.handles()}
        for a in addrs:
            w = get_worker_health(a, 10)["worker"]
            assert (w["index_generation"], w["generation"],
                    w["live"]) == (gen_a, 0, True)

        # threaded traffic across the rolling swap
        stop = threading.Event()
        seen, errors = [], []
        lock = threading.Lock()

        def client(tid: int) -> None:
            i = tid
            while not stop.is_set():
                s, t = i % 2, (i // 2) % len(texts)
                try:
                    out = rpc_post(addrs[s], "search",
                                   {"text": texts[t], "k": 10,
                                    "scoring": "bm25"}, 30)
                    with lock:
                        seen.append((s, t, out["generation"], out["hits"]))
                except Exception as e:  # noqa: BLE001 — must be none
                    with lock:
                        errors.append(repr(e))
                i += 4

        threads = [threading.Thread(target=client, args=(t,), daemon=True)
                   for t in range(4)]
        for th in threads:
            th.start()
        time.sleep(0.3)
        report = rolling_swap(ss, gen_b)
        time.sleep(0.3)
        stop.set()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors[:3]
        assert report["generation"] == gen_b and not report["failed"]
        assert len(report["swapped"]) == 2
        assert {g for _, _, g, _ in seen} == {gen_a, gen_b}
        for s, t, g, hits in seen:
            assert _bits(hits) == want[g][(s, t)]
        for a in addrs:
            assert get_worker_health(a, 10)["worker"][
                "index_generation"] == gen_b

        # a killed worker comes back on B, on a new port
        killed = ss.kill(0, 0)
        assert not ss.handles()[0][0].alive
        h = ss.respawn(0, 0)
        pids.add(h.pid)
        w = get_worker_health(h.addr, 10)["worker"]
        assert (w["index_generation"], w["generation"]) == (gen_b, 1)
        assert killed != h.pid and ss.epoch() == 3
        assert obs.get_registry().get("router.worker_respawn") == 1
        out = rpc_post(h.addr, "search", {"text": texts[0], "k": 10,
                                          "scoring": "bm25"}, 30)
        assert _bits(out["hits"]) == want[gen_b][(0, 0)]

        # a worker whose stdin closes exits
        other = ss.handles()[1][0]
        other.proc.stdin.close()
        assert other.proc.wait(timeout=60) == 0
    finally:
        ss.stop()
    assert pids and all(_pid_gone(p) for p in pids)
    # the respawned worker stopped on SIGTERM, the other on its stdin
    assert [h.proc.returncode for row in ss.handles() for h in row] == [0, 0]


# -- the command line and the micro-bench -------------------------------------


def test_swap_microbench_keys_equal_jax(tmp_path):
    kw = dict(base_docs=16, delta_docs=4, probe_s=0.4, num_shards=2)
    got = swap_microbench(str(tmp_path / "port"), device="cpu", **kw)
    want = jax_swap_microbench(str(tmp_path / "jax"), **kw)
    assert sorted(got) == sorted(want)
    assert (got["generation_a"], got["num_docs_b"]) == (
        want["generation_a"], want["num_docs_b"])
    assert got["generations_seen"] == [got["generation_a"],
                                       got["generation_b"]]
    assert got["probes"] > 0 and got["swap_staleness_ms"] >= 0


@pytest.mark.parametrize("fault", ["shed", "error"])
def test_swap_microbench_counts_a_shed_as_gap_and_raises_an_error(
        tmp_path, monkeypatch, fault):
    """A probe shed inside the swap is part of the gap the bench reports;
    any other probe error fails the bench (`tpu_ir` swallows both)."""
    from tpu_ir_torch.serving import frontend as frontend_mod

    real_search = frontend_mod.ServingFrontend.search
    real_reload = frontend_mod.ServingFrontend.reload_generation
    swapping = threading.Event()
    faulted = []

    def search(self, *a, **kw):
        if swapping.is_set():
            faulted.append(fault)
            if fault == "shed":
                raise Overloaded("queue_full", queue_depth=1, level="full")
            raise RuntimeError("a probe's own fault")
        return real_search(self, *a, **kw)

    def reload_generation(self, *a, **kw):
        swapping.set()
        try:
            time.sleep(0.3)
            return real_reload(self, *a, **kw)
        finally:
            swapping.clear()

    monkeypatch.setattr(frontend_mod.ServingFrontend, "search", search)
    monkeypatch.setattr(frontend_mod.ServingFrontend, "reload_generation",
                        reload_generation)
    kw = dict(base_docs=16, delta_docs=4, probe_s=0.4, num_shards=2,
              device="cpu")
    if fault == "error":
        with pytest.raises(RuntimeError, match="a probe's own fault"):
            swap_microbench(str(tmp_path / "live"), **kw)
        return
    got = swap_microbench(str(tmp_path / "live"), **kw)
    assert faulted and got["probes"] > 0
    assert got["swap_gap_ms"] >= 300.0


def test_ingest_swap_bench_and_soak_bench(tmp_path, capsys):
    live = str(tmp_path / "live")
    assert cli_main(["ingest", live, "--swap-bench", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {
        "generation_a", "generation_b", "generations_seen", "num_docs_b",
        "probes", "swap_gap_ms", "swap_staleness_ms", "swap_wall_s",
        "history", "history_row"}
    assert report["history"] is None
    assert report["history_row"]["config"] == "ingest_swap"
    assert report["history_row"]["backend"] == "cpu"
    assert report["num_docs_b"] == 80
    # the ingest soak at its defaults on a live dir of its own
    soak_live = str(tmp_path / "soak")
    assert cli_main(["ingest", soak_live, "--soak-bench",
                     "--device", "cpu"]) == 0
    soak = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert soak["history"] is None
    assert soak["history_row"] == {
        "config": "ingest_soak", "backend": "cpu", "docs": 48, "kills": 1,
        "swaps": soak["swaps"], "ingest_docs_per_s":
        soak["ingest_docs_per_s"], "freshness_lag_ms":
        soak["freshness_lag_ms"]}
    assert soak["lost_acked"] == soak["stale"] == soak["errors"] == 0
    assert soak["child_replayed"] >= 1 and soak["swaps"] >= 1
    assert soak["recovered_docs"] == 12 + 48


def test_serve_worker_cli_json_equals_jax(index_dir, tmp_path):
    """`serve-worker --run-for` in a subprocess prints one ready JSON line
    with the JAX command's keys and values, then exits 0."""
    r = subprocess.run(
        [sys.executable, "-m", "tpu_ir_torch.cli", "serve-worker", index_dir,
         "--shard", "1/2", "--run-for", "0.5", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    twin = str(tmp_path / "twin")
    shutil.copytree(index_dir, twin,
                    ignore=shutil.ignore_patterns("serving-*"))
    buf = io.StringIO()
    th = threading.Thread(target=lambda: jax_cli_main(
        ["serve-worker", twin, "--shard", "1/2", "--run-for", "0.2",
         "--no-warm", "--backend", "cpu"]))
    with contextlib.redirect_stdout(buf):
        th.start()
        th.join(timeout=300)
    want = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert sorted(got) == sorted(want)
    for key in ("shard", "num_shards", "replica", "index_generation",
                "doc_range"):
        assert got[key] == want[key], key
    assert got["addr"] == f"127.0.0.1:{got['port']}"
    assert cli_main(["serve-worker", index_dir, "--shard", "2/2",
                     "--device", "cpu"]) == 2
