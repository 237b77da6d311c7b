"""The port's query log and slow-query trap (tpu_ir_torch/obs/querylog.py
and its hooks in the Scorer, the frontend, the coalescer and the CLI)
held against `tpu_ir`'s on the CPU, after tests/test_querylog.py.

The same corpus and the same texts go through both packages' Scorer and
ServingFrontend. Entries are compared with their volatile fields left out
(`time`, `seq`, `batch_id`, trace ids and every `*_ms` stage time), the
top hits' docids exactly and their scores within rtol 1e-5 (XLA and torch
round sums differently in the last place). No worker process: the
router's entries are checked by tests/test_torch_router.py's chaos soak.
Wall-clock overhead is not pinned here (the card measures it)."""

import contextlib
import io
import json
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from tpu_ir import cli as jax_cli
from tpu_ir import obs as jax_obs
from tpu_ir.obs import querylog as jax_ql
from tpu_ir.search import Scorer as JaxScorer
from tpu_ir.serving import ServingFrontend as JaxFrontend

from tpu_ir_torch import cli as port_cli
from tpu_ir_torch import obs as port_obs
from tpu_ir_torch.index import build_index
from tpu_ir_torch.obs import disttrace as port_dt
from tpu_ir_torch.obs import querylog as port_ql
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.serving import ServingConfig, ServingFrontend
from tpu_ir_torch.serving.batching import CoalescingScheduler, _Slot

RTOL = 1e-5
WORDS = ("salmon fishing river bears honey quick brown fox lazy dog "
         "market investor asset bond stock season rain forest".split())
TEXTS = ["salmon fishing", "honey bears", "common salmon",
         "stock market investor", "zzznope", "common"]
VOLATILE = {"time", "seq", "batch_id", "trace_id"}
PACKAGES = {"port": (port_obs, port_ql), "jax": (jax_obs, jax_ql)}


@pytest.fixture(autouse=True)
def _clean_state():
    """Both packages' telemetry and query-log settings start and end at
    their defaults (the suite's conftest resets only tpu_ir's)."""
    for o, ql in PACKAGES.values():
        o.reset_all()
    yield
    for o, ql in PACKAGES.values():
        ql.configure(enabled=True, sample=1, ring_capacity=256,
                     redact=False, slow_ms=0.0, slow_keep=16)
        o.reset_all()


def write_corpus(path, n_docs=120):
    """`n_docs` docs over WORDS, "common" in two of three (the tiered
    layout's hot strip)."""
    body = []
    for i in range(n_docs):
        words = [WORDS[(i + j * (1 + i % 3)) % len(WORDS)]
                 for j in range(3 + i % 7)]
        if i % 3:
            words.insert(0, "common")
        body.append(f"<DOC>\n<DOCNO> Q-{i:04d} </DOCNO>\n<TEXT>\n"
                    f"{' '.join(words)}\n</TEXT>\n</DOC>\n")
    path.write_text("".join(body))
    return str(path)


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("querylog")
    out = str(tmp / "idx")
    build_index(write_corpus(tmp / "corpus.trec"), out, num_shards=2,
                compute_chargrams=False, device="cpu")
    return out


@pytest.fixture(scope="module")
def scorers(index_dir):
    """{layout: {package: scorer}}, each warmed on both scorings."""
    out = {}
    for layout in ("sparse", "dense"):
        out[layout] = {
            "port": Scorer.load(index_dir, layout=layout, device="cpu"),
            "jax": JaxScorer.load(index_dir, layout=layout)}
        for s in out[layout].values():
            for scoring in ("tfidf", "bm25"):
                s.search_batch(["salmon fishing"], k=5, scoring=scoring)
    for o, _ in PACKAGES.values():
        o.reset_all()
    return out


def norm(entry: dict) -> dict:
    """An entry without its volatile fields, the top hits' docids only."""
    out = {k: v for k, v in entry.items()
           if k not in VOLATILE and not k.endswith("_ms")}
    if "top" in out:
        out["top"] = [key for key, _ in out["top"]]
    return out


def assert_entries_match(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert norm(g) == norm(w)
        assert set(g) == set(w)
        np.testing.assert_allclose([s for _, s in g.get("top", [])],
                                   [s for _, s in w.get("top", [])],
                                   rtol=RTOL, atol=1e-6)


def both(fn):
    """fn(package) run for each package on its own query log; returns
    {package: that package's ring after the run}."""
    out = {}
    for name, (_, ql) in PACKAGES.items():
        ql.clear()
        fn(name)
        out[name] = ql.recent()
    return out


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["sparse", "dense"])
@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
def test_entries_match_tpu_ir(scorers, layout, scoring):
    """One entry a query, with tpu_ir's fields: terms, query_hash, level,
    batch size, the top hits and (tiered) the MaxScore decision."""
    rings = both(lambda p: scorers[layout][p].search_batch(
        TEXTS, k=5, scoring=scoring))
    assert_entries_match(rings["port"], rings["jax"])
    port = rings["port"]
    assert len({e["batch_id"] for e in port}) == 1
    assert [e["batch_size"] for e in port] == [len(TEXTS)] * len(TEXTS)
    assert port[0]["terms"] == ["salmon", "fish"]
    assert port[0]["total_ms"] >= port[0]["dispatch_ms"] >= 0
    assert ("prune" in port[0]) == (layout == "sparse")
    assert port_obs.get_registry().get("querylog.recorded") == len(TEXTS)


def test_query_hash_is_tpu_ir_crc():
    for terms in ([], [1, 2, 3], ["salmon", "fish"], [70000]):
        assert port_ql.query_hash(terms) == jax_ql.query_hash(terms)


def _ring_case(case, ql, run):
    if case == "sampling":
        ql.configure(sample=3)
        for i in range(9):
            run([f"salmon query{i}"])
    elif case == "ring_bound":
        ql.configure(ring_capacity=4)
        for _ in range(10):
            run(["honey"])
    elif case == "redaction":
        ql.configure(redact=True)
        run(["salmon fishing"])
        ql.configure(redact=False)
        run(["salmon fishing"])
    elif case == "disabled":
        ql.configure(enabled=False)
        run(["salmon"])


@pytest.mark.parametrize("case", ["sampling", "ring_bound", "redaction",
                                  "disabled"])
def test_ring_settings_match_tpu_ir(scorers, case):
    """Sampling keeps every N-th entry (the counter counts kept ones),
    the ring is bounded, redaction keeps the hash and drops the terms,
    and a disabled log records nothing: as in tpu_ir."""
    counts = {}

    def go(p):
        o, ql = PACKAGES[p]
        before = o.get_registry().get("querylog.recorded")
        _ring_case(case, ql, lambda t: scorers["sparse"][p].search_batch(
            t, k=2))
        counts[p] = (o.get_registry().get("querylog.recorded") - before,
                     ql.summary()["enabled"])

    rings = both(go)
    assert_entries_match(rings["port"], rings["jax"])
    assert counts["port"] == counts["jax"]
    want_len = {"sampling": 3, "ring_bound": 4, "redaction": 2,
                "disabled": 0}[case]
    assert len(rings["port"]) == want_len
    if case == "redaction":
        a, b = rings["port"]
        assert "terms" not in a and b["terms"] == ["salmon", "fish"]
        assert a["query_hash"] == b["query_hash"]


def test_frontend_level_matches_tpu_ir(scorers):
    """The request context stamps the frontend's level and queue depth;
    a frontend search records the same entry in both packages."""
    def go(p):
        s = scorers["sparse"][p]
        with PACKAGES[p][1].request_context(level="no_rerank",
                                            queue_depth=3):
            s.search_batch(["honey bears"], k=3)
        fe = (ServingFrontend(s, ServingConfig(deadline_s=None))
              if p == "port" else JaxFrontend(s))
        fe.search("salmon fishing", k=5, scoring="bm25")

    rings = both(go)
    assert_entries_match(rings["port"], rings["jax"])
    ctx, served = rings["port"]
    assert ctx["level"] == "no_rerank" and ctx["queue_depth"] == 3
    assert served["level"] == "full" and served["queue_depth"] == 0


def test_phrase_queries_record_slim_entries(tmp_path):
    """A phrase query scores on the host and leaves tpu_ir's slim entry:
    `phrase`, no stage split, no MaxScore decision."""
    corpus = tmp_path / "c.trec"
    corpus.write_text(
        "<DOC>\n<DOCNO> P-1 </DOCNO>\n<TEXT>\nsalmon river fishing\n"
        "</TEXT>\n</DOC>\n"
        "<DOC>\n<DOCNO> P-2 </DOCNO>\n<TEXT>\nriver salmon\n</TEXT>\n"
        "</DOC>\n")
    idx = str(tmp_path / "pidx")
    build_index(str(corpus), idx, compute_chargrams=False, positions=True,
                device="cpu")
    pair = {"port": Scorer.load(idx, device="cpu"),
            "jax": JaxScorer.load(idx)}
    rings = both(lambda p: [pair[p].search_batch([t], k=5) for t in (
        '"salmon river"', '"river fishing salmon"')])
    assert_entries_match(rings["port"], rings["jax"])
    hit, miss = rings["port"]
    assert hit["phrase"] is True and hit["top"][0][0] == "P-1"
    assert miss["top"] == [] and "dispatch_ms" not in hit


def test_coalesced_batch_refuses_a_phrase_with_slot_meta(scorers):
    with pytest.raises(ValueError, match="slot_meta"):
        scorers["sparse"]["port"].search_batch(
            ['"salmon river"', "honey"], slot_meta=[{}, {}])


# ---------------------------------------------------------------------------
# the slow-query trap
# ---------------------------------------------------------------------------


def _trap(p, scorers, tmp_path, monkeypatch, run):
    """Arm package p's trap for every request, its flight records under
    tmp_path/p, and run run(scorer); returns (result, captures)."""
    o, ql = PACKAGES[p]
    monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(tmp_path / p))
    ql.configure(slow_ms=0.0001)
    o.reset_rate_limit()
    res = run(scorers["sparse"][p])
    return res, ql.slow_recent()


def _frontend(p, s):
    fe = (ServingFrontend(s, ServingConfig(deadline_s=None))
          if p == "port" else JaxFrontend(s))
    return fe.search("salmon fishing", k=5, scoring="bm25")


def test_slow_trap_end_to_end_matches_tpu_ir(scorers, tmp_path,
                                             monkeypatch, capsys):
    """A slow frontend request leaves a capture with the open request's
    span tree, an explain whose sum is the returned score bit for bit,
    and a `slow_query` record whose header lists the offender and its
    trace id and whose last line is the telemetry; `querylog --slow`
    prints it. The capture and the record have tpu_ir's keys (less the
    header's profiling and time-series fields)."""
    caps, heads = {}, {}
    for p in PACKAGES:
        res, got = _trap(p, scorers, tmp_path, monkeypatch,
                         lambda s, p=p: _frontend(p, s))
        cap = got[-1]
        assert cap["slow"] is True and cap["span_tree"]["name"] == "request"
        assert "dispatch" in {c["name"] for c in cap["span_tree"]["children"]}
        ex = cap["explain"][0]
        assert ex["contribution_sum"] == ex["score"] == res[0][1]
        recs = [json.loads(line) for line in open(cap["flight_record"])]
        header = recs[0]
        assert header["reason"] == "slow_query"
        assert header["slow_queries"][-1]["query_hash"] == cap["query_hash"]
        assert header["extra"]["slow_query"]["explain"][0]["score"] == \
            ex["score"]
        assert recs[-1]["record"] == "telemetry"
        assert {r["record"] for r in recs[1:-1]} <= {"trace"}
        caps[p], heads[p] = cap, header
        cli = port_cli if p == "port" else jax_cli
        assert cli.main(["querylog", "--slow"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["slow_entries"][-1]["query_hash"] == cap["query_hash"]
        assert "entries" not in out
    assert set(caps["port"]) == set(caps["jax"])
    assert norm({k: v for k, v in caps["port"].items()
                 if k not in ("span_tree", "explain", "flight_record")}) == \
        norm({k: v for k, v in caps["jax"].items()
              if k not in ("span_tree", "explain", "flight_record")})
    assert set(heads["port"]) == set(heads["jax"])
    for key in ("memory", "compile_cache"):
        assert set(heads["port"][key]) == set(heads["jax"][key])
    # the frontend minted the request's trace: the header's join key
    assert heads["port"]["trace_id"] == caps["port"]["trace_id"]
    assert heads["port"]["open_root"]["name"] == "request"
    assert port_obs.get_registry().get("querylog.slow") == 1
    assert port_ql.slow_last_60s() == 1


def test_slow_trap_explain_rides_the_rate_gate(scorers, tmp_path,
                                               monkeypatch):
    """A second slow query inside the interval is captured, but neither
    explained nor recorded, in both packages."""
    shapes = {}
    for p in PACKAGES:
        def run(s):
            s.search_batch(["salmon fishing"], k=3, scoring="bm25")
            s.search_batch(["honey bears"], k=3, scoring="bm25")

        _, caps = _trap(p, scorers, tmp_path, monkeypatch, run)
        assert len(caps) == 2
        assert caps[0].get("explain") and caps[0]["flight_record"]
        assert caps[1].get("explain") is None
        assert caps[1]["flight_record"] is None
        assert len(list((tmp_path / p).glob("*slow_query.jsonl"))) == 1
        shapes[p] = [sorted(c) for c in caps]
    assert shapes["port"] == shapes["jax"]


def test_slow_capture_without_frontend_uses_ring_span(scorers, tmp_path,
                                                      monkeypatch):
    for p in PACKAGES:
        _, caps = _trap(p, scorers, tmp_path, monkeypatch,
                        lambda s: s.search_batch(["salmon fishing"], k=3))
        assert caps[-1].get("span_tree") is not None
        assert caps[-1].get("span_tree_source") == "ring"


# ---------------------------------------------------------------------------
# counters, the server, the CLI
# ---------------------------------------------------------------------------


def test_querylog_counters_are_declared():
    reg = port_obs.get_registry()
    assert {"querylog.recorded", "querylog.slow"} <= set(reg.counter_names())
    assert "querylog.slow_capture" in reg.snapshot()["histograms"]
    assert port_ql.summary().keys() == jax_ql.summary().keys()


def test_server_querylog_route(scorers):
    """/querylog (and ?slow=1, ?n=, ?format=html), /healthz's
    slow_queries_last_60s."""
    from tpu_ir_torch.obs.server import MetricsServer

    scorers["sparse"]["port"].search_batch(["salmon fishing", "honey"], k=3)
    srv = MetricsServer().start()
    try:
        def get(path):
            with urllib.request.urlopen(f"{srv.url}{path}", timeout=10) as r:
                return r.read()

        ql = json.loads(get("/querylog"))
        assert ql["ring"]["capacity"] == 256 and len(ql["entries"]) == 2
        assert json.loads(get("/querylog?n=1"))["entries"] == \
            ql["entries"][-1:]
        slow = json.loads(get("/querylog?slow=1"))
        assert "entries" not in slow and slow["slow_entries"] == []
        page = get("/querylog?format=html").decode()
        assert "/jobs?format=html" in page and "query_hash" in page
        assert json.loads(get("/healthz"))["slow_queries_last_60s"] == 0
    finally:
        srv.stop()


def test_serve_bench_report_carries_querylog(index_dir, capsys):
    """Both CLIs' single-process serve-bench report a `querylog` section
    of the same keys, every request recorded."""
    sections = {}
    for p, argv in (("port", ["--device", "cpu"]), ("jax", [])):
        cli = port_cli if p == "port" else jax_cli
        assert cli.main(["serve-bench", index_dir, "--threads", "2",
                         "--queries", "12", "--deadline", "5.0",
                         *argv]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        sections[p] = out["querylog"]
        assert out["querylog"]["recorded"] >= 12
    assert set(sections["port"]) == set(sections["jax"])
    assert sections["port"]["slow_entries"] == []


def test_querylog_trace_filter(scorers, capsys):
    """`querylog --trace ID` keeps the entries of one distributed trace,
    as tpu_ir's does (tests/test_disttrace.py)."""
    s = scorers["sparse"]["port"]
    fe = ServingFrontend(s, ServingConfig(deadline_s=None))
    a = fe.search("salmon fishing", k=3)
    fe.search("honey bears", k=3)
    assert a.trace_id
    assert port_cli.main(["querylog", "--trace", a.trace_id]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["trace_filter"] == a.trace_id
    assert [e["trace_id"] for e in out["entries"]] == [a.trace_id]
    assert jax_cli.main(["querylog", "--trace", a.trace_id]) == 0
    want = json.loads(capsys.readouterr().out)
    assert set(out) == set(want)


# ---------------------------------------------------------------------------
# the port alone: a coalesced batch's per-slot attribution
# ---------------------------------------------------------------------------


def test_coalesced_batch_stamps_each_slot(scorers):
    """A shared dispatch records one entry a slot, each with the slot's
    own level, queue depth, queue wait and trace id and the batch's
    occupancy, one batch_id, on the leader's thread."""
    s = scorers["sparse"]["port"]
    sched = CoalescingScheduler(s)
    key = dict(k=5, scoring="bm25", rerank=None, hot_only=False,
               force_host=False)
    from tpu_ir_torch.serving.batching import BatchKey

    slots, tids = [], []
    for i, (text, level) in enumerate((("salmon fishing", "full"),
                                       ("honey bears", "no_rerank"),
                                       ("common salmon", "full"))):
        ctx = port_dt.mint()
        tids.append(ctx.trace_id)
        with port_dt.use(ctx):
            slots.append(_Slot(text, BatchKey(**key), 0, level, i))
    port_ql.clear()
    sched._execute(slots)
    entries = port_ql.recent()
    assert [e["level"] for e in entries] == ["full", "no_rerank", "full"]
    assert [e["queue_depth"] for e in entries] == [0, 1, 2]
    assert [e["trace_id"] for e in entries] == tids
    assert {e["batch_occupancy"] for e in entries} == {3}
    assert len({e["batch_id"] for e in entries}) == 1
    assert all(e["queue_wait_ms"] >= 0 for e in entries)
    for slot, e in zip(slots, entries):
        assert slot.result is not None and e["top"][0][0] == \
            slot.result[0][0]


def test_coalesced_frontend_entries_carry_their_level(scorers):
    """Through a coalescing frontend under concurrency, every entry is
    stamped with its request's level and its own trace id."""
    s = scorers["sparse"]["port"]
    fe = ServingFrontend(s, ServingConfig(coalesce=True, deadline_s=None))
    port_ql.clear()
    results = [None] * 8

    def go(i):
        results[i] = fe.search(TEXTS[i % len(TEXTS)], k=3)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    entries = port_ql.recent()
    assert len(entries) == 8
    assert {e["trace_id"] for e in entries} == {r.trace_id for r in results}
    assert all(e["level"] == "full" and "batch_occupancy" in e
               for e in entries)
