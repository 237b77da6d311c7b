"""The port's distributed request tracing (tpu_ir_torch/obs/disttrace.py,
trace.py's ring and root hooks, aggregate.py's span spool, the `trace`
command) held against `tpu_ir`'s on the CPU, with no worker process.

Both packages get the same inputs: the same traceparent strings, the same
scripted span tree under one fake clock each, the same sequences of roots
for the keep-or-drop verdict, the same record sets to stitch, and each
other's span spool. Trace and span ids come from os.urandom in both, so
records are compared with the ids renamed in order of appearance.

Then, in the port alone (after tests/test_disttrace.py): a coalesced
batch's dispatch re-parented under every member's trace, the one-process
frontend's mint, the `/rpc` handler's adoption and piggyback, and the
`/slo`, `/trace` and `/trace/<id>` routes over an in-process server."""

import importlib
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from tpu_ir import cli as jax_cli
from tpu_ir import obs as jax_obs
from tpu_ir.obs import disttrace as jax_dt
from tpu_ir.obs.aggregate import read_span_spool as jax_read_spool

from tpu_ir_torch import cli as port_cli
from tpu_ir_torch import obs as port_obs
from tpu_ir_torch.obs import disttrace as port_dt
from tpu_ir_torch.obs.aggregate import read_span_spool as port_read_spool

# the modules (each package's obs re-exports a function named trace)
jax_trace = importlib.import_module("tpu_ir.obs.trace")
port_trace = importlib.import_module("tpu_ir_torch.obs.trace")

PACKAGES = {"port": (port_obs, port_dt, port_trace),
            "jax": (jax_obs, jax_dt, jax_trace)}
TID = "4bf92f3577b34da6a3ce929d0e0e4736"
SID = "00f067aa0ba902b7"
WORDS = ("salmon fishing river bears honey quick brown fox lazy dog "
         "market investor asset bond stock season rain forest".split())


@pytest.fixture(autouse=True)
def _clean_state():
    for o, dt, _ in PACKAGES.values():
        o.reset_all()
        dt.set_service("proc")
    yield
    for o, dt, _ in PACKAGES.values():
        o.reset_all()
        dt.set_service("proc")


class FakeClock:
    """A `time` module whose perf_counter_ns steps 1 ms a read and whose
    wall clock stands still, so two packages' spans get the same times."""

    def __init__(self):
        self.ns = 10**12
        self.wall = 1_760_000_000.0

    def perf_counter_ns(self):
        self.ns += 1_000_000
        return self.ns

    def time(self):
        return self.wall

    def advance_ms(self, ms: float):
        self.ns += int(ms * 1e6)

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock a package, in its trace and disttrace modules; the
    ring's sampling phase and settings start alike and are put back."""
    out = {}
    for name, (_, dt, tr) in PACKAGES.items():
        clock = out[name] = FakeClock()
        monkeypatch.setattr(tr, "time", clock)
        monkeypatch.setattr(dt, "time", clock)
        monkeypatch.setattr(tr, "_root_seq", 0)
        monkeypatch.setattr(tr, "_SAMPLE_N", 1)
        monkeypatch.setattr(tr, "_RING", tr._RING)
    return out


def _script(o, clock, anomaly=None):
    """The serving path's tree: request -> ladder, admission_wait,
    dispatch -> kernel x 2."""
    with o.trace("request", scoring="bm25") as r:
        with o.trace("ladder") as lsp:
            lsp.set("level", "full")
        with o.trace("admission_wait"):
            pass
        with o.trace("dispatch", label="topk"):
            for rows in (4, 1):
                with o.trace("kernel", rows=rows):
                    pass
        if anomaly == "slow":
            clock.advance_ms(300.0)
        elif anomaly == "error":
            raise RuntimeError("boom")
        elif anomaly == "hedges":
            r.set("hedges", 2)
        elif anomaly is not None:
            r.set(anomaly, True)
        r.set("level", "full")


def _normalized(records: list, keep: tuple = ()) -> list:
    """Records with each span id renamed by its order of appearance (ids
    in `keep`, or not among the records, stay as they are)."""
    names = {}
    for r in records:
        if r["span_id"] not in keep:
            names.setdefault(r["span_id"], f"#{len(names)}")
    out = []
    for r in records:
        r = dict(r, attrs=dict(r["attrs"]))
        r["span_id"] = names.get(r["span_id"], r["span_id"])
        r["parent_id"] = names.get(r["parent_id"], r["parent_id"])
        out.append(r)
    return out


def _counters(o) -> dict:
    return {n: v for n, v in o.get_registry().counters().items()
            if n.startswith(("disttrace.", "slo."))}


# -- the context -------------------------------------------------------------


@pytest.mark.parametrize("header", [
    f"00-{TID}-{SID}-01", f"00-{TID}-{SID}-00", f"  00-{TID}-{SID}-01\n",
    f"00-{TID.upper()}-{SID}-01",
    None, "", "garbage", "01-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-short-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-short-01",
    "00-" + "z" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01-x",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-1",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-zz",
])
def test_traceparent_parses_as_jax(header):
    got = port_dt.parse_traceparent(header)
    assert got == jax_dt.parse_traceparent(header)
    p, j = port_dt.adopt(header), jax_dt.adopt(header)
    assert (p is None) == (j is None) == (got is None)
    if p is not None:
        assert (p.trace_id, p.parent_id, p.flags, p.adopted) == (
            j.trace_id, j.parent_id, j.flags, j.adopted)
        assert p.span_id != p.parent_id and len(p.span_id) == 16
        assert _counters(port_obs) == _counters(jax_obs)


def test_context_header_child_and_use_as_jax():
    p, j = port_dt.TraceContext(TID, SID), jax_dt.TraceContext(TID, SID)
    assert p.to_header() == j.to_header() == f"00-{TID}-{SID}-01"
    assert repr(p) == repr(j)
    pc, jc = port_dt.child(p), jax_dt.child(j)
    assert (pc.trace_id, pc.parent_id, pc.flags) == (
        jc.trace_id, jc.parent_id, jc.flags) == (TID, SID, 1)
    assert port_dt.child(None) is None
    minted = port_dt.mint()
    assert len(minted.trace_id) == 32 and len(minted.span_id) == 16
    assert port_dt.current() is None
    with port_dt.use(minted):
        assert port_dt.current_trace_id() == minted.trace_id
        with port_dt.use(pc):
            assert port_dt.current() is pc
        assert port_dt.current() is minted
        seen = []
        t = threading.Thread(target=lambda: seen.append(port_dt.current()))
        t.start()
        t.join(5)
        assert not t.is_alive() and seen == [None]
    with port_dt.use(None):
        assert port_dt.current() is None
    port_dt.configure(enabled=False)
    jax_dt.configure(enabled=False)
    assert port_dt.mint() is jax_dt.mint() is None
    assert port_dt.adopt(f"00-{TID}-{SID}-01") is None
    assert port_dt.add_span(TID, "x") is None
    assert port_dt.piggyback(TID) is None


# -- the root-close hook: flatten, keep or drop ------------------------------


@pytest.mark.parametrize("how", ["minted", "adopted"])
def test_span_tree_flattens_as_jax(how, clocks):
    got = {}
    for name, (o, dt, _) in PACKAGES.items():
        dt.set_service("worker-s1r0")
        ctx = (dt.TraceContext(TID, SID) if how == "minted"
               else dt.adopt(f"00-{TID}-{SID}-01"))
        with dt.use(ctx):
            _script(o, clocks[name])
        recs = dt.spans_for(TID)
        assert recs[0]["span_id"] == ctx.span_id
        got[name] = _normalized(recs, keep=(SID,) if how == "adopted"
                                else ())
    assert got["port"] == got["jax"]
    names = [r["name"] for r in got["port"]]
    assert names == ["request", "ladder", "admission_wait", "dispatch",
                     "kernel", "kernel"]
    root = got["port"][0]
    assert root["parent_id"] == (SID if how == "adopted" else None)
    assert root["dur_ms"] > 0 and root["service"] == "worker-s1r0"
    assert _counters(port_obs) == _counters(jax_obs)


SEQUENCES = {
    "sample3": [None] * 7,
    "sample3_tail": [None, "partial", None, "slow", None, "hedges", None,
                     "error", None, "degraded", "shed", None],
    "sample3_no_tail": [None, "partial", None, "slow", None, "hedges",
                        None, "error", None, "degraded", "shed", None],
    **{f"anomaly_{a}": [a] for a in ("slow", "error", "partial",
                                     "degraded", "hedges", "shed")},
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_keep_or_drop_verdicts_equal_jax(name, clocks):
    tail = not name.endswith("no_tail")
    sample = 10_000 if name.startswith("anomaly") else 3
    got = {}
    for pkg, (o, dt, _) in PACKAGES.items():
        dt.configure(sample=sample, tail=tail)
        verdicts = []
        for anomaly in SEQUENCES[name]:
            ctx = dt.mint()
            try:
                with dt.use(ctx):
                    _script(o, clocks[pkg], anomaly)
            except RuntimeError:
                pass
            verdicts.append(ctx.trace_id in dt.trace_ids())
        got[pkg] = (verdicts, _counters(o))
    assert got["port"] == got["jax"]
    verdicts, counters = got["port"]
    if name.startswith("anomaly"):
        assert verdicts == [True] and counters["disttrace.kept_tail"] == 1
    elif name == "sample3":
        assert verdicts == [False, False, True] * 2 + [False]


def test_roots_without_a_context_are_not_recorded(clocks):
    for name, (o, dt, _) in PACKAGES.items():
        _script(o, clocks[name])
        assert dt.trace_ids() == []
    assert _counters(port_obs) == _counters(jax_obs)


# -- the store ---------------------------------------------------------------


def test_store_eviction_and_annotate_as_jax():
    tids = ["%032x" % i for i in (1, 2, 3)]
    got = {}
    for name, (o, dt, _) in PACKAGES.items():
        dt.configure(max_traces=2)
        for t in tids:
            dt.add_span(t, "x", start_ms=5.0)
        sid = dt.add_span(tids[2], "rpc.search", span_id=SID,
                          parent_id="ab" * 8, start_ms=7.0, dur_ms=0.0,
                          attrs={"shard": 0, "hedge": True})
        dt.annotate(tids[2], sid, dur_ms=12.5, outcome="won")
        dt.annotate(tids[2], "feedfeedfeedfeed", outcome="lost")
        dt.annotate("f" * 32, sid, outcome="lost")
        got[name] = (dt.trace_ids(), dt.spans_for(tids[0]),
                     _normalized(dt.spans_for(tids[2]), keep=(SID,)))
    assert got["port"] == got["jax"]
    ids, evicted, recs = got["port"]
    assert ids == tids[1:] and evicted == []
    assert recs[1]["dur_ms"] == 12.5
    assert recs[1]["attrs"] == {"shard": 0, "hedge": True,
                                "outcome": "won"}


def test_spans_past_a_trace_cap_are_dropped_as_jax(monkeypatch):
    for name, (o, dt, _) in PACKAGES.items():
        monkeypatch.setattr(dt, "_MAX_SPANS_PER_TRACE", 3)
        for i in range(5):
            dt.add_span(TID, f"s{i}")
        assert [r["name"] for r in dt.spans_for(TID)] == ["s0", "s1", "s2"]
    assert _counters(port_obs) == _counters(jax_obs)
    assert _counters(port_obs)["disttrace.spans_dropped"] == 2


def test_piggyback_and_ingest_remote_as_jax(clocks):
    got = {}
    for name, (o, dt, _) in PACKAGES.items():
        dt.set_service("worker-s0r0")
        ctx = dt.adopt(f"00-{TID}-{SID}-01")
        with dt.use(ctx):
            _script(o, clocks[name])
        batch = dt.piggyback(TID)
        dt.drop(TID)
        dt.ingest_remote(batch)
        dt.ingest_remote([{"no": "trace id"}, "junk"])
        again = dt.piggyback(TID)
        got[name] = (_normalized(batch, keep=(SID,)),
                     _normalized(dt.spans_for(TID), keep=(SID,)), again,
                     dt.spans_for(TID, local_only=True), _counters(o))
    assert got["port"] == got["jax"]
    batch, stored, again, local, counters = got["port"]
    assert len(batch) == 6 and stored == batch
    assert again is None and local == []
    assert counters["disttrace.spans_exported"] == 6
    assert counters["disttrace.adopted"] == 1


# -- stitching ---------------------------------------------------------------


def _record(sid, parent, name, start, dur, service="router", **attrs):
    return {"trace_id": TID, "span_id": sid, "parent_id": parent,
            "name": name, "service": service, "host": "h", "pid": 7,
            "start_ms": start, "dur_ms": dur, "attrs": attrs}


RECORDS = [
    _record("a" * 16, None, "request", 100.0, 40.0, router=True),
    _record("b" * 16, "a" * 16, "rpc.search", 110.0, 20.0, shard=1,
            outcome="won", hedge=False),
    _record("c" * 16, "a" * 16, "rpc.search", 105.0, 30.0, shard=0,
            outcome="won", hedge=False),
    _record("d" * 16, "c" * 16, "request", 107.0, 25.0, "worker-s0r0"),
    _record("e" * 16, "9" * 16, "rpc.search", 120.0, 3.0, shard=0,
            outcome="cancelled", hedge=True),
    _record("f" * 16, "a" * 16, "admission_wait", 100.5, 0.5),
]


def test_stitch_builds_the_same_tree_as_jax():
    got = {}
    for name, (o, dt, _) in PACKAGES.items():
        dt.ingest_remote([dict(r, attrs=dict(r["attrs"])) for r in RECORDS])
        got[name] = (dt.stitch(TID, include_spool=False),
                     dt.stitch("f" * 32, include_spool=False))
    assert got["port"] == got["jax"]
    st, unknown = got["port"]
    assert unknown is None
    assert st["span_count"] == 6 and st["dur_ms"] == 40.0
    assert st["services"] == ["router", "worker-s0r0"]
    # the orphan (its parent is in no record) is a root of its own
    assert [r["name"] for r in st["roots"]] == ["request", "rpc.search"]
    kids = st["roots"][0]["children"]
    assert [k["span_id"][0] for k in kids] == ["f", "c", "b"]
    assert kids[1]["children"][0]["service"] == "worker-s0r0"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_spool_stitches_the_same_in_both(writer, tmp_path, monkeypatch,
                                           clocks):
    monkeypatch.setenv("TPU_IR_TELEMETRY_DIR", str(tmp_path))
    o, dt, _ = PACKAGES[writer]
    dt.set_service("worker-s0r1")
    with dt.use(dt.adopt(f"00-{TID}-{SID}-01")):
        _script(o, clocks[writer])
    live = dt.stitch(TID, include_spool=False)
    dt.drop(TID)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 1 and files[0].startswith("spans-")
    assert port_read_spool() == jax_read_spool()
    port_st, jax_st = port_dt.stitch(TID), jax_dt.stitch(TID)
    assert port_st == jax_st == live
    assert port_st["span_count"] == 6


def test_trace_command_prints_as_jax(tmp_path, monkeypatch, capsys, clocks):
    """Both command lines over one spool: the listing, the stitched JSON,
    the waterfall, an unknown id."""
    monkeypatch.setenv("TPU_IR_TELEMETRY_DIR", str(tmp_path))
    ctx = port_dt.adopt(f"00-{TID}-{SID}-01")
    port_dt.set_service("worker-s1r1")
    with port_dt.use(ctx):
        _script(port_obs, clocks["port"])
    port_dt.add_span(TID, "rpc.search", span_id=SID, start_ms=1.0,
                     dur_ms=4.0, attrs={"outcome": "won", "hedge": True})
    port_dt._export_spool(TID)
    port_dt.reset()
    for argv in (["trace"], ["trace", TID, "--json"], ["trace", TID],
                 ["trace", "f" * 32]):
        rc_p = port_cli.main(argv)
        out_p = capsys.readouterr().out
        rc_j = jax_cli.main(argv)
        out_j = capsys.readouterr().out
        assert (rc_p, out_p) == (rc_j, out_j), argv
    assert port_cli.main(["trace"]) == 0
    assert json.loads(capsys.readouterr().out) == {"traces": [TID]}
    port_cli.main(["trace", TID])
    text = capsys.readouterr().out
    assert f"trace {TID}  spans=7" in text
    assert "[won+hedge]" in text and "worker-s1r1" in text


# -- trace.py: the ring, the hooks, record_span ------------------------------


def test_ring_and_to_dict_as_jax(clocks):
    got = {}
    for name, (o, dt, tr) in PACKAGES.items():
        tr.configure(sample=2, ring_capacity=2)
        for _ in range(5):
            _script(o, clocks[name])
        ring = o.recent_traces()
        got[name] = [s.to_dict() for s in ring]
        o.clear_traces()
        assert o.recent_traces() == []
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 2
    assert [c["name"] for c in got["port"][0]["children"]] == [
        "ladder", "admission_wait", "dispatch"]


def test_record_span_current_root_and_a_raising_hook(clocks):
    seen = []

    def bad_hook(span):
        seen.append(span.name)
        raise RuntimeError("a hook's fault")

    got = {}
    for name, (o, dt, tr) in PACKAGES.items():
        tr.add_root_hook(bad_hook)
        tr.add_root_hook(bad_hook)
        try:
            with o.trace("request") as r:
                with o.trace("dispatch"):
                    assert tr.current_root() is r
                    o.record_span("compile", 2_000_000, fn="topk")
            o.record_span("orphan", 1_000_000)
        finally:
            tr.remove_root_hook(bad_hook)
        assert tr.current_root() is None
        got[name] = [s.to_dict() for s in o.recent_traces()]
    assert seen == ["request", "orphan"] * 2
    assert got["port"] == got["jax"]
    compile_span = got["port"][0]["children"][0]["children"][0]
    assert compile_span["name"] == "compile"
    assert compile_span["dur_us"] == 2000.0


# -- the port alone: the coalescer, the frontend, the server -----------------


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    from tpu_ir_torch.index import build_index

    tmp = tmp_path_factory.mktemp("disttrace")
    body = []
    for i in range(80):
        text = "common " + " ".join(WORDS[(i + j) % len(WORDS)]
                                    for j in range(3 + i % 5))
        body.append(f"<DOC>\n<DOCNO> D-{i:04d} </DOCNO>\n<TEXT>\n"
                    f"{text}\n</TEXT>\n</DOC>\n")
    corpus = tmp / "corpus.trec"
    corpus.write_text("".join(body))
    out = str(tmp / "idx")
    build_index([str(corpus)], out, num_shards=1, compute_chargrams=False,
                device="cpu")
    return out


def test_coalesced_batch_reparents_under_every_member_trace(index_dir):
    """The shared dispatch appears once in every member's trace under one
    span id, parented under the member's own context, with its own
    batch.slot child (tests/test_disttrace.py's contract)."""
    from tpu_ir_torch.search import Scorer
    from tpu_ir_torch.serving import ServingConfig, ServingFrontend

    port_dt.configure(sample=1)
    scorer = Scorer.load(index_dir, layout="sparse", device="cpu")
    fe = ServingFrontend(scorer, ServingConfig(
        max_concurrency=8, max_queue=32, coalesce=True,
        batch_ladder=(1, 4, 16), batch_width=8))
    queries = ["common salmon", "salmon fishing river", "honey bears",
               "stock market investor"]
    n = 8
    barrier = threading.Barrier(n)
    ctxs, errors = [port_dt.mint() for _ in range(n)], []

    def client(ci):
        try:
            barrier.wait(10)
            with port_dt.use(ctxs[ci]):
                for i in range(6):
                    fe.search(queries[(ci + i) % len(queries)],
                              scoring="bm25")
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert fe.batcher.snapshot()["max_occupancy"] > 1
    members, slots = {}, {}
    for ctx in ctxs:
        for rec in port_dt.spans_for(ctx.trace_id):
            if rec["name"] == "batch.dispatch":
                members.setdefault(rec["span_id"], []).append(
                    (ctx.trace_id, rec))
                assert rec["parent_id"] == ctx.span_id
            elif rec["name"] == "batch.slot":
                slots.setdefault(ctx.trace_id, set()).add(rec["parent_id"])
                assert rec["attrs"]["queue_wait_ms"] >= 0
    assert any(len({t for t, _ in mem}) > 1 for mem in members.values())
    for sid, mem in members.items():
        assert len({rec["attrs"]["occupancy"] for _, rec in mem}) == 1
        assert len({rec["parent_id"] for _, rec in mem}) == len(mem)
        assert sum(rec["attrs"]["leader"] for _, rec in mem) <= 1
        for tid, rec in mem:
            assert sid in slots[tid] and rec["attrs"]["batch_id"] == sid
    # no member minted a trace of its own
    assert port_obs.get_registry().get("disttrace.minted") == n


def test_frontend_mints_at_its_edge_and_joins_an_adopted_trace(index_dir):
    from tpu_ir_torch.search import Scorer
    from tpu_ir_torch.serving import ServingFrontend

    fe = ServingFrontend(Scorer.load(index_dir, layout="sparse",
                                     device="cpu"))
    reg = port_obs.get_registry()
    res = fe.search("salmon fishing", scoring="bm25")
    assert res.trace_id is not None and res.trace_id in port_dt.trace_ids()
    assert reg.get("disttrace.minted") == 1
    assert reg.get("slo.good") + reg.get("slo.bad") == 1
    names = {r["name"] for r in port_dt.spans_for(res.trace_id)}
    assert {"request", "ladder", "admission_wait", "breaker", "dispatch",
            "kernel"} <= names
    ctx = port_dt.adopt(f"00-{TID}-{SID}-01")
    with port_dt.use(ctx):
        res = fe.search("honey bears", scoring="bm25")
    assert res.trace_id == TID
    assert reg.get("disttrace.minted") == 1           # no second trace
    assert reg.get("slo.good") + reg.get("slo.bad") == 1
    (root,) = [r for r in port_dt.spans_for(TID) if r["name"] == "request"]
    assert root["parent_id"] == SID
    port_dt.configure(enabled=False)
    assert fe.search("honey", scoring="bm25").trace_id is None


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10.0) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_rpc_adopts_and_piggybacks_and_the_trace_routes_answer():
    from tpu_ir_torch.obs.server import MetricsServer
    from tpu_ir_torch.serving.shardset import rpc_post

    port_dt.set_service("worker-s0r0")

    def handler(payload):
        with port_obs.trace("request") as r:
            r.set("k", payload.get("k"))
        return {"ok": True}

    ctx = port_dt.mint()
    attempt = port_dt.child(ctx)
    port_dt.slo_record("full", 1.0)
    with MetricsServer(rpc_handlers={"search": handler}) as srv:
        addr = f"{srv.host}:{srv.port}"
        out = rpc_post(addr, "search", {"k": 7}, 10.0,
                       headers={"traceparent": attempt.to_header()})
        assert out["ok"] is True
        (root,) = [r for r in out["_trace"] if r["name"] == "request"]
        assert root["trace_id"] == ctx.trace_id
        assert root["parent_id"] == attempt.span_id
        assert root["attrs"]["k"] == 7 and root["service"] == "worker-s0r0"
        bare = rpc_post(addr, "search", {"k": 1}, 10.0)
        assert "_trace" not in bare
        bad = rpc_post(addr, "search", {"k": 1}, 10.0,
                       headers={"traceparent": "garbage"})
        assert "_trace" not in bad
        code, body = _get(f"{srv.url}/slo")
        slo = json.loads(body)
        assert code == 200 and slo == port_dt.slo_snapshot()
        assert slo["good"] == 1
        code, body = _get(f"{srv.url}/slo?format=html")
        assert code == 200 and b"slo_p99_ms" in body
        code, body = _get(f"{srv.url}/trace")
        assert code == 200
        assert ctx.trace_id in json.loads(body)["traces"]
        code, body = _get(f"{srv.url}/trace/{ctx.trace_id}")
        st = json.loads(body)
        assert code == 200 and st["span_count"] == 1
        assert st == port_dt.stitch(ctx.trace_id)
        code, body = _get(f"{srv.url}/trace/{ctx.trace_id}?format=html")
        assert code == 200 and ctx.trace_id.encode() in body
        assert b"request" in body
        code, _ = _get(f"{srv.url}/trace/{'f' * 32}")
        assert code == 404
