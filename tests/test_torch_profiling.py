"""The port's device-cost profiler (tpu_ir_torch/obs/profiling.py) held
against `tpu_ir`'s (tests/test_profiling.py) on the CPU.

A cold call (a signature's first call in a process) stands in for a
compile: the same signature keys and renderings, the same ledger and
report shapes (plus the port's kernel-build ledger), one cold call a
signature, a new one for a changed static; the port's recompile is an
unwarmed coalesced dispatch, which feeds the same window and the same
`recompile_storm` record. Results are bitwise the same with the profiler
on and off. The dispatch tree of a CPU Scorer holds `dispatch.device`
beside `kernel`, as `tpu_ir`'s does; the host gauges are set, the card's
never read here (CUDA is not initialized)."""

import json
import os
import stat
import sys
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ir import obs as jax_obs
from tpu_ir.cli import main as jax_cli
from tpu_ir.obs import profiling as jprof
from tpu_ir.obs import registry as jax_registry
from tpu_ir.obs.profiling import profiled_jit
from tpu_ir.obs.server import MetricsServer as JaxMetricsServer
from tpu_ir.obs.server import health_snapshot as jax_health
from tpu_ir.search import Scorer as JaxScorer

from tpu_ir_torch import obs
from tpu_ir_torch.cli import main as port_cli
from tpu_ir_torch.index import build_index
from tpu_ir_torch.obs import profiling, recorder
from tpu_ir_torch.obs import registry as port_registry
from tpu_ir_torch.obs.profiling import profiled
from tpu_ir_torch.obs.server import MetricsServer, health_snapshot
from tpu_ir_torch.ops import _build, postings, scoring
from tpu_ir_torch.search import Scorer

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

STDLIB = os.path.join(ROOT, "data", "stdlib", "corpus.trec")


@pytest.fixture(autouse=True)
def _clean():
    for o in (obs, jax_obs):
        o.reset_all()
    yield
    profiling.configure(enabled=True, cost=True, recompile_limit=3)
    jprof.configure(enabled=True, cost=True, recompile_limit=3)
    for o in (obs, jax_obs):
        o.reset_all()


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("prof") / "idx")
    build_index(STDLIB, out, num_shards=2, device="cpu",
                compute_chargrams=False)
    return out


def _fn(report: dict, name: str) -> dict:
    return next(f for f in report["functions"] if f["name"] == name)


# -- signatures ---------------------------------------------------------------

SIG_CASES = {
    "array": ((((4, 8), "float32"),), {}),
    "statics": ((((3,), "int32"), 5, "x"), {"k": 10, "flag": True}),
    "sequence": (([((2,), "float32"), ((1, 2), "int32")],), {"n": None}),
    "bf16": ((((7, 3), "bfloat16"), 2.5), {}),
}


def _materialize(spec, port: bool):
    if isinstance(spec, tuple) and len(spec) == 2 \
            and isinstance(spec[0], tuple) and isinstance(spec[1], str):
        shape, dtype = spec
        if port:
            return torch.zeros(shape, dtype=getattr(torch, dtype))
        return jnp.zeros(shape, getattr(jnp, dtype))
    if isinstance(spec, list):
        return [_materialize(x, port) for x in spec]
    return spec


@pytest.mark.parametrize("case", sorted(SIG_CASES))
def test_signature_key_and_render_match_tpu_ir(case):
    """torch tensors key and render as `tpu_ir`'s arrays of the same
    shapes and dtypes do ('float32[4,8]', never 'torch.float32')."""
    args, kwargs = SIG_CASES[case]
    pa = tuple(_materialize(a, True) for a in args)
    ja = tuple(_materialize(a, False) for a in args)
    pk = profiling.signature_key(pa, kwargs)
    jk = jprof.signature_key(ja, kwargs)
    assert pk == jk
    assert profiling.render_signature(pk) == jprof.render_signature(jk)
    assert "torch." not in profiling.render_signature(pk)


def test_tier_table_keys_as_its_tensors():
    from tpu_ir_torch.ops.cold_tier import TierTable

    docs = [torch.zeros((3, 2), dtype=torch.int32),
            torch.zeros((1, 8), dtype=torch.int32)]
    table = TierTable(docs, [d.clone() for d in docs])
    key = profiling.signature_key((table,), {})
    assert profiling.render_signature(key) == \
        "(int32[3,2], int32[1,8], int32[3,2], int32[1,8])"


# -- cold calls ---------------------------------------------------------------


def test_one_cold_call_per_signature_as_tpu_ir():
    """Three shapes, three cold calls in each package; repeats add none."""
    pf = profiled(lambda x: x * 2.0, label="ladder_fn")
    jf = profiled_jit(lambda x: x * 2.0, label="ladder_fn")
    for n in (4, 8, 16, 8, 16):
        pf(torch.zeros(n))
        jf(np.zeros(n, np.float32))
    for mod, o in ((profiling, obs), (jprof, jax_obs)):
        reg = o.get_registry()
        assert reg.get("compile.count") == 3
        assert reg.get("compile.recompiles") == 0
        fn = _fn(mod.profile_report(), "ladder_fn")
        assert fn["compiles"] == 3 and len(fn["signatures"]) == 3
        assert all(s["compiles"] == 1 for s in fn["signatures"])
        assert reg.histogram("compile.time").state()[0] != [0] * 40
    port_sigs = {s["signature"] for s in _fn(profiling.profile_report(),
                                             "ladder_fn")["signatures"]}
    jax_sigs = {s["signature"] for s in _fn(jprof.profile_report(),
                                            "ladder_fn")["signatures"]}
    assert port_sigs == jax_sigs == {"float32[4]", "float32[8]",
                                     "float32[16]"}
    assert set(_fn(profiling.profile_report(), "ladder_fn")[
        "signatures"][0]) == set(_fn(jprof.profile_report(), "ladder_fn")[
            "signatures"][0])


def test_static_change_is_a_new_signature_as_tpu_ir():
    pf = profiled(lambda x, n: x * n, label="static_fn")
    jf = profiled_jit(lambda x, n: x * n, label="static_fn",
                      static_argnames=("n",))
    for n in (2, 3, 2):
        pf(torch.zeros(4), n=n)
        jf(np.zeros(4, np.float32), n=n)
    for mod in (profiling, jprof):
        fn = _fn(mod.profile_report(), "static_fn")
        assert fn["compiles"] == 2
        assert {s["signature"].split(", ")[-1]
                for s in fn["signatures"]} == {"n=2", "n=3"}


def test_nested_profiled_calls_are_the_outer_call():
    """build_postings_packed calls build_postings, which calls
    reduce_weighted_postings: one cold call, the outer label's, as a jit
    called under a jit is part of the outer program in tpu_ir."""
    t = torch.tensor([1, 1, 2, 0], dtype=torch.int32)
    out = postings.build_postings_packed(
        t, torch.tensor([1, 2], dtype=torch.int32),
        torch.tensor([2, 2], dtype=torch.int32), vocab_size=3, num_docs=2)
    assert int(out.num_pairs) == 3
    names = [f["name"] for f in profiling.profile_report()["functions"]]
    assert names == ["build_postings_packed"]
    assert obs.get_registry().get("compile.count") == 1


def test_cost_is_counted_from_shapes():
    """A dense signature counts chip_smoke.every_row_bytes and two
    operations a cell of a row; a tiered call's cold stage leaves both
    None, its hot stage alone reads the strip once."""
    b, l, v, d1 = 5, 2, 7, 11
    q = torch.zeros((b, l), dtype=torch.int32)
    matrix = torch.rand((v, d1))
    df = torch.ones(v, dtype=torch.int32)
    scoring.tfidf_topk_dense(q, matrix, df, d1 - 1, k=3)
    sig = _fn(profiling.profile_report(),
              "tfidf_topk_dense")["signatures"][0]
    assert sig["bytes_accessed"] == chip_smoke.every_row_bytes(b, l, d1, 4)
    assert sig["flops"] == 2 * b * l * d1
    strip = torch.rand((3, d1))
    args = (q, None, strip)
    assert scoring._tiered_cost(args, {}) is None
    assert scoring._tiered_cost(args, {"hot_only": True}) == {
        "flops": None, "bytes_accessed": float(3 * d1 * 4 + b * d1 * 4)}
    profiling.configure(cost=False)
    scoring.tfidf_topk_dense(torch.zeros((6, l), dtype=torch.int32), matrix,
                             df, d1 - 1, k=3)
    nocost = [s for s in _fn(profiling.profile_report(),
                             "tfidf_topk_dense")["signatures"]
              if s["signature"].startswith("int32[6,")]
    assert nocost[0]["bytes_accessed"] is None


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_profile_off_is_a_bitwise_passthrough(index_dir, layout):
    texts = ["heap queue", "sort list", "thread lock", "zzzzq"]
    results = {}
    for on in (True, False):
        obs.reset_all()
        profiling.configure(enabled=on)
        s = Scorer.load(index_dir, layout=layout, device="cpu")
        q = s.analyze_queries(texts)
        results[on] = [s.topk(q, k=5, scoring=sc) for sc in ("tfidf",
                                                              "bm25")]
        reg = obs.get_registry()
        if on:
            assert reg.get("compile.count") >= 2
        else:
            assert reg.get("compile.count") == 0
            assert profiling.profile_report()["functions"] == []
    for (s_on, d_on), (s_off, d_off) in zip(results[True], results[False]):
        assert s_on.tobytes() == s_off.tobytes()
        assert np.array_equal(d_on, d_off)


def test_build_inside_a_profiled_call_is_its_compile_span():
    """A library brought up inside a profiled call (ops/_build.py bills
    it through note_build) is that call's dispatch.compile span; inside a
    warm call it is a span of its own, cold=False."""
    pending = [0.25, 0.5]

    def body(x):
        _build._profiled_build(pending.pop(0))
        return x

    f = profiled(body, label="building_fn")
    for _ in range(2):
        with obs.trace("kernel"):
            f(torch.zeros(2))
    spans = [c for t in obs.recent_traces() for c in t.children
             if c.name == "dispatch.compile"]
    assert [s.attrs["cold"] for s in spans] == [True, False]
    assert spans[0].attrs["build_s"] == 0.25
    assert spans[1].dur_ns == int(0.5e9)
    assert obs.get_registry().get("compile.count") == 1
    assert obs.get_registry().histogram("compile.time").state()[1] >= 0.5


# -- recompiles: the unwarmed dispatches -------------------------------------


def test_unwarmed_storm_counts_window_and_writes_one_record(
        index_dir, tmp_path, monkeypatch):
    """Four coalesced dispatches of an unwarmed shape with the limit at 2:
    four recompiles in the window, one rate-limited recompile_storm record
    whose header carries the keys of tpu_ir's storm record."""
    monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(tmp_path / "port"))
    profiling.configure(recompile_limit=2)
    s = Scorer.load(index_dir, layout="sparse", device="cpu")
    q = s.analyze_queries(["heap queue"])
    for _ in range(4):
        s.topk_tagged(q, k=5, uniform=(1, 4))
    reg = obs.get_registry()
    assert reg.get("dispatch.unwarmed") == reg.get("compile.recompiles") \
        == profiling.recompiles_last_60s() == 4
    assert profiling.compile_cache_snapshot()["recompiles"] == 4
    port_recs = list((tmp_path / "port").glob("flight-*recompile_storm*"))
    assert len(port_recs) == 1
    # tpu_ir's storm: a fresh jit a call, one signature compiled again
    monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(tmp_path / "jax"))
    jprof.configure(recompile_limit=2)
    for _ in range(4):
        profiled_jit(lambda x: x + 1.0, label="storm_fn")(
            np.zeros(4, np.float32))
    jax_recs = list((tmp_path / "jax").glob("flight-*recompile_storm*"))
    assert len(jax_recs) == 1
    ph = json.loads(port_recs[0].read_text().splitlines()[0])
    jh = json.loads(jax_recs[0].read_text().splitlines()[0])
    assert set(ph) == set(jh)
    assert set(ph["extra"]) == set(jh["extra"])
    assert ph["extra"]["fn"] == "dispatch" and ph["extra"]["limit"] == 2
    assert ph["extra"]["signature"].startswith("int32[1,")
    assert set(ph["compile_cache"]) == set(jh["compile_cache"])
    assert ph["compile_cache"]["recompiles"] >= 3


def test_warm_repeats_keep_the_window_zero(index_dir):
    s = Scorer.load(index_dir, layout="sparse", device="cpu")
    q = s.analyze_queries(["heap queue", "sort list"])
    for _ in range(4):
        s.topk(q, k=5)
    assert profiling.recompiles_last_60s() == 0
    assert obs.get_registry().get("compile.recompiles") == 0
    assert health_snapshot()["recompiles_last_60s"] == 0 \
        == jax_health()["recompiles_last_60s"]


# -- the dispatch split and the gauges ---------------------------------------


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_dispatch_tree_holds_dispatch_device_as_tpu_ir(index_dir, layout):
    texts = ["heap queue", "sort list"]
    trees = {}
    for name, mod, o, scorer in (
            ("port", profiling, obs,
             Scorer.load(index_dir, layout=layout, device="cpu")),
            ("jax", jprof, jax_obs, JaxScorer.load(index_dir,
                                                   layout=layout))):
        q = scorer.analyze_queries(texts)
        o.clear_traces()
        scorer.topk(q, k=5, scoring="tfidf")
        disp = [t for t in o.recent_traces() if t.name == "dispatch"][-1]
        trees[name] = [c.name for c in disp.children]
        reg = o.get_registry()
        assert reg.get_gauge("host.rss_bytes") > 0
        assert reg.get_gauge("host.peak_rss_bytes") >= \
            reg.get_gauge("host.rss_bytes")
        assert mod.memory_snapshot()["device"] is None
    assert "dispatch.device" in trees["port"]
    assert "dispatch.device" in trees["jax"]
    assert "kernel" in trees["port"]
    # one wait a query block, beside the block's kernel span
    assert trees["port"].count("dispatch.device") == \
        trees["port"].count("kernel")
    assert not torch.cuda.is_initialized()


def test_memory_sampling_is_rate_limited_and_leaves_cuda_alone():
    reg = obs.get_registry()
    profiling.sample_memory(min_interval_s=0)
    rss = reg.get_gauge("host.rss_bytes")
    assert rss > 0 and reg.get_gauge("device.bytes_in_use") == 0.0
    reg.set_gauge("host.rss_bytes", 1.0)
    profiling.sample_memory()          # within 50 ms of the last: skipped
    assert reg.get_gauge("host.rss_bytes") == 1.0
    profiling.configure(enabled=False)
    profiling.sample_memory(min_interval_s=0)
    assert reg.get_gauge("host.rss_bytes") == 1.0
    assert not torch.cuda.is_initialized()


def test_gauge_declarations_and_policies_match_tpu_ir():
    assert port_registry.GAUGE_MERGE == jax_registry.GAUGE_MERGE
    assert set(port_registry.DECLARED_GAUGES) == \
        set(jax_registry.DECLARED_GAUGES)
    for name in ("compile.count", "compile.recompiles",
                 "decode.blocks_decoded", "decode.bytes_skipped",
                 "blockmax.blocks_masked", "blockmax.saved_dispatches"):
        assert name in port_registry.DECLARED_COUNTERS
        assert name in jax_registry.DECLARED_COUNTERS
    for name in ("compile.time", "dispatch.trace", "dispatch.compile",
                 "dispatch.device", "decode.block"):
        assert name in port_registry.DECLARED_HISTOGRAMS
        assert name in jax_registry.DECLARED_HISTOGRAMS
    regs = (port_registry.TelemetryRegistry(),
            jax_registry.TelemetryRegistry())
    for reg in regs:
        reg.update_gauge_max("device.peak_bytes", 500.0)
        reg.update_gauge_max("device.peak_bytes", 300.0)
        reg.set_gauge("custom.level", 7.0)
    snaps = [r.snapshot() for r in regs]
    assert snaps[0]["gauges"] == snaps[1]["gauges"]
    for reg in regs:
        reg.reset()
    assert regs[0].snapshot()["gauges"] == regs[1].snapshot()["gauges"]


# -- the report surfaces ------------------------------------------------------


def test_report_keys_equal_tpu_ir_plus_builds():
    profiled(lambda x: x, label="keys_fn")(torch.zeros(3))
    profiled_jit(lambda x: x, label="keys_fn")(np.zeros(3, np.float32))
    port, jax = profiling.profile_report(), jprof.profile_report()
    assert set(port) == set(jax) | {"builds"}
    for key in ("compile_counters", "pruning", "memory"):
        assert set(port[key]) == set(jax[key])
    assert set(port["dispatch"]) == set(jax["dispatch"])
    assert "note" in port["dispatch"]["dispatch.trace"]
    assert port["dispatch"]["dispatch.trace"]["count"] == 0
    assert set(_fn(port, "keys_fn")) == set(_fn(jax, "keys_fn"))
    assert isinstance(port["builds"], list)
    assert set(profiling.compile_cache_snapshot()) == \
        set(jprof.compile_cache_snapshot())


def test_profile_cli_matches_tpu_ir(capsys):
    profiled(lambda x: x - 1.0, label="cli_fn")(torch.zeros(4))
    profiled_jit(lambda x: x - 1.0, label="cli_fn")(np.zeros(4, np.float32))
    outs = {}
    for name, cli in (("port", port_cli), ("jax", jax_cli)):
        assert cli(["profile"]) == 0
        outs[name] = json.loads(capsys.readouterr().out)
    port, jax = outs["port"], outs["jax"]
    assert set(port) == set(jax) | {"builds"}
    assert port["enabled"] is True
    assert _fn(port, "cli_fn")["signatures"][0]["signature"] == \
        _fn(jax, "cli_fn")["signatures"][0]["signature"] == "float32[4]"
    assert "dispatch.device" in port["dispatch"]
    assert "compile.time" in port["dispatch"]


def test_profile_endpoint_and_healthz_window():
    profiled(lambda x: x * 5.0, label="http_fn")(torch.zeros(4))
    with MetricsServer(port=0) as srv, JaxMetricsServer(port=0) as jsrv:
        def get(server, route):
            with urllib.request.urlopen(server.url + route,
                                        timeout=10) as r:
                return json.loads(r.read())

        prof = get(srv, "/profile")
        assert any(f["name"] == "http_fn" for f in prof["functions"])
        assert prof["compile_counters"]["compile.count"] >= 1
        health, jhealth = get(srv, "/healthz"), get(jsrv, "/healthz")
        assert health["recompiles_last_60s"] == 0
        assert type(health["recompiles_last_60s"]) is \
            type(jhealth["recompiles_last_60s"]) is int
        assert "/profile" in get(srv, "/")["endpoints"]
        with urllib.request.urlopen(srv.url + "/profile?format=html",
                                    timeout=10) as r:
            page = r.read().decode()
        assert "http_fn" in page and "/doctor" in page


def test_flight_header_carries_memory_and_compile_cache():
    from tpu_ir.obs import recorder as jax_recorder

    profiled(lambda x: x, label="hdr_fn")(torch.zeros(2))
    ph = json.loads(recorder.artifact_lines("unit")[0])
    jh = json.loads(jax_recorder.artifact_lines("unit")[0])
    assert set(ph["memory"]) == set(jh["memory"]) == {"host_rss_bytes",
                                                      "device"}
    assert ph["memory"]["host_rss_bytes"] > 0
    assert ph["memory"]["device"] is None
    assert set(ph["compile_cache"]) == set(jh["compile_cache"])
    assert ph["compile_cache"]["compiles"] == 1


# -- the kernel-build ledger --------------------------------------------------

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z18dense_score_kernelILi4EEvPKiPKfS3_Pflll' for 'sm_90a'
ptxas info    : Function properties for _Z18dense_score_kernelILi4EEvPKiPKfS3_Pflll
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z15hot_stage_kernelPKiPKfS2_Pfll' for 'sm_90a'
ptxas info    : Function properties for _Z15hot_stage_kernelPKiPKfS2_Pfll
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, 8192 bytes smem, 392 bytes cmem[0]
"""
PTXAS_PARSED = [
    {"kernel": "dense_score_kernel<4>", "stack": 0, "spill_stores": 0,
     "spill_loads": 0, "registers": 40, "smem": 0},
    {"kernel": "hot_stage_kernel", "stack": 16, "spill_stores": 8,
     "spill_loads": 4, "registers": 255, "smem": 8192}]


def test_build_ledger_parses_a_captured_ptxas_log():
    assert _build.ptxas_report(PTXAS_LOG) == PTXAS_PARSED
    assert _build.ptxas_report("") == []


def test_build_ledger_records_built_and_reused(tmp_path, monkeypatch):
    """A stand-in nvcc (it writes the output file and prints the captured
    log): the first build enters the ledger as built with its seconds and
    ptxas's report; the next finds the library and reuses it, its report
    read back from the log kept beside it."""
    fake = tmp_path / "nvcc"
    log = tmp_path / "ptxas.txt"
    log.write_text(PTXAS_LOG)
    fake.write_text("#!/bin/sh\nout=\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then out=$2; fi; shift\ndone\n"
                    f"cat {log}\n: > \"$out\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_ledger", {})
    name = "hot_stage"
    assert _build.build([name]) == {name: PTXAS_LOG}
    first = _build.build_ledger()
    assert len(first) == 1 and first[0]["built"] is True
    assert first[0]["source"] == f"tpu_ir_torch/csrc/{name}.cu"
    assert first[0]["library"] == _build.lib_path(name).name
    assert first[0]["compile_s"] > 0 and first[0]["ptxas"] == PTXAS_PARSED
    assert _build.build([name]) == {}       # this process built it
    assert _build.build_ledger() == first
    monkeypatch.setattr(_build, "_ledger", {})
    assert _build.build([name]) == {}       # another process built it
    again = _build.build_ledger()[0]
    assert again["built"] is False and again["compile_s"] == 0.0
    assert again["ptxas"] == PTXAS_PARSED
    chip_smoke.check_build_ledger(
        [dict(again, load_s=0.01)], [name])
    with pytest.raises(AssertionError):
        chip_smoke.check_build_ledger([again], [name])  # never loaded
