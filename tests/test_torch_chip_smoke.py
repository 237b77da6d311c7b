"""chip_smoke.py's contract off the card: without CUDA, or outside the
repository, it exits nonzero and prints no result; its build and serve
phases run end to end on the CPU at a small size (the kernel phase needs
the card)."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import tpu_ir_torch  # noqa: E402


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(ROOT)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_refuses_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path))
    assert r.returncode != 0
    assert r.stdout == ""


def test_build_and_serve_phases_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "REF_CORPUS", dict(
        n_docs=200, target_bytes=200_000, vocab_size=2_000))
    monkeypatch.setattr(chip_smoke, "REF_QUERIES", 300)
    monkeypatch.setattr(chip_smoke, "ORACLE_QUERIES", 32)
    build, idx = chip_smoke.phase_build("cpu", str(tmp_path), device="cpu")
    assert build["num_docs"] == 200 and build["num_shards"] == 10
    assert build["part_bytes"] > 0 and build["num_pairs"] > 0
    assert build["analyze_alone_s"] > 0
    serve, _, q_ids, dense = chip_smoke.phase_serve("cpu", idx,
                                                    device="cpu")
    assert serve["recall_at_10"] == 1.0
    assert serve["oracle_max_rel_err"] <= chip_smoke.ORACLE_RTOL
    assert set(serve["oracle"]) == {"tfidf", "bm25"}
    assert serve["layout"] == "dense"
    # CPU: the plain twins, no launch
    assert serve["launches"] == {"dense_score": 0, "dequant_score": 0,
                                 "cold_tier": 0,
                                 "hot_stage": 0}
    json.dumps(serve)
    check = chip_smoke.phase_sparse_check("cpu", idx, q_ids, dense,
                                          device="cpu")
    assert check["tfidf"]["rows_with_other_ids"] == 0
    assert check["bm25"]["max_rel_diff"] <= chip_smoke.ORACLE_RTOL
    assert check["launches"] == {"dense_score": 0, "dequant_score": 0,
                                 "cold_tier": 0,
                                 "hot_stage": 0}
    json.dumps(check)


def test_build_streaming_and_crash_resume_phases_on_cpu(tmp_path,
                                                        monkeypatch):
    """The ref build with both analysis timings, the crash-resume check
    against it, and the three-way wiki100k build (radix, legacy,
    one-shot) whose shared artifacts have one sha256."""
    small = dict(n_docs=200, target_bytes=200_000, vocab_size=2_000)
    monkeypatch.setattr(chip_smoke, "REF_CORPUS", small)
    monkeypatch.setattr(chip_smoke, "WIKI_CORPUS", dict(
        n_docs=300, target_bytes=300_000, vocab_size=3_000))
    work = str(tmp_path)
    build, idx = chip_smoke.phase_build("cpu", work, device="cpu")
    assert build["analyze_alone_s"] > 0 and build["native_analyze_alone_s"] > 0
    assert build["chargram_ks"] == [2, 3]
    assert set(build["timings_s"]) >= {"tokenize", "postings_device",
                                       "chargrams", "write_shards"}
    resume = chip_smoke.phase_crash_resume("cpu", idx, work, device="cpu")
    assert resume["tokenized_again"] is False
    assert resume["pair_spills_at_crash"] == 3 * 10   # buckets 0-2
    assert resume["pass2_resumed_buckets"] == 3
    assert resume["identical_to_oneshot"] == len(os.listdir(idx)) - 1
    out, ridx = chip_smoke.phase_build_streaming("cpu", work, device="cpu")
    assert set(out["builds"]) == {"radix", "legacy", "oneshot"}
    radix = out["builds"]["radix"]
    assert radix["job"]["state"] == "succeeded"
    assert [p["phase"] for p in radix["job"]["phases"]] == [
        "pass1_tokenize", "pass2_combine", "pass3_reduce", "finalize"]
    assert radix["radix_spill_bytes"] > 0 and radix["peak_host_rss_bytes"] > 0
    assert out["builds"]["legacy"]["radix_spill_bytes"] == 0
    assert {"pass1_tokenize", "pass2_combine", "pass3_reduce", "docstore",
            "chargrams"} <= set(radix["timings_s"])
    assert out["verify"]["ok"] and out["identical_artifacts"] >= 10
    assert sorted(os.listdir(work)) == ["ref-idx", "wiki100k-radix"]
    assert ridx == os.path.join(work, "wiki100k-radix")
    json.dumps(out)


def test_build_streaming_takes_the_corpus_a_child_made(tmp_path,
                                                      monkeypatch):
    """The wiki100k corpus may be written beside the ref phases
    (make_wiki_corpus in a child): phase_build_streaming then waits for
    it, reports the child's seconds, and builds from its bytes, the same
    as the corpus it would write itself."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu_ir_torch.corpus import make_corpus

    monkeypatch.setattr(chip_smoke, "WIKI_CORPUS", dict(
        n_docs=120, target_bytes=120_000, vocab_size=1_500))
    work = str(tmp_path / "work")
    os.makedirs(work)
    with ThreadPoolExecutor(1) as ex:
        made = ex.submit(chip_smoke.make_wiki_corpus,
                         os.path.join(work, "wiki100k.trec"))
        out, ridx = chip_smoke.phase_build_streaming(
            "cpu", work, device="cpu", keep_corpus=True, corpus_made=made)
    n_bytes, gen_s = made.result()
    assert out["corpus_bytes"] == n_bytes and out["corpus_gen_s"] == gen_s
    assert out["corpus_wait_s"] >= 0 and out["verify"]["ok"]
    assert out["builds"]["radix"]["num_docs"] == 120
    own = str(tmp_path / "own.trec")
    make_corpus(own, seed=0, **chip_smoke.WIKI_CORPUS)
    with open(own, "rb") as f, open(os.path.join(work, "wiki100k.trec"),
                                     "rb") as g:
        assert f.read() == g.read()


def test_alone_child_reports_its_failure_and_stops():
    """AloneChild: a child that cannot load its index on the card sends
    its traceback, results() raises with it, and stop() leaves no child
    process."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import numpy as np

    block = np.zeros((2, 2), np.int32)
    child = chip_smoke.AloneChild("/nonexistent-index", block, block)
    try:
        with pytest.raises(AssertionError, match="alone child"):
            child.results()
    finally:
        child.stop()
    assert not child._proc.is_alive()


def test_wiki100k_phases_on_cpu(tmp_path, monkeypatch):
    from tpu_ir_torch.search import scorer as scorer_mod

    monkeypatch.setattr(chip_smoke, "WIKI_CORPUS", dict(
        n_docs=300, target_bytes=300_000, vocab_size=3_000))
    monkeypatch.setattr(chip_smoke, "REF_QUERIES", 300)
    monkeypatch.setattr(chip_smoke, "ORACLE_QUERIES", 32)
    # at this size only a smaller budget sends "auto" to the tiered layout
    monkeypatch.setattr(scorer_mod, "DENSE_BUDGET", 10_000)
    build, idx = chip_smoke.phase_build("cpu", str(tmp_path), device="cpu",
                                        config="wiki100k")
    assert build["num_docs"] == 300 and "analyze_alone_s" not in build
    assert not os.path.exists(os.path.join(str(tmp_path), "wiki100k.trec"))
    serve, scorer, _, _ = chip_smoke.phase_serve(
        "cpu", idx, device="cpu", config="wiki100k")
    assert serve["layout"] == "sparse" and scorer.layout == "sparse"
    assert serve["launches"] == {"dense_score": 0, "dequant_score": 0,
                                 "cold_tier": 0,
                                 "hot_stage": 0}
    assert serve["recall_at_10"] == 1.0
    assert serve["oracle_max_rel_err"] <= chip_smoke.ORACLE_RTOL
    tiers = serve["tiers"]
    assert tiers["hot_rows"] > 1 and len(tiers["caps_rows"]) >= 3
    assert tiers["weighted_strip_cached"] == ["bm25", "tfidf"]
    json.dumps(serve)


def test_compress_and_v3_serve_phases_on_cpu(tmp_path, monkeypatch):
    """The compress phase and the v3 serve on both layouts: a bf16 raw-tf
    matrix (ref-v3) and a bf16 hot strip (wiki100k-v3), each bitwise equal
    to its raw index's serve."""
    import torch

    from tpu_ir_torch.search import scorer as scorer_mod

    small = dict(n_docs=200, target_bytes=200_000, vocab_size=2_000)
    monkeypatch.setattr(chip_smoke, "REF_CORPUS", small)
    monkeypatch.setattr(chip_smoke, "WIKI_CORPUS", small)
    monkeypatch.setattr(chip_smoke, "REF_QUERIES", 200)
    monkeypatch.setattr(chip_smoke, "ORACLE_QUERIES", 16)
    work = str(tmp_path)
    _, idx = chip_smoke.phase_build("cpu", work, device="cpu")
    _, _, _, raw = chip_smoke.phase_serve("cpu", idx, device="cpu")
    comp, v3 = chip_smoke.phase_compress("cpu", idx, work, config="ref")
    assert comp["tf_dtype"] == "int8" and not comp["tf_lossy"]
    # (at this size the arenas' 4 KB section alignment outweighs the codec)
    assert comp["migrated"] == 10
    assert comp["part_bytes_before"] == chip_smoke.part_bytes(idx)
    assert comp["part_bytes_after"] == chip_smoke.part_bytes(v3)
    serve, scorer = chip_smoke.phase_serve_v3("cpu", v3, raw, device="cpu",
                                              config="ref-v3")
    assert serve["layout"] == "dense" and serve["tf_dtype"] == str(
        torch.bfloat16)
    assert serve["matrix_bytes"] == scorer._tf_matrix.numel() * 2
    assert serve["bitwise_equal_to_raw"] == {"tfidf": True, "bm25": True}
    assert serve["recall_at_10"] == 1.0
    json.dumps(comp), json.dumps(serve)

    monkeypatch.setattr(scorer_mod, "DENSE_BUDGET", 10_000)
    _, widx = chip_smoke.phase_build("cpu", work, device="cpu",
                                     config="wiki100k")
    _, _, _, wraw = chip_smoke.phase_serve("cpu", widx, device="cpu",
                                           config="wiki100k")
    # run_phases compresses the wiki100k copy in a spawned child
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as side:
        wcomp, wv3 = side.submit(chip_smoke.phase_compress, "cpu", widx,
                                 work, config="wiki100k").result()
    assert wcomp["config"] == "wiki100k" and wcomp["migrated"] == 10
    assert wcomp["part_bytes_after"] == chip_smoke.part_bytes(wv3)
    wserve, scorer = chip_smoke.phase_serve_v3(
        "cpu", wv3, wraw, device="cpu", config="wiki100k-v3")
    assert wserve["layout"] == "sparse"
    assert scorer.hot_tfs.dtype == torch.bfloat16
    assert wserve["tiers"]["strip_bytes"] == scorer.hot_tfs.numel() * 2
    assert wserve["bitwise_equal_to_raw"] == {"tfidf": True, "bm25": True}
    # a v3 serve that differs from the raw one fails the phase
    wraw["bm25"][0][0, 0] += 1.0
    with pytest.raises(AssertionError, match="differs from the raw"):
        chip_smoke.phase_serve_v3("cpu", wv3, wraw, device="cpu",
                                  config="wiki100k-v3")


def test_serve_phase_refuses_the_wrong_layout(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "WIKI_CORPUS", dict(
        n_docs=60, target_bytes=60_000, vocab_size=600))
    _, idx = chip_smoke.phase_build("cpu", str(tmp_path), device="cpu",
                                    config="wiki100k")
    with pytest.raises(AssertionError, match="expected 'sparse'"):
        chip_smoke.phase_serve("cpu", idx, device="cpu", config="wiki100k")


def test_same_ranking_allows_ties_only():
    import numpy as np

    ws = np.array([[3.0, 2.0, 2.0, 1.0]], np.float32)
    wd = np.array([[4, 5, 6, 7]], np.int32)
    assert chip_smoke.same_ranking((ws, wd), (ws, wd[:, [0, 2, 1, 3]])) \
        == (0.0, 0)
    assert chip_smoke.same_ranking((ws, wd), (ws, wd[:, [1, 0, 2, 3]]))[1] \
        == 1
    rel, _ = chip_smoke.same_ranking((ws, wd), (ws * 1.001, wd))
    assert rel == pytest.approx(1e-3, rel=1e-3)


def test_oracle_topk_orders_ties_by_docno():
    import numpy as np

    df = np.array([2, 1], np.int32)
    pair_doc = np.array([3, 1, 2], np.int32)
    pair_tf = np.array([1, 1, 1], np.int32)
    top, scores = chip_smoke.oracle_topk(np.array([0, -1], np.int32), df,
                                         pair_doc, pair_tf, num_docs=4, k=10)
    assert top == [1, 3] and scores[1] == scores[3] > 0


def test_oracle_bm25_matches_the_formula():
    import numpy as np

    df = np.array([2, 1], np.int32)
    pair_doc = np.array([1, 2, 2], np.int32)
    pair_tf = np.array([3, 1, 2], np.int32)
    doc_len = np.array([0, 3, 5], np.int32)
    top, scores = chip_smoke.oracle_topk(
        np.array([0, 1], np.int32), df, pair_doc, pair_tf, num_docs=2,
        k=10, scoring="bm25", doc_len=doc_len)
    k1, b, n, avg = 0.9, 0.4, 2, 4.0

    def w(tf, dfv, dl):
        idf = np.log(1 + (n - dfv + 0.5) / (dfv + 0.5))
        return idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avg))

    assert scores[1] == pytest.approx(w(3, 2, 3), rel=1e-6)
    assert scores[2] == pytest.approx(w(1, 2, 5) + w(2, 1, 5), rel=1e-6)
    assert top == sorted([1, 2], key=lambda d: -scores[d])


def test_prune_and_rerank_phases_on_cpu(tmp_path, monkeypatch):
    """The prune phase (on == off bitwise, the oracle's recall) on uniform
    and hot-term traffic, whole and in small batches, and the rerank phase
    on the dense and the tiered layout, at a small size on the CPU."""
    from tpu_ir_torch.search import Scorer
    from tpu_ir_torch.search import scorer as scorer_mod

    monkeypatch.setattr(chip_smoke, "WIKI_CORPUS", dict(
        n_docs=300, target_bytes=300_000, vocab_size=3_000))
    monkeypatch.setattr(chip_smoke, "REF_QUERIES", 300)
    monkeypatch.setattr(chip_smoke, "ORACLE_QUERIES", 32)
    monkeypatch.setattr(scorer_mod, "DENSE_BUDGET", 10_000)
    _, idx = chip_smoke.phase_build("cpu", str(tmp_path), device="cpu",
                                    config="wiki100k")
    serve, scorer, q_ids, _ = chip_smoke.phase_serve(
        "cpu", idx, device="cpu", config="wiki100k")
    assert serve["prune_diag"] == scorer.prune_diag(q_ids)
    assert set(serve["blockmax_per_topk"]) == {"tfidf", "bm25"}
    uniform = chip_smoke.phase_prune("cpu", scorer, idx, q_ids,
                                     traffic="uniform", device="cpu")
    assert uniform["bitwise_on_equals_off"] == {"tfidf": True, "bm25": True}
    assert uniform["recall_at_10"] == 1.0
    assert uniform["off"]["prune_diag"] == {"prune_applicable": False}
    assert scorer.prune
    hot_q = chip_smoke.hot_traffic(scorer, 200)
    assert (scorer._hot_rank_host[hot_q[:, 0]] >= 0).all()
    assert (scorer._hot_rank_host[hot_q[:, 1]] < 0).all()
    hot = chip_smoke.phase_prune("cpu", scorer, idx, hot_q, traffic="hot",
                                 device="cpu")
    assert hot["on"]["prune_diag"]["prune_hot_free_query_fraction"] == 0.0
    small = chip_smoke.phase_prune("cpu", scorer, idx, hot_q[:70],
                                   traffic="hot", device="cpu", batch=16)
    assert small["batch"] == 16 and "recall_at_10" not in small
    json.dumps([serve, uniform, hot, small])

    dense = Scorer.load(idx, layout="dense", device="cpu")
    rr, want = chip_smoke.phase_rerank("cpu", dense, q_ids, config="x",
                                       device="cpu", candidates=50)
    assert rr["layout"] == "dense" and rr["qps"] > 0
    rt, _ = chip_smoke.phase_rerank("cpu", scorer, q_ids, config="y",
                                    device="cpu", want=want, candidates=50)
    assert rt["rows_with_other_ids"] == 0
    with pytest.raises(AssertionError, match="bitwise"):
        chip_smoke.phase_rerank("cpu", scorer, q_ids, config="z",
                                device="cpu", want=(want[0] + 1, want[1]),
                                bitwise=True, candidates=50)
    json.dumps([rr, rt])


def test_hot_stage_inputs_and_bound_on_cpu(tmp_path, monkeypatch):
    """hot_inputs and hot_bound on a small tiered index: every query of
    hot-term traffic holds one hot slot; the bound counts the distinct
    rows, the active score rows and the slots."""
    from tpu_ir_torch.ops import hot_stage
    from tpu_ir_torch.search import Scorer

    monkeypatch.setattr(chip_smoke, "WIKI_CORPUS", dict(
        n_docs=200, target_bytes=200_000, vocab_size=2_000))
    _, idx = chip_smoke.phase_build("cpu", str(tmp_path), device="cpu",
                                    config="wiki100k")
    scorer = Scorer.load(idx, layout="sparse", device="cpu")
    q = chip_smoke.hot_traffic(scorer, 40)
    base, rows, w, strip = chip_smoke.hot_inputs(scorer, q)
    assert base.shape == (40, 201) and strip.shape[1] == 201
    assert ((rows >= 0).sum(dim=1) == 1).all()
    got = base.clone()
    hot_stage.hot_stage(got, rows, w, strip)
    want = scorer.topk(q, k=5)
    assert want[1].any()
    bound = chip_smoke.hot_bound(rows, strip, 201)
    n_rows = len(set(rows[rows >= 0].tolist()))
    assert bound["distinct_rows"] == n_rows and bound["active_queries"] == 40
    assert bound["bound_bytes"] == n_rows * 201 * 4 + 40 * 201 * 8 + 40 * 2 * 8
    assert bound["bound_by"] == "bytes"


def test_serving_phases_on_cpu(tmp_path, monkeypatch):
    """The serving phases (frontend, soak, sweep) end to end at a small
    size on the CPU, on the dense and the tiered layout: coalesced ==
    solo bitwise, hot_only == its plain twin, the clean and the chaos
    soak's invariants, the sweep's rows with nothing unwarmed."""
    from tpu_ir_torch import obs
    from tpu_ir_torch.search import Scorer

    obs.reset_all()
    monkeypatch.setattr(chip_smoke, "WIKI_CORPUS", dict(
        n_docs=200, target_bytes=200_000, vocab_size=2_000))
    monkeypatch.setattr(chip_smoke, "SOAK_THREADS", 4)
    monkeypatch.setattr(chip_smoke, "SOAK_QUERIES", 64)
    monkeypatch.setattr(chip_smoke, "SWEEP_LEVELS", (1, 4))
    monkeypatch.setattr(chip_smoke, "SWEEP_QUERIES", 16)
    monkeypatch.setattr(chip_smoke, "SWEEP_REPEATS", 2)
    monkeypatch.setattr(chip_smoke, "BREAKER_PROBES", 3)
    monkeypatch.setattr(chip_smoke, "QUERYLOG_PASS_TEXTS", 24)
    monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(tmp_path / "flight"))
    _, idx = chip_smoke.phase_build("cpu", str(tmp_path), device="cpu",
                                    config="wiki100k")
    tiered = Scorer.load(idx, layout="sparse", device="cpu")
    dense = Scorer.load(idx, layout="dense", device="cpu")
    fr = chip_smoke.phase_frontend("cpu", tiered, config="wiki100k",
                                   device="cpu")
    assert set(fr["coalesced_equals_solo"]) == {
        "tfidf", "bm25", "rerank", "hot_only_tfidf", "hot_only_bm25",
        "prune_off_tfidf", "prune_off_bm25"}
    assert fr["hot_only"]["bitwise_equal_to_plain"] and tiered.prune
    fd = chip_smoke.phase_frontend("cpu", dense, config="ref",
                                   device="cpu")
    assert "hot_only" not in fd and set(fd["coalesced_equals_solo"]) == {
        "tfidf", "bm25", "rerank"}
    soak = chip_smoke.phase_soak("cpu", tiered, config="wiki100k",
                                 device="cpu")
    assert soak["clean"]["degraded"] == 0
    assert soak["clean"]["served"] + soak["clean"]["shed"] == 64
    assert soak["chaos"]["degraded"] > 0
    assert soak["chaos"]["batch_mixed_degraded"] == 0
    assert soak["chaos"]["batches_observed"] > 0
    sweep = chip_smoke.phase_sweep("cpu", dense, config="ref", device="cpu")
    cost = sweep["querylog_cost"]
    assert [len(cost["walls_s"][a]) for a in ("on", "off")] == [3, 3]
    assert cost["entries"] == 24 and cost["ring_capacity"] == 256
    samp = sweep["sampler_cost"]
    assert [len(samp["walls_s"][a]) for a in ("on", "off")] == [3, 3]
    assert samp["interval_s"] == chip_smoke.SAMPLER_COST_INTERVAL_S
    assert samp["sample_us"] > 0 and samp["concurrency"] == 4
    assert set(samp["spread_share"]) == {"on", "off"}
    assert sweep["breaker_flight_record"]["reason"] == "breaker_open"
    assert sweep["breaker_flight_record"]["trace_lines"] >= 1
    from tpu_ir_torch.serving import ServingConfig, ServingFrontend

    fe = ServingFrontend(tiered, ServingConfig(coalesce=True))
    chip_smoke.closed_loop(fe, ["salmon"] * 8 + [""] * 8, 4, scoring="bm25",
                           k=10)
    assert fe.stats()["served_full"] == 16
    for scoring in ("bm25", "tfidf"):
        runs = sweep[scoring]["repeats"]
        assert len(runs) == 2
        for run in runs:
            assert [lv["concurrency"] for lv in run["levels"]] == [1, 4]
            assert all(lv["unwarmed"] == 0 for lv in run["levels"])
        for row in sweep[scoring]["spread"]:
            q = row["qps"]
            assert 0 < q["min"] <= q["median"] <= q["max"]
    assert sweep["deadline_expiry_ms"] >= 200.0
    assert sweep["breaker_open_ms"] < sweep["deadline_expiry_ms"]
    json.dumps([fr, fd, soak, sweep])
    obs.reset_all()


def test_querylog_phase_on_cpu(tmp_path, monkeypatch):
    """The querylog phase at a small size on the CPU: the batch's log
    on/off passes, and the slow-query trap on both layouts and both
    paths (the kernels' launches are the card's to check)."""
    from tpu_ir_torch import obs
    from tpu_ir_torch.search import Scorer

    obs.reset_all()
    monkeypatch.setattr(chip_smoke, "WIKI_CORPUS", dict(
        n_docs=200, target_bytes=200_000, vocab_size=2_000))
    monkeypatch.setattr(chip_smoke, "QUERYLOG_BATCH", 300)
    monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(tmp_path / "flight"))
    _, idx = chip_smoke.phase_build("cpu", str(tmp_path), device="cpu",
                                    config="wiki100k")
    serving = {"ref": Scorer.load(idx, layout="dense", device="cpu"),
               "wiki100k": Scorer.load(idx, layout="sparse", device="cpu")}
    out = chip_smoke.phase_querylog("cpu", serving, device="cpu")
    cost = out["batch_cost"]
    assert cost["entries"] == 300 and cost["config"] == "wiki100k"
    assert set(out["trap"]) == {"ref/frontend", "ref/search_batch",
                                "wiki100k/frontend",
                                "wiki100k/search_batch"}
    for name, row in out["trap"].items():
        assert row["contribution_sum"] == row["top_score"]
        assert row["record"]["trace_lines"] >= 1
        assert row["span_tree_source"] == (
            None if name.endswith("frontend") else "ring")
        assert (row["trace_id"] is not None) == name.endswith("frontend")
        assert row["rate_limited"]["captures"] == row["texts"]
    assert out["trap"]["ref/search_batch"]["texts"] == \
        chip_smoke.SLOW_PROBE_TEXTS
    assert out["slow_capture"]["count"] == 2 * sum(
        r["texts"] for r in out["trap"].values())
    assert obs.querylog.slow_query_ms() == 0.0 and obs.querylog.enabled()
    json.dumps(out)
    obs.reset_all()


def _capture(score=1.5, parts=(1.0, 0.5), source=None, kernel=True):
    tree = {"name": "request", "children": [
        {"name": "dispatch",
         "children": [{"name": "kernel"}] if kernel else []}]}
    cap = {"span_tree": tree, "explain": [
        {"score": score, "contribution_sum": sum(parts)}]}
    if source:
        cap["span_tree_source"] = source
    return cap


def test_check_slow_capture_holds_the_explain_to_the_score():
    e = chip_smoke.check_slow_capture(_capture(), 1.5, source=None)
    assert e["contribution_sum"] == 1.5
    chip_smoke.check_slow_capture(_capture(source="ring"), 1.5,
                                  source="ring")
    for cap, score, source in (
            (_capture(parts=(1.0, 0.25)), 1.5, None),    # sum != score
            (_capture(), 1.25, None),                    # != the result
            (_capture(score=1.5 + 1e-9, parts=(1.0, 0.5 + 1e-9)), 1.5,
             None),                                      # float32 bits
            (_capture(kernel=False), 1.5, None),         # no kernel span
            (_capture(), 1.5, "ring"),                   # the wrong source
            ({**_capture(), "explain": None}, 1.5, None)):
        with pytest.raises(AssertionError):
            chip_smoke.check_slow_capture(cap, score, source=source)


def _artifact(path, records):
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(path)


def test_read_flight_artifact_needs_its_lines(tmp_path):
    head = {"record": "header", "reason": "breaker_open", "seq": 3}
    trace = {"record": "trace", "trace": {"name": "request"}}
    tele = {"record": "telemetry", "telemetry": {}}
    ok = _artifact(tmp_path / "ok.jsonl", [head, trace, trace, tele])
    assert chip_smoke.read_flight_artifact(ok, "breaker_open")[
        "trace_lines"] == 2
    for name, records, reason in (
            ("no_telemetry", [head, trace], "breaker_open"),
            ("two_telemetry", [head, trace, tele, tele], "breaker_open"),
            ("no_trace", [head, tele], "breaker_open"),
            ("telemetry_first", [head, tele, trace], "breaker_open"),
            ("no_header", [trace, tele], "breaker_open"),
            ("other_reason", [head, trace, tele], "slow_query")):
        path = _artifact(tmp_path / f"{name}.jsonl", records)
        with pytest.raises(AssertionError):
            chip_smoke.read_flight_artifact(path, reason)


def test_percent_series_and_finished_job_checks():
    chip_smoke.check_percent_series([0.0, 12.5, 12.5, 60.0, 100.0])
    chip_smoke.check_percent_series([])
    with pytest.raises(AssertionError, match="fell"):
        chip_smoke.check_percent_series([0.0, 40.0, 39.99, 100.0])
    phases = ("pass1_tokenize", "pass2_combine", "pass3_reduce", "finalize")
    job = {"state": "succeeded", "percent": 100.0,
           "current_phase": "finalize", "phases": [
               {"phase": "pass1_tokenize", "done": 2, "total": None},
               {"phase": "pass2_combine", "done": 16, "total": 16},
               {"phase": "pass3_reduce", "done": 10, "total": 10},
               {"phase": "finalize", "done": 0, "total": None}]}
    chip_smoke.check_job_done(job, phases)
    for bad in ({"state": "failed"}, {"percent": 99.0},
                {"current_phase": "pass3_reduce"},
                {"phases": [dict(p, done=9) if p["phase"] == "pass3_reduce"
                            else p for p in job["phases"]]},
                {"phases": [dict(p, done=0) if p["phase"] == "pass1_tokenize"
                            else p for p in job["phases"]]}):
        with pytest.raises(AssertionError):
            chip_smoke.check_job_done({**job, **bad}, phases)


def test_wildcard_and_kgram_phases_on_cpu(tmp_path, monkeypatch):
    """The wildcard phase's three mixes on a small tiered index with
    char-grams (the oracles, prune on == off, recall@10 = 1.0, rows at
    least 64 wide for the glob mix) and the kgram phase (one-shot and
    streaming k = 2 builds equal, the composed globs answered), at a
    small size on the CPU; the oracles themselves against brute force."""
    import fnmatch

    import numpy as np

    from tpu_ir_torch.search import Scorer
    from tpu_ir_torch.search import scorer as scorer_mod
    from tpu_ir_torch.search.wildcard import _levenshtein_capped

    monkeypatch.setattr(chip_smoke, "WIKI_CORPUS", dict(
        n_docs=300, target_bytes=300_000, vocab_size=3_000))
    monkeypatch.setattr(chip_smoke, "REF_CORPUS", dict(
        n_docs=200, target_bytes=200_000, vocab_size=2_000))
    monkeypatch.setattr(chip_smoke, "ORACLE_QUERIES", 16)
    monkeypatch.setattr(chip_smoke, "WILDCARD_QUERIES", 120)
    monkeypatch.setattr(chip_smoke, "EXPANSION_SAMPLE", 40)
    monkeypatch.setattr(chip_smoke, "KGRAM_QUERIES", 100)
    monkeypatch.setattr(chip_smoke, "KGRAM_GLOBS", 40)
    monkeypatch.setattr(chip_smoke, "KGRAM_PROCS", 1)
    monkeypatch.setattr(scorer_mod, "DENSE_BUDGET", 10_000)
    _, idx = chip_smoke.phase_build("cpu", str(tmp_path), device="cpu",
                                    config="wiki100k")
    scorer = Scorer.load(idx, device="cpu")
    assert scorer.layout == "sparse"
    terms = scorer.vocab.terms
    by_len = chip_smoke.terms_by_length(terms)
    joined = "\n".join(terms)
    for pat in ("ab*", "a?c*", "*ing", "q*z"):
        assert chip_smoke.glob_oracle(joined, pat) == [
            t for t in terms if fnmatch.fnmatchcase(t, pat)]
    for word in ("abcd", terms[17], chip_smoke.one_edit(
            np.random.default_rng(0), terms[40])):
        want = sorted(((t, d) for t in terms
                       if (d := _levenshtein_capped(word, t, 1)) is not None),
                      key=lambda td: (td[1], td[0]))
        assert chip_smoke.fuzzy_oracle(by_len, word, 1) == want
    rows = list(chip_smoke.phase_wildcard("cpu", scorer, idx, device="cpu"))
    assert [r["mix"] for r in rows] == ["glob", "fuzzy", "question"]
    assert rows[0]["rows"]["width"] >= 64
    assert rows[2]["examples"][:3] == list(chip_smoke.QUEUE3_QUESTIONS)
    for r in rows:
        assert r["oracle_expansions"]["checked"] == 40
        assert r["topk"]["recall_at_10"] == 1.0
        assert r["topk"]["bitwise_on_equals_off"] == {"tfidf": True,
                                                      "bm25": True}
        assert r["search_batch"]["bm25"]["answered"] > 0
    json.dumps(rows)
    kg = chip_smoke.phase_kgram("cpu", str(tmp_path), device="cpu")
    assert kg["identical_artifacts"] >= 10 and kg["verify_ok"]
    assert kg["builds"]["streaming"]["chargram_ks"] == []
    assert kg["recall_at_10"] == 1.0 and kg["glob_answered"] >= 20
    json.dumps(kg)


def test_positions_phrase_prox_explain_snippet_phases_on_cpu(tmp_path,
                                                             monkeypatch):
    """The positions phase (ref: one-shot, legacy and radix-requested
    streaming; wiki100k: streaming with the store and one-shot, all with
    one sha256 a shared artifact), then prox on both, phrase with its
    stream-scan oracle, snippets through the frontend and explain with its
    plain-twin rerun, at a small size on the CPU."""
    import numpy as np

    from tpu_ir_torch.corpus import make_corpus
    from tpu_ir_torch.search import Scorer
    from tpu_ir_torch.search import scorer as scorer_mod

    small = dict(n_docs=200, target_bytes=200_000, vocab_size=2_000)
    monkeypatch.setattr(chip_smoke, "REF_CORPUS", small)
    monkeypatch.setattr(chip_smoke, "POSITIONS_REF_BATCH", 50)
    for name, n in (("PHRASE_TEXTS", 60), ("PHRASE_ORACLE", 20),
                    ("PROX_QUERIES", 100), ("PROX_ORACLE", 16),
                    ("EXPLAIN_QUERIES", 24), ("SNIPPET_HITS", 30)):
        monkeypatch.setattr(chip_smoke, name, n)
    # ref (~2,200 terms x 201) dense, wiki100k (~3,300 x 301) tiered
    monkeypatch.setattr(scorer_mod, "DENSE_BUDGET", 600_000)
    work = str(tmp_path)
    chip_smoke.phase_build("cpu", work, device="cpu", keep_corpus=True)
    make_corpus(os.path.join(work, "wiki100k.trec"), seed=0, n_docs=300,
                target_bytes=300_000, vocab_size=3_000)
    pos, dirs = chip_smoke.phase_positions("cpu", work, device="cpu")
    for config, extra in (("ref", 0), ("wiki100k", 2)):
        row = pos["configs"][config]
        assert row["identical_artifacts"] >= 16
        assert len(row["sha256"]) == 10
    builds = pos["configs"]["wiki100k"]["builds"]
    assert builds["streaming"]["radix_fallback_warning"]
    assert not pos["configs"]["ref"]["builds"]["legacy"][
        "radix_fallback_warning"]
    assert builds["oneshot"]["positions_bytes"] > 0
    assert not os.path.exists(os.path.join(work, "wiki100k.trec"))
    json.dumps(pos)

    rng = np.random.default_rng(1)
    ref = Scorer.load(dirs["ref"], device="cpu")
    assert ref.layout == "dense"
    ref_q = rng.integers(0, ref.meta.vocab_size, (200, 2)).astype(np.int32)
    prox = chip_smoke.phase_prox("cpu", ref, ref_q, config="ref",
                                 device="cpu")
    assert prox["answered"] > 20 and prox["oracle"]["queries"] == 16
    texts = [" ".join(ref.vocab.terms[int(t)] for t in row)
             for row in ref_q]
    ex = chip_smoke.phase_explain("cpu", ref, texts, config="ref",
                                  traffic="uniform",
                                  runs=("tfidf", "bm25", "rerank"))
    assert all(r["entries"] > 20 and r["bitwise_plain_twins"]
               for r in ex["runs"].values())

    wiki = Scorer.load(dirs["wiki100k"], device="cpu")
    assert wiki.layout == "sparse"
    wq = rng.integers(0, wiki.meta.vocab_size, (400, 2)).astype(np.int32)
    prox = chip_smoke.phase_prox("cpu", wiki, wq, config="wiki100k",
                                 device="cpu")
    assert prox["oracle"]["boosted_candidates"] > 0
    phrase = chip_smoke.phase_phrase("cpu", wiki, dirs["wiki100k"], work,
                                     device="cpu")
    assert phrase["oracle"]["phrases"] == 40
    # the streams read beforehand (run_phases gives them to a child): the
    # same texts and oracle, the reader's seconds and the wait reported
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as ex:
        streams = ex.submit(chip_smoke.store_streams_timed,
                            dirs["wiki100k"], work)
        again = chip_smoke.phase_phrase("cpu", wiki, dirs["wiki100k"], work,
                                        device="cpu", streams=streams)
    assert {k: v for k, v in again["oracle"].items()
            if k != "s"} == {
        k: v for k, v in phrase["oracle"].items() if k != "s"}
    assert again["examples"] == phrase["examples"]
    assert again["store_streams_s"] == streams.result()[3]
    assert again["store_streams_wait_s"] >= 0
    assert phrase["oracle"]["matched_docs"] >= 40
    assert set(phrase["runs"]) == {"slop0-tfidf", "slop0-bm25",
                                   "slop2-tfidf", "slop2-bm25"}
    snip = chip_smoke.phase_snippets("cpu", wiki, wq)
    assert snip["hits"] >= 30 and snip["marked_words"] >= 30
    hot = np.nonzero(wiki._hot_rank_host >= 0)[0]
    texts = [f"{wiki.vocab.terms[int(h)]} {wiki.vocab.terms[int(t)]}"
             for h, t in zip(rng.choice(hot, 24), wq[:24, 0])]
    ex = chip_smoke.phase_explain("cpu", wiki, texts, config="wiki100k",
                                  traffic="hot",
                                  runs=("tfidf", "bm25", "rerank"))
    assert all(r["entries"] > 20 for r in ex["runs"].values())
    json.dumps([prox, phrase, snip, ex])
    # the stream scan itself against a hand-made stream: docs 1 and 2
    flat = np.array([5, 6, 7, 5, 9, 6, 5, 6], np.int32)
    doc_of = np.array([1, 1, 1, 1, 1, 1, 2, 2], np.int32)
    assert chip_smoke.window_scan(flat, doc_of, [5, 6], 0) == [1, 2]
    assert chip_smoke.window_scan(flat, doc_of, [5, 7], 0) == []
    assert chip_smoke.window_scan(flat, doc_of, [5, 7], 1) == [1]
    assert chip_smoke.window_scan(flat, doc_of, [6, 5, 6], 0) == []
    assert chip_smoke.window_scan(flat, doc_of, [7, 6], 2) == [1]


def test_v1_merge_warm_doctor_phases_on_cpu(tmp_path, monkeypatch):
    """The v1 phase (a v1 ref build served bitwise as the v2 one, then
    migrated to its bytes), the merge phase (wiki100k from halves with
    the store against the radix build's digests, ref with positions
    against the positions build's; the merged index served bitwise as
    the radix one), the warm phase (a hit opens no part and serves the
    miss's bits; the CLI) and doctor, at a small size on the CPU."""
    from tpu_ir_torch.search import scorer as scorer_mod

    monkeypatch.setattr(chip_smoke, "REF_CORPUS", dict(
        n_docs=200, target_bytes=200_000, vocab_size=2_000))
    monkeypatch.setattr(chip_smoke, "WIKI_CORPUS", dict(
        n_docs=300, target_bytes=300_000, vocab_size=3_000))
    monkeypatch.setattr(chip_smoke, "POSITIONS_REF_BATCH", 50)
    monkeypatch.setattr(chip_smoke, "REF_QUERIES", 300)
    monkeypatch.setattr(chip_smoke, "ORACLE_QUERIES", 16)
    monkeypatch.setattr(chip_smoke, "WARM_RERANK", 50)
    monkeypatch.setattr(chip_smoke, "WARM_EXPLAIN_QUERIES", 16)
    # ref (~2,200 terms x 201) dense, wiki100k (~3,300 x 301) tiered
    monkeypatch.setattr(scorer_mod, "DENSE_BUDGET", 600_000)
    work = str(tmp_path)
    _, idx = chip_smoke.phase_build("cpu", work, device="cpu",
                                    keep_corpus=True)
    _, ref, ref_q, dense = chip_smoke.phase_serve("cpu", idx, device="cpu")
    del ref
    v1 = chip_smoke.phase_v1("cpu", work, idx, ref_q, dense, device="cpu")
    assert v1["verify_v1"] and v1["verify_v2"] and v1["topk_bitwise_v2"]
    assert v1["identical_artifacts_after_migrate"] >= 15
    assert v1["migrate"]["migrated"] == 10
    assert not os.path.exists(os.path.join(work, "ref-v1"))

    _, widx = chip_smoke.phase_build_streaming("cpu", work, device="cpu",
                                               keep_corpus=True)
    _, wiki, q_ids, wraw = chip_smoke.phase_serve("cpu", widx, device="cpu",
                                                  config="wiki100k")
    hot_q = chip_smoke.hot_traffic(wiki, 200)
    del wiki
    _, pos_dirs = chip_smoke.phase_positions("cpu", work, device="cpu",
                                             keep_corpora=True)
    merge = chip_smoke.phase_merge(
        "cpu", work, widx=widx, wdigests=chip_smoke.artifact_digests(widx),
        ref_pos=pos_dirs["ref"], q_ids=q_ids, want=wraw, device="cpu")
    wrow, rrow = merge["configs"]["wiki100k"], merge["configs"]["ref-pos"]
    assert wrow["store"] and not wrow["has_positions"]
    assert rrow["has_positions"] and not rrow["store"]
    assert wrow["identical_artifacts"] >= 18 and len(wrow["halves"]) == 2
    assert {"merge_postings", "docstore", "chargrams"} <= set(
        wrow["timings_s"])
    assert merge["topk_bitwise_radix"]
    # both corpora stay for the live phases (19d, 19e), which delete them
    assert os.path.exists(os.path.join(work, "wiki100k.trec"))
    assert os.path.exists(os.path.join(work, "ref.trec"))
    assert not os.path.exists(os.path.join(work, "wiki100k-merged"))

    warm = chip_smoke.phase_warm("cpu", widx, q_ids, hot_q, device="cpu")
    assert warm["hit_part_opens"] == 0 and warm["serve_part_opens"] == 0
    assert warm["cache_bytes"] > 0 and warm["explain_entries"] > 16
    assert len(warm["bitwise_miss"]) == 6
    assert warm["cli"]["cache_written"] and warm["cli"]["warm_skips_shards"]
    doc = chip_smoke.phase_doctor("cpu", widx)
    assert doc["block_bounds"]["bounds_exact"]
    assert doc["serving_caches"] == ["serving-tiered"]
    json.dumps([v1, merge, warm, doc])
    # the split: two files whose concatenation is the whole corpus
    c = os.path.join(work, "c.trec")
    with open(c, "w") as f:
        f.write("<DOC>\n<DOCNO> A </DOCNO>\nx\n</DOC>\n" * 5)
    a, b = chip_smoke.split_corpus(c, work, "c")
    assert open(a).read() + open(b).read() == open(c).read()
    assert open(b).read().startswith("<DOC>")


def test_live_phases_are_listed():
    """Phases 19d, 19e and 19f exist and the docstring lists each by name,
    19d's text the shards and elastic phases it runs before its operator
    checks, and 19e's the routed and elastic soaks."""
    for num, name in (("19d", "live"), ("19e", "live_crash"),
                      ("19f", "ingest_soak")):
        assert callable(getattr(chip_smoke, f"phase_{name}"))
        assert f"\n{num}. {name} " in chip_smoke.__doc__
    for name in ("shards", "elastic", "routed_soak", "elastic_soak"):
        assert callable(getattr(chip_smoke, f"phase_{name}"))
        assert f"`{name}`" in chip_smoke.__doc__


def test_depth_constants_cover_their_samples():
    """Every traffic the numpy oracle samples ORACLE_QUERIES rows of holds
    at least that many (the CPU tests below shrink both), and the other
    samples fit their populations."""
    c = chip_smoke
    for n in (c.KGRAM_QUERIES, c.KGRAM_GLOBS, c.WILDCARD_QUERIES,
              c.REF_QUERIES):
        assert n >= c.ORACLE_QUERIES
    assert c.PROX_QUERIES >= c.PROX_ORACLE // 2
    assert c.PHRASE_TEXTS >= c.PHRASE_ORACLE
    assert c.SWEEP_QUERIES >= max(c.SWEEP_LEVELS)
    assert c.SHARD_TEXTS >= c.SHARD_PROBE_TEXTS >= 8
    assert c.SHARD_TEXTS >= c.SHARD_RERANK_TEXTS
    assert 0 < c.SHARD_KILL_AT < 1 and 0 < c.ROUTED_SOAK_UPGRADE_AT < 1
    # the elastic phase: the narrow router queues under the clients (its
    # occupancy reaches the 0.6 that arms a grow), and the soak's plan
    # rolls, grows and drains in that order with a replica to drain
    assert c.SHARD_CLIENTS / c.ELASTIC_NARROW >= 0.6 * 2
    assert c.ELASTIC_KILL_CLIENTS >= 1 and c.ELASTIC_MEMORY_SLACK <= 0.5e9
    assert 1 <= c.ELASTIC_HOT_TEXTS <= c.SHARD_TEXTS
    plan = c.ELASTIC_SOAK_PLAN
    assert 0 < c.ELASTIC_SOAK_UPGRADE_AT < plan["up_at"] < plan["down_at"] < 1
    assert plan["kill_during_drain"] and c.ELASTIC_SOAK_REPLICAS >= 2
    # the forecast soak: its first crest (at 1 / (2 BURST_CYCLES) of the
    # requests) comes after the warm-up's 5% plus the fit's 8 points a
    # refit interval apart, and the occupancy can cross the autoscaler's
    # threshold (more clients than threshold x slots)
    from tpu_ir_torch.serving import soak as soak_mod
    from tpu_ir_torch.serving.workload import BURST_CYCLES

    assert c.FORECAST_SOAK_QUERIES / (2 * BURST_CYCLES) > \
        soak_mod._SCALE_WARMUP_FRAC * c.FORECAST_SOAK_QUERIES + 8
    assert c.FORECAST_SOAK_THREADS > 0.45 * c.FORECAST_SOAK_ROUTER_SLOTS
    assert c.FORECAST_SOAK_SAMPLE_S >= 0.05 and c.FORECAST_SOAK_BURST > 0
    assert c.FORECAST_SOAK_REPLICAS >= 2


def _span(sid, parent, name, start, dur, service="router", children=(),
          **attrs):
    return {"span_id": sid, "parent_id": parent, "name": name,
            "service": service, "start_ms": start, "dur_ms": dur,
            "attrs": attrs, "children": list(children)}


def _worker(sid, parent, shard, start, dur, kernel_ms=(1.0,)):
    """A worker's request span under an attempt: dispatch and kernels."""
    svc = f"worker-s{shard}r0"
    kernels = [_span(f"{sid}k{i}", f"{sid}d", "kernel", start + 2, ms, svc)
               for i, ms in enumerate(kernel_ms)]
    return _span(sid, parent, "request", start, dur, svc, [
        _span(f"{sid}l", sid, "ladder", start, 0.1, svc),
        _span(f"{sid}a", sid, "admission_wait", start, 0.5, svc),
        _span(f"{sid}d", sid, "dispatch", start + 1, dur - 2, svc,
              kernels)])


def _stitched(attempts, admission=2.0, root_ms=50.0):
    return {"roots": [_span("r", None, "request", 0.0, root_ms, "router", [
        _span("aw", "r", "admission_wait", 0.0, admission), *attempts])]}


def _answer(shards_ok, hedges=0):
    return types.SimpleNamespace(shards_ok=tuple(shards_ok), hedges=hedges)


def test_trace_attribution_of_a_hand_built_trace():
    """The parts of one routed request: they sum to the root; a winning
    hedge is the critical attempt, not the slow primary it beat; a failed
    attempt is never critical, its time falls to the router's remainder;
    a shard that did not answer is named and leaves the others' parts;
    spans that do not nest (a wrong stitch, a skewed clock) are
    problems."""
    c = chip_smoke
    # shard 0: the primary lost to a hedge; shard 1: a failover after a
    # failed attempt; the critical attempt is shard 0's hedge (30 ms)
    trace = _stitched([
        _span("a0", "r", "rpc.search", 3.0, 40.0, shard=0, replica=0,
              hedge=False, outcome="lost",
              children=[_worker("w0", "a0", 0, 4.0, 38.0)]),
        _span("a1", "r", "rpc.search", 10.0, 30.0, shard=0, replica=1,
              hedge=True, outcome="won",
              children=[_worker("w1", "a1", 0, 12.0, 24.0, (3.0, 1.5))]),
        _span("a2", "r", "rpc.search", 3.0, 1.0, shard=1, replica=1,
              hedge=False, outcome="failed"),
        _span("a3", "r", "rpc.search", 5.0, 20.0, shard=1, replica=0,
              hedge=False, outcome="won",
              children=[_worker("w3", "a3", 1, 6.0, 15.0)]),
    ])
    att = c.trace_attribution(trace, _answer((0, 1), hedges=1))
    assert att["problems"] == []
    assert att["critical_shard"] == 0 and att["critical_hedge"]
    assert (att["request"], att["admission_wait"], att["attempt"],
            att["worker_request"]) == (50.0, 2.0, 30.0, 24.0)
    assert att["dispatch"] == 22.0 and att["kernel"] == 4.5
    assert att["worker_admission_wait"] == 0.5
    assert att["wire"] == 6.0 and att["remainder"] == 18.0
    assert att["admission_wait"] + att["wire"] + att["worker_request"] \
        + att["remainder"] == att["request"]
    assert att["attempts"] == 4 and att["failed"] == 1
    assert att["missing_shards"] == []
    # a missing shard (its only attempt ran into the deadline): the
    # answer's shards_ok leaves it out, the parts are the other shard's
    partial = _stitched([
        _span("a0", "r", "rpc.search", 3.0, 12.0, shard=0, hedge=False,
              outcome="won", children=[_worker("w0", "a0", 0, 4.0, 9.0)]),
        _span("a1", "r", "rpc.search", 3.0, 45.0, shard=1, hedge=False,
              outcome="deadline")])
    att = c.trace_attribution(partial, _answer((0,)))
    assert att["problems"] == [] and att["missing_shards"] == [1]
    assert att["critical_shard"] == 0 and att["remainder"] == 36.0
    # what a sound full answer's trace must hold
    assert c.trace_attribution(partial, _answer((0, 1)))["problems"] == [
        "contributing_shard_without_winning_attempt"]
    assert c.trace_attribution(trace, _answer((0, 1), hedges=2))[
        "problems"] == ["hedge_spans=1<res.hedges=2"]
    no_kernel = _stitched([_span(
        "a0", "r", "rpc.search", 3.0, 12.0, shard=0, outcome="won",
        children=[_worker("w0", "a0", 0, 4.0, 9.0, kernel_ms=())])])
    assert c.trace_attribution(no_kernel, _answer((0,)))["problems"] == [
        "shard 0: no kernel span"]
    no_worker = _stitched([_span("a0", "r", "rpc.search", 3.0, 12.0,
                                 shard=0, outcome="won")])
    assert c.trace_attribution(no_worker, _answer((0,)))["problems"] == [
        "contributing_shard_without_worker_spans"]
    unjudged = _stitched([_span("a0", "r", "rpc.search", 3.0, 12.0,
                                shard=0, children=[_worker(
                                    "w0", "a0", 0, 4.0, 9.0)])])
    assert c.trace_attribution(unjudged, _answer((0,)))["problems"] == [
        "attempt_without_outcome"]
    two_roots = {"roots": trace["roots"] * 2}
    assert c.trace_attribution(two_roots, _answer((0,)))["problems"] == [
        "multi_root"]
    # a worker request longer than its attempt cannot nest
    skewed = _stitched([_span(
        "a0", "r", "rpc.search", 3.0, 8.0, shard=0, outcome="won",
        children=[_worker("w0", "a0", 0, 4.0, 12.0)])])
    assert c.trace_attribution(skewed, _answer((0,)))["problems"] == [
        "wire -4.000 ms"]
    # the worker's dispatch longer than its request, its kernels longer
    # than its dispatch: both stitched from the wrong spans
    w = _worker("w0", "a0", 0, 4.0, 9.0, kernel_ms=(9.0,))
    bad_nest = _stitched([_span("a0", "r", "rpc.search", 3.0, 12.0,
                                shard=0, outcome="won", children=[w])])
    assert c.trace_attribution(bad_nest, _answer((0,)))["problems"] == [
        "shard 0: kernel outside the dispatch"]
    w["children"][2]["dur_ms"] = 10.0
    w["children"][2]["children"] = []
    w["children"].append(_span("w0k", "w0d", "kernel", 6.0, 1.0,
                               w["service"]))
    assert c.trace_attribution(bad_nest, _answer((0,)))["problems"] == [
        "shard 0: admission wait and dispatch outside the worker's request"]
    # an attempt the harvest waited for cannot end after the root; one
    # cancelled in flight may, but none starts outside it
    late = _stitched([
        _span("a0", "r", "rpc.search", 3.0, 12.0, shard=0, outcome="won",
              children=[_worker("w0", "a0", 0, 4.0, 9.0)]),
        _span("a1", "r", "rpc.search", 30.0, 40.0, shard=0, replica=1,
              hedge=True, outcome="cancelled")])
    assert c.trace_attribution(late, _answer((0,), hedges=1))[
        "problems"] == []
    late["roots"][0]["children"][2]["attrs"]["outcome"] = "lost"
    assert c.trace_attribution(late, _answer((0,), hedges=1))[
        "problems"][0].startswith("attempt outside the root")
    early = _stitched([_span(
        "a0", "r", "rpc.search", -5.0, 12.0, shard=0, outcome="won",
        children=[_worker("w0", "a0", 0, 4.0, 9.0)])])
    assert c.trace_attribution(early, _answer((0,)))["problems"][
        0].startswith("attempt outside the root")


def test_attribute_traces_sums_and_shares(monkeypatch):
    """attribute_traces over stitched traces: untraced answers counted
    apart, a problem trace left out of the parts, the shares of the
    summed roots, p50 and p99 of each part."""
    from tpu_ir_torch.obs import disttrace

    c = chip_smoke
    traces = {}
    for i, root_ms in enumerate((40.0, 60.0)):
        traces[f"t{i}"] = _stitched([_span(
            "a0", "r", "rpc.search", 3.0, 20.0, shard=0, outcome="won",
            children=[_worker("w0", "a0", 0, 4.0, 16.0)])],
            root_ms=root_ms)
    traces["bad"] = _stitched([])
    monkeypatch.setattr(disttrace, "stitch",
                        lambda tid, include_spool=True: traces.get(tid))
    out = c.attribute_traces([(tid, _answer((0,))) for tid in
                              ("t0", "t1", "bad", None, "gone")])
    assert (out["answers"], out["stitched"], out["problems"]) == (5, 3, 1)
    parts = out["parts"]
    assert parts["request"]["share"] == 1.0
    assert parts["attempt"]["share"] == 40.0 / 100.0
    assert parts["remainder"]["p50_ms"] == 48.0 - 20.0
    assert parts["wire"]["p99_ms"] == 4.0
    assert out["critical_hedges"] == 0 and out["failed_attempts"] == 0
    assert out["critical_shards"] == {"0": 2}


def test_live_phases_on_cpu(tmp_path, monkeypatch):
    """19d and 19e at a small size on the CPU: the seed through the
    command line, the delta with flushes and a merge, B == the one-shot
    build, the swap under probes with its gap and the streamed load's
    spans, the gap trials, B bitwise the one-shot index, the shards phase
    (2 x 2 subprocess workers on A behind the Router, a replica killed
    under its traffic, the rolling swap to B under routed probes, the
    respawn), the operator checks; the backup and restore, the crash
    child SIGKILLed at its third flush, the recovery to the control's
    bytes, the dense serve of the recovered generation, its in-process
    workers behind the Router and the routed chaos soak."""
    from tpu_ir_torch.corpus import make_corpus
    from tpu_ir_torch.search import scorer as scorer_mod

    monkeypatch.setattr(chip_smoke, "LIVE", dict(
        seed_docs=260, updates=12, deletes=12, buffer_docs=10))
    monkeypatch.setattr(chip_smoke, "LIVE_CRASH", dict(
        seed_docs=160, updates=10, deletes=10, buffer_docs=10))
    monkeypatch.setattr(chip_smoke, "REF_QUERIES", 300)
    monkeypatch.setattr(chip_smoke, "SWAP_PROBE_S", 0.3)
    monkeypatch.setattr(chip_smoke, "SWAP_SAMPLE", 8)
    monkeypatch.setattr(chip_smoke, "LIVE_SERVE_TEXTS", 32)
    monkeypatch.setattr(chip_smoke, "SHARD_TEXTS", 24)
    monkeypatch.setattr(chip_smoke, "SHARD_CLIENTS", 4)
    monkeypatch.setattr(chip_smoke, "SHARD_RERANK_TEXTS", 6)
    monkeypatch.setattr(chip_smoke, "SHARD_PROBE_TEXTS", 6)
    monkeypatch.setattr(chip_smoke, "CRASH_WORKER_TEXTS", 12)
    monkeypatch.setattr(chip_smoke, "ROUTED_SOAK_THREADS", 6)
    monkeypatch.setattr(chip_smoke, "ROUTED_SOAK_QUERIES", 100)
    # ref (~2,200 terms x 201) dense, wiki100k (~3,300 x 301) tiered
    monkeypatch.setattr(scorer_mod, "DENSE_BUDGET", 600_000)
    work = str(tmp_path)
    make_corpus(os.path.join(work, "wiki100k.trec"), seed=0, n_docs=300,
                target_bytes=300_000, vocab_size=3_000)
    make_corpus(os.path.join(work, "ref.trec"), seed=0, n_docs=200,
                target_bytes=200_000, vocab_size=2_000)
    shards = {}

    def run_shards(live_dir, gen_a, gen_b, scorers):
        shards.update(chip_smoke.phase_shards("cpu", work, live_dir, gen_a,
                                              gen_b, scorers, device="cpu"))

    live = chip_smoke.phase_live("cpu", work, device="cpu",
                                 before_checks=run_shards)
    assert live["seed"]["wal_appends"] == 260 and live["seed"]["wal_bytes"]
    assert live["seed"]["segments"] == ["seg-000001"]
    assert live["delta"]["ops"] == 40 + 24
    assert live["delta"]["merge_steps"]["count"] >= 1
    assert live["delta"]["flushes"]["count"] >= 6
    assert live["identical_artifacts"] >= 15 and live["b_bitwise_one_shot"]
    assert live["num_docs_b"] == 300 - 12
    swap = live["swap"]
    assert swap["errors"] == 0 and swap["sheds"] == 0
    assert swap["generations_seen"] == [live["generation_a"],
                                        live["generation_b"]]
    assert swap["bitwise_sampled"] == 16 and swap["unwarmed"] == 0
    assert swap["swap_gap_ms"] > 0 and swap["baseline_gap_ms"] > 0
    assert swap["reload_wall_s"] > 0
    assert swap["gap_closed_by"] in swap["generations_seen"]
    assert swap["gap_opened_s"] < swap["reload_wall_s"]
    assert swap["wake_gap_ms"] > 0
    back = live["swap_preloaded"]
    assert back["errors"] == 0 and back["sheds"] == 0
    assert back["swap_gap_ms"] > 0 and back["reload_wall_s"] > 0
    assert live["warm_b_s"] > 0 and live["load_b_s"] > 0
    trials = live["gap_trials"]
    assert sorted(trials) == sorted([
        "cold_load_coalesced", "preloaded_coalesced", "cache_hit_coalesced",
        "cache_hit_plain", "preloaded_plain", "upload_coalesced",
        "stream_crossing", "pageable_crossing", "cold_streamed",
        "cold_pageable"])
    for name, trial in trials.items():
        assert trial["probes"] > 0 and trial["swap_gap_ms"] > 0, name
        assert trial["wake_gap_ms"] > 0 and trial["reload_wall_s"] > 0, name
    assert trials["cache_hit_coalesced"]["part_opens"] == 0
    assert trials["cache_hit_plain"]["part_opens"] == 0
    assert trials["upload_coalesced"]["bytes"] > 0
    # the streamed uploads: what crossed, the copies of as many bytes,
    # the cold streamed load's timeline
    reload_b = live["reload_b"]
    assert reload_b["bytes"] > 0 and reload_b["uploads"] >= 10
    names = {row[0] for row in reload_b["timeline"]}
    assert {"load.meta", "load.vocab", "load.read", "load.layout",
            "load.strip", "load.h2d", "load.norms", "warm_up"} <= names
    for name in ("stream_crossing", "pageable_crossing"):
        assert trials[name]["bytes"] == reload_b["bytes"]
        assert trials[name]["gb_per_s"] > 0
    for name in ("cold_streamed", "cold_pageable", "cache_hit_coalesced"):
        assert trials[name]["bytes"] == reload_b["bytes"], name
        assert {row[0] for row in trials[name]["timeline"]} >= {
            "load.h2d", "warm_up"}, name
        assert set(trials[name]["gap_within"]) <= names, name
    assert set(swap["gap_within"]) <= names
    # the workers on A behind the Router, a replica killed under the
    # traffic, the rolling swap to B, the respawn
    routed = shards["routed"]
    assert routed["mismatches"] == routed["errors"] == 0
    assert routed["texts"] == routed["counters"]["router.served_full"] \
        == 2 * 24
    assert routed["router.shard_rtt"]["count"] >= 2 * 2 * 24
    assert routed["killed"]["pid"] and routed["killed"]["after_answers"]
    assert routed["trace"]["stitched"] == 2 * 24
    assert routed["trace"]["problems"] == 0
    # the TF-IDF texts traced and with tracing off in turns; attributed
    att = shards["attribution"]
    assert att["texts"] == 24 and att["control_scope"] == "router_process"
    assert [r["traced"] for r in att["passes"]] == [
        True, False] * chip_smoke.SHARD_TRACE_PASSES
    for r in att["passes"]:
        assert r["answers"] == 24 and r["mismatches"] == 0
        assert r["router.request"]["count"] == 24
        assert r.get("untraced_answers", 24) == 24
    for name in ("traced", "control"):
        assert att[name]["routed_qps_median"] > 0
        assert att[name]["routed_qps_spread"] >= 0
        assert att[name]["router_request_p50_ms_median"] > 0
    assert att["qps_traced_over_control"] > 0
    parts = att["attribution"]["parts"]
    assert set(parts) == set(chip_smoke.ATTRIBUTION_PARTS)
    assert att["attribution"]["stitched"] == \
        chip_smoke.SHARD_TRACE_PASSES * 24
    assert att["attribution"]["problems"] == 0
    assert parts["request"]["share"] == 1.0
    assert 0 < parts["kernel"]["p50_ms"] <= parts["dispatch"]["p50_ms"]
    assert shards["rerank"]["bitwise"]
    walk = shards["rolling_swap"]
    assert walk["answers_a"] and walk["answers_b"]
    assert walk["swapped"] == 3 and walk["failed"] == 1
    assert [sh["shard"] for sh in walk["shards"]] == [0, 1]
    assert all(sh["answers"] and sh["widest_gap_ms"] > 0
               for sh in walk["shards"])
    assert walk["full_gap_ms"] >= walk["widest_gap_ms"] > 0
    assert shards["respawned"]["index_generation"] == live["generation_b"]
    assert shards["respawned"]["spawn_generation"] == 1
    assert len(shards["launches_by_worker"]) == 5
    assert shards["stopped"]["alive"] == []
    # the elastic phase on that fleet: the autoscaler's grow under the
    # narrow router's burst, 2 x 3, its drains when idle, the kill during
    # a scripted drain, `scale --url`
    el = shards["elastic"]
    for name in ("fleet_2x2", "fleet_2x3"):
        assert el[name]["texts"] == el[name]["answers"] == 24
        assert el[name]["mismatches"] == el[name]["errors"] == 0
    assert el["burst"]["answers"] > 0 and el["burst"]["mismatches"] == 0
    assert el["burst"]["ticks_to_up"] >= 3
    assert el["burst"]["reason"] in ("sustained_pressure", "slo_burn")
    assert el["counters"] == {"scale.up": 2, "scale.down": 2,
                              "router.breaker_opened": 0}
    assert el["scale_down"] == 3
    assert [(d["shard"], d["replica"]) for d in el["idle"]["drains"]] == [
        (0, 2), (1, 2)]
    assert el["idle"]["ticks_to_down"] >= 25 and el["idle"]["probes"] > 0
    assert el["kill_during_drain"]["drain"]["killed_mid_drain"]
    assert el["kill_during_drain"]["traffic"]["mismatches"] == 0
    assert el["lifecycle"] == [["active", "retired", "retired"],
                               ["active", "active", "retired"]]
    assert [e[0] for e in el["events"]] == ["up", "up", "down", "down",
                                            "down"]
    assert el["scale_cli"]["lifecycle"] == el["lifecycle"]
    assert el["scale_warmup"]["count"] == 1
    assert el["scale_drain"]["count"] == 3
    assert set(el["nice"]) == {"0/0", "0/1", "0/2", "1/0", "1/1", "1/2"}
    assert set(el["grown_warm_launches"]) == {"0/2", "1/2"}
    # texts led by a hot term, each once a replica from one client (none
    # of these 24 texts holds one of the 30 hot terms by itself)
    hp = el["hot_pass"]
    assert el["hot_bearing_texts"] == 0
    assert hp["texts"] == hp["answers"] == 3 * chip_smoke.ELASTIC_HOT_TEXTS
    assert hp["mismatches"] == hp["errors"] == 0
    assert set(el["grown_routed_by_worker"]) == {"0/2", "1/2"}
    assert el["retired_alive"] == []
    assert len(shards["stopped"]["returncodes"]) == 6
    # the dense workers' launch count opens after the reference's answers
    counting = []
    real_http_workers = chip_smoke.http_workers

    def http_workers(scorer, live_dir, **kw):
        real_search = scorer.search_batch
        real_reset = tpu_ir_torch.reset_kernel_launches

        def search_batch(*a, **kw):
            assert not counting, "the reference scored in the counted window"
            return real_search(*a, **kw)

        def reset_kernel_launches():
            counting.append(True)
            real_reset()

        monkeypatch.setattr(scorer, "search_batch", search_batch)
        monkeypatch.setattr(tpu_ir_torch, "reset_kernel_launches",
                            reset_kernel_launches)
        try:
            return real_http_workers(scorer, live_dir, **kw)
        finally:
            monkeypatch.setattr(tpu_ir_torch, "reset_kernel_launches",
                                real_reset)

    monkeypatch.setattr(chip_smoke, "http_workers", http_workers)
    soaks = []
    monkeypatch.setattr(chip_smoke, "emit", soaks.append)
    crash = chip_smoke.phase_live_crash("cpu", work, device="cpu")
    assert counting == [True]
    assert crash["restore_verified"] and crash["backup"]["bytes_linked"]
    assert crash["backup"]["wal_segments"] == 1
    assert crash["child_rc"] == -9 and crash["replayed"] >= 1
    assert crash["lease"]["taken_over"] and crash["lost_acked"] == 0
    assert 0 < crash["acked_ops"] < 60
    assert crash["identical_artifacts"] == live["identical_artifacts"]
    assert crash["bitwise_one_shot"]
    assert crash["workers"]["bitwise"] and crash["workers"]["texts"] == 24
    soak, elastic, forecast = soaks
    assert all(soak["checks"].values()) and soak["healthz_polls"]["n"]
    assert soak["report"]["submitted"] == 100
    assert crash["routed_soak_launches_lower_bound"] == soak[
        "launches_lower_bound"]
    assert set(soak["launches_with_warm_ups"]) == set(
        soak["launches_lower_bound"])
    assert soak["report"]["disttrace"]["traced"] > 0
    # the elastic soak: rolled, grown and drained with a kill mid-drain
    assert elastic["phase"] == "elastic_soak"
    assert all(elastic["checks"].values()), elastic["checks"]
    assert elastic["report"]["submitted"] == 100
    assert len(elastic["report"]["scale"]["drains"]) == 2
    assert crash["elastic_soak_launches_lower_bound"] == elastic[
        "launches_lower_bound"]
    # the forecast-armed autoscaler: fits, the workers' time series read
    # mid-soak, the spool's merge equal to each worker's own last counts
    assert forecast["phase"] == "forecast_soak"
    assert all(forecast["checks"].values()), forecast["checks"]
    assert forecast["report"]["submitted"] == \
        chip_smoke.FORECAST_SOAK_QUERIES
    assert forecast["autoscale"]["forecast_up"] == \
        forecast["autoscale"]["up_occupancy"] == 0.45
    assert forecast["autoscale"]["forecast_lead_s"] == 1.0
    assert forecast["forecast"]["fits"] >= 1
    assert forecast["cluster"]["processes"] >= 4
    assert forecast["cluster"]["submitted"] == forecast["cluster"][
        "own_submitted"] > 0
    # the spool against the router's own count of its search attempts
    searches = forecast["cluster"]["router_attempts"]["search"]
    assert {"merge_equals_files", "spool_equals_router"} <= set(
        forecast["checks"])
    assert searches["sent_ok"] <= forecast["cluster"]["answered"]
    assert forecast["cluster"]["submitted"] <= searches["sent_ok"] + \
        searches.get("sent_failed", 0)
    arm = forecast["forecast_arm"]
    assert arm["ticks"] > 0 and arm["forecast_max"] is not None
    # the poller reads this process's fleet each poll, not once: a worker
    # read between two polls leaves the next one on this process
    assert forecast["healthz_polls"]["with_router"] >= 2
    # each decision grows or drains a replica of every shard
    assert len(arm["scale_events"]) * chip_smoke.FORECAST_SOAK_SHARDS == \
        forecast["report"]["scale"]["events"]
    assert forecast["worker_timeseries"]["tiers"][0]["window_s"] == \
        chip_smoke.FORECAST_SOAK_SAMPLE_S
    assert set(forecast["forecast_arm"]) >= {"forecast_lead_s",
                                             "burst_p99_ms"}
    assert crash["forecast_soak_launches_lower_bound"] == forecast[
        "launches_lower_bound"]
    for name in ("TPU_IR_TELEMETRY_DIR", "TPU_IR_TS_SAMPLE_S"):
        assert name not in os.environ
    assert os.listdir(work) == []
    json.dumps([live, crash, shards, soak, elastic, forecast])


def test_forecast_record_of_hand_built_ticks():
    """The forecast's part in the autoscaler's ticks, recorded: the ticks
    whose forecast reached forecast_up, those the forecast alone armed,
    the highest forecast, and each membership change with its reason."""
    def tick(n, occ, fc, action=None, reason="steady"):
        return {"tick": n, "occupancy": occ, "forecast": fc,
                "action": action, "reason": reason, "active": 2,
                "slo_burn": 0.0}

    ticks = [tick(1, 0.1, 0.2), tick(2, 0.3, 0.5),
             tick(3, 0.6, 0.45), tick(4, 0.2, 0.47, "up", "forecast"),
             tick(5, 0.05, 0.1, "down", "steady"), tick(6, 0.5, 0.46)]
    rec = chip_smoke.forecast_record(ticks, 0.45, 0.55)
    assert rec["ticks"] == 6
    assert rec["forecast_live_ticks"] == 4 and rec["forecast_only_ticks"] == 3
    assert rec["forecast_max"] == 0.5
    assert rec["scale_events"] == [
        {"tick": 4, "action": "up", "reason": "forecast", "occupancy": 0.2,
         "forecast": 0.47},
        {"tick": 5, "action": "down", "reason": "steady", "occupancy": 0.05,
         "forecast": 0.1}]
    assert chip_smoke.forecast_record([], 0.45, 0.45)["forecast_max"] is None


def test_ingest_soak_phase_on_cpu(tmp_path):
    """19f on the CPU: `ingest --soak-bench` through the command line in
    this process, its invariants held again, its live dir removed."""
    out = chip_smoke.phase_ingest_soak("cpu", str(tmp_path), device="cpu")
    assert all(out["checks"].values()), out["checks"]
    rep = out["report"]
    assert rep["docs"] == 48 and rep["base_docs"] == 12
    assert rep["history_row"]["config"] == "ingest_soak"
    assert rep["ingest_docs_per_s"] > 0 and rep["freshness_lag_ms"] > 0
    assert set(out["launches_lower_bound"]) == set(chip_smoke.PORT_KERNELS)
    assert set(out["launches_with_warm_ups"]) == set(chip_smoke.PORT_KERNELS)
    assert os.listdir(tmp_path) == []
    json.dumps(out)


# -- the profiler's checks (pure helpers, on the CPU) -------------------------

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_Z16cold_tier_kernelILb1EEvPKiS1_PKfS1_ilPfllff' for 'sm_90a'
ptxas info    : Function properties for _Z16cold_tier_kernelILb1EEvPKiS1_PKfS1_ilPfllff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 4096 bytes smem, 432 bytes cmem[0]
"""


def test_ptxas_report_moved_into_the_package():
    """build_kernels reads the ledger, which parses nvcc's -Xptxas -v
    output with ops/_build.py::ptxas_report (no copy left here)."""
    from tpu_ir_torch.ops import _build

    assert not hasattr(chip_smoke, "ptxas_report")
    assert _build.ptxas_report(PTXAS_LOG) == [{
        "kernel": "cold_tier_kernel<1>", "stack": 0, "spill_stores": 0,
        "spill_loads": 0, "registers": 32, "smem": 4096}]


def _ledger_entry(name, **over):
    e = {"source": f"tpu_ir_torch/csrc/{name}.cu", "library": f"lib{name}",
         "compiler": "nvcc", "built": True, "compile_s": 3.0, "load_s": 0.01,
         "ptxas": [{"kernel": f"{name}_kernel", "registers": 40,
                    "spill_stores": 0, "spill_loads": 0, "stack": 0,
                    "smem": 0}]}
    e.update(over)
    return e


@pytest.mark.parametrize("broken", [None, "missing", "no_ptxas", "unloaded"])
def test_check_build_ledger(broken):
    names = ["cold_tier", "dense_score"]
    ledger = [_ledger_entry(n) for n in names]
    if broken == "missing":
        ledger = ledger[:1]
    elif broken == "no_ptxas":
        ledger[1]["ptxas"] = None
    elif broken == "unloaded":
        ledger[0]["load_s"] = None
    if broken is None:
        chip_smoke.check_build_ledger(ledger, names)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_build_ledger(ledger, names)


def test_every_row_bytes_is_dense_bounds_count():
    """The profiler's dense signature bytes are dense_bound's every-row
    bytes: the same helper prices both."""
    from tpu_ir_torch.ops.scoring import idf_weights

    q = torch.tensor([[0, 1], [2, -1], [1, 1]], dtype=torch.int32)
    idf = idf_weights(torch.tensor([1, 2, 3], dtype=torch.int32), 9)
    bound = chip_smoke.dense_bound(q, idf, 10, cell_bytes=4,
                                   ops_per_cell=2)
    want = chip_smoke.every_row_bytes(3, 2, 10, 4)
    assert want == 3 * 2 * 10 * 4 + 3 * 10 * 4
    assert bound["bound_ms_every_row_read"] == \
        want / chip_smoke.HBM_BYTES_PER_S * 1e3


def _report(sigs: dict) -> dict:
    return {"functions": [{"name": n, "signatures": [
        {"signature": s, "compiles": c, "bytes_accessed": b, "flops": None,
         "last_compile_s": 0.001} for s, c, b in rows]}
        for n, rows in sigs.items()]}


def test_check_serve_profile():
    labels = {"tfidf": {"tfidf_topk_dense"}, "bm25": {"bm25_topk_dense"}}
    split = {s: {"repeat_compiles": 0, **chip_smoke.dispatch_split(
        {"dispatch.device": {"count": 2, "p50_ms": 1.0, "p99_ms": 2.0}})}
        for s in labels}
    good = {"tfidf_topk_dense": [("int32[10,2], float32[5,9], ...", 1, 80)],
            "bm25_topk_dense": [("int32[10,2], float32[5,9], ...", 1, 80)]}
    out = chip_smoke.check_serve_profile(_report(good), labels, split, 2,
                                         "int32[10,2], float32[", 80)
    assert out["labels"] == ["bm25_topk_dense", "tfidf_topk_dense"]
    bad_cases = [
        (dict(good, tfidf_topk_dense=[("int32[10,2], float32[", 2, 80)]),
         split, 2, 80),                                  # two cold calls
        ({"bm25_topk_dense": good["bm25_topk_dense"]}, split, 2, 80),
        (good, split, 3, 80),                           # a block unseen
        (good, split, 2, 81),                           # wrong bytes
        (good, dict(split, bm25=dict(split["bm25"], repeat_compiles=1)),
         2, 80)]
    for sigs, sp, blocks, nbytes in bad_cases:
        with pytest.raises(AssertionError):
            chip_smoke.check_serve_profile(_report(sigs), labels, sp,
                                           blocks, "int32[10,2], float32[",
                                           nbytes)


def test_dispatch_split_and_served_labels():
    split = chip_smoke.dispatch_split(
        {"kernel": {"count": 3, "p50_ms": 0.5, "p99_ms": 1.0, "sum_ms": 2}})
    assert split["kernel"] == {"count": 3, "p50_ms": 0.5, "p99_ms": 1.0}
    assert split["dispatch.device"] == {"count": None, "p50_ms": None,
                                        "p99_ms": None}
    tiered = types.SimpleNamespace(layout="sparse")
    dense = types.SimpleNamespace(layout="dense", doc_matrix=None)
    assert chip_smoke.served_labels(tiered)["bm25"] == {
        "bm25_topk_tiered", "bm25_topk_blockmax"}
    assert chip_smoke.served_labels(dense)["tfidf"] == {
        "tfidf_topk_dense_quantized"}


def test_profiling_passes_and_scrapes_on_cpu():
    """Three passes on and three off in turns (the profiler restored on
    after), each with its collector pauses, the dispatch split over them,
    then one pass with the profiler on for the shim's cost; a pass whose
    results change caught; and the server's scrapes with
    /metrics?reset=1 refused."""
    from tpu_ir_torch import obs
    from tpu_ir_torch.obs import profiling

    seen = []
    fn = profiling.profiled(lambda x, k=1: x, label="passes_fn")

    def run():
        seen.append(profiling.enabled())
        with obs.trace("dispatch"):
            with obs.trace("dispatch.device"):
                fn(torch.zeros(3), k=2)
        return [1, 2]

    out = chip_smoke.profiling_passes(run)
    assert seen == [True, False] * chip_smoke.QUERYLOG_PASSES + [True]
    assert profiling.enabled()
    assert len(out["walls_s"]["on"]) == chip_smoke.QUERYLOG_PASSES
    assert len(out["gc"]["off"]) == chip_smoke.QUERYLOG_PASSES
    assert set(out["net_of_gc_median_s"]) == {"on", "off"}
    assert out["dispatch_split"]["dispatch.device"]["count"] >= 6
    assert out["shim"]["calls_a_pass"] == 1
    assert out["shim"]["signatures"][0]["signature"] == "float32[3], k=2"
    flips = iter(range(10))
    with pytest.raises(AssertionError):
        chip_smoke.profiling_passes(lambda: next(flips))
    assert profiling.enabled()
    profiling.profiled(lambda x: x, label="scrape_fn")(torch.zeros(1))
    scraped = chip_smoke.scrape_metrics_server()
    assert scraped["reset_refused"] == 403
    assert "scrape_fn" in scraped["profile_labels"]


def test_sampler_passes_on_cpu():
    """Three passes with a sampler running and three without, in turns,
    on first: the sampler samples in the on passes only (none is left
    running), a pass whose results change is caught, and one sample's
    cost is timed."""
    import threading

    from tpu_ir_torch.obs import get_registry

    seen = []

    def run():
        seen.append(any(t.name == "tpu-ir-obs-timeseries"
                        for t in threading.enumerate()))
        time.sleep(0.12)
        return [3]

    before = get_registry().get("timeseries.samples")
    out = chip_smoke.sampler_passes(run)
    assert seen == [True, False] * chip_smoke.QUERYLOG_PASSES
    assert not any(t.name == "tpu-ir-obs-timeseries"
                   for t in threading.enumerate())
    assert out["samples_on"] >= chip_smoke.QUERYLOG_PASSES
    assert get_registry().get("timeseries.samples") - before >= \
        out["samples_on"]
    assert out["sample_us"] > 0 and out["default_interval_s"] == 10.0
    assert 0 < out["default_share"] < 0.02
    assert set(out) >= {"cost_share", "net_of_gc_cost_share",
                        "spread_share", "walls_s", "gc"}
    flips = iter(range(10))
    with pytest.raises(AssertionError):
        chip_smoke.sampler_passes(lambda: next(flips))


def test_soak_lead_up_record_carries_the_time_series(tmp_path,
                                                     monkeypatch):
    """The routed soak's forced record: its header's timeseries window
    holds the curated series, the routed rate of a window after the
    soak's start above 0."""
    from tpu_ir_torch import obs
    from tpu_ir_torch.obs import timeseries

    obs.reset_all()
    monkeypatch.setenv("TPU_IR_FLIGHT_DIR", str(tmp_path))
    store = timeseries.get_store()
    store.sample()
    since = time.time()
    with obs.trace("request"):
        obs.get_registry().incr("router.requests", 5)
    time.sleep(0.01)
    store.sample()
    report = {k: 0 for k in ("submitted", "served", "shed", "errors",
                             "deadlocked", "full_mismatches",
                             "partial_mismatches")}
    out = chip_smoke.soak_lead_up_record(report, since)
    assert out["routed_per_s_max"] > 0
    assert "routed_per_s" in out["series"] and out["points"]["routed_per_s"]
    assert os.path.exists(tmp_path / out["path"])
    assert chip_smoke.soak_lead_up_record(report, time.time() + 60)[
        "routed_per_s_max"] == 0.0
    obs.reset_all()


def test_gc_pauses_and_collected_pass():
    """A full collection inside the block is counted with its seconds;
    collected_pass returns the run's result, its wall and the pauses;
    arm_summary's medians net of the pauses subtract each pass's own."""
    import gc

    with chip_smoke.gc_pauses() as pause:
        gc.collect()
    assert pause["count"] >= 1 and pause["full"] >= 1 and pause["s"] > 0
    got, wall, pause = chip_smoke.collected_pass(lambda: [7])
    assert got == [7] and wall >= 0 and pause["full"] == 0
    walls = {"a": [1.0, 3.0, 2.0]}
    pauses = {"a": [{"s": 0.0, "full": 0, "count": 0},
                    {"s": 2.0, "full": 1, "count": 1},
                    {"s": 0.5, "full": 0, "count": 2}]}
    out = chip_smoke.arm_summary(walls, pauses)
    assert out["median_s"]["a"] == 2.0 and out["spread_s"]["a"] == 2.0
    assert out["net_of_gc_median_s"]["a"] == 1.0
    assert out["gc"]["a"][1] == {"s": 2.0, "full": 1, "count": 1}


def test_profiler_shim_cost_captures_outermost_calls():
    """The shim's cost is timed at the captured arguments of the
    outermost profiled calls only (a nested one is the outer one's), one
    row a signature with its calls, and the profiler's ledger gains no
    cold call from the timing."""
    from tpu_ir_torch.obs import profiling

    inner = profiling.profiled(lambda x: x + 1, label="shim_inner")
    outer = profiling.profiled(lambda x, n=0: inner(x), label="shim_outer")

    def run():
        outer(torch.zeros(2), n=1)
        outer(torch.zeros(2), n=1)
        outer(torch.zeros(4, dtype=torch.int32))

    run()
    before = profiling.compile_cache_snapshot()["compiles"]
    out = chip_smoke.profiler_shim_cost(run)
    assert out["calls_a_pass"] == 3
    rows = {r["signature"]: r for r in out["signatures"]}
    assert set(rows) == {"float32[2], n=1", "int32[4]"}
    assert rows["float32[2], n=1"]["calls"] == 2
    assert {r["label"] for r in out["signatures"]} == {"shim_outer"}
    assert all(r["key_us"] > 0 for r in out["signatures"])
    assert out["sample_memory_us"] > 0 and out["shim_ms_a_pass"] > 0
    assert profiling.compile_cache_snapshot()["compiles"] == before


def test_dispatch_ab_refuses_without_cuda():
    """The A/B mode needs the card like the full run: without CUDA it
    exits nonzero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py", "--dispatch-ab",
                        os.path.join(ROOT, "build", "no-index")], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_dispatch_ablation_arms_on_cpu(tmp_path, monkeypatch):
    """--ablate's parts on the CPU: each arm of ablation() (span, memory
    sample and wrappers swapped out or kept) gives the bits of the
    shipped path through a coalescing frontend; the meter wraps the
    shipped _blocked_dispatch and counts each dispatch with its wall and
    its thread's CPU time; the shipped method, the span, the sample and
    the wrappers come back."""
    from tpu_ir_torch import obs
    from tpu_ir_torch.obs import profiling
    from tpu_ir_torch.ops import scoring as ops_scoring
    from tpu_ir_torch.search import Scorer
    from tpu_ir_torch.search import scorer as scorer_mod
    from tpu_ir_torch.serving import ServingConfig, ServingFrontend

    obs.reset_all()
    monkeypatch.setattr(chip_smoke, "WIKI_CORPUS", dict(
        n_docs=200, target_bytes=200_000, vocab_size=2_000))
    _, idx = chip_smoke.phase_build("cpu", str(tmp_path), device="cpu",
                                    config="wiki100k")
    dense = Scorer.load(idx, layout="dense", device="cpu")
    fe = ServingFrontend(dense, ServingConfig(max_concurrency=4,
                                              max_queue=8, coalesce=True))
    texts = [" ".join(dense.vocab.terms[i:i + 2]) for i in range(0, 48, 2)]

    def loop():
        return chip_smoke.closed_loop(fe, texts, 4, scoring="bm25", k=10)

    want = loop()
    shipped = Scorer.__dict__["_blocked_dispatch"]
    wrapped = ops_scoring.bm25_topk_dense
    real_trace, real_sample = scorer_mod.obs_trace, profiling.sample_memory
    samples = []
    monkeypatch.setattr(profiling, "sample_memory",
                        lambda *a, **kw: samples.append(1))
    meter = chip_smoke.DispatchMeter()
    meter.install(Scorer)
    assert Scorer.__dict__["_blocked_dispatch"] is not shipped
    try:
        for arm in chip_smoke.ABLATION_ARMS:
            span = arm not in ("no_span", "bare")
            sample = arm not in ("no_sample", "bare")
            unwrap = arm in ("unwrapped", "bare")
            with chip_smoke.ablation(arm) as n:
                assert (n >= 18) == unwrap and (n == 0) != unwrap
                assert isinstance(ops_scoring.bm25_topk_dense,
                                  profiling.Profiled) != unwrap
                assert (scorer_mod.bm25_topk_dense
                        is wrapped.__wrapped__) == unwrap
                before = obs.get_registry().histogram(
                    "dispatch.device").state()[0]
                del samples[:]
                assert loop() == want
                took = meter.take()
                assert took["dispatches"] >= 1
                assert took["wall_ms"] >= took["cpu_ms"] >= 0
                assert took["off_cpu_ms"] == pytest.approx(
                    took["wall_ms"] - took["cpu_ms"])
                after = obs.get_registry().histogram(
                    "dispatch.device").state()[0]
                assert (sum(after) > sum(before)) == span, arm
                assert bool(samples) == sample, arm
                assert meter.take()["dispatches"] == 0
            assert scorer_mod.obs_trace is real_trace
            assert ops_scoring.bm25_topk_dense is wrapped
    finally:
        meter.uninstall(Scorer)
    monkeypatch.setattr(profiling, "sample_memory", real_sample)
    assert Scorer.__dict__["_blocked_dispatch"].__func__ is shipped.__func__
    assert loop() == want
    assert set(chip_smoke.ABLATION_ARMS) == {
        "on", "off", "no_span", "no_sample", "unwrapped", "bare"}
    assert not hasattr(chip_smoke, "ablated_dispatch")
    obs.reset_all()


def test_dispatch_ablation_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py", "--dispatch-ab",
                        os.path.join(ROOT, "build", "no-index"),
                        "--ablate"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_pool_ablation_pools_processes_by_tree_and_arm(tmp_path):
    """--dispatch-ab-pool over two processes a tree: passes pooled by
    arm, the processes' medians' spread, the meter's medians, each arm
    over the first tree's arm in the same place."""
    def line(label, arms, walls, off_us):
        meter = {"dispatches": 10, "wall_ms": 100.0, "cpu_ms": 40.0,
                 "off_cpu_ms": 60.0, "off_cpu_us_a_dispatch": off_us}
        return {"dispatch_ab": label, "loop": {
            "walls_s": {a: list(walls) for a in arms},
            "meter": {a: [meter] * len(walls) for a in arms}}}

    paths = []
    for i, (label, arms, walls) in enumerate([
            ("parent", ("plain_0", "plain_1"), (1.0, 1.0, 1.2)),
            ("change", ("on", "off"), (1.1, 1.1, 1.3)),
            ("parent", ("plain_0", "plain_1"), (0.8, 0.8, 1.0)),
            ("change", ("on", "off"), (0.9, 0.9, 1.1))]):
        path = tmp_path / f"{i}.json"
        path.write_text("noise\n" + json.dumps(line(label, arms, walls,
                                                     6000.0)))
        paths.append(str(path))
    out = chip_smoke.pool_ablation(paths)
    assert list(out) == ["parent", "change"]
    on = out["change"]["arms"]["on"]
    assert out["change"]["processes"] == 2 and on["passes"] == 6
    assert on["median_s"] == pytest.approx(1.1)       # six passes pooled
    assert on["process_median_spread_s"] == pytest.approx(0.2)
    assert on["over_parent"] == pytest.approx(0.1)
    assert out["parent"]["arms"]["plain_1"]["over_parent"] == 0.0
    assert on["off_cpu_share"] == pytest.approx(0.6)
    assert on["cpu_ms_a_pass"] == 40.0 and on["dispatches_a_pass"] == 10.0
