"""chip_smoke.py's contract off the card: without CUDA, or outside the
repository, it exits nonzero and prints no result; its build and serve
phases run end to end on the CPU at a small size (the kernel phase needs
the card)."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


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
    assert radix["radix_spill_bytes"] > 0 and radix["peak_host_rss_bytes"] > 0
    assert out["builds"]["legacy"]["radix_spill_bytes"] == 0
    assert {"pass1_tokenize", "pass2_combine", "pass3_reduce", "docstore",
            "chargrams"} <= set(radix["timings_s"])
    assert out["verify"]["ok"] and out["identical_artifacts"] >= 10
    assert sorted(os.listdir(work)) == ["ref-idx", "wiki100k-radix"]
    assert ridx == os.path.join(work, "wiki100k-radix")
    json.dumps(out)


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
    _, wv3 = chip_smoke.phase_compress("cpu", widx, work, config="wiki100k")
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
    sweep = chip_smoke.phase_sweep("cpu", dense, config="ref", device="cpu")
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
    """Phases 19d and 19e exist and the docstring lists each by name."""
    for num, name in (("19d", "live"), ("19e", "live_crash")):
        assert callable(getattr(chip_smoke, f"phase_{name}"))
        assert f"\n{num}. {name} " in chip_smoke.__doc__


def test_live_phases_on_cpu(tmp_path, monkeypatch):
    """19d and 19e at a small size on the CPU: the seed through the
    command line, the delta with flushes and a merge, B == the one-shot
    build, the swap under probes with its gap, B bitwise the one-shot
    index, the operator checks; the backup and restore, the crash child
    SIGKILLed at its third flush, the recovery to the control's bytes
    and the dense serve of the recovered generation."""
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
    # ref (~2,200 terms x 201) dense, wiki100k (~3,300 x 301) tiered
    monkeypatch.setattr(scorer_mod, "DENSE_BUDGET", 600_000)
    work = str(tmp_path)
    make_corpus(os.path.join(work, "wiki100k.trec"), seed=0, n_docs=300,
                target_bytes=300_000, vocab_size=3_000)
    make_corpus(os.path.join(work, "ref.trec"), seed=0, n_docs=200,
                target_bytes=200_000, vocab_size=2_000)
    live = chip_smoke.phase_live("cpu", work, device="cpu")
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
        "cache_hit_plain", "preloaded_plain", "upload_coalesced"])
    for name, trial in trials.items():
        assert trial["probes"] > 0 and trial["swap_gap_ms"] > 0, name
        assert trial["wake_gap_ms"] > 0 and trial["reload_wall_s"] > 0, name
    assert trials["cache_hit_coalesced"]["part_opens"] == 0
    assert trials["cache_hit_plain"]["part_opens"] == 0
    assert trials["upload_coalesced"]["bytes"] > 0
    crash = chip_smoke.phase_live_crash("cpu", work, device="cpu")
    assert crash["restore_verified"] and crash["backup"]["bytes_linked"]
    assert crash["backup"]["wal_segments"] == 1
    assert crash["child_rc"] == -9 and crash["replayed"] >= 1
    assert crash["lease"]["taken_over"] and crash["lost_acked"] == 0
    assert 0 < crash["acked_ops"] < 60
    assert crash["identical_artifacts"] == live["identical_artifacts"]
    assert crash["bitwise_one_shot"]
    assert os.listdir(work) == []
    json.dumps([live, crash])
