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
    serve = chip_smoke.phase_serve("cpu", idx, device="cpu")
    assert serve["recall_at_10"] == 1.0
    assert serve["oracle_max_rel_err"] <= chip_smoke.ORACLE_RTOL
    assert serve["layout"] == "dense"
    assert serve["launches"] == {"dense_score": 0}  # CPU: the plain twin
    json.dumps(serve)


def test_oracle_topk_orders_ties_by_docno():
    import numpy as np

    df = np.array([2, 1], np.int32)
    pair_doc = np.array([3, 1, 2], np.int32)
    pair_tf = np.array([1, 1, 1], np.int32)
    top, scores = chip_smoke.oracle_topk(np.array([0, -1], np.int32), df,
                                         pair_doc, pair_tf, num_docs=4, k=10)
    assert top == [1, 3] and scores[1] == scores[3] > 0
