"""The port's `doctor`, `bounds_report` and `inspect` against the JAX
package's on the same indexes.

`doctor_report` equals tpu_ir's dict, `index_dir` aside, on a raw, a
compressed (v3), a positions and a cached index; `bounds_report` equals
tpu_ir's with the bounds present, missing and stale; `inspect_path`'s
lines and the CLI's index-dir dump equal tpu_ir's line for line over
every artifact of a streaming positions build with its spills kept
(tests/test_inspect_artifacts.py is the JAX package's counterpart). Every
comparison is exact."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest

from tpu_ir.cli import main as jax_cli_main
from tpu_ir.index import blockmax as jbmx
from tpu_ir.index import format as jfmt
from tpu_ir.index.artifacts import inspect_path as jax_inspect_path
from tpu_ir.index.doctor import doctor_report as jax_doctor_report

from tpu_ir_torch.cli import main as cli_main
from tpu_ir_torch.index import blockmax as bmx
from tpu_ir_torch.index import build_index, build_index_streaming
from tpu_ir_torch.index import format as fmt
from tpu_ir_torch.index.artifacts import inspect_path
from tpu_ir_torch.index.doctor import doctor_report
from tpu_ir_torch.index.migrate import migrate_index
from tpu_ir_torch.search import Scorer

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CORPUS = os.path.join(ROOT, "data", "stdlib", "corpus.trec")
SHARDS = 3


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The stdlib corpus built by the port: raw, positions with the store
    and the streaming spills kept, and v3 and cached copies of the raw."""
    d = tmp_path_factory.mktemp("doctor")
    raw, pos = str(d / "raw"), str(d / "pos")
    build_index(CORPUS, raw, num_shards=SHARDS, device="cpu")
    build_index_streaming(CORPUS, pos, num_shards=SHARDS, positions=True,
                          store=True, batch_docs=50, keep_spills=True,
                          radix_buckets=0, device="cpu")
    v3, cached = str(d / "v3"), str(d / "cached")
    shutil.copytree(raw, v3)
    migrate_index(v3, to_version=fmt.COMPRESSED_FORMAT_VERSION)
    shutil.copytree(raw, cached)
    Scorer.load(cached, layout="sparse", device="cpu")
    return {"raw": raw, "pos": pos, "v3": v3, "cached": cached}


def _without_dir(report):
    return {k: v for k, v in report.items() if k != "index_dir"}


@pytest.mark.parametrize("kind", ["raw", "v3", "pos", "cached"])
def test_doctor_report_equals_jax(dirs, kind):
    got = doctor_report(dirs[kind], top_terms=7)
    want = jax_doctor_report(dirs[kind], top_terms=7)
    assert got["index_dir"] == want["index_dir"]
    assert _without_dir(got) == _without_dir(want)
    assert got["block_bounds"]["ok"] and got["block_bounds"]["bounds_exact"]
    if kind == "v3":
        assert got["compression"]["compressed_shards"] == SHARDS
    if kind == "cached":
        assert [c["cache"] for c in got["serving_caches"]] == [
            "serving-tiered"]


@pytest.mark.parametrize("case", ["present", "missing", "stale"])
def test_bounds_report_equals_jax(dirs, tmp_path, case):
    idx = str(tmp_path / "idx")
    shutil.copytree(dirs["raw"], idx,
                    ignore=shutil.ignore_patterns("serving-*"))
    path = os.path.join(idx, bmx.BLOCKMAX_ARENA)
    if case == "missing":
        os.remove(path)
    elif case == "stale":
        # bounds over another term set, checksums recorded again: stale,
        # not corrupt
        sec = {k: np.array(v) for k, v in fmt.load_arena(path).items()}
        fmt.write_arena(path, {"tids": sec["tids"][1:],
                               "max_tf": sec["max_tf"][1:],
                               "info": sec["info"]})
        fmt.IndexMetadata.load(idx).save_with_checksums(
            idx, block_bounds=False)
    got = bmx.bounds_report(idx, fmt.IndexMetadata.load(idx))
    want = jbmx.bounds_report(idx, jfmt.IndexMetadata.load(idx))
    assert got == want
    assert got["present"] == (case != "missing")
    if case == "stale":
        assert got["stale"] and not got["ok"]


def _artifact_paths(pos):
    spill = os.path.join(pos, "_spill")
    out = [os.path.join(pos, n) for n in sorted(os.listdir(pos))]
    out += [os.path.join(spill, n) for n in sorted(os.listdir(spill))]
    return out + [spill]


def test_inspect_path_equals_jax(dirs, tmp_path):
    pos = dirs["pos"]
    Scorer.load(pos, layout="sparse", device="cpu")   # a serving cache
    paths = _artifact_paths(pos) + [
        os.path.join(dirs["v3"], "part-00001.carena")]
    # a v1 part, an unknown npz and a corrupt one
    v1 = str(tmp_path / "v1")
    shutil.copytree(dirs["raw"], v1,
                    ignore=shutil.ignore_patterns("serving-*"))
    migrate_index(v1, to_version=fmt.FORMAT_VERSION)
    paths.append(os.path.join(v1, "part-00002.npz"))
    other = str(tmp_path / "other.npz")
    np.savez(other, a=np.arange(12).reshape(3, 4), b=np.array([1.5]))
    bad = str(tmp_path / "bad.npz")
    raw = open(paths[-1], "rb").read()
    open(bad, "wb").write(raw[: len(raw) // 2])
    paths += [other, bad]
    names = {os.path.basename(p) for p in paths}
    assert {"part-00000.arena", "positions-00000.npz", "docstore.bin",
            "serving-tiered", "pass1.npz", "_spill"} <= names
    for n in (3, 10):
        for p in paths:
            if os.path.isdir(p) and os.path.exists(
                    os.path.join(p, fmt.METADATA)):
                continue
            assert list(inspect_path(p, n=n)) == list(
                jax_inspect_path(p, n=n)), p


def _cli(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [["-n", "5"], ["-n", "3",
                                                "--postings", "2"],
                                  ["--term", "heap queue"],
                                  ["--term", "zzzzqx"]])
def test_inspect_cli_equals_jax(dirs, argv):
    for kind in ("raw", "v3"):
        want = _cli(jax_cli_main, ["inspect", dirs[kind], *argv,
                                   "--backend", "cpu"])
        assert _cli(cli_main, ["inspect", dirs[kind], *argv]) == want
    # any other path goes to the artifact dump; a missing one is an error
    for p in (os.path.join(dirs["raw"], "vocab.txt"),
              os.path.join(dirs["raw"], "nope.npz")):
        assert _cli(cli_main, ["inspect", p, "-n", "4"]) == _cli(
            jax_cli_main, ["inspect", p, "-n", "4", "--backend", "cpu"])


def test_doctor_cli_and_live_dir(dirs, tmp_path):
    rc, out, err = _cli(cli_main, ["doctor", dirs["raw"], "--top", "4"])
    assert rc == 0
    report = json.loads(out)
    assert len(report["df"]["top_terms"]) == 4
    assert err == "".join(f"doctor: warning: {w}\n"
                          for w in report["warnings"])
    assert out == _cli(jax_cli_main, ["doctor", dirs["raw"],
                                      "--top", "4"])[1]
    # a live dir is routed to the live report: this malformed one (an
    # empty live.json, no CURRENT) fails as tpu_ir's doctor fails on it,
    # through the library and the command line
    live = tmp_path / "live"
    (live / "generations").mkdir(parents=True)
    (live / "live.json").write_text("{}")
    with pytest.raises(FileNotFoundError) as got:
        doctor_report(str(live))
    with pytest.raises(FileNotFoundError) as want:
        jax_doctor_report(str(live))
    assert str(got.value) == str(want.value)
    assert got.value.filename == str(live / "CURRENT")
    rc, out, err = _cli(cli_main, ["doctor", str(live)])
    assert (rc, out, err) == _cli(jax_cli_main, ["doctor", str(live)])
    assert rc == 1 and "missing artifact" in err
    # a live dir with a generation gets tpu_ir's topology report
    from tpu_ir_torch.index.ingest import IngestWriter
    from tpu_ir_torch.index.segments import LiveIndex

    live = str(tmp_path / "live2")
    LiveIndex.create(live, num_shards=SHARDS, chargram_ks=())
    with IngestWriter(live, device="cpu") as w:
        w.add("D-1", "heap queue")
        w.add("D-2", "priority queue")
    report = doctor_report(live)
    assert report["live"] is True and report["segment_count"] == 1
    assert report == jax_doctor_report(live)
    rc, out, _ = _cli(cli_main, ["doctor", live])
    assert rc == 0 and json.loads(out) == report
