"""Format v1 (npz parts) in the port against the JAX package: under
TPU_IR_FORMAT_VERSION=1 both builds write tpu_ir's bytes; migrate-index
walks v1 <-> v2 byte for byte, drops the stale twin a crash leaves, and
refuses a corrupt source; verify passes on a half-migrated dir; a v1
index serves bitwise what its v2 twin serves (tests/test_arena.py:136-300
are the JAX package's counterparts).

Every comparison here is exact: file bytes, or docnos and float32 score
bits within the port."""

import filecmp
import json
import os
import shutil

import pytest

from tpu_ir.index import build_index as jax_build_index

from tpu_ir_torch.cli import main as cli_main
from tpu_ir_torch.index import build_index, build_index_streaming
from tpu_ir_torch.index import format as fmt
from tpu_ir_torch.index.migrate import migrate_index
from tpu_ir_torch.index.verify import verify_index
from tpu_ir_torch.search import Scorer

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CORPUS = os.path.join(ROOT, "data", "stdlib", "corpus.trec")
SHARDS = 3
QUERIES = ["heap queue", "sort a list", "thread lock timeout", "json",
           "regular expression match", "qqqqzzzz"]


def artifacts(d):
    return sorted(n for n in os.listdir(d)
                  if n != fmt.JOBS_DIR and not n.startswith(".")
                  and not n.startswith("serving-"))


def assert_identical(got, want):
    assert artifacts(got) == artifacts(want)
    for n in artifacts(want):
        assert filecmp.cmp(os.path.join(got, n), os.path.join(want, n),
                           shallow=False), n


def results(d, layout="dense"):
    s = Scorer.load(d, layout=layout, device="cpu")
    return [[(k, float(v).hex()) for k, v in r]
            for sc in ("tfidf", "bm25")
            for r in s.search_batch(QUERIES, scoring=sc)]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """tpu_ir's v1 build, the port's v1 and v2 builds (no char-grams: the
    parts, not the char-gram npz files, are what v1 changes)."""
    d = tmp_path_factory.mktemp("v1")
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_IR_FORMAT_VERSION", "1")
    try:
        jax_build_index(CORPUS, str(d / "jax1"), num_shards=SHARDS,
                        compute_chargrams=False)
        build_index(CORPUS, str(d / "v1"), num_shards=SHARDS,
                    compute_chargrams=False, device="cpu")
    finally:
        mp.undo()
    build_index(CORPUS, str(d / "v2"), num_shards=SHARDS,
                compute_chargrams=False, device="cpu")
    return {n: str(d / n) for n in ("jax1", "v1", "v2")}


@pytest.fixture
def v1_copy(built, tmp_path):
    d = str(tmp_path / "idx")
    shutil.copytree(built["v1"], d)
    return d


def test_v1_parts_byte_identical_to_jax(built, tmp_path, monkeypatch):
    assert fmt.IndexMetadata.load(built["v1"]).format_version == 1
    assert os.path.exists(os.path.join(built["v1"], "part-00000.npz"))
    assert_identical(built["v1"], built["jax1"])
    # the streaming build honours the pin too
    monkeypatch.setenv("TPU_IR_FORMAT_VERSION", "1")
    s = str(tmp_path / "s")
    build_index_streaming(CORPUS, s, num_shards=SHARDS, batch_docs=50,
                          compute_chargrams=False, device="cpu")
    assert_identical(s, built["jax1"])


def test_format_pin_rejects_other_values(tmp_path, monkeypatch):
    # tpu_ir's declaration: 1 or 2; anything else raises, never falls back
    monkeypatch.setenv("TPU_IR_FORMAT_VERSION", "3")
    with pytest.raises(ValueError, match="TPU_IR_FORMAT_VERSION"):
        fmt.resolve_format_version()
    monkeypatch.setenv("TPU_IR_FORMAT_VERSION", "")
    assert fmt.resolve_format_version() == fmt.ARENA_FORMAT_VERSION
    assert fmt.resolve_format_version(1) == fmt.FORMAT_VERSION


def test_v1_v2_scorer_parity(built):
    assert verify_index(built["v1"])["ok"]
    assert verify_index(built["v1"])["format_version"] == 1
    for layout in ("dense", "sparse"):
        assert results(built["v1"], layout) == results(built["v2"], layout)


def test_migrate_roundtrip_byte_for_byte(built, v1_copy, capsys):
    idx = v1_copy
    assert cli_main(["migrate-index", idx]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] and out["migrated"] == SHARDS and out["skipped"] == 0
    assert_identical(idx, built["v2"])
    # idempotent: a second run skips every shard
    assert cli_main(["migrate-index", idx]) == 0
    assert json.loads(capsys.readouterr().out)["skipped"] == SHARDS
    # rollback: --to 1 gives tpu_ir's v1 bytes again
    assert cli_main(["migrate-index", idx, "--to", "1"]) == 0
    assert json.loads(capsys.readouterr().out)["migrated"] == SHARDS
    assert_identical(idx, built["jax1"])
    assert verify_index(idx)["ok"]


def test_migrate_refuses_corrupt_source(v1_copy):
    part = os.path.join(v1_copy, "part-00001.npz")
    size = os.path.getsize(part)
    with open(part, "r+b") as f:
        f.seek(size // 2)
        byte = f.read(1)
        f.seek(size // 2)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(fmt.IntegrityError) as ei:
        migrate_index(v1_copy)
    assert "part-00001" in ei.value.path
    assert fmt.IndexMetadata.load(v1_copy).format_version == 1


def _convert_shard0(idx):
    """Migration's per-shard step for shard 0 only: the arena written and
    the npz unlinked, the metadata not rewritten."""
    meta = fmt.IndexMetadata.load(idx)
    z = fmt.load_shard_verified(idx, 0, meta)
    fmt.save_shard(idx, 0, term_ids=z["term_ids"], indptr=z["indptr"],
                   pair_doc=z["pair_doc"], pair_tf=z["pair_tf"],
                   df=z["df"], format_version=2)
    return z


def test_verify_passes_on_interrupted_migration(built, v1_copy):
    idx = v1_copy
    want = results(idx)
    z = _convert_shard0(idx)
    assert not os.path.exists(os.path.join(idx, "part-00000.npz"))
    assert "part-00000.npz" in fmt.IndexMetadata.load(idx).checksums
    assert verify_index(idx)["ok"]      # the twin verified by its own CRCs
    # a rotted twin is caught by that check (a byte inside a section)
    arena = os.path.join(idx, "part-00000.arena")
    header, data_start = fmt.arena_file_header(arena)
    sec = next(s for s in header["sections"] if s["nbytes"] > 0)
    with open(arena, "r+b") as f:
        f.seek(data_start + sec["offset"])
        byte = f.read(1)
        f.seek(data_start + sec["offset"])
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(fmt.IntegrityError):
        verify_index(idx)
    fmt.save_shard(idx, 0, term_ids=z["term_ids"], indptr=z["indptr"],
                   pair_doc=z["pair_doc"], pair_tf=z["pair_tf"],
                   df=z["df"], format_version=2)
    out = migrate_index(idx)
    assert out["migrated"] == SHARDS - 1 and out["skipped"] == 1
    assert_identical(idx, built["v2"])
    assert results(idx) == want
    # with no twin either, the missing part is reported
    os.remove(fmt.part_path(idx, 1))
    with pytest.raises(fmt.IntegrityError, match="missing"):
        verify_index(idx)


def test_migrate_rerun_drops_stale_twin(built, v1_copy, tmp_path):
    idx = v1_copy
    npz = os.path.join(idx, "part-00000.npz")
    shutil.copyfile(npz, str(tmp_path / "keep.npz"))
    _convert_shard0(idx)                     # unlinks the npz ...
    shutil.copyfile(str(tmp_path / "keep.npz"), npz)   # ... a crash's twin
    out = migrate_index(idx)
    assert out["migrated"] == SHARDS - 1 and out["skipped"] == 1
    assert not os.path.exists(npz)
    meta = fmt.IndexMetadata.load(idx)
    assert "part-00000.npz" not in meta.checksums
    assert "part-00000.arena" in meta.checksums
    assert_identical(idx, built["v2"])
