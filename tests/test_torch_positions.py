"""Format v2 position runs in the port's builds, held against the JAX
package's on the in-repo stdlib corpus (144 documents): the artifacts,
positions-NNNNN.npz included, are byte-identical at k = 1 and k = 2 for
the one-shot build and for the legacy and radix-fallback streaming
builds, and after a crash and resume; verify rejects a corrupt positions
file as the JAX package's verify does; a lossy int8 compression of a
positions index is refused by both. Everything runs on the CPU."""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest

from tpu_ir.index import build_index as jax_build_index
from tpu_ir.index.migrate import migrate_index as jax_migrate
from tpu_ir.index.verify import verify_index as jax_verify

import tpu_ir_torch.index.streaming as streaming
from tpu_ir_torch import faults
from tpu_ir_torch.analysis import native
from tpu_ir_torch.index import build_index, build_index_streaming
from tpu_ir_torch.index import format as fmt
from tpu_ir_torch.index.compress import CompressError
from tpu_ir_torch.index.migrate import migrate_index
from tpu_ir_torch.index.positions import (
    PositionsReader,
    build_position_runs,
    positions_name,
)
from tpu_ir_torch.index.verify import verify_index

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CORPUS = os.path.join(ROOT, "data", "stdlib", "corpus.trec")
KW = dict(num_shards=2, compute_chargrams=False)
_REAL_TOKENIZER = native.make_chunked_tokenizer


def artifact_names(d):
    return sorted(n for n in os.listdir(d)
                  if not n.startswith((".", "_")) and n != fmt.JOBS_DIR)


def assert_identical(got_dir, want_dir):
    names = artifact_names(want_dir)
    assert artifact_names(got_dir) == names
    for n in names:
        assert filecmp.cmp(os.path.join(want_dir, n),
                           os.path.join(got_dir, n), shallow=False), n


@pytest.fixture(scope="module")
def jax_built(tmp_path_factory):
    """The JAX package's one-shot positions builds at k = 1 and k = 2."""
    d = tmp_path_factory.mktemp("jaxpos")
    out = {}
    for k in (1, 2):
        out[k] = str(d / f"k{k}")
        jax_build_index(CORPUS, out[k], k=k, positions=True, **KW)
    return out


def small_chunks(monkeypatch):
    """4 KB tokenizer chunks, so 40-doc batches span the corpus."""
    monkeypatch.setattr(
        streaming, "make_chunked_tokenizer",
        lambda *a, **kw: _REAL_TOKENIZER(*a, **{**kw, "chunk_bytes": 4_000}))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mode", ["oneshot", "legacy", "radix"])
def test_positions_byte_identical_to_jax(tmp_path, jax_built, caplog, k,
                                         mode):
    """Every artifact, the position runs included, is the JAX package's
    byte for byte; a radix request falls back to the per-batch pass 2
    with the JAX package's warning; verify reports what the JAX verify
    reports."""
    out = str(tmp_path / "idx")
    if mode == "oneshot":
        meta = build_index(CORPUS, out, k=k, positions=True, device="cpu",
                           **KW)
    else:
        meta = build_index_streaming(
            CORPUS, out, k=k, positions=True, batch_docs=40, device="cpu",
            radix_buckets=4 if mode == "radix" else 0, **KW)
        assert ("radix partitioning is unavailable with positions=True"
                in caplog.text) == (mode == "radix")
    assert meta.has_positions and meta.version == 2
    assert positions_name(1) in os.listdir(out)
    assert_identical(out, jax_built[k])
    assert verify_index(out) == jax_verify(out)


@pytest.mark.parametrize("site", ["crash.pass2:once@2", "crash.pass3:once@1",
                                  "corrupt_positions"])
def test_resume_after_crash_is_byte_identical(tmp_path, monkeypatch,
                                              jax_built, site):
    """A crash in pass 2 or 3 resumes to the JAX package's bytes; a
    positions file that rotted before the resume is quarantined and its
    shard rebuilt from the spills."""
    small_chunks(monkeypatch)
    out = str(tmp_path / "idx")
    kw = dict(KW, positions=True, batch_docs=40, radix_buckets=0,
              device="cpu")
    rule = "crash.pass3:once@1" if site == "corrupt_positions" else site
    faults.install(faults.parse_plan(rule))
    try:
        with pytest.raises(faults.InjectedCrash):
            build_index_streaming(CORPUS, out, **kw)
    finally:
        faults.clear()
    if site.startswith("crash.pass3") or site == "corrupt_positions":
        # shard 0 was finished: its positions file came before its part
        assert os.path.exists(os.path.join(out, positions_name(0)))
        assert os.path.exists(fmt.part_path(out, 0))
        assert not os.path.exists(os.path.join(out, positions_name(1)))
    if site == "corrupt_positions":
        p = os.path.join(out, positions_name(0))
        raw = bytearray(open(p, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(p, "wb").write(bytes(raw))
    meta = build_index_streaming(CORPUS, out, **kw)
    assert meta.has_positions
    assert_identical(out, jax_built[1])
    if site == "corrupt_positions":
        assert os.listdir(os.path.join(out, ".quarantine"))


def _rewrite_positions(d, mutate):
    """Rewrite shard 0's positions file through `mutate(indptr, delta)`
    and record the new checksums, so only the structure is wrong."""
    p = os.path.join(d, positions_name(0))
    with np.load(p) as z:
        indptr, delta = z["pos_indptr"].copy(), z["pos_delta"].copy()
    mutate(indptr, delta)
    fmt.savez_atomic(p, pos_indptr=indptr, pos_delta=delta)
    meta = fmt.IndexMetadata.load(d)
    meta.save_with_checksums(d)


def _zero_gap(indptr, delta):
    # the second position of the first run with tf >= 2 repeats the first
    lens = np.diff(indptr)
    r = int(np.flatnonzero(lens >= 2)[0])
    delta[indptr[r] + 1] = 0


def _beyond_doc(indptr, delta):
    delta[indptr[0]] = 10 ** 6


@pytest.mark.parametrize("case,match", [
    ("bytes", "positions-00000"),
    ("order", "not strictly ascending"),
    ("range", "beyond document length")])
def test_verify_rejects_corrupt_positions(tmp_path, jax_built, case, match):
    """A flipped byte fails the checksum (IntegrityError naming the
    file); a well-formed file with a repeated or out-of-range position
    fails the structural check. The JAX verify rejects the same copy."""
    d = str(tmp_path / "idx")
    shutil.copytree(jax_built[1], d)
    if case == "bytes":
        p = os.path.join(d, positions_name(0))
        raw = bytearray(open(p, "rb").read())
        raw[-30] ^= 0xFF
        open(p, "wb").write(bytes(raw))
    else:
        _rewrite_positions(d, _zero_gap if case == "order" else _beyond_doc)
    with pytest.raises(AssertionError, match=match):
        verify_index(d)
    with pytest.raises(AssertionError):
        jax_verify(d)


def test_int8_compression_refused_on_positions(tmp_path):
    """A shard with more than 256 distinct tfs cannot be int8 without
    loss, and a positions run's length must equal its tf: both packages
    refuse before touching a part; bf16 (lossless) goes through, with the
    JAX package's bytes."""
    corpus = str(tmp_path / "tf.trec")
    with open(corpus, "w") as f:
        for i in range(1, 301):
            f.write(f"<DOC>\n<DOCNO> D{i:04d} </DOCNO>\n<TEXT>\n"
                    + " ".join(["salmon"] * i) + " river\n</TEXT>\n</DOC>\n")
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    build_index(corpus, port, num_shards=1, positions=True,
                compute_chargrams=False, device="cpu")
    jax_build_index(corpus, jax, num_shards=1, positions=True,
                    compute_chargrams=False)
    before = open(fmt.part_path(port, 0), "rb").read()
    with pytest.raises(CompressError, match="positions"):
        migrate_index(port, to_version=3, tf_dtype="int8")
    with pytest.raises(ValueError, match="positions"):
        jax_migrate(jax, to_version=3, tf_dtype="int8")
    assert open(fmt.part_path(port, 0), "rb").read() == before
    assert migrate_index(port, to_version=3, tf_dtype="bf16")["migrated"] == 1
    jax_migrate(jax, to_version=3, tf_dtype="bf16")
    assert_identical(port, jax)
    assert json.load(open(os.path.join(port, fmt.METADATA)))[
        "has_positions"]
    assert verify_index(port)["ok"]


def test_position_runs_and_reader_match_a_scan(jax_built):
    """The runs decode back to each (term, doc)'s token positions: the
    reader's bulk path equals its per-row path, and a hand-made stream
    gives the (term asc, tf desc, doc asc) run order."""
    r = PositionsReader(jax_built[1])
    with np.load(os.path.join(jax_built[1], positions_name(1))) as z:
        n = len(z["pos_indptr"]) - 1
    rows = np.arange(0, n, 7)
    lens, pos = r.runs_concat(1, rows)
    want = [r.run(1, int(i)) for i in rows]
    assert lens.tolist() == [len(w) for w in want]
    assert pos.tolist() == [int(p) for w in want for p in w]
    # doc 1 holds term 0 twice and term 1 once; doc 2 term 0 once
    run_term, run_doc, run_tf, indptr, delta = build_position_runs(
        np.array([0, 1, 0, 0]), np.array([1, 1, 1, 2]),
        np.array([0, 1, 2, 0]))
    assert run_term.tolist() == [0, 0, 1]
    assert run_doc.tolist() == [1, 2, 1]
    assert run_tf.tolist() == [2, 1, 1]
    assert indptr.tolist() == [0, 2, 3, 4]
    assert delta.tolist() == [0, 2, 0, 1]
