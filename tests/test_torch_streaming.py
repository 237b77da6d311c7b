"""The port's streaming build: crash resume from every pass, the config
signature, bucket-scoped recovery from a corrupt spill, and the
bucket-segmented parts of TPU_IR_RADIX_PARTS (mirroring
tests/test_radix.py and tests/test_streaming_resume.py for the JAX
package). Everything runs on the CPU at a few hundred documents."""

import filecmp
import os

import numpy as np
import pytest

import tpu_ir.index.streaming as jax_streaming
import tpu_ir_torch.index.streaming as streaming
from tpu_ir_torch import faults
from tpu_ir_torch.analysis import native
from tpu_ir_torch.corpus import make_corpus
from tpu_ir_torch.index import build_index
from tpu_ir_torch.index import format as fmt
from tpu_ir_torch.index.blockmax import BLOCKMAX_ARENA
from tpu_ir_torch.index.streaming import build_index_streaming
from tpu_ir_torch.index.verify import verify_index
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.utils.report import recovery_counters

KW = dict(num_shards=3, batch_docs=40, device="cpu")
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


def count_tokenizer(monkeypatch) -> dict:
    """Count the streaming build's tokenizer constructions (4 KB chunks,
    so the corpus spans several batches)."""
    calls = {"n": 0}

    def counting(*a, **kw):
        calls["n"] += 1
        return _REAL_TOKENIZER(*a, **{**kw, "chunk_bytes": 4_000})

    monkeypatch.setattr(streaming, "make_chunked_tokenizer", counting)
    return calls


def count_reduces(monkeypatch) -> dict:
    calls = {"n": 0}
    real = streaming.build_postings_packed

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(streaming, "build_postings_packed", counting)
    return calls


def crash(site_rule, corpus, out, **kw):
    faults.install(faults.parse_plan(site_rule))
    try:
        with pytest.raises(faults.InjectedCrash):
            build_index_streaming(corpus, out, **{**KW, **kw})
    finally:
        faults.clear()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    corpus = str(d / "corpus.trec")
    make_corpus(corpus, seed=7, n_docs=200, target_bytes=200_000,
                vocab_size=2_000)
    want = str(d / "oneshot")
    build_index(corpus, want, num_shards=3, device="cpu")
    return corpus, want


@pytest.mark.parametrize("site,buckets,tokenized", [
    ("crash.pass1:once@2", 4, 1),     # no manifest yet: pass 1 again
    ("crash.pass2:once@2", 4, 0),
    ("crash.pass2:once@2", 0, 0),     # the legacy per-batch combine
    ("crash.pass3:once@2", 4, 0)])
def test_resume_after_crash_is_byte_identical(tmp_path, monkeypatch, ref,
                                              site, buckets, tokenized):
    corpus, want = ref
    out = str(tmp_path / "idx")
    count_tokenizer(monkeypatch)
    crash(site, corpus, out, radix_buckets=buckets)
    assert os.listdir(os.path.join(out, streaming.SPILL_DIR))
    calls = count_tokenizer(monkeypatch)
    reduces = count_reduces(monkeypatch)
    build_index_streaming(corpus, out, radix_buckets=buckets, **KW)
    assert calls["n"] == tokenized
    units = buckets or 5
    if site.startswith("crash.pass2"):
        # units 0 and 1 were spilled before the death: only the rest run
        assert reduces["n"] == units - 2
    if site.startswith("crash.pass3"):
        assert reduces["n"] == 0
    assert_identical(out, want)
    assert verify_index(out)["ok"]


@pytest.mark.parametrize("change", ["shards", "buckets", "radix_parts",
                                    "corpus"])
def test_changed_config_never_resumes(tmp_path, monkeypatch, ref, change):
    corpus, want = ref
    local = str(tmp_path / "corpus.trec")
    with open(corpus, "rb") as src, open(local, "wb") as dst:
        dst.write(src.read())
    out = str(tmp_path / "idx")
    crash("crash.pass3:once@1", local, out, radix_buckets=4)
    kw = dict(KW, radix_buckets=4)
    if change == "shards":
        kw["num_shards"] = 2
    elif change == "buckets":
        kw["radix_buckets"] = 8
    elif change == "radix_parts":
        kw["radix_parts"] = True
    else:
        with open(local, "ab") as f:
            f.write(b"<DOC>\n<DOCNO> EXTRA-1 </DOCNO>\nheap queue\n</DOC>\n")
    calls = count_tokenizer(monkeypatch)
    meta = build_index_streaming(local, out, **kw)
    assert calls["n"] == 1
    assert verify_index(out)["ok"]
    if change == "buckets":
        assert_identical(out, want)
    if change == "corpus":
        assert meta.num_docs == 201
    # k is in the signature too (k > 1 itself is a later slice)
    sig = streaming._config_sig([local], 1, 3, None, radix_buckets=4)
    assert not np.array_equal(
        sig, streaming._config_sig([local], 2, 3, None, radix_buckets=4))


def test_corrupt_bucket_pair_spill_recomputes_only_that_bucket(
        tmp_path, monkeypatch, ref):
    corpus, want = ref
    out = str(tmp_path / "idx")
    crash("crash.pass3:once@1", corpus, out, radix_buckets=5)
    victim = os.path.join(out, streaming.SPILL_DIR,
                          streaming.pair_spill_name(1, 2))
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    calls = count_tokenizer(monkeypatch)
    reduces = count_reduces(monkeypatch)
    before = recovery_counters().get("spill_integrity_discards")
    build_index_streaming(corpus, out, radix_buckets=5, **KW)
    assert calls["n"] == 0 and reduces["n"] == 1     # bucket 2 alone
    assert recovery_counters().get("spill_integrity_discards") == before + 1
    assert_identical(out, want)


def test_corrupt_rpairs_spill_discards_pass1(tmp_path, monkeypatch, ref):
    corpus, want = ref
    out = str(tmp_path / "idx")
    count_tokenizer(monkeypatch)
    crash("crash.pass2:once@1", corpus, out, radix_buckets=4)
    victim = os.path.join(out, streaming.SPILL_DIR,
                          streaming.radix_spill_name(2, 1))
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    calls = count_tokenizer(monkeypatch)
    build_index_streaming(corpus, out, radix_buckets=4, **KW)
    assert calls["n"] == 1
    assert_identical(out, want)


def test_radix_parts_layout(tmp_path, monkeypatch, ref):
    """TPU_IR_RADIX_PARTS=1: bucket-segmented parts that verify, bounds
    and top-10 equal to the canonical index's, and every artifact the JAX
    package's radix-parts build."""
    corpus, want = ref
    monkeypatch.setenv("TPU_IR_RADIX_PARTS", "1")
    out = str(tmp_path / "parts")
    build_index_streaming(corpus, out, radix_buckets=4, **KW)
    report = verify_index(out)
    assert report["ok"] and report["bucket_segmented_shards"] >= 1
    assert filecmp.cmp(os.path.join(out, BLOCKMAX_ARENA),
                       os.path.join(want, BLOCKMAX_ARENA), shallow=False)
    jax_dir = str(tmp_path / "jax")
    jax_streaming.build_index_streaming(corpus, jax_dir, radix_buckets=4,
                                        num_shards=3, batch_docs=40)
    assert_identical(out, jax_dir)
    got = Scorer.load(out, device="cpu")
    canon = Scorer.load(want, device="cpu")
    rng = np.random.default_rng(3)
    terms = canon.vocab.terms
    texts = [" ".join(terms[i] for i in rng.integers(0, len(terms), 2))
             for _ in range(40)]
    for scoring in ("tfidf", "bm25"):
        a = got.search_batch(texts, k=10, scoring=scoring)
        b = canon.search_batch(texts, k=10, scoring=scoring)
        for x, y in zip(a, b):
            assert [d for d, _ in x] == [d for d, _ in y]
            assert np.array_equal(np.float32([s for _, s in x]),
                                  np.float32([s for _, s in y]))


def test_spill_writes_retry_then_raise_build_error(tmp_path, ref):
    """An OSError on an atomic spill or part write is retried under
    SPILL_RETRY (the artifacts are unchanged); one that persists raises
    BuildError naming the file."""
    corpus, want = ref
    before = recovery_counters().get("retries")
    faults.install(faults.parse_plan("spill_write:first@2"))
    try:
        out = str(tmp_path / "idx")
        build_index_streaming(corpus, out, radix_buckets=2, **KW)
    finally:
        faults.clear()
    assert recovery_counters().get("retries") == before + 2
    assert_identical(out, want)
    faults.install(faults.parse_plan("spill_write@rpairs-:always"))
    try:
        with pytest.raises(faults.BuildError, match="write:rpairs-"):
            build_index_streaming(corpus, str(tmp_path / "bad"),
                                  radix_buckets=2, **KW)
    finally:
        faults.clear()
