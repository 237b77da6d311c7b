"""The port's analysis half of the build against the JAX package's: the
native tokenizer (its library built into the port's build dir, no
fallback without a compiler), the char-gram indexes, and the tokenizer
pool's spills against the serial tokenizer's. On the CPU, at a few
hundred documents."""

import filecmp
import gzip
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_ir_torch.index.streaming as streaming
from tpu_ir.analysis import native as jax_native
from tpu_ir.ops import chargram as jax_chargram
from tpu_ir_torch.analysis import native
from tpu_ir_torch.corpus import make_corpus
from tpu_ir_torch.index import build_index, build_index_streaming
from tpu_ir_torch.index import format as fmt
from tpu_ir_torch.ops import _build
from tpu_ir_torch.ops import chargram

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SHARDS = 3
STREAM = dict(num_shards=SHARDS, batch_docs=50)
# a record the C++ scanner hands to the Python analyzer
NON_ASCII = ("<DOC>\n<DOCNO> U-0001 </DOCNO>\n<TEXT>\nMüller's résumé: naïve "
             "café über 中文 queue heap\n</TEXT>\n</DOC>\n")


def write_corpus(path, seed=4, n_docs=240):
    make_corpus(str(path), seed=seed, n_docs=n_docs,
                target_bytes=n_docs * 1_000, vocab_size=2_500)
    with open(path, "a", encoding="utf-8") as f:
        f.write(NON_ASCII)
    return str(path)


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
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("build") / "corpus.trec")


# ---------------------------------------------------------------------------
# the native tokenizer
# ---------------------------------------------------------------------------


def test_native_tokenize_corpus_equals_jax(tmp_path, corpus):
    """docids, temp ids, lengths and vocab, with a non-ASCII record and a
    gzip file (both through the Python analyzer) merged in."""
    gz = str(tmp_path / "extra.trec.gz")
    with gzip.open(gz, "wt", encoding="utf-8") as f:
        f.write(NON_ASCII.replace("U-0001", "G-0001"))
    got = native.tokenize_corpus_native([corpus, gz])
    want = jax_native.tokenize_corpus_native([corpus, gz])
    assert got[0] == want[0] and "U-0001" in got[0] and "G-0001" in got[0]
    assert np.array_equal(got[1], want[1]) and got[1].dtype == np.int32
    assert np.array_equal(got[2], want[2]) and got[2].dtype == np.int64
    assert got[3] == want[3]
    text = open(corpus, encoding="utf-8").read()[:5_000]
    assert native.NativeAnalyzer().analyze(text) == \
        native.Analyzer().analyze(text)


def test_native_library_builds_into_the_port_build_dir(tmp_path,
                                                       monkeypatch):
    """The library is compiled from native/analyzer.cpp into the port's
    build dir, named by the source's digest; the JAX package's tracked
    native/analyzer.so is never written."""
    so = os.path.join(ROOT, "native", "analyzer.so")
    before = hashlib.sha256(open(so, "rb").read()).hexdigest()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(native, "_lib", None)
    lib = native.load_native()
    path = _build.host_lib_path(native.SOURCE)
    assert path.parent == tmp_path / "b" and path.exists()
    assert os.path.basename(lib._name) == path.name
    assert native.NativeAnalyzer().analyze("Running heaps") == ["run",
                                                                "heap"]
    assert hashlib.sha256(open(so, "rb").read()).hexdigest() == before
    assert _build.host_lib_path(native.SOURCE).name == \
        _build.host_lib_path(ROOT + "/native/analyzer.cpp").name


def test_native_build_without_gxx_raises(tmp_path, monkeypatch, corpus):
    """No compiler and no built library: the port raises; nothing falls
    back to the Python analyzer."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.make_analyzer()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build_index(corpus, str(tmp_path / "idx"), device="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.make_chunked_tokenizer([corpus])
    # the Python path runs only when asked for
    assert isinstance(native.make_analyzer(native=False), native.Analyzer)
    assert isinstance(native.make_chunked_tokenizer([corpus], native=False),
                      native.PyChunkedTokenizer)


# ---------------------------------------------------------------------------
# char-gram indexes
# ---------------------------------------------------------------------------

TERMS = sorted({"a", "ab", "abc", "abcd", "heap", "heapq", "queue", "über",
                "naïve", "café", "中文", "日本語の", "zz", "aaaaaaaaaa"})


@pytest.mark.parametrize("k", [1, 2, 3])
def test_chargram_device_path_equals_jax(k):
    tb, tl = chargram.pack_term_bytes(TERMS, k)
    want_tb, want_tl = jax_chargram.pack_term_bytes(TERMS, k)
    assert np.array_equal(tb, want_tb) and np.array_equal(tl, want_tl)
    got = chargram.build_chargram_index(torch.from_numpy(tb),
                                        torch.from_numpy(tl), k=k)
    want = jax_chargram.build_chargram_index(jnp.asarray(tb),
                                             jnp.asarray(tl), k=k)
    ng, ne = int(want.num_grams), int(want.num_entries)
    assert np.array_equal(got.gram_codes.numpy(),
                          np.asarray(want.gram_codes)[:ng])
    assert np.array_equal(got.indptr.numpy(), np.asarray(want.indptr)[:ng + 1])
    assert np.array_equal(got.term_ids.numpy(),
                          np.asarray(want.term_ids)[:ne])


@pytest.mark.parametrize("k", [4, 7])
def test_chargram_host_path_equals_jax(k):
    tb, tl = chargram.pack_term_bytes(TERMS, k)
    got = chargram.build_chargram_index_host(tb, tl, k=k)
    want = jax_chargram.build_chargram_index_host(tb, tl, k=k)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert chargram.gram_to_code("über"[:2], 3) == \
        jax_chargram.gram_to_code("über"[:2], 3)
    assert chargram.code_to_gram(chargram.gram_to_code("heap", 4), 4) == \
        "heap"


def test_chargram_k_limits():
    tb, tl = chargram.pack_term_bytes(TERMS, 8)
    with pytest.raises(ValueError, match="1<=k<=7"):
        chargram.build_chargram_index_host(tb, tl, k=8)
    with pytest.raises(ValueError, match="1<=k<=3"):
        chargram.build_chargram_index(torch.from_numpy(tb),
                                      torch.from_numpy(tl), k=4)


# ---------------------------------------------------------------------------
# the tokenizer pool
# ---------------------------------------------------------------------------


def test_tokenizer_pool_spills_equal_serial(tmp_path, monkeypatch, corpus):
    """TPU_IR_TOKENIZE_PROCS=2 against the serial Python tokenizer: every
    spill and artifact the same bytes, and the artifacts the native
    tokenizer's."""
    real = native.make_chunked_tokenizer
    monkeypatch.setattr(streaming, "make_chunked_tokenizer",
                        lambda *a, **kw: real(*a, **{**kw, "native": False,
                                                     "chunk_bytes": 20_000}))
    out = {}
    for procs in ("1", "2"):
        monkeypatch.setenv("TPU_IR_TOKENIZE_PROCS", procs)
        out[procs] = str(tmp_path / f"p{procs}")
        build_index_streaming(corpus, out[procs], radix_buckets=3,
                              keep_spills=True, device="cpu", **STREAM)
    spills = [os.path.join(d, streaming.SPILL_DIR) for d in out.values()]
    names = sorted(os.listdir(spills[0]))
    assert sum(n.startswith("rpairs-") for n in names) >= 3 * 2
    assert names == sorted(os.listdir(spills[1]))
    for n in names:
        assert filecmp.cmp(os.path.join(spills[0], n),
                           os.path.join(spills[1], n), shallow=False), n
    assert_identical(out["2"], out["1"])
    monkeypatch.undo()
    nat = str(tmp_path / "native")
    build_index_streaming(corpus, nat, radix_buckets=3, device="cpu",
                          **STREAM)
    assert_identical(out["1"], nat)


