"""The port's builds against the JAX package's: every artifact of the
one-shot, streaming legacy, streaming radix, store and TPU_IR_COMPRESS=1
builds byte for byte, the dictionary, verify and the CLI. Everything runs
on the CPU at a few hundred documents (test_torch_native.py holds the
native tokenizer, the char-gram indexes and the tokenizer pool)."""

import filecmp
import json
import os

import numpy as np
import pytest

import tpu_ir.index.streaming as jax_streaming
import tpu_ir_torch.index.streaming as streaming
from tpu_ir.analysis import native as jax_native
from tpu_ir.index import build_index as jax_build_index
from tpu_ir.index.dictionary import lookup_term as jax_lookup_term
from tpu_ir.index.verify import verify_index as jax_verify_index
from tpu_ir_torch import faults
from tpu_ir_torch.analysis import native
from tpu_ir_torch.cli import main as cli_main
from tpu_ir_torch.corpus import make_corpus
from tpu_ir_torch.index import build_index, build_index_streaming
from tpu_ir_torch.index import format as fmt
from tpu_ir_torch.index.dictionary import lookup_term
from tpu_ir_torch.index.verify import verify_index

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SHARDS = 3
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


def small_chunks(monkeypatch, module, real):
    """4 KB tokenizer chunks, so a streaming build spans several
    batches."""
    monkeypatch.setattr(module, "make_chunked_tokenizer",
                        lambda *a, **kw: real(*a, **{**kw,
                                                     "chunk_bytes": 4_000}))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("build") / "corpus.trec")


# ---------------------------------------------------------------------------
# every artifact, byte for byte
# ---------------------------------------------------------------------------

STREAM = dict(num_shards=SHARDS, batch_docs=50)
BUILDS = {
    "oneshot": (lambda c, d: build_index(c, d, num_shards=SHARDS,
                                         device="cpu"),
                lambda c, d: jax_build_index(c, d, num_shards=SHARDS)),
    "legacy": (lambda c, d: build_index_streaming(
        c, d, radix_buckets=0, device="cpu", **STREAM),
        lambda c, d: jax_streaming.build_index_streaming(
            c, d, radix_buckets=0, **STREAM)),
    **{f"radix{b}": (
        lambda c, d, b=b: build_index_streaming(c, d, radix_buckets=b,
                                                device="cpu", **STREAM),
        lambda c, d, b=b: jax_streaming.build_index_streaming(
            c, d, radix_buckets=b, **STREAM)) for b in (1, 3, 16)},
    "store": (lambda c, d: build_index_streaming(
        c, d, radix_buckets=4, store=True, device="cpu", **STREAM),
        lambda c, d: jax_streaming.build_index_streaming(
            c, d, radix_buckets=4, store=True, **STREAM)),
    "compress": (lambda c, d: build_index(c, d, num_shards=SHARDS,
                                          device="cpu"),
                 lambda c, d: jax_build_index(c, d, num_shards=SHARDS)),
}


@pytest.mark.parametrize("case", list(BUILDS))
def test_artifacts_byte_identical_to_jax(tmp_path, monkeypatch, corpus,
                                         case):
    if case == "compress":
        monkeypatch.setenv("TPU_IR_COMPRESS", "1")
    small_chunks(monkeypatch, streaming, native.make_chunked_tokenizer)
    small_chunks(monkeypatch, jax_streaming,
                 jax_native.make_chunked_tokenizer)
    port, jax = BUILDS[case]
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    meta = port(corpus, got)
    jax(corpus, want)
    assert_identical(got, want)
    assert meta.chargram_ks == [2, 3] and meta.num_docs == 241
    names = artifact_names(got)
    if case == "store":
        assert {"docstore.bin", "docstore-idx.npz"} <= set(names)
    if case == "compress":
        assert meta.format_version == fmt.COMPRESSED_FORMAT_VERSION
        assert all(n.endswith(".carena") for n in names
                   if n.startswith("part-"))
    if case.startswith(("radix", "store", "legacy")):
        with open(os.path.join(got, "jobs",
                               "TermKGramDocIndexer.json")) as f:
            job = json.load(f)
        assert {"pass1_tokenize", "pass2_combine", "pass3_reduce",
                "chargrams"} <= set(job["timings_s"])
        spilled = job["counters"]["radix_spill_bytes"]
        assert (spilled > 0) == (case != "legacy")
        assert not os.path.exists(os.path.join(got, streaming.SPILL_DIR))


def test_streaming_equals_oneshot_and_docstore_reads(tmp_path, corpus):
    """Every build path writes the same index; the store returns each
    record's raw bytes by docno."""
    from tpu_ir_torch.collection import DocnoMapping, read_trec_corpus
    from tpu_ir_torch.index import docstore

    one, radix = str(tmp_path / "one"), str(tmp_path / "radix")
    build_index(corpus, one, num_shards=SHARDS, device="cpu")
    build_index_streaming(corpus, radix, store=True, device="cpu",
                          **STREAM)
    for n in artifact_names(one):
        assert filecmp.cmp(os.path.join(one, n), os.path.join(radix, n),
                           shallow=False), n
    assert docstore.consistent(radix)
    mapping = DocnoMapping.load(os.path.join(radix, fmt.DOCNOS))
    store = docstore.DocStore(radix)
    try:
        for doc in read_trec_corpus([corpus]):
            assert store.get(mapping.get_docno(doc.docid)) == doc.content
    finally:
        store.close()
    assert docstore.stats(radix)["docs"] == 241


# ---------------------------------------------------------------------------
# dictionary, verify, CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_index(tmp_path_factory, corpus):
    d = str(tmp_path_factory.mktemp("idx") / "idx")
    build_index(corpus, d, num_shards=SHARDS, device="cpu")
    return d


def test_lookup_term_equals_jax_for_every_term(port_index):
    """Every term through the dictionary (Dictionary.get_value, what
    lookup_term resolves each term with) against the JAX package's, and
    lookup_term itself on raw and analyzed input."""
    from tpu_ir.index.dictionary import Dictionary as JaxDictionary
    from tpu_ir_torch.collection import Vocab
    from tpu_ir_torch.index.dictionary import Dictionary

    got_d, want_d = Dictionary(port_index), JaxDictionary(port_index)
    terms = Vocab.load(os.path.join(port_index, fmt.VOCAB)).terms
    assert len(got_d) == len(want_d) == len(terms)
    for term in terms:
        got, want = got_d.get_value(term), want_d.get_value(term)
        assert got[:5] == tuple(want[:5])
        assert np.array_equal(got.postings, want.postings)
    for term in terms[:: max(len(terms) // 40, 1)]:
        (got,) = lookup_term(port_index, term, analyze=False)
        (want,) = jax_lookup_term(port_index, term, analyze=False)
        assert got[:5] == tuple(want[:5])
    text = "Heaps of queues, naïve café"
    got = lookup_term(port_index, text)
    want = jax_lookup_term(port_index, text)
    assert [h.term for h in got] == [h.term for h in want] and got
    assert lookup_term(port_index, "zzzzqx") == []


def test_verify_report_equals_jax_and_flags_a_flipped_byte(tmp_path,
                                                           port_index):
    import shutil

    assert verify_index(port_index) == jax_verify_index(port_index)
    bad = str(tmp_path / "bad")
    shutil.copytree(port_index, bad)
    part = os.path.join(bad, fmt.part_name(1))
    raw = bytearray(open(part, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    open(part, "wb").write(bytes(raw))
    with pytest.raises(faults.IntegrityError, match="part-00001"):
        verify_index(bad)
    assert isinstance(faults.IntegrityError("p", "d"), AssertionError)


def test_cli_streaming_index_verify_inspect(tmp_path, capsys):
    idx = str(tmp_path / "idx")
    corpus = os.path.join(ROOT, "data", "stdlib", "corpus.trec")
    assert cli_main(["index", corpus, idx, "--streaming", "--radix-buckets",
                     "4", "--store", "--shards", "2", "--device",
                     "cpu"]) == 0
    meta = json.loads(capsys.readouterr().out)
    assert meta["num_docs"] == 144 and meta["chargram_ks"] == [2, 3]
    assert meta["docstore"]["docs"] == 144
    assert cli_main(["verify", idx]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["num_docs"] == 144
    assert cli_main(["inspect", idx, "--term", "Heaps", "--postings",
                     "2"]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    assert line.startswith("part-0000") and "\theap\tdf=" in line
    assert cli_main(["inspect", idx, "--term", "zzzzqx"]) == 1
    # the one-shot CLI build with --store pays one corpus pass
    one = str(tmp_path / "one")
    assert cli_main(["index", corpus, one, "--no-chargrams", "--store",
                     "--shards", "2", "--device", "cpu"]) == 0
    meta = json.loads(capsys.readouterr().out)
    assert meta["chargram_ks"] == [] and meta["docstore"]["docs"] == 144
