"""The port's index merge against the JAX package: indexes built and
merged by the port are byte for byte tpu_ir's one-shot build over the
concatenated corpus, at k = 1 and k = 2 with and without char-grams, with
positions and with the document store, from mixed streaming and one-shot
sources and from a compressed (v3) source; single-source resharding; the
guards; `tpu-ir-torch merge` (tests/test_merge.py and
tests/test_positions.py are the JAX package's counterparts).

Every comparison is exact: file bytes, or docnos and float32 score bits
within the port."""

import filecmp
import json
import os

import pytest

from tpu_ir.index import build_index as jax_build_index
from tpu_ir.index.docstore import build_docstore as jax_build_docstore

from tpu_ir_torch.cli import main as cli_main
from tpu_ir_torch.corpus import make_corpus
from tpu_ir_torch.index import build_index, build_index_streaming
from tpu_ir_torch.index import format as fmt
from tpu_ir_torch.index import merge_indexes
from tpu_ir_torch.index.docstore import build_docstore
from tpu_ir_torch.index.migrate import migrate_index
from tpu_ir_torch.index.verify import verify_index
from tpu_ir_torch.search import Scorer

DOCS_A = {
    "AP-0001": "The quick brown fox jumps over the lazy dog.",
    "AP-0002": "A quick quick quick fox. The dog sleeps soundly.",
    "ZF-077": "Honey prices rose as bears raided apiaries near the river.",
}
DOCS_B = {
    "FT-0003": "Stock markets fell sharply as investors fled risky assets.",
    "WSJ-9.2": "Salmon fishing season opened; fishermen crowded the rivers.",
    "AP-0010": "Brown bears eat honey. Bears love rivers and salmon fishing.",
}


def write_corpus(path, docs):
    path.write_text("".join(
        f"<DOC>\n<DOCNO> {d} </DOCNO>\n<TEXT>\n{t}\n</TEXT>\n</DOC>\n"
        for d, t in docs.items()))
    return str(path)


def artifacts(d):
    return sorted(n for n in os.listdir(d)
                  if n != fmt.JOBS_DIR and not n.startswith(".")
                  and not n.startswith("serving-"))


def assert_identical(got, want):
    assert artifacts(got) == artifacts(want)
    for n in artifacts(want):
        assert filecmp.cmp(os.path.join(got, n), os.path.join(want, n),
                           shallow=False), n


def result_bits(d, queries):
    s = Scorer.load(d, device="cpu")
    return [[(k, float(v).hex()) for k, v in r]
            for sc in ("tfidf", "bm25")
            for r in s.search_batch(queries, scoring=sc)]


@pytest.fixture(scope="module")
def halves(tmp_path_factory):
    """A 160-doc ASCII corpus cut at a document boundary into two files
    whose concatenation is the whole."""
    d = tmp_path_factory.mktemp("halves")
    whole = str(d / "all.trec")
    make_corpus(whole, seed=3, n_docs=160, target_bytes=120_000,
                vocab_size=1_500)
    text = open(whole).read()
    cut = text.index("<DOC>", len(text) // 2)
    (d / "a.trec").write_text(text[:cut])
    (d / "b.trec").write_text(text[cut:])
    return str(d / "a.trec"), str(d / "b.trec"), whole


@pytest.mark.parametrize("k,chargrams", [(1, [2, 3]), (1, None),
                                         (2, [2]), (2, None)])
def test_merge_equals_jax_one_shot(tmp_path, k, chargrams):
    ca = write_corpus(tmp_path / "a.trec", DOCS_A)
    cb = write_corpus(tmp_path / "b.trec", DOCS_B)
    both = write_corpus(tmp_path / "both.trec", {**DOCS_A, **DOCS_B})
    kw = (dict(chargram_ks=chargrams) if chargrams
          else dict(compute_chargrams=False))
    ia, ib = str(tmp_path / "ia"), str(tmp_path / "ib")
    build_index([ca], ia, k=k, num_shards=3, device="cpu", **kw)
    build_index([cb], ib, k=k, num_shards=2, device="cpu", **kw)
    want = str(tmp_path / "jax")
    jax_build_index([both], want, k=k, num_shards=4, **kw)
    merged = str(tmp_path / "merged")
    meta = merge_indexes([ia, ib], merged, num_shards=4, device="cpu")
    assert meta.num_docs == len(DOCS_A) + len(DOCS_B)
    assert verify_index(merged)["ok"]
    assert_identical(merged, want)
    if k == 2 and chargrams:
        assert os.path.exists(os.path.join(merged, "tokens.txt"))


def test_merge_carries_positions_and_refuses_a_mixed_merge(halves,
                                                           tmp_path):
    a, b, whole = halves
    ia, ib = str(tmp_path / "ia"), str(tmp_path / "ib")
    build_index([a], ia, num_shards=3, positions=True, device="cpu")
    build_index_streaming([b], ib, num_shards=2, positions=True,
                          batch_docs=30, device="cpu")
    want = str(tmp_path / "jax")
    jax_build_index([whole], want, num_shards=4, positions=True)
    merged = str(tmp_path / "merged")
    meta = merge_indexes([ia, ib], merged, num_shards=4, device="cpu")
    assert meta.has_positions and meta.version == 2
    assert verify_index(merged)["has_positions"]
    assert_identical(merged, want)
    # a source without positions: refused before any artifact is written
    ic = str(tmp_path / "ic")
    build_index([b], ic, num_shards=2, device="cpu")
    out = str(tmp_path / "mixed")
    with pytest.raises(ValueError, match="positions"):
        merge_indexes([ia, ic], out, device="cpu")
    assert not os.path.exists(out)


def test_merge_carries_the_store_from_mixed_sources(halves, tmp_path):
    """One source one-shot with its store built by a corpus pass, the
    other streaming with the store from its spills: the merged store is
    the concatenated corpus's, byte for byte, and so is everything
    else."""
    a, b, whole = halves
    ia, ib = str(tmp_path / "ia"), str(tmp_path / "ib")
    build_index([a], ia, num_shards=3, device="cpu")
    build_docstore([a], ia)
    build_index_streaming([b], ib, num_shards=2, store=True,
                          batch_docs=30, device="cpu")
    want = str(tmp_path / "jax")
    jax_build_index([whole], want, num_shards=4)
    jax_build_docstore([whole], want)
    merged = str(tmp_path / "merged")
    merge_indexes([ia, ib], merged, num_shards=4, device="cpu")
    assert "docstore.bin" in artifacts(merged)
    assert_identical(merged, want)
    # one source with a store and one without: refused up front
    ic = str(tmp_path / "ic")
    build_index([b], ic, num_shards=2, device="cpu")
    with pytest.raises(ValueError, match="document store"):
        merge_indexes([ia, ic], str(tmp_path / "mixed"), device="cpu")


def test_merge_decodes_a_compressed_source(halves, tmp_path):
    a, b, whole = halves
    ia, ib = str(tmp_path / "ia"), str(tmp_path / "ib")
    build_index([a], ia, num_shards=3, device="cpu")
    build_index([b], ib, num_shards=2, device="cpu")
    migrate_index(ib, to_version=fmt.COMPRESSED_FORMAT_VERSION)
    assert os.path.exists(os.path.join(ib, "part-00000.carena"))
    want = str(tmp_path / "jax")
    jax_build_index([whole], want, num_shards=4)
    merged = str(tmp_path / "merged")
    merge_indexes([ia, ib], merged, num_shards=4, device="cpu")
    assert_identical(merged, want)


def test_single_source_reshard_and_serving(halves, tmp_path):
    """A one-source merge reshards; the merged index serves bitwise what
    a one-shot build into the same shard count serves."""
    _, _, whole = halves
    src, direct = str(tmp_path / "src"), str(tmp_path / "direct")
    build_index([whole], src, num_shards=2, device="cpu")
    build_index([whole], direct, num_shards=5, device="cpu")
    out = str(tmp_path / "out")
    merge_indexes([src], out, num_shards=5, device="cpu")
    assert_identical(out, direct)
    s = Scorer.load(direct, device="cpu")
    queries = [" ".join(s.vocab.terms[i] for i in (7 * j, 11 * j + 3))
               for j in range(1, 30)]
    assert result_bits(out, queries) == result_bits(direct, queries)


def test_merge_guards(tmp_path):
    ca = write_corpus(tmp_path / "a.trec", DOCS_A)
    cb = write_corpus(tmp_path / "b.trec", DOCS_B)
    ia, ib = str(tmp_path / "ia"), str(tmp_path / "ib")
    build_index([ca], ia, num_shards=2, compute_chargrams=False,
                device="cpu")
    build_index([cb], ib, num_shards=2, compute_chargrams=False,
                device="cpu")
    with pytest.raises(ValueError, match="share docids"):
        merge_indexes([ia, ia], str(tmp_path / "dup"), device="cpu")
    with pytest.raises(ValueError, match="must not be one of"):
        merge_indexes([ia, ib], ia, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        merge_indexes([], str(tmp_path / "none"), device="cpu")
    ik2 = str(tmp_path / "ik2")
    build_index([cb], ik2, k=2, num_shards=2, compute_chargrams=False,
                device="cpu")
    with pytest.raises(ValueError, match="different k"):
        merge_indexes([ia, ik2], str(tmp_path / "k"), device="cpu")
    # k > 1 char-grams need every source's tokens.txt
    ka, kb = str(tmp_path / "ka"), str(tmp_path / "kb")
    build_index([ca], ka, k=2, chargram_ks=[2], num_shards=2, device="cpu")
    build_index([cb], kb, k=2, chargram_ks=[2], num_shards=2, device="cpu")
    os.remove(os.path.join(kb, "tokens.txt"))
    with pytest.raises(ValueError, match="tokens.txt"):
        merge_indexes([ka, kb], str(tmp_path / "kg"), device="cpu")
    merge_indexes([ka, kb], str(tmp_path / "kg"), compute_chargrams=False,
                  device="cpu")
    # a stale output is returned as it is; overwrite rebuilds it
    out = str(tmp_path / "out")
    assert merge_indexes([ia], out, num_shards=2, device="cpu").num_docs == 3
    assert merge_indexes([ia, ib], out, num_shards=2,
                         device="cpu").num_docs == 3
    assert merge_indexes([ia, ib], out, num_shards=2, overwrite=True,
                         device="cpu").num_docs == 6


def test_merge_cli(tmp_path, capsys):
    ca = write_corpus(tmp_path / "a.trec", DOCS_A)
    cb = write_corpus(tmp_path / "b.trec", DOCS_B)
    both = write_corpus(tmp_path / "both.trec", {**DOCS_A, **DOCS_B})
    ia, ib = str(tmp_path / "ia"), str(tmp_path / "ib")
    for c, d in ((ca, ia), (cb, ib)):
        assert cli_main(["index", c, d, "--shards", "2",
                         "--device", "cpu"]) == 0
    capsys.readouterr()
    out = str(tmp_path / "m")
    assert cli_main(["merge", ia, ib, out, "--shards", "3",
                     "--device", "cpu"]) == 0
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["num_docs"] == 6 and meta["chargram_ks"] == [2, 3]
    want = str(tmp_path / "jax")
    jax_build_index([both], want, num_shards=3)
    assert_identical(out, want)
    assert cli_main(["merge", ia, ib, out, "--shards", "3", "--overwrite",
                     "--no-chargrams", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["chargram_ks"] == []
