"""The port's compressed (format v3) index against the JAX package's: the
codec's sections byte for byte, its numpy bf16 bit operations against
ml_dtypes, whole migrated indexes, serving a compressed index (bitwise
equal to the raw index inside the port, within rtol 1e-5 of the JAX
package's top-10), the bf16 rule, `migrate-index` on the command line, and
the numpy state hand-over of a compressed index.

Tolerance across packages: rtol 1e-5 (XLA and torch round logs and sums
differently in the last place); where two adjacent reference scores lie
within it, the doc ids are compared as a set. Inside the port, compressed
equals raw bitwise: docnos and float32 score bits."""

import filecmp
import json
import logging
import os
import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_ir.index import compress as jcomp
from tpu_ir.index import format as jfmt
from tpu_ir.index.migrate import migrate_index as jax_migrate
from tpu_ir.search import Scorer as JaxScorer
from tpu_ir.search.layout import build_tiered_layout as jax_build_tiered

from tpu_ir_torch.cli import main as cli_main
from tpu_ir_torch.convert import scorer_from_numpy, tiered_scorer_from_numpy
from tpu_ir_torch.corpus import make_corpus
from tpu_ir_torch.index import build_index
from tpu_ir_torch.index import compress as comp
from tpu_ir_torch.index import format as fmt
from tpu_ir_torch.index.migrate import migrate_index
from tpu_ir_torch.search import Scorer

RTOL = 1e-5
SHARDS = 3


def random_shard(rng, *, terms, num_docs, max_tf=9, wide_tfs=()):
    """A raw shard dict in the builders' canonical impact order; tfs up to
    max_tf, with the values of `wide_tfs` mixed in."""
    term_ids, df_l, docs_l, tfs_l = [], [], [], []
    wide = np.asarray(wide_tfs, np.int64)
    for t in range(terms):
        n = int(rng.integers(1, min(num_docs, 200)))
        d = np.sort(rng.choice(np.arange(1, num_docs + 1), size=n,
                               replace=False))
        tf = rng.integers(1, max_tf + 1, size=n)
        if len(wide):
            pick = rng.random(n) < 0.3
            tf[pick] = rng.choice(wide, int(pick.sum()))
        order = np.lexsort((d, -tf))
        term_ids.append(t * 3)
        df_l.append(n)
        docs_l.append(d[order])
        tfs_l.append(tf[order])
    df = np.array(df_l, np.int64)
    return {
        "term_ids": np.array(term_ids, np.int32),
        "df": df.astype(np.int32),
        "indptr": np.concatenate([[0], np.cumsum(df)]).astype(np.int64),
        "pair_doc": np.concatenate(docs_l).astype(np.int32),
        "pair_tf": np.concatenate(tfs_l).astype(np.int32),
    }


# shard kinds: small tfs; > 256 distinct tfs (int8 is lossy, auto picks
# bf16); tfs bf16 cannot hold (257, 1023, 100001: bf16 exceptions)
SHARD_KINDS = {
    "small": {},
    "wide": {"max_tf": 400},
    "bf16_exceptions": {"wide_tfs": (257, 1023, 100_001, 256, 512)},
}


def _assert_same_sections(got: dict, want: dict):
    assert list(got) == list(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("width", [64, 512])
@pytest.mark.parametrize("tf_dtype", ["int8", "bf16", "auto"])
@pytest.mark.parametrize("kind", sorted(SHARD_KINDS))
@pytest.mark.parametrize("seed", [0, 1])
def test_codec_matches_jax_bytes(seed, kind, tf_dtype, width):
    rng = np.random.default_rng(seed)
    num_docs = 500 + seed * 777
    z = random_shard(rng, terms=10 + seed * 7, num_docs=num_docs,
                     **SHARD_KINDS[kind])
    enc = comp.encode_shard(z, num_docs=num_docs, tf_dtype=tf_dtype,
                            block_width=width)
    want = jcomp.encode_shard(z, num_docs=num_docs, tf_dtype=tf_dtype,
                              block_width=width)
    _assert_same_sections(enc, want)
    info = comp.shard_info(enc)
    assert info == jcomp.shard_info(want)
    lossy = kind == "wide" and tf_dtype == "int8"
    assert info["tf_lossy"] == lossy
    if kind == "bf16_exceptions" and info["tf_dtype"] == "bf16":
        assert len(enc["ctf_exc_idx"]) > 0
    # the port decodes its own sections and the JAX package's alike
    dec = comp.decode_shard(enc)
    jdec = jcomp.decode_shard(want)
    for k in ("term_ids", "df", "indptr", "pair_doc", "pair_tf"):
        assert np.asarray(dec[k]).dtype == np.asarray(jdec[k]).dtype, k
        assert np.array_equal(dec[k], jdec[k]), k
        if not lossy:
            assert np.asarray(dec[k]).dtype == z[k].dtype, k
            assert np.array_equal(dec[k], z[k]), k


def test_codec_refuses_noncanonical_order():
    z = random_shard(np.random.default_rng(9), terms=20, num_docs=3000)
    bad = dict(z, pair_doc=z["pair_doc"][::-1].copy())
    with pytest.raises(comp.CompressError):
        comp.encode_shard(bad, num_docs=3000)


def test_bf16_decode_matches_ml_dtypes():
    bits = np.arange(1 << 16, dtype=np.uint16)
    want = bits.view(ml_dtypes.bfloat16).astype(np.float32)
    ok = np.isfinite(want) & (want >= 0)
    assert ok.sum() > 32_000
    got = comp.bf16_to_float32(bits)
    assert got.dtype == np.float32
    assert got[ok].view(np.uint32).tobytes() == \
        want[ok].view(np.uint32).tobytes()


def test_bf16_encode_matches_ml_dtypes():
    rng = np.random.default_rng(0)
    tfs = np.concatenate([
        np.arange(0, 70_000),
        rng.integers(0, 2**31 - 1, 200_000),
        rng.integers(-2**31, 0, 1_000),
        [2**24 + 1, 2**24 + 3, 2**31 - 1, -2**31, 257, 32_897],
    ]).astype(np.int32)
    want = tfs.astype(ml_dtypes.bfloat16)
    assert np.array_equal(comp.bf16_bits(tfs), want.view(np.uint16))
    exact = want.astype(np.float32) == tfs.astype(np.float32)
    assert np.array_equal(comp.bf16_exact(tfs), exact)
    assert comp.bf16_exact(np.arange(257)).all()
    assert not comp.bf16_exact(np.array([257])).any()


# -- whole indexes ----------------------------------------------------------


def _wide_tf_corpus(path):
    """A corpus with 300 distinct tfs of one term ("salmon" i times in doc
    i), so one shard holds > 256 distinct tfs, some of which bf16 cannot
    hold (257, 259, ...): int8 is lossy on it and bf16 needs exceptions."""
    words = ["river", "honey", "bears", "market", "forest"]
    with open(path, "w") as f:
        for i in range(1, 301):
            body = " ".join(["salmon"] * i + words[: 1 + i % 5])
            f.write(f"<DOC>\n<DOCNO> W-{i:04d} </DOCNO>\n<TEXT>\n{body}\n"
                    f"</TEXT>\n</DOC>\n")
    return path


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("compress")
    small = str(d / "small.trec")
    make_corpus(small, seed=4, n_docs=200, target_bytes=200_000,
                vocab_size=1_500)
    return {"small": small, "wide": _wide_tf_corpus(str(d / "wide.trec"))}


@pytest.fixture(scope="module")
def raw_indexes(corpora, tmp_path_factory):
    d = tmp_path_factory.mktemp("raw")
    out = {}
    for name, corpus in corpora.items():
        out[name] = str(d / name)
        build_index(corpus, out[name], num_shards=SHARDS, device="cpu")
    return out


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _parts(d, version):
    return [fmt.part_name(s, version) for s in range(SHARDS)]


@pytest.mark.parametrize("corpus,tf_dtype", [
    ("small", "auto"), ("small", "bf16"), ("wide", "auto"),
    ("wide", "int8"), ("wide", "bf16")])
def test_migrated_index_matches_jax(raw_indexes, tmp_path, corpus,
                                    tf_dtype):
    raw = raw_indexes[corpus]
    port = _copy(raw, tmp_path / "port")
    jax = _copy(raw, tmp_path / "jax")
    info = migrate_index(port, to_version=3, tf_dtype=tf_dtype)
    jinfo = jax_migrate(jax, to_version=3, tf_dtype=tf_dtype)
    for key in ("migrated", "skipped", "tf_dtype", "tf_lossy",
                "format_version"):
        assert info[key] == jinfo[key], key
    assert info["tf_lossy"] == (corpus == "wide" and tf_dtype == "int8")
    for name in _parts(port, 3):
        assert filecmp.cmp(os.path.join(port, name), os.path.join(jax, name),
                           shallow=False), name
        assert not os.path.exists(os.path.join(port, fmt.part_name(
            int(name[5:10]))))
    pm, jm = fmt.IndexMetadata.load(port), jfmt.IndexMetadata.load(jax)
    assert pm.compressed and jm.compressed
    # the bounds artifact, re-derived from the decoded postings, too
    assert jm.checksums["blockmax.arena"]
    assert pm.checksums == jm.checksums
    assert filecmp.cmp(os.path.join(port, "blockmax.arena"),
                       os.path.join(jax, "blockmax.arena"), shallow=False)
    pd, jd = dict(pm.__dict__), dict(jm.__dict__)
    pd.pop("checksums"), jd.pop("checksums")
    assert pd == jd
    # the port runs again over a done dir without touching it
    again = migrate_index(port, to_version=3, tf_dtype=tf_dtype)
    assert again["migrated"] == 0 and again["skipped"] == SHARDS
    # and walks it back to the raw parts, byte for byte when lossless
    back = migrate_index(port, to_version=2)
    assert back["migrated"] == SHARDS
    meta = fmt.IndexMetadata.load(port)
    assert meta.format_version == 2 and meta.tf_dtype == "int32"
    assert meta.tf_lossy == info["tf_lossy"]
    same = [filecmp.cmp(os.path.join(port, n), os.path.join(raw, n),
                        shallow=False) for n in _parts(port, 2)]
    # a lossy index comes back floor-quantized in the shard holding the
    # wide tfs; the others are byte for byte the originals
    assert sum(same) == SHARDS - info["tf_lossy"]
    assert not any(f.endswith(".carena") for f in os.listdir(port))


def test_port_reads_a_mid_migration_dir(raw_indexes, tmp_path):
    """Parts already rewritten in the other format (metadata stamped last)
    load through their twin."""
    raw = raw_indexes["small"]
    d = _copy(raw, tmp_path / "mid")
    meta = fmt.IndexMetadata.load(d)
    z = fmt.load_shard_verified(d, 1, meta)
    fmt.save_shard(d, 1, term_ids=z["term_ids"], indptr=z["indptr"],
                   pair_doc=z["pair_doc"], pair_tf=z["pair_tf"], df=z["df"],
                   format_version=3, num_docs=meta.num_docs)
    assert sorted(f for f in os.listdir(d) if f.startswith("part-")) == [
        "part-00000.arena", "part-00001.carena", "part-00002.arena"]
    q = np.random.default_rng(3).integers(0, meta.vocab_size, (50, 2))
    got = Scorer.load(d, device="cpu").topk(q.astype(np.int32))
    want = Scorer.load(raw, device="cpu").topk(q.astype(np.int32))
    assert got[0].tobytes() == want[0].tobytes()
    assert np.array_equal(got[1], want[1])
    # the port's own migration completes the dir
    assert migrate_index(d, to_version=3)["skipped"] == 1


def test_v3_part_needs_num_docs(raw_indexes, tmp_path):
    """num_docs sizes a v3 part's block column, so save_shard refuses to
    guess it and leaves the raw part in place."""
    d = _copy(raw_indexes["small"], tmp_path / "nd")
    z = fmt.load_shard(d, 0)
    with pytest.raises(ValueError, match="num_docs"):
        fmt.save_shard(d, 0, term_ids=z["term_ids"], indptr=z["indptr"],
                       pair_doc=z["pair_doc"], pair_tf=z["pair_tf"],
                       df=z["df"], format_version=3)
    assert fmt.part_path(d, 0).endswith(".arena")


# -- serving ----------------------------------------------------------------


@pytest.fixture(scope="module")
def served(raw_indexes, tmp_path_factory):
    """The small index raw, and compressed by the JAX package."""
    d = tmp_path_factory.mktemp("served")
    raw = raw_indexes["small"]
    v3 = _copy(raw, d / "v3")
    jax_migrate(v3, to_version=3, tf_dtype="auto")
    return raw, v3


def _text_queries(vocab_terms, n=30, seed=0):
    rng = np.random.default_rng(seed)
    out = [" ".join(vocab_terms[i] for i in rng.integers(
        0, len(vocab_terms), rng.integers(1, 4))) for _ in range(n)]
    return out + ["", "qqqqzzzz", f"{vocab_terms[5]} {vocab_terms[5]}",
                  f"{vocab_terms[0]} {vocab_terms[1]} {vocab_terms[2]}"]


def _id_queries(v, seed=1, b=120):
    q = np.random.default_rng(seed).integers(0, v, (b, 3)).astype(np.int32)
    q[3, 1:] = -1
    q[4] = -1
    q[5, 0] = v + 2                              # out of vocabulary
    q[6, 1] = q[6, 0]                            # a duplicated term
    return q


def _assert_same_ranking(want_s, want_d, got_s, got_d):
    want_s, got_s = np.asarray(want_s, np.float64), np.asarray(got_s)
    np.testing.assert_allclose(got_s, want_s, rtol=RTOL, atol=1e-6)
    want_d, got_d = list(want_d), list(got_d)
    assert len(want_d) == len(got_d)
    i = 0
    while i < len(want_d):
        j = i + 1
        while j < len(want_d) and abs(want_s[j] - want_s[j - 1]) <= \
                RTOL * max(abs(want_s[j - 1]), 1e-30):
            j += 1
        if j < len(want_d) or j - i == 1:
            assert set(got_d[i:j]) == set(want_d[i:j]), (i, j)
        i = j


@pytest.mark.parametrize("scoring", ["tfidf", "bm25"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_compressed_serving_matches_jax_and_raw(served, layout, scoring):
    raw, v3 = served
    port = Scorer.load(v3, layout=layout, device="cpu")
    assert port.tf_dtype == torch.bfloat16
    jax_kw = {"prune": False} if layout == "sparse" else {}
    js = JaxScorer.load(v3, layout=layout, **jax_kw)
    qs = _text_queries(port.vocab.terms)
    for w, g in zip(js.search_batch(qs, scoring=scoring),
                    port.search_batch(qs, scoring=scoring)):
        _assert_same_ranking([s for _, s in w], [d for d, _ in w],
                             [s for _, s in g], [d for d, _ in g])
    q = _id_queries(port.meta.vocab_size)
    ws, wd = js.topk(q, k=10, scoring=scoring)
    gs, gd = port.topk(q, k=10, scoring=scoring)
    for i in range(len(q)):
        _assert_same_ranking(ws[i], wd[i], gs[i], gd[i])
    # inside the port, lossless compressed == raw, bitwise
    rs, rd = Scorer.load(raw, layout=layout, device="cpu").topk(
        q, k=10, scoring=scoring)
    assert np.array_equal(gd, rd)
    assert gs.tobytes() == rs.tobytes()
    assert port.search_batch(qs, scoring=scoring) == Scorer.load(
        raw, layout=layout, device="cpu").search_batch(qs, scoring=scoring)


def test_compressed_dense_holds_one_bf16_matrix(served):
    raw, v3 = served
    s = Scorer.load(v3, layout="dense", device="cpu")
    assert s.doc_matrix is None and s._pairs is None
    assert s._tf_matrix.dtype == torch.bfloat16
    assert s._ensure_tf_matrix() is s._tf_matrix
    floats = [t for t in vars(s).values() if isinstance(t, torch.Tensor)
              and t.dtype == torch.float32]
    assert floats == []
    r = Scorer.load(raw, layout="dense", device="cpu")
    assert r.tf_dtype == torch.float32 and r.doc_matrix.dtype == \
        torch.float32
    assert torch.equal(s._tf_matrix.float(), r._ensure_tf_matrix())


def test_bf16_rule_falls_back_to_float32(raw_indexes, tmp_path, caplog):
    """tfs bf16 cannot hold: the compressed index serves float32 (kernel
    1's matrix on the dense layout, an f32 strip on the tiered one), with
    a warning, and still equals the raw index bitwise."""
    raw = raw_indexes["wide"]
    v3 = _copy(raw, tmp_path / "v3")
    assert migrate_index(v3, to_version=3)["tf_dtype"] == "bf16"
    q = _id_queries(fmt.IndexMetadata.load(raw).vocab_size, b=40)
    for layout in ("dense", "sparse"):
        caplog.clear()
        with caplog.at_level(logging.WARNING,
                             logger="tpu_ir_torch.search.scorer"):
            s = Scorer.load(v3, layout=layout, device="cpu")
        assert s.tf_dtype == torch.float32
        assert "do not round-trip bf16" in caplog.text
        if layout == "dense":
            assert s.doc_matrix.dtype == torch.float32
        else:
            assert s.hot_tfs.dtype == torch.float32
        r = Scorer.load(raw, layout=layout, device="cpu")
        assert r.tf_dtype == torch.float32
        for scoring in ("tfidf", "bm25"):
            a, b = s.topk(q, scoring=scoring), r.topk(q, scoring=scoring)
            assert a[0].tobytes() == b[0].tobytes()
            assert np.array_equal(a[1], b[1])


def test_raw_index_is_always_float32(raw_indexes):
    for layout in ("dense", "sparse"):
        s = Scorer.load(raw_indexes["small"], layout=layout, device="cpu")
        assert s.tf_dtype == torch.float32
        strip = s.doc_matrix if layout == "dense" else s.hot_tfs
        assert strip.dtype == torch.float32


def test_compressed_state_carries_across_from_jax(served):
    """A JAX-compressed index's decoded postings and metadata build the
    port's bf16 layouts through convert, serving like the JAX Scorer."""
    _, v3 = served
    js = JaxScorer.load(v3, layout="dense")
    meta = dict(js.meta.__dict__)
    assert meta["format_version"] == 3
    pair_term, pair_doc, pair_tf = js._pairs
    conv = scorer_from_numpy(js.vocab.terms, js.mapping.docids,
                             np.asarray(js.df), np.asarray(js.doc_len),
                             pair_term, pair_doc, pair_tf, meta,
                             device="cpu")
    assert conv._tf_matrix.dtype == torch.bfloat16
    jt = JaxScorer.load(v3, layout="sparse", prune=False)
    jl = jax_build_tiered(np.asarray(pair_doc), np.asarray(pair_tf),
                    np.asarray(js.df), num_docs=js.meta.num_docs)
    tconv = tiered_scorer_from_numpy(js.vocab.terms, js.mapping.docids,
                                     np.asarray(js.df),
                                     np.asarray(js.doc_len), jl._asdict(),
                                     meta, device="cpu")
    assert tconv.hot_tfs.dtype == torch.bfloat16
    q = _id_queries(js.meta.vocab_size, seed=4)
    for scoring in ("tfidf", "bm25"):
        for want_scorer, got_scorer in ((js, conv), (jt, tconv)):
            ws, wd = want_scorer.topk(q, k=10, scoring=scoring)
            gs, gd = got_scorer.topk(q, k=10, scoring=scoring)
            for i in range(len(q)):
                _assert_same_ranking(ws[i], wd[i], gs[i], gd[i])


# -- command line -----------------------------------------------------------


def test_cli_migrate_index_round_trip(raw_indexes, tmp_path, capsys):
    raw = raw_indexes["small"]
    d = _copy(raw, tmp_path / "cli")
    assert cli_main(["migrate-index", d, "--compress",
                     "--tf-dtype", "bf16"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["format_version"] == 3
    assert out["tf_dtype"] == "bf16" and out["migrated"] == SHARDS
    assert cli_main(["search", d, "-q", "a b", "--device", "cpu"]) == 0
    capsys.readouterr()
    assert cli_main(["migrate-index", d, "--decompress"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["format_version"] == 2 and out["migrated"] == SHARDS
    for name in _parts(d, 2):
        assert filecmp.cmp(os.path.join(d, name), os.path.join(raw, name),
                           shallow=False), name
    assert cli_main(["migrate-index", d, "--compress",
                     "--decompress"]) == 2
    assert "mutually exclusive" in capsys.readouterr().out
    assert fmt.IndexMetadata.load(d).format_version == 2
