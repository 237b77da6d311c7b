"""The port's serving cache (`serving-tiered/`) against the JAX package's.

- The cache is tpu_ir's format: on the same index the manifest's key is
  equal and every tier and df section of cache.arena is bitwise equal.
  The rerank's doc norms are each package's own: on the stdlib fixture
  they differ in the last place for some docs (each package's own log
  and float32 rounding of the idf), so they are held within rtol 1e-6.
- Within the port a cache hit serves bitwise what the miss served
  (docnos and float32 score bits through the top-k, the rerank and
  explain) and opens no part file.
- Across packages each serves from the other's cache tpu_ir's top-10 doc
  sets with scores within rtol 1e-5 (where two adjacent reference scores
  lie within that tolerance, the doc ids are compared as a set).
- The JAX package's cache tests (tests/test_e2e.py:558-700,
  tests/test_arena.py:405-460, tests/test_compress.py:430-490,
  tests/test_blockmax.py:570, tests/test_cli.py:261) have their
  counterparts here.

Every test that pins a bitwise contract within the port works on its own
copy of the fixture index, made without any cache, so it never depends on
which package wrote a cache first."""

import io
import json
import os
import shutil
import contextlib

import numpy as np
import pytest

from tpu_ir.cli import main as jax_cli_main
from tpu_ir.index import build_index as jax_build_index
from tpu_ir.search import Scorer as JaxScorer

from tpu_ir_torch.cli import main as cli_main
from tpu_ir_torch.index import format as fmt
from tpu_ir_torch.index.migrate import migrate_index
from tpu_ir_torch.search import Scorer
from tpu_ir_torch.search import layout as lay

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CORPUS = os.path.join(ROOT, "data", "stdlib", "corpus.trec")
RTOL = 1e-5
SHARDS = 3
QUERIES = ["heap queue", "sort a list", "thread lock timeout",
           "json decode", "regular expression match", "socket connect",
           "date time format", "qqqqzzzz", "file path", "random sample"]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The stdlib corpus built once by tpu_ir (the port reads its indexes
    byte for byte as its own); tests copy it without caches."""
    d = str(tmp_path_factory.mktemp("cache") / "base")
    jax_build_index(CORPUS, d, num_shards=SHARDS)
    return d


@pytest.fixture
def idx(base, tmp_path):
    d = str(tmp_path / "idx")
    shutil.copytree(base, d, ignore=shutil.ignore_patterns("serving-*"))
    return d


def load(d, **kw):
    return Scorer.load(d, layout="sparse", device="cpu", **kw)


def bits(results):
    return [[(k, float(v).hex()) for k, v in r] for r in results]


def served(s):
    """TF-IDF, BM25 and the rerank, as docids and float32 bits."""
    out = [bits(s.search_batch(QUERIES, scoring=sc))
           for sc in ("tfidf", "bm25")]
    out.append(bits(s.search_batch(QUERIES, rerank=50)))
    return out


def explained(s):
    """explain's decompositions of BM25 and of the rerank."""
    out = []
    for kw in (dict(scoring="bm25"), dict(rerank=50)):
        res = s.search_batch(QUERIES, explain_k=3, **kw)
        out.append(bits(res))
        out.append(json.dumps([r.explain for r in res], sort_keys=True,
                              default=repr))
    return out


class PartReads:
    """Counts every way the port opens a part file."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("load_shard", "load_shard_verified", "read_part"):
            real = getattr(fmt, name)
            monkeypatch.setattr(fmt, name, self._wrap(real))

    def _wrap(self, real):
        def counted(*a, **kw):
            self.n += 1
            return real(*a, **kw)
        return counted


def same_top(want, got):
    """tpu_ir's top-k against the port's: scores within RTOL, doc ids
    equal except inside a run of reference scores tied within RTOL."""
    for w, g in zip(want, got):
        ws = np.array([s for _, s in w], np.float64)
        np.testing.assert_allclose([s for _, s in g], ws, rtol=RTOL,
                                   atol=1e-6)
        i = 0
        while i < len(w):
            j = i + 1
            while j < len(w) and abs(ws[j] - ws[j - 1]) <= \
                    RTOL * max(abs(ws[j - 1]), 1e-30):
                j += 1
            if j == len(w) and j - i > 1:
                break            # a tie run at the cut may continue past k
            assert {d for d, _ in w[i:j]} == {d for d, _ in g[i:j]}
            i = j
    assert len(want) == len(got)


def test_cache_sections_and_key_equal_jax(base, tmp_path):
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    for d in (jd, pd):
        shutil.copytree(base, d, ignore=shutil.ignore_patterns("serving-*"))
    JaxScorer.load(jd, layout="sparse")
    load(pd)
    mj, mp = (json.load(open(os.path.join(d, lay.CACHE_NAME,
                                          "manifest.json")))
              for d in (jd, pd))
    assert mj["key"] == mp["key"]
    assert {k: v for k, v in mj.items() if k != "part_stat"} == \
        {k: v for k, v in mp.items() if k != "part_stat"}
    aj, ap = (fmt.load_arena(os.path.join(d, lay.CACHE_NAME, "cache.arena"))
              for d in (jd, pd))
    assert list(aj) == list(ap)
    for name in aj:
        if name == "doc_norms":
            np.testing.assert_allclose(ap[name], aj[name], rtol=1e-6)
        else:
            assert aj[name].dtype == ap[name].dtype, name
            assert np.array_equal(aj[name], ap[name]), name


def test_hit_equals_miss_bitwise_and_reads_no_part(idx, monkeypatch):
    cold = load(idx)
    assert os.path.isdir(os.path.join(idx, lay.CACHE_NAME))
    want, want_explained = served(cold), explained(cold)
    reads = PartReads(monkeypatch)
    warm = load(idx)
    assert reads.n == 0
    assert warm._host_pairs is None and warm._norms_np is not None
    assert served(warm) == want
    assert reads.n == 0          # the rerank's norms came from the cache
    # explain looks raw tfs up in the host postings, as tpu_ir's does:
    # they are read, each part verified as it streams, once
    assert explained(warm) == want_explained
    assert reads.n == SHARDS
    assert len(warm._host_postings()[1]) == warm.meta.num_pairs
    assert reads.n == SHARDS


def test_each_package_serves_the_others_cache(base, tmp_path):
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    for d in (jd, pd):
        shutil.copytree(base, d, ignore=shutil.ignore_patterns("serving-*"))
    want = {sc: JaxScorer.load(jd, layout="sparse").search_batch(
        QUERIES, scoring=sc) for sc in ("tfidf", "bm25")}
    want["rerank"] = JaxScorer.load(jd, layout="sparse").search_batch(
        QUERIES, rerank=50)
    load(pd)                                  # the port writes its cache
    port_cached = load(jd)                    # the port reads tpu_ir's
    jax_cached = JaxScorer.load(pd, layout="sparse")   # and vice versa
    for s in (port_cached, jax_cached):
        for sc in ("tfidf", "bm25"):
            same_top(want[sc], s.search_batch(QUERIES, scoring=sc))
        same_top(want["rerank"], s.search_batch(QUERIES, rerank=50))
    # the port's top-k from tpu_ir's cache is its own, bitwise (the tiers
    # and df are equal); only the rerank's norms are tpu_ir's
    own = load(pd)
    for sc in ("tfidf", "bm25"):
        assert bits(port_cached.search_batch(QUERIES, scoring=sc)) == \
            bits(own.search_batch(QUERIES, scoring=sc))


def test_serving_layout_cache(idx, tmp_path):
    """A hit reads the cached arrays (a poisoned section surfaces), and an
    in-place rebuild of another corpus misses the stale cache."""
    r1 = load(idx).search_batch(["heap queue"])[0]
    arena = os.path.join(idx, lay.CACHE_NAME, "cache.arena")
    sections = {k: np.array(v) for k, v in fmt.load_arena(arena).items()}
    tier0 = sections["tier_tfs_0"].copy()
    sections["tier_tfs_0"] = tier0 * 0
    fmt.write_arena(arena, sections)
    assert load(idx).search_batch(["heap queue"])[0] != r1
    sections["tier_tfs_0"] = tier0
    fmt.write_arena(arena, sections)
    assert load(idx).search_batch(["heap queue"])[0] == r1

    from tpu_ir_torch.index import build_index

    small = tmp_path / "small.trec"
    small.write_text(
        "<DOC>\n<DOCNO> X-1 </DOCNO>\n<TEXT>\nsalmon salmon trout\n"
        "</TEXT>\n</DOC>\n"
        "<DOC>\n<DOCNO> X-2 </DOCNO>\n<TEXT>\ntrout river\n</TEXT>\n</DOC>\n")
    build_index([str(small)], idx, num_shards=SHARDS, overwrite=True,
                compute_chargrams=False, device="cpu")
    assert os.path.isdir(os.path.join(idx, lay.CACHE_NAME))
    assert {d for d, _ in load(idx).search_batch(["salmon"])[0]} == {"X-1"}


def test_truncated_cache_array_recovers(idx):
    want = bits([load(idx).search_batch(["heap queue"])[0]])
    path = os.path.join(idx, lay.CACHE_NAME, "cache.arena")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    assert lay.load_serving_cache(idx, meta=fmt.IndexMetadata.load(idx)) \
        is None
    assert bits([load(idx).search_batch(["heap queue"])[0]]) == want


def test_readonly_index_dir_serves_without_cache(idx, monkeypatch):
    monkeypatch.setattr("tpu_ir_torch.search.scorer.serving_cache_writable",
                        lambda d: False)
    s = load(idx)
    assert s._norms_np is None                       # the norms pass skipped
    assert not os.path.isdir(os.path.join(idx, lay.CACHE_NAME))
    assert s.search_batch(["heap queue"])[0]
    assert s.search_batch(["heap queue"], rerank=5)[0]
    assert s._norms_np is not None                   # computed on first use


def test_cache_revalidation_stat_and_params(idx):
    load(idx)
    meta = fmt.IndexMetadata.load(idx)
    assert lay.load_serving_cache(idx, meta=meta) is not None
    # mtime drift, same bytes: the stat check misses, the CRC key hits
    os.utime(fmt.part_path(idx, 0), ns=(1, 1))
    assert lay.load_serving_cache(idx, meta=meta) is not None
    # a layout parameter drift misses even with matching stats
    assert lay.load_serving_cache(idx, meta=meta, hot_budget=1) is None


def test_cache_revalidate_crc_catches_stat_preserving_rot(idx,
                                                          monkeypatch):
    load(idx)
    meta = fmt.IndexMetadata.load(idx)
    part = fmt.part_path(idx, 0)
    st = os.stat(part)
    with open(part, "r+b") as f:
        f.seek(st.st_size - 100)
        byte = f.read(1)
        f.seek(st.st_size - 100)
        f.write(bytes([byte[0] ^ 0xFF]))
    os.utime(part, ns=(st.st_atime_ns, st.st_mtime_ns))
    # stat mode: still a hit (the documented trade of the warm load)
    assert lay.load_serving_cache(idx, meta=meta) is not None
    monkeypatch.setenv("TPU_IR_CACHE_REVALIDATE", "crc")
    assert lay.load_serving_cache(idx, meta=meta) is None
    with pytest.raises(fmt.IntegrityError):
        load(idx)
    monkeypatch.setenv("TPU_IR_CACHE_REVALIDATE", " CRC ")
    assert lay.load_serving_cache(idx, meta=meta) is None
    monkeypatch.setenv("TPU_IR_CACHE_REVALIDATE", "full")
    with pytest.raises(ValueError, match="TPU_IR_CACHE_REVALIDATE"):
        lay.load_serving_cache(idx, meta=meta)


def test_cache_misses_after_mtime_preserving_compress(idx):
    meta = fmt.IndexMetadata.load(idx)
    raw = bits(load(idx).search_batch(QUERIES, scoring="bm25"))
    assert lay.load_serving_cache(idx, meta=meta) is not None
    old = {s: os.stat(fmt.part_path(idx, s)) for s in range(SHARDS)}
    migrate_index(idx, to_version=fmt.COMPRESSED_FORMAT_VERSION)
    for s in range(SHARDS):
        os.utime(fmt.part_path(idx, s),
                 ns=(old[s].st_atime_ns, old[s].st_mtime_ns))
    assert lay.load_serving_cache(idx, meta=fmt.IndexMetadata.load(idx)) \
        is None
    assert bits(load(idx).search_batch(QUERIES, scoring="bm25")) == raw


def test_cache_key_carries_section_dtype_signature(idx):
    meta = fmt.IndexMetadata.load(idx)
    migrate_index(idx, to_version=fmt.COMPRESSED_FORMAT_VERSION,
                  tf_dtype="int8")
    crcs = {os.path.basename(fmt.part_path(idx, s)): "crc32:00000000"
            for s in range(meta.num_shards)}
    k1 = lay._serving_cache_key(idx, fmt.IndexMetadata.load(idx), 1, 1, 1,
                                part_crcs=crcs)
    migrate_index(idx, to_version=fmt.ARENA_FORMAT_VERSION)
    migrate_index(idx, to_version=fmt.COMPRESSED_FORMAT_VERSION,
                  tf_dtype="bf16")
    k2 = lay._serving_cache_key(idx, fmt.IndexMetadata.load(idx), 1, 1, 1,
                                part_crcs=crcs)
    assert [f[2] for f in k1["part_files"]] == \
        [f[2] for f in k2["part_files"]]
    assert k1["section_dtypes"] != k2["section_dtypes"]
    assert k1 != k2


def test_serving_cache_carries_bounds(idx):
    cold = load(idx)
    warm = load(idx)
    assert warm._host_pairs is None
    assert np.array_equal(np.asarray(warm._hot_blk_max),
                          np.asarray(cold._hot_blk_max))
    assert warm._blockmax_width == cold._blockmax_width
    q = cold.analyze_queries(QUERIES)
    for sc in ("tfidf", "bm25"):
        a, b = cold.topk(q, k=100, scoring=sc), warm.topk(q, k=100,
                                                          scoring=sc)
        assert a[0].tobytes() == b[0].tobytes()
        assert np.array_equal(a[1], b[1])


def test_dense_layout_writes_no_cache(idx):
    Scorer.load(idx, layout="dense", device="cpu")
    assert not os.path.exists(os.path.join(idx, lay.CACHE_NAME))


def test_warm_cli_keys_equal_jax(base, tmp_path, capsys):
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    for d in (jd, pd):
        shutil.copytree(base, d, ignore=shutil.ignore_patterns("serving-*"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_cli_main(["warm", jd, "--backend", "cpu"]) == 0
    want = json.loads(buf.getvalue().strip().splitlines()[-1])
    capsys.readouterr()
    assert cli_main(["warm", pd, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for key in ("layout", "cache_dir", "cache_written",
                "warm_skips_shards"):
        assert got[key] == want[key], key
    assert got["cache_written"] is True and got["warm_skips_shards"] is True
    # warm again: the cache is there already, written by no load of this run
    assert cli_main(["warm", pd, "--device", "cpu"]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["warm_skips_shards"] is True
