"""The port's live index (tpu_ir_torch.index.segments, ingest, verify_live,
the doctor's live report and the live command line) on the CPU, against
the JAX package's.

(a) A fully compacted generation has the bytes (sha256 of every
artifact, metadata.json included) of the port's one-shot build over the
surviving documents, across add/update/delete sequences, flush
boundaries and merge orders; `drop_docs` writes the JAX package's bytes.
(b) The live dir is one format: the same feed through both packages
gives the same segment bytes, WAL files and manifests (all but
`created`), `plan_merges` gives the JAX package's plan, and each package
opens, verifies and replays the other's live dir. (d) A compacted
generation loaded by `Scorer.load_generation` serves bitwise as the
one-shot index loaded by `Scorer.load`, dense and sparse, and the JAX
package's top-10 (ids equal, scores within rtol 1e-5)."""

import contextlib
import hashlib
import io
import json
import os
import random
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from tpu_ir.cli import main as jax_cli_main
from tpu_ir.index.doctor import live_doctor_report as jax_live_doctor
from tpu_ir.index.ingest import IngestWriter as JaxWriter
from tpu_ir.index.ingest import trec_payload as jax_trec_payload
from tpu_ir.index.segments import LiveIndex as JaxLive
from tpu_ir.index.segments import plan_merges as jax_plan_merges
from tpu_ir.index.segments import resolve_serving as jax_resolve_serving
from tpu_ir.index.verify import verify_live as jax_verify_live
from tpu_ir.search.scorer import Scorer as JaxScorer

from tpu_ir_torch import faults, obs
from tpu_ir_torch.cli import main as cli_main
from tpu_ir_torch.index import build_index
from tpu_ir_torch.index import format as fmt
from tpu_ir_torch.index.doctor import doctor_report, live_doctor_report
from tpu_ir_torch.index.ingest import IngestWriter, trec_payload
from tpu_ir_torch.index.segments import (
    LiveIndex,
    compact,
    drop_docs,
    is_live,
    latest_servable,
    merge_debt,
    plan_merges,
    resolve_serving,
)
from tpu_ir_torch.index.verify import verify_live
from tpu_ir_torch.index.wal import lease_holder, wal_dir
from tpu_ir_torch.search import Scorer

WORDS = ("salmon fishing river bears honey quick brown fox lazy dog "
         "market investor asset bond stock season rain forest".split())
N_SHARDS = 3
RTOL = 1e-5
QUERIES = ["salmon fishing", "bears honey market", "quick fox",
           "rain forest investor", "asset bond stock", "lazy dog season"]
# keys whose values are paths or wall-clock stamps
_PATHS_TIMES = {"live_dir", "dest", "restored", "created", "age_s",
                "heartbeat_age_s"}


@pytest.fixture(autouse=True)
def _clean_port_state():
    """The port's registry and fault plan start and end clean (the
    suite's conftest resets only tpu_ir's)."""
    faults.clear()
    obs.reset_all()
    yield
    faults.clear()
    obs.reset_all()


def make_text(rng) -> str:
    return " ".join(rng.choice(WORDS) for _ in range(rng.randint(3, 8)))


def write_trec(path, docs: dict) -> str:
    with open(path, "w", encoding="utf-8") as f:
        for d, t in docs.items():
            f.write(f"<DOC>\n<DOCNO> {d} </DOCNO>\n<TEXT>\n{t}\n"
                    f"</TEXT>\n</DOC>\n")
    return str(path)


def scratch_build(tmp_path, docs: dict, name: str, **kw) -> str:
    """The oracle: the port's one-shot build over `docs` (in their order)
    with the live config's parameters; its dir."""
    corpus = write_trec(tmp_path / f"{name}.trec", docs)
    build_index([corpus], str(tmp_path / name), num_shards=N_SHARDS,
                device="cpu", **kw)
    return str(tmp_path / name)


def digests(index_dir: str) -> dict:
    """sha256 of every artifact of an index dir but the job reports."""
    out = {}
    for name in sorted(os.listdir(index_dir)):
        path = os.path.join(index_dir, name)
        if name != "jobs" and os.path.isfile(path):
            with open(path, "rb") as f:
                out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def assert_same_bytes(dir_a: str, dir_b: str):
    want, got = digests(dir_a), digests(dir_b)
    assert "metadata.json" in want and len(want) >= 6
    assert got == want, sorted(n for n in set(want) | set(got)
                               if want.get(n) != got.get(n))


def writer(live_dir, **kw):
    return IngestWriter(live_dir, device="cpu", **kw)


def test_trec_payload_equals_jax():
    """The ingested text of a record is the JAX package's: one and two
    sections, tags in any case, an unclosed section, DOC framing only,
    and surrounding whitespace."""
    cases = [
        "<DOC>\n<DOCNO> D1 </DOCNO>\n<TEXT>\nsalmon fishing\n</TEXT>\n"
        "</DOC>\n",
        "<text> a b </Text> mid <TEXT>\tc\n</TEXT>",
        "<TEXT>open only",
        "<DOC><DOCNO>y</DOCNO> body \u00a0words </DOC>",
        "<TEXT></TEXT>",
        "",
    ]
    for c in cases:
        assert trec_payload(c) == jax_trec_payload(c), repr(c)


# ---------------------------------------------------------------------------
# the manifest chain
# ---------------------------------------------------------------------------


def test_create_open_commit_roundtrip(tmp_path):
    live_dir = str(tmp_path / "live")
    live = LiveIndex.create(live_dir, num_shards=N_SHARDS)
    assert is_live(live_dir)
    assert live.current_gen() == 0
    assert live.manifest()["segments"] == []
    with pytest.raises(ValueError, match="already a live index"):
        LiveIndex.create(live_dir)
    with pytest.raises(ValueError, match="k=1 only"):
        LiveIndex.create(str(tmp_path / "k2"), k=2)
    with pytest.raises(ValueError, match="not a live index"):
        LiveIndex.open(str(tmp_path / "nowhere"))
    m = live.commit([], {}, {}, note="empty", wal_seq=5)
    assert m["gen"] == 1 and m["parent"] == 0 and m["wal"] == {"seq": 5}
    assert live.manifest(1) == m and live.generations() == [0, 1]
    # a commit without a watermark inherits the parent's
    assert live.commit([], {}, {})["wal"] == {"seq": 5}
    assert obs.get_registry().get("generation.commits") == 2
    assert obs.get_registry().gauges()["generation.current"] == 2


def test_ingest_flush_tombstones_and_live_view(tmp_path):
    live_dir = str(tmp_path / "live")
    LiveIndex.create(live_dir, num_shards=N_SHARDS, chargram_ks=())
    rng = random.Random(0)
    w = writer(live_dir, buffer_docs=4, auto_merge=False)
    for i in range(10):  # buffer_docs=4: auto-flushes mint segments
        w.add(f"D-{i:03d}", make_text(rng))
    w.flush()
    live = w.live
    assert len(live.manifest()["segments"]) >= 2
    assert live.doc_counts() == {"total": 10, "tombstoned": 0, "live": 10}
    with pytest.raises(ValueError, match="already exists"):
        w.add("D-000", "dup")
    w.update("D-000", "brand new text")
    assert w.delete("D-001") is True
    assert w.delete("NOPE") is False
    w.flush()
    m = live.manifest()
    # the updated and the deleted doc are tombstoned in their original
    # segment; the update's new copy lives in the new segment
    assert sum(len(t) for t in m["tombstones"].values()) == 2
    dm = live.live_doc_map()
    assert "D-001" not in dm and dm["D-000"] == m["segments"][-1]
    assert live.doc_counts()["live"] == 9
    with pytest.raises(ValueError, match="invalid docid"):
        w.add("bad id", "text")
    with pytest.raises(ValueError, match="TREC markup"):
        w.add("OK-1", "sneaky </TEXT> closer")
    w.close()
    assert lease_holder(live_dir) is None


def test_crash_safe_commit_and_gc(tmp_path):
    """A crash between the manifest write and the CURRENT flip leaves the
    previous generation current; a segment dir without metadata (a
    crashed build) is never named and gc removes it."""
    live_dir = str(tmp_path / "live")
    live = LiveIndex.create(live_dir, num_shards=N_SHARDS, chargram_ks=())
    rng = random.Random(1)
    w = writer(live_dir, auto_merge=False)
    for i in range(6):
        w.add(f"D-{i:03d}", make_text(rng))
        w.flush()  # one generation a doc: a chain to prune
    before = live.current_gen()
    faults.install(faults.parse_plan("ingest.commit_between:once@1"))
    with pytest.raises(faults.InjectedCrash):
        live.commit(live.manifest()["segments"], {}, live.manifest()["docs"])
    faults.clear()
    assert live.current_gen() == before     # the flip never happened
    assert before + 1 in live.generations()  # the orphan manifest
    w.abandon()
    orphan = live.segment_path("seg-999999")
    os.makedirs(orphan)
    out = live.gc(keep_generations=2)
    assert "seg-999999" in out["dropped_segments"]
    assert live.generations() == out["kept_generations"]
    for g in live.generations():
        for name in live.manifest(g)["segments"]:
            fmt.IndexMetadata.load(live.segment_path(name))
    assert live._next_segment_name(live.manifest()) != "seg-999999"
    # the next writer overwrites the orphan manifest with a real commit
    with writer(live_dir, auto_merge=False) as w2:
        w2.add("D-100", "fresh text")
    assert set(live.live_doc_map()) == {f"D-{i:03d}" for i in range(6)} | {
        "D-100"}


# ---------------------------------------------------------------------------
# bit identity: drop_docs, compaction, merge orders
# ---------------------------------------------------------------------------


def test_drop_docs_bit_identical(tmp_path):
    """drop_docs == a one-shot build over the survivors, and == the JAX
    package's drop_docs over the same source, checksum for checksum."""
    from tpu_ir.index.segments import drop_docs as jax_drop_docs

    rng = random.Random(2)
    docs = {f"D-{i:03d}": make_text(rng) for i in range(9)}
    src_dir = scratch_build(tmp_path, docs, "src")
    dropped = ["D-001", "D-004", "D-008"]
    meta = drop_docs(src_dir, str(tmp_path / "dropped"), dropped,
                     device="cpu")
    assert meta.num_docs == 6
    survivors = {d: t for d, t in docs.items() if d not in dropped}
    assert_same_bytes(scratch_build(tmp_path, survivors, "oracle"),
                      str(tmp_path / "dropped"))
    jax_drop_docs(src_dir, str(tmp_path / "jdropped"), dropped)
    assert_same_bytes(str(tmp_path / "jdropped"), str(tmp_path / "dropped"))
    with pytest.raises(ValueError, match="unknown docids"):
        drop_docs(src_dir, str(tmp_path / "x1"), ["GHOST"], device="cpu")
    with pytest.raises(ValueError, match="dropping every document"):
        drop_docs(src_dir, str(tmp_path / "x2"), list(docs), device="cpu")


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_compact_bit_identical_fuzz(tmp_path, seed):
    """Random add/update/delete sequences over random flush boundaries:
    full compaction == a one-shot build of the surviving docs."""
    rng = random.Random(seed)
    live_dir = str(tmp_path / "live")
    LiveIndex.create(live_dir, num_shards=N_SHARDS)
    surviving: dict = {}
    w = writer(live_dir, buffer_docs=64, auto_merge=seed == 5)
    next_id = 0
    for _ in range(28):
        op = rng.random()
        if op < 0.55 or not surviving:
            d = f"D-{next_id:03d}"
            next_id += 1
            t = make_text(rng)
            w.add(d, t)
            surviving[d] = t
        elif op < 0.8:
            d = rng.choice(sorted(surviving))
            t = make_text(rng)
            w.update(d, t)
            surviving[d] = t
        else:
            d = rng.choice(sorted(surviving))
            w.delete(d)
            del surviving[d]
        if rng.random() < 0.25:
            w.flush()
    m = w.compact_all()
    w.close()
    assert len(m["segments"]) == 1 and not m["tombstones"]
    sdir, gen = resolve_serving(live_dir)
    assert_same_bytes(scratch_build(tmp_path, surviving, "oracle"), sdir)
    assert latest_servable(live_dir) == (sdir, gen)


def test_merge_order_independent(tmp_path):
    """Pairwise compaction in either association order gives the bytes
    of one-shot compaction."""
    dirs = []
    for variant in ("all", "left", "right"):
        live_dir = str(tmp_path / f"live-{variant}")
        LiveIndex.create(live_dir, num_shards=N_SHARDS, chargram_ks=())
        w = writer(live_dir, buffer_docs=1000, auto_merge=False)
        rng_v = random.Random(5)  # the same op stream in each variant
        for i in range(12):
            w.add(f"D-{i:03d}", make_text(rng_v))
            if i % 4 == 3:
                w.flush()
        w.delete("D-002")
        w.update("D-005", "fresh text for five")
        w.flush()
        live = w.live
        segs = live.manifest()["segments"]
        assert len(segs) >= 3
        if variant == "left":
            compact(live, segs[:2], device="cpu")
        elif variant == "right":
            compact(live, segs[-2:], device="cpu")
        compact(live, device="cpu")
        w.close()
        dirs.append(resolve_serving(live_dir)[0])
    assert_same_bytes(dirs[0], dirs[1])
    assert_same_bytes(dirs[0], dirs[2])


def test_fully_tombstoned_segment_is_dropped(tmp_path):
    live_dir = str(tmp_path / "live")
    LiveIndex.create(live_dir, num_shards=N_SHARDS, chargram_ks=())
    rng = random.Random(6)
    w = writer(live_dir, auto_merge=False)
    for i in range(3):
        w.add(f"A-{i}", make_text(rng))
    w.flush()
    doomed = w.live.manifest()["segments"][0]
    for i in range(3):
        w.add(f"B-{i}", make_text(rng))
    w.flush()
    for i in range(3):
        w.delete(f"A-{i}")
    w.flush()
    segs_before = set(os.listdir(os.path.join(live_dir, "segments")))
    m = compact(w.live, [doomed], device="cpu")
    # the dead segment left the set without a merge minting a new one
    assert doomed not in m["segments"] and doomed not in m["tombstones"]
    assert set(os.listdir(os.path.join(live_dir, "segments"))) == \
        segs_before
    assert w.live.doc_counts()["live"] == 3
    compact(w.live, device="cpu")
    w.close()
    assert fmt.IndexMetadata.load(resolve_serving(live_dir)[0]).num_docs == 3


# ---------------------------------------------------------------------------
# the merge policy
# ---------------------------------------------------------------------------


def _random_manifest(rng) -> dict:
    names = [f"seg-{i:06d}" for i in range(rng.randint(0, 12))]
    docs = {n: rng.choice([1, 2, 7, 8, 9, 63, 64, 65, 500, 511, 512,
                           rng.randint(1, 40000)]) for n in names}
    tombs = {}
    for n in names:
        if rng.random() < 0.4:
            dead = rng.randint(1, docs[n])
            tombs[n] = [f"D{i}" for i in range(dead)]
    return {"segments": names, "docs": docs, "tombstones": tombs}


@pytest.mark.parametrize("seed", range(3))
def test_plan_merges_equals_jax(seed):
    """The tier policy's float log tiering and its dead-heavy rule give
    tpu_ir's groups on random manifests, at the defaults and at other
    factors and ratios (tier edges included: 8, 64, 512 docs)."""
    rng = random.Random(seed)
    for _ in range(200):
        m = _random_manifest(rng)
        for kw in ({}, {"factor": 2, "tier_ratio": 2.0},
                   {"factor": 3, "tier_ratio": 4.0},
                   {"factor": 4, "tier_ratio": 8.0}):
            assert plan_merges(m, **kw) == jax_plan_merges(m, **kw), (m, kw)
    m = {"segments": ["big"], "docs": {"big": 100},
         "tombstones": {"big": [f"D{i}" for i in range(60)]}}
    assert plan_merges(m) == [["big"]]
    debt = merge_debt(m)
    assert debt == {"segments": 1, "pending_merge_groups": [["big"]],
                    "tombstoned_docs": 60, "live_doc_fraction": 0.4}


def test_auto_merge_bounds_segment_count(tmp_path):
    live_dir = str(tmp_path / "live")
    LiveIndex.create(live_dir, num_shards=N_SHARDS, chargram_ks=())
    rng = random.Random(7)
    w = writer(live_dir, buffer_docs=1000, auto_merge=True)
    peak = 0
    for i in range(7):
        for j in range(2):
            w.add(f"D-{i:02d}-{j}", make_text(rng))
        w.flush()
        peak = max(peak, len(w.live.manifest()["segments"]))
    w.close()
    assert peak <= 4   # the TPU_IR_MERGE_FACTOR default
    assert obs.get_registry().get("merge.runs") >= 1


# ---------------------------------------------------------------------------
# serving resolution
# ---------------------------------------------------------------------------


def test_resolve_serving_and_latest_servable(tmp_path):
    live_dir = str(tmp_path / "live")
    LiveIndex.create(live_dir, num_shards=N_SHARDS, chargram_ks=())
    for gen, text in ((None, "no servable generation"),
                      (0, "has no segments")):
        with pytest.raises(ValueError, match=text) as got:
            resolve_serving(live_dir, gen)
        with pytest.raises(ValueError) as want:
            jax_resolve_serving(live_dir, gen)
        assert str(got.value) == str(want.value)
    plain = tmp_path / "plain"
    plain.mkdir()
    assert resolve_serving(str(plain)) == (str(plain), 0)
    assert latest_servable(str(plain)) == (str(plain), 0)
    rng = random.Random(8)
    w = writer(live_dir, auto_merge=False)
    for i in range(6):
        w.add(f"D-{i:03d}", make_text(rng))
    w.flush()
    servable = w.live.current_gen()
    for i in range(3):
        w.add(f"E-{i:03d}", make_text(rng))
    w.delete("D-001")
    w.flush()
    w.close()
    live = LiveIndex.open(live_dir)
    head = live.current_gen()
    # the uncompacted head is skipped by default, refused explicitly
    sdir, gen = resolve_serving(live_dir)
    assert gen == servable < head
    assert (sdir, gen) == latest_servable(live_dir)
    assert sdir == live.segment_path(live.manifest(servable)["segments"][0])
    with pytest.raises(ValueError, match="not servable") as got:
        resolve_serving(live_dir, head)
    with pytest.raises(ValueError) as want:
        jax_resolve_serving(live_dir, head)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        Scorer.load_generation(live_dir, head, device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


def _feed(writer_cls, live_cls, live_dir, **writer_kw):
    """One seeded create/add/update/delete/flush/merge/compact sequence,
    the writer left open with an unflushed tail in its WAL."""
    live_cls.create(live_dir, num_shards=N_SHARDS)
    rng = random.Random(11)
    w = writer_cls(live_dir, buffer_docs=5, auto_merge=True, **writer_kw)
    for i in range(26):
        w.add(f"D-{i:03d}", make_text(rng))
    w.update("D-004", "brand new text")
    w.update("D-020", make_text(rng))
    w.delete("D-007")
    w.flush()
    w.maybe_merge()
    w.compact_all()
    w.update("D-002", "after compaction")
    w.delete("D-010")
    w.flush()
    w.add("T-000", "an unflushed tail")
    return w


def _tree(live_dir: str) -> dict:
    """Every file of a live dir, job reports and the lease aside:
    {relative path: bytes}, manifests without `created`."""
    out = {}
    for root, _dirs, files in os.walk(live_dir):
        rel_root = os.path.relpath(root, live_dir)
        if "jobs" in rel_root.split(os.sep):
            continue
        for f in files:
            rel = os.path.normpath(os.path.join(rel_root, f))
            if f == "LEASE":
                continue
            with open(os.path.join(root, f), "rb") as fh:
                data = fh.read()
            if f.startswith("gen-") or f == "live.json":
                data = {k: v for k, v in json.loads(data).items()
                        if k != "created"}
            out[rel] = data
    return out


def test_same_feed_same_bytes_across_packages(tmp_path):
    """The same feed through both packages: the same files, each byte
    for byte (segment artifacts, metadata, WAL segments, CURRENT), the
    manifests and live.json field for field but `created`; and
    live.json's bytes too once `created` is equal."""
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jw = _feed(JaxWriter, JaxLive, jdir)
    pw = _feed(IngestWriter, LiveIndex, pdir, device="cpu")
    jw.abandon()
    pw.abandon()
    want, got = _tree(jdir), _tree(pdir)
    assert sorted(got) == sorted(want)
    assert any(p.startswith("wal" + os.sep) for p in got)
    differ = []
    for rel in want:
        a, b = want[rel], got[rel]
        if rel.endswith("metadata.json"):
            a = {k: v for k, v in json.loads(a).items() if k != "created"}
            b = {k: v for k, v in json.loads(b).items() if k != "created"}
        if a != b:
            differ.append(rel)
    assert not differ, differ
    # live.json and the manifests: the same layout (indent 2, sorted)
    for d in (jdir, pdir):
        for rel in [p for p in got if p.endswith(".json")
                    and "segments" not in p]:
            with open(os.path.join(d, rel), encoding="utf-8") as f:
                text = f.read()
            assert text == json.dumps(json.loads(text), indent=2,
                                      sort_keys=True), (d, rel)


def _dead_pid() -> int:
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    return child.pid


def _final_digests(live_dir: str) -> dict:
    return digests(resolve_serving(live_dir)[0])


def test_port_recovers_a_jax_live_dir(tmp_path):
    """A live dir the JAX package wrote, its writer dead mid-feed (an
    unflushed WAL tail, a lease from a dead pid): the port takes the
    lease over, replays the tail and compacts to the bytes the JAX
    package reaches on a copy of the same dir."""
    jdir = str(tmp_path / "jax")
    jw = _feed(JaxWriter, JaxLive, jdir)
    jw.abandon()
    lease = os.path.join(wal_dir(jdir), "LEASE")
    with open(lease, "w") as f:
        json.dump({"pid": _dead_pid(), "token": "dead",
                   "heartbeat": time.time()}, f)
    twin = str(tmp_path / "twin")
    shutil.copytree(jdir, twin)
    pw = writer(jdir, auto_merge=False)
    assert pw.lease_info["taken_over"] and pw.replayed == 1
    pw.compact_all()
    pw.close()
    with JaxWriter(twin, auto_merge=False) as jw2:
        assert jw2.replayed == 1
        jw2.compact_all()
    assert _final_digests(jdir) == _final_digests(twin)
    assert verify_live(jdir)["wal"]["pending_records"] == 0
    assert "T-000" in LiveIndex.open(jdir).live_doc_map()


def test_jax_verifies_and_recovers_a_port_live_dir(tmp_path):
    """The JAX package's verify_live passes on a live dir the port wrote
    (its uncompacted head, then after a crash), and its writer replays
    the port's WAL tail to the port's own recovery."""
    pdir = str(tmp_path / "port")
    pw = _feed(IngestWriter, LiveIndex, pdir, device="cpu")
    pw.abandon()
    want = verify_live(pdir)
    got = jax_verify_live(pdir)
    assert got == want and got["wal"]["pending_records"] == 1
    twin = str(tmp_path / "twin")
    shutil.copytree(pdir, twin)
    with JaxWriter(pdir, auto_merge=False) as jw:
        assert jw.replayed == 1
        jw.compact_all()
    with writer(twin, auto_merge=False) as w:
        assert w.replayed == 1
        w.compact_all()
    assert _final_digests(pdir) == _final_digests(twin)
    assert jax_verify_live(twin) == verify_live(twin)


def test_ingest_counters_and_gauges_declared(tmp_path):
    from tpu_ir_torch.obs.registry import (
        DECLARED_COUNTERS,
        DECLARED_GAUGES,
        DECLARED_HISTOGRAMS,
        FAULT_SITES,
    )
    from tpu_ir.obs.registry import FAULT_SITES as JAX_SITES
    from tpu_ir.obs.registry import INGEST_COUNTER_NAMES as JAX_INGEST

    assert {s for s in FAULT_SITES if s.startswith("ingest.")} == {
        s for s in JAX_SITES if s.startswith("ingest.")}
    for name in JAX_INGEST:
        assert name in DECLARED_COUNTERS
    for name in ("ingest.flush", "merge.run", "generation.swap"):
        assert name in DECLARED_HISTOGRAMS
    for name in ("generation.current", "generation.segments",
                 "generation.tombstones"):
        assert name in DECLARED_GAUGES
    live_dir = str(tmp_path / "live")
    LiveIndex.create(live_dir, num_shards=N_SHARDS, chargram_ks=())
    rng = random.Random(8)
    with writer(live_dir, auto_merge=False) as w:
        for i in range(6):
            w.add(f"D-{i:03d}", make_text(rng))
        w.flush()
        w.delete("D-001")
    reg = obs.get_registry()
    assert reg.get("ingest.docs_added") == 6
    assert reg.get("ingest.docs_deleted") == 1
    assert reg.get("ingest.flushes") == 2
    assert reg.get("generation.commits") == 2
    assert reg.get("ingest.wal_appends") == 7
    assert reg.gauges()["generation.current"] == 2
    assert reg.gauges()["generation.tombstones"] == 1


def test_no_cuda_means_no_silent_cpu(tmp_path, monkeypatch):
    """Without CUDA, the writer, drop_docs and compact raise unless asked
    for the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    live_dir = str(tmp_path / "live")
    LiveIndex.create(live_dir, num_shards=N_SHARDS, chargram_ks=())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IngestWriter(live_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compact(LiveIndex.open(live_dir))
    src = scratch_build(tmp_path, {"D-1": "a b", "D-2": "c d"}, "src")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        drop_docs(src, str(tmp_path / "out"), ["D-1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scorer.load_generation(src)
    assert lease_holder(live_dir) is None


# ---------------------------------------------------------------------------
# serving a compacted generation (d)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def compacted(tmp_path_factory):
    """A live dir fed through flushes, an auto-merge, updates and deletes,
    then fully compacted; and the port's one-shot build over its
    surviving docs."""
    tmp = tmp_path_factory.mktemp("compacted")
    live_dir = str(tmp / "live")
    LiveIndex.create(live_dir, num_shards=N_SHARDS)
    rng = random.Random(21)
    surviving = {}
    with IngestWriter(live_dir, buffer_docs=9, auto_merge=True,
                      device="cpu") as w:
        for i in range(60):
            d, t = f"D-{i:03d}", make_text(rng)
            w.add(d, t)
            surviving[d] = t
        for i in range(0, 60, 7):
            t = make_text(rng)
            w.update(f"D-{i:03d}", t)
            surviving[f"D-{i:03d}"] = t
        for i in range(3, 60, 11):
            w.delete(f"D-{i:03d}")
            del surviving[f"D-{i:03d}"]
        w.compact_all()
    oracle = scratch_build(tmp, surviving, "oracle")
    return live_dir, oracle


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_load_generation_bitwise_one_shot(compacted, layout):
    """(d) within the port: the compacted generation is the one-shot
    build byte for byte, and serves its top-10 bitwise."""
    live_dir, oracle = compacted
    assert_same_bytes(oracle, resolve_serving(live_dir)[0])
    gen = Scorer.load_generation(live_dir, layout=layout, device="cpu")
    assert gen.generation == LiveIndex.open(live_dir).current_gen()
    one_shot = Scorer.load(oracle, layout=layout, device="cpu")
    assert gen.layout == one_shot.layout == layout
    for scoring in ("tfidf", "bm25"):
        got = gen.search_batch(QUERIES, k=10, scoring=scoring)
        want = one_shot.search_batch(QUERIES, k=10, scoring=scoring)
        for r_got, r_want in zip(got, want):
            assert [(d, np.float32(s).tobytes()) for d, s in r_got] == [
                (d, np.float32(s).tobytes()) for d, s in r_want]
        assert any(len(r) for r in got)


def test_load_generation_equals_jax(compacted, tmp_path):
    """(d) across packages: the JAX package's load_generation of the same
    generation (on a copy, its serving cache apart) gives the same top-10
    doc ids, scores within rtol 1e-5, in both scorings."""
    live_dir, _ = compacted
    twin = str(tmp_path / "twin")
    shutil.copytree(live_dir, twin,
                    ignore=shutil.ignore_patterns("serving-*"))
    for layout in ("dense", "sparse"):
        got_scorer = Scorer.load_generation(live_dir, layout=layout,
                                            device="cpu")
        want_scorer = JaxScorer.load_generation(twin, layout=layout)
        assert got_scorer.generation == want_scorer.generation
        for scoring in ("tfidf", "bm25"):
            got = got_scorer.search_batch(QUERIES, k=10, scoring=scoring)
            want = want_scorer.search_batch(QUERIES, k=10, scoring=scoring)
            for r_got, r_want in zip(got, want):
                assert [d for d, _ in r_got] == [d for d, _ in r_want]
                np.testing.assert_allclose([s for _, s in r_got],
                                           [s for _, s in r_want],
                                           rtol=RTOL)


# ---------------------------------------------------------------------------
# verify_live, the doctor's live report and the command line
# ---------------------------------------------------------------------------


def _cli(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def _scrub(obj):
    """`obj` without the values of path and time keys."""
    if isinstance(obj, dict):
        return {k: "-" if k in _PATHS_TIMES else _scrub(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def test_verify_live_and_doctor_equal_jax(tmp_path):
    """On one live dir the port wrote (two segments, a tombstone, an
    unflushed WAL tail, a stray segment dir): the port's verify_live and
    live doctor report are the JAX package's dicts (paths and times
    aside), through the library and the command line; a tombstone naming
    a doc its segment never indexed fails both verifiers."""
    live = str(tmp_path / "live")
    LiveIndex.create(live, num_shards=2)
    rng = random.Random(4)
    w = writer(live, auto_merge=False)
    for i in range(8):
        w.add(f"D-{i}", make_text(rng))
    w.flush()
    w.add("E-0", "quick brown fox")
    w.delete("D-2")
    w.flush()
    w.add("T-0", "unflushed tail")
    w.abandon()
    os.makedirs(os.path.join(live, "segments", "seg-000099"))
    report = verify_live(live)
    assert report == jax_verify_live(live)
    assert report["num_segments"] == 2 and report["tombstoned"] == 1
    got, want = live_doctor_report(live), jax_live_doctor(live)
    assert _scrub(got) == _scrub(want)
    assert got["wal"]["pending_records"] == 1
    assert got["lease"]["pid"] == os.getpid()
    assert [u["segment"] for u in got["unreferenced_segments"]] == [
        "seg-000099"]
    assert {s["kind"] for s in got["segments"]} == {"base", "delta"}
    assert any("not directly servable" in x for x in got["warnings"])
    assert _scrub(doctor_report(live)) == _scrub(got)
    for cmd in ("verify", "doctor"):
        rc, out, err = _cli(cli_main, [cmd, live])
        rc_j, out_j, err_j = _cli(jax_cli_main, [cmd, live])
        assert rc == rc_j == 0
        assert _scrub(json.loads(out)) == _scrub(json.loads(out_j))
        assert err == err_j
    m = LiveIndex.open(live).manifest()
    LiveIndex.open(live).commit(m["segments"],
                                {m["segments"][0]: ["GHOST-DOC"]},
                                m["docs"], note="bad")
    with pytest.raises(faults.IntegrityError, match="never indexed"):
        verify_live(live)
    with pytest.raises(AssertionError):
        jax_verify_live(live)


def _both_cli(tmp_path, argv_of):
    """One command through both packages' command lines, each on its own
    live dir (`argv_of(live_dir, device flags)` builds the argv): the
    two JSON outputs scrubbed of paths and times."""
    outs = []
    for name, main, dev in (("jax", jax_cli_main, ["--backend", "cpu"]),
                            ("port", cli_main, ["--device", "cpu"])):
        argv = argv_of(str(tmp_path / name), dev)
        rc, out, err = _cli(main, argv)
        assert rc == 0, (name, argv, err[-2000:])
        outs.append(_scrub(json.loads(out.strip().splitlines()[-1])))
    return outs


def test_cli_ingest_compact_generations_equal_jax(tmp_path):
    """`ingest` (init, add, update, delete, merge, gc), `compact` (drain
    and --all), `generations` (-n, --gc) and `verify` through both
    command lines: the same JSON keys and values, paths and times aside;
    the compacted segment the same bytes. The error paths exit 1."""
    rng = random.Random(9)
    base = write_trec(tmp_path / "base.trec", {
        f"D-{i:02d}": make_text(rng) for i in range(14)})
    more = write_trec(tmp_path / "more.trec", {
        f"E-{i:02d}": make_text(rng) for i in range(5)})
    upd = write_trec(tmp_path / "upd.trec", {
        "D-03": make_text(rng), "N-01": make_text(rng)})
    steps = [
        lambda d, dev: ["ingest", d, "--init", "--add", base, "--shards",
                        "3", "--buffer-docs", "4", "--no-auto-merge",
                        *dev],
        lambda d, dev: ["ingest", d, "--add", more, "--update", upd,
                        "--delete", "D-05", "D-99", "--merge",
                        "--buffer-docs", "3", *dev],
        lambda d, dev: ["compact", d, *dev],
        lambda d, dev: ["ingest", d, "--delete", "D-06", "--gc", *dev],
        lambda d, dev: ["compact", d, "--all", "--gc", *dev],
        lambda d, dev: ["generations", d],
        lambda d, dev: ["generations", d, "-n", "2", "--gc"],
        lambda d, dev: ["verify", d],
    ]
    for step in steps:
        want, got = _both_cli(tmp_path, step)
        assert got == want
    assert got["live"] and got["num_segments"] == 1
    assert_same_bytes(resolve_serving(str(tmp_path / "jax"))[0],
                      resolve_serving(str(tmp_path / "port"))[0])
    rc, _out, err = _cli(cli_main, ["ingest", str(tmp_path / "port"),
                                    "--add", base, "--device", "cpu"])
    assert rc == 1 and err.startswith("error: docid")
    rc, _out, err = _cli(cli_main, ["compact", str(tmp_path / "nope"),
                                    "--device", "cpu"])
    assert rc == 1 and "not a live index" in err


@pytest.mark.parametrize("flag", ["--swap-bench"])
def test_cli_benches_name_the_later_slice(tmp_path, flag):
    """--swap-bench, which came with the shard workers, runs the
    micro-bench on a live dir it creates (--soak-bench, which came with
    the elastic fleet, runs in tests/test_torch_worker.py)."""
    rc, out, err = _cli(cli_main, ["ingest", str(tmp_path / "live"), flag,
                                   "--device", "cpu"])
    report = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and report["generations_seen"] == [
        report["generation_a"], report["generation_b"]]
    assert os.path.exists(tmp_path / "live")
