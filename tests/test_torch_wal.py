"""The port's durable ingest on the CPU (tpu_ir_torch.index.wal, ingest,
backup, and serving.soak's feeder child): WAL framing and its corruption
taxonomy, the writer lease, replay, backup and restore, and the SIGKILL
crash matrix, in tests/test_wal.py's terms.

(c) The matrix kills a real child process (the port's feeder on
`--device cpu`, an injected fault turned into a raw SIGKILL) at every
declared ingest fault site; the recovered live dir must hold the bytes
(sha256 of every artifact) of a writer that never crashed, with no
acknowledged document lost. One feed through both packages writes the
same WAL bytes."""

import contextlib
import filecmp
import hashlib
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

from tpu_ir.cli import main as jax_cli_main
from tpu_ir.index.ingest import IngestWriter as JaxWriter
from tpu_ir.index.segments import LiveIndex as JaxLive

from tpu_ir_torch import faults, obs
from tpu_ir_torch.cli import main as cli_main
from tpu_ir_torch.index.backup import backup_live, restore_live
from tpu_ir_torch.index.ingest import IngestWriter
from tpu_ir_torch.index.segments import LiveIndex
from tpu_ir_torch.index.verify import verify_live
from tpu_ir_torch.index.wal import (
    LEASE_FILE,
    WriteAheadLog,
    WriterLease,
    WriterLeaseHeld,
    lease_holder,
    list_segments,
    read_records,
    verify_wal,
    wal_dir,
)
from tpu_ir_torch.serving.soak import _feed_doc, _spawn_feeder


@pytest.fixture(autouse=True)
def _clean_port_state():
    faults.clear()
    obs.reset_all()
    yield
    faults.clear()
    obs.reset_all()


def _mklive(path) -> str:
    # chargram_ks=(): durability, not char-gram recall, is under test
    LiveIndex.create(str(path), num_shards=2, chargram_ks=())
    return str(path)


def _writer(live_dir, **kw):
    return IngestWriter(live_dir, device="cpu", **kw)


def _final_digests(live_dir: str) -> dict:
    """sha256 of every artifact of the one segment of the current
    (compacted) generation, the job reports aside."""
    live = LiveIndex.open(live_dir)
    m = live.manifest(live.current_gen())
    assert len(m["segments"]) == 1 and not m["tombstones"], (
        f"expected one compacted segment, got {m['segments']}")
    seg = live.segment_path(m["segments"][0])
    out = {}
    for name in sorted(os.listdir(seg)):
        path = os.path.join(seg, name)
        if name != "jobs" and os.path.isfile(path):
            with open(path, "rb") as f:
                out[name] = hashlib.sha256(f.read()).hexdigest()
    assert "metadata.json" in out and len(out) >= 6
    return out


def _watermark(live_dir: str) -> int:
    live = LiveIndex.open(live_dir)
    return live.manifest(live.current_gen()).get("wal", {}).get("seq", 0)


# ---------------------------------------------------------------------------
# WAL framing
# ---------------------------------------------------------------------------


def test_wal_append_read_rotate_retire(tmp_path):
    d = str(tmp_path)
    reg = obs.get_registry()
    w = WriteAheadLog(d, fsync_docs=2, fsync_ms=1e9)
    for i in range(5):
        seq = w.append({"op": "add", "docid": f"D{i}", "text": "x"},
                       key=f"D{i}")
        assert seq == i + 1
    assert w.last_seq == 5
    assert reg.get("ingest.wal_fsyncs") >= 2   # 5 appends, fsync_docs 2
    records, info = read_records(d)
    assert [s for s, _ in records] == [1, 2, 3, 4, 5]
    assert records[2][1]["docid"] == "D2" and not info["torn_tail"]
    # a watermark short of the tail retires nothing
    w.commit(3)
    assert reg.get("ingest.wal_segments_retired") == 0
    assert read_records(d, after_seq=3)[0] == records[3:]
    # full coverage rotates the tail and retires the covered segment
    w.commit(5)
    assert reg.get("ingest.wal_segments_retired") == 1
    segs = list_segments(d)
    assert len(segs) == 1 and segs[0][0] == 6
    assert read_records(d, after_seq=5)[0] == []
    assert w.append({"op": "add", "docid": "D5", "text": "x"},
                    key="D5") == 6
    w.close()
    assert verify_wal(d, watermark=5) == {
        "watermark": 5, "segments": 1, "records": 1,
        "pending_records": 1, "torn_tail": False}


def test_wal_missing_or_empty_is_noop(tmp_path):
    d = str(tmp_path)
    records, info = read_records(d)
    assert records == [] and info["segments"] == 0
    os.makedirs(wal_dir(d))
    assert read_records(d) == ([], info)
    open(os.path.join(wal_dir(d), "wal-000000000001.log"), "w").close()
    records, info = read_records(d)
    assert records == [] and not info["torn_tail"]


def _write_three(d: str) -> str:
    w = WriteAheadLog(d, fsync_docs=1)
    for i in range(3):
        w.append({"op": "add", "docid": f"D{i}", "text": "payload"},
                 key=f"D{i}")
    w.close()
    return list_segments(d)[0][1]


def test_torn_tail_truncates_and_continues(tmp_path, caplog):
    d = str(tmp_path)
    path = _write_three(d)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 5)   # the writer died mid-append of record 3
    # the read-only scan reports the tear and changes nothing
    records, info = read_records(d)
    assert [s for s, _ in records] == [1, 2]
    assert info["torn_tail"] and info["truncated_bytes"] > 0
    assert os.path.getsize(path) == size - 5
    # the writer-open path cuts it, counted and logged
    with caplog.at_level("WARNING", logger="tpu_ir_torch.index.wal"):
        records, info = read_records(d, truncate_torn=True)
    assert [s for s, _ in records] == [1, 2]
    assert obs.get_registry().get("ingest.wal_torn_tail_truncated") == 1
    assert os.path.getsize(path) < size - 5
    logged = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("wal_torn_tail: ")]
    assert len(logged) == 1
    fields = json.loads(logged[0][len("wal_torn_tail: "):])
    assert fields["last_good_seq"] == 2 and fields["path"] == path
    assert fields["truncated_bytes"] == info["truncated_bytes"]
    # the next writer appends over clean bytes, reusing seq 3
    w = WriteAheadLog(d)
    assert w.append({"op": "add", "docid": "D2b", "text": "x"},
                    key="D2b") == 3
    w.close()
    assert [s for s, _ in read_records(d)[0]] == [1, 2, 3]


def test_midfile_bitrot_raises_integrity_error(tmp_path):
    d = str(tmp_path)
    path = _write_three(d)
    with open(path, "r+b") as f:
        f.seek(20)
        byte = f.read(1)
        f.seek(20)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(faults.IntegrityError, match="bit-rot"):
        read_records(d)
    with pytest.raises(faults.IntegrityError):
        verify_wal(d)


def test_wal_bytes_equal_jax(tmp_path):
    """One feed (adds, updates with unicode and quotes, deletes, a flush
    and an unflushed tail) through both packages' writers: every WAL
    segment file is byte for byte the JAX package's."""
    texts = ["alpha text", "béta \"quoted\" text", "gamma\nsecond line",
             "delta ∆ text"]

    def feed(writer_cls, live_cls, d, **kw):
        live_cls.create(d, num_shards=2, chargram_ks=())
        w = writer_cls(d, buffer_docs=100, auto_merge=False, **kw)
        for i, t in enumerate(texts):
            w.add(f"D{i}", t)
        w.update("D1", "béta again")
        w.flush()
        w.delete("D2")
        w.update("D9", texts[3])
        w.abandon()

    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    feed(JaxWriter, JaxLive, jdir)
    feed(IngestWriter, LiveIndex, pdir, device="cpu")
    jsegs = [os.path.basename(p) for _, p in list_segments(jdir)]
    psegs = [os.path.basename(p) for _, p in list_segments(pdir)]
    assert psegs == jsegs and psegs
    for name in psegs:
        assert filecmp.cmp(os.path.join(wal_dir(jdir), name),
                           os.path.join(wal_dir(pdir), name), shallow=False)
    assert read_records(pdir, after_seq=_watermark(pdir))[0] == [
        (6, {"op": "delete", "docid": "D2"}),
        (7, {"op": "update", "docid": "D9", "text": texts[3]})]


# ---------------------------------------------------------------------------
# the writer lease
# ---------------------------------------------------------------------------


def _write_lease(d: str, pid: int, heartbeat: float) -> None:
    os.makedirs(wal_dir(d), exist_ok=True)
    with open(os.path.join(wal_dir(d), LEASE_FILE), "w") as f:
        json.dump({"pid": pid, "token": "foreign", "heartbeat": heartbeat},
                  f)


def _dead_pid() -> int:
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    return child.pid


def test_lease_conflict_stale_and_dead_takeover(tmp_path):
    d = str(tmp_path)
    reg = obs.get_registry()
    # a fresh heartbeat from a live foreign pid (pid 1 is always alive)
    _write_lease(d, 1, time.time())
    with pytest.raises(WriterLeaseHeld) as ei:
        WriterLease(d, ttl_s=30.0).acquire()
    assert ei.value.holder["pid"] == 1 and ei.value.age_s < 30.0
    assert reg.get("ingest.lease_conflicts") == 1
    # a stale heartbeat: taken over, with who was evicted
    _write_lease(d, 1, time.time() - 999.0)
    lease = WriterLease(d, ttl_s=30.0)
    info = lease.acquire()
    assert info["taken_over"] and info["previous_pid"] == 1
    lease.release()
    # a fresh heartbeat from a dead holder: taken over at once
    pid = _dead_pid()
    _write_lease(d, pid, time.time())
    lease = WriterLease(d, ttl_s=30.0)
    info = lease.acquire()
    assert info["taken_over"] and info["previous_pid"] == pid
    assert reg.get("ingest.lease_takeovers") == 2
    holder = lease_holder(d)
    assert holder["pid"] == os.getpid() and holder["alive"]
    lease.release()
    assert lease_holder(d) is None


def test_ingest_writer_refuses_foreign_live_lease(tmp_path):
    d = _mklive(tmp_path / "live")
    _write_lease(d, 1, time.time())
    with pytest.raises(WriterLeaseHeld):
        _writer(d, auto_merge=False)
    os.unlink(os.path.join(wal_dir(d), LEASE_FILE))
    with _writer(d, auto_merge=False) as w:
        assert not w.lease_info["taken_over"]
    assert lease_holder(d) is None   # a clean close releases it


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


def test_replay_recovers_mixed_ops(tmp_path):
    d = _mklive(tmp_path / "live")
    w = _writer(d, buffer_docs=100, auto_merge=False)
    w.add("D1", "alpha text")
    w.add("D2", "beta text")
    w.update("D1", "alpha prime")
    assert w.delete("D2")
    w.abandon()   # the crash image: the lease file stays, no flush

    w2 = _writer(d, buffer_docs=100, auto_merge=False)
    assert w2.replayed == 4
    assert not w2.lease_info["taken_over"]   # same pid: quiet
    assert w2.buffered() == 1   # D1 survives, D2's add + delete cancel
    w2.flush()
    assert _watermark(d) == 4
    assert set(w2.live.live_doc_map()) == {"D1"}
    w2.close()
    with _writer(d, auto_merge=False) as w3:
        assert w3.replayed == 0   # replay does not log again


def test_replay_idempotent_when_rekilled_mid_replay(tmp_path):
    d = _mklive(tmp_path / "live")
    w = _writer(d, buffer_docs=100, auto_merge=False)
    for i in range(5):
        w.update(*_feed_doc(i))
    w.abandon()
    # a tiny buffer flushes mid-replay, then the writer dies again
    w2 = _writer(d, buffer_docs=2, auto_merge=False)
    assert w2.replayed == 5
    mid = _watermark(d)
    assert 0 < mid < 5
    w2.abandon()
    w3 = _writer(d, buffer_docs=2, auto_merge=False)
    assert w3.replayed == 5 - mid   # only the suffix past the watermark
    w3.flush()
    assert _watermark(d) == 5
    assert set(w3.live.live_doc_map()) == {
        _feed_doc(i)[0] for i in range(5)}
    w3.close()
    verify_live(d)


def test_wal_disabled_path(tmp_path):
    d = _mklive(tmp_path / "live")
    with _writer(d, buffer_docs=2, auto_merge=False, wal=False) as w:
        w.update("D1", "alpha text")
        w.update("D2", "beta text")   # auto-flush at 2
        assert w.wal is None
    assert not os.path.exists(os.path.join(wal_dir(d), LEASE_FILE))
    assert _watermark(d) == 0
    assert set(LiveIndex.open(d).live_doc_map()) == {"D1", "D2"}


def test_pure_delete_feed_auto_flushes(tmp_path):
    d = _mklive(tmp_path / "live")
    with _writer(d, buffer_docs=3, auto_merge=False) as w:
        for i in range(6):
            w.update(*_feed_doc(i))
        w.flush()
        gen0 = w.live.current_gen()
        # tombstones count toward the threshold on their own
        for i in range(3):
            assert w.delete(_feed_doc(i)[0])
        assert w.live.current_gen() > gen0
        assert w.pending_tombstones() == 0
        assert set(w.live.live_doc_map()) == {
            _feed_doc(i)[0] for i in range(3, 6)}


def test_gc_on_open_and_doctor_unreferenced_warning(tmp_path):
    from tpu_ir_torch.index.doctor import live_doctor_report

    d = _mklive(tmp_path / "live")
    with _writer(d, buffer_docs=1, auto_merge=False) as w:
        w.update(*_feed_doc(0))
    junk = os.path.join(d, "segments", "seg-009999")
    os.makedirs(junk)
    with open(os.path.join(junk, "corpus.txt"), "w") as f:
        f.write("x" * 128)
    report = live_doctor_report(d)
    assert [u["segment"] for u in report["unreferenced_segments"]] == [
        "seg-009999"]
    assert any("unreferenced" in w_ for w_ in report["warnings"])
    with _writer(d, auto_merge=False):
        pass
    assert not os.path.exists(junk)
    assert live_doctor_report(d)["unreferenced_segments"] == []


# ---------------------------------------------------------------------------
# backup / restore
# ---------------------------------------------------------------------------


def test_backup_restore_carries_wal_tail(tmp_path):
    d = _mklive(tmp_path / "live")
    w = _writer(d, buffer_docs=100, auto_merge=False)
    w.update(*_feed_doc(0))
    w.update(*_feed_doc(1))
    w.compact_all()
    # two more acknowledged into the WAL and never flushed
    w.update(*_feed_doc(2))
    w.update(*_feed_doc(3))
    w.abandon()
    bdir = str(tmp_path / "backup")
    summary = backup_live(d, bdir)
    assert summary["wal_segments"] >= 1 and summary["files"] > 3
    assert not os.path.exists(os.path.join(wal_dir(bdir), LEASE_FILE))
    # segments are hardlinked, CURRENT is written
    seg = LiveIndex.open(d).manifest()["segments"][0]
    meta = os.path.join("segments", seg, "metadata.json")
    assert os.path.samefile(os.path.join(d, meta), os.path.join(bdir, meta))
    assert not os.path.samefile(os.path.join(d, "CURRENT"),
                                os.path.join(bdir, "CURRENT"))
    with pytest.raises(ValueError, match="not empty"):
        backup_live(d, bdir)
    rdir = str(tmp_path / "restored")
    report = restore_live(bdir, rdir)
    assert report["restored"] == os.path.abspath(rdir)
    assert report["ok"] and report["wal"]["pending_records"] == 2
    with _writer(rdir, auto_merge=False) as w2:
        assert w2.replayed == 2
        w2.flush()
        assert set(w2.live.live_doc_map()) == {
            _feed_doc(i)[0] for i in range(4)}
    # the source is untouched by the round trip
    assert verify_wal(d, watermark=_watermark(d))["pending_records"] == 2
    # the WAL is copied, never linked: the log's tail is appended in
    # place, so neither the source's nor the restore's writer may reach
    # the snapshot through it
    with _writer(d, auto_merge=False) as w3:
        w3.update(*_feed_doc(9))
    assert verify_wal(bdir, watermark=2)["pending_records"] == 2
    assert set(LiveIndex.open(rdir).live_doc_map()) == {
        _feed_doc(i)[0] for i in range(4)}
    with pytest.raises(ValueError, match="not a backup"):
        restore_live(str(tmp_path), str(tmp_path / "r2"))


def _cli(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_backup_and_restore(tmp_path):
    """`backup` and `backup --restore` through both command lines on two
    live dirs fed alike (a compacted generation, then an unflushed WAL
    tail): the same JSON but for paths (the byte counts are equal once
    the job reports and `created` stamps, which hold times, are made
    equal), and the restore replays the tail."""
    rng_texts = [_feed_doc(i) for i in range(8)]
    for name, writer_cls, live_cls, kw in (
            ("jax", JaxWriter, JaxLive, {}),
            ("port", IngestWriter, LiveIndex, {"device": "cpu"})):
        d = str(tmp_path / name)
        live_cls.create(d, num_shards=2, chargram_ks=())
        w = writer_cls(d, buffer_docs=100, auto_merge=False, **kw)
        for docid, text in rng_texts[:6]:
            w.update(docid, text)
        w.compact_all()
        for docid, text in rng_texts[6:]:
            w.update(docid, text)
        w.abandon()
        os.unlink(os.path.join(wal_dir(d), LEASE_FILE))
        for root, dirs, files in os.walk(d):
            if "jobs" in dirs:
                shutil.rmtree(os.path.join(root, "jobs"))
            for f in files:
                if f == "live.json" or (f.startswith("gen-")
                                        and f.endswith(".json")):
                    path = os.path.join(root, f)
                    with open(path, encoding="utf-8") as fh:
                        obj = json.load(fh)
                    obj["created"] = 0.0
                    with open(path, "w", encoding="utf-8") as fh:
                        json.dump(obj, fh, indent=2, sort_keys=True)
    outs = {}
    for argv_of in (lambda d: ["backup", d, d + "-bk"],
                    lambda d: ["backup", d + "-bk", d + "-rs",
                               "--restore"]):
        for name, main in (("jax", jax_cli_main), ("port", cli_main)):
            rc, out, err = _cli(main, argv_of(str(tmp_path / name)))
            assert rc == 0, err[-2000:]
            got = json.loads(out.strip().splitlines()[-1])
            for key in ("dest", "restored"):
                if key in got:
                    assert got[key] == os.path.abspath(
                        argv_of(str(tmp_path / name))[2])
                    got[key] = "-"
            outs[name] = got
        assert outs["port"] == outs["jax"]
    assert outs["port"]["ok"] and outs["port"]["wal"]["pending_records"] == 2
    with _writer(str(tmp_path / "port-rs"), auto_merge=False) as w:
        assert w.replayed == 2
        w.compact_all()
    assert set(LiveIndex.open(str(tmp_path / "port-rs")).live_doc_map()) \
        == {docid for docid, _ in rng_texts}


# ---------------------------------------------------------------------------
# the SIGKILL crash matrix
# ---------------------------------------------------------------------------

# one entry per ingest.* site of FAULT_SITES
_MATRIX_SITES = (
    "ingest.wal_append",      # dies before the record is framed
    "ingest.wal_torn",        # dies mid-frame: a torn tail on disk
    "ingest.wal_retire",      # dies mid WAL-segment retirement
    "ingest.flush_build",     # dies after the corpus write, pre-build
    "ingest.commit_between",  # dies between manifest and CURRENT
    "ingest.merge",           # dies mid-merge (compaction)
)
_MATRIX_DOCS = 10


def test_matrix_covers_every_ingest_fault_site():
    from tpu_ir_torch.obs.registry import FAULT_SITES

    assert {s for s in FAULT_SITES if s.startswith("ingest.")} == set(
        _MATRIX_SITES)


def _recover_and_finish(live_dir: str) -> None:
    """What an operator does after a crash: open (lease takeover and
    replay), feed what is missing, flush, compact."""
    with _writer(live_dir, buffer_docs=3, auto_merge=False) as w:
        assert w.lease_info["taken_over"]
        w.flush()
        have = w._docs()
        for i in range(_MATRIX_DOCS):
            docid, text = _feed_doc(i)
            if docid not in have:
                w.update(docid, text)
        w.flush()
        w.compact_all()


def test_sigkill_crash_matrix_bit_identical(tmp_path):
    control = _mklive(tmp_path / "control")
    with _writer(control, buffer_docs=3, auto_merge=False) as w:
        for i in range(_MATRIX_DOCS):
            w.update(*_feed_doc(i))
        w.flush()
        w.compact_all()
    want_docs = set(LiveIndex.open(control).live_doc_map())
    want_digests = _final_digests(control)

    # the children run at once, each on its own live dir
    kids = []
    for site in _MATRIX_SITES:
        d = _mklive(tmp_path / site.replace(".", "_"))
        ack = os.path.join(d, "feed.ack")
        open(ack, "w").close()
        proc, _out, err = _spawn_feeder(
            d, ack, 0, _MATRIX_DOCS, device="cpu", buffer_docs=3,
            compact_every=6, fault_plan=f"{site}:once@1")
        kids.append((site, d, ack, proc, err))

    reg = obs.get_registry()
    for site, d, ack, proc, err in kids:
        rc = proc.wait(timeout=240)
        with open(err, encoding="utf-8") as f:
            tail = f.read()[-2000:]
        assert rc == -signal.SIGKILL, (
            f"{site}: child exited rc={rc} (site never fired?): {tail}")
        with open(ack, encoding="utf-8") as f:
            acked = [ln.strip() for ln in f if ln.strip()]
        _recover_and_finish(d)
        got_map = LiveIndex.open(d).live_doc_map()
        lost = [a for a in acked if a not in got_map]
        assert not lost, f"{site}: lost acked docs {lost}"
        assert set(got_map) == want_docs, f"{site}: doc set diverged"
        assert _final_digests(d) == want_digests, (
            f"{site}: the recovered segment differs from the control's")
        assert verify_live(d)["wal"]["pending_records"] == 0
        assert lease_holder(d) is None
    # the torn-frame child left a torn tail the recovery cut
    assert reg.get("ingest.wal_torn_tail_truncated") == 1
