"""The write-ahead log and the writer lease: durability for the ingest
buffer (the port's copy of `tpu_ir/index/wal.py`, byte for byte the same
files).

A commit of the live index (index/segments.py) is crash-atomic, but the
IngestWriter's buffer is process memory: without a log, a crash between
an acknowledged `add`/`update`/`delete` and the next flush would lose it.
Every acknowledged mutation is therefore framed into the log first:

    live_dir/wal/
      LEASE                   heartbeat writer lease (single-writer lock)
      wal-000000000001.log    CRC-framed records, named by first seq

One record a mutation: a 16-byte little-endian header (crc32, payload
length, sequence number) and a compact sorted-key JSON payload. The CRC
covers length, seq and payload, so torn and rotten records differ:

- a record whose bytes run out at end-of-file is a torn tail (the writer
  died mid-append): it is truncated loudly (the counter
  `ingest.wal_torn_tail_truncated`, a warning in the log and a
  `wal_torn_tail` flight record) and ingest
  goes on, since an unacknowledged suffix may be lost;
- a bad CRC with more records after it is bit-rot: an IntegrityError
  naming the sequence range, since skipping the middle of an
  acknowledged history would un-acknowledge writes.

`append()` flushes to the OS on every record (a process death never
loses an acknowledged write) and fsyncs every TPU_IR_WAL_FSYNC_DOCS
records or TPU_IR_WAL_FSYNC_MS milliseconds (a host power loss can lose
at most one batch).

Exactly-once recovery is the watermark protocol: every generation
manifest records the highest sequence number it reflects
(`manifest["wal"]["seq"]`), a reopening writer replays exactly the suffix
past it, and replay changes only memory until the next flush commits, so
a writer killed mid-replay replays the same suffix again. Once a
watermark commits, `commit()` rotates the log and deletes every segment
the watermark covers.

`WriterLease` enforces one writer process per live dir: a fresh
heartbeat from a live pid refuses a second opener with `WriterLeaseHeld`;
a stale heartbeat or a dead holder is taken over. Within one process the
discipline stays the caller's (a same-pid reacquire is quiet).
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
import zlib

from .. import faults
from ..obs import flight_dump, get_registry
from ..obs import trace as obs_trace

logger = logging.getLogger(__name__)

WAL_DIR = "wal"
LEASE_FILE = "LEASE"

# header: crc32(length || seq || payload), payload length, sequence
_HEADER = struct.Struct("<IIQ")


def wal_dir(live_dir: str) -> str:
    return os.path.join(live_dir, WAL_DIR)


def _segment_name(start_seq: int) -> str:
    return f"wal-{start_seq:012d}.log"


def list_segments(live_dir: str) -> list[tuple[int, str]]:
    """[(first sequence number, path)] ascending; [] when no WAL yet."""
    root = wal_dir(live_dir)
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        if name.startswith("wal-") and name.endswith(".log"):
            try:
                out.append((int(name[4:-4]), os.path.join(root, name)))
            except ValueError:
                continue
    return sorted(out)


def _crc(length: int, seq: int, payload: bytes) -> int:
    return zlib.crc32(struct.pack("<IQ", length, seq) + payload)


def _scan_file(path: str, expect_seq: int | None):
    """Parse one WAL segment: (records, good_bytes, torn_detail).
    `records` is [(seq, payload dict)], `good_bytes` the offset past the
    last intact record (the truncation point of a torn tail), and
    `torn_detail` a description when the last record is torn, else None.
    Bit-rot before end-of-file raises IntegrityError."""
    with open(path, "rb") as f:
        data = f.read()
    records: list[tuple[int, dict]] = []
    off = 0
    n = len(data)
    while off < n:
        if off + _HEADER.size > n:
            return records, off, (f"{n - off} trailing header byte(s) "
                                  "at end of file")
        crc, length, seq = _HEADER.unpack_from(data, off)
        end = off + _HEADER.size + length
        if end > n:
            return records, off, (f"record seq {seq} claims {length} "
                                  f"payload bytes, {n - off - _HEADER.size}"
                                  " present")
        payload = data[off + _HEADER.size:end]
        if _crc(length, seq, payload) != crc:
            if end == n:
                # the bad bytes touch EOF: a death mid-append, not rot
                return records, off, f"record seq {seq} CRC mismatch at tail"
            raise faults.IntegrityError(
                path, f"WAL bit-rot at offset {off}: record seq {seq} "
                f"fails CRC with {n - end} intact byte(s) after it — "
                f"sequence range {seq}..? is unrecoverable "
                "(restore from backup)")
        if expect_seq is not None and seq != expect_seq:
            raise faults.IntegrityError(
                path, f"WAL sequence break at offset {off}: found seq "
                f"{seq}, expected {expect_seq}")
        try:
            rec = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as e:
            raise faults.IntegrityError(
                path, f"WAL record seq {seq} payload unreadable despite "
                f"a matching CRC: {e!r}") from e
        records.append((seq, rec))
        if expect_seq is not None:
            expect_seq += 1
        off = end
    return records, off, None


def read_records(live_dir: str, after_seq: int = 0, *,
                 truncate_torn: bool = False) -> tuple[list, dict]:
    """Every intact record with seq > `after_seq`, in order, and a scan
    summary {segments, records, torn_tail, truncated_bytes}. A torn last
    record is dropped and, with `truncate_torn`, cut off the file so the
    next writer appends over clean bytes (counted and logged, never
    raised). Rot before the end raises IntegrityError. A missing or empty
    WAL dir is a clean no-op."""
    segs = list_segments(live_dir)
    out: list[tuple[int, dict]] = []
    info = {"segments": len(segs), "records": 0, "torn_tail": False,
            "truncated_bytes": 0}
    expect = None
    for i, (start_seq, path) in enumerate(segs):
        records, good, torn = _scan_file(path, expect)
        if records:
            expect = records[-1][0] + 1
        if torn is not None:
            if i != len(segs) - 1:
                # a tear can only be at the very end of the log
                raise faults.IntegrityError(
                    path, f"non-final WAL segment is truncated: {torn}")
            size = os.path.getsize(path)
            info["torn_tail"] = True
            info["truncated_bytes"] = size - good
            if truncate_torn:
                with open(path, "r+b") as f:
                    f.truncate(good)
                get_registry().incr("ingest.wal_torn_tail_truncated")
                # the same fields go to the log and to a flight record
                torn_info = {"path": path, "detail": torn,
                             "truncated_bytes": size - good,
                             "last_good_seq": records[-1][0] if records
                             else start_seq - 1}
                logger.warning("wal_torn_tail: %s",
                               json.dumps(torn_info, sort_keys=True))
                flight_dump("wal_torn_tail", extra=torn_info)
        for seq, rec in records:
            info["records"] += 1
            if seq > after_seq:
                out.append((seq, rec))
    return out, info


def verify_wal(live_dir: str, watermark: int = 0) -> dict:
    """Read-only WAL health for verify_live and the doctor: record counts,
    the replay backlog past `watermark` and whether the tail is torn.
    Rot raises IntegrityError; a torn tail is reported."""
    records, info = read_records(live_dir, after_seq=int(watermark),
                                 truncate_torn=False)
    return {
        "watermark": int(watermark),
        "segments": info["segments"],
        "records": info["records"],
        "pending_records": len(records),
        "torn_tail": info["torn_tail"],
    }


class WriteAheadLog:
    """The writer's append/commit handle over one live dir's WAL. Not
    thread-safe (its IngestWriter is not either)."""

    def __init__(self, live_dir: str, *, start_seq: int | None = None,
                 fsync_docs: int | None = None,
                 fsync_ms: float | None = None):
        from .. import envvars

        self.live_dir = live_dir
        self.fsync_docs = (fsync_docs if fsync_docs is not None
                           else envvars.get_int("TPU_IR_WAL_FSYNC_DOCS"))
        self.fsync_ms = (fsync_ms if fsync_ms is not None
                         else envvars.get_float("TPU_IR_WAL_FSYNC_MS"))
        os.makedirs(wal_dir(live_dir), exist_ok=True)
        self._segments = list_segments(live_dir)
        if start_seq is None:
            start_seq = 1
            if self._segments:
                records, _good, _torn = _scan_file(self._segments[-1][1],
                                                   None)
                start_seq = ((records[-1][0] + 1) if records
                             else self._segments[-1][0])
        self._next_seq = int(start_seq)
        if self._segments:
            self._tail_start, tail_path = self._segments[-1]
            self._f = open(tail_path, "ab")
        else:
            self._open_new_segment()
        self._pending = 0
        self._last_fsync = time.monotonic()

    def _open_new_segment(self) -> None:
        self._tail_start = self._next_seq
        path = os.path.join(wal_dir(self.live_dir),
                            _segment_name(self._tail_start))
        self._f = open(path, "ab")
        self._segments = list_segments(self.live_dir)

    @property
    def last_seq(self) -> int:
        return self._next_seq - 1

    def append(self, record: dict, *, key: str | None = None) -> int:
        """Frame and write one record; returns its sequence number. The
        write reaches the OS before this returns (fsync is batched)."""
        faults.maybe_crash("ingest.wal_append", key)
        with obs_trace("ingest.wal_append") as sp:
            seq = self._next_seq
            sp.set("seq", seq)
            payload = json.dumps(record, sort_keys=True,
                                 separators=(",", ":")).encode("utf-8")
            frame = _HEADER.pack(_crc(len(payload), seq, payload),
                                 len(payload), seq) + payload
            if faults.should_fire("ingest.wal_torn", key) is not None:
                # the torn tail a death mid-append leaves: half the
                # frame reaches the OS, then the "process" dies
                self._f.write(frame[:max(1, len(frame) // 2)])
                self._f.flush()
                raise faults.InjectedCrash(
                    f"injected torn WAL record at seq {seq}")
            self._f.write(frame)
            self._f.flush()
            self._next_seq = seq + 1
            reg = get_registry()
            reg.incr("ingest.wal_appends")
            reg.incr("ingest.wal_bytes", len(frame))
            self._pending += 1
            if (self._pending >= max(self.fsync_docs, 1)
                    or (time.monotonic() - self._last_fsync) * 1e3
                    >= self.fsync_ms):
                self.sync()
        return seq

    def sync(self) -> None:
        """The batched fsync, now (a flush calls this before its segment
        build: the log must be at least as durable as what derives from
        it)."""
        with obs_trace("ingest.wal_fsync") as sp:
            sp.set("pending", self._pending)
            self._f.flush()
            os.fsync(self._f.fileno())
            if self._pending:
                get_registry().incr("ingest.wal_fsyncs")
            self._pending = 0
            self._last_fsync = time.monotonic()

    def commit(self, watermark: int) -> int:
        """A manifest recording `watermark` just committed: rotate the
        live segment if the watermark covers it, then delete every segment
        whose records are all <= watermark. Returns the number retired. A
        death between deletions (`ingest.wal_retire`) leaves covered
        segments that replay's seq filter ignores and the next commit
        retires."""
        watermark = int(watermark)
        if (self._next_seq - 1 <= watermark
                and self._next_seq > self._tail_start):
            # tail fully covered and non-empty: rotate so it can retire
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            self._open_new_segment()
            self._pending = 0
        retired = 0
        segs = list_segments(self.live_dir)
        reg = get_registry()
        for i, (start_seq, path) in enumerate(segs):
            if start_seq == self._tail_start:
                continue
            # the segment's last record precedes the next one's first
            next_start = (segs[i + 1][0] if i + 1 < len(segs)
                          else self._next_seq)
            if next_start - 1 <= watermark:
                faults.maybe_crash("ingest.wal_retire",
                                   os.path.basename(path))
                try:
                    os.unlink(path)
                except OSError:
                    continue
                retired += 1
                reg.incr("ingest.wal_segments_retired")
        if retired:
            self._segments = list_segments(self.live_dir)
        return retired

    def close(self) -> None:
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
        except (OSError, ValueError):
            pass
        self._f.close()


# ---------------------------------------------------------------------------
# the writer lease
# ---------------------------------------------------------------------------


class WriterLeaseHeld(RuntimeError):
    """A second writer tried to open a live dir whose lease has a fresh
    heartbeat from a live process."""

    def __init__(self, path: str, holder: dict, age_s: float):
        self.path = path
        self.holder = holder
        self.age_s = age_s
        super().__init__(
            f"live dir is owned by another writer (pid "
            f"{holder.get('pid')}, heartbeat {age_s:.1f}s ago): {path} — "
            "close it, or wait TPU_IR_WAL_LEASE_TTL_S for the lease to "
            "go stale")


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True
    return True


class WriterLease:
    """Heartbeat lease file: one writer process per live dir.

    acquire(): a fresh heartbeat from a live foreign pid raises
    WriterLeaseHeld (`ingest.lease_conflicts`); a stale heartbeat or a
    dead holder is taken over (`ingest.lease_takeovers`); a same-pid
    holder reacquires quietly. A daemon thread refreshes the heartbeat at
    ttl/4 until release(): a SIGKILLed holder stops heartbeating and its
    pid dies, so takeover happens at the next open, with no wait."""

    def __init__(self, live_dir: str, *, ttl_s: float | None = None):
        from .. import envvars

        self.path = os.path.join(wal_dir(live_dir), LEASE_FILE)
        self.ttl_s = (ttl_s if ttl_s is not None
                      else envvars.get_float("TPU_IR_WAL_LEASE_TTL_S"))
        self.token = f"{os.getpid()}-{id(self):x}-{time.time_ns():x}"
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _read(self) -> dict | None:
        try:
            with open(self.path, encoding="utf-8") as f:
                holder = json.load(f)
        except (OSError, ValueError):
            return None
        return holder if isinstance(holder, dict) else None

    def _write(self) -> None:
        tmp = self.path + f".tmp-{self.token}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"pid": os.getpid(), "token": self.token,
                       "heartbeat": time.time()}, f)
        os.replace(tmp, self.path)

    def acquire(self) -> dict:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        holder = self._read()
        reg = get_registry()
        out = {"taken_over": False}
        if holder is not None:
            pid = int(holder.get("pid", -1))
            age = time.time() - float(holder.get("heartbeat", 0.0))
            if pid != os.getpid() and age < self.ttl_s and _pid_alive(pid):
                reg.incr("ingest.lease_conflicts")
                raise WriterLeaseHeld(self.path, holder, age)
            if pid != os.getpid():
                reg.incr("ingest.lease_takeovers")
                out = {"taken_over": True, "previous_pid": pid,
                       "previous_age_s": round(age, 3)}
        self._write()
        reg.incr("ingest.lease_acquired")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name="tpu-ir-wal-lease")
        self._thread.start()
        return out

    def _heartbeat_loop(self) -> None:
        interval = max(self.ttl_s / 4.0, 0.05)
        while not self._stop.wait(interval):
            try:
                self._write()
            except OSError:
                continue

    def heartbeat(self) -> None:
        self._write()

    def owned(self) -> bool:
        holder = self._read()
        return bool(holder) and holder.get("token") == self.token

    def release(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.owned():
            try:
                os.unlink(self.path)
            except OSError:
                pass


def lease_holder(live_dir: str) -> dict | None:
    """The current LEASE payload with its freshness; None when no writer
    holds (or ever held) it."""
    path = os.path.join(wal_dir(live_dir), LEASE_FILE)
    try:
        with open(path, encoding="utf-8") as f:
            holder = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(holder, dict):
        return None
    age = time.time() - float(holder.get("heartbeat", 0.0))
    pid = int(holder.get("pid", -1))
    return {"pid": pid, "heartbeat_age_s": round(age, 3),
            "alive": _pid_alive(pid)}
