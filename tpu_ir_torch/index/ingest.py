"""IngestWriter: the live index's document write API (the port's copy of
`tpu_ir/index/ingest.py`).

`add` / `update` / `delete` change a bounded in-memory buffer; `flush`
turns the buffer into one delta segment (an ordinary index dir built by
the port's `build_index` on the writer's device: the existing corpus is
never tokenized again) plus per-segment tombstones for every replaced or
deleted on-disk document, committed as the next generation
(index/segments.py). Auto-flush fires at TPU_IR_INGEST_BUFFER_DOCS
buffered docs and pending tombstones; auto-merge runs the tiered
size-ratio policy after every flush.

One IngestWriter per live dir, no internal locks: commits are atomic
renames and readers only ever see committed generations. Across
processes the writer lease (index/wal.py) enforces it: a live second
writer gets WriterLeaseHeld, a stale or dead holder is taken over.

Durability: every acknowledged mutation is framed into the write-ahead
log before it touches the buffer, and every flush records the WAL
high-water mark it folded in on its manifest. Opening a writer therefore
recovers a crashed one exactly once: gc() the crash debris (a half-built
segment dir included), then replay the WAL suffix past the current
manifest's watermark into the buffer.

The writer runs its segment builds, drops and merges on `device` (CUDA
by default; pass device="cpu" to ingest on the CPU).
"""

from __future__ import annotations

import os
import re
import time

import torch

from .. import faults, resolve_device
from ..obs import get_registry
from ..obs import trace as obs_trace
from .segments import LiveIndex, compact, plan_merges

# markup that would corrupt the TREC framing of the buffered corpus,
# refused at add() time rather than mis-parsed at flush
_TEXT_FORBIDDEN = ("<DOC", "</DOC", "<TEXT", "</TEXT", "<DOCNO", "</DOCNO")


def _check_doc(docid: str, text: str) -> None:
    if not docid or any(c.isspace() for c in docid) or "<" in docid \
            or ">" in docid:
        raise ValueError(f"invalid docid {docid!r}: docids must be "
                         "non-empty and markup/whitespace-free")
    up = text.upper()
    bad = next((t for t in _TEXT_FORBIDDEN if t in up), None)
    if bad is not None:
        raise ValueError(f"document {docid!r} text contains TREC markup "
                         f"({bad}...) — it would corrupt the corpus "
                         "framing at flush")


class IngestWriter:
    """Buffered add/update/delete over one live index.

      - `add(docid, text)`: a new document; an existing live docid (on
        disk or buffered) raises (replacement is what `update` is for);
      - `update(docid, text)`: upsert; an on-disk copy is tombstoned in
        its segment and the new text buffers;
      - `delete(docid)`: removes a live document; False for an unknown
        docid (an idempotent feed);
      - `flush()`: buffer -> delta segment + tombstones -> committed
        generation; the new manifest, or None with nothing to commit.

    Not thread-safe: one writer per live dir."""

    def __init__(self, live_dir: str, *, buffer_docs: int | None = None,
                 auto_merge: bool | None = None,
                 wal: bool | None = None,
                 device: str | torch.device | None = None):
        from .. import envvars

        self.live = LiveIndex.open(live_dir)
        self.device = resolve_device(device)
        self.buffer_docs = (buffer_docs if buffer_docs is not None
                            else envvars.get_int(
                                "TPU_IR_INGEST_BUFFER_DOCS"))
        # None defers to TPU_IR_MERGE_AUTO: 0 leaves merges to `compact`
        self.auto_merge = (auto_merge if auto_merge is not None
                           else envvars.get_bool("TPU_IR_MERGE_AUTO"))
        self._buf: dict[str, str] = {}   # docid -> text, arrival order
        self._tombs: dict[str, set] = {}  # segment -> dead docids
        self._doc_seg: dict[str, str] | None = None  # lazy live view
        self._wal_enabled = (wal if wal is not None
                             else envvars.get_bool("TPU_IR_WAL"))
        self.wal = None
        self._lease = None
        self._wal_seq = 0   # last sequence number appended or replayed
        self.replayed = 0   # records recovered by this open
        if not self._wal_enabled:
            self.live.gc()
            return
        from .wal import WriteAheadLog, WriterLease

        self._lease = WriterLease(live_dir)
        self.lease_info = self._lease.acquire()
        try:
            # crash hygiene before replay: a death mid-build strands a
            # half-built dir nothing names, a death between the manifest
            # write and the CURRENT flip an orphan manifest the next
            # commit overwrites; gc() clears the one, replay re-derives
            # the rest from the log
            self.live.gc()
            self._replay()
            self.wal = WriteAheadLog(live_dir, start_seq=self._wal_seq + 1)
        except BaseException:
            self._lease.release()
            raise

    # -- the live-document view -------------------------------------------

    def _docs(self) -> dict:
        if self._doc_seg is None:
            self._doc_seg = self.live.live_doc_map()
            # pending (uncommitted) tombstones still shadow the disk view
            for seg, dead in self._tombs.items():
                for d in dead:
                    if self._doc_seg.get(d) == seg:
                        del self._doc_seg[d]
        return self._doc_seg

    def buffered(self) -> int:
        return len(self._buf)

    def pending_tombstones(self) -> int:
        return sum(len(t) for t in self._tombs.values())

    # -- mutations ---------------------------------------------------------
    #
    # Every public mutation is: validate -> WAL append (the durability
    # acknowledgment) -> the in-memory application replay also runs ->
    # counter -> flush check. The _apply_* bodies validate and log
    # nothing: they are exactly what `_replay` re-runs.

    def _wal_append(self, record: dict, *, key: str) -> None:
        if self.wal is not None:
            self._wal_seq = self.wal.append(record, key=key)

    def _apply_add(self, docid: str, text: str) -> None:
        self._buf[docid] = text

    def _apply_update(self, docid: str, text: str) -> None:
        seg = self._docs().get(docid)
        if seg is not None:
            self._tombs.setdefault(seg, set()).add(docid)
            del self._doc_seg[docid]
        self._buf[docid] = text

    def _apply_delete(self, docid: str) -> bool:
        if docid in self._buf:
            del self._buf[docid]
            return True
        seg = self._docs().get(docid)
        if seg is None:
            return False
        self._tombs.setdefault(seg, set()).add(docid)
        del self._doc_seg[docid]
        return True

    def add(self, docid: str, text: str) -> None:
        _check_doc(docid, text)
        if docid in self._buf or docid in self._docs():
            raise ValueError(f"docid {docid!r} already exists — use "
                             "update() to replace it")
        self._wal_append({"op": "add", "docid": docid, "text": text},
                         key=docid)
        self._apply_add(docid, text)
        get_registry().incr("ingest.docs_added")
        self._maybe_flush()

    def update(self, docid: str, text: str) -> None:
        _check_doc(docid, text)
        self._wal_append({"op": "update", "docid": docid, "text": text},
                         key=docid)
        self._apply_update(docid, text)
        get_registry().incr("ingest.docs_updated")
        self._maybe_flush()

    def delete(self, docid: str) -> bool:
        if docid not in self._buf and self._docs().get(docid) is None:
            # an unknown docid changes nothing, so nothing is logged
            return False
        self._wal_append({"op": "delete", "docid": docid}, key=docid)
        self._apply_delete(docid)
        get_registry().incr("ingest.docs_deleted")
        self._maybe_flush()
        return True

    def _maybe_flush(self) -> None:
        # pending tombstones count toward the threshold: a delete-heavy
        # feed must auto-flush too
        if (len(self._buf) + self.pending_tombstones()
                >= max(self.buffer_docs, 1)):
            self.flush()

    # -- recovery ----------------------------------------------------------

    def _replay(self) -> None:
        """Re-apply the WAL suffix past the current manifest's watermark.
        Memory-only until a flush commits, except that crossing the
        buffer threshold flushes mid-replay as the original timeline did,
        so the recovered commit history converges on the never-crashed
        writer's."""
        from .wal import read_records

        watermark = int(self.live.manifest().get("wal", {}).get("seq", 0))
        self._wal_seq = watermark
        t0 = time.perf_counter()
        with obs_trace("ingest.wal_replay") as sp:
            sp.set("watermark", watermark)
            records, _info = read_records(self.live.live_dir,
                                          after_seq=watermark,
                                          truncate_torn=True)
            for seq, rec in records:
                self._wal_seq = seq
                op = rec.get("op")
                if op == "add":
                    self._apply_add(rec["docid"], rec["text"])
                elif op == "update":
                    self._apply_update(rec["docid"], rec["text"])
                elif op == "delete":
                    self._apply_delete(rec["docid"])
                else:
                    raise faults.IntegrityError(
                        self.live.live_dir,
                        f"WAL record seq {seq} has unknown op {op!r}")
                self._maybe_flush()
            sp.set("replayed", len(records))
        self.replayed = len(records)
        if records:
            reg = get_registry()
            reg.incr("ingest.replayed", len(records))
            reg.observe("ingest.replay", time.perf_counter() - t0)

    # -- flush / merge -----------------------------------------------------

    def flush(self, *, note: str = "flush") -> dict | None:
        """Commit the buffer and the pending tombstones as the next
        generation. The delta segment is built straight into its segment
        dir: a crash mid-build leaves an unreferenced dir gc() removes."""
        from .builder import build_index

        if not self._buf and not self._tombs:
            return None
        t0 = time.perf_counter()
        if self.wal is not None:
            # the log must be at least as durable as the artifacts about
            # to be derived from it
            self.wal.sync()
        manifest = self.live.manifest()
        reg = get_registry()
        segments = list(manifest["segments"])
        docs = dict(manifest.get("docs", {}))
        new_name = None
        if self._buf:
            cfg = self.live.config
            new_name = self.live._next_segment_name(manifest)
            seg_dir = self.live.segment_path(new_name)
            os.makedirs(seg_dir, exist_ok=True)
            corpus = os.path.join(seg_dir, "corpus.trec.tmp")
            with open(corpus, "w", encoding="utf-8") as f:
                for docid, text in self._buf.items():
                    f.write(f"<DOC>\n<DOCNO> {docid} </DOCNO>\n<TEXT>\n"
                            f"{text}\n</TEXT>\n</DOC>\n")
            faults.maybe_crash("ingest.flush_build", new_name)
            try:
                with obs_trace("ingest.flush_build") as sp:
                    sp.set("segment", new_name)
                    sp.set("docs", len(self._buf))
                    meta = build_index(
                        [corpus], seg_dir, k=int(cfg["k"]),
                        chargram_ks=list(cfg["chargram_ks"]),
                        num_shards=int(cfg["num_shards"]),
                        device=self.device)
            finally:
                if os.path.exists(corpus):
                    os.unlink(corpus)
            segments.append(new_name)
            docs[new_name] = meta.num_docs
            reg.incr("ingest.segments_built")
        old = manifest.get("tombstones", {})
        tombs = {s: sorted(t) for s, t in
                 {**{s: set(v) for s, v in old.items()},
                  **{s: set(old.get(s, [])) | dead
                     for s, dead in self._tombs.items()}}.items()}
        m = self.live.commit(
            segments, tombs, docs, note=note,
            wal_seq=self._wal_seq if self._wal_enabled else None)
        # the just-flushed docs join the live view in place (no rescan)
        if self._doc_seg is not None and new_name is not None:
            for d in self._buf:
                self._doc_seg[d] = new_name
        self._buf.clear()
        self._tombs.clear()
        reg.incr("ingest.flushes")
        reg.observe("ingest.flush", time.perf_counter() - t0)
        if self.wal is not None:
            # the watermark is durable: retire what it covers
            self.wal.commit(self._wal_seq)
        if self.auto_merge:
            self.maybe_merge()
        return m

    def maybe_merge(self) -> dict | None:
        """One step of the tiered merge policy if a tier carries merge
        debt; the new manifest, or None."""
        groups = plan_merges(self.live.manifest())
        if not groups:
            return None
        m = compact(self.live, groups[0], note="auto-merge",
                    device=self.device)
        self._doc_seg = None  # segment ownership moved; rebuilt lazily
        return m

    def drain_merges(self, *, max_steps: int = 64) -> dict:
        """Tiered merge steps until no tier carries debt (each takes
        plan_merges' first group, as auto-merge would). {steps, manifest},
        the manifest the last one even when no step ran."""
        steps = 0
        m = self.live.manifest()
        while steps < max_steps:
            out = self.maybe_merge()
            if out is None:
                break
            m = out
            steps += 1
        return {"steps": steps, "manifest": m}

    def compact_all(self, *, note: str = "compact") -> dict:
        """Full compaction: every segment and tombstone folded into one
        segment, the generation `resolve_serving` accepts. The buffer
        flushes first."""
        self.flush()
        m = compact(self.live, note=note, device=self.device)
        self._doc_seg = None
        return m

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> dict | None:
        """Flush, then release the WAL handle and the writer lease."""
        try:
            return self.flush(note="close")
        finally:
            self._shutdown()

    def _shutdown(self) -> None:
        if self.wal is not None:
            self.wal.close()
            self.wal = None
        if self._lease is not None:
            self._lease.release()
            self._lease = None

    def abandon(self) -> None:
        """Drop the writer as a SIGKILL would, without flushing or
        releasing anything: the buffer survives only in the WAL and the
        lease file stays for the next open to take over."""
        if self.wal is not None:
            self.wal._f.close()
            self.wal = None
        if self._lease is not None:
            # stop only the heartbeat thread; the file stays, stale
            self._lease._stop.set()
            self._lease = None

    def __enter__(self) -> "IngestWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()
        else:
            # release the lease and handles without committing the
            # possibly inconsistent buffer: the WAL has every
            # acknowledged mutation and the next open replays it
            self._shutdown()


_TEXT_RE = re.compile(r"<TEXT>\s*(.*?)\s*</TEXT>", re.S | re.I)


def trec_payload(content: str) -> str:
    """The ingestable text of one raw TREC record: its <TEXT> section(s),
    framing stripped. The flush frames it again the canonical way, so a
    canonical record round-trips byte for byte."""
    sections = _TEXT_RE.findall(content)
    if sections:
        return "\n".join(sections)
    # no TEXT section: strip the DOC/DOCNO framing, keep the rest
    body = re.sub(r"</?DOC>|<DOCNO>.*?</DOCNO>", "", content,
                  flags=re.S | re.I)
    return body.strip()


def ingest_corpus(writer: IngestWriter, corpus_paths, *,
                  update: bool = False) -> int:
    """Feed TREC corpus file(s) through the writer (`ingest --add` /
    `--update`); returns the document count."""
    from ..collection import read_trec_corpus

    if isinstance(corpus_paths, (str, os.PathLike)):
        corpus_paths = [corpus_paths]
    n = 0
    for doc in read_trec_corpus(list(corpus_paths)):
        (writer.update if update else writer.add)(
            doc.docid, trec_payload(doc.content))
        n += 1
    return n
