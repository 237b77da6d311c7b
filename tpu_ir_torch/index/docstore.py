"""Compressed document-text store (the port's copy of
`tpu_ir/index/docstore.py`, byte-identical in what it writes).

The reference pipes every document's raw content through indexing and
then throws it away; the store keeps it next to the index, for snippets
(search/snippets.py) and for a merge to re-stream (`iter_arrival`).

Layout (both files written atomically):
    docstore.bin        zlib blocks (level 6), BLOCK_DOCS docs each
    docstore-idx.npz    block_starts int64 [nblocks+1]  byte offsets
                        lengths      int64 [ndocs]      per-doc raw bytes
                        perm         int64 [ndocs+1]    docno -> arrival row
                        block_docs   int64

Docs are stored in arrival (corpus) order and addressed through `perm`,
so the writer streams with O(block) memory at any corpus size. The
streaming build assembles the store from its pass-1 text spills (zlib
level 1, no second corpus read); `build_docstore` makes one corpus pass
for an index built otherwise.
"""

from __future__ import annotations

import os
import threading
import zlib

import numpy as np

from ..collection import DocnoMapping
from ..collection.trec import read_trec_corpus
from . import format as fmt

STORE_BIN = "docstore.bin"
STORE_IDX = "docstore-idx.npz"
BLOCK_DOCS = 256


def available(index_dir: str) -> bool:
    return (os.path.exists(os.path.join(index_dir, STORE_BIN))
            and os.path.exists(os.path.join(index_dir, STORE_IDX)))


def consistent(index_dir: str) -> bool:
    """available() AND the bin's size matches what the idx expects — the
    crash window between the two writes leaves a pair that available()
    accepts but DocStore refuses; callers offering to reuse or describe
    an existing store must gate on this."""
    if not available(index_dir):
        return False
    try:
        with np.load(os.path.join(index_dir, STORE_IDX),
                     allow_pickle=False) as z:
            expect = int(z["block_starts"][-1])
        return os.path.getsize(
            os.path.join(index_dir, STORE_BIN)) == expect
    except (OSError, KeyError, ValueError):
        return False


def write_text_spill(path: str, texts, docids) -> None:
    """One pass-1 text spill: zlib blob of the batch's raw record bytes +
    per-doc lengths + docids.

    Level 1, deliberately unlike the store's level 6: a spill is written
    once and read once at assembly, so compression speed is the whole
    cost. The persistent store recompresses at level 6."""
    fmt.savez_atomic(
        path,
        blob=np.frombuffer(zlib.compress(b"".join(texts), 1), np.uint8),
        lengths=np.array([len(t) for t in texts], np.int64),
        docids=np.array(list(docids), dtype=np.str_))


def iter_text_spill_docnos(path: str, sorted_docids: np.ndarray):
    """Yield (docno, raw_bytes) from one text spill, in arrival order —
    the docid→docno lookup is one vectorized searchsorted over the
    spill's docid column, not a scalar probe per document (at 1M docs
    the per-doc numpy dispatch overhead is seconds of host time inside
    the timed docstore phase)."""
    with np.load(path, allow_pickle=False) as z:
        blob = zlib.decompress(z["blob"].tobytes())
        lengths = z["lengths"]
        docids = z["docids"]
    docnos = np.searchsorted(sorted_docids, docids.astype(np.str_)) + 1
    ofs = 0
    for dn, ln in zip(docnos, lengths):
        yield int(dn), blob[ofs : ofs + int(ln)]
        ofs += int(ln)


def stats(index_dir: str) -> dict:
    """Size stats of an existing store (same shape as the build return)."""
    with np.load(os.path.join(index_dir, STORE_IDX),
                 allow_pickle=False) as z:
        return {"docs": int(len(z["lengths"])),
                "raw_bytes": int(z["lengths"].sum()),
                "stored_bytes": int(z["block_starts"][-1])}


def write_docstore(index_dir: str, records, n: int, *,
                   block_docs: int = BLOCK_DOCS) -> dict:
    """Streaming store writer: `records` yields (docno, raw_bytes) in
    ARRIVAL order; exactly `n` docs are expected (one per docno). Both
    the corpus-pass builder below and the streaming build's spill
    assembly (index/streaming.py) write through here, so the on-disk
    format has one producer. Returns size stats."""
    perm = np.zeros(n + 1, np.int64)
    lengths = np.zeros(n, np.int64)
    block_starts = [0]
    raw_bytes = 0
    row = 0
    tmp_bin = os.path.join(index_dir, STORE_BIN + ".tmp")
    try:
        with open(tmp_bin, "wb") as out:
            block: list[bytes] = []

            def flush():
                if not block:
                    return
                out.write(zlib.compress(b"".join(block), 6))
                block_starts.append(out.tell())
                block.clear()

            for docno, data in records:
                if row < n:
                    perm[docno] = row
                    lengths[row] = len(data)
                    raw_bytes += len(data)
                    block.append(data)
                row += 1
                if len(block) >= block_docs:
                    flush()
            flush()
        if row != n:
            raise ValueError(f"corpus pass saw {row} docs but the index "
                             f"maps {n}")
        os.replace(tmp_bin, os.path.join(index_dir, STORE_BIN))
    finally:
        if os.path.exists(tmp_bin):
            os.unlink(tmp_bin)
    fmt.savez_atomic(
        os.path.join(index_dir, STORE_IDX),
        block_starts=np.asarray(block_starts, np.int64),
        lengths=lengths, perm=perm,
        block_docs=np.int64(block_docs))
    return {"docs": n, "raw_bytes": raw_bytes,
            "stored_bytes": int(block_starts[-1])}


def build_docstore(corpus_paths, index_dir: str, *,
                   block_docs: int = BLOCK_DOCS) -> dict:
    """One streaming corpus pass -> compressed store. Returns size stats
    (the bench records the overhead). Every doc in the corpus must be in
    the index's docno mapping — the store and the index must come from
    the same corpus. The streaming builder avoids this second corpus
    read entirely (`build_index_streaming(..., store=True)` spills text
    during pass 1); this standalone pass covers the in-memory build and
    after-the-fact store construction."""
    if isinstance(corpus_paths, (str, os.PathLike)):
        corpus_paths = [corpus_paths]
    mapping = DocnoMapping.load(os.path.join(index_dir, fmt.DOCNOS))

    def records():
        for doc in read_trec_corpus([str(p) for p in corpus_paths]):
            try:
                docno = mapping.get_docno(doc.docid)
            except KeyError:
                raise ValueError(
                    f"docid {doc.docid!r} not in the index's docno "
                    "mapping; the store must be built from the same "
                    "corpus as the index") from None
            yield docno, doc.content.encode("utf-8")

    return write_docstore(index_dir, records(), len(mapping),
                          block_docs=block_docs)


class DocStore:
    """Random access to stored document text by docno. Decompresses one
    block per miss; a small LRU keeps recently-touched blocks hot (result
    pages cluster arrivals, so snippet rendering for one query usually
    costs a handful of block decompressions). Safe to share between
    threads: the serving frontend renders snippets from many."""

    CACHE_BLOCKS = 8

    def __init__(self, index_dir: str):
        if not available(index_dir):
            raise ValueError(
                "index has no document store; build one with "
                "`index --store` (or tpu_ir_torch.index.docstore."
                "build_docstore)")
        with np.load(os.path.join(index_dir, STORE_IDX),
                     allow_pickle=False) as z:
            self._block_starts = z["block_starts"]
            self._lengths = z["lengths"]
            self._perm = z["perm"]
            self._block_docs = int(z["block_docs"])
        # consistency gate: a crash between replacing the bin
        # and writing the idx can pair a new bin with a stale idx, whose
        # offsets would silently decode garbage; the sizes must agree
        bin_size = os.path.getsize(os.path.join(index_dir, STORE_BIN))
        if bin_size != int(self._block_starts[-1]):
            raise ValueError(
                f"document store is inconsistent: docstore.bin is "
                f"{bin_size} bytes but its index expects "
                f"{int(self._block_starts[-1])}; rebuild it with "
                "`index --store`")
        # per-doc offset within its block: prefix sums reset per block
        self._doc_ofs = np.zeros(len(self._lengths), np.int64)
        for b0 in range(0, len(self._lengths), self._block_docs):
            seg = self._lengths[b0 : b0 + self._block_docs]
            self._doc_ofs[b0 : b0 + len(seg)] = (
                np.cumsum(seg) - seg)
        self._bin = open(os.path.join(index_dir, STORE_BIN), "rb")
        self._cache: dict[int, bytes] = {}
        # one reader at a time: the file position and the LRU are shared
        self._lock = threading.Lock()

    def close(self) -> None:
        self._bin.close()

    def _block(self, b: int) -> bytes:
        with self._lock:
            hit = self._cache.pop(b, None)
            if hit is None:
                self._bin.seek(int(self._block_starts[b]))
                raw = self._bin.read(int(self._block_starts[b + 1]
                                         - self._block_starts[b]))
                hit = zlib.decompress(raw)
            self._cache[b] = hit
            while len(self._cache) > self.CACHE_BLOCKS:
                self._cache.pop(next(iter(self._cache)))
            return hit

    def get_bytes(self, docno: int) -> bytes:
        """The stored content of one document, exact raw bytes (a decode
        and re-encode would corrupt records that are not valid UTF-8)."""
        if not 1 <= docno < len(self._perm):
            raise KeyError(docno)
        row = int(self._perm[docno])
        blk = self._block(row // self._block_docs)
        ofs = int(self._doc_ofs[row])
        return blk[ofs : ofs + int(self._lengths[row])]

    def get(self, docno: int) -> str:
        """The stored content of one document (raw record text)."""
        return self.get_bytes(docno).decode("utf-8", errors="replace")


def iter_arrival(index_dir: str):
    """Yield (docno, raw bytes) over an existing store in arrival order,
    the order write_docstore takes, so a store can be streamed into
    another (the index merge). Each zlib block is decompressed once and
    its rows sliced off the lengths column."""
    store = DocStore(index_dir)
    try:
        n = len(store._lengths)
        inv = np.empty(n, np.int64)          # arrival row -> docno
        inv[store._perm[1:]] = np.arange(1, n + 1)
        bd = store._block_docs
        for b0 in range(0, n, bd):
            blk = store._block(b0 // bd)
            ofs = 0
            for dn, ln in zip(inv[b0 : b0 + bd].tolist(),
                              store._lengths[b0 : b0 + bd].tolist()):
                yield dn, blk[ofs : ofs + ln]
                ofs += ln
    finally:
        store.close()
