"""The native (C++) analysis pipeline, loaded through ctypes: the port's
copy of `tpu_ir/analysis/native.py`.

`native/analyzer.cpp` is compiled by g++ on first use into
`build/tpu_ir_torch/` (ops/_build.py::load_host: named by a digest of the
source, built into a per-process temporary file and renamed into place).
`native/analyzer.so`, the JAX package's copy, is never read or written.
A missing compiler or a failed build or dlopen raises with the compiler's
output: unlike the JAX loader, nothing falls back to the ten times slower
pure-Python analyzer on its own. The Python path runs only when the caller
asks for it (`make_analyzer(native=False)`,
`make_chunked_tokenizer(..., native=False)`).

The C++ path has the exact semantics of the Python `Analyzer` for ASCII
records. A record with non-ASCII bytes goes through the Python analyzer,
its terms interned into the same vocabulary (the C++ path is byte-wise
and skips Unicode case folding on purpose), and so does every gzip file.
A record with no (or an unclosed) <DOCNO> is a corpus error on every
path: the same ValueError naming its byte offset.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from ..collection.trec import TrecDocument, read_trec_corpus, read_trec_file
from ..collection.vocab import kgram_terms
from .analyzer import Analyzer
from .stopwords import TERRIER_STOPWORDS

SOURCE = Path(__file__).resolve().parents[2] / "native" / "analyzer.cpp"

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_VP = ctypes.c_void_p
# every C entry point: (restype, argtypes)
_SIGNATURES = {
    "ir_set_stopwords": (None, [ctypes.c_char_p, ctypes.c_int32]),
    "ir_analyze": (ctypes.c_int32, [ctypes.c_char_p, ctypes.c_int32,
                                    ctypes.c_char_p, ctypes.c_int32]),
    "ir_corpus_new": (_VP, []),
    "ir_corpus_free": (None, [_VP]),
    "ir_corpus_add_file": (ctypes.c_int64, [_VP, ctypes.c_char_p]),
    "ir_corpus_add_bytes": (ctypes.c_int64, [_VP, ctypes.c_char_p,
                                             ctypes.c_int64]),
    "ir_corpus_delta_stats": (None, [_VP, _I64P]),
    "ir_corpus_take_delta": (None, [_VP, _I32P, _I64P, ctypes.c_char_p,
                                    _I64P]),
    "ir_corpus_intern_term": (ctypes.c_int32, [_VP, ctypes.c_char_p,
                                               ctypes.c_int32]),
    "ir_corpus_vocab_bytes": (ctypes.c_int64, [_VP]),
    "ir_corpus_vocab_export": (None, [_VP, ctypes.c_char_p]),
    "ir_corpus_stats": (None, [_VP, _I64P]),
    "ir_corpus_export": (None, [_VP, _I32P, _I64P, ctypes.c_char_p,
                                ctypes.c_char_p, _I64P]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def load_native() -> ctypes.CDLL:
    """The native analyzer library, built on first use, with every entry
    point's types declared and the stopword list installed. Raises
    RuntimeError when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            from ..ops._build import load_host

            lib = load_host(SOURCE)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            blob = "\n".join(sorted(TERRIER_STOPWORDS)).encode()
            lib.ir_set_stopwords(blob, len(blob))
            _lib = lib
        return _lib


def _i32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _i64(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _lines(raw: bytes) -> list[str]:
    """A '\\n'-terminated blob as its lines."""
    return raw.decode("utf-8").split("\n")[:-1] if raw else []


class NativeAnalyzer:
    """The Analyzer interface over the C++ pipeline; non-ASCII text takes
    the Python analyzer. Thread-safe: the C++ side is pure, and the output
    buffer is per thread."""

    def __init__(self, out_cap: int = 1 << 20):
        self._lib = load_native()
        self._py = Analyzer()
        self._out_cap = out_cap
        self._tls = threading.local()

    def _buf(self):
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = self._tls.buf = ctypes.create_string_buffer(self._out_cap)
        return buf

    def analyze(self, text: str) -> list[str]:
        if not text.isascii():
            return self._py.analyze(text)
        raw = text.encode("ascii")
        buf = self._buf()
        n = self._lib.ir_analyze(raw, len(raw), buf, len(buf) - 1)
        if n < 0:  # grow and retry once
            buf = self._tls.buf = ctypes.create_string_buffer(2 * -n)
            n = self._lib.ir_analyze(raw, len(raw), buf, len(buf) - 1)
            if n < 0:
                return self._py.analyze(text)
        return buf.raw[: n - 1].decode("ascii").split("\n") if n > 1 else []


def _split_native_py_files(paths) -> tuple[list[str], list[str]]:
    """Directories expanded to their sorted regular files, routed by the
    gzip magic bytes: (native_files, py_files)."""
    files: list[str] = []
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            files.extend(os.path.join(p, n) for n in sorted(os.listdir(p))
                         if os.path.isfile(os.path.join(p, n)))
        else:
            files.append(p)
    native_files, py_files = [], []
    for f in files:
        with open(f, "rb") as fh:
            magic = fh.read(2)
        (py_files if magic == b"\x1f\x8b" else native_files).append(f)
    return native_files, py_files


def tokenize_corpus_native(paths):
    """Whole-corpus ingestion through the C++ pipeline: (docids, temp ids
    int32, doc lengths int64, vocab list), the temp ids in first-seen
    order (the caller remaps them to sorted ids). Gzip files and the
    records the scanner skips (non-ASCII, no docid) go through the Python
    analyzer and are appended after the native documents."""
    lib = load_native()
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    native_files, py_files = _split_native_py_files(paths)
    h = lib.ir_corpus_new()
    try:
        for f in native_files:
            if lib.ir_corpus_add_file(h, f.encode()) < 0:
                raise OSError(f"native reader failed on {f}")
        stats = (ctypes.c_int64 * 8)()
        lib.ir_corpus_stats(h, stats)
        n_docs, n_tokens, _, docid_b, vocab_b, n_skip = (
            int(x) for x in stats[:6])
        ids = np.empty(n_tokens, np.int32)
        doc_lens = np.empty(n_docs, np.int64)
        docid_buf = ctypes.create_string_buffer(max(docid_b, 1))
        vocab_buf = ctypes.create_string_buffer(max(vocab_b, 1))
        skip_buf = (ctypes.c_int64 * max(n_skip * 3, 1))()
        lib.ir_corpus_export(h, _i32(ids), _i64(doc_lens), docid_buf,
                             vocab_buf, skip_buf)
        docids = _lines(docid_buf.raw[:docid_b])
        vocab_list = _lines(vocab_buf.raw[:vocab_b])

        extra_docs: list[tuple[str, list[str]]] = []
        py = Analyzer()
        for i in range(n_skip):
            fi, lo, hi = skip_buf[3 * i: 3 * i + 3]
            with open(native_files[fi], "rb") as fh:
                fh.seek(lo)
                raw = fh.read(hi - lo).decode("utf-8", "replace")
            doc = TrecDocument(lo, raw)
            extra_docs.append((doc.docid, py.analyze(doc.content)))
        for f in py_files:
            for doc in read_trec_file(f):
                extra_docs.append((doc.docid, py.analyze(doc.content)))
        if extra_docs:
            vocab_index = {t: i for i, t in enumerate(vocab_list)}
            extra_ids: list[int] = []
            extra_lens: list[int] = []
            for docid, toks in extra_docs:
                docids.append(docid)
                for t in toks:
                    tid = vocab_index.get(t)
                    if tid is None:
                        tid = len(vocab_list)
                        vocab_index[t] = tid
                        vocab_list.append(t)
                    extra_ids.append(tid)
                extra_lens.append(len(toks))
            doc_lens = np.concatenate([doc_lens,
                                       np.array(extra_lens, np.int64)])
            ids = np.concatenate([ids, np.array(extra_ids, np.int32)])
        return docids, ids, doc_lens, vocab_list
    finally:
        lib.ir_corpus_free(h)


def _record_spans(chunk: bytes) -> list[tuple[int, int]]:
    """(lo, hi) byte spans of every complete <DOC>..</DOC> record, in
    order: the scan the C++ process_records() makes."""
    spans = []
    pos = 0
    while True:
        lo = chunk.find(b"<DOC>", pos)
        if lo < 0:
            break
        hi = chunk.find(b"</DOC>", lo + 5)
        if hi < 0:
            break
        hi += 6
        spans.append((lo, hi))
        pos = hi
    return spans


def _iter_record_chunks(path: str, chunk_bytes: int):
    """Byte buffers of about `chunk_bytes`, cut at </DOC> boundaries."""
    rem = b""
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk_bytes)
            if not buf:
                if rem:
                    yield rem  # an incomplete record in it is ignored
                break
            buf = rem + buf
            cut = buf.rfind(b"</DOC>")
            if cut < 0:
                rem = buf
                continue
            cut += 6
            yield buf[:cut]
            rem = buf[cut:]


def _delta_batch(with_text, docids, flat, lens, texts):
    """One tokenizer delta: (docids, ids, lens[, texts])."""
    out = (docids, np.array(flat, np.int32), np.array(lens, np.int64))
    return out + (texts,) if with_text else out


class NativeChunkedTokenizer:
    """Streaming whole-corpus ingestion in bounded memory (C++ chunk scan).

    Each non-gzip file is fed in ~chunk_bytes buffers cut at record
    boundaries; each chunk's delta (docids, temp term ids, per-doc
    lengths, and with `with_text` each record's raw bytes) is drained at
    once, so the C++ side holds only the vocabulary between chunks.
    Non-ASCII records and gzip files take the Python analyzer, their
    terms interned into the same vocabulary. Call vocab() after the last
    delta and remap the temp ids to sorted ids."""

    #: docs per delta of the Python (gzip) file path
    PY_BATCH_DOCS = 5_000

    def __init__(self, paths, chunk_bytes: int = 8 << 20,
                 with_text: bool = False):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self._chunk_bytes = chunk_bytes
        self._with_text = with_text
        self._lib = load_native()
        # classify the files before the handle exists: a missing corpus
        # path raises its own FileNotFoundError and leaks nothing
        self._native_files, self._py_files = _split_native_py_files(paths)
        self._h = self._lib.ir_corpus_new()
        self._py = Analyzer()

    def _intern_terms(self, terms):
        lib, h = self._lib, self._h
        out = []
        for t in terms:
            raw = t.encode("utf-8")
            out.append(lib.ir_corpus_intern_term(h, raw, len(raw)))
        return out

    def _take_delta(self, chunk: bytes):
        stats = (ctypes.c_int64 * 4)()
        self._lib.ir_corpus_delta_stats(self._h, stats)
        n_doc, n_tok, docid_b, n_skip = (int(x) for x in stats)
        ids = np.empty(n_tok, np.int32)
        lens = np.empty(n_doc, np.int64)
        docid_buf = ctypes.create_string_buffer(max(docid_b, 1))
        skips = (ctypes.c_int64 * max(n_skip * 2, 1))()
        self._lib.ir_corpus_take_delta(self._h, _i32(ids), _i64(lens),
                                       docid_buf, skips)
        docids = _lines(docid_buf.raw[:docid_b])
        texts: list[bytes] | None = None
        if self._with_text:
            # the native docs are the chunk's records less the skipped
            # ones, in order; skipped texts are appended below, in the
            # order their docids are
            skip_set = {(int(skips[2 * i]), int(skips[2 * i + 1]))
                        for i in range(n_skip)}
            texts = [chunk[lo:hi] for lo, hi in _record_spans(chunk)
                     if (lo, hi) not in skip_set]
            if len(texts) != n_doc:
                raise RuntimeError(
                    f"record-span scan found {len(texts)} native records "
                    f"but the scanner ingested {n_doc}")
        if n_skip:
            extra_ids: list[int] = []
            extra_lens: list[int] = []
            for i in range(n_skip):
                lo, hi = skips[2 * i], skips[2 * i + 1]
                doc = TrecDocument(lo, chunk[lo:hi].decode("utf-8",
                                                           "replace"))
                toks = [t for t in self._intern_terms(
                    self._py.analyze(doc.content)) if t >= 0]
                docids.append(doc.docid)
                extra_ids.extend(toks)
                extra_lens.append(len(toks))
                if texts is not None:
                    texts.append(chunk[lo:hi])
            lens = np.concatenate([lens, np.array(extra_lens, np.int64)])
            ids = np.concatenate([ids, np.array(extra_ids, np.int32)])
        if self._with_text:
            return docids, ids, lens, texts
        return docids, ids, lens

    def deltas(self):
        """Yield (docids, temp_ids int32, doc_lens int64[, texts]) per
        chunk."""
        for f in self._native_files:
            for chunk in _iter_record_chunks(f, self._chunk_bytes):
                if self._lib.ir_corpus_add_bytes(self._h, chunk,
                                                 len(chunk)) < 0:
                    raise OSError(f"native chunk scan failed in {f}")
                yield self._take_delta(chunk)
        for f in self._py_files:
            docids, flat, lens, texts = [], [], [], []
            for doc in read_trec_file(f):
                toks = [t for t in self._intern_terms(
                    self._py.analyze(doc.content)) if t >= 0]
                docids.append(doc.docid)
                flat.extend(toks)
                lens.append(len(toks))
                if self._with_text:
                    texts.append(doc.content.encode("utf-8"))
                if len(docids) >= self.PY_BATCH_DOCS:
                    yield _delta_batch(self._with_text, docids, flat,
                                       lens, texts)
                    docids, flat, lens, texts = [], [], [], []
            if docids:
                yield _delta_batch(self._with_text, docids, flat, lens,
                                   texts)

    def vocab(self) -> list[str]:
        nbytes = int(self._lib.ir_corpus_vocab_bytes(self._h))
        buf = ctypes.create_string_buffer(max(nbytes, 1))
        self._lib.ir_corpus_vocab_export(self._h, buf)
        return _lines(buf.raw[:nbytes])

    def close(self):
        if self._h is not None:
            self._lib.ir_corpus_free(self._h)
            self._h = None


class PyChunkedTokenizer:
    """The pure-Python tokenizer with the NativeChunkedTokenizer interface.

    Its deltas are cut as the native scanner's are: after the document
    that crosses BATCH_DOCS docs or `chunk_bytes` bytes of record text,
    and at every file's end, so the streaming build's resume batches are
    the same. `procs` (default TPU_IR_TOKENIZE_PROCS) > 1 analyzes the
    chunks in a process pool (analysis/pool.py): the parent still reads
    the records, decides the chunk boundaries and interns the terms in
    submission order, so the deltas, and every spill made from them, are
    the serial path's bytes. With k > 1 each document's terms are its
    k-token windows (the k > 1 streaming build's tokenizer, as in the
    JAX package)."""

    #: docs per delta at most (the JAX package's default)
    BATCH_DOCS = 5_000

    def __init__(self, paths, k: int = 1, with_text: bool = False,
                 chunk_bytes: int = 8 << 20, procs: int | None = None):
        self._paths = ([paths] if isinstance(paths, (str, os.PathLike))
                       else list(paths))
        self._k = k
        self._chunk_bytes = chunk_bytes
        self._an = Analyzer()
        self._vocab: dict[str, int] = {}
        self._with_text = with_text
        if procs is None:
            from .pool import tokenize_procs

            procs = tokenize_procs()
        self._procs = max(int(procs), 1)

    def _intern(self, term: str) -> int:
        tid = self._vocab.get(term)
        if tid is None:
            tid = len(self._vocab)
            self._vocab[term] = tid
        return tid

    def _iter_raw_chunks(self):
        """(docids, contents) per delta: the one boundary decision the
        serial and pooled paths share."""
        for path in self._paths:
            docids: list[str] = []
            contents: list[str] = []
            acc_bytes = 0
            for doc in read_trec_corpus([path]):
                docids.append(doc.docid)
                contents.append(doc.content)
                acc_bytes += len(doc.content)
                if (len(docids) >= self.BATCH_DOCS
                        or acc_bytes >= self._chunk_bytes):
                    yield docids, contents
                    docids, contents, acc_bytes = [], [], 0
            if docids:
                yield docids, contents

    def _chunk_delta(self, docids, contents, tok_lists):
        """Intern one chunk's analyzed tokens, in order, in the parent."""
        flat: list[int] = []
        lens: list[int] = []
        for toks in tok_lists:
            flat.extend(self._intern(t) for t in toks)
            lens.append(len(toks))
        texts = ([c.encode("utf-8") for c in contents]
                 if self._with_text else [])
        return _delta_batch(self._with_text, docids, flat, lens, texts)

    def deltas(self):
        if self._procs > 1:
            yield from self._deltas_pooled()
            return
        for docids, contents in self._iter_raw_chunks():
            yield self._chunk_delta(docids, contents,
                                    self._analyze_docs(contents))

    def _analyze_docs(self, contents):
        for content in contents:
            toks = self._an.analyze(content)
            yield kgram_terms(toks, self._k) if self._k > 1 else toks

    def _deltas_pooled(self):
        import collections

        from ..utils.transfer import pipeline_depth
        from .pool import AnalysisPool

        pool = AnalysisPool(self._procs, k=self._k,
                            ahead=self._procs + pipeline_depth())
        raw: collections.deque = collections.deque()
        try:
            def drain_one():
                docids, contents = raw.popleft()
                return self._chunk_delta(docids, contents, pool.collect())

            for docids, contents in self._iter_raw_chunks():
                while pool.in_flight >= pool.ahead:
                    yield drain_one()
                pool.submit(contents)
                raw.append((docids, contents))
            while raw:
                yield drain_one()
        finally:
            pool.close()

    def vocab(self) -> list[str]:
        return list(self._vocab)

    def close(self):
        pass


def make_chunked_tokenizer(paths, k: int = 1, chunk_bytes: int = 8 << 20,
                           with_text: bool = False,
                           procs: int | None = None, *,
                           native: bool = True):
    """The native chunked tokenizer, or with `native=False` or k > 1 (the
    native scanner emits single tokens) the Python one (`procs` reaches
    only the Python path: the C++ scanner already runs at memory speed on
    one core). Both yield temp ids in first-seen order; `with_text` adds
    each document's raw record bytes."""
    if native and k == 1:
        return NativeChunkedTokenizer(paths, chunk_bytes=chunk_bytes,
                                      with_text=with_text)
    return PyChunkedTokenizer(paths, k=k, with_text=with_text,
                              chunk_bytes=chunk_bytes, procs=procs)


def make_analyzer(native: bool = True):
    """A NativeAnalyzer, or with `native=False` the Python Analyzer."""
    return NativeAnalyzer() if native else Analyzer()
