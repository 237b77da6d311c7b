"""TREC collection ingestion: streaming <DOC> record extraction.

Parity target: the reference's XMLInputFormat/TrecDocumentInputFormat pair
(edu/umd/cloud9/collection/XMLInputFormat.java:54-199,
edu/umd/cloud9/collection/trec/TrecDocumentInputFormat.java:61-77) — scan the
byte stream for <DOC>...</DOC> records, keyed by the record's start byte
offset, transparently handling gzip; and TrecDocument
(edu/umd/cloud9/collection/trec/TrecDocument.java:76-96) — the docid is the
trimmed text between <DOCNO> and </DOCNO>, the content is the raw record XML.

Design note: this is pure host-side streaming IO. Documents are
yielded lazily so arbitrarily large corpora never need to fit in memory
(SURVEY.md §2.5 "streaming ingest"); downstream turns text into int32 arrays
before anything touches a device.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterable, Iterator

DOC_START = b"<DOC>"
DOC_END = b"</DOC>"
_DOCNO_START = "<DOCNO>"
_DOCNO_END = "</DOCNO>"


@dataclass
class TrecDocument:
    """One TREC document: raw record XML plus its source byte offset."""

    offset: int
    raw: str

    @property
    def docid(self) -> str:
        start = self.raw.find(_DOCNO_START)
        if start < 0:
            raise ValueError(f"record at offset {self.offset} has no <DOCNO>")
        start += len(_DOCNO_START)
        end = self.raw.find(_DOCNO_END, start)
        if end < 0:
            raise ValueError(f"record at offset {self.offset} has unclosed <DOCNO>")
        return self.raw[start:end].strip()

    @property
    def content(self) -> str:
        return self.raw


def _open_maybe_gzip(path: str | os.PathLike) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))  # type: ignore[arg-type]
    return io.BufferedReader(f)


def read_trec_stream(
    stream: io.BufferedReader,
    start_tag: bytes = DOC_START,
    end_tag: bytes = DOC_END,
    chunk_size: int = 1 << 20,
) -> Iterator[TrecDocument]:
    """Yield records delimited by start/end tags from a byte stream.

    Equivalent role to XMLRecordReader.readUntilMatch's byte scan, but
    buffered instead of byte-at-a-time: we keep a rolling window and use
    bytes.find, which vectorizes in C rather than looping per byte."""
    buf = b""
    base = 0  # absolute offset of buf[0]
    while True:
        in_record = False
        start_pos = buf.find(start_tag)
        if start_pos >= 0:
            end_pos = buf.find(end_tag, start_pos + len(start_tag))
            if end_pos >= 0:
                end = end_pos + len(end_tag)
                raw = buf[start_pos:end]
                yield TrecDocument(base + start_pos, raw.decode("utf-8", "replace"))
                buf = buf[end:]
                base += end
                continue
            in_record = True
        chunk = stream.read(chunk_size)
        if not chunk:
            return
        if not in_record and len(buf) > len(start_tag):
            # nothing useful before a partial start tag can survive; trim
            keep = len(start_tag) - 1
            base += len(buf) - keep
            buf = buf[-keep:]
        buf += chunk


def read_trec_file(path: str | os.PathLike) -> Iterator[TrecDocument]:
    with _open_maybe_gzip(path) as f:
        yield from read_trec_stream(f)


def read_trec_corpus(paths: Iterable[str | os.PathLike]) -> Iterator[TrecDocument]:
    """Stream every document of a corpus given files and/or directories.

    Directories are expanded to their (sorted) regular files, mirroring the
    reference's FileInputFormat directory handling."""
    for path in paths:
        path = os.fspath(path)
        if os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                sub = os.path.join(path, name)
                if os.path.isfile(sub):
                    yield from read_trec_file(sub)
        else:
            yield from read_trec_file(path)
