"""Line-oriented TREC document stream parsers and the parsed Document
model: the port's copy of `tpu_ir/collection/parsers.py`.

- `Document` holds {identifier, metadata, text, terms, tags}.
- `TrecTextParser` reads <DOC> records and keeps only the content of the
  known section tags (TEXT, HEADLINE, TITLE, HL, HEAD, TTL, DD, DATE, LP,
  LEADPARA), tag lines included; everything else is dropped.
- `TrecWebParser` reads the TREC-web (<DOCHDR>) variant: the header's
  first line carries the URL (scrubbed: a trailing '#' cut, lowercased,
  the :80 port dropped, trailing slashes dropped); the content is every
  line after </DOCHDR> up to </DOC>; url and identifier go to the
  metadata.

`parse_document` runs the tag tokenizer over a document's text, and
`to_trec` writes a document as the canonical TREC record the indexers
read; `tpu-ir-torch pack --format trectext|trecweb` chains the two
parsers into that shape.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Iterator, Protocol

from ..analysis.tag_tokenizer import Tag, TagTokenizer


@dataclass
class Document:
    """A parsed document (Document.java): raw ``text`` plus the analysis
    products ``terms``/``tags`` filled by :func:`parse_document`."""

    identifier: str
    text: str
    metadata: dict = field(default_factory=dict)
    terms: list[str] = field(default_factory=list)
    tags: list[Tag] = field(default_factory=list)


class DocumentStreamParser(Protocol):
    """DocumentStreamParser.java: ``next_document() -> Document | None``."""

    def next_document(self) -> Document | None: ...

    def __iter__(self) -> Iterator[Document]: ...


class _LineParser:
    """Shared line-stream machinery for the TREC text/web parsers."""

    def __init__(self, source) -> None:
        if isinstance(source, str):
            source = io.StringIO(source)
        self._lines = iter(source)

    def _readline(self) -> str | None:
        for line in self._lines:
            return line.rstrip("\r\n")  # CRLF corpora: like Java readLine
        return None

    def _wait_for(self, tag: str) -> str | None:
        """Skip to the next line starting with `tag`; None at stream end."""
        while (line := self._readline()) is not None:
            if line.startswith(tag):
                return line
        return None

    def __iter__(self) -> Iterator[Document]:
        while (doc := self.next_document()) is not None:
            yield doc

    def next_document(self) -> Document | None:  # pragma: no cover
        raise NotImplementedError


class TrecTextParser(_LineParser):
    """TREC-text reader (TrecTextParser.java:48-91): keeps only the known
    section tags' content (tag lines included), drops everything else."""

    _SECTIONS = ("TEXT", "HEADLINE", "TITLE", "HL", "HEAD",
                 "TTL", "DD", "DATE", "LP", "LEADPARA")

    def _parse_docno(self) -> str | None:
        """The reference accumulates lines until </DOCNO> shows up, then
        slices between the markers (TrecTextParser.java:32-46)."""
        all_text = self._wait_for("<DOCNO>")
        if all_text is None:
            return None
        while "</DOCNO>" not in all_text:
            line = self._readline()
            if line is None:
                break
            all_text += line
        start = all_text.find("<DOCNO>") + len("<DOCNO>")
        end = all_text.find("</DOCNO>")
        return all_text[start:end if end >= 0 else len(all_text)].strip()

    def next_document(self) -> Document | None:
        if self._wait_for("<DOC>") is None:
            return None
        identifier = self._parse_docno()
        if identifier is None:
            return None
        buf: list[str] = []
        in_tag: str | None = None
        while (line := self._readline()) is not None:
            if line.startswith("</DOC>"):
                break
            if in_tag is None:
                if line.startswith("<"):
                    for sec in self._SECTIONS:
                        if line.startswith(f"<{sec}>"):
                            in_tag = sec
                            buf.append(line)
                            # open + close on ONE line ends the section
                            # here — leaving it open would leak every
                            # following unknown-tag line into the text
                            if f"</{sec}>" in line:
                                in_tag = None
                            break
                continue  # outside any section: dropped
            buf.append(line)  # the end-tag line is kept
            if line.startswith(f"</{in_tag}>"):
                in_tag = None
        return Document(identifier, "".join(x + "\n" for x in buf))


class TrecWebParser(_LineParser):
    """TREC-web reader (TrecWebParser.java:66-96): one-line DOCNO, a
    ``<DOCHDR>`` whose first line is the (scrubbed) URL, content = every
    line after ``</DOCHDR>`` until ``</DOC>``."""

    @staticmethod
    def scrub_url(url: str) -> str:
        """TrecWebParser.java:37-53 — lowercase, no trailing '#', no :80
        port, no trailing slashes."""
        if url.endswith("#"):
            url = url[:-1]
        url = url.lower()
        url = url.replace(":80/", "/")
        if url.endswith(":80"):
            # the reference strips ALL ':80' occurrences in this branch,
            # not just the trailing one (TrecWebParser.java:46-48)
            url = url.replace(":80", "")
        return url.rstrip("/")

    def next_document(self) -> Document | None:
        if self._wait_for("<DOC>") is None:
            return None
        line = self._wait_for("<DOCNO>")
        if line is None:
            return None
        identifier = line[len("<DOCNO>"):].strip()
        if identifier.endswith("</DOCNO>"):
            identifier = identifier[: -len("</DOCNO>")].strip()
        if self._wait_for("<DOCHDR>") is None:
            return None
        url_line = self._readline() or ""
        url = self.scrub_url(url_line.split(" ", 1)[0]) if url_line else ""
        if self._wait_for("</DOCHDR>") is None:
            return None
        buf: list[str] = []
        while (line := self._readline()) is not None:
            if line.startswith("</DOC>"):
                break
            buf.append(line)
        doc = Document(identifier, "".join(x + "\n" for x in buf))
        doc.metadata["url"] = url
        doc.metadata["identifier"] = identifier
        return doc


def parse_document(doc: Document, record_tags: bool = True) -> Document:
    """Fill ``terms`` (and optionally ``tags``) from ``text`` with the same
    TagTokenizer the index build uses — the Document model's analysis half
    (Document.java fields the reference filled via TagTokenizer:626-642)."""
    tok = TagTokenizer(record_tags=record_tags)
    doc.terms = list(tok.tokenize(doc.text))
    doc.tags = list(tok.tags)
    return doc


def to_trec(doc: Document) -> str:
    """Canonical TREC record for this document — the bridge from the
    alternate stream-parser formats into the indexers' native ingestion
    path (collection/trec.py)."""
    return (f"<DOC>\n<DOCNO> {doc.identifier} </DOCNO>\n<TEXT>\n"
            f"{doc.text.rstrip()}\n</TEXT>\n</DOC>\n")
