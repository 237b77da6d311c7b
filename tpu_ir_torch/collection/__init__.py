"""TREC ingestion, docno mapping, vocabulary and the TREC text/web stream
parsers (copies of the matching `tpu_ir.collection` modules)."""

from .docno import DocnoMapping
from .parsers import (
    Document,
    TrecTextParser,
    TrecWebParser,
    parse_document,
    to_trec,
)
from .trec import TrecDocument, read_trec_corpus, read_trec_file, read_trec_stream
from .vocab import KGRAM_SEP, Vocab, kgram_terms

__all__ = [
    "DocnoMapping",
    "Document",
    "TrecDocument",
    "TrecTextParser",
    "TrecWebParser",
    "parse_document",
    "read_trec_corpus",
    "read_trec_file",
    "read_trec_stream",
    "to_trec",
    "KGRAM_SEP",
    "Vocab",
    "kgram_terms",
]
