"""TREC ingestion, docno mapping and vocabulary (copies of the matching
`tpu_ir.collection` modules; the record parsers of `parsers.py` are not
part of this slice)."""

from .docno import DocnoMapping
from .trec import TrecDocument, read_trec_corpus, read_trec_file, read_trec_stream
from .vocab import KGRAM_SEP, Vocab, kgram_terms

__all__ = [
    "DocnoMapping",
    "TrecDocument",
    "read_trec_corpus",
    "read_trec_file",
    "read_trec_stream",
    "KGRAM_SEP",
    "Vocab",
    "kgram_terms",
]
