"""Per-term random access through the forward index (dictionary.tsv): the
port's copy of `tpu_ir/index/dictionary.py`.

The reference resolves a term through its dictionary file: term ->
(fileNo, byteOffset), seek into part-NNNNN, read one record, and check
that the key read back is the term asked for. Here `dictionary.tsv` maps
term -> (shard, postings start in the shard's pair columns), the offset
resolves to a CSR row through the shard's indptr, and the same check is
kept. `inspect --term` and verify_index are its consumers.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from ..collection import Vocab
from . import format as fmt


class TermPostings(NamedTuple):
    term: str
    term_id: int
    shard: int
    offset: int          # postings start within the shard's pair columns
    df: int
    postings: np.ndarray  # int32 [df, 2] (docno, tf), tf desc then docno asc


class Dictionary:
    """term -> (shard, offset) map backed by dictionary.tsv.

    Mirrors the reference's Hashtable<String, Long> load
    (IntDocVectorsForwardIndex.java:93-122); term ids fall out of line
    order because the dictionary is written in sorted-term order."""

    def __init__(self, index_dir: str, *, text: str | None = None):
        """`text` lets a caller that already read dictionary.tsv (e.g. the
        verifier, which compares the raw bytes) share it instead of a
        second disk read."""
        self._dir = index_dir
        self._entries: dict[str, tuple[int, int, int]] = {}
        if text is None:
            with open(os.path.join(index_dir, fmt.DICTIONARY),
                      encoding="utf-8") as f:
                text = f.read()
        # split on \n ONLY: splitlines() also splits on U+0085/U+2028/…,
        # which the analyzer allows inside terms — a NEL in a term would
        # shear its dictionary line in two and shift every later term id
        lines = text.split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        for tid, line in enumerate(lines):
            term, shard, offset = line.rsplit("\t", 2)
            self._entries[term] = (tid, int(shard), int(offset))
        # shards load lazily and stay cached; a cooperating caller may
        # also consume the cache via pop_shard to avoid re-reads
        self._shard_cache: dict[int, dict[str, np.ndarray]] = {}

    def pop_shard(self, shard: int) -> dict[str, np.ndarray]:
        """Hand over (and forget) a shard's arrays — loading it if never
        touched — so a caller walking every shard after a spot-check pays
        one read total and memory is released as it goes."""
        z = self._shard_cache.pop(shard, None)
        if z is None:
            z = fmt.load_shard(self._dir, shard, decode=True)
        return z

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, term: str) -> bool:
        return term in self._entries

    def get_value(self, term: str) -> TermPostings | None:
        """The reference getValue: dictionary hit -> shard seek -> one
        record -> verify the key matches. Returns None on a dictionary miss
        (the reference returns null and the term is skipped,
        IntDocVectorsForwardIndex.java:150-153)."""
        hit = self._entries.get(term)
        if hit is None:
            return None
        tid, shard, offset = hit
        z = self._shard_cache.get(shard)
        if z is None:
            z = fmt.load_shard(self._dir, shard, decode=True)
            self._shard_cache[shard] = z
        # `offset` is the term's postings start inside the shard's pair
        # columns; its row is found by the CSR indptr (exact match required)
        row = int(np.searchsorted(z["indptr"], offset))
        if not (row < len(z["term_ids"]) and z["indptr"][row] == offset):
            raise AssertionError(
                f"dictionary offset {offset} is not a postings boundary "
                f"in shard {shard}")
        # post-seek verification (reference term-match check, :175-179)
        if int(z["term_ids"][row]) != tid:
            raise AssertionError(
                f"dictionary points term {term!r} (id {tid}) at shard "
                f"{shard} row {row}, which holds term id "
                f"{int(z['term_ids'][row])}")
        lo, hi = int(z["indptr"][row]), int(z["indptr"][row + 1])
        posts = np.stack([z["pair_doc"][lo:hi], z["pair_tf"][lo:hi]],
                         axis=1).astype(np.int32)
        return TermPostings(term, tid, shard, offset, hi - lo, posts)


def lookup_term(index_dir: str, term: str, *,
                analyze: bool = True) -> list[TermPostings]:
    """One-shot per-term lookup; `analyze=True` runs the input through the
    same analyzer as indexing first (reference parity: query terms are
    analyzed before the dictionary lookup, IntDocVectorsForwardIndex.java:
    276,295). Multi-token input composes the index's k-grams and EVERY
    composed gram is resolved (one TermPostings per dictionary hit; misses
    are skipped like the reference's null path)."""
    queries = [term]
    if analyze:
        from ..analysis.native import make_analyzer
        from ..collection import kgram_terms

        meta = fmt.IndexMetadata.load(index_dir)
        queries = kgram_terms(make_analyzer().analyze(term), meta.k)
    d = Dictionary(index_dir)
    hits = (d.get_value(q) for q in dict.fromkeys(queries))
    return [h for h in hits if h is not None]


def verify_dictionary_access(index_dir: str, sample: int = 64, *,
                             dictionary: Dictionary | None = None,
                             vocab: Vocab | None = None) -> int:
    """Spot-check the dictionary against the vocab: resolve `sample` evenly
    spaced terms through get_value and confirm df parity. Returns the number
    of terms checked (used by tests and `tpu-ir verify`). Pass `dictionary`
    / `vocab` to reuse already-loaded state (the verifier does)."""
    if vocab is None:
        vocab = Vocab.load(os.path.join(index_dir, fmt.VOCAB))
    d = dictionary if dictionary is not None else Dictionary(index_dir)
    n = len(vocab)
    step = max(1, n // max(sample, 1))
    checked = 0
    for tid in range(0, n, step):
        term = vocab.term(tid)
        tp = d.get_value(term)
        assert tp is not None, f"dictionary miss for vocab term {term!r}"
        assert tp.term_id == tid, f"term id mismatch for {term!r}"
        assert (tp.postings[:, 1] > 0).all(), f"empty tf for {term!r}"
        checked += 1
    return checked
