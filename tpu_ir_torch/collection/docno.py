"""Docid <-> docno mapping.

Parity target: DocnoMapping / TrecDocnoMapping
(edu/umd/cloud9/collection/DocnoMapping.java:42-72,
edu/umd/cloud9/collection/trec/TrecDocnoMapping.java:59-155) and the
NumberTrecDocuments job (edu/umd/cloud9/collection/trec/NumberTrecDocuments.java):
docnos are 1-based ints assigned in sorted-docid order; lookup is binary
search over the sorted docid array. The on-disk format is a small side file
(here: one docid per line, UTF-8, sorted), broadcast to every worker — the
DistributedCache equivalent is plain replication of the array to all hosts.
"""

from __future__ import annotations

import bisect
import os
from typing import Iterable, Sequence

from .sidefile import load_lines, save_lines


class DocnoMapping:
    """Sorted docid array; docno = 1-based index (reference semantics)."""

    def __init__(self, sorted_docids: Sequence[str]):
        self._docids = list(sorted_docids)
        for d in self._docids:
            # the on-disk format is one docid per line — an embedded
            # newline (a multi-line <DOCNO> keeps interior whitespace
            # after strip()) would shear docnos.txt and misalign every
            # docno after it on the next load
            if "\n" in d or "\r" in d:
                raise ValueError(f"docid {d!r} contains a newline; "
                                 "fix the <DOCNO> in the corpus")
        for a, b in zip(self._docids, self._docids[1:]):
            if a >= b:
                raise ValueError(f"docids not strictly sorted: {a!r} >= {b!r}")

    @classmethod
    def build(cls, docids: Iterable[str]) -> "DocnoMapping":
        """Assign docnos 1..N in sorted-docid order (NumberTrecDocuments
        reducer semantics: shuffle sorts docids, a counter assigns 1,2,3...)."""
        seen = sorted(set(docids))
        return cls(seen)

    def __len__(self) -> int:
        return len(self._docids)

    @property
    def docids(self) -> list[str]:
        return self._docids

    def get_docno(self, docid: str) -> int:
        i = bisect.bisect_left(self._docids, docid)
        if i >= len(self._docids) or self._docids[i] != docid:
            raise KeyError(docid)
        return i + 1

    def get_docid(self, docno: int) -> str:
        if not 1 <= docno <= len(self._docids):
            raise IndexError(f"docno {docno} out of range 1..{len(self._docids)}")
        return self._docids[docno - 1]

    def save(self, path: str | os.PathLike) -> None:
        save_lines(path, self._docids)

    @classmethod
    def load(cls, path: str | os.PathLike) -> "DocnoMapping":
        return cls(load_lines(path))
