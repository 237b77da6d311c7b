"""Term vocabulary: term <-> int32 term-id.

The reference has no explicit vocabulary (terms stay strings through the
Hadoop shuffle and become SequenceFile keys). Here strings never reach
a device: the host assigns term-ids and everything downstream is int32
arrays. Ids are assigned in sorted-term order so that id order == lexicographic
order — this makes the dictionary dump naturally sorted (like the reference's
single-reducer dictionary, BuildIntDocVectorsForwardIndex.java:139-153) and
lets the char-k-gram index store term-id lists that are simultaneously sorted
term lists (CharKGramTermIndexer.java:173-209 merge semantics).

Terms for k-gram indexes (k > 1) are the k analyzed tokens joined with a
single space, mirroring the reference's String[] k_gram key (TermDF.java).
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

from .sidefile import load_lines, save_lines

KGRAM_SEP = " "


class Vocab:
    def __init__(self, sorted_terms: Sequence[str]):
        self._terms = list(sorted_terms)
        for a, b in zip(self._terms, self._terms[1:]):
            if a >= b:
                raise ValueError(f"terms not strictly sorted: {a!r} >= {b!r}")
        self._ids = {t: i for i, t in enumerate(self._terms)}

    @classmethod
    def build(cls, terms: Iterable[str]) -> "Vocab":
        return cls(sorted(set(terms)))

    def __len__(self) -> int:
        return len(self._terms)

    def __contains__(self, term: str) -> bool:
        return term in self._ids

    @property
    def terms(self) -> list[str]:
        return self._terms

    def id(self, term: str) -> int:
        return self._ids[term]

    def id_or(self, term: str, default: int = -1) -> int:
        return self._ids.get(term, default)

    def term(self, term_id: int) -> str:
        return self._terms[term_id]

    def save(self, path: str | os.PathLike) -> None:
        save_lines(path, self._terms)

    @classmethod
    def load(cls, path: str | os.PathLike) -> "Vocab":
        return cls(load_lines(path))


def kgram_terms(tokens: Sequence[str], k: int) -> list[str]:
    """Sliding k-token windows joined with KGRAM_SEP.

    Parity: the reference mapper's k-window emission
    (TermKGramDocIndexer.java:135-159) — documents shorter than k tokens
    produce nothing."""
    if len(tokens) < k:
        return []
    if k == 1:
        return list(tokens)
    return [KGRAM_SEP.join(tokens[i : i + k]) for i in range(len(tokens) - k + 1)]
