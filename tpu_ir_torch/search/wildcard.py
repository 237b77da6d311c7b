"""Wildcard and fuzzy term lookup over the char-k-gram index (the port's
copy of `tpu_ir/search/wildcard.py`; host code on numpy, as there).

The reference built the char-k-gram -> term index "for wildcard/fuzzy
term lookup" (SURVEY.md §0) but shipped no query-side consumer. A
`te*d`-style pattern is decomposed into its $-padded k-grams, the per-gram
sorted term-id lists are intersected, and a final literal scan drops the
false positives (the classic k-gram postfilter). Fuzzy lookup counts the
grams a vocabulary term shares with the query, then confirms with a banded
edit distance.

The order of every result is part of the contract: the Scorer turns
expansions into query id rows, and a row must hold the JAX package's ids
in the JAX package's slots.
"""

from __future__ import annotations

import fnmatch
import itertools
import os
from functools import reduce

import numpy as np

from ..collection import Vocab
from ..index import format as fmt
from ..index.builder import TOKENS_VOCAB
from ..ops.chargram import gram_to_code

# the fuzzy edit ceiling of every surface (query tokens, `expand`): the
# k-gram count filter weakens fast past 2 edits
MAX_FUZZY_EDITS = 2


class WildcardLookup:
    def __init__(self, vocab: Vocab, k: int, gram_codes: np.ndarray | None,
                 indptr: np.ndarray | None, term_ids: np.ndarray | None):
        self.vocab = vocab
        self.k = k
        self._codes = gram_codes
        self._indptr = indptr
        self._term_ids = term_ids
        self._lazy_dir: str | None = None

    @classmethod
    def load(cls, index_dir: str, k: int,
             vocab: Vocab | None = None) -> "WildcardLookup":
        """The lookup of `index_dir`'s char-gram index of this k. `vocab`
        lets a caller that already holds the token vocabulary share it
        (a k = 1 index's vocabulary is the token vocabulary; a k > 1
        index keeps it in tokens.txt). The gram arrays load on first
        use."""
        if vocab is None:
            tok_vocab_path = os.path.join(index_dir, TOKENS_VOCAB)
            vocab = Vocab.load(
                tok_vocab_path if os.path.exists(tok_vocab_path)
                else os.path.join(index_dir, fmt.VOCAB))
        out = cls(vocab, k, None, None, None)
        out._lazy_dir = index_dir
        return out

    def _ensure_loaded(self) -> None:
        if self._codes is None:
            z = fmt.load_chargram(self._lazy_dir, self.k)
            # _codes last: a concurrent caller that sees it set finds the
            # other two set too (two racing loads read the same file)
            self._indptr = z["indptr"]
            self._term_ids = z["term_ids"]
            self._codes = z["gram_codes"]

    def _terms_for_gram(self, gram: bytes) -> np.ndarray:
        code = gram_to_code(gram, self.k)
        i = np.searchsorted(self._codes, code)
        if i >= len(self._codes) or self._codes[i] != code:
            return np.zeros(0, np.int32)
        return self._term_ids[self._indptr[i] : self._indptr[i + 1]]

    def pattern_grams(self, pattern: str) -> list[bytes]:
        """The k-grams a glob pattern implies: $ pads the fixed ends, and
        every maximal run free of wildcards gives its grams. Grams are
        UTF-8 byte windows, as the index packs terms."""
        padded = "$" + pattern + "$"
        runs = [r.encode("utf-8")
                for r in padded.replace("?", "*").split("*") if r]
        grams = []
        for run in runs:
            grams.extend(
                run[i : i + self.k] for i in range(len(run) - self.k + 1))
        return grams

    def fuzzy(self, term: str, max_edits: int = 1,
              limit: int | None = None) -> list[tuple[str, int]]:
        """Vocabulary terms within `max_edits` Levenshtein edits of
        `term`, as (term, distance) sorted by (distance, term).

        One edit disturbs at most k of the $-padded byte grams, so a match
        shares at least n_grams - max_edits*k of them: the candidates come
        from one bincount over the per-gram term lists, then a banded edit
        distance over characters confirms. Where that bound falls below 1
        (short terms, large k) it floors at one shared gram, which loses
        neighbours that share none ('cat'/'cut' at k = 3); the Scorer
        picks a k that keeps the bound positive. Non-ASCII text floors it
        at 1 too (one character edit can disturb up to 4*k byte grams).
        `max_edits=0` probes the vocabulary for the exact term."""
        self._ensure_loaded()
        q = term
        if max_edits < 1:
            return [(q, 0)] if q in self.vocab else []
        qb = ("$" + q + "$").encode("utf-8")
        # distinct grams: the count filter counts shared grams
        grams = list(dict.fromkeys(
            qb[i : i + self.k] for i in range(len(qb) - self.k + 1)))
        if not grams:
            return []
        ascii_q = len(qb) == len(q) + 2
        thr = (max(len(grams) - max_edits * self.k, 1) if ascii_q else 1)
        counts = np.zeros(len(self.vocab.terms), np.int32)
        for g in grams:
            counts[self._terms_for_gram(g)] += 1
        out = []
        for tid in np.nonzero(counts >= thr)[0]:
            t = self.vocab.term(int(tid))
            d = _levenshtein_capped(q, t, max_edits)
            if d is not None:
                out.append((t, d))
        out.sort(key=lambda td: (td[1], td[0]))
        return out[:limit] if limit is not None else out

    def expand(self, pattern: str, limit: int | None = None) -> list[str]:
        """Vocabulary terms matching a glob pattern ('te*', '*tion'), in
        term order; with `limit`, the first `limit` of them."""
        grams = self.pattern_grams(pattern)
        self._ensure_loaded()
        if grams:
            lists = [self._terms_for_gram(g) for g in grams]
            if any(len(lst) == 0 for lst in lists):
                return []
            cand_ids = reduce(np.intersect1d, lists)
            cands = (self.vocab.term(int(t)) for t in cand_ids)
        else:
            cands = iter(self.vocab.terms)     # a pattern like '*'
        matches = (t for t in cands if fnmatch.fnmatchcase(t, pattern))
        # candidates come in term order either way, so stopping at `limit`
        # returns the prefix a full scan would
        if limit is not None:
            return list(itertools.islice(matches, limit))
        return list(matches)


def _levenshtein_capped(a: str, b: str, cap: int) -> int | None:
    """The Levenshtein distance of a and b if it is at most `cap`, else
    None: a banded DP over the diagonal band of width 2*cap+1 that stops
    once a whole row exceeds the cap."""
    if a == b:
        return 0
    la, lb = len(a), len(b)
    if abs(la - lb) > cap:
        return None
    if la > lb:                  # the band runs over the shorter string
        a, b, la, lb = b, a, lb, la
    big = cap + 1
    prev = list(range(la + 1))
    for j in range(1, lb + 1):
        cur = [big] * (la + 1)
        cur[0] = j if j <= cap else big
        lo = max(1, j - cap)
        hi = min(la, j + cap)
        for i in range(lo, hi + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[i] = min(prev[i] + 1,         # delete
                         cur[i - 1] + 1,      # insert
                         prev[i - 1] + cost)  # substitute
        if min(cur) > cap:
            return None
        prev = cur
    return prev[la] if prev[la] <= cap else None
