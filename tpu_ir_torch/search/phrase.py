"""Phrase / ordered-window retrieval and proximity features over the
format v2 position runs (index/positions.py): the port's copy of
`tpu_ir/search/phrase.py`.

- ``"quoted phrases"`` in queries: documents must contain the analyzed
  tokens as an ordered window (exact adjacency at slop=0; at slop=s the
  ordered chain may stretch to (m-1)+s token gaps in all). Matching docs
  are then ranked by the standard scoring model restricted to them.
- a proximity feature for the two-stage rerank: candidates where query
  terms sit close together get a multiplicative boost.

These run on the host, in numpy, as in the JAX package: a phrase touches
a handful of dictionary seeks and position runs (kilobytes of data), too
little to pay for a device dispatch. The host scores are float64 sums
cast to float32, bitwise the JAX package's.
"""

from __future__ import annotations

import math
import re
import threading

import numpy as np

from ..index import format as fmt
from ..index.dictionary import Dictionary
from ..index.positions import PositionsReader

PHRASE_RE = re.compile(r'"([^"]*)"')

K1, B = 0.9, 0.4  # the BM25 constants every scoring path shares (explain too)


_MISS = object()


def _term_view(dictionary: Dictionary, term: str):
    """One term's postings as (TermPostings|None, doc column sorted,
    argsort rows, tf column in doc order) — the sorted view every host
    phrase/scoring path probes candidates against. The tf column is
    permuted here, once per term, so candidate probes stay O(candidates):
    re-permuting the full df-length column per scoring stage is O(df)
    work per term per stage. Single definition; PhraseIndex._term caches
    it with an LRU, make_term_lookup with a plain memo."""
    tp = dictionary.get_value(term)
    if tp is None:
        return (None, None, None, None)
    docs = tp.postings[:, 0].astype(np.int64)
    by_doc = np.argsort(docs)
    return (tp, docs[by_doc], by_doc, tp.postings[:, 1][by_doc])


def _lru_get(cache: dict, key):
    """Fetch + move-to-end (dicts iterate in insertion order, so popping
    and re-inserting makes the FIRST key the least recently used)."""
    hit = cache.pop(key, _MISS)
    if hit is not _MISS:
        cache[key] = hit
    return hit


def _lru_put(cache: dict, key, value, cap: int) -> None:
    cache[key] = value
    while len(cache) > cap:
        cache.pop(next(iter(cache)))


class PhraseIndex:
    """Positions-backed phrase matching + proximity features for one
    index dir. Construct once per Scorer; shard position files and the
    dictionary load lazily and stay memoized. The LRU caches are shared
    between the serving threads under one lock (the lookups they cache
    run outside it)."""

    # cache bounds: a long-lived serving process (REPL, --topics over
    # thousands of queries with --prox) must not grow without limit.
    # Postings for 256 distinct terms and 16k decoded runs are a few MB
    # on any realistic corpus; eviction is LRU
    TERM_CACHE_CAP = 256
    POS_CACHE_CAP = 16384

    def __init__(self, index_dir: str, *, meta=None):
        self.meta = meta or fmt.IndexMetadata.load(index_dir)
        if not self.meta.has_positions:
            raise ValueError(
                "index has no position runs (format v1); rebuild with "
                "positions=True / tpu-ir index --positions for phrase "
                "and proximity queries")
        self._dict = Dictionary(index_dir)
        self._reader = PositionsReader(index_dir)
        # per term: (TermPostings|None, doc column sorted, argsort rows,
        # tf column in doc order)
        self._term_cache: dict[str, tuple] = {}
        # decoded runs, populated ONLY for (term, doc) pairs actually
        # consulted — a high-df term costs O(requested docs), never O(df)
        self._pos_cache: dict[tuple[str, int], np.ndarray | None] = {}
        self._lock = threading.Lock()

    def _term(self, term: str):
        with self._lock:
            hit = _lru_get(self._term_cache, term)
        if hit is _MISS:
            hit = _term_view(self._dict, term)
            with self._lock:
                _lru_put(self._term_cache, term, hit, self.TERM_CACHE_CAP)
        return hit

    def doc_set(self, term: str) -> np.ndarray:
        """Sorted docnos containing the term (no position decoding)."""
        _, docs_sorted, _, _ = self._term(term)
        return docs_sorted if docs_sorted is not None else np.zeros(
            0, np.int64)

    def positions(self, term: str, docno: int) -> np.ndarray | None:
        """Ascending positions of `term` in `docno`, or None when absent.
        Decodes exactly one run (cached, bounded LRU)."""
        key = (term, docno)
        with self._lock:
            hit = _lru_get(self._pos_cache, key)
        if hit is not _MISS:
            return hit
        tp, docs_sorted, by_doc, _ = self._term(term)
        out = None
        if tp is not None:
            i = int(np.searchsorted(docs_sorted, docno))
            if i < len(docs_sorted) and docs_sorted[i] == docno:
                row = tp.offset + int(by_doc[i])
                out = self._reader.run(tp.shard, row)
        with self._lock:
            _lru_put(self._pos_cache, key, out, self.POS_CACHE_CAP)
        return out

    def positions_bulk(self, term: str, docnos: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Positions of `term` in each of the SORTED candidate `docnos`:
        (lens int64 [n], pos int64 [sum lens]), pos concatenated in doc
        order. One vectorized row lookup + PositionsReader.runs_concat —
        the phrase path's per-candidate cost is a gather, not a Python
        loop. Docs where the term is absent contribute len 0."""
        tp, docs_sorted, by_doc, _ = self._term(term)
        n = len(docnos)
        if tp is None or n == 0:
            return np.zeros(n, np.int64), np.zeros(0, np.int64)
        i = np.searchsorted(docs_sorted, docnos)
        i_c = np.minimum(i, len(docs_sorted) - 1)
        ok = (i < len(docs_sorted)) & (docs_sorted[i_c] == docnos)
        rows = tp.offset + by_doc[i_c][ok]
        lens, pos = self._reader.runs_concat(tp.shard, rows)
        if bool(ok.all()):
            return lens, pos
        full = np.zeros(n, np.int64)
        full[ok] = lens
        return full, pos

    def match_window(self, terms: list[str], slop: int = 0) -> list[int]:
        """Docnos containing `terms` as an ordered window: positions
        p_1 < p_2 < ... < p_m with p_m - p_1 <= (m-1) + slop. slop=0 is
        exact phrase adjacency. Greedy chains are optimal for ordered
        windows: for every start, each next term takes its smallest
        position beyond the current one.

        Fully vectorized: the candidate intersection runs rarest-term-
        first, then every candidate doc's chains advance together. Each
        term's positions across ALL candidates concatenate into one
        sorted key array (doc_rank * M + position, M > any position), so
        one searchsorted per term advances every chain at once — cost is
        O(total positions in candidates * m), sublinear in max df after
        the rarest-first intersection, with no per-doc Python loop."""
        if not terms:
            return []
        doc_sets = [self.doc_set(t) for t in terms]
        if any(len(ds) == 0 for ds in doc_sets):
            return []
        # rarest-first: start from the smallest doc set so intersection
        # work tracks the RAREST term's df, not the first word's ("new
        # york": 'york' prunes before 'new' ever materializes)
        order = sorted(range(len(terms)), key=lambda j: len(doc_sets[j]))
        docs = doc_sets[order[0]]
        for j in order[1:]:
            docs = docs[np.isin(docs, doc_sets[j], assume_unique=True)]
            if len(docs) == 0:
                return []
        span = len(terms) - 1 + slop
        per_term = [self.positions_bulk(t, docs) for t in terms]
        maxpos = max(int(p.max(initial=0)) for _, p in per_term)
        m_key = maxpos + span + 2
        ranks = np.arange(len(docs), dtype=np.int64)
        keys = [np.repeat(ranks, lens) * m_key + pos
                for lens, pos in per_term]
        cur = keys[0]
        starts = cur
        alive = np.ones(len(cur), bool)
        for kk in keys[1:]:
            if len(kk) == 0:
                return []
            idx = np.searchsorted(kk, cur, side="right")
            i_c = np.minimum(idx, len(kk) - 1)
            nxt = kk[i_c]
            # the successor must exist AND sit in the same doc block
            alive &= (idx < len(kk)) & (nxt // m_key == cur // m_key)
            cur = nxt
        ok = alive & (cur - starts <= span)
        return docs[np.unique(starts[ok] // m_key)].tolist()

    def min_gap(self, term_a: str, term_b: str, docno: int) -> int | None:
        """Smallest |pos_a - pos_b| between two terms in a doc, or None
        when either is absent (the classic sorted-merge distance)."""
        pa = self.positions(term_a, docno)
        pb = self.positions(term_b, docno)
        if pa is None or pb is None:
            return None
        idx = np.searchsorted(pb, pa)
        best = np.inf
        left = idx > 0
        if left.any():
            best = min(best, int(np.min(
                pa[left] - pb[np.maximum(idx[left] - 1, 0)])))
        right = idx < len(pb)
        if right.any():
            best = min(best, int(np.min(
                pb[np.minimum(idx[right], len(pb) - 1)] - pa[right])))
        return int(best) if np.isfinite(best) else None

    def proximity_bonus(self, terms: list[str], docno: int) -> float:
        """Sum over adjacent query-term pairs of 1/(1+min_gap). 0 when no
        pair co-occurs; adjacency (gap 1) contributes 0.5 per pair."""
        bonus = 0.0
        for a, b in zip(terms, terms[1:]):
            if a == b:
                continue
            g = self.min_gap(a, b, docno)
            if g is not None:
                bonus += 1.0 / (1.0 + g)
        return bonus


PROX_ALPHA = 0.5    # rerank boost strength: score * (1 + alpha * bonus)
PROX_DEPTH = 50     # candidates rescored by proximity per query


def split_phrases(text: str) -> tuple[str, list[str]]:
    """Pull double-quoted spans out of a query; returns (rest, phrases).
    The quoted words still participate in scoring — a phrase constrains
    WHICH docs rank, not what scores them — so callers score
    `rest + ' ' + ' '.join(phrases)`."""
    phrases = [p.strip() for p in PHRASE_RE.findall(text) if p.strip()]
    rest = PHRASE_RE.sub(" ", text)
    return rest, phrases


def _tf_for_candidates(docs_sorted, tfs_sorted,
                       docnos_arr: np.ndarray) -> np.ndarray:
    """tf of one term in each candidate doc (0 where absent): the host
    seek-and-probe every explicit-candidate scoring model shares, over a
    PRE-SORTED postings view (term_lookup contract)."""
    idx = np.searchsorted(docs_sorted, docnos_arr)
    i_c = np.minimum(idx, len(docs_sorted) - 1)
    ok = (idx < len(docs_sorted)) & (docs_sorted[i_c] == docnos_arr)
    return np.where(ok, tfs_sorted[i_c], 0).astype(np.float64)


def make_term_lookup(dictionary: Dictionary):
    """Memoized _term_view — the same shape PhraseIndex._term serves from
    its LRU, so the host scorers below take either interchangeably and a
    phrase pipeline sorts each term's postings ONCE across match + both
    rerank stages."""
    cache: dict = {}

    def get(term: str):
        if term not in cache:
            cache[term] = _term_view(dictionary, term)
        return cache[term]

    return get


def score_docs_host(q_terms: list[str], docnos: list[int], *,
                    dictionary: Dictionary, num_docs: int,
                    doc_len: np.ndarray, scoring: str = "tfidf",
                    compat_int_idf: bool = False,
                    term_lookup=None) -> tuple[np.ndarray, np.ndarray]:
    """The standard scoring formulas over an explicit candidate doc set,
    on host — numerically the same model as ops/scoring.py ((1+ln tf) *
    log10(N/df) TF-IDF; the k1=0.9/b=0.4 BM25), used where a device
    dispatch cannot amortize (phrase-filtered result sets). Pass
    `term_lookup` (e.g. PhraseIndex._term) to reuse already-sorted
    postings views across pipeline stages."""
    docnos_arr = np.asarray(sorted(docnos), np.int64)
    scores = np.zeros(len(docnos_arr), np.float64)
    if scoring == "bm25":
        dl = doc_len[docnos_arr].astype(np.float64)
        avg_dl = float(doc_len[1:].sum()) / max(num_docs, 1)
        dl_norm = 1.0 - B + B * dl / max(avg_dl, 1e-9)
    # repeated query terms contribute once per OCCURRENCE, matching the
    # device kernels (analyze_queries keeps duplicates and the tiered/
    # dense programs sum per slot); only the term lookup is memoized
    lookup = term_lookup or make_term_lookup(dictionary)
    for t in q_terms:
        tp, docs_sorted, _, tfs_sorted = lookup(t)
        if tp is None:
            continue
        tf = _tf_for_candidates(docs_sorted, tfs_sorted, docnos_arr)
        if scoring == "bm25":
            w_q = math.log(1.0 + (num_docs - tp.df + 0.5) / (tp.df + 0.5))
            scores += np.where(
                tf > 0, tf * (K1 + 1.0) / (tf + K1 * dl_norm), 0.0) * w_q
        else:
            if compat_int_idf:
                idf = math.log10(max(num_docs // max(tp.df, 1), 1e-30))
            else:
                idf = math.log10(num_docs / max(tp.df, 1))
            scores += np.where(tf > 0, 1.0 + np.log(np.maximum(tf, 1.0)),
                               0.0) * idf
    return docnos_arr, scores.astype(np.float32)


def cosine_score_host(q_terms: list[str], docnos, *,
                      dictionary: Dictionary, num_docs: int,
                      doc_norms: np.ndarray,
                      term_lookup=None) -> tuple[np.ndarray, np.ndarray]:
    """Host twin of the stage-2 device reranker
    (ops/scoring.py::cosine_rerank_dense): score = sum over query-term
    occurrences of idf^2 * (1 + ln tf), / ||d|| under (1+ln tf)*idf doc
    weights. Float idf regardless of compat mode, like the device rerank.
    Used by the phrase pipeline, whose KB-scale candidate sets cannot
    amortize a device dispatch."""
    docnos_arr = np.asarray(sorted(docnos), np.int64)
    scores = np.zeros(len(docnos_arr), np.float64)
    lookup = term_lookup or make_term_lookup(dictionary)
    for t in q_terms:
        tp, docs_sorted, _, tfs_sorted = lookup(t)
        if tp is None:
            continue
        tf = _tf_for_candidates(docs_sorted, tfs_sorted, docnos_arr)
        idf = math.log10(num_docs / max(tp.df, 1))
        scores += np.where(tf > 0, 1.0 + np.log(np.maximum(tf, 1.0)),
                           0.0) * idf * idf
    scores /= np.maximum(doc_norms[docnos_arr], 1e-30)
    return docnos_arr, scores.astype(np.float32)
