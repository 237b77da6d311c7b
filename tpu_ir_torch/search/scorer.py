"""The Scorer: load an index to the device once, answer query batches.

The counterpart of `tpu_ir/search/scorer.py` for the dense layout: the
whole index lives on the device as a [V, D+1] (1 + ln tf) doc matrix
(plus a raw-tf matrix built on the first BM25 call); a query batch is
analyzed on the host into an int32 [B, L] term-id array and scored in
query blocks whose [block, D+1] score accumulator stays within
SCORE_BUDGET elements. Dense TF-IDF runs the fused CUDA kernel
(ops/fused_scoring.py); BM25 runs plain torch.

Not in this slice (each raises ValueError naming a later slice): the
tiered sparse layout that `layout="auto"` picks above DENSE_BUDGET, the
sharded layout, rerank and the proximity boost, phrase queries, wildcard
and fuzzy expansion over char-gram indexes, explain, the serving knobs
(deadline, force_host, hot_only) and the query log.
"""

from __future__ import annotations

import os
import re
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..analysis import Analyzer
from ..collection import DocnoMapping, Vocab, kgram_terms
from ..index import format as fmt
from ..ops.postings import pair_term_from_df
from ..ops.scoring import (
    bm25_topk_dense,
    dense_doc_matrix,
    dense_tf_matrix,
    tfidf_topk_dense,
)

# dense [V, D+1] matrix budget in elements (f32); above it the JAX package
# serves the tiered sparse layout
DENSE_BUDGET = 500_000_000

# the BM25 constants every scoring path of the JAX package shares
K1, B = 0.9, 0.4

_LATER = "is not supported by tpu_ir_torch yet (a later slice of the port)"

# a whitespace-delimited token holding a glob metacharacter, and a fuzzy
# token ('salmn~', 'color~2'): the same patterns the JAX package expands
_WILDCARD_RE = re.compile(r"\S*[*?]\S*")
_FUZZY_RE = re.compile(r"(\S+?)~(\d?)(?=[\s.,;:!)\]}]|$)")


class SearchResult(list):
    """List of (docid, score) or (docno, score) tuples for one query,
    best first. (The JAX package's serving tags — degraded, level,
    partial, explain — belong to paths this slice does not have.)"""


class Scorer:
    # max elements of the [B_block, D+1] score accumulator per dispatch
    SCORE_BUDGET = 250_000_000

    def __init__(
        self,
        *,
        vocab: Vocab,
        mapping: DocnoMapping,
        pair_term: np.ndarray,
        pair_doc: np.ndarray,
        pair_tf: np.ndarray,
        df: np.ndarray,
        doc_len: np.ndarray,
        meta: fmt.IndexMetadata,
        layout: str = "auto",
        compat_int_idf: bool = False,
        device: str | torch.device | None = None,
    ):
        """Build the dense layout on `device` from the host postings
        columns (global CSR order)."""
        self.device = resolve_device(device)
        self.vocab = vocab
        self.mapping = mapping
        self.meta = meta
        self.compat_int_idf = compat_int_idf
        self.layout = _resolve_layout(layout, meta)
        self._analyzer = Analyzer()
        self._pairs = (np.asarray(pair_term), np.asarray(pair_doc),
                       np.asarray(pair_tf))
        self.df = self._upload(df)
        self.doc_len = self._upload(doc_len)
        pt, pd, ptf = (self._upload(a) for a in self._pairs)
        self.doc_matrix = dense_doc_matrix(
            pt, pd, ptf, vocab_size=meta.vocab_size, num_docs=meta.num_docs)
        self._tf_matrix: torch.Tensor | None = None  # first BM25 call

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """An int32 host array on the device (copied on the host first
        only where it is read-only or not contiguous, as loaded arena
        views are)."""
        a = np.require(a, np.int32, ["C_CONTIGUOUS", "WRITEABLE"])
        return torch.from_numpy(a).to(self.device)

    # -- loading -----------------------------------------------------------

    @classmethod
    def load(cls, index_dir: str, *, layout: str = "auto",
             compat_int_idf: bool = False,
             device: str | torch.device | None = None) -> "Scorer":
        """Load an index dir (built by either package) onto the device.
        Side files are verified against their recorded checksums, and
        each part file is verified by the one streamed read that loads
        it."""
        dev = resolve_device(device)
        meta = fmt.IndexMetadata.load(index_dir)
        _resolve_layout(layout, meta)  # fail before reading the parts
        fmt.require_arena_format(meta.format_version)
        fmt.verify_checksums(index_dir, meta,
                             names=[fmt.DOCLEN, fmt.DOCNOS, fmt.VOCAB])
        vocab = Vocab.load(os.path.join(index_dir, fmt.VOCAB))
        mapping = DocnoMapping.load(os.path.join(index_dir, fmt.DOCNOS))
        doc_len = np.load(os.path.join(index_dir, fmt.DOCLEN))
        df, pair_doc, pair_tf = _assemble_csr(index_dir, meta)
        return cls(vocab=vocab, mapping=mapping,
                   pair_term=pair_term_from_df(df), pair_doc=pair_doc,
                   pair_tf=pair_tf, df=df, doc_len=doc_len, meta=meta,
                   layout=layout, compat_int_idf=compat_int_idf, device=dev)

    # -- query pipeline ----------------------------------------------------

    def analyze_queries(self, texts: Sequence[str]) -> np.ndarray:
        """Analyze query texts into an int32 [B, L] id array (pad -1).

        Unknown terms are dropped (the reference's dictionary-miss path).
        L is the longest row bucketed up to a power of two, as in the JAX
        package."""
        rows = []
        for text in texts:
            # without char-gram artifacts the JAX package, too, reads glob
            # and fuzzy tokens as literal text; with them it expands them
            if self.meta.chargram_ks and (_WILDCARD_RE.search(text) or (
                    "~" in text and _FUZZY_RE.search(text))):
                raise ValueError(f"wildcard and fuzzy expansion {_LATER}:"
                                 f" {text!r}")
            grams = kgram_terms(self._analyzer.analyze(text), self.meta.k)
            rows.append([i for i in (self.vocab.id_or(g) for g in grams)
                         if i >= 0])
        cap = max(max((len(r) for r in rows), default=1), 1)
        cap = 1 << (cap - 1).bit_length()
        out = np.full((len(rows), cap), -1, np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out

    def _block_size(self) -> int:
        """Queries per dispatch block: one [block, D+1] float32 score
        accumulator stays within SCORE_BUDGET elements."""
        return max(1, self.SCORE_BUDGET // (self.meta.num_docs + 1))

    @staticmethod
    def _blocked_dispatch(block: int, dispatch, q: np.ndarray):
        """Run `dispatch` over row blocks of the [B, L] query array,
        copying each block's (scores, docnos) to the host before the
        next. Rows are independent, so the last block runs at its own
        size (unlike the JAX package, nothing is compiled per shape, so
        nothing is padded)."""
        b = q.shape[0]
        if b == 0:
            return np.zeros((0, 0), np.float32), np.zeros((0, 0), np.int32)
        parts = []
        for lo in range(0, b, block):
            s, d = dispatch(q[lo : lo + block])
            parts.append((s.cpu().numpy(), d.cpu().numpy()))
        if len(parts) == 1:
            return parts[0]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    def topk(self, q_terms: np.ndarray, k: int = 10,
             scoring: str = "tfidf") -> tuple[np.ndarray, np.ndarray]:
        """Score an id batch. Returns host arrays (scores [B, k] float32,
        docnos [B, k] int32, docno 0 = empty slot)."""
        if scoring not in ("tfidf", "bm25"):
            raise ValueError(f"unknown scoring {scoring!r}; expected "
                             "'tfidf' or 'bm25'")
        q = np.ascontiguousarray(q_terms, dtype=np.int32)
        return self._blocked_dispatch(
            self._block_size(), lambda qb: self._topk_device(qb, k, scoring),
            q)

    def _topk_device(self, q_terms: np.ndarray, k: int, scoring: str):
        """One query block on the device; returns device tensors."""
        q = torch.from_numpy(q_terms).to(self.device)
        n = self.meta.num_docs
        if scoring == "bm25":
            return bm25_topk_dense(q, self._ensure_tf_matrix(), self.df,
                                   self.doc_len, n, k=k, k1=K1, b=B)
        return tfidf_topk_dense(q, self.doc_matrix, self.df, n, k=k,
                                compat_int_idf=self.compat_int_idf)

    def _ensure_tf_matrix(self) -> torch.Tensor:
        """The dense [V, D+1] raw-tf matrix, built on the first BM25 call."""
        if self._tf_matrix is None:
            pt, pd, ptf = (self._upload(a) for a in self._pairs)
            self._tf_matrix = dense_tf_matrix(
                pt, pd, ptf, vocab_size=self.meta.vocab_size,
                num_docs=self.meta.num_docs)
        return self._tf_matrix

    def search_batch(
        self, texts: Sequence[str], k: int = 10, scoring: str = "tfidf",
        return_docids: bool = True, rerank: int | None = None,
        prox: bool = False, phrase_slop: int = 0, *,
        deadline_s: float | None = None, force_host: bool = False,
        hot_only: bool = False, explain_k: int = 0,
    ) -> list[SearchResult]:
        """Ranked retrieval for plain query texts: one SearchResult of
        (docid or docno, score) per text, best first."""
        unsupported = {"rerank": rerank, "prox": prox,
                       "phrase_slop": phrase_slop, "deadline_s": deadline_s,
                       "force_host": force_host, "hot_only": hot_only,
                       "explain_k": explain_k}
        for name, value in unsupported.items():
            if value:
                raise ValueError(f"search_batch({name}=...) {_LATER}")
        texts = list(texts)
        for t in texts:
            if '"' in t:
                raise ValueError(f"phrase queries {_LATER}: {t!r}")
        q = self.analyze_queries(texts)
        scores, docnos = self.topk(q, k=k, scoring=scoring)
        out = []
        for qi in range(len(texts)):
            res = SearchResult()
            for s, dn in zip(scores[qi], docnos[qi]):
                if dn <= 0:
                    continue
                key = (self.mapping.get_docid(int(dn)) if return_docids
                       else int(dn))
                res.append((key, float(s)))
            out.append(res)
        return out


def _resolve_layout(layout: str, meta: fmt.IndexMetadata) -> str:
    if layout not in ("auto", "dense", "sparse", "sharded"):
        raise ValueError(f"unknown layout {layout!r}; expected 'auto', "
                         "'dense', 'sparse' or 'sharded'")
    if layout == "auto":
        v, d = meta.vocab_size, meta.num_docs
        if v * (d + 1) > DENSE_BUDGET:
            raise ValueError(
                f"V*(D+1) = {v * (d + 1):,} exceeds DENSE_BUDGET; the tiered "
                f"sparse layout {_LATER}")
        return "dense"
    if layout != "dense":
        raise ValueError(f"layout {layout!r} {_LATER}")
    return layout


def _assemble_csr(index_dir: str, meta: fmt.IndexMetadata):
    """Part files -> (df, pair_doc, pair_tf) in global CSR order, each
    part verified by the streamed read that loads it. A part holds
    contiguous per-term runs, so each run goes to the global indptr
    slice of its term id; no sort is needed."""
    from concurrent.futures import ThreadPoolExecutor

    n_threads = max(1, min(8, os.cpu_count() or 1, meta.num_shards))
    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        shards = list(ex.map(
            lambda s: fmt.load_shard_verified(index_dir, s, meta),
            range(meta.num_shards)))

    df = np.zeros(meta.vocab_size, np.int32)
    for z in shards:
        df[z["term_ids"]] = z["df"]
    indptr = np.concatenate([[0], np.cumsum(df, dtype=np.int64)])
    total = int(indptr[-1])
    pair_doc = np.empty(total, np.int32)
    pair_tf = np.empty(total, np.int32)
    for z in shards:
        lens = np.diff(z["indptr"]).astype(np.int64)
        n = int(lens.sum())
        if n == 0:
            continue
        ends = np.cumsum(lens)
        within = np.arange(n, dtype=np.int64) - np.repeat(ends - lens, lens)
        dest = np.repeat(indptr[z["term_ids"]], lens) + within
        pair_doc[dest] = z["pair_doc"]
        pair_tf[dest] = z["pair_tf"]
    return df, pair_doc, pair_tf
