"""The Scorer: load an index to the device once, answer query batches.

The counterpart of `tpu_ir/search/scorer.py` for two layouts:

- dense (V*(D+1) <= DENSE_BUDGET under layout="auto"): the whole index
  lives on the device as a [V, D+1] (1 + ln tf) doc matrix (plus a raw-tf
  matrix built on the first BM25 call). Dense TF-IDF runs the fused CUDA
  kernel (ops/fused_scoring.py); BM25 runs plain torch.
- sparse (above DENSE_BUDGET): the tiered layout of search/layout.py, a
  budget-capped dense hot strip plus padded df tiers, scored exactly as
  the JAX package's unpruned tiered path: the cold tiers through the
  cold-tier CUDA kernel (ops/cold_tier.py), one launch per query block,
  then the hot strip as one float32 product.

A compressed (format v3) index is decoded on load and served from the same
layouts with the raw tfs held in bf16 when every tf round-trips bf16
exactly (the JAX package's `_strip_dtype` rule; otherwise float32, with a
warning): the dense layout keeps one bf16 raw-tf matrix, which the
quantized CUDA kernel reads for TF-IDF and BM25 widens, and the tiered
layout's hot strip is bf16. The weights are computed in float32 from the
widened tfs, so the results are bitwise those of the raw index.

A query batch is analyzed on the host into an int32 [B, L] term-id array
and scored in query blocks whose [block, D+1] score accumulator stays
within SCORE_BUDGET elements.

Not in this slice (each raises ValueError naming a later slice): the
sharded layout, MaxScore and block-max pruning, rerank and the proximity
boost, phrase queries, wildcard and fuzzy expansion over char-gram
indexes, explain, the serving knobs (deadline, force_host, hot_only) and
the query log.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..analysis import Analyzer
from ..collection import DocnoMapping, Vocab, kgram_terms
from ..index import format as fmt
from ..index.compress import bf16_exact
from ..ops.cold_tier import TierTable
from ..ops.postings import pair_term_from_df
from ..ops.scoring import (
    bm25_strip,
    bm25_topk_dense,
    bm25_topk_tiered,
    dense_doc_matrix,
    dense_tf_matrix,
    lntf_strip,
    tfidf_topk_dense,
    tfidf_topk_dense_quantized,
    tfidf_topk_tiered,
)
from .layout import (
    HOT_BUDGET,
    TieredPostings,
    build_tiered_layout,
    upload_index,
)

logger = logging.getLogger(__name__)

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
        pair_term: np.ndarray | None,
        pair_doc: np.ndarray | None,
        pair_tf: np.ndarray | None,
        df: np.ndarray,
        doc_len: np.ndarray,
        meta: fmt.IndexMetadata,
        layout: str = "auto",
        compat_int_idf: bool = False,
        device: str | torch.device | None = None,
        tiers: TieredPostings | None = None,
    ):
        """Build the layout on `device` from the host postings columns
        (global CSR order). The sparse layout may come prebuilt as
        `tiers` instead, with the columns None."""
        self.device = resolve_device(device)
        self.vocab = vocab
        self.mapping = mapping
        self.meta = meta
        self.compat_int_idf = compat_int_idf
        self.layout = _resolve_layout(layout, meta)
        self._analyzer = Analyzer()
        # host postings columns (pair_term is needed by the dense layout
        # only, which keeps them for its BM25 matrix); the tiered layout
        # may come prebuilt without them and drops them once built
        self._pairs = (None if pair_doc is None else
                       (pair_term, np.asarray(pair_doc), np.asarray(pair_tf)))
        if (self.layout == "dense" and pair_term is None) or (
                self._pairs is None and tiers is None):
            raise ValueError(f"layout {self.layout!r} needs the postings "
                             "columns or a prebuilt tiered layout")
        self.df = upload_index(df, self.device)
        self.doc_len = upload_index(doc_len, self.device)
        if self.layout == "dense":
            self.tf_dtype = _strip_dtype(meta, self._pairs[2])
            pt, pd, ptf = (upload_index(a, self.device)
                           for a in self._pairs)
            self._tf_matrix: torch.Tensor | None = None  # first BM25 call
            if self.tf_dtype == torch.bfloat16:
                # the only resident matrix: raw tf in bf16, weighted by
                # the quantized kernel (TF-IDF) or widened (BM25)
                self.doc_matrix = None
                self._tf_matrix = dense_tf_matrix(
                    pt, pd, ptf, vocab_size=meta.vocab_size,
                    num_docs=meta.num_docs, dtype=torch.bfloat16)
                self._pairs = None
                return
            self.doc_matrix = dense_doc_matrix(
                pt, pd, ptf, vocab_size=meta.vocab_size,
                num_docs=meta.num_docs)
            return
        # tiered sparse: a budget-capped dense strip for the hottest terms
        # plus geometric-capacity padded tiers for the rest, raw tf
        # everywhere so the same arrays serve TF-IDF and BM25
        if tiers is None:
            tiers = build_tiered_layout(self._pairs[1], self._pairs[2],
                                        np.asarray(df),
                                        num_docs=meta.num_docs)
        self._pairs = None               # the tiers hold every posting
        self.hot_rank = upload_index(tiers.hot_rank, self.device)
        # densified on the device: only the COO postings cross the link
        self.tf_dtype = _strip_dtype(meta, tiers.hot_vals)
        self.hot_tfs = tiers.hot_device(self.device, dtype=self.tf_dtype)
        self.tier_of = upload_index(tiers.tier_of, self.device)
        self.row_of = upload_index(tiers.row_of, self.device)
        # slim uint16 host columns are widened to int32 at upload; the
        # kernel's tier table is built once here, not per query block
        self.cold_tiers = TierTable(
            [upload_index(a, self.device) for a in tiers.tier_docs],
            [upload_index(a, self.device) for a in tiers.tier_tfs])
        self._wstrip_cache: dict[str, torch.Tensor] = {}

    # -- loading -----------------------------------------------------------

    @classmethod
    def load(cls, index_dir: str, *, layout: str = "auto",
             compat_int_idf: bool = False,
             device: str | torch.device | None = None) -> "Scorer":
        """Load an index dir (built by either package, raw or compressed)
        onto the device. Side files are verified against their recorded
        checksums, and each part file is verified by the one streamed
        read that loads it (a compressed part is then decoded)."""
        dev = resolve_device(device)
        meta = fmt.IndexMetadata.load(index_dir)
        resolved = _resolve_layout(layout, meta)  # fail before any reads
        fmt.require_arena_format(meta.format_version)
        fmt.verify_checksums(index_dir, meta,
                             names=[fmt.DOCLEN, fmt.DOCNOS, fmt.VOCAB])
        vocab = Vocab.load(os.path.join(index_dir, fmt.VOCAB))
        mapping = DocnoMapping.load(os.path.join(index_dir, fmt.DOCNOS))
        doc_len = np.load(os.path.join(index_dir, fmt.DOCLEN))
        df, pair_doc, pair_tf = _assemble_csr(index_dir, meta)
        # the term column is read by the dense scatter only
        pair_term = pair_term_from_df(df) if resolved == "dense" else None
        return cls(vocab=vocab, mapping=mapping,
                   pair_term=pair_term, pair_doc=pair_doc,
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
        if self.layout == "sparse":
            ws = self._hot_wstrip(scoring)
            strip = self.hot_tfs if ws is None else ws
            if scoring == "bm25":
                return bm25_topk_tiered(
                    q, self.hot_rank, strip, self.tier_of, self.row_of,
                    self.cold_tiers, self.df, self.doc_len, n,
                    k=k, k1=K1, b=B, hot_preweighted=ws is not None)
            return tfidf_topk_tiered(
                q, self.hot_rank, strip, self.tier_of, self.row_of,
                self.cold_tiers, self.df, n, k=k,
                compat_int_idf=self.compat_int_idf,
                hot_preweighted=ws is not None)
        if scoring == "bm25":
            return bm25_topk_dense(q, self._ensure_tf_matrix(), self.df,
                                   self.doc_len, n, k=k, k1=K1, b=B)
        if self.doc_matrix is None:                  # bf16 raw-tf matrix
            return tfidf_topk_dense_quantized(
                q, self._tf_matrix, self.df, n, k=k,
                compat_int_idf=self.compat_int_idf)
        return tfidf_topk_dense(q, self.doc_matrix, self.df, n, k=k,
                                compat_int_idf=self.compat_int_idf)

    def _hot_wstrip(self, scoring: str) -> torch.Tensor | None:
        """The device-cached pre-weighted hot strip of a scoring mode
        (lntf_strip / bm25_strip), or None when one more strip-sized
        buffer would pass half the hot budget (the JAX package's auto
        rule). The weighting is query-independent; cached, the hot stage
        is the product alone, with bitwise the same scores. The test is on
        elements, not bytes, so a bf16 strip makes the same decision as a
        float32 one; a bf16 strip is widened first, exactly."""
        h, d1 = self.hot_tfs.shape
        if h * d1 > HOT_BUDGET // 2:
            return None
        key = "bm25" if scoring == "bm25" else "tfidf"
        if key not in self._wstrip_cache:
            hot = self.hot_tfs.to(torch.float32)
            self._wstrip_cache[key] = (
                bm25_strip(hot, self.doc_len, self.meta.num_docs,
                           k1=K1, b=B) if key == "bm25"
                else lntf_strip(hot))
        return self._wstrip_cache[key]

    def _ensure_tf_matrix(self) -> torch.Tensor:
        """The dense [V, D+1] raw-tf matrix: built on the first BM25 call
        (float32), or the resident bf16 one."""
        if self._tf_matrix is None:
            pt, pd, ptf = (upload_index(a, self.device)
                           for a in self._pairs)
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


def _strip_dtype(meta: fmt.IndexMetadata, tfs: np.ndarray) -> torch.dtype:
    """The dtype of the resident raw-tf matrix or hot strip: bf16 when the
    index is compressed and every tf it holds round-trips bf16 exactly
    (integers up to 256 do), so the widened values are the raw index's;
    otherwise float32, with a warning for a compressed index, since a
    silent narrowing would change rankings."""
    if not meta.compressed:
        return torch.float32
    exact = bf16_exact(tfs)
    if exact.all():
        return torch.bfloat16
    logger.warning(
        "compressed index requested a bf16 tf matrix but %d tfs do not "
        "round-trip bf16 exactly; serving it in float32 (exact, no memory "
        "saving)", int((~exact).sum()))
    return torch.float32


def _resolve_layout(layout: str, meta: fmt.IndexMetadata) -> str:
    if layout not in ("auto", "dense", "sparse", "sharded"):
        raise ValueError(f"unknown layout {layout!r}; expected 'auto', "
                         "'dense', 'sparse' or 'sharded'")
    if layout == "auto":
        v, d = meta.vocab_size, meta.num_docs
        return "dense" if v * (d + 1) <= DENSE_BUDGET else "sparse"
    if layout == "sharded":
        raise ValueError(f"layout 'sharded' (the tiered layout's doc axis "
                         f"over several GPUs) {_LATER}")
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
