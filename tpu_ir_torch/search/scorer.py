"""The Scorer: load an index to the device once, answer query batches.

The counterpart of `tpu_ir/search/scorer.py` for two layouts:

- dense (V*(D+1) <= DENSE_BUDGET under layout="auto"): the whole index
  lives on the device as a [V, D+1] (1 + ln tf) doc matrix (plus a raw-tf
  matrix built on the first BM25 call). Dense TF-IDF runs the fused CUDA
  kernel (ops/fused_scoring.py); BM25 runs plain torch.
- sparse (above DENSE_BUDGET): the tiered layout of search/layout.py, a
  budget-capped dense hot strip plus padded df tiers, served as the JAX
  package's production tiered path: the cold tiers through the cold-tier
  CUDA kernel (ops/cold_tier.py), one launch per query block, then the
  hot strip through the hot-stage CUDA kernel (ops/hot_stage.py). With
  `prune` (the default) a batch runs the MaxScore schedule: queries with
  no hot term go first, in blocks that skip the hot stage, and blocks
  that hold hot terms go through block-max pruning where it engages
  (the bounds from blockmax.arena, or computed at load). Results are
  bitwise those of `prune=False`.

`rerank_topk` and `search_batch(rerank=N)` are the two-stage retrieval
of the JAX package on both layouts: BM25 top-N, then cosine TF-IDF over
those candidates, with the doc norms computed from the postings on first
use.

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

The serving surface of the JAX Scorer (`tpu_ir.serving`'s caller):
`topk_tagged` / `rerank_topk_tagged` return the per-request `degraded`
flag. With a deadline (per call or `Scorer(deadline_s=)`) or a fault plan
installed, a dispatch runs under `faults.run_with_deadline`; a deadline
expiry or a device loss that `faults.is_device_loss` recognises answers
from `_topk_host` (numpy float32 over the host postings, the JAX
package's code) and is tagged and counted. `force_host` (an open circuit
breaker) goes to the host directly. Any other error raises: nothing falls
back when a kernel fails to build or launch. `hot_only` scores the tiered
hot strip alone (the ladder's cheapest level; a no-op on the dense
layout). `pad_to`, `width_floor` and `rung_ladder` are the coalescer's
closed set of batch shapes; a query keeps its bits in any padded batch.

Query analysis is the JAX package's, k-gram composition for a k > 1
index included. On an index with char-gram artifacts a glob token ('te*',
'ho?se') or a fuzzy token ('salmn~', 'color~2') expands on the host to an
OR over at most WILDCARD_LIMIT vocabulary terms (search/wildcard.py); on
a k > 1 index the expansions come from the token vocabulary (tokens.txt)
and compose k-gram terms window by window. The expanded id row is the
JAX package's, id for id and slot for slot, and goes down the same
dispatch as any other row.

On an index built with positions (format v2) a text holding a quoted
span is a phrase query: its spans must match as ordered windows
(`phrase_slop` extra gaps), found and scored on the host in numpy as in
the JAX package (search/phrase.py); `prox=True` adds the positional
proximity boost as stage 3 of the rerank. `explain_k` / `explain_ks`
attach the exact per-term decomposition of the top hits, read out of
the same kernels the top-k ran (search/explain.py), and `snippet`
renders a highlighted window from the document store.
`load_generation` / `reload_generation` serve a live index's compacted
generations (index/segments.py). `doc_range=(lo, hi)` restricts a scorer
to one shard's docs for the shard worker tier (serving/shardset.py),
bitwise the unrestricted scores inside the range, and `cosine_scores_at`
is that tier's rerank stage 2.

Every load-time upload streams through utils/transfer.py::
stream_to_device (pinned chunks on a side stream on the card).

Not in this slice (each raises ValueError naming a later slice): the
sharded layout and the query log. The JAX package's donated-query twins
(`donate`, `TPU_IR_BATCH_DONATE`) have no counterpart: torch frees a
batch's query tensor when its last reference goes, so there is nothing
to donate.
"""

from __future__ import annotations

import itertools
import logging
import os
import re
import threading
import time
from typing import Sequence

import numpy as np
import torch

from .. import envvars, faults, resolve_device
from ..analysis import Analyzer
from ..collection import KGRAM_SEP, DocnoMapping, Vocab, kgram_terms
from ..index import format as fmt
from ..index.blockmax import load_block_bounds
from ..index.compress import bf16_exact
from ..obs import get_registry, kernel_annotation, profiling, querylog
from ..obs import trace as obs_trace
from ..ops.cold_tier import TierTable
from ..ops.postings import pair_term_from_df
from ..ops.scoring import (
    blockmax_cand_blocks,
    bm25_strip,
    bm25_topk_blockmax,
    bm25_topk_dense,
    bm25_topk_tiered,
    cosine_rerank_dense,
    cosine_rerank_tiered,
    dense_doc_matrix,
    dense_tf_matrix,
    idf_weights,
    lntf_strip,
    tfidf_topk_blockmax,
    tfidf_topk_dense,
    tfidf_topk_dense_quantized,
    tfidf_topk_tiered,
)
from ..utils.report import recovery_counters
from ..utils.transfer import stream_to_device
from .layout import (
    HOT_BUDGET,
    TieredPostings,
    build_tiered_layout,
    load_serving_cache,
    restrict_tiers,
    save_serving_cache,
    serving_cache_writable,
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
# token ('salmn~', 'color~2'; the '~' follows a token, and the distance is
# one digit, so '5~10' keeps the literal '10'): the JAX package's patterns
_WILDCARD_RE = re.compile(r"\S*[*?]\S*")
_FUZZY_RE = re.compile(r"(\S+?)~(\d?)(?=[\s.,;:!)\]}]|$)")

# punctuation the analyzer strips from a literal token, stripped from a
# glob token's edges too ('fish*,' is the pattern 'fish*')
_EDGE_PUNCT = "".join(c for c in
                      r"""!"#$%&'()+,-./:;<=>@[\]^_`{|}~""" if c not in "*?")

# interior punctuation splits a glob token as the analyzer splits a
# literal one ('salmon,fish*' is the literal 'salmon' and the pattern
# 'fish*'); '.' and "'" stay inside parts for acronyms and apostrophes
_GLOB_SPLIT_RE = re.compile(
    "[" + re.escape("".join(c for c in _EDGE_PUNCT if c not in ".'")) + "]+")


def compute_doc_norms(pair_term, pair_doc, pair_tf, df,
                      num_docs: int) -> np.ndarray:
    """float32 [D+1] doc-vector norms under (1 + ln tf) * idf weights (the
    cosine rerank's denominator) from the host CSR columns, as
    `tpu_ir/search/scorer.py::compute_doc_norms`: float32 weights squared
    and summed per doc in float64, 2^24 pairs at a time. The idf is the
    port's float idf on the CPU, whatever compat mode serves. With
    `pair_term=None` each pair's term is its df run (the columns are in
    global CSR order)."""
    idf = idf_weights(torch.from_numpy(np.asarray(df, np.int32)),
                      num_docs).numpy()
    indptr = (None if pair_term is not None
              else np.cumsum(np.asarray(df, np.int64)))
    sq = np.zeros(num_docs + 1, np.float64)
    step = 1 << 24
    for lo in range(0, len(pair_doc), step):
        sl = slice(lo, min(lo + step, len(pair_doc)))
        if pair_term is not None:
            terms = pair_term[sl]
        else:
            # pair i's term: the first run start strictly above i
            terms = np.searchsorted(indptr,
                                    np.arange(sl.start, sl.stop,
                                              dtype=np.int64),
                                    side="right").astype(np.int64)
        w = (1.0 + np.log(np.maximum(pair_tf[sl], 1)
                          .astype(np.float32))) * idf[terms]
        sq += np.bincount(pair_doc[sl], weights=w * w,
                          minlength=num_docs + 1)
    return np.sqrt(sq[: num_docs + 1]).astype(np.float32)


class SearchResult(list):
    """List of (docid, score) or (docno, score) tuples for one query,
    best first, with the JAX package's serving tags:

    `degraded`: the results came from the host fallback (deadline expiry,
    device loss, or an open circuit breaker), a correct ranking by the
    host's float32 scoring but not the device path's. `level`: the
    service level that answered ("full" unless a ServingFrontend stepped
    its ladder down). `breaker_vote`: in a coalesced batch exactly one
    result carries True, so the breaker gets one verdict per dispatch.
    `generation`: the index generation that answered (0: a batch-built
    index). `explain`: the per-term decompositions of the top hits when
    `search_batch(explain_k=N)` asked for them (search/explain.py), None
    otherwise and on a degraded or proximity-boosted result. `snippets`:
    one highlighted text window a hit when the serving frontend was asked
    for them. A routed answer (serving/router.py) also carries `partial`
    (a shard is missing from it), `shards_ok` and `missing_shards` (shard
    ids) and `hedges` (hedged attempts it took). `trace_id`: the id of the
    distributed trace that answered, stamped by the ServingFrontend that
    minted it or by the Router (obs/disttrace.py); None on a plain Scorer
    call."""

    degraded: bool = False
    level: str = "full"
    explain: list | None = None
    snippets: list | None = None
    breaker_vote: bool = True
    generation: int = 0
    partial: bool = False
    shards_ok: tuple = ()
    missing_shards: tuple = ()
    hedges: int = 0
    trace_id: str | None = None


class Scorer:
    # max elements of the [B_block, D+1] score accumulator per dispatch
    SCORE_BUDGET = 250_000_000
    # least number of hot-free queries worth a block of their own (that
    # skips the hot stage) when a batch also holds hot queries
    MIN_SKIP_GROUP = 32
    # most vocabulary terms one wildcard or fuzzy token expands to
    WILDCARD_LIMIT = 64
    # a shard worker's (lo, hi) docids; None serves every doc
    doc_range: tuple | None = None

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
        prune: bool = True,
        pairs_loader=None,
        deadline_s: float | None = None,
        index_dir: str | None = None,
        doc_norms: np.ndarray | None = None,
        doc_range: tuple | None = None,
    ):
        """Build the layout on `device` from the host postings columns
        (global CSR order). The sparse layout may come prebuilt as
        `tiers` instead, with the columns None. `prune` runs the tiered
        layout's MaxScore schedule and block-max pruning (bitwise the
        same results). The rerank's doc norms and the host fallback read
        the postings columns, or `pairs_loader()` (which returns df,
        pair_doc, pair_tf) once, on first use. `deadline_s` bounds every
        score dispatch that names no deadline of its own. `index_dir`,
        where the index was loaded from, is where wildcard and fuzzy
        expansion read the char-gram artifacts (without it, glob and
        fuzzy tokens are literal text, as in the JAX package). `doc_norms`
        are the rerank's norms where they are known already (the serving
        cache holds them).

        `doc_range=(lo, hi)` (1-based inclusive global docids) makes this
        a shard worker's scorer (serving/shardset.py): the layout keeps
        its whole geometry, but every posting outside the range has its
        tf zeroed (layout.restrict_tiers on the tiered layout, the pair tf
        column on the dense one), so a doc inside the range scores bitwise
        as under the unrestricted scorer and a doc outside scores 0.0 and
        never surfaces. df, N, the doc lengths and the rerank's norms
        stay global.

        Lazy state (the weighted strips, block-max's bound tables, the
        BM25 tf matrix, the doc norms, the host postings) is built outside
        any lock and published by one assignment: two racing threads may
        both build it, and one copy is dropped."""
        self.device = resolve_device(device)
        self.vocab = vocab
        self.mapping = mapping
        self.meta = meta
        self.compat_int_idf = compat_int_idf
        self.layout = _resolve_layout(layout, meta)
        self.prune = prune
        self.deadline_s = deadline_s
        # the index generation (a batch-built index is generation 0) and,
        # for a scorer of a live index, its dir and load kwargs
        # (load_generation), which reload_generation replays
        self.generation = 0
        self._live_dir: str | None = None
        self._load_kwargs: dict = {}
        # one analyzer a thread: the tag tokenizer keeps each call's
        # state on the instance, so concurrent callers must not share one
        self._analyzers = threading.local()
        # the char-gram lookups, loaded on the first query that needs
        # them, under the lock
        self._index_dir = index_dir
        self._lazy_lock = threading.Lock()
        self._wildcard: list | None = None
        self._wildcard_tried = False
        self._phrase = None
        self._store = None
        self._norms_np: np.ndarray | None = (
            None if doc_norms is None else np.array(doc_norms, np.float32))
        self._norms: torch.Tensor | None = None
        self._host_pairs: tuple | None = None
        self._pairs_loader = pairs_loader
        # what block-max did, summed over this scorer's dispatches under a
        # lock (the registry's blockmax.* counters sum every scorer's)
        self.blockmax_stats = {"blocks_considered": 0, "blocks_masked": 0,
                               "fallback_dispatches": 0,
                               "saved_dispatches": 0}
        self._stats_lock = threading.Lock()
        # (rows, width, variant, scoring, k) of the dispatches the
        # coalescer warmed (serving/batching.py::precompile)
        self.warmed_shapes: set = set()
        # host postings columns (pair_term is needed by the dense layout
        # only, which keeps them for its BM25 matrix); the tiered layout
        # may come prebuilt without them and drops them once built
        self._pairs = (None if pair_doc is None else
                       (pair_term, np.asarray(pair_doc), np.asarray(pair_tf)))
        if (self.layout == "dense" and pair_term is None) or (
                self._pairs is None and tiers is None):
            raise ValueError(f"layout {self.layout!r} needs the postings "
                             "columns or a prebuilt tiered layout")
        self.doc_range = None
        if doc_range is not None:
            lo, hi = int(doc_range[0]), int(doc_range[1])
            if lo < 1 or hi > meta.num_docs:
                raise ValueError(f"doc_range {doc_range!r} outside the "
                                 f"index's 1..{meta.num_docs} docid space")
            self.doc_range = (lo, hi)
            if self.layout == "dense":
                # one mask of the tf column restricts every dense path:
                # the doc matrix, the BM25 tf matrix and the host fallback
                pdoc = self._pairs[1].astype(np.int64)
                ptf = np.array(self._pairs[2])
                ptf[(pdoc < lo) | (pdoc > hi)] = 0
                self._pairs = (self._pairs[0], self._pairs[1], ptf)
        self._df_host = np.asarray(df)
        if self._pairs is not None and self._pairs_loader is None:
            # the rerank's norms come from these columns when first asked,
            # also after a layout that drops them is built
            cols = (self._df_host,) + self._pairs[1:]
            self._pairs_loader = lambda: cols
        # the host fallback reads these, never the device
        self._doc_len_host = np.asarray(doc_len)
        self.df = upload_index(df, self.device, label="df")
        self.doc_len = upload_index(doc_len, self.device, label="doc_len")
        if self.layout == "dense":
            self.tf_dtype = _strip_dtype(meta, self._pairs[2])
            pt, pd, ptf = (upload_index(a, self.device, label=name)
                           for a, name in zip(self._pairs, _PAIR_LABELS))
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
                                        self._df_host,
                                        num_docs=meta.num_docs)
        self._pairs = None               # the tiers hold every posting
        if self.doc_range is not None:
            tiers = restrict_tiers(tiers, *self.doc_range)
        self._hot_rank_host = np.asarray(tiers.hot_rank)
        self.hot_rank = upload_index(tiers.hot_rank, self.device,
                                     label="hot_rank")
        # densified on the device: only the COO postings cross the link
        self.tf_dtype = _strip_dtype(meta, tiers.hot_vals)
        with obs_trace("load.strip", rows=int(tiers.num_hot)):
            self.hot_tfs = tiers.hot_device(self.device, dtype=self.tf_dtype)
        self.tier_of = upload_index(tiers.tier_of, self.device,
                                    label="tier_of")
        self.row_of = upload_index(tiers.row_of, self.device, label="row_of")
        # slim uint16 host columns are widened to int32 at upload; the
        # kernel's tier table is built once here, not per query block
        self.cold_tiers = TierTable(
            [upload_index(a, self.device, label=f"tier_docs_{i}")
             for i, a in enumerate(tiers.tier_docs)],
            [upload_index(a, self.device, label=f"tier_tfs_{i}")
             for i, a in enumerate(tiers.tier_tfs)])
        self._wstrip_cache: dict[str, torch.Tensor] = {}
        # block-max bounds: the hot rows' largest tf per doc block
        self._hot_blk_max = tiers.hot_blk_max
        self._blockmax_width = int(tiers.blockmax_width or 0)
        self._blockmax_tables: dict[str, torch.Tensor] = {}

    # -- loading -----------------------------------------------------------

    @classmethod
    def load(cls, index_dir: str, *, layout: str = "auto",
             compat_int_idf: bool = False,
             device: str | torch.device | None = None,
             prune: bool = True,
             deadline_s: float | None = None,
             doc_range: tuple | None = None) -> "Scorer":
        """Load an index dir (built by either package, any format) onto
        the device (`deadline_s`, `doc_range`: as the constructor's).
        Side files are verified against their recorded checksums, and each
        part file is verified by the one streamed read that loads it (a
        compressed part is then decoded). The tiered layout takes its block-max
        bounds from blockmax.arena; a corrupt artifact is quarantined and
        the bounds are computed from the postings instead.

        The tiered layout goes through the serving cache (search/
        layout.py): a hit maps the tiers, df and the rerank's doc norms
        from `serving-tiered/` and reads no part (the host postings stay
        lazy, verified as they stream); a miss builds the layout from the
        parts and, when the dir is writable, computes the norms and writes
        the cache. The dense layout has no cache.

        With a `doc_range` on a compressed index the range goes into the
        parts' decode, so posting blocks wholly outside it are never
        decoded (they come back as (doc 0, tf 0) slots); such a partial
        read writes no cache. A raw index is read whole and restricted
        after. The stages are spans: `load.meta` (the metadata and the
        side files' checksums), `load.vocab` (the vocabulary, the docnos
        and the doc lengths), `load.read` (the parts, or a cache hit),
        `load.layout`, `load.norms`, `load.cache_write`, and in the
        constructor `load.strip` and each upload's `load.h2d`."""
        from ..obs.server import register_index_dir

        dev = resolve_device(device)
        register_index_dir(index_dir)          # /doctor reports it
        with obs_trace("load.meta"):
            meta = fmt.IndexMetadata.load(index_dir)
            resolved = _resolve_layout(layout, meta)  # fail before reads
            fmt.require_known_format(meta.format_version)
            fmt.verify_checksums(index_dir, meta,
                                 names=[fmt.DOCLEN, fmt.DOCNOS, fmt.VOCAB])
        with obs_trace("load.vocab"):
            vocab = Vocab.load(os.path.join(index_dir, fmt.VOCAB))
            mapping = DocnoMapping.load(os.path.join(index_dir, fmt.DOCNOS))
            doc_len = np.load(os.path.join(index_dir, fmt.DOCLEN))
        # the rerank's norms and the host fallback re-read the postings on
        # first use: the tiered layout keeps no host copy of them
        loader = lambda: _assemble_csr(index_dir, meta)  # noqa: E731
        if resolved == "sparse":
            with obs_trace("load.read", cache=True):
                cached = load_serving_cache(index_dir, meta=meta)
            if cached is not None:
                tiers, df, norms = cached
                return cls(vocab=vocab, mapping=mapping, pair_term=None,
                           pair_doc=None, pair_tf=None, df=np.asarray(df),
                           doc_len=doc_len, meta=meta, layout=layout,
                           compat_int_idf=compat_int_idf, device=dev,
                           tiers=tiers, prune=prune, pairs_loader=loader,
                           deadline_s=deadline_s, index_dir=index_dir,
                           doc_norms=norms, doc_range=doc_range)
        lean = doc_range if meta.compressed else None
        with obs_trace("load.read", shards=meta.num_shards):
            df, pair_doc, pair_tf = _assemble_csr(index_dir, meta,
                                                  doc_range=lean)
        if resolved == "sparse":
            bounds = load_block_bounds(index_dir, meta,
                                       quarantine_corrupt=True)
            with obs_trace("load.layout"):
                tiers = build_tiered_layout(pair_doc, pair_tf, df,
                                            num_docs=meta.num_docs,
                                            block_bounds=bounds)
            norms = None
            # the norms pass is paid here only for the cache; on a
            # read-only dir, or from a range-restricted read (whose dead
            # slots would poison every later full load), they stay lazy
            if lean is None and serving_cache_writable(index_dir):
                with obs_trace("load.norms"):
                    norms = compute_doc_norms(None, pair_doc, pair_tf, df,
                                              meta.num_docs)
                with obs_trace("load.cache_write"):
                    save_serving_cache(index_dir, tiers, df, norms,
                                       meta=meta)
            return cls(vocab=vocab, mapping=mapping, pair_term=None,
                       pair_doc=None, pair_tf=None, df=df, doc_len=doc_len,
                       meta=meta, layout=layout,
                       compat_int_idf=compat_int_idf, device=dev,
                       tiers=tiers, prune=prune, pairs_loader=loader,
                       deadline_s=deadline_s, index_dir=index_dir,
                       doc_norms=norms, doc_range=doc_range)
        # the term column is read by the dense scatter only
        return cls(vocab=vocab, mapping=mapping,
                   pair_term=pair_term_from_df(df), pair_doc=pair_doc,
                   pair_tf=pair_tf, df=df, doc_len=doc_len, meta=meta,
                   layout=layout, compat_int_idf=compat_int_idf, device=dev,
                   prune=prune, pairs_loader=loader, deadline_s=deadline_s,
                   index_dir=index_dir, doc_range=doc_range)

    @classmethod
    def load_generation(cls, live_dir: str, generation: int | None = None,
                        **load_kwargs) -> "Scorer":
        """Load one generation of a live index (index/segments.py), or a
        plain index dir as generation 0. The generation must be servable
        (one segment, no tombstones: `ingest --compact` makes one); None
        follows the newest servable one. The scorer is stamped with its
        generation and remembers the live dir and `load_kwargs` (passed
        to Scorer.load, `device` and `doc_range` included), which
        reload_generation replays."""
        from ..index import segments as seg

        index_dir, gen = seg.resolve_serving(live_dir, generation)
        scorer = cls.load(index_dir, **load_kwargs)
        scorer.generation = int(gen)
        scorer._live_dir = (os.path.abspath(live_dir)
                            if seg.is_live(live_dir) else None)
        scorer._load_kwargs = dict(load_kwargs)
        return scorer

    def reload_generation(self, generation: int | None = None,
                          **override_kwargs) -> "Scorer":
        """A new Scorer over the given (or newest servable) generation of
        this scorer's live dir, loaded with the same kwargs (overridable: a
        shard worker passes the doc_range it recomputed for the new
        generation's doc count).
        A functional swap, never an in-place change: the query path reads
        many attributes per request, and changing them under a running
        request would tear it. This scorer stays valid (in-flight requests
        finish on the arrays they hold); the publish is the caller's one
        reference assignment (ServingFrontend.reload_generation)."""
        if self._live_dir is None:
            raise ValueError("this scorer was not loaded from a live "
                             "index dir (use Scorer.load_generation)")
        kwargs = {**self._load_kwargs, **override_kwargs}
        return type(self).load_generation(self._live_dir, generation,
                                          **kwargs)

    # -- query pipeline ----------------------------------------------------

    def _analyzer(self) -> Analyzer:
        analyzer = getattr(self._analyzers, "analyzer", None)
        if analyzer is None:
            analyzer = self._analyzers.analyzer = Analyzer()
        return analyzer

    def _wildcard_lookups(self) -> list:
        """The char-gram lookups, largest k first, loaded once; [] when
        the index has no char-gram artifacts or no directory. They cover
        the token vocabulary: a k = 1 index's own vocabulary (shared), a
        k > 1 index's tokens.txt."""
        if not self._wildcard_tried:
            with self._lazy_lock:
                if not self._wildcard_tried:
                    self._load_wildcard_lookups()
        return self._wildcard or []

    def _load_wildcard_lookups(self) -> None:
        """Under _lazy_lock; sets _wildcard_tried last, so no reader sees
        it set with the lookups unloaded."""
        try:
            if self._index_dir and self.meta.chargram_ks:
                from ..index.builder import TOKENS_VOCAB
                from .wildcard import WildcardLookup

                if self.meta.k == 1:
                    shared = self.vocab
                else:
                    # one read of tokens.txt for every k
                    tok = os.path.join(self._index_dir, TOKENS_VOCAB)
                    shared = Vocab.load(tok) if os.path.exists(tok) \
                        else None
                self._wildcard = [
                    WildcardLookup.load(self._index_dir, ck, vocab=shared)
                    for ck in sorted(self.meta.chargram_ks, reverse=True)]
        finally:
            self._wildcard_tried = True

    def _pattern_tokens(self, pattern: str) -> list[str] | None:
        """The token-vocabulary expansion of one glob pattern through the
        largest char-gram k whose grams cover it; None when none does
        (a pattern too short for every k, such as '*')."""
        for lookup in self._wildcard_lookups():
            if lookup.pattern_grams(pattern):
                # k > 1 keeps the lexicographically first LIMIT matches,
                # the prefix a limited expand returns; k = 1 ranks every
                # match by df
                limit = (None if self.meta.k == 1
                         else self.WILDCARD_LIMIT + 1)
                terms = lookup.expand(pattern, limit=limit)
                if len(terms) > self.WILDCARD_LIMIT:
                    terms = self._truncate_expansion(pattern, terms)
                return terms
        return None

    def _truncate_expansion(self, pattern: str, terms: list[str]
                            ) -> list[str]:
        """An over-limit expansion cut to WILDCARD_LIMIT terms. k = 1: the
        highest-df matches, ties to the lower term id, in (df desc, id
        asc) order. k > 1 (the token vocabulary has no df): the
        lexicographically first ones. Both are the JAX package's pinned
        rules."""
        if self.meta.k != 1:
            logger.warning(
                "pattern %r matches more than %d terms; expansion "
                "truncated to the lexicographically-first %d",
                pattern, self.WILDCARD_LIMIT, self.WILDCARD_LIMIT)
            return terms[: self.WILDCARD_LIMIT]
        logger.warning(
            "pattern %r matches %d terms; expansion truncated to %d",
            pattern, len(terms), self.WILDCARD_LIMIT)
        df = self._df_host
        ids = np.array([self.vocab.id_or(t) for t in terms])
        order = np.lexsort((ids, -df[ids]))[: self.WILDCARD_LIMIT]
        return [terms[i] for i in order.tolist()]

    def _fuzzy_lookup_for(self, token: str, max_edits: int):
        """The lookup fuzzy expansion consults: the largest k whose count
        bound stays positive for this token (else the smallest k), so a
        short term keeps its one-edit neighbours that share no large
        gram ('cat'/'cut' at k = 3)."""
        lookups = self._wildcard_lookups()
        return next(
            (lk for lk in lookups
             if len(token) + 3 - lk.k - max_edits * lk.k >= 1),
            lookups[-1])

    def _fuzzy_terms(self, token: str, max_edits: int) -> list[str]:
        """The fuzzy expansion of one token over a k = 1 index's
        vocabulary: at most WILDCARD_LIMIT matches, in (distance asc, df
        desc, term id asc) order."""
        lookup = self._fuzzy_lookup_for(token, max_edits)
        matches = lookup.fuzzy(token, max_edits=max_edits)
        if not matches:
            return []
        ids = np.array([self.vocab.id_or(t) for t, _ in matches])
        dist = np.array([d for _, d in matches])
        df = self._df_host
        order = np.lexsort((ids, -df[ids], dist))[: self.WILDCARD_LIMIT]
        if len(matches) > self.WILDCARD_LIMIT:
            logger.warning(
                "fuzzy token %r~%d matches %d terms; expansion truncated "
                "to %d", token, max_edits, len(matches),
                self.WILDCARD_LIMIT)
        return [matches[i][0] for i in order.tolist()]

    def _expand_fuzzy(self, text: str) -> tuple[str, list[int]]:
        """The text without its fuzzy tokens, and the term ids of their
        expansions (an OR, as for wildcards); k = 1."""
        from .wildcard import MAX_FUZZY_EDITS

        extra: list[int] = []

        def repl(m: re.Match) -> str:
            tok = m.group(1).strip(_EDGE_PUNCT).lower()
            if not tok or "*" in tok or "?" in tok:
                return m.group(0)   # glob and fuzzy: the glob path's
            # '~0' probes for the exact term, '~' alone is one edit
            d = min(int(m.group(2)) if m.group(2) else 1, MAX_FUZZY_EDITS)
            for t in self._fuzzy_terms(tok, d):
                tid = self.vocab.id_or(t)
                if tid >= 0:
                    extra.append(tid)
            return " "

        return _FUZZY_RE.sub(repl, text), extra

    def _expand_wildcards(self, text: str) -> tuple[str, list[int]]:
        """The text without its glob tokens, and the term ids of their
        vocabulary expansions (an OR over the matches); k = 1."""
        extra: list[int] = []

        def repl(m: re.Match) -> str:
            token = m.group(0).strip(_EDGE_PUNCT)
            literals = []
            for part in _GLOB_SPLIT_RE.split(token):
                # a trailing '?' is a question mark, not a glob: 'river?'
                # is the literal term 'river'
                part = part.rstrip("?")
                if not part:
                    continue
                if ("*" not in part and "?" not in part
                        # without char-grams the analyzer reads the part
                        or not self._wildcard_lookups()):
                    literals.append(part)
                else:
                    # a pattern no k covers ('*') expands to nothing,
                    # never to a scan of the vocabulary
                    for t in self._pattern_tokens(part.lower()) or []:
                        tid = self.vocab.id_or(t)
                        if tid >= 0:
                            extra.append(tid)
            return " ".join(literals) if literals else " "

        return _WILDCARD_RE.sub(repl, text), extra

    def _fuzzy_tokens(self, token: str, max_edits: int) -> list[str]:
        """The fuzzy expansion of one token over a k > 1 index's token
        vocabulary (no df there): at most WILDCARD_LIMIT matches in
        (distance asc, term asc) order, WildcardLookup.fuzzy's own."""
        lookup = self._fuzzy_lookup_for(token, max_edits)
        matches = lookup.fuzzy(token, max_edits=max_edits,
                               limit=self.WILDCARD_LIMIT + 1)
        if len(matches) > self.WILDCARD_LIMIT:
            logger.warning(
                "fuzzy token %r~%d matches more than %d terms; expansion "
                "truncated", token, max_edits, self.WILDCARD_LIMIT)
            matches = matches[: self.WILDCARD_LIMIT]
        return [t for t, _ in matches]

    def _analyze_expansion_kgram(self, text: str) -> list[int]:
        """A k > 1 query with glob or fuzzy tokens: each such token
        expands over the token vocabulary to one slot of candidates, each
        literal token is a slot of one, and every window of k slots
        composes its k-gram terms (the cartesian product, at most
        WILDCARD_LIMIT a window); each window is an OR over the composed
        terms the vocabulary holds."""
        from .wildcard import MAX_FUZZY_EDITS

        analyzer = self._analyzer()
        slots: list[list[str]] = []
        for raw in text.split():
            fm = (None if "*" in raw or "?" in raw
                  else _FUZZY_RE.search(raw))
            if fm is not None:
                tok = fm.group(1).strip(_EDGE_PUNCT).lower()
                if tok:
                    d = min(int(fm.group(2)) if fm.group(2) else 1,
                            MAX_FUZZY_EDITS)
                    slots.append(self._fuzzy_tokens(tok, d))
                    continue
                # nothing left after the punctuation: a literal token
            if "*" in raw or "?" in raw:
                token = raw.strip(_EDGE_PUNCT)
                for part in _GLOB_SPLIT_RE.split(token):
                    part = part.rstrip("?")
                    if not part:
                        continue
                    if "*" not in part and "?" not in part:
                        for t in analyzer.analyze(part):
                            slots.append([t])
                    else:
                        # no expansion: a slot no window matches through
                        slots.append(self._pattern_tokens(part.lower())
                                     or [])
            else:
                for t in analyzer.analyze(raw):
                    slots.append([t])
        k = self.meta.k
        row: list[int] = []
        seen: set[int] = set()
        for i in range(max(len(slots) - k + 1, 0)):
            window = slots[i : i + k]
            if any(not s for s in window):
                continue
            # each multi-candidate slot gets the same share of the
            # window's WILDCARD_LIMIT combinations (itertools.product
            # varies the last slot fastest, so a plain cut would spend
            # the budget on the first candidate of a leading glob); the
            # share is the exact integer root, not a truncated float one
            n_multi = sum(1 for s in window if len(s) > 1)
            if n_multi:
                per_slot = max(
                    int(self.WILDCARD_LIMIT ** (1.0 / n_multi)), 1)
                while (per_slot + 1) ** n_multi <= self.WILDCARD_LIMIT:
                    per_slot += 1
                window = [s[:per_slot] if len(s) > 1 else s
                          for s in window]
            for combo in itertools.islice(
                    itertools.product(*window), self.WILDCARD_LIMIT):
                tid = self.vocab.id_or(KGRAM_SEP.join(combo))
                if tid >= 0 and tid not in seen:
                    seen.add(tid)
                    row.append(tid)
        return row

    def analyze_queries(self, texts: Sequence[str],
                        width_floor: int | None = None) -> np.ndarray:
        """Analyze query texts into an int32 [B, L] id array (pad -1).

        Unknown terms are dropped (the reference's dictionary-miss path).
        Glob and fuzzy tokens expand to an OR over vocabulary terms
        through the char-gram index, as in the JAX package; ids an
        expansion shares with the literal terms, or with another
        expansion, are kept once. L is the longest row, raised to
        `width_floor` when one is given (the coalescer pins every batch
        to one width and never cuts a wider row; a -1 slot adds an exact
        0), then bucketed up to a power of two, as in the JAX package."""
        analyzer = self._analyzer()
        rows = []
        for text in texts:
            extra: list[int] = []
            has_fuzzy = "~" in text and _FUZZY_RE.search(text) is not None
            lookups = (self._wildcard_lookups()
                       if has_fuzzy or "*" in text or "?" in text else [])
            if has_fuzzy and not lookups:
                logger.warning(
                    "query %r contains a fuzzy token but the index has "
                    "no char-gram artifacts; '~' is treated as "
                    "punctuation (rebuild with chargrams for fuzzy)",
                    text)
            if has_fuzzy and self.meta.k == 1 and lookups:
                text, extra = self._expand_fuzzy(text)
            has_glob = "*" in text or "?" in text
            if (has_glob or has_fuzzy) and self.meta.k > 1 and lookups:
                rows.append(self._analyze_expansion_kgram(text))
                continue
            if has_glob:
                text, wc_extra = self._expand_wildcards(text)
                extra += wc_extra
            grams = kgram_terms(analyzer.analyze(text), self.meta.k)
            row = [i for i in (self.vocab.id_or(g) for g in grams)
                   if i >= 0]
            seen = set(row)
            row += [i for i in dict.fromkeys(extra) if i not in seen]
            rows.append(row)
        cap = max(max((len(r) for r in rows), default=1), 1)
        if width_floor:
            cap = max(cap, int(width_floor))
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
        nothing is padded).

        The dispatch split: each block's wait for the card is its
        `dispatch.device` span, the copy of its scores to the host, which
        waits for the block's work (block x k floats: the copy itself is
        microseconds). No synchronization point of its own, so no extra
        release of the interpreter lock a block, which other serving
        threads would take; on the CPU nothing waits. Beside it the
        block's `kernel` span (the host's launches); a memory sample
        follows the dispatch (obs/profiling.py, rate-limited)."""
        b = q.shape[0]
        if b == 0:
            return np.zeros((0, 0), np.float32), np.zeros((0, 0), np.int32)
        parts = []
        for lo in range(0, b, block):
            s, d = dispatch(q[lo : lo + block])
            with obs_trace("dispatch.device", rows=min(block, b - lo)):
                s_host = s.cpu()
            parts.append((s_host.numpy(), d.cpu().numpy()))
        profiling.sample_memory()
        if len(parts) == 1:
            return parts[0]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    def topk(self, q_terms: np.ndarray, k: int = 10,
             scoring: str = "tfidf", deadline_s: float | None = None, *,
             hot_only: bool = False, force_host: bool = False
             ) -> tuple[np.ndarray, np.ndarray]:
        """Score an id batch. Returns host arrays (scores [B, k] float32,
        docnos [B, k] int32, docno 0 = empty slot), in the batch's order.
        `deadline_s`, `hot_only` and `force_host` as in topk_tagged."""
        s, d, _ = self.topk_tagged(q_terms, k=k, scoring=scoring,
                                   deadline_s=deadline_s, hot_only=hot_only,
                                   force_host=force_host)
        return s, d

    def topk_tagged(self, q_terms: np.ndarray, k: int = 10,
                    scoring: str = "tfidf", deadline_s: float | None = None,
                    *, hot_only: bool = False, force_host: bool = False,
                    uniform: tuple | None = None
                    ) -> tuple[np.ndarray, np.ndarray, bool]:
        """topk() with this request's degraded flag: (scores, docnos,
        degraded), the thread-safe surface (`tpu_ir/search/scorer.py::
        topk_tagged`). A dispatch past its deadline (`deadline_s`, else
        the Scorer's) or on a lost device answers from the host and is
        tagged; `force_host` goes to the host without a dispatch (an open
        circuit breaker). `hot_only` scores the tiered hot strip alone.
        `uniform=(rungs...)` (the coalescer) pads each scheduled group to
        a ladder rung, so batch content picks no shape outside the warmed
        set; results are the same bits."""
        if scoring not in ("tfidf", "bm25"):
            raise ValueError(f"unknown scoring {scoring!r}; expected "
                             "'tfidf' or 'bm25'")
        q = np.ascontiguousarray(q_terms, dtype=np.int32)
        return self._dispatch_degradable(
            lambda: self._topk_primary(q, k, scoring, hot_only=hot_only,
                                       uniform=uniform),
            lambda: self._topk_host(q, k, scoring),
            deadline_s, "score dispatch",
            "answering from the host CPU backend", force_host=force_host)

    def _dispatch_degradable(self, primary, fallback, deadline_s,
                             label, consequence, force_host=False):
        """Run `primary` under the per-batch deadline; on expiry or a
        device loss, count and log it and answer with `fallback`, tagged.
        Any other error raises: a program or shape bug never degrades.
        With no deadline and no fault plan this is a plain call.
        `force_host` runs `fallback` directly, with no dispatch and no
        deadline thread (an open circuit breaker). Returns the result
        tuple with the degraded flag appended."""
        if force_host:
            recovery_counters().incr("forced_host_batches")
            with obs_trace("fallback", label=label, forced=True):
                return fallback() + (True,)
        deadline = self.deadline_s if deadline_s is None else deadline_s
        if deadline is None and faults.active() is None:
            with obs_trace("dispatch", label=label):
                return primary() + (False,)
        reason = None
        try:
            with obs_trace("dispatch", label=label, deadline_s=deadline):
                return (faults.run_with_deadline(primary, deadline)
                        + (False,))
        except faults.ScoreDeadlineExceeded as e:
            recovery_counters().incr("deadline_expired")
            reason = str(e)
        except Exception as e:
            if not faults.is_device_loss(e):
                raise
            recovery_counters().incr("device_loss")
            reason = f"device loss: {e}"
        recovery_counters().incr("degraded_batches")
        logger.warning("%s degraded (%s); %s", label, reason, consequence)
        with obs_trace("fallback", label=label, reason=reason):
            return fallback() + (True,)

    def _block_fn(self, k: int, scoring: str, variant: str,
                  warm_check: bool):
        """The dispatch of one query block, one of the variants "full",
        "skip" (no hot stage) and "hot_only" (no cold stage). With
        `warm_check` (a coalesced call) a block outside the coalescer's
        warmed shapes counts `dispatch.unwarmed`."""
        kw = {"full": {}, "skip": {"skip_hot": True},
              "hot_only": {"hot_only": True}}[variant]

        def run(qb):
            shape = (len(qb), qb.shape[1], variant, scoring, k)
            if warm_check and shape not in self.warmed_shapes:
                get_registry().incr("dispatch.unwarmed")
                profiling.note_unwarmed(shape)     # the port's recompile
            return self._topk_device(qb, k, scoring, **kw)

        return run

    def _topk_primary(self, q: np.ndarray, k: int, scoring: str,
                      hot_only: bool = False, uniform: tuple | None = None):
        """The device path (`tpu_ir/search/scorer.py::_topk_primary`):
        the MaxScore schedule on the tiered layout with `prune`, hot-free
        queries first, in blocks that skip the hot stage, then the rest;
        results come back in the caller's order. Outside the coalescer
        groups run at their own size: nothing is compiled per shape, so
        nothing is padded. `hot_only` runs no schedule (there is no cold
        stage to schedule around) and is a no-op on the dense layout."""
        block = self._block_size()
        hot_only = hot_only and self.layout == "sparse"
        checked = uniform is not None
        full = self._block_fn(k, scoring, "full", checked)
        skip = self._block_fn(k, scoring, "skip", checked)
        if uniform and not hot_only and self.layout == "sparse" \
                and self.prune:
            return self._topk_uniform(q, uniform, full, skip)
        if hot_only:
            return self._blocked_dispatch(
                block, self._block_fn(k, scoring, "hot_only", checked), q)
        if self.layout != "sparse" or not self.prune:
            return self._blocked_dispatch(block, full, q)
        has_hot, n_free, mode = self._skip_plan(q)
        if mode != "split":
            return self._blocked_dispatch(
                block, skip if mode == "all_skip" else full, q)
        order = self._schedule_order(has_hot)
        inv = np.argsort(order, kind="stable")
        qs = q[order]
        s1, d1 = self._blocked_dispatch(block, skip, qs[:n_free])
        s2, d2 = self._blocked_dispatch(block, full, qs[n_free:])
        return (np.concatenate([s1, s2])[inv],
                np.concatenate([d1, d2])[inv])

    def _topk_uniform(self, q: np.ndarray, rungs: tuple, full, skip):
        """The coalesced dispatch (`tpu_ir/search/scorer.py::
        _topk_uniform`): the exact MaxScore partition (hot-free rows,
        the rung's -1 pad rows among them, skip the hot stage), each
        group padded to the smallest ladder rung that holds it, so the
        shapes are rungs x {skip, full} per scoring and k, the set the
        coalescer warms. A batch whose only hot-free rows are all -1
        goes whole through one full dispatch. Unlike the JAX package on a
        TPU, a small hot-free group is never folded into the full
        dispatch: on the card a padded row costs a full top-k row over
        D+1 columns. Results are bitwise the same either way."""
        block = self._block_size()
        has_hot = self._has_hot(q)
        n_free = int((~has_hot).sum())
        if n_free == len(q):
            return self._rung_dispatch(q, block, rungs, skip)
        real_free = int((~has_hot & ~(q < 0).all(axis=1)).sum())
        if real_free == 0:
            return self._rung_dispatch(q, block, rungs, full)
        order = self._schedule_order(has_hot)
        inv = np.argsort(order, kind="stable")
        qs = q[order]
        s1, d1 = self._rung_dispatch(qs[:n_free], block, rungs, skip)
        s2, d2 = self._rung_dispatch(qs[n_free:], block, rungs, full)
        return (np.concatenate([s1, s2])[inv],
                np.concatenate([d1, d2])[inv])

    def _rung_dispatch(self, qg: np.ndarray, block: int, rungs: tuple,
                       dispatch):
        """Dispatch one scheduled group padded with -1 rows to the
        smallest ladder rung that holds it (a larger group runs as it
        is); the pad rows' results are dropped."""
        b = len(qg)
        pad_to = next((r for r in rungs if r >= b), b)
        if pad_to <= b:
            return self._blocked_dispatch(block, dispatch, qg)
        qp = np.full((pad_to, qg.shape[1]), -1, np.int32)
        qp[:b] = qg
        s, d = self._blocked_dispatch(block, dispatch, qp)
        return s[:b], d[:b]

    def _topk_host(self, q: np.ndarray, k: int, scoring: str):
        """The degraded path's host scoring (`tpu_ir/search/scorer.py::
        _topk_host`, the same numpy float32 code): each query's postings
        slices accumulated in float32 on the host, no device touched, with
        the device's tie order (score desc, docno asc). It reads the
        postings columns once, on first use."""
        df_i, pd, ptf = self._host_postings()
        df = df_i.astype(np.int64)
        indptr = np.concatenate([[0], np.cumsum(df, dtype=np.int64)])
        n = self.meta.num_docs
        doc_len = self._doc_len_host.astype(np.float32)
        if scoring == "bm25":
            dff = df.astype(np.float32)
            idf = np.where(df > 0,
                           np.log(1.0 + (n - dff + 0.5) / (dff + 0.5)),
                           0.0).astype(np.float32)
            avg = float(doc_len.sum()) / max(n, 1)
            dl_norm = 1.0 - B + B * doc_len / max(avg, 1e-9)
        else:
            if self.compat_int_idf:
                ratio = (n // np.maximum(df, 1)).astype(np.float32)
            else:
                ratio = (n / np.maximum(df, 1)).astype(np.float32)
            idf = np.where(df > 0, np.log10(np.maximum(ratio, 1e-30)),
                           0.0).astype(np.float32)
        out_s = np.zeros((len(q), k), np.float32)
        out_d = np.zeros((len(q), k), np.int32)
        scores = np.zeros(n + 1, np.float32)
        for qi, row in enumerate(q):
            scores[:] = 0.0
            for tid in row:
                if tid < 0 or tid >= len(df) or df[tid] == 0:
                    continue
                sl = slice(int(indptr[tid]), int(indptr[tid + 1]))
                tf = ptf[sl].astype(np.float32)
                if scoring == "bm25":
                    w = idf[tid] * tf * (K1 + 1.0) / np.maximum(
                        tf + K1 * dl_norm[pd[sl]], 1e-9)
                else:
                    w = (1.0 + np.log(np.maximum(tf, 1.0))) * idf[tid]
                # docnos are unique within one term's run, so fancy-index
                # += accumulates correctly across terms
                scores[pd[sl]] += w
            if self.doc_range is not None:
                # the host postings are global (only the device layout is
                # restricted): without this a degraded batch would leak
                # another shard's docs into this worker's results
                lo, hi = self.doc_range
                scores[:lo] = 0.0
                scores[hi + 1:] = 0.0
            top = np.argsort(-scores[1:], kind="stable")[:k] + 1
            keep = scores[top] > 0.0
            m = int(keep.sum())  # desc order => positives are a prefix
            out_s[qi, :m] = scores[top[:m]]
            out_d[qi, :m] = top[:m]
        return out_s, out_d

    def _has_hot(self, q: np.ndarray) -> np.ndarray:
        """Bool [B]: does the query hold a hot-strip term? (The MaxScore
        partition, on the host: a hot-free query's hot stage adds 0.)"""
        hot_rank = self._hot_rank_host
        valid = (q >= 0) & (q < len(hot_rank))
        return ((hot_rank[np.where(valid, q, 0)] >= 0) & valid).any(axis=1)

    @staticmethod
    def _schedule_order(has_hot: np.ndarray) -> np.ndarray:
        """The schedule: a stable order with the hot-free queries first."""
        return np.argsort(has_hot, kind="stable")

    def _skip_plan(self, q: np.ndarray):
        """(has_hot [B], n_free, mode), mode one of 'all_skip' (every
        query hot-free), 'all_full' (fewer than MIN_SKIP_GROUP hot-free
        queries: not worth a block of their own) and 'split'; the one
        decision topk() and prune_diag() share."""
        has_hot = self._has_hot(q)
        n_free = int((~has_hot).sum())
        if n_free == len(q):
            mode = "all_skip"
        elif n_free < self.MIN_SKIP_GROUP:
            mode = "all_full"
        else:
            mode = "split"
        return has_hot, n_free, mode

    def prune_diag(self, q_terms: np.ndarray) -> dict:
        """The MaxScore schedule of a query batch on the tiered layout, as
        topk() dispatches it: the share of hot-free queries and of blocks
        that skip the hot stage (`tpu_ir/search/scorer.py::prune_diag`)."""
        if self.layout != "sparse":
            return {"prune_layout": self.layout}
        if not self.prune:
            return {"prune_applicable": False}
        q = np.asarray(q_terms, np.int32)
        block = self._block_size()
        _, n_free, mode = self._skip_plan(q)
        if mode == "all_skip":
            skip_blocks, full_blocks = -(-len(q) // block), 0
        elif mode == "all_full":
            skip_blocks, full_blocks = 0, -(-len(q) // block)
        else:
            skip_blocks = -(-n_free // block)
            full_blocks = -(-(len(q) - n_free) // block)
        total = max(skip_blocks + full_blocks, 1)
        return {
            "prune_hot_free_query_fraction": round(
                n_free / max(len(q), 1), 4),
            "prune_skip_block_fraction": round(skip_blocks / total, 4),
            "prune_block_queries": block,
        }

    def _topk_device(self, q_terms: np.ndarray, k: int, scoring: str,
                     skip_hot: bool = False, hot_only: bool = False):
        """One query block on the device; returns device tensors.
        `skip_hot` leaves the tiered hot stage out (exact only for a
        block the schedule certified hot-free); `hot_only` leaves the
        cold stage out (partial scores; a no-op on the dense layout);
        otherwise a block on the tiered layout goes through block-max
        where _blockmax_plan engages. The fault sites `score.hang` and
        `score.device_loss` fire here, once a block. The "kernel" span
        times the block's dispatch (the device runs on; its completion
        lands in the enclosing "dispatch" span)."""
        with obs_trace("kernel", layout=self.layout, scoring=scoring,
                       rows=int(len(q_terms))), \
                kernel_annotation(f"tpu_ir_torch.topk.{self.layout}."
                                  f"{scoring}"):
            faults.maybe_hang("score.hang")
            if faults.should_fire("score.device_loss") is not None:
                raise faults.DeviceLoss("injected device loss")
            return self._topk_device_raw(q_terms, k, scoring,
                                         skip_hot=skip_hot,
                                         hot_only=hot_only)

    def _topk_device_raw(self, q_terms: np.ndarray, k: int, scoring: str,
                         skip_hot: bool, hot_only: bool):
        q = torch.from_numpy(q_terms).to(self.device)
        n = self.meta.num_docs
        if self.layout == "sparse":
            plan = (None if skip_hot or hot_only
                    else self._blockmax_plan(k, scoring))
            # the cached weighted strip serves every path that runs the
            # hot stage; the skip path never reads the strip
            ws = None if skip_hot else self._hot_wstrip(scoring)
            strip = self.hot_tfs if ws is None else ws
            if plan is not None:
                bound, width, cand = plan
                if scoring == "bm25":
                    s, d, stats = bm25_topk_blockmax(
                        q, self.hot_rank, strip, self.tier_of, self.row_of,
                        self.cold_tiers, self.df, self.doc_len, n, bound,
                        width=width, cand_blocks=cand, k=k, k1=K1, b=B,
                        hot_preweighted=ws is not None)
                else:
                    s, d, stats = tfidf_topk_blockmax(
                        q, self.hot_rank, strip, self.tier_of, self.row_of,
                        self.cold_tiers, self.df, n, bound, width=width,
                        cand_blocks=cand, k=k,
                        compat_int_idf=self.compat_int_idf,
                        hot_preweighted=ws is not None)
                self._note_blockmax_stats(stats)
                return s, d
            if scoring == "bm25":
                return bm25_topk_tiered(
                    q, self.hot_rank, strip, self.tier_of, self.row_of,
                    self.cold_tiers, self.df, self.doc_len, n,
                    k=k, k1=K1, b=B, hot_preweighted=ws is not None,
                    skip_hot=skip_hot, hot_only=hot_only)
            return tfidf_topk_tiered(
                q, self.hot_rank, strip, self.tier_of, self.row_of,
                self.cold_tiers, self.df, n, k=k,
                compat_int_idf=self.compat_int_idf,
                hot_preweighted=ws is not None, skip_hot=skip_hot,
                hot_only=hot_only)
        if scoring == "bm25":
            return bm25_topk_dense(q, self._ensure_tf_matrix(), self.df,
                                   self.doc_len, n, k=k, k1=K1, b=B)
        if self.doc_matrix is None:                  # bf16 raw-tf matrix
            return tfidf_topk_dense_quantized(
                q, self._tf_matrix, self.df, n, k=k,
                compat_int_idf=self.compat_int_idf)
        return tfidf_topk_dense(q, self.doc_matrix, self.df, n, k=k,
                                compat_int_idf=self.compat_int_idf)

    # -- block-max pruning -------------------------------------------------

    def _blockmax_plan(self, k: int, scoring: str):
        """(bound table, width, cand_blocks) for a block-max dispatch, or
        None: with `prune`, on the tiered layout, unless TPU_IR_BLOCKMAX
        is 0, and only where the mask can skip work (the budget leaves
        at least two blocks out) and the candidate columns hold the top
        k. Results are bitwise the same either way."""
        if (self.layout != "sparse" or not self.prune
                or self._hot_blk_max is None or not self._blockmax_width
                or scoring not in ("tfidf", "bm25")
                or envvars.get_choice("TPU_IR_BLOCKMAX") == "0"):
            return None
        width = self._blockmax_width
        nblk = self._hot_blk_max.shape[1]
        cand = blockmax_cand_blocks(k, self.meta.num_docs, width)
        if (cand + 2 > nblk or k > cand * width
                or k > self.meta.num_docs + 1):
            return None
        return self._blockmax_bound_table(scoring), width, cand

    def _blockmax_bound_table(self, scoring: str) -> torch.Tensor:
        """float32 [H, nblk] on the device, built once per scoring: each
        hot row's weight curve at its block's largest tf, (1 + ln tf) for
        TF-IDF; for BM25 the saturation at the block's least doc-length
        norm (it grows with tf and falls with the norm, so it bounds every
        posting of the block)."""
        table = self._blockmax_tables.get(scoring)
        if table is not None:
            return table
        max_tf = np.asarray(self._hot_blk_max, np.float32)
        if scoring == "tfidf":
            bound = np.where(max_tf > 0,
                             1.0 + np.log(np.maximum(max_tf, 1.0)), 0.0)
        else:
            width = self._blockmax_width
            d = self.meta.num_docs
            nblk = max_tf.shape[1]
            dlf = self.doc_len.cpu().numpy().astype(np.float32)
            avg = float(dlf.sum()) / max(d, 1)
            dl_norm = 1.0 - B + B * dlf / max(avg, 1e-9)
            # the dead slot 0 and the pad tail leave the block minimum be
            padded = np.full(nblk * width, np.inf, np.float32)
            padded[1: d + 1] = dl_norm[1: d + 1]
            dl_min = padded.reshape(nblk, width).min(axis=1)
            dl_min = np.where(np.isfinite(dl_min), dl_min, 0.0)
            sat = max_tf * (K1 + 1.0) / np.maximum(
                max_tf + K1 * dl_min[None, :], 1e-9)
            bound = np.where(max_tf > 0, sat, 0.0)
        table = stream_to_device(np.ascontiguousarray(bound, np.float32),
                                 device=self.device,
                                 label=f"blockmax_bounds_{scoring}")
        self._blockmax_tables[scoring] = table
        return table

    def _note_blockmax_stats(self, stats) -> None:
        """One block-max dispatch into this scorer's blockmax_stats and
        the registry's blockmax.* counters (the JAX package's names)."""
        considered, masked, fallback = stats
        key = "fallback_dispatches" if fallback else "saved_dispatches"
        with self._stats_lock:
            self.blockmax_stats["blocks_considered"] += considered
            self.blockmax_stats["blocks_masked"] += masked
            self.blockmax_stats[key] += 1
        reg = get_registry()
        reg.incr("blockmax.blocks_considered", considered)
        reg.incr("blockmax.blocks_masked", masked)
        reg.incr(f"blockmax.{key}")

    def _hot_wstrip(self, scoring: str) -> torch.Tensor | None:
        """The device-cached pre-weighted hot strip of a scoring mode
        (lntf_strip / bm25_strip), or None when one more strip-sized
        buffer would pass half the hot budget (the JAX package's auto
        rule). The weighting is query-independent; cached, the hot stage
        reads the weights directly, with bitwise the same scores. The
        test is on elements, not bytes, so a bf16 strip makes the same
        decision as a float32 one; a bf16 strip is widened first,
        exactly."""
        h, d1 = self.hot_tfs.shape
        if h * d1 > HOT_BUDGET // 2:
            return None
        key = "bm25" if scoring == "bm25" else "tfidf"
        strip = self._wstrip_cache.get(key)
        if strip is None:
            hot = self.hot_tfs.to(torch.float32)
            strip = (bm25_strip(hot, self.doc_len, self.meta.num_docs,
                                k1=K1, b=B) if key == "bm25"
                     else lntf_strip(hot))
            self._wstrip_cache[key] = strip
        return strip

    def _ensure_tf_matrix(self) -> torch.Tensor:
        """The dense [V, D+1] raw-tf matrix: built on the first BM25 call
        (float32), or the resident bf16 one."""
        matrix = self._tf_matrix
        if matrix is None:
            pt, pd, ptf = (upload_index(a, self.device, label=name)
                           for a, name in zip(self._pairs, _PAIR_LABELS))
            matrix = dense_tf_matrix(
                pt, pd, ptf, vocab_size=self.meta.vocab_size,
                num_docs=self.meta.num_docs)
            self._tf_matrix = matrix
        return matrix

    # -- two-stage rerank --------------------------------------------------

    def _host_postings(self) -> tuple:
        """(df, pair_doc, pair_tf) on the host in global CSR order: the
        dense layout's own columns, or `pairs_loader()`'s, read once."""
        cols = self._host_pairs
        if cols is None:
            if self._pairs is not None:
                cols = (self._df_host,) + tuple(self._pairs[1:])
            elif self._pairs_loader is not None:
                cols = tuple(self._pairs_loader())
            else:
                raise ValueError("the rerank's doc norms and the host "
                                 "fallback need the postings columns, "
                                 "which this Scorer was built without")
            self._host_pairs = cols
        return cols

    def _doc_norms_host(self) -> np.ndarray:
        """The rerank's float32 [D+1] doc norms on the host, computed from
        the postings on first use."""
        norms = self._norms_np
        if norms is None:
            df, pair_doc, pair_tf = self._host_postings()
            norms = compute_doc_norms(None, pair_doc, pair_tf, df,
                                      self.meta.num_docs)
            self._norms_np = norms
        return norms

    def _doc_norms(self) -> torch.Tensor:
        """The rerank's doc norms on the device."""
        norms = self._norms
        if norms is None:
            norms = stream_to_device(
                np.ascontiguousarray(self._doc_norms_host(), np.float32),
                device=self.device, label="doc_norms")
            self._norms = norms
        return norms

    def rerank_topk(self, q_terms: np.ndarray, k: int = 10,
                    candidates: int = 1000, deadline_s: float | None = None,
                    *, force_host: bool = False
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Two-stage retrieval (`tpu_ir/search/scorer.py::rerank_topk`):
        BM25 top-`candidates`, then cosine TF-IDF (ops/scoring.py::
        cosine_rerank_dense) over those candidates. Both stages run
        inside one query block, so the candidates stay on the device;
        stage 1 goes through block-max where it engages. Returns host
        arrays (scores [B, k], docnos [B, k]). Under a deadline expiry or
        a device loss it degrades to host BM25, the rerank dropped."""
        s, d, _ = self.rerank_topk_tagged(q_terms, k=k,
                                          candidates=candidates,
                                          deadline_s=deadline_s,
                                          force_host=force_host)
        return s, d

    def rerank_topk_tagged(self, q_terms: np.ndarray, k: int = 10,
                           candidates: int = 1000,
                           deadline_s: float | None = None, *,
                           force_host: bool = False
                           ) -> tuple[np.ndarray, np.ndarray, bool]:
        """rerank_topk() with this request's degraded flag (see
        topk_tagged)."""
        q = np.ascontiguousarray(q_terms, dtype=np.int32)
        return self._dispatch_degradable(
            lambda: self._rerank_primary(q, k, candidates),
            lambda: self._topk_host(q, k, "bm25"),
            deadline_s, "rerank dispatch",
            "answering with host BM25, rerank stage dropped",
            force_host=force_host)

    def _rerank_primary(self, q: np.ndarray, k: int, candidates: int):
        norms = self._doc_norms()
        n = self.meta.num_docs

        def dispatch(qb):
            qd = torch.from_numpy(qb).to(self.device)
            _, cand = self._topk_device(qb, candidates, "bm25")
            if self.layout == "dense":
                matrix = (self.doc_matrix if self.doc_matrix is not None
                          else self._tf_matrix)
                return cosine_rerank_dense(qd, matrix, self.df, norms, cand,
                                           n, k=k)
            # the cosine stage weights the strip as TF-IDF does, so it
            # takes the cached TF-IDF strip
            ws = self._hot_wstrip("tfidf")
            return cosine_rerank_tiered(
                qd, self.hot_rank, self.hot_tfs if ws is None else ws,
                self.tier_of, self.row_of, self.cold_tiers, self.df, norms,
                n, cand, k=k, hot_preweighted=ws is not None)

        return self._blocked_dispatch(self._block_size(), dispatch, q)

    def search_batch(
        self, texts: Sequence[str], k: int = 10, scoring: str = "tfidf",
        return_docids: bool = True, rerank: int | None = None,
        prox: bool = False, phrase_slop: int = 0, *,
        deadline_s: float | None = None, force_host: bool = False,
        hot_only: bool = False, explain_k: int = 0,
        explain_ks: Sequence[int] | None = None,
        pad_to: int | None = None, width_floor: int | None = None,
        rung_ladder: tuple | None = None,
        slot_meta: Sequence[dict] | None = None,
    ) -> list[SearchResult]:
        """Ranked retrieval for query texts: one SearchResult of (docid or
        docno, score) per text, best first, each tagged with this
        request's `degraded` flag (`tpu_ir/search/scorer.py::
        search_batch`). `rerank=N` is the two-stage rerank over BM25's
        top N (`scoring` then does not apply); `prox=True` adds the
        positional proximity boost to it. A text holding a double-quoted
        span is a phrase query (ordered windows, `phrase_slop` extra
        gaps), scored on the host; phrases and `prox` need an index built
        with positions.

        Serving knobs (the ServingFrontend is the intended caller):
        `deadline_s` bounds this batch's dispatch, `force_host` answers
        from the host with no dispatch, `hot_only` scores the tiered hot
        strip alone; phrase queries ignore them. `explain_k=N` attaches
        the exact decomposition of each query's top N hits
        (`SearchResult.explain`), `explain_ks` one depth a query; a
        degraded or proximity-boosted result carries None. The
        coalescer's: `pad_to=R` pads the query rows with -1 rows to R
        (their results are dropped), `width_floor` pins the analyzed
        width, `rung_ladder` pads the MaxScore groups to ladder rungs, and
        `slot_meta[i]` merges a slot's own fields (service level, queue
        wait, occupancy, trace id) into query i's query-log entry; such a
        batch cannot hold a phrase query. Every plain query leaves one
        query-log entry (obs/querylog.py)."""
        if prox and not rerank:
            raise ValueError("the proximity boost is stage 3 of the "
                             "two-stage rerank; pass rerank=N (--rerank) "
                             "together with prox (--prox)")
        texts = list(texts)
        if explain_ks is not None and len(explain_ks) != len(texts):
            raise ValueError(f"explain_ks has {len(explain_ks)} entries for "
                             f"{len(texts)} queries")
        plain = [t for t in texts if '"' not in t]
        if len(plain) != len(texts) and (
                pad_to is not None or explain_ks is not None
                or slot_meta is not None):
            # the per-slot lists index the plain batch: a phrase query in
            # it would shift every later slot's explain depth and query-log
            # attribution
            raise ValueError("a coalesced batch (pad_to / explain_ks / "
                             "slot_meta) cannot contain phrase queries "
                             "— the coalescing frontend routes them "
                             "solo")
        plain_iter = iter(self._search_batch_plain(
            plain, k=k, scoring=scoring, return_docids=return_docids,
            rerank=rerank, prox=prox, deadline_s=deadline_s,
            force_host=force_host, hot_only=hot_only, explain_k=explain_k,
            explain_ks=explain_ks, pad_to=pad_to, width_floor=width_floor,
            rung_ladder=rung_ladder, slot_meta=slot_meta) if plain else [])
        return [self._search_phrase(t, k=k, scoring=scoring,
                                    slop=phrase_slop,
                                    return_docids=return_docids,
                                    rerank=rerank, prox=prox)
                if '"' in t else next(plain_iter) for t in texts]

    def _search_batch_plain(
        self, texts: Sequence[str], *, k: int, scoring: str,
        return_docids: bool, rerank: int | None, prox: bool,
        deadline_s: float | None = None, force_host: bool = False,
        hot_only: bool = False, explain_k: int = 0,
        explain_ks: Sequence[int] | None = None,
        pad_to: int | None = None, width_floor: int | None = None,
        rung_ladder: tuple | None = None,
        slot_meta: Sequence[dict] | None = None,
    ) -> list[SearchResult]:
        t0 = time.perf_counter()
        q = self.analyze_queries(texts, width_floor=width_floor)
        if pad_to is not None and pad_to > len(q):
            q = np.vstack([q, np.full((pad_to - len(q), q.shape[1]), -1,
                                      np.int32)])
        t_analyzed = time.perf_counter()
        if rerank:
            from .phrase import PROX_DEPTH

            kk = max(k, min(PROX_DEPTH, rerank)) if prox else k
            scores, docnos, degraded = self.rerank_topk_tagged(
                q, k=kk, candidates=rerank, deadline_s=deadline_s,
                force_host=force_host)
            if prox:
                scores, docnos = self._apply_proximity(
                    texts, scores[: len(texts)], docnos[: len(texts)], k)
        else:
            scores, docnos, degraded = self.topk_tagged(
                q, k=k, scoring=scoring, deadline_s=deadline_s,
                hot_only=hot_only, force_host=force_host,
                uniform=rung_ladder if pad_to is not None else None)
        t_dispatched = time.perf_counter()
        out = []
        for qi in range(len(texts)):
            res = SearchResult()
            res.degraded = degraded
            for s, dn in zip(scores[qi], docnos[qi]):
                if dn <= 0:
                    continue
                key = (self.mapping.get_docid(int(dn)) if return_docids
                       else int(dn))
                res.append((key, float(s)))
            out.append(res)
        # the serving latency, taken before the optional explain: its
        # debug dispatches must not trip the slow-query trap on a request
        # that was served fast
        total_s = time.perf_counter() - t0
        if (explain_k or explain_ks) and not degraded and not prox:
            # the boosted scores come from the host after the kernels:
            # they are not a kernel decomposition
            from .explain import explain_hits

            for qi, text in enumerate(texts):
                ek = explain_ks[qi] if explain_ks is not None else explain_k
                top = [int(dn) for dn in docnos[qi][:ek] if dn > 0]
                if top:
                    out[qi].explain = explain_hits(
                        self, text, top, scoring=scoring, rerank=rerank,
                        hot_only=hot_only)
        self._querylog_record(
            texts, q, docnos, out, k=k, scoring=scoring, rerank=rerank,
            hot_only=hot_only, force_host=force_host, degraded=degraded,
            prox=prox, analyze_s=t_analyzed - t0,
            dispatch_s=t_dispatched - t_analyzed, total_s=total_s,
            slot_meta=slot_meta)
        return out

    def _querylog_record(self, texts, q, docnos, results, *, k, scoring,
                         rerank, hot_only, force_host, degraded, prox,
                         analyze_s, dispatch_s, total_s,
                         slot_meta=None) -> None:
        """One query-log entry a query of this batch (`tpu_ir`'s fields):
        terms (only their hash when redacted), level, the batch's stage
        split, batch id, the top hits, and the MaxScore skip decision,
        re-derived on the host from the analyzed rows (`_skip_plan` reads
        `_hot_rank_host`: no device read-back). `slot_meta[qi]` overrides
        entry qi's batch-wide fields with the slot's own (the leader's
        request context is not a follower's). The trap's explain of the
        first query's top hit is a callable the flight recorder runs only
        inside an admitted dump."""
        if not querylog.enabled() or not texts:
            return
        batch_id = querylog.next_batch_id()
        mode = has_hot = None
        if self.layout == "sparse" and self.prune and not hot_only:
            has_hot, _, mode = self._skip_plan(q)
        level = "hot_only" if hot_only else "full"
        stage = {"analyze_ms": round(analyze_s * 1e3, 3),
                 "dispatch_ms": round(dispatch_s * 1e3, 3),
                 "total_ms": round(total_s * 1e3, 3)}
        for qi, text in enumerate(texts):
            ids = [int(t) for t in q[qi] if t >= 0]
            entry = {
                "query_hash": querylog.query_hash(ids),
                "n_terms": len(ids),
                "level": level,
                "degraded": bool(degraded),
                "forced_host": bool(force_host),
                "scoring": scoring,
                "rerank": rerank,
                "prox": bool(prox),
                "k": k,
                "batch_id": batch_id,
                "batch_size": len(texts),
                **stage,
                "top": [[key, round(float(s), 6)]
                        for key, s in results[qi][:10]],
            }
            if slot_meta is not None:
                entry.update(slot_meta[qi])
            if not querylog.redacted():
                entry["terms"] = [self.vocab.term(t) for t in ids]
            if mode is not None:
                entry["prune"] = {"dispatch_mode": mode,
                                  "has_hot": bool(has_hot[qi])}
            explain_fn = None
            top_dn = [int(dn) for dn in docnos[qi][:1] if dn > 0]
            if qi == 0 and top_dn and not degraded and not prox:
                # the trap's target: the batch's first query's top hit
                # (the latency is the batch's, so any member stands for it)
                def explain_fn(text=text, dn=top_dn):
                    from .explain import explain_hits

                    return explain_hits(self, text, dn, scoring=scoring,
                                        rerank=rerank, hot_only=hot_only)
            querylog.record(entry, explain_fn=explain_fn)

    def cosine_scores_at(self, texts: Sequence[str],
                         cand: np.ndarray) -> np.ndarray:
        """float32 [B, C] cosine rerank-stage scores at the global docids
        `cand` ([C] for every text, or [B, C]): the shard worker tier's
        stage-2 RPC (serving/shardset.py). The same accumulation the
        rerank runs at the same candidate width (search/explain.py::
        _cosine_scores_at), so each value is bitwise what a rerank in one
        process saw. On a doc-range scorer candidates outside the range
        score 0.0; the merge takes each candidate from its owning shard."""
        from .explain import _cosine_scores_at

        texts = list(texts)
        q = self.analyze_queries(texts)
        cand = np.asarray(cand, np.int32)
        if cand.ndim == 1:
            cand = np.repeat(cand[None, :], len(texts), axis=0)
        return _cosine_scores_at(self, q, cand)

    def explain(self, text: str, key, *, is_docid: bool = True,
                scoring: str = "tfidf", rerank: int | None = None,
                hot_only: bool = False) -> dict:
        """The exact per-term decomposition of one (query, doc) score:
        tf, df, idf, length norm and tier placement a term, the skip
        decision, and marginal per-slot contributions whose float64 sum
        is the kernel's score bit for bit; with `rerank`, of the cosine
        stage (search/explain.py)."""
        from .explain import explain_hits

        docno = self.mapping.get_docno(key) if is_docid else int(key)
        return explain_hits(self, text, [docno], scoring=scoring,
                            rerank=rerank, hot_only=hot_only)[0]

    # -- positions-backed retrieval (format v2) ----------------------------

    def _phrase_index(self):
        """The PhraseIndex over this index dir's position runs, made once
        (a racing thread may make a second one, which is dropped)."""
        pidx = self._phrase
        if pidx is None:
            if self._index_dir is None:
                raise ValueError("phrase/proximity queries need an index "
                                 "directory (Scorer built from arrays)")
            from .phrase import PhraseIndex

            pidx = PhraseIndex(self._index_dir, meta=self.meta)
            self._phrase = pidx
        return pidx

    def _query_term_sequence(self, text: str) -> list[str]:
        """The query's analyzed index-term sequence, k-grams composed:
        the coordinates the position runs are stored in."""
        return kgram_terms(self._analyzer().analyze(text), self.meta.k)

    def _search_phrase(self, text: str, *, k: int, scoring: str, slop: int,
                       return_docids: bool, rerank: int | None = None,
                       prox: bool = False) -> SearchResult:
        """One phrase query (`tpu_ir/search/scorer.py::_search_phrase`):
        every quoted span must match as an ordered window; the matching
        docs are ranked by the scoring model over all the query's terms,
        on the host. `rerank`/`prox` compose as on the plain path: BM25
        picks the top N matched docs, cosine TF-IDF rescores them, and
        the proximity boost goes over the top of that."""
        from .phrase import (
            PROX_ALPHA,
            PROX_DEPTH,
            cosine_score_host,
            score_docs_host,
            split_phrases,
        )

        # a stray or empty quote ('19" rack') is a plain query on any
        # index: only a real phrase needs the position runs
        _, phrases = split_phrases(text)
        analyzed = [toks for toks in (self._query_term_sequence(p)
                                      for p in phrases) if toks]
        if not analyzed:
            return self._search_batch_plain(
                [text.replace('"', ' ')], k=k, scoring=scoring,
                return_docids=return_docids, rerank=rerank, prox=prox)[0]
        t0 = time.perf_counter()
        pidx = self._phrase_index()
        matched: set[int] | None = None
        for toks in analyzed:
            docs = set(pidx.match_window(toks, slop=slop))
            matched = docs if matched is None else matched & docs
            if not matched:
                return self._querylog_phrase(text, SearchResult(), t0, k=k,
                                             scoring=scoring, rerank=rerank)
        all_terms = self._query_term_sequence(text.replace('"', ' '))
        if rerank:
            # stage 1: BM25 over the matched docs, the top `rerank` kept
            docnos, scores = score_docs_host(
                all_terms, sorted(matched), dictionary=pidx._dict,
                num_docs=self.meta.num_docs, doc_len=self._doc_len_host,
                scoring="bm25", term_lookup=pidx._term)
            keep = np.lexsort((docnos, -scores))[:rerank]
            # stage 2: cosine TF-IDF over the candidates
            docnos, scores = cosine_score_host(
                all_terms, docnos[keep], dictionary=pidx._dict,
                num_docs=self.meta.num_docs,
                doc_norms=self._doc_norms_host(), term_lookup=pidx._term)
            if prox and len(all_terms) > 1:
                # stage 3: the proximity boost over the top PROX_DEPTH
                scores = scores.astype(np.float64)
                for i in np.lexsort((docnos, -scores))[:PROX_DEPTH]:
                    if scores[i] > 0:
                        scores[i] *= 1.0 + PROX_ALPHA * pidx.proximity_bonus(
                            all_terms, int(docnos[i]))
        else:
            docnos, scores = score_docs_host(
                all_terms, sorted(matched), dictionary=pidx._dict,
                num_docs=self.meta.num_docs, doc_len=self._doc_len_host,
                scoring=scoring, compat_int_idf=self.compat_int_idf,
                term_lookup=pidx._term)
        res = SearchResult()
        for i in np.lexsort((docnos, -scores))[:k]:
            # zero-score docs are kept, unlike the plain path: each one
            # meets the phrase the user asked for, and a query whose terms
            # all have idf 0 must still return its matches (ranked after
            # the positive scores, docno ascending)
            dn = int(docnos[i])
            key = self.mapping.get_docid(dn) if return_docids else dn
            res.append((key, float(scores[i])))
        return self._querylog_phrase(text, res, t0, k=k, scoring=scoring,
                                     rerank=rerank)

    def _querylog_phrase(self, text, res, t0, *, k, scoring, rerank):
        """A phrase query's query-log entry, `tpu_ir`'s slim form: no
        stage split and no explain target (the phrase pipeline runs on
        the host, no kernel to decompose)."""
        if querylog.enabled():
            total_ms = round((time.perf_counter() - t0) * 1e3, 3)
            terms = self._query_term_sequence(text.replace('"', ' '))
            ids = [self.vocab.id_or(t) for t in terms]
            entry = {
                "query_hash": querylog.query_hash([i for i in ids
                                                   if i >= 0]),
                "n_terms": len(terms),
                "level": "full",
                "degraded": False,
                "phrase": True,
                "scoring": scoring,
                "rerank": rerank,
                "k": k,
                "batch_id": querylog.next_batch_id(),
                "batch_size": 1,
                "total_ms": total_ms,
                "top": [[key, round(float(s), 6)] for key, s in res[:10]],
            }
            if not querylog.redacted():
                entry["terms"] = terms
            querylog.record(entry)
        return res

    def _apply_proximity(self, texts, scores, docnos, k: int):
        """Stage 3 of the rerank: each candidate's score times (1 +
        PROX_ALPHA * bonus), bonus = the sum over adjacent query-term
        pairs of 1 / (1 + min_gap), in float64; then the lexsort order
        (score desc, docno asc), cast back to float32. Host work, bounded
        by the rerank's kk candidates (at most PROX_DEPTH past k)."""
        from .phrase import PROX_ALPHA

        pidx = self._phrase_index()
        b, kk = scores.shape
        out_s = np.zeros((b, k), np.float32)
        out_d = np.zeros((b, k), np.int32)
        for qi, text in enumerate(texts):
            terms = self._query_term_sequence(text)
            row_s = scores[qi].astype(np.float64).copy()
            for j in range(kk):
                dn = int(docnos[qi, j])
                if dn > 0 and row_s[j] > 0 and len(terms) > 1:
                    row_s[j] *= 1.0 + PROX_ALPHA * pidx.proximity_bonus(
                        terms, dn)
            order = np.lexsort((docnos[qi], -row_s))[:k]
            valid = row_s[order] > 0
            out_s[qi, : valid.sum()] = row_s[order][valid]
            out_d[qi, : valid.sum()] = docnos[qi][order][valid]
        return out_s, out_d

    # -- snippets (the document store) -------------------------------------

    def _docstore(self):
        store = self._store
        if store is None:
            if self._index_dir is None:
                raise ValueError("snippets need an index directory "
                                 "(Scorer built from arrays)")
            from ..index.docstore import DocStore

            store = DocStore(self._index_dir)
            self._store = store
        return store

    def snippet(self, query_text: str, key, *, is_docid: bool = True,
                width: int | None = None) -> str:
        """A highlighted text window of one result (search/snippets.py):
        matching goes token by token through the indexing analyzer, so a
        k-gram or quoted query highlights its component words."""
        from .snippets import SNIPPET_WORDS, make_snippet

        docno = self.mapping.get_docno(key) if is_docid else int(key)
        analyzer = self._analyzer()
        toks = set(analyzer.analyze(query_text.replace('"', ' ')))
        return make_snippet(self._docstore().get(docno), toks, analyzer,
                            width=width or SNIPPET_WORDS)


# the labels of the dense layout's three postings columns' uploads
_PAIR_LABELS = ("pair_term", "pair_doc", "pair_tf")


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


def _assemble_csr(index_dir: str, meta: fmt.IndexMetadata,
                  doc_range: tuple | None = None):
    """Part files -> (df, pair_doc, pair_tf) in global CSR order, each
    part verified by the streamed read that loads it. A part holds
    contiguous per-term runs, so each run goes to the global indptr
    slice of its term id; no sort is needed. `doc_range=(lo, hi)`
    (1-based inclusive) goes to a compressed part's decode as the
    half-open [lo, hi + 1); a raw part ignores it."""
    from concurrent.futures import ThreadPoolExecutor

    dr = (None if doc_range is None
          else (int(doc_range[0]), int(doc_range[1]) + 1))
    n_threads = max(1, min(8, os.cpu_count() or 1, meta.num_shards))
    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        shards = list(ex.map(
            lambda s: fmt.load_shard_verified(index_dir, s, meta,
                                              doc_range=dr),
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
