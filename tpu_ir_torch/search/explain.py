"""Exact per-term score decomposition: why a document ranked where it did
(the port's copy of `tpu_ir/search/explain.py`).

The numbers are the kernels' own floats, not a re-derivation that could
drift from them:

- Every score comes from a `*_scores_at_*` twin of the production top-k
  (ops/scoring.py) that calls the same score function, through the same
  hand-written kernels on the card (dense_score or dequant_score for
  dense TF-IDF, cold_tier then hot_stage on the tiered layout; dense BM25
  and the dense cosine are plain torch, as they are plain XLA in the JAX
  package), and gathers the requested docnos instead of selecting the top
  k. The gathered score of a returned hit is bitwise the score the top-k
  ranked it by.

- Per-term contributions are marginal deltas in accumulation order: the
  query's L slots become an (L+1)-row prefix batch (row j holds the first
  j term ids, the rest -1), scored in one dispatch; slot l's contribution
  is float64(S_l) - float64(S_{l-1}). A -1 slot adds exactly +0 in every
  kernel and a row's sums do not depend on the batch it rides in, so S_L
  is the production score and the float64 telescope sums back to it
  exactly.

Metadata (tf, df, idf, length norm, tier placement, the MaxScore skip
decision, the rerank's stages) comes from the host arrays. The sharded
layout is a later slice of the port; a sharded Scorer cannot be loaded.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs import trace as obs_trace
from ..ops.scoring import bm25_idf_weights, idf_weights

# the BM25 constants every scoring path shares (search/phrase.py too)
K1 = 0.9
B = 0.4


def _idf_host(scorer, scoring: str) -> np.ndarray:
    """Host copy of the idf vector the kernels use, computed by the same
    ops functions on the scorer's device and cached per model."""
    key = (scoring, scorer.compat_int_idf)
    cache = getattr(scorer, "_explain_idf_cache", None)
    if cache is None:
        cache = scorer._explain_idf_cache = {}
    if key not in cache:
        n = scorer.meta.num_docs
        w = (bm25_idf_weights(scorer.df, n) if scoring == "bm25"
             else idf_weights(scorer.df, n, scorer.compat_int_idf))
        cache[key] = w.cpu().numpy()
    return cache[key]


def _csr_for_tf(scorer):
    """(indptr, pair_doc, pair_tf) for host tf lookups, or None when the
    Scorer has no postings columns. The indptr is cached on the scorer."""
    try:
        df, pd, ptf = scorer._host_postings()
    except ValueError:
        return None
    indptr = getattr(scorer, "_explain_indptr_cache", None)
    if indptr is None:
        indptr = np.concatenate([[0], np.cumsum(df, dtype=np.int64)])
        scorer._explain_indptr_cache = indptr
    return indptr, pd, ptf


def _tf_in_doc(csr, tid: int, docno: int) -> int | None:
    """Raw tf of term `tid` in `docno` from the host CSR columns."""
    if csr is None:
        return None
    indptr, pd, ptf = csr
    run = pd[int(indptr[tid]): int(indptr[tid + 1])]
    hits = np.nonzero(run == docno)[0]
    if not len(hits):
        return 0
    return int(ptf[int(indptr[tid]) + int(hits[0])])


def _placement(scorer, tid: int) -> dict:
    """Where the term's postings live in the serving layout: the dense
    matrix, the hot strip, or which cold tier."""
    if scorer.layout == "dense":
        return {"placement": "dense"}
    if scorer._hot_rank_host[tid] >= 0:
        return {"placement": "hot"}
    tof = getattr(scorer, "_explain_tier_of", None)
    if tof is None:
        tof = scorer._explain_tier_of = scorer.tier_of.cpu().numpy()
    if tof[tid] >= 0:
        return {"placement": f"tier:{int(tof[tid])}"}
    return {"placement": "absent"}


def _scores_at(scorer, q: np.ndarray, docs: np.ndarray, *, scoring: str,
               skip_hot: bool = False, hot_only: bool = False
               ) -> np.ndarray:
    """[B, C] float32 production-kernel scores at docnos `docs`, through
    the top-k's twins with the arguments `Scorer._topk_device_raw` passes
    (the cached weighted strip included)."""
    from ..ops.scoring import (
        bm25_scores_at_dense,
        bm25_scores_at_tiered,
        tfidf_scores_at_dense,
        tfidf_scores_at_dense_quantized,
        tfidf_scores_at_tiered,
    )

    dev = scorer.device
    qd = torch.from_numpy(np.ascontiguousarray(q, np.int32)).to(dev)
    cand = torch.from_numpy(np.ascontiguousarray(docs, np.int32)).to(dev)
    n = scorer.meta.num_docs
    if scorer.layout == "dense":
        if scoring == "bm25":
            out = bm25_scores_at_dense(qd, scorer._ensure_tf_matrix(),
                                       scorer.df, scorer.doc_len, n, cand,
                                       k1=K1, b=B)
        elif scorer.doc_matrix is None:              # bf16 raw-tf matrix
            out = tfidf_scores_at_dense_quantized(
                qd, scorer._tf_matrix, scorer.df, n, cand,
                compat_int_idf=scorer.compat_int_idf)
        else:
            out = tfidf_scores_at_dense(
                qd, scorer.doc_matrix, scorer.df, n, cand,
                compat_int_idf=scorer.compat_int_idf)
        return out.cpu().numpy()
    ws = None if skip_hot else scorer._hot_wstrip(scoring)
    strip = scorer.hot_tfs if ws is None else ws
    if scoring == "bm25":
        out = bm25_scores_at_tiered(
            qd, scorer.hot_rank, strip, scorer.tier_of, scorer.row_of,
            scorer.cold_tiers, scorer.df, scorer.doc_len, n, cand, k1=K1,
            b=B, hot_preweighted=ws is not None, skip_hot=skip_hot,
            hot_only=hot_only)
    else:
        out = tfidf_scores_at_tiered(
            qd, scorer.hot_rank, strip, scorer.tier_of, scorer.row_of,
            scorer.cold_tiers, scorer.df, n, cand,
            compat_int_idf=scorer.compat_int_idf,
            hot_preweighted=ws is not None, skip_hot=skip_hot,
            hot_only=hot_only)
    return out.cpu().numpy()


def _cosine_scores_at(scorer, q: np.ndarray, cand: np.ndarray
                      ) -> np.ndarray:
    """[B, C] rerank stage-2 cosine scores in candidate order, through
    the rerank's twins with `Scorer._rerank_primary`'s arguments."""
    from ..ops.scoring import cosine_scores_at_dense, cosine_scores_at_tiered

    dev = scorer.device
    qd = torch.from_numpy(np.ascontiguousarray(q, np.int32)).to(dev)
    cd = torch.from_numpy(np.ascontiguousarray(cand, np.int32)).to(dev)
    n = scorer.meta.num_docs
    norms = scorer._doc_norms()
    if scorer.layout == "dense":
        matrix = (scorer.doc_matrix if scorer.doc_matrix is not None
                  else scorer._tf_matrix)
        out = cosine_scores_at_dense(qd, matrix, scorer.df, norms, cd, n)
    else:
        ws = scorer._hot_wstrip("tfidf")
        out = cosine_scores_at_tiered(
            qd, scorer.hot_rank, scorer.hot_tfs if ws is None else ws,
            scorer.tier_of, scorer.row_of, scorer.cold_tiers, scorer.df,
            norms, n, cd, hot_preweighted=ws is not None)
    return out.cpu().numpy()


def _prefix_batch(ids: list[int], width: int) -> np.ndarray:
    """The (L+1)-row prefix query batch (row j = the first j ids, the rest
    -1), its row count padded to a power of two as in the JAX package."""
    rows = len(ids) + 1
    cap = 1 << max(rows - 1, 0).bit_length()
    qp = np.full((cap, width), -1, np.int32)
    for j in range(1, rows):
        qp[j, :j] = ids[:j]
    return qp


def _telescope(prefix_scores: np.ndarray) -> list[float]:
    """Marginal per-slot contributions: float64 deltas of consecutive
    prefix scores, whose sum collapses exactly to the last minus the
    first."""
    s = prefix_scores.astype(np.float64)
    return [float(s[j] - s[j - 1]) for j in range(1, len(s))]


def explain_hits(scorer, text: str, docnos, *, scoring: str = "tfidf",
                 rerank: int | None = None, hot_only: bool = False,
                 ) -> list[dict]:
    """Explain dicts for `docnos` (ints) under one query: one prefix-batch
    dispatch for all the docs (plus the stage-1 candidate generation and
    one cosine dispatch when `rerank` is set).

    Each dict decomposes the score the production pipeline reports for
    that (query, doc): per-slot marginal contributions under the final
    ranking model (BM25 or TF-IDF for a plain top-k, the cosine stage for
    a rerank), with tf, df, idf, length norm and tier placement per term
    and the query's MaxScore skip decision."""
    docnos = [int(d) for d in docnos]
    with obs_trace("explain", docs=len(docnos), scoring=scoring,
                   rerank=rerank or 0):
        return _explain_hits(scorer, text, docnos, scoring=scoring,
                             rerank=rerank, hot_only=hot_only)


def _explain_hits(scorer, text, docnos, *, scoring, rerank, hot_only):
    q = scorer.analyze_queries([text])
    ids = [int(t) for t in q[0] if t >= 0]
    width = q.shape[1]
    n_docs = scorer.meta.num_docs

    # the decision the production schedule (Scorer._skip_plan) makes for
    # this query: a hot-free query on the tiered layout skips the hot
    # stage
    skip_hot = False
    dispatch = {"layout": scorer.layout, "hot_only": bool(hot_only),
                "skip_hot": False, "prune_scheduling": False}
    if scorer.layout == "sparse" and scorer.prune and not hot_only:
        has_hot = bool(scorer._has_hot(q)[0]) if ids else False
        skip_hot = not has_hot
        dispatch.update({"prune_scheduling": True, "has_hot_terms": has_hot,
                         "skip_hot": skip_hot})

    qp = _prefix_batch(ids, width)
    docs_ok = [d for d in docnos if 1 <= d <= n_docs]
    cand = np.tile(np.asarray(docs_ok, np.int32)[None, :] if docs_ok
                   else np.zeros((1, 1), np.int32), (len(qp), 1))

    stage1 = None
    if docs_ok:
        if rerank:
            # stage 1 regenerates the BM25 candidates as _rerank_primary
            # does; stage 2 reads the cosine scores out of a candidate
            # matrix of the same shape
            _, cand_d = scorer._topk_device(q, rerank, "bm25")
            cand_row = cand_d[:1].cpu().numpy()               # [1, C]
            cand_full = np.tile(cand_row, (len(qp), 1))
            prefix = _cosine_scores_at(scorer, qp, cand_full)  # [B*, C]
            stage1 = _scores_at(scorer, q, np.asarray([docs_ok], np.int32),
                                scoring="bm25")[0]
            # each explained doc's column in the candidate set
            col_of = {int(d): j for j, d in
                      reversed(list(enumerate(cand_row[0])))}
        else:
            prefix = _scores_at(scorer, qp, cand, scoring=scoring,
                                skip_hot=skip_hot, hot_only=hot_only)
    idf = _idf_host(scorer, "tfidf" if rerank else scoring)
    csr = _csr_for_tf(scorer)
    df_host = scorer._df_host
    doc_len = scorer._doc_len_host
    avg_dl = float(doc_len.astype(np.float64).sum()) / max(n_docs, 1)
    norms = scorer._doc_norms_host() if rerank else None

    out = []
    for d in docnos:
        entry = {
            "query": text,
            "docno": d,
            "docid": None,
            "scoring": "cosine_rerank" if rerank else scoring,
            "layout": scorer.layout,
            "dispatch": dispatch,
            "score": 0.0,
            "contribution_sum": 0.0,
            "terms": [],
        }
        if 1 <= d <= n_docs:
            entry["docid"] = scorer.mapping.get_docid(d)
        else:
            entry["error"] = f"docno {d} out of range 1..{n_docs}"
            out.append(entry)
            continue
        entry["doc_len"] = int(doc_len[d])
        if scoring == "bm25" and not rerank:
            entry["avg_doc_len"] = round(avg_dl, 4)
            entry["dl_norm"] = float(
                1.0 - B + B * float(doc_len[d]) / max(avg_dl, 1e-9))
            entry["k1"], entry["b"] = K1, B
        if rerank:
            j = col_of.get(d)
            if j is None:
                # not in the stage-1 candidates (an arbitrary doc, not a
                # returned hit): its cosine score through a 1-candidate
                # gather, the right value but not the rerank's shape
                solo = np.tile(np.asarray([[d]], np.int32), (len(qp), 1))
                col = _cosine_scores_at(scorer, qp, solo)[:, 0]
                entry["rerank"] = {"in_candidates": False,
                                   "candidates": rerank}
            else:
                col = prefix[:, j]
                entry["rerank"] = {
                    "in_candidates": True,
                    "candidates": rerank,
                    "stage1_score": float(stage1[docs_ok.index(d)]),
                }
            entry["doc_norm"] = float(norms[d])
        else:
            col = prefix[:, docs_ok.index(d)]
        col = col[: len(ids) + 1]
        contribs = _telescope(col)
        entry["score"] = float(col[len(ids)])
        entry["contribution_sum"] = float(np.sum(
            np.asarray(contribs, np.float64)))
        if rerank and entry["rerank"].get("stage1_score") is not None:
            entry["rerank"]["delta"] = float(
                np.float64(entry["score"])
                - np.float64(entry["rerank"]["stage1_score"]))
        for slot, tid in enumerate(ids):
            t = {
                "slot": slot,
                "term": scorer.vocab.term(tid),
                "term_id": tid,
                "df": int(df_host[tid]),
                "idf": float(idf[tid]),
                "tf": _tf_in_doc(csr, tid, d),
                "contribution": contribs[slot],
            }
            t.update(_placement(scorer, tid))
            entry["terms"].append(t)
        out.append(entry)
    return out
