"""Inverted-index construction on the device: a sort-based group-by in torch.

The counterpart of `tpu_ir/ops/postings.py`. The mapper's per-occurrence
emission is a flat (term_id, docno) pair array; the shuffle's sort and
group become stable sorts plus run-length segmentation; the reducer's
per-term merge (sum tf per doc, df = number of docs, postings re-sorted
by tf desc) becomes segment sums and a second set of stable sorts.

`jnp.lexsort` becomes successive `torch.sort(stable=True)` passes, least
significant key first. This is an integer pipeline, so the result equals
the JAX package's element for element. Padding semantics are the same:
inputs may be padded with PAD_TERM, outputs have the input's length and
a `num_pairs` valid prefix. The three entry points are profiled under the
JAX package's names (obs/profiling.py); their work follows the data, so
no cost is counted.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..obs.profiling import profiled

# Padding sentinel: sorts after every real term id.
PAD_TERM = int(np.iinfo(np.int32).max)
# uint16 term-id padding sentinel for the slim term column (vocab < 65535)
PAD_TERM_U16 = 0xFFFF


class Postings(NamedTuple):
    """Postings in compacted sorted order.

    pair_term/pair_doc/pair_tf: int32 [C]; the first `num_pairs` entries
    are valid, sorted by (term asc, tf desc, doc asc). indptr: int32 [V+1]
    CSR offsets per term id. df: int32 [V]. doc_len: int32 [D+1] total
    term occurrences per docno (slot 0 unused). num_pairs: int32 scalar.
    """

    pair_term: torch.Tensor
    pair_doc: torch.Tensor
    pair_tf: torch.Tensor
    indptr: torch.Tensor
    df: torch.Tensor
    doc_len: torch.Tensor
    num_pairs: torch.Tensor


def _lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Indices sorting by keys[-1], then keys[-2], ... (np.lexsort's
    convention): one stable sort per key, least significant first."""
    order = torch.argsort(keys[0], stable=True)
    for key in keys[1:]:
        order = order[torch.argsort(key[order], stable=True)]
    return order


def _shift_right(x: torch.Tensor, fill: int) -> torch.Tensor:
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device),
                      x[:-1]])


@profiled()
def reduce_weighted_postings(term: torch.Tensor, doc: torch.Tensor,
                             tf: torch.Tensor, *, vocab_size: int):
    """Merge (term, doc, tf) triples: sum tf over duplicate (term, doc)
    keys, order postings (term asc, tf desc, doc asc), df per term.
    Padding: term == PAD_TERM.

    Returns (pair_term, pair_doc, pair_tf, df, num_pairs)."""
    term = term.to(torch.int32)
    doc = doc.to(torch.int32)
    tf = tf.to(torch.int32)
    dev = term.device
    c = term.shape[0]
    valid = term != PAD_TERM
    doc = torch.where(valid, doc, 0)
    tf = torch.where(valid, tf, 0)

    order = _lexsort([doc, term])
    t_s, d_s, w_s, v_s = term[order], doc[order], tf[order], valid[order]

    new = ((t_s != _shift_right(t_s, -1)) | (d_s != _shift_right(d_s, -1))) \
        & v_s
    idx = torch.cumsum(new.to(torch.int64), 0) - 1
    num_pairs = (idx[-1] + 1).to(torch.int32) if c \
        else torch.zeros((), dtype=torch.int32, device=dev)

    p_term = torch.full((c,), PAD_TERM, dtype=torch.int32, device=dev)
    p_doc = torch.zeros((c,), dtype=torch.int32, device=dev)
    p_tf = torch.zeros((c,), dtype=torch.int32, device=dev)
    p_term[idx[new]] = t_s[new]
    p_doc[idx[new]] = d_s[new]
    p_tf.index_add_(0, idx[v_s], w_s[v_s])

    df = torch.zeros((vocab_size,), dtype=torch.int32, device=dev)
    df.index_add_(0, t_s[new].to(torch.int64),
                  torch.ones_like(t_s[new]))

    order2 = _lexsort([p_doc, -p_tf, p_term])
    return (p_term[order2], p_doc[order2], p_tf[order2], df, num_pairs)


@profiled()
def build_postings(term_ids: torch.Tensor, doc_ids: torch.Tensor, *,
                   vocab_size: int, num_docs: int) -> Postings:
    """Group (term, doc) occurrence pairs into tf postings on the device.

    term_ids: int32 [T] with PAD_TERM padding; doc_ids: int32 [T] 1-based
    docnos (padding value irrelevant)."""
    term_ids = term_ids.to(torch.int32)
    doc_ids = doc_ids.to(torch.int32)
    dev = term_ids.device
    valid = term_ids != PAD_TERM
    doc_ids = torch.where(valid, doc_ids, 0)

    # an occurrence is a (term, doc, tf=1) triple
    pair_term, pair_doc, pair_tf, df, num_pairs = reduce_weighted_postings(
        term_ids, doc_ids, torch.ones_like(term_ids), vocab_size=vocab_size)

    # doc lengths (total occurrences per doc) for BM25; out-of-range
    # docnos are dropped, as the JAX scatter's mode="drop" does
    keep = valid & (doc_ids >= 0) & (doc_ids <= num_docs)
    doc_len = torch.zeros((num_docs + 1,), dtype=torch.int32, device=dev)
    doc_len.index_add_(0, doc_ids[keep].to(torch.int64),
                       torch.ones_like(doc_ids[keep]))

    indptr = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                        torch.cumsum(df, 0).to(torch.int32)])
    return Postings(pair_term, pair_doc, pair_tf, indptr, df, doc_len,
                    num_pairs)


@profiled()
def build_postings_packed(term_ids: torch.Tensor, docnos: torch.Tensor,
                          lengths: torch.Tensor, *, vocab_size: int,
                          num_docs: int) -> Postings:
    """Slim front end for build_postings: the occurrence-sized doc column
    is rebuilt on the device from the per-document (docno, length) arrays,
    and term ids may ride as uint16 (pad 0xFFFF) when the vocab fits.

    term_ids: uint16 or int32 (pad PAD_TERM) [C]; docnos, lengths: int32
    [D] in emission order. Slots past sum(lengths) must carry the pad."""
    cap = term_ids.shape[0]
    if term_ids.dtype == torch.uint16:
        # widen through int16's bits: uint16 arithmetic is not
        # implemented for every device
        t32 = term_ids.view(torch.int16).to(torch.int32) & 0xFFFF
        t32 = torch.where(t32 == PAD_TERM_U16, PAD_TERM, t32)
    else:
        t32 = term_ids.to(torch.int32)
    doc = torch.repeat_interleave(docnos.to(torch.int32),
                                  lengths.to(torch.int64))[:cap]
    if doc.shape[0] < cap:
        # the tail slots carry PAD_TERM, so their doc is never read
        doc = torch.cat([doc, torch.zeros(cap - doc.shape[0],
                                          dtype=torch.int32,
                                          device=doc.device)])
    return build_postings(t32, doc, vocab_size=vocab_size, num_docs=num_docs)


def pair_term_from_df(df: np.ndarray) -> np.ndarray:
    """The valid-prefix pair_term column on the host, from df alone: the
    valid pairs are term-major, so pair i's term is the df run it is in."""
    return np.repeat(np.arange(len(df), dtype=np.int32), df)
