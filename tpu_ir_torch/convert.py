"""Carry an index's state across from the JAX package.

`scorer_from_numpy` takes the state a `tpu_ir.search.Scorer` holds, as
numpy arrays and plain values, and builds the port's Scorer from it, so
the two packages can score identical state; `tiered_scorer_from_numpy`
does the same for the tiered sparse layout, from the fields of a
`tpu_ir.search.layout.TieredPostings`. A compressed index's state (its
metadata with format_version 3, its postings decoded to numpy) builds the
same bf16 layouts that `Scorer.load` builds from the compressed dir.
Nothing here imports the JAX package: the caller hands the arrays over.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .collection import DocnoMapping, Vocab
from .index.format import IndexMetadata
from .search.layout import TieredPostings
from .search.scorer import Scorer


def scorer_from_numpy(vocab_terms: Sequence[str], docids: Sequence[str],
                      df: np.ndarray, doc_len: np.ndarray,
                      pair_term: np.ndarray, pair_doc: np.ndarray,
                      pair_tf: np.ndarray, meta_dict: dict, *,
                      device: str | torch.device | None = None) -> Scorer:
    """A dense-layout Scorer on `device` from host state: the sorted
    vocabulary and docids, df [V], doc_len [D+1], the postings columns in
    global CSR order, and the index metadata as a dict (format_version 3
    selects the bf16 raw-tf matrix of a compressed index)."""
    return Scorer(vocab=Vocab(list(vocab_terms)),
                  mapping=DocnoMapping(list(docids)),
                  pair_term=np.asarray(pair_term, np.int32),
                  pair_doc=np.asarray(pair_doc, np.int32),
                  pair_tf=np.asarray(pair_tf, np.int32),
                  df=np.asarray(df, np.int32),
                  doc_len=np.asarray(doc_len, np.int32),
                  meta=IndexMetadata(**meta_dict), device=device)


def tiered_scorer_from_numpy(vocab_terms: Sequence[str],
                             docids: Sequence[str], df: np.ndarray,
                             doc_len: np.ndarray, tiers: Mapping,
                             meta_dict: dict, *,
                             compat_int_idf: bool = False,
                             device: str | torch.device | None = None
                             ) -> Scorer:
    """A tiered-layout Scorer on `device` from host state: the sorted
    vocabulary and docids, df [V], doc_len [D+1], the layout's fields as
    a mapping (a JAX `TieredPostings._asdict()`, block-max bounds
    included) and the index metadata as a dict (format_version 3 selects
    the bf16 hot strip of a compressed index). No postings columns come
    with a prebuilt layout, so its rerank raises."""
    layout = TieredPostings(**{f: tiers[f] for f in TieredPostings._fields
                               if f in tiers})
    return Scorer(vocab=Vocab(list(vocab_terms)),
                  mapping=DocnoMapping(list(docids)),
                  pair_term=None, pair_doc=None, pair_tf=None,
                  df=np.asarray(df, np.int32),
                  doc_len=np.asarray(doc_len, np.int32),
                  meta=IndexMetadata(**meta_dict), layout="sparse",
                  compat_int_idf=compat_int_idf, device=device,
                  tiers=layout)
