"""Carry an index's state across from the JAX package.

`scorer_from_numpy` takes the state a `tpu_ir.search.Scorer` holds, as
numpy arrays and plain values, and builds the port's Scorer from it, so
the two packages can score identical state. Nothing here imports the JAX
package: the caller hands the arrays over.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .collection import DocnoMapping, Vocab
from .index.format import IndexMetadata
from .search.scorer import Scorer


def scorer_from_numpy(vocab_terms: Sequence[str], docids: Sequence[str],
                      df: np.ndarray, doc_len: np.ndarray,
                      pair_term: np.ndarray, pair_doc: np.ndarray,
                      pair_tf: np.ndarray, meta_dict: dict, *,
                      device: str | torch.device | None = None) -> Scorer:
    """A dense-layout Scorer on `device` from host state: the sorted
    vocabulary and docids, df [V], doc_len [D+1], the postings columns in
    global CSR order, and the index metadata as a dict."""
    return Scorer(vocab=Vocab(list(vocab_terms)),
                  mapping=DocnoMapping(list(docids)),
                  pair_term=np.asarray(pair_term, np.int32),
                  pair_doc=np.asarray(pair_doc, np.int32),
                  pair_tf=np.asarray(pair_tf, np.int32),
                  df=np.asarray(df, np.int32),
                  doc_len=np.asarray(doc_len, np.int32),
                  meta=IndexMetadata(**meta_dict), device=device)
