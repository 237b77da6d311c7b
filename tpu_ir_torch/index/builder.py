"""The indexer: TREC corpus -> term-sharded inverted index + dictionary.

Follows `tpu_ir/index/builder.py::_build_index`: analysis on the host
(the pure-Python analyzer), vocabulary and term ids by one `np.unique`,
docno mapping, the postings group-by on the device
(ops/postings.py::build_postings_packed), then the part files, the
dictionary and the metadata with its checksums. The artifacts are
byte-identical to the JAX package's for the same corpus and shard count,
the block-max bounds artifact and `metadata.json` included.

Only the one-shot k = 1 build is ported: char-gram indexes, positions,
k > 1, the SPMD mesh build and the streaming build raise ValueError.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..analysis import Analyzer
from ..collection import DocnoMapping, Vocab, read_trec_corpus
from ..ops.postings import PAD_TERM_U16, build_postings_packed
from . import format as fmt

_LATER = "is not supported by tpu_ir_torch yet (a later slice of the port)"


def analyze_corpus(corpus_paths: Sequence[str]
                    ) -> tuple[list[str], list[list[str]]]:
    """Stream and analyze every document: (docids, per-doc token lists)."""
    analyzer = Analyzer()
    docids: list[str] = []
    doc_tokens: list[list[str]] = []
    for doc in read_trec_corpus(corpus_paths):
        docids.append(doc.docid)
        doc_tokens.append(analyzer.analyze(doc.content))
    return docids, doc_tokens


def build_index(
    corpus_paths: Sequence[str] | str,
    index_dir: str,
    *,
    num_shards: int = 10,
    k: int = 1,
    compute_chargrams: bool = False,
    positions: bool = False,
    spmd_devices: int | None = None,
    streaming: bool = False,
    overwrite: bool = False,
    device: str | torch.device | None = None,
) -> fmt.IndexMetadata:
    """Build the index artifacts of a TREC corpus into `index_dir`.

    An existing index (its metadata.json) is returned as it is unless
    `overwrite=True`. The postings group-by runs on `device` (CUDA by
    default; pass device="cpu" to build on the CPU)."""
    if k != 1:
        raise ValueError(f"k={k} term-k-gram indexes {_LATER}")
    if compute_chargrams:
        raise ValueError(f"char-gram indexes {_LATER}; pass "
                         "compute_chargrams=False")
    if positions:
        raise ValueError(f"position runs (format v2 positions) {_LATER}")
    if spmd_devices:
        raise ValueError(f"the SPMD mesh build {_LATER}")
    if streaming:
        raise ValueError(f"the streaming build {_LATER}")
    dev = resolve_device(device)
    if isinstance(corpus_paths, (str, os.PathLike)):
        corpus_paths = [corpus_paths]
    os.makedirs(index_dir, exist_ok=True)
    if overwrite:
        for name in os.listdir(index_dir):
            p = os.path.join(index_dir, name)
            if os.path.isfile(p):
                os.unlink(p)
    if os.path.exists(os.path.join(index_dir, fmt.METADATA)):
        return fmt.IndexMetadata.load(index_dir)

    # --- tokenize + vocab + term-id assignment (host) ---
    docids, doc_tokens = analyze_corpus(corpus_paths)
    num_docs = len(docids)
    if num_docs == 0:
        raise ValueError(f"no <DOC> records found in {corpus_paths}")
    lengths = np.fromiter((len(t) for t in doc_tokens), np.int64, num_docs)
    flat_terms = np.array([t for toks in doc_tokens for t in toks],
                          dtype=np.str_)
    # one C-speed sort gives both the sorted vocab and the term ids
    uniques, inverse = np.unique(flat_terms, return_inverse=True)
    vocab = Vocab(uniques.tolist())
    vocab.save(os.path.join(index_dir, fmt.VOCAB))
    v = len(vocab)

    # --- docno mapping (NumberTrecDocuments equivalent) ---
    mapping = DocnoMapping.build(docids)
    if len(mapping) != num_docs:
        raise ValueError("duplicate docids in corpus")
    mapping.save(os.path.join(index_dir, fmt.DOCNOS))
    sorted_docids = np.array(mapping.docids, dtype=np.str_)
    docnos = (np.searchsorted(sorted_docids, np.array(docids, dtype=np.str_))
              + 1).astype(np.int32)

    # --- postings group-by on the device ---
    # term ids ride as uint16 when the vocab fits below the pad value
    use16 = v < PAD_TERM_U16
    term_ids = inverse.reshape(-1).astype(np.uint16 if use16 else np.int32)
    p = build_postings_packed(
        torch.from_numpy(term_ids).to(dev),
        torch.from_numpy(docnos).to(dev),
        torch.from_numpy(lengths.astype(np.int32)).to(dev),
        vocab_size=v, num_docs=num_docs)
    num_pairs = int(p.num_pairs)
    df = p.df.cpu().numpy()
    doc_len = p.doc_len.cpu().numpy()
    pair_doc = p.pair_doc[:num_pairs].cpu().numpy()
    pair_tf = p.pair_tf[:num_pairs].cpu().numpy()

    # --- shard + persist (part-NNNNN layout), dictionary, metadata ---
    np.save(os.path.join(index_dir, fmt.DOCLEN), doc_len)
    shard_of, offset_of = fmt.write_pair_shards(index_dir, df, pair_doc,
                                                pair_tf, num_shards)
    fmt.write_dictionary(index_dir, vocab.terms, shard_of, offset_of)
    meta = fmt.IndexMetadata(
        num_docs=num_docs, vocab_size=v, k=1, num_shards=num_shards,
        num_pairs=num_pairs, chargram_ks=[],
        version=fmt.FORMAT_VERSION, has_positions=False,
        format_version=fmt.ARENA_FORMAT_VERSION)
    meta.save_with_checksums(index_dir)
    return meta

