"""The indexer: TREC corpus -> term-sharded inverted index, char-gram
indexes and dictionary.

Follows `tpu_ir/index/builder.py::_build_index`: the whole corpus pass
(record split, analysis, first-seen vocabulary) in the native C++
tokenizer (analysis/native.py), term ids remapped to the sorted
vocabulary by one argsort, the docno mapping, the postings group-by on
the device (ops/postings.py::build_postings_packed), the char-gram
indexes of k = 2, 3 (ops/chargram.py, on the same device), then the part
files, the dictionary and the metadata with its checksums. The artifacts
are byte-identical to the JAX package's for the same corpus and settings,
its defaults included (char-grams on), the block-max bounds artifact,
`metadata.json` and, under TPU_IR_COMPRESS=1, the v3 parts too.

A k > 1 term-k-gram index is analyzed document by document (the
JAX package's path for k > 1, where the native corpus pass does not
apply): each document's tokens become k-token windows, and one np.unique
builds the vocabulary and the term ids. Its char-gram indexes cover the
token vocabulary, which goes to the `tokens.txt` sidecar, so wildcard and
fuzzy queries expand over tokens and compose k-gram terms.

The streaming build for corpora larger than memory is
index/streaming.py. Positions and the SPMD mesh build raise ValueError
(later slices of the port).
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np
import torch

from .. import faults, resolve_device
from ..analysis import Analyzer
from ..collection import DocnoMapping, Vocab, kgram_terms, read_trec_corpus
from ..ops.postings import PAD_TERM_U16, build_postings_packed
from ..utils.report import JobReport
from ..utils.transfer import fetch_narrow, narrow_uint, shrink_pairs
from . import format as fmt

_LATER = "is not supported by tpu_ir_torch yet (a later slice of the port)"

TOKENS_VOCAB = "tokens.txt"  # the token vocabulary of a k > 1 index


def check_build_args(k: int, positions: bool, spmd_devices) -> None:
    """Raise ValueError for the build options a later slice ports, and
    for a k below 1."""
    if k < 1:
        raise ValueError(f"k={k}: a term-k-gram index needs k >= 1")
    if positions:
        raise ValueError(f"position runs (format v2 positions) {_LATER}")
    if spmd_devices:
        raise ValueError(f"the SPMD mesh build {_LATER}")


def analyze_corpus(corpus_paths: Sequence[str], analyzer=None
                   ) -> tuple[list[str], list[list[str]]]:
    """Every document through `analyzer` (the pure-Python Analyzer by
    default): (docids, per-doc token lists). A k > 1 build calls it with
    the native analyzer; with the Python one it is the twin of the native
    corpus pass, kept to time and test that pass against."""
    analyzer = analyzer or Analyzer()
    docids: list[str] = []
    doc_tokens: list[list[str]] = []
    for doc in read_trec_corpus(corpus_paths):
        docids.append(doc.docid)
        doc_tokens.append(analyzer.analyze(doc.content))
    return docids, doc_tokens


def clear_index_dir(index_dir: str) -> None:
    """Delete every file of `index_dir` but the job reports."""
    for name in os.listdir(index_dir):
        if name != fmt.JOBS_DIR:
            p = os.path.join(index_dir, name)
            if os.path.isfile(p):
                os.unlink(p)


def build_index(
    corpus_paths: Sequence[str] | str,
    index_dir: str,
    *,
    k: int = 1,
    chargram_ks: Iterable[int] = (2, 3),
    num_shards: int = 10,
    overwrite: bool = False,
    compute_chargrams: bool = True,
    spmd_devices: int | None = None,
    positions: bool = False,
    device: str | torch.device | None = None,
) -> fmt.IndexMetadata:
    """Build the index artifacts of a TREC corpus into `index_dir`, with
    the JAX package's defaults (char-gram indexes of k = 2, 3).

    An existing index (its metadata.json) is returned as it is unless
    `overwrite=True`. The postings group-by and the char-gram builds run
    on `device` (CUDA by default; pass device="cpu" to build on the
    CPU)."""
    check_build_args(k, positions, spmd_devices)
    dev = resolve_device(device)
    if isinstance(corpus_paths, (str, os.PathLike)):
        corpus_paths = [corpus_paths]
    chargram_ks = list(chargram_ks)
    os.makedirs(index_dir, exist_ok=True)
    if overwrite:
        clear_index_dir(index_dir)
    if fmt.artifact_exists(index_dir, fmt.METADATA):
        return fmt.IndexMetadata.load(index_dir)
    report = JobReport("TermKGramDocIndexer", config={
        "k": k, "num_shards": num_shards, "chargram_ks": chargram_ks})

    doc_tokens: list[list[str]] = []
    if k == 1:
        # the corpus pass in C++, temp ids remapped to sorted ids
        with report.phase("tokenize"):
            from ..analysis.native import tokenize_corpus_native

            docids, temp_ids, lengths, vocab_list = tokenize_corpus_native(
                corpus_paths)
        _require_docs(docids, corpus_paths)
        with report.phase("vocab"):
            vocab_arr = np.array(vocab_list, dtype=np.str_)
            order = np.argsort(vocab_arr)
            rank = np.empty(len(order), np.int64)
            rank[order] = np.arange(len(order))
            vocab = Vocab(vocab_arr[order].tolist())
            inverse = rank[temp_ids]
    else:
        # each document analyzed, then its k-token windows; one np.unique
        # is both the vocabulary and the term-id assignment
        with report.phase("tokenize"):
            from ..analysis.native import make_analyzer

            docids, doc_tokens = analyze_corpus(corpus_paths,
                                                make_analyzer())
        _require_docs(docids, corpus_paths)
        with report.phase("vocab"):
            doc_kgrams = [kgram_terms(toks, k) for toks in doc_tokens]
            lengths = np.fromiter((len(g) for g in doc_kgrams), np.int64,
                                  len(doc_kgrams))
            flat_terms = np.array(
                [t for grams in doc_kgrams for t in grams], dtype=np.str_)
            del doc_kgrams
            uniques, inverse = np.unique(flat_terms, return_inverse=True)
            vocab = Vocab(uniques.tolist())
    num_docs = len(docids)
    report.set_counter("Count.DOCS", num_docs)
    vocab.save(os.path.join(index_dir, fmt.VOCAB))
    v = len(vocab)
    report.set_counter("map_output_records", len(inverse))
    report.set_counter("reduce_output_groups", v)

    # --- docno mapping (NumberTrecDocuments equivalent) ---
    with report.phase("docno_mapping"):
        mapping = DocnoMapping.build(docids)
        if len(mapping) != num_docs:
            raise ValueError("duplicate docids in corpus")
        mapping.save(os.path.join(index_dir, fmt.DOCNOS))
        sorted_docids = np.array(mapping.docids, dtype=np.str_)
        docnos = (np.searchsorted(sorted_docids,
                                  np.array(docids, dtype=np.str_))
                  + 1).astype(np.int32)

    # --- postings group-by on the device ---
    with report.phase("postings_device"):
        # term ids ride as uint16 when the vocab fits below the pad value
        use16 = v < PAD_TERM_U16
        term_ids = inverse.astype(np.uint16 if use16 else np.int32)
        p = build_postings_packed(
            torch.from_numpy(term_ids).to(dev),
            torch.from_numpy(docnos).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev),
            vocab_size=v, num_docs=num_docs)
        df = p.df.cpu().numpy()
        doc_len = p.doc_len.cpu().numpy()
        num_pairs = int(df.sum())
        tf_max = int(p.pair_tf.max()) if num_pairs else 0
        pair_doc, pair_tf = shrink_pairs(p.pair_doc, p.pair_tf, num_pairs,
                                         num_docs=num_docs, tf_max=tf_max)
        del p
    report.set_counter("num_pairs", num_pairs)

    # --- char-k-gram indexes (CharKGramTermIndexer) ---
    built_chargrams = bool(compute_chargrams and chargram_ks)
    if built_chargrams:
        with report.phase("chargrams"):
            if k == 1:
                token_vocab = vocab
            else:
                token_vocab = Vocab.build(
                    t for toks in doc_tokens for t in toks)
                token_vocab.save(os.path.join(index_dir, TOKENS_VOCAB))
            build_chargram_artifacts(index_dir, token_vocab.terms,
                                     chargram_ks, device=dev)
    del doc_tokens

    # --- shard + persist (part-NNNNN layout), dictionary, metadata ---
    with report.phase("write_shards"):
        np.save(os.path.join(index_dir, fmt.DOCLEN), doc_len)
        shard_of, offset_of = fmt.write_pair_shards(index_dir, df, pair_doc,
                                                    pair_tf, num_shards)
    with report.phase("dictionary"):
        fmt.write_dictionary(index_dir, vocab.terms, shard_of, offset_of)
        dict_report = JobReport("BuildIntDocVectorsForwardIndex")
        dict_report.set_counter("Dictionary.Size", v)
        dict_report.save(os.path.join(index_dir, fmt.JOBS_DIR))

    faults.maybe_crash("crash.builder", "pre-metadata")
    meta = fmt.IndexMetadata(
        num_docs=num_docs, vocab_size=v, k=k, num_shards=num_shards,
        num_pairs=num_pairs,
        chargram_ks=chargram_ks if built_chargrams else [],
        version=fmt.FORMAT_VERSION, has_positions=False,
        format_version=fmt.ARENA_FORMAT_VERSION)
    with report.phase("finalize"):
        meta.save_with_checksums(index_dir)
    report.record_peaks(dev)
    report.save(os.path.join(index_dir, fmt.JOBS_DIR))
    return meta


def _require_docs(docids: list[str], corpus_paths) -> None:
    if not docids:
        raise ValueError(f"no <DOC> records found in {corpus_paths}")


def build_chargram_artifacts(index_dir: str, terms: list[str],
                             ks: Iterable[int], *,
                             device: torch.device) -> None:
    """Write the char-gram index of each k in `ks` that is not on disk
    yet: k <= 3 on `device`, 3 < k <= 7 through the numpy twin (k > 7
    raises). One packed byte matrix serves every k. Each artifact's job
    report is `jobs/CharKGramTermIndexer-k<k>.json`."""
    from ..ops.chargram import (
        build_chargram_index,
        build_chargram_index_host,
        pack_term_bytes,
    )

    ks = [ck for ck in ks
          if not fmt.artifact_exists(index_dir, fmt.chargram_name(ck))]
    if not ks:
        return
    tb_np, tl_np = pack_term_bytes(terms, max(ks))
    tb = tl = None
    for ck in ks:
        report = JobReport("CharKGramTermIndexer", config={"k": ck},
                           suffix=f"-k{ck}")
        if ck > 3:
            gram_codes, indptr, term_ids = build_chargram_index_host(
                tb_np, tl_np, k=ck)
        else:
            if tb is None:
                tb = torch.from_numpy(tb_np).to(device)
                tl = torch.from_numpy(tl_np).to(device)
            idx = build_chargram_index(tb, tl, k=ck)
            # the JAX package's narrowing before the copy to the host
            gram_codes = fetch_narrow(idx.gram_codes, len(idx.gram_codes),
                                      narrow_uint((1 << (8 * ck)) - 1))
            indptr = idx.indptr.cpu().numpy()
            term_ids = fetch_narrow(idx.term_ids, len(idx.term_ids),
                                    narrow_uint(len(terms) - 1))
        fmt.save_chargram(index_dir, ck, gram_codes=gram_codes,
                          indptr=indptr, term_ids=term_ids)
        report.set_counter("map_output_records", len(term_ids))
        report.set_counter("reduce_output_groups", len(gram_codes))
        report.save(os.path.join(index_dir, fmt.JOBS_DIR))
