"""Index merging: N built indexes into one index over the union corpus
(the port's copy of `tpu_ir/index/merge.py`).

An operator who grows a corpus in batches indexes each batch on its own
and merges. The contract is the JAX package's: the merged artifacts are
byte-identical to one build over the concatenated corpus. It follows from
the format's determinism: docnos are ranks in sorted-docid order, term
ids ranks in sorted-vocabulary order, and postings run in (term asc, tf
desc, doc asc) order.

The remap (searchsorted), the regroup (one lexsort over the union pairs)
and the writes run on the host in numpy, as in the JAX package; the
char-gram artifacts depend only on the merged vocabulary and are rebuilt
on `device` through build_index's own path. Position runs and the
document store are carried, byte for byte, only when every source has
them: a mixed merge is an error, not a silent loss of a capability.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..collection import DocnoMapping, Vocab
from ..utils.report import JobReport
from . import docstore as ds
from . import format as fmt
from .builder import TOKENS_VOCAB, build_chargram_artifacts, clear_index_dir
from .positions import positions_name, realign_runs, write_position_shards


def merge_indexes(
    sources: Sequence[str],
    out_dir: str,
    *,
    num_shards: int = 10,
    compute_chargrams: bool = True,
    overwrite: bool = False,
    device: str | torch.device | None = None,
) -> fmt.IndexMetadata:
    """Merge built indexes into `out_dir`. Sources must share k and have
    disjoint docid sets; the char-gram ks are the union of the sources'.
    As with build_index, an existing output is returned as it is unless
    `overwrite=True`, which deletes it first. The char-grams are rebuilt
    on `device` (CUDA by default; pass device="cpu" to merge on the
    CPU)."""
    if len(sources) < 1:
        raise ValueError("need at least one source index")
    out_abs = os.path.abspath(out_dir)
    if any(os.path.abspath(s) == out_abs for s in sources):
        raise ValueError("out_dir must not be one of the sources")
    metas = [fmt.IndexMetadata.load(s) for s in sources]
    k = metas[0].k
    if any(m.k != k for m in metas):
        raise ValueError(f"cannot merge indexes with different k: "
                         f"{[m.k for m in metas]}")
    chargram_ks = sorted({ck for m in metas for ck in m.chargram_ks})
    if compute_chargrams and chargram_ks and k > 1:
        # a k > 1 index's token vocabulary is its tokens.txt; a source
        # without one would drop out of wildcard coverage unseen
        missing = [s for s in sources
                   if not os.path.exists(os.path.join(s, TOKENS_VOCAB))]
        if missing:
            raise ValueError(
                "chargram merge needs every source's token vocabulary "
                f"(tokens.txt); missing from {missing} — rebuild those "
                "sources with chargrams, or pass compute_chargrams=False")

    # the store and the positions are carried all or nothing, checked up
    # front: failing after the docno and vocab phases would leave partial
    # artifacts behind
    corrupt = [s for s in sources
               if ds.available(s) and not ds.consistent(s)]
    if corrupt:
        raise ValueError(
            f"cannot merge: document store in {corrupt} is inconsistent "
            "(crash between bin and idx writes?); rebuild it with "
            "`tpu-ir index --store`, or delete its "
            "docstore.bin/docstore-idx.npz to merge without one")
    has_store = [ds.available(s) for s in sources]
    if any(has_store) and not all(has_store):
        raise ValueError(
            "cannot merge: some sources carry a document store and some "
            f"do not ({[(s, h) for s, h in zip(sources, has_store)]}); "
            "build the missing stores with `tpu-ir index --store`, or "
            "delete docstore.bin/docstore-idx.npz from the others to "
            "merge without one")
    has_positions = all(m.has_positions for m in metas)
    if any(m.has_positions for m in metas) and not has_positions:
        raise ValueError(
            "cannot merge: some sources carry positions and some do not "
            f"({[(s, m.has_positions) for s, m in zip(sources, metas)]}); "
            "rebuild the v1 sources with positions=True, or drop the "
            "positions by rebuilding the v2 sources without them")
    dev = resolve_device(device)

    os.makedirs(out_dir, exist_ok=True)
    if overwrite:
        clear_index_dir(out_dir)
    if fmt.artifact_exists(out_dir, fmt.METADATA):
        return fmt.IndexMetadata.load(out_dir)
    report = JobReport("MergeIndexes", config={
        "sources": list(sources), "num_shards": num_shards, "k": k})

    # docno space: the union of the docids, numbered by sorted rank
    with report.phase("docnos"):
        mappings = [DocnoMapping.load(os.path.join(s, fmt.DOCNOS))
                    for s in sources]
        all_docids = np.concatenate(
            [np.asarray(m.docids, dtype=object) for m in mappings])
        if len(np.unique(all_docids)) != len(all_docids):
            raise ValueError("sources share docids; corpora must be "
                             "disjoint to merge")
        merged_map = DocnoMapping.build(list(all_docids))
        merged_map.save(os.path.join(out_dir, fmt.DOCNOS))
        merged_docids = np.asarray(merged_map.docids, dtype=object)
        # per source: old docno (1-based) -> new docno
        docno_lut = []
        for m in mappings:
            lut = np.zeros(len(m) + 1, np.int32)
            lut[1:] = np.searchsorted(
                merged_docids, np.asarray(m.docids, dtype=object)) + 1
            docno_lut.append(lut)
        num_docs = len(merged_map)
        report.set_counter("Count.DOCS", num_docs)

    # vocabulary: the sorted union, and each source's id remap row
    with report.phase("vocab"):
        vocabs = [Vocab.load(os.path.join(s, fmt.VOCAB)) for s in sources]
        merged_terms = sorted(set().union(*[set(v.terms) for v in vocabs]))
        term_lut = [np.searchsorted(merged_terms, np.asarray(v.terms))
                    .astype(np.int32) for v in vocabs]
        Vocab(merged_terms).save(os.path.join(out_dir, fmt.VOCAB))
        v_size = len(merged_terms)
        report.set_counter("Dictionary.Size", v_size)

    with report.phase("doc_len"):
        # int32, as build_index's doc lengths are (byte identity)
        doc_len = np.zeros(num_docs + 1, np.int32)
        for i, s in enumerate(sources):
            dl = np.load(os.path.join(s, fmt.DOCLEN))
            doc_len[docno_lut[i][1:]] = dl[1:]
        np.save(os.path.join(out_dir, fmt.DOCLEN), doc_len)

    # postings: remap the ids, one union lexsort, reshard
    with report.phase("merge_postings"):
        terms_l, docs_l, tfs_l = [], [], []
        delta_l, rlen_l = [], []
        for i, s in enumerate(sources):
            for sh in range(metas[i].num_shards):
                # a compressed (v3) source part is decoded here
                z = fmt.load_shard(s, sh, decode=True)
                t = np.repeat(term_lut[i][z["term_ids"]],
                              np.diff(z["indptr"]).astype(np.int64))
                terms_l.append(t.astype(np.int32))
                docs_l.append(docno_lut[i][z["pair_doc"]])
                tfs_l.append(np.asarray(z["pair_tf"], np.int32))
                if has_positions:
                    with np.load(os.path.join(
                            s, positions_name(sh))) as pz:
                        delta_l.append(pz["pos_delta"])
                        rlen_l.append(np.diff(pz["pos_indptr"]))
        pt = np.concatenate(terms_l) if terms_l else np.zeros(0, np.int32)
        pd = np.concatenate(docs_l) if docs_l else np.zeros(0, np.int32)
        ptf = np.concatenate(tfs_l) if tfs_l else np.zeros(0, np.int32)
        order = np.lexsort((pd, -ptf.astype(np.int64), pt))
        pt, pd, ptf = pt[order], pd[order], ptf[order]
        df = np.bincount(pt, minlength=v_size).astype(np.int32)
        report.set_counter("num_pairs", len(pt))

    with report.phase("write_shards"):
        shard_of, offset_of = fmt.write_pair_shards(out_dir, df, pd, ptf,
                                                    num_shards)

    if has_positions:
        # runs follow their pairs through the union sort (deltas are local
        # to a run, so reordering runs re-encodes nothing), then split by
        # term_id % S as the pairs are
        with report.phase("merge_positions"):
            all_delta = (np.concatenate(delta_l) if delta_l
                         else np.zeros(0, np.int32))
            all_len = (np.concatenate(rlen_l).astype(np.int64) if rlen_l
                       else np.zeros(0, np.int64))
            starts = np.concatenate([[0], np.cumsum(all_len)])[:-1]
            out_indptr, gather = realign_runs(starts[order],
                                              all_len[order])
            write_position_shards(out_dir, pt, out_indptr,
                                  all_delta[gather], num_shards)

    with report.phase("dictionary"):
        fmt.write_dictionary(out_dir, merged_terms, shard_of, offset_of)

    if all(has_store):
        # each source store in its own arrival order, sources in argument
        # order: with the sources in corpus order that is the
        # concatenated corpus's arrival order, so the zlib blocks fall on
        # a one-shot `--store` build's 256-doc cuts
        with report.phase("docstore"):
            def records():
                for i, s in enumerate(sources):
                    for old_dn, data in ds.iter_arrival(s):
                        yield int(docno_lut[i][old_dn]), data

            st = ds.write_docstore(out_dir, records(), num_docs)
            report.set_counter("docstore_raw_bytes", st["raw_bytes"])
            report.set_counter("docstore_stored_bytes", st["stored_bytes"])

    # char-gram artifacts over the merged token vocabulary
    built_chargrams = bool(compute_chargrams and chargram_ks)
    if built_chargrams:
        with report.phase("chargrams"):
            if k == 1:
                token_terms = merged_terms
            else:
                token_terms = sorted(set().union(*[
                    set(Vocab.load(os.path.join(s, TOKENS_VOCAB)).terms)
                    for s in sources]))
                if token_terms:
                    Vocab(token_terms).save(
                        os.path.join(out_dir, TOKENS_VOCAB))
            if token_terms:
                build_chargram_artifacts(out_dir, token_terms, chargram_ks,
                                         device=dev)
            else:
                built_chargrams = False

    meta = fmt.IndexMetadata(
        num_docs=num_docs, vocab_size=v_size, k=k, num_shards=num_shards,
        num_pairs=int(len(pt)),
        chargram_ks=chargram_ks if built_chargrams else [],
        version=2 if has_positions else fmt.FORMAT_VERSION,
        has_positions=has_positions,
        format_version=fmt.resolve_format_version())
    with report.phase("finalize"):
        meta.save_with_checksums(out_dir)
    report.record_peaks(dev)
    report.save(os.path.join(out_dir, fmt.JOBS_DIR))
    return meta
