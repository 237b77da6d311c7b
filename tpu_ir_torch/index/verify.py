"""Index validation pass (the port's copy of `tpu_ir/index/verify.py`).

The reference's scattered sanity asserts (the record reader's byte
position check, the dictionary build's one-position-per-term check, the
term-match check after each query seek) as one structural verification
of a built index, after its recorded checksums: `verify` on the command
line. The report equals the JAX package's on the same index. Position
runs and live index dirs are later slices of the port and raise.
"""

from __future__ import annotations

import os

import numpy as np

from ..collection import DocnoMapping, Vocab
from . import format as fmt


def verify_index(index_dir: str) -> dict:
    """Check every invariant of the on-disk index; raises AssertionError with
    a specific message on violation, returns a summary dict on success."""
    meta = fmt.IndexMetadata.load(index_dir)
    fmt.require_arena_format(meta.format_version)
    if meta.has_positions:
        raise ValueError("verifying position runs is not supported by "
                         "tpu_ir_torch yet (a later slice of the port)")
    # integrity first: recorded checksums must match the bytes on disk
    # (a corrupt artifact should surface as ONE structured IntegrityError
    # naming the file, before any structural assert trips on its content)
    checksums_verified = fmt.verify_checksums(index_dir, meta)
    vocab = Vocab.load(os.path.join(index_dir, fmt.VOCAB))
    mapping = DocnoMapping.load(os.path.join(index_dir, fmt.DOCNOS))
    doc_len = np.load(os.path.join(index_dir, fmt.DOCLEN))

    assert len(vocab) == meta.vocab_size, "vocab size != metadata"
    assert len(mapping) == meta.num_docs, "docno mapping size != metadata"
    assert doc_len.shape[0] == meta.num_docs + 1, "doclen length"
    assert doc_len[0] == 0, "doclen slot 0 must be unused"

    # dictionary access path first (the reference's post-seek term-match
    # check, exercised end to end): the Dictionary shares this function's
    # reads — it is handed the raw tsv text, and the shards its spot-check
    # pulled in are consumed (pop_shard) by the structural loop below, so
    # the whole verification reads each artifact exactly once
    from .dictionary import Dictionary, verify_dictionary_access

    with open(os.path.join(index_dir, fmt.DICTIONARY),
              encoding="utf-8") as f:
        dict_text = f.read()
    dictionary = Dictionary(index_dir, text=dict_text)
    dict_checked = verify_dictionary_access(
        index_dir, dictionary=dictionary, vocab=vocab)

    seen_terms = np.zeros(meta.vocab_size, bool)
    df_global = np.zeros(meta.vocab_size, np.int64)
    # each term's actual postings start inside its part, read off the
    # part's own indptr: for the canonical (globally term-sorted) layout
    # this reproduces fmt.shard_local_offsets exactly, and for the
    # bucket-segmented layout (radix_parts builds — term ids ascend only
    # within each bucket segment) it is the offset the dictionary MUST
    # record, so one collection serves both layouts
    offset_actual = np.zeros(meta.vocab_size, np.int64)
    segmented_shards = 0
    total_pairs = 0
    total_tf = 0
    for s in range(meta.num_shards):
        z = dictionary.pop_shard(s)
        tids, indptr = z["term_ids"], z["indptr"]
        pd, ptf, df = z["pair_doc"], z["pair_tf"], z["df"]
        assert ((tids % meta.num_shards) == s).all(), f"shard {s}: foreign term"
        if len(tids) > 1 and not (np.diff(tids) > 0).all():
            # bucket-segmented part (index/streaming.write_bucketed_shard):
            # terms must still be UNIQUE across the part, and every
            # descending step must be a segment boundary — i.e. within
            # each maximal ascending run the ids strictly ascend, which
            # the run decomposition gives by construction; uniqueness is
            # the real invariant (a duplicated term would double-count
            # df and desync the dictionary)
            segmented_shards += 1
            sorted_tids = np.sort(tids)
            assert (np.diff(sorted_tids) > 0).all(), \
                f"shard {s}: duplicated terms"
        assert not seen_terms[tids].any(), f"shard {s}: duplicated terms"
        seen_terms[tids] = True
        offset_actual[tids] = indptr[:-1]
        assert len(indptr) == len(tids) + 1, f"shard {s}: indptr length"
        assert (np.diff(indptr) >= 0).all(), f"shard {s}: indptr not monotone"
        assert indptr[-1] == len(pd) == len(ptf), f"shard {s}: nnz mismatch"
        # one-position-per-term (reference BuildIntDocVectorsForwardIndex
        # assert): df equals the postings slice length
        assert (np.diff(indptr) == df).all(), f"shard {s}: df != slice length"
        assert (ptf > 0).all(), f"shard {s}: nonpositive tf"
        assert ((pd >= 1) & (pd <= meta.num_docs)).all(), f"shard {s}: docno range"
        # posting order within each term (tf desc, then docno asc), checked
        # as one vectorized diff over the whole shard: positions crossing a
        # term boundary (indptr starts) are masked out. Per-term Python
        # loops took tens of minutes at 1M-doc vocabularies.
        if len(pd) > 1:
            within = np.ones(len(pd) - 1, bool)
            starts = indptr[1:-1]  # first slot of every segment but the 0th
            within[starts[(starts > 0) & (starts < len(pd))] - 1] = False
            d_tf = np.diff(ptf)
            d_doc = np.diff(pd)
            assert (d_tf[within] <= 0).all(), f"shard {s}: tf order"
            ties = within & (d_tf == 0)
            assert (d_doc[ties] > 0).all(), f"shard {s}: docno tie order"
            # duplicate docnos need not be tf-adjacent: pack (segment, doc)
            # into one int64 key and sort — equal neighbors = duplicate.
            # (np.lexsort over the two columns did the same in 60 s at 250M
            # pairs; the packed single-key sort does it in 8 s.)
            seg = np.repeat(np.arange(len(tids), dtype=np.int64),
                            np.diff(indptr))
            key = seg * np.int64(meta.num_docs + 1) + pd
            key.sort()
            assert not (np.diff(key) == 0).any(), \
                f"shard {s}: duplicate docno"
        df_global[tids] = df
        total_pairs += int(indptr[-1])
        total_tf += int(ptf.sum())

    assert seen_terms.all(), "terms missing from all shards"
    assert total_pairs == meta.num_pairs, "num_pairs != metadata"
    tf_lossy = bool(getattr(meta, "tf_lossy", False))
    if not tf_lossy:
        assert total_tf == int(doc_len.sum()), "sum(tf) != sum(doc_len)"
    # lossy int8 floor-quantizes tfs, so tf mass is NOT conserved — the
    # conservation check is skipped and the report says so LOUDLY below
    # (compress_index refuses lossy int8 on positional indexes, where
    # the run-length invariant has no such escape hatch)

    # dictionary: sorted, complete, offsets point at real slices. The
    # whole expected file is regenerated from the vocab + the offsets
    # COLLECTED from the parts themselves (for the canonical layout
    # these equal fmt.shard_local_offsets' derivation from df; for
    # bucket-segmented parts they are the only correct answer) and
    # compared as one string — the reference's one-position-per-term
    # assert, without a per-term loop.
    shard_of = fmt.shard_assignment(meta.vocab_size, meta.num_shards)
    if not segmented_shards:
        _, offset_canon = fmt.shard_local_offsets(df_global,
                                                  meta.num_shards)
        assert (offset_actual == offset_canon).all(), \
            "part CSR offsets diverge from the canonical term order"
    expected = "".join(
        f"{term}\t{shard_of[tid]}\t{offset_actual[tid]}\n"
        for tid, term in enumerate(vocab.terms))
    assert dict_text == expected, "dictionary content mismatch"
    terms_arr = np.array(vocab.terms, dtype=np.str_)
    assert (terms_arr[:-1] < terms_arr[1:]).all(), "vocab not sorted-unique"

    # char-gram artifacts: per-gram term lists sorted-unique, checked with
    # the same masked-diff trick as the posting order above
    for ck in meta.chargram_ks:
        z = fmt.load_chargram(index_dir, ck)
        codes, indptr, tids = z["gram_codes"], z["indptr"], z["term_ids"]
        # a negative code is unreachable by gram_to_code's unsigned
        # packing — the signature of a sign-bit overflow in the build
        # (the k=4 int32 class fixed in r5); sortedness alone passes it
        assert (codes >= 0).all(), f"chargram k={ck}: negative gram codes"
        assert (np.diff(codes) > 0).all(), f"chargram k={ck}: codes not sorted"
        assert indptr[-1] == len(tids), f"chargram k={ck}: nnz"
        if len(tids) > 1:
            within = np.ones(len(tids) - 1, bool)
            starts = indptr[1:-1]
            within[starts[(starts > 0) & (starts < len(tids))] - 1] = False
            assert (np.diff(tids)[within] > 0).all(), \
                f"chargram k={ck}: term lists not sorted-unique"

    out = {
        "checksums_verified": checksums_verified,
        "dictionary_terms_checked": dict_checked,
        "bucket_segmented_shards": segmented_shards,
        "has_positions": meta.has_positions,
        "num_docs": meta.num_docs,
        "vocab_size": meta.vocab_size,
        "num_pairs": total_pairs,
        "num_shards": meta.num_shards,
        "total_tf": total_tf,
        "format_version": meta.format_version,
        "ok": True,
    }
    if getattr(meta, "compressed", False) or tf_lossy:
        out["compressed"] = bool(getattr(meta, "compressed", False))
        out["tf_dtype"] = getattr(meta, "tf_dtype", "int32")
        out["tf_lossy"] = tf_lossy
        if tf_lossy:
            out["tf_lossy_warning"] = (
                "term frequencies are floor-quantized (lossy int8): "
                "tf-mass conservation was NOT checked and rankings may "
                "differ from the raw index")
    return out


def verify_live(live_dir: str) -> dict:
    """Verify a live index dir (segments, tombstones, WAL): raises
    ValueError until the live index is ported (a later slice)."""
    raise ValueError("live index dirs are not supported by tpu_ir_torch "
                     "yet (a later slice of the port)")
