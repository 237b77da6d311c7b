"""Streaming (out-of-core) index build for corpora larger than memory: the
port's copy of `tpu_ir/index/streaming.py`, on one device.

  pass 1 (map): the corpus streams in byte chunks through the native C++
    scanner (record split, analysis and a corpus-wide first-seen
    vocabulary, all in C++); each chunk's delta (temp term ids, doc
    lengths) is drained at once and spilled. Memory is the vocabulary
    and one batch.
  between passes: the docno mapping (sorted docids) and the vocabulary's
    argsort; one rank array remaps temp ids to sorted ids.
  pass 2 (combine and spill): in legacy mode (`radix_buckets=0`) each
    token batch is remapped and grouped into (term, doc, tf) on the
    device (ops/postings.py::build_postings_packed) and its pairs are
    spilled by term shard (term_id % S). In radix mode pass 1 also
    partitioned each batch's occurrences by bucket (temp_id % B,
    `rpairs-RRR-BBBBB.npz`, documents run-length packed, written on a
    thread one batch behind the tokenizer), so pass 2 is B independent
    per-bucket reduces: a bucket is a function of the term alone, so its
    tfs are final. A prefetch thread reads and remaps bucket N+1 while
    the device reduces bucket N.
  pass 3 (order and write): per term shard, its spills are concatenated
    and sorted on the host into the posting order (term asc, tf desc,
    doc asc) and written as the part file; peak memory is one shard's
    pairs. With TPU_IR_RADIX_PARTS the sort is skipped and the parts are
    the bucket segments laid end to end (write_bucketed_shard).

The artifacts are byte-identical to the JAX package's streaming build,
and to the one-shot build (index/builder.py), at any bucket count.

Crash resume: every spill and part is written atomically, pass 1 ends by
writing a manifest (docids, the native vocabulary, per-batch and per-doc
occurrence counts, the config signature, every spill's CRC), and a
restart resumes from the last complete artifact: the corpus is never
tokenized again, a complete pass-2 batch or bucket is never reduced
again, a complete part is never sorted again. Spills of another config
(corpus bytes, k, shards, radix buckets, radix parts) are discarded. A
pass-1 spill that fails its manifest CRC discards pass 1; a corrupt
pass-2 spill recomputes only its batch or bucket. `crash.pass1/2/3` are
the fault sites the resume is tested against.

A k > 1 build tokenizes through the Python chunked tokenizer, whose
terms are each document's k-token windows (the native scanner emits
single tokens); pass 2 and 3 are unchanged, k only widens the
vocabulary. As in the JAX package, a streaming k > 1 build writes no
char-gram indexes (they need the token vocabulary, which the k-gram
spills do not keep).

The SPMD pass 2 (`spmd_devices`) and positions raise ValueError (later
slices of the port), as does a build without CUDA unless device="cpu"
is asked for.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from .. import envvars, faults, resolve_device
from ..analysis.native import make_chunked_tokenizer
from ..collection import DocnoMapping, Vocab
from ..obs import get_registry
from ..ops.postings import PAD_TERM_U16, build_postings_packed, pair_term_from_df
from ..utils.report import JobReport, recovery_counters
from ..utils.transfer import prefetch_iter, shrink_pairs
from . import format as fmt
from .builder import build_chargram_artifacts, check_build_args, clear_index_dir

logger = logging.getLogger(__name__)

PASS1_MANIFEST = "pass1.npz"
SPILL_DIR = "_spill"


def _config_sig(corpus_paths: Sequence[str], k: int, num_shards: int,
                spmd_devices: int | None, positions: bool = False,
                store: bool = False, radix_buckets: int = 0,
                radix_parts: bool = False) -> np.ndarray:
    """The build's config signature, kept in the pass-1 manifest: a
    resume is valid only over spills of the same corpus files (path,
    size and mtime: a regenerated corpus of the same size must not
    resume) and the same build shape."""
    parts = [f"k={k}", f"shards={num_shards}", f"spmd={spmd_devices or 0}",
             f"pos={int(positions)}", f"store={int(store)}",
             f"radix={radix_buckets}", f"rparts={int(radix_parts)}"]
    for p in corpus_paths:
        ap = os.path.abspath(p)
        if os.path.exists(ap):
            st = os.stat(ap)
            size, mtime = st.st_size, st.st_mtime_ns
        else:
            size, mtime = -1, -1
        parts.append(f"{ap}:{size}:{mtime}")
    return np.array(parts, dtype=np.str_)


def radix_spill_name(bucket: int, batch: int) -> str:
    """Pass-1 pair spill of (radix bucket, tokenize batch)."""
    return f"rpairs-{bucket:03d}-{batch:05d}.npz"


def pair_spill_name(shard: int, unit: int) -> str:
    """Pass-2 pair spill of (term shard, batch or bucket)."""
    return f"pairs-{shard:03d}-{unit:05d}.npz"


class _ResumeState:
    """The pass-1 state of a matching manifest: docids (corpus order), the
    native vocabulary (temp-id order), the batch count, per-batch
    occurrence counts and every doc's occurrence count."""

    def __init__(self, docids, vocab, n_batches, batch_occ, doc_lens):
        self.docids = docids
        self.vocab = vocab
        self.n_batches = n_batches
        self.batch_occ = batch_occ
        self.doc_lens = doc_lens


def _pass1_spill_paths(spill_dir: str, b: int, radix_buckets: int):
    """Batch b's pass-1 spills, in the manifest's CRC order."""
    if radix_buckets:
        return [os.path.join(spill_dir, radix_spill_name(r, b))
                for r in range(radix_buckets)]
    return [os.path.join(spill_dir, f"tokens-{b:05d}.npz")]


def _load_resume_state(spill_dir: str, sig: np.ndarray):
    """The _ResumeState of a complete pass 1 of this exact config, else
    None. A spill that fails its manifest CRC discards the whole pass-1
    state: it cannot be rebuilt without tokenizing again."""
    path = os.path.join(spill_dir, PASS1_MANIFEST)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if len(z["sig"]) != len(sig) or not (z["sig"] == sig).all():
                return None
            n_batches = int(z["n_batches"])
            radix = int(z["radix_buckets"])
            spill_crc = z["spill_crc"].tolist()
            if len(spill_crc) != n_batches * max(radix, 1):
                return None
            i = 0
            for b in range(n_batches):
                for spill in _pass1_spill_paths(spill_dir, b, radix):
                    if not os.path.exists(spill):
                        return None
                    if fmt.file_checksum(spill) != spill_crc[i]:
                        recovery_counters().incr("spill_integrity_discards")
                        logger.warning(
                            "pass-1 spill %s fails its manifest checksum;"
                            " discarding the pass-1 resume state", spill)
                        return None
                    i += 1
            return _ResumeState(z["docids"].tolist(), z["vocab"].tolist(),
                                n_batches, z["batch_occ"], z["doc_lens"])
    except fmt.CORRUPT_NPZ:
        return None


def _batch_pairs_done(spill_dir: str, b: int, num_shards: int,
                      validate: bool = False) -> bool:
    """Whether batch (or bucket) b's per-shard pair spills all exist. With
    `validate` (the resume path) each is read in full, and a corrupt one
    deletes the unit's spills so only that unit is reduced again."""
    paths = [os.path.join(spill_dir, pair_spill_name(s, b))
             for s in range(num_shards)]
    if not all(os.path.exists(p) for p in paths):
        return False
    if validate and not all(fmt.readable_npz(p) for p in paths):
        recovery_counters().incr("spill_integrity_discards")
        logger.warning("unit %d has a corrupt pair spill; reducing it again",
                       b)
        for p in paths:
            if os.path.exists(p):
                os.unlink(p)
        return False
    return True


def reduce_shard_spills(spill_dir: str, index_dir: str, row: int,
                        n_units: int, vocab_size: int,
                        shard_of: np.ndarray) -> tuple[np.ndarray, int]:
    """Pass 3 for one term shard: concatenate its pair spills, sort them
    into the posting order (term asc, tf desc, doc asc) on the host and
    write the part. A sort, not a merge: a (term, doc) pair lives in one
    spill only (batches partition documents, buckets partition terms).
    Returns (rdf int32 [V], num_pairs)."""
    terms, docs, tfs = [], [], []
    for b in range(n_units):
        with np.load(os.path.join(spill_dir, pair_spill_name(row, b))) as z:
            terms.append(z["term"])
            docs.append(z["doc"])
            tfs.append(z["tf"])
    t = np.concatenate(terms) if terms else np.zeros(0, np.int32)
    d = np.concatenate(docs) if docs else np.zeros(0, np.int32)
    w = np.concatenate(tfs) if tfs else np.zeros(0, np.int32)
    # tf negated as int64: spills may hold it as uint16
    order = np.lexsort((d, -w.astype(np.int64), t))
    t, d, w = t[order], d[order], w[order]
    rdf = np.bincount(t, minlength=vocab_size).astype(np.int32)
    tids = np.nonzero(shard_of == row)[0].astype(np.int32)
    local_indptr = np.concatenate([[0], np.cumsum(rdf[tids].astype(np.int64))])
    fmt.save_shard(index_dir, row, term_ids=tids, indptr=local_indptr,
                   pair_doc=d, pair_tf=w, df=rdf[tids])
    return rdf, len(t)


def write_radix_spills(spill_dir: str, b: int, ids: np.ndarray,
                       lengths: np.ndarray, doc_ofs: int,
                       radix_buckets: int) -> list[str]:
    """Partition one tokenize batch's occurrences by bucket (temp_id % B:
    temp ids are pinned by the manifest, so stable across a resume) and
    spill each bucket's share atomically, documents as runs (global doc
    ordinal, run length): the partition keeps emission order, so a doc's
    occurrences in one bucket stay contiguous. Returns the spills' CRCs
    in bucket order."""
    reg = get_registry()
    flat_ord = np.repeat(
        np.arange(doc_ofs, doc_ofs + len(lengths), dtype=np.int64),
        lengths.astype(np.int64)).astype(np.int32)
    bucket = ids % np.int32(radix_buckets)
    order = np.argsort(bucket, kind="stable")
    ids_p = ids[order].astype(np.int32)
    ord_p = flat_ord[order]
    starts = np.concatenate([[0], np.cumsum(
        np.bincount(bucket, minlength=radix_buckets))])
    crcs = []
    for r in range(radix_buckets):
        lo, hi = int(starts[r]), int(starts[r + 1])
        t_r, o_r = ids_p[lo:hi], ord_p[lo:hi]
        if len(o_r):
            run_start = np.concatenate(
                [[0], np.flatnonzero(np.diff(o_r) != 0) + 1])
            run_docs = o_r[run_start]
            run_lens = np.diff(np.concatenate(
                [run_start, [len(o_r)]])).astype(np.int32)
        else:
            run_docs = np.zeros(0, np.int32)
            run_lens = np.zeros(0, np.int32)
        path = os.path.join(spill_dir, radix_spill_name(r, b))
        crcs.append(fmt.savez_atomic(path, term=t_r, doc=run_docs,
                                     len=run_lens))
        reg.incr("build.radix.bucket_spills")
        reg.incr("build.radix.spill_bytes", int(os.path.getsize(path)))
    return crcs


def write_bucketed_shard(spill_dir: str, index_dir: str, row: int,
                         num_buckets: int, vocab_size: int, *,
                         offset_of: np.ndarray | None = None
                         ) -> tuple[np.ndarray, int]:
    """Pass 3 for one term shard in the bucket-segmented layout
    (TPU_IR_RADIX_PARTS): each bucket's pass-2 spill already holds final
    postings in posting order, so the part is its bucket segments laid
    end to end and no sort runs. Term ids are unique in the part but
    ascend only within a segment; every reader assembles by term id, but
    the part's bytes (and the dictionary) differ from the canonical
    layout. `offset_of` (int64 [V]) receives each term's postings start
    in its part, which the dictionary must record."""
    tids_l, df_l, doc_l, tf_l = [], [], [], []
    for r in range(num_buckets):
        with np.load(os.path.join(spill_dir, pair_spill_name(row, r))) as z:
            t, d, w = z["term"], z["doc"], z["tf"]
        if not len(t):
            continue
        ut, counts = np.unique(t, return_counts=True)
        tids_l.append(ut.astype(np.int32))
        df_l.append(counts.astype(np.int32))
        doc_l.append(d)
        tf_l.append(w)
    tids = np.concatenate(tids_l) if tids_l else np.zeros(0, np.int32)
    df_part = np.concatenate(df_l) if df_l else np.zeros(0, np.int32)
    indptr = np.concatenate([[0], np.cumsum(df_part, dtype=np.int64)])
    pair_doc = np.concatenate(doc_l) if doc_l else np.zeros(0, np.int32)
    pair_tf = np.concatenate(tf_l) if tf_l else np.zeros(0, np.int32)
    fmt.save_shard(index_dir, row, term_ids=tids, indptr=indptr,
                   pair_doc=pair_doc, pair_tf=pair_tf, df=df_part)
    if offset_of is not None:
        offset_of[tids] = indptr[:-1]
    rdf = np.zeros(vocab_size, np.int32)
    rdf[tids] = df_part
    return rdf, len(pair_doc)


def run_pass1_spills(tok, spill_dir: str, batch_docs: int, store: bool,
                     report: JobReport, *, radix_buckets: int = 0):
    """The pass-1 loop: drain the tokenizer into batches of at least
    `batch_docs` docs and spill each atomically (a token spill, or with
    `radix_buckets` its per-bucket pair spills, written on a thread one
    batch behind the tokenizer). With `store`, the batch's text spill is
    written first: the token or pair spills are the batch's resume
    marker, so its text must never trail them.

    Returns (docids, vocab_list, n_batches, per-batch occurrences, spill
    CRCs, per-doc occurrence counts int64 in corpus order); the caller
    writes the manifest last."""
    from .docstore import write_text_spill

    all_docids: list[str] = []
    stats: list[int] = []
    spill_crcs: list[str] = []
    all_lens: list[np.ndarray] = []
    n_written = 0

    def spill_batch(b: int, ids, lengths, texts, docids, doc_ofs):
        nonlocal n_written
        if store:
            write_text_spill(os.path.join(spill_dir, f"text-{b:05d}.npz"),
                             texts, docids)
        if radix_buckets:
            spill_crcs.extend(write_radix_spills(
                spill_dir, b, ids, lengths, doc_ofs, radix_buckets))
        else:
            spill_crcs.append(fmt.savez_atomic(
                os.path.join(spill_dir, f"tokens-{b:05d}.npz"),
                ids=ids, lengths=lengths))
        n_written = b + 1
        faults.maybe_crash("crash.pass1", f"b={b + 1}")

    def batches():
        """(b, ids, lengths, texts, docids, doc_ofs) per batch; doc_ofs is
        the global ordinal of the batch's first document."""
        acc_ids, acc_lens, acc_texts, acc_docids = [], [], [], []
        b = doc_ofs = 0
        for delta in tok.deltas():
            if store:
                docids_d, ids_d, lens_d, texts_d = delta
                acc_texts.extend(texts_d)
            else:
                docids_d, ids_d, lens_d = delta
            report.incr("Count.DOCS", len(docids_d))
            all_docids.extend(docids_d)
            acc_docids.extend(docids_d)
            acc_ids.append(ids_d)
            acc_lens.append(lens_d)
            if len(acc_docids) >= batch_docs:
                yield flush(b, doc_ofs, acc_ids, acc_lens, acc_texts,
                            acc_docids)
                b += 1
                doc_ofs = len(all_docids)
                acc_ids, acc_lens, acc_texts, acc_docids = [], [], [], []
        if acc_docids:
            yield flush(b, doc_ofs, acc_ids, acc_lens, acc_texts,
                        acc_docids)

    def flush(b, doc_ofs, acc_ids, acc_lens, acc_texts, acc_docids):
        ids = np.concatenate(acc_ids)
        lengths = np.concatenate(acc_lens)
        all_lens.append(lengths.astype(np.int64))
        stats.append(len(ids))
        return b, ids, lengths, acc_texts, acc_docids, doc_ofs

    it = batches()
    if radix_buckets:
        it = prefetch_iter(it, name="pass1-spill")
    try:
        for args in it:
            spill_batch(*args)
        vocab_list = tok.vocab()
    finally:
        # close the pipeline before the tokenizer: the producer thread
        # must be out of tok.deltas() before its native handle is freed
        it.close()
        tok.close()
    doc_lens = (np.concatenate(all_lens) if all_lens
                else np.zeros(0, np.int64))
    return all_docids, vocab_list, n_written, stats, spill_crcs, doc_lens


def build_index_streaming(
    corpus_paths: Sequence[str] | str,
    index_dir: str,
    *,
    k: int = 1,
    chargram_ks: Iterable[int] = (2, 3),
    num_shards: int = 10,
    batch_docs: int = 50_000,
    compute_chargrams: bool = True,
    keep_spills: bool = False,
    spmd_devices: int | None = None,
    overwrite: bool = False,
    positions: bool = False,
    store: bool = False,
    radix_buckets: int | None = None,
    radix_parts: bool | None = None,
    tokenize_procs: int | None = None,
    device: str | torch.device | None = None,
) -> fmt.IndexMetadata:
    """Build the index of a TREC corpus in bounded host memory, with the
    JAX package's parameters and defaults (`radix_buckets` from
    TPU_IR_RADIX_BUCKETS, 16; 0 is the per-batch combine). Pass 2's
    group-by and the char-gram builds run on `device` (CUDA by default).
    `tokenize_procs` reaches only the Python tokenizer (k > 1, or
    `make_chunked_tokenizer(native=False)`); the native one is a single
    C++ pass. k > 1 writes no char-gram indexes. The job's phase timings
    and counters are saved as `jobs/TermKGramDocIndexer.json`."""
    check_build_args(k, positions, spmd_devices)
    dev = resolve_device(device)
    if isinstance(corpus_paths, (str, os.PathLike)):
        corpus_paths = [corpus_paths]
    chargram_ks = list(chargram_ks)
    if radix_buckets is None:
        radix_buckets = envvars.get_int("TPU_IR_RADIX_BUCKETS")
    radix_buckets = int(radix_buckets or 0)
    if radix_parts is None:
        radix_parts = envvars.get_bool("TPU_IR_RADIX_PARTS")
    radix_parts = bool(radix_parts) and radix_buckets > 0
    os.makedirs(index_dir, exist_ok=True)
    spill_dir = os.path.join(index_dir, SPILL_DIR)
    if overwrite:
        clear_index_dir(index_dir)
        shutil.rmtree(spill_dir, ignore_errors=True)
    if fmt.artifact_exists(index_dir, fmt.METADATA):
        return fmt.IndexMetadata.load(index_dir)

    # ---- crash resume: a spill dir whose manifest matches this config is
    # reused; anything else (and every half-written artifact) goes ----
    sig = _config_sig(corpus_paths, k, num_shards, spmd_devices, positions,
                      store, radix_buckets=radix_buckets,
                      radix_parts=radix_parts)
    resume_state = _load_resume_state(spill_dir, sig)
    if resume_state is None:
        shutil.rmtree(spill_dir, ignore_errors=True)
        clear_index_dir(index_dir)
    os.makedirs(spill_dir, exist_ok=True)
    resuming = resume_state is not None
    reg = get_registry()
    spill_bytes0 = reg.get("build.radix.spill_bytes")
    report = JobReport("TermKGramDocIndexer", config={
        "k": k, "num_shards": num_shards, "streaming": True,
        "batch_docs": batch_docs, "spmd_devices": spmd_devices,
        "store": store, "radix_buckets": radix_buckets,
        "radix_parts": radix_parts, "resumed": resuming,
        "device": str(dev)})

    # ---- pass 1: chunked tokenize -> spilled batches ----
    if resuming:
        all_docids = resume_state.docids
        vocab_list = resume_state.vocab
        n_batches = resume_state.n_batches
        batch_occ = resume_state.batch_occ
        all_doc_lens = resume_state.doc_lens
        report.incr("Count.DOCS", len(all_docids))
        report.set_counter("pass1_resumed_batches", n_batches)
    else:
        tok = make_chunked_tokenizer(corpus_paths, k=k, with_text=store,
                                     procs=tokenize_procs)
        with report.phase("pass1_tokenize"):
            (all_docids, vocab_list, n_batches, occ_per_batch, spill_crcs,
             all_doc_lens) = run_pass1_spills(
                tok, spill_dir, batch_docs, store, report,
                radix_buckets=radix_buckets)
        batch_occ = np.array(occ_per_batch, dtype=np.int64)
        # the manifest last: its existence certifies pass 1
        fmt.savez_atomic(
            os.path.join(spill_dir, PASS1_MANIFEST), sig=sig,
            docids=np.array(all_docids, dtype=np.str_),
            vocab=np.array(vocab_list, dtype=np.str_),
            n_batches=np.int64(n_batches), batch_occ=batch_occ,
            radix_buckets=np.int64(radix_buckets),
            doc_lens=np.asarray(all_doc_lens, dtype=np.int64),
            spill_crc=np.array(spill_crcs, dtype=np.str_))

    num_docs = len(all_docids)
    if num_docs == 0:
        raise ValueError(f"no <DOC> records found in {corpus_paths}")

    # ---- between passes: docno mapping + vocab (temp -> sorted rank) ----
    with report.phase("docno_mapping"):
        mapping = DocnoMapping.build(all_docids)
        if len(mapping) != num_docs:
            raise ValueError("duplicate docids in corpus")
        mapping.save(os.path.join(index_dir, fmt.DOCNOS))
        sorted_docids = np.array(mapping.docids, dtype=np.str_)
    with report.phase("vocab"):
        vocab_arr = np.array(vocab_list, dtype=np.str_)
        order = np.argsort(vocab_arr)
        rank = np.empty(len(order), np.int32)
        rank[order] = np.arange(len(order), dtype=np.int32)
        vocab = Vocab(vocab_arr[order].tolist())
        vocab.save(os.path.join(index_dir, fmt.VOCAB))
        v = len(vocab)
        report.set_counter("reduce_output_groups", v)

    doc_len = np.zeros(num_docs + 1, np.int64)
    if radix_buckets:
        # every doc's docno by its global ordinal; doc_len straight from
        # the manifest's per-doc counts (pass 2 reads no token spill)
        docno_of = (np.searchsorted(
            sorted_docids, np.array(all_docids, dtype=np.str_)) + 1
        ).astype(np.int32)
        doc_len[docno_of] = np.asarray(all_doc_lens, dtype=np.int64)

    def iter_buckets():
        """(r, term_ids, docnos, run_lens) per bucket that still needs its
        pass-2 spills; on the prefetch thread. A bucket whose spills all
        exist (and read in full) is complete. A corrupt pass-1 rpairs
        spill cannot be rebuilt without tokenizing again: one
        IntegrityError."""
        for r in range(radix_buckets):
            if resuming and _batch_pairs_done(spill_dir, r, num_shards,
                                              validate=True):
                report.incr("pass2_resumed_buckets", 1)
                continue
            terms, rdocs, rlens = [], [], []
            for b in range(n_batches):
                spill = os.path.join(spill_dir, radix_spill_name(r, b))
                try:
                    with np.load(spill) as z:
                        terms.append(z["term"])
                        rdocs.append(z["doc"])
                        rlens.append(z["len"])
                except fmt.CORRUPT_NPZ as e:
                    raise faults.IntegrityError(
                        spill, f"bucketed pair spill unreadable ({e}); "
                        "re-run the build — the restart re-tokenizes "
                        "the corpus") from e
            yield (r, rank[np.concatenate(terms)],
                   docno_of[np.concatenate(rdocs)],
                   np.concatenate(rlens).astype(np.int32))

    def iter_batches():
        """(b, term_ids, docnos, lengths) per batch that still needs its
        pair spills, filling doc_len as it walks; a complete batch loads
        only its lengths."""
        ofs = 0
        for b in range(n_batches):
            spill = os.path.join(spill_dir, f"tokens-{b:05d}.npz")
            try:
                with np.load(spill) as z:
                    lengths = z["lengths"]
                    done = resuming and _batch_pairs_done(
                        spill_dir, b, num_shards, validate=True)
                    flat = None if done else z["ids"]
            except fmt.CORRUPT_NPZ as e:
                raise faults.IntegrityError(
                    spill, f"token spill unreadable ({e}); re-run the "
                    "build — the restart re-tokenizes the corpus") from e
            docids = np.array(all_docids[ofs: ofs + len(lengths)],
                              dtype=np.str_)
            ofs += len(lengths)
            docnos = (np.searchsorted(sorted_docids, docids) + 1).astype(
                np.int32)
            doc_len[docnos] = lengths
            if done:
                report.incr("pass2_resumed_batches", 1)
                continue
            yield b, rank[flat], docnos, lengths

    use16 = v < PAD_TERM_U16

    def reduce_unit(b, term_ids, docnos, lengths):
        """One batch's or bucket's group-by on the device, its pairs
        spilled by term shard."""
        t0 = time.perf_counter()
        t_dev = torch.from_numpy(
            term_ids.astype(np.uint16 if use16 else np.int32)).to(dev)
        p = build_postings_packed(
            t_dev, torch.from_numpy(docnos.astype(np.int32)).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev),
            vocab_size=v, num_docs=num_docs)
        df_b = p.df.cpu().numpy()
        npairs = int(df_b.sum())
        tf_max = int(p.pair_tf.max()) if len(term_ids) else 0
        pd, ptf = shrink_pairs(p.pair_doc, p.pair_tf, npairs,
                               num_docs=num_docs, tf_max=tf_max)
        del p, t_dev
        pt = pair_term_from_df(df_b)
        shard = pt % num_shards
        for s in range(num_shards):
            sel = shard == s
            fmt.savez_atomic(os.path.join(spill_dir, pair_spill_name(s, b)),
                             term=pt[sel], doc=pd[sel], tf=ptf[sel])
        if radix_buckets:
            reg.observe("build.radix.bucket_pairs", float(npairs))
            reg.observe("build.radix.bucket_s", time.perf_counter() - t0)
        faults.maybe_crash("crash.pass2", f"b={b}")

    with report.phase("pass2_combine"):
        units = (prefetch_iter(iter_buckets(), name="bucket-read")
                 if radix_buckets else iter_batches())
        try:
            for unit in units:
                reduce_unit(*unit)
        finally:
            units.close()
    report.set_counter("map_output_records", int(batch_occ.sum()))

    # ---- pass 3: per-shard sort -> part files ----
    n_units = radix_buckets or n_batches
    df = np.zeros(v, np.int32)
    num_pairs_total = 0
    shard_of = fmt.shard_assignment(v, num_shards)
    offset_of_parts = np.zeros(v, np.int64) if radix_parts else None
    with report.phase("pass3_reduce"):
        for s in range(num_shards):
            part = fmt.part_path(index_dir, s)
            z = None
            if resuming and os.path.exists(part):
                # parts are written atomically after every pass-2 spill
                # exists: an existing part is this shard's output. One
                # that fails its full read is quarantined and rebuilt
                # from its spills
                try:
                    z = fmt.load_arena(part)
                    if fmt.compress.is_compressed(z):
                        z = fmt.compress.decode_shard(z)
                except fmt.CORRUPT_NPZ:
                    qpath = fmt.quarantine(index_dir, os.path.basename(part))
                    logger.warning("corrupt part file quarantined to %s; "
                                   "rebuilding shard %d from its spills",
                                   qpath, s)
                    report.incr("Fault.QUARANTINED_PARTS", 1)
                    z = None
            if z is not None:
                rdf = np.zeros(v, np.int32)
                rdf[z["term_ids"]] = z["df"]
                npairs = len(z["pair_doc"])
                if offset_of_parts is not None:
                    offset_of_parts[z["term_ids"]] = np.asarray(
                        z["indptr"][:-1], np.int64)
                report.incr("pass3_resumed_shards", 1)
            elif radix_parts:
                rdf, npairs = write_bucketed_shard(
                    spill_dir, index_dir, s, radix_buckets, v,
                    offset_of=offset_of_parts)
            else:
                rdf, npairs = reduce_shard_spills(
                    spill_dir, index_dir, s, n_units, v, shard_of)
            faults.maybe_crash("crash.pass3", f"s={s}")
            num_pairs_total += npairs
            df += rdf
    report.set_counter("num_pairs", num_pairs_total)

    with report.phase("dictionary"):
        np.save(os.path.join(index_dir, fmt.DOCLEN), doc_len.astype(np.int32))
        if offset_of_parts is not None:
            offset_of = offset_of_parts
        else:
            _, offset_of = fmt.shard_local_offsets(df, num_shards)
        fmt.write_dictionary(index_dir, vocab.terms, shard_of, offset_of)
        dict_report = JobReport("BuildIntDocVectorsForwardIndex")
        dict_report.set_counter("Dictionary.Size", v)
        dict_report.save(os.path.join(index_dir, fmt.JOBS_DIR))

    if store:
        # the store from the pass-1 text spills: no second corpus read
        from .docstore import iter_text_spill_docnos, write_docstore

        with report.phase("docstore"):
            def records():
                for b in range(n_batches):
                    yield from iter_text_spill_docnos(
                        os.path.join(spill_dir, f"text-{b:05d}.npz"),
                        sorted_docids)

            stats = write_docstore(index_dir, records(), num_docs)
            report.set_counter("docstore_raw_bytes", stats["raw_bytes"])
            report.set_counter("docstore_stored_bytes",
                               stats["stored_bytes"])

    built_chargrams = bool(compute_chargrams and chargram_ks and k == 1)
    if built_chargrams:
        with report.phase("chargrams"):
            build_chargram_artifacts(index_dir, vocab.terms, chargram_ks,
                                     device=dev)

    if not keep_spills:
        shutil.rmtree(spill_dir, ignore_errors=True)

    meta = fmt.IndexMetadata(
        num_docs=num_docs, vocab_size=v, k=k, num_shards=num_shards,
        num_pairs=num_pairs_total,
        chargram_ks=chargram_ks if built_chargrams else [],
        version=fmt.FORMAT_VERSION, has_positions=False,
        format_version=fmt.ARENA_FORMAT_VERSION)
    with report.phase("finalize"):
        meta.save_with_checksums(index_dir)
    report.record_peaks(dev)
    report.set_counter("radix_spill_bytes",
                       reg.get("build.radix.spill_bytes") - spill_bytes0)
    report.save(os.path.join(index_dir, fmt.JOBS_DIR))
    return meta
