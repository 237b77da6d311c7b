"""Artifact inspection: `inspect` on any file the framework writes (the
port's copy of `tpu_ir/index/artifacts.py`, line for line the same
output).

The reference's ReadSequenceFile dumps any SequenceFile, whatever it
holds; here every artifact has a dump: the known shapes (part shards in
any format, position shards, build spills, pass-1 manifests, serving
caches, the document store) each get their own rendering, and any other
npz, arena or npy a named-array listing. Index directories keep their
dictionary-aware dump in cli.cmd_inspect.
"""

from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

from .format import ARENA_SUFFIXES, load_arena
from .format import CORRUPT_NPZ as _CORRUPT_NPZ

_HEAD = 8  # values shown per array in the fallback listing


def _head(a: np.ndarray, n: int = _HEAD) -> str:
    flat = np.asarray(a).reshape(-1)
    vals = flat[:n].tolist()
    suffix = " ..." if flat.size > n else ""
    return f"{vals}{suffix}"


def _array_lines(z, names, n: int) -> Iterator[str]:
    for name in names:
        a = z[name]
        yield f"{name}\t{a.dtype}\t{a.shape}\thead={_head(a)}"


def _decode_runs(indptr: np.ndarray, delta: np.ndarray, lo: int, hi: int):
    for r in range(lo, min(hi, len(indptr) - 1)):
        d = delta[indptr[r] : indptr[r + 1]]
        yield r, np.cumsum(d, dtype=np.int64).tolist()


def _inspect_npz(path: str, n: int) -> Iterator[str]:
    base = os.path.basename(path)
    try:
        yield from _inspect_npz_inner(path, base, n)
    except _CORRUPT_NPZ as e:
        # a truncated/bit-rotted npz (e.g. a quarantined part file being
        # post-mortemed) gets a clean diagnosis, not a zipfile traceback
        yield (f"{base}: CORRUPT npz ({type(e).__name__}: {e}) — "
               f"size={os.path.getsize(path)} bytes; if this is a part "
               "file, re-run the build to rebuild the shard from spills")


class _ArenaView:
    """The minimal np.load-result surface (.files + mapping access) over
    an arena's sections, so the shape-specialized dumps below serve both
    formats through one code path."""

    def __init__(self, sections: dict[str, np.ndarray]):
        self._sections = sections
        self.files = list(sections)

    def __getitem__(self, name: str) -> np.ndarray:
        return self._sections[name]


def _inspect_arena(path: str, n: int) -> Iterator[str]:
    base = os.path.basename(path)
    try:
        # eager verified read: per-section CRCs checked, same
        # read-fully-implies-intact contract the inspect dump certifies
        # for npz; the shape-specialized renderings below are shared, so
        # a part shard dumps identically whichever format holds it
        z = _ArenaView(load_arena(path))
        yield from _dump_known_shapes(z, base, n)
    except _CORRUPT_NPZ as e:
        yield (f"{base}: CORRUPT arena ({type(e).__name__}: {e}) — "
               f"size={os.path.getsize(path)} bytes; if this is a part "
               "file, re-run the build (or restore/migrate) to rebuild "
               "the shard")


def _inspect_npz_inner(path: str, base: str, n: int) -> Iterator[str]:
    with np.load(path, allow_pickle=False) as z:
        yield from _dump_known_shapes(z, base, n)


def _dump_known_shapes(z, base: str, n: int) -> Iterator[str]:
    names = list(z.files)
    have = set(names)

    if {"pos_indptr", "pos_delta"} <= have:
        # positions-NNNNN.npz shard, pos-SSS-BBBBB.npz streaming
        # spill, or pos-RRR-bBBBBB-pPPP.npz multi-host shared spill
        indptr, delta = z["pos_indptr"], z["pos_delta"]
        nruns = len(indptr) - 1
        yield (f"{base}: position runs\truns={nruns}"
               f"\tpositions={len(delta)}")
        keyed = {"term", "doc", "tf"} <= have
        for r, pos in _decode_runs(indptr, delta, 0, n):
            key = (f"term={int(z['term'][r])}\tdoc={int(z['doc'][r])}"
                   f"\ttf={int(z['tf'][r])}\t" if keyed else "")
            yield f"run {r}\t{key}{pos}"
        return

    if {"term", "doc", "tf"} <= have:
        # pairs-SSS-BBBBB.npz build spill (one term shard, one batch)
        yield (f"{base}: pair spill\tpairs={len(z['term'])}")
        triples = list(zip(z["term"][:n].tolist(),
                           z["doc"][:n].tolist(),
                           z["tf"][:n].tolist()))
        for t, d, w in triples:
            yield f"term={t}\tdoc={d}\ttf={w}"
        return

    if {"ids", "lengths"} <= have:
        # tokens-NNNNN.npz pass-1 spill (temp-id occurrence stream)
        lengths = z["lengths"]
        yield (f"{base}: token spill\tdocs={len(lengths)}"
               f"\toccurrences={len(z['ids'])}")
        yield f"lengths\thead={_head(lengths, n)}"
        yield f"ids\thead={_head(z['ids'], n)}"
        return

    if {"sig", "docids", "n_batches"} <= have:
        # pass1.npz crash-resume manifest (streaming / multi-host)
        yield (f"{base}: pass-1 manifest\tdocs={len(z['docids'])}"
               f"\tvocab={len(z['vocab'])}"
               f"\tn_batches={int(z['n_batches'])}")
        yield f"batch_occ\thead={_head(z['batch_occ'], n)}"
        for part in z["sig"].tolist():
            yield f"sig\t{part}"
        return

    if {"term_ids", "indptr", "pair_doc", "pair_tf", "df"} <= have:
        # part-NNNNN.npz shard outside an index dir (no vocab at
        # hand, so terms print as ids)
        tids = z["term_ids"]
        yield f"{base}: postings shard\tterms={len(tids)}" \
              f"\tpairs={len(z['pair_doc'])}"
        for i, tid in enumerate(tids[:n].tolist()):
            lo, hi = int(z["indptr"][i]), int(z["indptr"][i + 1])
            posts = list(zip(z["pair_doc"][lo:hi][:n].tolist(),
                             z["pair_tf"][lo:hi][:n].tolist()))
            yield f"term_id={tid}\tdf={int(z['df'][i])}\t{posts}"
        return

    # anything else: named-array listing (the generic dump)
    kind = "arena" if isinstance(z, _ArenaView) else "npz"
    yield f"{base}: {kind}\tarrays={len(names)}"
    yield from _array_lines(z, names, n)


def _inspect_serving_cache(path: str, n: int) -> Iterator[str]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    yield f"{os.path.basename(path)}: serving cache\t{json.dumps(manifest)}"
    arena = os.path.join(path, "cache.arena")
    if os.path.exists(arena):
        # every array is a section of one mapped arena
        for name, a in load_arena(arena, mmap=True).items():
            yield f"cache.arena/{name}\t{a.dtype}\t{a.shape}\thead={_head(a)}"


def inspect_path(path: str, n: int = 10) -> Iterator[str]:
    """Yield a human-readable dump of any framework artifact: file
    (npz/npy/json/tsv/txt) or non-index directory (serving cache, spill
    dir). Index DIRECTORIES keep their richer dictionary-aware dump in
    cli.cmd_inspect; this is everything else."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "manifest.json")):
            yield from _inspect_serving_cache(path, n)
            return
        # spill dir / unknown dir: per-entry one-liners
        entries = sorted(os.listdir(path))
        yield f"{os.path.basename(path) or path}: directory\tentries={len(entries)}"
        for name in entries:
            p = os.path.join(path, name)
            size = os.path.getsize(p) if os.path.isfile(p) else "-"
            yield f"{name}\t{size}"
        return
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if os.path.basename(path) == "docstore.bin":
        # compressed doc-text store: summarize via the sibling index and
        # show the first docs' stored text (index/docstore.py)
        index_dir = os.path.dirname(path) or "."
        from .docstore import DocStore

        try:
            store = DocStore(index_dir)
        except ValueError as e:
            # missing idx sidecar / bin-idx mismatch: report, don't
            # traceback
            yield f"docstore.bin: unreadable — {e}"
            return
        ndocs = len(store._lengths)
        yield (f"docstore.bin: document store\tdocs={ndocs}"
               f"\tblocks={len(store._block_starts) - 1}"
               f"\tbytes={os.path.getsize(path)}")
        for docno in range(1, min(n, ndocs) + 1):
            text = store.get(docno).replace("\n", " ")
            yield f"docno {docno}\t{text[:120]}"
        store.close()
        return
    if path.endswith(".npz"):
        yield from _inspect_npz(path, n)
    elif path.endswith(ARENA_SUFFIXES):
        yield from _inspect_arena(path, n)
    elif path.endswith(".npy"):
        a = np.load(path, mmap_mode="r")
        yield (f"{os.path.basename(path)}: npy\t{a.dtype}\t{a.shape}"
               f"\thead={_head(a, n)}")
    elif path.endswith(".json"):
        with open(path) as f:
            yield json.dumps(json.load(f))
    else:
        # tsv/txt side artifacts (dictionary, vocab, docnos): first n lines
        with open(path, errors="replace") as f:
            for i, line in enumerate(f):
                if i >= n:
                    yield "..."
                    break
                yield line.rstrip("\n")
