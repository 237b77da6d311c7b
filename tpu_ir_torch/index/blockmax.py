"""Block-max score bounds: per hot term and doc block, the largest raw tf.

The counterpart of `tpu_ir/index/blockmax.py`, byte for byte the same
artifact. The doc axis is cut into blocks of a fixed width, and for every
term the tiered layout puts in its hot strip (search/layout.plan_tiers)
the largest tf inside each block goes into one arena side file,
`blockmax.arena`. Both scoring models weight a posting by a function that
grows with tf, so the block's largest tf bounds its score; the scorer
turns it into each model's per-block bound at load (search/scorer.py).

Every build and migration writes the artifact through one hook in
IndexMetadata.save_with_checksums; `migrate-index --add-bounds` writes it
for an existing index in place. A missing or corrupt artifact never stops
an index from serving: the layout then computes the bounds from the
postings, with the same values. `bounds_report` is doctor's view of the
artifact's health.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from . import format as fmt

logger = logging.getLogger(__name__)

#: the bounds side artifact (one arena v2 file, integrity-checksummed)
BLOCKMAX_ARENA = "blockmax.arena"

#: blockmax.arena schema version (the `info` section's first slot)
BLOCKMAX_VERSION = 1


def block_width() -> int:
    """Doc-axis block width (TPU_IR_BLOCKMAX_WIDTH, default 512, at least
    64). An artifact records the width it was written at, and a reader
    takes that one."""
    from .. import envvars

    return envvars.get_int("TPU_IR_BLOCKMAX_WIDTH")


def num_blocks(num_docs: int, width: int) -> int:
    """Blocks covering the [0, num_docs] doc axis (slot 0 included: the
    dead column lies in block 0)."""
    return -(-(num_docs + 1) // width)


def hot_candidate_tids(df: np.ndarray, num_docs: int) -> np.ndarray:
    """The terms whose bounds serving reads: exactly the hot strip's terms,
    from the same plan_tiers the layout calls."""
    from ..search.layout import plan_tiers

    hot_tids, _, _, _ = plan_tiers(np.asarray(df), num_docs=num_docs)
    return np.asarray(hot_tids, np.int64)


def term_block_max(pair_doc: np.ndarray, pair_tf: np.ndarray,
                   *, num_docs: int, width: int) -> np.ndarray:
    """int32 [nblk] largest tf per doc block of ONE term's postings."""
    out = np.zeros(num_blocks(num_docs, width), np.int32)
    blk = np.asarray(pair_doc, np.int64) // width
    np.maximum.at(out, blk, np.asarray(pair_tf, np.int64))
    return out


def compute_block_max(tids, pair_doc, pair_tf, indptr, *, num_docs: int,
                      width: int) -> np.ndarray:
    """int32 [len(tids), nblk] largest tf per doc block of the given
    terms, from postings columns in global CSR order (`indptr`: each
    term's run start)."""
    nblk = num_blocks(num_docs, width)
    out = np.zeros((len(tids), nblk), np.int32)
    if not len(tids):
        return out
    tids = np.asarray(tids, np.int64)
    indptr = np.asarray(indptr)
    counts = (indptr[tids + 1] - indptr[tids]).astype(np.int64)
    rows = np.repeat(np.arange(len(tids), dtype=np.int64), counts)
    ends = np.cumsum(counts)
    within = np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(
        ends - counts, counts)
    src = np.repeat(indptr[tids], counts) + within
    blk = np.asarray(pair_doc)[src].astype(np.int64) // width
    np.maximum.at(out, (rows, blk), np.asarray(pair_tf)[src])
    return out


def coo_block_max(rows, docs, vals, *, num_rows: int, num_docs: int,
                  width: int) -> np.ndarray:
    """int32 [num_rows, nblk] largest tf per doc block from the hot strip's
    COO postings (layout.TieredPostings hot_rows/hot_docs/hot_vals): the
    values compute_block_max gives for the same postings."""
    out = np.zeros((num_rows, num_blocks(num_docs, width)), np.int32)
    if len(np.asarray(docs)):
        blk = np.asarray(docs, np.int64) // width
        np.maximum.at(out, (np.asarray(rows, np.int64), blk),
                      np.asarray(vals, np.int64))
    return out


def _iter_shards(index_dir: str, meta, verify: bool):
    """Each part's five raw arrays in turn: verify-while-read (the
    --add-bounds backfill must not turn damaged parts into bounds), or
    mapped without a check (the finalize hook reads what the build just
    wrote). Compressed parts are decoded."""
    for s in range(meta.num_shards):
        if verify:
            yield fmt.load_shard_verified(index_dir, s, meta)
        else:
            yield fmt.load_shard(index_dir, s, decode=True)


def write_block_bounds(index_dir: str, meta, *, verify: bool = False,
                       df=None, pair_doc=None, pair_tf=None) -> dict:
    """Compute `blockmax.arena` for the index at `index_dir` and write it
    atomically, reading one part at a time (no global CSR columns), or
    from the global columns when the caller passes them. Identical
    postings give identical bytes.

    Sections: `tids` int64 [T] covered term ids (ascending), `max_tf`
    int32 [T, nblk], `info` int64 [version, width, nblk, num_docs]."""
    width = block_width()
    nblk = num_blocks(meta.num_docs, width)
    if pair_doc is not None and df is not None:
        df = np.asarray(df)
        tids = hot_candidate_tids(df, meta.num_docs)
        indptr = np.concatenate([[0], np.cumsum(df, dtype=np.int64)])
        max_tf = compute_block_max(tids, pair_doc, pair_tf, indptr,
                                   num_docs=meta.num_docs, width=width)
    else:
        tids, max_tf, _ = _sharded_bounds(index_dir, meta, width,
                                          verify=verify)
    info = np.array([BLOCKMAX_VERSION, width, nblk, meta.num_docs],
                    np.int64)
    fmt.write_arena_atomic(
        os.path.join(index_dir, BLOCKMAX_ARENA),
        tids=np.asarray(tids, np.int64), max_tf=max_tf.astype(np.int32),
        info=info)
    return {"terms": int(len(tids)), "width": width, "blocks": int(nblk)}


def _sharded_bounds(index_dir: str, meta, width: int, *,
                    verify: bool = False, want_tids=None):
    """(tids, max_tf [T, nblk], df) part by part. Pass 1 gathers the
    global dfs to pick the hot set (unless `want_tids` fixes it); pass 2
    takes the block maxima of the covered terms' runs in each part, whose
    pair_doc holds global docnos."""
    df = np.zeros(meta.vocab_size, np.int64)
    for z in _iter_shards(index_dir, meta, verify):
        df[np.asarray(z["term_ids"])] = np.asarray(z["df"])
        del z
    tids = (np.asarray(want_tids, np.int64) if want_tids is not None
            else hot_candidate_tids(df, meta.num_docs))
    max_tf = np.zeros((len(tids), num_blocks(meta.num_docs, width)),
                      np.int32)
    for z in (_iter_shards(index_dir, meta, verify) if len(tids) else ()):
        stids = np.asarray(z["term_ids"], np.int64)
        pos = np.searchsorted(tids, stids)
        pos_c = np.minimum(pos, len(tids) - 1)
        covered = np.nonzero(tids[pos_c] == stids)[0]
        if not len(covered):
            continue
        local = compute_block_max(
            covered, np.asarray(z["pair_doc"]), np.asarray(z["pair_tf"]),
            np.asarray(z["indptr"]), num_docs=meta.num_docs, width=width)
        # a term's postings may span parts: fold with max
        np.maximum.at(max_tf, pos_c[covered], local.astype(np.int32))
    return tids, max_tf, df


def ensure_block_bounds(index_dir: str, meta, **pairs) -> None:
    """The save_with_checksums hook: (re)write the bounds before the
    checksum pass records them. An index with no postings gets an empty
    artifact. A failure here only logs: an index without bounds serves
    the same results (the layout computes them from the postings)."""
    try:
        write_block_bounds(index_dir, meta, **pairs)
    except Exception as e:  # noqa: BLE001 — derived data, never fatal
        logger.warning("block-max bounds not written for %s (%s); serving "
                       "computes them at load — backfill with "
                       "`migrate-index --add-bounds`", index_dir, e)


def load_block_bounds(index_dir: str, meta=None, *,
                      quarantine_corrupt: bool = False):
    """(tids [T], max_tf [T, nblk], width) from blockmax.arena, or None
    when there is none. The file is checked against its recorded checksum
    and its section CRCs. A corrupt artifact raises IntegrityError, or,
    with `quarantine_corrupt` (the serving load), is moved into
    .quarantine/ and None is returned: the layout then computes the
    bounds from the postings."""
    path = os.path.join(index_dir, BLOCKMAX_ARENA)
    if not os.path.exists(path):
        return None
    try:
        want = (meta.checksums or {}).get(BLOCKMAX_ARENA) if meta else None
        if want is not None:
            got = fmt.file_checksum(path)
            if got != want:
                raise fmt.IntegrityError(
                    path, f"checksum mismatch (recorded {want}, found "
                    f"{got}); the bounds artifact is corrupt")
        sections = fmt.load_arena(path)
        info = sections["info"]
        if int(info[0]) > BLOCKMAX_VERSION:
            raise fmt.IntegrityError(
                path, f"bounds schema v{int(info[0])} is newer than this "
                f"reader (v{BLOCKMAX_VERSION})")
        return (np.asarray(sections["tids"]),
                np.asarray(sections["max_tf"]), int(info[1]))
    except (fmt.IntegrityError, OSError, ValueError, KeyError,
            IndexError) as e:
        if not quarantine_corrupt:
            raise
        logger.warning("quarantining corrupt bounds artifact %s (%s); "
                       "serving computes the bounds from the postings",
                       path, e)
        fmt.quarantine(index_dir, BLOCKMAX_ARENA)
        return None


def bounds_report(index_dir: str, meta) -> dict:
    """doctor's block-bound section (`tpu_ir/index/blockmax.py::
    bounds_report`): presence, staleness (the stored term set against the
    hot set the current dfs promote), exactness and tightness (the stored
    bound against the actual per-block max), and the expected share of
    block lanes a threshold at a bound-weight percentile would mask."""
    try:
        stored = load_block_bounds(index_dir, meta)
    except (fmt.IntegrityError, *fmt.CORRUPT_NPZ) as e:
        return {"present": True, "ok": False, "error": str(e)}
    if stored is None:
        return {"present": False,
                "hint": "backfill with `tpu-ir migrate-index "
                        "--add-bounds`"}
    tids, max_tf, width = stored
    _, actual, df = _sharded_bounds(index_dir, meta, int(width),
                                    want_tids=tids)
    want_tids = hot_candidate_tids(df, meta.num_docs)
    stale = not np.array_equal(np.asarray(tids), want_tids)
    out = {
        "present": True, "ok": not stale, "stale": stale,
        "terms": int(len(tids)), "width": int(width),
        "blocks": int(max_tf.shape[1]) if max_tf.ndim == 2 else 0,
    }
    if stale:
        out["hint"] = ("stored bounds cover a different hot-term set "
                       "than the current dfs promote — re-run "
                       "`tpu-ir migrate-index --add-bounds`")
        return out
    if len(tids):
        occupied = actual > 0
        exact = bool(np.array_equal(max_tf, actual))
        out["bounds_exact"] = exact
        if not exact:
            out["ok"] = False
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.where(occupied, max_tf / np.maximum(actual, 1),
                                 np.nan)
            out["tightness"] = {
                "p50": float(np.nanpercentile(ratio, 50)),
                "p99": float(np.nanpercentile(ratio, 99)),
            }
            out["hint"] = ("stored bounds diverge from the postings — "
                           "the artifact is stale; re-run "
                           "`tpu-ir migrate-index --add-bounds`")
        # a block lane is maskable at threshold t when its bound weight
        # (1 + ln max_tf) is below t: the share of occupied lanes under
        # each weight percentile
        w = np.where(occupied, 1.0 + np.log(np.maximum(max_tf, 1)), 0.0)
        occ_w = w[occupied]
        out["block_occupancy"] = round(float(occupied.mean()), 4)
        if len(occ_w):
            out["expected_skip_fraction"] = {
                f"p{q}": round(float((occ_w < np.percentile(occ_w, q))
                                     .mean()), 4)
                for q in (50, 90, 99)}
    return out
