"""Host-side construction of the tiered sparse scoring layout.

The counterpart of `tpu_ir/search/layout.py`. Past the dense-matrix budget
the index is served from two parts:

- **hot strip**: the highest-df terms become dense [H, D+1] raw-tf rows,
  with H capped by an element budget (HOT_BUDGET // (D+1));
- **df tiers**: every other term goes to a padded [V_t, P_t] tier whose
  capacity is its df rounded up to BASE_CAP * GROWTH**i, so padding wastes
  at most GROWTH x and there are log_GROWTH(max df) tiers.

The host arrays are element- and dtype-exact against the JAX package's
(slim uint16 columns included), the block-max bounds of the hot rows
(`hot_blk_max`, the largest tf per doc block of width `blockmax_width`)
with them.

The serving cache (`serving-tiered/`, at the end of this module) keeps
the layout, df and the rerank's doc norms next to the index, in the JAX
package's format, so a restart maps them instead of reading the parts.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

# dense hot-strip budget in f32 elements (~2 GB)
HOT_BUDGET = 500_000_000
# first tier capacity and geometric growth factor between tiers
BASE_CAP = 2
GROWTH = 4


def upload_index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """An integer host column on `device` as int32.

    uint16 columns cross the link at two bytes a value and are widened on
    the device (torch has few uint16 operations, so they travel as int16
    bits and are masked back to 0..65535); other columns are cast to int32
    on the host. A column is copied on the host only where it is read-only
    or not contiguous (as loaded arena views and mapped cache sections
    are)."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        a = np.require(a, None, ["C_CONTIGUOUS", "WRITEABLE"])
        t = torch.from_numpy(a.view(np.int16))
        return t.to(device).to(torch.int32) & 0xFFFF
    a = np.require(a, np.int32, ["C_CONTIGUOUS", "WRITEABLE"])
    return torch.from_numpy(a).to(device)


class TieredPostings(NamedTuple):
    """Host (numpy) arrays; the Scorer moves them to the device.

    The hot strip is carried as COO postings (hot_rows/hot_docs/hot_vals),
    not as the dense [H, D+1] matrix: `hot_device` uploads the postings
    and densifies them on the device."""

    hot_rank: np.ndarray   # int32 [V]: row in the hot strip, or -1
    hot_rows: np.ndarray   # [nnz] strip row per hot posting (uint16/int32)
    hot_docs: np.ndarray   # [nnz] docno per hot posting (uint16/int32)
    hot_vals: np.ndarray   # [nnz] raw tf per hot posting (uint16/int32)
    num_hot: int           # H >= 1 (one all-zero row when nothing is hot)
    hot_width: int         # D + 1
    tier_of: np.ndarray    # int32 [V]: tier index (-1 for hot/df=0 terms)
    row_of: np.ndarray     # int32 [V]: row within the tier (0 likewise)
    tier_docs: tuple       # each [V_t, P_t] docnos, 0 = empty slot
    tier_tfs: tuple        # each [V_t, P_t] tfs, 0 = empty slot
    hot_blk_max: np.ndarray | None = None   # int32 [H, nblk] largest tf
    blockmax_width: int = 0                 # per doc block of this width

    def hot_dense(self) -> np.ndarray:
        """The dense float32 [H, D+1] raw-tf strip on the host (tests)."""
        out = np.zeros((self.num_hot, self.hot_width), np.float32)
        out[np.asarray(self.hot_rows, np.int64),
            np.asarray(self.hot_docs, np.int64)] = self.hot_vals
        return out

    def hot_device(self, device: str | torch.device,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The dense [H, D+1] raw-tf strip, built on `device` from the COO
        postings: only the postings cross the link, not the strip. Each
        (row, doc) pair appears once, so the store is exact."""
        device = torch.device(device)
        rows = upload_index(self.hot_rows, device).long()
        docs = upload_index(self.hot_docs, device).long()
        vals = upload_index(self.hot_vals, device)
        strip = torch.zeros((self.num_hot, self.hot_width), dtype=dtype,
                            device=device)
        strip.index_put_((rows, docs), vals.to(dtype))
        return strip


def _slim(a: np.ndarray, hi: int) -> np.ndarray:
    """uint16 when every value fits, else int32 (halves transport bytes
    for strip rows, tfs and small-corpus docnos)."""
    return a.astype(np.uint16 if hi < 65536 else np.int32)


def _scatter_rows(tids: np.ndarray, indptr: np.ndarray, counts: np.ndarray):
    """Source indices for packing terms' postings into rows: returns
    (row_index, within_row, source_index) for every posting of `tids`."""
    total = int(counts.sum())
    rows = np.repeat(np.arange(len(tids), dtype=np.int64), counts)
    ends = np.cumsum(counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(ends - counts,
                                                          counts)
    src = np.repeat(indptr[tids], counts) + within
    return rows, within, src


def plan_tiers(
    df: np.ndarray,
    *,
    num_docs: int,
    hot_budget: int = HOT_BUDGET,
    base_cap: int = BASE_CAP,
    growth: int = GROWTH,
):
    """Which terms get a hot-strip row (terms above the p99 df want one;
    the element budget decides how many get one, largest dfs first), the
    geometric tier-capacity ladder, and each cold term's rung.

    Returns (hot_tids, cold_tids, caps, want): sorted hot term ids, the
    cold term ids, the capacity ladder, and `want[i]` = the ladder rung
    of cold_tids[i]."""
    d = num_docs
    nonzero_df = df[df > 0]
    pcap = max(int(np.percentile(nonzero_df, 99)) if len(nonzero_df) else 1,
               1)
    hot_tids = np.nonzero(df > pcap)[0]
    max_hot = max(int(hot_budget // (d + 1)), 1)
    if len(hot_tids) > max_hot:
        order = np.argsort(df[hot_tids], kind="stable")[::-1]
        hot_tids = np.sort(hot_tids[order[:max_hot]])
    is_hot = np.zeros(len(df), bool)
    is_hot[hot_tids] = True
    cold = np.nonzero(~is_hot & (df > 0))[0]
    caps: list[int] = []
    want = np.zeros(0, np.int64)
    if len(cold):
        caps = [base_cap]
        while caps[-1] < int(df[cold].max()):
            caps.append(caps[-1] * growth)
        want = np.searchsorted(caps, df[cold], side="left")
    return hot_tids, cold, caps, want


def build_tiered_layout(
    pair_doc: np.ndarray,
    pair_tf: np.ndarray,
    df: np.ndarray,
    *,
    num_docs: int,
    hot_budget: int = HOT_BUDGET,
    base_cap: int = BASE_CAP,
    growth: int = GROWTH,
    block_bounds: tuple | None = None,
) -> TieredPostings:
    """Build the layout from postings columns in global CSR order
    (sorted by term id, runs of length df[tid]: the Scorer.load order).

    `block_bounds` = (tids, max_tf, width) from blockmax.arena
    (index/blockmax.py). When it covers this layout's hot terms, their
    rows are sliced from it at its width; otherwise the bounds are
    computed from the postings at TPU_IR_BLOCKMAX_WIDTH, with the same
    values."""
    from ..index import blockmax as bmx

    v = len(df)
    d = num_docs
    indptr = np.concatenate([[0], np.cumsum(df, dtype=np.int64)])

    hot_tids, cold, caps, want = plan_tiers(
        df, num_docs=num_docs, hot_budget=hot_budget, base_cap=base_cap,
        growth=growth)
    hot_rank = np.full(v, -1, np.int32)
    hot_rank[hot_tids] = np.arange(len(hot_tids), dtype=np.int32)

    num_hot = max(len(hot_tids), 1)
    if len(hot_tids):
        rows, _, src = _scatter_rows(hot_tids, indptr, df[hot_tids])
        hot_rows = _slim(rows, num_hot)
        hot_docs = _slim(pair_doc[src], d + 1)
        hot_vals = _slim(pair_tf[src], int(pair_tf[src].max(initial=0)) + 1)
    else:
        hot_rows = np.zeros(0, np.uint16)
        hot_docs = np.zeros(0, np.uint16)
        hot_vals = np.zeros(0, np.uint16)

    # cold tiers: capacity = df rounded up to base_cap * growth^i.
    # tier_of = -1 for df == 0 and hot terms: a 0 default would alias them
    # onto tier 0 row 0, which BM25's nonzero idf would then score
    tier_of = np.full(v, -1, np.int32)
    row_of = np.zeros(v, np.int32)
    tier_docs: list[np.ndarray] = []
    tier_tfs: list[np.ndarray] = []
    max_tf = int(pair_tf.max(initial=0))
    if len(cold):
        for i in range(len(caps)):
            tids = cold[want == i]
            if not len(tids):
                continue  # skip empty tiers entirely
            cap = caps[i]
            docs = np.zeros((len(tids), cap), np.int32)
            tfs = np.zeros((len(tids), cap), np.int32)
            rows, within, src = _scatter_rows(tids, indptr, df[tids])
            docs[rows, within] = pair_doc[src]
            tfs[rows, within] = pair_tf[src]
            tier_of[tids] = len(tier_docs)
            row_of[tids] = np.arange(len(tids), dtype=np.int32)
            tier_docs.append(_slim(docs, d + 1))
            tier_tfs.append(_slim(tfs, max_tf + 1))
    if not tier_docs:  # every term hot (or empty): keep one dummy tier
        tier_docs.append(np.zeros((1, 1), np.int32))
        tier_tfs.append(np.zeros((1, 1), np.int32))

    width = bmx.block_width()
    hot_blk_max = None
    if block_bounds is not None and len(hot_tids):
        btids, bmax, bwidth = block_bounds
        pos = np.searchsorted(btids, hot_tids)
        if (len(btids) and pos.max(initial=0) < len(btids)
                and np.array_equal(np.asarray(btids)[pos], hot_tids)):
            hot_blk_max = np.asarray(bmax)[pos].astype(np.int32)
            width = int(bwidth)
    if hot_blk_max is None:
        if len(hot_tids):
            hot_blk_max = bmx.compute_block_max(
                hot_tids, pair_doc, pair_tf, indptr, num_docs=d,
                width=width)
        else:
            hot_blk_max = np.zeros((1, bmx.num_blocks(d, width)), np.int32)

    return TieredPostings(hot_rank, hot_rows, hot_docs, hot_vals,
                          num_hot, d + 1, tier_of, row_of,
                          tuple(tier_docs), tuple(tier_tfs),
                          hot_blk_max, width)


# ---------------------------------------------------------------------------
# the serving cache (`tpu_ir/search/layout.py:326-635`)
# ---------------------------------------------------------------------------
#
# A sparse Scorer.load that misses writes the tiered layout, df and the
# rerank's doc norms into index_dir/serving-tiered/ (one cache.arena and
# manifest.json); a later load that hits maps them and reads no part. The
# directory, the arena's sections and the manifest's keys are the JAX
# package's, so a cache written by either package is read by the other.

#: the JAX package's serving-cache version: v7 keys the part files by
#: their tagged CRC (format.file_checksum), sizes and stats, and the
#: index's serving interpretation (format version, tf dtype, lossiness,
#: each part's section dtypes)
_CACHE_VERSION = 7
CACHE_NAME = "serving-tiered"


def _part_stat(index_dir: str, meta) -> list:
    """[name, size, mtime_ns] per part file: the cheap revalidation stamp.
    Any write through the filesystem lands a new mtime_ns, so a stat match
    means the parts are the ones the key certified when the cache was
    written. Rot below the filesystem that keeps size and mtime shows only
    when the parts stream (the lazy verified pairs loader), or on every
    load with TPU_IR_CACHE_REVALIDATE=crc."""
    from ..index import format as fmt

    out = []
    for s in range(meta.num_shards):
        path = fmt.part_path(index_dir, s)
        st = os.stat(path)
        out.append([os.path.basename(path), st.st_size, st.st_mtime_ns])
    return out


def _section_signature(index_dir: str, meta) -> list:
    """Per part, its arena header's (section name, dtype) pairs ("npz" for
    a v1 part): how its bytes are decoded, which a stat or even a
    whole-file CRC of a byte-identical re-migration cannot tell. Header
    reads only."""
    from ..index import format as fmt

    out = []
    for s in range(meta.num_shards):
        path = fmt.part_path(index_dir, s)
        if path.endswith(".npz"):
            out.append([os.path.basename(path), "npz"])
            continue
        header, _ = fmt.arena_file_header(path)
        out.append([os.path.basename(path),
                    [[sec["name"], sec["dtype"]]
                     for sec in header["sections"]]])
    return out


def _serving_cache_key(index_dir: str, meta, hot_budget: int, base_cap: int,
                       growth: int, part_crcs: dict | None = None) -> dict:
    """The content-addressed key, field for field the JAX package's: each
    part's name, size and format.file_checksum digest (from `part_crcs`
    where a digest is already known, else streamed), the index counts,
    its serving interpretation and the layout parameters."""
    from ..index import format as fmt

    files = []
    for s in range(meta.num_shards):
        path = fmt.part_path(index_dir, s)
        name = os.path.basename(path)
        crc = (part_crcs or {}).get(name) or fmt.file_checksum(path)
        files.append([name, os.path.getsize(path), crc])
    return {
        "version": _CACHE_VERSION,
        "num_docs": meta.num_docs,
        "vocab_size": meta.vocab_size,
        "num_pairs": meta.num_pairs,
        "part_files": files,
        "format_version": meta.format_version,
        "tf_dtype": getattr(meta, "tf_dtype", "int32"),
        "tf_lossy": bool(getattr(meta, "tf_lossy", False)),
        "section_dtypes": _section_signature(index_dir, meta),
        "hot_budget": hot_budget,
        "base_cap": base_cap,
        "growth": growth,
    }


def serving_cache_writable(index_dir: str) -> bool:
    """Whether a cache write can succeed: on a read-only index dir the
    load skips the cache-only work (the norms pass)."""
    return os.access(index_dir, os.W_OK)


def cache_revalidate_mode() -> str:
    """TPU_IR_CACHE_REVALIDATE: 'stat' (the default: trust unchanged part
    names, sizes and mtimes) or 'crc' (stream every part's CRC and prove
    each hit). A bogus value raises: an integrity knob must not fall back
    to the weaker check."""
    from .. import envvars

    return envvars.get_choice("TPU_IR_CACHE_REVALIDATE")


def read_cache_manifest(index_dir: str, cache_name: str, key,
                        part_stat=None):
    """(manifest, section getter) when the cache's key matches, else None.

    `key` may be a callable (taking an optional {name: digest}), computed
    only when needed: when the manifest's recorded part stats equal
    `part_stat`'s, the key is rebuilt from the manifest's own digests (no
    part read) and still compared, so a change of any other key field
    misses; otherwise (or under TPU_IR_CACHE_REVALIDATE=crc) the key is
    computed by streaming every part's CRC. The sections are mapped from
    cache.arena zero-copy."""
    from ..index import format as fmt

    cache_dir = os.path.join(index_dir, cache_name)
    manifest = os.path.join(cache_dir, "manifest.json")
    if not os.path.exists(manifest):
        return None
    with open(manifest) as f:
        m = json.load(f)
    if cache_revalidate_mode() == "crc":
        part_stat = None
    stat_now = part_stat() if callable(part_stat) else part_stat
    if (callable(key) and stat_now is not None
            and m.get("part_stat") == stat_now):
        recorded = {f[0]: f[2]
                    for f in m.get("key", {}).get("part_files", [])}
        if m["key"] != key(recorded):
            return None
    elif m["key"] != (key() if callable(key) else key):
        return None
    sections = fmt.load_arena(os.path.join(cache_dir, "cache.arena"),
                              mmap=True)
    return m, sections.__getitem__


def write_cache_atomic(index_dir: str, cache_name: str, arrays: dict,
                       manifest) -> None:
    """Write cache.arena and manifest.json into a temp dir and rename it
    into place. Any OSError (the key's part reads included, when
    `manifest` is a callable) leaves no cache, never an exception."""
    import shutil
    import tempfile

    from ..index import format as fmt

    cache_dir = os.path.join(index_dir, cache_name)
    tmp = None
    try:
        if callable(manifest):
            manifest = manifest()
        tmp = tempfile.mkdtemp(dir=index_dir, prefix=f".{cache_name}-")
        fmt.write_arena(os.path.join(tmp, "cache.arena"),
                        {n: np.asarray(a) for n, a in arrays.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(cache_dir, ignore_errors=True)
        os.replace(tmp, cache_dir)
    except OSError:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def load_serving_cache(index_dir: str, *, meta, hot_budget: int = HOT_BUDGET,
                       base_cap: int = BASE_CAP, growth: int = GROWTH):
    """A cache hit: (TieredPostings, df, doc_norms), every array mapped
    from the one arena with no part read; None on a miss or an unreadable
    cache (the caller then builds the layout from the parts)."""
    cache_revalidate_mode()  # a bogus knob raises here, not into except
    try:
        hit = read_cache_manifest(
            index_dir, CACHE_NAME,
            lambda part_crcs=None: _serving_cache_key(
                index_dir, meta, hot_budget, base_cap, growth,
                part_crcs=part_crcs),
            part_stat=lambda: _part_stat(index_dir, meta))
        if hit is None:
            return None
        m, arr = hit
        tiers = TieredPostings(
            arr("hot_rank"), arr("hot_rows"), arr("hot_docs"),
            arr("hot_vals"), m["num_hot"], m["hot_width"],
            arr("tier_of"), arr("row_of"),
            tuple(arr(f"tier_docs_{i}") for i in range(m["num_tiers"])),
            tuple(arr(f"tier_tfs_{i}") for i in range(m["num_tiers"])),
            arr("hot_blk_max"), m["blockmax_width"])
        return tiers, arr("df"), arr("doc_norms")
    except (OSError, KeyError, ValueError):
        return None


def save_serving_cache(index_dir: str, tiers: TieredPostings, df: np.ndarray,
                       doc_norms: np.ndarray, *, meta,
                       hot_budget: int = HOT_BUDGET,
                       base_cap: int = BASE_CAP,
                       growth: int = GROWTH) -> None:
    """Write the serving arrays to index_dir/serving-tiered/; the key
    reuses the metadata's recorded part digests where it has them."""
    arrays = {
        "hot_rank": tiers.hot_rank, "hot_rows": tiers.hot_rows,
        "hot_docs": tiers.hot_docs, "hot_vals": tiers.hot_vals,
        "tier_of": tiers.tier_of, "row_of": tiers.row_of,
        "df": np.asarray(df, np.int32),
        "doc_norms": np.asarray(doc_norms, np.float32),
        # an all-zero [1, 1] row when the layout has no hot term
        "hot_blk_max": np.asarray(
            tiers.hot_blk_max if tiers.hot_blk_max is not None
            else np.zeros((1, 1), np.int32), np.int32),
    }
    for i, (d, t) in enumerate(zip(tiers.tier_docs, tiers.tier_tfs)):
        arrays[f"tier_docs_{i}"] = d
        arrays[f"tier_tfs_{i}"] = t
    write_cache_atomic(
        index_dir, CACHE_NAME, arrays,
        lambda: {"key": _serving_cache_key(
                     index_dir, meta, hot_budget, base_cap, growth,
                     part_crcs=getattr(meta, "checksums", None)),
                 "part_stat": _part_stat(index_dir, meta),
                 "num_tiers": len(tiers.tier_docs),
                 "num_hot": tiers.num_hot,
                 "hot_width": tiers.hot_width,
                 "blockmax_width": int(tiers.blockmax_width)})
