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
"""

from __future__ import annotations

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
    on the host, and copied there only where they are read-only or not
    contiguous (as loaded arena views are)."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
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
