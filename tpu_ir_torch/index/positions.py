"""Per-posting term positions (index format v2): the port's copy of
`tpu_ir/index/positions.py`.

Alongside each part file an optional ``positions-NNNNN.npz`` stores, for
every (term, doc) pair row of that shard, the ascending 0-based token
positions of the term in the document (post-analysis coordinates: the
i-th analyzed token, or the i-th k-gram window of a k > 1 index, has
position i).

Layout per shard (aligned 1:1 with the part file's pair rows):
    pos_indptr  int64 [npairs+1]  run extents per pair row
    pos_delta   int32 [sum tf]    positions, delta-encoded per run
                                  (first absolute, then gaps)

Indexes without these files keep loading; every consumer checks
``IndexMetadata.has_positions``.

Positions are built on the host from the same doc-major occurrence
stream the device group-by consumes, as in the JAX package: the
(term, doc) -> tf aggregation is the device's work, while position runs
are variable-length byte pushing whose cost is one lexsort.
"""

from __future__ import annotations

import os

import numpy as np

from . import format as fmt


def positions_name(shard: int) -> str:
    return f"positions-{shard:05d}.npz"


def build_position_runs(flat_term: np.ndarray, flat_doc: np.ndarray,
                        flat_pos: np.ndarray):
    """Occurrence stream -> position runs in global CSR pair order.

    Returns (run_term, run_doc, run_tf, pos_indptr, pos_delta) where runs
    are ordered (term asc, tf desc, doc asc) — exactly the pair order of
    ops/postings.py::build_postings, so run j describes pair row j of the
    global CSR and shard filtering aligns with the part files."""
    flat_term = np.asarray(flat_term, np.int64)
    flat_doc = np.asarray(flat_doc, np.int64)
    flat_pos = np.asarray(flat_pos, np.int64)
    # group occurrences: (term, doc) runs with ascending positions
    order = np.lexsort((flat_pos, flat_doc, flat_term))
    t, d, p = flat_term[order], flat_doc[order], flat_pos[order]
    n = len(t)
    if n == 0:
        return (np.zeros(0, np.int32),) * 3 + (
            np.zeros(1, np.int64), np.zeros(0, np.int32))
    new_run = np.empty(n, bool)
    new_run[0] = True
    new_run[1:] = (t[1:] != t[:-1]) | (d[1:] != d[:-1])
    starts = np.flatnonzero(new_run)
    run_term = t[starts]
    run_doc = d[starts]
    run_tf = np.diff(np.append(starts, n))
    # reorder runs into the device program's pair order
    run_order = np.lexsort((run_doc, -run_tf, run_term))
    # gather each run's positions in the new order
    new_starts = starts[run_order]
    new_tf = run_tf[run_order]
    out_starts = np.concatenate([[0], np.cumsum(new_tf)])
    gather = (np.repeat(new_starts, new_tf)
              + np.arange(n) - np.repeat(out_starts[:-1], new_tf))
    pos = p[gather]
    # delta-encode per run: first absolute, then gaps (positions ascend
    # strictly within a run, so every delta after the first is >= 1)
    delta = np.empty(n, np.int64)
    delta[0] = pos[0]
    delta[1:] = pos[1:] - pos[:-1]
    delta[out_starts[:-1]] = pos[out_starts[:-1]]
    return (run_term[run_order].astype(np.int32),
            run_doc[run_order].astype(np.int32),
            new_tf.astype(np.int32),
            out_starts.astype(np.int64),
            delta.astype(np.int32))


def flat_positions_from_lengths(lengths: np.ndarray) -> np.ndarray:
    """Doc-major occurrence stream -> within-doc 0-based position of each
    occurrence (the token coordinate)."""
    lengths = np.asarray(lengths, np.int64)
    n = int(lengths.sum())
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return np.arange(n) - np.repeat(starts, lengths)


def realign_runs(old_starts: np.ndarray, new_lens: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(new_indptr, gather) re-laying concatenated variable-length runs:
    `old_starts[i]` is where NEW row i's payload begins in the old flat
    array and `new_lens[i]` its length; payload[gather] lists the runs
    in the new order and new_indptr delimits them. The one CSR
    permutation behind every shard split (a selection) and part-order
    sort (a permutation) of position runs."""
    new_indptr = np.concatenate([[0], np.cumsum(new_lens)])
    gather = (np.repeat(old_starts, new_lens)
              + np.arange(int(new_lens.sum()))
              - np.repeat(new_indptr[:-1], new_lens))
    return new_indptr, gather


def split_runs_by_shard(run_term: np.ndarray, pos_indptr: np.ndarray,
                        pos_delta: np.ndarray, num_shards: int):
    """Yield (shard, indptr, delta) splitting ordered runs by
    term_id % S with the same order-preserving filter as
    fmt.write_pair_shards — so each shard's run rows align with its pair
    rows."""
    run_shard = run_term.astype(np.int64) % num_shards
    run_len = np.diff(pos_indptr)
    for s in range(num_shards):
        sel = run_shard == s
        indptr, gather = realign_runs(pos_indptr[:-1][sel], run_len[sel])
        yield s, indptr.astype(np.int64), pos_delta[gather].astype(np.int32)


def write_position_shards(index_dir: str, run_term: np.ndarray,
                          pos_indptr: np.ndarray, pos_delta: np.ndarray,
                          num_shards: int) -> None:
    """Split globally-ordered position runs into per-shard files aligned
    with the part files' pair rows."""
    for s, indptr, delta in split_runs_by_shard(
            run_term, pos_indptr, pos_delta, num_shards):
        fmt.savez_atomic(
            os.path.join(index_dir, positions_name(s)),
            pos_indptr=indptr, pos_delta=delta)


def batch_position_runs(flat_term: np.ndarray, docnos: np.ndarray,
                        lengths: np.ndarray):
    """One batch's occurrence stream -> ordered runs (streaming pass-2
    helper): returns (run_term, pos_indptr, pos_delta) in the device
    program's pair order for the batch."""
    flat_doc = np.repeat(np.asarray(docnos, np.int64),
                         np.asarray(lengths, np.int64))
    flat_pos = flat_positions_from_lengths(lengths)
    run_term, _, _, pos_indptr, pos_delta = build_position_runs(
        flat_term, flat_doc, flat_pos)
    return run_term, pos_indptr, pos_delta


def build_and_write_positions(index_dir: str, flat_term: np.ndarray,
                              docnos: np.ndarray, lengths: np.ndarray,
                              num_shards: int) -> None:
    """One-call path for the in-memory builder: doc-major occurrence
    stream (term ids + per-doc docno/length) -> per-shard position files."""
    flat_doc = np.repeat(np.asarray(docnos, np.int64),
                         np.asarray(lengths, np.int64))
    flat_pos = flat_positions_from_lengths(lengths)
    run_term, _, _, pos_indptr, pos_delta = build_position_runs(
        flat_term, flat_doc, flat_pos)
    write_position_shards(index_dir, run_term, pos_indptr, pos_delta,
                          num_shards)


class PositionsReader:
    """Random access to a term's position lists, mirroring the dictionary
    seek path (index/dictionary.py): shard + local row -> per-doc
    position arrays. Shard files load lazily and are memoized."""

    def __init__(self, index_dir: str):
        self._dir = index_dir
        self._shards: dict[int, dict[str, np.ndarray]] = {}

    def available(self) -> bool:
        return os.path.exists(os.path.join(self._dir, positions_name(0)))

    def _shard(self, s: int) -> dict[str, np.ndarray]:
        if s not in self._shards:
            with np.load(os.path.join(self._dir, positions_name(s))) as z:
                self._shards[s] = {k: z[k] for k in z.files}
        return self._shards[s]

    def run(self, shard: int, row: int) -> np.ndarray:
        """Decoded positions of ONE pair row — the proximity/phrase path's
        unit of work (O(tf) per call, never O(df))."""
        z = self._shard(shard)
        indptr = z["pos_indptr"]
        d = z["pos_delta"][indptr[row] : indptr[row + 1]]
        return np.cumsum(d, dtype=np.int64)

    def runs_concat(self, shard: int, rows: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Decoded positions for MANY pair rows in one shot: returns
        (lens int64 [n], pos int64 [sum lens]) where pos concatenates the
        rows' position lists in order. One fancy-index gather + a
        segmented cumsum over the shard arrays — the bulk path phrase
        matching scales on (no per-row Python loop)."""
        z = self._shard(shard)
        indptr = z["pos_indptr"]
        delta = z["pos_delta"]
        rows = np.asarray(rows, np.int64)
        starts = indptr[rows]
        lens = indptr[rows + 1] - starts
        total = int(lens.sum())
        if total == 0:
            return lens, np.zeros(0, np.int64)
        out_starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        gather = np.repeat(starts - out_starts, lens) + np.arange(total)
        d = delta[gather].astype(np.int64)
        c = np.cumsum(d)
        # positions within run r = cumsum of its deltas: subtract the
        # running total just before the run starts. A zero-length run at
        # the tail would put its out_starts entry at `total` (one past
        # the end): clamp, since its base is repeated 0 times (tf >= 1
        # makes every run non-empty, but arbitrary rows must not
        # IndexError)
        safe = np.minimum(out_starts, total - 1)
        base = np.repeat(c[safe] - d[safe], lens)
        return lens, c - base

    def runs_for_rows(self, shard: int, row_lo: int, row_hi: int
                      ) -> list[np.ndarray]:
        """Decoded (cumsum of deltas) position arrays for the pair rows
        [row_lo, row_hi) of `shard` — the rows of one term's postings."""
        z = self._shard(shard)
        indptr = z["pos_indptr"]
        out = []
        for r in range(row_lo, row_hi):
            d = z["pos_delta"][indptr[r] : indptr[r + 1]]
            out.append(np.cumsum(d, dtype=np.int64))
        return out
