"""Fixed log-bucket latency histograms with percentile estimation (a
copy of `tpu_ir/obs/histogram.py`).

A histogram is a fixed array of counters over power-of-two latency
buckets, so an observation is one bisect over a 39-entry tuple plus one
locked increment. The shared bucket layout (module constants) makes
histograms delta-able: two snapshots subtract bucket-wise, and a
percentile estimate is exact to within one bucket width.

Bucket i covers (BOUNDS[i-1], BOUNDS[i]] seconds; bucket 0 also takes
everything <= 1 microsecond, and the last bucket is the overflow past
~275 s.
"""

from __future__ import annotations

import bisect
import threading

BASE_S = 1e-6           # upper bound of bucket 0: 1 microsecond
NUM_BUCKETS = 40        # covers (0, ~275 s] + one overflow bucket
# upper bounds of buckets 0..NUM_BUCKETS-2; the last bucket is unbounded
BOUNDS = tuple(BASE_S * 2.0 ** i for i in range(NUM_BUCKETS - 1))


def bucket_index(seconds: float) -> int:
    """The bucket an observation lands in. Boundary values belong to the
    bucket they bound (bucket i is (BOUNDS[i-1], BOUNDS[i]]): bisect_left
    returns the first bound >= the value, which IS that bucket — exact,
    no floating log."""
    if seconds <= BASE_S:
        return 0
    i = bisect.bisect_left(BOUNDS, seconds)
    return min(i, NUM_BUCKETS - 1)


def percentile_from_counts(counts, q: float) -> float | None:
    """Estimate the q-th percentile (0..100) from a bucket-count array:
    find the bucket holding the target rank, interpolate linearly inside
    it. The true sample percentile lies in the same bucket, so the
    estimate is within one bucket width of exact (pinned by tests)."""
    total = sum(counts)
    if total == 0:
        return None
    rank = max(1, -(-int(q * total) // 100))  # ceil(q/100 * total), >= 1
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= rank:
            lo = BOUNDS[i - 1] if i > 0 else 0.0
            hi = BOUNDS[i] if i < len(BOUNDS) else BOUNDS[-1] * 2.0
            return lo + (hi - lo) * (rank - cum) / c
        cum += c
    return BOUNDS[-1] * 2.0  # unreachable unless counts mutate mid-walk


def summary_from_counts(counts, total_s: float) -> dict:
    """The JSON-facing digest of one bucket-count array: count, total
    time, and p50/p95/p99 estimates in milliseconds (None when empty)."""
    n = sum(counts)
    out = {"count": n, "sum_ms": round(total_s * 1e3, 3)}
    for q in (50, 95, 99):
        p = percentile_from_counts(counts, q)
        out[f"p{q}_ms"] = None if p is None else round(p * 1e3, 4)
    return out


class LatencyHistogram:
    """Thread-safe fixed log-bucket histogram (seconds)."""

    __slots__ = ("_lock", "_counts", "_sum_s")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * NUM_BUCKETS
        self._sum_s = 0.0

    def observe(self, seconds: float) -> None:
        i = bucket_index(seconds)
        with self._lock:
            self._counts[i] += 1
            self._sum_s += seconds

    def state(self) -> tuple[list[int], float]:
        """(bucket counts copy, total seconds): the delta unit."""
        with self._lock:
            return list(self._counts), self._sum_s

    def drain(self) -> tuple[list[int], float]:
        """Read and zero (counts, total seconds) under one lock hold: an
        observation lands in exactly one scrape interval."""
        with self._lock:
            counts, sum_s = self._counts, self._sum_s
            self._counts = [0] * NUM_BUCKETS
            self._sum_s = 0.0
            return counts, sum_s

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * NUM_BUCKETS
            self._sum_s = 0.0
