"""Traffic models for the soaks and `serve-bench` (the port of
`tpu_ir/serving/workload.py`).

The uniform workload (soak.make_queries' own draw) has the one shape real
traffic never has. Query logs are Zipf-distributed (a few head queries
take most of the volume; web logs measure exponents around 0.7-1.2) and
arrive in diurnal waves. A `Workload` models both, from a seed:

- **query popularity**: each request draws a query rank from a Zipf(s)
  law over a large query universe (s = 0 is the uniform control: over
  100,000 queries a repeat is rare). A rank always makes the same
  request (text, scoring, rerank), so a repeated rank is a repeated
  request, what the exact-hit cache lives on.
- **terms**: each query's terms are drawn over the index's vocabulary
  ranked by document frequency, term rank r with weight 1/r^s, so head
  queries use head terms.
- **length**: 1-3 terms a query, as in the uniform soak.
- **mix**: the uniform soak's TF-IDF/BM25 split and ~25% reranks.
- **bursts** (optional): `pacing_scale(frac)` stretches or shrinks the
  arrival pacing along a sinusoid over the run; amplitude b makes the
  peak's arrivals ~(1+b)x denser than the trough's.

One seed gives one query list and one arrival schedule, so a soak
replays. Each draw inverts a cumulative weight table with one
`random.Random` float (no numpy generator state), so the same seed on
the same index gives `tpu_ir`'s queries in `tpu_ir`'s order.
"""

from __future__ import annotations

import math
import random
from bisect import bisect_left

import numpy as np

# the uniform soak's mix (soak.make_queries), so a Zipf run differs from
# a uniform one only in its term draw and its arrivals
SCORINGS = ("tfidf", "bm25")
RERANK_CHOICES = (None, None, None, 25)
BURST_CYCLES = 2.0  # diurnal periods across one soak run


class Workload:
    """One seeded traffic model over a fixed term universe.

    `terms` are ranked most popular first (df descending in
    from_scorer); `skew` is the Zipf exponent s (0: uniform), `burst`
    the diurnal amplitude (0: flat arrivals)."""

    # distinct queries the popularity draw ranges over: enough that the
    # s = 0 control barely repeats, few enough that its table builds in
    # microseconds
    UNIVERSE = 100_000

    def __init__(self, terms, *, skew: float = 0.0, seed: int = 0,
                 burst: float = 0.0, lengths=(1, 3), k: int = 10,
                 universe: int | None = None):
        self.terms = list(terms)
        if not self.terms:
            raise ValueError("workload needs a non-empty term universe")
        self.skew = float(skew)
        self.seed = int(seed)
        self.burst = float(burst)
        self.lengths = (int(lengths[0]), int(lengths[1]))
        self.k = int(k)
        self.universe = int(universe or self.UNIVERSE)
        # cumulative 1/r^s weights, one table over term ranks and one over
        # query ranks (the same exponent); s = 0 is the uniform draw
        self._term_cum, self._term_total = self._zipf_cdf(
            len(self.terms))
        self._rank_cum, self._rank_total = self._zipf_cdf(self.universe)
        self._rank_cache: dict[int, dict] = {}

    def _zipf_cdf(self, n: int) -> tuple[list, float]:
        ranks = np.arange(1, n + 1, dtype=np.float64)
        cum = np.cumsum(ranks ** (-self.skew))
        return cum.tolist(), float(cum[-1])

    @classmethod
    def from_scorer(cls, scorer, *, kind: str | None = None,
                    skew: float | None = None, seed: int = 0,
                    burst: float | None = None) -> "Workload | None":
        """The model over a loaded scorer's vocabulary ranked by df
        descending (a stable sort: ties keep vocabulary order). `kind`,
        `skew` and `burst` default to TPU_IR_WORKLOAD*; the uniform kind
        returns None, and the caller draws the uniform soak's queries."""
        from .. import envvars

        kind = kind or envvars.get_choice("TPU_IR_WORKLOAD")
        if kind == "uniform":
            return None
        if skew is None:
            skew = envvars.get_float("TPU_IR_WORKLOAD_SKEW")
        if burst is None:
            burst = envvars.get_float("TPU_IR_WORKLOAD_BURST")
        terms = list(scorer.vocab.terms)
        if not terms:
            raise ValueError("scorer has an empty vocabulary")
        df = _df_ranking(scorer, len(terms))
        if df is not None:
            order = np.argsort(-df, kind="stable")
            terms = [terms[int(i)] for i in order]
        return cls(terms, skew=skew, seed=seed, burst=burst)

    # -- the draw ----------------------------------------------------------

    def draw_term(self, rng: random.Random) -> str:
        i = bisect_left(self._term_cum, rng.random() * self._term_total)
        return self.terms[min(i, len(self.terms) - 1)]

    def draw_rank(self, rng: random.Random) -> int:
        """One query-popularity rank (0-based) from the Zipf(s) law over
        the query universe."""
        i = bisect_left(self._rank_cum, rng.random() * self._rank_total)
        return min(i, self.universe - 1)

    def query_for_rank(self, rank: int) -> dict:
        """The request rank `rank` always makes: a generator seeded from
        the rank draws its length, terms, scoring and rerank, so a
        repeated rank repeats the request exactly."""
        cached = self._rank_cache.get(rank)
        if cached is not None:
            return dict(cached)
        rng = random.Random((self.seed + 1) * 0x9E3779B1 + rank)
        lo, hi = self.lengths
        req = {
            "text": " ".join(self.draw_term(rng)
                             for _ in range(rng.randint(lo, hi))),
            "scoring": rng.choice(SCORINGS),
            "rerank": rng.choice(RERANK_CHOICES),
            "k": self.k,
        }
        if len(self._rank_cache) < 4096:  # head ranks; bounded
            self._rank_cache[rank] = req
        return dict(req)

    def make_queries(self, n: int, seed: int | None = None) -> list[dict]:
        """The soak's request list, in soak.make_queries' dict shape
        (text, scoring, rerank, k): each one the request of a Zipf-drawn
        query rank."""
        rng = random.Random(self.seed if seed is None else seed)
        return [self.query_for_rank(self.draw_rank(rng))
                for _ in range(int(n))]

    # -- the arrival schedule ----------------------------------------------

    def pacing_scale(self, frac: float) -> float:
        """The factor on the soak's pacing for the request at completed
        fraction `frac` of the run: 1.0 with burst = 0, else a sinusoid
        over BURST_CYCLES periods whose trough paces ~(1+burst)x slower
        than its peak, normalized so the mean pacing stays near the flat
        schedule's."""
        if self.burst <= 0.0:
            return 1.0
        # starts at the trough (wave(0) = 0): the run opens calm and rises
        # into its first crest at frac (k + 1/2) / C
        wave = 0.5 - 0.5 * math.cos(2.0 * math.pi * BURST_CYCLES
                                    * float(frac))
        return (1.0 + self.burst * (1.0 - wave)) / (1.0 + self.burst / 2.0)

    def is_peak(self, frac: float) -> bool:
        """Whether the request at fraction `frac` falls in a peak (arrivals
        denser than the flat schedule's); always False without bursts."""
        return self.burst > 0.0 and self.pacing_scale(frac) < 1.0

    def describe(self) -> dict:
        return {"kind": "zipf", "skew": self.skew, "seed": self.seed,
                "burst": self.burst, "terms": len(self.terms),
                "universe": self.universe,
                "lengths": list(self.lengths)}


def _df_ranking(scorer, vocab_size: int) -> np.ndarray | None:
    """The df vector the ranking sorts by: the scorer's host copy (or its
    device df, fetched) when it covers the vocabulary, else None
    (vocabulary order)."""
    df = getattr(scorer, "_df_host", None)
    if df is None:
        df = getattr(scorer, "df", None)
        if df is None:
            return None
        if hasattr(df, "detach"):
            df = df.detach().cpu().numpy()
    host = np.asarray(df).reshape(-1)
    if len(host) < vocab_size:
        return None
    return host[:vocab_size].astype(np.int64)


def resolve_workload(scorer, workload, *, seed: int = 0):
    """A soak's `workload` argument as a Workload or None (uniform): None
    defers to TPU_IR_WORKLOAD*, "uniform" or "zipf" builds from the
    scorer (skew and burst from the environment), a dict ({"kind",
    "skew", "burst"}, serve-bench's per-skew runs) builds with those,
    and a Workload passes through."""
    if workload is None or isinstance(workload, str):
        return Workload.from_scorer(scorer, kind=workload, seed=seed)
    if isinstance(workload, dict):
        return Workload.from_scorer(scorer, seed=seed, **workload)
    return workload
