"""The exact merges of the shard worker tier (the part of
`tpu_ir/serving/router.py` the workers' contract is held through).

Each worker (serving/shardset.py) scores the whole index restricted to a
contiguous docid range (search/layout.py::shard_doc_ranges), so a doc's
score does not depend on the partition: the global top-k is the merge of
the shards' top-k lists, and the rerank's stage 2 takes each candidate's
cosine score from the shard that owns it. The router itself (fan-out,
hedging, breakers, partial answers) is not ported yet.
"""

from __future__ import annotations


def merge_shard_topk(shard_hits, k: int) -> list:
    """The exact top-k of per-shard hit lists.

    `shard_hits`: per-shard [(docid, score), ...] lists in the shard's
    rank order (score desc, docid asc, the kernels' tie rule), ordered by
    ascending shard id. The shards are contiguous ascending docid ranges,
    so a stable sort on the score alone reproduces the single scorer's
    order, ties to the lower docid. Empty slots (docid <= 0 or score <=
    0) are dropped."""
    merged = [h for hits in shard_hits for h in hits
              if h[0] > 0 and h[1] > 0.0]
    merged.sort(key=lambda h: -h[1])  # stable
    return merged[:k]


def merge_candidate_scores(cand: list, per_shard: dict,
                           ranges: list, k: int) -> list:
    """The rerank's stage 2 across shards: each global candidate's cosine
    score comes from its owning shard's `cosine_at` answer (`per_shard`:
    shard id -> [C] scores aligned with `cand`; `ranges`: each shard's
    (lo, hi)), then the top-k in candidate order, ties to the earlier
    candidate, as the rerank in one process picks them. A candidate whose
    owner did not answer is dropped."""
    scored = []
    for pos, docid in enumerate(cand):
        if docid <= 0:
            continue
        owner = next((s for s, (lo, hi) in enumerate(ranges)
                      if lo <= docid <= hi), None)
        if owner is None or owner not in per_shard:
            continue
        scored.append((docid, per_shard[owner][pos]))
    scored.sort(key=lambda h: -h[1])
    return [(d, s) for d, s in scored[:k] if s > 0.0]
