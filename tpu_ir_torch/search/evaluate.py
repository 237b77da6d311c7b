"""Run-file evaluation: MAP, MRR, NDCG@10, P@5, P@10 and recall@100 from
a trec_eval-format run and qrels (the port's copy of
`tpu_ir/search/evaluate.py`).

`tpu-ir-torch search --topics T --trec-run tag > run.txt`, then
`tpu-ir-torch eval run.txt qrels.txt`, needs no trec_eval install.

Formats:
- run:   `qid Q0 docid rank score tag` (rank-ordered per qid)
- qrels: `qid 0 docid rel` (rel > 0 is relevant; graded rels feed NDCG)
"""

from __future__ import annotations

import math
from collections import defaultdict


def read_run(path: str) -> dict[str, list[str]]:
    """qid -> docids in rank order. Lines that do not parse are skipped;
    the rank column orders each qid's docids."""
    per: dict[str, list[tuple[int, str]]] = defaultdict(list)
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue
            qid, docid, rank = parts[0], parts[2], parts[3]
            try:
                per[qid].append((int(rank), docid))
            except ValueError:
                continue
    return {q: [d for _, d in sorted(rows)] for q, rows in per.items()}


def read_qrels(path: str) -> dict[str, dict[str, int]]:
    """qid -> {docid: graded relevance}. Zero and negative grades are kept
    (judged nonrelevant) and count as not relevant."""
    per: dict[str, dict[str, int]] = defaultdict(dict)
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            try:
                per[parts[0]][parts[2]] = int(parts[3])
            except ValueError:
                continue
    return dict(per)


def evaluate_run(run: dict[str, list[str]],
                 qrels: dict[str, dict[str, int]],
                 complete: bool = False,
                 exp_gains: bool = False) -> dict:
    """Mean metrics over the judged queries.

    By default (trec_eval's convention) the mean runs over the qids in
    both the run and the qrels: a judged query with no results is left
    out, not scored zero. `complete=True` (trec_eval -c) averages over
    every qrels qid with a relevant document, a qid missing from the run
    scoring zero. Topics judged only nonrelevant are skipped in both
    modes, as trec_eval does. `exp_gains` uses 2^g - 1 gains in NDCG
    (the web-search form) in place of the linear ones."""
    has_rel = {q for q, grades in qrels.items()
               if any(g > 0 for g in grades.values())}
    qids = sorted(has_rel) if complete else sorted(set(run) & has_rel)
    if not qids:
        return {"queries": 0}
    ap_l, rr_l, ndcg_l, p5_l, p10_l, r100_l = [], [], [], [], [], []
    gain = (lambda g: 2.0 ** g - 1) if exp_gains else (lambda g: g)
    for qid in qids:
        ranked = run.get(qid, [])
        grades = qrels[qid]
        rel = {d for d, g in grades.items() if g > 0}
        n_rel = len(rel)
        hits = 0
        ap = 0.0
        rr = 0.0
        for i, d in enumerate(ranked, 1):
            if d in rel:
                hits += 1
                ap += hits / i
                if rr == 0.0:
                    rr = 1.0 / i
        ap_l.append(ap / n_rel if n_rel else 0.0)
        rr_l.append(rr)
        dcg = sum(gain(max(grades.get(d, 0), 0)) / math.log2(i + 1)
                  for i, d in enumerate(ranked[:10], 1))
        ideal = sorted((g for g in grades.values() if g > 0), reverse=True)
        idcg = sum(gain(g) / math.log2(i + 1)
                   for i, g in enumerate(ideal[:10], 1))
        ndcg_l.append(dcg / idcg if idcg > 0 else 0.0)
        p5_l.append(sum(1 for d in ranked[:5] if d in rel) / 5.0)
        p10_l.append(sum(1 for d in ranked[:10] if d in rel) / 10.0)
        r100_l.append(sum(1 for d in ranked[:100] if d in rel)
                      / n_rel if n_rel else 0.0)

    def mean(xs):
        return round(sum(xs) / len(xs), 4)

    return {
        "queries": len(qids),
        "map": mean(ap_l),
        "mrr": mean(rr_l),
        "ndcg_at_10": mean(ndcg_l),
        "p_at_5": mean(p5_l),
        "p_at_10": mean(p10_l),
        "recall_at_100": mean(r100_l),
    }
