"""The hot-postings residency hint of a shard worker (the port of
`tpu_ir/serving/residency.py`).

A scorer builds some device state on the first request that needs it:
the tiered layout's weighted hot strips and block-max bound tables (one
per scoring), the dense layout's raw-tf matrix (BM25). Under skewed
traffic that first cost lands on the head queries, whose terms are the
top-df ones the hot strip holds. This module reads the doctor's df-skew
report (index/doctor.py::df_skew_report) and, when the top-df decile
holds most of the postings, builds that state at load, before a worker
writes its ready file.

TPU_IR_HOT_RESIDENCY: auto (engage when the decile's share is at least
SKEW_ENGAGE), 1 (always), 0 (never). It builds exactly the state the
first requests would build, so it changes no bit of any answer.
"""

from __future__ import annotations

import time

# auto engages when the top-df decile holds at least this share of the
# postings
SKEW_ENGAGE = 0.5


def residency_hint(scorer) -> dict:
    """The df-skew report of this scorer's df column (global also on a
    doc-range scorer), as `doctor` reports it."""
    from ..index.doctor import df_skew_report

    return df_skew_report(scorer._df_host)


def prewarm_hot_residency(scorer, *, mode: str | None = None) -> dict:
    """Apply the hint to one loaded scorer and return the decision (the
    worker's /healthz identity carries it): the mode, whether it
    engaged, what it built (`warmed`), the skew report and `warm_s`."""
    from .. import envvars

    if mode is None:
        mode = envvars.get_choice("TPU_IR_HOT_RESIDENCY")
    hint = residency_hint(scorer)
    share = hint.get("top_decile_postings_share")
    engage = mode == "1" or (mode == "auto" and share is not None
                             and share >= SKEW_ENGAGE)
    report = {"mode": mode, "engaged": bool(engage), "warmed": [], **hint}
    if not engage:
        return report
    t0 = time.perf_counter()
    warmed = report["warmed"]
    if scorer.layout == "sparse":
        # the weighted strips (the TF-IDF one is also the rerank's), then
        # the bound tables where the layout has block-max bounds
        for scoring in ("tfidf", "bm25"):
            if scorer._hot_wstrip(scoring) is not None:
                warmed.append(f"strip.{scoring}")
        if getattr(scorer, "_hot_blk_max", None) is not None:
            for scoring in ("tfidf", "bm25"):
                scorer._blockmax_bound_table(scoring)
                warmed.append(f"bounds.{scoring}")
    elif scorer.layout == "dense":
        scorer._ensure_tf_matrix()
        warmed.append("tf_matrix")
    report["warm_s"] = round(time.perf_counter() - t0, 4)
    return report
