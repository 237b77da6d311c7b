#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_ir_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds every kernel of the port from csrc/, then runs these phases in
order, printing one JSON line per phase; any failure ends the run with a
nonzero exit code:

1. env      the card's name and power limit (nvidia-smi), torch and CUDA
            versions;
2. kernels  each kernel against its plain PyTorch twin on the card at the
            shapes of the `ref` configuration, with its time, its bound,
            the twin's time and one library call's time (CUDA events,
            median of 20 runs after warm-up);
3. build    the `ref` corpus (8,761 TREC docs, 23.95 MB; bench.py's
            make_corpus, copied into the port) indexed into 10 shards on
            the card;
4. serve    Scorer.load on the card, search_batch under TF-IDF and BM25,
            then topk over 10,000 two-term queries with k = 10, checked
            against an exhaustive numpy oracle (recall@10 on 64 queries)
            and against the kernels' launch counts.

The last three lines are the `kernels` summary, the card's name and power
limit, and {"ok": true, "device": {...}}. Without CUDA, or outside the
repository, the script exits nonzero before printing any result.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
KERNEL_TOL = 0.0               # kernel vs twin: same order, same rounding
ORACLE_RTOL = 1e-5             # device float32 vs float64 numpy oracle
REF_VOCAB_ROWS = 30_000        # the ref corpus's word-shape pool
REF_QUERIES = 10_000           # bench.py's ref query load: B x 2 terms
REF_QUERY_TERMS = 2
ORACLE_QUERIES = 64            # queries held against the numpy oracle
REF_CORPUS: dict = {}          # make_corpus arguments; {} is the ref size
TIMED_RUNS = 20


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median milliseconds of `fn` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_env(card: str) -> dict:
    import torch

    return {"phase": "env", "card": card,
            "device_name": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}


def phase_kernels(card: str, *, vocab_rows: int, width: int,
                  batch: int, terms: int, seed: int = 0) -> dict:
    """Kernel 1 (dense_score) against its plain twin at the ref shapes."""
    import torch

    from tpu_ir_torch.ops import fused_scoring
    from tpu_ir_torch.ops.scoring import idf_weights

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    # (1 + ln tf) cells: ~1.8% nonzero, like the ref corpus's matrix
    tf = torch.randint(1, 8, (vocab_rows, width), generator=gen,
                       device=dev, dtype=torch.int32)
    keep = torch.rand((vocab_rows, width), generator=gen, device=dev) < 0.018
    matrix = torch.where(keep, 1.0 + torch.log(tf.float()), 0.0)
    matrix[:, 0] = 0.0
    del tf, keep
    df = torch.from_numpy(rng.integers(0, width, vocab_rows, dtype=np.int32))
    df[:5] = 0                                     # empty vocabulary rows
    q = rng.integers(0, vocab_rows, (batch, terms)).astype(np.int32)
    q[1::7, -1] = -1                               # -1 pads
    q[3] = -1                                      # an empty query
    q[5, :] = q[5, 0]                              # a duplicated term
    q[9, 0] = vocab_rows + 3                       # out of vocabulary
    q[11, 0] = 0                                   # a row with df == 0
    q_d = torch.from_numpy(q).to(dev)
    idf = idf_weights(df.to(dev), width - 1)

    got = fused_scoring.dense_scores(q_d, idf, matrix)
    want = fused_scoring.dense_scores_plain(q_d, idf, matrix)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    if not torch.isfinite(got).all() or max_abs > KERNEL_TOL:
        raise AssertionError(f"dense_score kernel disagrees with its "
                             f"plain twin: max_abs_diff {max_abs}")
    if not bool((got[3] == 0).all()):
        raise AssertionError("an empty query must score 0 everywhere")

    ms = cuda_ms(lambda: fused_scoring.dense_scores(q_d, idf, matrix))
    plain_ms = cuda_ms(
        lambda: fused_scoring.dense_scores_plain(q_d, idf, matrix))

    # yardstick only (the port never calls it): one sparse [B, V] idf
    # weight matrix times the dense doc matrix
    safe_q, q_w = fused_scoring.query_weights(q_d, idf)
    nz = q_w != 0
    rows = torch.arange(batch, device=dev)[:, None].expand_as(q_w)[nz]
    sq = torch.sparse_coo_tensor(
        torch.stack([rows, safe_q[nz].long()]), q_w[nz],
        (batch, vocab_rows)).coalesce()
    lib = torch.sparse.mm(sq, matrix)
    lib_diff = float((lib - got).abs().max())
    library_ms = cuda_ms(lambda: torch.sparse.mm(sq, matrix))

    # least time for this work: the distinct rows the queries reference
    # read once, the ids and weights read once, the scores written once
    n_rows = int(torch.unique(safe_q[nz]).numel())
    bytes_moved = (n_rows * width * 4 + batch * terms * 8
                   + batch * width * 4)
    flops = 2 * int(nz.sum()) * width
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    return {"phase": "kernels", "card": card, "name": "dense_score",
            "shape": {"V": vocab_rows, "D+1": width, "B": batch,
                      "L": terms},
            "max_abs_diff": max_abs, "tolerance": KERNEL_TOL,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "torch.sparse.mm(Q[B,V] sparse, M[V,D+1])",
            "library_max_abs_diff": lib_diff,
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"),
            "bound_bytes": bytes_moved, "distinct_rows": n_rows,
            "bound_ms_every_row_read": (batch * terms * width * 4
                                        + batch * width * 4)
            / HBM_BYTES_PER_S * 1e3,
            "launches_while_comparing": fused_scoring.dense_score_launches()}


def phase_build(card: str, work: str, *, device: str) -> tuple[dict, str]:
    """The ref corpus, generated from seed 0, indexed into 10 shards. The
    CPU test shrinks the corpus through REF_CORPUS, a test hook only."""
    from tpu_ir_torch.corpus import make_corpus
    from tpu_ir_torch.index import build_index

    corpus = os.path.join(work, "ref.trec")
    t0 = time.perf_counter()
    corpus_bytes = make_corpus(corpus, seed=0, **REF_CORPUS)
    gen_s = time.perf_counter() - t0
    idx = os.path.join(work, "idx")
    t0 = time.perf_counter()
    meta = build_index(corpus, idx, num_shards=10, device=device)
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    part_bytes = sum(os.path.getsize(os.path.join(idx, f))
                     for f in os.listdir(idx) if f.startswith("part-"))
    # the host analysis alone, timed apart: the rest of build_s is the
    # vocab sort, the device group-by and the artifact writes
    from tpu_ir_torch.index.builder import analyze_corpus

    t0 = time.perf_counter()
    analyze_corpus([corpus])
    analyze_s = time.perf_counter() - t0
    return {"phase": "build", "card": card, "corpus_bytes": corpus_bytes,
            "corpus_gen_s": gen_s, "build_s": wall,
            "analyze_alone_s": analyze_s,
            "docs_per_s": meta.num_docs / wall, "num_docs": meta.num_docs,
            "vocab_size": meta.vocab_size, "num_pairs": meta.num_pairs,
            "num_shards": meta.num_shards, "part_bytes": part_bytes}, idx


def profile_topk(scorer, q_ids: np.ndarray, k: int, scoring: str) -> dict:
    """One topk call under torch.profiler: device time by kernel name and
    the device's idle share of the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scorer.topk(q_ids, k=k, scoring=scoring)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue                       # host ops: their kernels count
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((evt.key, us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": (1 - device_ms / wall_ms) if wall_ms > 0 else None,
            "top": [{"kernel": n[:90], "ms": ms, "calls": c}
                    for n, ms, c in rows[:8]]}


def oracle_topk(q: np.ndarray, df: np.ndarray, pair_doc: np.ndarray,
                pair_tf: np.ndarray, num_docs: int, k: int):
    """Exhaustive TF-IDF over the host postings columns, float64 sums of
    float32 weights: (docnos [k'], scores [num_docs+1]) of one query."""
    indptr = np.concatenate([[0], np.cumsum(df, dtype=np.int64)])
    idf = np.where(df > 0, np.log10(np.float32(num_docs)
                                    / np.maximum(df, 1).astype(np.float32)),
                   0).astype(np.float32)
    scores = np.zeros(num_docs + 1, np.float64)
    for t in q:
        if t < 0 or t >= len(df):
            continue
        lo, hi = indptr[t], indptr[t + 1]
        w = (1.0 + np.log(pair_tf[lo:hi].astype(np.float32))) * idf[t]
        np.add.at(scores, pair_doc[lo:hi], w.astype(np.float64))
    scores[0] = 0.0
    order = np.lexsort((np.arange(num_docs + 1), -scores))
    top = [int(d) for d in order[:k] if scores[d] > 0]
    return top, scores


def phase_serve(card: str, idx: str, *, device: str, k: int = 10) -> dict:
    """Load the index on the device and serve it; counts kernel launches
    from the load to the end of the timed topk. The CPU test shrinks the
    query load through REF_QUERIES and ORACLE_QUERIES, test hooks only."""
    import torch

    import tpu_ir_torch
    from tpu_ir_torch.search import Scorer

    n_queries, n_oracle = REF_QUERIES, ORACLE_QUERIES
    on_cuda = device == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    tpu_ir_torch.reset_kernel_launches()
    t0 = time.perf_counter()
    scorer = Scorer.load(idx, device=device)
    sync()
    load_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() if on_cuda else None

    terms = scorer.vocab.terms
    texts = [f"{terms[7]} {terms[len(terms) // 2]}",
             f"{terms[len(terms) // 3]}", f"{terms[1]} {terms[2]} {terms[3]}",
             "zzzzzzzzq"]
    text_hits = {}
    for scoring in ("tfidf", "bm25"):
        res = scorer.search_batch(texts, k=k, scoring=scoring)
        for r in res[:3]:
            s = [x[1] for x in r]
            if not r or not all(np.isfinite(s)) or s != sorted(s,
                                                               reverse=True):
                raise AssertionError(f"{scoring} search_batch gave {r!r}")
        if res[3]:
            raise AssertionError("an unknown term must match nothing")
        text_hits[scoring] = [len(r) for r in res]

    rng = np.random.default_rng(1)
    v = scorer.meta.vocab_size
    q_ids = rng.integers(0, v, size=(n_queries, REF_QUERY_TERMS)).astype(
        np.int32)
    scorer.topk(q_ids, k=k)                          # warm-up
    t0 = time.perf_counter()
    scores, docnos = scorer.topk(q_ids, k=k)         # host arrays: synced
    tfidf_s = time.perf_counter() - t0
    scorer.topk(q_ids, k=k, scoring="bm25")
    t0 = time.perf_counter()
    bm25_scores, _ = scorer.topk(q_ids, k=k, scoring="bm25")
    bm25_s = time.perf_counter() - t0
    launches = tpu_ir_torch.kernel_launches()
    peak = torch.cuda.max_memory_allocated() if on_cuda else None
    profiles = ({s: profile_topk(scorer, q_ids, k, s)
                 for s in ("tfidf", "bm25")} if on_cuda else None)

    if scores.shape != (n_queries, k) or not np.isfinite(scores).all() \
            or not np.isfinite(bm25_scores).all():
        raise AssertionError("topk returned malformed scores")
    if on_cuda and launches["dense_score"] == 0:
        raise AssertionError("the serve phase never launched dense_score")
    if on_cuda and resident < 1e9:
        raise AssertionError(f"only {resident} bytes resident on the card; "
                             "the dense doc matrix should hold > 1 GB")

    # recall@10 against the exhaustive oracle; documents tied with the
    # oracle's 10th score (within ORACLE_RTOL) are interchangeable
    _, pair_doc, pair_tf = scorer._pairs
    df = scorer.df.cpu().numpy()
    sample = np.random.default_rng(2).choice(n_queries, n_oracle,
                                             replace=False)
    recalls, worst_rel = [], 0.0
    for qi in sample:
        top, oscores = oracle_topk(q_ids[qi], df, pair_doc, pair_tf,
                                   scorer.meta.num_docs, k)
        got = [int(d) for d in docnos[qi] if d > 0]
        if not top:
            recalls.append(1.0 if not got else 0.0)
            continue
        cut = oscores[top[-1]] * (1 - ORACLE_RTOL)
        hits = sum(1 for d in got if oscores[d] >= cut)
        recalls.append(min(hits, len(top)) / len(top))
        for s, d in zip(scores[qi], docnos[qi]):
            if d > 0:
                worst_rel = max(worst_rel, abs(s - oscores[d])
                                / max(oscores[d], 1e-30))
    recall = float(np.mean(recalls))
    if recall < 1.0 or worst_rel > ORACLE_RTOL:
        raise AssertionError(f"oracle check failed: recall@10 {recall}, "
                             f"max rel score error {worst_rel}")
    return {"phase": "serve", "card": card, "load_s": load_s,
            "layout": scorer.layout, "block": scorer._block_size(),
            "resident_bytes": resident, "peak_bytes": peak,
            "text_hits": text_hits, "queries": n_queries, "k": k,
            "tfidf_s": tfidf_s, "tfidf_qps": n_queries / tfidf_s,
            "bm25_s": bm25_s, "bm25_qps": n_queries / bm25_s,
            "launches": launches, "oracle_queries": n_oracle,
            "recall_at_10": recall, "oracle_max_rel_err": worst_rel,
            "profile": profiles}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port "
              "on a GPU and has nothing to do here", file=sys.stderr)
        return 2
    try:
        import tpu_ir_torch  # noqa: F401
        from tpu_ir_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: cannot import tpu_ir_torch ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    for name in _build.kernel_sources():
        _build.load(name)
    emit({"phase": "build_kernels", "seconds": time.perf_counter() - t0,
          "libraries": {n: _build.lib_path(n).name
                        for n in _build.kernel_sources()}})
    emit(phase_env(card))
    kern = phase_kernels(card, vocab_rows=REF_VOCAB_ROWS,
                         width=8_761 + 1, batch=REF_QUERIES,
                         terms=REF_QUERY_TERMS)
    emit(kern)
    torch.cuda.empty_cache()

    root = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(root, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(dir=scratch)
    try:
        build, idx = phase_build(card, work, device="cuda")
        emit(build)
        serve = phase_serve(card, idx, device="cuda")
        emit(serve)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    emit({"kernels": [{
        "name": "dense_score", "route": "cuda",
        "source": "tpu_ir_torch/csrc/dense_score.cu",
        "replaces": "tpu_ir/ops/pallas_scoring.py:52",
        "launches": serve["launches"]["dense_score"],
        "max_abs_err": kern["max_abs_diff"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"]}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
