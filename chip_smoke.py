#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_ir_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds every kernel of the port from csrc/ (one nvcc per source, all
started together; the build line reports each kernel's registers, spills
and shared memory from ptxas) and the native tokenizer from
native/analyzer.cpp (g++), then runs these phases in order, printing
one JSON line per phase; any failure ends the run with a nonzero exit
code:

1. env        the card's name and power limit (nvidia-smi), torch and CUDA
              versions;
2. kernels    dense_score against its plain PyTorch twin on the card at the
              shapes of the `ref` configuration, with its wrapper's time,
              the kernel's time alone (torch.profiler, with the launches
              its trace holds, at least 90%), the rate and share
              of its bytes bound that reaches, the twin's time and one
              library call's time (CUDA events, median of 20 runs after
              warm-up); then bitwise against the twin at edge shapes (odd
              and tiny widths, B = 1, L = 1 to 9 and 33, 64, 128, ids V-1,
              int64 ids);
3. kernels    dequant_score likewise, on a bf16 raw-tf matrix of the same
              synthetic tfs, and bitwise against dense_score over their
              float32 (1 + ln tf) matrix, there and at the edge shapes
              (both kernels' edge shapes include L = 33, 64 and 128);
4. build      the `ref` corpus (8,761 TREC docs, 23.95 MB; bench.py's
              make_corpus, copied into the port) indexed one-shot into 10
              shards on the card with build_index's defaults (the native
              C++ tokenizer, char-grams k = 2, 3), the analysis timed
              alone through the Python and the native analyzer; then
              `crash_resume`: the ref corpus through the streaming radix
              build (16 buckets) with `crash.pass2` injected at its third
              bucket, built again: pass 1 must not run again and every
              artifact must equal the one-shot build's;
5. serve      Scorer.load on the card (dense layout), search_batch under
              TF-IDF and BM25, then topk over 10,000 two-term queries with
              k = 10, checked against an exhaustive numpy oracle (recall@10
              on 64 queries, both scorings) and the kernels' launch counts;
6. rerank     rerank_topk (BM25 top 1,000, then cosine TF-IDF, k = 10)
              over the same queries: q/s, device time, launches;
7. sparse     the same index and queries on the tiered sparse layout,
              held against the dense layout's top-10 row by row; then its
              rerank against the dense layout's (same docs, rtol 1e-6);
8. compress   `migrate_index(to_version=3)` on a copy of the ref index
              (format v3, tf_dtype "auto");
9. serve      as 5, on the compressed copy (`ref-v3`): a bf16 raw-tf
              matrix, TF-IDF through dequant_score, and top-10 bitwise
              equal to the raw index's for both scorings; its rerank
              bitwise the raw index's;
10. build_streaming  the `wiki100k` corpus (100,000 docs, 270 MB
              target, 200,000 word shapes) indexed into 10 shards three
              ways on the card: the streaming radix build (16 buckets,
              batch_docs 50,000, the document store, char-grams 2, 3;
              pass 2's device time and idle share from torch.profiler),
              the legacy streaming build and the one-shot build; every
              artifact they share has one sha256, verify_index passes on
              the radix build, and each build's wall s, docs/s, phase
              timings, spill bytes, peak host RSS and peak device memory
              are printed. The phases below serve the radix build's index;
11. serve     as 5, on wiki100k, where layout "auto" picks the tiered
              sparse layout and topk runs the MaxScore schedule and
              block-max (prune, the default): cold_tier launched once per
              query block and hot_stage once per block holding hot terms;
12. prune     the same 10,000 queries with prune on and off: q/s, device
              time, idle share, launches, prune_diag, block-max's stats;
              on == off bitwise, recall@10 = 1.0; then hot-term traffic
              (10,000 queries of one hot term and one cold term of df
              30-300) likewise, and its first 640 queries in batches of
              64;
13. rerank    as 6, on wiki100k;
14. wildcard  three mixes of 2,000 texts on wiki100k (a literal term and
              a prefix glob; a literal term and a fuzzy token; the three
              questions that once raised, then two-token texts ending in
              '?'): 200 patterns of each held against a glob and a
              Levenshtein oracle over the vocabulary; the expansion's host
              seconds (first call and warm), the rows' widths; the rows
              through phase 12's checks (prune on == off bitwise, recall@10
              = 1.0, q/s, launches, block-max, the hot-free share, device
              time) and search_batch end to end (q/s, device time and idle
              share); cold_tier and hot_stage must launch in this phase;
15. kernels   hot_stage against its plain twin over one 2,499-query block
              of hot-term traffic, on the whole (1 + ln tf) strip and on
              a block-max column set (which must give the whole strip's
              bits), with the same timings (the kernel alone in a child
              process) beside torch.matmul(w_hot, strip); then bitwise at
              edge cases (B = 1, 2,499 and 70,000 by L = 1, 2, 3, 9 and
              40, and the wide L = 33, 64 and 128 of wildcard traffic;
              N = 1, 4,097 and 100,001; repeated terms, slots outside the
              strip, a query with no hot slot);
16. kernels   cold_tier against its plain twin over the whole cold stage
              of one 2,499-query block of the wiki100k traffic (one
              launch for every tier), TF-IDF and BM25, with the same
              timings (the kernel alone in a child process, each launch
              on a freshly zeroed accumulator as in serving) and the
              score cells' 32-byte sectors beside the bound; then bitwise
              against the twin at edge cases (B = 1, 2,499 and 70,000 by
              L = 1, 2, 3 and 9, and 33, 64 and 128, where the term loop
              turns more than once; caps 1 to 4,096, empty tiers, wide
              tiers before narrow ones, zero and 16 tiers);
17. compress  and serve `wiki100k-v3` as 8 and 9: a bf16 hot strip, top-10
              bitwise equal to the raw wiki100k index's;
18. kgram     the ref corpus as a k = 2 term-k-gram index, one-shot (with
              char-grams over tokens.txt) and streaming (the Python
              tokenizer in 4 processes): every artifact both write has
              one sha256, verify passes; the one-shot index served with
              layout "auto" (2,000 two- and three-token texts, recall@10
              = 1.0 against the oracle; 200 globs composed over
              tokens.txt): build wall s and docs/s, V, the layout, q/s,
              device time and launches.

Then the serving tier (tpu_ir_torch.serving) over `ref` and `wiki100k`,
loaded again, with the kernels' launches counted from phase 19 to the end
of phase 21 (each of dense_score, cold_tier and hot_stage must launch):

19. frontend  on each: a ServingFrontend search at level full bitwise
              search_batch's; 16 texts of 1 to 8 terms in rung-padded
              batches (1, 3 and 16 texts at width floor 8, the
              coalescer's dispatch, and the 16 once more with every
              kernel's plain twin) bitwise their solo dispatch, for
              TF-IDF, BM25 and the rerank, and on wiki100k also hot_only
              and prune off; on wiki100k hot_only through the frontend
              (its ladder stepped down), which launches hot_stage and
              never cold_tier and gives the bits of hot_stage's plain
              twin on the same path;
20. soak      wiki100k, 8 threads x 480 requests of make_queries through a
              coalescing frontend: a clean run (served + shed ==
              submitted, no error, deadlock, untagged mismatch or
              degraded response, no forced host batch, kernels launched),
              then the same under DEFAULT_CHAOS_PLAN (every invariant but
              `degraded`, and one degraded verdict in each shared batch);
21. sweep     on each, run_concurrency_sweep at concurrency 1, 4 and 16,
              2,000 requests a level, BM25 and TF-IDF, three times each:
              solo round trip, p50/p95/p99 ms, q/s, mean occupancy and
              `unwarmed` (must be 0), and the repeats' spread; then one
              request's latency past a 0.25 s deadline beside the open
              breaker's.

The last three lines are the `kernels` summary, the card's name and power
limit, and {"ok": true, "device": {...}}. Without CUDA, or outside the
repository, the script exits nonzero before printing any result.
"""

from __future__ import annotations

import contextlib
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
# bench.py's wiki100k configuration: make_corpus arguments
WIKI_CORPUS = dict(n_docs=100_000, target_bytes=270_000_000,
                   vocab_size=200_000)
# what layout "auto" must pick, and the least resident bytes, per config:
# a compressed (v3) index holds its raw tfs in bf16, half the float32 bytes
LAYOUTS = {"ref": "dense", "wiki100k": "sparse", "ref-v3": "dense",
           "wiki100k-v3": "sparse"}
MIN_RESIDENT = {"ref": 1e9, "wiki100k": 1e9, "ref-v3": 0.5e9,
                "wiki100k-v3": 0.5e9}
K1, BM25_B = 0.9, 0.4          # the port's BM25 constants
HOT_SMALL_QUERIES = 640         # hot-term traffic served 64 queries a batch
HOT_SMALL_BATCH = 64
TIMED_RUNS = 20
PROFILER_SETTLE_S = 0.05       # idle time at each end of a profiler session
MIN_TRACED = 0.9               # least share of the launches a trace must hold
# query widths of wildcard and fuzzy traffic: one term past a warp, and
# the power-of-two buckets of rows an expansion of up to 64 terms gives
WIDE_TERMS = (33, 64, 128)


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


def kernel_alone(fn, kernel: str, runs: int = TIMED_RUNS) -> dict:
    """The kernel named `<kernel>_kernel` alone over `runs` calls of `fn`,
    from its own torch.profiler session: the mean device milliseconds per
    launch the trace holds, without the wrapper's host time or other
    launches, and how many launches the trace holds. The session waits
    PROFILER_SETTLE_S after it starts and after the last launch ends, so
    that no launch falls outside its capture window; it fails if the trace
    holds fewer than MIN_TRACED of the `runs` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_SETTLE_S)
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILER_SETTLE_S)
    device = [evt for evt in prof.events()
              if evt.device_type == torch.autograd.DeviceType.CUDA]
    us = [evt.time_range.elapsed_us() for evt in device
          if f"{kernel}_kernel" in evt.name]
    if len(us) < MIN_TRACED * runs:
        raise AssertionError(
            f"the profiler saw {len(us)} {kernel} launches in {runs} calls "
            f"({len(device)} device events: "
            f"{sorted({e.name[:60] for e in device})[:5]})")
    return {"kernel_ms": float(np.mean(us)) / 1e3,
            "traced_launches": len(us), "traced_of": runs}


def bandwidth(bound: dict, alone: dict) -> dict:
    """What a kernel's time alone reaches of its bytes bound."""
    kernel_ms = alone["kernel_ms"]
    return {**alone, "achieved_tb_s": bound["bound_bytes"] / kernel_ms / 1e9,
            "bound_share": bound["bound_ms"] / kernel_ms}


def edge_checks(name: str) -> dict:
    """The dense kernel `name` (dense_score or dequant_score) bitwise
    against its plain twin at edge shapes on the card: odd and tiny widths,
    B = 1, L = 1, 3 and 9 and the wide queries of WIDE_TERMS, ids V-1 (the
    allocation's last row), -1 and past V, an int64 batch; dequant_score
    also against dense_score on the same tfs. Its launches here are
    comparisons, not the main path's."""
    import torch

    from tpu_ir_torch.ops import fused_scoring
    from tpu_ir_torch.ops.scoring import _lntf

    dev = torch.device("cuda")
    cases = 0
    for width in (1, 7, 8_761, 8_763, 8_769):
        for batch, terms in ((1, 2), (257, 1), (257, 3), (64, 9)) + tuple(
                (64 if terms % 2 else 257, terms) for terms in WIDE_TERMS):
            rng = np.random.default_rng(width * 100 + terms)
            vocab = 40
            q = rng.integers(-1, vocab + 2, (batch, terms))
            q[::3, 0] = vocab - 1
            idf = rng.uniform(0.05, 3.0, vocab).astype(np.float32)
            idf[rng.random(vocab) < 0.2] = 0.0
            tf = rng.integers(1, 257, (vocab, width))
            tf[rng.random((vocab, width)) < 0.7] = 0
            tf16 = torch.from_numpy(tf).to(torch.bfloat16).to(dev)
            matrix = _lntf(tf16)
            idf_d = torch.from_numpy(idf).to(dev)
            for dtype in (np.int32, np.int64):
                q_d = torch.from_numpy(q.astype(dtype)).to(dev)
                if name == "dense_score":
                    got = fused_scoring.dense_scores(q_d, idf_d, matrix)
                    want = [fused_scoring.dense_scores_plain(q_d, idf_d,
                                                             matrix)]
                else:
                    got = fused_scoring.dense_scores_quantized(q_d, idf_d,
                                                               tf16)
                    want = [fused_scoring.dense_scores_quantized_plain(
                        q_d, idf_d, tf16),
                        fused_scoring.dense_scores(q_d, idf_d, matrix)]
                for w in want:
                    if not torch.equal(got.view(torch.int32),
                                       w.view(torch.int32)):
                        raise AssertionError(
                            f"{name} disagrees at width {width}, B "
                            f"{batch}, L {terms}, {dtype.__name__} ids: "
                            f"max_abs_diff {float((got - w).abs().max())}")
                cases += 1
    return {"cases": cases, "max_abs_diff": 0.0}


def phase_env(card: str) -> dict:
    import torch

    return {"phase": "env", "card": card,
            "device_name": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "python": sys.version.split()[0]}


def ref_kernel_inputs(*, vocab_rows: int, width: int, batch: int,
                      terms: int, seed: int = 0):
    """The dense kernels' synthetic inputs at the ref shapes, on the card:
    (tf int32 [V, D+1], integer tfs 1..7 in ~1.8% of the cells like the ref
    corpus's matrix and 0 elsewhere; q int32 [B, L] with the edge cases; idf
    float32 [V]). The same seed gives the same inputs."""
    import torch

    from tpu_ir_torch.ops.scoring import idf_weights

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    tf = torch.randint(1, 8, (vocab_rows, width), generator=gen,
                       device=dev, dtype=torch.int32)
    keep = torch.rand((vocab_rows, width), generator=gen, device=dev) < 0.018
    tf.mul_(keep)
    del keep
    tf[:, 0] = 0
    df = torch.from_numpy(rng.integers(0, width, vocab_rows, dtype=np.int32))
    df[:5] = 0                                     # empty vocabulary rows
    q = rng.integers(0, vocab_rows, (batch, terms)).astype(np.int32)
    q[1::7, -1] = -1                               # -1 pads
    q[3] = -1                                      # an empty query
    q[5, :] = q[5, 0]                              # a duplicated term
    q[9, 0] = vocab_rows + 3                       # out of vocabulary
    q[11, 0] = 0                                   # a row with df == 0
    return tf, torch.from_numpy(q).to(dev), idf_weights(df.to(dev),
                                                         width - 1)


def dense_bound(q_d, idf, width: int, cell_bytes: int,
                ops_per_cell: int) -> dict:
    """The least time of a dense score kernel on these inputs: the distinct
    rows the queries reference read once (`cell_bytes` a cell), ids and
    weights read once, the scores written once; `ops_per_cell` operations
    for each cell of each weighted (b, l)."""
    import torch

    from tpu_ir_torch.ops import fused_scoring

    batch, terms = q_d.shape
    safe_q, q_w = fused_scoring.query_weights(q_d, idf)
    nz = q_w != 0
    n_rows = int(torch.unique(safe_q[nz]).numel())
    bytes_moved = (n_rows * width * cell_bytes + batch * terms * 8
                   + batch * width * 4)
    ops = ops_per_cell * int(nz.sum()) * width
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"),
            "bound_bytes": bytes_moved, "distinct_rows": n_rows,
            "bound_ms_every_row_read": (batch * terms * width * cell_bytes
                                        + batch * width * 4)
            / HBM_BYTES_PER_S * 1e3}


def sparse_mm_yardstick(q_d, idf, matrix) -> tuple:
    """(the scores, the median ms) of one torch.sparse.mm of a sparse
    [B, V] idf weight matrix and the float32 doc matrix: the one PyTorch
    call that computes kernel 1's scores. A yardstick only; the port never
    calls it."""
    import torch

    from tpu_ir_torch.ops import fused_scoring

    batch = q_d.shape[0]
    safe_q, q_w = fused_scoring.query_weights(q_d, idf)
    nz = q_w != 0
    rows = torch.arange(batch, device=q_d.device)[:, None].expand_as(q_w)[nz]
    sq = torch.sparse_coo_tensor(
        torch.stack([rows, safe_q[nz].long()]), q_w[nz],
        (batch, matrix.shape[0])).coalesce()
    return torch.sparse.mm(sq, matrix), cuda_ms(lambda: torch.sparse.mm(
        sq, matrix))


def phase_kernels(card: str, *, vocab_rows: int, width: int,
                  batch: int, terms: int, seed: int = 0) -> dict:
    """Kernel 1 (dense_score) against its plain twin at the ref shapes."""
    import torch

    from tpu_ir_torch.ops import fused_scoring
    from tpu_ir_torch.ops.scoring import _lntf

    tf, q_d, idf = ref_kernel_inputs(vocab_rows=vocab_rows, width=width,
                                     batch=batch, terms=terms, seed=seed)
    matrix = _lntf(tf)                            # float32 (1 + ln tf)
    del tf

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
    alone = kernel_alone(
        lambda: fused_scoring.dense_scores(q_d, idf, matrix), "dense_score")
    plain_ms = cuda_ms(
        lambda: fused_scoring.dense_scores_plain(q_d, idf, matrix))
    lib, library_ms = sparse_mm_yardstick(q_d, idf, matrix)
    lib_diff = float((lib - got).abs().max())
    del lib, got, want
    bound = dense_bound(q_d, idf, width, cell_bytes=4, ops_per_cell=2)
    return {"phase": "kernels", "card": card, "name": "dense_score",
            "shape": {"V": vocab_rows, "D+1": width, "B": batch,
                      "L": terms},
            "max_abs_diff": max_abs, "tolerance": KERNEL_TOL,
            "ms": ms, **bandwidth(bound, alone),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "torch.sparse.mm(Q[B,V] sparse, M[V,D+1])",
            "library_max_abs_diff": lib_diff, **bound,
            "edge_checks": edge_checks("dense_score"),
            "launches_while_comparing": fused_scoring.dense_score_launches()}


def phase_dequant_score(card: str, *, vocab_rows: int, width: int,
                        batch: int, terms: int, seed: int = 0) -> dict:
    """Kernel 2 (dequant_score) against its plain twin, and bitwise against
    kernel 1 over the float32 (1 + ln tf) matrix of the same tfs, at the
    ref shapes on kernel 1's synthetic tfs held as a bf16 raw-tf matrix."""
    import torch

    from tpu_ir_torch.ops import fused_scoring
    from tpu_ir_torch.ops.scoring import _lntf

    tf, q_d, idf = ref_kernel_inputs(vocab_rows=vocab_rows, width=width,
                                     batch=batch, terms=terms, seed=seed)
    tf16 = tf.to(torch.bfloat16)
    matrix = _lntf(tf)
    del tf
    before = (fused_scoring.dequant_score_launches(),
              fused_scoring.dense_score_launches())

    got = fused_scoring.dense_scores_quantized(q_d, idf, tf16)
    want = fused_scoring.dense_scores_quantized_plain(q_d, idf, tf16)
    k1 = fused_scoring.dense_scores(q_d, idf, matrix)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    vs_k1 = float((got - k1).abs().max())
    if not torch.isfinite(got).all() or max_abs > KERNEL_TOL \
            or not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"dequant_score kernel disagrees with its "
                             f"plain twin: max_abs_diff {max_abs}")
    if vs_k1 > KERNEL_TOL or not torch.equal(got.view(torch.int32),
                                             k1.view(torch.int32)):
        raise AssertionError(f"dequant_score kernel disagrees with "
                             f"dense_score on the same tfs: max_abs_diff "
                             f"{vs_k1}")
    if not bool((got[3] == 0).all()):
        raise AssertionError("an empty query must score 0 everywhere")
    del want, k1

    ms = cuda_ms(lambda: fused_scoring.dense_scores_quantized(q_d, idf,
                                                              tf16))
    alone = kernel_alone(
        lambda: fused_scoring.dense_scores_quantized(q_d, idf, tf16),
        "dequant_score")
    plain_ms = cuda_ms(
        lambda: fused_scoring.dense_scores_quantized_plain(q_d, idf, tf16))
    k1_ms = cuda_ms(lambda: fused_scoring.dense_scores(q_d, idf, matrix))
    k1_alone = kernel_alone(
        lambda: fused_scoring.dense_scores(q_d, idf, matrix), "dense_score")
    # no single PyTorch call weights a bf16 raw-tf matrix; kernel 1's
    # yardstick gives the same scores from the uncompressed matrix
    _, k1_library_ms = sparse_mm_yardstick(q_d, idf, matrix)
    # per cell: compare, max, log, add (the weight), multiply, add
    bound = dense_bound(q_d, idf, width, cell_bytes=2, ops_per_cell=6)
    edges = edge_checks("dequant_score")
    return {"phase": "kernels", "card": card, "name": "dequant_score",
            "shape": {"V": vocab_rows, "D+1": width, "B": batch,
                      "L": terms},
            "max_abs_diff": max_abs, "tolerance": KERNEL_TOL,
            "max_abs_diff_vs_dense_score": vs_k1,
            "ms": ms, **bandwidth(bound, alone), "plain_ms": plain_ms,
            "dense_score_ms": k1_ms,
            "dense_score_kernel_ms": k1_alone["kernel_ms"],
            "dense_score_traced_launches": k1_alone["traced_launches"],
            "library_ms": None, "library": "none",
            "dense_score_library_ms": k1_library_ms,
            "dense_score_library": "torch.sparse.mm(Q[B,V] sparse, "
                                   "M[V,D+1] float32 (1 + ln tf))",
            **bound, "edge_checks": edges,
            "launches_while_comparing": (
                fused_scoring.dequant_score_launches() - before[0],
                fused_scoring.dense_score_launches() - before[1])}


def phase_build(card: str, work: str, *, device: str,
                config: str = "ref") -> tuple[dict, str]:
    """A configuration's corpus, generated from seed 0, indexed one-shot
    into 10 shards with build_index's defaults (the native tokenizer,
    char-grams k = 2, 3). The CPU test shrinks the corpora through
    REF_CORPUS and WIKI_CORPUS, test hooks only. At ref the host analysis
    is timed once more on its own, through the pure-Python analyzer
    (`analyze_alone_s`) and through the native C++ pass
    (`native_analyze_alone_s`); at wiki100k the corpus stays for
    phase_build_streaming."""
    from tpu_ir_torch.corpus import make_corpus
    from tpu_ir_torch.index import build_index

    corpus = os.path.join(work, f"{config}.trec")
    t0 = time.perf_counter()
    corpus_bytes = make_corpus(
        corpus, seed=0, **(REF_CORPUS if config == "ref" else WIKI_CORPUS))
    gen_s = time.perf_counter() - t0
    idx = os.path.join(work, f"{config}-idx")
    t0 = time.perf_counter()
    meta = build_index(corpus, idx, num_shards=10, device=device)
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    part_bytes = sum(os.path.getsize(os.path.join(idx, f))
                     for f in os.listdir(idx) if f.startswith("part-"))
    out = {"phase": "build", "card": card, "config": config,
           "corpus_bytes": corpus_bytes, "corpus_gen_s": gen_s,
           "build_s": wall, "docs_per_s": meta.num_docs / wall,
           "num_docs": meta.num_docs, "vocab_size": meta.vocab_size,
           "num_pairs": meta.num_pairs, "num_shards": meta.num_shards,
           "chargram_ks": meta.chargram_ks, "part_bytes": part_bytes,
           "timings_s": job_timings(idx)}
    if config == "ref":
        # the host analysis alone, timed apart: the rest of build_s is the
        # vocab sort, the device group-by, the char-grams and the writes
        from tpu_ir_torch.analysis.native import tokenize_corpus_native
        from tpu_ir_torch.index.builder import analyze_corpus

        t0 = time.perf_counter()
        analyze_corpus([corpus])
        out["analyze_alone_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tokenize_corpus_native([corpus])
        out["native_analyze_alone_s"] = time.perf_counter() - t0
    os.unlink(corpus)
    return out, idx


def job_timings(idx: str) -> dict:
    """The build job's phase timings (jobs/TermKGramDocIndexer.json)."""
    with open(os.path.join(idx, "jobs", "TermKGramDocIndexer.json")) as f:
        return json.load(f)["timings_s"]


def artifact_digests(idx: str) -> dict:
    """sha256 of every artifact of an index dir but the job reports."""
    import hashlib

    out = {}
    for name in sorted(os.listdir(idx)):
        path = os.path.join(idx, name)
        if name == "jobs" or name.startswith(".") or not os.path.isfile(
                path):
            continue
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 22), b""):
                h.update(chunk)
        out[name] = h.hexdigest()
    return out


class PeakRss:
    """The process's resident set at the start of a window and its peak
    over the window, sampled from /proc/self/statm every 20 ms on a
    thread (ru_maxrss cannot be reset between builds)."""

    def __enter__(self):
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page

    def _run(self):
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, self._rss())
        return False


def pass2_device(prof) -> dict:
    """Device time inside the build's pass-2 window of a profiled build:
    the CUDA kernels that start inside the `tpu_ir_torch.build.
    pass2_combine` region (JobReport.phase), and the device's idle share
    of that window."""
    import torch

    events = prof.events()
    window = [e for e in events
              if e.name == "tpu_ir_torch.build.pass2_combine"
              and e.device_type == torch.autograd.DeviceType.CPU]
    if len(window) != 1:
        return {"device_ms": None, "note": f"{len(window)} pass-2 regions "
                                            "in the trace"}
    lo, hi = window[0].time_range.start, window[0].time_range.end
    # the region's own device-side row spans its kernels: skip it (and
    # any other named region), or the device time counts twice
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("tpu_ir_torch.")
               and lo <= e.time_range.start <= hi]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    wall_us = hi - lo
    return {"device_ms": device_us / 1e3, "window_ms": wall_us / 1e3,
            "kernels": len(kernels),
            "idle_share": 1 - device_us / wall_us if wall_us else None}


def phase_build_streaming(card: str, work: str, *, device: str,
                          config: str = "wiki100k") -> tuple[dict, str]:
    """The configuration's corpus (seed 0, WIKI_CORPUS) built three ways
    into 10 shards: the streaming radix build (16 buckets, batch_docs
    50,000, store, char-grams 2, 3; under torch.profiler for pass 2's
    device time), the legacy streaming build (radix 0) and the one-shot
    build (no store). Every artifact the three share must have one
    sha256, and verify_index must pass on the radix build, whose index
    dir is returned. For each build: wall s, docs/s, the phase timings
    of its job report, the radix spill bytes, peak host RSS and
    torch.cuda.max_memory_allocated."""
    import torch

    from tpu_ir_torch.corpus import make_corpus
    from tpu_ir_torch.index import build_index, build_index_streaming
    from tpu_ir_torch.index.verify import verify_index

    corpus = os.path.join(work, f"{config}.trec")
    t0 = time.perf_counter()
    corpus_bytes = make_corpus(corpus, seed=0, **WIKI_CORPUS)
    out = {"phase": "build_streaming", "card": card, "config": config,
           "corpus_bytes": corpus_bytes,
           "corpus_gen_s": time.perf_counter() - t0, "builds": {}}
    on_card = device == "cuda"
    builds = {
        "radix": lambda d: build_index_streaming(
            corpus, d, num_shards=10, batch_docs=50_000, radix_buckets=16,
            store=True, device=device),
        "legacy": lambda d: build_index_streaming(
            corpus, d, num_shards=10, batch_docs=50_000, radix_buckets=0,
            device=device),
        "oneshot": lambda d: build_index(corpus, d, num_shards=10,
                                         device=device)}
    dirs, digests = {}, {}
    for name, build in builds.items():
        d = dirs[name] = os.path.join(work, f"{config}-{name}")
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        prof = None
        with PeakRss() as rss, contextlib.ExitStack() as stack:
            if on_card and name == "radix":
                from torch.profiler import ProfilerActivity, profile

                prof = stack.enter_context(profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            t0 = time.perf_counter()
            meta = build(d)
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        with open(os.path.join(d, "jobs", "TermKGramDocIndexer.json")) as f:
            job = json.load(f)
        row = {"wall_s": wall, "docs_per_s": meta.num_docs / wall,
               "num_docs": meta.num_docs, "vocab_size": meta.vocab_size,
               "num_pairs": meta.num_pairs,
               "timings_s": job["timings_s"],
               "radix_spill_bytes": job["counters"].get("radix_spill_bytes"),
               "host_rss_start_bytes": rss.start,
               "peak_host_rss_bytes": rss.peak,
               "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                        if on_card else None)}
        if prof is not None:
            row["pass2"] = pass2_device(prof)
        out["builds"][name] = row
        digests[name] = artifact_digests(d)
    os.unlink(corpus)
    shared = sorted(set(digests["radix"]) & set(digests["legacy"])
                    & set(digests["oneshot"]))
    store_only = sorted(set(digests["radix"]) - set(digests["oneshot"]))
    if store_only != ["docstore-idx.npz", "docstore.bin"] or set(
            digests["legacy"]) != set(digests["oneshot"]):
        raise AssertionError(f"the builds' artifact sets differ: "
                             f"{ {k: sorted(v) for k, v in digests.items()} }")
    differ = [n for n in shared
              if len({digests[b][n] for b in digests}) != 1]
    if differ:
        raise AssertionError(f"radix, legacy and one-shot artifacts differ "
                             f"in {differ}")
    out["identical_artifacts"] = len(shared)
    out["sha256"] = {n: digests["radix"][n][:16] for n in shared}
    t0 = time.perf_counter()
    report = verify_index(dirs["radix"])
    out["verify_s"] = time.perf_counter() - t0
    if not report["ok"] or report["bucket_segmented_shards"]:
        raise AssertionError(f"verify_index on the radix build: {report}")
    out["verify"] = report
    for name in ("legacy", "oneshot"):
        shutil.rmtree(dirs[name])
    return out, dirs["radix"]


def phase_crash_resume(card: str, idx: str, work: str, *,
                       device: str) -> dict:
    """The ref corpus built by the streaming radix build (16 buckets)
    with `crash.pass2` injected at its third bucket; the InjectedCrash is
    caught, the build run again with the tokenizer counted: pass 1 must
    not run again, and every artifact must equal the one-shot build's at
    `idx`. An injected crash is the only exception this phase catches."""
    from tpu_ir_torch import faults
    from tpu_ir_torch.corpus import make_corpus
    from tpu_ir_torch.index import streaming

    corpus = os.path.join(work, "ref-resume.trec")
    make_corpus(corpus, seed=0, **REF_CORPUS)
    out_dir = os.path.join(work, "ref-resume-idx")
    kw = dict(num_shards=10, radix_buckets=16, device=device)
    faults.install(faults.parse_plan("crash.pass2:once@3"))
    crashed = False
    try:
        streaming.build_index_streaming(corpus, out_dir, **kw)
    except faults.InjectedCrash:
        crashed = True
    finally:
        faults.install(None)
    if not crashed:
        raise AssertionError("crash.pass2:once@3 never fired")
    spills = sorted(os.listdir(os.path.join(out_dir, streaming.SPILL_DIR)))
    tokenized = []
    real = streaming.make_chunked_tokenizer

    def counting(*a, **k):
        tokenized.append(1)
        return real(*a, **k)

    streaming.make_chunked_tokenizer = counting
    try:
        t0 = time.perf_counter()
        streaming.build_index_streaming(corpus, out_dir, **kw)
        resume_s = time.perf_counter() - t0
    finally:
        streaming.make_chunked_tokenizer = real
    os.unlink(corpus)
    got, want = artifact_digests(out_dir), artifact_digests(idx)
    if tokenized:
        raise AssertionError("the resumed build tokenized the corpus again")
    if got != want:
        raise AssertionError(f"the resumed build differs from the one-shot "
                             f"build in "
                             f"{sorted(n for n in set(got) | set(want) if got.get(n) != want.get(n))}")
    with open(os.path.join(out_dir, "jobs", "TermKGramDocIndexer.json")) as f:
        counters = json.load(f)["counters"]
    shutil.rmtree(out_dir)
    return {"phase": "crash_resume", "card": card, "config": "ref",
            "crash": "crash.pass2:once@3",
            "pair_spills_at_crash": sum(n.startswith("pairs-")
                                        for n in spills),
            "resume_s": resume_s, "tokenized_again": False,
            "pass2_resumed_buckets": counters.get("pass2_resumed_buckets"),
            "identical_to_oneshot": len(got)}


PORT_KERNELS = ("dense_score", "dequant_score", "cold_tier", "hot_stage")


def profile_call(fn) -> dict:
    """One call of `fn` under torch.profiler: device time by kernel name
    and the device's idle share of the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue                       # host ops: their kernels count
        if getattr(evt, "is_user_annotation", False) \
                or evt.key.startswith("tpu_ir_torch."):
            continue                       # a named region spans kernels
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((evt.key, us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    # the port's own kernels, wherever they rank
    port = {name: {"ms": ms, "calls": c} for n, ms, c in rows
            for name in PORT_KERNELS if f"{name}_kernel" in n}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": (1 - device_ms / wall_ms) if wall_ms > 0 else None,
            "port_kernels": port,
            "top": [{"kernel": n[:90], "ms": ms, "calls": c}
                    for n, ms, c in rows[:8]]}


def profile_topk(scorer, q_ids: np.ndarray, k: int, scoring: str) -> dict:
    """One topk call under torch.profiler (profile_call)."""
    return profile_call(lambda: scorer.topk(q_ids, k=k, scoring=scoring))


def scheduled_blocks(scorer, q: np.ndarray) -> tuple[int, int]:
    """(query blocks that skip the hot stage, blocks that run it) of one
    topk of `q`: the MaxScore schedule on the tiered layout with prune,
    every block otherwise."""
    block = scorer._block_size()
    ceil = lambda n: -(-n // block)  # noqa: E731
    if scorer.layout != "sparse" or not scorer.prune:
        return 0, ceil(len(q))
    _, n_free, mode = scorer._skip_plan(q)
    if mode == "all_skip":
        return ceil(len(q)), 0
    if mode == "all_full":
        return 0, ceil(len(q))
    return ceil(n_free), ceil(len(q) - n_free)


def oracle_topk(q: np.ndarray, df: np.ndarray, pair_doc: np.ndarray,
                pair_tf: np.ndarray, num_docs: int, k: int, *,
                scoring: str = "tfidf", doc_len: np.ndarray | None = None):
    """Exhaustive TF-IDF or BM25 over the host postings columns, float64
    sums of float32 per-posting weights: (docnos [k'], scores
    [num_docs+1]) of one query. BM25 needs doc_len [num_docs+1]."""
    f32 = np.float32
    indptr = np.concatenate([[0], np.cumsum(df, dtype=np.int64)])
    dff = np.maximum(df, 1).astype(f32)
    if scoring == "bm25":
        n = f32(num_docs)
        idf = np.log(f32(1) + (n - df.astype(f32) + f32(0.5))
                     / (df.astype(f32) + f32(0.5)))
        dl = doc_len.astype(f32)
        avg_dl = dl.sum(dtype=f32) / max(n, f32(1))
        dl_norm = f32(1 - BM25_B) + f32(BM25_B) * dl / max(avg_dl, f32(1e-9))
    else:
        idf = np.log10(f32(num_docs) / dff)
    idf = np.where(df > 0, idf, 0).astype(f32)
    scores = np.zeros(num_docs + 1, np.float64)
    for t in q:
        if t < 0 or t >= len(df):
            continue
        lo, hi = indptr[t], indptr[t + 1]
        tf = pair_tf[lo:hi].astype(f32)
        docs = pair_doc[lo:hi]
        if scoring == "bm25":
            cell = tf * f32(K1 + 1) / np.maximum(
                tf + f32(K1) * dl_norm[docs], f32(1e-9))
        else:
            cell = f32(1) + np.log(tf)
        np.add.at(scores, docs, (cell * idf[t]).astype(np.float64))
    scores[0] = 0.0
    order = np.lexsort((np.arange(num_docs + 1), -scores))
    top = [int(d) for d in order[:k] if scores[d] > 0]
    return top, scores


def oracle_check(scorer, postings: tuple, q_ids: np.ndarray,
                 scores: np.ndarray, docnos: np.ndarray, *, scoring: str,
                 k: int) -> dict:
    """recall@k and the worst relative score error of ORACLE_QUERIES
    sampled rows against the exhaustive oracle over the index's host
    postings (df, pair_doc, pair_tf); documents tied with the oracle's
    k-th score (within ORACLE_RTOL) are interchangeable."""
    df, pair_doc, pair_tf = postings
    doc_len = scorer.doc_len.cpu().numpy()
    sample = np.random.default_rng(2).choice(len(q_ids), ORACLE_QUERIES,
                                             replace=False)
    recalls, worst_rel = [], 0.0
    for qi in sample:
        top, oscores = oracle_topk(q_ids[qi], df, pair_doc, pair_tf,
                                   scorer.meta.num_docs, k, scoring=scoring,
                                   doc_len=doc_len)
        got = [int(d) for d in docnos[qi] if d > 0]
        if not top:
            recalls.append(1.0 if not got else 0.0)
            continue
        cut = oscores[top[-1]] * (1 - ORACLE_RTOL)
        hits = sum(1 for d in got if oscores[d] >= cut)
        recalls.append(min(hits, len(top)) / len(top))
        for sc, d in zip(scores[qi], docnos[qi]):
            if d > 0:
                worst_rel = max(worst_rel, abs(sc - oscores[d])
                                / max(oscores[d], 1e-30))
    recall = float(np.mean(recalls))
    if recall < 1.0 or worst_rel > ORACLE_RTOL:
        raise AssertionError(f"{scoring} oracle check failed: recall@{k} "
                             f"{recall}, max rel score error {worst_rel}")
    return {"recall_at_10": recall, "max_rel_err": worst_rel}


def phase_serve(card: str, idx: str, *, device: str, config: str = "ref",
                k: int = 10):
    """Load the index with layout "auto" and serve it. Counts kernel
    launches from the load to the end of the timed topk calls, the main
    path's window. Returns (report, scorer, query ids, {scoring: (scores,
    docnos)}). The CPU test shrinks the query load through REF_QUERIES
    and ORACLE_QUERIES, test hooks only."""
    import torch

    import tpu_ir_torch
    from tpu_ir_torch.search import Scorer

    n_queries = REF_QUERIES
    on_cuda = device == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize()

    tpu_ir_torch.reset_kernel_launches()
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scorer = Scorer.load(idx, device=device)
    sync()
    load_s = time.perf_counter() - t0
    if scorer.layout != LAYOUTS[config]:
        raise AssertionError(f"{config}: layout {scorer.layout!r}, "
                             f"expected {LAYOUTS[config]!r}")
    resident = torch.cuda.memory_allocated() if on_cuda else None
    load_peak = torch.cuda.max_memory_allocated() if on_cuda else None
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()

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
    results, walls, per_topk, blockmax = {}, {}, {}, {}
    for scoring in ("tfidf", "bm25"):
        scorer.topk(q_ids, k=k, scoring=scoring)     # warm-up
        before = tpu_ir_torch.kernel_launches()
        stats = dict(scorer.blockmax_stats)
        t0 = time.perf_counter()
        results[scoring] = scorer.topk(q_ids, k=k, scoring=scoring)
        walls[scoring] = time.perf_counter() - t0    # host arrays: synced
        after = tpu_ir_torch.kernel_launches()
        per_topk[scoring] = {n: after[n] - before[n] for n in after}
        blockmax[scoring] = {n: v - stats[n]
                             for n, v in scorer.blockmax_stats.items()}
    launches = tpu_ir_torch.kernel_launches()
    peak = torch.cuda.max_memory_allocated() if on_cuda else None
    profiles = ({s: profile_topk(scorer, q_ids, k, s)
                 for s in ("tfidf", "bm25")} if on_cuda else None)

    for scoring, (sc, dn) in results.items():
        if sc.shape != (n_queries, k) or dn.shape != (n_queries, k) \
                or not np.isfinite(sc).all():
            raise AssertionError(f"{scoring} topk returned malformed scores")
    kernels = (("cold_tier", "hot_stage") if scorer.layout == "sparse" else
               ("dense_score",) if scorer.doc_matrix is not None
               else ("dequant_score",))
    for kernel in kernels:
        if on_cuda and launches[kernel] == 0:
            raise AssertionError(f"the serve phase never launched {kernel}")
    skip_blocks, full_blocks = scheduled_blocks(scorer, q_ids)
    if on_cuda and scorer.layout == "sparse" and any(
            (c["cold_tier"], c["hot_stage"])
            != (skip_blocks + full_blocks, full_blocks)
            for c in per_topk.values()):
        raise AssertionError(
            f"the cold stage must launch once per query block and the hot "
            f"stage once per block that holds hot terms ({skip_blocks} + "
            f"{full_blocks} a topk): {per_topk}")
    if on_cuda and resident < MIN_RESIDENT[config]:
        raise AssertionError(f"only {resident} bytes resident on the card; "
                             f"{config} should hold > "
                             f"{MIN_RESIDENT[config]:.0f}")
    # the oracle reads the postings from the part files itself: the
    # scorer keeps none on the host
    from tpu_ir_torch.search.scorer import _assemble_csr

    postings = _assemble_csr(idx, scorer.meta)
    oracle = {s: oracle_check(scorer, postings, q_ids, *results[s],
                              scoring=s, k=k)
              for s in ("tfidf", "bm25")}
    del postings

    out = {"phase": "serve", "card": card, "config": config,
           "load_s": load_s, "layout": scorer.layout,
           "tf_dtype": str(scorer.tf_dtype),
           "block": scorer._block_size(), "resident_bytes": resident,
           "load_peak_bytes": load_peak, "peak_bytes": peak,
           "text_hits": text_hits,
           "queries": n_queries, "k": k,
           "tfidf_s": walls["tfidf"], "tfidf_qps": n_queries / walls["tfidf"],
           "bm25_s": walls["bm25"], "bm25_qps": n_queries / walls["bm25"],
           "launches": launches, "launches_per_topk": per_topk,
           "blocks_skip_hot_full": [skip_blocks, full_blocks],
           "prune_diag": scorer.prune_diag(q_ids),
           "blockmax_per_topk": blockmax,
           "oracle_queries": ORACLE_QUERIES,
           "recall_at_10": min(o["recall_at_10"] for o in oracle.values()),
           "oracle_max_rel_err": max(o["max_rel_err"]
                                     for o in oracle.values()),
           "oracle": oracle, "profile": profiles}
    if scorer.layout == "sparse":
        out["tiers"] = {
            "hot_rows": int(scorer.hot_tfs.shape[0]),
            "strip_bytes": (scorer.hot_tfs.numel()
                            * scorer.hot_tfs.element_size()),
            "caps_rows": [[int(t.shape[1]), int(t.shape[0])]
                          for t in scorer.cold_tiers.docs],
            "tier_bytes": sum(t.numel() * 4 for t in scorer.cold_tiers.docs
                              + scorer.cold_tiers.tfs),
            "weighted_strip_cached": sorted(scorer._wstrip_cache)}
    return out, scorer, q_ids, results


def same_ranking(want: tuple, got: tuple, rtol: float = ORACLE_RTOL
                 ) -> tuple[float, int]:
    """(max relative score difference, rows whose ids differ) of two
    [B, k] top-k results. Ids may differ only inside a run of adjacent
    reference scores within `rtol`; a run that reaches the k-th slot may
    continue past it, so there only its length counts."""
    ws, wd = want
    gs, gd = got
    rel = np.abs(gs.astype(np.float64) - ws) / np.maximum(np.abs(ws), 1e-30)
    bad = 0
    for i in np.nonzero((wd != gd).any(axis=1))[0]:
        j0 = 0
        while j0 < ws.shape[1]:
            j = j0 + 1
            while j < ws.shape[1] and abs(ws[i, j] - ws[i, j - 1]) <= \
                    rtol * max(abs(ws[i, j - 1]), 1e-30):
                j += 1
            if (j < ws.shape[1] or j - j0 == 1) and \
                    set(wd[i, j0:j]) != set(gd[i, j0:j]):
                bad += 1
                break
            j0 = j
    return float(rel.max(initial=0.0)), bad


def phase_sparse_check(card: str, idx: str, q_ids: np.ndarray,
                       dense: dict, *, device: str, k: int = 10) -> dict:
    """The ref index on the tiered sparse layout against the dense
    layout's top-k on the same queries, row by row."""
    import tpu_ir_torch
    from tpu_ir_torch.search import Scorer

    tpu_ir_torch.reset_kernel_launches()
    scorer = Scorer.load(idx, layout="sparse", device=device)
    out = {"phase": "sparse_check", "card": card, "config": "ref",
           "hot_rows": int(scorer.hot_tfs.shape[0]),
           "tiers": len(scorer.cold_tiers)}
    for scoring in ("tfidf", "bm25"):
        rel, bad = same_ranking(dense[scoring],
                                scorer.topk(q_ids, k=k, scoring=scoring))
        if rel > ORACLE_RTOL or bad:
            raise AssertionError(f"ref {scoring}: the sparse layout "
                                 f"disagrees with the dense one (max rel "
                                 f"{rel}, {bad} rows with other ids)")
        out[scoring] = {"max_rel_diff": rel, "rows_with_other_ids": bad}
    out["launches"] = tpu_ir_torch.kernel_launches()
    if device == "cuda" and out["launches"]["cold_tier"] == 0:
        raise AssertionError("the sparse check never launched cold_tier")
    return out


def part_bytes(idx: str) -> int:
    return sum(os.path.getsize(os.path.join(idx, f))
               for f in os.listdir(idx) if f.startswith("part-"))


def phase_compress(card: str, idx: str, work: str, *, config: str
                   ) -> tuple[dict, str]:
    """A copy of a built index compressed in place by migrate_index
    (format v3, tf_dtype "auto"). Returns (report, the copy's dir)."""
    from tpu_ir_torch.index.migrate import migrate_index

    v3 = os.path.join(work, f"{config}-v3-idx")
    shutil.copytree(idx, v3)
    before = part_bytes(v3)
    t0 = time.perf_counter()
    info = migrate_index(v3, to_version=3, tf_dtype="auto")
    seconds = time.perf_counter() - t0
    after = part_bytes(v3)
    return {"phase": "compress", "card": card, "config": config,
            "tf_dtype": info["tf_dtype"], "tf_lossy": info["tf_lossy"],
            "migrated": info["migrated"], "seconds": seconds,
            "part_bytes_before": before, "part_bytes_after": after,
            "ratio": before / after}, v3


def phase_serve_v3(card: str, idx: str, raw: dict, *, device: str,
                   config: str, k: int = 10):
    """phase_serve on a compressed copy, held to the raw index's serve:
    the raw tfs resident in bf16, the layout's kernel launched (on the
    dense layout TF-IDF through dequant_score and never dense_score), and
    the top-k bitwise equal to `raw`'s ({scoring: (scores, docnos)}) for
    both scorings. Returns (report, scorer)."""
    import torch

    out, scorer, _, results = phase_serve(card, idx, device=device,
                                          config=config, k=k)
    if scorer.tf_dtype != torch.bfloat16:
        raise AssertionError(f"{config}: tfs resident as {scorer.tf_dtype}, "
                             "expected torch.bfloat16")
    if scorer.layout == "dense":
        if scorer.doc_matrix is not None or \
                scorer._tf_matrix.dtype != torch.bfloat16:
            raise AssertionError(f"{config}: the dense layout must hold one "
                                 "bf16 raw-tf matrix and nothing else")
        out["matrix_bytes"] = (scorer._tf_matrix.numel()
                               * scorer._tf_matrix.element_size())
        if device == "cuda" and (
                out["launches_per_topk"]["tfidf"]["dequant_score"] < 1
                or out["launches"]["dense_score"] != 0):
            raise AssertionError(f"{config}: TF-IDF must run dequant_score "
                                 f"and never dense_score: "
                                 f"{out['launches']}")
    elif scorer.hot_tfs.dtype != torch.bfloat16:
        raise AssertionError(f"{config}: the hot strip must be bf16")
    out["bitwise_equal_to_raw"] = {}
    for scoring, (sc, dn) in results.items():
        rs, rd = raw[scoring]
        same = np.array_equal(dn, rd) and sc.tobytes() == rs.tobytes()
        if not same:
            rows = int(((dn != rd) | (sc.view(np.int32)
                                      != rs.view(np.int32))).any(1).sum())
            raise AssertionError(f"{config} {scoring}: top-{k} differs from "
                                 f"the raw index's in {rows} rows")
        out["bitwise_equal_to_raw"][scoring] = same
    return out, scorer


COLD_EDGE_WIDTH = 5_001        # D+1 of the cold-tier edge cases
# tier caps of the edge cases, in tier order (0: an empty tier): caps 1 and
# 4,096, warp tiers before block-wide ones (cap >= 2048) as in a real
# layout; then a wide tier before narrow ones, and an empty tier among the
# block-wide ones
COLD_EDGE_CAPS = (1, 2, 8, 0, 32, 512, 4096)
COLD_EDGE_ORDERS = ((4096, 1, 512, 2), (2, 512, 0, 4096))
COLD_SHARED_DOC = 7            # the doc the (tier, l)-order query hits


def cold_edge_case(seed: int, batch: int, terms: int, device, *,
                   caps=COLD_EDGE_CAPS, width: int = COLD_EDGE_WIDTH):
    """One cold-stage edge case on `device`: (start scores float32
    [B, width] uniform in [0, 1), q_tier, rows int32 [B, L], q_w float32
    [B, L], a TierTable of `caps`, dl_norm float32 [width]). Rows hold
    distinct docs, some past D (dropped), and tf = 0 slots anywhere in the
    row. Query 0 puts its terms in the non-empty tiers from the last one
    down, each row holding COLD_SHARED_DOC, so that the (tier, l) order
    decides the bits; query 1 puts all its terms in one tier; other terms
    are random, with tier -1, past the table or in an empty tier, rows
    past V_t and negative, and zero weights. The same arguments give the
    same case."""
    import torch

    from tpu_ir_torch.ops.cold_tier import TierTable

    rng = np.random.default_rng(seed)
    docs, tfs = [], []
    for cap in caps:
        v_t = int(rng.integers(3, 9)) if cap else 0
        d = np.zeros((v_t, cap), np.int32)
        f = np.zeros((v_t, cap), np.int32)
        for r in range(v_t):
            d[r] = rng.choice(np.arange(1, width + 40), cap, replace=False)
            f[r] = rng.integers(1, 300, cap)
            f[r, rng.random(cap) < 0.2] = 0
        if v_t:                  # row 0 holds the shared doc, first slot
            d[0, d[0] == COLD_SHARED_DOC] = width + 40
            d[0, 0], f[0, 0] = COLD_SHARED_DOC, 3
        docs.append(d)
        tfs.append(f)
    full = [t for t, cap in enumerate(caps) if cap]
    n_t = len(caps)
    q_tier = rng.choice([-1, n_t + 1] + list(range(n_t)),
                        (batch, terms)).astype(np.int32)
    rows = rng.integers(-2, 12, (batch, terms)).astype(np.int32)
    q_w = rng.uniform(0.05, 2.0, (batch, terms)).astype(np.float32)
    q_w[rng.random((batch, terms)) < 0.1] = 0.0
    order = full[::-1]
    for l in range(min(terms, len(order))):
        q_tier[0, l], rows[0, l], q_w[0, l] = order[l], 0, 0.5 + l
    if batch > 1 and full:
        q_tier[1] = full[len(full) // 2]
        q_w[1] = 1.25
    dl_norm = rng.uniform(0.3, 1.3, width).astype(np.float32)
    start = rng.random((batch, width), np.float32)
    dev = torch.device(device)
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (up(start), up(q_tier), up(rows), up(q_w),
            TierTable([up(a) for a in docs], [up(a) for a in tfs]),
            up(dl_norm))


def cold_edge_checks() -> dict:
    """The cold-tier kernel bitwise against its whole-stage plain twin on
    the card from random starting scores, TF-IDF and BM25: B = 1, 2,499
    and 70,000 by L = 1, 2, 3 and 9 over COLD_EDGE_CAPS, B = 1 and 2,499
    by the wide L of WIDE_TERMS (its term loop turns more than once) and
    B = 70,000 by the widest, the COLD_EDGE_ORDERS, a layout of zero tiers
    and one of MAX_TIERS tiers; one tier more must raise. Its launches
    here are comparisons, not the main path's."""
    import torch

    from tpu_ir_torch.ops import cold_tier

    dev = torch.device("cuda")
    cases = [dict(batch=b, terms=l) for b in (1, 2_499, 70_000)
             for l in (1, 2, 3, 9)]
    cases += [dict(batch=b, terms=l) for b in (1, 2_499) for l in WIDE_TERMS]
    cases += [dict(batch=70_000, terms=WIDE_TERMS[-1])]
    cases += [dict(batch=2_499, terms=3, caps=c) for c in COLD_EDGE_ORDERS]
    cases += [dict(batch=2_499, terms=3, caps=()),
              dict(batch=2_499, terms=9,
                   caps=tuple(range(1, cold_tier.MAX_TIERS + 1)))]
    n = 0
    for i, case in enumerate(cases):
        start, q_tier, rows, q_w, tiers, dl_norm = cold_edge_case(
            i, device=dev, **case)
        for bm25 in (False, True):
            kw = {"dl_norm": dl_norm, "k1": K1} if bm25 else {}
            got, want = start.clone(), start.clone()
            cold_tier.cold_stage(got, q_tier, rows, q_w, tiers, **kw)
            cold_tier.cold_stage_plain(want, q_tier, rows, q_w, tiers, **kw)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(
                    f"cold_tier disagrees with its twin at {case}, "
                    f"bm25={bm25}: max_abs_diff "
                    f"{float((got - want).abs().max())}")
            if case.get("caps", COLD_EDGE_CAPS) and torch.equal(got, start):
                raise AssertionError(f"cold_tier added nothing at {case}")
            n += 1
        del start, got, want
    over = cold_tier.MAX_TIERS + 1
    try:
        cold_tier.TierTable([tiers.docs[0]] * over, [tiers.tfs[0]] * over)
    except ValueError:
        pass
    else:
        raise AssertionError(f"a table of {over} tiers must raise")
    torch.cuda.empty_cache()
    return {"cases": n, "max_abs_diff": 0.0}


HOT_EDGE_ROWS = 37             # H of the hot-stage edge cases


def hot_edge_case(seed: int, batch: int, terms: int, width: int, device,
                  *, strip_rows: int = HOT_EDGE_ROWS):
    """One hot-stage edge case on `device`: (start scores float32 [B,
    width] in [0, 1), slot rows int32 [B, L], weights float32 [B, L], a
    weighted strip float32 [H, width] with 30% zero cells). The slots come
    from hot_slots over random terms (60% hot, 10% zero weights), so
    repeated terms are folded as in serving; then some slots get rows
    past H, which add nothing. Query 0 holds no hot slot and starts at
    -0.0 everywhere, which must stay; query 1 repeats one hot row, with
    no zero cell, in every slot. The same arguments give the same
    case."""
    import torch

    from tpu_ir_torch.ops.hot_stage import hot_slots

    rng = np.random.default_rng(seed)
    rank = rng.integers(0, strip_rows, (batch, terms)).astype(np.int32)
    is_hot = rng.random((batch, terms)) < 0.6
    q_w = rng.uniform(0.05, 2.0, (batch, terms)).astype(np.float32)
    q_w[rng.random((batch, terms)) < 0.1] = 0.0
    is_hot[0] = False
    if batch > 1:
        rank[1], is_hot[1], q_w[1] = rank[1, 0], True, 1.25
    rows, w = hot_slots(*(torch.from_numpy(a) for a in (rank, is_hot, q_w)))
    rows = rows.numpy()
    past = (rng.random((batch, terms)) < 0.05) & (rows >= 0)
    past[1:2] = False
    rows[past] = strip_rows + 3
    strip = rng.uniform(0.0, 4.0, (strip_rows, width)).astype(np.float32)
    strip[rng.random((strip_rows, width)) < 0.3] = 0.0
    strip[rank[min(batch - 1, 1), 0]] += 0.5
    start = rng.random((batch, width), np.float32)
    start[0] = -0.0
    dev = torch.device(device)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return up(start), up(rows), w.to(dev), up(strip)


def cold_inputs(scorer, q, scoring_name: str):
    """A query block's per-term arrays (TieredTerms) and BM25's dl_norm
    (None for TF-IDF) for the cold stage on `scorer`'s layout."""
    from tpu_ir_torch.ops import scoring

    n = scorer.meta.num_docs
    if scoring_name == "bm25":
        weights = scoring.bm25_idf_weights(scorer.df, n)
        dl_norm = scoring.bm25_dl_norm(scorer.doc_len, n, BM25_B)
    else:
        weights = scoring.idf_weights(scorer.df, n, scorer.compat_int_idf)
        dl_norm = None
    return scoring.tiered_terms(q, scorer.hot_rank, scorer.tier_of,
                                scorer.row_of, weights), dl_norm


def cold_tier_alone(idx: str, q_block: np.ndarray) -> dict:
    """Kernel 3 alone (kernel_alone) over the cold stage of `q_block` on
    the index `idx`, TF-IDF and BM25, each launch one whole stage onto a
    freshly zeroed [B, D+1] accumulator, as serving launches it: the 1 GB
    memset leaves no row or score sector of the last launch in L2 (the
    memset is another kernel, not counted). Run in a fresh process: late
    in this script's own process (some ten minutes and nine profiler
    sessions in) a session holding only these launches twice traced no
    device event at all, with or without CPU activity, while a fresh
    process's sessions traced every launch."""
    import torch

    from tpu_ir_torch.ops import cold_tier
    from tpu_ir_torch.search import Scorer

    scorer = Scorer.load(idx, device="cuda")
    q = torch.from_numpy(q_block).to(scorer.device)
    out = {}
    for name in ("tfidf", "bm25"):
        terms, dl_norm = cold_inputs(scorer, q, name)
        acc = torch.zeros((q.shape[0], scorer.meta.num_docs + 1),
                          device=scorer.device)

        def stage():
            acc.zero_()
            cold_tier.cold_stage(acc, terms.tier, terms.row, terms.q_w,
                                 scorer.cold_tiers, dl_norm=dl_norm, k1=K1)

        out[name] = kernel_alone(stage, "cold_tier")
    return out


def phase_cold_tier(card: str, scorer, idx: str, q_block: np.ndarray
                    ) -> dict:
    """Kernel 3 (cold_tier) against its plain twin over the whole cold
    stage (every tier, in order, one launch) of one query block of the
    index `idx` loaded as `scorer`, TF-IDF and BM25, with the wrapper's
    time, the kernel's time alone (cold_tier_alone, in a child process),
    the twin's and one library yardstick's; then at the edge cases
    (cold_edge_checks)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from tpu_ir_torch.ops import cold_tier, scoring

    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as ex:
        alone_by_scoring = ex.submit(cold_tier_alone, idx, q_block).result()
    dev = scorer.device
    n = scorer.meta.num_docs
    width = n + 1
    tiers = scorer.cold_tiers
    launches_before = cold_tier.cold_tier_launches()
    q = torch.from_numpy(q_block).to(dev)
    b, num_terms = q_block.shape
    out = {"phase": "kernels", "card": card, "name": "cold_tier",
           "shape": {"B": b, "L": num_terms, "D+1": width,
                     "caps_rows": [[int(t.shape[1]), int(t.shape[0])]
                                   for t in tiers.docs]},
           "tolerance": KERNEL_TOL}
    for name in ("tfidf", "bm25"):
        terms, dl_norm = cold_inputs(scorer, q, name)

        def stage(acc, fn):
            fn(acc, terms.tier, terms.row, terms.q_w, tiers,
               dl_norm=dl_norm, k1=K1)

        got = torch.zeros((b, width), device=dev)
        stage(got, cold_tier.cold_stage)
        want = torch.zeros((b, width), device=dev)
        stage(want, cold_tier.cold_stage_plain)
        torch.cuda.synchronize()
        max_abs = float((got - want).abs().max())
        if not torch.isfinite(got).all() or max_abs > KERNEL_TOL \
                or not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
            raise AssertionError(f"cold_tier ({name}) disagrees with its "
                                 f"plain twin: max_abs_diff {max_abs}")
        if not got.any():
            raise AssertionError("the cold stage scored nothing")
        acc = torch.zeros_like(got)
        ms = cuda_ms(lambda: stage(acc, cold_tier.cold_stage))
        alone = alone_by_scoring[name]
        plain_ms = cuda_ms(lambda: stage(acc, cold_tier.cold_stage_plain))

        # yardstick only (the port never calls it): one scatter_add_ per
        # tier over precomputed [B, L*P_t] slots and cell weights
        slots, vals = [], []
        bytes_moved, ops, postings = 0, 0, 0
        for i, (tdocs, ttfs) in enumerate(zip(tiers.docs, tiers.tfs)):
            in_tier = terms.tier == i
            rows, w = cold_tier.tier_rows_and_weights(
                terms.tier, terms.row, terms.q_w, i, tdocs.shape[0])
            docs = tdocs[rows.long()].long()              # [B, L, P_t]
            tfs = ttfs[rows.long()]
            cell = (scoring._lntf(tfs) if dl_norm is None else
                    scoring.bm25_saturation(tfs, dl_norm[docs], k1=K1))
            cell = torch.where(tfs > 0, cell, 0.0) * w[..., None]
            slots.append(torch.where(tfs > 0, docs, width).reshape(b, -1))
            vals.append(cell.reshape(b, -1))
            # least bytes: each needed row read once, each posting's score
            # read and written once (and its dl_norm read, for BM25), the
            # rows and weights read once
            need = in_tier & (terms.q_w != 0)
            nnz = int((ttfs[terms.row[need].long()] > 0).sum())
            postings += nnz
            bytes_moved += (int(need.sum()) * tdocs.shape[1] * 8
                            + nnz * (8 if dl_norm is None else 12)
                            + b * num_terms * 8)
            ops += nnz * (3 if dl_norm is None else 6)
        del docs, tfs, cell
        buf = torch.zeros((b, width + 1), device=dev)
        for sl, va in zip(slots, vals):
            buf.scatter_add_(1, sl, va)
        lib_diff = float((buf[:, :width] - want).abs().max())
        library_ms = cuda_ms(lambda: [buf.scatter_add_(1, sl, va)
                                      for sl, va in zip(slots, vals)])
        del slots, vals, buf, acc, got, want
        bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = ops / FP32_FLOP_PER_S * 1e3
        bound = {"bound_ms": max(bound_bytes_ms, bound_ops_ms),
                 "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                              else "operations"),
                 "bound_bytes": bytes_moved}
        # a scattered score cell moves a 32-byte sector to be read and one
        # to be written, and BM25's dl_norm one more: not in the bound
        sectors = postings * 32 * (2 if dl_norm is None else 3)
        out[name] = {
            "max_abs_diff": max_abs, "ms": ms, **bandwidth(bound, alone),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "torch.Tensor.scatter_add_ per tier over "
                       "precomputed [B, L*P_t] slots",
            "library_max_abs_diff": lib_diff, **bound,
            "postings": postings, "sector_bytes": sectors}
        torch.cuda.empty_cache()
    out["edge_checks"] = cold_edge_checks()
    out["launches_while_comparing"] = (cold_tier.cold_tier_launches()
                                       - launches_before)
    return out


def same_bits(a: tuple, b: tuple) -> bool:
    """Whether two (scores, docnos) host results are bitwise equal."""
    return (np.array_equal(a[1], b[1])
            and np.asarray(a[0]).tobytes() == np.asarray(b[0]).tobytes())


def hot_traffic(scorer, n: int, seed: int = 3) -> np.ndarray:
    """int32 [n, 2] queries of one hot term and one cold term of df
    30-300 (the `mixed` regime of tests/test_blockmax.py, where
    block-max is meant to engage), both uniform over their sets."""
    rng = np.random.default_rng(seed)
    hot_rank = scorer._hot_rank_host
    df = scorer._df_host
    hot = np.nonzero(hot_rank >= 0)[0]
    mid = np.nonzero((hot_rank < 0) & (df >= 30) & (df <= 300))[0]
    if not len(mid):                 # a small test index: any cold term
        mid = np.nonzero((hot_rank < 0) & (df > 0))[0]
    return np.stack([rng.choice(hot, n), rng.choice(mid, n)],
                    axis=1).astype(np.int32)


def phase_prune(card: str, scorer, idx: str, q_ids: np.ndarray, *,
                traffic: str, device: str, batch: int | None = None,
                k: int = 10) -> dict:
    """The tiered layout's batch `q_ids` served with prune on (the
    MaxScore schedule and block-max, the default) and off, on one scorer
    with the flag toggled, TF-IDF and BM25: q/s, launches by kernel,
    block-max's stats, prune_diag and (whole batches on the card) device
    time and idle share of one profiled topk. `batch` serves the queries
    in batches of that size. Fails unless on == off bitwise and, for the
    prune-on results, recall@10 = 1.0 against the float64 oracle."""
    import tpu_ir_torch
    from tpu_ir_torch.search.scorer import _assemble_csr

    size = batch or len(q_ids)

    def run(scoring):
        parts = [scorer.topk(q_ids[lo:lo + size], k=k, scoring=scoring)
                 for lo in range(0, len(q_ids), size)]
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    out = {"phase": "prune", "card": card, "config": "wiki100k",
           "traffic": traffic, "queries": len(q_ids), "batch": size, "k": k}
    results = {}
    for prune in (True, False):
        scorer.prune = prune
        row = {"prune_diag": scorer.prune_diag(q_ids[:size]),
               "blocks_skip_hot_full": scheduled_blocks(scorer,
                                                        q_ids[:size])}
        for scoring in ("tfidf", "bm25"):
            run(scoring)                                  # warm-up
            before = tpu_ir_torch.kernel_launches()
            stats = dict(scorer.blockmax_stats)
            t0 = time.perf_counter()
            results[prune, scoring] = run(scoring)
            wall = time.perf_counter() - t0
            after = tpu_ir_torch.kernel_launches()
            bm = {n: v - stats[n] for n, v in scorer.blockmax_stats.items()}
            row[scoring] = {
                "s": wall, "qps": len(q_ids) / wall,
                "launches": {n: after[n] - before[n] for n in after},
                "blockmax": bm,
                "masked_share": (bm["blocks_masked"]
                                 / bm["blocks_considered"]
                                 if bm["blocks_considered"] else None)}
            if device == "cuda" and batch is None:
                row[scoring]["profile"] = profile_topk(scorer, q_ids, k,
                                                       scoring)
        out["on" if prune else "off"] = row
    scorer.prune = True
    out["bitwise_on_equals_off"] = {}
    for scoring in ("tfidf", "bm25"):
        on, off = results[True, scoring], results[False, scoring]
        if not same_bits(on, off):
            rows = int(((on[1] != off[1]) | (on[0].view(np.int32)
                                             != off[0].view(np.int32))
                        ).any(1).sum())
            raise AssertionError(f"{traffic} {scoring}: prune on differs "
                                 f"from prune off in {rows} rows")
        out["bitwise_on_equals_off"][scoring] = True
    if batch is None:
        postings = _assemble_csr(idx, scorer.meta)
        oracle = {s: oracle_check(scorer, postings, q_ids,
                                  *results[True, s], scoring=s, k=k)
                  for s in ("tfidf", "bm25")}
        del postings
        out["recall_at_10"] = min(o["recall_at_10"] for o in oracle.values())
        out["oracle"] = oracle
    return out


def phase_rerank(card: str, scorer, q_ids: np.ndarray, *, config: str,
                 device: str, want: tuple | None = None,
                 bitwise: bool = False, k: int = 10,
                 candidates: int = 1000) -> tuple[dict, tuple]:
    """rerank_topk (BM25 top-`candidates`, then cosine TF-IDF, k = 10) over
    `q_ids` on a loaded scorer: q/s, launches by kernel, and on the card
    device time and idle share of one profiled rerank. The doc norms are
    computed in a first, untimed call. With `want`, the result must equal
    it bitwise (`bitwise`) or rank alike with scores within rtol 1e-6.
    Returns (report, (scores, docnos))."""
    import tpu_ir_torch

    t0 = time.perf_counter()
    scorer.rerank_topk(q_ids[:64], k=k, candidates=candidates)
    setup_s = time.perf_counter() - t0
    before = tpu_ir_torch.kernel_launches()
    t0 = time.perf_counter()
    result = scorer.rerank_topk(q_ids, k=k, candidates=candidates)
    wall = time.perf_counter() - t0
    after = tpu_ir_torch.kernel_launches()
    sc, dn = result
    if sc.shape != (len(q_ids), k) or not np.isfinite(sc).all() \
            or not (dn > 0).any():
        raise AssertionError(f"{config}: the rerank returned malformed "
                             "results")
    out = {"phase": "rerank", "card": card, "config": config,
           "layout": scorer.layout, "queries": len(q_ids), "k": k,
           "candidates": candidates, "norms_and_warmup_s": setup_s,
           "s": wall, "qps": len(q_ids) / wall,
           "launches": {n: after[n] - before[n] for n in after}}
    if device == "cuda":
        out["profile"] = profile_call(lambda: scorer.rerank_topk(
            q_ids, k=k, candidates=candidates))
    if want is not None:
        if bitwise:
            if not same_bits(want, result):
                raise AssertionError(f"{config}: the rerank differs from "
                                     "the reference bitwise")
            out["bitwise_equal"] = True
        else:
            rel, bad = same_ranking(want, result, rtol=1e-6)
            if rel > 1e-6 or bad:
                raise AssertionError(f"{config}: the rerank disagrees (max "
                                     f"rel {rel}, {bad} rows with other "
                                     "ids)")
            out["max_rel_diff"], out["rows_with_other_ids"] = rel, bad
    return out, result


def hot_inputs(scorer, q_block: np.ndarray):
    """A TF-IDF query block's hot-stage inputs on `scorer`'s tiered
    layout: (base float32 [B, D+1], the block's cold partial; slot rows
    and weights [B, L]; the float32 (1 + ln tf) strip [H, D+1])."""
    import torch

    from tpu_ir_torch.ops import scoring
    from tpu_ir_torch.ops.hot_stage import hot_slots

    q = torch.from_numpy(q_block).to(scorer.device)
    terms, _ = cold_inputs(scorer, q, "tfidf")
    base = torch.zeros((q.shape[0], scorer.meta.num_docs + 1),
                       device=scorer.device)
    scoring.cold_stage(base, terms, scorer.cold_tiers)
    rows, w = hot_slots(terms.rank, terms.is_hot, terms.q_w)
    return base, rows, w, scoring._lntf(scorer.hot_tfs)


def hot_stage_alone(idx: str, q_block: np.ndarray) -> dict:
    """The hot-stage kernel alone (kernel_alone) on `q_block`'s inputs
    (hot_inputs) over the whole strip, each launch onto a fresh copy of
    the cold partial, as serving adds to a partial the cold stage just
    wrote; run in a fresh process, as cold_tier_alone is."""
    from tpu_ir_torch.ops import hot_stage
    from tpu_ir_torch.search import Scorer

    scorer = Scorer.load(idx, device="cuda")
    base, rows, w, strip = hot_inputs(scorer, q_block)
    acc = base.clone()

    def stage():
        acc.copy_(base)
        hot_stage.hot_stage(acc, rows, w, strip)

    return kernel_alone(stage, "hot_stage")


def hot_edge_checks() -> dict:
    """The hot-stage kernel bitwise against its twin on the card at the
    edge cases (hot_edge_case): B = 1, 2,499 and 70,000 by L = 1, 2, 3, 9
    and 40 at N = 1 and 4,097, and B = 1 and 2,499 at the wiki100k width
    N = 100,001; then the wide L of WIDE_TERMS (repeated hot terms folded
    into their first slot) at B = 1 and 2,499 by N = 4,097 and 100,001,
    and B = 70,000 by the widest at N = 4,097. Its launches here are
    comparisons, not the main path's."""
    import torch

    from tpu_ir_torch.ops import hot_stage

    dev = torch.device("cuda")
    cases = [(b, l, n) for b in (1, 2_499, 70_000) for l in (1, 2, 3, 9, 40)
             for n in (1, 4_097)]
    cases += [(b, l, 100_001) for b in (1, 2_499) for l in (1, 2, 3, 9, 40)]
    cases += [(b, l, n) for b in (1, 2_499) for l in WIDE_TERMS
              for n in (4_097, 100_001)]
    cases += [(70_000, WIDE_TERMS[-1], 4_097)]
    for i, (b, l, n) in enumerate(cases):
        start, rows, w, strip = hot_edge_case(i, b, l, n, dev)
        got, want = start.clone(), start.clone()
        hot_stage.hot_stage(got, rows, w, strip)
        hot_stage.hot_stage_plain(want, rows, w, strip)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(
                f"hot_stage disagrees with its twin at B {b}, L {l}, N {n}:"
                f" max_abs_diff {float((got - want).abs().max())}")
        if not torch.equal(got[0].view(torch.int32),
                           start[0].view(torch.int32)):
            raise AssertionError(f"hot_stage changed a query with no hot "
                                 f"slot at B {b}, L {l}, N {n}")
        if b > 1 and torch.equal(got[1], start[1]):
            raise AssertionError(f"hot_stage added nothing at B {b}, L {l},"
                                 f" N {n}")
        del start, got, want, rows, w, strip
    torch.cuda.empty_cache()
    return {"cases": len(cases), "max_abs_diff": 0.0}


def hot_bound(rows, strip, width: int) -> dict:
    """The least time of the hot stage on these inputs: each distinct
    strip row the slots reference read once over the `width` columns, the
    score rows of queries with a hot slot read and written once, slots
    read once; a multiply and an add per live slot and column, and one
    add per active score cell."""
    import torch

    live = (rows >= 0) & (rows < strip.shape[0])
    active = int(live.any(dim=1).sum())
    n_rows = int(torch.unique(rows[live]).numel())
    bytes_moved = (n_rows * width * 4 + active * width * 8
                   + rows.numel() * 8)
    ops = (2 * int(live.sum()) + active) * width
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes": bytes_moved, "distinct_rows": n_rows,
            "active_queries": active}


def phase_hot_stage(card: str, scorer, idx: str, q_block: np.ndarray
                    ) -> dict:
    """The hot-stage kernel against its plain twin at wiki100k shapes: one
    block of hot-term queries (every query holds a hot term) over the
    whole (1 + ln tf) strip, N = D+1, and over a block-max column set
    (the budget's blocks, every fourth), where it must also give the
    whole strip's bits at those columns; with the wrapper's time, the
    kernel's time alone (hot_stage_alone, in a child process), the twin's,
    the yardstick torch.matmul(w_hot, strip) at the same shapes, and the
    bound (hot_bound); then the edge cases (hot_edge_checks)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from tpu_ir_torch.ops import hot_stage
    from tpu_ir_torch.ops.scoring import blockmax_cand_blocks

    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as ex:
        alone = ex.submit(hot_stage_alone, idx, q_block).result()
    launches_before = hot_stage.hot_stage_launches()
    base, rows, w, strip = hot_inputs(scorer, q_block)
    b, width = base.shape
    h = strip.shape[0]
    out = {"phase": "kernels", "card": card, "name": "hot_stage",
           "shape": {"B": b, "L": rows.shape[1], "H": h, "N": width},
           "tolerance": KERNEL_TOL}
    if not bool(((rows >= 0).any(dim=1)).all()):
        raise AssertionError("every query of the block must hold a hot term")

    got, want = base.clone(), base.clone()
    hot_stage.hot_stage(got, rows, w, strip)
    hot_stage.hot_stage_plain(want, rows, w, strip)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    if not torch.isfinite(got).all() or not torch.equal(
            got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"hot_stage disagrees with its plain twin: "
                             f"max_abs_diff {max_abs}")
    # timed in place on one accumulator: each call adds the same work
    acc = base.clone()
    ms = cuda_ms(lambda: hot_stage.hot_stage(acc, rows, w, strip))
    plain_ms = cuda_ms(lambda: hot_stage.hot_stage_plain(acc, rows, w,
                                                         strip))
    # yardstick only (the port never calls it): the JAX package's hot
    # product, a [B, H] weight row times the strip
    w_hot = torch.zeros((b, h + 1), device=base.device)
    w_hot.scatter_add_(1, torch.where(rows >= 0, rows, h).long(), w)
    w_hot = w_hot[:, :h].contiguous()
    library_ms = cuda_ms(lambda: torch.matmul(w_hot, strip))
    lib_diff = float((base + torch.matmul(w_hot, strip) - got).abs().max())
    bound = hot_bound(rows, strip, width)
    out["full"] = {"max_abs_diff": max_abs, "ms": ms,
                   **bandwidth(bound, alone), "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "library": "torch.matmul(w_hot [B, H], strip [H, D+1])",
                   "library_max_abs_diff": lib_diff, **bound}

    # a block-max column set: the default budget's blocks, every fourth
    bw = scorer._blockmax_width
    cand = blockmax_cand_blocks(10, scorer.meta.num_docs, bw)
    nblk = -(-width // bw)
    sel = torch.arange(0, nblk, max(nblk // cand, 1),
                       device=base.device)[:cand]
    cols = (sel[:, None] * bw + torch.arange(bw, device=base.device)
            ).reshape(-1)
    cols = cols[cols < width]
    sub_strip = strip.index_select(1, cols).contiguous()
    sub_base = base.index_select(1, cols).contiguous()
    sub_got, sub_want = sub_base.clone(), sub_base.clone()
    hot_stage.hot_stage(sub_got, rows, w, sub_strip)
    hot_stage.hot_stage_plain(sub_want, rows, w, sub_strip)
    torch.cuda.synchronize()
    if not (torch.equal(sub_got.view(torch.int32),
                        sub_want.view(torch.int32))
            and torch.equal(sub_got.view(torch.int32),
                            got.index_select(1, cols).view(torch.int32))):
        raise AssertionError("hot_stage over a block-max column set "
                             "disagrees with its twin or the whole strip")
    sub_acc = sub_base.clone()
    sub_bound = hot_bound(rows, sub_strip, len(cols))
    out["blockmax_columns"] = {
        "N": len(cols), "blocks": int(len(sel)), "width": bw,
        "bitwise_equal_to_whole_strip": True,
        "ms": cuda_ms(lambda: hot_stage.hot_stage(sub_acc, rows, w,
                                                  sub_strip)),
        "plain_ms": cuda_ms(lambda: hot_stage.hot_stage_plain(
            sub_acc, rows, w, sub_strip)),
        "library_ms": cuda_ms(lambda: torch.matmul(w_hot, sub_strip)),
        **sub_bound}
    del got, want, acc, sub_got, sub_want, sub_acc, sub_strip, strip
    torch.cuda.empty_cache()
    out["edge_checks"] = hot_edge_checks()
    out["launches_while_comparing"] = (hot_stage.hot_stage_launches()
                                       - launches_before)
    return out


WILDCARD_QUERIES = 2_000        # query texts of each wildcard mix
EXPANSION_SAMPLE = 200         # patterns of a mix held against the oracles
# the questions that raised on a char-gram index before wildcard search
QUEUE3_QUESTIONS = ("how do I sort a list?", "thread*", "pythn~")
KGRAM_QUERIES = 2_000          # two- and three-token texts on the k = 2 index
KGRAM_GLOBS = 200              # glob texts composed over its tokens.txt
KGRAM_PROCS = 4                # tokenizer processes, streaming k = 2 build


def one_edit(rng, word: str) -> str:
    """`word` with one random substitution, insertion or deletion."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    i = int(rng.integers(0, len(word)))
    c = letters[int(rng.integers(0, 26))]
    op = int(rng.integers(0, 3))
    if op == 0:
        return word[:i] + c + word[i + 1:]
    if op == 1:
        return word[:i] + c + word[i:]
    return word[:i] + word[i + 1:]


def wildcard_mixes(terms: list[str], n: int, seed: int = 11) -> dict:
    """The wildcard phase's three traffic mixes over a vocabulary, each
    {"texts": [n texts], "patterns": [(kind, pattern) of each text's
    glob or fuzzy token]}:
    glob: a literal term and a prefix glob (the first 3-5 characters of a
        term, then '*');
    fuzzy: a literal term and a fuzzy token (a term of 4 or more
        characters with one random edit, then '~');
    question: the QUEUE3_QUESTIONS, then two-token texts ending in '?'
        (a question mark, not a glob) whose first token is a literal
        term, a prefix glob or a fuzzy token."""
    rng = np.random.default_rng(seed)
    vocab = np.asarray(terms, dtype=object)
    long_terms = vocab[np.fromiter((len(t) >= 4 for t in terms), bool,
                                   len(terms))]

    def glob():
        t = str(rng.choice(vocab))
        return "glob", t[: int(rng.integers(3, 6))] + "*"

    def fuzzy():
        return "fuzzy", one_edit(rng, str(rng.choice(long_terms)))

    def token(kind_pat):
        kind, pat = kind_pat
        return pat + "~" if kind == "fuzzy" else pat

    out = {}
    for mix, make in (("glob", glob), ("fuzzy", fuzzy)):
        pats = [make() for _ in range(n)]
        out[mix] = {"texts": [f"{rng.choice(vocab)} {token(p)}"
                              for p in pats], "patterns": pats}
    texts, pats = list(QUEUE3_QUESTIONS), []
    for _ in range(n - len(texts)):
        pick = int(rng.integers(0, 3))
        first = (glob() if pick == 0 else fuzzy() if pick == 1 else None)
        if first is not None:
            pats.append(first)
        texts.append(f"{token(first) if first else rng.choice(vocab)} "
                     f"{rng.choice(vocab)}?")
    out["question"] = {"texts": texts, "patterns": pats}
    return out


def glob_oracle(joined: str, pattern: str) -> list[str]:
    """The vocabulary terms (one a line of `joined`, in term order) that
    the glob `pattern` matches as a whole: '*' any run of characters, '?'
    one character, anything else itself."""
    import fnmatch
    import re

    body = "".join("[^\n]*" if c == "*" else "[^\n]" if c == "?"
                   else re.escape(c) for c in pattern)
    got = re.findall(f"(?m)^{body}$", joined)
    if not all(fnmatch.fnmatchcase(t, pattern) for t in got):
        raise AssertionError(f"the glob oracle disagrees with fnmatch on "
                             f"{pattern!r}")
    return got


def terms_by_length(terms: list[str]) -> dict:
    """{length: (terms array, int32 [N, length] code points)}."""
    groups: dict = {}
    for t in terms:
        groups.setdefault(len(t), []).append(t)
    return {n: (np.array(g, dtype=object),
                np.array([[ord(c) for c in t] for t in g],
                         np.int32).reshape(len(g), n))
            for n, g in groups.items()}


def fuzzy_oracle(by_len: dict, word: str, max_edits: int
                 ) -> list[tuple[str, int]]:
    """Every vocabulary term within `max_edits` Levenshtein edits of
    `word`, as (term, distance) in (distance, term) order: the full
    dynamic program against every term whose length is within
    `max_edits` of the word's (any other is farther), vectorized over
    the terms of one length."""
    w = np.array([ord(c) for c in word], np.int32)
    out = []
    for m in range(max(len(word) - max_edits, 0), len(word) + max_edits + 1):
        if m not in by_len:
            continue
        group, codes = by_len[m]
        prev = np.tile(np.arange(m + 1, dtype=np.int32), (len(group), 1))
        for i in range(1, len(w) + 1):
            cur = np.empty_like(prev)
            cur[:, 0] = i
            sub = prev[:, :-1] + (codes != w[i - 1])
            for j in range(1, m + 1):
                cur[:, j] = np.minimum(np.minimum(prev[:, j] + 1,
                                                  cur[:, j - 1] + 1),
                                       sub[:, j - 1])
            prev = cur
        dist = prev[:, m]
        out += [(str(t), int(d)) for t, d in zip(group, dist)
                if d <= max_edits]
    return sorted(out, key=lambda td: (td[1], td[0]))


def expansion_check(scorer, patterns: list, sample: int, seed: int) -> dict:
    """`sample` of the patterns held against the oracles over the token
    vocabulary: a glob's whole expansion through the char-gram k the
    Scorer picks for it, in term order; a fuzzy token's (one edit),
    through the k the Scorer picks, in (distance, term) order. Returns
    the counts and the expansions' sizes."""
    lookups = scorer._wildcard_lookups()
    terms = lookups[0].vocab.terms
    joined = "\n".join(terms)
    by_len = None
    rng = np.random.default_rng(seed)
    picked = [patterns[i] for i in rng.choice(
        len(patterns), min(sample, len(patterns)), replace=False)]
    sizes = {"glob": [], "fuzzy": []}
    for kind, pat in picked:
        if kind == "glob":
            lookup = next(lk for lk in lookups if lk.pattern_grams(pat))
            got, want = lookup.expand(pat), glob_oracle(joined, pat)
        else:
            if by_len is None:
                by_len = terms_by_length(terms)
            got = scorer._fuzzy_lookup_for(pat, 1).fuzzy(pat, max_edits=1)
            want = fuzzy_oracle(by_len, pat, 1)
        if got != want:
            raise AssertionError(f"{kind} {pat!r}: expansion {got[:8]} "
                                 f"({len(got)}) != oracle {want[:8]} "
                                 f"({len(want)})")
        sizes[kind].append(len(got))
    return {"checked": len(picked),
            **{f"{k}_checked": len(v) for k, v in sizes.items()},
            **{f"{k}_mean_matches": (float(np.mean(v)) if v else None)
               for k, v in sizes.items()}}


def row_widths(q: np.ndarray) -> dict:
    """Ids a row (mean, max) and the histogram of rows by the power-of-two
    bucket of their id count, beside the batch's padded width L."""
    n = (q >= 0).sum(axis=1)
    buckets = np.where(n > 0, 1 << np.ceil(np.log2(np.maximum(n, 1))
                                           ).astype(np.int64), 0)
    vals, counts = np.unique(buckets, return_counts=True)
    return {"width": int(q.shape[1]), "mean_ids": float(n.mean()),
            "max_ids": int(n.max(initial=0)),
            "empty_rows": int((n == 0).sum()),
            "hist": {str(int(v)): int(c) for v, c in zip(vals, counts)}}


def phase_wildcard(card: str, scorer, idx: str, *, device: str,
                   k: int = 10):
    """Wildcard and fuzzy traffic on the wiki100k index (tiered, char-grams
    2 and 3): the three mixes of wildcard_mixes, WILDCARD_QUERIES texts
    each. For each: EXPANSION_SAMPLE patterns held against the glob and
    Levenshtein oracles; the expansion's host seconds (analyze_queries,
    the first call loading the char-gram artifacts, then again warm);
    the rows' widths; then the expanded rows through phase_prune (topk
    q/s, launches, block-max, the MaxScore hot-free share, device time
    and idle share, prune on == off bitwise, recall@10 = 1.0 against the
    float64 oracle), search_batch end to end over the texts (q/s, and on
    the card its device time and idle share under the profiler), and the
    expansion's share of one pass of analyze_queries then topk. Yields
    one report a mix."""
    mixes = wildcard_mixes(scorer.vocab.terms, WILDCARD_QUERIES)
    on_cuda = device == "cuda"
    for i, (mix, traffic) in enumerate(mixes.items()):
        texts = traffic["texts"]
        row = {"phase": "wildcard", "card": card, "config": "wiki100k",
               "mix": mix, "queries": len(texts), "k": k,
               "examples": texts[:4]}
        with counted_truncations() as truncated:
            t0 = time.perf_counter()
            q = scorer.analyze_queries(texts)
            row["expand_s" if i else "expand_first_s"] = \
                time.perf_counter() - t0
        row["truncated_expansions"] = truncated[0]
        if i == 0:
            t0 = time.perf_counter()
            with counted_truncations():
                q2 = scorer.analyze_queries(texts)
            row["expand_s"] = time.perf_counter() - t0
            if not np.array_equal(q, q2):
                raise AssertionError("a second expansion gave other rows")
        row["rows"] = row_widths(q)
        row["oracle_expansions"] = expansion_check(
            scorer, traffic["patterns"], EXPANSION_SAMPLE, seed=i)
        row["topk"] = phase_prune(card, scorer, idx, q, traffic=mix,
                                  device=device, k=k)
        e2e = {}
        with counted_truncations():
            for scoring in ("tfidf", "bm25"):
                scorer.search_batch(texts[:64], k=k, scoring=scoring)
                t0 = time.perf_counter()
                res = scorer.search_batch(texts, k=k, scoring=scoring)
                wall = time.perf_counter() - t0
                for r in res:
                    s = [x[1] for x in r]
                    if not all(np.isfinite(s)) or \
                            s != sorted(s, reverse=True):
                        raise AssertionError(f"{mix} {scoring}: {r!r}")
                e2e[scoring] = {"s": wall, "qps": len(texts) / wall,
                                "answered": sum(1 for r in res if r)}
                if on_cuda:
                    e2e[scoring]["profile"] = profile_call(
                        lambda: scorer.search_batch(texts, k=k,
                                                    scoring=scoring))
            # the host share within one pass: the expansion, then the
            # dispatch of its rows
            t0 = time.perf_counter()
            q = scorer.analyze_queries(texts)
            t1 = time.perf_counter()
            scorer.topk(q, k=k)
            t2 = time.perf_counter()
        e2e["split"] = {"expand_s": t1 - t0, "topk_s": t2 - t1,
                        "expand_share": (t1 - t0) / (t2 - t0)}
        row["search_batch"] = e2e
        yield row


@contextlib.contextmanager
def counted_truncations():
    """Count, and keep off the log, the Scorer's warnings that an
    expansion was cut to WILDCARD_LIMIT terms (thousands a wildcard mix);
    yields a one-element list holding the count."""
    import logging

    count = [0]

    def drop(record):
        if "truncated" in record.getMessage():
            count[0] += 1
            return False
        return True

    log = logging.getLogger("tpu_ir_torch.search.scorer")
    log.addFilter(drop)
    try:
        yield count
    finally:
        log.removeFilter(drop)


def phase_kgram(card: str, work: str, *, device: str, k: int = 10) -> dict:
    """The ref corpus (seed 0) as a k = 2 term-k-gram index, built one-shot
    (char-grams 2, 3 over the token vocabulary, tokens.txt) and streaming
    (the Python tokenizer in KGRAM_PROCS processes; no char-grams, as in
    the JAX package): every artifact both write has one sha256 and the
    metadata differs only in the char-grams; verify_index passes. Then the
    one-shot index served with layout "auto": KGRAM_QUERIES two- and
    three-token texts through topk (q/s, launches, device time), recall@10
    = 1.0 against the float64 oracle, and KGRAM_GLOBS glob texts composed
    over tokens.txt through search_batch."""
    import torch

    import tpu_ir_torch
    from tpu_ir_torch.corpus import make_corpus
    from tpu_ir_torch.index import build_index, build_index_streaming
    from tpu_ir_torch.index.verify import verify_index
    from tpu_ir_torch.search import Scorer
    from tpu_ir_torch.search.scorer import _assemble_csr

    on_cuda = device == "cuda"
    corpus = os.path.join(work, "ref-k2.trec")
    make_corpus(corpus, seed=0, **REF_CORPUS)
    out = {"phase": "kgram", "card": card, "config": "ref", "k": 2,
           "builds": {}}
    builds = {
        "oneshot": lambda d: build_index(corpus, d, k=2, num_shards=10,
                                         device=device),
        "streaming": lambda d: build_index_streaming(
            corpus, d, k=2, num_shards=10, tokenize_procs=KGRAM_PROCS,
            device=device)}
    dirs, digests = {}, {}
    for name, build in builds.items():
        d = dirs[name] = os.path.join(work, f"ref-k2-{name}")
        t0 = time.perf_counter()
        meta = build(d)
        if on_cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["builds"][name] = {"wall_s": wall,
                               "docs_per_s": meta.num_docs / wall,
                               "vocab_size": meta.vocab_size,
                               "num_pairs": meta.num_pairs,
                               "chargram_ks": meta.chargram_ks,
                               "timings_s": job_timings(d)}
        digests[name] = artifact_digests(d)
    os.unlink(corpus)
    only_oneshot = sorted(set(digests["oneshot"]) - set(digests["streaming"]))
    if only_oneshot != ["chargram-k2.npz", "chargram-k3.npz", "tokens.txt"] \
            or set(digests["streaming"]) - set(digests["oneshot"]):
        raise AssertionError(f"the k = 2 builds' artifact sets differ: "
                             f"{ {n: sorted(v) for n, v in digests.items()} }")
    shared = sorted(set(digests["streaming"]) - {"metadata.json"})
    differ = [n for n in shared
              if digests["oneshot"][n] != digests["streaming"][n]]
    metas = []
    for name in ("oneshot", "streaming"):
        with open(os.path.join(dirs[name], "metadata.json")) as f:
            m = json.load(f)
        m.pop("chargram_ks")
        m["checksums"] = {n: c for n, c in m["checksums"].items()
                          if n not in only_oneshot}
        metas.append(m)
    if differ or metas[0] != metas[1]:
        raise AssertionError(f"one-shot and streaming k = 2 artifacts "
                             f"differ in {differ or 'metadata.json'}")
    out["identical_artifacts"] = len(shared) + 1
    report = verify_index(dirs["oneshot"])
    if not report["ok"]:
        raise AssertionError(f"verify_index on the k = 2 index: {report}")
    out["verify_ok"] = True
    shutil.rmtree(dirs["streaming"])

    idx = dirs["oneshot"]
    tpu_ir_torch.reset_kernel_launches()
    t0 = time.perf_counter()
    scorer = Scorer.load(idx, device=device)
    out["load_s"] = time.perf_counter() - t0
    out["layout"] = scorer.layout
    out["vocab_size"] = scorer.meta.vocab_size
    out["dense_cells"] = scorer.meta.vocab_size * (scorer.meta.num_docs + 1)
    rng = np.random.default_rng(7)
    terms = scorer.vocab.terms
    pick = lambda: terms[int(rng.integers(0, len(terms)))]  # noqa: E731
    texts = [pick() if i % 2 else f"{pick()} {pick().split()[0]}"
             for i in range(KGRAM_QUERIES)]
    q = scorer.analyze_queries(texts)
    out["rows"] = row_widths(q)
    results, serve = {}, {}
    for scoring in ("tfidf", "bm25"):
        scorer.topk(q, k=k, scoring=scoring)
        before = tpu_ir_torch.kernel_launches()
        t0 = time.perf_counter()
        results[scoring] = scorer.topk(q, k=k, scoring=scoring)
        wall = time.perf_counter() - t0
        after = tpu_ir_torch.kernel_launches()
        serve[scoring] = {"s": wall, "qps": len(q) / wall,
                          "launches": {n: after[n] - before[n]
                                       for n in after}}
        if on_cuda:
            serve[scoring]["profile"] = profile_topk(scorer, q, k, scoring)
    postings = _assemble_csr(idx, scorer.meta)
    oracle = {s: oracle_check(scorer, postings, q, *results[s], scoring=s,
                              k=k) for s in ("tfidf", "bm25")}
    out["serve"] = serve
    out["recall_at_10"] = min(o["recall_at_10"] for o in oracle.values())
    out["oracle"] = oracle

    # globs composed over the token vocabulary: a bigram's first token
    # and its second token's first three characters, then '*'
    pairs = [t.split() for t in terms if len(t.split()[1]) >= 3]
    globs = [f"{a} {b[:3]}*" for a, b in (
        pairs[int(i)] for i in rng.integers(0, len(pairs), KGRAM_GLOBS))]
    with counted_truncations() as truncated:
        t0 = time.perf_counter()
        qg = scorer.analyze_queries(globs)
        out["glob_expand_s"] = time.perf_counter() - t0
    out["glob_truncated_expansions"] = truncated[0]
    out["glob_rows"] = row_widths(qg)
    with counted_truncations():
        t0 = time.perf_counter()
        res = scorer.search_batch(globs, k=k, scoring="bm25")
        out["glob_search_s"] = time.perf_counter() - t0
    out["glob_answered"] = sum(1 for r in res if r)
    if out["glob_answered"] < len(globs) // 2:
        raise AssertionError(f"only {out['glob_answered']} of {len(globs)} "
                             "composed globs matched")
    gs, gd = scorer.topk(qg, k=k, scoring="bm25")
    out["glob_oracle"] = oracle_check(scorer, postings, qg, gs, gd,
                                      scoring="bm25", k=k)
    del postings
    out["launches"] = tpu_ir_torch.kernel_launches()
    kernels = (("cold_tier",) if scorer.layout == "sparse"
               else ("dense_score",))
    for kernel in kernels:
        if on_cuda and out["launches"][kernel] == 0:
            raise AssertionError(f"the kgram phase never launched {kernel}")
    del scorer
    shutil.rmtree(idx)
    return out


COALESCE_LADDER = (1, 4, 16)     # the default ladder's rungs on the card
COALESCE_WIDTH = 8               # TPU_IR_BATCH_WIDTH's default
FRONTEND_TEXTS = 16              # query texts of the coalesced == solo check
SOAK_THREADS = 8
SOAK_QUERIES = 480
SWEEP_LEVELS = (1, 4, 16)
SWEEP_QUERIES = 2000             # per level
SWEEP_REPEATS = 3                # sweeps per scoring, for the spread
BREAKER_PROBES = 10              # breaker-open requests timed


def launch_delta(before: dict) -> dict:
    """Kernel launches since the `kernel_launches()` snapshot `before`."""
    import tpu_ir_torch

    after = tpu_ir_torch.kernel_launches()
    return {n: after[n] - before[n] for n in after}


def serving_texts(scorer, n: int, seed: int = 5) -> list[str]:
    """`n` query texts of 1 to 8 vocabulary terms (analyzed widths 1, 2,
    4 and 8), every fourth one led by a hot-strip term where the layout
    has one, and one unknown term."""
    rng = np.random.default_rng(seed)
    terms = scorer.vocab.terms
    hot = (np.nonzero(scorer._hot_rank_host >= 0)[0]
           if scorer.layout == "sparse" else np.zeros(0, np.int64))
    out = []
    for i in range(n - 1):
        ids = list(rng.integers(0, len(terms), 1 + i % 8))
        if i % 4 == 0 and len(hot):
            ids[0] = int(rng.choice(hot))
        out.append(" ".join(terms[int(t)] for t in ids))
    return out + ["zzzzzzzzq"]


def result_bits(res) -> list:
    """A SearchResult as (docid, float32 bits) pairs."""
    return [(d, int(np.float32(s).view(np.int32))) for d, s in res]


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper the serving path calls for its plain
    PyTorch twin, for the duration of the block."""
    from tpu_ir_torch.ops import cold_tier, fused_scoring, hot_stage

    swaps = ((fused_scoring, "dense_scores", fused_scoring.dense_scores_plain),
             (fused_scoring, "dense_scores_quantized",
              fused_scoring.dense_scores_quantized_plain),
             (cold_tier, "cold_stage", cold_tier.cold_stage_plain),
             (hot_stage, "hot_stage", hot_stage.hot_stage_plain))
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, kernel in kept:
            setattr(mod, name, kernel)


def coalesced_equals_solo(scorer, texts: list[str], **kw) -> int:
    """Hold each text's results in rung-padded batches (1, 3 and all of
    `texts`, padded to rungs 1, 4 and 16 at width floor 8, the MaxScore
    groups padded to rungs: the coalescer's dispatch) against its solo
    `search_batch`, bitwise; then the batch of all of `texts` once more
    with every kernel swapped for its plain twin (plain_kernels), so a
    kernel fault at the serving shapes shows even if it is the same in
    the solo and the coalesced run. Returns the number of results
    compared."""
    solo = [result_bits(scorer.search_batch([t], **kw)[0]) for t in texts]
    n = 0
    for size, plain in ((1, False), (3, False), (len(texts), False),
                        (len(texts), True)):
        rung = next(r for r in COALESCE_LADDER if r >= size)
        with plain_kernels() if plain else contextlib.nullcontext():
            batched = scorer.search_batch(
                texts[:size], pad_to=rung, width_floor=COALESCE_WIDTH,
                rung_ladder=COALESCE_LADDER, **kw)
        for text, got, want in zip(texts, batched, solo):
            if result_bits(got) != want:
                twin = " with the plain twins" if plain else ""
                raise AssertionError(f"coalesced{twin} != solo for "
                                     f"{text!r} in a batch of {size} ({kw})")
            n += 1
    return n


def phase_frontend(card: str, scorer, *, config: str, device: str,
                   k: int = 10) -> dict:
    """The serving frontend on a loaded scorer: a search at level full
    bitwise `search_batch`'s; coalesced == solo bitwise (TF-IDF and BM25,
    the rerank, and on the tiered layout hot_only and prune off); and on
    the tiered layout hot_only through the frontend, which must launch
    hot_stage and never cold_tier and give the bits of the same path with
    hot_stage's plain twin."""
    import tpu_ir_torch
    from tpu_ir_torch.serving import ServingConfig, ServingFrontend

    texts = serving_texts(scorer, FRONTEND_TEXTS)
    fe = ServingFrontend(scorer, ServingConfig(deadline_s=None))
    for scoring in ("tfidf", "bm25"):
        for text in texts:
            res = fe.search(text, k=k, scoring=scoring)
            want = scorer.search_batch([text], k=k, scoring=scoring)[0]
            if res.level != "full" or res.degraded or \
                    result_bits(res) != result_bits(want):
                raise AssertionError(f"{config}: the frontend at level full "
                                     f"differs from search_batch for "
                                     f"{text!r}")
    cases = {f"{s}": {"scoring": s} for s in ("tfidf", "bm25")}
    cases["rerank"] = {"rerank": 100}
    if scorer.layout == "sparse":
        cases.update({f"hot_only_{s}": {"scoring": s, "hot_only": True}
                      for s in ("tfidf", "bm25")})
    compared = {name: coalesced_equals_solo(scorer, texts, k=k, **kw)
                for name, kw in cases.items()}
    if scorer.layout == "sparse":
        scorer.prune = False
        try:
            for s in ("tfidf", "bm25"):
                compared[f"prune_off_{s}"] = coalesced_equals_solo(
                    scorer, texts, k=k, scoring=s)
        finally:
            scorer.prune = True
    out = {"phase": "frontend", "card": card, "config": config,
           "layout": scorer.layout, "texts": len(texts),
           "frontend_equals_search_batch": True,
           "coalesced_equals_solo": compared}
    if scorer.layout != "sparse":
        return out
    # hot_only through the frontend: its ladder stepped down twice
    hot_texts = [" ".join(scorer.vocab.terms[int(t)] for t in row)
                 for row in hot_traffic(scorer, FRONTEND_TEXTS)]
    fe = ServingFrontend(scorer, ServingConfig(
        down_cooldown_s=0.0, recover_successes=1 << 30))
    for _ in range(2):
        fe.ladder.observe(pressure=1.0, failed=False)
    if fe.ladder.level() != "hot_only":
        raise AssertionError(f"the ladder is at {fe.ladder.level()!r}")
    before = tpu_ir_torch.kernel_launches()
    got = {s: [fe.search(t, k=k, scoring=s) for t in hot_texts]
           for s in ("tfidf", "bm25")}
    launches = launch_delta(before)
    if device == "cuda" and (launches["hot_stage"] == 0
                             or launches["cold_tier"] != 0):
        raise AssertionError(f"hot_only must launch hot_stage and never "
                             f"cold_tier: {launches}")
    with plain_kernels():
        plain = {s: [scorer.search_batch([t], k=k, scoring=s,
                                         hot_only=True)[0]
                     for t in hot_texts] for s in ("tfidf", "bm25")}
    for s in ("tfidf", "bm25"):
        for text, g, w in zip(hot_texts, got[s], plain[s]):
            if g.level != "hot_only" or result_bits(g) != result_bits(w):
                raise AssertionError(f"hot_only {s} {text!r}: the kernel's "
                                     "bits differ from the plain twin's")
    if not any(len(r) for r in got["bm25"]):
        raise AssertionError("hot_only found nothing on hot-term traffic")
    out["hot_only"] = {"requests": 2 * len(hot_texts),
                       "launches": launches,
                       "bitwise_equal_to_plain": True}
    return out


def phase_soak(card: str, scorer, *, config: str, device: str) -> dict:
    """run_soak through a coalescing frontend: a clean run (every
    response full and bitwise the serial reference, nothing degraded, no
    forced host batch, the layout's kernels launched), then the same
    under DEFAULT_CHAOS_PLAN, where every invariant but `degraded` holds
    and the slots of every shared batch carry one degraded verdict
    (recorded by wrapping the scheduler's batch execution)."""
    import tpu_ir_torch
    from tpu_ir_torch import faults
    from tpu_ir_torch.serving import (
        DEFAULT_CHAOS_PLAN,
        CoalescingScheduler,
        ServingConfig,
        run_soak,
    )

    def invariants(rep: dict, name: str) -> None:
        if rep["errors"] or rep["deadlocked"] or rep["untagged_mismatches"] \
                or rep["served"] + rep["shed"] != rep["submitted"]:
            counts = {n: rep[n] for n in (
                "submitted", "served", "shed", "errors", "deadlocked",
                "untagged_mismatches", "error_samples")}
            raise AssertionError(f"{name} soak broke an invariant: {counts}")

    summary = ("submitted", "served", "shed", "errors", "deadlocked",
               "degraded", "levels", "full_bitidentical",
               "tagged_divergent", "untagged_mismatches", "wall_s",
               "recovery_delta", "latency", "batching")
    out = {"phase": "soak", "card": card, "config": config,
           "threads": SOAK_THREADS, "queries": SOAK_QUERIES}
    cfg = dict(max_concurrency=4, max_queue=8, breaker_threshold=4,
               breaker_cooldown_s=0.2, coalesce=True)
    before = tpu_ir_torch.kernel_launches()
    clean = run_soak(scorer, threads=SOAK_THREADS, queries=SOAK_QUERIES,
                     seed=0, fault_spec=None,
                     config=ServingConfig(deadline_s=1.0, **cfg))
    launches = launch_delta(before)
    invariants(clean, "clean")
    if clean["degraded"] or "forced_host_batches" in clean["recovery_delta"]:
        raise AssertionError(f"clean soak degraded: {clean['degraded']}, "
                             f"{clean['recovery_delta']}")
    kernels = (("cold_tier", "hot_stage") if scorer.layout == "sparse"
               else ("dense_score",))
    if device == "cuda" and not all(launches[n] for n in kernels):
        raise AssertionError(f"the soak launched {launches}")
    out["clean"] = {n: clean.get(n) for n in summary}
    out["clean"]["launches"] = launches

    shared = []
    execute = CoalescingScheduler._execute

    def recording(self, slots):
        execute(self, slots)
        if len(slots) > 1:
            shared.append({sl.result.degraded for sl in slots
                           if sl.state == "done"})

    CoalescingScheduler._execute = recording
    try:
        chaos = run_soak(scorer, threads=SOAK_THREADS, queries=SOAK_QUERIES,
                         seed=1, fault_spec=DEFAULT_CHAOS_PLAN,
                         config=ServingConfig(deadline_s=0.25, **cfg))
    finally:
        CoalescingScheduler._execute = execute
        faults.clear()
    invariants(chaos, "chaos")
    if not chaos["degraded"]:
        raise AssertionError("the chaos plan never bit")
    mixed = sum(1 for flags in shared if len(flags) > 1)
    if mixed:
        raise AssertionError(f"{mixed} shared batches mixed degraded and "
                             "clean slots")
    out["chaos"] = {n: chaos.get(n) for n in summary}
    out["chaos"]["shared_batches"] = len(shared)
    out["chaos"]["batch_mixed_degraded"] = mixed
    return out


def closed_loop(fe, texts: list[str], clients: int, *, scoring: str,
                k: int) -> None:
    """`clients` threads sending `texts` through the frontend `fe`, each
    thread its share one request after the other (a sweep level's
    traffic, for the profiler)."""
    import threading

    errors = []

    def client(ci):
        try:
            for text in texts[ci::clients]:
                fe.search(text, k=k, scoring=scoring)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def phase_sweep(card: str, scorer, *, config: str, device: str,
                k: int = 10) -> dict:
    """run_concurrency_sweep at SWEEP_LEVELS through a coalescing frontend,
    BM25 and TF-IDF, SWEEP_REPEATS times each (seeds 0, 1, ...): per
    repeat the solo round trip and per level p50/p95/p99 ms, q/s, mean
    occupancy and `unwarmed` (must be 0), and per level the least, median
    and greatest q/s and p99 of the repeats; on the card the device time and
    idle share of the top level's BM25 traffic (closed_loop, profiled);
    then one request's latency when its dispatch hangs past a 0.25 s
    deadline beside the median latency of BREAKER_PROBES requests once
    the breaker is open (the host answers without a dispatch)."""
    from tpu_ir_torch import faults
    from tpu_ir_torch.serving import (
        ServingConfig,
        ServingFrontend,
        run_concurrency_sweep,
    )
    from tpu_ir_torch.serving.soak import _sweep_queries

    out = {"phase": "sweep", "card": card, "config": config,
           "layout": scorer.layout, "levels": list(SWEEP_LEVELS),
           "queries_per_level": SWEEP_QUERIES, "repeats": SWEEP_REPEATS}
    for scoring in ("bm25", "tfidf"):
        runs = []
        for seed in range(SWEEP_REPEATS):
            rep = run_concurrency_sweep(scorer, levels=SWEEP_LEVELS,
                                        queries_per_level=SWEEP_QUERIES,
                                        seed=seed, scoring=scoring, k=k)
            for lv in rep["levels"]:
                if lv["errors"] or lv["unwarmed"] or lv["served"] == 0:
                    raise AssertionError(f"{config} {scoring} sweep level "
                                         f"{lv['concurrency']}: {lv}")
            runs.append({
                "solo_rtt_ms": rep["solo_rtt_ms"],
                "levels": [{n: lv[n] for n in (
                    "concurrency", "served", "shed", "qps", "p50_ms",
                    "p95_ms", "p99_ms", "occupancy_mean", "unwarmed",
                    "coalesced", "solo_flush")} for lv in rep["levels"]]})
        spread = []
        for i, level in enumerate(SWEEP_LEVELS):
            row = {"concurrency": level}
            for metric in ("qps", "p50_ms", "p99_ms"):
                vals = sorted(r["levels"][i][metric] for r in runs)
                row[metric] = {"min": vals[0], "median": vals[len(vals) // 2],
                               "max": vals[-1]}
            spread.append(row)
        out[scoring] = {"repeats": runs, "spread": spread}
    if device == "cuda":
        top = max(SWEEP_LEVELS)
        fe = ServingFrontend(scorer, ServingConfig(
            max_concurrency=top, max_queue=2 * top, coalesce=True))
        texts = _sweep_queries(scorer, SWEEP_QUERIES, seed=0)
        out["profile_top_level"] = profile_call(
            lambda: closed_loop(fe, texts, top, scoring="bm25", k=k))
    deadline = 0.25
    fe = ServingFrontend(scorer, ServingConfig(
        deadline_s=deadline, breaker_threshold=1, breaker_cooldown_s=300.0,
        fail_threshold=1 << 30))
    texts = serving_texts(scorer, BREAKER_PROBES + 1, seed=9)
    faults.install(faults.FaultPlan().add("score.hang", "always",
                                          sleep_s=1.0))
    try:
        t0 = time.perf_counter()
        first = fe.search(texts[0], k=k)
        expiry_ms = (time.perf_counter() - t0) * 1e3
        if not first.degraded or fe.breaker.state != "open":
            raise AssertionError("a hung dispatch must expire its deadline "
                                 "and open the breaker")
        lat = []
        for text in texts[1:]:
            t0 = time.perf_counter()
            res = fe.search(text, k=k)
            lat.append((time.perf_counter() - t0) * 1e3)
            if not res.degraded:
                raise AssertionError("breaker-open answers must be tagged")
    finally:
        faults.clear()
        faults.drain_abandoned(timeout_s=10.0)
    out["deadline_expiry_ms"] = expiry_ms
    out["breaker_open_ms"] = float(np.median(lat))
    out["breaker_open_requests"] = len(lat)
    return out


def ptxas_report(log: str) -> list[dict]:
    """Registers, spills and shared memory of each kernel in nvcc's
    `-Xptxas -v` output."""
    import re

    kernels = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            short = re.search(r"\d([a-z_]+_kernel)(?:IL[bi](\d+)E)?",
                              m.group(1))
            kernels.append({"kernel": (
                short.group(1) + (f"<{short.group(2)}>" if short.group(2)
                                  else "")) if short else m.group(1)})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and kernels:
            kernels[-1].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernels:
            smem = re.search(r"(\d+) bytes smem", line)
            kernels[-1].update(registers=int(m.group(1)),
                               smem=int(smem.group(1)) if smem else 0)
    return kernels


def build_kernels(card: str) -> dict:
    """Build every kernel source at once (one nvcc per source, all
    started together), then load each library; with ptxas's resource
    report of each kernel built here."""
    from tpu_ir_torch.ops import _build

    from tpu_ir_torch.analysis import native

    names = _build.kernel_sources()
    t0 = time.perf_counter()
    logs = _build.build(names)
    for name in names:
        _build.load(name)
    seconds = time.perf_counter() - t0
    # the native tokenizer (g++), so no build phase pays its compile
    t0 = time.perf_counter()
    native.load_native()
    return {"phase": "build_kernels", "card": card, "seconds": seconds,
            "native_analyzer_s": time.perf_counter() - t0,
            "native_analyzer": _build.host_lib_path(native.SOURCE).name,
            "libraries": {n: _build.lib_path(n).name for n in names},
            "ptxas": {n: ptxas_report(log) for n, log in logs.items()}}


def kernel_row(name: str, kern: dict, launches: int, serving_launches: int,
               wildcard_launches: int, kgram_launches: int,
               **fields) -> dict:
    """One kernel's entry of the summary line: `launches` in its serve
    window, then in the wildcard phase, the kgram phase and the serving
    tier's phases."""
    return {"name": name, "route": "cuda", **fields, "launches": launches,
            "wildcard_launches": wildcard_launches,
            "kgram_launches": kgram_launches,
            "serving_launches": serving_launches,
            "max_abs_err": kern["max_abs_diff"], "ms": kern["ms"],
            "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
            "bound_by": kern["bound_by"], "library_ms": kern["library_ms"]}


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
        import tpu_ir_torch
    except ImportError as e:
        print(f"chip_smoke: cannot import tpu_ir_torch ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2

    from tpu_ir_torch import faults
    from tpu_ir_torch.search import Scorer

    card = card_line()
    emit(build_kernels(card))
    emit(phase_env(card))
    shapes = dict(vocab_rows=REF_VOCAB_ROWS, width=8_761 + 1,
                  batch=REF_QUERIES, terms=REF_QUERY_TERMS)
    kern = phase_kernels(card, **shapes)
    emit(kern)
    torch.cuda.empty_cache()
    dequant = phase_dequant_score(card, **shapes)
    emit(dequant)
    torch.cuda.empty_cache()

    root = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(root, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(dir=scratch)
    try:
        build, idx = phase_build(card, work, device="cuda")
        emit(build)
        emit(phase_crash_resume(card, idx, work, device="cuda"))
        serve, scorer, q_ids, dense = phase_serve(card, idx, device="cuda")
        emit(serve)
        rerank, ref_rerank = phase_rerank(card, scorer, q_ids, config="ref",
                                          device="cuda")
        emit(rerank)
        del scorer
        torch.cuda.empty_cache()
        emit(phase_sparse_check(card, idx, q_ids, dense, device="cuda"))
        tiered = Scorer.load(idx, layout="sparse", device="cuda")
        emit(phase_rerank(card, tiered, q_ids, config="ref-tiered",
                          device="cuda", want=ref_rerank)[0])
        del tiered
        torch.cuda.empty_cache()
        comp, v3 = phase_compress(card, idx, work, config="ref")
        emit(comp)
        serve_v3, scorer = phase_serve_v3(card, v3, dense, device="cuda",
                                          config="ref-v3")
        emit(serve_v3)
        emit(phase_rerank(card, scorer, q_ids, config="ref-v3",
                          device="cuda", want=ref_rerank, bitwise=True)[0])
        del scorer
        shutil.rmtree(v3)
        torch.cuda.empty_cache()

        wbuild, widx = phase_build_streaming(card, work, device="cuda")
        emit(wbuild)
        wserve, scorer, q_ids, wraw = phase_serve(card, widx, device="cuda",
                                                  config="wiki100k")
        emit(wserve)
        emit(phase_prune(card, scorer, widx, q_ids, traffic="uniform",
                         device="cuda"))
        hot_q = hot_traffic(scorer, REF_QUERIES)
        emit(phase_prune(card, scorer, widx, hot_q, traffic="hot",
                         device="cuda"))
        emit(phase_prune(card, scorer, widx, hot_q[:HOT_SMALL_QUERIES],
                         traffic="hot", device="cuda",
                         batch=HOT_SMALL_BATCH))
        emit(phase_rerank(card, scorer, q_ids, config="wiki100k",
                          device="cuda")[0])
        torch.cuda.empty_cache()
        # wildcard and fuzzy traffic, its launches counted on their own
        tpu_ir_torch.reset_kernel_launches()
        for row in phase_wildcard(card, scorer, widx, device="cuda"):
            emit(row)
        wildcard_launches = tpu_ir_torch.kernel_launches()
        for kernel in ("cold_tier", "hot_stage"):
            if wildcard_launches[kernel] == 0:
                raise AssertionError(f"the wildcard phase never launched "
                                     f"{kernel}: {wildcard_launches}")
        torch.cuda.empty_cache()
        hot = phase_hot_stage(card, scorer, widx,
                              hot_q[:scorer._block_size()])
        hot["kernel_per_10k_topk"] = {
            s: wserve["profile"][s]["port_kernels"].get("hot_stage")
            for s in ("tfidf", "bm25")}
        emit(hot)
        torch.cuda.empty_cache()
        cold = phase_cold_tier(card, scorer, widx,
                               q_ids[:scorer._block_size()])
        cold["launches_per_10k_topk"] = wserve["launches_per_topk"]
        # the kernel's device time in one profiled 10k topk (serve phase)
        cold["kernel_per_10k_topk"] = {
            s: wserve["profile"][s]["port_kernels"]["cold_tier"]
            for s in ("tfidf", "bm25")}
        emit(cold)
        del scorer
        torch.cuda.empty_cache()
        wcomp, wv3 = phase_compress(card, widx, work, config="wiki100k")
        emit(wcomp)
        wserve_v3, scorer = phase_serve_v3(card, wv3, wraw, device="cuda",
                                           config="wiki100k-v3")
        emit(wserve_v3)
        del scorer
        shutil.rmtree(wv3)
        torch.cuda.empty_cache()
        kgram = phase_kgram(card, work, device="cuda")
        emit(kgram)
        torch.cuda.empty_cache()

        # the serving tier over both layouts, its launches counted from
        # here to the end of the sweep
        serving = {"ref": Scorer.load(idx, device="cuda"),
                   "wiki100k": Scorer.load(widx, device="cuda")}
        tpu_ir_torch.reset_kernel_launches()
        for config, scorer in serving.items():
            emit(phase_frontend(card, scorer, config=config,
                                device="cuda"))
        emit(phase_soak(card, serving["wiki100k"], config="wiki100k",
                        device="cuda"))
        for config, scorer in serving.items():
            emit(phase_sweep(card, scorer, config=config, device="cuda"))
        serving_launches = tpu_ir_torch.kernel_launches()
        for kernel in ("dense_score", "cold_tier", "hot_stage"):
            if serving_launches[kernel] == 0:
                raise AssertionError(f"the serving phases never launched "
                                     f"{kernel}: {serving_launches}")
        del serving, scorer
    finally:
        faults.drain_abandoned(timeout_s=10.0)
        shutil.rmtree(work, ignore_errors=True)

    # cold_tier's times are the TF-IDF stage's (the default scoring); its
    # error is the larger of the two scorings'
    cold_row = dict(cold["tfidf"], max_abs_diff=max(
        cold[s]["max_abs_diff"] for s in ("tfidf", "bm25")))
    emit({"kernels": [
        kernel_row("dense_score", kern, serve["launches"]["dense_score"],
                   serving_launches["dense_score"],
                   wildcard_launches["dense_score"],
                   kgram["launches"]["dense_score"],
                   source="tpu_ir_torch/csrc/dense_score.cu",
                   replaces="tpu_ir/ops/pallas_scoring.py:52"),
        kernel_row("dequant_score", dequant,
                   serve_v3["launches"]["dequant_score"],
                   serving_launches["dequant_score"],
                   wildcard_launches["dequant_score"],
                   kgram["launches"]["dequant_score"],
                   source="tpu_ir_torch/csrc/dequant_score.cu",
                   replaces="tpu_ir/ops/pallas_scoring.py:129"),
        kernel_row("cold_tier", cold_row, wserve["launches"]["cold_tier"],
                   serving_launches["cold_tier"],
                   wildcard_launches["cold_tier"],
                   kgram["launches"]["cold_tier"],
                   source="tpu_ir_torch/csrc/cold_tier.cu",
                   replaces="experiments/cold_tier_bench.py:42"),
        kernel_row("hot_stage", hot["full"], wserve["launches"]["hot_stage"],
                   serving_launches["hot_stage"],
                   wildcard_launches["hot_stage"],
                   kgram["launches"]["hot_stage"],
                   source="tpu_ir_torch/csrc/hot_stage.cu",
                   replaces="tpu_ir/ops/scoring.py:290")]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
