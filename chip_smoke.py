#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_ir_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds every kernel of the port from csrc/ (one nvcc per source, all
started together; the build line prints the build ledger of
ops/_build.py: each library's nvcc and load seconds and ptxas's
registers, spills, stack and shared memory for each kernel) and the
native tokenizer from native/analyzer.cpp (g++), then runs these phases
in order, printing
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
              and the profiler's view (obs/profiling.py): the labels
              dispatched, one cold call a signature, none on the timed
              repeat, one `dispatch.device` a query block, the dense
              TF-IDF signature's bytes equal to dense_bound's every-row
              bytes, the memory gauges against torch.cuda.memory_allocated
              (1 MiB), and each scoring's dispatch split;
6. rerank     rerank_topk (BM25 top 1,000, then cosine TF-IDF, k = 10)
              over the same queries: q/s, device time, launches; then
              `explain`: 16 of the queries as texts through search_batch
              with explain_k = 10 (TF-IDF, BM25 and the rerank): every
              entry's float64 sum of contributions equals its score, and
              its score the returned one, as float32 bits, and the same
              call with every kernel swapped for its plain twin gives the
              same bits; explain ms a query. Explain runs again after 9
              (ref-v3, TF-IDF and BM25) and 13 (wiki100k, uniform and
              hot-term traffic, TF-IDF, BM25 and the rerank); over those
              runs each of dense_score, dequant_score, cold_tier and
              hot_stage must launch (`explain_launches`);
7. sparse     the same index and queries on the tiered sparse layout,
              held against the dense layout's top-10 row by row; then its
              rerank against the dense layout's (same docs, rtol 1e-6);
8. compress   `migrate_index(to_version=3)` on a copy of the ref index
              (format v3, tf_dtype "auto");
9. serve      as 5, on the compressed copy (`ref-v3`): a bf16 raw-tf
              matrix, TF-IDF through dequant_score, and top-10 bitwise
              equal to the raw index's for both scorings; its rerank
              bitwise the raw index's;
9a. v1        the ref corpus built one-shot under TPU_IR_FORMAT_VERSION=1
              (npz parts) and served dense: top-10 bitwise the v2 index's,
              dense_score launched; migrated to v2, every artifact has the
              v2 build's sha256; verify_index on both;
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
14. wildcard  three mixes of 64 texts on wiki100k (a literal term and
              a prefix glob; a literal term and a fuzzy token; the three
              questions that once raised, then two-token texts ending in
              '?'): 40 patterns of each held against a glob and a
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
              bitwise equal to the raw wiki100k index's (the compressing
              copy is made by a child process from phase 11 on);
18. kgram     the ref corpus as a k = 2 term-k-gram index, one-shot (with
              char-grams over tokens.txt) and streaming (the Python
              tokenizer in 4 processes): every artifact both write has
              one sha256, verify passes; the one-shot index served with
              layout "auto" (250 two- and three-token texts, recall@10
              = 1.0 against the oracle; 64 globs composed over
              tokens.txt): build wall s and docs/s, V, the layout, q/s,
              device time and launches;
19. positions format v2 position runs: ref one-shot, legacy streaming
              and a radix request (which falls back to the per-batch pass
              2 with its warning), every artifact with one sha256;
              wiki100k streaming with the store (a radix request) and
              one-shot, their shared artifacts with one sha256; verify
              on each; wall s, docs/s, positions bytes, peak host RSS;
19a. merge    each kept corpus split at a document boundary into two
              files whose concatenation is the whole, each half built
              one-shot into 10 shards (wiki100k with the store through one
              corpus pass, ref with positions) and the halves merged on the
              card: every merged artifact has the sha256 of the radix
              build's (wiki100k, the store included) or the ref positions
              build's artifact of that name; the halves' and the merge's
              seconds, the merge's phase timings and peak host RSS; the
              merged wiki100k index served (the uniform queries, TF-IDF
              and BM25) bitwise as the radix index, cold_tier and hot_stage
              launched;
19b. warm     the wiki100k serving cache removed, a load that misses and
              writes it (cold_load_s), one that hits (warm_load_s) and opens
              no part file (counted); the hit scorer serves the uniform and
              hot-term traffic, TF-IDF and BM25, the rerank of 1,000 and an
              explain batch of 64 texts bitwise as the miss scorer,
              launching cold_tier and hot_stage; the cache's bytes; then
              `tpu-ir-torch warm` through the command line;
19c. doctor   doctor_report on the wiki100k index: its seconds, the block
              bounds ok and exact, serving-tiered among the caches, the
              warnings;
19d. live     the live index at wiki100k (`wiki100k-live`: k = 1, 10
              shards, char-grams 2, 3): the corpus's first 95,000 docs
              through `tpu-ir-torch ingest LIVE --init --add ...
              --compact` (one flush; generation A; docs/s, WAL appends,
              bytes and fsyncs, the flush's seconds); A loaded by
              Scorer.load_generation and served through a coalesced
              ServingFrontend (512 texts, q/s); the delta with the
              writer's defaults (flushes of 1,000, auto-merge on): the
              held-back 5,000 docs added, 500 of A's docs updated with
              another doc's text and 500 others deleted (ops/s, the
              flushes' and merge steps' seconds, at least one merge step);
              compact_all gives generation B (99,500 docs; seconds), whose
              every artifact must have the sha256 of a one-shot build
              over the surviving docs (its seconds); 4 probe threads send
              BM25 texts while `frontend.reload_generation(generation=B)`
              loads B (every upload streamed: pinned chunks on a side
              stream) and warms its coalescer before the publish: the
              reload's wall, the widest gap between successful responses
              across it (where in the reload it opened, which
              generation's response closed it, and which of the reload's
              spans it overlaps) beside the widest before it and a
              thread's that only wakes every 0.5 ms, the probes, the
              generations seen, no error, shed, degraded response or
              unwarmed dispatch, and 64 A-tagged and 64 B-tagged
              responses bitwise their generation's solo answer; the
              bytes B's load moved across the link, its uploads' seconds
              and GB/s, and the timeline of its spans (the part reads,
              the layout, the norms, the cache write, the strip build,
              each upload, the warm-up); then the swap back to A's
              scorer, loaded already, under the same probes (its gaps:
              the swap without a load); then what holds the gap, each
              under the same probes: B loaded again from the serving
              cache its first load wrote (no part file opened), that
              cache hit and the preloaded swap through a frontend
              without a coalescer (no warm-up); no swap but one pageable
              host-to-card copy of B's resident bytes, one streamed copy
              of the bytes B's load moved and one pageable copy of as
              many (bytes, wall, GB/s each); and B loaded cold again
              (its serving cache removed) through the streamed uploads,
              then once more with each upload one pageable copy on the
              serving stream, as before the streamed path (the control);
              the cache hit's and both cold loads' span timelines;
              B as the last swap loaded it serves 10,000 uniform queries
              bitwise as the one-shot index, TF-IDF and BM25 (q/s), its
              own timed run launching cold_tier and hot_stage; then
              `shards`, its own line, printed before live's: on the live
              dir, a ShardSet of 2 doc shards x 2 replicas, subprocesses
              on the card serving A (spawn to ready seconds, what the
              workers add to the card's used memory in nvidia-smi), behind
              a Router (serving/router.py: hedging, failover, breakers);
              through Router.search 32 texts from one client alone, then
              256 TF-IDF and 256 BM25 texts from 8 client threads with
              replica 0/1 SIGKILLed after 30% of them: every answer full
              and bitwise A's top-10 in this process (routed q/s, the
              request's p50 and p99, the router.request, router.shard_rtt
              and router.merge histograms, hedges fired and won a
              request), every answer's distributed trace stitched whole
              (one root, a verdict on every attempt, each contributing
              shard's worker request and kernel spans); before that pass
              the 256 TF-IDF texts from 8 clients four times on the
              whole fleet, traced and with this process's tracing off
              (the control; the workers keep tracing) in turns (q/s and
              router.request p50 of each, their medians, every answer
              bitwise A's top-10), the routed request's time attributed
              from the traced answers' stitched traces (the root, its
              admission wait, the critical attempt, the worker's request
              and its admission wait, dispatch and kernel spans, the
              wire, the router's remainder; p50, p99 and share of the
              root; every span nested in its parent within 1 ms); 32 texts through the router's two-phase rerank
              bitwise this process's rerank of 100; rolling_swap to B
              under 4 threads probing through the Router: every answer
              one generation's, full ones bitwise its top-10, partial
              ones (the mixed window) its exact merge of their shards
              (the walk's widest gap, its wall, the staleness); the
              killed replica respawned comes back on B and answers as its
              sibling; cold_tier and hot_stage launched in the workers
              over the routed traffic (their /healthz); then `elastic`,
              its own line, on that fleet (on B): 256 TF-IDF texts from 8
              clients through the Router at 2 x 2; an Autoscaler in
              thread mode (run_distributed_soak's defaults: 2 to 3
              replicas, cooldown 0.5 s, up at 0.6, down at 0.15, 3 and
              25 ticks) behind a Router narrowed to 2 requests at once,
              the 8 clients cycling the texts through it until the
              autoscaler has grown one warm replica a shard (ticks to
              the decision, the grow's seconds, each worker's nice, the
              grown workers' warm-up launches); the same 256 texts at
              2 x 3 through the first Router (q/s, the client's and
              `router.request`'s p50 and p99 at 2 x 2 and 2 x 3), then
              the first 2 of them, each led by a hot term, once a
              replica from one client (the round robin reaches
              every replica with a block that runs the hot stage); idle
              ticks with one probe a 0.1 s until a second autoscaler
              drains the highest replica of each shard (drain-not-drop:
              the drains' seconds and admitted peak), the card's used
              memory back within 0.5 GB of before the grow; a scripted
              retire of replica 0/1 SIGKILLed during its drain under 4
              clients (killed_mid_drain, the answers full through 0/0);
              `scale --url` against this process's /healthz; every
              answer full and bitwise B's top-10, no breaker opened, each
              grown replica's routed cold_tier and hot_stage launches
              above 0; stop() leaves no worker pid; then verify_live
              (seconds), and doctor,
              generations and compact --gc through the command line
              (seconds each);
19e. live_crash  the same at ref scale (`ref-live`: the first 8,261 ref
              docs as A; a delta of 500 adds, 100 updates and 100
              deletes in flushes of 100): A backed up (segments
              hardlinked, the WAL copied) and restored into a new dir
              (restore_live runs verify_live); the delta fed into A with
              no crash and compacted (the control); a spawned child
              (`serving.soak.ingest_feed_main --ops`) feeds the same
              delta into the restore under
              TPU_IR_FAULTS=ingest.flush_build:once@3, acknowledging each
              op, and SIGKILLs itself (rc -9); the parent recovers (lease
              takeover, the WAL replayed, the unacknowledged ops fed
              again, compact_all): no acknowledged op lost, the control's
              live docs, every artifact the control's sha256 and the
              one-shot build's; that generation served dense on the card,
              10,000 uniform queries bitwise as the one-shot index,
              TF-IDF and BM25, launching dense_score; then through 3
              in-process dense workers (serve_worker) behind a Router,
              64 TF-IDF and 64 BM25 texts bitwise the scorer's top-10,
              the workers launching dense_score; then `routed_soak`, its
              own line: run_distributed_soak on that dir, 2 x 2 dense
              subprocess workers behind a Router, 160 requests from 8
              threads under its chaos schedule (a replica SIGKILLed, then
              a whole shard, then the respawn) and a rolling swap to a
              generation B at 60% of the answers: conservation, no error
              or deadlock, partial answers none mismatched, no full
              mismatch, 3 respawns, every recovery probe full on B, every
              served answer's trace stitched in the right shape and none
              of the tail's missing, the trace bookkeeping within 5% of a
              mean request (1% with tracing off), every served request in
              the SLO windows, the workers' dense_score launches (read
              from this process's /healthz, the router's fleet block, a
              lower bound: a request served while a reload warms counts
              as the warm-up's) above 0, and a forced flight record
              after it (the breach path's) whose header carries the time
              series' lead-up, the routed rate above 0 in the soak's
              windows; then
              `elastic_soak`, its own line: run_distributed_soak on that
              dir again, 2 x 2 dense workers, no chaos, a rolling swap to
              another generation at 25% and the scale plan: a grow at
              30%, a drain of each shard's highest replica at 60% with
              that replica SIGKILLed during its drain (tpu_ir's
              zero-stale-swap-during-scale and conservation-across-
              membership-changes tests in one schedule): their asserts,
              and the workers' routed dense_score launches above 0; then
              `forecast_soak`, its own line: run_distributed_soak on that
              dir once more, 2 x 2 dense workers behind a Router of 4
              requests at once, no chaos, the diurnal burst workload
              (Zipf 1.1, burst 3, two waves, 16 clients, 600
              requests) under serve-bench --autoscale's config with the
              forecast armed (forecast_up = up_occupancy, lead 1 s): the
              soak refits the Forecaster every 1/8 s over this process's
              timeseries store; the fleet spools to a fresh
              TPU_IR_TELEMETRY_DIR and samples every 0.5 s. Conservation,
              no error, deadlock or mismatch, forecast.fits >= 1 and the
              forecast_occupancy gauge in the store, the workers' routed
              dense_score launches above 0, one worker's /timeseries read
              mid-soak with tier-0 points of submitted_per_s and its
              rings within ring_limits(), and `stats --cluster
              --telemetry-dir` counting the workers' submitted and
              answered requests equal to each worker's own last snapshot,
              to the request; the arm's forecast_lead_s and burst p99 are
              recorded, not held;
19f. ingest_soak  `ingest --soak-bench` through the command line in
              this process on a fresh live dir at run_ingest_soak's
              defaults (48 docs after 12, flushes of 6, compaction every
              12, the feeder child SIGKILLed at half, its successor
              replaying the WAL): no acknowledged write lost, no stale
              answer, a replayed successor; docs/s, the freshness lag,
              and the in-process frontend's kernel launches over its
              probes, its load's, warm-up's and reloads' left out (a
              lower bound: a probe served while a reload warms counts as
              the reload's);
20. prox      ref and wiki100k (their positions indexes): the first 500
              uniform queries as texts through search_batch(rerank=1,000,
              prox=True): q/s and the launches of stage 1 and of the
              cosine stage; 64 queries (32 uniform, 32 pairs of common
              terms) held bitwise against the boost recomputed in numpy
              from the position files;
21. phrase    wiki100k: 64 quoted windows of 2-3 analyzed tokens of
              random docs (default_rng(12)), half with a free term, at
              slop 0 and 2, TF-IDF and BM25: q/s and the host's share;
              20 phrases a slop held against a scan of the token streams
              of the document store;
22. snippets  wiki100k: 200 hits through a ServingFrontend with
              snippets=True, every marked word one of the query's
              analyzed tokens; ms a snippet.

Then the serving tier (tpu_ir_torch.serving) over `ref` and `wiki100k`,
loaded again, with the kernels' launches counted from phase 23 to the end
of phase 25 (each of dense_score, cold_tier and hot_stage must launch):

23. frontend  on each: a ServingFrontend search at level full bitwise
              search_batch's; 16 texts of 1 to 8 terms in rung-padded
              batches (1, 3 and 16 texts at width floor 8, the
              coalescer's dispatch, and the 16 once more with every
              kernel's plain twin) bitwise their solo dispatch, for
              TF-IDF, BM25 and the rerank, and on wiki100k also hot_only
              and prune off; on wiki100k hot_only through the frontend
              (its ladder stepped down), which launches hot_stage and
              never cold_tier and gives the bits of hot_stage's plain
              twin on the same path;
24. soak      wiki100k, 8 threads x 240 requests of make_queries through a
              coalescing frontend: a clean run (served + shed ==
              submitted, no error, deadlock, untagged mismatch or
              degraded response, no forced host batch, kernels launched),
              then the same under DEFAULT_CHAOS_PLAN (every invariant but
              `degraded`, and one degraded verdict in each shared batch,
              seen by the scheduler and in the query log:
              `batch_mixed_degraded` 0 over `batches_observed` > 0);
25. sweep     on each, run_concurrency_sweep at concurrency 1, 4 and 16,
              100 requests a level, BM25 and TF-IDF, twice each:
              solo round trip, p50/p95/p99 ms, q/s, mean occupancy,
              `unwarmed` and `compiles` (both 0 after the coalescer's
              warm-up), and the repeats' spread; on ref
              `querylog_cost`: 400 BM25 requests from 16 clients, three
              passes with the query log on and three off in turns (q/s
              medians and spreads, the host cost of one entry; the ring
              holds min(256, entries) and `querylog.recorded` counts
              them) and `profile_cost`: the same passes with the profiler
              on and off, each after a full collection (medians, spreads,
              the garbage collector's pauses in each pass and the medians
              net of them, every pass bitwise the first, the dispatch
              split at concurrency 16, the profiler's own host cost a
              call at the arguments the passes gave it) and
              `sampler_cost`: the same passes with a timeseries sampler
              running every 0.05 s and without one (medians, spreads,
              one sample's host µs); then one request's
              latency past a 0.25 s deadline
              beside the open breaker's, and the `breaker_open` flight
              record the opening wrote (header, trace and telemetry
              lines, newest in the flight dir); last `/metrics`,
              `/metrics.json` and `/profile` scraped from a MetricsServer,
              `/metrics?reset=1` refused with 403;
26. querylog  on wiki100k one search_batch of 2,048 texts timed three
              times with the query log on and three off, in turns, and
              likewise with the profiler (`profile_cost`, as in the
              sweep's, with the batch's dispatch split); then
              the slow-query trap on ref and wiki100k with every request
              slow, through a ServingFrontend and through a plain
              search_batch of 8 texts: the capture's span tree holds a
              kernel span (the open request's, or the ring's), its
              explain sums to the top score bit for bit, one `slow_query`
              record whose header lists the offender (and the answer's
              trace id through the frontend), a second probe within the
              rate limit records but writes and explains nothing and
              launches only the search's kernels; each record's header
              carries the card's memory and the compile cache's cold
              calls; the explain's launches (dense_score on ref,
              cold_tier and hot_stage on wiki100k) and
              `querylog.slow_capture`'s p50.

Every flight record of the run goes to a folder of its work dir
(TPU_IR_FLIGHT_DIR). Phase 10's radix build is read through its progress
job every 0.5 s (its percent never falls; it ends succeeded at 100 with
its phases' tasks done), and `routed_soak` checks the query log: a router
entry with a trace id for each served request, a worker's /querylog
(over HTTP) holding some of those traces, and /jobs showing the soak's
job succeeded at 100%.

Host work that no phase times on the card runs in one spawned child
beside the main path: the wiki100k corpus (during phases 2-9), the
wiki100k compressing copy (17, during 12-16) and the phrase oracle's
token streams (21, during 19a-19f); each phase reports the child's
seconds and its own wait.

The last three lines are the `kernels` summary, the card's name and power
limit, and {"ok": true, "device": {...}}. Without CUDA, or outside the
repository, the script exits nonzero before printing any result.

With `--dispatch-ab INDEX [--root TREE] [--label L]` it runs only the
serving passes of `profile_cost` on the ref corpus, for an A/B of two
trees on one card: `--root` imports `tpu_ir_torch` from another checkout
(a parent commit unpacked beside this one), and INDEX is built from the
ref corpus on first use. Each pass (DISPATCH_AB_PASSES of each arm, in
turns; the arms are the profiler on and off where the tree has it, else
two like arms, `plain` and `plain_b`, so both trees run as many passes in
the same order) times 400 BM25 requests from 16 clients through a
coalescing frontend on the dense layout and one search_batch of 2,048
texts on the tiered layout, each after a full collection, then as many
passes with no collection first, all with the collector's pauses. It also profiles one batch of each arm (cProfile, the
functions with the most own time) and times the profiler's own host cost
a call. It prints one JSON line:

    python3 chip_smoke.py --dispatch-ab build/ab/idx --root build/parent --label parent
    python3 chip_smoke.py --dispatch-ab build/ab/idx --label change

With `--ablate` it times the closed loop alone, in the arms of
ABLATION_ARMS: the profiler on and off, then the tree's own serving loop
with its dispatch.device span, its memory sample, its profiled entry
points or all three swapped for no-ops (ablation(); a tree without the
profiler runs as many like arms), each pass with the dispatching
thread's time off its core inside each dispatch (DispatchMeter).
`--dispatch-ab-pool FILE...` pools such lines of several processes by
tree and arm (pool_ablation; no card needed):

    python3 chip_smoke.py --dispatch-ab-pool ab/parent-*.json ab/change-*.json
"""

from __future__ import annotations

import contextlib
import json
import logging
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


_START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also says when it ended, in seconds
    since the script started (`elapsed_s`)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _START}
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


def every_row_bytes(batch: int, terms: int, width: int,
                    cell_bytes: int) -> int:
    """A dense score's bytes when every (b, l) reads its matrix row in
    full and the [B, D+1] float32 scores are written once: what the
    profiler counts for a dense signature (ops/scoring.py::_dense_cost)."""
    return batch * terms * width * cell_bytes + batch * width * 4


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
            "bound_ms_every_row_read": every_row_bytes(
                batch, terms, width, cell_bytes) / HBM_BYTES_PER_S * 1e3}


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
                config: str = "ref", keep_corpus: bool = False
                ) -> tuple[dict, str]:
    """A configuration's corpus, generated from seed 0, indexed one-shot
    into 10 shards with build_index's defaults (the native tokenizer,
    char-grams k = 2, 3). The CPU test shrinks the corpora through
    REF_CORPUS and WIKI_CORPUS, test hooks only. At ref the host analysis
    is timed once more on its own, through the pure-Python analyzer
    (`analyze_alone_s`) and through the native C++ pass
    (`native_analyze_alone_s`). With `keep_corpus` the corpus stays at
    work/<config>.trec (for phase_positions)."""
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
    if not keep_corpus:
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


def make_wiki_corpus(path: str) -> tuple[int, float]:
    """The wiki100k corpus (seed 0, WIKI_CORPUS) written to `path`, in a
    child process while the ref phases run: (its bytes, the seconds it
    took)."""
    from tpu_ir_torch.corpus import make_corpus

    t0 = time.perf_counter()
    n = make_corpus(path, seed=0, **WIKI_CORPUS)
    return n, time.perf_counter() - t0


def phase_build_streaming(card: str, work: str, *, device: str,
                          config: str = "wiki100k",
                          keep_corpus: bool = False,
                          corpus_made=None) -> tuple[dict, str]:
    """The configuration's corpus (seed 0, WIKI_CORPUS; `corpus_made`, a
    future of make_wiki_corpus's answer, when a child made it) built
    three ways
    into 10 shards: the streaming radix build (16 buckets, batch_docs
    50,000, store, char-grams 2, 3; under torch.profiler for pass 2's
    device time), the legacy streaming build (radix 0) and the one-shot
    build (no store). Every artifact the three share must have one
    sha256, and verify_index must pass on the radix build, whose index
    dir is returned. For each build: wall s, docs/s, the phase timings
    of its job report, the radix spill bytes, peak host RSS and
    torch.cuda.max_memory_allocated. With `keep_corpus` the corpus stays
    at work/<config>.trec (for phase_positions). The radix build's job
    (obs/progress.py) is read every JOB_POLL_S while it runs: its percent
    never falls, and it ends succeeded at 100 in finalize, with tasks done
    in pass1_tokenize, pass2_combine and pass3_reduce and every phase that
    declares a task count done with all of them (check_job_done); its
    phases are printed."""
    import torch

    from tpu_ir_torch.corpus import make_corpus
    from tpu_ir_torch.index import build_index, build_index_streaming
    from tpu_ir_torch.index.verify import verify_index
    from tpu_ir_torch.obs import progress

    corpus = os.path.join(work, f"{config}.trec")
    t0 = time.perf_counter()
    if corpus_made is None:
        corpus_bytes = make_corpus(corpus, seed=0, **WIKI_CORPUS)
        gen_s = time.perf_counter() - t0
    else:
        corpus_bytes, gen_s = corpus_made.result()
    out = {"phase": "build_streaming", "card": card, "config": config,
           "corpus_bytes": corpus_bytes, "corpus_gen_s": gen_s,
           "corpus_wait_s": time.perf_counter() - t0, "builds": {}}
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
        prof = poll = None
        with PeakRss() as rss, contextlib.ExitStack() as stack:
            if name == "radix":
                poll = stack.enter_context(JobPoll())
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
        if poll is not None:
            job = [j for j in progress.jobs()
                   if j.name == f"streaming:{os.path.basename(d)}"][-1]
            job = job.to_dict()
            check_percent_series(poll.percents + [job["percent"]])
            check_job_done(job, ("pass1_tokenize", "pass2_combine",
                                 "pass3_reduce", "finalize"))
            row["job"] = {"polls": len(poll.percents),
                          "percents": poll.percents,
                          "state": job["state"],
                          "percent": job["percent"],
                          "phases": job["phases"]}
        out["builds"][name] = row
        digests[name] = artifact_digests(d)
    if not keep_corpus:
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


SPLIT_SPANS = ("kernel", "dispatch.device", "dispatch")
MEMORY_SLACK_BYTES = 1 << 20   # gauge vs torch.cuda.memory_allocated()


def dispatch_split(delta: dict) -> dict:
    """The dispatch's parts over a run, from a registry delta_summary:
    the host's launches (`kernel`), the wait on the card
    (`dispatch.device`) and the whole dispatch, each span's count and its
    p50 and p99 ms."""
    return {name: {n: (delta.get(name) or {}).get(n)
                   for n in ("count", "p50_ms", "p99_ms")}
            for name in SPLIT_SPANS}


def served_labels(scorer, scorings=("tfidf", "bm25")) -> dict:
    """The profiled labels a topk of each scoring may dispatch on this
    scorer (the JAX package's function names)."""
    if scorer.layout == "sparse":
        return {s: {f"{s}_topk_tiered", f"{s}_topk_blockmax"}
                for s in scorings}
    tfidf = ("tfidf_topk_dense" if scorer.doc_matrix is not None
             else "tfidf_topk_dense_quantized")
    return {s: {tfidf if s == "tfidf" else "bm25_topk_dense"}
            for s in scorings}


def check_serve_profile(report: dict, labels: dict, split: dict,
                        blocks: int, dense_sig: str | None,
                        dense_bytes: int | None) -> dict:
    """The profiler's view of a serve (profiling.profile_report):
    every scoring dispatched one of its `labels`, every signature had
    exactly one cold call, the timed repeat added no compile.count
    (`split[scoring]["repeat_compiles"]`) and one `dispatch.device` a
    query block (`blocks`), and on the dense layout the tfidf_topk_dense
    signature that starts with `dense_sig` counted `dense_bytes`
    (every_row_bytes). Returns the
    labels dispatched and the signatures' facts."""
    functions = {f["name"]: f for f in report["functions"]}
    for scoring, want in labels.items():
        if not want & set(functions):
            raise AssertionError(f"{scoring}: none of {sorted(want)} in "
                                 f"the profile ({sorted(functions)})")
    sigs = {name: [{k: sig[k] for k in ("signature", "compiles",
                                        "bytes_accessed", "flops",
                                        "last_compile_s")}
                   for sig in f["signatures"]]
            for name, f in functions.items()}
    for name, rows in sigs.items():
        if any(r["compiles"] != 1 for r in rows):
            raise AssertionError(f"{name}: a signature with other than "
                                 f"one cold call: {rows}")
    for scoring, row in split.items():
        if row["repeat_compiles"] != 0:
            raise AssertionError(f"{scoring}: the repeat at the same "
                                 f"shape added {row['repeat_compiles']} "
                                 "compiles")
        if row["dispatch.device"]["count"] != blocks:
            raise AssertionError(f"{scoring}: {row['dispatch.device']} "
                                 f"dispatch.device for {blocks} blocks")
    if dense_sig is not None:
        got = [r["bytes_accessed"] for r in sigs["tfidf_topk_dense"]
               if r["signature"].startswith(dense_sig)]
        if got != [dense_bytes]:
            raise AssertionError(f"the dense TF-IDF signature {dense_sig}"
                                 f" counted {got} bytes, expected "
                                 f"{dense_bytes}")
    return {"labels": sorted(functions), "signatures": sigs}


def check_memory_gauges(resident: int) -> dict:
    """A forced memory sample against torch.cuda.memory_allocated() at
    the same point: device.bytes_in_use within MEMORY_SLACK_BYTES of it,
    device.peak_bytes at least the `resident` bytes."""
    import torch

    from tpu_ir_torch.obs import get_registry, profiling

    reg = get_registry()
    profiling.sample_memory(min_interval_s=0)
    allocated = torch.cuda.memory_allocated()
    in_use = reg.get_gauge("device.bytes_in_use")
    peak = reg.get_gauge("device.peak_bytes")
    if abs(in_use - allocated) > MEMORY_SLACK_BYTES or peak < resident:
        raise AssertionError(f"memory gauges: in use {in_use}, peak {peak}"
                             f"; allocated {allocated}, resident "
                             f"{resident}")
    return {"bytes_in_use": in_use, "memory_allocated": allocated,
            "peak_bytes": peak, "host_rss_bytes": reg.get_gauge(
                "host.rss_bytes")}


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
    from tpu_ir_torch.obs import get_registry, profiling
    from tpu_ir_torch.search import Scorer

    n_queries = REF_QUERIES
    on_cuda = device == "cuda"
    reg = get_registry()

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
    results, walls, per_topk, blockmax, split = {}, {}, {}, {}, {}
    for scoring in ("tfidf", "bm25"):
        scorer.topk(q_ids, k=k, scoring=scoring)     # warm-up: cold calls
        before = tpu_ir_torch.kernel_launches()
        stats = dict(scorer.blockmax_stats)
        compiles = reg.get("compile.count")
        hist0 = reg.hist_state()
        t0 = time.perf_counter()
        results[scoring] = scorer.topk(q_ids, k=k, scoring=scoring)
        walls[scoring] = time.perf_counter() - t0    # host arrays: synced
        after = tpu_ir_torch.kernel_launches()
        per_topk[scoring] = {n: after[n] - before[n] for n in after}
        blockmax[scoring] = {n: v - stats[n]
                             for n, v in scorer.blockmax_stats.items()}
        split[scoring] = {
            "repeat_compiles": reg.get("compile.count") - compiles,
            **dispatch_split(reg.delta_summary(hist0))}
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
    dense_sig = dense_bytes = None
    if scorer.layout == "dense" and scorer.doc_matrix is not None:
        dense_sig = f"int32[{n_queries},{REF_QUERY_TERMS}], float32["
        dense_bytes = every_row_bytes(n_queries, REF_QUERY_TERMS,
                                      scorer.meta.num_docs + 1,
                                      scorer.doc_matrix.element_size())
    prof = check_serve_profile(profiling.profile_report(),
                               served_labels(scorer), split,
                               skip_blocks + full_blocks, dense_sig,
                               dense_bytes)
    prof["dispatch_split"] = split
    prof["dense_signature_bytes"] = dense_bytes
    prof["memory"] = check_memory_gauges(resident) if on_cuda else None
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
           "oracle": oracle, "profile": profiles, "profiler": prof}
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


def cold_tier_alone(scorer, q_block: np.ndarray) -> dict:
    """Kernel 3 alone (kernel_alone) over the cold stage of `q_block` on
    `scorer`, TF-IDF and BM25, each launch one whole stage onto a
    freshly zeroed [B, D+1] accumulator, as serving launches it: the 1 GB
    memset leaves no row or score sector of the last launch in L2 (the
    memset is another kernel, not counted). Run in a fresh process
    (AloneChild): late in this script's own process (some ten minutes
    and nine profiler sessions in) a session holding only these launches
    twice traced no device event at all, with or without CPU activity,
    while a fresh process's sessions traced every launch."""
    import torch

    from tpu_ir_torch.ops import cold_tier

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
        del acc
    return out


def alone_child_main(idx: str, hot_block: np.ndarray,
                     cold_block: np.ndarray, conn) -> None:
    """AloneChild's process: load `idx` on the card, say "loaded", wait
    for "go", then send ("ok", {"hot_stage": hot_stage_alone's,
    "cold_tier": cold_tier_alone's}) or ("error", the traceback)."""
    import traceback

    try:
        from tpu_ir_torch.search import Scorer

        scorer = Scorer.load(idx, device="cuda")
        conn.send("loaded")
        if conn.recv() != "go":
            return
        conn.send(("ok", {"hot_stage": hot_stage_alone(scorer, hot_block),
                          "cold_tier": cold_tier_alone(scorer,
                                                       cold_block)}))
    except BaseException:  # noqa: BLE001 — sent to the parent, which raises
        with contextlib.suppress(OSError):
            conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class AloneChild:
    """The kernels' times alone (hot_stage_alone, cold_tier_alone), taken
    in one fresh process. It starts, and loads the index, while the
    wildcard phase (host work) runs; `results()` lets it measure, with
    this process idle on the card, and returns what it measured. `stop()`
    ends it in any case."""

    def __init__(self, idx: str, hot_block: np.ndarray,
                 cold_block: np.ndarray):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, child_conn = ctx.Pipe()
        self._proc = ctx.Process(target=alone_child_main,
                                 args=(idx, hot_block, cold_block,
                                       child_conn), daemon=True)
        self._proc.start()
        child_conn.close()
        self._results = None

    def _recv(self, timeout_s: float):
        if not self._conn.poll(timeout_s):
            raise AssertionError(f"the alone child said nothing in "
                                 f"{timeout_s} s")
        return self._conn.recv()

    def results(self) -> dict:
        if self._results is None:
            said = self._recv(600)
            if said != "loaded":
                raise AssertionError(f"the alone child: {said}")
            self._conn.send("go")
            state, payload = self._recv(600)
            if state != "ok":
                raise AssertionError(f"the alone child failed:\n{payload}")
            self._results = payload
        return self._results

    def stop(self) -> None:
        with contextlib.suppress(OSError):
            self._conn.close()
        self._proc.join(timeout=60)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(timeout=30)


def phase_cold_tier(card: str, scorer, q_block: np.ndarray,
                    alone_by_scoring: dict) -> dict:
    """Kernel 3 (cold_tier) against its plain twin over the whole cold
    stage (every tier, in order, one launch) of one query block on
    `scorer`, TF-IDF and BM25, with the wrapper's time, the kernel's time
    alone (`alone_by_scoring`: cold_tier_alone's, from AloneChild), the
    twin's and one library yardstick's; then at the edge cases
    (cold_edge_checks)."""
    import torch

    from tpu_ir_torch.ops import cold_tier, scoring

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


def hot_stage_alone(scorer, q_block: np.ndarray) -> dict:
    """The hot-stage kernel alone (kernel_alone) on `q_block`'s inputs
    (hot_inputs) over the whole strip, each launch onto a fresh copy of
    the cold partial, as serving adds to a partial the cold stage just
    wrote; run in a fresh process (AloneChild), as cold_tier_alone is."""
    from tpu_ir_torch.ops import hot_stage

    base, rows, w, strip = hot_inputs(scorer, q_block)
    acc = base.clone()

    def stage():
        acc.copy_(base)
        hot_stage.hot_stage(acc, rows, w, strip)

    out = kernel_alone(stage, "hot_stage")
    del base, acc, strip
    return out


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


def phase_hot_stage(card: str, scorer, q_block: np.ndarray,
                    alone: dict) -> dict:
    """The hot-stage kernel against its plain twin at wiki100k shapes: one
    block of hot-term queries (every query holds a hot term) over the
    whole (1 + ln tf) strip, N = D+1, and over a block-max column set
    (the budget's blocks, every fourth), where it must also give the
    whole strip's bits at those columns; with the wrapper's time, the
    kernel's time alone (`alone`: hot_stage_alone's, from AloneChild),
    the twin's, the yardstick torch.matmul(w_hot, strip) at the same shapes, and the
    bound (hot_bound); then the edge cases (hot_edge_checks)."""
    import torch

    from tpu_ir_torch.ops import hot_stage
    from tpu_ir_torch.ops.scoring import blockmax_cand_blocks

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


WILDCARD_QUERIES = 64           # query texts of each wildcard mix (2,000
                                # before the run outgrew its time, 1,000
                                # before the live phases, 500 before the
                                # shard workers, 250 before the router,
                                # 125 before the query log's checks, 100
                                # before the profiler's)
EXPANSION_SAMPLE = 40          # patterns of a mix held against the oracles
                               # (200 before the run outgrew its time, 80
                               # before the routed attribution passes)
# the questions that raised on a char-gram index before wildcard search
QUEUE3_QUESTIONS = ("how do I sort a list?", "thread*", "pythn~")
KGRAM_QUERIES = 250            # two- and three-token texts on the k = 2
                               # index (2,000 before the run outgrew its time,
                               # 1,000 before the shard workers, 500 before
                               # the router)
KGRAM_GLOBS = 64               # glob texts composed over its tokens.txt
                               # (200 before the shard workers, 100 before
                               # the router; the oracle samples
                               # ORACLE_QUERIES of them)
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
SOAK_QUERIES = 240               # (480 before the run outgrew its time)
SWEEP_LEVELS = (1, 4, 16)
SWEEP_QUERIES = 100              # per level (2,000 before the merge, warm
                                 # and doctor phases paid for their time,
                                 # 500 before the shard workers, 250 before
                                 # the router, 150 before the routed
                                 # attribution passes)
SWEEP_REPEATS = 2                # sweeps per scoring, for the spread
BREAKER_PROBES = 10              # breaker-open requests timed
QUERYLOG_PASSES = 3              # passes with the query log on, and off, in
                                 # turns, of each of its cost checks
QUERYLOG_PASS_TEXTS = 400        # requests of one such pass of the ref sweep
                                 # at its top concurrency
QUERYLOG_BATCH = 2_048           # texts of the wiki100k search_batch timed
SLOW_PROBE_TEXTS = 8             # texts of the trap's plain search_batch
JOB_POLL_S = 0.5                 # how often the build's job is read


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
    (recorded by wrapping the scheduler's batch execution, and from the
    query log by the soak: `batch_mixed_degraded` 0 in both runs, over
    `batches_observed` > 0 shared batches under the chaos)."""
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
               "recovery_delta", "latency", "batching",
               "batch_mixed_degraded", "batches_observed")
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
    if clean["batch_mixed_degraded"] or chaos["batch_mixed_degraded"] \
            or not chaos["batches_observed"]:
        raise AssertionError(
            f"the query log's shared batches: clean "
            f"{clean['batch_mixed_degraded']} mixed, chaos "
            f"{chaos['batch_mixed_degraded']} mixed of "
            f"{chaos['batches_observed']}")
    mixed = sum(1 for flags in shared if len(flags) > 1)
    if mixed:
        raise AssertionError(f"{mixed} shared batches mixed degraded and "
                             "clean slots")
    out["chaos"] = {n: chaos.get(n) for n in summary}
    out["chaos"]["shared_batches"] = len(shared)
    out["chaos"]["batch_mixed_degraded"] = mixed
    return out


def closed_loop(fe, texts: list[str], clients: int, *, scoring: str,
                k: int) -> list:
    """`clients` threads sending `texts` through the frontend `fe`, each
    thread its share one request after the other (a sweep level's
    traffic, for the profiler). Returns each text's result_bits, in the
    texts' order."""
    import threading

    errors = []
    out = [None] * len(texts)

    def client(ci):
        try:
            for i in range(ci, len(texts), clients):
                out[i] = result_bits(fe.search(texts[i], k=k,
                                               scoring=scoring))
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
    return out


# -- the query log, the slow-query trap, flight records and jobs -------------

def span_names(tree: dict) -> set:
    """The names of a span tree's spans (`Span.to_dict()` nesting)."""
    out = {tree.get("name")}
    for child in tree.get("children", ()):
        out |= span_names(child)
    return out


def check_slow_capture(capture: dict, top_score: float, *,
                       source: str | None) -> dict:
    """A slow-query capture as the trap must leave it: a span tree holding
    a `kernel` span, read from `source` (None: the request still open;
    "ring": the trace ring's newest tree), and an explain of the top hit
    whose float64 sum of contributions is its score, which is the
    returned top score as float32 bits. Returns the explain entry."""
    tree = capture.get("span_tree")
    if not tree or "kernel" not in span_names(tree):
        raise AssertionError(f"the capture's span tree holds no kernel "
                             f"span: {tree}")
    if capture.get("span_tree_source") != source:
        raise AssertionError(f"the span tree came from "
                             f"{capture.get('span_tree_source')!r}, "
                             f"expected {source!r}")
    explained = capture.get("explain")
    if not explained:
        raise AssertionError(f"the capture has no explain: "
                             f"{capture.get('explain_error')}")
    e = explained[0]
    if not (e["contribution_sum"] == e["score"] == top_score
            and np.float32(e["score"]).tobytes()
            == np.float32(top_score).tobytes()):
        raise AssertionError(f"the explain sums to {e['contribution_sum']} "
                             f"for a score of {e['score']}, the search "
                             f"returned {top_score}")
    return e


def read_flight_artifact(path: str, reason: str) -> dict:
    """A flight record's lines checked: the header first (its reason
    `reason`), at least one trace line, and exactly one telemetry line,
    the last. Returns the header with the lines' counts."""
    with open(path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    if not lines or lines[0].get("record") != "header" \
            or lines[0].get("reason") != reason:
        raise AssertionError(f"{path}: no {reason!r} header line")
    kinds = [line.get("record") for line in lines[1:]]
    traces = kinds.count("trace")
    if traces < 1 or kinds.count("telemetry") != 1 \
            or kinds[-1] != "telemetry" \
            or traces + 1 != len(kinds):
        raise AssertionError(f"{path}: {traces} trace lines and "
                             f"{kinds.count('telemetry')} telemetry lines "
                             f"in {len(kinds)}")
    return {**lines[0], "trace_lines": traces}


def check_percent_series(series: list) -> None:
    """A job's percent as its poller read it: never falling."""
    for a, b in zip(series, series[1:]):
        if b < a:
            raise AssertionError(f"the job's percent fell from {a} to {b}: "
                                 f"{series}")


def check_job_done(job: dict, phases: tuple) -> None:
    """A finished job: succeeded at 100% in its last phase of `phases`,
    each earlier one with tasks done, and each phase that declared a
    task count done with all of them (`tpu_ir`'s builds declare none for
    pass 1 of a fresh build and for finalize)."""
    if job["state"] != "succeeded" or job["percent"] != 100.0 \
            or job["current_phase"] != phases[-1]:
        raise AssertionError(f"the job ended {job['state']} at "
                             f"{job['percent']}% in "
                             f"{job['current_phase']!r}: {job}")
    rows = {p["phase"]: p for p in job["phases"]}
    idle = [p for p in phases[:-1] if rows.get(p, {}).get("done", 0) == 0]
    short = [p["phase"] for p in job["phases"]
             if p["total"] is not None and p["done"] != p["total"]]
    if idle or short:
        raise AssertionError(f"the job's phases: no task done in {idle}, "
                             f"unfinished {short}: {job['phases']}")


class JobPoll:
    """Read the newest running job (obs/progress.py) every JOB_POLL_S on
    a thread, keeping each read's percent."""

    def __init__(self):
        import threading

        self.percents: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        from tpu_ir_torch.obs import progress

        while not self._stop.wait(JOB_POLL_S):
            job = progress.current_job()
            if job is not None:
                self.percents.append(job.to_dict()["percent"])

    def __enter__(self) -> "JobPoll":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=30)


def flight_files(d: str) -> set:
    try:
        return {n for n in os.listdir(d) if n.startswith("flight-")}
    except OSError:
        return set()


def querylog_passes(run, entries: int) -> dict:
    """`run()` timed QUERYLOG_PASSES times with the query log on and as
    often off, in turns (on first), each pass on an empty ring. After an
    `on` pass the ring must hold min(its capacity, `entries`) and
    `querylog.recorded` must have counted `entries` kept entries; after
    an `off` pass none. Returns each arm's seconds, their medians and
    spreads (greatest less least), and the host cost of one entry,
    (on - off) / entries, from the medians, in µs."""
    from tpu_ir_torch.obs import get_registry, querylog

    reg = get_registry()
    cap = querylog.summary()["ring"]["capacity"]
    walls = {"on": [], "off": []}
    try:
        for i in range(2 * QUERYLOG_PASSES):
            arm = "on" if i % 2 == 0 else "off"
            querylog.configure(enabled=arm == "on")
            querylog.clear()
            kept0 = reg.get("querylog.recorded")
            t0 = time.perf_counter()
            run()
            walls[arm].append(time.perf_counter() - t0)
            kept = reg.get("querylog.recorded") - kept0
            ring = len(querylog.recent())
            want = (entries, min(cap, entries)) if arm == "on" else (0, 0)
            if (kept, ring) != want:
                raise AssertionError(f"query log {arm}: {kept} kept, {ring} "
                                     f"in the ring, expected {want}")
    finally:
        querylog.configure(enabled=True)
    med = {a: float(np.median(w)) for a, w in walls.items()}
    return {"entries": entries, "ring_capacity": cap, "walls_s": walls,
            "median_s": med,
            "spread_s": {a: max(w) - min(w) for a, w in walls.items()},
            "entry_cost_us": (med["on"] - med["off"]) / entries * 1e6}


@contextlib.contextmanager
def gc_pauses():
    """The garbage collector's pauses while the block runs (gc.callbacks).
    Yields a dict that holds, once the block ends, the collections'
    `count`, how many were `full` (the oldest generation's) and their
    seconds `s`."""
    import gc

    out = {"count": 0, "full": 0, "s": 0.0}
    start = [0.0]

    def note(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            out["count"] += 1
            out["full"] += info["generation"] == 2
            out["s"] += time.perf_counter() - start[0]

    gc.callbacks.append(note)
    try:
        yield out
    finally:
        gc.callbacks.remove(note)


def collected_pass(run, collect: bool = True):
    """`run()` after a full collection, timed: (its result, wall seconds,
    gc_pauses' dict). Where a full collection falls depends on what every
    earlier pass allocated: without the collection first, passes in turns
    can meet it in one arm again and again. `collect=False` times the
    pass as it comes, the collector's pauses still counted."""
    import gc

    if collect:
        gc.collect()
    with gc_pauses() as pause:
        t0 = time.perf_counter()
        got = run()
        wall = time.perf_counter() - t0
    return got, wall, pause


def arm_summary(walls: dict, pauses: dict) -> dict:
    """Passes' walls and collector pauses by arm: the walls, their
    medians and spreads (greatest less least), each pass's pauses and the
    median of the walls net of them."""
    med = {a: float(np.median(w)) for a, w in walls.items()}
    net = {a: float(np.median([w - p["s"] for w, p in zip(walls[a],
                                                           pauses[a])]))
           for a in walls}
    return {"walls_s": walls, "median_s": med,
            "spread_s": {a: max(w) - min(w) for a, w in walls.items()},
            "gc": {a: [{"s": p["s"], "full": p["full"],
                        "count": p["count"]} for p in ps]
                   for a, ps in pauses.items()},
            "net_of_gc_median_s": net}


SHIM_REPS = 2_000                # timed calls of each captured signature


def profiler_shim_cost(run) -> dict:
    """The profiler's own host cost at the arguments the serving path
    really passes: one `run()` with the profiled entry points' outermost
    calls captured, then, for each distinct signature, its signature key
    and a profiled no-op (on a signature it has seen, the warm path)
    timed SHIM_REPS times against the bare no-op; and one memory sample
    (forced, the card's allocator read). Returns the calls a pass, µs a
    call of each, and the shim's ms a pass (calls x the wrapper's µs,
    plus one sample each 50 ms of the pass)."""
    from tpu_ir_torch.obs import profiling

    calls = []
    real = profiling.Profiled.__call__

    def capture(self, *args, **kwargs):
        if getattr(profiling._tls, "acc", None) is None:
            calls.append((self.label, args, kwargs))
        return real(self, *args, **kwargs)

    profiling.Profiled.__call__ = capture
    try:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    finally:
        profiling.Profiled.__call__ = real

    def noop(*args, **kwargs):
        return None

    def per_call_us(fn, args, kwargs) -> float:
        t0 = time.perf_counter()
        for _ in range(SHIM_REPS):
            fn(*args, **kwargs)
        return (time.perf_counter() - t0) / SHIM_REPS * 1e6

    rows = {}
    for label, args, kwargs in calls:
        sig = profiling.signature_key(args, kwargs)
        if (label, sig) in rows:
            rows[label, sig]["calls"] += 1
            continue
        shim = profiling.Profiled(noop, label="shim")
        shim._seen.add(sig)                  # the warm path: no cold call
        key_us = per_call_us(profiling.signature_key, (args, kwargs), {})
        bare_us = per_call_us(noop, args, kwargs)
        rows[label, sig] = {"label": label,
                            "signature": profiling.render_signature(sig),
                            "calls": 1, "key_us": key_us,
                            "wrapper_us": per_call_us(shim, args, kwargs)
                            - bare_us}
    del calls
    t0 = time.perf_counter()
    for _ in range(100):
        profiling.sample_memory(min_interval_s=0)
    sample_us = (time.perf_counter() - t0) / 100 * 1e6
    n = sum(r["calls"] for r in rows.values())
    shim_ms = sum(r["calls"] * r["wrapper_us"] for r in rows.values()) / 1e3
    return {"calls_a_pass": n, "signatures": list(rows.values()),
            "sample_memory_us": sample_us,
            "shim_ms_a_pass": shim_ms
            + (wall / profiling.SAMPLE_MIN_INTERVAL_S + 1) * sample_us / 1e3,
            "pass_s": wall}


def on_off_passes(run, arm, what: str) -> dict:
    """`run()` timed QUERYLOG_PASSES times in each of the arms "on" and
    "off", in turns, on first, each pass after a full collection
    (collected_pass) inside the context `arm(name)` gives; every pass
    must return what the first returned. Returns arm_summary's walls,
    medians, spreads and collector pauses, with the on arm's cost over
    the off arm's median (of the walls, and net of the pauses)."""
    walls = {"on": [], "off": []}
    pauses = {"on": [], "off": []}
    first = None
    for i in range(2 * QUERYLOG_PASSES):
        name = "on" if i % 2 == 0 else "off"
        with arm(name):
            got, wall, pause = collected_pass(run)
        walls[name].append(wall)
        pauses[name].append(pause)
        if first is None:
            first = got
        elif got != first:
            raise AssertionError(f"{what} {name}, pass {i}: the results "
                                 "differ from the first pass's")
    out = arm_summary(walls, pauses)
    med, net = out["median_s"], out["net_of_gc_median_s"]
    out["cost_share"] = (med["on"] - med["off"]) / med["off"]
    out["net_of_gc_cost_share"] = (net["on"] - net["off"]) / net["off"]
    return out


def profiling_passes(run) -> dict:
    """on_off_passes with the profiler on and off (profiling.configure;
    on again after), with the dispatch split over all the passes
    (dispatch_split) and the profiler's own cost a call
    (profiler_shim_cost)."""
    from tpu_ir_torch.obs import get_registry, profiling

    @contextlib.contextmanager
    def arm(name):
        profiling.configure(enabled=name == "on")
        try:
            yield
        finally:
            profiling.configure(enabled=True)

    reg = get_registry()
    hist0 = reg.hist_state()
    out = on_off_passes(run, arm, "profiler")
    out["dispatch_split"] = dispatch_split(reg.delta_summary(hist0))
    out["shim"] = profiler_shim_cost(run)
    return out


SAMPLE_COST_REPS = 200          # timed store.sample() calls (sampler_passes)


def sampler_passes(run) -> dict:
    """on_off_passes with a timeseries sampler running at
    SAMPLER_COST_INTERVAL_S (the dearest cadence TPU_IR_TS_SAMPLE_S
    allows) and without one; beside the cost, the arms' spreads over
    their medians, the samples the on passes took, and one sample's host
    µs off this process's registry (SAMPLE_COST_REPS calls) with its
    share of a second at the default cadence."""
    from tpu_ir_torch import envvars
    from tpu_ir_torch.obs import get_registry, timeseries

    @contextlib.contextmanager
    def arm(name):
        sampler = None
        if name == "on":
            sampler = timeseries.TimeseriesSampler(
                store=timeseries.TimeseriesStore(),
                interval_s=SAMPLER_COST_INTERVAL_S).start()
        try:
            yield
        finally:
            if sampler is not None:
                sampler.stop()

    reg = get_registry()
    samples0 = reg.get("timeseries.samples")
    out = on_off_passes(run, arm, "sampler")
    out["spread_share"] = {a: out["spread_s"][a] / out["median_s"][a]
                           for a in out["median_s"]}
    out["interval_s"] = SAMPLER_COST_INTERVAL_S
    out["samples_on"] = reg.get("timeseries.samples") - samples0
    store = timeseries.TimeseriesStore()
    store.sample()
    t0 = time.perf_counter()
    for _ in range(SAMPLE_COST_REPS):
        store.sample()
    out["sample_us"] = (time.perf_counter() - t0) / SAMPLE_COST_REPS * 1e6
    out["default_interval_s"] = envvars.get_float("TPU_IR_TS_SAMPLE_S")
    out["default_share"] = out["sample_us"] / 1e6 / out["default_interval_s"]
    return out


def scrape_metrics_server() -> dict:
    """/metrics, /metrics.json and /profile scraped from a MetricsServer
    of this process, and `/metrics?reset=1` refused with 403 (the
    registry's reset count unchanged by it). Returns each body's size
    and the profile's labels."""
    import urllib.error
    import urllib.request

    from tpu_ir_torch.obs import get_registry
    from tpu_ir_torch.obs.server import MetricsServer

    reg = get_registry()
    with MetricsServer(port=0) as srv:
        def get(route: str) -> bytes:
            with urllib.request.urlopen(srv.url + route, timeout=30) as r:
                return r.read()

        prom = get("/metrics").decode("utf-8")
        snap = json.loads(get("/metrics.json"))
        prof = json.loads(get("/profile"))
        resets = reg.seq
        try:
            get("/metrics?reset=1")
            refused = None
        except urllib.error.HTTPError as e:
            refused = e.code
    if "# TYPE tpu_ir_events_total counter" not in prom \
            or 'tpu_ir_events_total{name="compile.count"}' not in prom:
        raise AssertionError("/metrics lacks the counter family")
    if snap["counters"]["compile.count"] < 1 or not prof["functions"] \
            or "builds" not in prof:
        raise AssertionError(f"/metrics.json {snap['counters']['compile.count']}"
                             f" cold calls, /profile {len(prof['functions'])}"
                             " functions")
    if refused != 403 or reg.seq != resets:
        raise AssertionError(f"/metrics?reset=1 answered {refused}")
    return {"metrics_bytes": len(prom), "metrics_json_counters":
            len(snap["counters"]), "profile_labels":
            sorted(f["name"] for f in prof["functions"]),
            "reset_refused": refused}


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
    the breaker is open (the host answers without a dispatch), and the
    `breaker_open` flight record the opening writes (the rate limit reset
    first): its header, trace and telemetry lines, and first in
    recent_headers of the flight dir. On ref, the query log's cost at the
    top level first: QUERYLOG_PASS_TEXTS BM25 requests through a
    coalescing frontend by as many clients, QUERYLOG_PASSES passes with
    the log on and off in turns (querylog_passes: q/s medians, spreads,
    the host cost of an entry), then the profiler's on the same passes
    (profiling_passes) with the dispatch split at that level. Every
    level adds no cold call after the warm-up (`compiles` 0); last the
    server's /metrics, /metrics.json and /profile are scraped
    (scrape_metrics_server)."""
    from tpu_ir_torch import faults, obs
    from tpu_ir_torch.obs.recorder import flight_dir, recent_headers
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
                # no cold call after the coalescer's warm-up, as no
                # unwarmed shape
                if lv["errors"] or lv["unwarmed"] or lv["compiles"] \
                        or lv["served"] == 0:
                    raise AssertionError(f"{config} {scoring} sweep level "
                                         f"{lv['concurrency']}: {lv}")
            runs.append({
                "solo_rtt_ms": rep["solo_rtt_ms"],
                "levels": [{n: lv[n] for n in (
                    "concurrency", "served", "shed", "qps", "p50_ms",
                    "p95_ms", "p99_ms", "occupancy_mean", "unwarmed",
                    "compiles", "coalesced", "solo_flush")}
                    for lv in rep["levels"]]})
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
    if config == "ref":
        top = max(SWEEP_LEVELS)
        fe = ServingFrontend(scorer, ServingConfig(
            max_concurrency=top, max_queue=2 * top, coalesce=True))
        texts = _sweep_queries(scorer, QUERYLOG_PASS_TEXTS, seed=2)
        closed_loop(fe, texts, top, scoring="bm25", k=k)   # warm
        cost = querylog_passes(
            lambda: closed_loop(fe, texts, top, scoring="bm25", k=k),
            len(texts))
        cost["qps"] = {a: [len(texts) / w for w in cost["walls_s"][a]]
                       for a in ("on", "off")}
        cost["qps_median"] = {a: float(np.median(v))
                              for a, v in cost["qps"].items()}
        cost["concurrency"] = top
        out["querylog_cost"] = cost
        # the profiler's cost on the same passes, and the dispatch split
        # at the top level
        prof = profiling_passes(
            lambda: closed_loop(fe, texts, top, scoring="bm25", k=k))
        prof["qps_median"] = {a: len(texts) / w
                              for a, w in prof["median_s"].items()}
        prof["concurrency"] = top
        out["profile_cost"] = prof
        # the timeseries sampler's cost on the same passes
        samp = sampler_passes(
            lambda: closed_loop(fe, texts, top, scoring="bm25", k=k))
        samp["qps_median"] = {a: len(texts) / w
                              for a, w in samp["median_s"].items()}
        samp["concurrency"] = top
        out["sampler_cost"] = samp
    out["scrapes"] = scrape_metrics_server()
    deadline = 0.25
    fe = ServingFrontend(scorer, ServingConfig(
        deadline_s=deadline, breaker_threshold=1, breaker_cooldown_s=300.0,
        fail_threshold=1 << 30))
    texts = serving_texts(scorer, BREAKER_PROBES + 1, seed=9)
    obs.reset_rate_limit()
    records = flight_files(flight_dir())
    faults.install(faults.FaultPlan().add("score.hang", "always",
                                          sleep_s=1.0))
    try:
        t0 = time.perf_counter()
        first = fe.search(texts[0], k=k)
        expiry_ms = (time.perf_counter() - t0) * 1e3
        if not first.degraded or fe.breaker.state != "open":
            raise AssertionError("a hung dispatch must expire its deadline "
                                 "and open the breaker")
        new = flight_files(flight_dir()) - records
        newest = recent_headers(flight_dir())
        if len(new) != 1 or not newest \
                or os.path.basename(newest[0]["path"]) not in new:
            raise AssertionError(f"the breaker's opening wrote {sorted(new)}"
                                 f"; newest {newest[:1]}")
        header = read_flight_artifact(newest[0]["path"], "breaker_open")
        if header["extra"]["breaker"]["state"] != "open":
            raise AssertionError(f"the breaker record: {header['extra']}")
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
    out["breaker_flight_record"] = {
        "path": newest[0]["path"],
        **{n: header[n] for n in ("reason", "seq", "trace_lines")}}
    return out


def trap_probe(search, *, admitted: bool, captures: int) -> dict:
    """One search with the slow-query trap armed for every request: the
    result, its wall ms, the kernel launches it made, the `captures` slow
    captures it left (oldest first) and the flight records it wrote.
    `admitted` resets the flight recorder's rate limit first."""
    import tpu_ir_torch
    from tpu_ir_torch import obs
    from tpu_ir_torch.obs import querylog
    from tpu_ir_torch.obs.recorder import flight_dir

    if admitted:
        obs.reset_rate_limit()
    seq0 = max((c["seq"] for c in querylog.slow_recent()), default=0)
    records = flight_files(flight_dir())
    before = tpu_ir_torch.kernel_launches()
    t0 = time.perf_counter()
    res = search()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_delta(before)
    caps = [c for c in querylog.slow_recent() if c["seq"] > seq0]
    if len(caps) != captures:
        raise AssertionError(f"{len(caps)} slow captures, expected "
                             f"{captures}")
    return {"result": res, "wall_ms": wall_ms, "launches": launches,
            "captures": caps,
            "records": sorted(flight_files(flight_dir()) - records)}


def slow_trap(scorer, *, config: str, path: str, k: int = 10) -> dict:
    """The slow-query trap on one path: (a) "frontend", one
    ServingFrontend.search, whose capture reads the open request's tree;
    (b) "search_batch", one plain call of SLOW_PROBE_TEXTS texts, whose
    capture reads the ring's newest tree. The same search runs first with
    the trap off (its own launches); then the trap trips with the rate
    limit reset: one `slow_query` record (its header carries the
    offender's query_hash, on (a) the answer's trace id; a telemetry line
    and trace lines), the explain bitwise the top score, and the
    explain's launches the probe's less the search's own; then once more
    within TPU_IR_FLIGHT_INTERVAL: the entries recorded and captured, no
    record, no explain and no launch beyond the search's own. Both
    probes' wall ms are reported: their difference is what the admitted
    capture (span tree, explain, record) cost."""
    import tpu_ir_torch
    from tpu_ir_torch.obs import querylog
    from tpu_ir_torch.serving import ServingConfig, ServingFrontend

    # from the fifth text on: the first explained one holds five terms,
    # led by a hot-strip term on the tiered layout (both stages explained)
    texts = serving_texts(scorer, SLOW_PROBE_TEXTS + 5, seed=17)[
        4:4 + SLOW_PROBE_TEXTS]
    if path == "frontend":
        fe = ServingFrontend(scorer, ServingConfig(deadline_s=None))
        texts = texts[:1]

        def search():
            return [fe.search(texts[0], k=k)]
    else:
        def search():
            return scorer.search_batch(texts, k=k)
    search()                                 # warm, the trap off
    before = tpu_ir_torch.kernel_launches()
    plain = search()
    base = launch_delta(before)              # the search's own launches
    querylog.configure(slow_ms=1e-3)
    try:
        first = trap_probe(search, admitted=True, captures=len(texts))
        second = trap_probe(search, admitted=False, captures=len(texts))
    finally:
        querylog.configure(slow_ms=0.0)
    res = first["result"]
    if [result_bits(r) for r in res] != [result_bits(r) for r in plain]:
        raise AssertionError(f"{config} {path}: the trapped search's "
                             "results differ from the same search's")
    cap = first["captures"][0]
    explained = check_slow_capture(
        cap, res[0][0][1], source=None if path == "frontend" else "ring")
    if len(first["records"]) != 1 or not cap["flight_record"] \
            or os.path.basename(cap["flight_record"]) != first["records"][0]:
        raise AssertionError(f"{config} {path}: the trap wrote "
                             f"{first['records']}, the capture names "
                             f"{cap['flight_record']}")
    header = read_flight_artifact(cap["flight_record"], "slow_query")
    stamped = [s for s in header["slow_queries"]
               if s.get("query_hash") == cap["query_hash"]]
    if not stamped:
        raise AssertionError(f"{config} {path}: the header's slow_queries "
                             f"lack {cap['query_hash']}")
    if path == "frontend" and not (
            res[0].trace_id and header.get("trace_id") == res[0].trace_id
            == cap.get("trace_id") == stamped[-1].get("trace_id")):
        raise AssertionError(f"{config}: the record's trace id "
                             f"{header.get('trace_id')} is not the answer's "
                             f"{res[0].trace_id}")
    if header["extra"]["slow_query"]["query_hash"] != cap["query_hash"]:
        raise AssertionError(f"{config} {path}: the record's capture is "
                             "another query's")
    explain_launches = {n: first["launches"][n] - base[n] for n in base}
    if second["records"] or second["launches"] != base or any(
            c.get("flight_record") or "explain" in c
            for c in second["captures"]):
        raise AssertionError(f"{config} {path}: the rate-limited probe "
                             f"wrote {second['records']} and launched "
                             f"{second['launches']} against the search's "
                             f"{base}")
    return {"texts": len(texts), "search_launches": base,
            "explain_launches": explain_launches,
            "top_score": res[0][0][1], "contribution_sum":
            explained["contribution_sum"], "span_tree_source":
            cap.get("span_tree_source"), "trace_id": header.get("trace_id"),
            "record": {"path": cap["flight_record"],
                       "seq": header["seq"],
                       "trace_lines": header["trace_lines"],
                       "slow_queries": len(header["slow_queries"]),
                       "memory": header.get("memory"),
                       "compile_cache": header.get("compile_cache")},
            "rate_limited": {"captures": len(second["captures"]),
                             "launches": second["launches"]},
            # the admitted capture's cost (span tree, explain, record)
            # beside a rate-limited one's, on the same search
            "wall_ms": {"admitted": first["wall_ms"],
                        "rate_limited": second["wall_ms"]}}


def phase_querylog(card: str, serving: dict, *, device: str) -> dict:
    """The query log and its slow-query trap on the card. On wiki100k the
    cost of the log on one search_batch of QUERYLOG_BATCH texts
    (querylog_passes: QUERYLOG_PASSES timed calls with the log on and as
    many off, in turns), and the profiler's on the same call
    (profiling_passes, with its dispatch split); then on ref (dense) and
    wiki100k (tiered) the
    trap on both paths (slow_trap), with the explain's launches:
    dense_score on ref, cold_tier and hot_stage on wiki100k, each
    record's header with its memory (the card's, on the card) and at
    least one cold call in its compile cache, and the
    `querylog.slow_capture` histogram's p50 over the phase."""
    from tpu_ir_torch.obs import get_registry

    reg = get_registry()
    hist0 = reg.hist_state()
    out = {"phase": "querylog", "card": card}
    wiki = serving["wiki100k"]
    texts = serving_texts(wiki, QUERYLOG_BATCH, seed=13)
    wiki.search_batch(texts, k=10)           # warm
    out["batch_cost"] = dict(
        querylog_passes(lambda: wiki.search_batch(texts, k=10), len(texts)),
        config="wiki100k")
    # the profiler's cost on the same batch, with its dispatch split
    out["profile_cost"] = dict(profiling_passes(
        lambda: [result_bits(r) for r in wiki.search_batch(texts, k=10)]),
        config="wiki100k", texts=len(texts))
    want = {"ref": ("dense_score",), "wiki100k": ("cold_tier", "hot_stage")}
    out["trap"] = {}
    for config, scorer in serving.items():
        for path in ("frontend", "search_batch"):
            row = slow_trap(scorer, config=config, path=path)
            if device == "cuda" and not all(
                    row["explain_launches"][n] for n in want[config]):
                raise AssertionError(f"{config} {path}: the explain launched "
                                     f"{row['explain_launches']}")
            # the record's header: the memory (the card's on the card)
            # and the compile cache's cold calls
            rec = row["record"]
            if (rec["compile_cache"] or {}).get("compiles", 0) < 1 or (
                    device == "cuda" and not rec["memory"]["device"]):
                raise AssertionError(f"{config} {path}: the record's header"
                                     f" memory {rec['memory']}, compile "
                                     f"cache {rec['compile_cache']}")
            out["trap"][f"{config}/{path}"] = row
    out["slow_capture"] = reg.delta_summary(
        hist0, always=("querylog.slow_capture",))["querylog.slow_capture"]
    return out


# -- positions, phrase, proximity, explain, snippets --------------------------

POSITIONS_REF_BATCH = 2_000     # ref docs a streaming batch (several batches)
PHRASE_TEXTS = 64               # phrase texts of the wiki100k phrase phase
                                # (2,000 before the run outgrew its time,
                                # 400 before the shard workers, 200 before
                                # the router, 100 before the query log's
                                # checks, 80 before the profiler's)
PHRASE_SLOPS = (0, 2)
PHRASE_ORACLE = 40              # phrases a slop held against a stream scan
                                # (100 before the run outgrew its time)
PROX_QUERIES = 500              # uniform queries through the prox rerank
                                # (10,000 before the run outgrew its time,
                                # 2,000 before the shard workers, 1,000
                                # before the router)
PROX_CANDIDATES = 1_000
PROX_ORACLE = 64                # queries whose boost numpy recomputes
EXPLAIN_QUERIES = 16            # queries of each explain traffic (256 before
                                # the merge, warm and doctor phases, 128
                                # before the live phases, 64 before the
                                # shard workers, 32 before the router)
EXPLAIN_K = 10
SNIPPET_HITS = 200              # hits rendered through the frontend


class CapturedLog(logging.Handler):
    """The messages one logger emits inside a `with` block."""

    def __init__(self, name: str):
        super().__init__(logging.WARNING)
        self.messages: list[str] = []
        self._logger = logging.getLogger(name)

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self._logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)
        return False


def positions_bytes(idx: str) -> int:
    return sum(os.path.getsize(os.path.join(idx, f))
               for f in os.listdir(idx) if f.startswith("positions-"))


def timed_build(build, d: str, device: str) -> dict:
    """One build into `d`: wall s, docs/s, peak host RSS, the positions
    bytes, the job's phase timings, the streaming build's radix fallback
    warning."""
    import torch

    on_card = device == "cuda"
    with PeakRss() as rss, CapturedLog("tpu_ir_torch.index.streaming") as log:
        t0 = time.perf_counter()
        meta = build(d)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not meta.has_positions or meta.version != 2:
        raise AssertionError(f"{d}: metadata {meta.__dict__}")
    return {"wall_s": wall, "docs_per_s": meta.num_docs / wall,
            "num_docs": meta.num_docs, "num_pairs": meta.num_pairs,
            "positions_bytes": positions_bytes(d),
            "peak_host_rss_bytes": rss.peak,
            "host_rss_start_bytes": rss.start,
            "timings_s": job_timings(d),
            "radix_fallback_warning": any("radix partitioning is "
                                          "unavailable" in m
                                          for m in log.messages)}


def phase_positions(card: str, work: str, *, device: str,
                    keep_corpora: bool = False) -> tuple[dict, dict]:
    """Format v2 position runs in both builds at full scale. `ref`:
    one-shot, legacy streaming (batches of POSITIONS_REF_BATCH docs) and
    a radix request (16 buckets), which must fall back to the per-batch
    pass 2 with its warning; every artifact of the three has one sha256.
    `wiki100k`: streaming with the store and a radix request (the same
    fallback) and one-shot (no store); the artifacts they share, the
    position runs included, have one sha256. verify_index passes on each.
    The corpora are the ones phase_build and phase_build_streaming kept
    in `work`, deleted here unless `keep_corpora`. Returns (report, {"ref": the one-shot
    index, "wiki100k": the streaming index with the store})."""
    from tpu_ir_torch.index import build_index, build_index_streaming
    from tpu_ir_torch.index.verify import verify_index

    out = {"phase": "positions", "card": card, "configs": {}}
    keep = {}
    for config, builds in (
            ("ref", {
                "oneshot": lambda c, d: build_index(
                    c, d, num_shards=10, positions=True, device=device),
                "legacy": lambda c, d: build_index_streaming(
                    c, d, num_shards=10, batch_docs=POSITIONS_REF_BATCH,
                    radix_buckets=0, positions=True, device=device),
                "radix": lambda c, d: build_index_streaming(
                    c, d, num_shards=10, batch_docs=POSITIONS_REF_BATCH,
                    radix_buckets=16, positions=True, device=device)}),
            ("wiki100k", {
                "streaming": lambda c, d: build_index_streaming(
                    c, d, num_shards=10, batch_docs=50_000,
                    radix_buckets=16, store=True, positions=True,
                    device=device),
                "oneshot": lambda c, d: build_index(
                    c, d, num_shards=10, positions=True, device=device)})):
        corpus = os.path.join(work, f"{config}.trec")
        row = {"builds": {}}
        digests, dirs = {}, {}
        for name, build in builds.items():
            d = dirs[name] = os.path.join(work, f"{config}-pos-{name}")
            row["builds"][name] = timed_build(
                lambda p: build(corpus, p), d, device)
            digests[name] = artifact_digests(d)
            warned = row["builds"][name]["radix_fallback_warning"]
            if name != "oneshot" and warned != (name != "legacy"):
                raise AssertionError(f"{config} {name}: radix fallback "
                                     f"warning {warned}")
        if not keep_corpora:
            os.unlink(corpus)
        names = [set(v) for v in digests.values()]
        shared = sorted(set.intersection(*names))
        extra = sorted(set.union(*names) - set(shared))
        if extra not in ([], ["docstore-idx.npz", "docstore.bin"]) or \
                "positions-00009.npz" not in shared:
            raise AssertionError(f"{config}: artifact sets differ: {extra}")
        differ = [n for n in shared
                  if len({digests[b][n] for b in digests}) != 1]
        if differ:
            raise AssertionError(f"{config}: the positions builds differ "
                                 f"in {differ}")
        row["identical_artifacts"] = len(shared)
        row["sha256"] = {n: digests["oneshot"][n][:16] for n in shared
                         if n.startswith("positions-0000")}
        row["verify_s"] = {}
        for name in ("oneshot", "streaming" if config == "wiki100k"
                     else "legacy"):
            t0 = time.perf_counter()
            report = verify_index(dirs[name])
            row["verify_s"][name] = time.perf_counter() - t0
            if not report["ok"] or not report["has_positions"]:
                raise AssertionError(f"{config} {name}: verify {report}")
        keep[config] = dirs["oneshot" if config == "ref" else "streaming"]
        for name, d in dirs.items():
            if d != keep[config]:
                shutil.rmtree(d)
        out["configs"][config] = row
    return out, keep


def store_streams(idx: str, work: str):
    """Every document's analyzed token stream, from the document store:
    the stored records written to one TREC file and run through the
    native corpus pass. Returns (flat token ids int32, doc of each token
    int32 (docno), {token: id})."""
    from tpu_ir_torch.analysis.native import tokenize_corpus_native
    from tpu_ir_torch.collection import DocnoMapping
    from tpu_ir_torch.index import format as fmt
    from tpu_ir_torch.index.docstore import DocStore

    mapping = DocnoMapping.load(os.path.join(idx, fmt.DOCNOS))
    store = DocStore(idx)
    path = os.path.join(work, "store-records.trec")
    with open(path, "w", encoding="utf-8") as f:
        for docno in range(1, len(mapping) + 1):
            f.write(store.get(docno))
            f.write("\n")
    store.close()
    docids, ids, lengths, vocab = tokenize_corpus_native([path])
    os.unlink(path)
    docnos = np.array([mapping.get_docno(d) for d in docids], np.int32)
    doc_of = np.repeat(docnos, lengths)
    return ids, doc_of, {t: i for i, t in enumerate(vocab)}


def store_streams_timed(idx: str, work: str) -> tuple:
    """store_streams and its seconds (what a child process returns)."""
    t0 = time.perf_counter()
    return (*store_streams(idx, work), time.perf_counter() - t0)


def window_scan(flat: np.ndarray, doc_of: np.ndarray, ids: list[int],
                slop: int) -> list[int]:
    """Docnos whose token stream holds `ids` in order within a span of
    len(ids) - 1 + slop: every start of the first id, and each later id
    looked for in the rest of the start's window, one column at a time
    (a numpy scan of the stream, apart from the position runs)."""
    span = len(ids) - 1 + slop
    starts = np.flatnonzero(flat == ids[0])
    if not len(starts):
        return []
    offs = starts[:, None] + np.arange(1, span + 1)[None, :]
    inside = offs < len(flat)
    offs = np.minimum(offs, len(flat) - 1)
    win = np.where(inside & (doc_of[offs] == doc_of[starts][:, None]),
                   flat[offs], -1)
    cursor = np.full(len(starts), -1)
    alive = np.ones(len(starts), bool)
    for t in ids[1:]:
        # the first occurrence of t after the cursor, in each window
        hit = (win == t) & (np.arange(span)[None, :] > cursor[:, None])
        found = hit.any(axis=1)
        alive &= found
        cursor = np.where(found, hit.argmax(axis=1), span)
    return sorted(set(doc_of[starts[alive]].tolist()))


def phrase_texts(flat: np.ndarray, doc_of: np.ndarray, vocab: list[str],
                 analyzer, n: int, seed: int = 12) -> list[tuple]:
    """`n` (text, window tokens) pairs: a quoted window of 2-3 consecutive
    analyzed tokens of a random doc (so that doc matches), every second
    one with one more token of the same doc after the quotes. Windows
    whose tokens would not analyze back to themselves as query text are
    drawn again."""
    rng = np.random.default_rng(seed)
    bounds = np.flatnonzero(np.diff(doc_of)) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(flat)]])
    out = []
    while len(out) < n:
        d = int(rng.integers(len(starts)))
        lo, hi = int(starts[d]), int(ends[d])
        m = int(rng.integers(2, 4))
        if hi - lo < m:
            continue
        i = lo + int(rng.integers(hi - lo - m + 1))
        window = [vocab[t] for t in flat[i:i + m]]
        text = '"' + " ".join(window) + '"'
        extra = []
        if len(out) % 2:
            extra = [vocab[int(flat[lo + int(rng.integers(hi - lo))])]]
            text += " " + extra[0]
        if analyzer.analyze(text.replace('"', " ")) != window + extra:
            continue
        out.append((text, window))
    return out


def phase_phrase(card: str, scorer, idx: str, work: str, *, device: str,
                 k: int = 10, streams=None) -> dict:
    """Phrase queries on the wiki100k positions index: PHRASE_TEXTS texts
    (phrase_texts, default_rng(12)) through search_batch at each slop of
    PHRASE_SLOPS, TF-IDF and BM25: every text answers (its source doc
    matches), scores finite and ranked; q/s, and on the card the device's
    idle share of a call over the first 200 texts (phrase queries run on
    the host). Then
    PHRASE_ORACLE phrases a slop: match_window against a scan of the
    documents' analyzed token streams from the store (window_scan).
    `streams` is a future of store_streams_timed(idx, work) a child began
    earlier (None: read them here)."""
    from tpu_ir_torch.analysis import Analyzer

    t0 = time.perf_counter()
    if streams is None:
        flat, doc_of, vocab_ids, streams_s = store_streams_timed(idx, work)
    else:
        flat, doc_of, vocab_ids, streams_s = streams.result(timeout=1800)
    wait_s = time.perf_counter() - t0
    vocab = [None] * len(vocab_ids)
    for t, i in vocab_ids.items():
        vocab[i] = t
    pairs = phrase_texts(flat, doc_of, vocab, Analyzer(), PHRASE_TEXTS)
    texts = [t for t, _ in pairs]
    out = {"phase": "phrase", "card": card, "config": "wiki100k",
           "texts": len(texts), "k": k, "examples": texts[:4],
           "store_streams_s": streams_s, "store_streams_wait_s": wait_s,
           "runs": {}}
    t0 = time.perf_counter()
    scorer.search_batch(texts[:8], k=k)             # loads the runs
    out["first_load_s"] = time.perf_counter() - t0
    for slop in PHRASE_SLOPS:
        for scoring in ("tfidf", "bm25"):
            t0 = time.perf_counter()
            res = scorer.search_batch(texts, k=k, scoring=scoring,
                                      phrase_slop=slop)
            wall = time.perf_counter() - t0
            for t, r in zip(texts, res):
                s = [x[1] for x in r]
                if not r or not all(np.isfinite(s)) or \
                        s != sorted(s, reverse=True):
                    raise AssertionError(f"{t!r} slop {slop} {scoring}: "
                                         f"{r!r}")
            row = {"s": wall, "qps": len(texts) / wall,
                   "mean_hits": float(np.mean([len(r) for r in res]))}
            if device == "cuda" and slop == 0 and scoring == "tfidf":
                # the first 200 texts under the profiler: phrase queries
                # dispatch nothing to the card
                row["profile"] = profile_call(lambda: scorer.search_batch(
                    texts[:200], k=k, scoring=scoring, phrase_slop=slop))
                row["host_share"] = row["profile"]["idle_share"]
            out["runs"][f"slop{slop}-{scoring}"] = row
    pidx = scorer._phrase_index()
    t0 = time.perf_counter()
    checked = matched = 0
    for slop in PHRASE_SLOPS:
        for _, window in pairs[:PHRASE_ORACLE]:
            want = window_scan(flat, doc_of, [vocab_ids[t] for t in window],
                               slop)
            got = pidx.match_window(window, slop=slop)
            if got != want:
                raise AssertionError(f"match_window({window}, {slop}): "
                                     f"{len(got)} docs, the stream scan "
                                     f"{len(want)}")
            checked += 1
            matched += len(got)
    out["oracle"] = {"phrases": checked, "matched_docs": matched,
                     "s": time.perf_counter() - t0}
    return out


def plain_min_gap(reader, dictionary, a: str, b: str, docno: int):
    """Smallest |pos_a - pos_b| in a doc by an outer difference of the
    two runs read from the position files, or None."""
    runs = []
    for t in (a, b):
        tp = dictionary.get_value(t)
        if tp is None:
            return None
        hit = np.flatnonzero(tp.postings[:, 0] == docno)
        if not len(hit):
            return None
        runs.append(reader.run(tp.shard, tp.offset + int(hit[0])))
    return int(np.abs(runs[0][:, None] - runs[1][None, :]).min())


def phase_prox(card: str, scorer, q_ids: np.ndarray, *, config: str,
               device: str, k: int = 10) -> dict:
    """The proximity-boosted rerank (search_batch(rerank=PROX_CANDIDATES,
    prox=True)) over the first PROX_QUERIES uniform queries as texts:
    q/s, the kernels' launches by stage 1 (the BM25 candidates) and by
    the cosine stage; then for PROX_ORACLE queries (half of them uniform,
    half pairs of the 200 largest-df terms, which co-occur, so the boost
    engages) the boost recomputed in numpy from the rerank's own
    candidates (plain_min_gap over the position files, the float64
    product, the (score desc, docno asc) order): the final order and
    scores must equal search_batch's bitwise."""
    import tpu_ir_torch
    from tpu_ir_torch.index.dictionary import Dictionary
    from tpu_ir_torch.index.positions import PositionsReader
    from tpu_ir_torch.search.phrase import PROX_ALPHA, PROX_DEPTH

    terms = scorer.vocab.terms
    texts = [" ".join(terms[int(t)] for t in row)
             for row in q_ids[:PROX_QUERIES]]
    scorer.search_batch(texts[:64], k=k, rerank=PROX_CANDIDATES, prox=True)
    stage1 = {n: 0 for n in tpu_ir_torch.kernel_launches()}
    real = scorer._topk_device

    def counted(*a, **kw):
        before = tpu_ir_torch.kernel_launches()
        try:
            return real(*a, **kw)
        finally:
            for n, v in launch_delta(before).items():
                stage1[n] += v

    before = tpu_ir_torch.kernel_launches()
    scorer._topk_device = counted
    try:
        t0 = time.perf_counter()
        res = scorer.search_batch(texts, k=k, rerank=PROX_CANDIDATES,
                                  prox=True, return_docids=False)
        wall = time.perf_counter() - t0
    finally:
        del scorer._topk_device
    total = launch_delta(before)
    for r in res:
        s = [x[1] for x in r]
        if not all(np.isfinite(s)) or s != sorted(s, reverse=True):
            raise AssertionError(f"{config} prox: {r!r}")
    out = {"phase": "prox", "card": card, "config": config,
           "layout": scorer.layout, "queries": len(texts), "k": k,
           "candidates": PROX_CANDIDATES, "s": wall,
           "qps": len(texts) / wall,
           "answered": sum(1 for r in res if r),
           "launches_stage1": stage1,
           "launches_cosine": {n: total[n] - stage1[n] for n in total}}
    # the oracle: the same rerank without the boost, then numpy
    idx = scorer._index_dir
    dictionary, reader = Dictionary(idx), PositionsReader(idx)
    common = np.argsort(-scorer._df_host, kind="stable")[:200]
    pairs = np.random.default_rng(13).choice(
        common, (PROX_ORACLE - PROX_ORACLE // 2, 2))
    sub = texts[:PROX_ORACLE // 2] + [" ".join(terms[int(t)] for t in p)
                                      for p in pairs]
    res = (res[:PROX_ORACLE // 2]
           + scorer.search_batch(sub[PROX_ORACLE // 2:], k=k,
                                 rerank=PROX_CANDIDATES, prox=True,
                                 return_docids=False))
    q = scorer.analyze_queries(sub)
    kk = max(k, min(PROX_DEPTH, PROX_CANDIDATES))
    sc, dn = scorer.rerank_topk(q, k=kk, candidates=PROX_CANDIDATES)
    boosted = 0
    for qi, text in enumerate(sub):
        seq = scorer._query_term_sequence(text)
        row = sc[qi].astype(np.float64)
        for j in range(kk):
            if dn[qi, j] > 0 and row[j] > 0 and len(seq) > 1:
                bonus = 0.0
                for a, b in zip(seq, seq[1:]):
                    if a == b:
                        continue
                    g = plain_min_gap(reader, dictionary, a, b,
                                      int(dn[qi, j]))
                    if g is not None:
                        bonus += 1.0 / (1.0 + g)
                boosted += bonus > 0
                row[j] *= 1.0 + PROX_ALPHA * bonus
        order = np.lexsort((dn[qi], -row))[:k]
        order = order[row[order] > 0]
        want = [(int(dn[qi, j]), np.float32(row[j]).tobytes())
                for j in order]
        got = [(d, np.float32(s).tobytes()) for d, s in res[qi]]
        if got != want:
            raise AssertionError(f"{config} prox {text!r}: {res[qi]!r}")
    if not boosted:
        raise AssertionError(f"{config} prox: the boost never engaged")
    out["oracle"] = {"queries": len(sub), "boosted_candidates": int(boosted)}
    return out


def explain_rows(results) -> list:
    """Every explained hit as (docno, score bits, contributions), after
    holding contribution_sum == score == the returned score bitwise."""
    rows = []
    for res in results:
        for (docno, score), e in zip(res, res.explain or []):
            bits = np.float32(score).tobytes()
            if (e["docno"] != docno or e["contribution_sum"] != e["score"]
                    or np.float32(e["score"]).tobytes() != bits):
                raise AssertionError(
                    f"explain of {e['query']!r} doc {docno}: score "
                    f"{e['score']!r}, sum {e['contribution_sum']!r}, the "
                    f"result's {score!r}")
            rows.append((docno, bits, [t["contribution"]
                                       for t in e["terms"]]))
    return rows


def phase_explain(card: str, scorer, texts: list[str], *, config: str,
                  traffic: str, runs: tuple) -> dict:
    """Explain on a loaded scorer: each of `runs` ("tfidf", "bm25",
    "rerank") over EXPLAIN_QUERIES texts with explain_k=EXPLAIN_K: every
    entry's contribution_sum equals its score, and its score the one
    search_batch returned, as float32 bits; then the same with every
    kernel swapped for its plain twin (plain_kernels), whose entries must
    be the same bits. Explain ms a query is the call's wall time less
    the same call's without explain. The caller counts the launches."""
    texts = texts[:EXPLAIN_QUERIES]
    out = {"phase": "explain", "card": card, "config": config,
           "layout": scorer.layout, "traffic": traffic,
           "queries": len(texts), "explain_k": EXPLAIN_K, "runs": {}}
    for run in runs:
        kw = ({"rerank": PROX_CANDIDATES} if run == "rerank"
              else {"scoring": run})
        scorer.search_batch(texts[:4], explain_k=EXPLAIN_K,
                            return_docids=False, **kw)
        t0 = time.perf_counter()
        scorer.search_batch(texts, return_docids=False, **kw)
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = scorer.search_batch(texts, explain_k=EXPLAIN_K,
                                  return_docids=False, **kw)
        wall = time.perf_counter() - t0
        got = explain_rows(res)
        with plain_kernels():
            want = explain_rows(scorer.search_batch(
                texts, explain_k=EXPLAIN_K, return_docids=False, **kw))
        if got != want:
            raise AssertionError(f"{config} {traffic} {run}: explain "
                                 "through the kernels differs from the "
                                 "plain twins'")
        skips = [e["dispatch"]["skip_hot"] for r in res
                 for e in (r.explain or [])[:1]]
        out["runs"][run] = {
            "entries": len(got), "s": wall, "search_s": plain_s,
            "explain_ms_per_query": (wall - plain_s) * 1e3 / len(texts),
            "skip_hot_queries": int(sum(skips)),
            "bitwise_plain_twins": True}
        if not got:
            raise AssertionError(f"{config} {traffic} {run}: nothing was "
                                 "explained")
    return out


def phase_snippets(card: str, scorer, q_ids: np.ndarray, *,
                   config: str = "wiki100k", k: int = 10) -> dict:
    """SNIPPET_HITS hits through a ServingFrontend with snippets=True (the
    uniform queries as texts, until that many hits): one snippet a hit,
    every marked word analyzing to one of the query's tokens, and a
    snippet with no mark only where no word of the doc's display text
    does (the query matched the docno, which is not displayed); ms a
    snippet from the request's wall time less the same request's
    without snippets."""
    import re

    from tpu_ir_torch.search.snippets import display_text
    from tpu_ir_torch.serving import ServingFrontend

    fe = ServingFrontend(scorer)
    analyzer = scorer._analyzer()
    terms = scorer.vocab.terms
    hits = marked = unmarked = 0
    snip_s = plain_s = 0.0
    queries = 0
    for row in q_ids:
        if hits >= SNIPPET_HITS:
            break
        text = " ".join(terms[int(t)] for t in row)
        t0 = time.perf_counter()
        base = fe.search(text, k=k, return_docids=False)
        t1 = time.perf_counter()
        res = fe.search(text, k=k, snippets=True, return_docids=False)
        t2 = time.perf_counter()
        if not res:
            continue
        queries += 1
        plain_s += t1 - t0
        snip_s += t2 - t1
        if list(res) != list(base) or len(res.snippets) != len(res):
            raise AssertionError(f"snippets of {text!r}: {res.snippets!r}")
        toks = set(analyzer.analyze(text))
        for (docno, _), snip in zip(res, res.snippets):
            words = re.findall(r"\*\*(.+?)\*\*", snip)
            if any(not toks & set(analyzer.analyze(w)) for w in words):
                raise AssertionError(f"snippet of {text!r} marks {words}")
            if not words:
                shown = display_text(scorer._docstore().get(docno))
                if any(toks & set(analyzer.analyze(w))
                       for w in shown.split(" ")):
                    raise AssertionError(f"snippet of {text!r} in doc "
                                         f"{docno} marks nothing")
                unmarked += 1
            marked += len(words)
        hits += len(res)
    if hits < SNIPPET_HITS:
        raise AssertionError(f"only {hits} hits for the snippets phase")
    return {"phase": "snippets", "card": card, "config": config,
            "queries": queries, "hits": hits, "marked_words": marked,
            "docno_only_hits": unmarked,
            "ms_per_snippet": (snip_s - plain_s) * 1e3 / hits,
            "request_ms": snip_s * 1e3 / queries}


# -- merge, the serving cache, doctor, format v1 ------------------------------

WARM_EXPLAIN_QUERIES = 64       # texts of the warm phase's explain batch
WARM_RERANK = 1_000             # candidates of the warm phase's rerank


def split_corpus(corpus: str, work: str, config: str) -> list[str]:
    """Two TREC files cut at the document boundary nearest the middle,
    whose concatenation is `corpus` byte for byte."""
    with open(corpus, "rb") as f:
        data = f.read()
    cut = data.index(b"<DOC>", len(data) // 2)
    halves = []
    for name, part in (("a", data[:cut]), ("b", data[cut:])):
        path = os.path.join(work, f"{config}-half-{name}.trec")
        with open(path, "wb") as f:
            f.write(part)
        halves.append(path)
    return halves


def merge_check(card: str, corpus: str, work: str, want: dict, *,
                config: str, device: str, positions: bool = False,
                store: bool = False) -> tuple[dict, str]:
    """`corpus` split at a document boundary, each half built one-shot
    into 10 shards (char-grams 2, 3; with the store through one corpus
    pass, the quickest way that carries one; with positions if asked),
    then merged on `device` into 10 shards: every artifact of the merged
    index must have the sha256 in `want` (the full build's digests),
    under the same names. Returns (report, the merged index dir)."""
    import torch

    from tpu_ir_torch.index import build_index, merge_indexes
    from tpu_ir_torch.index.docstore import build_docstore

    on_card = device == "cuda"
    halves = split_corpus(corpus, work, config)
    out = {"halves": {}}
    dirs = []
    for path in halves:
        d = path[: -len(".trec")] + "-idx"
        t0 = time.perf_counter()
        meta = build_index(path, d, num_shards=10, positions=positions,
                           device=device)
        if store:
            build_docstore([path], d)
        if on_card:
            torch.cuda.synchronize()
        out["halves"][os.path.basename(d)] = {
            "wall_s": time.perf_counter() - t0, "num_docs": meta.num_docs}
        dirs.append(d)
        os.unlink(path)
    merged = os.path.join(work, f"{config}-merged")
    with PeakRss() as rss:
        t0 = time.perf_counter()
        meta = merge_indexes(dirs, merged, num_shards=10, device=device)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for d in dirs:
        shutil.rmtree(d)
    with open(os.path.join(merged, "jobs", "MergeIndexes.json")) as f:
        job = json.load(f)
    got = artifact_digests(merged)
    if sorted(got) != sorted(want):
        raise AssertionError(f"{config}: merged artifacts {sorted(got)}, "
                             f"the full build's {sorted(want)}")
    differ = [n for n in got if got[n] != want[n]]
    if differ:
        raise AssertionError(f"{config}: the merge differs from the full "
                             f"build in {differ}")
    out.update({"merge_s": wall, "docs_per_s": meta.num_docs / wall,
                "num_docs": meta.num_docs, "num_pairs": meta.num_pairs,
                "timings_s": job["timings_s"],
                "peak_host_rss_bytes": rss.peak,
                "host_rss_start_bytes": rss.start,
                "identical_artifacts": len(got),
                "has_positions": meta.has_positions,
                "store": "docstore.bin" in got})
    return out, merged


def phase_merge(card: str, work: str, *, widx: str, wdigests: dict,
                ref_pos: str, q_ids: np.ndarray, want: dict,
                device: str, k: int = 10) -> dict:
    """The wiki100k corpus kept in `work` merged from its halves (with
    the store and char-grams) against the radix build's digests
    (`wdigests`), and the ref corpus merged with positions against the
    ref positions build (`ref_pos`); then the merged wiki100k index
    loaded and the uniform queries `q_ids` served (TF-IDF and BM25): its
    top-k must be the radix index's (`want`) bitwise, and cold_tier and
    hot_stage must launch. Both corpora stay for the live phases."""
    import tpu_ir_torch
    from tpu_ir_torch.search import Scorer

    out = {"phase": "merge", "card": card, "configs": {}}
    wiki, merged = merge_check(
        card, os.path.join(work, "wiki100k.trec"), work, wdigests,
        config="wiki100k", device=device, store=True)
    out["configs"]["wiki100k"] = wiki
    ref, ref_merged = merge_check(
        card, os.path.join(work, "ref.trec"), work,
        artifact_digests(ref_pos), config="ref-pos", device=device,
        positions=True)
    shutil.rmtree(ref_merged)
    out["configs"]["ref-pos"] = ref

    tpu_ir_torch.reset_kernel_launches()
    t0 = time.perf_counter()
    scorer = Scorer.load(merged, device=device)
    out["load_s"] = time.perf_counter() - t0
    if scorer.layout != "sparse":
        raise AssertionError(f"merged wiki100k: layout {scorer.layout!r}")
    for scoring in ("tfidf", "bm25"):
        t0 = time.perf_counter()
        got = scorer.topk(q_ids, k=k, scoring=scoring)
        out[f"{scoring}_qps"] = len(q_ids) / (time.perf_counter() - t0)
        if not same_bits(got, want[scoring]):
            raise AssertionError(f"merged wiki100k {scoring}: top-{k} "
                                 "differs from the radix index's")
    out["launches"] = tpu_ir_torch.kernel_launches()
    if device == "cuda" and not (out["launches"]["cold_tier"]
                                 and out["launches"]["hot_stage"]):
        raise AssertionError(f"the merged index's serve never launched "
                             f"cold_tier and hot_stage: {out['launches']}")
    out["topk_bitwise_radix"] = True
    del scorer
    shutil.rmtree(merged)
    return out


class PartOpens:
    """Counts the calls that open a part file (format.load_shard,
    load_shard_verified, read_part, and the verified whole-file read of
    a part) while the `with` block runs."""

    NAMES = ("load_shard", "load_shard_verified", "read_part",
             "_read_file_verified")

    def __enter__(self):
        from tpu_ir_torch.index import format as fmt

        self.n = 0
        self._fmt = fmt
        self._kept = {n: getattr(fmt, n) for n in self.NAMES}
        for name, real in self._kept.items():
            setattr(fmt, name, self._counted(name, real))
        return self

    def _counted(self, name, real):
        def counted(*a, **kw):
            if name != "_read_file_verified" or os.path.basename(
                    str(a[0])).startswith("part-"):
                self.n += 1
            return real(*a, **kw)
        return counted

    def __exit__(self, *exc):
        for name, real in self._kept.items():
            setattr(self._fmt, name, real)
        return False


def phase_warm(card: str, idx: str, q_ids: np.ndarray, hot_q: np.ndarray,
               *, device: str, k: int = 10) -> dict:
    """The serving cache at wiki100k: the cache removed, a load that
    misses (builds the layout, computes the norms, writes the cache),
    then one that hits, counting the part files it opens (none may be
    opened). The hit scorer serves the uniform and hot-term traffic
    (TF-IDF and BM25), the rerank of WARM_RERANK and one explain batch
    of WARM_EXPLAIN_QUERIES texts bitwise as the miss scorer does, and
    must launch cold_tier and hot_stage. Then `tpu-ir-torch warm` once
    through the command line, its JSON recorded."""
    import torch

    import tpu_ir_torch
    from tpu_ir_torch.search import Scorer
    from tpu_ir_torch.search.layout import CACHE_NAME

    on_card = device == "cuda"
    cache = os.path.join(idx, CACHE_NAME)
    shutil.rmtree(cache, ignore_errors=True)

    def timed_load():
        t0 = time.perf_counter()
        s = Scorer.load(idx, device=device)
        if on_card:
            torch.cuda.synchronize()
        return s, time.perf_counter() - t0

    miss, cold_s = timed_load()
    if not os.path.isdir(cache):
        raise AssertionError("the missing load wrote no serving cache")
    with PartOpens() as opens:
        hit, warm_s = timed_load()
    out = {"phase": "warm", "card": card, "config": "wiki100k",
           "cold_load_s": cold_s, "warm_load_s": warm_s,
           "cache_bytes": sum(os.path.getsize(os.path.join(cache, f))
                              for f in os.listdir(cache)),
           "hit_part_opens": opens.n}
    if opens.n or hit._host_pairs is not None:
        raise AssertionError(f"the cache hit opened {opens.n} part files")

    def serve(s):
        res = {}
        for traffic, q in (("uniform", q_ids), ("hot", hot_q)):
            for scoring in ("tfidf", "bm25"):
                res[traffic, scoring] = s.topk(q, k=k, scoring=scoring)
        res["rerank"] = s.rerank_topk(q_ids, k=k, candidates=WARM_RERANK)
        return res

    want = serve(miss)
    tpu_ir_torch.reset_kernel_launches()
    with PartOpens() as opens:
        t0 = time.perf_counter()
        got = serve(hit)
        out["hit_serve_s"] = time.perf_counter() - t0
    out["launches"] = tpu_ir_torch.kernel_launches()
    out["serve_part_opens"] = opens.n
    differ = [key for key in want if not same_bits(want[key], got[key])]
    if differ:
        raise AssertionError(f"the cache hit differs from the miss in "
                             f"{differ}")
    if on_card and not (out["launches"]["cold_tier"]
                        and out["launches"]["hot_stage"]):
        raise AssertionError(f"the hit scorer never launched cold_tier and "
                             f"hot_stage: {out['launches']}")
    if opens.n:
        raise AssertionError(f"the hit scorer's serve opened {opens.n} "
                             "part files (the rerank's norms are cached)")
    terms = hit.vocab.terms
    texts = [" ".join(terms[int(t)] for t in row)
             for row in q_ids[:WARM_EXPLAIN_QUERIES]]
    rows = [explain_rows(s.search_batch(texts, explain_k=EXPLAIN_K,
                                        return_docids=False))
            for s in (miss, hit)]
    if rows[0] != rows[1] or not rows[0]:
        raise AssertionError("explain on the cache hit differs from the "
                             "miss")
    out["explain_entries"] = len(rows[0])
    out["bitwise_miss"] = [key if isinstance(key, str) else "-".join(key)
                           for key in want] + ["explain"]
    del miss, hit
    if on_card:
        torch.cuda.empty_cache()
    # the command line, from a cache-less dir: one miss, one hit
    shutil.rmtree(cache)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "tpu_ir_torch.cli", "warm",
                        idx, "--device", device], capture_output=True,
                       text=True, cwd=os.path.dirname(os.path.abspath(
                           __file__)), timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"tpu-ir-torch warm: {r.stderr[-2000:]}")
    out["cli_s"] = time.perf_counter() - t0
    out["cli"] = json.loads(r.stdout.strip().splitlines()[-1])
    if not (out["cli"]["cache_written"] and out["cli"]["warm_skips_shards"]):
        raise AssertionError(f"tpu-ir-torch warm: {out['cli']}")
    return out


def phase_doctor(card: str, idx: str) -> dict:
    """doctor_report on the wiki100k index after `warm`: its wall s, the
    block bounds' health (ok and exact), the serving caches it lists
    (serving-tiered among them) and the warnings it raised."""
    from tpu_ir_torch.index.doctor import doctor_report

    t0 = time.perf_counter()
    report = doctor_report(idx)
    wall = time.perf_counter() - t0
    bb = report["block_bounds"]
    caches = [c["cache"] for c in report["serving_caches"]]
    if not (bb.get("ok") and bb.get("bounds_exact")):
        raise AssertionError(f"doctor: block bounds {bb}")
    if "serving-tiered" not in caches:
        raise AssertionError(f"doctor: serving caches {caches}")
    return {"phase": "doctor", "card": card, "config": "wiki100k",
            "doctor_s": wall, "block_bounds": bb, "serving_caches": caches,
            "tiers": report["tiers"], "skew": report["df"]["skew"],
            "shards_balance": {k: v for k, v in report["shards"].items()
                               if k != "per_shard"},
            "warnings": report["warnings"]}


def phase_v1(card: str, work: str, idx: str, q_ids: np.ndarray,
             want: dict, *, device: str, k: int = 10) -> dict:
    """The ref corpus kept in `work` built one-shot under
    TPU_IR_FORMAT_VERSION=1 (npz parts) and served dense: its top-k over
    `q_ids` must be the v2 ref index's (`want`) bitwise, with
    dense_score launched; then migrated to v2, when every artifact must
    have the v2 build's (`idx`) sha256; verify_index passes on both."""
    import torch

    import tpu_ir_torch
    from tpu_ir_torch.index import build_index
    from tpu_ir_torch.index.migrate import migrate_index
    from tpu_ir_torch.index.verify import verify_index
    from tpu_ir_torch.search import Scorer

    v1 = os.path.join(work, "ref-v1")
    kept = os.environ.get("TPU_IR_FORMAT_VERSION")
    os.environ["TPU_IR_FORMAT_VERSION"] = "1"
    try:
        t0 = time.perf_counter()
        meta = build_index(os.path.join(work, "ref.trec"), v1,
                           num_shards=10, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        if kept is None:
            del os.environ["TPU_IR_FORMAT_VERSION"]
        else:
            os.environ["TPU_IR_FORMAT_VERSION"] = kept
    if meta.format_version != 1 or not os.path.exists(
            os.path.join(v1, "part-00000.npz")):
        raise AssertionError(f"the v1 build wrote {sorted(os.listdir(v1))}")
    out = {"phase": "v1", "card": card, "config": "ref", "build_s": build_s,
           "verify_v1": verify_index(v1)["ok"]}
    tpu_ir_torch.reset_kernel_launches()
    t0 = time.perf_counter()
    scorer = Scorer.load(v1, device=device)
    out["load_s"] = time.perf_counter() - t0
    if scorer.layout != "dense":
        raise AssertionError(f"ref-v1: layout {scorer.layout!r}")
    for scoring in ("tfidf", "bm25"):
        if not same_bits(scorer.topk(q_ids, k=k, scoring=scoring),
                         want[scoring]):
            raise AssertionError(f"ref-v1 {scoring}: top-{k} differs from "
                                 "the v2 index's")
    out["launches"] = tpu_ir_torch.kernel_launches()
    if device == "cuda" and not out["launches"]["dense_score"]:
        raise AssertionError(f"ref-v1 never launched dense_score: "
                             f"{out['launches']}")
    del scorer
    t0 = time.perf_counter()
    out["migrate"] = migrate_index(v1, to_version=2)
    out["migrate_s"] = time.perf_counter() - t0
    got, full = artifact_digests(v1), artifact_digests(idx)
    if sorted(got) != sorted(full) or any(got[n] != full[n] for n in got):
        raise AssertionError(f"ref-v1 migrated to v2 differs from the v2 "
                             f"build in {[n for n in got if got[n] != full.get(n)]}")
    out["identical_artifacts_after_migrate"] = len(got)
    out["verify_v2"] = verify_index(v1)["ok"]
    out["topk_bitwise_v2"] = True
    shutil.rmtree(v1)
    return out


# ---------------------------------------------------------------------------
# the live index: wiki100k (19d) and its crash recovery at ref scale (19e)
# ---------------------------------------------------------------------------

# the seed is a corpus's first `seed_docs` docs and the rest are the delta's
# adds; `updates` of the seed's docs get another seed doc's text and
# `deletes` others go. buffer_docs None is the writer's default
# (TPU_IR_INGEST_BUFFER_DOCS, 1,000). The CPU test shrinks both.
LIVE = dict(seed_docs=95_000, updates=500, deletes=500, buffer_docs=None)
# ref has 8,761 docs: a delta of 500 adds, 100 updates and 100 deletes in
# flushes of 100, so the feeder dies at its third flush mid-stream
LIVE_CRASH = dict(seed_docs=8_261, updates=100, deletes=100,
                  buffer_docs=100)
LIVE_CRASH_PLAN = "ingest.flush_build:once@3"   # the feeder's third flush
SWAP_PROBE_THREADS = 4          # probe threads across the swap
SWAP_PROBE_S = 0.3              # probing before the swap, and after it
                                # (1.0 before the shard workers, 0.5 before
                                # the router)
SWAP_SAMPLE = 64                # A- and B-tagged responses held bitwise
LIVE_SERVE_TEXTS = 512          # texts A serves through the frontend


def run_cli(argv: list[str]) -> tuple[dict, float]:
    """One tpu-ir-torch command through the command line's entry point in
    this process: its last JSON line and its wall seconds."""
    import io

    from tpu_ir_torch.cli import main as cli_main

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"tpu-ir-torch {' '.join(argv)}: exit {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1]), wall


def corpus_docs(path: str) -> list[tuple[str, str]]:
    """(docid, text) of every record of a TREC file in file order, the text
    as the writer ingests it."""
    from tpu_ir_torch.collection import read_trec_corpus
    from tpu_ir_torch.index.ingest import trec_payload

    return [(d.docid, trec_payload(d.content))
            for d in read_trec_corpus([path])]


def head_records(corpus: str, n: int, out: str) -> None:
    """The first `n` records of a TREC file, byte for byte, into `out`."""
    with open(corpus, "rb") as f:
        data = f.read()
    pos = 0
    for _ in range(n):
        pos = data.index(b"<DOC>", pos) + 1
    cut = data.find(b"<DOC>", pos)
    with open(out, "wb") as f:
        f.write(data[:len(data) if cut < 0 else cut])


def live_ops(seed_docs: list, held_back: list, *, updates: int,
             deletes: int, seed: int = 21) -> list:
    """The delta, in one seeded interleaving: an add of each held-back doc,
    `updates` of the seed's docs given another seed doc's text, and
    `deletes` of other seed docs ([op, docid(, text)] lists)."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(seed_docs), updates + deletes, replace=False)
    donors = rng.choice(len(seed_docs), updates)
    ops = [["add", d, t] for d, t in held_back]
    ops += [["update", seed_docs[i][0], seed_docs[j][1]]
            for i, j in zip(pick[:updates], donors)]
    ops += [["delete", seed_docs[i][0]] for i in pick[updates:]]
    return [ops[i] for i in rng.permutation(len(ops))]


def apply_op(w, op: list, *, refeed: bool = False) -> None:
    """One delta op through an IngestWriter. A re-fed add is an upsert, so
    an op the WAL already replayed is not an error."""
    if op[0] == "delete":
        w.delete(op[1])
    elif op[0] == "add" and not refeed:
        w.add(op[1], op[2])
    else:
        w.update(op[1], op[2])


def survivors(seed_docs: list, ops: list) -> dict:
    """{docid: text} the delta leaves live: the seed's docs in corpus order
    (an update's text in place), then the adds in feed order."""
    live = dict(seed_docs)
    for op in ops:
        if op[0] == "delete":
            del live[op[1]]
        else:
            live[op[1]] = op[2]
    return live


def write_docs(path: str, docs: dict) -> None:
    """`docs` as TREC records in the writer's own framing."""
    with open(path, "w", encoding="utf-8") as f:
        for d, t in docs.items():
            f.write(f"<DOC>\n<DOCNO> {d} </DOCNO>\n<TEXT>\n{t}\n"
                    f"</TEXT>\n</DOC>\n")


def segment_of(live: str) -> str:
    """The one segment dir of a live dir's current (compacted) generation."""
    from tpu_ir_torch.index.segments import LiveIndex

    li = LiveIndex.open(live)
    m = li.manifest()
    if len(m["segments"]) != 1 or m["tombstones"]:
        raise AssertionError(f"{live}: generation {m['gen']} is not "
                             f"compacted: {m['segments']}")
    return li.segment_path(m["segments"][0])


def digest_diff(got: dict, want: dict) -> list[str]:
    return sorted(n for n in set(got) | set(want) if got.get(n) != want.get(n))


def seed_live(live: str, corpus: str, n_seed: int, *, device: str) -> dict:
    """A live dir created and seeded with the first `n_seed` records of
    `corpus` through `tpu-ir-torch ingest --init --add --compact` (one
    flush: the buffer holds the whole seed): generation A, one segment.
    Its wall, docs/s, WAL appends, bytes and fsyncs, and the flush's
    seconds."""
    from tpu_ir_torch import obs

    reg = obs.get_registry()
    seed_path = os.path.join(os.path.dirname(live), "seed.trec")
    head_records(corpus, n_seed, seed_path)
    wal0 = {n: reg.get(f"ingest.{n}")
            for n in ("wal_appends", "wal_bytes", "wal_fsyncs")}
    hist0 = reg.hist_state()
    seed_json, seed_s = run_cli(
        ["ingest", live, "--init", "--add", seed_path, "--buffer-docs",
         str(n_seed + 1), "--compact", "--device", device])
    os.unlink(seed_path)
    flush = reg.delta_summary(hist0, always=("ingest.flush",))
    out = {"wall_s": seed_s, "docs_per_s": n_seed / seed_s,
           **{n: reg.get(f"ingest.{n}") - v for n, v in wal0.items()},
           "flush_s": flush["ingest.flush"]["sum_ms"] / 1e3,
           "generation": seed_json["generation"],
           "segments": seed_json["segments"], "live": seed_json["live"]}
    if seed_json["live"] != n_seed or len(seed_json["segments"]) != 1:
        raise AssertionError(f"the seed: {seed_json}")
    return out


LIVE_TIMED_RUNS = 3             # timed topk runs of a live serve (median)


def live_topk(scorer, q: np.ndarray, *, k: int, scoring: str,
              device: str) -> tuple[tuple, dict, float]:
    """One warmed scorer's topk of `q`: the first timed run's result and
    kernel launches, and q/s over the median of LIVE_TIMED_RUNS runs
    (synchronized on the card)."""
    import torch

    import tpu_ir_torch

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    scorer.topk(q[:64], k=k, scoring=scoring)     # warm-up
    sync()
    walls = []
    for run in range(LIVE_TIMED_RUNS):
        if run == 0:
            tpu_ir_torch.reset_kernel_launches()
        t0 = time.perf_counter()
        got = scorer.topk(q, k=k, scoring=scoring)
        sync()
        walls.append(time.perf_counter() - t0)
        if run == 0:
            first, launches = got, tpu_ir_torch.kernel_launches()
    return first, launches, len(q) / float(np.median(walls))


def swap_probes(frontend, texts: list[str], swap, *, k: int = 10) -> dict:
    """SWAP_PROBE_THREADS probe threads send `texts` (BM25, k) through
    `frontend` for SWAP_PROBE_S, then while `swap()` runs (a
    reload_generation of the frontend, or other work in its place;
    timed), then SWAP_PROBE_S more, while one more thread does nothing
    but wake every 0.5 ms. Returns the responses (completion time,
    generation, text index, bits, degraded), the errors and sheds, the
    reload's wall, the widest gap between successive successful responses
    across the reload (from the last one completed before it began to the
    first completed after it ended), where that gap opened (seconds from
    the reload's start) and the generation of the response that closed
    it, the widest gap in the probing before the reload, and the waking
    thread's widest gap across the reload (what a thread that needs only
    the interpreter lock waited)."""
    import threading

    from tpu_ir_torch.serving import Overloaded

    stop = threading.Event()
    lock = threading.Lock()
    events, errors = [], []
    sheds = [0]
    wakes = []

    def wake() -> None:
        while not stop.is_set():
            wakes.append(time.perf_counter())
            time.sleep(0.0005)

    def probe(tid: int) -> None:
        i = tid
        while not stop.is_set():
            try:
                res = frontend.search(texts[i % len(texts)], k=k,
                                      scoring="bm25")
                done = time.perf_counter()
                with lock:
                    events.append((done, res.generation, i % len(texts),
                                   result_bits(res), res.degraded))
            except Overloaded:
                with lock:
                    sheds[0] += 1
            except Exception as e:  # noqa: BLE001 — counted, must be none
                with lock:
                    errors.append(repr(e))
            i += SWAP_PROBE_THREADS

    threads = [threading.Thread(target=probe, args=(t,), daemon=True)
               for t in range(SWAP_PROBE_THREADS)]
    threads.append(threading.Thread(target=wake, daemon=True))
    start = time.perf_counter()
    for th in threads:
        th.start()
    try:
        time.sleep(SWAP_PROBE_S)
        t0 = time.perf_counter()
        swap()
        t1 = time.perf_counter()
        time.sleep(SWAP_PROBE_S)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60.0)
    done = sorted(e[0] for e in events)
    before = [t for t in done if t < t0]
    after = [t for t in done if t > t1]
    if not before or not after:
        raise AssertionError(f"the swap: {len(before)} responses before it, "
                             f"{len(after)} after it")
    span = np.array([t for t in done if before[-1] <= t <= after[0]])
    widest = int(np.argmax(np.diff(span)))
    closed_by = next(e[1] for e in events if e[0] == span[widest + 1])
    baseline = [start] + before
    woke = [t for t in wakes if t < t0][-1:] + [t for t in wakes
                                                if t0 <= t <= t1]
    woke += [t for t in wakes if t > t1][:1]
    return {"events": events, "errors": errors, "sheds": sheds[0],
            "wake_gap_ms": 1e3 * float(np.diff(woke).max()),
            "reload_wall_s": t1 - t0,
            "swap_gap_ms": 1e3 * float(span[widest + 1] - span[widest]),
            "gap_opened_s": float(span[widest] - t0),
            "gap_closed_by": closed_by,
            "baseline_gap_ms": 1e3 * float(np.diff(baseline).max())
            if len(baseline) > 1 else 0.0}


def gap_trial(probed: dict, part_opens: int | None = None) -> dict:
    """One swap_probes run's numbers, without its responses; it must have
    no error and no shed."""
    if probed["errors"] or probed["sheds"]:
        raise AssertionError(f"a gap trial: {probed['errors'][:3]}, "
                             f"{probed['sheds']} shed")
    out = {key: probed[key] for key in (
        "reload_wall_s", "swap_gap_ms", "gap_opened_s", "baseline_gap_ms",
        "wake_gap_ms")}
    out["probes"] = len(probed["events"])
    if part_opens is not None:
        out["part_opens"] = part_opens
    return out


def copy_trial(frontend, texts: list[str], n_bytes: int, copy, *,
               k: int) -> dict:
    """One gap trial with no swap: `copy()` (a host-to-card copy of
    `n_bytes`, synchronized) under the probes, with its bytes, wall and
    GB/s."""
    trial = gap_trial(swap_probes(frontend, texts, copy, k=k))
    trial["bytes"] = n_bytes
    trial["copy_wall_s"] = trial["reload_wall_s"]
    trial["gb_per_s"] = n_bytes / trial["copy_wall_s"] / 1e9
    return trial


def span_timeline(root, prefix: str = "load.") -> list:
    """[name, start ms, duration ms] of every span under `root` whose name
    starts with `prefix`, at any depth, in start order, the start counted
    from `root`'s."""
    rows = []

    def walk(span):
        for c in span.children:
            if c.name.startswith(prefix):
                rows.append([c.name, (c.start_ns - root.start_ns) / 1e6,
                             c.dur_ns / 1e6])
            walk(c)

    walk(root)
    return sorted(rows, key=lambda r: r[1])


def gap_within(timeline: list, opened_s: float, gap_ms: float) -> list:
    """The names of the timeline's spans that overlap the gap."""
    lo, hi = 1e3 * opened_s, 1e3 * opened_s + gap_ms
    return sorted({name for name, start, dur in timeline
                   if start < hi and start + dur > lo})


def traced_reload(frontend, gen: int, device: str) -> dict:
    """`frontend.reload_generation(generation=gen)` inside one span: its
    load.* spans' timeline, the warm-up's interval (the coalescer's
    precompile, the reload's last step), the bytes its uploads moved
    across the link, their seconds (the load.h2d spans) and GB/s, and the
    card's allocated memory's growth."""
    import torch

    from tpu_ir_torch import obs

    reg = obs.get_registry()
    h2d0 = reg.get("load.h2d_bytes")
    hist0 = reg.hist_state()
    before = torch.cuda.memory_allocated() if device == "cuda" else 0
    with obs.trace("swap.reload") as root:
        frontend.reload_generation(generation=gen)
    grew = (torch.cuda.memory_allocated() - before if device == "cuda"
            else 0)
    stages = ("load.meta", "load.vocab", "load.read", "load.layout",
              "load.norms", "load.cache_write", "load.strip", "load.h2d",
              "batch.precompile")
    steps = reg.delta_summary(hist0, always=stages)
    timeline = span_timeline(root)
    wall_ms = root.dur_ns / 1e6
    warm_ms = steps["batch.precompile"]["sum_ms"]
    timeline.append(["warm_up", wall_ms - warm_ms, warm_ms])
    crossed = reg.get("load.h2d_bytes") - h2d0
    h2d_s = steps["load.h2d"]["sum_ms"] / 1e3
    return {"bytes": crossed, "copy_wall_s": h2d_s,
            "gb_per_s": crossed / h2d_s / 1e9 if h2d_s else None,
            "uploads": steps["load.h2d"]["count"],
            "allocated_growth": grew,
            "stages_ms": {name: steps[name]["sum_ms"] for name in stages},
            "timeline": timeline}


def gap_trials(frontend, texts: list[str], scorer_a, gen_b: int, seg_b: str,
               b_bytes: int, crossing: int, *, k: int, device: str,
               done: dict) -> dict:
    """What holds the swap's gap, beside the two swaps `done` already
    measured (B loaded cold, A preloaded; through `frontend`, which
    coalesces and serves A): B loaded again from the serving cache its
    first load wrote (no part file opened); the same cache hit and the
    preloaded swap through a frontend with no coalescer, so no warm-up;
    with no swap at all, one pageable host-to-card copy of `b_bytes` (B's
    growth of the card's allocated memory on its first load), one
    streamed copy (utils/transfer.py::stream_to_device: pinned chunks on
    a side stream) of `crossing` bytes (what B's first load moved across
    the link) and one pageable copy of as many; and B loaded cold again
    (its serving cache removed) through the streamed uploads, then once
    more through pageable_uploads (the control). Each trial's gaps as
    swap_probes gives them; the copies' bytes, copy wall and GB/s; the
    cache hit's and the cold loads' as traced_reload gives them, with the
    spans that overlap the gap."""
    import torch

    from tpu_ir_torch.search.layout import CACHE_NAME
    from tpu_ir_torch.serving import ServingConfig, ServingFrontend
    from tpu_ir_torch.utils.transfer import stream_to_device

    if not os.path.isdir(os.path.join(seg_b, CACHE_NAME)):
        raise AssertionError("B's first load wrote no serving cache")
    trials = {name: gap_trial(probed) for name, probed in done.items()}

    def traced(name: str, probed: dict, reloads: list, **kw) -> None:
        trial = gap_trial(probed, **kw)
        trial.update(reloads[0])
        trial["gap_within"] = gap_within(trial["timeline"],
                                         trial["gap_opened_s"],
                                         trial["swap_gap_ms"])
        trials[name] = trial

    reloads = []
    with PartOpens() as opens:
        probed = swap_probes(frontend, texts, lambda: reloads.append(
            traced_reload(frontend, gen_b, device)), k=k)
    traced("cache_hit_coalesced", probed, reloads, part_opens=opens.n)
    plain = ServingFrontend(scorer_a, ServingConfig(
        max_concurrency=SWAP_PROBE_THREADS, max_queue=16))
    with PartOpens() as opens:
        probed = swap_probes(
            plain, texts, lambda: plain.reload_generation(generation=gen_b),
            k=k)
    trials["cache_hit_plain"] = gap_trial(probed, opens.n)
    trials["preloaded_plain"] = gap_trial(swap_probes(
        plain, texts, lambda: plain.reload_generation(scorer_a), k=k))
    del plain
    for name in ("cache_hit_coalesced", "cache_hit_plain"):
        if trials[name]["part_opens"]:
            raise AssertionError(f"{name}: B's cached load opened "
                                 f"{trials[name]['part_opens']} part files")

    def copied(fn):
        def run():
            copies.append(fn())
            if device == "cuda":
                torch.cuda.synchronize()
        return run

    copies = []
    host = torch.ones(b_bytes, dtype=torch.uint8)
    trials["upload_coalesced"] = copy_trial(
        frontend, texts, b_bytes,
        copied(lambda: host.to(device, copy=True)), k=k)
    del host
    cross = np.ones(crossing, np.uint8)
    trials["stream_crossing"] = copy_trial(
        frontend, texts, crossing,
        copied(lambda: stream_to_device(cross, device=device)), k=k)
    trials["pageable_crossing"] = copy_trial(
        frontend, texts, crossing,
        copied(lambda: torch.from_numpy(cross).to(device)), k=k)
    copies.clear()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the same cold load twice: streamed, then with the uploads as they
    # were before the streamed path (the control)
    for name, uploads in (("cold_streamed", contextlib.nullcontext),
                          ("cold_pageable", pageable_uploads)):
        shutil.rmtree(os.path.join(seg_b, CACHE_NAME))
        reloads = []
        with uploads():
            probed = swap_probes(frontend, texts, lambda: reloads.append(
                traced_reload(frontend, gen_b, device)), k=k)
        traced(name, probed, reloads)
        if not os.path.isdir(os.path.join(seg_b, CACHE_NAME)):
            raise AssertionError(f"B's load of {name} wrote no serving "
                                 "cache")
    return trials


@contextlib.contextmanager
def pageable_uploads():
    """While the block runs, stream_to_device's card path is what every
    upload of the port was before it: one pageable copy of the whole
    array on the caller's stream (no staging, no side stream); the CRC
    is folded over the whole array after it. The control of the gap
    trials' cold load."""
    import warnings
    import zlib

    import torch

    from tpu_ir_torch.utils import transfer

    def pageable(src, dst, step, fold):
        with warnings.catch_warnings():   # a read-only memory map
            warnings.simplefilter("ignore", UserWarning)
            dst.copy_(torch.from_numpy(src))
        return zlib.crc32(src) if fold else 0

    real = transfer._chunks_cuda
    transfer._chunks_cuda = pageable
    try:
        yield
    finally:
        transfer._chunks_cuda = real


SHARD_WORKERS = 2               # doc shards of the shards phase
SHARD_REPLICAS = 2              # replicas a shard (failover and hedging)
SHARD_CLIENTS = 8               # client threads of its routed traffic
SHARD_TEXTS = 256               # routed texts a scoring (512 before the
#                                 profiler's checks)
SHARD_TRACE_PASSES = 3          # traced and untraced passes of the TF-IDF
                                # texts each, alternating (medians)
SHARD_KILL_AT = 0.3             # share of the routed texts answered when
#                                 replica (0, 1) is SIGKILLed
SHARD_RERANK_TEXTS = 32         # texts through the rerank's two phases (64
#                                 before the routed attribution passes)
SHARD_RERANK = 100              # the rerank's candidates
SHARD_PROBE_TEXTS = 64          # BM25 texts the probes send across the walk
SHARD_SOLO_RPCS = 32            # one-term texts sent by one client alone
SHARD_DEADLINE_MS = 5_000.0     # the router's per-shard deadline there
ORACLE_K = 1_000                # depth of a partial answer's oracle ranking
ROUTER_STAGES = ("router.request", "router.shard_rtt", "router.merge")
ELASTIC_NARROW = 2              # requests at once through the router the
#                                 autoscaler reads (tpu_ir's closed-loop test)
ELASTIC_PROBE_S = 0.1           # one probe this often while the fleet idles
ELASTIC_KILL_CLIENTS = 4        # client threads across the scripted kill
ELASTIC_MEMORY_SLACK = 0.5e9    # bytes the card may hold past its memory
#                                 before the grow once the retires are done
ELASTIC_TIMEOUT_S = 300.0       # the burst's and the idle's bound
ELASTIC_HOT_TEXTS = 2           # texts led by a hot term sent once a
#                                 replica at 2 x 3 by one client


def nvidia_smi_apps() -> dict:
    """{pid: used MiB} of the processes on the card, as nvidia-smi's
    compute-apps query gives them (pids as the card's host sees them,
    which in a container need not be this namespace's)."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    apps = {}
    for line in r.stdout.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
            apps[int(parts[0])] = int(parts[1])
    return apps


def card_used_mib() -> int:
    """The card's used memory in MiB, as nvidia-smi gives it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    return int(r.stdout.split()[0])


def router_window(router, reg, hist_before: dict, counters_before: dict,
                  requests: int) -> dict:
    """The router's histograms (p50 / p99 ms, log-bucket estimates) and
    counters (`router.stats()`) over one window of `requests` routed
    requests, hedges fired and won a request among them."""
    lat = reg.delta_summary(hist_before, always=ROUTER_STAGES)
    counters = {n: v - counters_before.get(n, 0)
                for n, v in router.stats().items()}
    out = {stage: {k: lat[stage][k] for k in ("count", "p50_ms", "p99_ms")}
           for stage in ROUTER_STAGES}
    out["counters"] = counters
    out["hedge_fired_per_request"] = (
        counters["router.hedge_fired"] / requests)
    out["hedge_won_per_request"] = counters["router.hedge_won"] / requests
    return out


def partial_oracle(rank: list, ranges: list, shards_ok: tuple,
                   k: int) -> list | None:
    """The exact merge of the answering shards' ranges: the whole ranking
    (`rank`, by docno, ORACLE_K deep) filtered to them; None when the
    filtered list runs out before k while the ranking was cut at ORACLE_K
    (the oracle cannot tell)."""
    keep = [(d, s) for d, s in rank
            if any(ranges[s_][0] <= d <= ranges[s_][1] for s_ in shards_ok)]
    if len(keep) < k and len(rank) >= ORACLE_K:
        return None
    return keep[:k]


def elastic_config():
    """run_distributed_soak's autoscaler defaults over SHARD_REPLICAS."""
    from tpu_ir_torch.serving import AutoscaleConfig

    return AutoscaleConfig(
        min_replicas=SHARD_REPLICAS, max_replicas=SHARD_REPLICAS + 1,
        cooldown_s=0.5, up_occupancy=0.6, down_occupancy=0.15,
        sustain_up=3, sustain_down=25, drain_timeout_s=15.0)


def recording_autoscaler(ss, router):
    """An Autoscaler (elastic_config) that keeps each decision that acted,
    with the wall times its tick began and ended, in `decisions`."""
    from tpu_ir_torch.serving import Autoscaler

    class Recording(Autoscaler):
        def tick(self, now=None):
            t0 = time.perf_counter()
            d = super().tick(now)
            if d["action"] is not None:
                self.decisions.append((t0, time.perf_counter(), d))
            return d

    scaler = Recording(ss, router, elastic_config())
    scaler.decisions = []
    return scaler


def nice_of(pid: int) -> int:
    """A process's nice value (field 19 of /proc/<pid>/stat)."""
    with open(f"/proc/{pid}/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[16])


# the parts of a routed request's time, from its stitched trace
ATTRIBUTION_PARTS = ("request", "admission_wait", "attempt",
                     "worker_request", "worker_admission_wait", "dispatch",
                     "kernel", "wire", "remainder")
ATTRIBUTION_SLACK_MS = 1.0      # how far a nested span may pass its parent
# attempts the harvest waited for: their duration ends inside the root
ATTEMPT_HARVESTED = ("won", "lost", "failed")


def trace_attribution(st: dict, res) -> dict:
    """One routed request's time from its stitched trace (disttrace.stitch)
    and its answer `res` (shards_ok, hedges), in ms: the root `request`;
    its `admission_wait`; the critical attempt, the longest winning
    `rpc.search` over the shards in `res.shards_ok` (a hedge when the
    hedge won; a failed or lost attempt is never it); inside it the
    worker's own `request` span and the `admission_wait`, `dispatch` and
    `kernel` spans under that (each summed); the wire, the attempt less
    the worker's request (HTTP, JSON, the pool and the socket); the
    router's remainder, the root less the admission wait and the critical
    attempt (the merge, the waits in the pool, the failed attempts before
    a failover). With the attempts counted, the failed ones, whether the
    critical one was a hedge, and the shards that were tried but did not
    answer. `problems` lists what makes the answer unsound, and the parts
    are filled only when it is empty: the routed soak's shape rule
    (soak._trace_shape_ok) broken, a root that is not the router's
    `request`, a contributing shard's winning attempt without exactly
    one worker `request` span under it or without a `kernel` span in
    that, and spans that do not nest within ATTRIBUTION_SLACK_MS: every
    attempt starting inside the root and, once harvested, ending inside
    it; the worker's admission wait and dispatch inside its request, the
    kernels inside the dispatch, the worker's request inside the attempt
    and the admission wait and attempt inside the root (the wire and the
    remainder not below zero). A wrong stitch or a skewed clock breaks
    one of these."""
    from tpu_ir_torch.serving.soak import _trace_shape_ok, _walk_spans

    ok, why = _trace_shape_ok(st, res)
    if not ok:
        return {"problems": [why]}
    root = st["roots"][0]
    if root.get("name") != "request":
        return {"problems": [f"root {root.get('name')!r}"]}
    slack = ATTRIBUTION_SLACK_MS
    r0, r1 = root["start_ms"], root["start_ms"] + root["dur_ms"]
    attempts = [n for n in _walk_spans([root])
                if n["name"].startswith("rpc.")]
    problems = []
    for a in attempts:
        end = a["start_ms"] + a["dur_ms"]
        if not r0 - slack <= a["start_ms"] <= r1 + slack or (
                a["attrs"]["outcome"] in ATTEMPT_HARVESTED
                and end > r1 + slack):
            problems.append(f"attempt outside the root: {a['attrs']}")
    won = {a["attrs"]["shard"]: a for a in attempts
           if a["name"] == "rpc.search" and a["attrs"]["outcome"] == "won"}
    per_shard = {}
    for s in res.shards_ok:
        a = won[s]
        reqs = [c for c in a.get("children", ())
                if c["name"] == "request"
                and c.get("service", "").startswith("worker-")]
        if len(reqs) != 1:
            problems.append(f"shard {s}: {len(reqs)} worker request spans")
            continue
        req = reqs[0]
        spans = list(_walk_spans([req]))

        def total(name, spans=spans):
            return sum(n["dur_ms"] for n in spans if n["name"] == name)

        parts = {"worker_request": req["dur_ms"],
                 "worker_admission_wait": total("admission_wait"),
                 "dispatch": total("dispatch"), "kernel": total("kernel")}
        if not any(n["name"] == "kernel" for n in spans):
            problems.append(f"shard {s}: no kernel span")
        if (parts["worker_admission_wait"] + parts["dispatch"]
                > parts["worker_request"] + slack):
            problems.append(f"shard {s}: admission wait and dispatch "
                            f"outside the worker's request")
        if parts["kernel"] > parts["dispatch"] + slack:
            problems.append(f"shard {s}: kernel outside the dispatch")
        per_shard[s] = (a, parts)
    if problems:
        return {"problems": problems}
    shard = max(per_shard, key=lambda s_: per_shard[s_][0]["dur_ms"])
    a, parts = per_shard[shard]
    admission = sum(c["dur_ms"] for c in root.get("children", ())
                    if c["name"] == "admission_wait")
    out = {
        "request": root["dur_ms"],
        "admission_wait": admission,
        "attempt": a["dur_ms"],
        **parts,
        "wire": a["dur_ms"] - parts["worker_request"],
        "remainder": root["dur_ms"] - admission - a["dur_ms"],
        "critical_shard": shard,
        "critical_hedge": bool(a["attrs"].get("hedge")),
        "attempts": len(attempts),
        "failed": sum(1 for x in attempts
                      if x["attrs"]["outcome"] == "failed"),
        "missing_shards": sorted({x["attrs"]["shard"] for x in attempts}
                                 - set(res.shards_ok)),
        "problems": [],
    }
    # the worker's request inside the attempt, the admission wait and the
    # attempt inside the root
    for part in ("wire", "remainder"):
        if out[part] < -slack:
            out["problems"].append(f"{part} {out[part]:.3f} ms")
    return out


def attribute_traces(seen: list) -> dict:
    """Stitch the trace of every answer in `seen` ((trace id, answer)
    pairs, the id None when the answer carries none) and attribute each
    (trace_attribution): the answers, the traces stitched, those with a
    problem (and a few of them), how often each shard's attempt was the
    critical one and how often a hedge, the failed attempts, and p50, p99
    (ms) and share of the summed roots of each part."""
    from tpu_ir_torch.obs import disttrace

    rows, bad, untraced = [], [], 0
    for tid, res in seen:
        st = disttrace.stitch(tid, include_spool=False) if tid else None
        if st is None:
            untraced += 1
            continue
        att = trace_attribution(st, res)
        if att["problems"]:
            bad.append({"trace_id": tid, "problems": att["problems"][:3]})
        else:
            rows.append(att)
    out = {"answers": len(seen), "stitched": len(seen) - untraced,
           "problems": len(bad), "problem_samples": bad[:3]}
    if not rows:
        return out
    total = sum(r["request"] for r in rows) or 1.0
    out["parts"] = {
        p: {"p50_ms": float(np.percentile([r[p] for r in rows], 50)),
            "p99_ms": float(np.percentile([r[p] for r in rows], 99)),
            "share": sum(r[p] for r in rows) / total}
        for p in ATTRIBUTION_PARTS}
    out["critical_shards"] = {
        str(s): sum(r["critical_shard"] == s for r in rows)
        for s in sorted({r["critical_shard"] for r in rows})}
    out["critical_hedges"] = sum(r["critical_hedge"] for r in rows)
    out["failed_attempts"] = sum(r["failed"] for r in rows)
    return out


def routed_traffic(router, reg, texts: list, idx: list, want: dict,
                   gen: int, *, clients: int, k: int, until=None,
                   timeout_s: float = 600.0, shed_ok: bool = False,
                   seen: list | None = None) -> dict:
    """TF-IDF texts `idx` through router.search from `clients` threads,
    each once, or (with `until`) cycled until until() holds: every answer
    must be full, of generation `gen` and bitwise want[i], and answers
    plus sheds (Overloaded, allowed with `shed_ok`) must be every request
    sent. Returns the answers, sheds, errors and mismatches, wall s, q/s
    (answers), the client's p50 and p99 ms over the answers and the
    router's histograms (sheds included) and counters. `seen` gets each
    answer's (trace id, shards_ok)."""
    import threading

    from tpu_ir_torch.serving import Overloaded, Router

    lock = threading.Lock()
    lat, errors, bad, shed = [], [], [], []
    cursor = [0]
    deadline = time.monotonic() + timeout_s

    def client() -> None:
        while time.monotonic() < deadline:
            with lock:
                n = cursor[0]
                cursor[0] += 1
            if until is None and n >= len(idx):
                return
            if until is not None and until():
                return
            i = idx[n % len(idx)]
            t_req = time.perf_counter()
            try:
                res = router.search(texts[i], k=k, scoring="tfidf",
                                    return_docids=False)
            except Overloaded as e:
                with lock:
                    shed.append(e.reason)
                continue
            except Exception as e:  # noqa: BLE001 — counted, none
                with lock:
                    errors.append(repr(e))
                continue
            with lock:
                lat.append(time.perf_counter() - t_req)
                if seen is not None:
                    seen.append((res.trace_id, res))
                if (Router.classify(res) != "full" or res.generation != gen
                        or result_bits(res) != want[i]):
                    bad.append(i)

    c0, h0 = router.stats(), reg.hist_state()
    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout_s + 60)
    wall = time.perf_counter() - t0
    sent = len(lat) + len(shed) + len(errors)
    out = router_window(router, reg, h0, c0, max(sent, 1))
    ms = np.array(lat) * 1e3 if lat else np.zeros(1)
    out.update({"texts": sent, "answers": len(lat), "shed": len(shed),
                "shed_reasons": sorted(set(shed)), "errors": len(errors),
                "error_samples": errors[:3], "mismatches": len(bad),
                "wall_s": wall, "routed_qps": len(lat) / wall,
                "request_p50_ms": float(np.percentile(ms, 50)),
                "request_p99_ms": float(np.percentile(ms, 99))})
    if (errors or bad or not lat or any(th.is_alive() for th in threads)
            or (shed and not shed_ok)
            or out["counters"]["router.served_full"] != len(lat)
            or out["counters"]["router.shed"] != len(shed)):
        raise AssertionError(f"routed traffic: {out}")
    return out


def worker_launches(ss) -> dict:
    """{pid: (kernel launches, those of its warm-ups)} of every live
    worker, from its /healthz."""
    from tpu_ir_torch.serving import get_worker_health

    out = {}
    for row in ss.handles():
        for h in row:
            if h is not None and h.alive:
                w = get_worker_health(h.addr, 60)["worker"]
                out[h.pid] = (w["kernel_launches"], w["warm_launches"])
    return out


def phase_elastic(card: str, ss, router, live: str, scorer_b, gen_b: int,
                  texts: list, *, device: str, k: int = 10):
    """The elastic fleet on the `shards` phase's ShardSet (2 x 2 on B,
    pinned to B) and Router. Returns (its line, the pids it SIGKILLed)."""
    import threading

    import torch

    from tpu_ir_torch import obs
    from tpu_ir_torch.obs import disttrace
    from tpu_ir_torch.obs.server import MetricsServer
    from tpu_ir_torch.serving import Router, RouterConfig, get_worker_health

    reg = obs.get_registry()
    on_card = device == "cuda"
    t_phase = time.perf_counter()
    # the SLO windows start empty: the shards phase's mixed-window partial
    # answers would otherwise keep the fast window's burn past the
    # autoscaler's 2.0 for its 60 s, and a burning autoscaler at its
    # ceiling drains nothing (on an H100 it waited 750 ticks, 38 s)
    disttrace.reset()
    out = {"phase": "elastic", "card": card, "config": "wiki100k-live",
           "shards": SHARD_WORKERS,
           "replicas": [SHARD_REPLICAS, SHARD_REPLICAS + 1],
           "clients": SHARD_CLIENTS, "narrow_concurrency": ELASTIC_NARROW}
    idx = list(range(SHARD_TEXTS))   # the shards phase's TF-IDF texts
    want = dict(zip(idx, (result_bits(r) for r in scorer_b.search_batch(
        [texts[i] for i in idx], k=k, scoring="tfidf",
        return_docids=False))))
    # texts whose blocks run the hot stage in every worker (the hot set is
    # the generation's, the same in each shard's scorer): the first routed
    # texts, each led by a hot term of the strip's first rows
    hot_texts, hot_want = [], {}
    if scorer_b.layout == "sparse":
        ranks = scorer_b._hot_rank_host
        out["hot_bearing_texts"] = int(scorer_b._has_hot(
            scorer_b.analyze_queries([texts[i] for i in idx])).sum())
        hot_ids = np.flatnonzero(ranks >= 0)
        hot_ids = hot_ids[np.argsort(ranks[hot_ids], kind="stable")]
        terms = [scorer_b.vocab.terms[int(t)] for t in hot_ids[:64]]
        # a stem need not analyze to itself ("aaftsecli" stems to
        # "aaftsec"): the terms whose own analysis is hot
        keep = scorer_b._has_hot(scorer_b.analyze_queries(terms))
        hot_texts = [f"{t} {texts[i]}" for t, i in zip(
            [t for t, h in zip(terms, keep) if h][:ELASTIC_HOT_TEXTS], idx)]
        if not (len(hot_texts) == ELASTIC_HOT_TEXTS and scorer_b._has_hot(
                scorer_b.analyze_queries(hot_texts)).all()):
            raise AssertionError(f"texts led by a hot term: {hot_texts}")
        hot_want = dict(enumerate(result_bits(r) for r in
                                  scorer_b.search_batch(
                                      hot_texts, k=k, scoring="tfidf",
                                      return_docids=False)))
    elif on_card:
        raise AssertionError("the elastic fleet's layout is not tiered")
    c0 = {n: reg.get(n) for n in ("scale.up", "scale.down",
                                  "router.breaker_opened")}
    h0 = reg.hist_state()
    base = worker_launches(ss)

    def drive(r, **kw) -> dict:
        return routed_traffic(r, reg, texts, idx, want, gen_b,
                              clients=SHARD_CLIENTS, k=k, **kw)

    out["fleet_2x2"] = drive(router)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out["used_before_grow_mib"] = card_used_mib()

    # the burst through the narrow router until the autoscaler has grown
    narrow = Router(live, ss, RouterConfig(
        deadline_ms=SHARD_DEADLINE_MS, max_concurrency=ELASTIC_NARROW,
        max_queue=128))
    sigkilled = set()
    try:
        scaler = recording_autoscaler(ss, narrow)
        t0 = time.perf_counter()
        scaler.run_in_thread()
        try:
            # two requests at once: the queue behind them is the
            # pressure, and a waiter that newer arrivals keep beating to
            # a slot may shed after the deadline (counted, answered
            # requests + sheds == requests)
            burst = drive(narrow, until=lambda: reg.get("scale.up")
                          - c0["scale.up"] >= SHARD_WORKERS,
                          timeout_s=ELASTIC_TIMEOUT_S, shed_ok=True)
        finally:
            scaler.stop()
        ups = [(a, b, d) for a, b, d in scaler.decisions
               if d["action"] == "up"]
        grown = [(s, SHARD_REPLICAS) for s in range(SHARD_WORKERS)]
        if not ups or ups[0][2]["slots"] != grown:
            raise AssertionError(f"the autoscaler's grow: "
                                 f"{scaler.decisions}")
        t_dec, t_done, dec = ups[0]
        handles = ss.handles()
        grid = ss.addresses()
        burst.update({"ticks_to_up": dec["tick"],
                      "decision_s": t_dec - t0, "grow_s": t_done - t_dec,
                      "reason": dec["reason"],
                      "occupancy_at_up": dec["occupancy"]})
        out["burst"] = burst
        if on_card:
            out["used_after_grow_mib"] = card_used_mib()
        out["nice"] = {f"{s}/{r}": nice_of(handles[s][r].pid)
                       for s in range(SHARD_WORKERS)
                       for r in range(SHARD_REPLICAS + 1)}
        grown_health = {sl: get_worker_health(grid[sl[0]][sl[1]], 60)[
            "worker"] for sl in grown}
        for sl, w in grown_health.items():
            if (w["index_generation"] != gen_b or w["generation"] != 0
                    or ss.lifecycle()[sl[0]][sl[1]] != "active"):
                raise AssertionError(f"the grown worker {sl}: {w}")
        out["grown_warm_launches"] = {
            f"{s}/{r}": w["warm_launches"]
            for (s, r), w in grown_health.items()}
        if on_card and not all(sum(w["warm_launches"].values())
                               for w in grown_health.values()):
            raise AssertionError("a grown worker entered the grid before "
                                 "its warm-up launched a kernel")

        # the same texts at 2 x 3 through the wide router
        out["fleet_2x3"] = drive(router)
        # few of the texts hold a hot term, and where the 8 clients' ones
        # land is the round robin's interleaving: the grown replicas' share
        # of them can be none. Each shard's round-robin start turns once a
        # request, so one client sending a hot-bearing text once a replica
        # reaches every replica of every shard with a block that runs the
        # hot stage
        if hot_texts:
            out["hot_pass"] = routed_traffic(
                router, reg, hot_texts,
                [j for j in range(len(hot_texts))
                 for _ in range(SHARD_REPLICAS + 1)],
                hot_want, gen_b, clients=1, k=k)
        after = worker_launches(ss)
        launches = dict.fromkeys(PORT_KERNELS, 0)
        for pid, (kl, wl) in after.items():
            kb, wb = base.get(pid, (dict.fromkeys(kl, 0),
                                    dict.fromkeys(kl, 0)))
            for n in PORT_KERNELS:
                launches[n] += (kl[n] - wl[n]) - (kb[n] - wb[n])
        out["launches"] = launches
        grown_routed = dict.fromkeys(PORT_KERNELS, 0)
        by_worker = {}
        for s, r in grown:
            kl, wl = after[handles[s][r].pid]
            by_worker[f"{s}/{r}"] = {n: kl[n] - wl[n] for n in PORT_KERNELS}
            for n in PORT_KERNELS:
                grown_routed[n] += kl[n] - wl[n]
        out["grown_routed_launches"] = grown_routed
        out["grown_routed_by_worker"] = by_worker
        if on_card and not all(w["cold_tier"] and w["hot_stage"]
                               for w in by_worker.values()):
            raise AssertionError(f"a grown worker's routed traffic never "
                                 f"launched cold_tier and hot_stage: "
                                 f"{by_worker}")

        # idle: a trickle of probes until the autoscaler drained one
        # replica a shard
        stop = threading.Event()
        probes = {"n": 0, "bad": []}

        def trickle() -> None:
            n = 0
            while not stop.wait(ELASTIC_PROBE_S):
                i = idx[n % len(idx)]
                n += 1
                try:
                    res = router.search(texts[i], k=k, scoring="tfidf",
                                        return_docids=False)
                    ok = (Router.classify(res) == "full"
                          and result_bits(res) == want[i])
                except Exception as e:  # noqa: BLE001 — must be none
                    ok = repr(e)
                probes["n"] += 1
                if ok is not True:
                    probes["bad"].append(ok)

        idler = recording_autoscaler(ss, narrow)
        th = threading.Thread(target=trickle, daemon=True)
        t0 = time.perf_counter()
        th.start()
        idler.run_in_thread()
        deadline = time.monotonic() + ELASTIC_TIMEOUT_S
        while (reg.get("scale.down") - c0["scale.down"] < SHARD_WORKERS
               and time.monotonic() < deadline):
            time.sleep(0.05)
        idler.stop()
        stop.set()
        th.join(timeout=60)
        downs = [(a, b, d) for a, b, d in idler.decisions
                 if d["action"] == "down"]
        if (not downs or probes["bad"] or not probes["n"]
                or [(d["shard"], d["replica"]) for d in downs[0][2]["drains"]]
                != grown
                or not all(d["drained_clean"] for d in downs[0][2]["drains"])
                or any(ss.lifecycle()[s][r] != "retired" for s, r in grown)):
            raise AssertionError(f"the idle drain: {idler.decisions} "
                                 f"{probes}")
        t_dec, t_done, dec = downs[0]
        out["idle"] = {"ticks_to_down": dec["tick"],
                       "decision_s": t_dec - t0, "drain_s": t_done - t_dec,
                       "drains": dec["drains"], "probes": probes["n"]}
        # the grow, the 2 x 3 traffic and the drains opened no breaker
        # (the scripted kill below may: its in-flight attempts fail over)
        out["counters"] = {n: reg.get(n) - v for n, v in c0.items()}
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            out["used_after_retire_mib"] = card_used_mib()
            back = out["used_after_retire_mib"] - out["used_before_grow_mib"]
            out["memory_not_returned_mib"] = back
            if abs(back) * 2**20 > ELASTIC_MEMORY_SLACK:
                raise AssertionError(f"the retired workers' memory: "
                                     f"{back} MiB beside before the grow")
        out["retired_alive"] = [handles[s][r].pid for s, r in grown
                                if pid_alive(handles[s][r].pid)]
        if out["retired_alive"]:
            raise AssertionError(f"retired workers alive: "
                                 f"{out['retired_alive']}")

        # a scripted retire of 0/1, SIGKILLed during its drain, under
        # traffic that fails over to 0/0
        drain_out = {}

        def retire() -> None:
            drain_out.update(ss.retire_replica(0, 1, drain_timeout_s=15.0))

        stop_kill = threading.Event()
        kill_pass = {}

        def kill_traffic() -> None:
            kill_pass.update(routed_traffic(
                router, reg, texts, idx, want, gen_b,
                clients=ELASTIC_KILL_CLIENTS, k=k,
                until=stop_kill.is_set, timeout_s=ELASTIC_TIMEOUT_S))

        traffic = threading.Thread(target=kill_traffic, daemon=True)
        traffic.start()
        time.sleep(0.2)
        victim = ss.handles()[0][1]
        rt = threading.Thread(target=retire, daemon=True)
        rt.start()
        for _ in range(400):
            if ss.lifecycle()[0][1] == "draining":
                break
            time.sleep(0.005)
        # inside the poll's first sleep: its first read is done
        time.sleep(0.03)
        ss.kill(0, 1)
        sigkilled.add(victim.pid)
        rt.join(timeout=60)
        time.sleep(0.2)
        stop_kill.set()
        traffic.join(timeout=120)
        if not (drain_out.get("killed_mid_drain")
                and kill_pass.get("answers")):
            raise AssertionError(f"the kill during the drain: {drain_out} "
                                 f"{kill_pass}")
        out["kill_during_drain"] = {"drain": drain_out,
                                    "traffic": kill_pass}
        out["lifecycle"] = ss.lifecycle()
        out["events"] = ss.events()

        # the autoscaler section of this process's /healthz, through the
        # command line
        with MetricsServer() as server:
            scale, _ = run_cli(["scale", "--url", server.url])
        live_sec = scale.get("live") or {}
        if (live_sec.get("lifecycle") != ss.lifecycle()
                or "reason" not in live_sec.get("last_decision", {})):
            raise AssertionError(f"scale --url: {scale}")
        out["scale_cli"] = {"epoch": live_sec["epoch"],
                            "events": live_sec["events"],
                            "last_decision": live_sec["last_decision"],
                            "lifecycle": live_sec["lifecycle"]}
    finally:
        narrow.close()
    lat = reg.delta_summary(h0, always=("scale.warmup_ms", "scale.drain_ms"))
    out["scale_warmup"] = lat["scale.warmup_ms"]
    out["scale_drain"] = lat["scale.drain_ms"]
    out["inflight_peak"] = max(d["inflight_peak"] for d in
                               out["idle"]["drains"]
                               + [out["kill_during_drain"]["drain"]])
    out["scale_down"] = reg.get("scale.down") - c0["scale.down"]
    out["phase_s"] = time.perf_counter() - t_phase
    if (out["counters"]["scale.up"] != SHARD_WORKERS
            or out["counters"]["scale.down"] != SHARD_WORKERS
            or out["scale_down"] != SHARD_WORKERS + 1
            or out["counters"]["router.breaker_opened"]):
        raise AssertionError(f"the elastic counters: {out['counters']}")
    return out, sigkilled


def phase_shards(card: str, work: str, live: str, gen_a: int, gen_b: int,
                 scorers: dict, *, device: str, k: int = 10) -> dict:
    """The routed serving tier on the live dir of phase 19d
    (`wiki100k-live`, generations A and B, full width): a ShardSet of
    SHARD_WORKERS doc shards x SHARD_REPLICAS replicas, each a subprocess
    on the one card serving A, loaded from A's serving cache (spawn to
    ready seconds a worker, what they added to the card's used memory as
    nvidia-smi gives it), behind a Router (tpu_ir's hedge floor, a
    SHARD_DEADLINE_MS deadline). Through Router.search: SHARD_SOLO_RPCS
    texts from one client alone; SHARD_TEXTS TF-IDF and as many BM25 texts
    from SHARD_CLIENTS client threads, replica (0, 1) SIGKILLed once
    SHARD_KILL_AT of them are answered: no request lost, every answer
    full and bitwise the top-10 of A loaded in this process (routed q/s;
    the client's p50 and p99 beside the router's `router.request`,
    `router.shard_rtt` and `router.merge` histograms; hedges fired and
    won a request); SHARD_RERANK_TEXTS texts through the router's
    two-phase rerank bitwise this process's rerank of SHARD_RERANK; then
    rolling_swap to B under 4 threads probing through the Router: every
    answer one generation's, full ones bitwise that generation's top-10
    and partial ones (the mixed window) that generation's exact merge of
    their shards; the walk's widest gap between answers (partial ones
    too), between full answers, and per shard between the answers it
    contributed to, and the staleness, the fleet's and each shard's;
    the killed
    replica respawned comes back on B and answers as its sibling does;
    the workers' cold_tier and hot_stage launches over the routed
    traffic (their /healthz) must be above 0; stop() leaves no worker
    pid alive. Before the killed pass the SHARD_TEXTS TF-IDF texts go
    through the whole fleet SHARD_TRACE_PASSES times traced and as many
    with this process's tracing off (the control), in turns, each answer
    bitwise A's top-10, the traced answers' time attributed from their
    stitched traces (attribute_traces); every answer of the killed pass
    stitches to a sound trace. `scorers` holds A and B loaded in this
    process, by generation."""
    import threading

    import torch

    from tpu_ir_torch import obs
    from tpu_ir_torch.obs import disttrace
    from tpu_ir_torch.search.layout import shard_doc_ranges
    from tpu_ir_torch.serving import (
        Router,
        RouterConfig,
        ShardSet,
        get_worker_health,
        rolling_swap,
        rpc_post,
    )

    reg = obs.get_registry()
    out = {"phase": "shards", "card": card, "config": "wiki100k-live",
           "shards": SHARD_WORKERS, "replicas": SHARD_REPLICAS,
           "generation_a": gen_a, "generation_b": gen_b}
    ss = ShardSet(live, shards=SHARD_WORKERS, replicas=SHARD_REPLICAS,
                  index_generation=gen_a, device=device,
                  rundir=tempfile.mkdtemp(dir=work), spawn_timeout_s=600.0)
    slots = [(s, r) for s in range(SHARD_WORKERS)
             for r in range(SHARD_REPLICAS)]
    pids = set()
    on_card = device == "cuda"
    router = None
    try:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            used0 = card_used_mib()
        t_spawn = time.time()
        t0 = time.perf_counter()
        ss.start()
        out["start_s"] = time.perf_counter() - t0
        out["ready_s"] = [os.stat(ss._cfg_paths(s, r, 0)[1]).st_mtime
                          - t_spawn for s, r in slots]
        grid = ss.addresses()
        pids |= {h.pid for row in ss.handles() for h in row}
        if on_card:
            # what the workers added to the card's used memory (the
            # compute-apps rows need not carry this namespace's pids)
            out["workers_mib"] = card_used_mib() - used0
            out["worker_mib_each"] = out["workers_mib"] / len(slots)
            apps = nvidia_smi_apps()
            out["nvidia_smi_apps_mib"] = {str(p): m for p, m in apps.items()}
        health = {(s, r): get_worker_health(grid[s][r], 60)["worker"]
                  for s, r in slots}
        out["residency"] = [health[sl]["residency"] for sl in slots]
        scorer_a, scorer_b = scorers[gen_a], scorers[gen_b]
        ranges_a = shard_doc_ranges(scorer_a.meta.num_docs, SHARD_WORKERS)
        if ([tuple(health[(s, r)]["doc_range"]) for s, r in slots]
                != [ranges_a[s] for s, _ in slots]
                or {h["index_generation"] for h in health.values()}
                != {gen_a}):
            raise AssertionError(f"the workers' identities: {health}")
        router = Router(live, ss, RouterConfig(deadline_ms=SHARD_DEADLINE_MS))
        # keep every trace, and hold the traced passes' (or the killed
        # pass's, both scorings) until stitched
        disttrace.configure(sample=1, max_traces=max(
            SHARD_TRACE_PASSES, 2) * SHARD_TEXTS + 256)

        # one client alone first: the round trip without queueing
        c0, h0 = router.stats(), reg.hist_state()
        solo = []
        for text in scorer_a.vocab.terms[:SHARD_SOLO_RPCS]:
            t0 = time.perf_counter()
            router.search(text, k=k, scoring="bm25", return_docids=False)
            solo.append(time.perf_counter() - t0)
        out["solo"] = router_window(router, reg, h0, c0, SHARD_SOLO_RPCS)
        out["solo"]["request_p50_ms"] = float(np.percentile(
            np.array(solo) * 1e3, 50))

        # routed traffic on A, a replica SIGKILLed in the middle of it
        rng = np.random.default_rng(7)
        terms = scorer_a.vocab.terms
        texts = [" ".join(terms[int(t)] for t in row) for row in
                 rng.integers(0, len(terms), (2 * SHARD_TEXTS, 2))]
        jobs = [("tfidf", i) for i in range(SHARD_TEXTS)] + [
            ("bm25", SHARD_TEXTS + i) for i in range(SHARD_TEXTS)]
        random_order = np.random.default_rng(9).permutation(len(jobs))
        jobs = [jobs[int(j)] for j in random_order]
        want = {}
        for scoring in ("tfidf", "bm25"):
            idx = [i for sc, i in jobs if sc == scoring]
            for i, res in zip(idx, scorer_a.search_batch(
                    [texts[i] for i in idx], k=k, scoring=scoring,
                    return_docids=False)):
                want[i] = result_bits(res)
        before = {sl: dict(health[sl]["kernel_launches"]) for sl in slots}
        # the TF-IDF texts on the whole 2 x 2 fleet in turns, traced and
        # untraced, SHARD_TRACE_PASSES times each: untraced is this
        # process's tracing off (the workers keep theirs, and mint traces
        # of their own), so the gap is the router's share of the cost.
        # Each traced answer's time attributed from its stitched trace
        tfidf = list(range(SHARD_TEXTS))
        was = disttrace.enabled()
        seen_t, passes = [], []
        for traced in (True, False) * SHARD_TRACE_PASSES:
            seen = seen_t if traced else []
            disttrace.configure(enabled=traced)
            try:
                run = routed_traffic(router, reg, texts, tfidf, want, gen_a,
                                     clients=SHARD_CLIENTS, k=k, seen=seen)
            finally:
                disttrace.configure(enabled=was)
            run["traced"] = traced
            if not traced:
                run["untraced_answers"] = sum(t is None for t, _ in seen)
            passes.append(run)
        att = attribute_traces(seen_t)
        out["attribution"] = {
            "texts": len(tfidf), "clients": SHARD_CLIENTS,
            "control_scope": "router_process", "passes": passes,
            "attribution": att}
        for traced, name in ((True, "traced"), (False, "control")):
            qps = [r["routed_qps"] for r in passes if r["traced"] is traced]
            med = float(np.median(qps))
            out["attribution"][name] = {
                "routed_qps_median": med,
                "routed_qps_spread": (max(qps) - min(qps)) / med,
                "router_request_p50_ms_median": float(np.median(
                    [r["router.request"]["p50_ms"] for r in passes
                     if r["traced"] is traced]))}
        out["attribution"]["qps_traced_over_control"] = (
            out["attribution"]["traced"]["routed_qps_median"]
            / out["attribution"]["control"]["routed_qps_median"])
        if (att["stitched"] != SHARD_TRACE_PASSES * len(tfidf)
                or att["problems"]
                or any(r["untraced_answers"] != len(tfidf)
                       for r in passes if not r["traced"])):
            raise AssertionError(f"the attribution: {out['attribution']}")

        # both scorings' texts, replica 0/1 SIGKILLed in the middle of them
        lock = threading.Lock()
        lat, errors, bad, seen = [], [], [], []
        done = [0]
        killed = {}
        cursor = iter(jobs)
        kill_at = int(SHARD_KILL_AT * len(jobs))

        def kill_replica() -> None:
            # its launches up to the kill, then SIGKILL under traffic
            killed["health"] = get_worker_health(grid[0][1], 60)["worker"]
            killed["pid"] = ss.kill(0, 1)
            killed["at"] = done[0]

        def client() -> None:
            while True:
                with lock:
                    job = next(cursor, None)
                    fire = done[0] >= kill_at and not killed
                    if fire:
                        killed["firing"] = True
                if fire:
                    kill_replica()
                if job is None:
                    return
                scoring, i = job
                t_req = time.perf_counter()
                try:
                    res = router.search(texts[i], k=k, scoring=scoring,
                                        return_docids=False)
                except Exception as e:  # noqa: BLE001 — counted, none
                    with lock:
                        errors.append(repr(e))
                        done[0] += 1
                    continue
                with lock:
                    lat.append(time.perf_counter() - t_req)
                    done[0] += 1
                    seen.append((res.trace_id, res))
                    if (Router.classify(res) != "full"
                            or res.generation != gen_a
                            or result_bits(res) != want[i]):
                        bad.append(i)

        c0, h0 = router.stats(), reg.hist_state()
        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(SHARD_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        ms = np.array(lat) * 1e3
        routed = router_window(router, reg, h0, c0, len(jobs))
        routed.update({
            "texts": len(jobs), "errors": len(errors),
            "mismatches": len(bad), "wall_s": wall,
            "routed_qps": len(jobs) / wall,
            "request_p50_ms": float(np.percentile(ms, 50)),
            "request_p99_ms": float(np.percentile(ms, 99)),
            "killed": {"replica": [0, 1], "pid": killed.get("pid"),
                       "after_answers": killed.get("at")}})
        routed["trace"] = attribute_traces(seen)
        out["routed"] = routed
        if (errors or bad or len(lat) != len(jobs) or "pid" not in killed
                or routed["counters"]["router.served_full"] != len(jobs)):
            raise AssertionError(f"routed traffic: {routed} {errors[:3]}")
        if (routed["trace"]["stitched"] != len(jobs)
                or routed["trace"]["problems"]):
            raise AssertionError(f"the killed pass's traces: "
                                 f"{routed['trace']}")

        # the rerank's two phases through the router
        t0 = time.perf_counter()
        for text in texts[:SHARD_RERANK_TEXTS]:
            got = router.search(text, k=k, rerank=SHARD_RERANK,
                                return_docids=False)
            solo_r = scorer_a.search_batch([text], k=k, rerank=SHARD_RERANK,
                                           return_docids=False)[0]
            if (Router.classify(got) != "full"
                    or result_bits(got) != result_bits(solo_r)):
                raise AssertionError(f"the routed rerank of {text!r} "
                                     "differs from the rerank in one "
                                     "process")
        out["rerank"] = {"texts": SHARD_RERANK_TEXTS,
                         "candidates": SHARD_RERANK, "bitwise": True,
                         "wall_s": time.perf_counter() - t0}
        # the workers' launches over the routed traffic (the killed one's
        # up to its kill)
        traffic = dict.fromkeys(PORT_KERNELS, 0)
        for sl in slots:
            h = (killed["health"] if sl == (0, 1)
                 else get_worker_health(grid[sl[0]][sl[1]], 60)["worker"])
            for n in PORT_KERNELS:
                traffic[n] += h["kernel_launches"][n] - before[sl][n]
        out["traffic_launches"] = traffic
        probe_idx = [SHARD_TEXTS + i for i in range(SHARD_PROBE_TEXTS)]
        probe_rank_a = scorer_a.search_batch(
            [texts[i] for i in probe_idx], k=ORACLE_K, scoring="bm25",
            return_docids=False)

        # the rolling swap to B under probes through the router
        stop = threading.Event()
        events, probe_errors = [], []

        def probe(tid: int) -> None:
            n = tid
            while not stop.is_set():
                i = probe_idx[n % len(probe_idx)]
                try:
                    res = router.search(texts[i], k=k, scoring="bm25",
                                        return_docids=False)
                    with lock:
                        events.append((time.perf_counter(), i,
                                       res.generation, Router.classify(res),
                                       res.shards_ok, result_bits(res)))
                except Exception as e:  # noqa: BLE001 — counted, none
                    with lock:
                        probe_errors.append(repr(e))
                n += SWAP_PROBE_THREADS

        c0, h0 = router.stats(), reg.hist_state()
        probes = [threading.Thread(target=probe, args=(t,), daemon=True)
                  for t in range(SWAP_PROBE_THREADS)]
        t_probe = time.perf_counter()
        for th in probes:
            th.start()
        time.sleep(SWAP_PROBE_S)
        t_w0 = time.perf_counter()
        report = rolling_swap(ss, gen_b)
        router.note_generation(gen_b)
        t_w1 = time.perf_counter()
        time.sleep(SWAP_PROBE_S)
        stop.set()
        for th in probes:
            th.join(timeout=600)
        swap_window = router_window(router, reg, h0, c0,
                                    max(len(events), 1))
        live_slots = [sl for sl in slots if sl != (0, 1)]
        health = {sl: get_worker_health(grid[sl[0]][sl[1]], 60)["worker"]
                  for sl in live_slots}
        if ({(s, r) for s, r, _ in report["swapped"]} != set(live_slots)
                or [tuple(f[:2]) for f in report["failed"]] != [(0, 1)]
                or {h["index_generation"] for h in health.values()}
                != {gen_b} or probe_errors):
            raise AssertionError(f"the rolling swap: {report} {health} "
                                 f"{probe_errors[:3]}")
        ranges_b = shard_doc_ranges(scorer_b.meta.num_docs, SHARD_WORKERS)
        want_b = dict(zip(probe_idx, (result_bits(r) for r in
                                      scorer_b.search_batch(
                                          [texts[i] for i in probe_idx],
                                          k=k, scoring="bm25",
                                          return_docids=False))))
        rank_b = dict(zip(probe_idx, (list(r) for r in scorer_b.search_batch(
            [texts[i] for i in probe_idx], k=ORACLE_K, scoring="bm25",
            return_docids=False))))
        rank_a = dict(zip(probe_idx, (list(r) for r in probe_rank_a)))
        want_a = {i: want[i] for i in probe_idx}
        full_of = {gen_a: want_a, gen_b: want_b}
        rank_of = {gen_a: (rank_a, ranges_a), gen_b: (rank_b, ranges_b)}
        tagged = {gen_a: 0, gen_b: 0}
        partial = unjudged = 0
        for _t, i, gen, cls, shards_ok, bits in events:
            if gen not in full_of:
                raise AssertionError(f"a probe answer tagged {gen}")
            if cls == "full":
                ok = bits == full_of[gen][i]
            else:
                rank, ranges = rank_of[gen]
                expect = partial_oracle(rank[i], ranges, shards_ok, k)
                partial += 1
                unjudged += expect is None
                ok = cls == "partial" and (expect is None
                                           or bits == result_bits(expect))
            if not ok:
                raise AssertionError(f"a {cls} probe answer tagged {gen} "
                                     f"of {texts[i]!r} is not that "
                                     "generation's")
            tagged[gen] += 1
        def gaps(times: list) -> dict:
            # the widest gap between successive answers across the walk
            # (from the last before it to the first after it), beside the
            # widest in the probing before it
            times = sorted(times)
            before_w = [t for t in times if t < t_w0]
            after_w = [t for t in times if t > t_w1]
            span = [before_w[-1]] + [t for t in times
                                     if t_w0 <= t <= t_w1] + [after_w[0]]
            return {"widest_gap_ms": 1e3 * float(np.diff(span).max()),
                    "baseline_gap_ms": 1e3 * float(np.diff(
                        [t_probe] + before_w).max())}

        # the fleet as a caller sees it: any answer (a partial one too),
        # then full answers only; and per shard (what a fleet of one
        # replica a shard measured per worker): the answers that shard
        # contributed to, and its first answer on B
        per_shard = []
        for s in range(SHARD_WORKERS):
            mine = [(t, g) for t, _i, g, _c, ok, _b in events if s in ok]
            per_shard.append({
                "shard": s, "answers": len(mine),
                **gaps([t for t, _g in mine]),
                "staleness_s": min(t for t, g in mine if g == gen_b)
                - t_w0})
        out["rolling_swap"] = {
            "wall_s": t_w1 - t_w0, "rounds": report["rounds"],
            "swapped": len(report["swapped"]),
            "failed": len(report["failed"]),
            "probes": len(events), "answers_a": tagged[gen_a],
            "answers_b": tagged[gen_b], "partial": partial,
            "partial_unjudged": unjudged,
            **gaps([t for t, *_ in events]),
            "full_gap_ms": gaps([t for t, _i, _g, c, *_ in events
                                 if c == "full"])["widest_gap_ms"],
            "staleness_s": min(t for t, _i, g, *_ in events if g == gen_b)
            - t_w0,
            "shards": per_shard, "router": swap_window}
        if not (tagged[gen_a] and tagged[gen_b]):
            raise AssertionError(f"the probes saw {tagged}")

        # the killed replica comes back on B and answers as its sibling
        t0 = time.perf_counter()
        handle = ss.respawn(0, 1)
        out["respawn_s"] = time.perf_counter() - t0
        pids.add(handle.pid)
        grid = ss.addresses()
        back = get_worker_health(grid[0][1], 60)["worker"]
        for i in probe_idx[:8]:
            pay = {"text": texts[i], "k": k, "scoring": "bm25"}
            mine = rpc_post(grid[0][1], "search", pay, 120)
            sibling = rpc_post(grid[0][0], "search", pay, 120)
            if (back["index_generation"] != gen_b or back["generation"] != 1
                    or mine["generation"] != gen_b
                    or result_bits([tuple(h) for h in mine["hits"]])
                    != result_bits([tuple(h) for h in sibling["hits"]])):
                raise AssertionError(f"the respawned worker: {back}")
        out["respawned"] = {"killed_pid": killed["pid"], "pid": handle.pid,
                            "index_generation": back["index_generation"],
                            "spawn_generation": back["generation"]}
        launches = {n: killed["health"]["kernel_launches"][n]
                    for n in PORT_KERNELS}
        by_worker = {"0/1 (killed)": killed["health"]["kernel_launches"]}
        for s, r in slots:
            h = get_worker_health(grid[s][r], 60)["worker"]
            by_worker[f"{s}/{r}"] = h["kernel_launches"]
            for n in PORT_KERNELS:
                launches[n] += h["kernel_launches"][n]
        out["launches"] = launches
        out["launches_by_worker"] = by_worker
        if device == "cuda" and not (traffic["cold_tier"]
                                     and traffic["hot_stage"]):
            raise AssertionError(f"the routed traffic never launched "
                                 f"cold_tier and hot_stage: {traffic}")
        out["elastic"], sigkilled = phase_elastic(
            card, ss, router, live, scorer_b, gen_b, texts, device=device,
            k=k)
        pids |= {h.pid for row in ss.handles() for h in row}
    except BaseException:
        for s, r in [(s, r) for s, row in enumerate(ss.handles())
                     for r in range(len(row))]:
            with contextlib.suppress(OSError):
                with open(ss.log_path(s, r)) as f:
                    print(f"worker {s}/{r} log:\n{f.read()[-3000:]}",
                          file=sys.stderr)
        raise
    finally:
        if router is not None:
            router.close()
        ss.stop()
        shutil.rmtree(ss.rundir, ignore_errors=True)
    alive = [p for p in pids if pid_alive(p)]
    # the SIGKILLed worker exits -9, every other one 0 (SIGTERM)
    codes = {h.pid: h.proc.returncode for row in ss.handles() for h in row}
    out["stopped"] = {"pids": len(pids), "alive": alive,
                      "returncodes": list(codes.values())}
    if alive or codes != {p: -9 if p in sigkilled else 0 for p in codes}:
        raise AssertionError(f"after stop(): {out['stopped']}")
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def phase_live(card: str, work: str, *, device: str, k: int = 10,
               before_checks=None) -> dict:
    """The live index at wiki100k (config `wiki100k-live`), from the corpus
    kept in `work`: generation A seeded through the command line, served
    through a coalesced ServingFrontend from Scorer.load_generation; the
    delta fed with the writer's defaults (flushes of 1,000, auto-merge),
    then compact_all into generation B, whose every artifact must have the
    sha256 of a one-shot build over the surviving docs; the frontend swaps
    to B (reload_generation) under probe threads: no error, shed,
    degraded response or unwarmed dispatch, and each sampled response
    bitwise the solo answer of the one generation it names; B, as the
    swap loaded it, serves the uniform queries bitwise as the one-shot
    index does, TF-IDF and BM25, its own timed run launching cold_tier
    and hot_stage; then verify_live, and doctor, generations, compact --gc
    and verify through the command line. The flush, merge, swap and
    warm-up seconds are the registry's histograms. Deletes the corpus and
    the live dir."""
    import torch

    import tpu_ir_torch
    from tpu_ir_torch import obs
    from tpu_ir_torch.index import build_index
    from tpu_ir_torch.index.ingest import IngestWriter
    from tpu_ir_torch.index.segments import LiveIndex
    from tpu_ir_torch.index.verify import verify_live
    from tpu_ir_torch.search import Scorer
    from tpu_ir_torch.serving import ServingConfig, ServingFrontend

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    reg = obs.get_registry()
    corpus = os.path.join(work, "wiki100k.trec")
    live = os.path.join(work, "live")
    n_seed = LIVE["seed_docs"]
    out = {"phase": "live", "card": card, "config": "wiki100k-live",
           "seed_docs": n_seed}
    out["seed"] = seed_live(live, corpus, n_seed, device=device)
    docs = corpus_docs(corpus)
    os.unlink(corpus)
    seed_docs, held = docs[:n_seed], docs[n_seed:]
    gen_a = out["seed"]["generation"]

    # A through the coalesced frontend; A's launches count from its load
    # to the end of its serve
    tpu_ir_torch.reset_kernel_launches()
    t0 = time.perf_counter()
    scorer_a = Scorer.load_generation(live, device=device)
    sync()
    out["load_a_s"] = time.perf_counter() - t0
    if (scorer_a.generation != gen_a or scorer_a.layout != "sparse"
            or scorer_a.device.type != device):
        raise AssertionError(f"A: generation {scorer_a.generation}, "
                             f"layout {scorer_a.layout!r}, device "
                             f"{scorer_a.device}")
    t0 = time.perf_counter()
    frontend = ServingFrontend(scorer_a, ServingConfig(
        max_concurrency=SWAP_PROBE_THREADS, max_queue=16, coalesce=True))
    out["frontend_warm_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    terms_a = scorer_a.vocab.terms
    texts = [" ".join(terms_a[int(t)] for t in row) for row in rng.integers(
        0, len(terms_a), (LIVE_SERVE_TEXTS, REF_QUERY_TERMS))]
    t0 = time.perf_counter()
    for text in texts:
        if frontend.search(text, k=k, scoring="bm25").generation != gen_a:
            raise AssertionError("A's frontend answered from another "
                                 "generation")
    out["a_frontend_qps"] = len(texts) / (time.perf_counter() - t0)
    out["launches_a"] = tpu_ir_torch.kernel_launches()

    # the delta, with the writer's defaults, then generation B
    ops = live_ops(seed_docs, held, updates=LIVE["updates"],
                   deletes=LIVE["deletes"])
    wal0 = {n: reg.get(f"ingest.{n}")
            for n in ("wal_appends", "wal_bytes", "wal_fsyncs")}
    w = IngestWriter(live, buffer_docs=LIVE["buffer_docs"], device=device)
    hist0 = reg.hist_state()
    t0 = time.perf_counter()
    for op in ops:
        apply_op(w, op)
    w.flush()
    delta_s = time.perf_counter() - t0
    steps = reg.delta_summary(hist0, always=("ingest.flush", "merge.run"))
    t0 = time.perf_counter()
    m_b = w.compact_all()
    out["compact_s"] = time.perf_counter() - t0
    w.close()
    gen_b = m_b["gen"]
    out["delta"] = {
        "ops": len(ops), "adds": len(held), "updates": LIVE["updates"],
        "deletes": LIVE["deletes"], "wall_s": delta_s,
        "ops_per_s": len(ops) / delta_s,
        **{n: reg.get(f"ingest.{n}") - v for n, v in wal0.items()},
        "flushes": steps["ingest.flush"], "merge_steps": steps["merge.run"]}
    out["generation_a"], out["generation_b"] = gen_a, gen_b
    if not steps["merge.run"]["count"]:
        raise AssertionError("the delta ran no tiered merge")
    seg_b = segment_of(live)
    want = survivors(seed_docs, ops)
    if set(LiveIndex.open(live).live_doc_map()) != set(want):
        raise AssertionError("B's live docs are not the survivors")

    # the one-shot build over the survivors
    control_corpus = os.path.join(work, "live-control.trec")
    write_docs(control_corpus, want)
    del docs, seed_docs, held
    control = os.path.join(work, "live-control")
    t0 = time.perf_counter()
    build_index(control_corpus, control, num_shards=10, device=device)
    sync()
    out["control_build_s"] = time.perf_counter() - t0
    os.unlink(control_corpus)
    digests_b, digests_c = artifact_digests(seg_b), artifact_digests(control)
    if digests_b != digests_c:
        raise AssertionError("B differs from the one-shot build in "
                             f"{digest_diff(digests_b, digests_c)}")
    out["identical_artifacts"] = len(digests_b)
    out["num_docs_b"] = len(want)

    # the swap under probe traffic; B's load and its coalescer's warm-up
    # are read from the histograms the swap observes
    hist0 = reg.hist_state()
    unwarmed0 = reg.get("dispatch.unwarmed")
    reloads = []
    swap = swap_probes(frontend, texts, lambda: reloads.append(
        traced_reload(frontend, gen_b, device)), k=k)
    reload_b = reloads[0]
    if not on_card:
        reload_b["allocated_growth"] = part_bytes(seg_b)
    scorer_b = frontend.scorer
    steps = reg.delta_summary(hist0, always=("generation.swap",
                                             "batch.precompile"))
    out["warm_b_s"] = steps["batch.precompile"]["sum_ms"] / 1e3
    out["load_b_s"] = (steps["generation.swap"]["sum_ms"] / 1e3
                       - out["warm_b_s"])
    events = swap["events"]
    gens = sorted({e[1] for e in events})
    out["swap"] = {
        "reload_wall_s": swap["reload_wall_s"],
        "swap_gap_ms": swap["swap_gap_ms"],
        "gap_opened_s": swap["gap_opened_s"],
        "gap_closed_by": swap["gap_closed_by"],
        "baseline_gap_ms": swap["baseline_gap_ms"],
        "wake_gap_ms": swap["wake_gap_ms"],
        "errors": len(swap["errors"]), "sheds": swap["sheds"],
        "probes": len(events), "generations_seen": gens,
        "degraded": sum(1 for e in events if e[4]),
        "unwarmed": reg.get("dispatch.unwarmed") - unwarmed0,
        "gap_within": gap_within(reload_b["timeline"],
                                 swap["gap_opened_s"], swap["swap_gap_ms"])}
    # what B's load moved across the link, and the reload's spans
    out["reload_b"] = reload_b
    if reload_b["bytes"] <= 0 or not reload_b["uploads"]:
        raise AssertionError(f"B's load streamed nothing: {reload_b}")
    if (swap["errors"] or swap["sheds"] or gens != [gen_a, gen_b]
            or out["swap"]["degraded"] or out["swap"]["unwarmed"]
            or steps["batch.precompile"]["count"] != 1):
        raise AssertionError(f"the swap: {out['swap']} "
                             f"{swap['errors'][:3]}")
    if (scorer_b.generation != gen_b or scorer_b.device.type != device
            or frontend.batcher is None):
        raise AssertionError(f"after the swap: generation "
                             f"{scorer_b.generation} on {scorer_b.device}")
    sampled = 0
    for gen, scorer in ((gen_a, scorer_a), (gen_b, scorer_b)):
        for e in [e for e in events if e[1] == gen][:SWAP_SAMPLE]:
            solo = scorer.search_batch([texts[e[2]]], k=k, scoring="bm25")
            if result_bits(solo[0]) != e[3]:
                raise AssertionError(f"a generation-{gen} response differs "
                                     "from that generation's solo answer")
            sampled += 1
    out["swap"]["bitwise_sampled"] = sampled
    # the swap back to A, whose scorer is loaded already: what the swap
    # costs without a load in its window
    back = swap_probes(frontend, texts,
                       lambda: frontend.reload_generation(scorer_a), k=k)
    out["swap_preloaded"] = {
        key: back[key] for key in ("reload_wall_s", "swap_gap_ms",
                                   "baseline_gap_ms", "wake_gap_ms",
                                   "sheds")}
    out["swap_preloaded"]["errors"] = len(back["errors"])
    if (back["errors"] or back["sheds"]
            or sorted({e[1] for e in back["events"]}) != [gen_a, gen_b]):
        raise AssertionError(f"the swap back to A: {back['errors'][:3]}, "
                             f"{back['sheds']} shed")
    out["gap_trials"] = gap_trials(
        frontend, texts, scorer_a, gen_b, seg_b,
        reload_b["allocated_growth"], reload_b["bytes"], k=k,
        device=device, done={"cold_load_coalesced": swap,
                             "preloaded_coalesced": back})
    scorer_b = frontend.scorer
    del events, swap, back

    # B, loaded by the swap, serves the uniform queries as the one-shot
    # index does; its own timed run's launches are the phase's
    q_b = np.random.default_rng(1).integers(
        0, scorer_b.meta.vocab_size,
        size=(REF_QUERIES, REF_QUERY_TERMS)).astype(np.int32)
    got = {}
    launches = dict.fromkeys(tpu_ir_torch.kernel_launches(), 0)
    for scoring in ("tfidf", "bm25"):
        got[scoring], ran, out[f"b_{scoring}_qps"] = live_topk(
            scorer_b, q_b, k=k, scoring=scoring, device=device)
        for n, v in ran.items():
            launches[n] += v
    out["launches"] = launches
    if on_card and not (launches["cold_tier"] and launches["hot_stage"]):
        raise AssertionError(f"B's serve never launched cold_tier and "
                             f"hot_stage: {launches}")
    one_shot = Scorer.load(control, device=device)
    for scoring in ("tfidf", "bm25"):
        if not same_bits(got[scoring], one_shot.topk(q_b, k=k,
                                                     scoring=scoring)):
            raise AssertionError(f"B's {scoring} top-{k} differs from the "
                                 "one-shot index's")
    out["b_bitwise_one_shot"] = True
    del one_shot, frontend
    shutil.rmtree(control)
    if on_card:
        torch.cuda.empty_cache()
    if before_checks is not None:
        # generations A and B are both still in the live dir here, and
        # both loaded: the checks hold their answers against these
        before_checks(live, gen_a, gen_b, {gen_a: scorer_a, gen_b: scorer_b})
    del scorer_a, scorer_b

    # the operator's checks
    t0 = time.perf_counter()
    vl = verify_live(live)
    out["verify_live_s"] = time.perf_counter() - t0
    doctor, out["doctor_s"] = run_cli(["doctor", live])
    gens_json, out["generations_s"] = run_cli(["generations", live])
    comp, out["compact_gc_s"] = run_cli(["compact", live, "--gc",
                                         "--device", device])
    if not (vl["ok"] and vl["num_docs"] == len(want)
            and vl["num_segments"] == 1
            and doctor["segment_count"] == 1
            and gens_json["generations"][-1]["servable"]
            and gens_json["current"] == gen_b
            and comp["steps"] == 0 and comp["segments"] == [
                os.path.basename(seg_b)]):
        raise AssertionError(f"the operator checks: {vl} {doctor} {comp}")
    out["doctor_warnings"] = doctor["warnings"]
    out["generations_listed"] = len(gens_json["generations"])
    out["gc_dropped_segments"] = len(comp["gc"]["dropped_segments"])
    out["gc_dropped_generations"] = len(comp["gc"]["dropped_generations"])
    shutil.rmtree(live)
    return out


def phase_live_crash(card: str, work: str, *, device: str,
                     k: int = 10) -> dict:
    """The live index's durability at ref scale (config `ref-live`), from
    the ref corpus kept in `work`: generation A seeded through the command
    line, backed up (segments hardlinked, the WAL copied) and restored
    into a new dir (restore_live runs verify_live); the delta fed into the
    original with no crash and compacted: the control; the same delta fed
    into the restore by a spawned child under LIVE_CRASH_PLAN, which
    SIGKILLs itself (rc -9); an IngestWriter opened on the restore takes
    the lease over and replays the WAL, the unacknowledged ops are fed
    again and compact_all runs: no acknowledged op lost, the control's
    live docs, and every artifact the control's sha256 and the one-shot
    build's over the survivors; that generation, loaded by
    Scorer.load_generation on the card (dense), serves the uniform
    queries bitwise as the one-shot index does, TF-IDF and BM25, its
    own timed run launching dense_score. Deletes the corpus and the
    dirs."""
    import torch

    import tpu_ir_torch
    from tpu_ir_torch import obs
    from tpu_ir_torch.index import build_index
    from tpu_ir_torch.index.backup import backup_live, restore_live
    from tpu_ir_torch.index.ingest import IngestWriter
    from tpu_ir_torch.index.segments import LiveIndex
    from tpu_ir_torch.search import Scorer
    from tpu_ir_torch.serving.soak import _spawn_feeder

    on_card = device == "cuda"
    reg = obs.get_registry()
    corpus = os.path.join(work, "ref.trec")
    live = os.path.join(work, "crash-live")
    n_seed = LIVE_CRASH["seed_docs"]
    out = {"phase": "live_crash", "card": card, "config": "ref-live",
           "seed_docs": n_seed}
    out["seed"] = seed_live(live, corpus, n_seed, device=device)
    docs = corpus_docs(corpus)
    os.unlink(corpus)
    seed_docs, held = docs[:n_seed], docs[n_seed:]
    ops = live_ops(seed_docs, held, updates=LIVE_CRASH["updates"],
                   deletes=LIVE_CRASH["deletes"])
    want = survivors(seed_docs, ops)
    buffer_docs = LIVE_CRASH["buffer_docs"]

    # A backed up and restored
    backup = os.path.join(work, "crash-backup")
    restored = os.path.join(work, "crash-restored")
    t0 = time.perf_counter()
    summary = backup_live(live, backup)
    out["backup_s"] = time.perf_counter() - t0
    linked = sum(os.path.getsize(os.path.join(r, f))
                 for r, _d, fs in os.walk(backup) for f in fs
                 if os.stat(os.path.join(r, f)).st_nlink > 1)
    out["backup"] = {"files": summary["files"], "bytes": summary["bytes"],
                     "bytes_linked": linked,
                     "wal_segments": summary["wal_segments"]}
    t0 = time.perf_counter()
    rep = restore_live(backup, restored)
    out["restore_s"] = time.perf_counter() - t0
    out["restore_verified"] = bool(rep["ok"])
    if not (rep["ok"] and rep["num_docs"] == n_seed and linked):
        raise AssertionError(f"the restore: {rep}, {linked} bytes linked")
    shutil.rmtree(backup)

    # the control: the delta with no crash
    t0 = time.perf_counter()
    with IngestWriter(live, buffer_docs=buffer_docs, device=device) as w:
        for op in ops:
            apply_op(w, op)
        w.compact_all()
    out["control_s"] = time.perf_counter() - t0
    digests_c = artifact_digests(segment_of(live))
    docs_c = set(LiveIndex.open(live).live_doc_map())
    if docs_c != set(want):
        raise AssertionError("the control's live docs are not the "
                             "survivors")

    # the feeder, killed mid-stream
    ops_path = os.path.join(work, "crash-ops.json")
    with open(ops_path, "w", encoding="utf-8") as f:
        json.dump(ops, f)
    ack = os.path.join(work, "crash.ack")
    open(ack, "w").close()
    t0 = time.perf_counter()
    child, child_out, child_err = _spawn_feeder(
        restored, ack, ops_path=ops_path, device=device,
        buffer_docs=buffer_docs, fault_plan=LIVE_CRASH_PLAN)
    try:
        rc = child.wait(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    out["child_s"] = time.perf_counter() - t0
    out["child_rc"] = rc
    if rc != -9:
        with open(child_err) as f:
            raise AssertionError(f"the feeder exited {rc}, not by SIGKILL: "
                                 f"{f.read()[-2000:]}")
    with open(ack) as f:
        acked = [ln.strip() for ln in f if ln.strip()]
    if (acked != [op[1] for op in ops[:len(acked)]]
            or not 0 < len(acked) < len(ops)):
        raise AssertionError(f"the ack file holds {len(acked)} ops, not a "
                             "proper prefix of the delta")
    out["acked_ops"] = len(acked)

    # the recovery: lease takeover, replay, the rest fed again, compaction
    takeovers0 = reg.get("ingest.lease_takeovers")
    t0 = time.perf_counter()
    w = IngestWriter(restored, buffer_docs=buffer_docs, device=device)
    out["open_replay_s"] = time.perf_counter() - t0
    out["replayed"] = w.replayed
    out["lease"] = w.lease_info
    for op in ops[len(acked):]:
        apply_op(w, op, refeed=True)
    w.compact_all()
    w.close()
    out["recovery_s"] = time.perf_counter() - t0
    if not (w.replayed and out["lease"]["taken_over"]
            and reg.get("ingest.lease_takeovers") > takeovers0):
        raise AssertionError(f"the recovery: replayed {w.replayed}, lease "
                             f"{out['lease']}")
    docs_r = set(LiveIndex.open(restored).live_doc_map())
    lost = [op[1] for op in ops[:len(acked)]
            if (op[0] == "delete") == (op[1] in docs_r)]
    out["lost_acked"] = len(lost)
    if lost:
        raise AssertionError(f"acknowledged ops lost: {lost[:5]}")
    if docs_r != docs_c:
        raise AssertionError("the recovered live docs are not the "
                             "control's")
    seg_r = segment_of(restored)
    digests_r = artifact_digests(seg_r)
    if digests_r != digests_c:
        raise AssertionError("the recovered segment differs from the "
                             f"control in {digest_diff(digests_r, digests_c)}")
    out["identical_artifacts"] = len(digests_r)

    # the one-shot build over the survivors, and the recovered generation
    # served dense beside it
    control_corpus = os.path.join(work, "crash-control.trec")
    write_docs(control_corpus, want)
    one_shot_dir = os.path.join(work, "crash-one-shot")
    build_index(control_corpus, one_shot_dir, num_shards=10, device=device)
    os.unlink(control_corpus)
    digests_o = artifact_digests(one_shot_dir)
    if digests_o != digests_r:
        raise AssertionError("the recovered segment differs from the "
                             f"one-shot build in "
                             f"{digest_diff(digests_r, digests_o)}")
    gen = Scorer.load_generation(restored, device=device)
    one_shot = Scorer.load(one_shot_dir, device=device)
    if gen.layout != "dense" or gen.generation != LiveIndex.open(
            restored).current_gen():
        raise AssertionError(f"the recovered generation: layout "
                             f"{gen.layout!r}, generation {gen.generation}")
    q = np.random.default_rng(1).integers(
        0, gen.meta.vocab_size,
        size=(REF_QUERIES, REF_QUERY_TERMS)).astype(np.int32)
    launches = dict.fromkeys(tpu_ir_torch.kernel_launches(), 0)
    for scoring in ("tfidf", "bm25"):
        got, ran, out[f"{scoring}_qps"] = live_topk(
            gen, q, k=k, scoring=scoring, device=device)
        for n, v in ran.items():
            launches[n] += v
        if not same_bits(got, one_shot.topk(q, k=k, scoring=scoring)):
            raise AssertionError(f"the recovered generation's {scoring} "
                                 f"top-{k} differs from the one-shot "
                                 "index's")
    out["launches"] = launches
    if on_card and not launches["dense_score"]:
        raise AssertionError(f"the recovered generation's serve never "
                             f"launched dense_score: {launches}")
    out["bitwise_one_shot"] = True
    del one_shot
    out["workers"] = http_workers(gen, restored, device=device, k=k)
    del gen
    if on_card:
        torch.cuda.empty_cache()
    soak = phase_routed_soak(card, restored, work, device=device)
    emit(soak)
    out["routed_soak_launches_lower_bound"] = soak["launches_lower_bound"]
    elastic = phase_elastic_soak(card, restored, work, device=device)
    emit(elastic)
    out["elastic_soak_launches_lower_bound"] = elastic[
        "launches_lower_bound"]
    forecast = phase_forecast_soak(card, restored, work, device=device)
    emit(forecast)
    if not all(forecast["checks"].values()):
        raise AssertionError(f"the forecast soak: {forecast['checks']}")
    out["forecast_soak_launches_lower_bound"] = forecast[
        "launches_lower_bound"]
    for path in (restored, live, one_shot_dir):
        shutil.rmtree(path)
    for path in (ops_path, ack, child_out, child_err):
        os.unlink(path)
    if on_card:
        torch.cuda.empty_cache()
    return out


CRASH_WORKERS = 3               # in-process dense workers of live_crash
CRASH_WORKER_TEXTS = 64         # texts a scoring through them (128 before
                                # the routed soak)
ROUTED_SOAK_SHARDS = 2          # the routed soak's fleet: doc shards
ROUTED_SOAK_REPLICAS = 2        # and replicas a shard
ROUTED_SOAK_UPGRADE_AT = 0.6    # share of its requests answered at the roll
ROUTED_SOAK_POLL_S = 1.0        # how often its /healthz is read
ROUTED_SOAK_THREADS = 8         # its client threads (tpu_ir's default)
ROUTED_SOAK_QUERIES = 160       # its requests (tpu_ir's default)
ELASTIC_SOAK_SHARDS = 2         # the elastic soak's fleet: doc shards
ELASTIC_SOAK_REPLICAS = 2       # and replicas a shard (tpu_ir's zero-stale
#                                 test runs 1, its membership test 2: at 1
#                                 the drain at 60% needs the grown replica,
#                                 and a grow's start outlasts the traffic
#                                 from 30% to 60%, so it would drain none)
ELASTIC_SOAK_UPGRADE_AT = 0.25  # share of its requests answered at the roll
ELASTIC_SOAK_PLAN = {"up_at": 0.3, "down_at": 0.6, "kill_during_drain": True}
FORECAST_SOAK_SHARDS = 2        # the forecast soak's fleet: doc shards
FORECAST_SOAK_REPLICAS = 2      # and replicas a shard (the autoscaler may
#                                 grow a third)
FORECAST_SOAK_LEAD_S = 1.0      # the forecast horizon (serve-bench --lead's
#                                 default): refits every 1/8 s
FORECAST_SOAK_THREADS = 16      # its clients (32 in the first card run
#                                 kept 16 or more requests in flight: the
#                                 fleet answered 66 q/s, p50 347 ms, the
#                                 occupancy flat at its ceiling, no fit)
FORECAST_SOAK_ROUTER_SLOTS = 4  # its Router's requests at once (the
#                                 occupancy's denominator: a crest queues
#                                 there, and the occupancy rides the wave)
FORECAST_SOAK_QUERIES = 600     # its requests: BURST_CYCLES = 2 waves of
#                                 300, ~10 s at ~60 q/s, the first crest at
#                                 25%, so the fit (8 points after 5% of the
#                                 requests, one each 1/8 s) locks on its
#                                 rising edge (2,400 at Zipf 0.9 in the
#                                 first card run: 1,566 distinct requests
#                                 whose oracle took ~230 s)
FORECAST_SOAK_PACING_S = 0.03   # the soak's pacing unit: the clients ask
#                                 2 / 0.03 ~ 67 q/s on average (whatever
#                                 their number), ~27 at a trough and ~107
#                                 at a crest, past the 2 x 2 fleet's ~66
#                                 (0.01, serve-bench's, in the first card
#                                 run: saturated throughout, no wave)
FORECAST_SOAK_SKEW = 1.1        # Zipf: ~280 distinct requests in 600 (web
#                                 logs measure 0.7-1.2), so the soak's
#                                 oracle stays short
FORECAST_SOAK_BURST = 3.0       # the wave's amplitude: the crest's arrivals
#                                 ~4x the trough's
FORECAST_SOAK_SEED = 19
FORECAST_SOAK_SAMPLE_S = 0.5    # TPU_IR_TS_SAMPLE_S of the fleet: tier-0
#                                 points inside the soak


def http_workers(scorer, live: str, *, device: str, k: int) -> dict:
    """CRASH_WORKERS in-process workers (serve_worker, dense, warmed) on
    the live dir's newest generation behind a Router on their static
    address grid: CRASH_WORKER_TEXTS TF-IDF and as many BM25 texts, each
    answer full and bitwise `scorer`'s top-k. `scorer`'s answers are
    computed before the workers start, so the kernels' launches, counted
    from 0 after the workers' warm-up to the last answer, are the routed
    requests' alone (dense_score must launch on the card)."""
    import tpu_ir_torch
    from tpu_ir_torch.serving import Router, RouterConfig, serve_worker

    rng = np.random.default_rng(8)
    terms = scorer.vocab.terms
    wants = []
    for scoring in ("tfidf", "bm25"):
        texts = [" ".join(terms[int(t)] for t in row) for row in
                 rng.integers(0, len(terms), (CRASH_WORKER_TEXTS, 2))]
        wants.append((scoring, texts, scorer.search_batch(
            texts, k=k, scoring=scoring, return_docids=False)))
    t0 = time.perf_counter()
    started = [serve_worker(live, s, CRASH_WORKERS, layout="dense",
                            device=device)
               for s in range(CRASH_WORKERS)]
    out = {"workers": CRASH_WORKERS, "start_s": time.perf_counter() - t0}
    try:
        grid = [[f"127.0.0.1:{srv.port}"] for srv, _, _ in started]
        if any(sc.generation != scorer.generation or sc.layout != "dense"
               for _, _, sc in started):
            raise AssertionError("a worker serves another generation or "
                                 "layout")
        lat = []
        with Router(live, grid, RouterConfig(
                deadline_ms=SHARD_DEADLINE_MS)) as router:
            tpu_ir_torch.reset_kernel_launches()
            t0 = time.perf_counter()
            for scoring, texts, want in wants:
                for text, res in zip(texts, want):
                    t_req = time.perf_counter()
                    got = router.search(text, k=k, scoring=scoring,
                                        return_docids=False)
                    lat.append(time.perf_counter() - t_req)
                    if (Router.classify(got) != "full"
                            or result_bits(got) != result_bits(res)):
                        raise AssertionError(
                            f"the dense workers' {scoring} answer of "
                            f"{text!r} differs from the scorer's")
            out["wall_s"] = time.perf_counter() - t0
            out["launches"] = tpu_ir_torch.kernel_launches()
        out["texts"] = 2 * CRASH_WORKER_TEXTS
        out["request_p50_ms"] = float(np.percentile(np.array(lat) * 1e3,
                                                    50))
        out["bitwise"] = True
    finally:
        for srv, _, _ in started:
            srv.stop()
    if device == "cuda" and not out["launches"]["dense_score"]:
        raise AssertionError(f"the dense workers never launched "
                             f"dense_score: {out['launches']}")
    return out


def polled_soak(live: str, work: str, *, timeseries: bool = False,
                **soak_kw) -> tuple[dict, dict]:
    """run_distributed_soak(live, **soak_kw) while this process's /healthz
    (a MetricsServer here, which spools nothing: the spool, when one is
    set, holds the workers' snapshots alone) is read every
    ROUTED_SOAK_POLL_S: the router's
    fleet block names each worker's pid, its kernel launches and those of
    its warm-ups (its start's and each reload's). Returns (the report,
    the polls: the workers seen, their launches less the warm-ups' summed
    (`launches_lower_bound`: the routed requests' launches, less any
    request served while a reload warmed, which counts as the warm-up's),
    and with them, the phase's seconds; every live worker's `/querylog`,
    read over HTTP at each poll, the trace ids of its entries pooled over
    the polls (`worker_querylog`);
    with `timeseries`, the newest `/timeseries` of that worker with
    tier-0 points of submitted_per_s (`worker_timeseries`); this
    process's `/jobs` read after the soak (`jobs`))."""
    import threading
    import urllib.request

    from tpu_ir_torch.obs.server import MetricsServer
    from tpu_ir_torch.serving import run_distributed_soak
    from tpu_ir_torch.serving.shardset import get_worker_health

    seen: dict = {}            # worker pid -> its newest launches, and
    routed: dict = {}          # those less its warm-ups
    polls = {"n": 0, "with_router": 0, "errors": 0}
    worker_log: dict = {}
    worker_ts: dict = {}
    stop = threading.Event()

    def get_json(url: str) -> dict:
        with urllib.request.urlopen(url, timeout=30) as r:
            return json.loads(r.read())

    def poll(addr: str) -> None:
        while not stop.wait(ROUTED_SOAK_POLL_S):
            try:
                fleet = get_worker_health(addr, 30).get("shards")
            except Exception:  # noqa: BLE001 — counted
                polls["errors"] += 1
                continue
            polls["n"] += 1
            if not fleet or "shards" not in fleet:
                continue
            polls["with_router"] += 1
            for shard in fleet["shards"]:
                for rep in shard["replicas"]:
                    w = rep.get("worker") or {}
                    if rep.get("up") and w.get("pid"):
                        seen[w["pid"]] = w["kernel_launches"]
                        routed[w["pid"]] = {
                            n: v - w["warm_launches"][n]
                            for n, v in w["kernel_launches"].items()}
            up = [rep["addr"] for shard in fleet["shards"]
                  for rep in shard["replicas"] if rep.get("up")]
            # (`worker`, not `addr`: the next poll reads this process)
            for worker in up:
                try:
                    log = get_json(f"http://{worker}/querylog")
                except Exception:  # noqa: BLE001 — counted
                    polls["errors"] += 1
                    continue
                if log.get("entries"):
                    # every live worker's log each poll, the trace ids
                    # pooled: a replica respawned after the last read holds
                    # its warm-up's entries only
                    worker_log["addrs"] = sorted(
                        set(worker_log.get("addrs", ())) | {worker})
                    worker_log["entries"] = max(worker_log.get("entries", 0),
                                                len(log["entries"]))
                    worker_log["trace_ids"] = sorted(
                        set(worker_log.get("trace_ids", ()))
                        | {en["trace_id"] for en in log["entries"]
                           if en.get("trace_id")})
            if up:
                if timeseries:
                    try:
                        body = get_json(f"http://{up[0]}/timeseries")
                    except Exception:  # noqa: BLE001 — counted
                        polls["errors"] += 1
                        continue
                    if body.get("enabled") and body["series"][
                            "submitted_per_s"]["tiers"][0]:
                        worker_ts.update(addr=up[0], body=body)

    server = MetricsServer(spool=False).start()
    poller = threading.Thread(target=poll, args=(f"127.0.0.1:{server.port}",),
                              daemon=True)
    poller.start()
    rundir = tempfile.mkdtemp(dir=work)
    t0 = time.perf_counter()
    try:
        report = run_distributed_soak(live, rundir=rundir, **soak_kw)
        stop.set()
        poller.join(timeout=60)
        jobs = [{n: j[n] for n in ("job_id", "kind", "name", "state",
                                    "percent")}
                for j in get_json(f"{server.url}/jobs")["jobs"]]
    finally:
        stop.set()
        poller.join(timeout=60)
        server.stop()
        shutil.rmtree(rundir, ignore_errors=True)
    launches = dict.fromkeys(PORT_KERNELS, 0)
    with_warm_ups = dict.fromkeys(PORT_KERNELS, 0)
    for pid, per in routed.items():
        for n in PORT_KERNELS:
            launches[n] += per.get(n, 0)
            with_warm_ups[n] += seen[pid].get(n, 0)
    out = {"phase_s": time.perf_counter() - t0,
           "healthz_polls": polls, "workers_seen": len(seen),
           "worker_pids": sorted(seen),
           "launches_lower_bound": launches,
           "launches_with_warm_ups": with_warm_ups,
           "worker_querylog": worker_log, "jobs": jobs}
    if timeseries:
        out["worker_timeseries"] = worker_ts
    return report, out


def phase_routed_soak(card: str, live: str, work: str, *,
                      device: str) -> dict:
    """run_distributed_soak on the recovered ref-live dir (`ref-live`,
    dense): ROUTED_SOAK_SHARDS x ROUTED_SOAK_REPLICAS subprocess workers
    on the card behind a Router, tpu_ir's defaults (ROUTED_SOAK_THREADS
    threads, ROUTED_SOAK_QUERIES requests of the uniform workload, its
    chaos schedule: replica (0, 1) SIGKILLed at 30%
    of the answers, the last shard's every replica at 55%, the respawn at
    75%), the fleet rolled onto a generation B (A and 8 seeded docs) at
    ROUTED_SOAK_UPGRADE_AT. Held as tpu_ir's test holds it: conservation, no
    error or deadlock, partial answers and none mismatched, no full
    mismatch, at least 3 respawns, every recovery probe full (and on B),
    no answer from A late after the roll; the report's `disttrace` and
    `slo` sections as tpu_ir's test holds them: answers traced, no trace
    violation and none of the tail's missing, at least 3 spans a trace,
    the bookkeeping at most 5% of a mean request with tracing on and 1%
    with it off, every served request in the SLO windows. The workers'
    routed launches (polled_soak) of dense_score must be above 0. The
    query log: this process's ring (emptied first) holds a router entry
    for each served request, up to its capacity, each with a distinct
    trace id; a worker's `/querylog`, read over HTTP during the soak,
    holds entries of some of those traces; `/jobs` shows the soak's job
    succeeded at 100%."""
    from tpu_ir_torch.obs import querylog, timeseries

    querylog.clear()
    store = timeseries.get_store()
    store.sample()                          # the lead-up's baseline
    since = time.time()
    report, polled = polled_soak(
        live, work, shards=ROUTED_SOAK_SHARDS, replicas=ROUTED_SOAK_REPLICAS,
        threads=ROUTED_SOAK_THREADS, queries=ROUTED_SOAK_QUERIES,
        layout="dense", upgrade_at=ROUTED_SOAK_UPGRADE_AT, device=device)
    store.sample()
    lead_up = soak_lead_up_record(report, since)
    up = report["upgrade"]
    out = {"phase": "routed_soak", "card": card, "config": "ref-live",
           "shards": ROUTED_SOAK_SHARDS, "replicas": ROUTED_SOAK_REPLICAS,
           "upgrade_at": ROUTED_SOAK_UPGRADE_AT, "report": report,
           **polled}
    checks = {
        "conservation": report["served"] + report["shed"]
        == report["submitted"],
        "no_error": report["errors"] == 0,
        "no_deadlock": report["deadlocked"] == 0,
        "taxonomy": sum(report["classes"].values()) == report["served"],
        "partial": report["classes"]["partial"] > 0
        and report["partial_checked"] > 0,
        "no_partial_mismatch": report["partial_mismatches"] == 0,
        "full": report["classes"]["full"] > 0,
        "no_full_mismatch": report["full_mismatches"] == 0,
        "respawns": report["router"]["router.worker_respawn"] >= 3,
        "recovery": report["recovery_full"] == report["recovery_probes"],
        "rolled": bool(up["swap"] and up["swap"]["swapped"]),
        "no_late_a": up["late_old_generation"] == 0
        and report["unknown_generation"] == 0,
        "traced": report["disttrace"]["traced"] > 0,
        "no_trace_violation": report["disttrace"]["violations"] == 0,
        "no_tail_missing": report["disttrace"]["tail_missing"] == 0,
        "spans": report["disttrace"]["mean_spans"] >= 3,
        "trace_overhead": report["disttrace"]["overhead"][
            "enabled_overhead_fraction"] <= 0.05
        and report["disttrace"]["overhead"][
            "disabled_overhead_fraction"] <= 0.01,
        "slo_counted": report["slo"]["good"] + report["slo"]["bad"]
        >= report["served"],
        "dense_score": device != "cuda"
        or polled["launches_lower_bound"]["dense_score"] > 0,
    }
    ring = querylog.recent()
    routed = [en for en in ring if en.get("router")]
    tids = [en.get("trace_id") for en in routed]
    cap = querylog.summary()["ring"]["capacity"]
    worker_tids = set(polled["worker_querylog"].get("trace_ids", ()))
    soak_jobs = [j for j in polled["jobs"]
                 if j["name"].startswith("routed-soak-")]
    out["querylog"] = {"ring": len(ring), "capacity": cap,
                       "router_entries": len(routed),
                       "traced": sum(1 for t in tids if t),
                       "worker_entries": polled["worker_querylog"].get(
                           "entries", 0),
                       "worker_traces_in_router_ring": len(
                           worker_tids & set(tids))}
    checks.update({
        "querylog_router_entries": len(routed)
        >= min(cap, report["served"]),
        "querylog_trace_ids": all(tids) and len(set(tids)) == len(tids),
        "querylog_worker_traces": len(worker_tids & set(tids)) > 0,
        "soak_job": bool(soak_jobs) and soak_jobs[0]["state"]
        == "succeeded" and soak_jobs[0]["percent"] == 100.0,
        "lead_up_record": lead_up["routed_per_s_max"] > 0,
    })
    out["lead_up_record"] = lead_up
    out["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"the routed soak: {checks} {report}")
    return out


def soak_lead_up_record(report: dict, since: float) -> dict:
    """The forced flight record the routed soak writes on a breach,
    written here once more after a clean soak (flight_dump with
    force=True, reason `routed_soak_lead_up`, the soak's counts as its
    extra): its header must carry the time series' lead-up, tier-0
    points of at least one curated series, this process's routed rate
    above 0 in a window that ended after `since` (the soak's start).
    Returns its path, the series it holds and that rate's highest."""
    from tpu_ir_torch.obs import flight_dump

    path = flight_dump("routed_soak_lead_up", extra={
        k: report[k] for k in ("submitted", "served", "shed", "errors",
                               "deadlocked", "full_mismatches",
                               "partial_mismatches")}, force=True)
    header = read_flight_artifact(path, "routed_soak_lead_up")
    window = header.get("timeseries") or {"series": {}}
    routed = [v for t, v in window["series"].get("routed_per_s", ())
              if t >= since]
    return {"path": os.path.basename(path),
            "window_s": window.get("window_s"),
            "series": sorted(window["series"]),
            "points": {k: len(v) for k, v in window["series"].items()},
            "routed_per_s_max": max(routed, default=0.0)}


def phase_elastic_soak(card: str, live: str, work: str, *,
                       device: str) -> dict:
    """run_distributed_soak on the recovered ref-live dir again (dense),
    ELASTIC_SOAK_SHARDS x ELASTIC_SOAK_REPLICAS workers, no chaos, the
    fleet rolled onto another generation at ELASTIC_SOAK_UPGRADE_AT and
    ELASTIC_SOAK_PLAN: a grow at 30% (while the roll's pin holds the new
    generation), a drain of each shard's highest active replica at 60%,
    SIGKILLed during its drain. tpu_ir's zero-stale-swap-during-scale and
    conservation-across-membership-changes asserts: conservation, no
    error, deadlock or mismatch, the roll done with none failed, no
    answer from the old generation late after it and none unknown, the
    new one served, the grow and both drains in the membership log,
    every drain clean or killed, every recovery probe full on the new
    generation; the workers' routed dense_score launches above 0."""
    report, polled = polled_soak(
        live, work, shards=ELASTIC_SOAK_SHARDS,
        replicas=ELASTIC_SOAK_REPLICAS, threads=ROUTED_SOAK_THREADS,
        queries=ROUTED_SOAK_QUERIES, layout="dense", chaos=False,
        upgrade_at=ELASTIC_SOAK_UPGRADE_AT,
        scale_plan=dict(ELASTIC_SOAK_PLAN), device=device)
    up, sc = report["upgrade"], report["scale"]
    out = {"phase": "elastic_soak", "card": card, "config": "ref-live",
           "shards": ELASTIC_SOAK_SHARDS, "replicas": ELASTIC_SOAK_REPLICAS,
           "upgrade_at": ELASTIC_SOAK_UPGRADE_AT,
           "scale_plan": ELASTIC_SOAK_PLAN, "report": report, **polled}
    checks = {
        "conservation": report["served"] + report["shed"]
        == report["submitted"],
        "no_error": report["errors"] == 0,
        "no_deadlock": report["deadlocked"] == 0,
        "no_full_mismatch": report["full_mismatches"] == 0,
        "no_partial_mismatch": report["partial_mismatches"] == 0,
        "rolled": bool(up["swap"] and up["swap"]["swapped"]
                       and not up["swap"]["failed"]),
        "no_late_old": up["late_old_generation"] == 0
        and report["unknown_generation"] == 0,
        "new_served": report["generations_served"].get(
            str(up["generation_b"]), 0) > 0,
        "events": sc["events"] >= 2 * ELASTIC_SOAK_SHARDS,
        "drains": len(sc["drains"]) == ELASTIC_SOAK_SHARDS
        and sc["killed_mid_drain"] + sc["drained_clean"]
        == ELASTIC_SOAK_SHARDS,
        "epoch": sc["epoch"] > 0 and sc["mean_replicas"] > 0
        and 0.0 <= sc["overprovision_fraction"] <= 1.0,
        "recovery": report["recovery_full"] == report["recovery_probes"],
        "dense_score": device != "cuda"
        or polled["launches_lower_bound"]["dense_score"] > 0,
    }
    out["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"the elastic soak: {checks} {report}")
    return out


def forecast_config():
    """serve-bench --autoscale's AutoscaleConfig at ROUTED 2 x 2 with the
    forecast armed as its forecast arm arms it (forecast_up =
    up_occupancy, forecast_lead_s = FORECAST_SOAK_LEAD_S, --lead's
    default)."""
    from tpu_ir_torch.serving.autoscale import AutoscaleConfig

    return AutoscaleConfig(
        min_replicas=FORECAST_SOAK_REPLICAS,
        max_replicas=FORECAST_SOAK_REPLICAS + 1, cooldown_s=0.5,
        up_occupancy=0.45, down_occupancy=0.1, sustain_up=5,
        sustain_down=50, drain_timeout_s=15.0, forecast_up=0.45,
        forecast_lead_s=FORECAST_SOAK_LEAD_S)


def worker_spool(spool: str) -> dict:
    """Each worker process's own last snapshot in the spool, read file by
    file (the newest seq of each pid): pid -> (its submitted, its
    answered: the served_* counters of its frontend)."""
    best: dict = {}
    for name in sorted(os.listdir(spool)):
        if not (name.startswith("telemetry-") and name.endswith(".json")):
            continue
        with open(os.path.join(spool, name)) as f:
            snap = json.load(f)
        if snap["pid"] not in best or snap["seq"] > best[snap["pid"]]["seq"]:
            best[snap["pid"]] = snap
    return {pid: (snap["counters"].get("serving.submitted", 0),
                  sum(v for k, v in snap["counters"].items()
                      if k.startswith("serving.served_")))
            for pid, snap in best.items()}


@contextlib.contextmanager
def soak_witness():
    """What this process's Router and Autoscaler did in the block, seen
    from their side (Router._call_replica and Autoscaler.tick wrapped,
    restored after): each replica attempt by its RPC path and verdict
    (`sent_ok`, `sent_failed`; an attempt the breaker stopped is
    `unsent`), and each autoscaler tick's forecast and decision. Yields
    {"attempts": {path: {verdict: n}}, "ticks": [decision, ...]}."""
    import threading

    from tpu_ir_torch.serving import Autoscaler, Router

    real_call, real_tick = Router._call_replica, Autoscaler.tick
    seen: dict = {"attempts": {}, "ticks": []}
    lock = threading.Lock()

    def call(self, shard, replica, addr, path, payload, timeout_s,
             ctx=None):
        ok, data = real_call(self, shard, replica, addr, path, payload,
                             timeout_s, ctx)
        verdict = ("sent_ok" if ok else "unsent" if data == "breaker_open"
                   else "sent_failed")
        with lock:
            by = seen["attempts"].setdefault(path, {})
            by[verdict] = by.get(verdict, 0) + 1
        return ok, data

    def tick(self, now=None):
        decision = real_tick(self, now)
        with lock:
            seen["ticks"].append(dict(decision))
        return decision

    Router._call_replica, Autoscaler.tick = call, tick
    try:
        yield seen
    finally:
        Router._call_replica, Autoscaler.tick = real_call, real_tick


def forecast_record(ticks: list, forecast_up: float,
                    up_occupancy: float) -> dict:
    """The third signal's part in the soak's decisions, recorded, not
    held: the ticks, those whose forecast reached forecast_up (and of
    them, those whose occupancy stayed under up_occupancy: the forecast
    alone armed the tick), the highest forecast a tick read, and every
    membership change with its tick, action and reason."""
    live = [d for d in ticks if d["forecast"] >= forecast_up]
    return {"ticks": len(ticks), "forecast_live_ticks": len(live),
            "forecast_only_ticks": sum(
                1 for d in live if d["occupancy"] < up_occupancy),
            "forecast_max": max((d["forecast"] for d in ticks),
                                default=None),
            "scale_events": [{k: d[k] for k in ("tick", "action", "reason",
                                                "occupancy", "forecast")}
                             for d in ticks if d["action"] is not None]}


def phase_forecast_soak(card: str, live: str, work: str, *,
                        device: str) -> dict:
    """The forecast-armed autoscaler on the card: run_distributed_soak on
    the recovered ref-live dir (dense), FORECAST_SOAK_SHARDS x
    FORECAST_SOAK_REPLICAS subprocess workers behind a Router of
    FORECAST_SOAK_ROUTER_SLOTS requests at once, no chaos, the diurnal
    burst workload (Zipf FORECAST_SOAK_SKEW, burst FORECAST_SOAK_BURST,
    BURST_CYCLES waves, FORECAST_SOAK_THREADS clients at
    FORECAST_SOAK_PACING_S), under forecast_config(): the soak's
    controller samples this process's timeseries store and refits the
    Forecaster every FORECAST_SOAK_LEAD_S / 8, publishing
    forecast_occupancy. TPU_IR_TELEMETRY_DIR names a fresh dir and
    TPU_IR_TS_SAMPLE_S is FORECAST_SOAK_SAMPLE_S, both inherited by the
    workers. Checks: conservation, no error, deadlock or full or partial
    mismatch; forecast.fits >= 1 and forecast_occupancy points in this
    process's store over the soak; the workers' routed dense_score
    launches above 0; one worker's /timeseries, read mid-soak, with
    tier-0 points of submitted_per_s and every ring within its
    ring_limits(); after the fleet stopped, `stats --cluster
    --telemetry-dir` (run_cli, the spool's merge) counts the workers'
    answered requests at least the search attempts the Router saw
    answered and their submitted ones at most those it sent
    (soak_witness: equal, to the request, when none failed), the merge
    equal to the spool's files summed one by one, one snapshot a worker
    process (the polled pids among them), and the answers at least one a
    shard for each full routed answer. The arm's forecast_lead_s (its
    first scale-up's lead on the first crest), burst_p99_ms and the
    forecast's part in the autoscaler's ticks (forecast_record) are
    recorded, not held."""
    import dataclasses

    from tpu_ir_torch import obs
    from tpu_ir_torch.obs import timeseries

    reg = obs.get_registry()
    # the SLO windows start empty: the burn the autoscaler reads is this
    # soak's, not the routed soak's kills' (the trace store goes with them)
    obs.disttrace.reset()
    spool = os.path.join(work, "forecast-spool")
    env = {"TPU_IR_TELEMETRY_DIR": spool,
           "TPU_IR_TS_SAMPLE_S": str(FORECAST_SOAK_SAMPLE_S)}
    saved = {k: os.environ.get(k) for k in env}
    fits0 = reg.get("forecast.fits")
    t_start = time.time()
    os.environ.update(env)
    try:
        with soak_witness() as seen:
            report, polled = polled_soak(
                live, work, timeseries=True, shards=FORECAST_SOAK_SHARDS,
                replicas=FORECAST_SOAK_REPLICAS,
                threads=FORECAST_SOAK_THREADS,
                queries=FORECAST_SOAK_QUERIES, layout="dense", chaos=False,
                autoscale=forecast_config(),
                pacing_s=FORECAST_SOAK_PACING_S,
                router_config=forecast_router_config(),
                workload={"kind": "zipf", "skew": FORECAST_SOAK_SKEW,
                          "burst": FORECAST_SOAK_BURST},
                seed=FORECAST_SOAK_SEED, device=device)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    fits = reg.get("forecast.fits") - fits0
    published = timeseries.get_store().points(
        "gauge", "forecast_occupancy", tier=0, since=t_start)
    cluster, cluster_s = run_cli(["stats", "--cluster", "--telemetry-dir",
                                  spool])
    own = worker_spool(spool)
    shutil.rmtree(spool)
    ts_body = polled["worker_timeseries"].get("body") or {}
    rings_ok = bool(ts_body) and all(
        t["len"] <= t["capacity"] for t in ts_body["tiers"]) and sum(
        t["len"] for t in ts_body["tiers"]) <= ts_body["ring_limits"][
        "max_windows"]
    merged_answered = sum(v for k, v in cluster["serving"].items()
                          if k.startswith("served_"))
    sc = report.get("scale", {})
    cfg = forecast_config()
    out = {"phase": "forecast_soak", "card": card, "config": "ref-live",
           "shards": FORECAST_SOAK_SHARDS,
           "replicas": FORECAST_SOAK_REPLICAS,
           "workload": {"kind": "zipf", "skew": FORECAST_SOAK_SKEW,
                        "burst": FORECAST_SOAK_BURST,
                        "threads": FORECAST_SOAK_THREADS,
                        "queries": FORECAST_SOAK_QUERIES,
                        "pacing_s": FORECAST_SOAK_PACING_S},
           "router_slots": FORECAST_SOAK_ROUTER_SLOTS,
           "sample_s": FORECAST_SOAK_SAMPLE_S,
           "autoscale": dataclasses.asdict(cfg),
           "forecast_arm": {
               "forecast_lead_s": sc.get("forecast_lead_s"),
               "burst_p99_ms": report["burst_p99_ms"],
               "first_up_reason": sc.get("first_up_reason"),
               "first_up_s": sc.get("first_up_s"),
               "first_peak_s": sc.get("first_peak_s"),
               "events": sc.get("events"),
               "mean_replicas": sc.get("mean_replicas"),
               **forecast_record(seen["ticks"], cfg.forecast_up,
                                 cfg.up_occupancy)},
           "forecast": {"fits": fits, "published_points": len(published),
                        "last_fit": timeseries.get_store().last_fit},
           "worker_timeseries": {
               "addr": polled["worker_timeseries"].get("addr"),
               "tiers": ts_body.get("tiers"),
               "ring_limits": ts_body.get("ring_limits"),
               "submitted_points": len(ts_body["series"]["submitted_per_s"]
                                       ["tiers"][0]) if ts_body else 0},
           "cluster": {"processes": cluster["processes"],
                       "submitted": cluster["serving"].get("submitted", 0),
                       "answered": merged_answered, "cli_s": cluster_s,
                       "own_submitted": sum(v[0] for v in own.values()),
                       "own_answered": sum(v[1] for v in own.values()),
                       "worker_pids": sorted(own),
                       "router_attempts": seen["attempts"]},
           "report": report,
           **{k: v for k, v in polled.items() if k != "worker_timeseries"}}
    c = out["cluster"]
    searches = seen["attempts"].get("search", {})
    sent_ok = searches.get("sent_ok", 0)
    sent = sent_ok + searches.get("sent_failed", 0)
    out["checks"] = {
        "conservation": report["served"] + report["shed"]
        == report["submitted"],
        "no_error": report["errors"] == 0,
        "no_deadlock": report["deadlocked"] == 0,
        "no_full_mismatch": report["full_mismatches"] == 0,
        "no_partial_mismatch": report["partial_mismatches"] == 0,
        "forecast_fits": fits >= 1,
        "forecast_published": len(published) >= 1,
        "dense_score": device != "cuda"
        or polled["launches_lower_bound"]["dense_score"] > 0,
        "worker_timeseries": out["worker_timeseries"][
            "submitted_points"] > 0 and rings_ok,
        # the merge itself: the spool's files summed one by one
        "merge_equals_files": c["submitted"] == c["own_submitted"]
        and c["answered"] == c["own_answered"] > 0,
        # the spool against the router's own count of the search attempts
        # it sent: each answered one is a worker's answered request, and
        # a worker counts none that was not sent (equal when none failed)
        "spool_equals_router": 0 < sent_ok <= c["answered"]
        and c["submitted"] <= sent,
        "spool_processes": c["processes"] == len(own)
        and set(polled["worker_pids"]) <= set(own),
        "spool_covers_answers": c["answered"]
        >= report["classes"]["full"] * FORECAST_SOAK_SHARDS,
    }
    return out


def forecast_router_config():
    """The forecast soak's Router: the soak's generous deadline, and
    FORECAST_SOAK_ROUTER_SLOTS requests at once, so the occupancy the
    autoscaler reads rides the arrival wave."""
    from tpu_ir_torch.serving import RouterConfig

    return RouterConfig(deadline_ms=3000.0,
                        max_concurrency=FORECAST_SOAK_ROUTER_SLOTS,
                        max_queue=4 * FORECAST_SOAK_THREADS)


def phase_ingest_soak(card: str, work: str, *, device: str) -> dict:
    """`ingest --soak-bench` through the command line's entry point in this
    process on a fresh live dir, at run_ingest_soak's defaults: the
    report (docs/s, the freshness lag, swaps, lost and stale answers, the
    successor's replay) and the kernel launches of the soak's in-process
    frontend over its probes: the report's `kernel_launches` less its
    `warm_launches` (the load, the warm-up searches and each reload), a
    lower bound (a probe served while a reload warmed counts as the
    reload's), with the warm-ups beside them (the feeder children's
    launches are their own). The soak raises on a breach; the phase holds
    its invariants again, and on the card the probes must launch the
    tiered pair."""
    live = os.path.join(work, "ingest-soak-live")
    report, wall = run_cli(["ingest", live, "--soak-bench",
                            "--device", device])
    shutil.rmtree(live)
    total, warm = report["kernel_launches"], report["warm_launches"]
    launches = {n: total[n] - warm[n] for n in PORT_KERNELS}
    out = {"phase": "ingest_soak", "card": card, "config": "feed-48",
           "wall_s": wall, "report": report,
           "launches_lower_bound": launches,
           "launches_with_warm_ups": {n: total[n] for n in PORT_KERNELS}}
    checks = {
        "no_lost_ack": report["lost_acked"] == 0
        and not report["unexpected_docs"],
        "no_stale": report["stale"] == 0,
        "no_error": report["errors"] == 0,
        "conservation": report["served"] + report["shed"]
        + report["errors"] == report["submitted"] > 0,
        "killed": report["kills"] == 1,
        "replayed": (report["child_replayed"] or 0) >= 1
        and report["lease_takeover"],
        "swapped": report["swaps"] >= 1 and report["freshness_samples"] >= 1,
        "tiered_pair": device != "cuda"
        or launches["cold_tier"] + launches["hot_stage"] > 0,
    }
    out["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"the ingest soak: {checks} {report}")
    return out


def check_build_ledger(ledger: list, names: list) -> None:
    """The build ledger (ops/_build.py::build_ledger) holds every kernel
    library of `names` once, each with its compiler's and its load's
    seconds and ptxas's registers, spills, stack and shared memory for
    each of its kernels."""
    by_src = {e["source"]: e for e in ledger}
    for name in names:
        e = by_src.get(f"tpu_ir_torch/csrc/{name}.cu")
        if e is None:
            raise AssertionError(f"the build ledger lacks {name}: {ledger}")
        if e["compile_s"] is None or e["load_s"] is None \
                or e["compile_s"] < 0 or e["load_s"] < 0:
            raise AssertionError(f"{name}: the ledger's seconds {e}")
        if not e["ptxas"] or not all(
                {"registers", "spill_stores", "spill_loads", "stack",
                 "smem"} <= set(k) for k in e["ptxas"]):
            raise AssertionError(f"{name}: no ptxas report for each "
                                 f"kernel: {e['ptxas']}")


def build_kernels(card: str) -> dict:
    """Build every kernel source at once (one nvcc per source, all
    started together), then load each library and the native analyzer;
    with the build ledger of each library (ops/_build.py): whether nvcc
    ran, its seconds and the load's, and ptxas's resource report of each
    kernel (check_build_ledger)."""
    from tpu_ir_torch.ops import _build

    from tpu_ir_torch.analysis import native

    names = _build.kernel_sources()
    t0 = time.perf_counter()
    _build.build(names)
    for name in names:
        _build.load(name)
    seconds = time.perf_counter() - t0
    # the native tokenizer (g++), so no build phase pays its compile
    t0 = time.perf_counter()
    native.load_native()
    native_s = time.perf_counter() - t0
    ledger = _build.build_ledger()
    check_build_ledger(ledger, names)
    by_lib = {e["library"]: e for e in ledger}
    return {"phase": "build_kernels", "card": card, "seconds": seconds,
            "native_analyzer_s": native_s,
            "native_analyzer": _build.host_lib_path(native.SOURCE).name,
            "libraries": {n: _build.lib_path(n).name for n in names},
            "ptxas": {n: by_lib[_build.lib_path(n).name]["ptxas"]
                      for n in names},
            "ledger": ledger}


def kernel_row(name: str, kern: dict, launches: int, serving_launches: int,
               wildcard_launches: int, kgram_launches: int,
               explain_launches: int, **fields) -> dict:
    """One kernel's entry of the summary line: `launches` in its serve
    window, then in the wildcard phase, the kgram phase, the explain
    phases and the serving tier's phases; `fields` adds its source, what
    it replaces and its launches in the merge, warm, live (19d and 19e
    together), shard worker (the shards phase's workers and live_crash's
    in-process ones), routed soak (its workers' /healthz, their warm-ups'
    launches left out), elastic (the fleet's workers over its traffic,
    warm-ups left out), elastic soak and forecast soak (as the routed
    soak), ingest soak (its in-process frontend over its probes, warm-ups
    left out) and v1 phases. The four soaks' counts are lower bounds
    (`*_lower_bound`): a request served while a reload warmed counts as
    the warm-up's."""
    return {"name": name, "route": "cuda", **fields, "launches": launches,
            "wildcard_launches": wildcard_launches,
            "kgram_launches": kgram_launches,
            "explain_launches": explain_launches,
            "serving_launches": serving_launches,
            "max_abs_err": kern["max_abs_diff"], "ms": kern["ms"],
            "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
            "bound_by": kern["bound_by"], "library_ms": kern["library_ms"]}


DISPATCH_AB_PASSES = 10          # passes of each arm of --dispatch-ab (5
                                 # left the trees' medians inside the noise)
DISPATCH_AB_CLIENTS = 16         # the closed loop's clients
CPROFILE_TOP = 15                # functions listed from each arm's profile
# --dispatch-ab --ablate: the arms of a tree with the profiler, each the
# shipped serving loop less one of its per-dispatch parts (ablation():
# `on` the profiler on; `off` the profiler off; `no_span` without the
# dispatch.device span; `no_sample` without the memory sample;
# `unwrapped` with the profiled entry points unwrapped; `bare` without
# all three, the parent's code for them)
ABLATION_ARMS = ("on", "off", "no_span", "no_sample", "unwrapped", "bare")
SAMPLER_COST_INTERVAL_S = 0.05   # the sampler's dearest cadence: the floor
                                 # of TPU_IR_TS_SAMPLE_S


class DispatchMeter:
    """The dispatching thread's time inside Scorer._blocked_dispatch, each
    call: its wall and its own CPU time (time.thread_time_ns). Wall less
    CPU is the time the thread was off its core inside the dispatch:
    waits for the interpreter lock (which the other serving threads
    hold), for the card (a dense block's copy waits 0.06-0.1 ms) and for
    page faults. `install(scorer_cls)` wraps the shipped static method,
    `uninstall` puts it back; `take()` returns the sums since the last
    take and zeroes them."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._sums = self._zero()
        self._shipped = None

    @staticmethod
    def _zero() -> dict:
        return {"calls": 0, "wall_ns": 0, "cpu_ns": 0}

    def install(self, scorer_cls) -> None:
        fn = scorer_cls.__dict__["_blocked_dispatch"].__func__
        self._shipped = fn
        sums, lock = self, self._lock

        def metered(block, dispatch, q):
            c0 = time.thread_time_ns()
            t0 = time.perf_counter_ns()
            try:
                return fn(block, dispatch, q)
            finally:
                t1 = time.perf_counter_ns()
                c1 = time.thread_time_ns()
                with lock:
                    acc = sums._sums
                    acc["calls"] += 1
                    acc["wall_ns"] += t1 - t0
                    acc["cpu_ns"] += c1 - c0

        scorer_cls._blocked_dispatch = staticmethod(metered)

    def uninstall(self, scorer_cls) -> None:
        if self._shipped is not None:
            scorer_cls._blocked_dispatch = staticmethod(self._shipped)
            self._shipped = None

    def take(self) -> dict:
        with self._lock:
            acc, self._sums = self._sums, self._zero()
        n = max(acc["calls"], 1)
        return {"dispatches": acc["calls"],
                "wall_ms": acc["wall_ns"] / 1e6,
                "cpu_ms": acc["cpu_ns"] / 1e6,
                "off_cpu_ms": (acc["wall_ns"] - acc["cpu_ns"]) / 1e6,
                "off_cpu_us_a_dispatch":
                    (acc["wall_ns"] - acc["cpu_ns"]) / 1e3 / n}


@contextlib.contextmanager
def ablation(arm: str):
    """The shipped serving path with `arm`'s parts swapped for no-ops for
    the block, restored after: `no_span` and `bare` the dispatch.device
    span (search/scorer.py's obs_trace, every other span passed through),
    `no_sample` and `bare` the memory sample (obs/profiling.py's
    sample_memory), `unwrapped` and `bare` the profiled entry points
    (unwrapped_entry_points); any other arm swaps nothing. Yields the
    number of entry points unwrapped."""
    import tpu_ir_torch.search.scorer as scorer_mod
    from tpu_ir_torch.obs import profiling

    real_trace, real_sample = scorer_mod.obs_trace, profiling.sample_memory

    def trace(name, **attrs):
        if name == "dispatch.device":
            return contextlib.nullcontext()
        return real_trace(name, **attrs)

    with contextlib.ExitStack() as stack:
        unwrapped = 0
        if arm in ("no_span", "bare"):
            scorer_mod.obs_trace = trace
            stack.callback(setattr, scorer_mod, "obs_trace", real_trace)
        if arm in ("no_sample", "bare"):
            profiling.sample_memory = lambda *a, **kw: None
            stack.callback(setattr, profiling, "sample_memory", real_sample)
        if arm in ("unwrapped", "bare"):
            unwrapped = stack.enter_context(unwrapped_entry_points())
        yield unwrapped


@contextlib.contextmanager
def unwrapped_entry_points():
    """The profiled scoring entry points replaced by the functions they
    wrap, where the serving path reads them (ops/scoring.py's module and
    search/scorer.py's imports), for the block; restored after."""
    import tpu_ir_torch.ops.scoring as ops_scoring
    import tpu_ir_torch.search.scorer as scorer_mod
    from tpu_ir_torch.obs.profiling import Profiled

    saved = [(mod, name, obj) for mod in (ops_scoring, scorer_mod)
             for name, obj in list(vars(mod).items())
             if isinstance(obj, Profiled)]
    for mod, name, obj in saved:
        setattr(mod, name, obj.__wrapped__)
    try:
        yield len(saved)
    finally:
        for mod, name, obj in saved:
            setattr(mod, name, obj)


def dispatch_ab(argv: list[str]) -> int:
    """`--dispatch-ab INDEX [--root TREE] [--label L]`: the serving passes
    of profile_cost on the ref corpus, for an A/B of two trees on one card
    (the module docstring's last paragraph). Prints one JSON line: each
    arm's walls, medians, spreads and collector pauses for the closed loop
    (`loop`) and the batch (`batch`), each pass after a full collection,
    then as many passes as they come (`loop_as_is`, `batch_as_is`), the
    batch's results as one digest
    (equal across arms and trees), each arm's cProfile top functions of
    one batch, each arm's span histograms (count, p50, p99) over its
    passes, and the profiler's own cost (profiler_shim_cost), where the
    tree has the profiler."""
    import argparse
    import cProfile
    import hashlib
    import pstats

    ap = argparse.ArgumentParser(prog="chip_smoke.py --dispatch-ab")
    ap.add_argument("index")
    ap.add_argument("--root", default=None)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args(argv)
    if args.ablate:
        return dispatch_ablation(args)
    setup = ab_setup(args)
    if setup is None:
        return 2
    card, dense, fe, loop_texts = setup
    import tpu_ir_torch
    from tpu_ir_torch.obs import get_registry
    from tpu_ir_torch.obs.histogram import summary_from_counts
    from tpu_ir_torch.search import Scorer

    try:
        from tpu_ir_torch.obs import profiling
    except ImportError:                      # a tree before the profiler
        profiling = None
    sparse = Scorer.load(args.index, layout="sparse", device="cuda")
    batch_texts = serving_texts(sparse, QUERYLOG_BATCH, seed=13)

    def loop():
        return closed_loop(fe, loop_texts, DISPATCH_AB_CLIENTS,
                           scoring="bm25", k=10)

    def batch():
        return [result_bits(r)
                for r in sparse.search_batch(batch_texts, k=10)]

    want = {"loop": loop(), "batch": batch()}          # warm
    # a tree without the profiler runs two like arms: the same passes in
    # the same order as the on/off tree, so a pass's place in the process
    # is matched too
    arms = ("on", "off") if profiling is not None else ("plain", "plain_b")
    # the passes after a full collection each, then as many as they come
    series = [(n, c) for c in (True, False) for n in want]
    walls = {s: {a: [] for a in arms} for s in series}
    pauses = {s: {a: [] for a in arms} for s in series}
    # each arm's span histograms over its collected passes: bucket counts
    # summed
    spans = {n: {a: {} for a in arms} for n in want}
    reg = get_registry()
    try:
        for collect in (True, False):
            for _ in range(DISPATCH_AB_PASSES):
                for arm in arms:
                    if profiling is not None:
                        profiling.configure(enabled=arm == "on")
                    for name, run in (("loop", loop), ("batch", batch)):
                        before = reg.hist_state()
                        got, wall, pause = collected_pass(run, collect)
                        if got != want[name]:
                            raise AssertionError(
                                f"{args.label} {arm} {name}: the results "
                                "differ")
                        walls[name, collect][arm].append(wall)
                        pauses[name, collect][arm].append(pause)
                        if not collect:
                            continue
                        acc = spans[name][arm]
                        for h, (counts, sum_s) in reg.hist_state().items():
                            b_counts, b_sum = before.get(
                                h, ([0] * len(counts), 0.0))
                            c, t = acc.get(h, ([0] * len(counts), 0.0))
                            acc[h] = ([x + a - b for x, a, b in
                                       zip(c, counts, b_counts)],
                                      t + sum_s - b_sum)
        top = {}
        for arm in arms:
            if profiling is not None:
                profiling.configure(enabled=arm == "on")
            prof = cProfile.Profile()
            prof.runcall(batch)
            stats = pstats.Stats(prof).stats
            rows = sorted(stats.items(), key=lambda kv: -kv[1][2])
            top[arm] = [{"fn": f"{os.path.relpath(f, os.getcwd())}:{ln}"
                               f"({name})" if f != "~" else name,
                         "calls": v[1], "own_ms": v[2] * 1e3,
                         "cum_ms": v[3] * 1e3}
                        for (f, ln, name), v in rows[:CPROFILE_TOP]]
    finally:
        if profiling is not None:
            profiling.configure(enabled=True)
    digest = hashlib.sha256(json.dumps(want["batch"]).encode()).hexdigest()

    def span_rows(name: str) -> dict:
        return {a: {h: {k: v for k, v in summary_from_counts(c, t).items()
                        if k in ("count", "p50_ms", "p99_ms")}
                    for h, (c, t) in sorted(spans[name][a].items())
                    if sum(c)}
                for a in arms}
    print(json.dumps({
        "dispatch_ab": args.label, "card": card, "root": args.root,
        "package": os.path.dirname(tpu_ir_torch.__file__),
        "passes": DISPATCH_AB_PASSES,
        "loop": dict(arm_summary(walls["loop", True],
                                 pauses["loop", True]),
                     requests=len(loop_texts),
                     clients=DISPATCH_AB_CLIENTS, spans=span_rows("loop")),
        "batch": dict(arm_summary(walls["batch", True],
                                  pauses["batch", True]),
                      texts=len(batch_texts), results_sha256=digest,
                      spans=span_rows("batch")),
        "loop_as_is": arm_summary(walls["loop", False],
                                  pauses["loop", False]),
        "batch_as_is": arm_summary(walls["batch", False],
                                   pauses["batch", False]),
        "cprofile_batch": top,
        "shim": {"loop": profiler_shim_cost(loop),
                 "batch": profiler_shim_cost(batch)}
        if profiling is not None else None}), flush=True)
    return 0


def ab_setup(args):
    """--dispatch-ab's common start: `--root`'s package first on the
    path, the card checked, the ref index built on first use; returns
    (the card line, the dense Scorer, the coalescing frontend over it,
    the loop's texts) or None without CUDA."""
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return None
    from tpu_ir_torch.search import Scorer
    from tpu_ir_torch.serving import ServingConfig, ServingFrontend
    from tpu_ir_torch.serving.soak import _sweep_queries

    card = card_line()
    if not os.path.exists(os.path.join(args.index, "metadata.json")):
        from tpu_ir_torch.corpus import make_corpus
        from tpu_ir_torch.index import build_index

        os.makedirs(os.path.dirname(os.path.abspath(args.index)),
                    exist_ok=True)
        corpus = args.index.rstrip("/") + ".trec"
        make_corpus(corpus, seed=0, **REF_CORPUS)
        build_index(corpus, args.index, num_shards=10, device="cuda")
    dense = Scorer.load(args.index, layout="dense", device="cuda")
    fe = ServingFrontend(dense, ServingConfig(
        max_concurrency=DISPATCH_AB_CLIENTS,
        max_queue=2 * DISPATCH_AB_CLIENTS, coalesce=True))
    return card, dense, fe, _sweep_queries(dense, QUERYLOG_PASS_TEXTS,
                                           seed=2)


def dispatch_ablation(args) -> int:
    """`--dispatch-ab INDEX --ablate [--root TREE] [--label L]`: the
    serving loop of --dispatch-ab only (QUERYLOG_PASS_TEXTS BM25 requests
    from DISPATCH_AB_CLIENTS clients through a coalescing frontend on the
    dense layout), in the arms of ABLATION_ARMS where the tree has the
    profiler (else as many like arms, `plain_0`, ...), in turns,
    DISPATCH_AB_PASSES passes of each, each after a full collection;
    every pass's results bitwise the first's. Every arm runs the tree's
    own Scorer._blocked_dispatch, with the arm's parts swapped out
    (ablation()). Each pass also reads the dispatching thread's time
    inside each dispatch (DispatchMeter: wall, its own CPU, off its
    core). Prints one JSON line: each arm's arm_summary of the walls and
    the meter's sums a pass."""
    import threading

    setup = ab_setup(args)        # puts --root's package first on the path
    if setup is None:
        return 2
    card, dense, fe, texts = setup
    from tpu_ir_torch.search import Scorer

    try:
        from tpu_ir_torch.obs import profiling
    except ImportError:                      # a tree before the profiler
        profiling = None
    ablate = profiling is not None
    arms = (ABLATION_ARMS if ablate
            else tuple(f"plain_{i}" for i in range(len(ABLATION_ARMS))))
    meter = DispatchMeter()

    def loop():
        return closed_loop(fe, texts, DISPATCH_AB_CLIENTS, scoring="bm25",
                           k=10)

    want = loop()                                       # warm
    walls = {a: [] for a in arms}
    pauses = {a: [] for a in arms}
    meters = {a: [] for a in arms}
    unwrapped = 0
    meter.install(Scorer)
    try:
        for _ in range(DISPATCH_AB_PASSES):
            for arm in arms:
                with contextlib.ExitStack() as stack:
                    if ablate:
                        profiling.configure(enabled=arm != "off")
                        unwrapped = max(unwrapped, stack.enter_context(
                            ablation(arm)))
                    meter.take()
                    got, wall, pause = collected_pass(loop)
                    if got != want:
                        raise AssertionError(
                            f"{args.label} {arm}: the results differ")
                    walls[arm].append(wall)
                    pauses[arm].append(pause)
                    meters[arm].append(meter.take())
    finally:
        meter.uninstall(Scorer)
        if ablate:
            profiling.configure(enabled=True)
    print(json.dumps({
        "dispatch_ab": args.label, "ablate": ablate, "card": card,
        "root": args.root, "package": os.path.dirname(
            sys.modules["tpu_ir_torch"].__file__),
        "passes": DISPATCH_AB_PASSES,
        "requests": len(texts), "clients": DISPATCH_AB_CLIENTS,
        "unwrapped_entry_points": unwrapped,
        "threads_at_end": threading.active_count(),
        "loop": dict(arm_summary(walls, pauses), meter=meters)}),
        flush=True)
    return 0


def pool_ablation(paths: list[str]) -> dict:
    """The --ablate lines of several processes pooled by tree (the
    `dispatch_ab` label) and arm: every pass's wall, their median and
    the spread of the processes' medians; the meter's off-core µs a
    dispatch, its off-core share and CPU ms a pass, pooled medians; each arm's
    median over the first tree's arm of the same place in its arm
    order (a tree without the profiler runs like arms in that order)."""
    trees: dict = {}
    for path in paths:
        with open(path) as f:
            line = json.loads(f.read().strip().splitlines()[-1])
        tree = trees.setdefault(line["dispatch_ab"], {"processes": 0,
                                                      "arms": {}})
        tree["processes"] += 1
        for arm, walls in line["loop"]["walls_s"].items():
            acc = tree["arms"].setdefault(arm, {"walls": [], "medians": [],
                                                "meter": []})
            acc["walls"] += walls
            acc["medians"].append(float(np.median(walls)))
            acc["meter"] += line["loop"]["meter"][arm]
    out = {}
    for label, tree in trees.items():
        rows = {}
        for arm, acc in tree["arms"].items():
            m = acc["meter"]
            rows[arm] = {
                "passes": len(acc["walls"]),
                "median_s": float(np.median(acc["walls"])),
                "process_median_spread_s": max(acc["medians"])
                - min(acc["medians"]),
                "off_cpu_us_a_dispatch": float(np.median(
                    [x["off_cpu_us_a_dispatch"] for x in m])),
                "off_cpu_share": float(np.median(
                    [x["off_cpu_ms"] / x["wall_ms"] for x in m
                     if x["wall_ms"]])),
                "cpu_ms_a_pass": float(np.median([x["cpu_ms"] for x in m])),
                "dispatches_a_pass": float(np.median(
                    [x["dispatches"] for x in m]))}
        out[label] = {"processes": tree["processes"], "arms": rows}
    labels = list(out)
    base = out[labels[0]]["arms"]
    for label in labels:
        for (arm, row), base_row in zip(out[label]["arms"].items(),
                                        base.values()):
            row[f"over_{labels[0]}"] = (row["median_s"]
                                        / base_row["median_s"] - 1.0)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--dispatch-ab-pool"]:
        print(json.dumps(pool_ablation(sys.argv[2:]), indent=1))
        return 0
    if sys.argv[1:2] == ["--dispatch-ab"]:
        return dispatch_ab(sys.argv[2:])
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
        import tpu_ir_torch  # noqa: F401 — the check only
    except ImportError as e:
        print(f"chip_smoke: cannot import tpu_ir_torch ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    card = card_line()
    emit(build_kernels(card))
    root = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(root, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    work = tempfile.mkdtemp(dir=scratch)
    # host work runs in one child beside the main path: it writes the
    # wiki100k corpus while the kernel and ref phases run, compresses a
    # copy of the wiki100k index while the wildcard and kernel phases run,
    # and reads the phrase oracle's token streams while the merge and live
    # phases run
    side = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    corpus_made = side.submit(
        make_wiki_corpus, os.path.join(work, "wiki100k.trec"))
    try:
        return run_phases(card, work, side, corpus_made)
    finally:
        side.shutdown(wait=True, cancel_futures=True)
        # the spawn context's semaphores started multiprocessing's resource
        # tracker, a child that would outlive this process for a moment
        from multiprocessing import resource_tracker

        resource_tracker._resource_tracker._stop()
        shutil.rmtree(work, ignore_errors=True)


def run_phases(card: str, work: str, side, corpus_made) -> int:
    """Every phase after the kernels' build, in order, then the summary
    line and the last line. `side` is the executor of the host work that
    runs beside the main path."""
    import torch

    import tpu_ir_torch
    from tpu_ir_torch import faults
    from tpu_ir_torch.search import Scorer

    # every flight record of the run (and of the worker processes it
    # spawns) lands in the work dir
    os.environ["TPU_IR_FLIGHT_DIR"] = os.path.join(work, "flight")
    emit(phase_env(card))
    shapes = dict(vocab_rows=REF_VOCAB_ROWS, width=8_761 + 1,
                  batch=REF_QUERIES, terms=REF_QUERY_TERMS)
    kern = phase_kernels(card, **shapes)
    emit(kern)
    torch.cuda.empty_cache()
    dequant = phase_dequant_score(card, **shapes)
    emit(dequant)
    torch.cuda.empty_cache()

    try:
        build, idx = phase_build(card, work, device="cuda", keep_corpus=True)
        emit(build)
        emit(phase_crash_resume(card, idx, work, device="cuda"))
        serve, scorer, q_ids, dense = phase_serve(card, idx, device="cuda")
        emit(serve)
        ref_q_ids = q_ids
        rerank, ref_rerank = phase_rerank(card, scorer, q_ids, config="ref",
                                          device="cuda")
        emit(rerank)
        # explain, its launches counted over its own runs only
        explain_launches = {n: 0 for n in PORT_KERNELS}

        def explain(*args, **kw):
            tpu_ir_torch.reset_kernel_launches()
            emit(phase_explain(card, *args, **kw))
            for n, v in tpu_ir_torch.kernel_launches().items():
                explain_launches[n] += v

        ref_texts = [" ".join(scorer.vocab.terms[int(t)] for t in row)
                     for row in q_ids[:EXPLAIN_QUERIES]]
        explain(scorer, ref_texts, config="ref", traffic="uniform",
                runs=("tfidf", "bm25", "rerank"))
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
        explain(scorer, ref_texts, config="ref-v3", traffic="uniform",
                runs=("tfidf", "bm25"))
        del scorer
        shutil.rmtree(v3)
        torch.cuda.empty_cache()
        v1 = phase_v1(card, work, idx, ref_q_ids, dense, device="cuda")
        emit(v1)
        torch.cuda.empty_cache()

        wbuild, widx = phase_build_streaming(card, work, device="cuda",
                                             keep_corpus=True,
                                             corpus_made=corpus_made)
        emit(wbuild)
        wserve, scorer, q_ids, wraw = phase_serve(card, widx, device="cuda",
                                                  config="wiki100k")
        emit(wserve)
        # the serve wrote the index's serving cache: a copy from here on is
        # the one the compress phase always took
        wcomp_made = side.submit(phase_compress, card, widx, work,
                                 config="wiki100k")
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
        for traffic, rows in (("uniform", q_ids), ("hot", hot_q)):
            explain(scorer, [" ".join(scorer.vocab.terms[int(t)]
                                      for t in row)
                             for row in rows[:EXPLAIN_QUERIES]],
                    config="wiki100k", traffic=traffic,
                    runs=("tfidf", "bm25", "rerank"))
        for kernel, n in explain_launches.items():
            if n == 0:
                raise AssertionError(f"the explain phases never launched "
                                     f"{kernel}: {explain_launches}")
        torch.cuda.empty_cache()
        # the kernels' times alone: a fresh process loads the index while
        # the wildcard phase's host work runs, and measures after it
        block = scorer._block_size()
        alone = AloneChild(widx, hot_q[:block], q_ids[:block])
        try:
            # wildcard and fuzzy traffic, its launches counted on their own
            tpu_ir_torch.reset_kernel_launches()
            for row in phase_wildcard(card, scorer, widx, device="cuda"):
                emit(row)
            alone_ms = alone.results()
        finally:
            alone.stop()
        wildcard_launches = tpu_ir_torch.kernel_launches()
        for kernel in ("cold_tier", "hot_stage"):
            if wildcard_launches[kernel] == 0:
                raise AssertionError(f"the wildcard phase never launched "
                                     f"{kernel}: {wildcard_launches}")
        torch.cuda.empty_cache()
        hot = phase_hot_stage(card, scorer, hot_q[:block],
                              alone_ms["hot_stage"])
        hot["kernel_per_10k_topk"] = {
            s: wserve["profile"][s]["port_kernels"].get("hot_stage")
            for s in ("tfidf", "bm25")}
        emit(hot)
        torch.cuda.empty_cache()
        cold = phase_cold_tier(card, scorer, q_ids[:block],
                               alone_ms["cold_tier"])
        cold["launches_per_10k_topk"] = wserve["launches_per_topk"]
        # the kernel's device time in one profiled 10k topk (serve phase)
        cold["kernel_per_10k_topk"] = {
            s: wserve["profile"][s]["port_kernels"]["cold_tier"]
            for s in ("tfidf", "bm25")}
        emit(cold)
        del scorer
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        wcomp, wv3 = wcomp_made.result(timeout=1800)
        wcomp["wait_s"] = time.perf_counter() - t0
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

        # positions: both builds at ref and wiki100k, then the positional
        # queries over them
        positions, pos_dirs = phase_positions(card, work, device="cuda",
                                              keep_corpora=True)
        emit(positions)
        streams = side.submit(store_streams_timed, pos_dirs["wiki100k"],
                              work)
        # merge (both corpora, kept for the live phases), then the serving
        # cache and doctor on the wiki100k index
        merge = phase_merge(card, work, widx=widx,
                            wdigests=artifact_digests(widx),
                            ref_pos=pos_dirs["ref"], q_ids=q_ids,
                            want=wraw, device="cuda")
        emit(merge)
        torch.cuda.empty_cache()
        warm = phase_warm(card, widx, q_ids, hot_q, device="cuda")
        emit(warm)
        torch.cuda.empty_cache()
        emit(phase_doctor(card, widx))
        # the live index: wiki100k, then the crash at ref scale (each
        # deletes its corpus)
        shards = {}

        def run_shards(live_dir, gen_a, gen_b, scorers):
            shards.update(phase_shards(card, work, live_dir, gen_a, gen_b,
                                       scorers, device="cuda"))
            elastic = shards.pop("elastic")
            emit(shards)
            emit(elastic)
            shards["elastic_launches"] = elastic["launches"]

        live = phase_live(card, work, device="cuda",
                          before_checks=run_shards)
        emit(live)
        torch.cuda.empty_cache()
        live_crash = phase_live_crash(card, work, device="cuda")
        emit(live_crash)
        live_launches = {n: live["launches"][n] + live_crash["launches"][n]
                         for n in PORT_KERNELS}
        shard_launches = {
            n: shards["launches"][n] + live_crash["workers"]["launches"][n]
            for n in PORT_KERNELS}
        ingest_soak = phase_ingest_soak(card, work, device="cuda")
        emit(ingest_soak)
        # the soaks' routed launches, each a lower bound (kernel_row)
        lower_bounds = {n: {
            "soak_launches_lower_bound": live_crash[
                "routed_soak_launches_lower_bound"][n],
            "elastic_soak_launches_lower_bound": live_crash[
                "elastic_soak_launches_lower_bound"][n],
            "forecast_soak_launches_lower_bound": live_crash[
                "forecast_soak_launches_lower_bound"][n],
            "ingest_soak_launches_lower_bound": ingest_soak[
                "launches_lower_bound"][n]} for n in PORT_KERNELS}
        torch.cuda.empty_cache()
        scorer = Scorer.load(pos_dirs["ref"], device="cuda")
        emit(phase_prox(card, scorer, ref_q_ids, config="ref",
                        device="cuda"))
        del scorer
        shutil.rmtree(pos_dirs["ref"])
        torch.cuda.empty_cache()
        scorer = Scorer.load(pos_dirs["wiki100k"], device="cuda")
        emit(phase_prox(card, scorer, q_ids, config="wiki100k",
                        device="cuda"))
        emit(phase_phrase(card, scorer, pos_dirs["wiki100k"], work,
                          streams=streams,
                          device="cuda"))
        emit(phase_snippets(card, scorer, q_ids))
        del scorer
        shutil.rmtree(pos_dirs["wiki100k"])
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
        emit(phase_querylog(card, serving, device="cuda"))
        del serving, scorer
    finally:
        faults.drain_abandoned(timeout_s=10.0)

    # cold_tier's times are the TF-IDF stage's (the default scoring); its
    # error is the larger of the two scorings'
    cold_row = dict(cold["tfidf"], max_abs_diff=max(
        cold[s]["max_abs_diff"] for s in ("tfidf", "bm25")))
    emit({"kernels": [
        kernel_row("dense_score", kern, serve["launches"]["dense_score"],
                   serving_launches["dense_score"],
                   wildcard_launches["dense_score"],
                   kgram["launches"]["dense_score"],
                   explain_launches["dense_score"],
                   merge_launches=merge["launches"]["dense_score"],
                   warm_launches=warm["launches"]["dense_score"],
                   live_launches=live_launches["dense_score"],
                   shard_launches=shard_launches["dense_score"],
                   elastic_launches=shards["elastic_launches"]["dense_score"],
                   **lower_bounds["dense_score"],
                   v1_launches=v1["launches"]["dense_score"],
                   source="tpu_ir_torch/csrc/dense_score.cu",
                   replaces="tpu_ir/ops/pallas_scoring.py:52"),
        kernel_row("dequant_score", dequant,
                   serve_v3["launches"]["dequant_score"],
                   serving_launches["dequant_score"],
                   wildcard_launches["dequant_score"],
                   kgram["launches"]["dequant_score"],
                   explain_launches["dequant_score"],
                   merge_launches=merge["launches"]["dequant_score"],
                   warm_launches=warm["launches"]["dequant_score"],
                   live_launches=live_launches["dequant_score"],
                   shard_launches=shard_launches["dequant_score"],
                   elastic_launches=shards["elastic_launches"]["dequant_score"],
                   **lower_bounds["dequant_score"],
                   v1_launches=v1["launches"]["dequant_score"],
                   source="tpu_ir_torch/csrc/dequant_score.cu",
                   replaces="tpu_ir/ops/pallas_scoring.py:129"),
        kernel_row("cold_tier", cold_row, wserve["launches"]["cold_tier"],
                   serving_launches["cold_tier"],
                   wildcard_launches["cold_tier"],
                   kgram["launches"]["cold_tier"],
                   explain_launches["cold_tier"],
                   merge_launches=merge["launches"]["cold_tier"],
                   warm_launches=warm["launches"]["cold_tier"],
                   live_launches=live_launches["cold_tier"],
                   shard_launches=shard_launches["cold_tier"],
                   elastic_launches=shards["elastic_launches"]["cold_tier"],
                   **lower_bounds["cold_tier"],
                   v1_launches=v1["launches"]["cold_tier"],
                   source="tpu_ir_torch/csrc/cold_tier.cu",
                   replaces="experiments/cold_tier_bench.py:42"),
        kernel_row("hot_stage", hot["full"], wserve["launches"]["hot_stage"],
                   serving_launches["hot_stage"],
                   wildcard_launches["hot_stage"],
                   kgram["launches"]["hot_stage"],
                   explain_launches["hot_stage"],
                   merge_launches=merge["launches"]["hot_stage"],
                   warm_launches=warm["launches"]["hot_stage"],
                   live_launches=live_launches["hot_stage"],
                   shard_launches=shard_launches["hot_stage"],
                   elastic_launches=shards["elastic_launches"]["hot_stage"],
                   **lower_bounds["hot_stage"],
                   v1_launches=v1["launches"]["hot_stage"],
                   source="tpu_ir_torch/csrc/hot_stage.cu",
                   replaces="tpu_ir/ops/scoring.py:290")]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
