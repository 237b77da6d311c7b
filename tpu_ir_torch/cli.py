"""Command line of the port: `index`, `search`, `expand`, `eval`,
`inspect`, `verify`, `migrate-index`, `merge`, `warm`, `doctor`,
`serve-bench`, `serve-worker`, `scale`, `ingest`, `compact`,
`generations`, `backup`, `trace`, `querylog`, `trace-dump`, `stats`,
`metrics`, `top`, `profile`, `cache`, `pack`, `count` and `docno`, with
tpu_ir's flag names and defaults.

    python -m tpu_ir_torch.cli index CORPUS... IDX [--shards N] [--k 1]
        [--chargram-k 2 3] [--no-chargrams] [--overwrite] [--streaming
        [--batch-docs N] [--radix-buckets B] [--tokenize-procs N]] [--store]
        [--positions] [--track PORT] [--device cuda|cpu]
    python -m tpu_ir_torch.cli inspect PATH [-n N] [--postings N]
        [--term TEXT]
    python -m tpu_ir_torch.cli verify IDX|LIVE
    python -m tpu_ir_torch.cli search IDX [-q TEXT | --queries-file F |
        --topics F] [--scoring tfidf|bm25] [--k K] [--rerank N]
        [--layout auto|dense|sparse|sharded] [--docnos] [--compat]
        [--trec-run TAG] [--prox] [--slop S] [--show-matches] [--snippets]
    python -m tpu_ir_torch.cli expand IDX PATTERN [--chargram-k 3] [-n 50]
    python -m tpu_ir_torch.cli eval RUN QRELS [--complete]
    python -m tpu_ir_torch.cli migrate-index IDX [--to 1|2|3]
        [--compress | --decompress] [--tf-dtype auto|int8|bf16]
        [--add-bounds]
    python -m tpu_ir_torch.cli merge SRC... OUT [--shards N]
        [--no-chargrams] [--overwrite] [--device cuda|cpu]
    python -m tpu_ir_torch.cli warm IDX [--layout sparse|...]
        [--device cuda|cpu]
    python -m tpu_ir_torch.cli doctor IDX|LIVE [--top N]
    python -m tpu_ir_torch.cli serve-bench IDX [--threads N] [--queries N]
        [--seed S] [--concurrency N | N,N,...] [--queue-depth N]
        [--deadline S] [--coalesce auto|on|off] [--breaker-threshold N]
        [--cache N] [--timeout S] [--chaos] [--layout ...] [--device ...]
        [--shards N [--replicas R] [--autoscale [--lead S]] [--pacing S]]
        [--workload uniform|zipf] [--skew S[,S...]] [--burst B]
        [--flight-dir DIR] [--metrics-port PORT]
    python -m tpu_ir_torch.cli serve-worker IDX|LIVE --shard i/S [--port P]
        [--host H] [--replica R] [--layout auto|dense|sparse]
        [--deadline S] [--concurrency N] [--queue-depth N] [--no-warm]
        [--run-for S] [--device cuda|cpu]
    python -m tpu_ir_torch.cli scale [--url http://HOST:PORT]
    python -m tpu_ir_torch.cli ingest LIVE [--init [--shards N]
        [--chargram-k 2 3]] [--add TREC...] [--update TREC...]
        [--delete DOCID...] [--merge | --compact] [--gc]
        [--buffer-docs N] [--no-auto-merge] [--swap-bench | --soak-bench]
        [--device cuda|cpu]
    python -m tpu_ir_torch.cli compact LIVE [--all] [--max-steps N] [--gc]
        [--device cuda|cpu]
    python -m tpu_ir_torch.cli generations LIVE [-n N] [--gc]
    python -m tpu_ir_torch.cli backup SRC DEST [--restore]
    python -m tpu_ir_torch.cli trace [TRACE_ID] [--json]
    python -m tpu_ir_torch.cli querylog [-n N] [--slow] [--trace ID]
    python -m tpu_ir_torch.cli trace-dump [--out FILE]
    python -m tpu_ir_torch.cli stats [--reset | --cluster
        [--telemetry-dir DIR]]
    python -m tpu_ir_torch.cli metrics [--prom] [--reset | --cluster
        [--telemetry-dir DIR]]
    python -m tpu_ir_torch.cli top [--url URL] [--tier N] [--watch N]
        [--interval S] [--json]
    python -m tpu_ir_torch.cli profile
    python -m tpu_ir_torch.cli cache [stats|clear]
    python -m tpu_ir_torch.cli pack TEXT_FILE OUT [--prefix LINE]
        [--format lines|trectext|trecweb]
    python -m tpu_ir_torch.cli count CORPUS...
    python -m tpu_ir_torch.cli docno IDX list|getDocno DOCID|getDocid DOCNO

`index`, `search`, `merge`, `warm`, `serve-bench`, `serve-worker`,
`ingest` and `compact` run on CUDA unless `--device cpu` is given; the
others run on the host.
`verify` and `doctor` take a live index dir too (its verify_live and
live topology reports). Each prints its JSON
report last (`inspect` prints an index dir's metadata and its first
records, one line per hit with `--term`, or the dump of any other
artifact file or dir; `expand` one term per line, `docno` the mapping's
lines; `doctor` its warnings on standard error). `search` with none of `-q`,
`--queries-file` and `--topics` reads queries from standard input, one a
line, until `exit`. Quoted spans are phrase queries and `--prox` the
proximity boost of a `--rerank` (both need `index --positions`);
`--show-matches` prints each hit's term positions, `--snippets` a
highlighted text window (needs `index --store`). A ValueError of the
library (a phrase query on an index without positions, a bad option)
prints one `error:` line and exits 1, as tpu_ir's command line does.
`serve-bench` runs the soak through the serving frontend (one
`--concurrency` value), or the concurrency sweep (a comma list), and
exits 1 when an invariant fails; `--shards N` runs the distributed chaos
soak instead (S x R worker processes behind the Router, one soak a
`--skew` level) and prints its report with the row the JAX package would
append to BENCH_HISTORY.jsonl (`history` is null: the port writes no
row); `--autoscale` runs that soak under the autoscaler, then the forecast arm
(the same soak with the autoscaler's third signal armed: the diurnal fit
publishes the occupancy predicted `--lead` seconds ahead, default 1.0;
`forecast_arm` holds its burst p99 and its lead on the first crest), then
a static control at the reactive arm's mean replica count.
`scale` prints the autoscaler's resolved configuration and, with
`--url`, a serving process's /healthz autoscaler section.
`serve-worker` serves one doc shard's RPC surface (serving/shardset.py)
and prints one ready JSON line; `--run-for S` stops it after S seconds.
`ingest --swap-bench` runs the ingest -> compact -> swap micro-bench and
prints its report with the row the JAX package would append to
BENCH_HISTORY.jsonl (`history` is null: the port writes no row).
`ingest --soak-bench` runs the ingest and serve soak (a feeder child
SIGKILLed mid-feed, its successor's recovery) and prints its report the
same way.
`trace` lists the distributed trace ids this process stores and the span
spool under TPU_IR_TELEMETRY_DIR holds; with an id it stitches that
trace and prints its waterfall, each attempt with its verdict (`--json`:
the stitched tree), and exits 1 for an unknown id.
`index --track PORT` serves the build's progress job over HTTP while it
runs (`/jobs`, `/healthz`, `/flight`; 0 picks a free port), announces the
URL on standard error and stops the server when the build returns.
`querylog` prints this process's query log and slow-query captures (one
JSON object; empty from a fresh command, the shape is the contract; a
serving process shows its own on `/querylog`), `--trace ID` only the
entries of one distributed trace. `trace-dump` prints the flight
recorder's artifact on demand (JSONL: header, the ring's traces, the
telemetry), or writes it to `--out FILE`. `serve-bench` reports the
query log's counts and last slow entries under `querylog`, and an
invariant breach writes its flight record to `--flight-dir` (default:
TPU_IR_FLIGHT_DIR, else the system temp dir). `serve-bench
--metrics-port PORT` serves the process's telemetry while the soak, the
sweep or the routed soak runs (/metrics, /metrics.json, /profile,
/doctor, /healthz, /jobs, /querylog, /flight; 0 picks a free port).
`stats`, `metrics` (`--prom`: Prometheus text), `profile` (the
device-cost profiler's report) and `cache stats|clear` (the live result
caches) print this process's telemetry in tpu_ir's shapes: empty from a
fresh command, the shape is the contract; a serving process shows its
own on its server. `--reset` reads and zeroes in one step. `--cluster`
merges the snapshots the serving processes spooled to
TPU_IR_TELEMETRY_DIR (or `--telemetry-dir`): counters and histogram
buckets added, gauges by their merge policy, with `processes` and
`per_process`; it exits 1 when no spool is set or it is empty. `top` draws
the telemetry time machine (obs/timeseries.py): this process's store, or
with `--url` a serving process's /timeseries (`--json`: the payload).
`serve-bench --metrics-port` also serves /timeseries and, with
TPU_IR_TELEMETRY_DIR set, /cluster.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys


class _MaybeTrack:
    """Serve this process's telemetry (obs/server.py: /metrics, /profile,
    /doctor, /jobs, /healthz, /flight, ...) for the length of a command
    when a port is given (0 picks a free one), announcing the URL on
    standard error; the server stops with the command."""

    def __init__(self, port: int | None):
        self._port = port
        self.server = None

    def __enter__(self):
        if self._port is not None:
            from .obs.server import MetricsServer

            self.server = MetricsServer(port=self._port).start()
            print(f"tpu-ir: serving live telemetry on {self.server.url} "
                  "(/metrics /healthz /jobs /profile /flight)",
                  file=sys.stderr)
        return self

    def __exit__(self, *exc):
        if self.server is not None:
            self.server.stop()
        return False


def cmd_index(args) -> int:
    with _MaybeTrack(args.track):
        return _run_index(args)


def _run_index(args) -> int:
    from .index import build_index, build_index_streaming

    missing = [p for p in args.corpus if not os.path.exists(p)]
    if missing:
        print(f"error: corpus path(s) not found: {', '.join(missing)}",
              file=sys.stderr)
        return 1
    kw = dict(k=args.k, chargram_ks=args.chargram_k, num_shards=args.shards,
              overwrite=args.overwrite,
              compute_chargrams=not args.no_chargrams,
              positions=args.positions, device=args.device)
    if args.streaming:
        meta = build_index_streaming(
            args.corpus, args.index_dir, batch_docs=args.batch_docs,
            store=args.store, radix_buckets=args.radix_buckets,
            tokenize_procs=args.tokenize_procs, **kw)
    else:
        meta = build_index(args.corpus, args.index_dir, **kw)
    out = dict(meta.__dict__)
    if args.store:
        from .index import docstore as ds

        # the streaming build wrote the store from its pass-1 text spills;
        # the one-shot build, or a store a crash left inconsistent, pays
        # one corpus pass
        out["docstore"] = (ds.stats(args.index_dir)
                           if ds.consistent(args.index_dir)
                           else ds.build_docstore(args.corpus,
                                                  args.index_dir))
    print(json.dumps(out))
    return 0


def cmd_inspect(args) -> int:
    """An index dir's metadata and first `-n` records (with `--term`, one
    term's postings through the dictionary, the reference's getValue
    seek; the input is analyzed like a query), or the dump of any other
    artifact file or dir (index/artifacts.py)."""
    from .index import format as fmt

    if not (os.path.isdir(args.index_dir)
            and fmt.artifact_exists(args.index_dir, fmt.METADATA)):
        from .index.artifacts import inspect_path

        try:
            for line in inspect_path(args.index_dir, n=args.n):
                print(line)
        except FileNotFoundError:
            print(f"no such artifact: {args.index_dir}", file=sys.stderr)
            return 1
        return 0
    if args.term is None:
        return _dump_index(args)
    from .index.dictionary import lookup_term

    hits = lookup_term(args.index_dir, args.term)
    if not hits:
        print(f"term {args.term!r} not in dictionary", file=sys.stderr)
        return 1
    for tp in hits:
        posts = [tuple(p) for p in tp.postings[: args.postings].tolist()]
        print(f"part-{tp.shard:05d}@{tp.offset}\t{tp.term}\tdf={tp.df}"
              f"\t{posts}")
    return 0


def _dump_index(args) -> int:
    """metadata.json as one JSON line, then the first `-n` terms of the
    parts in shard order with up to `--postings` postings each."""
    from .collection import Vocab
    from .index import format as fmt

    meta = fmt.IndexMetadata.load(args.index_dir)
    print(json.dumps(meta.__dict__))
    vocab = Vocab.load(os.path.join(args.index_dir, fmt.VOCAB))
    shown = 0
    for s in range(meta.num_shards):
        if shown >= args.n:
            break
        z = fmt.load_shard(args.index_dir, s, decode=True)
        for i, tid in enumerate(z["term_ids"]):
            if shown >= args.n:
                break
            lo, hi = z["indptr"][i], z["indptr"][i + 1]
            posts = list(zip(z["pair_doc"][lo:hi].tolist(),
                             z["pair_tf"][lo:hi].tolist()))
            print(f"part-{s:05d}\t{vocab.term(int(tid))}"
                  f"\tdf={int(z['df'][i])}\t{posts[: args.postings]}")
            shown += 1
    return 0


def cmd_verify(args) -> int:
    from .index import segments as seg
    from .index.verify import verify_index, verify_live

    if seg.is_live(args.index_dir):
        print(json.dumps(verify_live(args.index_dir)))
    else:
        print(json.dumps(verify_index(args.index_dir)))
    return 0


def cmd_serve_worker(args) -> int:
    """One shard worker (serving/shardset.py::serve_worker) in this
    process: prints one ready JSON line (addr, port, shard, num_shards,
    replica, pid, index_generation, doc_range), then serves until SIGTERM,
    Ctrl-C or `--run-for` seconds."""
    from . import faults
    from .serving.shardset import serve_worker, sigterm_flag, wait_until

    try:
        shard_s, _, total_s = args.shard.partition("/")
        shard, num_shards = int(shard_s), int(total_s)
    except ValueError:
        print(f"--shard {args.shard!r}: expected i/S (e.g. 0/4)",
              file=sys.stderr)
        return 2
    if not 0 <= shard < num_shards:
        print(f"--shard {args.shard!r}: shard index out of range",
              file=sys.stderr)
        return 2
    layout = "sparse" if args.layout == "auto" else args.layout
    stopped = sigterm_flag()
    server, _frontend, scorer = serve_worker(
        args.index_dir, shard, num_shards, layout=layout, port=args.port,
        host=args.host, replica=args.replica, deadline_s=args.deadline,
        max_concurrency=args.concurrency, max_queue=args.queue_depth,
        warm=not args.no_warm, device=args.device)
    print(json.dumps({
        "addr": f"{args.host}:{server.port}", "port": server.port,
        "shard": shard, "num_shards": num_shards, "replica": args.replica,
        "pid": os.getpid(), "index_generation": scorer.generation,
        "doc_range": list(scorer.doc_range or ()),
    }, sort_keys=True), flush=True)
    try:
        wait_until(stopped, args.run_for or None)
    finally:
        server.stop()
        faults.drain_abandoned(timeout_s=5.0)
    return 0


def cmd_ingest(args) -> int:
    """The live index's write surface (index/ingest.py): `--init` creates
    a live dir; `--add`/`--update` feed TREC corpora through the
    IngestWriter, `--delete` tombstones docids, `--merge` runs one tiered
    merge step, `--compact` folds everything into one servable segment,
    `--gc` prunes old generations. One JSON summary on stdout.
    `--swap-bench` runs serving/generation.py::swap_microbench on the
    live dir (created if missing), `--soak-bench` serving/soak.py::
    run_ingest_soak; each prints its report with the row the JAX package
    would append to BENCH_HISTORY.jsonl (`history` null)."""
    from .index import segments as seg
    from .index.ingest import IngestWriter, ingest_corpus

    if args.swap_bench:
        from .serving.generation import swap_microbench

        report = swap_microbench(args.live_dir, device=args.device)
        row = {"config": "ingest_swap", "backend": args.device,
               "num_docs": report["num_docs_b"],
               "swap_gap_ms": report["swap_gap_ms"],
               "swap_staleness_ms": report["swap_staleness_ms"],
               "swap_wall_s": report["swap_wall_s"]}
        report["history"] = None
        report["history_row"] = row
        print(json.dumps(report, sort_keys=True))
        return 0
    if args.soak_bench:
        from .serving.soak import run_ingest_soak

        report = run_ingest_soak(args.live_dir, device=args.device)
        row = {"config": "ingest_soak", "backend": args.device,
               "docs": report["docs"], "kills": report["kills"],
               "swaps": report["swaps"],
               "ingest_docs_per_s": report["ingest_docs_per_s"],
               "freshness_lag_ms": report["freshness_lag_ms"]}
        report["history"] = None
        report["history_row"] = row
        print(json.dumps(report, sort_keys=True))
        return 0
    if args.init and not seg.is_live(args.live_dir):
        seg.LiveIndex.create(args.live_dir, k=args.k,
                             num_shards=args.shards,
                             chargram_ks=args.chargram_k)
    missing = [p for p in args.add + args.update
               if not os.path.exists(p)]
    if missing:
        print(f"error: corpus path(s) not found: {', '.join(missing)}",
              file=sys.stderr)
        return 1
    writer = IngestWriter(args.live_dir, buffer_docs=args.buffer_docs,
                          auto_merge=not args.no_auto_merge,
                          device=args.device)
    added = sum(ingest_corpus(writer, p) for p in args.add)
    updated = sum(ingest_corpus(writer, p, update=True)
                  for p in args.update)
    deleted = sum(bool(writer.delete(d)) for d in args.delete)
    # compact or merge before close: close releases the WAL and the
    # lease, and a merge commit belongs inside the owned window
    if args.compact:
        writer.compact_all()
    elif args.merge:
        writer.flush()
        writer.maybe_merge()
    writer.close()
    live = writer.live
    out = {
        "live_dir": os.path.abspath(args.live_dir),
        "generation": live.current_gen(),
        "added": added, "updated": updated, "deleted": deleted,
        **live.doc_counts(),
        "segments": live.manifest()["segments"],
    }
    if args.gc:
        out["gc"] = live.gc()
    print(json.dumps(out, sort_keys=True))
    return 0


def cmd_compact(args) -> int:
    """Drive a live index's merges explicitly: drain the tiered policy's
    merge debt (plan_merges steps, what auto-merge would run), or with
    `--all` fold everything into one servable segment. Readers keep their
    generation until the final atomic rename publishes the next."""
    from .index import segments as seg
    from .index.ingest import IngestWriter

    if not seg.is_live(args.live_dir):
        print(f"error: {args.live_dir} is not a live index dir "
              "(`tpu-ir ingest DIR --init` creates one)", file=sys.stderr)
        return 1
    writer = IngestWriter(args.live_dir, auto_merge=False,
                          device=args.device)
    before = writer.live.manifest()
    if args.all:
        m = writer.compact_all()
        steps = 1
    else:
        drained = writer.drain_merges(max_steps=args.max_steps)
        m, steps = drained["manifest"], drained["steps"]
    out = {
        "live_dir": os.path.abspath(args.live_dir),
        "mode": "all" if args.all else "drain",
        "steps": steps,
        "segments_before": len(before["segments"]),
        "segments": m["segments"],
        "generation": writer.live.current_gen(),
        **writer.live.doc_counts(),
    }
    if args.gc:
        out["gc"] = writer.live.gc()
    print(json.dumps(out, sort_keys=True))
    return 0


def cmd_backup(args) -> int:
    """Snapshot a live dir's current generation (index/backup.py),
    hardlinked where the filesystem allows, with the WAL tail; with
    `--restore`, materialize a snapshot into a new dir and prove it with
    verify_live."""
    from .index.backup import backup_live, restore_live

    if args.restore:
        out = restore_live(args.src, args.dest)
    else:
        out = backup_live(args.src, args.dest)
    print(json.dumps(out, sort_keys=True))
    return 0


def cmd_generations(args) -> int:
    """A live index's generation chain: each generation's segments, live
    docs, tombstones and whether it is servable. `--gc` prunes manifests
    and segments past TPU_IR_INGEST_KEEP_GENERATIONS."""
    from .index import segments as seg

    live = seg.LiveIndex.open(args.live_dir)
    gens = live.generations()
    if args.n:
        gens = gens[-args.n:]
    entries = []
    for g in gens:
        m = live.manifest(g)
        tombs = sum(len(t) for t in m.get("tombstones", {}).values())
        entries.append({
            "gen": g,
            "parent": m.get("parent"),
            "segments": m["segments"],
            "docs": sum(m.get("docs", {}).values()) - tombs,
            "tombstones": tombs,
            "servable": len(m["segments"]) == 1
            and not m.get("tombstones"),
            "note": m.get("note", ""),
            "created": m.get("created"),
        })
    out = {"live_dir": os.path.abspath(args.live_dir),
           "current": live.current_gen(),
           "generations": entries}
    if args.gc:
        out["gc"] = live.gc()
    print(json.dumps(out, sort_keys=True))
    return 0


def cmd_search(args) -> int:
    from .search import Scorer

    if args.snippets:
        # fail before anything is printed: without a usable store every
        # result row would die on the DocStore's error mid-listing
        from .index import docstore as ds

        if not ds.consistent(args.index_dir):
            print("error: index has no usable document store; rebuild "
                  "with `tpu-ir index --store` to render snippets",
                  file=sys.stderr)
            return 1
    scorer = Scorer.load(args.index_dir, layout=args.layout,
                         compat_int_idf=args.compat, device=args.device)
    show_docids = not args.docnos

    def run_batch(queries: list[str], qids: list | None = None) -> None:
        # the reference's guard: 1-2 word queries only
        # (IntDocVectorsForwardIndex.java:292,297)
        skipped = ({q for q in queries if len(q.split()) > 2}
                   if args.compat else set())
        kept = [q for q in queries if q not in skipped]
        results = iter(scorer.search_batch(
            kept, k=args.k, scoring=args.scoring,
            return_docids=show_docids, rerank=args.rerank,
            prox=args.prox, phrase_slop=args.slop) if kept else [])
        if qids is None:
            qids = list(range(1, len(queries) + 1))
        for qid, q in zip(qids, queries):
            if args.trec_run is None:
                print(f"query: {q}")
            if q in skipped:
                if args.trec_run is None:
                    print("  (compat mode: queries are limited to 1-2 "
                          "words)")
                continue
            res = next(results)
            if args.trec_run is not None:
                # trec_eval's run format: qid Q0 docid rank score tag
                for rank, (key, score) in enumerate(res, 1):
                    print(f"{qid} Q0 {key} {rank} {score:.6f} "
                          f"{args.trec_run}")
                continue
            if not res:
                print("  (no matching documents)")
            for rank, (key, score) in enumerate(res, 1):
                print(f"  {rank:2d}. {key}\t{score:.6f}")
                if args.show_matches:
                    print("      "
                          + _format_matches(scorer, q, key, show_docids))
                if args.snippets:
                    print("      "
                          + scorer.snippet(q, key, is_docid=show_docids))

    if args.query:
        run_batch([args.query])
    elif args.topics:
        qids, queries = _read_trec_topics(args.topics)
        run_batch(queries, qids=qids)
    elif args.queries_file:
        with open(args.queries_file, encoding="utf-8") as f:
            queries = [line.strip() for line in f if line.strip()]
        run_batch(queries)
    else:
        # the REPL; 'exit' quits, as the reference's main loop does
        # (IntDocVectorsForwardIndex.java:289)
        print(f"tpu-ir: {scorer.meta.num_docs} docs, "
              f"{scorer.meta.vocab_size} terms, k={scorer.meta.k}, "
              f"layout={scorer.layout}. Type a query, or 'exit'.",
              file=sys.stderr if args.trec_run is not None else sys.stdout)
        next_qid = 1            # a running qid keeps --trec-run lines apart
        # input()'s prompt goes to stdout: only at a terminal, so piped
        # output (run files) stays clean
        prompt = ("query> " if sys.stdin.isatty() and sys.stdout.isatty()
                  and args.trec_run is None else "")
        while True:
            try:
                line = input(prompt).strip()
            except EOFError:
                break
            if not line:
                continue
            if line == "exit":
                break
            run_batch([line], qids=[next_qid])
            next_qid += 1
    return 0


def _format_matches(scorer, query: str, key, key_is_docid: bool) -> str:
    """One hit's match coordinates from the position runs: each distinct
    analyzed query term with its token positions in the document."""
    docno = scorer.mapping.get_docno(key) if key_is_docid else int(key)
    pidx = scorer._phrase_index()
    parts = []
    for t in dict.fromkeys(
            scorer._query_term_sequence(query.replace('"', ' '))):
        pos = pidx.positions(t, docno)
        if pos is not None:
            parts.append(f"{t}@{','.join(str(int(p)) for p in pos)}")
    return " ".join(parts) if parts else "(no positional matches)"


def _read_trec_topics(path: str) -> tuple[list[str], list[str]]:
    """A TREC topics file's (qids, title queries): <top> records with a
    <num> Number: NNN line and a <title>, whose text runs on the next
    lines to the next tag or sits on one line as <title>text</title>."""
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    qids: list[str] = []
    queries: list[str] = []
    for top in re.split(r"(?i)<top>", text)[1:]:
        num = re.search(r"(?i)<num>\s*(?:Number:)?\s*([^<\s][^<\n]*)", top)
        title = re.search(
            r"(?i)<title>\s*(?:Topic:)?\s*(.*?)\s*(?=<|\Z)", top, re.S)
        if not num or not title:
            continue
        q = " ".join(title.group(1).split())
        if q:
            qids.append(num.group(1).strip())
            queries.append(q)
    return qids, queries


def cmd_pack(args) -> int:
    """Each line of a plain text file as one TREC <DOC> with the docid
    PREFIX-NNNNNNN; `--format trectext|trecweb` instead parses the input
    with that stream parser and writes each document as the indexers'
    TREC record."""
    from .collection.parsers import (
        Document,
        TrecTextParser,
        TrecWebParser,
        to_trec,
    )

    with open(args.text_file, encoding="utf-8") as fin, \
            open(args.output, "w", encoding="utf-8") as fout:
        if args.format == "lines":
            docs = (Document(f"{args.prefix}-{i:07d}", line.rstrip("\n"))
                    for i, line in enumerate(fin))
        else:
            cls = (TrecTextParser if args.format == "trectext"
                   else TrecWebParser)
            docs = iter(cls(fin))
        n = 0
        for doc in docs:
            fout.write(to_trec(doc))
            n += 1
    print(json.dumps({"docs_packed": n, "output": args.output,
                      "format": args.format}))
    return 0


def cmd_count(args) -> int:
    """A corpus's document count and its least and greatest docid."""
    from .collection import read_trec_corpus

    n = 0
    first = last = None
    for doc in read_trec_corpus(args.corpus):
        d = doc.docid
        first = d if first is None or d < first else first
        last = d if last is None or d > last else last
        n += 1
    print(json.dumps({"Count.DOCS": n, "min_docid": first,
                      "max_docid": last}))
    return 0


def cmd_docno(args) -> int:
    """The docno mapping: `list` (docno TAB docid a line), `getDocno
    DOCID` or `getDocid DOCNO`."""
    from .collection import DocnoMapping
    from .index import format as fmt

    mapping = DocnoMapping.load(os.path.join(args.index_dir, fmt.DOCNOS))
    if args.op != "list" and args.arg is None:
        print(f"usage: tpu-ir docno INDEX_DIR {args.op} "
              f"{'DOCID' if args.op == 'getDocno' else 'DOCNO'}",
              file=sys.stderr)
        return 1
    if args.op == "list":
        for docno in range(1, len(mapping) + 1):
            print(f"{docno}\t{mapping.get_docid(docno)}")
    elif args.op == "getDocno":
        try:
            print(mapping.get_docno(args.arg))
        except KeyError:
            print(f"docid {args.arg!r} not found", file=sys.stderr)
            return 1
    else:
        try:
            docno = int(args.arg)
        except ValueError:
            print(f"invalid docno {args.arg!r}", file=sys.stderr)
            return 1
        if not 1 <= docno <= len(mapping):
            print(f"docno {docno} out of range 1..{len(mapping)}",
                  file=sys.stderr)
            return 1
        print(mapping.get_docid(docno))
    return 0


def cmd_expand(args) -> int:
    """A glob pattern's vocabulary terms, one a line, or a fuzzy token's
    ('term~', 'term~0', 'term~2') as term and distance."""
    from .search.wildcard import MAX_FUZZY_EDITS, WildcardLookup

    lookup = WildcardLookup.load(args.index_dir, args.chargram_k)
    m = re.fullmatch(r"(.+?)~(\d?)", args.pattern)
    if m:
        d = min(int(m.group(2)) if m.group(2) else 1, MAX_FUZZY_EDITS)
        for term, dist in lookup.fuzzy(m.group(1), max_edits=d,
                                       limit=args.n):
            print(f"{term}\t{dist}")
        return 0
    for term in lookup.expand(args.pattern, limit=args.n):
        print(term)
    return 0


def cmd_eval(args) -> int:
    """A trec_eval-format run scored against qrels: MAP, MRR, NDCG@10,
    P@5, P@10 and recall@100 as one JSON line; exit 1 when no query was
    judged."""
    from .search.evaluate import evaluate_run, read_qrels, read_run

    out = evaluate_run(read_run(args.run), read_qrels(args.qrels),
                       complete=args.complete)
    print(json.dumps(out))
    return 0 if out.get("queries") else 1


def cmd_migrate_index(args) -> int:
    from .index.migrate import migrate_index

    if args.compress and args.decompress:
        print(json.dumps({"error": "--compress and --decompress are "
                                   "mutually exclusive"}))
        return 2
    to = 3 if args.compress else 2 if args.decompress else args.to
    print(json.dumps(migrate_index(args.index_dir, to_version=to,
                                   tf_dtype=args.tf_dtype,
                                   add_bounds=args.add_bounds)))
    return 0


def cmd_merge(args) -> int:
    """Merge built indexes into one, byte-identical to one build over the
    concatenated corpus (index/merge.py); prints the metadata."""
    from .index.merge import merge_indexes

    meta = merge_indexes(args.sources, args.out_dir, num_shards=args.shards,
                         compute_chargrams=not args.no_chargrams,
                         overwrite=args.overwrite, device=args.device)
    print(json.dumps(meta.__dict__))
    return 0


def cmd_warm(args) -> int:
    """Write the serving cache at deploy time instead of on the first
    load: one load that builds the layout and writes the cache (a miss,
    unless a cache is there already), then one that maps it; prints both
    loads' seconds."""
    import time

    from .search import Scorer
    from .search.layout import CACHE_NAME

    start_wall = time.time()
    t0 = time.perf_counter()
    scorer = Scorer.load(args.index_dir, layout=args.layout,
                         device=args.device)
    cold_s = time.perf_counter() - t0
    cache_dir = os.path.join(args.index_dir, CACHE_NAME)
    mtime = os.path.getmtime(cache_dir) if os.path.isdir(cache_dir) else 0
    t0 = time.perf_counter()
    warm = Scorer.load(args.index_dir, layout=args.layout,
                       device=args.device)
    warm_s = time.perf_counter() - t0
    print(json.dumps({
        "layout": scorer.layout,
        "cache_dir": CACHE_NAME,
        # written by this run (the dir's mtime), not left by an earlier one
        "cache_written": mtime >= start_wall - 1.0,
        "cold_load_s": round(cold_s, 2),
        "warm_load_s": round(warm_s, 2),
        "warm_skips_shards": (warm._pairs is None
                              and warm._host_pairs is None),
    }))
    return 0


def cmd_trace(args) -> int:
    """The distributed traces (obs/disttrace.py): with no id, the ids in
    this process's store and in the span spool (TPU_IR_TELEMETRY_DIR,
    where every process spools the traces it keeps); with an id, that
    trace stitched across processes, as a waterfall of indented spans on
    one timeline, each attempt marked with its verdict (won, lost,
    failed, cancelled, deadline), or with `--json` as the stitched
    structure."""
    from .obs import disttrace
    from .obs.aggregate import read_span_spool

    if not args.trace_id:
        ids = set(disttrace.trace_ids())
        for rec in read_span_spool():
            tid = rec.get("trace_id")
            if tid:
                ids.add(tid)
        print(json.dumps({"traces": sorted(ids)}))
        return 0
    st = disttrace.stitch(args.trace_id)
    if st is None:
        print(json.dumps({"error": "unknown_trace",
                          "trace_id": args.trace_id}))
        return 1
    if args.json:
        print(json.dumps(st, sort_keys=True, default=repr))
        return 0
    _print_trace_waterfall(st)
    return 0


def cmd_querylog(args) -> int:
    """This process's query log (obs/querylog.py): its settings and
    counts, the ring's entries and the slow captures (span tree and
    explain of each trapped query), as one JSON object; `--trace` keeps
    the entries of one distributed trace."""
    from .obs import querylog

    out = dict(querylog.summary())
    if not args.slow:
        out["entries"] = querylog.recent(args.n)
    out["slow_entries"] = querylog.slow_recent(args.n)
    if args.trace:
        out["trace_filter"] = args.trace
        for key in ("entries", "slow_entries"):
            if key in out:
                out[key] = [e for e in out[key]
                            if e.get("trace_id") == args.trace]
    print(json.dumps(out, sort_keys=True, default=repr))
    return 0


def cmd_trace_dump(args) -> int:
    """The flight recorder's artifact on demand (obs/recorder.py: the
    header, a line a trace of the ring, the telemetry snapshot), the
    shape a failure writes, as JSONL on standard output or in `--out`."""
    from .obs.recorder import artifact_lines

    lines = artifact_lines("manual_trace_dump")
    text = "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        # less the header and the telemetry line: the traces
        print(json.dumps({"traces": len(lines) - 2, "out": args.out}))
    else:
        sys.stdout.write(text)
    return 0


def _spooled_snapshots(args, command: str) -> list | None:
    """The spool's snapshots for `--cluster` (`--telemetry-dir`, else
    TPU_IR_TELEMETRY_DIR), the newest of each process; None, after
    tpu_ir's `error:` line for `command`, when no dir is set or it holds
    none."""
    from .obs import aggregate

    d = args.telemetry_dir or aggregate.spool_dir()
    snaps = aggregate.read_spool(d) if d else []
    if command == "stats" and not snaps:
        print("error: --cluster needs spooled telemetry "
              "(TPU_IR_TELEMETRY_DIR / --telemetry-dir)", file=sys.stderr)
        return None
    if not d:
        print("error: --cluster needs TPU_IR_TELEMETRY_DIR or "
              "--telemetry-dir", file=sys.stderr)
        return None
    if not snaps:
        print(f"error: no spooled telemetry under {d}", file=sys.stderr)
        return None
    return snaps


def cmd_stats(args) -> int:
    """This process's recovery and serving counters, the fault sites that
    fired, the pruning counters and the latency histograms, one JSON
    object in tpu_ir's shape, from one snapshot (`--reset` reads and
    zeroes it in one step). `--cluster`: the same sections over the
    spooled processes' merged snapshots, with `processes` and
    `per_process`."""
    from . import obs

    if args.cluster:
        from .obs import aggregate

        snaps = _spooled_snapshots(args, "stats")
        if snaps is None:
            return 1
        snap = aggregate.merge_snapshots(snaps)
        extra = {"processes": snap["processes"],
                 "per_process": snap["per_process"]}
    else:
        snap = obs.get_registry().snapshot(reset=args.reset)
        extra = {}

    def section(prefix: str) -> dict:
        n = len(prefix)
        return {k[n:]: v for k, v in snap["counters"].items()
                if k.startswith(prefix)}

    print(json.dumps({
        "recovery": section("recovery."),
        "serving": section("serving."),
        "fault_injection": {k: v for k, v in section("fault.").items()
                            if v},
        "pruning": {k: v for k, v in snap["counters"].items()
                    if k.startswith(("prune.", "blockmax."))},
        "histograms": snap["histograms"],
        **extra,
    }, sort_keys=True))
    return 0


def cmd_metrics(args) -> int:
    """The whole registry (counters, gauges, histograms) as one JSON
    object, or with `--prom` as Prometheus text; `--reset` zeroes it in
    the same step. `--cluster`: the spooled processes' snapshots merged
    (counters added, buckets added, gauges by their merge policy; this
    command's own empty registry left out)."""
    from . import obs

    if args.cluster:
        from .obs import aggregate

        snaps = _spooled_snapshots(args, "metrics")
        if snaps is None:
            return 1
        print(json.dumps(aggregate.merge_snapshots(snaps), sort_keys=True))
        return 0
    reg = obs.get_registry()
    if args.prom:
        sys.stdout.write(reg.prometheus_text(reset=args.reset))
    else:
        print(json.dumps(reg.snapshot(reset=args.reset), sort_keys=True))
    return 0


_SPARK_BLOCKS = "\u2581\u2582\u2583\u2584\u2585\u2586\u2587\u2588"


def _sparkline(values, width: int = 48) -> str:
    """A sparkline of unicode blocks over the last `width` values."""
    vs = list(values)[-width:]
    if not vs:
        return ""
    lo, hi = min(vs), max(vs)
    span = hi - lo
    if span <= 0:
        return _SPARK_BLOCKS[0] * len(vs)
    return "".join(
        _SPARK_BLOCKS[min(len(_SPARK_BLOCKS) - 1,
                          int((v - lo) / span * len(_SPARK_BLOCKS)))]
        for v in vs)


def cmd_top(args) -> int:
    """The telemetry time machine's terminal view (obs/timeseries.py): a
    line a curated series with its newest value, its range over the tier
    and a sparkline, then the last anomaly and the forecast fit. Reads
    this process's store, or a serving process's /timeseries with
    `--url`; `--watch N` draws N times `--interval` seconds apart;
    `--json` prints the /timeseries payload instead."""
    import time

    def fetch() -> dict:
        if args.url:
            import urllib.request

            url = args.url.rstrip("/") + "/timeseries"
            with urllib.request.urlopen(url, timeout=10.0) as r:
                return json.loads(r.read().decode("utf-8"))
        from .obs import timeseries

        return timeseries.payload()

    try:
        payload = fetch()
    except Exception as e:  # noqa: BLE001 — a dead server is the answer
        print(f"error: cannot read /timeseries: {e!r}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(payload, sort_keys=True))
        return 0
    tier = max(0, args.tier)
    for it in range(max(1, args.watch)):
        if it:
            time.sleep(args.interval)
            try:
                payload = fetch()
            except Exception as e:  # noqa: BLE001
                print(f"error: cannot read /timeseries: {e!r}",
                      file=sys.stderr)
                return 1
            print("\x1b[2J\x1b[H", end="")  # clear and home between draws
        if not payload.get("enabled"):
            print("timeseries disabled (TPU_IR_TIMESERIES=0)")
            return 0
        tiers = payload.get("tiers", [])
        if tier >= len(tiers):
            print(f"error: tier {tier} out of range "
                  f"(store has {len(tiers)})", file=sys.stderr)
            return 2
        t = tiers[tier]
        print(f"tpu-ir top \u2014 tier {tier} "
              f"({t['window_s']:g}s x {t['capacity']} windows, "
              f"{t['len']} held)")
        for label in sorted(payload.get("series", {})):
            vals = [v for _, v in payload["series"][label]["tiers"][tier]]
            if not vals:
                print(f"  {label:<24} (no data)")
                continue
            print(f"  {label:<24} {vals[-1]:>10.3f}  "
                  f"[{min(vals):.3f}..{max(vals):.3f}]  "
                  f"{_sparkline(vals)}")
        anomalies = payload.get("anomalies") or []
        if anomalies:
            a = anomalies[-1]
            print(f"  last anomaly: {a['series']} z={a['z']} "
                  f"value={a['value']} median={a['median']}")
        fit = payload.get("forecast")
        if fit:
            print(f"  forecast: period={fit['period_s']:g}s "
                  f"amplitude={fit['amplitude']:g} r2={fit['r2']:g} "
                  f"-> occupancy {fit.get('forecast', 0.0):g} "
                  f"in {fit.get('lead_s', 0.0):g}s")
    return 0


def cmd_profile(args) -> int:
    """The device-cost profiler's report (obs/profiling.py): cold calls
    by function and signature with their cost, the dispatch split, the
    memory gauges, the recompile window and the kernel-build ledger, one
    JSON object."""
    from .obs.profiling import profile_report

    print(json.dumps(profile_report(), sort_keys=True, default=repr))
    return 0


def cmd_cache(args) -> int:
    """The result caches (serving/result_cache.py): `stats` prints the
    cache.* counters and every live cache's size; `clear` also drops
    every live cache's entries and zeroes the cache.* counters."""
    from .obs import get_registry
    from .serving.result_cache import cache_counters, clear_all, live_caches

    out = {"counters": cache_counters(),
           "caches": [c.snapshot() for c in live_caches()]}
    if args.verb == "clear":
        out["cleared_entries"] = clear_all()
        get_registry().reset_counters("cache.")
        out["counters_reset"] = True
    print(json.dumps(out, sort_keys=True))
    return 0


def _print_trace_waterfall(st: dict) -> None:
    """One stitched trace as text: a line a span, indented by depth, its
    bar on the trace's timeline, its offset and duration, its service and
    the attempt's verdict."""
    t0 = st["start_ms"]
    total = max(st["dur_ms"], 1e-9)
    width = 40
    print(f"trace {st['trace_id']}  spans={st['span_count']}  "
          f"dur={st['dur_ms']}ms  services={','.join(st['services'])}")

    def walk(node: dict, depth: int) -> None:
        off = max(node.get("start_ms", t0) - t0, 0.0)
        dur = node.get("dur_ms", 0.0)
        lo = min(int(width * off / total), width - 1)
        ln = max(1, min(int(round(width * dur / total)), width - lo))
        bar = " " * lo + "#" * ln
        a = node.get("attrs", {})
        mark = ""
        if a.get("outcome"):
            mark = f" [{a['outcome']}{'+hedge' if a.get('hedge') else ''}]"
        if node.get("error"):
            mark += " [error]"
        label = "  " * depth + node.get("name", "?")
        print(f"{label:<34.34} |{bar:<{width}}| {off:9.2f}ms "
              f"{dur:8.2f}ms  {node.get('service', '?')}{mark}")
        for c in node.get("children", ()):
            walk(c, depth + 1)

    for r in st["roots"]:
        walk(r, 0)


def cmd_doctor(args) -> int:
    """The index health report (index/doctor.py) as one JSON object, its
    warnings on standard error; exits 0 on a readable index (a report,
    not a gate)."""
    from .index.doctor import doctor_report

    report = doctor_report(args.index_dir, top_terms=args.top)
    print(json.dumps(report, sort_keys=True))
    for w in report["warnings"]:
        print(f"doctor: warning: {w}", file=sys.stderr)
    return 0


def _workload_specs(args) -> list:
    """serve-bench's workload plan, one (label, spec) a run: the uniform
    workload is one run (spec None); `--workload zipf --skew S[,S...]`
    one run a skew level (skew 0 draws uniformly through the same
    model, so the levels' rows compare)."""
    from . import envvars

    kind = args.workload or envvars.get_choice("TPU_IR_WORKLOAD")
    if kind == "uniform":
        return [("uniform", None)]
    if args.skew is None:
        skews = [envvars.get_float("TPU_IR_WORKLOAD_SKEW")]
    else:
        skews = [float(p) for p in str(args.skew).split(",") if p.strip()]
        if not skews or any(s < 0 for s in skews):
            raise ValueError(
                f"--skew {args.skew!r}: expected a non-negative number "
                "or comma list like 0,0.7,1.1")
    return [(f"zipf{s:g}", {"kind": "zipf", "skew": s,
                            "burst": args.burst})
            for s in skews]


def _serve_routed(args) -> int:
    """serve-bench's scatter-gather mode: the distributed chaos soak
    (serving/soak.py::run_distributed_soak) over S x R worker processes
    behind the Router, once a workload skew level; prints the report (a
    `runs` list for several levels) with the row the JAX package would
    append to BENCH_HISTORY.jsonl (`history` null: no row is written).

    `--autoscale` runs each soak under the autoscaler (from R to R + 1
    replicas a shard: a warm grow on sustained pressure, a drain on
    sustained idleness), then a static control at the autoscaled run's
    mean replica count, same workload and seed; the row adds the scale
    events, burst p99 and overprovisioned share beside the control's
    burst p99. The elastic run must conserve and its burst p99 stay
    within 1.5x + 250 ms of the control's."""
    from .serving import run_distributed_soak
    from .serving.result_cache import resolve_capacity

    if args.shards < 1 or args.replicas < 1:
        print("--shards and --replicas must be >= 1", file=sys.stderr)
        return 2
    layout = "sparse" if args.layout == "auto" else args.layout
    if layout == "sharded":
        print("--shards mode runs one single-device scorer per worker; "
              "use --layout sparse or dense", file=sys.stderr)
        return 2
    try:
        specs = _workload_specs(args)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    cache_n = resolve_capacity(args.cache)
    reports = []
    ok = True
    re_cfg = None
    fc_cfg = None
    if args.autoscale:
        import dataclasses

        from .serving.autoscale import AutoscaleConfig

        # one config for the reactive and the forecast arms: the forecast
        # arm differs by the third signal alone
        re_cfg = AutoscaleConfig(
            min_replicas=args.replicas, max_replicas=args.replicas + 1,
            cooldown_s=0.5, up_occupancy=0.45, down_occupancy=0.1,
            sustain_up=5, sustain_down=50, drain_timeout_s=15.0)
        fc_cfg = dataclasses.replace(
            re_cfg, forecast_up=re_cfg.up_occupancy,
            forecast_lead_s=args.lead)

    def soak(spec, replicas, autoscale=False):
        return run_distributed_soak(
            args.index_dir, shards=args.shards, replicas=replicas,
            threads=args.threads, queries=args.queries, seed=args.seed,
            layout=layout, chaos=args.chaos,
            worker_deadline_s=(1.0 if args.deadline is None
                               else args.deadline),
            timeout_s=args.timeout, workload=spec,
            cache_entries=args.cache, device=args.device,
            autoscale=autoscale, flight_dir=args.flight_dir,
            **({} if args.pacing is None else {"pacing_s": args.pacing}))

    for label, spec in specs:
        report = soak(spec, args.replicas, autoscale=re_cfg or False)
        static = None
        forecast = None
        if args.autoscale:
            # the forecast arm: the same fleet, workload and seed with the
            # third signal armed (the soak drives the diurnal fit over the
            # occupancy series); each arm's lead on the first crest and
            # its burst p99 are recorded side by side
            forecast = soak(spec, args.replicas, autoscale=fc_cfg)
            report["forecast_arm"] = {
                "burst_p99_ms": forecast["burst_p99_ms"],
                "served": forecast["served"],
                "shed": forecast["shed"],
                "errors": forecast["errors"],
                "scale": {k: forecast["scale"].get(k)
                          for k in ("events", "first_up_s",
                                    "first_up_reason", "first_up_frac",
                                    "first_peak_s", "forecast_lead_s")},
            }
            # the control: a static fleet at the elastic run's mean
            # replica count, the same workload and seed
            ctrl_replicas = max(1, int(round(
                report["scale"]["mean_replicas"])))
            static = soak(spec, ctrl_replicas)
            report["static_control"] = {
                "replicas": ctrl_replicas,
                "burst_p99_ms": static["burst_p99_ms"],
                "served": static["served"], "shed": static["shed"],
                "errors": static["errors"]}
        p99 = (report["latency"].get("router.request") or {}).get("p99_ms")
        row = {
            # chaos, each workload and cache on or off are separate
            # comparability groups
            "config": (f"serve_routed-{report['submitted']}q-"
                       f"s{args.shards}r{args.replicas}"
                       + ("-chaos" if args.chaos else "")
                       + ("" if label == "uniform" else f"-{label}")
                       + ("-autoscale" if args.autoscale else "")
                       + (f"-c{cache_n}" if cache_n else "")),
            "backend": args.device,
            "shards": args.shards,
            "replicas": args.replicas,
            "workload": label,
            "cache_entries": cache_n,
            "routed_qps": (round(report["served"] / report["wall_s"], 1)
                           if report["wall_s"] else -1.0),
            "routed_p99_ms": -1.0 if p99 is None else p99,
            "cache_hit_fraction": report["cache"]["hit_fraction"],
            "partial_fraction": report["partial_fraction"],
            "hedge_fired": report["router"].get("router.hedge_fired", 0),
            "recovery_full": report["recovery_full"],
        }
        if static is not None:
            row["scale_events"] = report["scale"]["events"]
            row["burst_p99_ms"] = report["burst_p99_ms"]
            row["overprovision_fraction"] = (
                report["scale"]["overprovision_fraction"])
            row["mean_replicas"] = report["scale"]["mean_replicas"]
            row["static_replicas"] = report["static_control"]["replicas"]
            row["static_burst_p99_ms"] = static["burst_p99_ms"]
            row["forecast_burst_p99_ms"] = forecast["burst_p99_ms"]
            row["forecast_lead_s"] = forecast["scale"].get(
                "forecast_lead_s", -1.0)
            row["reactive_lead_s"] = report["scale"].get(
                "forecast_lead_s", -1.0)
        report["history"] = None
        report["history_row"] = row
        reports.append(report)
        ok = ok and (
            report["errors"] == 0 and report["deadlocked"] == 0
            and report["full_mismatches"] == 0
            and report["partial_mismatches"] == 0
            and report["served"] + report["shed"] == report["submitted"])
        if static is not None:
            # the control conserves too, and elasticity must not lose to
            # equal static spend at the burst (a loose smoke bound)
            ok = ok and (
                static["errors"] == 0 and static["deadlocked"] == 0
                and static["served"] + static["shed"] == static["submitted"])
            if static["burst_p99_ms"] > 0:
                ok = ok and (report["burst_p99_ms"]
                             <= static["burst_p99_ms"] * 1.5 + 250.0)
        if forecast is not None:
            # the forecast arm conserves too, and its burst p99 must not
            # lose to the reactive arm's (the same loose bound)
            ok = ok and (
                forecast["errors"] == 0 and forecast["deadlocked"] == 0
                and forecast["served"] + forecast["shed"]
                == forecast["submitted"])
            if report["burst_p99_ms"] > 0:
                ok = ok and (forecast["burst_p99_ms"]
                             <= report["burst_p99_ms"] * 1.5 + 250.0)
    out = reports[0] if len(reports) == 1 else {
        "runs": reports,
        "levels": [r["history_row"]["workload"] for r in reports]}
    print(json.dumps(out, sort_keys=True, default=repr))
    return 0 if ok else 1


def cmd_serve_bench(args) -> int:
    """The soak (`serving/soak.py::run_soak`) through a ServingFrontend,
    optionally under the chaos plan, or with `--concurrency N,N,...` the
    concurrency sweep; `--shards N` runs the distributed chaos soak
    (`_serve_routed`). Prints the JSON report. `--metrics-port` serves
    the process's telemetry while it runs."""
    if args.autoscale and args.shards is None:
        print("--autoscale needs --shards N: the elastic topology is "
              "the routed worker fleet", file=sys.stderr)
        return 2
    if args.shards is not None:
        with _MaybeTrack(args.metrics_port):
            return _serve_routed(args)
    try:
        levels = [int(p) for p in str(args.concurrency).split(",")
                  if p.strip()]
        if any(n < 1 for n in levels):
            raise ValueError
    except ValueError:
        print(f"--concurrency {args.concurrency!r}: expected a positive "
              "integer or a comma list like 1,4,16", file=sys.stderr)
        return 2
    if not levels:
        levels = [4]
    try:
        wl_specs = _workload_specs(args)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if len(wl_specs) > 1:
        print("a multi-skew sweep records per-skew ROUTED rows; use "
              "--shards N with --skew 0,0.7,1.1 (the single-process "
              "soak takes one skew)", file=sys.stderr)
        return 2
    workload = wl_specs[0][1]
    if len(levels) > 1 and workload is not None:
        # the sweep draws its own fixed query set
        print("--concurrency sweep and --workload zipf are exclusive: "
              "the sweep measures coalescing under a fixed query set; "
              "use the soak (single --concurrency) for traffic shapes",
              file=sys.stderr)
        return 2
    with _MaybeTrack(args.metrics_port):
        return _serve_one(args, levels, workload)


def _serve_one(args, levels: list, workload) -> int:
    """serve-bench in one process: the concurrency sweep for several
    levels, else the soak at the one level."""
    from . import faults
    from .search import Scorer
    from .serving import (
        DEFAULT_CHAOS_PLAN,
        ServingConfig,
        run_concurrency_sweep,
        run_soak,
    )

    scorer = Scorer.load(args.index_dir, layout=args.layout,
                         device=args.device)
    if len(levels) > 1:
        report = run_concurrency_sweep(
            scorer, levels=tuple(levels), queries_per_level=args.queries,
            seed=args.seed, coalesce=args.coalesce != "off",
            deadline_s=args.deadline)
        print(json.dumps(report, sort_keys=True, default=repr))
        return 0 if all(lv["errors"] == 0
                        for lv in report["levels"]) else 1
    spec = DEFAULT_CHAOS_PLAN if args.chaos else None
    # a TPU_IR_FAULTS plan drives the chaos phase; run_soak installs it
    # itself, after its clean reference run. install(None), not clear():
    # clear() would read the variable again inside run_soak
    if faults.active() is not None:
        from . import envvars

        spec = envvars.get_str("TPU_IR_FAULTS")
        faults.install(None)
    report = run_soak(
        scorer, threads=args.threads, queries=args.queries,
        seed=args.seed, fault_spec=spec,
        config=ServingConfig(
            max_concurrency=levels[0], max_queue=args.queue_depth,
            # the soak's 0.25 s default; the sweep defaults to none
            deadline_s=0.25 if args.deadline is None else args.deadline,
            breaker_threshold=args.breaker_threshold,
            coalesce=(args.coalesce == "on"),
            cache_entries=args.cache),
        timeout_s=args.timeout, flight_dir=args.flight_dir,
        workload=workload)
    # the soak's query-log view: its counts and the last slow captures
    from .obs import querylog

    report["querylog"] = {**querylog.summary(),
                          "slow_entries": querylog.slow_header_entries()}
    print(json.dumps(report, sort_keys=True, default=repr))
    ok = (report["errors"] == 0 and report["deadlocked"] == 0
          and report["untagged_mismatches"] == 0
          and report["served"] + report["shed"] == report["submitted"])
    return 0 if ok else 1


def cmd_scale(args) -> int:
    """The autoscaler's configuration as an Autoscaler would resolve it
    (TPU_IR_AUTOSCALE and the TPU_IR_SCALE_* knobs) and, with `--url`, a
    serving process's /healthz autoscaler section: the epoch, each
    replica's lifecycle, the hysteresis counters and the last decision
    with its reason. One JSON object on stdout."""
    from .serving.autoscale import AutoscaleConfig, autoscale_enabled

    cfg = AutoscaleConfig().resolved()
    out = {
        "enabled": autoscale_enabled(),
        "config": {
            "min_replicas": cfg.min_replicas,
            "max_replicas": cfg.max_replicas,
            "cooldown_s": cfg.cooldown_s,
            "up_occupancy": cfg.up_occupancy,
            "down_occupancy": cfg.down_occupancy,
            "sustain_up": cfg.sustain_up,
            "sustain_down": cfg.sustain_down,
            "drain_timeout_s": cfg.drain_timeout_s,
        },
    }
    if args.url:
        import urllib.request

        url = args.url.rstrip("/") + "/healthz"
        try:
            with urllib.request.urlopen(url, timeout=10.0) as r:
                payload = json.loads(r.read().decode("utf-8"))
        except Exception as e:  # noqa: BLE001 — a dead server is the
            # answer here, not a traceback
            print(f"error: cannot read {url}: {e!r}", file=sys.stderr)
            return 1
        out["live"] = payload.get("autoscaler") or {
            "error": "no autoscaler registered in that process"}
    print(json.dumps(out, sort_keys=True))
    return 0


# commands whose whole job is loading artifacts the user named: only for
# these does a FileNotFoundError mean a wrong path (one `error:` line, as
# tpu_ir's command line prints); elsewhere it keeps its traceback
_ARTIFACT_ENTRY_CMDS = frozenset({
    "cmd_search", "cmd_inspect", "cmd_verify", "cmd_warm", "cmd_docno",
    "cmd_expand", "cmd_eval", "cmd_count", "cmd_pack", "cmd_merge",
    "cmd_serve_bench", "cmd_migrate_index", "cmd_doctor",
    "cmd_generations", "cmd_backup",
})


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="tpu-ir-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build the index artifacts of a "
                                      "TREC corpus")
    pi.add_argument("corpus", nargs="+", help="TREC files or directories")
    pi.add_argument("index_dir")
    pi.add_argument("--k", type=int, default=1, help="term-k-gram size")
    pi.add_argument("--chargram-k", type=int, nargs="*", default=[2, 3])
    pi.add_argument("--shards", type=int, default=10,
                    help="term shards (reference used 10 reducers)")
    pi.add_argument("--overwrite", action="store_true")
    pi.add_argument("--no-chargrams", action="store_true")
    pi.add_argument("--streaming", action="store_true",
                    help="out-of-core spill/merge build for corpora larger "
                         "than memory")
    pi.add_argument("--batch-docs", type=int, default=50000,
                    help="streaming: documents per tokenize batch")
    pi.add_argument("--radix-buckets", type=int, default=None, metavar="B",
                    help="streaming: radix-partition pass-1 pair spills "
                         "into B buckets so pass 2 runs as per-bucket "
                         "local device reduces (default: "
                         "$TPU_IR_RADIX_BUCKETS, 16; 0 = per-batch combine; "
                         "artifacts are bit-identical either way)")
    pi.add_argument("--tokenize-procs", type=int, default=None, metavar="N",
                    help="worker processes for the pure-Python tokenizer "
                         "path (default: $TPU_IR_TOKENIZE_PROCS; the "
                         "native tokenizer is one C++ pass)")
    pi.add_argument("--store", action="store_true",
                    help="also build the compressed document-text store "
                         "(enables search --snippets)")
    pi.add_argument("--positions", action="store_true",
                    help="format v2: also write per-posting position runs "
                         "(enables \"quoted phrase\" and --prox queries)")
    pi.add_argument("--track", type=int, default=None, metavar="PORT",
                    help="serve live build progress over HTTP for the "
                         "duration of the build (/jobs /healthz /flight; "
                         "0 = ephemeral port, announced on stderr)")
    pi.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pi.set_defaults(fn=cmd_index)

    pn = sub.add_parser(
        "inspect",
        help="dump index records, or any framework artifact: part and "
             "positions shards, build spills, pass-1 manifests, serving "
             "caches, the document store, npy/json/tsv side files")
    pn.add_argument("index_dir", metavar="path",
                    help="index dir, artifact file, or artifact dir")
    pn.add_argument("-n", type=int, default=20,
                    help="max terms / records to print")
    pn.add_argument("--postings", type=int, default=10,
                    help="max postings per term")
    pn.add_argument("--term", default=None,
                    help="the term, analyzed like a query")
    pn.set_defaults(fn=cmd_inspect)

    pv = sub.add_parser("verify", help="validate index structural invariants")
    pv.add_argument("index_dir")
    pv.set_defaults(fn=cmd_verify)

    ps = sub.add_parser(
        "search",
        help="query an index (REPL or batch); glob tokens like te* and "
             "fuzzy tokens like tem~ expand over the char-k-gram index "
             "(OR of up to 64 matching terms)")
    ps.add_argument("index_dir")
    ps.add_argument("--query", "-q")
    ps.add_argument("--queries-file")
    ps.add_argument("--topics", metavar="FILE", default=None,
                    help="TREC topics file (<top>/<num>/<title> records); "
                         "titles become the queries, topic numbers the "
                         "qids for --trec-run")
    ps.add_argument("--k", "-k", type=int, default=10,
                    help="results per query")
    ps.add_argument("--scoring", choices=["tfidf", "bm25"], default="tfidf")
    ps.add_argument("--rerank", type=int, default=None, metavar="N",
                    help="two-stage retrieval: BM25 top-N candidates, then "
                         "cosine TF-IDF rerank")
    ps.add_argument("--prox", action="store_true",
                    help="add the positions-based proximity boost to the "
                         "rerank (needs an index built with --positions)")
    ps.add_argument("--slop", type=int, default=0, metavar="S",
                    help="\"quoted phrase\" matching tolerates S extra "
                         "token gaps (0 = exact adjacency)")
    ps.add_argument("--show-matches", action="store_true",
                    help="print each hit's query-term token positions "
                         "(needs an index built with --positions)")
    ps.add_argument("--snippets", action="store_true",
                    help="print a query-highlighted text window per hit "
                         "(needs an index built with --store)")
    ps.add_argument("--layout",
                    choices=["auto", "dense", "sparse", "sharded"],
                    default="auto",
                    help="'auto' serves the dense matrix up to "
                         "DENSE_BUDGET elements and the tiered sparse "
                         "layout above it; 'sharded' is a later slice")
    ps.add_argument("--docnos", action="store_true",
                    help="print docnos instead of docids")
    ps.add_argument("--compat", action="store_true",
                    help="reproduce reference quirks (int-division idf, "
                         "1-2 word query cap)")
    ps.add_argument("--trec-run", metavar="TAG", default=None,
                    help="emit standard trec_eval run lines "
                         "('qid Q0 docid rank score TAG'; qids are "
                         "1-based query positions) instead of the "
                         "human-readable listing")
    ps.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ps.set_defaults(fn=cmd_search)

    px = sub.add_parser("expand", help="wildcard term lookup (char-k-grams)")
    px.add_argument("index_dir")
    px.add_argument("pattern", help="glob pattern, e.g. 'te*' or '*tion'; "
                                    "or a fuzzy token, e.g. 'tem~'")
    px.add_argument("--chargram-k", type=int, default=3)
    px.add_argument("-n", type=int, default=50)
    px.set_defaults(fn=cmd_expand)

    pe = sub.add_parser("eval", help="score a trec_eval-format run file "
                                     "against qrels (MAP/MRR/NDCG@10/...)")
    pe.add_argument("run", help="run file (qid Q0 docid rank score tag)")
    pe.add_argument("qrels", help="qrels file (qid 0 docid rel)")
    pe.add_argument("--complete", action="store_true",
                    help="average over every qrels qid, scoring qids "
                         "missing from the run as zero (trec_eval -c)")
    pe.set_defaults(fn=cmd_eval)

    pm = sub.add_parser(
        "migrate-index",
        help="convert part shards between artifact formats in place "
             "(npz v1 <-> arena v2 <-> compressed v3; atomic per shard, "
             "checksums re-recorded, idempotent)")
    pm.add_argument("index_dir")
    pm.add_argument("--to", type=int, choices=[1, 2, 3], default=2,
                    help="target format_version (3 = compressed arenas, "
                         "2 = raw arenas, 1 = npz rollback)")
    pm.add_argument("--compress", action="store_true",
                    help="rewrite the parts as compressed arenas (v3)")
    pm.add_argument("--decompress", action="store_true",
                    help="walk a compressed index back to raw arenas (v2; "
                         "byte-identical when the tf mode was lossless)")
    pm.add_argument("--tf-dtype", choices=["auto", "int8", "bf16"],
                    default="auto",
                    help="tf encoding for --compress: auto = int8 when "
                         "lossless in every shard, else bf16")
    pm.add_argument("--add-bounds", action="store_true",
                    help="backfill the block-max bounds artifact "
                         "(blockmax.arena) from the postings in place — "
                         "no part rewrite, idempotent, verify-clean")
    pm.set_defaults(fn=cmd_migrate_index)

    pg = sub.add_parser("merge", help="merge built indexes into one "
                                      "(same artifacts as one build over "
                                      "the concatenated corpus)")
    pg.add_argument("sources", nargs="+", help="source index dirs")
    pg.add_argument("out_dir", help="output index dir")
    pg.add_argument("--shards", type=int, default=10)
    pg.add_argument("--no-chargrams", action="store_true")
    pg.add_argument("--overwrite", action="store_true",
                    help="delete an existing output index first")
    pg.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pg.set_defaults(fn=cmd_merge)

    pw = sub.add_parser("warm", help="write the serving cache (tiered "
                                     "layout, df and rerank norms) so later "
                                     "process starts take the fast path")
    pw.add_argument("index_dir")
    pw.add_argument("--layout", choices=["auto", "dense", "sparse",
                                         "sharded"],
                    default="sparse")
    pw.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pw.set_defaults(fn=cmd_warm)

    pdr = sub.add_parser(
        "doctor", help="index health report: df skew, per-shard "
                       "term/doc balance, tier occupancy, arena section "
                       "sizes, serving caches, block-max bounds, heuristic "
                       "warnings")
    pdr.add_argument("index_dir")
    pdr.add_argument("--top", type=int, default=10,
                     help="top-N terms by df to list")
    pdr.set_defaults(fn=cmd_doctor)

    pb = sub.add_parser(
        "serve-bench",
        help="soak: mixed multi-threaded traffic through the serving "
             "frontend (admission control, degradation ladder, circuit "
             "breaker), optionally under the chaos plan; or, with a comma "
             "list of --concurrency levels, the concurrency sweep")
    pb.add_argument("index_dir")
    pb.add_argument("--threads", type=int, default=8,
                    help="concurrent client threads of the soak")
    pb.add_argument("--queries", type=int, default=240,
                    help="queries across all threads (the sweep: per "
                         "level)")
    pb.add_argument("--seed", type=int, default=0,
                    help="workload and chaos seed")
    pb.add_argument("--concurrency", default="4",
                    help="admission: requests executing at once; a comma "
                         "list (e.g. 1,4,16) runs the concurrency sweep, "
                         "one closed-loop pass per level")
    pb.add_argument("--queue-depth", type=int, default=8,
                    help="admission: requests waiting for a slot before "
                         "arrivals shed")
    pb.add_argument("--deadline", type=float, default=None,
                    help="per-request device dispatch deadline (s); "
                         "default 0.25 for the soak, none for the sweep")
    pb.add_argument("--coalesce", choices=["auto", "on", "off"],
                    default="auto",
                    help="the coalescer: auto = off for the soak, on for "
                         "the sweep")
    pb.add_argument("--breaker-threshold", type=int, default=4,
                    help="consecutive device failures that open the "
                         "circuit breaker")
    pb.add_argument("--cache", type=int, default=None, metavar="N",
                    help="exact-hit result cache entries (0 disables; "
                         "default: TPU_IR_CACHE_RESULTS)")
    pb.add_argument("--flight-dir", default=None,
                    help="where an invariant breach writes its "
                         "flight-recorder JSONL (default: "
                         "TPU_IR_FLIGHT_DIR or the system temp dir)")
    pb.add_argument("--timeout", type=float, default=300.0,
                    help="the soak's wall-clock bound (s); requests still "
                         "pending past it count as deadlocked")
    pb.add_argument("--chaos", action="store_true",
                    help="inject the default chaos plan (hangs and device "
                         "losses at the score dispatch); TPU_IR_FAULTS "
                         "overrides it. With --shards the chaos is process "
                         "kills: a replica, then a whole shard, then the "
                         "respawn")
    pb.add_argument("--shards", type=int, default=None, metavar="N",
                    help="scatter-gather mode (serving/router.py): N "
                         "doc-shard worker processes behind the Router, "
                         "the distributed soak instead of the "
                         "single-process one")
    pb.add_argument("--replicas", type=int, default=1, metavar="R",
                    help="replicas a shard in --shards mode (failover "
                         "and hedging need R >= 2)")
    pb.add_argument("--autoscale", action="store_true",
                    help="elastic --shards mode (serving/autoscale.py): "
                         "the routed soak under the autoscaler (a warm "
                         "grow on sustained pressure, a drain on "
                         "sustained idleness), then a static control at "
                         "its mean replica count")
    pb.add_argument("--lead", type=float, default=1.0, metavar="S",
                    help="the forecast horizon (s) of --autoscale's "
                         "forecast arm: the diurnal fit publishes the "
                         "occupancy predicted this far ahead, so its "
                         "scale-up leads the burst by about as much "
                         "(live serving reads TPU_IR_SCALE_LEAD_S)")
    pb.add_argument("--pacing", type=float, default=None, metavar="S",
                    help="mean inter-arrival pacing unit (s) of the routed "
                         "soak; raise it so arrivals, not service time, "
                         "set the occupancy wave (default: the soak's "
                         "0.002)")
    pb.add_argument("--workload", choices=["uniform", "zipf"],
                    default=None,
                    help="traffic (serving/workload.py): uniform, or zipf "
                         "(rank-skewed over the df-ordered vocabulary); "
                         "default TPU_IR_WORKLOAD")
    pb.add_argument("--skew", default=None, metavar="S[,S...]",
                    help="Zipf exponent(s) of --workload zipf; a comma "
                         "list in --shards mode runs one soak a level "
                         "(default TPU_IR_WORKLOAD_SKEW)")
    pb.add_argument("--burst", type=float, default=None,
                    help="diurnal burst amplitude of the arrival pacing "
                         "(default TPU_IR_WORKLOAD_BURST)")
    pb.add_argument("--layout",
                    choices=["auto", "dense", "sparse", "sharded"],
                    default="auto")
    pb.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pb.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve live telemetry over HTTP while the soak, "
                         "the sweep or the routed soak runs (/metrics "
                         "/profile /doctor /healthz /jobs /flight; 0 = a "
                         "free port, announced on stderr)")
    pb.set_defaults(fn=cmd_serve_bench)

    psw = sub.add_parser(
        "serve-worker",
        help="a shard worker: serve one doc shard's /rpc surface on a "
             "port until SIGTERM (or --run-for)")
    psw.add_argument("index_dir")
    psw.add_argument("--shard", required=True, metavar="i/S",
                     help="this worker's shard index and the shard count, "
                          "e.g. 0/4 (every worker derives the same doc "
                          "partition)")
    psw.add_argument("--port", type=int, default=0,
                     help="listen port (0 = a free one, given in the "
                          "ready JSON)")
    psw.add_argument("--host", default="127.0.0.1",
                     help="bind address (the default is reachable from "
                          "this machine only)")
    psw.add_argument("--replica", type=int, default=0,
                     help="replica index within the shard (identity only; "
                          "shown in /healthz)")
    psw.add_argument("--layout", choices=["auto", "dense", "sparse"],
                     default="auto")
    psw.add_argument("--deadline", type=float, default=None,
                     help="per-request device dispatch deadline (s)")
    psw.add_argument("--concurrency", type=int, default=4,
                     help="admission: requests executing at once")
    psw.add_argument("--queue-depth", type=int, default=16,
                     help="admission: requests waiting for a slot")
    psw.add_argument("--no-warm", action="store_true",
                     help="skip the shape warm-up and the residency hint")
    psw.add_argument("--run-for", type=float, default=None, metavar="S",
                     help="serve for S seconds, then exit (default: until "
                          "SIGTERM or Ctrl-C)")
    psw.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    psw.set_defaults(fn=cmd_serve_worker)

    psc = sub.add_parser(
        "scale",
        help="the autoscaler's resolved configuration and, with --url, a "
             "serving process's /healthz autoscaler section")
    psc.add_argument("--url", default=None, metavar="URL",
                     help="base URL of a live serving process's metrics "
                          "server (e.g. http://127.0.0.1:8123)")
    psc.set_defaults(fn=cmd_scale)

    pin = sub.add_parser(
        "ingest",
        help="live index writes: buffered add/update/delete flushed to "
             "delta segments and tombstones, tiered merges, compaction")
    pin.add_argument("live_dir", help="live index dir (see --init)")
    pin.add_argument("--init", action="store_true",
                     help="create the live dir first if it is not one "
                          "yet (pins k/shards/chargrams for every "
                          "future segment)")
    pin.add_argument("--add", nargs="*", default=[], metavar="TREC",
                     help="TREC corpus file(s) to ADD (a docid that "
                          "already exists is an error — use --update)")
    pin.add_argument("--update", nargs="*", default=[], metavar="TREC",
                     help="TREC corpus file(s) to UPSERT (existing "
                          "copies are tombstoned)")
    pin.add_argument("--delete", nargs="*", default=[], metavar="DOCID",
                     help="docids to tombstone (unknown ids are ignored)")
    pin.add_argument("--merge", action="store_true",
                     help="run one tiered-merge step if any size tier "
                          "carries merge debt")
    pin.add_argument("--compact", action="store_true",
                     help="full compaction: one segment, no tombstones — "
                          "the generation serving swaps to (the "
                          "checksums of a one-shot build of the "
                          "surviving docs)")
    pin.add_argument("--gc", action="store_true",
                     help="prune generations past "
                          "TPU_IR_INGEST_KEEP_GENERATIONS and delete "
                          "unreferenced segment dirs")
    pin.add_argument("--buffer-docs", type=int, default=None,
                     help="auto-flush threshold (default: "
                          "TPU_IR_INGEST_BUFFER_DOCS)")
    pin.add_argument("--no-auto-merge", action="store_true",
                     help="skip the post-flush tiered-merge check")
    pin.add_argument("--k", type=int, default=1,
                     help="--init: term-k-gram size (live indexes "
                          "support k=1 only)")
    pin.add_argument("--shards", type=int, default=10,
                     help="--init: term shards per segment")
    pin.add_argument("--chargram-k", type=int, nargs="*",
                     default=[2, 3], help="--init: char-gram sizes")
    pin.add_argument("--swap-bench", action="store_true",
                     help="run the ingest->compact->swap micro-bench "
                          "against live_dir (created if missing) and "
                          "print swap_gap_ms (no history row is written)")
    pin.add_argument("--soak-bench", action="store_true",
                     help="the durable ingest+serve soak against live_dir "
                          "(created if missing): a feeder child SIGKILLed "
                          "mid-feed, its successor's recovery; prints "
                          "ingest_docs_per_s and freshness_lag_ms (no "
                          "history row is written)")
    pin.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pin.set_defaults(fn=cmd_ingest)

    pco = sub.add_parser(
        "compact",
        help="drive live-index merges explicitly (the TPU_IR_MERGE_AUTO"
             "=0 companion): drain the tiered merge policy's debt, or "
             "--all for full compaction into one segment")
    pco.add_argument("live_dir")
    pco.add_argument("--all", action="store_true",
                     help="full compaction (every segment and tombstone "
                          "folded into one servable segment)")
    pco.add_argument("--max-steps", type=int, default=64,
                     help="bound on tiered merge steps when draining")
    pco.add_argument("--gc", action="store_true",
                     help="prune old generation manifests and "
                          "unreferenced segment dirs afterwards")
    pco.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pco.set_defaults(fn=cmd_compact)

    pgen = sub.add_parser(
        "generations",
        help="list a live index's generation chain: segments, doc "
             "counts, tombstones, servability")
    pgen.add_argument("live_dir")
    pgen.add_argument("-n", type=int, default=None,
                      help="newest N generations only")
    pgen.add_argument("--gc", action="store_true",
                      help="prune old generations and unreferenced "
                           "segments after listing")
    pgen.set_defaults(fn=cmd_generations)

    pbk = sub.add_parser(
        "backup",
        help="generation-pinned hardlink snapshot of a live dir "
             "(current manifest, referenced segments, WAL tail) — or, "
             "with --restore, materialize and verify a snapshot into a "
             "new dir")
    pbk.add_argument("src", help="live dir to snapshot (or, with "
                                 "--restore, the backup to restore)")
    pbk.add_argument("dest", help="destination dir (must not exist or "
                                  "be empty)")
    pbk.add_argument("--restore", action="store_true",
                     help="treat src as a backup: link/copy it into "
                          "dest and run verify_live on the result")
    pbk.set_defaults(fn=cmd_backup)

    pp = sub.add_parser("pack", help="pack plain text into TREC format "
                                     "(one <DOC> per input line), or "
                                     "canonicalize trectext/trecweb corpora")
    pp.add_argument("text_file")
    pp.add_argument("output", help="TREC file to write")
    pp.add_argument("--prefix", default="LINE", help="docid prefix")
    pp.add_argument("--format", choices=["lines", "trectext", "trecweb"],
                    default="lines",
                    help="'trectext' keeps only the known section tags' "
                         "content; 'trecweb' parses <DOCHDR> records and "
                         "scrubs the URL")
    pp.set_defaults(fn=cmd_pack)

    pc = sub.add_parser("count", help="count documents in a corpus")
    pc.add_argument("corpus", nargs="+")
    pc.set_defaults(fn=cmd_count)

    ptr = sub.add_parser(
        "trace", help="distributed request traces: list known trace ids "
                      "(store + TPU_IR_TELEMETRY_DIR span spool), or "
                      "stitch one id's cross-process waterfall")
    ptr.add_argument("trace_id", nargs="?", default=None,
                     help="trace id to stitch (omit to list)")
    ptr.add_argument("--json", action="store_true",
                     help="print the stitched span tree as JSON instead "
                          "of the ASCII waterfall")
    ptr.set_defaults(fn=cmd_trace)

    pql = sub.add_parser(
        "querylog", help="dump the sampled query log: per-request "
                         "entries (terms/hash, level, stage split, "
                         "top-k, prune decision) + slow-query captures")
    pql.add_argument("-n", type=int, default=None,
                     help="newest N entries only (default: the whole "
                          "ring)")
    pql.add_argument("--slow", action="store_true",
                     help="slow-query captures only (span tree + "
                          "explain of trapped offenders)")
    pql.add_argument("--trace", default=None, metavar="TRACE_ID",
                     help="only entries recorded under this distributed "
                          "trace id (the `trace` join key)")
    pql.set_defaults(fn=cmd_querylog)

    ptd = sub.add_parser(
        "trace-dump", help="dump the flight-recorder ring (recent span "
                           "trees) + a telemetry snapshot as JSONL")
    ptd.add_argument("--out", default=None,
                     help="write the JSONL here instead of stdout")
    ptd.set_defaults(fn=cmd_trace_dump)

    pst = sub.add_parser(
        "stats", help="dump the process-wide recovery + serving counters, "
                      "fault-plan fire counts and latency histograms as "
                      "JSON")
    pst.add_argument("--reset", action="store_true",
                     help="zero the telemetry registry after reading "
                          "(per-interval scrapes instead of lifetime "
                          "counts)")
    pst.add_argument("--cluster", action="store_true",
                     help="merge the spooled per-process snapshots "
                          "(TPU_IR_TELEMETRY_DIR) into cluster totals "
                          "instead of reading this process's registry")
    pst.add_argument("--telemetry-dir", default=None, metavar="DIR",
                     help="spool directory for --cluster (default: "
                          "TPU_IR_TELEMETRY_DIR)")
    pst.set_defaults(fn=cmd_stats)

    pmx = sub.add_parser(
        "metrics", help="dump the unified TelemetryRegistry (counters, "
                        "gauges, latency histograms) as JSON, or "
                        "Prometheus text with --prom")
    pmx.add_argument("--prom", action="store_true",
                     help="Prometheus text exposition format")
    pmx.add_argument("--reset", action="store_true",
                     help="zero the telemetry registry after reading")
    pmx.add_argument("--cluster", action="store_true",
                     help="merge the spooled per-process snapshots "
                          "(TPU_IR_TELEMETRY_DIR) into cluster totals "
                          "instead of reading this process's registry")
    pmx.add_argument("--telemetry-dir", default=None, metavar="DIR",
                     help="spool directory for --cluster (default: "
                          "TPU_IR_TELEMETRY_DIR)")
    pmx.set_defaults(fn=cmd_metrics)

    ptp = sub.add_parser(
        "top",
        help="terminal view of the telemetry time machine "
             "(obs/timeseries.py): a sparkline a curated series off this "
             "process's store or a serving process's /timeseries (--url)")
    ptp.add_argument("--url", default=None, metavar="URL",
                     help="base URL of a serving process's telemetry "
                          "server; default: this process's store")
    ptp.add_argument("--tier", type=int, default=0,
                     help="ring tier to draw (0: the finest)")
    ptp.add_argument("--watch", type=int, default=1, metavar="N",
                     help="draw N times before exiting (1: once)")
    ptp.add_argument("--interval", type=float, default=2.0,
                     help="seconds between --watch draws")
    ptp.add_argument("--json", action="store_true",
                     help="print the /timeseries payload instead of the "
                          "terminal view")
    ptp.set_defaults(fn=cmd_top)

    ppr = sub.add_parser(
        "profile", help="device-cost profiling report: cold calls by "
                        "signature with bytes/operations, dispatch time "
                        "split, memory gauges, recompile window, kernel "
                        "builds")
    ppr.set_defaults(fn=cmd_profile)

    pca = sub.add_parser(
        "cache",
        help="result-cache introspection: cache.* counters + live cache "
             "snapshots (stats), or drop every live cache's entries and "
             "reset the counters (clear)")
    pca.add_argument("verb", nargs="?", choices=["stats", "clear"],
                     default="stats")
    pca.set_defaults(fn=cmd_cache)

    pd = sub.add_parser(
        "docno", help="docid <-> docno mapping (TrecDocnoMapping CLI)")
    pd.add_argument("index_dir")
    pd.add_argument("op", choices=["list", "getDocno", "getDocid"])
    pd.add_argument("arg", nargs="?", default=None,
                    help="docid for getDocno, docno for getDocid")
    pd.set_defaults(fn=cmd_docno)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except ValueError as e:
        # a capability or usage error of the library (a phrase query on
        # an index without positions, prox without rerank) is one line
        print(f"error: {e}", file=sys.stderr)
        return 1
    except FileNotFoundError as e:
        if getattr(args.fn, "__name__", "") not in _ARTIFACT_ENTRY_CMDS:
            raise
        path = e.filename if e.filename else str(e)
        print(f"error: missing artifact: {path} (if this path is not an "
              "artifact you asked for, it is a bug — please report)",
              file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
