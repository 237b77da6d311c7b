"""Command line of the port: `index`, `search`, `expand`, `eval`,
`inspect --term`, `verify`, `migrate-index` and `serve-bench`, with
tpu_ir's flag names and defaults.

    python -m tpu_ir_torch.cli index CORPUS... IDX [--shards N] [--k 1]
        [--chargram-k 2 3] [--no-chargrams] [--overwrite] [--streaming
        [--batch-docs N] [--radix-buckets B] [--tokenize-procs N]] [--store]
        [--device cuda|cpu]
    python -m tpu_ir_torch.cli inspect IDX --term TEXT [--postings N]
    python -m tpu_ir_torch.cli verify IDX
    python -m tpu_ir_torch.cli search IDX [-q TEXT | --queries-file F |
        --topics F] [--scoring tfidf|bm25] [--k K] [--rerank N]
        [--layout auto|dense|sparse|sharded] [--docnos] [--compat]
        [--trec-run TAG]
    python -m tpu_ir_torch.cli expand IDX PATTERN [--chargram-k 3] [-n 50]
    python -m tpu_ir_torch.cli eval RUN QRELS [--complete]
    python -m tpu_ir_torch.cli migrate-index IDX [--compress | --decompress]
        [--tf-dtype auto|int8|bf16] [--add-bounds]
    python -m tpu_ir_torch.cli serve-bench IDX [--threads N] [--queries N]
        [--seed S] [--concurrency N | N,N,...] [--queue-depth N]
        [--deadline S] [--coalesce auto|on|off] [--breaker-threshold N]
        [--cache N] [--timeout S] [--chaos] [--layout ...] [--device ...]

`index`, `search` and `serve-bench` run on CUDA unless `--device cpu` is
given; `inspect`, `verify`, `migrate-index`, `expand` and `eval` run on
the host. Each prints its JSON report last (`inspect --term` prints one
line per hit, `expand` one term per line). `search` with none of `-q`,
`--queries-file` and `--topics` reads queries from standard input, one a
line, until `exit`; its `--prox`, `--slop`, `--show-matches` and
`--snippets` belong to a later slice and exit 2.
`serve-bench` runs the soak through the serving frontend (one
`--concurrency` value), or the concurrency sweep (a comma list), and
exits 1 when an invariant fails. It writes no BENCH_HISTORY.jsonl row.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys


def cmd_index(args) -> int:
    from .index import build_index, build_index_streaming

    missing = [p for p in args.corpus if not os.path.exists(p)]
    if missing:
        print(f"error: corpus path(s) not found: {', '.join(missing)}",
              file=sys.stderr)
        return 1
    kw = dict(k=args.k, chargram_ks=args.chargram_k, num_shards=args.shards,
              overwrite=args.overwrite,
              compute_chargrams=not args.no_chargrams, device=args.device)
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
    """One term's postings through the dictionary (the reference's
    getValue seek); the input is analyzed like a query."""
    from .index.dictionary import lookup_term

    if args.term is None:
        print("error: only `inspect --term` is ported (a later slice of "
              "the port dumps records and artifacts)", file=sys.stderr)
        return 2
    hits = lookup_term(args.index_dir, args.term)
    if not hits:
        print(f"term {args.term!r} not in dictionary", file=sys.stderr)
        return 1
    for tp in hits:
        posts = [tuple(p) for p in tp.postings[: args.postings].tolist()]
        print(f"part-{tp.shard:05d}@{tp.offset}\t{tp.term}\tdf={tp.df}"
              f"\t{posts}")
    return 0


def cmd_verify(args) -> int:
    from .index.verify import verify_index

    print(json.dumps(verify_index(args.index_dir)))
    return 0


# search flags whose machinery (positions, phrases, the document store's
# snippets) a later slice of the port brings
_LATER_SEARCH_FLAGS = (("prox", "--prox"), ("slop", "--slop"),
                       ("show_matches", "--show-matches"),
                       ("snippets", "--snippets"))


def cmd_search(args) -> int:
    from .search import Scorer

    for attr, flag in _LATER_SEARCH_FLAGS:
        if getattr(args, attr) not in (None, False):
            print(f"error: {flag} is not supported by tpu_ir_torch yet (a "
                  "later slice of the port: positions, phrase and "
                  "proximity queries, snippets)", file=sys.stderr)
            return 2
    try:
        scorer = Scorer.load(args.index_dir, layout=args.layout,
                             compat_int_idf=args.compat, device=args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    show_docids = not args.docnos

    def run_batch(queries: list[str], qids: list | None = None) -> None:
        # the reference's guard: 1-2 word queries only
        # (IntDocVectorsForwardIndex.java:292,297)
        skipped = ({q for q in queries if len(q.split()) > 2}
                   if args.compat else set())
        kept = [q for q in queries if q not in skipped]
        results = iter(scorer.search_batch(
            kept, k=args.k, scoring=args.scoring,
            return_docids=show_docids, rerank=args.rerank) if kept else [])
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
    to = 3 if args.compress else 2
    print(json.dumps(migrate_index(args.index_dir, to_version=to,
                                   tf_dtype=args.tf_dtype,
                                   add_bounds=args.add_bounds)))
    return 0


def cmd_serve_bench(args) -> int:
    """The soak (`serving/soak.py::run_soak`) through a ServingFrontend,
    optionally under the chaos plan, or with `--concurrency N,N,...` the
    concurrency sweep; prints the JSON report."""
    from . import faults
    from .search import Scorer
    from .serving import (
        DEFAULT_CHAOS_PLAN,
        ServingConfig,
        run_concurrency_sweep,
        run_soak,
    )

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
        scorer = Scorer.load(args.index_dir, layout=args.layout,
                             device=args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
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
        timeout_s=args.timeout)
    print(json.dumps(report, sort_keys=True, default=repr))
    ok = (report["errors"] == 0 and report["deadlocked"] == 0
          and report["untagged_mismatches"] == 0
          and report["served"] + report["shed"] == report["submitted"])
    return 0 if ok else 1


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
                    help="also build the compressed document-text store")
    pi.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pi.set_defaults(fn=cmd_index)

    pn = sub.add_parser("inspect", help="print one term's postings via the "
                                        "dictionary")
    pn.add_argument("index_dir")
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
                    help="the proximity boost (a later slice: exits 2)")
    ps.add_argument("--slop", type=int, default=None, metavar="S",
                    help="phrase slop (a later slice: exits 2)")
    ps.add_argument("--show-matches", action="store_true",
                    help="match positions (a later slice: exits 2)")
    ps.add_argument("--snippets", action="store_true",
                    help="text snippets (a later slice: exits 2)")
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
        help="convert part shards between raw (v2) and compressed (v3) "
             "arenas in place (atomic per shard, checksums re-recorded)")
    pm.add_argument("index_dir")
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
    pb.add_argument("--timeout", type=float, default=300.0,
                    help="the soak's wall-clock bound (s); requests still "
                         "pending past it count as deadlocked")
    pb.add_argument("--chaos", action="store_true",
                    help="inject the default chaos plan (hangs and device "
                         "losses at the score dispatch); TPU_IR_FAULTS "
                         "overrides it")
    pb.add_argument("--layout", choices=["auto", "dense", "sparse"],
                    default="auto")
    pb.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pb.set_defaults(fn=cmd_serve_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
