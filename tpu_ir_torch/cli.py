"""Command line of the port: `index`, `search`, `inspect --term`, `verify`,
`migrate-index` and `serve-bench`, with tpu_ir's flag names and defaults.

    python -m tpu_ir_torch.cli index CORPUS... IDX [--shards N] [--k 1]
        [--chargram-k 2 3] [--no-chargrams] [--overwrite] [--streaming
        [--batch-docs N] [--radix-buckets B] [--tokenize-procs N]] [--store]
        [--device cuda|cpu]
    python -m tpu_ir_torch.cli inspect IDX --term TEXT [--postings N]
    python -m tpu_ir_torch.cli verify IDX
    python -m tpu_ir_torch.cli search IDX -q TEXT [--scoring tfidf|bm25] [--k K]
        [--rerank N] [--layout auto|dense|sparse|sharded]
    python -m tpu_ir_torch.cli migrate-index IDX [--compress | --decompress]
        [--tf-dtype auto|int8|bf16] [--add-bounds]
    python -m tpu_ir_torch.cli serve-bench IDX [--threads N] [--queries N]
        [--seed S] [--concurrency N | N,N,...] [--queue-depth N]
        [--deadline S] [--coalesce auto|on|off] [--breaker-threshold N]
        [--cache N] [--timeout S] [--chaos] [--layout ...] [--device ...]

`index`, `search` and `serve-bench` run on CUDA unless `--device cpu` is
given; `inspect`, `verify` and `migrate-index` run on the host. Each
prints its JSON report last (`inspect --term` prints one line per hit).
`serve-bench` runs the soak through the serving frontend (one
`--concurrency` value), or the concurrency sweep (a comma list), and
exits 1 when an invariant fails. It writes no BENCH_HISTORY.jsonl row.
"""

from __future__ import annotations

import argparse
import json
import os
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


def cmd_search(args) -> int:
    from .search import Scorer

    try:
        scorer = Scorer.load(args.index_dir, layout=args.layout,
                             device=args.device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    (res,) = scorer.search_batch([args.query], k=args.k,
                                 scoring=args.scoring, rerank=args.rerank)
    print(f"query: {args.query}")
    if not res:
        print("  (no matching documents)")
    for rank, (key, score) in enumerate(res, 1):
        print(f"  {rank:2d}. {key}\t{score:.6f}")
    return 0


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

    ps = sub.add_parser("search", help="query an index")
    ps.add_argument("index_dir")
    ps.add_argument("--query", "-q", required=True)
    ps.add_argument("--k", "-k", type=int, default=10,
                    help="results per query")
    ps.add_argument("--scoring", choices=["tfidf", "bm25"], default="tfidf")
    ps.add_argument("--rerank", type=int, default=None, metavar="N",
                    help="two-stage retrieval: BM25 top-N candidates, then "
                         "cosine TF-IDF rerank")
    ps.add_argument("--layout",
                    choices=["auto", "dense", "sparse", "sharded"],
                    default="auto",
                    help="'auto' serves the dense matrix up to "
                         "DENSE_BUDGET elements and the tiered sparse "
                         "layout above it; 'sharded' is a later slice")
    ps.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ps.set_defaults(fn=cmd_search)

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
