"""Command line of the port: `index`, `search` and `migrate-index`, with
tpu_ir's flag names.

    python -m tpu_ir_torch.cli index CORPUS... IDX [--shards N] [--device cuda|cpu]
    python -m tpu_ir_torch.cli search IDX -q TEXT [--scoring tfidf|bm25] [--k K]
        [--rerank N] [--layout auto|dense|sparse|sharded]
    python -m tpu_ir_torch.cli migrate-index IDX [--compress | --decompress]
        [--tf-dtype auto|int8|bf16] [--add-bounds]

`index` and `search` run on CUDA unless `--device cpu` is given;
`migrate-index` runs on the host and prints its JSON summary last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def cmd_index(args) -> int:
    from .index import build_index

    missing = [p for p in args.corpus if not os.path.exists(p)]
    if missing:
        print(f"error: corpus path(s) not found: {', '.join(missing)}",
              file=sys.stderr)
        return 1
    meta = build_index(args.corpus, args.index_dir, num_shards=args.shards,
                       device=args.device)
    print(json.dumps(meta.__dict__))
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


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="tpu-ir-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build the index artifacts of a "
                                      "TREC corpus")
    pi.add_argument("corpus", nargs="+", help="TREC files or directories")
    pi.add_argument("index_dir")
    pi.add_argument("--shards", type=int, default=10,
                    help="term shards (reference used 10 reducers)")
    pi.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pi.set_defaults(fn=cmd_index)

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

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
