"""Command line of the port: `index` and `search`, with tpu_ir's flag names.

    python -m tpu_ir_torch.cli index CORPUS... IDX [--shards N] [--device cuda|cpu]
    python -m tpu_ir_torch.cli search IDX -q TEXT [--scoring tfidf|bm25] [--k K]
        [--layout auto|dense|sparse|sharded]

Both run on CUDA unless `--device cpu` is given.
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
                                 scoring=args.scoring)
    print(f"query: {args.query}")
    if not res:
        print("  (no matching documents)")
    for rank, (key, score) in enumerate(res, 1):
        print(f"  {rank:2d}. {key}\t{score:.6f}")
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
    ps.add_argument("--layout",
                    choices=["auto", "dense", "sparse", "sharded"],
                    default="auto",
                    help="'auto' serves the dense matrix up to "
                         "DENSE_BUDGET elements and the tiered sparse "
                         "layout above it; 'sharded' is a later slice")
    ps.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ps.set_defaults(fn=cmd_search)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
