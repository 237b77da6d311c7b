"""Command line of the port: `index`, `search`, `expand`, `eval`,
`inspect`, `verify`, `migrate-index`, `merge`, `warm`, `doctor`,
`serve-bench`, `ingest`, `compact`, `generations`, `backup`, `pack`,
`count` and `docno`, with tpu_ir's flag names and defaults.

    python -m tpu_ir_torch.cli index CORPUS... IDX [--shards N] [--k 1]
        [--chargram-k 2 3] [--no-chargrams] [--overwrite] [--streaming
        [--batch-docs N] [--radix-buckets B] [--tokenize-procs N]] [--store]
        [--positions] [--device cuda|cpu]
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
    python -m tpu_ir_torch.cli ingest LIVE [--init [--shards N]
        [--chargram-k 2 3]] [--add TREC...] [--update TREC...]
        [--delete DOCID...] [--merge | --compact] [--gc]
        [--buffer-docs N] [--no-auto-merge] [--swap-bench | --soak-bench]
        [--device cuda|cpu]
    python -m tpu_ir_torch.cli compact LIVE [--all] [--max-steps N] [--gc]
        [--device cuda|cpu]
    python -m tpu_ir_torch.cli generations LIVE [-n N] [--gc]
    python -m tpu_ir_torch.cli backup SRC DEST [--restore]
    python -m tpu_ir_torch.cli pack TEXT_FILE OUT [--prefix LINE]
        [--format lines|trectext|trecweb]
    python -m tpu_ir_torch.cli count CORPUS...
    python -m tpu_ir_torch.cli docno IDX list|getDocno DOCID|getDocid DOCNO

`index`, `search`, `merge`, `warm`, `serve-bench`, `ingest` and `compact`
run on CUDA unless `--device cpu` is given; the others run on the host.
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
exits 1 when an invariant fails. It writes no BENCH_HISTORY.jsonl row.
`ingest --swap-bench` and `--soak-bench` exit 1 with an error naming the
later slice (the routed serving tier) that brings them.
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


def cmd_ingest(args) -> int:
    """The live index's write surface (index/ingest.py): `--init` creates
    a live dir; `--add`/`--update` feed TREC corpora through the
    IngestWriter, `--delete` tombstones docids, `--merge` runs one tiered
    merge step, `--compact` folds everything into one servable segment,
    `--gc` prunes old generations. One JSON summary on stdout.
    `--swap-bench` and `--soak-bench` raise ValueError: they come with
    the routed serving tier, a later slice."""
    from .index import segments as seg
    from .index.ingest import IngestWriter, ingest_corpus

    if args.swap_bench or args.soak_bench:
        bench = "--swap-bench" if args.swap_bench else "--soak-bench"
        raise ValueError(
            f"ingest {bench} is not ported yet: the swap under traffic "
            "comes with the routed serving tier, a later slice of the "
            "port (ROADMAP item 6b)")
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
        timeout_s=args.timeout)
    print(json.dumps(report, sort_keys=True, default=repr))
    ok = (report["errors"] == 0 and report["deadlocked"] == 0
          and report["untagged_mismatches"] == 0
          and report["served"] + report["shed"] == report["submitted"])
    return 0 if ok else 1


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
                     help="the ingest->compact->swap micro-bench: not "
                          "ported yet (the routed serving tier's slice)")
    pin.add_argument("--soak-bench", action="store_true",
                     help="the durable ingest+serve soak: not ported yet "
                          "(the routed serving tier's slice)")
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
