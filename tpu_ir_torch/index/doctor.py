"""`doctor`: the index health report (the port's copy of
`tpu_ir/index/doctor.py`), computed from the on-disk artifacts alone,
with no Scorer load and no device, as in the JAX package:

- the df distribution and posting-list skew: percentiles, the top terms
  by df and the postings share they take;
- per-shard term, postings and byte balance;
- tier occupancy from the assignment serving uses (search/layout.py::
  plan_tiers, shared code), with each rung's fill and the padding waste;
- arena section sizes, the serving caches present and what they hold;
- the compression readout and the block-max bounds' health
  (blockmax.bounds_report);
- doc-length stats and a short list of heuristic warnings.

The report equals the JAX package's dict on the same index, `index_dir`
aside. A live index dir (segments, generations) gets the topology report
instead (`live_doctor_report`): per-segment docs, pairs and bytes with
the base/delta split, tombstones, the live-doc fraction, the merge debt,
unreferenced segment dirs, the WAL's health and the writer lease.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..collection import Vocab
from . import compress as comp
from . import format as fmt

# balance ratios (max/mean) above this land in `warnings`
BALANCE_WARN = 1.5
# cold-tier padding-waste fraction above this lands in `warnings`
WASTE_WARN = 0.6


def _pct(a, qs=(50, 90, 99)) -> dict:
    if not len(a):
        return {f"p{q}": None for q in qs}
    return {f"p{q}": float(np.percentile(a, q)) for q in qs}


def _shard_scan(index_dir: str, meta) -> tuple[np.ndarray, list, dict]:
    """One pass over the parts: the global df column, per-shard stats (a
    compressed part's codec facts included) and, for arena parts, the
    byte total of each section name. Compressed parts are decoded, so
    `postings` and df mean the same at every format version."""
    df = np.zeros(meta.vocab_size, np.int64)
    shards = []
    sections: dict[str, int] = {}
    for s in range(meta.num_shards):
        path = fmt.part_path(index_dir, s)
        z = fmt.load_shard(index_dir, s, decode=True)
        df[z["term_ids"]] = z["df"]
        entry = {
            "shard": s,
            "file": os.path.basename(path),
            "bytes": os.path.getsize(path),
            "terms": int(len(z["term_ids"])),
            "postings": int(z["indptr"][-1]) if len(z["indptr"]) else 0,
            # the same postings as decoded raw arrays: the compression
            # ratio's numerator
            "raw_equivalent_bytes": int(sum(
                np.asarray(z[k]).nbytes
                for k in ("term_ids", "indptr", "pair_doc",
                          "pair_tf", "df"))),
        }
        if path.endswith(fmt.ARENA_SUFFIXES):
            header, _ = fmt.arena_file_header(path)
            for sec in header["sections"]:
                sections[sec["name"]] = (sections.get(sec["name"], 0)
                                         + int(sec["nbytes"]))
            if comp.COMPRESS_INFO in {sec["name"]
                                      for sec in header["sections"]}:
                entry["codec"] = comp.shard_info(
                    fmt.load_shard(index_dir, s))
        shards.append(entry)
    return df, shards, sections


def _balance(values) -> float | None:
    """max/mean: 1.0 is balanced, 2.0 means the worst shard carries twice
    its share."""
    v = list(values)
    if not v or not sum(v):
        return None
    return round(max(v) / (sum(v) / len(v)), 4)


def df_skew_report(df: np.ndarray) -> dict:
    """The share of the postings that the top-df decile of the nonzero-df
    terms holds: near 1.0 is a Zipf-shaped corpus, where the hot work of
    almost every query sits in that decile."""
    df = np.asarray(df).reshape(-1)
    nz = np.sort(df[df > 0])[::-1]
    if not len(nz):
        return {"nonzero_terms": 0, "top_decile_terms": 0,
                "top_decile_postings_share": None}
    decile = max(int(len(nz) * 0.1), 1)
    total = int(nz.sum())
    return {
        "nonzero_terms": int(len(nz)),
        "top_decile_terms": int(decile),
        "top_decile_postings_share": round(
            int(nz[:decile].sum()) / max(total, 1), 4),
    }


def _tier_report(df: np.ndarray, num_docs: int) -> dict:
    """Tier occupancy, from the assignment serving's layout uses
    (search/layout.py::plan_tiers)."""
    from ..search.layout import BASE_CAP, GROWTH, HOT_BUDGET, plan_tiers

    hot_tids, cold, caps, want = plan_tiers(df, num_docs=num_docs)
    total_postings = int(df.sum())
    hot_postings = int(df[hot_tids].sum())
    tiers = []
    cells_total = waste_total = 0
    for i, cap in enumerate(caps):
        tids = cold[want == i]
        if not len(tids):
            continue
        postings = int(df[tids].sum())
        cells = int(len(tids)) * cap
        cells_total += cells
        waste_total += cells - postings
        tiers.append({
            "cap": int(cap),
            "rows": int(len(tids)),
            "postings": postings,
            "fill_fraction": round(postings / cells, 4),
        })
    return {
        "ladder": {"hot_budget": HOT_BUDGET, "base_cap": BASE_CAP,
                   "growth": GROWTH},
        "hot": {
            "terms": int(len(hot_tids)),
            "budget_rows": max(int(HOT_BUDGET // (num_docs + 1)), 1),
            "postings": hot_postings,
            "postings_fraction": round(
                hot_postings / max(total_postings, 1), 4),
        },
        "tiers": tiers,
        "cold_padding_waste_fraction": round(
            waste_total / max(cells_total, 1), 4),
    }


def _serving_caches(index_dir: str) -> list:
    """Every serving-cache dir present, with its arena's section sizes:
    what a warm load maps."""
    out = []
    try:
        names = sorted(n for n in os.listdir(index_dir)
                       if n.startswith("serving-"))
    except OSError:
        return out
    for name in names:
        arena = os.path.join(index_dir, name, "cache.arena")
        entry = {"cache": name}
        try:
            header, _ = fmt.arena_file_header(arena)
            entry["bytes"] = os.path.getsize(arena)
            entry["sections"] = {sec["name"]: int(sec["nbytes"])
                                 for sec in header["sections"]}
        except (OSError, ValueError) as e:
            entry["error"] = repr(e)
        out.append(entry)
    return out


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                continue
    return total


def live_doctor_report(live_dir: str) -> dict:
    """The live-index topology report: per-segment docs, pairs and bytes
    with the base-vs-delta split, tombstones, the live-doc fraction, the
    merge-debt readout (what the tiered policy would do now), segment
    dirs no manifest names, the WAL's replay backlog and tail, and the
    writer lease. `doctor_report` routes live dirs here."""
    from . import segments as seg
    from .wal import lease_holder, verify_wal

    live = seg.LiveIndex.open(live_dir)
    gen = live.current_gen()
    manifest = live.manifest(gen)
    tombs = manifest.get("tombstones", {})
    segments = []
    for name in manifest["segments"]:
        p = live.segment_path(name)
        meta = fmt.IndexMetadata.load(p)
        segments.append({
            "segment": name,
            "docs": meta.num_docs,
            "num_pairs": meta.num_pairs,
            "bytes": _dir_bytes(p),
            "format_version": meta.format_version,
            "compressed": bool(getattr(meta, "compressed", False)),
            "tf_lossy": bool(getattr(meta, "tf_lossy", False)),
            "tombstones": len(tombs.get(name, [])),
            "block_bounds": os.path.exists(
                os.path.join(p, "blockmax.arena")),
        })
    base = max(segments, key=lambda s: s["docs"], default=None)
    for s in segments:
        s["kind"] = "base" if base is not None and s is base else "delta"
    base_bytes = base["bytes"] if base else 0
    debt = seg.merge_debt(manifest)
    counts = live.doc_counts(gen)
    # segment dirs no manifest on disk names: crashed half-builds or
    # pre-gc leftovers, dead bytes either way
    referenced: set = set()
    for g in live.generations():
        referenced.update(live.manifest(g).get("segments", []))
    unreferenced = []
    now = time.time()
    seg_root = os.path.join(live.live_dir, seg.SEGMENTS_DIR)
    for name in sorted(os.listdir(seg_root)):
        if name.startswith(".") or name in referenced:
            continue
        try:
            age_s = now - os.path.getmtime(os.path.join(seg_root, name))
        except OSError:
            continue
        unreferenced.append({"segment": name, "age_s": round(age_s, 1),
                             "bytes": _dir_bytes(
                                 os.path.join(seg_root, name))})
    try:
        wal_info = verify_wal(
            live_dir, watermark=manifest.get("wal", {}).get("seq", 0))
    except AssertionError as e:   # IntegrityError: the doctor reports
        wal_info = {"error": str(e)}  # it, verify raises
    report = {
        "live_dir": os.path.abspath(live_dir),
        "live": True,
        "generation": gen,
        "generations_on_disk": live.generations(),
        "config": live.config,
        "docs": counts,
        "live_doc_fraction": debt["live_doc_fraction"],
        "segments": segments,
        "segment_count": len(segments),
        "base_bytes": base_bytes,
        "delta_bytes": sum(s["bytes"] for s in segments) - base_bytes,
        "merge_debt": debt,
        "unreferenced_segments": unreferenced,
        "wal": wal_info,
        "lease": lease_holder(live_dir),
    }
    warnings = []
    if unreferenced:
        oldest = max(u["age_s"] for u in unreferenced)
        warnings.append(
            f"{len(unreferenced)} unreferenced segment dir(s) "
            f"(oldest {oldest:.0f}s, "
            f"{sum(u['bytes'] for u in unreferenced)} bytes): crashed "
            "half-builds or pre-gc leftovers — the next IngestWriter "
            "open (or `tpu-ir ingest --gc`) reclaims them")
    if wal_info.get("torn_tail"):
        warnings.append(
            "the WAL tail is torn (a writer died mid-append): the next "
            "writer open truncates it loudly — only unacknowledged "
            "bytes are lost")
    if wal_info.get("error"):
        warnings.append(
            f"WAL integrity: {wal_info['error']} — acknowledged history "
            "is damaged; restore the live dir from a `tpu-ir backup` "
            "snapshot")
    missing_bounds = [s["segment"] for s in segments
                      if not s["block_bounds"]]
    if missing_bounds:
        warnings.append(
            f"generation {gen} has segment(s) without block-max bounds "
            f"({', '.join(missing_bounds)}): deep-k serving falls back "
            "to recomputing bounds at load — backfill with `tpu-ir "
            "migrate-index <segment> --add-bounds` or compact")
    if debt["pending_merge_groups"]:
        warnings.append(
            f"merge debt: {len(debt['pending_merge_groups'])} tier(s) "
            f"over TPU_IR_MERGE_FACTOR — run `tpu-ir ingest "
            f"{live_dir} --merge` (or let auto-merge catch up) before "
            "delta count bounds swap freshness")
    frac = debt["live_doc_fraction"]
    if frac is not None and frac < 0.8:
        warnings.append(
            f"only {frac:.0%} of indexed documents are live — "
            "tombstone debt is paying index bytes and merge time for "
            "dead docs; compact (`tpu-ir ingest --compact`)")
    if len(segments) > 1 or tombs:
        warnings.append(
            f"generation {gen} is not directly servable "
            f"({len(segments)} segments, "
            f"{counts['tombstoned']} tombstones); serving follows the "
            "latest COMPACTED generation until the next compaction")
    comp_segs = [s["segment"] for s in segments if s["compressed"]]
    if comp_segs and len(comp_segs) < len(segments):
        warnings.append(
            f"mixed segment formats in generation {gen}: "
            f"{len(comp_segs)} compressed, "
            f"{len(segments) - len(comp_segs)} raw — per-worker HBM "
            "projections are the raw segments' until every segment is "
            "migrated (`tpu-ir migrate-index <segment> --compress`) or "
            "the next compaction rewrites them uniformly")
    report["warnings"] = warnings
    return report


def doctor_report(index_dir: str, top_terms: int = 10) -> dict:
    """The full health report (see the module docstring). A non-index dir
    raises FileNotFoundError; a live index dir gets the topology report
    (`live_doctor_report`)."""
    from .segments import is_live

    if is_live(index_dir):
        return live_doctor_report(index_dir)
    meta = fmt.IndexMetadata.load(index_dir)
    df, shards, sections = _shard_scan(index_dir, meta)
    nz = df[df > 0]
    total_postings = int(df.sum())

    order = np.argsort(df, kind="stable")[::-1][:top_terms]
    vocab = Vocab.load(os.path.join(index_dir, fmt.VOCAB))
    top = [{"term": vocab.term(int(t)), "df": int(df[t]),
            "df_fraction": round(int(df[t]) / max(meta.num_docs, 1), 4)}
           for t in order if df[t] > 0]
    top_share = round(sum(e["df"] for e in top)
                      / max(total_postings, 1), 4)

    doc_len = np.load(os.path.join(index_dir, fmt.DOCLEN))
    dl = doc_len[1:].astype(np.int64)  # slot 0 is the dead column

    report = {
        "index_dir": os.path.abspath(index_dir),
        "metadata": {
            "num_docs": meta.num_docs,
            "vocab_size": meta.vocab_size,
            "num_pairs": meta.num_pairs,
            "num_shards": meta.num_shards,
            "k": meta.k,
            "format_version": meta.format_version,
        },
        "docs": {
            "count": int(len(dl)),
            "empty": int((dl == 0).sum()),
            "mean_len": round(float(dl.mean()), 2) if len(dl) else None,
            **{k: (round(v, 2) if v is not None else None)
               for k, v in _pct(dl).items()},
            "max_len": int(dl.max()) if len(dl) else None,
        },
        "df": {
            "zero_df_terms": int((df == 0).sum()),
            "max": int(df.max()) if len(df) else 0,
            **{k: (round(v, 2) if v is not None else None)
               for k, v in _pct(nz).items()},
            "top_terms": top,
            f"top{top_terms}_postings_fraction": top_share,
            "skew": df_skew_report(df),
        },
        "shards": {
            "per_shard": shards,
            "terms_balance": _balance(s["terms"] for s in shards),
            "postings_balance": _balance(s["postings"] for s in shards),
            "bytes_balance": _balance(s["bytes"] for s in shards),
        },
        "tiers": _tier_report(df, meta.num_docs),
        "compression": _compression_report(meta, shards),
        "arena_sections": sections or None,
        "serving_caches": _serving_caches(index_dir),
        "block_bounds": _bounds_report(index_dir, meta),
    }
    report["warnings"] = _warnings(report)
    return report


def _compression_report(meta, shards: list) -> dict:
    """How many shards carry the codec, what the bytes shrank to, and the
    postings bytes one doc-range worker of a scatter-gather tier would
    hold at 1, 4 and 16 workers (raw: the full CSR; compressed: its
    share)."""
    compressed = [s for s in shards if "codec" in s]
    file_bytes = sum(s["bytes"] for s in shards)
    raw_eq = sum(s["raw_equivalent_bytes"] for s in shards)
    nd = max(meta.num_docs, 1)
    out = {
        "compressed_shards": len(compressed),
        "raw_shards": len(shards) - len(compressed),
        "tf_dtype": getattr(meta, "tf_dtype", "int32"),
        "tf_lossy": bool(getattr(meta, "tf_lossy", False)),
        "file_bytes": int(file_bytes),
        "raw_equivalent_bytes": int(raw_eq),
        "ratio": (round(raw_eq / file_bytes, 3) if file_bytes else None),
        "bytes_per_doc": round(file_bytes / nd, 2),
        "raw_bytes_per_doc": round(raw_eq / nd, 2),
    }
    if compressed:
        out["projected_worker_hbm_bytes"] = {
            str(w): {"raw": int(raw_eq), "compressed": int(raw_eq // w)}
            for w in (1, 4, 16)}
    return out


def _bounds_report(index_dir: str, meta) -> dict:
    from .blockmax import bounds_report

    try:
        return bounds_report(index_dir, meta)
    except Exception as e:  # noqa: BLE001 — doctor reports, never dies
        return {"present": None, "error": repr(e)}


def _warnings(report: dict) -> list[str]:
    """Heuristic red flags; advisory (the command still exits 0)."""
    out = []
    sh = report["shards"]
    for key in ("terms_balance", "postings_balance"):
        v = sh.get(key)
        if v is not None and v > BALANCE_WARN:
            out.append(
                f"shard {key.split('_')[0]} imbalance {v}x (max/mean > "
                f"{BALANCE_WARN}x): hot shards will bound scatter-gather "
                "latency (ROADMAP 4)")
    waste = report["tiers"]["cold_padding_waste_fraction"]
    if waste > WASTE_WARN:
        out.append(
            f"cold-tier padding waste {waste:.0%} (> {WASTE_WARN:.0%}): "
            "the geometric capacity ladder fits this df distribution "
            "poorly; consider tuning BASE_CAP/GROWTH")
    docs = report["docs"]
    if docs["count"] and docs["empty"] / docs["count"] > 0.1:
        out.append(
            f"{docs['empty']} of {docs['count']} documents are empty "
            "after analysis: check the corpus parser / stopword list")
    top = report["df"]["top_terms"]
    if top and top[0]["df_fraction"] >= 0.5:
        out.append(
            f"term {top[0]['term']!r} appears in {top[0]['df_fraction']:.0%} "
            "of documents (stopword-grade; its idf contributes ~nothing "
            "while its postings dominate the hot strip)")
    comp_rep = report.get("compression") or {}
    if comp_rep.get("compressed_shards") and comp_rep.get("raw_shards"):
        out.append(
            f"mixed shard formats: {comp_rep['compressed_shards']} "
            f"compressed, {comp_rep['raw_shards']} raw — an interrupted "
            "`migrate-index --compress`; finish it (re-run is "
            "idempotent) or roll back with --decompress")
    if comp_rep.get("tf_lossy"):
        out.append(
            "term frequencies are LOSSY (int8 floor-quantized to 256 "
            "anchors): rankings may differ from the raw index; "
            "`--decompress` cannot restore the original tfs. Use "
            "--tf-dtype bf16 where bit-exactness matters")
    return out
