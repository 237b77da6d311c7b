"""The live index: immutable segments under a chain of generation
manifests (the port's copy of `tpu_ir/index/segments.py`).

A batch-built index changes only by building it again. A live index dir
is a set of immutable segments (each an ordinary, self-verifying index
dir) and a chain of generation manifests that say which segments, and
which per-segment tombstones, make up the corpus at one instant:

    live_dir/
      live.json                 pinned build params (k, shards, chargrams)
      CURRENT                   current generation number (atomic rename)
      generations/gen-000007.json   manifest: segments, tombstones, docs
      segments/seg-000003/      one ordinary index dir per segment

Writes are incremental (index/ingest.py buffers documents and flushes
small delta segments); reads are immutable (a committed generation never
changes, so a serving process keeps answering from its generation while
newer ones land). Compaction (`compact`) applies tombstones (`drop_docs`)
and folds segments together through index/merge.py, so a fully
compacted generation has the metadata checksums of a one-shot build over
the surviving documents.

The manifest fields, their JSON layout (`indent=2, sort_keys=True`),
the segment names and the commit order (manifest first, then the
CURRENT flip, each an atomic rename) are the JAX package's, so either
package opens a live dir the other wrote. One writer per live dir (the
IngestWriter), many readers; a segment build that dies leaves a dir
without metadata.json that nothing references and `gc()` removes.

`drop_docs` and `compact` rebuild char-grams (and merge) on `device`,
CUDA by default. Scope, as in the JAX package: live indexes are k = 1,
without positions and without a document store.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time

import numpy as np
import torch

from .. import faults, resolve_device
from ..obs import get_registry
from . import format as fmt

LIVE_CONFIG = "live.json"
CURRENT = "CURRENT"
GENERATIONS_DIR = "generations"
SEGMENTS_DIR = "segments"


def is_live(path: str) -> bool:
    """Whether `path` is a live index dir (vs a plain built index)."""
    return (os.path.isdir(path)
            and os.path.exists(os.path.join(path, LIVE_CONFIG))
            and os.path.isdir(os.path.join(path, GENERATIONS_DIR)))


def _manifest_name(gen: int) -> str:
    return f"gen-{gen:06d}.json"


def _atomic_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def _write_current(live_dir: str, gen: int) -> None:
    tmp = os.path.join(live_dir, CURRENT + ".tmp")
    with open(tmp, "w") as f:
        f.write(str(gen))
    os.replace(tmp, os.path.join(live_dir, CURRENT))


class LiveIndex:
    """One live index dir: the manifest chain and the segment namespace.
    Not thread-safe: the single-writer discipline keeps every commit a
    plain sequence of atomic renames with no lock held across IO."""

    def __init__(self, live_dir: str):
        self.live_dir = os.path.abspath(live_dir)
        with open(os.path.join(self.live_dir, LIVE_CONFIG),
                  encoding="utf-8") as f:
            self.config = json.load(f)

    @classmethod
    def create(cls, live_dir: str, *, k: int = 1, num_shards: int = 10,
               chargram_ks=(2, 3)) -> "LiveIndex":
        """An empty live index (generation 0, no segments). The build
        parameters are pinned here once: every delta segment and every
        merge must agree on them."""
        if int(k) != 1:
            raise ValueError("live indexes support k=1 only (tombstone "
                             "application cannot reproduce a k>1 "
                             "tokens.txt bit-exactly)")
        if is_live(live_dir):
            raise ValueError(f"{live_dir} is already a live index")
        os.makedirs(os.path.join(live_dir, GENERATIONS_DIR), exist_ok=True)
        os.makedirs(os.path.join(live_dir, SEGMENTS_DIR), exist_ok=True)
        _atomic_json(os.path.join(live_dir, GENERATIONS_DIR,
                                  _manifest_name(0)),
                     {"gen": 0, "parent": None, "segments": [],
                      "tombstones": {}, "docs": {}, "note": "init",
                      "wal": {"seq": 0}, "created": time.time()})
        _atomic_json(os.path.join(live_dir, LIVE_CONFIG),
                     {"k": int(k), "num_shards": int(num_shards),
                      "chargram_ks": [int(c) for c in chargram_ks],
                      "created": time.time()})
        _write_current(live_dir, 0)
        return cls(live_dir)

    @classmethod
    def open(cls, live_dir: str) -> "LiveIndex":
        if not is_live(live_dir):
            raise ValueError(f"{live_dir} is not a live index dir "
                             "(create one with `tpu-ir ingest --init`)")
        return cls(live_dir)

    # -- the manifest chain ------------------------------------------------

    def current_gen(self) -> int:
        with open(os.path.join(self.live_dir, CURRENT)) as f:
            return int(f.read().strip())

    def manifest(self, gen: int | None = None) -> dict:
        if gen is None:
            gen = self.current_gen()
        path = os.path.join(self.live_dir, GENERATIONS_DIR,
                            _manifest_name(gen))
        with open(path, encoding="utf-8") as f:
            m = json.load(f)
        if int(m.get("gen", -1)) != int(gen):
            raise faults.IntegrityError(
                path, f"manifest names generation {m.get('gen')!r}, "
                f"expected {gen}")
        return m

    def generations(self) -> list[int]:
        """Every manifest on disk, ascending (gc prunes old ones)."""
        out = []
        for name in os.listdir(os.path.join(self.live_dir,
                                            GENERATIONS_DIR)):
            if name.startswith("gen-") and name.endswith(".json"):
                try:
                    out.append(int(name[4:-5]))
                except ValueError:
                    continue
        return sorted(out)

    def segment_path(self, name: str) -> str:
        return os.path.join(self.live_dir, SEGMENTS_DIR, name)

    def _next_segment_name(self, manifest: dict) -> str:
        """Monotonic over everything on disk and everything the manifest
        names, so a crashed (unreferenced) build dir is never reused for
        other content."""
        used = set(manifest.get("segments", []))
        try:
            used.update(os.listdir(os.path.join(self.live_dir,
                                                 SEGMENTS_DIR)))
        except OSError:
            pass
        top = 0
        for name in used:
            if name.startswith("seg-"):
                try:
                    top = max(top, int(name.split("-")[1]))
                except (IndexError, ValueError):
                    continue
        return f"seg-{top + 1:06d}"

    def commit(self, segments: list[str], tombstones: dict,
               docs: dict, *, note: str = "",
               wal_seq: int | None = None) -> dict:
        """Write the next generation's manifest, then flip CURRENT: a
        crash anywhere leaves the previous generation intact and current.
        Tombstones are {segment name: sorted docids}, per segment,
        because an updated document lives in two segments at once (dead
        in the old, live in the new). `wal_seq` is the WAL high-water
        mark this generation reflects; None (merges, compaction) inherits
        the parent's."""
        parent = self.current_gen()
        gen = parent + 1
        if wal_seq is None:
            wal_seq = int(self.manifest(parent).get(
                "wal", {}).get("seq", 0))
        tombstones = {s: sorted(set(t)) for s, t in tombstones.items()
                      if t and s in segments}
        m = {"gen": gen, "parent": parent, "segments": list(segments),
             "tombstones": tombstones,
             "docs": {s: int(docs[s]) for s in segments},
             "note": note, "wal": {"seq": int(wal_seq)},
             "created": time.time()}
        _atomic_json(os.path.join(self.live_dir, GENERATIONS_DIR,
                                  _manifest_name(gen)), m)
        faults.maybe_crash("ingest.commit_between", str(gen))
        _write_current(self.live_dir, gen)
        reg = get_registry()
        reg.incr("generation.commits")
        reg.set_gauge("generation.current", gen)
        reg.set_gauge("generation.segments", len(segments))
        reg.set_gauge("generation.tombstones",
                      sum(len(t) for t in tombstones.values()))
        return m

    # -- views -------------------------------------------------------------

    def live_doc_map(self, gen: int | None = None) -> dict:
        """{docid: segment name} for every live document of a generation:
        later segments shadow earlier ones (an update's new copy wins),
        then each segment's tombstones remove the pairs they name."""
        from ..collection import DocnoMapping

        m = self.manifest(gen)
        out: dict[str, str] = {}
        for name in m["segments"]:
            mapping = DocnoMapping.load(
                os.path.join(self.segment_path(name), fmt.DOCNOS))
            for d in mapping.docids:
                out[d] = name
        for name, tombs in m.get("tombstones", {}).items():
            for d in tombs:
                if out.get(d) == name:
                    del out[d]
        return out

    def doc_counts(self, gen: int | None = None) -> dict:
        """{"total": indexed docs, "tombstoned": dead, "live": the rest}."""
        m = self.manifest(gen)
        total = sum(m.get("docs", {}).values())
        dead = sum(len(t) for t in m.get("tombstones", {}).values())
        return {"total": total, "tombstoned": dead, "live": total - dead}

    # -- housekeeping ------------------------------------------------------

    def gc(self, keep_generations: int | None = None) -> dict:
        """Prune old manifests and delete the segment dirs no kept
        manifest names (crashed half-builds included). Run it only once
        every serving process has moved past the dropped generations."""
        from .. import envvars

        if keep_generations is None:
            keep_generations = envvars.get_int(
                "TPU_IR_INGEST_KEEP_GENERATIONS")
        gens = self.generations()
        keep = set(gens[-max(keep_generations, 1):])
        referenced: set[str] = set()
        for g in keep:
            referenced.update(self.manifest(g)["segments"])
        dropped_gens = []
        for g in gens:
            if g in keep:
                continue
            os.unlink(os.path.join(self.live_dir, GENERATIONS_DIR,
                                   _manifest_name(g)))
            dropped_gens.append(g)
        dropped_segs = []
        seg_root = os.path.join(self.live_dir, SEGMENTS_DIR)
        for name in sorted(os.listdir(seg_root)):
            if name not in referenced and not name.startswith("."):
                shutil.rmtree(os.path.join(seg_root, name),
                              ignore_errors=True)
                dropped_segs.append(name)
        return {"kept_generations": sorted(keep),
                "dropped_generations": dropped_gens,
                "dropped_segments": dropped_segs}


def resolve_serving(path: str, gen: int | None = None) -> tuple[str, int]:
    """(servable index dir, generation) for `path`. A plain index dir is
    (itself, 0). A live dir with an explicit `gen` resolves it strictly:
    a generation of several segments or with tombstones is not servable
    (scoring needs one docno space and global statistics) and raises
    with the compaction recipe. `gen=None` follows the newest servable
    generation (`latest_servable`)."""
    if not is_live(path):
        return os.path.abspath(path), 0
    if gen is None:
        return latest_servable(path)
    live = LiveIndex.open(path)
    m = live.manifest(gen)
    segs = m["segments"]
    if not segs:
        raise ValueError(f"{path}: generation {gen} has no segments — "
                         "ingest documents first")
    if len(segs) > 1 or m.get("tombstones"):
        raise ValueError(
            f"{path}: generation {gen} is not servable "
            f"({len(segs)} segments, "
            f"{sum(len(t) for t in m.get('tombstones', {}).values())} "
            "tombstones); compact it first (`tpu-ir ingest --compact`)")
    return live.segment_path(segs[0]), gen


def latest_servable(path: str) -> tuple[str, int]:
    """(servable index dir, generation) of the newest servable generation
    at or below current."""
    if not is_live(path):
        return os.path.abspath(path), 0
    live = LiveIndex.open(path)
    for gen in reversed(live.generations()):
        m = live.manifest(gen)
        if len(m["segments"]) == 1 and not m.get("tombstones"):
            return live.segment_path(m["segments"][0]), gen
    raise ValueError(f"{path}: no servable generation yet — ingest and "
                     "compact first (`tpu-ir ingest --compact`)")


# ---------------------------------------------------------------------------
# tombstone application: rewrite a segment without some documents
# ---------------------------------------------------------------------------


def drop_docs(src_dir: str, out_dir: str, drop_docids, *,
              device: str | torch.device | None = None
              ) -> fmt.IndexMetadata:
    """Rewrite the index at `src_dir` into `out_dir` without the named
    documents, with the metadata checksums of a one-shot build over the
    survivors: docnos are ranks in sorted-docid order, term ids ranks in
    sorted-vocabulary order, and the postings order (term asc, tf desc,
    doc asc) survives any filter because both remaps are monotone. The
    filter and the remaps run on the host in numpy, as in the JAX
    package; the char-grams are rebuilt over the surviving vocabulary on
    `device` (CUDA by default) through build_index's own path."""
    from ..collection import DocnoMapping, Vocab
    from ..utils.report import JobReport
    from .builder import build_chargram_artifacts

    meta = fmt.IndexMetadata.load(src_dir)
    if meta.has_positions:
        raise ValueError(f"{src_dir}: drop_docs does not support "
                         "position runs (live indexes are built "
                         "without positions)")
    if meta.k != 1:
        raise ValueError(f"{src_dir}: drop_docs supports k=1 only")
    dev = resolve_device(device)
    drop = set(drop_docids)
    mapping = DocnoMapping.load(os.path.join(src_dir, fmt.DOCNOS))
    old_docids = list(mapping.docids)
    unknown = drop - set(old_docids)
    if unknown:
        raise ValueError(f"{src_dir}: cannot drop unknown docids "
                         f"{sorted(unknown)[:5]}")
    survivors = [d for d in old_docids if d not in drop]
    if not survivors:
        raise ValueError(f"{src_dir}: dropping every document — remove "
                         "the segment from the manifest instead")
    os.makedirs(out_dir, exist_ok=True)
    report = JobReport("DropDocs", config={
        "src": src_dir, "dropped": len(drop),
        "num_shards": meta.num_shards})

    # docno space: survivors keep sorted order, renumbered by rank
    new_map = DocnoMapping.build(survivors)
    new_map.save(os.path.join(out_dir, fmt.DOCNOS))
    lut = np.zeros(len(old_docids) + 1, np.int32)  # old docno -> new, 0=dead
    new_of = {d: i + 1 for i, d in enumerate(new_map.docids)}
    for old_dn, d in enumerate(old_docids, start=1):
        lut[old_dn] = new_of.get(d, 0)
    num_docs = len(survivors)
    report.set_counter("Count.DOCS", num_docs)

    # postings: the global CSR order (each shard's per-term runs land at
    # their term's indptr slice), filtered, both axes remapped
    with report.phase("filter_postings"):
        v = meta.vocab_size
        df_old = np.zeros(v, np.int64)
        shard_data = []
        for s in range(meta.num_shards):
            z = fmt.load_shard(src_dir, s, decode=True)
            df_old[z["term_ids"]] = z["df"]
            shard_data.append(z)
        indptr = np.concatenate([[0], np.cumsum(df_old)])
        total = int(indptr[-1])
        pair_doc = np.empty(total, np.int32)
        pair_tf = np.empty(total, np.int32)
        for z in shard_data:
            lens = np.diff(z["indptr"]).astype(np.int64)
            n = int(lens.sum())
            if n == 0:
                continue
            ends = np.cumsum(lens)
            within = np.arange(n, dtype=np.int64) - np.repeat(
                ends - lens, lens)
            dest = np.repeat(indptr[z["term_ids"]], lens) + within
            pair_doc[dest] = z["pair_doc"]
            pair_tf[dest] = z["pair_tf"]
        del shard_data
        pair_term = np.repeat(np.arange(v, dtype=np.int64), df_old)
        keep = lut[pair_doc] > 0
        pt, pd, ptf = pair_term[keep], lut[pair_doc[keep]], pair_tf[keep]

    # vocabulary: terms that kept at least one posting, re-ranked
    with report.phase("vocab"):
        old_vocab = Vocab.load(os.path.join(src_dir, fmt.VOCAB))
        df_new_old_ids = np.bincount(pt, minlength=v).astype(np.int64)
        alive = np.nonzero(df_new_old_ids > 0)[0]
        term_lut = np.full(v, -1, np.int64)
        term_lut[alive] = np.arange(len(alive))
        new_terms = [old_vocab.term(int(t)) for t in alive]
        Vocab(new_terms).save(os.path.join(out_dir, fmt.VOCAB))
        pt = term_lut[pt].astype(np.int32)
        df = df_new_old_ids[alive].astype(np.int32)
        report.set_counter("Dictionary.Size", len(new_terms))

    # doc lengths: gathered through the docno remap (int32, as build_index)
    doc_len_old = np.load(os.path.join(src_dir, fmt.DOCLEN))
    doc_len = np.zeros(num_docs + 1, np.int32)
    keep_dn = np.nonzero(lut[1:] > 0)[0] + 1
    doc_len[lut[keep_dn]] = doc_len_old[keep_dn]
    np.save(os.path.join(out_dir, fmt.DOCLEN), doc_len)

    with report.phase("write_shards"):
        shard_of, offset_of = fmt.write_pair_shards(
            out_dir, df, pd.astype(np.int32), ptf.astype(np.int32),
            meta.num_shards)
    fmt.write_dictionary(out_dir, new_terms, shard_of, offset_of)

    built_chargrams = bool(meta.chargram_ks and new_terms)
    if built_chargrams:
        # k = 1: the index vocabulary is the token vocabulary
        with report.phase("chargrams"):
            build_chargram_artifacts(out_dir, new_terms, meta.chargram_ks,
                                     device=dev)

    out_meta = fmt.IndexMetadata(
        num_docs=num_docs, vocab_size=len(new_terms), k=meta.k,
        num_shards=meta.num_shards, num_pairs=int(len(pt)),
        chargram_ks=list(meta.chargram_ks) if built_chargrams else [],
        version=fmt.FORMAT_VERSION, has_positions=False,
        format_version=fmt.resolve_format_version())
    with report.phase("finalize"):
        out_meta.save_with_checksums(out_dir)
    report.record_peaks(dev)
    report.save(os.path.join(out_dir, fmt.JOBS_DIR))
    get_registry().incr("merge.docs_dropped", len(drop))
    return out_meta


# ---------------------------------------------------------------------------
# tiered merge policy + compaction
# ---------------------------------------------------------------------------


def plan_merges(manifest: dict, *, factor: int | None = None,
                tier_ratio: float | None = None) -> list[list[str]]:
    """The size-ratio tier policy: segments fall in geometric doc-count
    tiers (tier = floor(log_ratio docs)); a tier holding >= `factor`
    segments is merge debt, one group in manifest order. A segment whose
    tombstones kill at least half its docs joins the smallest indebted
    group whatever its size (rewriting it is mostly reclamation)."""
    from .. import envvars

    if factor is None:
        factor = envvars.get_int("TPU_IR_MERGE_FACTOR")
    if tier_ratio is None:
        tier_ratio = envvars.get_float("TPU_IR_MERGE_TIER_RATIO")
    docs = manifest.get("docs", {})
    tombs = manifest.get("tombstones", {})
    tiers: dict[int, list[str]] = {}
    dead_heavy = []
    for name in manifest.get("segments", []):
        n = max(int(docs.get(name, 0)), 1)
        if len(tombs.get(name, [])) * 2 >= n:
            dead_heavy.append(name)
            continue
        tiers.setdefault(int(math.log(n, tier_ratio)), []).append(name)
    groups = [names for _, names in sorted(tiers.items())
              if len(names) >= factor]
    if dead_heavy:
        if groups:
            groups[0] = dead_heavy + groups[0]
        elif len(dead_heavy) > 1 or tombs.get(dead_heavy[0]):
            groups = [dead_heavy]
    return groups


def compact(live: LiveIndex, segment_names: list[str] | None = None,
            *, note: str = "compact",
            device: str | torch.device | None = None) -> dict:
    """Merge `segment_names` (default: every segment, full compaction)
    into one segment, their tombstones applied first, and commit the
    successor generation. The merge is index/merge.py's on `device`
    (CUDA by default), so the result has the checksums of a one-shot
    build over the group's surviving docs. Intermediate tombstone-applied
    copies live in a dot-prefixed scratch dir (never referenced, gc'd);
    the merged segment is complete before the manifest names it."""
    import tempfile

    from .merge import merge_indexes

    dev = resolve_device(device)
    t0 = time.perf_counter()
    manifest = live.manifest()
    group = list(segment_names or manifest["segments"])
    unknown = [s for s in group if s not in manifest["segments"]]
    if unknown:
        raise ValueError(f"cannot compact unknown segments {unknown}")
    if not group:
        return manifest
    tombs = manifest.get("tombstones", {})
    scratch = tempfile.mkdtemp(
        prefix=".compact-", dir=os.path.join(live.live_dir, SEGMENTS_DIR))
    reg = get_registry()
    try:
        inputs = []
        for name in group:
            src = live.segment_path(name)
            dead = tombs.get(name, [])
            if not dead:
                inputs.append(src)
                continue
            if len(dead) >= int(manifest["docs"].get(name, 0)):
                continue  # fully dead: the segment just leaves the set
            cleaned = os.path.join(scratch, name)
            drop_docs(src, cleaned, dead, device=dev)
            inputs.append(cleaned)
        cfg = live.config
        new_name = live._next_segment_name(manifest)
        out_dir = live.segment_path(new_name)
        if not inputs:
            # every input was fully tombstoned: the successor generation
            # drops them and their tombstones
            segments = [s for s in manifest["segments"] if s not in group]
            docs = {s: manifest["docs"][s] for s in segments}
            new_tombs = {s: t for s, t in tombs.items() if s in segments}
            m = live.commit(segments, new_tombs, docs, note=note)
        else:
            if len(inputs) == 1 and inputs[0].startswith(scratch):
                # one cleaned input: drop_docs already wrote the segment
                os.replace(inputs[0], out_dir)
                meta = fmt.IndexMetadata.load(out_dir)
            elif len(inputs) == 1:
                # one untouched input: nothing to rewrite
                return manifest
            else:
                faults.maybe_crash("ingest.merge", new_name)
                meta = merge_indexes(
                    inputs, out_dir, num_shards=int(cfg["num_shards"]),
                    compute_chargrams=bool(cfg["chargram_ks"]), device=dev)
            segments, docs = [], {}
            placed = False
            for s in manifest["segments"]:
                if s in group:
                    if not placed:
                        segments.append(new_name)
                        docs[new_name] = meta.num_docs
                        placed = True
                    continue
                segments.append(s)
                docs[s] = manifest["docs"][s]
            new_tombs = {s: t for s, t in tombs.items()
                         if s in segments and s != new_name}
            m = live.commit(segments, new_tombs, docs, note=note)
        reg.incr("merge.runs")
        reg.incr("merge.segments_merged", len(group))
        reg.observe("merge.run", time.perf_counter() - t0)
        return m
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def merge_debt(manifest: dict) -> dict:
    """The doctor's merge-debt readout: what plan_merges would do now and
    the tombstone pressure behind it."""
    docs = manifest.get("docs", {})
    total = sum(docs.values())
    dead = sum(len(t) for t in manifest.get("tombstones", {}).values())
    return {
        "segments": len(manifest.get("segments", [])),
        "pending_merge_groups": plan_merges(manifest),
        "tombstoned_docs": dead,
        "live_doc_fraction": round((total - dead) / total, 4)
        if total else None,
    }
