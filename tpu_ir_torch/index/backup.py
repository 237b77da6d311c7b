"""Generation-pinned live-dir snapshots, `backup` and `backup --restore`
(the port's copy of `tpu_ir/index/backup.py`).

A backup is the current generation, pinned: live.json, the one manifest
CURRENT names, every segment dir that manifest references, and the WAL
tail, so a snapshot taken mid-ingest carries the acknowledged but
unflushed writes too (an IngestWriter opened on the restore replays them
past the manifest's watermark, as after a crash).

Files are hardlinked where the destination shares the filesystem
(segments never change once committed, and manifests are replaced by
rename, never rewritten, so a link is as safe as a copy) and copied where
a link crosses devices. CURRENT is written, not linked. The WAL segments
are always copied: the log's tail is appended in place, so a link would
let the source writer's later records (or, after a restore, the restored
writer's) into the snapshot. The JAX package links them too; the port
copies them. Older generations, unreferenced segments and the LEASE file
stay out: a restore never inherits another machine's writer lease.
`restore_live` runs `verify_live` on the result before it reports
success.
"""

from __future__ import annotations

import json
import os
import shutil

from .segments import (CURRENT, GENERATIONS_DIR, LIVE_CONFIG,
                       SEGMENTS_DIR, LiveIndex, _manifest_name,
                       _write_current, is_live)
from .wal import WAL_DIR, list_segments as wal_segments


def _link_or_copy(src: str, dst: str, *, link: bool = True) -> int:
    """Hardlink `src` to `dst`, or copy it where the link fails or
    `link` is False; the file's size."""
    if link:
        try:
            os.link(src, dst)
            return os.path.getsize(dst)
        except OSError:
            pass
    shutil.copy2(src, dst)
    return os.path.getsize(dst)


def _snap_tree(src_dir: str, dst_dir: str) -> tuple[int, int]:
    """(files, bytes) linked or copied for one dir tree; the files of a
    WAL dir are copied."""
    files = size = 0
    for root, _dirs, names in os.walk(src_dir):
        rel = os.path.relpath(root, src_dir)
        out = os.path.join(dst_dir, rel) if rel != "." else dst_dir
        os.makedirs(out, exist_ok=True)
        for name in names:
            size += _link_or_copy(os.path.join(root, name),
                                  os.path.join(out, name),
                                  link=rel != WAL_DIR)
            files += 1
    return files, size


def backup_live(live_dir: str, dest: str) -> dict:
    """Snapshot `live_dir`'s current generation into `dest` (absent or
    empty). Returns a summary: the generation, its segments, the WAL
    segments carried, files and bytes."""
    live = LiveIndex.open(live_dir)
    if os.path.exists(dest) and os.listdir(dest):
        raise ValueError(f"backup destination {dest} exists and is not "
                         "empty")
    gen = live.current_gen()
    manifest = live.manifest(gen)
    os.makedirs(os.path.join(dest, GENERATIONS_DIR), exist_ok=True)
    os.makedirs(os.path.join(dest, SEGMENTS_DIR), exist_ok=True)
    size = _link_or_copy(os.path.join(live_dir, LIVE_CONFIG),
                         os.path.join(dest, LIVE_CONFIG))
    size += _link_or_copy(
        os.path.join(live_dir, GENERATIONS_DIR, _manifest_name(gen)),
        os.path.join(dest, GENERATIONS_DIR, _manifest_name(gen)))
    # CURRENT is written, not linked: the source writer keeps flipping
    # its own, and a linked pointer would follow it
    _write_current(dest, gen)
    files = 3
    for name in manifest["segments"]:
        n, b = _snap_tree(live.segment_path(name),
                          os.path.join(dest, SEGMENTS_DIR, name))
        files += n
        size += b
    wal_files = 0
    for _start, path in wal_segments(live_dir):
        os.makedirs(os.path.join(dest, WAL_DIR), exist_ok=True)
        size += _link_or_copy(path, os.path.join(
            dest, WAL_DIR, os.path.basename(path)), link=False)
        files += 1
        wal_files += 1
    return {"generation": gen, "segments": list(manifest["segments"]),
            "wal_segments": wal_files, "files": files, "bytes": size,
            "dest": os.path.abspath(dest)}


def restore_live(backup_dir: str, dest: str) -> dict:
    """Materialize a backup into `dest` (linked or copied again: the
    backup stays intact) and prove it with verify_live before returning
    {**verify report, "restored": dest, "files", "bytes"}."""
    from .verify import verify_live

    if not is_live(backup_dir):
        raise ValueError(f"{backup_dir} is not a backup of a live dir "
                         "(missing live.json/generations)")
    if os.path.exists(dest) and os.listdir(dest):
        raise ValueError(f"restore destination {dest} exists and is not "
                         "empty")
    files, size = _snap_tree(backup_dir, dest)
    report = verify_live(dest)
    with open(os.path.join(dest, CURRENT)) as f:
        gen = int(f.read().strip())
    with open(os.path.join(dest, GENERATIONS_DIR, _manifest_name(gen)),
              encoding="utf-8") as f:
        json.load(f)   # a malformed manifest fails restore, not serving
    return {**report, "restored": os.path.abspath(dest),
            "files": files, "bytes": size}
