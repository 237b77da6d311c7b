"""In-place part format migration between v1 npz parts, v2 raw arenas and
v3 compressed arenas (`tpu_ir/index/migrate.py::migrate_index`).

`migrate_index(dir, to_version=3)` (`migrate-index --compress`) rewrites
every part through compress.compress_index; `to_version=2`
(`--decompress`, the default) writes each part as a raw arena, byte for
byte the original whenever a compressed index's tf mode was lossless
(the encoder proves the restoration when it compresses), and
`to_version=1` (`--to 1`) as an npz part, the rollback pin's format.
Each part is read verify-while-read, written atomically (temp file +
rename) and its other format's twin unlinked; the checksums and the
format stamp are recorded in one final metadata write, which also writes
the block-max bounds artifact anew from the postings serving will
decode. An interrupted run leaves a mixed dir that every reader
tolerates, and running it again completes it: a shard already in the
target format whose source twin a crash left behind has the twin
dropped once the kept target verifies against its own CRCs.

`add_bounds=True` (`migrate-index --add-bounds`) rewrites no part: it
computes `blockmax.arena` from the parts on disk, each read
verify-while-read, and records the checksums again.
"""

from __future__ import annotations

import os

from . import compress
from . import format as fmt


def migrate_index(index_dir: str,
                  to_version: int = fmt.ARENA_FORMAT_VERSION,
                  tf_dtype: str = "auto", add_bounds: bool = False) -> dict:
    """Convert every part of the index at `index_dir` to `to_version` (1 =
    npz parts, 2 = raw arenas, 3 = compressed arenas with `tf_dtype`
    auto|int8|bf16).
    Returns a summary; parts already in the target format count as
    skipped. With `add_bounds` only the block-max bounds artifact is
    (re)written, the same bytes on every run for the same postings."""
    fmt.require_known_format(to_version)
    meta = fmt.IndexMetadata.load(index_dir)
    if add_bounds:
        from .blockmax import BLOCKMAX_ARENA, write_block_bounds

        info = write_block_bounds(index_dir, meta, verify=True)
        meta.save_with_checksums(index_dir, block_bounds=False)
        return {"index_dir": index_dir, "add_bounds": True,
                "bounds_artifact": BLOCKMAX_ARENA, **info,
                "checksums_recorded": len(meta.checksums), "ok": True}
    if to_version == fmt.COMPRESSED_FORMAT_VERSION:
        info = compress.compress_index(index_dir, meta, tf_dtype=tf_dtype)
        meta.save_with_checksums(index_dir, compress=False)
        return {"index_dir": index_dir, "format_version": to_version,
                "num_shards": meta.num_shards, **info,
                "checksums_recorded": len(meta.checksums), "ok": True}
    migrated = skipped = 0
    for s in range(meta.num_shards):
        src = fmt.part_path(index_dir, s)
        if not os.path.exists(src):
            raise FileNotFoundError(src)
        if os.path.basename(src) == fmt.part_name(s, to_version):
            # a crash between save_shard's rename and its twin unlink
            # leaves the source copy: drop it once the kept target
            # verifies, never before
            twin = fmt._part_twin(index_dir, os.path.basename(src))
            if twin is not None:
                fmt._self_verify_part(src)
                os.remove(twin)
            skipped += 1
            continue
        z = fmt.load_shard_verified(index_dir, s, meta)
        fmt.save_shard(index_dir, s, term_ids=z["term_ids"],
                       indptr=z["indptr"], pair_doc=z["pair_doc"],
                       pair_tf=z["pair_tf"], df=z["df"],
                       format_version=to_version)
        migrated += 1
    meta.format_version = to_version
    # raw parts hold exact int32 tfs again, but tf_lossy stays: a lossy
    # index decompresses to its floor-quantized values
    meta.tf_dtype = "int32"
    # a TPU_IR_COMPRESS=1 left in the environment must not undo this walk
    meta.save_with_checksums(index_dir, compress=False)
    return {"index_dir": index_dir, "format_version": to_version,
            "num_shards": meta.num_shards, "migrated": migrated,
            "skipped": skipped, "checksums_recorded": len(meta.checksums),
            "ok": True}
