"""On-disk index format: the subset the port writes and reads.

A copy of the parts of `tpu_ir/index/format.py` the port needs, byte
compatible with it:

    index_dir/
      metadata.json     N, k, vocab size, shard count, counters, checksums
      docnos.txt        docid list, sorted; docno = 1-based position
      vocab.txt         term list, sorted; term id = 0-based position
      doclen.npy        int32 [N+1] total occurrences per docno (BM25)
      part-00000.arena  per term-shard CSR postings (format v2 arenas), or
      part-00000.carena the same shard compressed (format v3, compress.py)
      dictionary.tsv    term -> (shard, offset) forward index
      chargram-k<k>.npz char-k-gram -> sorted term-id lists
      blockmax.arena    per-(hot term, doc block) max tf (index/blockmax.py)
      docstore.bin      the compressed document store (index/docstore.py)
      jobs/*.json       job reports (phase timings and counters)

Term shard assignment is term_id % num_shards. Formats v2 (raw
page-aligned arenas) and v3 (compressed arenas, decoded on load) are read
and written here; v1 npz parts belong to a later slice of the port and
raise ValueError.
"""

from __future__ import annotations

import json
import os
import struct
import zipfile
import zlib
from dataclasses import dataclass, field

import numpy as np

from .. import faults
from ..faults import IntegrityError
from . import compress

# what an unreadable or corrupt npz or arena artifact raises on a full
# read (zip entry CRCs, arena section CRCs, IO)
CORRUPT_NPZ = (OSError, ValueError, KeyError, zipfile.BadZipFile,
               zlib.error)

FORMAT_VERSION = 1
ARENA_FORMAT_VERSION = 2
COMPRESSED_FORMAT_VERSION = 3
METADATA = "metadata.json"
DOCNOS = "docnos.txt"
VOCAB = "vocab.txt"
DOCLEN = "doclen.npy"
DICTIONARY = "dictionary.tsv"
JOBS_DIR = "jobs"
QUARANTINE_DIR = ".quarantine"
ARENA_SUFFIX = ".arena"
COMPRESSED_SUFFIX = ".carena"

_LATER = ("is not supported by tpu_ir_torch yet (a later slice of the "
          "port); only format v2 raw and v3 compressed arenas are")


def require_arena_format(format_version: int) -> None:
    """Raise ValueError unless the index is format v2 (raw arenas) or v3
    (compressed arenas)."""
    if format_version not in (ARENA_FORMAT_VERSION,
                              COMPRESSED_FORMAT_VERSION):
        kind = ("v1 npz parts" if format_version < ARENA_FORMAT_VERSION
                else "an unknown format")
        raise ValueError(f"index format {format_version} ({kind}) {_LATER}")


def part_name(shard: int, format_version: int = ARENA_FORMAT_VERSION) -> str:
    """A shard's part file name; the extension carries the format (npz
    v1, arena v2, compressed arena v3)."""
    if format_version >= COMPRESSED_FORMAT_VERSION:
        return f"part-{shard:05d}{COMPRESSED_SUFFIX}"
    if format_version >= ARENA_FORMAT_VERSION:
        return f"part-{shard:05d}{ARENA_SUFFIX}"
    return f"part-{shard:05d}.npz"


def part_path(index_dir: str, shard: int) -> str:
    """The shard's part file, whichever format is present, newest first
    (a mid-migration dir holds two copies and the newer ones are the
    complete set); the v2 name when none exists."""
    for fv in (COMPRESSED_FORMAT_VERSION, ARENA_FORMAT_VERSION,
               FORMAT_VERSION):
        p = os.path.join(index_dir, part_name(shard, fv))
        if os.path.exists(p):
            return p
    return os.path.join(index_dir, part_name(shard))


def chargram_name(k: int) -> str:
    return f"chargram-k{k}.npz"


def artifact_exists(index_dir: str, name: str) -> bool:
    return os.path.exists(os.path.join(index_dir, name))


@dataclass
class IndexMetadata:
    num_docs: int
    vocab_size: int
    k: int
    num_shards: int
    num_pairs: int
    chargram_ks: list[int]
    version: int = FORMAT_VERSION
    has_positions: bool = False
    checksums: dict[str, str] = field(default_factory=dict)
    format_version: int = FORMAT_VERSION
    tf_dtype: str = "int32"
    tf_lossy: bool = False

    @property
    def compressed(self) -> bool:
        return self.format_version >= COMPRESSED_FORMAT_VERSION

    def save(self, index_dir: str) -> None:
        with open(os.path.join(index_dir, METADATA), "w") as f:
            json.dump(self.__dict__, f, indent=2, sort_keys=True)

    def save_with_checksums(self, index_dir: str,
                            block_bounds: bool = True,
                            compress: bool = True) -> None:
        """Checksum every integrity-covered artifact on disk, record the
        digests, then save: metadata existence certifies the index and
        pins its bytes. Every build and migration ends here, so this is
        also where, with TPU_IR_COMPRESS=1, the parts just written become
        compressed (v3) arenas (`compress=False` opts out: a migration
        has converted already), and then where the block-max bounds
        artifact (index/blockmax.py) is written, before the checksum
        pass records it; `block_bounds=False` skips that (migrate
        --add-bounds writes the bounds itself first)."""
        if compress:
            from .compress import ensure_compressed

            ensure_compressed(index_dir, self)
        if block_bounds:
            from .blockmax import ensure_block_bounds

            ensure_block_bounds(index_dir, self)
        self.checksums = {name: file_checksum(os.path.join(index_dir, name))
                          for name in integrity_names(index_dir, self)}
        self.save(index_dir)

    @classmethod
    def load(cls, index_dir: str) -> "IndexMetadata":
        with open(os.path.join(index_dir, METADATA)) as f:
            return cls(**json.load(f))


def file_checksum(path: str, chunk_bytes: int = 1 << 22) -> str:
    """Streamed CRC32 of one file, as 'crc32:XXXXXXXX'."""
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(chunk_bytes):
            crc = zlib.crc32(chunk, crc)
    return f"crc32:{crc:08x}"


def _read_file_verified(path: str, chunk_bytes: int = 1 << 22):
    """One streamed pass: read the file into a preallocated buffer while
    folding its CRC32. Returns (read-only memoryview, crc)."""
    size = os.path.getsize(path)
    buf = bytearray(size)
    mv = memoryview(buf)
    pos = 0
    crc = 0
    with open(path, "rb") as f:
        while pos < size:
            n = f.readinto(mv[pos : pos + chunk_bytes])
            if not n:
                break
            crc = zlib.crc32(mv[pos : pos + n], crc)
            pos += n
    if pos != size:
        raise ValueError(f"{path}: short read ({pos} of {size} bytes) — "
                         "file truncated mid-load")
    return mv.toreadonly(), crc


# ---------------------------------------------------------------------------
# format v2: page-aligned raw-bytes arenas
# ---------------------------------------------------------------------------
#
# Layout (all little-endian):
#   [0:8)    magic b"TPUIRAR2"
#   [8:16)   uint64 header length H
#   [16:16+H) JSON header: {"align": A, "sections": [
#                {"name", "dtype", "shape", "offset", "nbytes", "crc32"}]}
#   data     starts at the first A-aligned offset >= 16+H; each section's
#            "offset" is relative to that data start and itself A-aligned.

ARENA_MAGIC = b"TPUIRAR2"
ARENA_ALIGN = 4096


def _align_up(n: int, align: int = ARENA_ALIGN) -> int:
    return -(-n // align) * align


def _arena_header(arrays: dict[str, np.ndarray]) -> tuple[bytes, list]:
    sections = []
    contig = []
    offset = 0
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        if a.dtype.hasobject:
            raise ValueError(f"arena section {name!r}: object dtype")
        contig.append((name, a))
        sections.append({
            "name": name, "dtype": a.dtype.str, "shape": list(a.shape),
            "offset": offset, "nbytes": int(a.nbytes),
            "crc32": f"crc32:"
                     f"{zlib.crc32(a.reshape(-1).view(np.uint8)):08x}",
        })
        offset = _align_up(offset + a.nbytes)
    header = json.dumps({"align": ARENA_ALIGN, "sections": sections},
                        sort_keys=True,
                        separators=(",", ":")).encode("utf-8")
    return header, contig


def load_arena(path: str) -> dict[str, np.ndarray]:
    """Read one arena whole and check every section's CRC: {name: array},
    read-only views of the buffer. A damaged file raises ValueError."""
    buf, _ = _read_file_verified(path)
    header, data_start = read_arena_header(buf)
    return _arena_views(buf, header, data_start, path, verify=True)


def write_arena(path: str, arrays: dict[str, np.ndarray]) -> None:
    header, contig = _arena_header(arrays)
    with open(path, "wb") as f:
        f.write(ARENA_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        data_start = _align_up(16 + len(header))
        f.write(b"\0" * (data_start - 16 - len(header)))
        pos = 0
        for _, a in contig:
            f.write(memoryview(a.reshape(-1).view(np.uint8)))
            pos += a.nbytes
            pad = _align_up(pos) - pos
            f.write(b"\0" * pad)
            pos += pad


def _write_atomic(path: str, tmp_suffix: str, write_tmp) -> str:
    """Temp file + rename under the spill retry policy, so a file's
    existence implies it is complete (what the streaming build's resume
    trusts), with the `spill_write` fault site (an OSError before the
    write). Returns the CRC ('crc32:XXXXXXXX') of the temp file, taken
    before the rename: corruption after the write never matches it."""
    name = os.path.basename(path)
    tmp = path + tmp_suffix

    def write() -> str:
        if faults.should_fire("spill_write", name) is not None:
            raise OSError(f"injected spill write failure: {path}")
        write_tmp(tmp)
        crc = file_checksum(tmp)
        os.replace(tmp, path)
        return crc

    return faults.run_with_retry(write, stage=f"write:{name}")


def write_arena_atomic(path: str, **arrays) -> str:
    """One arena, written atomically (_write_atomic); returns its CRC."""
    return _write_atomic(path, ".tmp.arena",
                         lambda tmp: write_arena(tmp, arrays))


def savez_atomic(path: str, **arrays) -> str:
    """np.savez, written atomically (_write_atomic); returns its CRC."""
    return _write_atomic(path, ".tmp.npz",
                         lambda tmp: np.savez(tmp, **arrays))


def readable_npz(path: str) -> bool:
    """Whether every array of an npz or arena artifact reads in full (the
    zip entry CRCs or arena section CRCs are checked on a full read)."""
    try:
        if path.endswith((ARENA_SUFFIX, COMPRESSED_SUFFIX)):
            load_arena(path)
            return True
        with np.load(path, allow_pickle=False) as z:
            for name in z.files:
                z[name]
        return True
    except CORRUPT_NPZ:
        return False


def read_arena_header(buf) -> tuple[dict, int]:
    """(header dict, absolute data start) of an in-memory arena."""
    head = bytes(buf[:16])
    if len(head) < 16 or head[:8] != ARENA_MAGIC:
        raise ValueError("not an arena file (bad magic)")
    hlen = struct.unpack("<Q", head[8:16])[0]
    raw = bytes(buf[16 : 16 + hlen])
    if len(raw) < hlen:
        raise ValueError("truncated arena header")
    header = json.loads(raw.decode("utf-8"))
    return header, _align_up(16 + hlen, header.get("align", ARENA_ALIGN))


def _arena_views(buf, header: dict, data_start: int, path: str,
                 verify: bool) -> dict[str, np.ndarray]:
    out = {}
    mv = memoryview(buf)
    for sec in header["sections"]:
        lo = data_start + sec["offset"]
        hi = lo + sec["nbytes"]
        if hi > len(mv):
            raise ValueError(
                f"{path}: arena section {sec['name']!r} extends past end "
                "of file (truncated artifact)")
        raw = mv[lo:hi]
        if verify:
            got = f"crc32:{zlib.crc32(raw):08x}"
            if got != sec["crc32"]:
                raise ValueError(
                    f"{path}: arena section {sec['name']!r} CRC mismatch "
                    f"(recorded {sec['crc32']}, found {got})")
        out[sec["name"]] = np.frombuffer(
            raw, dtype=np.dtype(sec["dtype"])).reshape(sec["shape"])
    return out


def integrity_names(index_dir: str, meta: IndexMetadata) -> list[str]:
    """The artifact files covered by metadata checksums, in the JAX
    package's order, filtered to what exists. The list names every file
    the JAX package covers, so an index it built verifies here too."""
    names = [f"part-{s:05d}{ext}" for s in range(meta.num_shards)
             for ext in (".npz", ".arena", ".carena")]
    if meta.has_positions:
        names += [f"positions-{s:05d}.npz" for s in range(meta.num_shards)]
    names += [f"chargram-k{ck}.npz" for ck in meta.chargram_ks]
    names += [DOCLEN, DICTIONARY, DOCNOS, VOCAB, "tokens.txt",
              "blockmax.arena"]
    return [n for n in names if os.path.exists(os.path.join(index_dir, n))]


def quarantine(index_dir: str, name: str, *, keep: int | None = None) -> str:
    """Move a corrupt artifact into index_dir/.quarantine/ (replacing an
    earlier quarantined copy of the same name), out of every reader's way
    but kept for a post-mortem; returns its new path. Only the `keep`
    most recently quarantined files stay (default TPU_IR_QUARANTINE_KEEP,
    8); older ones are deleted."""
    if keep is None:
        from .. import envvars

        keep = envvars.get_int("TPU_IR_QUARANTINE_KEEP")
    qdir = os.path.join(index_dir, QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    dest = os.path.join(qdir, name)
    os.replace(os.path.join(index_dir, name), dest)
    os.utime(dest)      # the quarantine time orders retention, not the mtime
    entries = sorted((e for e in os.scandir(qdir) if e.is_file()),
                     key=lambda e: e.stat().st_mtime, reverse=True)
    for stale in entries[max(keep, 1):]:
        try:
            os.remove(stale.path)
        except OSError:
            continue            # another process evicted it first
    return dest


def verify_checksums(index_dir: str, meta: IndexMetadata,
                     names: list[str] | None = None) -> int:
    """Verify recorded artifact checksums; raises IntegrityError naming
    the first corrupt or missing file, returns the number of files
    checked. `names` restricts the check."""
    checked = 0
    for name, want in meta.checksums.items():
        if names is not None and name not in names:
            continue
        path = os.path.join(index_dir, name)
        if not os.path.exists(path):
            raise IntegrityError(
                path, "file recorded in metadata checksums is missing")
        got = file_checksum(path)
        if got != want:
            raise IntegrityError(
                path, f"checksum mismatch (recorded {want}, found {got}); "
                "the artifact is corrupt — rebuild the index (or restore "
                "from a good copy)")
        checked += 1
    return checked


def save_shard(index_dir: str, shard: int, *, term_ids: np.ndarray,
               indptr: np.ndarray, pair_doc: np.ndarray,
               pair_tf: np.ndarray, df: np.ndarray,
               format_version: int = ARENA_FORMAT_VERSION,
               num_docs: int | None = None,
               tf_dtype: str = "auto") -> str:
    """Write one part file (v2, or v3 encoded by compress.encode_shard)
    and unlink the same shard's part of any other format. Returns the
    new file's CRC. v3 needs the index's num_docs: it sizes the
    block-index column, as in the JAX package's parts."""
    require_arena_format(format_version)
    arrays = dict(
        term_ids=term_ids.astype(np.int32),
        indptr=indptr.astype(np.int64),
        pair_doc=pair_doc.astype(np.int32),
        pair_tf=pair_tf.astype(np.int32),
        df=df.astype(np.int32),
    )
    if format_version == COMPRESSED_FORMAT_VERSION:
        if num_docs is None:
            raise ValueError("a v3 part needs the index's num_docs")
        arrays = compress.encode_shard(arrays, num_docs=num_docs,
                                       tf_dtype=tf_dtype)
    crc = write_arena_atomic(
        os.path.join(index_dir, part_name(shard, format_version)), **arrays)
    # a stale part of another format would be read and checksummed too
    for other in (FORMAT_VERSION, ARENA_FORMAT_VERSION,
                  COMPRESSED_FORMAT_VERSION):
        stale = os.path.join(index_dir, part_name(shard, other))
        if other != format_version and os.path.exists(stale):
            os.unlink(stale)
    return crc


def write_pair_shards(index_dir: str, df: np.ndarray, pair_doc: np.ndarray,
                      pair_tf: np.ndarray, num_shards: int):
    """Write term-sharded part files from CSR-ordered pair columns (sorted
    by term id with per-term runs of length df). Returns (shard_of,
    offset_of) for the dictionary."""
    shard_of, offset_of = shard_local_offsets(df, num_shards)
    pair_shard = np.repeat(shard_of, df.astype(np.int64))
    for s in range(num_shards):
        tids = np.nonzero(shard_of == s)[0].astype(np.int32)
        lens = df[tids].astype(np.int64)
        local_indptr = np.concatenate([[0], np.cumsum(lens)])
        sel = pair_shard == s
        save_shard(index_dir, s, term_ids=tids, indptr=local_indptr,
                   pair_doc=pair_doc[sel], pair_tf=pair_tf[sel],
                   df=df[tids])
    return shard_of, offset_of


def _shard_arrays(buf, path: str, *, verify: bool) -> dict[str, np.ndarray]:
    """The sections of an in-memory part, as they are on disk."""
    if not path.endswith((ARENA_SUFFIX, COMPRESSED_SUFFIX)):
        raise ValueError(f"{path}: v1 npz parts {_LATER}")
    header, data_start = read_arena_header(buf)
    return _arena_views(buf, header, data_start, path, verify=verify)


def load_shard(index_dir: str, shard: int, *,
               decode: bool = False) -> dict[str, np.ndarray]:
    """Map one part, whichever format is on disk, without verifying it. A
    compressed part's sections come back as they are, or decoded to the
    five raw arrays with `decode`."""
    path = part_path(index_dir, shard)
    z = _shard_arrays(np.memmap(path, dtype=np.uint8, mode="r"), path,
                      verify=False)
    return compress.decode_shard(z) if decode and compress.is_compressed(
        z) else z


def load_shard_verified(index_dir: str, shard: int,
                        meta: IndexMetadata) -> dict[str, np.ndarray]:
    """Verify-while-read shard load: one streamed pass folds the file's
    CRC32 and compares it with the metadata digest, then the arrays are
    viewed from the in-memory buffer (a compressed part's decoded).
    Raises IntegrityError on a mismatch or a missing part.

    In a mid-migration dir the part metadata names may be gone, already
    rewritten in the other format; that twin is read instead, with its
    recorded digest if metadata has one, else its section CRCs."""
    require_arena_format(meta.format_version)
    name = part_name(shard, meta.format_version)
    path = os.path.join(index_dir, name)
    want = meta.checksums.get(name) if meta.checksums else None
    if not os.path.exists(path):
        other = part_path(index_dir, shard)
        if not os.path.exists(other):
            raise IntegrityError(path, "part file missing")
        path = other
        want = (meta.checksums.get(os.path.basename(path))
                if meta.checksums else None)
    buf, crc = _read_file_verified(path)
    got = f"crc32:{crc:08x}"
    if want is not None and got != want:
        raise IntegrityError(
            path, f"checksum mismatch (recorded {want}, found {got}); "
            "the artifact is corrupt — rebuild the index (or restore "
            "from a good copy)")
    # the whole-file digest matched, so section CRCs only need checking
    # when metadata recorded nothing to pin the bytes
    z = _shard_arrays(buf, path, verify=want is None)
    return compress.decode_shard(z) if compress.is_compressed(z) else z


def save_chargram(index_dir: str, k: int, *, gram_codes: np.ndarray,
                  indptr: np.ndarray, term_ids: np.ndarray) -> None:
    savez_atomic(os.path.join(index_dir, chargram_name(k)),
                 gram_codes=gram_codes.astype(np.int64),
                 indptr=indptr.astype(np.int64),
                 term_ids=term_ids.astype(np.int32))


def load_chargram(index_dir: str, k: int) -> dict[str, np.ndarray]:
    with np.load(os.path.join(index_dir, chargram_name(k))) as z:
        return {name: z[name] for name in z.files}


def shard_assignment(vocab_size: int, num_shards: int) -> np.ndarray:
    """shard_of [V] = term_id % num_shards: the term-routing rule."""
    return np.arange(vocab_size, dtype=np.int32) % num_shards


def shard_local_offsets(df: np.ndarray, num_shards: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """(shard_of [V], offset_of [V]): each term's shard (term_id % shards)
    and its postings start within that shard's pair columns."""
    v = len(df)
    shard_of = shard_assignment(v, num_shards)
    offset_of = np.zeros(v, np.int64)
    for s in range(num_shards):
        tids = np.nonzero(shard_of == s)[0]
        offset_of[tids] = np.concatenate(
            [[0], np.cumsum(df[tids], dtype=np.int64)])[:-1]
    return shard_of, offset_of


def write_dictionary(index_dir: str, terms: list[str],
                     shard_of: np.ndarray, offset_of: np.ndarray) -> None:
    """Sorted 'term<TAB>shard<TAB>offset' lines, one per term."""
    tmp = os.path.join(index_dir, DICTIONARY + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        for tid, term in enumerate(terms):
            f.write(f"{term}\t{int(shard_of[tid])}\t{int(offset_of[tid])}\n")
    os.replace(tmp, os.path.join(index_dir, DICTIONARY))
