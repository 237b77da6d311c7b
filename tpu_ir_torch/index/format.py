"""On-disk index format: the subset the dense path writes and reads.

A copy of the parts of `tpu_ir/index/format.py` this slice needs, byte
compatible with it:

    index_dir/
      metadata.json     N, k, vocab size, shard count, counters, checksums
      docnos.txt        docid list, sorted; docno = 1-based position
      vocab.txt         term list, sorted; term id = 0-based position
      doclen.npy        int32 [N+1] total occurrences per docno (BM25)
      part-00000.arena  per term-shard CSR postings (format v2 arenas)
      dictionary.tsv    term -> (shard, offset) forward index

Term shard assignment is term_id % num_shards. Only format v2 (raw
page-aligned arenas) is read and written here. v1 npz parts, v3
compressed arenas (.carena) and the block-max bounds artifact belong to
later slices of the port and raise ValueError.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

FORMAT_VERSION = 1
ARENA_FORMAT_VERSION = 2
COMPRESSED_FORMAT_VERSION = 3
METADATA = "metadata.json"
DOCNOS = "docnos.txt"
VOCAB = "vocab.txt"
DOCLEN = "doclen.npy"
DICTIONARY = "dictionary.tsv"

_LATER = ("is not supported by tpu_ir_torch yet (a later slice of the "
          "port); only format v2 raw arenas are")


class IntegrityError(RuntimeError):
    """An index artifact failed its recorded checksum (or is missing)."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"{path}: {reason}")
        self.path = path
        self.reason = reason


def require_arena_format(format_version: int) -> None:
    """Raise ValueError unless the index is format v2 (raw arenas)."""
    if format_version != ARENA_FORMAT_VERSION:
        kind = ("v1 npz parts" if format_version < ARENA_FORMAT_VERSION
                else "v3 compressed arenas (.carena)")
        raise ValueError(f"index format {format_version} ({kind}) {_LATER}")


def part_name(shard: int) -> str:
    return f"part-{shard:05d}.arena"


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

    def save(self, index_dir: str) -> None:
        with open(os.path.join(index_dir, METADATA), "w") as f:
            json.dump(self.__dict__, f, indent=2, sort_keys=True)

    def save_with_checksums(self, index_dir: str) -> None:
        """Checksum every integrity-covered artifact on disk, record the
        digests, then save: metadata existence certifies the index and
        pins its bytes. Unlike the JAX package this writes no block-max
        bounds artifact (a later slice), so the checksum set lacks
        `blockmax.arena`."""
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


def write_arena_atomic(path: str, **arrays) -> str:
    """Temp file + rename, so a part's existence implies it is complete.
    Returns the file's CRC ('crc32:XXXXXXXX')."""
    tmp = path + ".tmp.arena"
    write_arena(tmp, arrays)
    crc = file_checksum(tmp)
    os.replace(tmp, path)
    return crc


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
               format_version: int = ARENA_FORMAT_VERSION) -> str:
    """Write one v2 part file; returns its CRC."""
    require_arena_format(format_version)
    return write_arena_atomic(
        os.path.join(index_dir, part_name(shard)),
        term_ids=term_ids.astype(np.int32),
        indptr=indptr.astype(np.int64),
        pair_doc=pair_doc.astype(np.int32),
        pair_tf=pair_tf.astype(np.int32),
        df=df.astype(np.int32),
    )


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


def load_shard_verified(index_dir: str, shard: int,
                        meta: IndexMetadata) -> dict[str, np.ndarray]:
    """Verify-while-read shard load: one streamed pass folds the file's
    CRC32 and compares it with the metadata digest, then the arrays are
    viewed from the in-memory buffer. Raises IntegrityError on a
    mismatch or a missing part."""
    require_arena_format(meta.format_version)
    name = part_name(shard)
    path = os.path.join(index_dir, name)
    want = meta.checksums.get(name) if meta.checksums else None
    if not os.path.exists(path):
        raise IntegrityError(path, "part file missing")
    buf, crc = _read_file_verified(path)
    got = f"crc32:{crc:08x}"
    if want is not None and got != want:
        raise IntegrityError(
            path, f"checksum mismatch (recorded {want}, found {got}); "
            "the artifact is corrupt — rebuild the index (or restore "
            "from a good copy)")
    header, data_start = read_arena_header(buf)
    # the whole-file digest matched, so section CRCs only need checking
    # when metadata recorded nothing to pin the bytes
    return _arena_views(buf, header, data_start, path, verify=want is None)


def shard_local_offsets(df: np.ndarray, num_shards: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """(shard_of [V], offset_of [V]): each term's shard (term_id % shards)
    and its postings start within that shard's pair columns."""
    v = len(df)
    shard_of = np.arange(v, dtype=np.int32) % num_shards
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
