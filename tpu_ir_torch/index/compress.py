"""Compressed posting codec of format v3 (`part-*.carena`): bit-packed doc
columns and int8-LUT or bf16 tf.

A copy of `tpu_ir/index/compress.py`, byte-identical in what it writes. A
v3 part is an ordinary arena whose sections encode the same five arrays a
raw shard stores (term_ids / indptr / pair_doc / pair_tf / df):

- doc column: per term, postings re-sorted to ascending doc order and cut
  into groups. A grid group covers one block of BLOCK_WIDTH docs and packs
  each posting's offset from the block base at the group's bit width; a
  flat group covers a whole sparse term run at the width of its max doc.
  The encoder picks grid or flat per term by byte cost. Groups are byte
  aligned in one payload; their byte offsets are derived, never stored.
- tf column, in the same order: bf16 bit patterns plus an exception list
  for values bf16 cannot hold (always lossless), or int8 codes into a
  <= 256-entry int32 LUT (lossless with <= 256 distinct tfs, else
  floor-quantized and flagged lossy).

Decode restores the builders' canonical impact order (tf descending, doc
ascending per term) with one lexsort, and the encoder proves that
restoration before it writes anything.

bf16 is done with numpy bit operations (the card's host has no
ml_dtypes): encode rounds float32 to nearest even on the upper 16 bits,
decode shifts the 16 bits back up. The doc-range decode and the
`decode.*` counters of the JAX package are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Mapping

import numpy as np

logger = logging.getLogger(__name__)

CODEC_VERSION = 1

#: tf encodings (cinfo slot): int8 LUT codes / bf16 bit patterns
TF_INT8, TF_BF16 = 0, 1
TF_MODE_NAMES = {TF_INT8: "int8", TF_BF16: "bf16"}

#: group kinds (cterm_mode): block-grid groups / one flat whole-run group
_MODE_GRID, _MODE_FLAT = 0, 1

#: the doc-axis block width of the JAX package's block-max grid
#: (`blockmax.block_width()`'s default), which the grid groups share
BLOCK_WIDTH = 512

#: cinfo layout (int64 vector): codec version, block width, pair count,
#: group count, term count, num_docs, tf mode, tf lossy flag, and the
#: dtype codes needed to reproduce the raw arrays bit-identically
_INFO_LEN = 11
(_I_VERSION, _I_WIDTH, _I_PAIRS, _I_GROUPS, _I_TERMS, _I_NUM_DOCS,
 _I_TF_MODE, _I_TF_LOSSY, _I_INDPTR_DT, _I_DOC_DT, _I_TF_DT) = range(_INFO_LEN)

_DT_CODES = {0: np.int32, 1: np.int64, 2: np.uint32, 3: np.uint64}
_DT_TO_CODE = {np.dtype(v): k for k, v in _DT_CODES.items()}

#: the section whose presence marks a compressed arena
COMPRESS_INFO = "cinfo"


class CompressError(ValueError):
    """A shard that cannot be compressed with a byte-identical rollback."""


def num_blocks(num_docs: int, width: int) -> int:
    """Blocks covering the [0, num_docs] doc axis (slot 0 included)."""
    return -(-(num_docs + 1) // width)


def bf16_bits(values: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns of `values` (converted to float32
    first), rounded to nearest, ties to even: what numpy's cast to
    `ml_dtypes.bfloat16` gives for finite values."""
    u = np.asarray(values).astype(np.float32).view(np.uint32).astype(
        np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_to_float32(bits: np.ndarray) -> np.ndarray:
    """float32 values of uint16 bfloat16 bit patterns (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def bf16_exact(values: np.ndarray) -> np.ndarray:
    """Per value: does its float32 form round-trip bf16 exactly? (Its low
    16 bits are zero; integers up to 256 always are.)"""
    u = np.asarray(values).astype(np.float32).view(np.uint32)
    return (u & 0xFFFF) == 0


def _narrow_uint(max_value: int) -> np.dtype:
    for dt in (np.uint8, np.uint16, np.uint32):
        if max_value <= np.iinfo(dt).max:
            return np.dtype(dt)
    return np.dtype(np.uint64)


def _bit_widths(values: np.ndarray) -> np.ndarray:
    """Exact bit length per value (0 -> 0 bits): frexp's exponent is the
    bit length of a positive integer below 2**53."""
    v = np.asarray(values, np.int64)
    w = np.frexp(v.astype(np.float64))[1].astype(np.int64)
    return np.where(v > 0, w, 0)


def _pack_bits(values: np.ndarray, bit_start: np.ndarray, widths: np.ndarray,
               total_bytes: int) -> np.ndarray:
    """Scatter each value's `width` bits at its absolute bit offset. Values
    never overlap and groups are byte aligned, so the 8-byte big-endian
    windows share only zero bits and an add is an or."""
    payload = np.zeros(total_bytes + 8, np.uint8)
    if len(values):
        byte0 = bit_start >> 3
        shift = 64 - widths - (bit_start & 7)
        window = values.astype(np.uint64) << shift.astype(np.uint64)
        for k in range(8):
            lane = ((window >> np.uint64(8 * (7 - k))) & np.uint64(0xFF))
            np.add.at(payload, byte0 + k, lane.astype(np.uint8))
    return payload[:total_bytes]


def _unpack_bits(payload: np.ndarray, bit_start: np.ndarray,
                 widths: np.ndarray) -> np.ndarray:
    """Gather each value's `width` bits back out of the payload."""
    if not len(bit_start):
        return np.zeros(0, np.int64)
    buf = np.zeros(len(payload) + 8, np.uint8)
    buf[:len(payload)] = payload
    byte0 = bit_start >> 3
    window = np.zeros(len(bit_start), np.uint64)
    for k in range(8):
        window = (window << np.uint64(8)) | buf[byte0 + k].astype(np.uint64)
    shift = (64 - widths - (bit_start & 7)).astype(np.uint64)
    mask = np.where(widths > 0,
                    (np.uint64(1) << widths.astype(np.uint64))
                    - np.uint64(1), np.uint64(0))
    return ((window >> shift) & mask).astype(np.int64)


def _canonical_perm(term_idx: np.ndarray, doc: np.ndarray,
                    tf: np.ndarray) -> np.ndarray:
    """Permutation restoring the builders' impact order: per term, tf
    descending then doc ascending."""
    return np.lexsort((doc, -tf.astype(np.int64), term_idx))


def _segment_starts(counts: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts[:-1])]).astype(np.int64) \
        if len(counts) else np.zeros(0, np.int64)


def _encode_tf(tf: np.ndarray, tf_dtype: str) -> tuple[dict, int, bool]:
    """tf column sections in doc-ascending order: (sections, mode, lossy)."""
    uniq = np.unique(tf)
    if tf_dtype == "auto":
        tf_dtype = "int8" if len(uniq) <= 256 else "bf16"
    if tf_dtype == "int8":
        lossy = len(uniq) > 256
        if lossy:
            # floor-quantize to 256 anchors spread over the distinct
            # values; floor keeps every served tf <= its raw value
            anchor_idx = np.unique(np.linspace(
                0, len(uniq) - 1, 256).round().astype(np.int64))
            lut = uniq[anchor_idx].astype(np.int32)
        else:
            lut = uniq.astype(np.int32)
        codes = (np.searchsorted(lut, tf, side="right") - 1).astype(np.uint8)
        return ({"ctf_codes": codes, "ctf_lut": lut}, TF_INT8, lossy)
    if tf_dtype == "bf16":
        bits = bf16_bits(tf)
        back = np.clip(bf16_to_float32(bits).astype(np.float64), 0,
                       2**31 - 1).astype(np.int64)
        exc = np.flatnonzero(back != tf.astype(np.int64))
        return ({"ctf_bf16": bits,
                 "ctf_exc_idx": exc.astype(np.int64),
                 "ctf_exc_val": tf[exc].astype(np.int32)}, TF_BF16, False)
    raise CompressError(f"unknown tf dtype {tf_dtype!r} "
                        f"(expected int8|bf16|auto)")


def _decode_tf(sections: Mapping[str, np.ndarray], mode: int) -> np.ndarray:
    if mode == TF_INT8:
        lut = np.asarray(sections["ctf_lut"], np.int32)
        return lut[np.asarray(sections["ctf_codes"])]
    tf = np.clip(bf16_to_float32(sections["ctf_bf16"]).astype(np.float64),
                 0, 2**31 - 1).astype(np.int32)
    exc = np.asarray(sections["ctf_exc_idx"], np.int64)
    if len(exc):
        tf[exc] = np.asarray(sections["ctf_exc_val"], np.int32)
    return tf


def encode_shard(z: Mapping[str, np.ndarray], *, num_docs: int,
                 tf_dtype: str = "auto",
                 block_width: int | None = None) -> dict[str, np.ndarray]:
    """Encode one raw shard dict into compressed arena sections.

    Raises CompressError if the shard's posting order is not the canonical
    impact order (restoration would not be byte-identical) or if indptr is
    not the cumsum of df (it is derived, never stored)."""
    width = int(block_width or BLOCK_WIDTH)
    term_ids = np.asarray(z["term_ids"])
    df = np.asarray(z["df"])
    indptr = np.asarray(z["indptr"])
    pair_doc = np.asarray(z["pair_doc"])
    pair_tf = np.asarray(z["pair_tf"])
    expect = np.concatenate([[0], np.cumsum(df.astype(np.int64))])
    if not np.array_equal(indptr.astype(np.int64), expect):
        raise CompressError("indptr is not cumsum(df); refusing to drop it")
    P, T = len(pair_doc), len(df)
    term_idx = np.repeat(np.arange(T, dtype=np.int64), df.astype(np.int64))

    # doc-ascending order (docs are unique per term: a true permutation)
    doc_perm = np.lexsort((pair_doc, term_idx))
    docs = pair_doc[doc_perm].astype(np.int64)
    tfs = pair_tf[doc_perm]

    # the restoration proof: the canonical sort of the doc-ordered pairs
    # must reproduce the input arrays exactly
    restore = _canonical_perm(term_idx, docs, tfs.astype(np.int64))
    if not (np.array_equal(docs[restore], pair_doc.astype(np.int64))
            and np.array_equal(tfs[restore], pair_tf)):
        raise CompressError(
            "shard posting order is not the canonical impact order "
            "(tf desc, doc asc per term); compression would not round-trip")

    # candidate grid groups: runs of equal (term, doc // width)
    blk = docs // width
    if P:
        new_grp = np.concatenate(
            [[True], (term_idx[1:] != term_idx[:-1])
             | (blk[1:] != blk[:-1])])
        grp_start = np.flatnonzero(new_grp)
        grp_count = np.diff(np.concatenate([grp_start, [P]]))
        grp_term = term_idx[grp_start]
        grp_blk = blk[grp_start]
        off = docs - grp_blk.repeat(grp_count) * width
        grp_w = np.maximum.reduceat(_bit_widths(off), grp_start)
        grp_bytes = (grp_count * grp_w + 7) >> 3
        groups_per_term = np.bincount(grp_term, minlength=T).astype(np.int64)
    else:
        grp_start = grp_count = grp_term = grp_blk = grp_w = \
            grp_bytes = np.zeros(0, np.int64)
        groups_per_term = np.zeros(T, np.int64)

    # per-term flat alternative: one group, base 0, width of the max doc
    nz = df > 0
    t_maxdoc = np.zeros(T, np.int64)
    t_grid_payload = np.zeros(T, np.int64)
    if P:
        t_maxdoc[nz] = np.maximum.reduceat(docs, expect[:-1][nz])
        np.add.at(t_grid_payload, grp_term, grp_bytes)
    t_flat_w = _bit_widths(t_maxdoc)
    t_flat_payload = (df.astype(np.int64) * t_flat_w + 7) >> 3

    # metadata cost per group entry (count + block + width columns at
    # their worst-case dtypes; the choice only needs to be close)
    meta_cost = 7
    grid_cost = t_grid_payload + groups_per_term * meta_cost
    flat_cost = t_flat_payload + meta_cost
    flat = (flat_cost < grid_cost) & nz
    cterm_mode = np.where(flat, _MODE_FLAT, _MODE_GRID).astype(np.uint8)
    cterm_groups = np.where(flat, 1, groups_per_term).astype(np.uint32)

    # final group arrays: term-major, block-ascending within a term (grid
    # terms keep their grid groups; flat terms collapse to one)
    keep = ~flat[grp_term] if len(grp_term) else np.zeros(0, bool)
    f_count = np.concatenate([grp_count[keep], df[flat].astype(np.int64)])
    f_blk = np.concatenate([grp_blk[keep], np.zeros(int(flat.sum()),
                                                    np.int64)])
    f_w = np.concatenate([grp_w[keep], t_flat_w[flat]])
    f_term = np.concatenate([grp_term[keep],
                             np.flatnonzero(flat).astype(np.int64)])
    order = np.argsort(f_term, kind="stable")
    f_count, f_blk, f_w, f_term = (f_count[order], f_blk[order],
                                   f_w[order], f_term[order])

    # pack the doc column: per posting, its group's width and base (flat
    # groups pack absolute docids, base 0)
    G = len(f_count)
    post_grp = np.repeat(np.arange(G, dtype=np.int64), f_count)
    f_base = np.where(cterm_mode[f_term] == _MODE_FLAT, 0, f_blk * width)
    values = docs - f_base[post_grp] if P else np.zeros(0, np.int64)
    post_w = f_w[post_grp]
    grp_nbytes = (f_count * f_w + 7) >> 3
    grp_byte0 = np.concatenate(
        [[0], np.cumsum(grp_nbytes)])[:-1].astype(np.int64) \
        if G else np.zeros(0, np.int64)
    idx_in_grp = np.arange(P, dtype=np.int64) - _segment_starts(
        f_count)[post_grp] if P else np.zeros(0, np.int64)
    bit_start = grp_byte0[post_grp] * 8 + idx_in_grp * post_w
    total_bytes = int(grp_nbytes.sum())
    payload = _pack_bits(values, bit_start, post_w, total_bytes)

    tf_sections, tf_mode, tf_lossy = _encode_tf(tfs, tf_dtype)

    nblk = num_blocks(num_docs, width)
    info = np.zeros(_INFO_LEN, np.int64)
    info[_I_VERSION] = CODEC_VERSION
    info[_I_WIDTH] = width
    info[_I_PAIRS] = P
    info[_I_GROUPS] = len(f_count)
    info[_I_TERMS] = T
    info[_I_NUM_DOCS] = num_docs
    info[_I_TF_MODE] = tf_mode
    info[_I_TF_LOSSY] = int(tf_lossy)
    info[_I_INDPTR_DT] = _DT_TO_CODE[indptr.dtype]
    info[_I_DOC_DT] = _DT_TO_CODE[pair_doc.dtype]
    info[_I_TF_DT] = _DT_TO_CODE[pair_tf.dtype]

    return {
        COMPRESS_INFO: info,
        "term_ids": term_ids,
        "df": df,
        "cterm_mode": cterm_mode,
        "cterm_groups": cterm_groups,
        "cblk_count": f_count.astype(_narrow_uint(int(f_count.max())
                                                  if len(f_count) else 0)),
        "cblk_block": f_blk.astype(_narrow_uint(max(nblk, 1))),
        "cblk_width": f_w.astype(np.uint8),
        "cdoc_payload": payload,
        **tf_sections,
    }


def decode_shard(sections: Mapping[str, np.ndarray]) -> dict:
    """Decode compressed sections back to the raw shard dict, in the
    builders' canonical impact order."""
    info = np.asarray(sections[COMPRESS_INFO], np.int64)
    if info[_I_VERSION] != CODEC_VERSION:
        raise ValueError(f"unknown compressed codec version "
                         f"{int(info[_I_VERSION])}")
    width = int(info[_I_WIDTH])
    P, G, T = int(info[_I_PAIRS]), int(info[_I_GROUPS]), int(info[_I_TERMS])
    df = np.asarray(sections["df"])
    indptr_dt = _DT_CODES[int(info[_I_INDPTR_DT])]
    doc_dt = _DT_CODES[int(info[_I_DOC_DT])]
    tf_dt = _DT_CODES[int(info[_I_TF_DT])]
    indptr = np.concatenate(
        [[0], np.cumsum(df.astype(np.int64))]).astype(indptr_dt)

    f_count = np.asarray(sections["cblk_count"], np.int64)
    f_blk = np.asarray(sections["cblk_block"], np.int64)
    f_w = np.asarray(sections["cblk_width"], np.int64)
    cterm_mode = np.asarray(sections["cterm_mode"])
    cterm_groups = np.asarray(sections["cterm_groups"], np.int64)
    payload = np.asarray(sections["cdoc_payload"], np.uint8)

    grp_term = np.repeat(np.arange(T, dtype=np.int64), cterm_groups)
    grp_is_flat = cterm_mode[grp_term] == _MODE_FLAT
    grp_nbytes = (f_count * f_w + 7) >> 3
    grp_byte0 = np.concatenate([[0], np.cumsum(grp_nbytes)])[:-1] \
        if G else np.zeros(0, np.int64)

    docs = np.zeros(P, np.int64)
    tfs = np.zeros(P, np.int64)
    if P:
        post_grp = np.repeat(np.arange(G, dtype=np.int64), f_count)
        w_post = f_w[post_grp]
        idx_in_grp = np.arange(P, dtype=np.int64) - _segment_starts(
            f_count)[post_grp]
        bit_start = grp_byte0[post_grp] * 8 + idx_in_grp * w_post
        base = np.where(grp_is_flat[post_grp], 0, f_blk[post_grp] * width)
        docs = _unpack_bits(payload, bit_start, w_post) + base
        tfs = _decode_tf(sections, int(info[_I_TF_MODE])).astype(np.int64)

    term_idx = np.repeat(np.arange(T, dtype=np.int64), df.astype(np.int64))
    restore = _canonical_perm(term_idx, docs, tfs)
    return {
        "term_ids": np.asarray(sections["term_ids"]),
        "indptr": indptr,
        "pair_doc": docs[restore].astype(doc_dt),
        "pair_tf": tfs[restore].astype(tf_dt),
        "df": df,
    }


def is_compressed(names) -> bool:
    """True when an arena's section names mark the compressed codec."""
    return COMPRESS_INFO in set(names)


def shard_info(sections: Mapping[str, np.ndarray]) -> dict:
    """Codec facts of a compressed shard (no decode)."""
    info = np.asarray(sections[COMPRESS_INFO], np.int64)
    return {
        "codec_version": int(info[_I_VERSION]),
        "block_width": int(info[_I_WIDTH]),
        "pairs": int(info[_I_PAIRS]),
        "groups": int(info[_I_GROUPS]),
        "tf_dtype": TF_MODE_NAMES[int(info[_I_TF_MODE])],
        "tf_lossy": bool(info[_I_TF_LOSSY]),
    }


# ---------------------------------------------------------------------------
# index level: migrate-index --compress


def resolve_tf_dtype(index_dir: str, meta, tf_dtype: str = "auto") -> str:
    """Resolve "auto" to one tf mode for the whole index: int8 only when
    every shard is int8-lossless (<= 256 distinct tfs), else bf16, so the
    metadata carries one honest label."""
    if tf_dtype in ("int8", "bf16"):
        return tf_dtype
    if tf_dtype != "auto":
        raise CompressError(f"unknown tf dtype {tf_dtype!r} "
                            f"(expected int8|bf16|auto)")
    from . import format as fmt

    for s in range(meta.num_shards):
        z = fmt.load_shard(index_dir, s)
        if is_compressed(z):
            if shard_info(z)["tf_dtype"] == "bf16":
                return "bf16"
            continue
        if len(np.unique(np.asarray(z["pair_tf"]))) > 256:
            return "bf16"
    return "int8"


def compress_index(index_dir: str, meta, *, tf_dtype: str = "auto",
                   verify: bool = True) -> dict:
    """Rewrite every raw part of the index as a v3 compressed arena
    (verify-while-read from the raw copy unless `verify=False`, atomic
    write, raw twin unlinked) and stamp meta.format_version / tf_dtype /
    tf_lossy in memory; the caller records the checksums with one final
    metadata write. Parts already compressed are skipped, so a half-done
    run completes when run again. Positional indexes are not read by the
    port, so the JAX package's lossy-int8 positions probe has nothing to
    guard here."""
    from . import format as fmt

    mode = resolve_tf_dtype(index_dir, meta, tf_dtype)
    migrated = skipped = 0
    lossy = False
    for s in range(meta.num_shards):
        raw = fmt.load_shard(index_dir, s)
        if is_compressed(raw):
            lossy = lossy or shard_info(raw)["tf_lossy"]
            skipped += 1
            continue
        if verify:
            raw = fmt.load_shard_verified(index_dir, s, meta)
        fmt.save_shard(index_dir, s, term_ids=raw["term_ids"],
                       indptr=raw["indptr"], pair_doc=raw["pair_doc"],
                       pair_tf=raw["pair_tf"], df=raw["df"],
                       format_version=fmt.COMPRESSED_FORMAT_VERSION,
                       num_docs=meta.num_docs, tf_dtype=mode)
        # auto picks int8 only when every shard is lossless; an int8
        # asked for is lossy where the shard has more than 256 tfs
        lossy = lossy or (tf_dtype == "int8" and len(
            np.unique(np.asarray(raw["pair_tf"]))) > 256)
        migrated += 1
    meta.format_version = fmt.COMPRESSED_FORMAT_VERSION
    meta.tf_dtype = mode
    meta.tf_lossy = bool(lossy)
    return {"migrated": migrated, "skipped": skipped, "tf_dtype": mode,
            "tf_lossy": bool(lossy)}


def ensure_compressed(index_dir: str, meta) -> None:
    """The save_with_checksums hook: with TPU_IR_COMPRESS=1, compress the
    parts a build just wrote before the bounds and the checksums are
    recorded. A failure degrades loudly (a warning) to a raw or mixed dir,
    which every reader accepts, rather than failing a finished build;
    `migrate-index --compress` completes it later."""
    from .. import envvars

    if envvars.get_choice("TPU_IR_COMPRESS") != "1":
        return
    try:
        compress_index(index_dir, meta, verify=False)
    except Exception as e:  # noqa: BLE001 — compression is optional
        logger.warning(
            "index compression incomplete for %s (%s); the dir stays "
            "readable (mixed raw/compressed parts are accepted); finish "
            "with `migrate-index --compress`", index_dir, e)
