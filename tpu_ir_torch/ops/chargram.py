"""Char-k-gram -> term index construction on the device (the port's copy of
`tpu_ir/ops/chargram.py`).

Parity target: CharKGramTermIndexer: every vocabulary term is padded as
"$term$", each length-k byte window maps gram -> the set of terms that
hold it, and each gram's term list is sorted and deduplicated. Term ids
are assigned in lexicographic order, so sorted id lists are the
reference's sorted string lists.

The device path (1 <= k <= 3) packs each window's k bytes into one gram
code, makes one int64 key per (gram, term) window, `code * T + term`, and
sorts the keys (a stable sort; the full key orders by gram then term, so
duplicates are identical keys). Dropping equal neighbours removes the
repeats of a gram inside one term, and the run lengths of the grams
give `indptr`. The JAX package computes this outside any Pallas kernel;
here it is plain torch, on the card or on the CPU.

For 3 < k <= 7 the numpy twin (`build_chargram_index_host`) packs grams
into int64 codes, as the JAX package does. k > 7 is rejected: an 8-byte
gram whose leading byte is >= 0x80 would overflow int64's sign bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BOUNDARY = ord("$")  # terms are padded as $term$


class CharGramIndex(NamedTuple):
    """gram_codes int64 [G] sorted unique packed grams; indptr int64
    [G+1]; term_ids int64 [C], sorted within each gram."""

    gram_codes: torch.Tensor
    indptr: torch.Tensor
    term_ids: torch.Tensor


def pack_term_bytes(terms: list[str], k: int) -> tuple[np.ndarray, np.ndarray]:
    """'$term$' per term (utf-8) as a padded uint8 matrix: (bytes
    [T, Lmax], lengths int32 [T])."""
    encoded = [b"$" + t.encode("utf-8") + b"$" for t in terms]
    lmax = max(max((len(e) for e in encoded), default=k), k)
    out = np.zeros((len(encoded), lmax), np.uint8)
    lens = np.zeros((len(encoded),), np.int32)
    for i, e in enumerate(encoded):
        out[i, : len(e)] = np.frombuffer(e, np.uint8)
        lens[i] = len(e)
    return out, lens


def build_chargram_index(term_bytes: torch.Tensor, term_lens: torch.Tensor,
                         *, k: int) -> CharGramIndex:
    """The gram -> sorted term-id lists of a packed term matrix (uint8
    [T, Lmax], lengths [T]), on the matrix's device; 1 <= k <= 3."""
    if not 1 <= k <= 3:
        raise ValueError(
            "the device path packs k bytes into one code beside the term "
            "id; need 1<=k<=3 (use build_chargram_index_host for k<=7)")
    dev = term_bytes.device
    t, lmax = term_bytes.shape
    n_windows = max(lmax - k + 1, 1)
    codes = torch.zeros((t, n_windows), dtype=torch.int64, device=dev)
    for j in range(k):
        codes = (codes << 8) | term_bytes[:, j: j + n_windows].to(torch.int64)
    valid = (torch.arange(n_windows, device=dev)[None, :] + k
             <= term_lens.to(dev)[:, None])
    terms = torch.arange(t, dtype=torch.int64, device=dev)[:, None] \
        .expand(t, n_windows)
    keys = codes[valid] * max(t, 1) + terms[valid]
    keys, _ = torch.sort(keys, stable=True)
    keep = torch.ones_like(keys, dtype=torch.bool)
    keep[1:] = keys[1:] != keys[:-1]           # (gram, term) dedup
    keys = keys[keep]
    grams = keys // max(t, 1)
    gram_codes, counts = torch.unique_consecutive(grams, return_counts=True)
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(counts, 0)])
    return CharGramIndex(gram_codes, indptr, keys % max(t, 1))


def build_chargram_index_host(term_bytes: np.ndarray, term_lens: np.ndarray,
                              *, k: int
                              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy twin for 1 <= k <= 7 (int64 gram codes of at most 56 bits):
    (gram_codes int64 [G], indptr int64 [G+1], term_ids int32 [C])."""
    if not 1 <= k <= 7:
        raise ValueError(
            "gram codes must stay within int64's positive range; need "
            "1<=k<=7 (56-bit codes)")
    t, lmax = term_bytes.shape
    n_windows = max(lmax - k + 1, 1)
    codes = np.zeros((t, n_windows), np.int64)
    for j in range(k):
        codes = (codes << 8) | term_bytes[:, j: j + n_windows].astype(
            np.int64)
    valid = (np.arange(n_windows)[None, :] + k) <= term_lens[:, None]
    flat_codes = codes[valid]
    flat_terms = np.broadcast_to(
        np.arange(t, dtype=np.int32)[:, None], codes.shape)[valid]
    order = np.lexsort((flat_terms, flat_codes))
    g, tm = flat_codes[order], flat_terms[order]
    keep = np.ones(len(g), bool)
    keep[1:] = (np.diff(g) != 0) | (np.diff(tm) != 0)
    g, tm = g[keep], tm[keep]
    gram_codes, counts = np.unique(g, return_counts=True)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return gram_codes.astype(np.int64), indptr, tm.astype(np.int32)


def code_to_gram(code: int, k: int) -> str:
    """Unpack a gram code back to its k-byte string."""
    bs = bytes((code >> (8 * (k - 1 - j))) & 0xFF for j in range(k))
    return bs.decode("utf-8", "replace")


def gram_to_code(gram: str | bytes, k: int) -> int:
    bs = gram if isinstance(gram, bytes) else gram.encode("utf-8")
    if len(bs) != k:
        raise ValueError(f"gram {gram!r} is not {k} bytes")
    code = 0
    for b in bs:
        code = (code << 8) | b
    return code
