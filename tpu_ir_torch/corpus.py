"""The reference-scale synthetic TREC corpus of the repo's `ref` benchmark.

A copy of `bench.make_corpus` (bench.py:33-61): byte-identical output for
the same seed and arguments. The defaults are the reference course
project's PA1 job: 8,761 documents, 23.95 MB, drawn with a Zipf law from
30,000 random word shapes.
"""

from __future__ import annotations

import numpy as np

VOCAB_SIZE = 30_000
DOC_COUNT = 8_761
TARGET_BYTES = 23_950_858


def make_corpus(path: str, seed: int = 0, *, n_docs: int | None = None,
                target_bytes: int | None = None,
                vocab_size: int | None = None) -> int:
    """Write the corpus to `path`; returns its size in bytes."""
    n_docs = DOC_COUNT if n_docs is None else n_docs
    target_bytes = TARGET_BYTES if target_bytes is None else target_bytes
    vocab_size = VOCAB_SIZE if vocab_size is None else vocab_size
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    lengths = rng.integers(3, 11, vocab_size)
    words = np.array(["".join(rng.choice(letters, l)) for l in lengths])
    zipf_p = 1.0 / np.arange(1, vocab_size + 1)
    zipf_p /= zipf_p.sum()

    avg_doc_words = target_bytes // n_docs // 8  # ~8 bytes/word incl space
    n_words_per_doc = rng.integers(avg_doc_words // 2,
                                   avg_doc_words * 3 // 2, n_docs)
    all_ids = rng.choice(vocab_size, int(n_words_per_doc.sum()), p=zipf_p)
    total = 0
    pos = 0
    with open(path, "w") as f:
        for i in range(n_docs):
            n = int(n_words_per_doc[i])
            body = " ".join(words[all_ids[pos : pos + n]])
            pos += n
            rec = (f"<DOC>\n<DOCNO> SYN-{i:06d} </DOCNO>\n<TEXT>\n{body}\n"
                   f"</TEXT>\n</DOC>\n")
            f.write(rec)
            total += len(rec)
    return total
