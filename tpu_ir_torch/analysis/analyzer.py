"""Analysis pipeline: tag-aware tokenize -> Terrier stopword filter -> Porter2.

Parity target: the reference analyzer facade
(ivory/tokenize/GalagoTokenizer.java:139-183) — tokenize with the tag
tokenizer, drop stopwords, then stem every surviving token (with a memo cache
cleared at 50k entries). Query text goes through the identical pipeline at
search time (reference IntDocVectorsForwardIndex.java:276,295).
"""

from __future__ import annotations

from .porter2 import Porter2Stemmer
from .stopwords import TERRIER_STOPWORDS
from .tag_tokenizer import TagTokenizer


class Analyzer:
    """Reusable analyzer. Unlike the reference (which constructs a fresh
    tokenizer+stemmer per document, defeating its own cache), one Analyzer
    instance is safe to reuse across documents and benefits from the stem
    cache. Output is identical either way: the cache is a pure memo."""

    def __init__(self) -> None:
        self._tokenizer = TagTokenizer()
        self._stemmer = Porter2Stemmer()

    def analyze(self, text: str) -> list[str]:
        stem = self._stemmer.stem
        return [
            stem(tok)
            for tok in self._tokenizer.tokenize(text)
            if tok not in TERRIER_STOPWORDS
        ]

    def is_stopword(self, word: str) -> bool:
        return word in TERRIER_STOPWORDS


def analyze(text: str) -> list[str]:
    return Analyzer().analyze(text)
