"""Text analysis: a pure-Python copy of `tpu_ir.analysis` (tag-aware
tokenizer, Terrier stopwords, Porter2). Kept as a copy so the port never
imports the JAX package; tests/test_torch_analysis.py pins the two to
identical token streams."""

from .analyzer import Analyzer, analyze
from .porter2 import Porter2Stemmer, stem
from .stopwords import TERRIER_STOPWORDS
from .tag_tokenizer import TagTokenizer, tokenize

__all__ = [
    "Analyzer",
    "analyze",
    "Porter2Stemmer",
    "stem",
    "TERRIER_STOPWORDS",
    "TagTokenizer",
    "tokenize",
]
