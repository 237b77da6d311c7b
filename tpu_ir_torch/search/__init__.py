"""Query serving on the dense and the tiered sparse layout, wildcard and
fuzzy lookup over the char-gram index, and run-file evaluation."""

from .scorer import DENSE_BUDGET, Scorer, SearchResult
from .wildcard import WildcardLookup

__all__ = ["DENSE_BUDGET", "Scorer", "SearchResult", "WildcardLookup"]
