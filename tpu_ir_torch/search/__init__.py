"""Query serving on the dense and the tiered sparse layout."""

from .scorer import DENSE_BUDGET, Scorer, SearchResult

__all__ = ["DENSE_BUDGET", "Scorer", "SearchResult"]
