"""Query serving on the dense layout."""

from .scorer import DENSE_BUDGET, Scorer, SearchResult

__all__ = ["DENSE_BUDGET", "Scorer", "SearchResult"]
