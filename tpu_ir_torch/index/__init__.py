"""Index build and on-disk format (format v2 raw arenas)."""

from .builder import build_index

__all__ = ["build_index"]
