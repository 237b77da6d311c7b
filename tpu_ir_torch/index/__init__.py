"""Index build (one-shot and streaming) and on-disk format (format v2 raw
and v3 compressed arenas)."""

from .builder import build_index
from .streaming import build_index_streaming

__all__ = ["build_index", "build_index_streaming"]
