"""Index build (one-shot and streaming), merge, and the on-disk format
(v1 npz parts, v2 raw and v3 compressed arenas)."""

from .builder import build_index
from .merge import merge_indexes
from .streaming import build_index_streaming

__all__ = ["build_index", "build_index_streaming", "merge_indexes"]
