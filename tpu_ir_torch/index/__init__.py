"""Index build (one-shot and streaming), merge, the on-disk format (v1
npz parts, v2 raw and v3 compressed arenas) and the live index
(segments, write-ahead log, ingest, backup)."""

from .builder import build_index
from .ingest import IngestWriter
from .merge import merge_indexes
from .segments import LiveIndex
from .streaming import build_index_streaming

__all__ = ["build_index", "build_index_streaming", "merge_indexes",
           "IngestWriter", "LiveIndex"]
