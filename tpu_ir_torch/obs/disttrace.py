"""The process's service identity in distributed traces (the part of
`tpu_ir/obs/disttrace.py` the shard worker tier needs): a worker names
itself once (`set_service("worker-s0r1")`) and every span it opens
carries the name. Trace contexts, their propagation and stitching are
not ported yet."""

from __future__ import annotations

_SERVICE = "proc"


def set_service(name: str) -> None:
    """Label this process's spans (router, worker-s0r1, ...)."""
    global _SERVICE
    _SERVICE = str(name)


def service() -> str:
    """This process's service name ("proc" until one is set)."""
    return _SERVICE
