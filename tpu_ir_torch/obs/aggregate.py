"""The span spool: distributed-trace records on disk (the span half of
`tpu_ir/obs/aggregate.py`'s file spool, in its file names and JSON).

Each process appends the span records of the traces it keeps as batch
files `spans-<host>-<pid>-<seq>.json` ({"host", "pid", "seq", "spans"})
in TPU_IR_TELEMETRY_DIR, written to a temporary name and renamed, so a
reader never sees a torn file. A batch holds records no other batch
holds, so the reader folds every file; the writer keeps the newest
`_SPAN_SPOOL_KEEP` batches of its own process. `trace <id>` stitches a
waterfall from the spool after the processes that wrote it are gone, and
either package reads the other's spool.
"""

from __future__ import annotations

import json
import os
import socket
import threading

from .. import envvars

_SPAN_SPOOL_KEEP = 64
_span_spool_lock = threading.Lock()
_span_spool_seq = 0


def spool_dir() -> str | None:
    """The telemetry spool directory, or None when spooling is off."""
    return envvars.get_str("TPU_IR_TELEMETRY_DIR")


def span_spool_write(spans: list, out_dir: str | None = None
                     ) -> str | None:
    """Write one batch of finished span records to the spool. Returns its
    path, or None when no spool dir is set or the batch is empty. Never
    raises: a full disk must not fail the request the spans describe."""
    d = out_dir or spool_dir()
    if not d or not spans:
        return None
    global _span_spool_seq
    try:
        os.makedirs(d, exist_ok=True)
        host = socket.gethostname()
        pid = os.getpid()
        with _span_spool_lock:
            _span_spool_seq += 1
            seq = _span_spool_seq
        path = os.path.join(d, f"spans-{host}-{pid}-{seq:06d}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"host": host, "pid": pid, "seq": seq,
                       "spans": spans}, f, default=repr)
        os.replace(tmp, path)
        # keep this process's newest batches
        prefix = f"spans-{host}-{pid}-"
        mine = sorted(n for n in os.listdir(d)
                      if n.startswith(prefix) and n.endswith(".json"))
        for name in mine[:-_SPAN_SPOOL_KEEP]:
            try:
                os.unlink(os.path.join(d, name))
            except OSError:
                pass
        return path
    except Exception:  # noqa: BLE001 — spooling must not fail serving
        return None


def read_span_spool(out_dir: str | None = None,
                    trace_id: str | None = None) -> list:
    """Every spooled span record of every process (only `trace_id`'s when
    given). An unreadable batch is skipped."""
    d = out_dir or spool_dir()
    if not d or not os.path.isdir(d):
        return []
    out = []
    for name in sorted(os.listdir(d)):
        if not (name.startswith("spans-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                batch = json.load(f)
        except (OSError, ValueError):
            continue
        for rec in batch.get("spans", ()):
            if trace_id is None or rec.get("trace_id") == trace_id:
                out.append(rec)
    return out
