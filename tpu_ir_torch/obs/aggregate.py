"""Cross-process telemetry: N registries merged into one cluster view,
and the span spool (the port of `tpu_ir/obs/aggregate.py`, in its file
names and JSON: either package merges the other's spool).

The cumulative half rides on the registry's raw snapshot
(`TelemetryRegistry.collect_state()`: counters, bucket counts and the
gauges set, stamped with schema, seq, resets and run id):

- `merge_snapshots(snaps)`: counters add, histograms add bucket by
  bucket (the fixed shared bucket layout makes that exact, associative
  and commutative), gauges fold by their declared policy
  (registry.GAUGE_MERGE) in a fixed order; the per-process identities
  ride along.
- `gather_cluster()`: the live view of this process. `tpu_ir`'s gathers
  every process of a JAX distributed job; the port's multi-process
  gather comes with multihost serving over `torch.distributed`.
- the file spool (TPU_IR_TELEMETRY_DIR): each process writes
  `telemetry-<host>-<pid>-<seq>.json` (a temporary name, then a rename);
  `read_spool()` keeps the newest snapshot of each run id (snapshots are
  cumulative: two of one process would count it twice) and
  `merge_spool()` folds them. `SpoolWriter` refreshes this process's
  snapshot and its time-series store (obs/timeseries.py) on an interval,
  so a crashed process leaves a near-final record.

`stats --cluster`, `metrics --cluster` and the server's `/cluster` read
the merge.

The span half: each process appends the span records of the traces it
keeps as batch files `spans-<host>-<pid>-<seq>.json` ({"host", "pid",
"seq", "spans"}) in the same directory. A batch holds records no other
batch holds, so the reader folds every file; the writer keeps the newest
`_SPAN_SPOOL_KEEP` batches of its own process. `trace <id>` stitches a
waterfall from the spool after the processes that wrote it are gone.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time

from .. import envvars
from .histogram import NUM_BUCKETS, summary_from_counts
from .registry import GAUGE_MERGE, SNAPSHOT_SCHEMA, get_registry


def _process_index() -> int:
    """This process's rank in a live torch.distributed job, else 0 (read
    only when the caller already imported torch.distributed)."""
    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() \
                and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 — identity is best-effort
        pass
    return 0


def local_snapshot(reset: bool = False) -> dict:
    """This process's raw snapshot, stamped with its host, pid, wall time
    and process index."""
    snap = get_registry().collect_state(reset)
    snap["host"] = socket.gethostname()
    snap["pid"] = os.getpid()
    snap["time"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    snap["process_index"] = _process_index()
    return snap


def merge_snapshots(snaps: list) -> dict:
    """N raw snapshots folded into the cluster view: counters add,
    histogram buckets add element-wise, gauges fold by GAUGE_MERGE ("max"
    keeps the peak, "last" the newest snapshot's level, ordered by (time,
    seq, run id) so any order of the input gives one answer), and the
    per-process identities ride along. A snapshot of a newer schema, or
    a histogram of another bucket layout, raises rather than mis-sums."""
    for s in snaps:
        if s.get("schema", 0) > SNAPSHOT_SCHEMA:
            raise ValueError(
                f"snapshot schema {s.get('schema')} is newer than this "
                f"build understands ({SNAPSHOT_SCHEMA}); upgrade tpu-ir")
    counters: dict[str, int] = {}
    hist_counts: dict[str, list] = {}
    hist_sums: dict[str, float] = {}
    gauges: dict[str, float] = {}
    for s in sorted(snaps, key=lambda s: (s.get("time") or "",
                                          s.get("seq", 0),
                                          s.get("run_id") or "")):
        for k, v in s.get("gauges", {}).items():
            if GAUGE_MERGE.get(k) == "max":
                gauges[k] = max(gauges.get(k, float(v)), float(v))
            else:
                gauges[k] = float(v)
    for s in snaps:
        for k, v in s.get("counters", {}).items():
            counters[k] = counters.get(k, 0) + int(v)
        for name, h in s.get("histograms", {}).items():
            c = list(h["counts"])
            if len(c) != NUM_BUCKETS:
                raise ValueError(
                    f"histogram {name!r} has {len(c)} buckets, expected "
                    f"{NUM_BUCKETS} — mixed-version snapshots?")
            if name in hist_counts:
                hist_counts[name] = [a + b
                                     for a, b in zip(hist_counts[name], c)]
                hist_sums[name] += float(h["sum_s"])
            else:
                hist_counts[name] = c
                hist_sums[name] = float(h["sum_s"])
    return {
        "schema": SNAPSHOT_SCHEMA,
        "processes": len(snaps),
        "counters": counters,
        "gauges": gauges,
        "histograms": {n: summary_from_counts(c, hist_sums[n])
                       for n, c in sorted(hist_counts.items())},
        "per_process": [
            {"host": s.get("host"), "pid": s.get("pid"),
             "process_index": s.get("process_index"),
             "run_id": s.get("run_id"), "seq": s.get("seq"),
             "time": s.get("time"),
             "events": sum(s.get("counters", {}).values())}
            for s in snaps],
    }


def gather_cluster(reset: bool = False) -> dict:
    """The live cluster view of this process alone:
    merge_snapshots([local_snapshot(reset)]). `tpu_ir`'s gathers the
    snapshots of every process of a JAX distributed job; the port's
    gather across processes comes with multihost serving over
    torch.distributed, so a live job of more than one process raises
    here instead of answering for one."""
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "gather_cluster across torch.distributed processes is not "
            "ported; merge the spool (merge_spool) instead")
    return merge_snapshots([local_snapshot(reset)])


# -- the file spool ----------------------------------------------------------


def spool_dir() -> str | None:
    """The telemetry spool directory, or None when spooling is off."""
    return envvars.get_str("TPU_IR_TELEMETRY_DIR")


def spool_write(out_dir: str | None = None) -> str | None:
    """Write this process's snapshot into the spool (a temporary name,
    then a rename: a reader never sees a torn file) and delete this
    process's older ones. Returns the path, or None when no spool dir is
    set. Never raises: a full disk must not fail what it observes."""
    d = out_dir or spool_dir()
    if not d:
        return None
    try:
        os.makedirs(d, exist_ok=True)
        snap = local_snapshot()
        path = os.path.join(
            d, f"telemetry-{snap['host']}-{snap['pid']}-"
               f"{snap['seq']:06d}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f, default=repr)
        os.replace(tmp, path)
        prefix = f"telemetry-{snap['host']}-{snap['pid']}-"
        for name in os.listdir(d):
            if (name.startswith(prefix) and name.endswith(".json")
                    and os.path.join(d, name) != path):
                try:
                    os.unlink(os.path.join(d, name))
                except OSError:
                    pass
        return path
    except Exception:  # noqa: BLE001 — see the docstring
        return None


def read_spool(out_dir: str | None = None) -> list:
    """Every spooled snapshot, the newest (highest seq) of each run id
    only: snapshots are cumulative."""
    d = out_dir or spool_dir()
    if not d or not os.path.isdir(d):
        return []
    best: dict[str, dict] = {}
    for name in sorted(os.listdir(d)):
        if not (name.startswith("telemetry-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            continue
        key = snap.get("run_id") or name
        if key not in best or snap.get("seq", 0) > best[key].get("seq", 0):
            best[key] = snap
    return list(best.values())


def merge_spool(out_dir: str | None = None,
                include_local: bool = False) -> dict:
    """The spool's cluster view. With `include_local` (a process that is
    part of the cluster, not a fresh command) or an empty spool, this
    process's live snapshot is folded in and displaces its own spooled
    one, so a serving process that spools and answers /cluster counts
    itself once."""
    snaps = read_spool(out_dir)
    if include_local or not snaps:
        local = local_snapshot()
        snaps = [s for s in snaps
                 if s.get("run_id") != local["run_id"]] + [local]
    return merge_snapshots(snaps)


class SpoolWriter:
    """A daemon thread refreshing this process's spool files (its
    snapshot and its time-series store) every TPU_IR_SPOOL_INTERVAL
    seconds, so a crash leaves a near-final record. Named under the
    "tpu-ir-obs" prefix; stop() joins it and writes the last record."""

    def __init__(self, out_dir: str | None = None,
                 interval_s: float | None = None):
        self._dir = out_dir or spool_dir()
        self._interval = (interval_s if interval_s is not None
                          else envvars.get_float("TPU_IR_SPOOL_INTERVAL"))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "SpoolWriter":
        if self._dir and self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="tpu-ir-obs-spool", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            spool_write(self._dir)
            self._spool_timeseries()

    def _spool_timeseries(self) -> None:
        # the history rides the same cadence: one timeseries-<host>-<pid>
        # file a process, merged by /timeseries?cluster=1
        try:
            from . import timeseries

            timeseries.spool_write_store(self._dir)
        except Exception:  # noqa: BLE001 — spooling is best-effort
            pass

    def stop(self) -> None:
        """Stop the thread and write the last snapshot (the authoritative
        record of the run)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        spool_write(self._dir)
        self._spool_timeseries()


# -- the span spool ------------------------------------------------------------

_SPAN_SPOOL_KEEP = 64
_span_spool_lock = threading.Lock()
_span_spool_seq = 0


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
