"""Shard workers of the scatter-gather serving tier and their elastic
membership (the port of `tpu_ir/serving/shardset.py`).

One index, S doc shards, R replicas a shard: every worker is a whole
serving process (a Scorer and a ServingFrontend with admission, the
degradation ladder, the breaker and deadline fallback) restricted to its
shard's docids (`Scorer.load(doc_range=)`: the layout keeps its whole
geometry with the postings outside the range tf-zeroed, so a doc scores
bitwise as in one process and serving/router.py's merges are exact). A
worker serves over obs/server.py:

  POST /rpc/search     {"text", "k", "scoring"} -> its top-k (raw docids
                       and scores, tagged with level, degraded and the
                       index generation)
  POST /rpc/cosine_at  {"text", "cand": [docids]} -> the rerank's stage-2
                       cosine scores at the merged candidates
  POST /rpc/reload     {"generation"} (a live index only): load, warm and
                       publish another generation (serving/generation.py)
  GET  /healthz        the health payload and the worker's identity
                       (shard, replica, doc range, spawn and index
                       generation, its kernel launches, and those of
                       its warm-ups)

Two forms share this code: `serve_worker()` runs a worker in the calling
process, and `ShardSet` runs each (shard, replica) as `python -m
tpu_ir_torch.serving.shardset <config.json>`, with a ready file written
after the warm-up, SIGKILL-able and respawned with a bumped spawn
generation. A worker exits when its stdin closes, so a parent that dies
leaves no worker serving. Every worker runs on its config's `device`
(the card unless it says "cpu"); on one card the workers are processes
sharing it. The grid is elastic: `ShardSet.grow` adds one warm replica a
shard and `retire_replica` drains one away (serving/autoscale.py drives
both).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time

logger = logging.getLogger(__name__)

READY_POLL_S = 0.05
# a grown worker warms up at this nice level, so its start steals less of
# the host from the serving it is meant to relieve; full priority comes
# back once its ready file lands (that needs CAP_SYS_NICE: without it the
# worker serves niced, still warm)
GROW_NICE = 5
# the directory that holds the tpu_ir_torch package: a worker imports it
# from there whatever the parent's working directory
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class RPCError(RuntimeError):
    """A worker RPC that failed. Subclasses say how, which is what a
    caller that fails over tells apart: the worker could not be reached
    (RPCConnectError), it shed the request (RPCShedError: its 503 with a
    reason and a level), or it answered another status (RPCStatusError).
    A connection that breaks or times out after the request went out
    raises the socket's own error."""


class RPCConnectError(RPCError):
    """The connection was refused, reset or timed out before the request
    was sent: no worker listens at the address (a killed or a lost one)."""


class RPCStatusError(RPCError):
    """The worker answered a status other than 200 (`status`, `body`)."""

    def __init__(self, addr: str, path: str, status: int, body: bytes):
        self.status = int(status)
        self.body = body
        super().__init__(f"worker {addr} /rpc/{path} -> {status}: "
                         f"{body[:200]!r}")


class RPCShedError(RPCStatusError):
    """The worker shed the request (503 Overloaded): `reason` and
    `level` are its Overloaded's."""

    def __init__(self, addr: str, path: str, status: int, body: bytes):
        super().__init__(addr, path, status, body)
        try:
            info = json.loads(body)
        except ValueError:
            info = {}
        self.reason = info.get("reason")
        self.level = info.get("level")


def rpc_post(addr: str, path: str, payload: dict, timeout_s: float, *,
             connect_timeout_s: float | None = None,
             headers: dict | None = None) -> dict:
    """One worker RPC: POST `payload` as JSON to http://addr/rpc/<path>
    and return the JSON answer. The one client of the worker surface
    (the router's fan-out, rolling swaps, tests). `connect_timeout_s`
    (None: `timeout_s`) bounds the TCP connect, `timeout_s` each read
    after it; `headers` go beside Content-Type (the router's
    `traceparent`). Raises RPCConnectError when the connect fails,
    RPCShedError on a 503 shed, RPCStatusError on another status, and
    the socket's error when the exchange breaks after the connect; the
    caller decides what a failure means."""
    import http.client

    host, port = addr.rsplit(":", 1)
    timeout_s = max(timeout_s, 1e-3)
    connect_s = (timeout_s if connect_timeout_s is None
                 else max(min(connect_timeout_s, timeout_s), 1e-3))
    conn = http.client.HTTPConnection(host, int(port), timeout=connect_s)
    try:
        try:
            conn.connect()
        except OSError as e:
            raise RPCConnectError(f"worker {addr} unreachable: {e!r}") from e
        conn.sock.settimeout(timeout_s)
        conn.request("POST", f"/rpc/{path}", body=json.dumps(payload),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        body = resp.read()
        if resp.status == 503:
            raise RPCShedError(addr, path, resp.status, body)
        if resp.status != 200:
            raise RPCStatusError(addr, path, resp.status, body)
        return json.loads(body)
    finally:
        conn.close()


def get_worker_health(addr: str, timeout_s: float) -> dict:
    """One worker's /healthz payload."""
    import http.client

    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port),
                                      timeout=max(timeout_s, 1e-3))
    try:
        conn.request("GET", "/healthz")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def worker_rpc_handlers(frontend, *, reload_fn=None) -> dict:
    """The worker's RPC handlers over its frontend. The scorer is read
    from the frontend on every call, so the call after a generation swap
    serves, and tags, the new generation; every answer names its
    generation, so a merge never mixes two snapshots. `reload_fn(gen)`
    (a live index's worker only) serves /rpc/reload."""

    def search(payload: dict) -> dict:
        res = frontend.search(
            str(payload["text"]), k=int(payload.get("k", 10)),
            scoring=str(payload.get("scoring", "tfidf")), rerank=None,
            return_docids=False)
        return {"hits": [[int(d), float(s)] for d, s in res],
                "level": res.level, "degraded": bool(res.degraded),
                "generation": int(res.generation)}

    def cosine_at(payload: dict) -> dict:
        sc = frontend.scorer
        scores = sc.cosine_scores_at(
            [str(payload["text"])],
            [int(c) for c in payload.get("cand", [])])
        return {"scores": [float(s) for s in scores[0]],
                "generation": int(sc.generation)}

    handlers = {"search": search, "cosine_at": cosine_at}
    if reload_fn is not None:
        def reload(payload: dict) -> dict:
            gen = payload.get("generation")
            return reload_fn(None if gen is None else int(gen))

        handlers["reload"] = reload
    return handlers


def serve_worker(index_dir: str, shard: int, num_shards: int, *,
                 layout: str = "sparse", port: int = 0,
                 host: str = "127.0.0.1", replica: int = 0,
                 generation: int = 0, index_generation: int | None = None,
                 deadline_s: float | None = None, max_concurrency: int = 4,
                 max_queue: int = 16, warm: bool = True, device=None):
    """Load this shard's doc-range scorer on `device`, wrap it in a
    ServingFrontend and serve it over an RPC server. Returns (server,
    frontend, scorer); the caller owns `server.stop()`.

    On a live index dir (index/segments.py) the worker serves
    `index_generation` (None: the newest servable one) and answers
    /rpc/reload: load the named generation (None: the newest) with the
    doc range recomputed for its doc count, warm it, and publish it; the
    old generation serves until the publish. `generation` is the spawn
    generation (ShardSet.respawn bumps it), another axis; /healthz shows
    both. `warm` runs the shape warm-up and the residency hint before
    this returns."""
    from ..index import format as fmt
    from ..index import segments as seg
    from ..obs import disttrace
    from ..obs.server import MetricsServer
    from ..search.layout import shard_doc_ranges
    from ..search.scorer import Scorer
    from .frontend import ServingConfig, ServingFrontend
    from .residency import prewarm_hot_residency

    live = seg.is_live(index_dir)

    def load_for(gen: int | None) -> Scorer:
        # each generation deals its (possibly grown) doc count over the
        # same shard grid
        resolved, g = seg.resolve_serving(index_dir, gen)
        meta = fmt.IndexMetadata.load(resolved)
        rg = shard_doc_ranges(meta.num_docs, num_shards)[shard]
        return Scorer.load_generation(index_dir, g, layout=layout,
                                      deadline_s=deadline_s, doc_range=rg,
                                      device=device)

    scorer = load_for(index_generation)
    warm_launches = WarmLaunches()
    disttrace.set_service(f"worker-s{shard}r{replica}")
    frontend = ServingFrontend(scorer, ServingConfig(
        max_concurrency=max_concurrency, max_queue=max_queue,
        deadline_s=deadline_s))
    residency = {"engaged": False}

    def info() -> dict:
        sc = frontend.scorer
        return {"worker": {
            "shard": shard, "replica": replica, "num_shards": num_shards,
            "doc_range": list(sc.doc_range or ()),
            "generation": generation,
            "index_generation": sc.generation,
            "live": live,
            "residency": residency,
            "in_flight": frontend.admission.in_flight(),
            "queued": frontend.admission.queue_depth(),
            # nothing compiles per shape in the port; its launches of
            # each hand-written kernel stand beside the JAX keys
            "compiles": {"count": None, "recompiles": None},
            **warm_launches.snapshot(),
            "pid": os.getpid(), "layout": sc.layout,
        }}

    reload_fn = None
    if live:
        def reload_fn(gen: int | None) -> dict:
            new = load_for(gen)
            if warm:
                # warmed before the publish: the first request after the
                # swap pays no first-dispatch cost
                with warm_launches.counting():
                    _warm_worker(new)
                    residency.clear()
                    residency.update(prewarm_hot_residency(new))
            frontend.reload_generation(new)
            return {"generation": new.generation,
                    "num_docs": new.meta.num_docs,
                    "doc_range": list(new.doc_range or ())}

    server = MetricsServer(
        port=port, host=host,
        rpc_handlers=worker_rpc_handlers(frontend, reload_fn=reload_fn),
        extra_health=info).start()
    if warm:
        with warm_launches.counting():
            _warm_worker(scorer)
            residency.update(prewarm_hot_residency(scorer))
    return server, frontend, scorer


class WarmLaunches:
    """A worker's kernel launches split for /healthz: `kernel_launches`,
    every launch of the process, and `warm_launches`, those of its
    warm-ups (at the start and at each reload). The counters are the
    process's, so a request served while a reload warms counts as the
    warm-up's: the difference of the two is a lower bound of the
    launches the served requests made, never more."""

    def __init__(self):
        self._lock = threading.Lock()
        self._done: dict = {}
        self._base: dict | None = None  # the counts a running warm-up began at
        self._running = 0

    @contextlib.contextmanager
    def counting(self):
        """The launches inside this block are a warm-up's."""
        import tpu_ir_torch

        with self._lock:
            if not self._running:
                self._base = tpu_ir_torch.kernel_launches()
            self._running += 1
        try:
            yield
        finally:
            now = tpu_ir_torch.kernel_launches()
            with self._lock:
                self._running -= 1
                if not self._running:
                    for n, v in now.items():
                        self._done[n] = (self._done.get(n, 0) + v
                                         - self._base.get(n, 0))
                    self._base = None

    def snapshot(self) -> dict:
        """{"kernel_launches", "warm_launches"}, read at one instant: a
        warm-up under way counts every launch since it began."""
        import tpu_ir_torch

        with self._lock:
            now = tpu_ir_torch.kernel_launches()
            warm = {n: self._done.get(n, 0) for n in now}
            if self._base is not None:
                for n in now:
                    warm[n] += now[n] - self._base.get(n, 0)
        return {"kernel_launches": now, "warm_launches": warm}


def shard_doc_ranges_for(index_dir: str, shard: int,
                         num_shards: int) -> tuple:
    """This shard's (lo, hi) from the index's metadata (a live dir's
    newest servable generation): the partition every worker derives."""
    from ..index import format as fmt
    from ..index import segments as seg
    from ..search.layout import shard_doc_ranges

    resolved, _ = seg.resolve_serving(index_dir)
    meta = fmt.IndexMetadata.load(resolved)
    return shard_doc_ranges(meta.num_docs, num_shards)[shard]


def _warm_worker(scorer, ks=(10,), rerank_ks=(25,)) -> None:
    """Run the shapes real traffic makes once (1-3 term texts, each depth
    in `ks`, both scorings; the rerank's stage 1 at each depth in
    `rerank_ks` and its [1, C] cosine gather), over cold terms and, on
    the tiered layout, with a hot term too (the MaxScore schedule runs
    other code for blocks with hot terms), so no routed request pays a
    first dispatch."""
    import numpy as np

    all_terms = list(scorer.vocab.terms)
    if not all_terms:
        return

    def prefixes(ts):
        return [" ".join(ts[:n]) for n in range(1, len(ts) + 1)]

    texts = prefixes(all_terms[:3])
    if scorer.layout == "sparse":
        hot_ids = np.nonzero(scorer._hot_rank_host >= 0)[0]
        if len(hot_ids):
            texts += prefixes([scorer.vocab.term(int(hot_ids[0]))]
                              + all_terms[:2])
    for scoring in ("tfidf", "bm25"):
        for txt in texts:
            for k in ks:
                scorer.search_batch([txt], k=int(k), scoring=scoring,
                                    return_docids=False)
    for c in rerank_ks:
        for txt in texts:
            scorer.search_batch([txt], k=int(c), scoring="bm25",
                                return_docids=False)
            scorer.cosine_scores_at([txt], [0] * int(c))


# -- the subprocess worker ----------------------------------------------------


def _watch_parent() -> None:
    """Exit when the parent closes our stdin (it died or stopped us), so
    no worker outlives the process that spawned it. The watcher reads the
    raw descriptor: a thread parked in the buffered reader holds its lock,
    and an interpreter that shuts down (after SIGTERM) while it does
    aborts."""

    def run():
        try:
            while os.read(sys.stdin.fileno(), 1):
                pass
        except Exception:  # noqa: BLE001 — any read failure means gone
            pass
        os._exit(0)

    threading.Thread(target=run, name="tpu-ir-worker-parent-watch",
                     daemon=True).start()


def sigterm_flag() -> list:
    """A list that SIGTERM appends to (left empty off the main thread,
    where no handler can be set). The handler takes no lock: one that
    set a threading.Event could deadlock against the main thread inside
    that Event's wait."""
    stopped: list = []
    try:
        signal.signal(signal.SIGTERM, lambda *_: stopped.append(True))
    except ValueError:
        pass
    return stopped


def wait_until(stopped: list, seconds: float | None = None) -> None:
    """Sleep in short steps until `stopped` holds something, `seconds`
    pass, or Ctrl-C."""
    deadline = None if seconds is None else time.monotonic() + seconds
    try:
        while not stopped and (deadline is None
                               or time.monotonic() < deadline):
            time.sleep(0.05)
    except KeyboardInterrupt:
        pass


def worker_main(config_path: str) -> int:
    """`python -m tpu_ir_torch.serving.shardset <config.json>`: serve until
    SIGTERM or the parent's death. The ready file (port, pid, shard,
    replica, spawn generation; an atomic rename) is written after the
    warm-up, so a parent that sees it may send traffic at once."""
    with open(config_path, encoding="utf-8") as f:
        cfg = json.load(f)
    _watch_parent()
    # before the load: a SIGTERM that comes early still stops cleanly
    stopped = sigterm_flag()
    index_generation = cfg.get("index_generation")
    server, _frontend, _scorer = serve_worker(
        cfg["index_dir"], int(cfg["shard"]), int(cfg["num_shards"]),
        layout=cfg.get("layout", "sparse"), port=int(cfg.get("port", 0)),
        replica=int(cfg.get("replica", 0)),
        generation=int(cfg.get("generation", 0)),
        index_generation=(None if index_generation is None
                          else int(index_generation)),
        deadline_s=cfg.get("deadline_s"),
        max_concurrency=int(cfg.get("max_concurrency", 4)),
        max_queue=int(cfg.get("max_queue", 16)),
        warm=bool(cfg.get("warm", True)), device=cfg.get("device"))
    ready = {"port": server.port, "pid": os.getpid(),
             "shard": cfg["shard"], "replica": cfg.get("replica", 0),
             "generation": cfg.get("generation", 0)}
    tmp = cfg["ready_path"] + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(ready, f)
    os.replace(tmp, cfg["ready_path"])
    try:
        wait_until(stopped)
    finally:
        server.stop()
        # a deadline-abandoned dispatch may still be on the card; let it
        # end before the interpreter tears down
        from .. import faults

        faults.drain_abandoned(timeout_s=5.0)
    return 0


class WorkerHandle:
    """One (shard, replica) subprocess: its Popen, address and spawn
    generation. `alive` tells a serving worker from a killed one whose
    slot awaits a respawn."""

    __slots__ = ("shard", "replica", "generation", "proc", "host",
                 "port", "pid")

    def __init__(self, shard: int, replica: int, generation: int,
                 proc, host: str, port: int, pid: int):
        self.shard = shard
        self.replica = replica
        self.generation = generation
        self.proc = proc
        self.host = host
        self.port = port
        self.pid = pid

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class ShardSet:
    """Spawn and manage the S x R grid of worker subprocesses, whose
    membership changes under traffic.

    The grid changes under one lock: `kill` SIGKILLs a replica (its slot
    keeps the stale address, as a lost host looks to a caller) and
    `respawn` brings it back with a bumped spawn generation. Every slot
    has a lifecycle state (warming, active, draining, retired) and every
    transition bumps the membership `epoch`, which rolling_swap re-reads
    to walk a grid that changed under it again. `addresses()` is every
    slot's address, `dispatchable()` only the active ones': the router
    dials those, which gives the two contracts of the elastic fleet:

    - **warm start**: a grown replica is `warming` until its ready file
      lands, and the worker writes that file only after its shape
      warm-up and the residency pre-warm, so no routed request reaches a
      cold process;
    - **drain-not-drop**: a retiring replica goes `draining` (new
      fan-outs leave it out at once) but keeps serving; retire polls its
      admitted requests to zero before SIGTERM, so requests already sent
      to it complete. An attempt from a grid read before the drain that
      lands after the poll fails over at the router and is answered or
      shed, never lost: shed + served == submitted holds across every
      membership change."""

    def __init__(self, index_dir: str, *, shards: int, replicas: int = 1,
                 layout: str = "sparse", deadline_s: float | None = None,
                 rundir: str | None = None, warm: bool = True,
                 max_concurrency: int = 4, max_queue: int = 16,
                 spawn_timeout_s: float = 120.0,
                 index_generation: int | None = None, device=None):
        if shards < 1 or replicas < 1:
            raise ValueError("shards and replicas must be >= 1")
        self.index_dir = index_dir
        # a live index's spawns load this generation (None: each worker
        # resolves the newest servable one)
        self.index_generation = index_generation
        self.shards = shards
        self.replicas = replicas
        self.layout = layout
        self.deadline_s = deadline_s
        self.warm = warm
        self.max_concurrency = max_concurrency
        self.max_queue = max_queue
        self.spawn_timeout_s = spawn_timeout_s
        self.device = "cuda" if device is None else str(device)
        import tempfile

        self.rundir = rundir or tempfile.mkdtemp(prefix="tpu-ir-shardset-")
        os.makedirs(self.rundir, exist_ok=True)
        self._lock = threading.Lock()
        self._grid: list[list[WorkerHandle | None]] = [
            [None] * replicas for _ in range(shards)]
        self._state: list[list[str]] = [
            ["warming"] * replicas for _ in range(shards)]
        self._epoch = 0
        # ("up" | "down", shard, replica, epoch): a replica that entered
        # or left the dispatch grid
        self._events: list[tuple] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ShardSet":
        """Spawn every worker at once (each pays an interpreter, the torch
        import, the device context, the load and the warm-up), then wait
        for every ready file."""
        procs = []
        try:
            for s in range(self.shards):
                for r in range(self.replicas):
                    procs.append((s, r, self._spawn(s, r, generation=0)))
            deadline = time.monotonic() + self.spawn_timeout_s
            for s, r, (proc, ready_path) in procs:
                handle = self._wait_ready(s, r, 0, proc, ready_path,
                                          deadline)
                with self._lock:
                    self._grid[s][r] = handle
                    self._state[s][r] = "active"
                    self._epoch += 1
        except BaseException:
            # a worker that failed takes its siblings down with it
            for _, _, (proc, _) in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait(timeout=30.0)
            raise
        return self

    def _cfg_paths(self, shard: int, replica: int, generation: int):
        base = f"worker-{shard}-{replica}-g{generation}"
        return (os.path.join(self.rundir, base + ".json"),
                os.path.join(self.rundir, base + ".ready"))

    def log_path(self, shard: int, replica: int) -> str:
        """The worker's stdout and stderr, every incarnation appended."""
        return os.path.join(self.rundir, f"worker-{shard}-{replica}.log")

    def _spawn(self, shard: int, replica: int, *, generation: int,
               nice: int = 0):
        cfg_path, ready_path = self._cfg_paths(shard, replica, generation)
        # a reused slot never reads an earlier incarnation's ready file
        if os.path.exists(ready_path):
            os.unlink(ready_path)
        cfg = {
            "index_dir": self.index_dir, "shard": shard,
            "num_shards": self.shards, "replica": replica,
            "generation": generation,
            "index_generation": self.index_generation,
            "layout": self.layout, "deadline_s": self.deadline_s,
            "warm": self.warm, "max_concurrency": self.max_concurrency,
            "max_queue": self.max_queue, "port": 0,
            "ready_path": ready_path, "device": self.device,
        }
        with open(cfg_path, "w", encoding="utf-8") as f:
            json.dump(cfg, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PKG_PARENT, env.get("PYTHONPATH")) if p)
        log = open(self.log_path(shard, replica), "ab")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "tpu_ir_torch.serving.shardset",
                 cfg_path], stdin=subprocess.PIPE, stdout=log, stderr=log,
                env=env)
        finally:
            log.close()   # the child holds its own descriptor
        if nice:
            # set from here, not in a pre-exec hook (a fork of a threaded
            # parent); the child's first instants run at the parent's
            try:
                os.setpriority(os.PRIO_PROCESS, proc.pid, nice)
            except OSError:
                pass
        return proc, ready_path

    def _wait_ready(self, shard: int, replica: int, generation: int,
                    proc, ready_path: str, deadline: float):
        while time.monotonic() < deadline:
            if os.path.exists(ready_path):
                with open(ready_path, encoding="utf-8") as f:
                    ready = json.load(f)
                return WorkerHandle(shard, replica, generation, proc,
                                    "127.0.0.1", int(ready["port"]),
                                    int(ready["pid"]))
            if proc.poll() is not None:
                raise RuntimeError(
                    f"worker {shard}/{replica} died during startup "
                    f"(rc={proc.returncode}); see "
                    f"{self.log_path(shard, replica)}")
            time.sleep(READY_POLL_S)
        proc.kill()
        proc.wait(timeout=10.0)
        raise TimeoutError(f"worker {shard}/{replica} not ready within "
                           f"{self.spawn_timeout_s}s")

    def kill(self, shard: int, replica: int, sig=signal.SIGKILL) -> int:
        """Signal one replica (SIGKILL by default) and reap it; returns
        its pid. The slot keeps its handle and stale address."""
        with self._lock:
            h = self._grid[shard][replica]
        if h is None or h.proc is None:
            raise RuntimeError(f"no live worker at {shard}/{replica}")
        h.proc.send_signal(sig)
        h.proc.wait(timeout=30.0)
        return h.pid

    def respawn(self, shard: int, replica: int) -> WorkerHandle:
        """Bring a killed replica back in a fresh process on a fresh port,
        its spawn generation bumped; it loads the pinned index generation
        (set_index_generation)."""
        from ..obs import get_registry

        with self._lock:
            old = self._grid[shard][replica]
            generation = (old.generation + 1) if old else 0
        proc, ready_path = self._spawn(shard, replica, generation=generation)
        handle = self._wait_ready(shard, replica, generation, proc,
                                  ready_path,
                                  time.monotonic() + self.spawn_timeout_s)
        with self._lock:
            self._grid[shard][replica] = handle
            self._state[shard][replica] = "active"
            self._epoch += 1
        get_registry().incr("router.worker_respawn")
        return handle

    def set_index_generation(self, generation: int | None) -> None:
        """Pin the index generation later spawns load (rolling_swap pins
        its target, so a respawn after it comes back on the new one)."""
        with self._lock:
            self.index_generation = generation

    # -- elastic membership --------------------------------------------------

    def grow(self) -> list:
        """Add one warm replica to every shard: spawn them at once (at
        GROW_NICE), wait for every ready file (written after the
        worker's warm-up and residency pre-warm), and only then publish
        each handle into the dispatch grid. Returns the [(shard, replica)]
        slots added. A shard's lowest retired slot is reused, its spawn
        generation bumped past the retiree's, so a breathing workload does
        not widen the grid without bound. If the index generation pinned
        for spawns moved while a worker loaded (a rolling swap during the
        grow), the worker reloads onto it before it is published. A spawn
        that fails stops this grow's other workers, marks their slots
        retired and raises."""
        from ..obs import get_registry

        t0 = time.perf_counter()
        slots: list = []
        with self._lock:
            for s in range(self.shards):
                row, states = self._grid[s], self._state[s]
                for r, st in enumerate(states):
                    if st == "retired":
                        gen = (row[r].generation + 1) if row[r] else 0
                        break
                else:
                    r, gen = len(row), 0
                    row.append(None)
                    states.append("warming")
                states[r] = "warming"
                self._epoch += 1
                slots.append((s, r, gen))
        procs = [(s, r, g, self._spawn(s, r, generation=g,
                                       nice=GROW_NICE))
                 for s, r, g in slots]
        deadline = time.monotonic() + self.spawn_timeout_s
        added = []
        try:
            for s, r, g, (proc, ready_path) in procs:
                handle = self._wait_ready(s, r, g, proc, ready_path,
                                          deadline)
                try:  # full priority before it takes traffic
                    os.setpriority(os.PRIO_PROCESS, handle.pid, 0)
                except (OSError, AttributeError):
                    pass  # no CAP_SYS_NICE: it serves niced
                with self._lock:
                    pinned = self.index_generation
                # the swap-during-scale gate: a worker that loaded the old
                # pin while a rolling swap moved it reloads before it can
                # serve one routed request
                if pinned is not None \
                        and pinned != self._worker_index_gen(handle):
                    rpc_post(handle.addr, "reload", {"generation": pinned},
                             timeout_s=self.spawn_timeout_s)
                with self._lock:
                    self._grid[s][r] = handle
                    self._state[s][r] = "active"
                    self._epoch += 1
                    self._events.append(("up", s, r, self._epoch))
                added.append((s, r))
        except BaseException:
            published = set(added)
            for s, r, _g, (proc, _) in procs:
                if (s, r) in published:
                    continue
                if proc.poll() is None:
                    proc.kill()
                proc.wait(timeout=30.0)
                with self._lock:
                    self._state[s][r] = "retired"
                    self._epoch += 1
            raise
        finally:
            reg = get_registry()
            reg.incr("scale.up", len(added))
        reg.observe("scale.warmup_ms", time.perf_counter() - t0)
        return added

    def _worker_index_gen(self, handle) -> int | None:
        """The index generation a just-readied worker loaded (None when
        its /healthz cannot be read: the gate then reloads it)."""
        try:
            w = get_worker_health(handle.addr, 2.0).get("worker") or {}
            g = w.get("index_generation")
            return None if g is None else int(g)
        except Exception:  # noqa: BLE001 — unreadable: reload to be sure
            return None

    def begin_drain(self, shard: int, replica: int) -> WorkerHandle:
        """Turn one active replica `draining`: it leaves dispatchable()
        (the router stops dialing it) but serves what it already holds.
        Returns its handle."""
        with self._lock:
            h = self._grid[shard][replica]
            st = self._state[shard][replica]
            if h is None or st != "active":
                raise RuntimeError(
                    f"cannot drain {shard}/{replica}: state={st}")
            self._state[shard][replica] = "draining"
            self._epoch += 1
        return h

    def retire_replica(self, shard: int, replica: int, *,
                       drain_timeout_s: float = 30.0) -> dict:
        """Drain-not-drop retirement: begin_drain (dispatch stops at once),
        poll the worker's admitted requests (`in_flight` + `queued` of its
        /healthz) until two reads in a row find none, then SIGTERM it and
        mark the slot retired. A replica SIGKILLed during the drain ends
        the poll early (`killed_mid_drain`): its in-flight requests fail
        over at the router and are still answered or shed (a health read
        that fails is a kill when the process exits within 2 s, else an
        unreachable worker with nothing left to watch). Returns the drain
        report."""
        from ..obs import get_registry

        t0 = time.perf_counter()
        with self._lock:
            already_draining = self._state[shard][replica] == "draining"
            h = self._grid[shard][replica] if already_draining else None
        if h is None:
            h = self.begin_drain(shard, replica)
        inflight_peak = 0
        zeros = 0
        deadline = time.monotonic() + max(drain_timeout_s, 0.1)
        killed_mid_drain = False
        settled = False
        while time.monotonic() < deadline:
            if not h.alive:
                killed_mid_drain = True
                break
            try:
                w = get_worker_health(h.addr, 1.0).get("worker") or {}
                admitted = (int(w.get("in_flight", 0))
                            + int(w.get("queued", 0)))
            except Exception:  # noqa: BLE001
                # a read that fails while the worker dies: give its exit a
                # moment (a killer's wait() holds the Popen lock, and
                # poll() reads a dying process as alive until then)
                try:
                    h.proc.wait(timeout=2.0)
                    killed_mid_drain = True
                except subprocess.TimeoutExpired:
                    settled = True  # unreachable: nothing left to watch
                break
            inflight_peak = max(inflight_peak, admitted)
            if admitted == 0:
                zeros += 1
                if zeros >= 2:
                    settled = True
                    break
            else:
                zeros = 0
            time.sleep(0.05)
        drained_clean = settled and not killed_mid_drain
        if h.proc is not None and h.proc.poll() is None:
            h.proc.terminate()
            try:
                h.proc.wait(timeout=15.0)
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait(timeout=10.0)
        with self._lock:
            self._state[shard][replica] = "retired"
            self._epoch += 1
            self._events.append(("down", shard, replica, self._epoch))
        reg = get_registry()
        reg.incr("scale.down")
        reg.incr("scale.drain_inflight", inflight_peak)
        drain_s = time.perf_counter() - t0
        reg.observe("scale.drain_ms", drain_s)
        return {"shard": shard, "replica": replica,
                "drain_s": round(drain_s, 3),
                "inflight_peak": inflight_peak,
                "drained_clean": drained_clean,
                "killed_mid_drain": killed_mid_drain}

    def active_replicas(self, shard: int | None = None) -> int:
        """Active replicas of one shard, or the least over the shards
        (the fleet's replication, the autoscaler's clamp) when None."""
        with self._lock:
            counts = [sum(1 for st in states if st == "active")
                      for states in self._state]
        if shard is not None:
            return counts[shard]
        return min(counts) if counts else 0

    # -- membership views ----------------------------------------------------

    def epoch(self) -> int:
        """Bumped on every grid or state change (a publish, a respawn, a
        drain's start, a retirement)."""
        with self._lock:
            return self._epoch

    def lifecycle(self) -> list:
        """[shard][replica] -> warming, active, draining or retired."""
        with self._lock:
            return [list(row) for row in self._state]

    def events(self) -> list:
        """The membership log: ("up" | "down", shard, replica, epoch) for
        every replica that entered or left the dispatch grid."""
        with self._lock:
            return list(self._events)

    def dispatchable(self) -> list:
        """addresses() with every slot that is not active set to None."""
        with self._lock:
            return [[h.addr if h and st == "active" else None
                     for h, st in zip(row, states)]
                    for row, states in zip(self._grid, self._state)]

    def addresses(self) -> list:
        """[shard][replica] -> "host:port", killed, draining and retired
        slots included (the router dials dispatchable())."""
        with self._lock:
            return [[h.addr if h else None for h in row]
                    for row in self._grid]

    def handles(self) -> list:
        with self._lock:
            return [list(row) for row in self._grid]

    def stop(self) -> None:
        """Terminate every worker and reap it (idempotent)."""
        with self._lock:
            handles = [h for row in self._grid for h in row if h]
        for h in handles:
            if h.proc is not None and h.proc.poll() is None:
                h.proc.terminate()
        deadline = time.monotonic() + 15.0
        for h in handles:
            if h.proc is None:
                continue
            try:
                h.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait(timeout=10.0)
            if h.proc.stdin:
                try:
                    h.proc.stdin.close()
                except OSError:
                    pass

    def __enter__(self) -> "ShardSet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


if __name__ == "__main__":  # the worker subprocess's entry
    sys.exit(worker_main(sys.argv[1]))
