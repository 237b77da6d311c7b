"""Moving a serving fleet from one index generation to the next (the port
of `tpu_ir/serving/generation.py`).

A live index (index/segments.py) makes immutable generations. In one
process `ServingFrontend.reload_generation` is the whole swap (load and
warm outside the request path, publish by one assignment). Across the
shard worker tier `rolling_swap` walks the grid one replica at a time,
POSTing /rpc/reload and reading each worker's /healthz back before it
moves on; every worker serves its old generation until its own publish,
so no replica goes dark, and every answer names the one generation it
came from. `swap_microbench` measures one ingest -> compact -> swap cycle
under probe traffic.
"""

from __future__ import annotations

import logging
import threading
import time

from ..obs import get_registry
from .shardset import get_worker_health, rpc_post

logger = logging.getLogger(__name__)


def rolling_swap(shardset, generation: int | None = None, *,
                 reload_timeout_s: float = 300.0) -> dict:
    """Roll a ShardSet's workers onto index generation `generation`
    (None: each worker's newest servable one), one replica at a time.
    Each worker loads and warms the new generation while it still serves
    the old one (its reload RPC returns after the publish); its /healthz
    is read back and must name the new generation before the next
    replica starts.

    A replica that cannot be reached is skipped and reported (`failed`):
    a respawn brings it back on the new generation, which is pinned on
    the ShardSet before the walk and again after it. When the grid's
    membership epoch moves during a pass, the grid is walked again
    (confirmed addresses skipped) until a pass sees it unchanged, so a
    replica that grew into the grid mid-walk is swapped too. A draining
    or retired replica is not walked: it is leaving the fleet.
    Returns the generation, the (shard, replica, addr) swapped and
    failed, the passes and the wall seconds."""
    t0 = time.perf_counter()
    swapped, failed = [], []
    confirmed: set = set()
    result_gen = generation
    if generation is not None:
        # pinned first: a replica spawned during the walk loads the new
        # generation
        shardset.set_index_generation(int(generation))
    rounds = 0
    while True:
        rounds += 1
        epoch_before = shardset.epoch()
        grid = shardset.addresses()
        life = shardset.lifecycle()
        for shard, row in enumerate(grid):
            for replica, addr in enumerate(row):
                if not addr or addr in confirmed:
                    continue
                # the two views are read apart: a slot grown in between
                # has no state yet, and is walked
                st = (life[shard][replica] if shard < len(life)
                      and replica < len(life[shard]) else None)
                if st in ("draining", "retired"):
                    # a draining worker only finishes what it holds; a
                    # retired slot has no process
                    continue
                payload = ({} if generation is None
                           else {"generation": int(generation)})
                try:
                    out = rpc_post(addr, "reload", payload,
                                   reload_timeout_s)
                    result_gen = out.get("generation", result_gen)
                    h = get_worker_health(addr, 10.0)
                    got = (h.get("worker") or {}).get("index_generation")
                    if result_gen is not None and got != result_gen:
                        raise RuntimeError(
                            f"worker {addr} reports index_generation "
                            f"{got!r} after reload to {result_gen}")
                    swapped.append((shard, replica, addr))
                    confirmed.add(addr)
                except Exception as e:  # noqa: BLE001 — a dead replica
                    # must not wedge the walk; it respawns on the new one
                    logger.warning("rolling swap: %s failed: %r", addr, e)
                    failed.append((shard, replica, addr, repr(e)))
        if shardset.epoch() == epoch_before:
            break
        if rounds >= 8:
            logger.warning("rolling swap: membership still changing after "
                           "%d passes; stopping", rounds)
            break
    shardset.set_index_generation(result_gen)
    return {"generation": result_gen, "swapped": swapped, "failed": failed,
            "rounds": rounds, "wall_s": round(time.perf_counter() - t0, 3)}


# ---------------------------------------------------------------------------
# the ingest -> swap micro-bench
# ---------------------------------------------------------------------------

_BENCH_WORDS = ("salmon fishing river bears honey quick brown fox lazy "
                "dog market investor asset bond stock season rain "
                "forest".split())


def _bench_doc(i: int) -> tuple[str, str]:
    text = " ".join(_BENCH_WORDS[(i + j) % len(_BENCH_WORDS)]
                    for j in range(4 + (i % 6)))
    return f"SWAP-{i:05d}", text


def swap_microbench(live_dir: str, *, base_docs: int = 64,
                    delta_docs: int = 16, probe_s: float = 1.0,
                    num_shards: int = 4, device=None) -> dict:
    """What one ingest -> compact -> swap cycle costs the readers.

    Builds (or reuses) the live index `live_dir`, serves generation A on
    `device` (the card by default) through a frontend while a probe
    thread sends back-to-back BM25 queries, ingests a delta, compacts it
    into generation B and calls `frontend.reload_generation`. Reports
    `swap_gap_ms` (the widest gap between successive successful probe
    answers across the swap window), `swap_staleness_ms` (from the
    reload call to the first B-tagged answer) and `swap_wall_s` (the
    reload call), with the generations and the probe count."""
    from ..index.ingest import IngestWriter
    from ..index.segments import LiveIndex, is_live
    from ..search.scorer import Scorer
    from .admission import Overloaded
    from .frontend import ServingConfig, ServingFrontend

    if not is_live(live_dir):
        LiveIndex.create(live_dir, num_shards=num_shards)
    live = LiveIndex.open(live_dir)
    with IngestWriter(live_dir, auto_merge=False, device=device) as w:
        existing = w._docs()
        for i in range(base_docs):
            docid, text = _bench_doc(i)
            if docid not in existing:
                w.add(docid, text)
        w.compact_all(note="swap-bench base")

    scorer_a = Scorer.load_generation(live_dir, layout="sparse",
                                      device=device)
    frontend = ServingFrontend(scorer_a, ServingConfig(
        max_concurrency=4, max_queue=16))

    # generation B is prepared while A serves
    with IngestWriter(live_dir, auto_merge=False, device=device) as w:
        for i in range(base_docs, base_docs + delta_docs):
            w.update(*_bench_doc(i))
        w.compact_all(note="swap-bench delta")
    gen_b = live.current_gen()

    texts = [" ".join(_BENCH_WORDS[i % len(_BENCH_WORDS)]
                      for i in range(j, j + 2)) for j in range(8)]
    for t in texts:   # every probe shape once before the measurement
        frontend.search(t, k=5, scoring="bm25")

    stop = threading.Event()
    events: list[tuple[float, int]] = []   # (completion time, generation)
    errors: list[BaseException] = []
    lock = threading.Lock()

    def probe() -> None:
        i = 0
        while not stop.is_set():
            try:
                res = frontend.search(texts[i % len(texts)], k=5,
                                      scoring="bm25")
                with lock:
                    events.append((time.perf_counter(), res.generation))
            except Overloaded:     # a shed in the swap window shows as
                pass               # a gap: that is the finding
            except BaseException as e:  # re-raised by the caller
                errors.append(e)
                return
            i += 1

    th = threading.Thread(target=probe, name="tpu-ir-swap-bench-probe")
    th.start()
    try:
        time.sleep(probe_s / 2)
        t_swap0 = time.perf_counter()
        frontend.reload_generation(generation=gen_b)
        t_swap1 = time.perf_counter()
        time.sleep(probe_s / 2)
    finally:
        stop.set()
        th.join(timeout=30.0)
    if errors:
        raise errors[0]

    with lock:
        evs = list(events)
    window = [t for t, _ in evs if t_swap0 - 0.25 <= t <= t_swap1 + 0.25]
    gap_ms = 0.0
    prev = t_swap0 - 0.25
    for t in sorted(window) + [t_swap1 + 0.25]:
        gap_ms = max(gap_ms, (t - prev) * 1e3)
        prev = t
    first_b = next((t for t, g in evs if g == gen_b and t >= t_swap0), None)
    get_registry().set_gauge("generation.current", gen_b)
    return {
        "generation_a": scorer_a.generation,
        "generation_b": gen_b,
        "probes": len(evs),
        "generations_seen": sorted({g for _, g in evs}),
        "swap_gap_ms": round(gap_ms, 3),
        "swap_staleness_ms": (round((first_b - t_swap0) * 1e3, 3)
                              if first_b is not None else -1.0),
        "swap_wall_s": round(t_swap1 - t_swap0, 3),
        "num_docs_b": frontend.scorer.meta.num_docs,
    }
