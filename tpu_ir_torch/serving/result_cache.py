"""Generation-keyed exact-hit result cache (the port of
`tpu_ir/serving/result_cache.py`).

A bounded LRU from an exact request identity to its full-level response.
The frontend's key is

    (analyzed term ids, k, scoring, rerank, hot_only, generation)

every field that selects the dispatch or the serving route, plus the
index generation that would answer a miss; the router's (it has no
analyzer) is (whitespace-split terms, generation, k, scoring, rerank).
A generation swap moves the key space, so a stale entry can never be
reached. Only clean (not degraded, not partial) responses are stored,
and a hit replays one verbatim: the same docids, float bits and tie
order as the miss path.

Counters: cache.hit, cache.miss, cache.evict, cache.stale_generation in
the registry; the frontend observes the cache.lookup histogram. Every
cache registers itself, by weak reference, with the process's list of
live caches (`live_caches`), which the `cache` command and /profile read
and `clear_all` empties.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict

from .. import envvars
from ..obs import get_registry
from ..obs.registry import CACHE_COUNTER_NAMES


# the live caches, by weak reference: registering keeps no owner alive
_live_caches: list = []
_live_lock = threading.Lock()


def _drop_dead_ref(ref) -> None:
    with _live_lock:
        try:
            _live_caches.remove(ref)
        except ValueError:
            pass


def live_caches() -> list:
    """This process's live ResultCache instances, oldest first."""
    with _live_lock:
        alive = [ref() for ref in _live_caches]
    return [c for c in alive if c is not None]


def clear_all() -> int:
    """Drop every live cache's entries (`cache clear`); returns how many
    were dropped."""
    return sum(c.clear() for c in live_caches())


def normalize_terms(text: str) -> tuple:
    """The router's key normalization: whitespace only. The workers
    analyze, and their analyzer ignores whitespace, so two texts with
    equal splits get equal answers; a weaker key than the frontend's
    costs missed hits, never a wrong one."""
    return tuple(text.split())


def cacheable_text(text: str) -> bool:
    """Texts an exact-hit key covers: no phrase spans and no glob or
    fuzzy operators (they expand against the vocabulary, and a key that
    dropped the operator would collide with the literal query)."""
    return not any(ch in text for ch in '"*?~')


class ResultCache:
    """Bounded thread-safe LRU of key -> (generation, payload); the
    payload is opaque (the frontend stores a response's hit tuples).
    `capacity` <= 0 turns gets and puts off."""

    def __init__(self, capacity: int, *, name: str = "cache"):
        self.name = name
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self._generation = 0
        with _live_lock:
            _live_caches.append(weakref.ref(self, _drop_dead_ref))

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def generation(self) -> int:
        with self._lock:
            return self._generation

    def bump_generation(self, gen: int) -> int:
        """Advance the cache's generation (never backwards) and purge the
        entries of older generations, already unreachable by key, counting
        them as cache.stale_generation. Returns how many were purged."""
        with self._lock:
            if gen <= self._generation:
                return 0
            self._generation = int(gen)
            dead = [k for k, (g, _) in self._entries.items() if g < gen]
            for k in dead:
                del self._entries[k]
        if dead:
            get_registry().incr("cache.stale_generation", len(dead))
        return len(dead)

    def get(self, key: tuple):
        """The payload for `key`, or None (counts cache.hit / cache.miss;
        a disabled cache counts nothing). A hit refreshes LRU order."""
        if not self.enabled:
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
        reg = get_registry()
        if entry is None:
            reg.incr("cache.miss")
            return None
        reg.incr("cache.hit")
        return entry[1]

    def put(self, key: tuple, payload, *, generation: int) -> None:
        """Store one full-level response under its exact key. An entry of
        a generation older than the cache's is refused (a slow miss that
        completes after a swap must not bring the old index back)."""
        if not self.enabled:
            return
        evicted = 0
        with self._lock:
            if generation < self._generation:
                return
            self._entries[key] = (int(generation), payload)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                evicted += 1
        if evicted:
            get_registry().incr("cache.evict", evicted)

    def clear(self) -> int:
        """Drop every entry; returns how many there were."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
        return n

    def snapshot(self) -> dict:
        """Size, capacity and generation; never the entries."""
        with self._lock:
            return {"name": self.name, "capacity": self.capacity,
                    "entries": len(self._entries),
                    "generation": self._generation}


def cache_counters() -> dict:
    """The process-wide cache.* counters and the hit fraction."""
    reg = get_registry()
    out = {name: reg.get(name) for name in CACHE_COUNTER_NAMES}
    looked = out["cache.hit"] + out["cache.miss"]
    out["hit_fraction"] = (round(out["cache.hit"] / looked, 4)
                           if looked else 0.0)
    return out


def resolve_capacity(explicit: int | None) -> int:
    """An explicit capacity wins; None reads TPU_IR_CACHE_RESULTS."""
    if explicit is not None:
        return max(int(explicit), 0)
    return envvars.get_int("TPU_IR_CACHE_RESULTS")
