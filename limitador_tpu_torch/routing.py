"""Owner routing of counters to shards.

Counterpart of ``stable_hash``, ``counter_key`` and ``RouteMemo`` of
``limitador_tpu/routing.py:79-141``: one crc32 over the ``repr`` of a
counter's routed identity decides its owner shard,

    shard = stable_hash(counter_key(counter)) % n_shards

byte for byte as the JAX package decides it (the port's ``Limit``
keeps the JAX package's ``_identity`` tuple, so the ``repr`` is the
same bytes), so both packages put every counter in the same shard and a
checkpoint re-routes the same way. ``PodTopology`` and ``PodRouter``, the
routing of the multi-process pod, are not ported yet (ROADMAP Queue A).
"""

from __future__ import annotations

import zlib
from typing import Dict, Optional

__all__ = ["stable_hash", "counter_key", "RouteMemo"]


def stable_hash(key: tuple) -> int:
    """Deterministic (process-independent) hash for ownership routing:
    crc32 over the key's repr."""
    return zlib.crc32(repr(key).encode())


def counter_key(counter) -> tuple:
    """The routed identity of a counter: the tuple the sharded storage
    slots by and hashes."""
    return (counter.limit._identity, tuple(counter.set_variables.items()))


class RouteMemo:
    """Bounded LRU memo of key -> owner shard. The crc32 is pure, but
    repr + crc per hit dominates staging, so routing memoizes; the cap
    keeps the memo from growing one entry per key ever seen. Not
    thread-safe by itself: callers serialize under their own lock."""

    __slots__ = ("_cap", "_map", "hits", "misses", "evictions")

    def __init__(self, cap: int):
        self._cap = max(int(cap), 1)
        self._map: Dict[tuple, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._map)

    def get(self, key: tuple) -> Optional[int]:
        shard = self._map.get(key)
        if shard is None:
            self.misses += 1
            return None
        self.hits += 1
        # pop + reinsert moves the key to the back: eviction pops the
        # least recently used entry.
        del self._map[key]
        self._map[key] = shard
        return shard

    def put(self, key: tuple, shard: int) -> None:
        if len(self._map) >= self._cap:
            self._map.pop(next(iter(self._map)))
            self.evictions += 1
        self._map[key] = shard

    def stats(self) -> dict:
        return {
            "sharded_route_memo_hits": self.hits,
            "sharded_route_memo_misses": self.misses,
            "sharded_route_memo_evictions": self.evictions,
            "sharded_route_memo_size": len(self._map),
        }
