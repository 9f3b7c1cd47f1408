"""Owner routing of counters to shards and to the hosts of a pod.

Counterpart of ``limitador_tpu/routing.py``: one crc32 over the ``repr``
of a counter's routed identity decides its owner shard,

    shard = stable_hash(counter_key(counter)) % n_shards

byte for byte as the JAX package decides it (the port's ``Limit`` keeps
the JAX package's ``_identity`` tuple, so the ``repr`` is the same
bytes), so both packages put every counter in the same shard and a
checkpoint re-routes the same way.

A pod of ``hosts`` processes splits one flat shard axis of ``hosts *
shards_per_host`` global shards into contiguous per-host blocks:

    global_shard = stable_hash(key) % (hosts * shards_per_host)
    owner_host   = global_shard // shards_per_host
    local_shard  = global_shard %  shards_per_host

so a one-host pod routes exactly as the sharded storage does.
``PodRouter.plan`` answers per request, from the counter keys the
request touches: every key owned here is ``LOCAL``; every key on one
other host is ``FORWARD`` (one peer-lane hop to the owner); a namespace
with more than one limit, or a global one, is pinned whole to one host
(``PINNED``, the hash of the namespace), so its requests take at most
one hop and its counters live on one host.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

__all__ = [
    "stable_hash",
    "counter_key",
    "RouteMemo",
    "PodTopology",
    "PodRouter",
    "LOCAL",
    "FORWARD",
    "PINNED",
    "METRIC_FAMILIES",
]

#: families of the pod's routing (polled off the pod frontend's
#: library_stats); the peer health and failover families belong to
#: ``server/peering.py``
METRIC_FAMILIES = (
    "pod_routed_local",
    "pod_routed_forwarded",
    "pod_routed_pinned",
    "pod_peer_errors",
    "pod_peer_p99_ms",
)

# Routing verdicts (``PodRouter.plan``).
LOCAL = "local"
FORWARD = "forward"
PINNED = "pinned"


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


class PodTopology(NamedTuple):
    """The pod's shard geometry: ``hosts`` processes, each owning a
    contiguous block of ``shards_per_host`` global shards."""

    hosts: int
    host_id: int
    shards_per_host: int

    @property
    def total_shards(self) -> int:
        return self.hosts * self.shards_per_host

    def owner_shard(self, key: tuple) -> int:
        return stable_hash(key) % self.total_shards

    def owner_host(self, key: tuple) -> int:
        return self.owner_shard(key) // self.shards_per_host

    def local_shard(self, key: tuple) -> int:
        return self.owner_shard(key) % self.shards_per_host


class PodRouter:
    """Request-level routing over a :class:`PodTopology`.

    ``configure(limits, global_namespaces)`` classifies namespaces once
    a limits generation (pinning multi-limit and global namespaces);
    ``plan(namespace, keys)`` then answers per request with (verdict,
    owner_host). Counters of a pinned namespace all live on the pin
    host, whose storage routes them as a one-host deployment would."""

    def __init__(self, topology: PodTopology):
        self.topology = topology
        self._lock = threading.Lock()
        self._pinned_ns: Dict[str, int] = {}
        self.routed_local = 0
        self.routed_forwarded = 0
        self.routed_pinned = 0
        #: limits generation, bumped by every configure() (the pod's
        #: event log records each bump)
        self.epoch = 0
        #: topology generation, bumped only by ``retarget`` (a
        #: membership change), never by a limits reload
        self.topology_epoch = 0
        # the last limits generation, so that retarget() can derive the
        # pins again for a new host count
        self._last_limits: List = []
        self._last_global: Tuple[str, ...] = ()

    # -- configuration -------------------------------------------------------

    @staticmethod
    def pin_host(namespace: str, hosts: int) -> int:
        """Deterministic pin host of a namespace: every ingress host
        agrees without coordination."""
        return stable_hash(("ns", str(namespace))) % hosts

    @classmethod
    def _derive_pinned(
        cls, limits, global_namespaces, hosts: int
    ) -> Dict[str, int]:
        """The pinning policy: a namespace whose requests can touch more
        than one counter (more than one limit), or whose budget is
        pod-global, is pinned whole to one host."""
        per_ns: Dict[str, int] = {}
        for limit in limits:
            ns = str(limit.namespace)
            per_ns[ns] = per_ns.get(ns, 0) + 1
        pinned = {
            ns: cls.pin_host(ns, hosts)
            for ns, count in per_ns.items()
            if count > 1
        }
        for ns in global_namespaces:
            pinned[str(ns)] = cls.pin_host(str(ns), hosts)
        return pinned

    def configure(
        self, limits: Iterable, global_namespaces: Iterable[str] = ()
    ) -> None:
        """Apply a limits generation: derive the pinned namespaces and
        bump the limits epoch."""
        limits = list(limits)
        global_namespaces = tuple(str(ns) for ns in global_namespaces)
        pinned = self._derive_pinned(
            limits, global_namespaces, self.topology.hosts
        )
        with self._lock:
            self._pinned_ns = pinned
            self.epoch += 1
            self._last_limits = limits
            self._last_global = global_namespaces

    def retarget(
        self, topology: PodTopology, epoch: Optional[int] = None
    ) -> int:
        """Install a new topology on a running router: new arrivals
        route by it from the moment this returns, with the pins derived
        again from the last limits generation (a pin host depends on the
        host count). Returns the new topology epoch: one more, or
        ``epoch`` when the members agreed on one."""
        with self._lock:
            limits, global_ns = self._last_limits, self._last_global
        pinned = self._derive_pinned(limits, global_ns, topology.hosts)
        with self._lock:
            self.topology = topology
            self._pinned_ns = pinned
            if epoch is not None:
                self.topology_epoch = int(epoch)
            else:
                self.topology_epoch += 1
            return self.topology_epoch

    # -- the per-request verdict ---------------------------------------------

    def pinned_map(self) -> Dict[str, int]:
        """A copy of the pinned-namespace map."""
        with self._lock:
            return dict(self._pinned_ns)

    def pinned_host(self, namespace: str) -> Optional[int]:
        """The pin host of a namespace, or None when it routes per key."""
        with self._lock:
            return self._pinned_ns.get(str(namespace))

    def verdict(
        self, namespace: str, keys: List[tuple]
    ) -> Tuple[str, int]:
        """The routing verdict, with no counter touched."""
        with self._lock:
            return self._verdict_locked(namespace, keys)

    def _verdict_locked(
        self, namespace: str, keys: List[tuple]
    ) -> Tuple[str, int]:
        me = self.topology.host_id
        pin = self._pinned_ns.get(str(namespace))
        if pin is not None:
            return (LOCAL, me) if pin == me else (PINNED, pin)
        owners = {self.topology.owner_host(key) for key in keys}
        if not owners or owners == {me}:
            return LOCAL, me
        if len(owners) == 1:
            return FORWARD, owners.pop()
        # Keys spanning hosts under an unpinned namespace: a limits
        # generation raced the request. The namespace's pin host decides,
        # and when that is this host the verdict is LOCAL (there is no
        # peer lane to self).
        pin = self.pin_host(str(namespace), self.topology.hosts)
        return (LOCAL, me) if pin == me else (PINNED, pin)

    def plan(
        self, namespace: str, keys: List[tuple]
    ) -> Tuple[str, int]:
        """(verdict, owner_host) for one request's counter keys, counted
        under the same lock acquisition as the verdict."""
        with self._lock:
            verdict, owner = self._verdict_locked(namespace, keys)
            if verdict == LOCAL:
                self.routed_local += 1
            elif verdict == FORWARD:
                self.routed_forwarded += 1
            else:
                self.routed_pinned += 1
        return verdict, owner

    def ownership_map(self) -> dict:
        """What an upstream load balancer can learn (``GET
        /debug/pod/routing``): topology, per-host shard blocks, the
        pinned namespaces and the epochs."""
        with self._lock:
            topo = self.topology
            pinned = dict(self._pinned_ns)
            epoch = self.epoch
            tepoch = self.topology_epoch
        return {
            "topology_epoch": tepoch,
            "hosts": topo.hosts,
            "host_id": topo.host_id,
            "shards_per_host": topo.shards_per_host,
            "total_shards": topo.total_shards,
            "hash": "crc32(repr(counter_key))",
            "owner": "crc32 % total_shards // shards_per_host",
            "shard_blocks": {
                str(h): [h * topo.shards_per_host,
                         (h + 1) * topo.shards_per_host]
                for h in range(topo.hosts)
            },
            "pinned_namespaces": pinned,
            "epoch": epoch,
        }

    def stats(self) -> dict:
        with self._lock:
            return {
                "pod_routed_local": self.routed_local,
                "pod_routed_forwarded": self.routed_forwarded,
                "pod_routed_pinned": self.routed_pinned,
            }
