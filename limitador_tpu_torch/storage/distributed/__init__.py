"""Leaderless replicated counter storage (CRDT + gossip).

Port counterpart of ``limitador_tpu/storage/distributed/__init__.py``,
copied with its imports kept package-relative. The gossip broker
(``broker.py``) is the JAX package's wire, so a port node and a JAX node
replicate with each other; the replicated device table
(``device/replicated.py``) gossips through the same broker.

Mirrors upstream limitador/src/storage/distributed/mod.rs: counters
are per-actor CRDTs merged by max (cr_counter_value.py); every local
increment publishes the counter's full snapshot to the replication Broker
(distributed/mod.rs:286-292); incoming CounterUpdates merge into local
state (:233-247); a newly connected peer receives a full re-sync
(:294-332). Reads never block on the network — bounded over-admission
between gossip rounds is the documented contract of this topology
(doc/topologies.md).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set

from ...core.counter import Counter
from ...core.limit import Limit
from ..base import Authorization, CounterStorage
from ..keys import LimitKeyIndex, key_for_counter, partial_counter_from_key
from .broker import Broker
from .cr_counter_value import CrCounterValue, CrTatValue

__all__ = ["Broker", "CrInMemoryStorage", "CrCounterValue", "CrTatValue"]


class _Entry:
    __slots__ = ("key", "value")

    def __init__(self, key: bytes, value: CrCounterValue):
        self.key = key
        self.value = value


class CrInMemoryStorage(CounterStorage):
    # Token buckets replicate as a shared TAT max-merged over gossip
    # (CrTatValue; same contract as device/replicated.py).
    supports_token_bucket = True

    def __init__(
        self,
        node_id: str,
        listen_address: Optional[str] = None,
        peers: Optional[List[str]] = None,
        clock=time.time,
        advertise_address: Optional[str] = None,
    ):
        self._lock = threading.RLock()
        self._clock = clock
        self.node_id = node_id
        self._counters: Dict[bytes, _Entry] = {}
        self.broker = None
        if listen_address is not None:
            self.broker = Broker(
                peer_id=node_id,
                listen_address=listen_address,
                peer_urls=peers or [],
                on_update=self._on_remote_update,
                snapshot_provider=self._snapshot,
                advertise_address=advertise_address,
            )
            self.broker.start()

    @classmethod
    def standalone(cls, node_id: str) -> "CrInMemoryStorage":
        """Single-node instance (no replication) — same CRDT semantics."""
        return cls(node_id)

    # -- replication plumbing ------------------------------------------------

    def _snapshot(self):
        """Full counter set for re-syncing a newly connected peer."""
        with self._lock:
            out = []
            now = self._clock()
            for entry in self._counters.values():
                if entry.value.expired_at(now):
                    continue
                values, expiry = entry.value.snapshot()
                out.append((entry.key, values, int(expiry * 1000)))
            return out

    def _on_remote_update(
        self, key: bytes, values: Dict[str, int], expires_at_ms: int
    ) -> None:
        now = self._clock()
        expiry = expires_at_ms / 1000.0
        with self._lock:
            entry = self._counters.get(key)
            if entry is None:
                value = CrCounterValue(self.node_id, 0.0, now)  # expired shell
                entry = _Entry(key, value)
                self._counters[key] = entry
            entry.value.merge_at(values, expiry, now)

    def _publish(self, entry: _Entry) -> None:
        if self.broker is not None:
            values, expiry = entry.value.snapshot()
            self.broker.publish(entry.key, values, int(expiry * 1000))

    # -- internals -------------------------------------------------------------

    def _coerce_policy(self, entry: _Entry, counter: Counter) -> None:
        """Remote updates can land before the limit is configured here:
        the shell is a window CRDT holding what the wire carried. For a
        bucket counter that payload was TAT ticks — adopt the join
        (per-actor max) into the TAT cell. Caller holds the lock."""
        if (
            counter.limit.policy == "token_bucket"
            and isinstance(entry.value, CrCounterValue)
        ):
            values, _expiry = entry.value.snapshot()
            entry.value = CrTatValue(
                self.node_id, counter.limit,
                max(values.values(), default=0),
            )

    def _entry_for(self, counter: Counter, now: float) -> _Entry:
        key = key_for_counter(counter)
        entry = self._counters.get(key)
        if entry is None:
            if counter.limit.policy == "token_bucket":
                value = CrTatValue(self.node_id, counter.limit)
            else:
                value = CrCounterValue(
                    self.node_id, counter.window_seconds, now
                )
            entry = _Entry(key, value)
            self._counters[key] = entry
        else:
            self._coerce_policy(entry, counter)
        return entry

    # -- CounterStorage ----------------------------------------------------------

    def is_within_limits(self, counter: Counter, delta: int) -> bool:
        now = self._clock()
        with self._lock:
            entry = self._counters.get(key_for_counter(counter))
            if entry is not None:
                self._coerce_policy(entry, counter)
            value = entry.value.read_at(now) if entry else 0
        return value + delta <= counter.max_value

    def add_counter(self, limit: Limit) -> None:
        pass  # entries are created on first touch

    def update_counter(self, counter: Counter, delta: int) -> None:
        now = self._clock()
        with self._lock:
            entry = self._entry_for(counter, now)
            entry.value.inc_at(delta, counter.window_seconds, now)
            self._publish(entry)

    def check_and_update(
        self, counters: List[Counter], delta: int, load_counters: bool
    ) -> Authorization:
        now = self._clock()
        with self._lock:
            first_limited: Optional[Authorization] = None
            to_update: List[tuple] = []
            for counter in counters:
                entry = self._entry_for(counter, now)
                value = entry.value.read_at(now)
                if load_counters:
                    remaining = counter.max_value - (value + delta)
                    counter.remaining = max(remaining, 0)
                    if counter.limit.policy == "token_bucket":
                        # bucket expires_in is time-to-full (0 = full);
                        # there is no fresh-window display case
                        counter.expires_in = entry.value.ttl(now)
                    else:
                        counter.expires_in = (
                            entry.value.ttl(now)
                            if not entry.value.expired_at(now)
                            else counter.window_seconds
                        )
                    if first_limited is None and remaining < 0:
                        first_limited = Authorization.limited_by(
                            counter.limit.name
                        )
                if value + delta > counter.max_value:
                    if not load_counters:
                        return Authorization.limited_by(counter.limit.name)
                to_update.append((entry, counter))
            if first_limited is not None:
                return first_limited
            for entry, counter in to_update:
                entry.value.inc_at(delta, counter.window_seconds, now)
                self._publish(entry)
            return Authorization.OK

    @staticmethod
    def _decode(key: bytes, limits: Set[Limit]) -> Optional[Counter]:
        """Counter from key, or None for foreign/undecodable keys (a peer
        running a different key codec must not break the admin API)."""
        try:
            return partial_counter_from_key(key, limits)
        except Exception:
            return None

    def get_counters(self, limits: Set[Limit]) -> Set[Counter]:
        now = self._clock()
        out: Set[Counter] = set()
        index = LimitKeyIndex(limits)
        # Keys decode OUTSIDE the lock (the scan cost must not stall the
        # broker's merges or the check path); the second, short locked
        # pass coerces policy shells — a bucket key whose entry is still
        # a window shell from pre-configuration gossip must not have its
        # ticks read as counts — and reads the values the broker thread
        # mutates.
        with self._lock:
            snapshot = list(self._counters.values())
        decoded = [
            (entry, counter)
            for entry in snapshot
            if (counter := self._decode(entry.key, index)) is not None
        ]
        with self._lock:
            for entry, counter in decoded:
                self._coerce_policy(entry, counter)
                if entry.value.expired_at(now):
                    continue
                counter.remaining = (
                    counter.max_value - entry.value.read_at(now)
                )
                counter.expires_in = entry.value.ttl(now)
                out.add(counter)
        return out

    def delete_counters(self, limits: Set[Limit]) -> None:
        with self._lock:
            index = LimitKeyIndex(limits)
            doomed = [
                key
                for key in self._counters
                if self._decode(key, index) is not None
            ]
            for key in doomed:
                del self._counters[key]

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()

    def close(self) -> None:
        if self.broker is not None:
            self.broker.stop()
