"""Write-behind cached counter storage.

Port counterpart of ``limitador_tpu/storage/cached.py``, copied with its
spans taken from the port's own ``observability/metrics_layer`` and
``observability/tracing``.

Mirrors the reference's cached-Redis topology
(upstream limitador/src/storage/redis/redis_cached.rs and
counters_cache.rs): N replicas keep local counters and asynchronously
reconcile with a shared authority —

- reads hit the local cache; a miss is optimistically treated as a fresh
  counter ("this is a plain lie!", redis_cached.rs:101-116) so decisions
  never wait on the authority;
- increments apply locally AND queue in a batcher (pending delta per
  counter, coalesced); a background flush loop pushes batches to the
  authority every ``flush_period`` / when ``batch_size`` accumulates
  (counters_cache.rs:183-238);
- the authority applies deltas and returns authoritative values, which
  reconcile into the cache (other replicas' increments become visible:
  apply_remote_delta, counters_cache.rs:303-331);
- a transient authority failure flips the partitioned flag and RETURNS the
  in-flight deltas to the cache — nothing is lost, the replica keeps
  serving from local state (redis_cached.rs:216-230, 363-388).

Accuracy contract: bounded over-admission (by flush period x replica
count), exactly as the reference documents for this topology
(redis_cached.rs:25-41). Any backend exposing ``apply_deltas`` can be the
authority (in-memory, disk, the device table — the analogue of Redis
here).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..core.counter import Counter
from ..core.limit import Limit
from ..observability.metrics_layer import metrics_span
from ..observability.tracing import datastore_span
from .base import (
    AsyncCounterStorage,
    Authorization,
    CounterStorage,
    StorageError,
    require_nonnegative_delta,
)
from .expiring_value import ExpiringValue
from .keys import key_for_counter

__all__ = ["CachedCounterStorage", "DEFAULT_FLUSH_PERIOD", "DEFAULT_BATCH_SIZE"]

logger = logging.getLogger(__name__)

DEFAULT_FLUSH_PERIOD = 1.0   # seconds (redis/mod.rs:10-13)
DEFAULT_BATCH_SIZE = 100
DEFAULT_MAX_CACHED = 10_000


class _CachedValue:
    """Local view of one counter: last authoritative value + local deltas
    not yet flushed (CachedCounterValue, counters_cache.rs:71-120)."""

    __slots__ = ("value", "pending", "from_authority")

    def __init__(self, value: ExpiringValue, from_authority: bool):
        self.value = value
        self.pending = 0
        self.from_authority = from_authority


class CachedCounterStorage(AsyncCounterStorage):
    def __init__(
        self,
        authority: CounterStorage,
        flush_period: float = DEFAULT_FLUSH_PERIOD,
        batch_size: int = DEFAULT_BATCH_SIZE,
        max_cached: int = DEFAULT_MAX_CACHED,
        max_pending: Optional[int] = None,
        clock=time.time,
        on_partitioned: Optional[Callable[[bool], None]] = None,
    ):
        self.authority = authority
        self.flush_period = flush_period
        self.batch_size = batch_size
        self.max_cached = max_cached
        # Pending-write bound (the reference Batcher's semaphore cap,
        # counters_cache.rs:143-247): past this many distinct pending
        # counters, writers flush inline — backpressure instead of
        # unbounded growth under a slow/partitioned authority.
        self.max_pending = max_pending or batch_size * 100
        self._clock = clock
        self._on_partitioned = on_partitioned
        self.partitioned = False
        self._cache: Dict[bytes, _CachedValue] = {}
        self._counters: Dict[bytes, Counter] = {}  # key -> identity counter
        # Last observed excess-over-limit per key. Lives OUTSIDE the cache so
        # an evict/recreate cycle cannot re-count a standing excess, while a
        # genuinely new counter (baseline 0) has its first-reconcile excess
        # counted — the reference records overshoot on every reconcile
        # (counters_cache.rs:46-53). Only counters sitting above their limit
        # have entries; pruned on excess==0 / delete / clear, size-capped.
        self._overshoot_baseline: Dict[bytes, int] = {}
        self._batch: Dict[bytes, int] = {}  # pending flush deltas
        # All flushes (periodic loop + inline backpressure) serialize here:
        # each flush swaps a disjoint batch, but without ordering a later
        # batch's authority reply could reconcile before an earlier one and
        # overwrite entry.value with a stale authoritative total (the
        # reference runs every flush in the one loop task,
        # redis_cached.rs:192-203).
        self._flush_lock = asyncio.Lock()
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        # Operational counters (counters_cache.rs:49,267,368-371), polled
        # by the metrics layer via library_stats().
        self.evicted_pending_writes = 0
        self.flush_errors = 0
        self.counter_overshoot = 0
        self._flush_sizes: List[int] = []
        self._bind_metrics: Optional[Callable[[], None]] = None

    def set_metrics(self, metrics) -> None:
        """Route every flush's ``flush_batcher_and_update_counters``
        aggregate to ``metrics`` (the server's ``PrometheusMetrics``),
        whichever request's context started the flush loop: the server
        binds its metrics to gRPC requests only."""
        from ..observability.metrics import bind_request_metrics

        self._bind_metrics = lambda: bind_request_metrics(metrics)

    def library_stats(self) -> dict:
        flush_sizes, self._flush_sizes = self._flush_sizes, []
        return {
            "batcher_size": len(self._batch),
            "cache_size": len(self._cache),
            "counter_overshoot": self.counter_overshoot,
            "evicted_pending_writes": self.evicted_pending_writes,
            "flush_sizes": flush_sizes,
        }

    # -- flush loop --------------------------------------------------------

    def _ensure_started(self) -> None:
        if self._task is None or self._task.done():
            self._wake = asyncio.Event()
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        while not self._closed:
            try:
                await asyncio.wait_for(
                    self._wake.wait(), timeout=self.flush_period
                )
            except asyncio.TimeoutError:
                pass
            self._wake.clear()
            if self._batch:
                try:
                    await self.flush()
                except Exception:
                    # One bad flush must not kill write-behind; deltas for a
                    # non-transient failure are re-queued below so the next
                    # round retries them (the reference's loop lives forever,
                    # redis_cached.rs:192-203).
                    self.flush_errors += 1
                    logger.exception("write-behind flush failed; will retry")

    async def flush(self) -> None:
        """One write-behind flush: push pending deltas, reconcile
        authoritative values (flush_batcher_and_update_counters,
        redis_cached.rs:344-394). The span doubles as the
        ``flush_batcher_and_update_counters`` MetricsLayer aggregate
        (main.rs:914-917): authority I/O below lands in
        datastore_latency even though it happens off the request path.
        Detached (inherit=False): an inline backpressure flush runs under
        a request's own datastore span, and inheriting would fold the
        authority I/O into the should_rate_limit aggregate twice."""
        if self._bind_metrics is not None:
            self._bind_metrics()
        with metrics_span("flush_batcher_and_update_counters", inherit=False):
            async with self._flush_lock:
                await self._flush_locked()

    async def _flush_locked(self) -> None:
        batch, self._batch = self._batch, {}
        if not batch:
            return
        # Keys whose identity is gone (delete_counters raced the swap) are
        # dropped; everything else must survive any error path below.
        items: List[Tuple[Counter, int]] = []
        keys: List[bytes] = []
        for key, delta in batch.items():
            counter = self._counters.get(key)
            if counter is None:
                continue
            items.append((counter, delta))
            keys.append(key)
        if not items:
            return
        self._flush_sizes.append(len(items))
        del self._flush_sizes[:-1000]
        loop = asyncio.get_running_loop()
        try:
            with datastore_span("apply_deltas"):
                authoritative = await loop.run_in_executor(
                    None, self._apply_to_authority, items
                )
        except BaseException as exc:
            # Return the in-flight deltas to the batch so nothing is lost —
            # for a partition we keep serving locally (redis_cached.rs:363-388),
            # for any other failure the next round retries. entry.pending
            # still includes these deltas (they are only consumed on a
            # successful reconcile), so the local view stays correct.
            for key, (counter, delta) in zip(keys, items):
                self._batch[key] = self._batch.get(key, 0) + delta
                self._counters.setdefault(key, counter)
            if isinstance(exc, StorageError) and exc.transient:
                self._set_partitioned(True)
                return
            raise
        self._set_partitioned(False)
        now = self._clock()
        for key, (counter, flushed), (value, ttl) in zip(
            keys, items, authoritative
        ):
            entry = self._cache.get(key)
            if entry is None:
                # Evicted while in flight: the authority has the delta; drop
                # the identity unless new deltas queued behind it.
                if key not in self._batch:
                    self._counters.pop(key, None)
                continue
            # The flushed amount is now part of the authoritative value;
            # deltas queued while the flush was in flight remain pending and
            # are layered on top (add_from_authority semantics,
            # counters_cache.rs:303-331 — remote increments become visible,
            # local unflushed writes are preserved).
            entry.pending = max(entry.pending - flushed, 0)
            entry.value.set(value + entry.pending, ttl, now)
            entry.from_authority = True
            # Overshoot: how far the replica fleet admitted past the limit
            # while views were stale (counters_cache.rs:46-53). Count the
            # growth of the excess since this KEY's last reconcile — the
            # baseline survives eviction (see _overshoot_baseline), so a
            # new counter's first burst is counted but an evict/recreate
            # cycle never re-counts the same standing excess.
            excess = max(value - counter.max_value, 0)
            baseline = self._overshoot_baseline.get(key, 0)
            if excess > baseline:
                self.counter_overshoot += excess - baseline
            if excess > 0:
                # pop-then-set refreshes dict insertion order, so the size
                # cap evicts the stalest baseline, not a hot key whose
                # re-count would inflate the metric.
                self._overshoot_baseline.pop(key, None)
                self._overshoot_baseline[key] = excess
                if len(self._overshoot_baseline) > 4 * self.max_cached:
                    self._overshoot_baseline.pop(
                        next(iter(self._overshoot_baseline))
                    )
            else:
                self._overshoot_baseline.pop(key, None)

    def _apply_to_authority(self, items: List[Tuple[Counter, int]]):
        apply = getattr(self.authority, "apply_deltas", None)
        if apply is not None:
            return apply(items)
        # Fallback: plain updates, reconcile with a local re-read.
        out = []
        for counter, delta in items:
            self.authority.update_counter(counter, delta)
            out.append((0, counter.window_seconds))
        return out

    def _set_partitioned(self, value: bool) -> None:
        if value != self.partitioned:
            self.partitioned = value
            if self._on_partitioned:
                self._on_partitioned(value)

    # -- cache helpers ------------------------------------------------------

    def _entry(self, counter: Counter, key: bytes, now: float) -> _CachedValue:
        entry = self._cache.get(key)
        if entry is None:
            # Optimistic miss: assume a fresh window (the documented lie).
            entry = _CachedValue(
                ExpiringValue(0, now + counter.window_seconds),
                from_authority=False,
            )
            # If the key was evicted with deltas still queued, those deltas
            # are this counter's unflushed local writes — re-adopt them so
            # the post-flush reconcile stays exact.
            entry.pending = self._batch.get(key, 0)
            self._cache[key] = entry
            self._counters[key] = counter.key()
            if len(self._cache) > self.max_cached:
                evict = next(iter(self._cache))
                if evict != key:
                    self._cache.pop(evict, None)
                    if evict in self._batch:
                        # Keep the identity alive: the batcher still owns a
                        # pending delta and the next flush must be able to
                        # deliver it (counters_cache.rs:278-301,
                        # evicted_pending_writes).
                        self.evicted_pending_writes += 1
                    else:
                        self._counters.pop(evict, None)
        return entry

    def _queue(
        self, counter: Counter, key: bytes, delta: int, now: float
    ) -> None:
        entry = self._cache.get(key)
        if entry is not None:
            # Track the unflushed local delta so the flush reconcile can
            # preserve writes that race an in-flight batch
            # (pending_writes_and_value, counters_cache.rs:71-98).
            entry.pending += delta
        self._batch[key] = self._batch.get(key, 0) + delta
        if self._wake is None:
            return
        # Flush triggers: batch full | priority (counters_cache.rs:138-247)
        # — a counter the authority has never seen, or one whose window
        # expires before the next interval flush could deliver it.
        if (
            len(self._batch) >= self.batch_size
            or entry is None
            or not entry.from_authority
            or entry.value.ttl(now) <= 2 * self.flush_period
        ):
            self._wake.set()

    async def _backpressure(self) -> None:
        """Bound pending writes (the reference Batcher's semaphore): past
        max_pending distinct counters, the writer flushes inline instead of
        queueing further. Never during a partition (deltas re-queue anyway
        and the replica must keep serving from local state), and a flush
        failure here is counted, not surfaced — the request was already
        admitted locally."""
        if len(self._batch) >= self.max_pending and not self.partitioned:
            try:
                async with self._flush_lock:
                    # Re-check after the wait: a writer queued behind an
                    # in-flight flush usually finds the batch already
                    # drained — don't pay an authority round-trip for the
                    # couple of deltas that trickled in meanwhile.
                    if len(self._batch) >= self.max_pending:
                        await self._flush_locked()
            except Exception:
                self.flush_errors += 1
                logger.exception("inline backpressure flush failed")

    # -- AsyncCounterStorage -------------------------------------------------

    async def is_within_limits(self, counter: Counter, delta: int) -> bool:
        now = self._clock()
        entry = self._cache.get(key_for_counter(counter))
        value = entry.value.value_at(now) if entry is not None else 0
        return value + delta <= counter.max_value

    async def add_counter(self, limit: Limit) -> None:
        pass

    async def update_counter(self, counter: Counter, delta: int) -> None:
        # Reject at enqueue: a negative delta queued into the batch would
        # poison every subsequent flush against an authority that enforces
        # unsigned deltas (the re-queue-on-error path retries the batch).
        require_nonnegative_delta(delta)
        self._ensure_started()
        now = self._clock()
        key = key_for_counter(counter)
        entry = self._entry(counter, key, now)
        entry.value.update(delta, counter.window_seconds, now)
        self._queue(counter, key, delta, now)
        await self._backpressure()

    async def check_and_update(
        self, counters: List[Counter], delta: int, load_counters: bool
    ) -> Authorization:
        require_nonnegative_delta(delta)
        self._ensure_started()
        now = self._clock()
        first_limited: Optional[Authorization] = None
        staged: List[Tuple[Counter, bytes, _CachedValue]] = []
        for counter in counters:
            key = key_for_counter(counter)
            entry = self._entry(counter, key, now)
            value = entry.value.value_at(now)
            if load_counters:
                remaining = counter.max_value - (value + delta)
                counter.remaining = max(remaining, 0)
                counter.expires_in = entry.value.ttl(now)
                if first_limited is None and remaining < 0:
                    first_limited = Authorization.limited_by(counter.limit.name)
            if value + delta > counter.max_value:
                if not load_counters:
                    return Authorization.limited_by(counter.limit.name)
            staged.append((counter, key, entry))
        if first_limited is not None:
            return first_limited
        for counter, key, entry in staged:
            entry.value.update(delta, counter.window_seconds, now)
            self._queue(counter, key, delta, now)
        await self._backpressure()
        return Authorization.OK

    async def get_counters(self, limits: Set[Limit]) -> Set[Counter]:
        now = self._clock()
        out: Set[Counter] = set()
        namespaces = {limit.namespace for limit in limits}
        for key, counter in self._counters.items():
            if counter.limit in limits or counter.namespace in namespaces:
                entry = self._cache.get(key)
                if entry is None or entry.value.is_expired(now):
                    continue
                c = counter.key()
                c.remaining = c.max_value - entry.value.value_at(now)
                c.expires_in = entry.value.ttl(now)
                out.add(c)
        return out

    async def delete_counters(self, limits: Set[Limit]) -> None:
        doomed = [
            key
            for key, counter in self._counters.items()
            if counter.limit in limits
        ]
        for key in doomed:
            self._cache.pop(key, None)
            self._counters.pop(key, None)
            self._batch.pop(key, None)
            self._overshoot_baseline.pop(key, None)
        self.authority.delete_counters(limits)

    async def clear(self) -> None:
        self._cache.clear()
        self._counters.clear()
        self._batch.clear()
        self._overshoot_baseline.clear()
        self.authority.clear()

    async def close(self) -> None:
        self._closed = True
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        await asyncio.get_running_loop().run_in_executor(
            None, self.authority.close
        )
