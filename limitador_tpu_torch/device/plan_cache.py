"""Hot-descriptor decision-plan caches for the serving fast paths.

Under Zipf-shaped traffic most requests are byte-identical descriptor
sets, yet every request used to re-derive the same work: protobuf parse,
CEL limit selection, counter-key encoding and slot hashing. These caches
memoize the derived *plan* — which limits match, which device slots they
hit, and which prebuilt response template answers each outcome — keyed
by what the wire actually repeats:

- ``DecisionPlanCache`` (native columnar path): raw RateLimitRequest
  blob -> ``DecisionPlan``. A kernel plan carries the resolved device
  hits as one flat tuple of Python ints so a whole batch of cached rows
  assembles into kernel arrays with a single ``np.array`` conversion
  (no per-row numpy calls); trivial plans short-circuit to the OK /
  UNKNOWN response blobs without touching the device.
- ``CounterPlanCache`` (compiled + gRPC path): (namespace, descriptor
  values) -> the resolved ``Counter`` list, skipping CEL evaluation and
  Counter construction for repeat identities.

Coherence contract (the part that makes caching safe):

- **Limits epoch**: every cache carries an epoch counter; any limits
  change (add/update/delete/reload) bumps it, which atomically orphans
  every cached plan — a stale plan can never outlive the limits that
  produced it. Entries are dropped eagerly on the bump (the map is the
  invalidation, not a lazy per-entry check).
- **Slot coherence** (DecisionPlanCache only): plans pin device slot
  indices, so an LRU eviction/delete/clear that releases a slot drops
  every plan referencing it via the reverse index (``invalidate_slot``
  is called from the slot table's release hook, under the storage
  lock — the same lock the lookup->launch window holds).

Both caches are size-bounded (insertion-ordered eviction — hits are
deliberately not re-ranked; the O(1) read beats exact LRU on the hot
loop, and the cap is a memory bound, not a working-set model). Stats
are cumulative counts (``stats()``).

Port counterpart of ``limitador_tpu/tpu/plan_cache.py``. The plan-seed
wire form (``plan_to_wire``/``plan_from_wire``, ``export_seed``/
``import_seed``) that ships plans to a joining pod host waits for the
pod slice.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

__all__ = [
    "DecisionPlan",
    "DecisionPlanCache",
    "CounterPlanCache",
    "PLAN_KERNEL",
    "PLAN_OK",
    "PLAN_UNKNOWN",
]

PLAN_KERNEL = 0   # resolved device hits; decision comes from the kernel
PLAN_OK = 1       # no limit applies: answer the OK template directly
PLAN_UNKNOWN = 2  # empty/absent domain: answer the UNKNOWN template


class DecisionPlan:
    """Memoized per-blob decision plan.

    ``record`` is a flat tuple of Python ints, 4 per hit in limit
    compile order: (slot, max_value, window_ms, bucket_flag). Keeping it
    a plain tuple (not arrays) is what lets batch staging convert a
    whole group of same-arity plans with ONE ``np.array(list_of_tuples)``
    call. ``delta`` is the request's raw hits_addend (blob-identical
    requests carry identical addends); ``delta_capped`` the per-hit
    device delta. ``namespace`` is None for plans that must not count
    metrics (the empty-limits-namespace OK path counts nothing, matching
    the uncached path)."""

    __slots__ = (
        "kind", "namespace", "delta", "delta_capped", "nhits", "record",
        "limit_names", "slots",
    )

    def __init__(self, kind, namespace=None, delta=1, delta_capped=1,
                 record=(), limit_names=(), slots=()):
        self.kind = kind
        self.namespace = namespace
        self.delta = delta
        self.delta_capped = delta_capped
        self.record = record
        self.nhits = len(record) // 4
        self.limit_names = limit_names
        self.slots = slots  # tuple of ints, for the reverse index


class _BaseCache:
    """LRU + epoch machinery shared by both caches."""

    def __init__(self, max_size: int):
        self.max_size = int(max_size)
        self.epoch = 0
        self._entries: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()
        # cumulative stats (polled by metrics; monotone)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        # post-bump notification (outside the lock): the lease broker's
        # wake-up so limits reloads settle stranded lease tokens without
        # waiting out a refresh interval.
        self.on_epoch_bump = None

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key):
        """Single-key lookup. Hot batch loops should read
        ``cache.entries.get`` directly and account stats once per batch
        via ``count`` — a per-row bound-method call plus per-row stats
        increments measurably tax the cached lane."""
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        return entry

    @property
    def entries(self):
        """The underlying mapping, for batch-loop lookups. Insertion
        order approximates recency (entries are not re-ranked on hit:
        the O(1) read is worth more than exact LRU — eviction is a cap,
        not a working-set model)."""
        return self._entries

    def count(self, hits: int, misses: int) -> None:
        """Batched stats accounting for loops that read ``entries``
        directly."""
        self.hits += hits
        self.misses += misses

    def bump_epoch(self) -> None:
        """Limits changed: orphan every cached plan atomically. The
        optional ``on_epoch_bump`` hook fires AFTER the bump, outside
        the lock (the lease broker rides it to settle reload-stranded
        tokens promptly — the C mirror clears lazily at its next begin,
        pushing any leased balances onto the return ring)."""
        with self._lock:
            self.epoch += 1
            self.invalidations += len(self._entries)
            self._clear_locked()
        hook = self.on_epoch_bump
        if hook is not None:
            hook()

    def _clear_locked(self) -> None:
        self._entries.clear()

    def _evict_locked(self) -> None:
        while len(self._entries) > self.max_size:
            key, entry = self._entries.popitem(last=False)
            self.evictions += 1
            self._on_evict(key, entry)

    def _on_evict(self, key, entry) -> None:
        pass

    def stats(self) -> dict:
        return {
            "plan_cache_hits": self.hits,
            "plan_cache_misses": self.misses,
            "plan_cache_evictions": self.evictions,
            "plan_cache_invalidations": self.invalidations,
            "plan_cache_size": len(self._entries),
            "plan_cache_epoch": self.epoch,
        }

    @property
    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class DecisionPlanCache(_BaseCache):
    """blob -> DecisionPlan with per-slot invalidation.

    Lookup and insertion on the hot path run under the storage lock
    (the caller's lookup->launch window), which is also the lock every
    slot release fires ``invalidate_slot`` under — a plan returned by
    ``get`` references only live slots until the caller's kernel
    launches."""

    def __init__(self, max_size: int = 1 << 16):
        super().__init__(max_size)
        # slot -> set of blob keys whose plans pin it
        self._by_slot: Dict[int, set] = {}
        # Downstream mirrors (the C-side plan mirror of the native hot
        # lane, native/hostpath.cc): every slot invalidation forwards so
        # a mirrored plan can never outlive the slot it pins. Epoch
        # bumps need no forwarding — mirrors sync the epoch lazily at
        # their next begin, which clears them before any lookup under
        # the new epoch.
        self._mirrors: list = []

    def add_mirror(self, mirror) -> None:
        """Register an object with ``invalidate_slot(slot)``; called
        under the storage lock on every slot release."""
        self._mirrors.append(mirror)

    def remove_mirror(self, mirror) -> None:
        try:
            self._mirrors.remove(mirror)
        except ValueError:
            pass

    def put(self, blob: bytes, plan: DecisionPlan,
            epoch: Optional[int] = None) -> None:
        """Insert a plan. ``epoch`` is the limits epoch the caller
        snapshotted BEFORE deriving the plan: if a bump happened in
        between (a limits reload raced the derivation on another
        thread), the plan was derived from dead limits and is discarded
        — without this, a stale plan inserted after the bump would be
        filed under the new epoch and served indefinitely."""
        if self.max_size <= 0:
            return
        with self._lock:
            if epoch is not None and epoch != self.epoch:
                return
            old = self._entries.get(blob)
            if old is not None:
                self._unindex(blob, old)
            self._entries[blob] = plan
            self._entries.move_to_end(blob)
            for slot in plan.slots:
                self._by_slot.setdefault(slot, set()).add(blob)
            self._evict_locked()

    def invalidate_slot(self, slot: int) -> None:
        """A device slot was released (LRU eviction / delete / clear):
        drop every plan that pinned it. Called under the storage lock.
        Mirrors are notified UNCONDITIONALLY — this cache's LRU may have
        evicted the plan while the mirror still holds it, so an empty
        reverse-index bucket here proves nothing about the mirror."""
        for mirror in self._mirrors:
            mirror.invalidate_slot(slot)
        with self._lock:
            keys = self._by_slot.pop(slot, None)
            if not keys:
                return
            for key in keys:
                entry = self._entries.pop(key, None)
                if entry is not None:
                    self.invalidations += 1
                    self._unindex(key, entry, skip_slot=slot)

    def _unindex(self, key, plan, skip_slot: Optional[int] = None) -> None:
        for slot in plan.slots:
            if slot == skip_slot:
                continue
            bucket = self._by_slot.get(slot)
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._by_slot[slot]

    def _on_evict(self, key, entry) -> None:
        self._unindex(key, entry)

    def _clear_locked(self) -> None:
        super()._clear_locked()
        self._by_slot.clear()


class CounterPlanCache(_BaseCache):
    """(namespace, descriptor-values tuple) -> resolved Counter list.

    Counters are shared across requests, so this cache only serves
    ``load_counters=False`` traffic (the caller's contract): loads
    mutate per-counter observability fields and need fresh objects."""

    def put(self, key: Tuple, counters,
            epoch: Optional[int] = None) -> None:
        """Insert a resolved counter list; ``epoch`` is the caller's
        pre-derivation snapshot — a mismatch means a limits change raced
        the evaluation, so the entry is discarded (same contract as
        DecisionPlanCache.put)."""
        if self.max_size <= 0:
            return
        with self._lock:
            if epoch is not None and epoch != self.epoch:
                return
            self._entries[key] = counters
            self._entries.move_to_end(key)
            self._evict_locked()
