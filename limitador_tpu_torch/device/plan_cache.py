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

Port counterpart of ``limitador_tpu/tpu/plan_cache.py``. A pod member's
native pipeline memoizes a blob whose counters another host owns as a
``PLAN_FOREIGN`` plan with its ``owner``. The plan-seed wire form
(``plan_to_wire``/``plan_from_wire``, ``export_seed``/``import_seed``)
ships a donor's plans to a joining pod host (``server/resize.py``); its
bytes equal the JAX package's for the same plan.
"""

from __future__ import annotations

import base64
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

__all__ = [
    "DecisionPlan",
    "DecisionPlanCache",
    "CounterPlanCache",
    "PLAN_KERNEL",
    "PLAN_OK",
    "PLAN_UNKNOWN",
    "PLAN_FOREIGN",
    "plan_to_wire",
    "plan_from_wire",
    "METRIC_FAMILIES",
]

#: the plan caches' families, as the JAX package
#: registers them (the analysis gate holds them to
#: observability/metrics.py)
METRIC_FAMILIES = (
    "plan_cache_hits",
    "plan_cache_misses",
    "plan_cache_evictions",
    "plan_cache_invalidations",
    "plan_cache_size",
)

PLAN_KERNEL = 0   # resolved device hits; decision comes from the kernel
PLAN_OK = 1       # no limit applies: answer the OK template directly
PLAN_UNKNOWN = 2  # empty/absent domain: answer the UNKNOWN template
PLAN_FOREIGN = 3  # pod: another host owns the counters; bulk-forward


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
        "limit_names", "slots", "owner",
    )

    def __init__(self, kind, namespace=None, delta=1, delta_capped=1,
                 record=(), limit_names=(), slots=(), owner=-1):
        self.kind = kind
        self.namespace = namespace
        self.delta = delta
        self.delta_capped = delta_capped
        self.record = record
        self.nhits = len(record) // 4
        self.limit_names = limit_names
        self.slots = slots  # tuple of ints, for the reverse index
        #: pod ownership: the host that must decide this blob; -1 =
        #: locally owned (always -1 outside a pod). A PLAN_FOREIGN plan
        #: pins no slots: its counters live on the owner.
        self.owner = owner


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


    # -- plan seed (a joining pod host's warm start) --------------------------

    def export_seed(self, counter_of_slot=None,
                    max_entries: int = 4096) -> List[dict]:
        """The portable seed of this cache: newest entries first, bounded
        so that one seed RPC stays within the lane's receive cap. Kernel
        plans whose hits cannot be attributed to live counters are
        skipped (``plan_to_wire``)."""
        with self._lock:
            items = list(self._entries.items())[-int(max_entries):]
        out = []
        for blob, plan in reversed(items):
            wire = plan_to_wire(blob, plan, counter_of_slot)
            if wire is not None:
                out.append(wire)
        return out

    def import_seed(self, entries, slot_of_counter=None,
                    epoch: Optional[int] = None) -> int:
        """Replay a shipped seed through :meth:`put` under ``epoch`` (the
        limits epoch taken when the ship started): a limits reload racing
        the ship bumps the epoch and every row is discarded. Returns the
        number of rows seeded."""
        if epoch is None:
            epoch = self.epoch
        seeded = 0
        for entry in entries:
            try:
                rebuilt = plan_from_wire(entry, slot_of_counter)
            except (KeyError, ValueError, TypeError):
                continue  # one malformed row must not fail the seed
            if rebuilt is None:
                continue
            blob, plan = rebuilt
            before = len(self._entries)
            self.put(blob, plan, epoch)
            if len(self._entries) > before:
                seeded += 1
        return seeded


# -- the plan-seed wire form -------------------------------------------------
# A joining host starts with an empty plan cache. The seed ships the
# donor's blob -> plan entries over the ``plan_seed`` lane kind
# (server/peering.py) in a portable form: slot indices are host-local, so
# a kernel hit travels as the identity of the counter that resolved it and
# the portable ints of its record; the importer resolves slots against
# its own table. Import rides ``DecisionPlanCache.put``, so that a limits
# reload racing the ship discards the seed through the stale-epoch rule.


def _limit_identity_to_wire(limit) -> dict:
    """JSON-safe identity of a Limit (the fields the migrate lane's
    ``_counter_to_wire`` carries; ``policy`` is part of the identity)."""
    return {
        "ns": str(limit.namespace),
        "max": limit.max_value,
        "seconds": limit.seconds,
        "conditions": sorted(c.source for c in limit.conditions),
        "variables": sorted(v.source for v in limit.variables),
        "name": limit.name,
        "id": limit.id,
        "policy": limit.policy,
    }


def _counter_identity_from_wire(blob: dict):
    from ..core.counter import Counter
    from ..core.limit import Limit

    limit = Limit(
        blob["ns"], blob["max"], blob["seconds"],
        blob.get("conditions", ()), blob.get("variables", ()),
        name=blob.get("name"), id=blob.get("id"),
        policy=blob.get("policy", "fixed_window"),
    )
    return Counter(limit, dict(blob.get("vars", ())))


def plan_to_wire(blob: bytes, plan: DecisionPlan,
                 counter_of_slot=None) -> Optional[dict]:
    """One cache entry as a JSON-safe seed row, or None when it cannot
    travel (a kernel hit whose slot no longer names a counter).
    ``counter_of_slot(slot) -> Counter or None`` attributes kernel hits;
    without it kernel plans are skipped."""
    out = {
        "blob": base64.b64encode(blob).decode(),
        "kind": int(plan.kind),
        "ns": plan.namespace,
        "delta": int(plan.delta),
        "delta_capped": int(plan.delta_capped),
        "owner": int(plan.owner),
        "names": list(plan.limit_names),
    }
    if plan.kind != PLAN_KERNEL:
        return out
    if counter_of_slot is None:
        return None
    hits = []
    record = plan.record
    for i in range(plan.nhits):
        slot = record[4 * i]
        counter = counter_of_slot(slot)
        if counter is None:
            return None
        wire = _limit_identity_to_wire(counter.limit)
        wire["vars"] = sorted(counter.set_variables.items())
        hits.append({
            "c": wire,
            # (max, window_ms, bucket flag) ship as they are; only the
            # slot column is host-local
            "rec": [int(record[4 * i + 1]), int(record[4 * i + 2]),
                    int(record[4 * i + 3])],
        })
    out["hits"] = hits
    return out


def plan_from_wire(entry: dict, slot_of_counter=None
                   ) -> Optional[Tuple[bytes, DecisionPlan]]:
    """Rebuild (blob, plan) from one seed row under this host's table.
    ``slot_of_counter(counter) -> slot or None`` resolves (allocating)
    the importer's slot of each kernel hit; a row that cannot resolve
    (a full table) is skipped, never seeded wrong."""
    blob = base64.b64decode(entry["blob"])
    kind = int(entry["kind"])
    if kind != PLAN_KERNEL:
        return blob, DecisionPlan(
            kind, namespace=entry.get("ns"), delta=int(entry["delta"]),
            delta_capped=int(entry.get("delta_capped", 1)),
            owner=int(entry.get("owner", -1)),
        )
    if slot_of_counter is None:
        return None
    record: List[int] = []
    for hit in entry.get("hits", ()):
        counter = _counter_identity_from_wire(hit["c"])
        slot = slot_of_counter(counter)
        if slot is None:
            return None
        rec = hit["rec"]
        record.extend((int(slot), int(rec[0]), int(rec[1]), int(rec[2])))
    record_t = tuple(record)
    return blob, DecisionPlan(
        PLAN_KERNEL,
        namespace=entry.get("ns"),
        delta=int(entry["delta"]),
        delta_capped=int(entry.get("delta_capped", 1)),
        record=record_t,
        limit_names=tuple(entry.get("names", ())),
        slots=record_t[0::4],
        owner=int(entry.get("owner", -1)),
    )


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
