"""TieredStorage: the device table over an exact host cold tier.

Port counterpart of ``limitador_tpu/tier/storage.py``: a ``TorchStorage``
whose keyspace is no longer bounded by device memory. The device table
serves the resident hot set, and everything else lives in the
:class:`~limitador_tpu_torch.tier.cold.ColdStore`: exact host cells
behind the same decision lane the big-limit host path already rides.
The integration points that make residency a pure performance fact:

* **Routing**: ``_is_big`` answers True for cold residents, so every
  per-request entry point (begin_check_many, is_within_limits,
  update_counter, apply_deltas) routes cold keys down the exact host
  lane with no new decision code. ``_big_cell`` serves the cold cell and
  counts the touch as heat; ``_apply_big``/``_on_big_write`` journal
  cold writes.
* **Eviction IS demotion**: ``_evict_one`` reads the LRU slot's exact
  device state (one B3a peek under the lock, on the storage stream after
  every prior launch, so it observes all applied batches) and seats it
  in the cold tier before releasing the slot.
* **The columnar lanes promote on demand**: the native pipeline decides
  on the device only and allocates its missing slots through
  ``_slot_for``. A cold key arriving there is promoted on the spot (one
  B4d seed of its exact cell) instead of getting a fresh slot beside its
  cold cell. The JAX package has no such step: its native pipeline
  counts a returning cold key from zero on a new slot while the cold
  cell stays (ROADMAP Queue C).

Migrations (TierManager-driven) are two-phase: phase A records the key
and its absolute state in a ledger; phase B re-reads the absolute state
and seats it in the destination tier atomically with the residency
flip, under the storage lock. The ledger buys idempotency (a retried
phase B finds the key already moved and does nothing) and abort
push-back (dropping the ledger leaves the source tier untouched:
nothing doubled, nothing lost).

The host decisions happen in the JAX order (one B4d seed per promoted
key before the next slot allocation, one B3a peek per eviction), so the
port's slot allocation, and with it the final arrays, equal the JAX
package's on the same inputs.

Snapshots carry the cold cells beside the big-limit cells
(``_snapshot_table``), and ``restore``/``from_snapshot`` take the spill
path. The JAX package's tiered snapshot writes the device table alone,
so a restart forgets every cold counter's spent quota (ROADMAP Queue C).

Cold decides time themselves into the ``tier_cold_decide_seconds``
samples and, with a process flight recorder attached (``flight_tap``,
set by the server), tap its ``cold_tier`` lane.

Lock order: everything here runs under the inherited storage lock; the
cold store takes no lock of its own. Keys with live ``_big_inflight``
reservations never migrate, so an in-flight host decision can never
lose its apply to a residency flip.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device.storage import TorchStorage, cell_rows
from ..storage.base import StorageError
from ..storage.expiring_value import ExpiringValue
from ..storage.gcra import restore_cell
from .cold import ColdStore

__all__ = ["TieredStorage"]

_INT32_MAX = int(np.iinfo(np.int32).max)


class TieredStorage(TorchStorage):
    """Device-resident hot set over an exact host cold tier."""

    def __init__(
        self,
        capacity: int = 1 << 20,
        cache_size: Optional[int] = None,
        clock=time.time,
        spill_path: Optional[str] = None,
        device=None,
    ):
        super().__init__(
            capacity=capacity, cache_size=cache_size, clock=clock,
            device=device,
        )
        self._cold = ColdStore(spill_path)
        # Migration ledgers (key -> (counter, absolute state at phase A)):
        # the receiver-ledger halves of the two migration directions.
        self._promo_ledger: Dict[tuple, tuple] = {}
        self._demo_ledger: Dict[tuple, tuple] = {}
        # cold-decide latency ring (p50/p99 for tier_stats) + the
        # undrained samples feeding the tier_cold_decide_seconds histogram
        self._cold_decide_s: deque = deque(maxlen=1024)
        self._decide_pending: List[float] = []
        #: optional flight.FlightRecorder: cold-tier decisions tap its
        #: ``cold_tier`` lane (set by the server)
        self.flight_tap = None

    # -- decision routing (the big-limit host lane serves cold keys) -------

    def _is_big(self, counter) -> bool:
        if super()._is_big(counter):
            return True
        return self._key_of(counter) in self._cold.cells

    def _big_cell(self, counter, key: tuple):
        entry = self._cold.cells.get(key)
        if entry is not None:
            self._cold.touch(key)
            return entry[0]
        return super()._big_cell(counter, key)

    def _apply_big(self, applies, now: float) -> None:
        rest = []
        for key, delta, window in applies:
            entry = self._cold.cells.get(key)
            if entry is None:
                rest.append((key, delta, window))
                continue
            entry[0].update(delta, window, now)
            self._cold.record_write(key)
        if rest:
            super()._apply_big(rest, now)

    def _on_big_write(self, key: tuple) -> None:
        if key in self._cold.cells:
            self._cold.record_write(key)
            return
        super()._on_big_write(key)

    def _eval_big_hits(self, ordered, raw_delta: int, now: float):
        d0 = self._cold.decisions
        t0 = time.perf_counter()
        out = super()._eval_big_hits(ordered, raw_delta, now)
        if self._cold.decisions != d0:
            dt = time.perf_counter() - t0
            self._cold_decide_s.append(dt)
            if len(self._decide_pending) < 4096:
                self._decide_pending.append(dt)
            tap = self.flight_tap
            if tap is not None:
                tap.tap(dt, "cold_tier",
                        namespace=ordered[0].namespace if ordered else None)
        return out

    def _emit_big_counters(self, limits, namespaces, now, out) -> None:
        super()._emit_big_counters(limits, namespaces, now, out)
        for _key, (cell, counter) in self._cold.cells.items():
            if (
                counter.limit in limits
                or counter.namespace in namespaces
            ) and not cell.is_expired(now):
                c = counter.key()
                c.remaining = c.max_value - cell.value_at(now)
                c.expires_in = cell.ttl(now)
                out.add(c)

    def _delete_big(self, limits) -> None:
        super()._delete_big(limits)
        for key, (_cell, counter) in list(self._cold.cells.items()):
            if counter.limit in limits:
                self._cold.drop(key)

    def _clear_big(self) -> None:
        super()._clear_big()
        self._cold.clear()

    def is_within_limits(self, counter, delta: int) -> bool:
        with self._lock:  # RLock: super() re-enters below
            entry = self._cold.cells.get(self._key_of(counter))
            if entry is not None:
                self._cold.touch(self._key_of(counter))
                value = entry[0].value_at(self._clock())
                return value + delta <= counter.max_value
            return super().is_within_limits(counter, delta)

    # -- eviction IS demotion ----------------------------------------------

    def _evict_one(self) -> None:
        """Demote the LRU qualified slot instead of dropping it: peek
        the exact device cell (in program order after every applied
        batch) and seat it cold before release. Outstanding lease
        tokens are NOT settled here (the broker's identity check drops
        a released slot's credits, as on a plain eviction); manager-driven
        demotions settle first (TierManager)."""
        key, slot = self._lru_victim()
        entry = self._table.info.get(slot)
        values, ttls = self.peek_slots([slot])
        if entry is not None and int(ttls[0]) > 0:
            counter = entry[1]
            self._cold.seat(
                key, self._demoted_cell(counter, int(values[0]),
                                        int(ttls[0])), counter,
            )
        self._table.release(slot, key, qualified=True)
        self._table.evictions += 1

    def _demoted_cell(self, counter, value: int, ttl_ms: int):
        """Exact host cell from an observed device cell. Fixed windows:
        (value, absolute expiry). Device bucket cells live at scale 1
        (ms ticks) with the TAT in the expiry lane, so absolute TAT =
        now_ms + base_rel (the observed ttl)."""
        now = self._clock()
        if counter.limit.policy == "token_bucket":
            return restore_cell(
                counter.limit, int(now * 1000) + int(ttl_ms), 1
            )
        return ExpiringValue(int(value), now + ttl_ms / 1000.0)

    # -- promotion -----------------------------------------------------------

    def _seed_from_cold(self, key: tuple, counter, cell, now: float,
                        now_ms: int) -> int:
        """Give a cold key a device slot seeded with its exact cell (one
        B4d launch) and release it from the cold tier; returns the slot.
        Seeds BEFORE the next allocation: a later _slot_for may evict
        this very slot, and _evict_one's exactness peek must observe the
        promoted state, not the previous occupant's stale cell. Caller
        holds the lock and has checked the cell is live."""
        if counter.limit.policy == "token_bucket":
            # device bucket: TAT rides the expiry lane (scale 1); the
            # values lane is unspecified for buckets
            value = 0
        else:
            value = int(cell.value_at(now))
        exp_rel = min(now_ms + int(round(cell.ttl(now) * 1000)), _INT32_MAX)
        slot, _fresh = super()._slot_for(counter, create=True)
        self.seed_slot_values([slot], [value], [exp_rel])
        self._cold.release(key)
        return slot

    def _slot_for(self, counter, create: bool):
        """The base lookup, except that creating a slot for a cold key
        promotes it (its exact cell seeded through B4d) and answers
        ``fresh=False``, so the kernel counts on from the seeded cell. The
        per-request lanes never get here with a cold key (``_is_big``
        routes it to the host first); the native pipeline's slot-map
        misses do. A cold key with an in-flight host decision cannot move
        (that decision's apply would lose its cell): its request fails
        with StorageError, as on a full table."""
        if create:
            key = self._key_of(counter)
            entry = self._cold.cells.get(key)
            if entry is not None and not super()._is_big(counter):
                if key in self._big_inflight:
                    raise StorageError(
                        "a cold counter with an in-flight host decision "
                        "cannot move to the device yet"
                    )
                cell = entry[0]
                now = self._clock()
                if cell.is_expired(now):
                    # no live state: the new slot starts fresh
                    self._cold.release(key)
                else:
                    slot = self._seed_from_cold(key, counter, cell, now,
                                                self._now_ms())
                    return slot, False
        return super()._slot_for(counter, create)

    # -- migration primitives (TierManager) --------------------------------

    def promote_begin(self, keys) -> List[tuple]:
        """Phase A of cold->device moves: ledger each key with the
        absolute cell state observed now. Keys that are not cold, are
        already in a migration, carry an in-flight host reservation, or
        are host-only by policy (``super()._is_big``) are skipped."""
        rows: List[tuple] = []
        with self._lock:
            now = self._clock()
            for key in keys:
                entry = self._cold.cells.get(key)
                if (
                    entry is None
                    or key in self._promo_ledger
                    or key in self._big_inflight
                ):
                    continue
                cell, counter = entry
                if super()._is_big(counter):
                    continue  # host-exact by policy: never device-resident
                self._promo_ledger[key] = (counter, cell.value_at(now))
                rows.append(key)
        return rows

    def promote_finish(self, keys) -> int:
        """Phase B: re-read each ledgered key's absolute state and seed
        a device slot with it, atomically with the residency flip.
        Idempotent: a key no longer cold (retried phase B, or deleted)
        settles its ledger row and moves nothing."""
        moved = 0
        with self._lock:
            now = self._clock()
            now_ms = self._now_ms()
            for key in keys:
                led = self._promo_ledger.pop(key, None)
                if led is None:
                    continue
                entry = self._cold.cells.get(key)
                if entry is None or key in self._big_inflight:
                    continue
                cell, counter = entry
                if cell.is_expired(now):
                    # no live state: the next device hit starts fresh
                    self._cold.release(key)
                else:
                    self._seed_from_cold(key, counter, cell, now, now_ms)
                moved += 1
        return moved

    def demote_begin(self, keys) -> List[tuple]:
        """Phase A of device->cold moves: ledger each qualified
        resident key with its absolute device state observed now.
        (Simple-limit slots are pinned: they never demote, matching
        the eviction policy.)"""
        rows: List[tuple] = []
        with self._lock:
            targets = [
                (key, self._table.qualified[key]) for key in keys
                if key in self._table.qualified
                and key not in self._demo_ledger
            ]
            if not targets:
                return rows
            values, ttls = self.peek_slots([s for _k, s in targets])
            for i, (key, slot) in enumerate(targets):
                entry = self._table.info.get(slot)
                if entry is None:
                    continue
                self._demo_ledger[key] = (
                    entry[1], int(values[i]), int(ttls[i])
                )
                rows.append(key)
        return rows

    def demote_finish(self, keys) -> int:
        """Phase B: re-read each ledgered key's absolute device state,
        seat the exact cold cell and release the slot, in one atomic
        section, so the release hooks (plan-cache drop, native-map
        removal) fire with the cold cell already serving. Idempotent: a
        key no longer resident settles its ledger row and moves
        nothing."""
        moved = 0
        with self._lock:
            for key in keys:
                led = self._demo_ledger.pop(key, None)
                if led is None:
                    continue
                slot = self._table.qualified.get(key)
                if slot is None:
                    continue  # evicted or deleted since phase A
                entry = self._table.info.get(slot)
                values, ttls = self.peek_slots([slot])
                if entry is not None and int(ttls[0]) > 0:
                    counter = entry[1]
                    self._cold.seat(
                        key,
                        self._demoted_cell(counter, int(values[0]),
                                           int(ttls[0])),
                        counter,
                    )
                self._table.release(slot, key, qualified=True)
                moved += 1
        return moved

    def migrate_abort(self) -> dict:
        """Push both ledgers back: phase A moved nothing, so dropping
        the ledgers IS the abort (the source tiers still own every
        ledgered key: nothing doubled, nothing lost)."""
        with self._lock:
            n_promo, n_demo = len(self._promo_ledger), len(self._demo_ledger)
            self._promo_ledger.clear()
            self._demo_ledger.clear()
        return {"promotions_aborted": n_promo, "demotions_aborted": n_demo}

    # -- manager feeds / observability -------------------------------------

    def cold_hot_candidates(self, k: int) -> List[Tuple[tuple, int]]:
        """Read-and-reset the cold tier's heat accumulator (promotion
        candidates, hottest first)."""
        with self._lock:
            return self._cold.drain_hot(k)

    def demotion_candidates(self, k: int) -> List[tuple]:
        """The K least-recently-used qualified resident keys (the
        demand-free end of the device LRU): demotion candidates before
        the heat veto."""
        with self._lock:
            out: List[tuple] = []
            for key in self._table.qualified:
                out.append(key)
                if len(out) >= k:
                    break
            return out

    def slot_of(self, key: tuple) -> Optional[int]:
        with self._lock:
            return self._table.qualified.get(
                key, self._table.simple.get(key)
            )

    def drain_cold_journal(self) -> List[tuple]:
        """Read-and-reset the cold write journal (the spill feed);
        rows serialize OFF the lock via ``spill_cold_rows``."""
        with self._lock:
            return self._cold.drain_dirty()

    def spill_cold_rows(self, rows) -> int:
        return self._cold.spill_rows(rows, self._clock())

    def drain_cold_decide_samples(self) -> List[float]:
        """Read-and-reset the cold-decide latencies observed since the
        last render (the ``tier_cold_decide_seconds`` histogram feed)."""
        with self._lock:
            out, self._decide_pending = self._decide_pending, []
            return out

    def tier_stats(self) -> dict:
        with self._lock:
            lat = sorted(self._cold_decide_s)
            n = len(lat)
            p50 = lat[n // 2] if n else 0.0
            p99 = lat[min(int(n * 0.99), n - 1)] if n else 0.0
            return {
                "device_resident": len(self._table.info),
                "device_capacity": self._capacity,
                "cold": self._cold.stats(),
                "cold_decide_p50_ms": round(p50 * 1000, 4),
                "cold_decide_p99_ms": round(p99 * 1000, 4),
                "promo_ledger": len(self._promo_ledger),
                "demo_ledger": len(self._demo_ledger),
            }

    # -- checkpoint / resume ---------------------------------------------

    def _snapshot_table(self) -> dict:
        table = super()._snapshot_table()
        table["cold"] = cell_rows(self._cold.cells)
        return table

    def _load_cold(self, rows: dict) -> None:
        """Seat a checkpoint's cold cells (already durable in the
        checkpoint, so not journaled; no demotion is counted)."""
        with self._lock:
            self._cold.clear()
            for key, (a, b, counter) in rows.items():
                self._cold.cells[key] = (
                    restore_cell(counter.limit, a, b), counter
                )

    def close(self) -> None:
        self._cold.close()
        super().close()
