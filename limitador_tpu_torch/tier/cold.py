"""The exact host cold tier: unbounded resident set + write journal.

Port counterpart of ``limitador_tpu/tier/cold.py``, host code only: the
same cells (the in-memory oracle's ExpiringValue/GcraValue), the same
journal and the same spill rows, one JSON object per line, byte for byte
what the JAX package writes.

Every cell is exact and every write is journaled, but residency is
permanent until the TierManager promotes a key back to the device.

Synchronization: ColdStore has NO lock of its own. Every mutation runs
under the owning TieredStorage's storage lock, exactly like the
big-limit host map it sits beside (``_BigLimitMixin`` docstring: "every
method assumes the caller holds the storage lock"). The one exception
is the append-log spill: ``spill_rows`` writes to disk and is called by
the TierManager OFF the storage lock, from rows drained under it — the
journal drain is the lock-to-disk handoff.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

__all__ = ["ColdStore"]


class ColdStore:
    """Host-resident exact counters for cold keys.

    ``cells`` maps counter identity -> (cell, Counter), the same shape
    as the big-limit map. ``dirty`` is the write journal: keys whose
    cell changed since the last drain (the
    journal records that an exact decision was taken against host
    state, so durability is a drain away, never a correctness fact).
    ``hits`` is the heat accumulator the TierManager drains for
    promotion candidates — the host-side mirror of the device table's
    per-slot ``hits`` column.
    """

    def __init__(self, spill_path: Optional[str] = None):
        self.cells: Dict[tuple, Tuple[object, object]] = {}
        self.dirty: set = set()
        self.hits: Dict[tuple, int] = {}
        # cumulative accounting (tier_* families / /debug/tiering)
        self.decisions = 0       # hits decided against a cold cell
        self.demotions = 0       # cells seated by demotion
        self.promotions = 0      # cells released by promotion
        self.spilled = 0         # journal rows appended to the log
        self._spill_path = spill_path
        self._spill = None

    # -- residency (caller holds the storage lock) -------------------------

    def __contains__(self, key: tuple) -> bool:
        return key in self.cells

    def get(self, key: tuple):
        return self.cells.get(key)

    def seat(self, key: tuple, cell, counter) -> None:
        """Seat a demoted counter's exact cell. The arriving state is a
        write (it must survive a drain), so the key lands dirty."""
        self.cells[key] = (cell, counter)
        self.dirty.add(key)
        self.demotions += 1

    def release(self, key: tuple) -> None:
        """Drop a key promoted back to the device (its state moved; the
        journal entry — if any — still spills the last cold value,
        which the promoted cell supersedes)."""
        if self.cells.pop(key, None) is not None:
            self.promotions += 1
        self.hits.pop(key, None)

    def drop(self, key: tuple) -> None:
        """Delete without promotion accounting (delete_counters/clear)."""
        self.cells.pop(key, None)
        self.hits.pop(key, None)
        self.dirty.discard(key)

    # -- decision-path accounting (caller holds the storage lock) ----------

    def touch(self, key: tuple) -> None:
        self.decisions += 1
        self.hits[key] = self.hits.get(key, 0) + 1

    def record_write(self, key: tuple) -> None:
        self.dirty.add(key)

    # -- heat / journal drains (caller holds the storage lock) -------------

    def drain_hot(self, k: int) -> List[Tuple[tuple, int]]:
        """Read-and-reset the heat accumulator: the K hottest cold keys
        since the last drain, hottest first — the promotion candidate
        feed, mirroring the device table's ``drain_top_hits``."""
        if not self.hits or k <= 0:
            return []
        items = sorted(self.hits.items(), key=lambda kv: -kv[1])[:k]
        self.hits.clear()
        return items

    def drain_dirty(self) -> List[Tuple[tuple, object, object]]:
        """Read-and-reset the write journal: (key, cell, counter) for
        every cell written since the last drain. Snapshots the scalar
        cell state is NOT taken here — the spill serializer reads the
        live cell, and a racing write between drain and spill only
        makes the journal row fresher (absolute values, last wins)."""
        if not self.dirty:
            return []
        out = []
        for key in self.dirty:
            entry = self.cells.get(key)
            if entry is not None:
                out.append((key, entry[0], entry[1]))
        self.dirty.clear()
        return out

    # -- append-log spill (manager thread, OFF the storage lock) -----------

    def spill_rows(self, rows, now: float) -> int:
        """Append drained journal rows to the disk log, one JSON object
        per line carrying the counter's registry identity and the
        cell's absolute state — (value, expiry) for fixed windows,
        (tat_ticks, scale) for buckets, the same two-scalar form the
        snapshot format persists (``restore_cell`` rebuilds from it
        given the limits registry). Absolute state means replay is
        last-row-wins: retries and overlapping drains are idempotent."""
        if not self._spill_path or not rows:
            return 0
        if self._spill is None:
            self._spill = open(self._spill_path, "a", encoding="utf-8")
        n = 0
        for _key, cell, counter in rows:
            if getattr(cell, "POLICY", None) == "token_bucket":
                a, b = int(cell.tat), int(cell.scale)
            else:
                a, b = int(cell.value_raw), float(cell.expiry)
            self._spill.write(json.dumps({
                "ns": counter.namespace,
                "limit": counter.limit.name,
                "vars": dict(counter.set_variables),
                "a": a,
                "b": b,
                "ts": round(float(now), 3),
            }) + "\n")
            n += 1
        self._spill.flush()
        self.spilled += n
        return n

    # -- lifecycle ---------------------------------------------------------

    def clear(self) -> None:
        self.cells.clear()
        self.hits.clear()
        self.dirty.clear()

    def close(self) -> None:
        spill, self._spill = self._spill, None
        if spill is not None:
            spill.close()

    def stats(self) -> dict:
        return {
            "resident": len(self.cells),
            "dirty": len(self.dirty),
            "decisions": self.decisions,
            "demotions": self.demotions,
            "promotions": self.promotions,
            "spilled": self.spilled,
            "spill_path": self._spill_path,
        }
