"""Per-actor CRDT counter (G-counter with window expiry).

Port counterpart of
``limitador_tpu/storage/distributed/cr_counter_value.py``, copied with
its imports kept package-relative.

Mirrors upstream limitador/src/storage/distributed/cr_counter_value.rs:
each replica ("actor") owns its count; the value reads as the sum of all
live per-actor counts (read-as-sum, :38-46); merging takes the per-actor
max (:77-113) so replays are idempotent and concurrent merges commute; an
expired window resets everything.

Python port notes: callers serialize access (the storage lock), so plain
ints replace the atomics; time is float seconds since epoch.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["CrCounterValue", "CrTatValue"]


class CrCounterValue:
    __slots__ = ("ourselves", "own", "others", "expiry")

    def __init__(self, actor: str, window_seconds: float, now: float):
        self.ourselves = actor
        self.own = 0
        self.others: Dict[str, int] = {}
        self.expiry = now + window_seconds

    def expired_at(self, now: float) -> bool:
        return now >= self.expiry

    def read_at(self, now: float) -> int:
        if self.expired_at(now):
            return 0
        return self.own + sum(self.others.values())

    def ttl(self, now: float) -> float:
        return max(self.expiry - now, 0.0)

    def inc_at(self, increment: int, window_seconds: float, now: float) -> None:
        if self.expired_at(now):
            self.own = increment
            self.others.clear()
            self.expiry = now + window_seconds
        else:
            self.own += increment

    def inc_actor_at(
        self, actor: str, increment: int, window_seconds: float, now: float
    ) -> None:
        if actor == self.ourselves:
            self.inc_at(increment, window_seconds, now)
        elif self.expired_at(now):
            self.own = 0
            self.others = {actor: increment}
            self.expiry = now + window_seconds
        else:
            self.others[actor] = self.others.get(actor, 0) + increment

    def merge_at(
        self, values: Dict[str, int], expiry: float, now: float
    ) -> None:
        """Merge a remote snapshot: per-actor max, earliest future expiry;
        an expired local window adopts the remote one wholesale
        (cr_counter_value.rs:84-113)."""
        if expiry <= now:
            return
        if self.expired_at(now):
            self.own = 0
            self.others.clear()
            self.expiry = expiry
        else:
            self.expiry = min(
                e for e in (self.expiry, expiry) if e > now
            )
        for actor, other_value in values.items():
            if actor == self.ourselves:
                if other_value > self.own:
                    self.own = other_value
            else:
                local = self.others.get(actor, 0)
                if other_value > local:
                    self.others[actor] = other_value

    def snapshot(self) -> Tuple[Dict[str, int], float]:
        """All per-actor values (incl. our own) + expiry, for replication."""
        values = dict(self.others)
        values[self.ourselves] = self.own
        return values, self.expiry

    def __repr__(self) -> str:
        return (
            f"CrCounterValue(actor={self.ourselves!r}, own={self.own}, "
            f"others={self.others!r}, expiry={self.expiry})"
        )


class CrTatValue:
    """Shared-TAT token-bucket CRDT (an extension; the reference is
    fixed-window only). The whole state is ONE integer — the GCRA TAT in
    the limit's ticks: local admission advances it
    (``max(TAT, now) + d*I``) and merge takes the max over every actor's
    TAT — monotone, idempotent, commutative, the same join-semilattice
    shape as the window merge above (and as device/replicated.py's device
    lane). Speaks the CrCounterValue surface so the storage stays
    cell-agnostic; on the wire the count lane carries ``tat_ticks`` and
    expires_at carries the TAT in abs ms (the liveness lane — a TAT in
    the past is a full bucket, i.e. no live state)."""

    __slots__ = ("ourselves", "cell")

    def __init__(self, actor: str, limit, tat_ticks: int = 0):
        from ..gcra import GcraValue

        self.ourselves = actor
        self.cell = GcraValue(limit.max_value, limit.seconds)
        self.cell.tat = int(tat_ticks)

    def expired_at(self, now: float) -> bool:
        return self.cell.is_expired(now)

    def read_at(self, now: float) -> int:
        return self.cell.value_at(now)

    def ttl(self, now: float) -> float:
        return self.cell.ttl(now)

    def inc_at(self, increment: int, window_seconds: float, now: float) -> None:
        self.cell.update(increment, window_seconds, now)

    def merge_at(
        self, values: Dict[str, int], expiry: float, now: float
    ) -> None:
        """Join: the shared TAT is the max over actors (the per-actor
        attribution of the window CRDT is unnecessary — max of per-actor
        maxes == global max, and it is what admission consults)."""
        tat = max(values.values(), default=0)
        if tat > self.cell.tat:
            self.cell.tat = int(tat)

    def snapshot(self) -> Tuple[Dict[str, int], float]:
        return (
            {self.ourselves: int(self.cell.tat)},
            self.cell.tat / (1000.0 * self.cell.scale),
        )

    def __repr__(self) -> str:
        return (
            f"CrTatValue(actor={self.ourselves!r}, tat={self.cell.tat}, "
            f"scale={self.cell.scale})"
        )
