"""Host-plane failover store: the exact stand-in behind the breaker.

Port counterpart of ``limitador_tpu/storage/failover.py``. While the
admission plane's device breaker is OPEN, the check path decides against
this store instead of the card's table. It is an exact ``InMemoryStorage``
oracle (the parity reference every backend is tested against) plus a
delta journal. On recovery, ``reconcile_into`` replays the journaled
deltas through the ``apply_deltas`` contract the write-behind topology
already uses (one B2 host-form launch on a ``TorchStorage``, B6b on a
replicated node, B7c on the sharded table), so no delta is lost across a
failover window. The answers of a failover window come from this oracle
and from nothing else: never from the plain PyTorch versions of the
kernels.

Accuracy contract (the reference's partitioned write-behind behaviour,
counters_cache.rs): the oracle starts EMPTY at trip time, because the
card's live counts are unreadable precisely when the plane is dead, so
each window's budget is enforced against failover-local counts only.
Across one trip boundary a window may admit up to one extra budget; it
never under-admits, and the journal keeps the card table's totals exact
once reconciled.

The pod's degraded-owner failover (``server/peering.py``) keeps one store
an owner and replays its journal into the owner over the peer lane. The
elastic pod's abort (``server/resize.py``) redistributes the journals of
members a revert removed, out of band: ``reset_oracle`` forgets the window
state after a redistribution landed, and ``rejournal`` puts back what did
not land.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

from ..core.counter import Counter
from .base import Authorization
from .in_memory import InMemoryStorage

__all__ = ["FailoverStore"]


class FailoverStore:
    def __init__(self, cache_size: int = 100_000, clock=time.time):
        self._oracle = InMemoryStorage(cache_size, clock=clock)
        self._lock = threading.Lock()
        # counter identity -> accumulated delta while failed over
        self._journal: Dict[Counter, int] = {}
        self.decisions = 0          # checks served host-side (cumulative)
        self.reconciled_deltas = 0  # deltas replayed to device (cumulative)
        #: cumulative count of drained deltas whose apply the sink
        #: acknowledged: a chunked reconcile that fails partway restores
        #: only the unacknowledged tail, so a re-driven reconcile never
        #: applies the acknowledged prefix twice
        self.drained_high_water = 0

    # -- the failed-over check path ------------------------------------------

    def check_and_update(
        self, counters: List[Counter], delta: int, load_counters: bool
    ) -> Authorization:
        auth = self._oracle.check_and_update(counters, delta, load_counters)
        with self._lock:
            self.decisions += 1
            if not auth.limited and delta:
                for counter in counters:
                    key = counter.key()
                    self._journal[key] = self._journal.get(key, 0) + int(delta)
        return auth

    def is_within_limits(self, counter: Counter, delta: int) -> bool:
        with self._lock:
            self.decisions += 1
        return self._oracle.is_within_limits(counter, delta)

    def update_counter(self, counter: Counter, delta: int) -> None:
        self._oracle.update_counter(counter, delta)
        if delta:
            with self._lock:
                key = counter.key()
                self._journal[key] = self._journal.get(key, 0) + int(delta)

    # -- recovery ------------------------------------------------------------

    def journal_size(self) -> int:
        with self._lock:
            return len(self._journal)

    def drain(self) -> List[Tuple[Counter, int]]:
        """Take (and clear) the journaled deltas. Decisions taken after
        the drain land in a fresh journal (the breaker may re-open)."""
        with self._lock:
            items = list(self._journal.items())
            self._journal.clear()
        return items

    def reset_oracle(self) -> None:
        """Forget the stand-in's window state without a reconcile: the
        journal was redistributed out of band (the elastic pod's abort),
        and keeping the oracle would count twice in the next degraded
        window of the same keys."""
        self._oracle.clear()

    def rejournal(self, items: List[Tuple[Counter, int]]) -> None:
        """Put drained deltas that did not land back (merged with what
        was journaled since): a delta is only gone once some owner
        acknowledged it, as ``reconcile_into`` restores its
        unacknowledged tail."""
        with self._lock:
            for counter, delta in items:
                self._journal[counter] = (
                    self._journal.get(counter, 0) + int(delta)
                )

    def reconcile_into(self, storage) -> int:
        """Replay the journal into ``storage`` (the card's table) through
        its ``apply_deltas``; returns the number of counter deltas
        applied. On failure only the UNACKNOWLEDGED tail of the journal is
        restored: a sink that applies in acknowledged chunks
        (``apply_deltas_acked(items, ack)``) reports its applied prefix,
        and a re-driven reconcile must not apply it twice. An
        all-or-nothing sink (a plain ``apply_deltas``, the card's table)
        applied nothing when it raises, so everything is restored."""
        items = self.drain()
        if not items:
            self._oracle.clear()
            return 0
        acked = 0

        def ack(n: int) -> None:
            # chunked sinks call this after each acknowledged chunk; ``n``
            # is the applied item-count prefix so far
            nonlocal acked
            acked = max(acked, min(int(n), len(items)))

        try:
            apply_acked = getattr(storage, "apply_deltas_acked", None)
            if apply_acked is not None:
                apply_acked(items, ack)
            else:
                storage.apply_deltas(items)
            acked = len(items)
        except BaseException:
            with self._lock:
                for counter, delta in items[acked:]:
                    self._journal[counter] = (
                        self._journal.get(counter, 0) + delta
                    )
                self.drained_high_water += acked
                self.reconciled_deltas += acked
            raise
        with self._lock:
            self.reconciled_deltas += len(items)
            self.drained_high_water += len(items)
        # The oracle's window state is now folded into the card's table;
        # keeping it would double-count on the next failover window.
        self._oracle.clear()
        return len(items)
