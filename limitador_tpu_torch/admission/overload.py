"""Adaptive overload control: AIMD concurrency limit + queue-wait
estimate.

Port counterpart of ``limitador_tpu/admission/overload.py``. The decision
path's latency lives in the batcher queue (``batcher_queue_wait``), not
the kernel: when the card slows down, admitted requests pile into the
queue and every deadline blows at once. This module closes the loop the
way TCP does:

* once per check flush the device-plane recorder reports the flush's
  worst queue wait; an EWMA of those samples is the **queue-wait
  estimate**, both the congestion signal and the basis for
  deadline-aware shedding;
* once per adjustment interval: estimate above target -> multiplicative
  decrease of the concurrency limit; at or below target -> additive
  increase;
* admission takes a slot only while ``inflight`` is under the
  class-shaped limit: lower priority classes saturate earlier
  (``PRIORITY_SHARES``), so overload sheds low-priority traffic first
  while critical traffic rides until the hard cap.

Thread-safe; every hot-path operation is a few arithmetic operations
under one lock.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

__all__ = ["PRIORITY_SHARES", "AdaptiveLimiter"]

#: Fraction of the current adaptive limit each priority class may fill
#: before ITS admissions shed (index = priority level). Critical rides
#: to the full limit; low sheds at half of it.
PRIORITY_SHARES = (0.5, 0.75, 0.9, 1.0)


class AdaptiveLimiter:
    def __init__(
        self,
        max_inflight: int = 4096,
        min_limit: int = 8,
        target_queue_wait: float = 0.02,
        ewma_alpha: float = 0.2,
        backoff: float = 0.75,
        adjust_interval: float = 0.1,
        clock=None,
    ):
        self.max_inflight = max(int(max_inflight), 1)
        #: the configured hard cap; ``set_ceiling`` may only tighten
        #: below this, never raise
        self.hard_max = self.max_inflight
        self.min_limit = max(min(int(min_limit), self.max_inflight), 1)
        self.target_queue_wait = float(target_queue_wait)
        self.ewma_alpha = float(ewma_alpha)
        self.backoff = float(backoff)
        self.adjust_interval = float(adjust_interval)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._limit = float(self.max_inflight)
        self._inflight = 0
        self._ewma: Optional[float] = None
        self._last_adjust = self._clock()

    # -- observability -------------------------------------------------------

    @property
    def limit(self) -> int:
        return int(self._limit)

    @property
    def inflight(self) -> int:
        return self._inflight

    def set_ceiling(self, ceiling: int) -> int:
        """Clamp the AIMD envelope's top to ``ceiling`` (a capacity
        controller's admission knob), bounded to ``[min_limit,
        hard_max]``: it can tighten below the configured
        ``--max-inflight`` and relax back up to it, never above. A limit
        already above the new top snaps down. Returns the applied
        ceiling."""
        with self._lock:
            c = max(min(int(ceiling), self.hard_max), self.min_limit)
            self.max_inflight = c
            self._limit = min(self._limit, float(c))
            return c

    def queue_wait_estimate(self) -> float:
        """Current queue-wait estimate in seconds (0.0 before the first
        sample: a cold start must not doom every deadline)."""
        with self._lock:
            return self._ewma or 0.0

    # -- admission -----------------------------------------------------------

    def try_acquire(self, priority: int = 1) -> bool:
        """Take one in-flight slot, or refuse (the caller sheds). The
        effective cap is the adaptive limit scaled by the class share,
        never below ``min_limit`` (a fully backed-off limiter still
        serves a trickle of every class rather than starving one)."""
        share = PRIORITY_SHARES[
            max(0, min(int(priority), len(PRIORITY_SHARES) - 1))
        ]
        with self._lock:
            cap = max(self._limit * share, float(self.min_limit))
            if self._inflight >= cap:
                return False
            self._inflight += 1
            return True

    def release(self, queue_wait: Optional[float] = None) -> None:
        """Return a slot; ``queue_wait`` is the decided request's
        observed batcher queue wait in seconds (feeds the EWMA and the
        AIMD adjustment)."""
        with self._lock:
            if self._inflight > 0:
                self._inflight -= 1
            if queue_wait is not None:
                self.observe_locked(queue_wait)

    def observe(self, queue_wait: float) -> None:
        with self._lock:
            self.observe_locked(queue_wait)

    def observe_locked(self, queue_wait: float) -> None:
        queue_wait = max(float(queue_wait), 0.0)
        if self._ewma is None:
            self._ewma = queue_wait
        else:
            a = self.ewma_alpha
            self._ewma = a * queue_wait + (1.0 - a) * self._ewma
        now = self._clock()
        if now - self._last_adjust < self.adjust_interval:
            return
        self._last_adjust = now
        if self._ewma > self.target_queue_wait:
            self._limit = max(
                self._limit * self.backoff, float(self.min_limit)
            )
        else:
            self._limit = min(
                self._limit + 1.0, float(self.max_inflight)
            )
