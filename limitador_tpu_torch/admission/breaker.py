"""Device-plane health monitor + circuit breaker.

Port counterpart of ``limitador_tpu/admission/breaker.py``. A
three-state breaker over the card, fed by the batchers' per-batch
outcomes (error classification) and an in-flight stall watch (a wedged
device sync is how a dead plane shows):

* **closed**: healthy; device batches flow.
* **open**: tripped (consecutive failures, or an in-flight batch older
  than ``stall_timeout``); the check path must not touch the card (the
  controller fails it over to the host oracle).
* **half_open**: ``reset_timeout`` elapsed since the trip; exactly one
  probe may try the card. Success closes the breaker (after the
  controller reconciles), failure re-opens it.

Transient errors (``StorageError(transient=True)``) count toward the
failure threshold, and so do ``OSError``, ``TimeoutError`` and
``RuntimeError``: a CUDA fault surfaces from the port's kernel wrappers
and from torch as ``RuntimeError`` (``torch.AcceleratorError`` is a
subclass). Other errors (a ``ValueError`` from a bad delta) do NOT count:
a caller bug must never fail the whole plane over.

Thread-safe: batch outcomes arrive on collect/dispatch threads while
admission checks run on the event loop.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

from ..storage.base import StorageError

__all__ = ["BreakerState", "CircuitBreaker"]


class BreakerState:
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    #: gauge encoding for admission_breaker_state
    GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 3,
        stall_timeout: float = 2.0,
        reset_timeout: float = 5.0,
        warmup_stall_timeout: float = 30.0,
        clock=None,
    ):
        self.failure_threshold = max(int(failure_threshold), 1)
        self.stall_timeout = float(stall_timeout)
        self.reset_timeout = float(reset_timeout)
        # Until the FIRST batch completes, the plane is warming: a first
        # batch may carry the kernels' first load, which can exceed the
        # steady-state stall timeout. The stall watch uses this larger
        # bound until warmed, so a cold start is not misread as a dead
        # plane while a card dead AT boot still trips eventually.
        self.warmup_stall_timeout = max(
            float(warmup_stall_timeout), self.stall_timeout
        )
        self._warmed = False
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._state = BreakerState.CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._open_seconds_total = 0.0
        self._last_error: Optional[str] = None
        self._probe_claimed = False
        # in-flight device batches: token -> start time (stall watch)
        self._inflight: Dict[int, float] = {}
        self._tokens = itertools.count(1)
        #: called OUTSIDE the lock on every transition: fn(new_state)
        self.listeners: List[Callable[[str], None]] = []

    # -- state ---------------------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    def is_open(self) -> bool:
        """True when the check path must not touch the card (open, or
        half-open). Also advances open -> half_open on reset expiry and
        trips on a detected stall, so a steady request stream drives the
        state machine without a dedicated timer."""
        with self._lock:
            tripped = self._check_stall_locked()
            reset = self._maybe_half_open_locked()
            result = self._state != BreakerState.CLOSED
        self._notify(tripped)
        self._notify(reset)
        return result

    def open_seconds_total(self) -> float:
        with self._lock:
            total = self._open_seconds_total
            if self._opened_at is not None:
                total += self._clock() - self._opened_at
            return total

    def last_error(self) -> Optional[str]:
        return self._last_error

    # -- batch outcome feed (batcher/pipeline threads) -----------------------

    def batch_started(self) -> int:
        """Register an in-flight device batch for the stall watch;
        returns the token for ``batch_finished``."""
        token = next(self._tokens)
        with self._lock:
            self._inflight[token] = self._clock()
        return token

    def batch_finished(self, token: int, exc: Optional[BaseException] = None) -> None:
        with self._lock:
            self._inflight.pop(token, None)
        if exc is None:
            self.record_success()
        else:
            self.record_failure(exc)

    def record_success(self) -> None:
        """A device batch completed. Does NOT close a half-open breaker:
        only ``probe_succeeded`` does, after the controller has
        reconciled the failover journal (a pre-trip batch completing late
        must not skip the reconcile)."""
        with self._lock:
            self._consecutive_failures = 0
            self._warmed = True

    def probe_succeeded(self) -> None:
        """The half-open probe (and the reconcile that follows it)
        succeeded: close."""
        transitioned = None
        with self._lock:
            self._consecutive_failures = 0
            self._warmed = True
            if self._state != BreakerState.CLOSED:
                transitioned = self._transition_locked(BreakerState.CLOSED)
        self._notify(transitioned)

    def record_failure(self, exc: BaseException) -> None:
        """Count an error toward the trip threshold. Only device/storage
        failures count: StorageError, OS/timeout errors and RuntimeError
        (CUDA faults); caller bugs (ValueError on a bad delta, ...) must
        not open the plane."""
        if not isinstance(
            exc, (StorageError, OSError, TimeoutError, RuntimeError)
        ):
            return
        transitioned = None
        with self._lock:
            self._last_error = f"{type(exc).__name__}: {exc}"
            self._consecutive_failures += 1
            if self._state == BreakerState.HALF_OPEN:
                transitioned = self._transition_locked(BreakerState.OPEN)
            elif (
                self._state == BreakerState.CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                transitioned = self._transition_locked(BreakerState.OPEN)
        self._notify(transitioned)

    def trip(self, reason: str) -> bool:
        """Force-open (stall watchdog, operator action). Returns True
        when this call performed the transition."""
        with self._lock:
            if self._state == BreakerState.OPEN:
                return False
            self._last_error = reason
            transitioned = self._transition_locked(BreakerState.OPEN)
        self._notify(transitioned)
        return transitioned is not None

    # -- probe protocol (controller watchdog) --------------------------------

    def check_stall(self) -> bool:
        """Trip when any in-flight device batch is older than the stall
        bound. Returns True when open (whether or not this call tripped
        it)."""
        with self._lock:
            transitioned = self._check_stall_locked()
            is_open = self._state == BreakerState.OPEN
        self._notify(transitioned)
        return is_open

    def try_claim_probe(self) -> bool:
        """Half-open: claim the single probe slot. The claimant MUST
        report through ``probe_succeeded``/``record_failure``."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state != BreakerState.HALF_OPEN or self._probe_claimed:
                return False
            self._probe_claimed = True
            return True

    # -- internals -----------------------------------------------------------

    def _check_stall_locked(self):
        if self._state != BreakerState.CLOSED or not self._inflight:
            return None
        timeout = (
            self.stall_timeout if self._warmed
            else self.warmup_stall_timeout
        )
        oldest = min(self._inflight.values())
        if self._clock() - oldest > timeout:
            self._last_error = f"device batch stalled > {timeout:.3f}s"
            return self._transition_locked(BreakerState.OPEN)
        return None

    def _maybe_half_open_locked(self):
        if (
            self._state == BreakerState.OPEN
            and self._opened_at is not None
            and self._clock() - self._opened_at >= self.reset_timeout
        ):
            return self._transition_locked(BreakerState.HALF_OPEN)
        return None

    def _transition_locked(self, new_state: str) -> Optional[str]:
        if new_state == self._state:
            return None
        now = self._clock()
        if new_state == BreakerState.OPEN:
            # Accrue any running open/half-open time, then RE-STAMP: a
            # failed half-open probe re-arms the full reset dwell.
            if self._opened_at is not None:
                self._open_seconds_total += now - self._opened_at
            self._opened_at = now
            # Everything in flight at trip time is failed over by the
            # controller; dropping the tokens keeps a batch wedged forever
            # on the dead plane from re-tripping the stall watch after a
            # later recovery.
            self._inflight.clear()
        if new_state == BreakerState.CLOSED and self._opened_at is not None:
            # open + half_open time both count as failed-over seconds.
            self._open_seconds_total += now - self._opened_at
            self._opened_at = None
        if new_state == BreakerState.HALF_OPEN:
            self._probe_claimed = False
        self._state = new_state
        self._consecutive_failures = 0
        return new_state

    def _notify(self, new_state: Optional[str]) -> None:
        if new_state is None:
            return
        for listener in self.listeners:
            try:
                listener(new_state)
            except Exception:
                pass  # telemetry must never break the state machine
