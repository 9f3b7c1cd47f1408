"""The admission controller: what the serving plane asks before a
decision touches the storage and the card.

Port counterpart of ``limitador_tpu/admission/controller.py``. One
instance per process, built by the server when ``--admission-mode`` is
``monitor`` or ``enforce`` and bound to the batched device storage
(``AsyncTorchStorage.set_admission``). It owns:

* the :class:`~limitador_tpu_torch.admission.breaker.CircuitBreaker` over
  the device plane and the
  :class:`~limitador_tpu_torch.storage.failover.FailoverStore` the check
  path fails over to while it is open;
* the :class:`~limitador_tpu_torch.admission.overload.AdaptiveLimiter`
  and the deadline-aware shed decision (``admit``), taken BEFORE the
  request occupies a batch slot;
* the watchdog task driving stall detection, half-open probes and the
  recovery reconcile (journal -> ``apply_deltas`` on the card's table);
* every ``admission_*`` metric family and the ``/debug/stats``
  ``admission`` section (shed ring, breaker state, failover ledger).

The probe is one empty device batch, ``check_many([_Request([], 0,
False)])``: it pads to one bucket and launches the storage's check kernel
(B1 on a ``TorchStorage``, B6a on a replicated node, B7a on the sharded
table), then waits for and downloads the answer, so it exercises launch,
sync and download without touching a counter. It runs on a fresh
one-thread executor (``admission-probe``) per attempt: a probe wedged on
a still-dead card blocks its own thread forever, never the serving loop.
After the breaker closes, deltas journaled while the reconcile ran are
reconciled at once (``_reconcile_late``); the JAX controller leaves them
for the next recovery.

Shed semantics: ``AdmissionShed`` is a ``StorageError`` subclass, so a
handler that forgets to catch it still answers UNAVAILABLE (Envoy's
failure-mode policy decides fail-open/closed), never a spurious OK.
``--shed-response overlimit`` makes handlers answer OVER_LIMIT instead.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import deque
from typing import Optional

from ..storage.base import StorageError
from ..storage.failover import FailoverStore
from .breaker import BreakerState, CircuitBreaker
from .overload import AdaptiveLimiter
from .priority import PriorityResolver, priority_name

__all__ = ["AdmissionController", "AdmissionShed"]

log = logging.getLogger("limitador.admission")

SHED_UNAVAILABLE = "unavailable"
SHED_OVERLIMIT = "overlimit"


class AdmissionShed(StorageError):
    """A request rejected by the admission plane before batch admission.

    ``overlimit`` tells the handler to answer OVER_LIMIT (429) instead of
    UNAVAILABLE (503): the two RLS shed semantics."""

    def __init__(self, reason: str, priority: int, overlimit: bool):
        super().__init__(
            f"admission shed ({reason}, priority={priority_name(priority)})",
            transient=True,
        )
        self.reason = reason
        self.priority = priority
        self.overlimit = overlimit


class _Ticket:
    """One admitted request's in-flight slot; release exactly once.
    ``holds_slot`` is False for monitor-mode admissions that could not
    take a slot: releasing one of those must not free a slot another
    request holds."""

    __slots__ = ("_controller", "_released", "holds_slot")

    def __init__(self, controller: "AdmissionController",
                 holds_slot: bool = True):
        self._controller = controller
        self._released = False
        self.holds_slot = holds_slot

    def release(self) -> None:
        if not self._released:
            self._released = True
            if self.holds_slot:
                self._controller.overload.release()


class AdmissionController:
    def __init__(
        self,
        mode: str = "enforce",
        metrics=None,
        breaker: Optional[CircuitBreaker] = None,
        overload: Optional[AdaptiveLimiter] = None,
        priorities: Optional[PriorityResolver] = None,
        failover: Optional[FailoverStore] = None,
        shed_response: str = SHED_UNAVAILABLE,
        deadline_margin: float = 0.001,
        watchdog_tick: float = 0.25,
        clock=time.monotonic,
    ):
        if mode not in ("monitor", "enforce"):
            raise ValueError(f"admission mode {mode!r} (use off|monitor|enforce)")
        self.mode = mode
        self.enforcing = mode == "enforce"
        self.metrics = metrics
        self.breaker = breaker or CircuitBreaker()
        self.overload = overload or AdaptiveLimiter()
        self.priorities = priorities or PriorityResolver()
        self.failover = failover or FailoverStore()
        self.shed_overlimit = shed_response == SHED_OVERLIMIT
        self.deadline_margin = float(deadline_margin)
        #: priority classes STRICTLY below this level shed before any
        #: other admission check runs (reason ``controller``); a capacity
        #: controller's knob. 0 = shed nothing, the default.
        self.shed_floor = 0
        self.watchdog_tick = float(watchdog_tick)
        self._clock = clock
        self._shed_counts = {}  # (reason, priority name) -> int
        self._shed_lock = threading.Lock()
        self.recent_sheds: deque = deque(maxlen=32)
        self._storage = None        # AsyncTorchStorage, via bind_storage
        self._device = None         # its inner device table
        self._drainables: list = []  # objects with fail_over_queued()
        self._watchdog_task: Optional[asyncio.Task] = None
        self._probe_pool = None
        self._failover_seconds_reported = 0.0
        self._stopped = False
        self.breaker.listeners.append(self._on_transition)

    # -- wiring --------------------------------------------------------------

    def bind_storage(self, storage) -> None:
        """Attach the batched device storage this controller guards
        (called by ``AsyncTorchStorage.set_admission``)."""
        self._storage = storage
        self._device = getattr(storage, "inner", None)
        self.add_drainable(storage)
        recorder = getattr(storage, "recorder", None)
        if recorder is not None:
            recorder.on_queue_waits = self.observe_queue_waits

    def add_drainable(self, obj) -> None:
        """Register another queue owner (a pipeline) whose
        ``fail_over_queued(decider, exc)`` runs on breaker trips."""
        if obj not in self._drainables:
            self._drainables.append(obj)

    def start(self, loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
        """Start the watchdog (stall detection, probes, reconcile) on the
        serving loop."""
        loop = loop or asyncio.get_running_loop()
        if self._watchdog_task is None or self._watchdog_task.done():
            self._watchdog_task = loop.create_task(self._watchdog())

    async def close(self) -> None:
        self._stopped = True
        if self._watchdog_task is not None:
            self._watchdog_task.cancel()
            try:
                await self._watchdog_task
            except asyncio.CancelledError:
                pass
        if self._probe_pool is not None:
            self._probe_pool.shutdown(wait=False)

    # -- the admit decision (serving-plane hot path) -------------------------

    def admit(
        self,
        namespace,
        values: Optional[dict] = None,
        deadline: Optional[float] = None,
    ) -> _Ticket:
        """Decide whether this request may occupy a batch slot.

        ``deadline`` is the request's remaining lifetime in seconds (gRPC
        ``context.time_remaining()``); None means no deadline. Returns a
        ticket (release when the decision resolves) or raises
        :class:`AdmissionShed`. In monitor mode sheds are counted but the
        request is admitted anyway."""
        priority = self.priorities.resolve(namespace, values)
        reason = None
        if priority < self.shed_floor:
            reason = "controller"
        if reason is None and deadline is not None:
            estimate = self.overload.queue_wait_estimate()
            if deadline <= estimate + self.deadline_margin:
                reason = "deadline"
        if reason is None and not self.overload.try_acquire(priority):
            reason = "overload"
        if reason is None:
            return _Ticket(self)
        self._record_shed(reason, priority, namespace)
        if self.enforcing:
            raise AdmissionShed(reason, priority, self.shed_overlimit)
        # Monitor mode: shed counted, request admitted anyway. Deadline
        # and controller sheds never tried for a slot, so try now; the
        # ticket records whether it holds one, so release() balances.
        holds = (
            reason != "overload" and self.overload.try_acquire(priority)
        )
        return _Ticket(self, holds_slot=holds)

    def _record_shed(self, reason: str, priority: int, namespace) -> None:
        from ..observability.device_plane import current_request_id

        pname = priority_name(priority)
        with self._shed_lock:
            key = (reason, pname)
            self._shed_counts[key] = self._shed_counts.get(key, 0) + 1
            self.recent_sheds.append({
                "request_id": current_request_id(),
                "namespace": str(namespace),
                "reason": reason,
                "priority": pname,
                "enforced": self.enforcing,
            })
        m = self.metrics
        if m is not None:
            m.admission_sheds.labels(reason, pname).inc()

    # -- queue-wait feed (DeviceStatsRecorder.record_flush) ------------------

    def observe_queue_waits(self, waits) -> None:
        if waits:
            # The flush's worst wait is the congestion signal: one sample
            # per flush keeps this off the per-request path.
            self.overload.observe(max(waits))

    # -- device-plane failover ----------------------------------------------

    def use_failover(self) -> bool:
        """True when the check path must decide host-side (breaker not
        closed). Also advances the breaker state machine (stall trip,
        open -> half-open on reset expiry)."""
        return self.breaker.is_open()

    def failover_check_and_update(self, counters, delta, load_counters):
        m = self.metrics
        if m is not None:
            m.admission_failover_decisions.inc()
        return self.failover.check_and_update(counters, delta, load_counters)

    def failover_is_within_limits(self, counter, delta) -> bool:
        m = self.metrics
        if m is not None:
            m.admission_failover_decisions.inc()
        return self.failover.is_within_limits(counter, delta)

    def failover_update_counter(self, counter, delta) -> None:
        self.failover.update_counter(counter, delta)

    # -- breaker transitions -------------------------------------------------

    def _on_transition(self, state: str) -> None:
        log.warning(
            "admission breaker -> %s (%s)", state,
            self.breaker.last_error() or "recovered",
        )
        m = self.metrics
        if m is not None:
            m.admission_breaker_state.set(BreakerState.GAUGE[state])
            m.admission_breaker_transitions.labels(state).inc()
        if state == BreakerState.OPEN:
            # Fail the queues over NOW: requests already waiting on the
            # dead plane get host decisions (queued) or a transient error
            # (dispatched) instead of hanging.
            exc = StorageError(
                "device plane failed over: "
                + (self.breaker.last_error() or "tripped"),
                transient=True,
            )
            for drainable in self._drainables:
                try:
                    drainable.fail_over_queued(
                        self.failover_check_and_update, exc
                    )
                except Exception as dexc:
                    log.warning("failover drain failed: %s", dexc)

    # -- watchdog: stall detection, probes, reconcile ------------------------

    def _probe(self) -> None:
        """One empty device batch: launch, sync and download without
        touching any counter (runs on a probe thread; blocks while the
        plane is still dead)."""
        from ..device.storage import _Request

        self._device.check_many([_Request([], 0, False)])

    async def _watchdog(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopped:
            await asyncio.sleep(self.watchdog_tick)
            try:
                self.breaker.check_stall()
                self._tick_metrics()
                if self._device is None:
                    continue
                if self.breaker.try_claim_probe():
                    await self._run_probe(loop)
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # the watchdog must never die
                log.warning("admission watchdog error: %s", exc)

    async def _run_probe(self, loop) -> None:
        from concurrent.futures import ThreadPoolExecutor

        # A FRESH single-use executor per probe: a probe wedged on a
        # still-dead plane blocks its thread forever, and a shared pool
        # would wedge solid after two such probes. The leak is bounded by
        # one thread per reset dwell.
        pool = ThreadPoolExecutor(1, thread_name_prefix="admission-probe")
        self._probe_pool = pool
        try:
            try:
                await asyncio.wait_for(
                    loop.run_in_executor(pool, self._probe),
                    timeout=self.breaker.stall_timeout,
                )
            except Exception as exc:
                self.breaker.record_failure(
                    exc if isinstance(exc, (StorageError, OSError))
                    else TimeoutError(f"device probe failed: {exc!r}")
                )
                return
            # Probe succeeded: reconcile the failover journal into the
            # card's table BEFORE closing; traffic keeps deciding
            # host-side until the device totals are caught up.
            try:
                applied = await loop.run_in_executor(
                    pool, self.failover.reconcile_into, self._device,
                )
            except Exception as exc:
                self.breaker.record_failure(
                    exc if isinstance(exc, (StorageError, OSError))
                    else StorageError(
                        f"reconcile failed: {exc!r}", transient=True
                    )
                )
                return
            if applied and self.metrics is not None:
                self.metrics.admission_reconciled_deltas.inc(applied)
            log.warning(
                "admission breaker recovery: reconciled %d counter "
                "deltas into the device table", applied,
            )
            self.breaker.probe_succeeded()
            if self.failover.journal_size():
                # Host decisions taken while the reconcile ran (a launch
                # failed over at the trip whose rows reach the exact path
                # only now the card answers again) journaled after its
                # drain. The breaker is closed, so no decision on this
                # loop journals any more: replay them now instead of at
                # the next recovery (the JAX controller leaves them
                # there).
                await self._reconcile_late(loop, pool)
        finally:
            pool.shutdown(wait=False)

    async def _reconcile_late(self, loop, pool) -> None:
        try:
            late = await loop.run_in_executor(
                pool, self.failover.reconcile_into, self._device,
            )
        except Exception as exc:
            # kept in the journal for the next recovery
            self.breaker.record_failure(
                exc if isinstance(exc, (StorageError, OSError))
                else StorageError(f"reconcile failed: {exc!r}",
                                  transient=True)
            )
            return
        if late and self.metrics is not None:
            self.metrics.admission_reconciled_deltas.inc(late)
        log.warning("admission breaker recovery: reconciled %d late "
                    "counter deltas", late)

    def _tick_metrics(self) -> None:
        m = self.metrics
        if m is None:
            return
        m.admission_inflight.set(self.overload.inflight)
        m.admission_limit.set(self.overload.limit)
        m.admission_breaker_state.set(BreakerState.GAUGE[self.breaker.state])
        total = self.breaker.open_seconds_total()
        if total > self._failover_seconds_reported:
            m.admission_failover_seconds.inc(
                total - self._failover_seconds_reported
            )
            self._failover_seconds_reported = total

    # -- /debug/stats --------------------------------------------------------

    def admission_debug(self) -> dict:
        with self._shed_lock:
            shed_counts = {
                f"{reason}:{pname}": count
                for (reason, pname), count in sorted(self._shed_counts.items())
            }
            recent = list(self.recent_sheds)
        return {
            "mode": self.mode,
            "breaker": {
                "state": self.breaker.state,
                "last_error": self.breaker.last_error(),
                "open_seconds_total": round(
                    self.breaker.open_seconds_total(), 3
                ),
            },
            "overload": {
                "inflight": self.overload.inflight,
                "limit": self.overload.limit,
                "queue_wait_estimate_ms": round(
                    self.overload.queue_wait_estimate() * 1e3, 3
                ),
            },
            "sheds": shed_counts,
            "recent_sheds": recent,
            "failover": {
                "decisions": self.failover.decisions,
                "journal_size": self.failover.journal_size(),
                "reconciled_deltas": self.failover.reconciled_deltas,
            },
        }
