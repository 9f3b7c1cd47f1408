"""Async micro-batcher: many concurrent checks -> one kernel launch.

Counterpart of ``limitador_tpu/tpu/batcher.py`` (``MicroBatcher``,
``UpdateBatcher``, ``AsyncTpuStorage`` -> ``AsyncTorchStorage``). The
serving plane awaits ``AsyncTorchStorage`` methods; concurrent
``check_and_update`` calls coalesce into one device batch. The batcher
flushes when the batch is full or the oldest request has waited
``max_delay``; the flush IS the decision, so admission stays exact.

- Off-loop dispatch: every device interaction runs on executor threads;
  the asyncio loop only builds batches and resolves futures.
- Double buffering: through the storage's ``begin_check_many`` /
  ``finish_check_many`` split, batch N+1 is launched while batch N's
  results are still coming back; up to ``max_inflight`` overlap.

``UpdateBatcher`` coalesces the unconditional Report/update path: deltas
sum per counter, and each flush is one ``apply_deltas`` call (one B2,
on a replicated node B6b, on the sharded table B7c launch). Within a
batch, requests keep their enqueue order and the kernel decides them
exactly as if serially; the hit-building and decoding live in the
storage's ``check_many``. The storage is a ``TorchStorage`` (or one of
its subclasses) or a ``TorchShardedStorage``: the batchers call only
``begin_check_many``, ``finish_check_many``, ``check_many`` and
``apply_deltas``.

Chunked dispatch (``ChunkPlanner``, shared with the compiled and native
pipelines): a flush is cut into chunks that ride the in-flight window, so
chunk i+1's staging and upload overlap chunk i's device time and a
request waits for its chunk's round trip, not the whole flush's. Chunks
of one flush launch in order on the one dispatch thread and never split a
request, so the decisions are those of the monolithic flush.
``dispatch_chunk``: None (auto, sized from the observed device time per
hit against the 2 ms budget), 0 (monolithic) or a fixed hit count.

Metrics (``AsyncTorchStorage.set_metrics``): each decided request
observes its batch's round trip (begin to finish, queue wait excluded)
into ``datastore_device_latency`` (``datastore_latency`` is the
MetricsLayer's); ``library_stats`` feeds the library gauges
(``batcher_size``, ``cache_size``, ``batcher_flush_size``, the queue
depth and, on the sharded table, ``sharded_launches`` and the route
memo) and ``device_stats`` the per-shard table families. ``set_metrics``
also attaches one ``DeviceStatsRecorder`` to every loop's batcher pair:
flush reasons, queue waits, fill ratios, chunk plans, the per-batch
phases (``dispatch``, ``host_stage``, ``device_sync``, ``unpack``) and
the flight recorder, with a ``device_batch_span`` around each batch. A
batcher without a recorder touches no observability object.

Admission (``AsyncTorchStorage.set_admission``, ``admission/``): every
batcher pair gets the controller. Each launch, every chunk of a chunked
flush included, takes a breaker token before its begin and returns it
when its answers are in (or with the error that failed it), so that the
breaker's stall watch sees a wedged device sync. While the breaker is
not closed, ``check_and_update``, ``is_within_limits`` and
``update_counter`` decide on the controller's exact host oracle and
never reach a batcher. At a trip, ``fail_over_queued`` decides every
queued request on the oracle and fails every dispatched but unfinished
launch, and every chunk still waiting for the in-flight window, with a
transient error (their kernel may already have run, so deciding them
again on the host would count them twice). A batcher without a
controller takes no token.
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from ..core.counter import Counter
from ..core.limit import Limit
from ..observability.device_plane import (
    DeviceStatsRecorder,
    current_request_id,
)
from ..observability.tracing import device_batch_span
from ..storage.base import (
    AsyncCounterStorage,
    Authorization,
    StorageError,
    require_nonnegative_delta,
)
from .storage import TorchStorage, _Request, _bucket

__all__ = [
    "ChunkPlanner",
    "chunk_queue_wait",
    "MicroBatcher",
    "UpdateBatcher",
    "AsyncTorchStorage",
]


class ChunkPlanner:
    """Sizes pipelined sub-batches for one dispatch lane.

    ``dispatch_chunk``: ``None`` = auto, ``0`` = monolithic (never
    split), ``> 0`` = fixed hits per chunk. Auto mode sizes chunks so ONE
    sub-batch's device time tracks ``target_s`` (default 2 ms, the p99
    budget), from an EWMA of observed device seconds per hit. Once the
    queue wait alone has eaten the budget, the device slice tightens to
    half the budget so decisions start flowing sooner. The EWMA update
    races across collect threads benignly (floats, last write wins)."""

    MIN_CHUNK = 512
    MAX_SPLITS = 16

    def __init__(self, dispatch_chunk: Optional[int] = None,
                 target_s: float = 0.002):
        self.dispatch_chunk = dispatch_chunk
        self.target_s = float(target_s)
        self._per_hit_s = 0.0  # EWMA device_sync seconds per hit

    #: retarget() bounds: the device-time target moves only inside this
    #: envelope (seconds)
    MIN_TARGET_S = 0.0005
    MAX_TARGET_S = 0.008

    def retarget(self, target_s: float) -> float:
        """Move the auto mode's device-time target, clamped to
        ``[MIN_TARGET_S, MAX_TARGET_S]``; a fixed ``dispatch_chunk``
        still wins in :meth:`chunk_hits`. Returns the applied target in
        seconds."""
        self.target_s = min(
            max(float(target_s), self.MIN_TARGET_S), self.MAX_TARGET_S
        )
        return self.target_s

    def observe(self, device_s: float, hits: int) -> None:
        """Feed one finished launch's device_sync time."""
        if hits <= 0 or device_s <= 0.0:
            return
        per = device_s / hits
        self._per_hit_s = (
            per if self._per_hit_s == 0.0
            else 0.8 * self._per_hit_s + 0.2 * per
        )

    def chunk_hits(self, queue_wait_s: float = 0.0) -> int:
        """Target hits per chunk; 0 = dispatch monolithically."""
        fixed = self.dispatch_chunk
        if fixed is not None:
            return max(int(fixed), 0)
        per = self._per_hit_s
        if per <= 0.0:
            return 0  # no device-time signal yet: stay monolithic
        target = self.target_s
        if queue_wait_s > target:
            target = target / 2
        # Quantized to the kernel's power-of-two hit buckets.
        return _bucket(max(int(target / per), self.MIN_CHUNK))

    def split(self, sizes, queue_wait_s: float = 0.0):
        """Partition a flush into chunk index ranges. ``sizes`` holds
        per-item hit counts in flush order; returns ``[(lo, hi), ...]``
        covering every item. A flush under 2 chunks' worth of hits stays
        monolithic, and a flush never splits past MAX_SPLITS launches."""
        n_items = len(sizes)
        chunk = self.chunk_hits(queue_wait_s)
        total = sum(sizes)
        if chunk <= 0 or total < 2 * chunk or n_items < 2:
            return [(0, n_items)]
        chunk = max(chunk, (total + self.MAX_SPLITS - 1) // self.MAX_SPLITS)
        ranges = []
        lo = 0
        acc = 0
        for i, size in enumerate(sizes):
            acc += size
            if acc >= chunk and i + 1 < n_items:
                ranges.append((lo, i + 1))
                lo, acc = i + 1, 0
        ranges.append((lo, n_items))
        if len(ranges) > 1 and acc < min(self.MIN_CHUNK, chunk):
            # A tail launch under MIN_CHUNK costs more than it hides:
            # fold it into the previous chunk.
            (lo2, _hi2), (lo1, hi1) = ranges[-2], ranges[-1]
            ranges[-2:] = [(lo2, hi1)]
        return ranges


def chunk_queue_wait(admission, oldest_enqueue: float,
                     t_flush: float) -> float:
    """Queue-wait signal feeding a ChunkPlanner, shared by the three
    dispatch lanes (MicroBatcher and both compiled pipelines): the
    admission plane's AIMD estimate when a controller is attached (the
    signal it already keeps from the recorder's flushes), else this
    flush's oldest wait."""
    if admission is not None:
        try:
            return admission.overload.queue_wait_estimate()
        except Exception:
            pass
    return t_flush - oldest_enqueue


def _observe(metrics, n_requests: int, seconds: float) -> None:
    """One ``datastore_device_latency`` sample per request of a batch."""
    hist = metrics.datastore_device_latency
    for _ in range(n_requests):
        hist.observe(seconds)


def _timed_call(fn, arg):
    """(fn(arg), t_start, t_end): phase timing across an executor hop
    (t_start minus the caller's submit time is the executor handoff)."""
    t_start = time.perf_counter()
    out = fn(arg)
    return out, t_start, time.perf_counter()


class MicroBatcher:
    def __init__(
        self,
        storage: TorchStorage,
        max_batch_hits: int = 8192,
        max_delay: float = 0.0005,
        max_inflight: int = 2,
        dispatch_chunk: Optional[int] = None,
    ):
        self.storage = storage
        self.max_batch_hits = max_batch_hits
        self.max_delay = max_delay
        self.max_inflight = max_inflight
        #: sizes each flush's launches (module docstring)
        self.chunk_planner = ChunkPlanner(dispatch_chunk)
        self._pending: List[tuple] = []  # (_Request, Future, t_enq, rid)
        self._pending_hits = 0
        self._wakeup: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        # Dispatch thread: serializes begin_check_many in batch order.
        # Collect threads: waits for results, may overlap.
        self._dispatch_pool = ThreadPoolExecutor(
            1, thread_name_prefix="torch-dispatch"
        )
        self._collect_pool = ThreadPoolExecutor(
            max_inflight, thread_name_prefix="torch-collect"
        )
        self._finishers: set = set()
        #: PrometheusMetrics sink (``AsyncTorchStorage.set_metrics``)
        self.metrics = None
        #: DeviceStatsRecorder (``AsyncTorchStorage.set_metrics``); None
        #: = detached: no request id or record per decision
        self.recorder = None
        #: hits per flush, drained by ``AsyncTorchStorage.library_stats``
        self.flush_sizes: List[int] = []
        #: AdmissionController (``AsyncTorchStorage.set_admission``);
        #: None = no breaker token, no failover drain
        self.admission = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # Dispatched-but-unfinished launches (and chunks waiting for the
        # window), so that a breaker trip can fail their futures instead
        # of leaving them parked on a dead plane.
        self._inflight_batches: Dict[int, list] = {}
        self._batch_seq = 0

    def _ensure_started(self) -> None:
        if self._task is None or self._task.done():
            self._wakeup = asyncio.Event()
            self._loop = asyncio.get_running_loop()
            self._task = self._loop.create_task(self._run())

    def fail_over_queued(self, decider, exc) -> None:
        """Breaker trip: every QUEUED request gets an immediate host
        decision through ``decider(counters, delta, load) ->
        Authorization``; dispatched-but-unfinished launches fail with
        ``exc`` (transient: their kernel may already have run, so
        deciding them again on the host would count them twice).
        Thread-safe: the trip listener can fire from a collect thread."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return

        def _drain():
            pending, self._pending = self._pending, []
            self._pending_hits = 0
            for request, future, _t, _rid in pending:
                if future.done():
                    continue
                try:
                    future.set_result(
                        decider(request.ordered, request.delta, request.load)
                    )
                except Exception as dexc:
                    future.set_exception(dexc)
            for batch in list(self._inflight_batches.values()):
                self._fail(batch, exc)

        loop.call_soon_threadsafe(_drain)

    async def submit(
        self, counters: List[Counter], delta: int, load: bool
    ) -> Authorization:
        """Enqueue one request; resolves when its batch has been decided."""
        require_nonnegative_delta(delta)
        self._ensure_started()
        future = asyncio.get_running_loop().create_future()
        request = _Request(counters, delta, load)
        rid = current_request_id() if self.recorder is not None else None
        self._pending.append((request, future, time.perf_counter(), rid))
        self._pending_hits += len(request.ordered)
        self._wakeup.set()
        return await future

    @staticmethod
    def _fail(batch, exc) -> None:
        for _r, future, _t, _rid in batch:
            if not future.done():
                future.set_exception(exc)

    @staticmethod
    def _resolve(batch, auths) -> None:
        for (_r, future, _t, _rid), auth in zip(batch, auths):
            if not future.done():
                future.set_result(auth)

    @staticmethod
    def _record_batch(rec, batch, batch_id, t_flush, phases) -> None:
        rec.record_batch(
            (
                (t_enq, rid,
                 request.ordered[0].namespace if request.ordered else None)
                for request, _future, t_enq, rid in batch
            ),
            batch_id, t_flush, phases,
        )

    async def _finish_inflight(self, batch, handle, finish, sem, loop, t0,
                               t_flush, batch_id, phases, n_hits, seq,
                               token):
        adm = self.admission
        try:
            with device_batch_span(batch_id, len(batch)) as span_phases:
                auths, t_fin, t_done = await loop.run_in_executor(
                    self._collect_pool, _timed_call, finish, handle
                )
                phases["device_sync"] = t_done - t_fin
                self.chunk_planner.observe(phases["device_sync"], n_hits)
                if self.metrics is not None:
                    _observe(self.metrics, len(batch),
                             time.perf_counter() - t0)
                self._resolve(batch, auths)
                phases["unpack"] = time.perf_counter() - t_done
                span_phases(phases)
                rec = self.recorder
                if rec is not None:
                    self._record_batch(rec, batch, batch_id, t_flush, phases)
            if adm is not None:
                adm.breaker.batch_finished(token)
        except Exception as exc:
            self._fail(batch, exc)
            if adm is not None:
                adm.breaker.batch_finished(token, exc)
        finally:
            self._inflight_batches.pop(seq, None)
            sem.release()

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        begin = self.storage.begin_check_many
        finish = self.storage.finish_check_many
        sem = asyncio.Semaphore(self.max_inflight)
        while not self._closed:
            while not self._pending:
                self._wakeup.clear()
                if self._closed:
                    return
                try:
                    await asyncio.wait_for(self._wakeup.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    if self._closed:
                        return
            if self._pending_hits < self.max_batch_hits:
                # Linger briefly to let concurrent requests coalesce.
                await asyncio.sleep(self.max_delay)
            # Take the inflight slot BEFORE the batch: under device
            # backpressure requests keep coalescing in _pending, where a
            # breaker trip can still fail them over.
            await sem.acquire()
            # A failover drain may have emptied the queue during the
            # linger or the slot wait: nothing to flush.
            if not self._pending:
                sem.release()
                continue
            # The linger may have filled the batch past the size trigger:
            # classify by what released the flush.
            reason = (
                "size" if self._pending_hits >= self.max_batch_hits
                else "deadline"
            )
            batch = self._pending
            flush_hits = self._pending_hits
            self._pending = []
            self._pending_hits = 0
            requests = [r for r, _f, _t, _rid in batch]
            # Recorded in hits, the batcher_flush_size histogram's unit.
            self.flush_sizes.append(flush_hits)
            del self.flush_sizes[:-1000]
            rec = self.recorder
            t_flush = time.perf_counter()
            batch_id = 0
            if rec is not None:
                batch_id = rec.next_batch_id()
                rec.record_flush(
                    reason, flush_hits / self.max_batch_hits,
                    [t_flush - t for _r, _f, t, _rid in batch],
                )
            # Chunked dispatch: the flush splits into launches riding the
            # inflight window, so chunk i+1 stages and uploads while
            # chunk i runs. The first chunk uses the slot taken above;
            # each further chunk takes its own.
            adm = self.admission
            sizes = [len(r.ordered) for r in requests]
            ranges = self.chunk_planner.split(
                sizes, chunk_queue_wait(adm, batch[0][2], t_flush)
            )
            chunk_hits = [sum(sizes[lo:hi]) for lo, hi in ranges]
            if rec is not None:
                rec.record_chunks(chunk_hits)
            # Every chunk registers as in flight BEFORE any await: a
            # breaker trip must be able to fail the chunks still waiting
            # for the window, which have left _pending.
            seqs = []
            for lo, hi in ranges:
                self._batch_seq += 1
                self._inflight_batches[self._batch_seq] = batch[lo:hi]
                seqs.append(self._batch_seq)
            failed = None
            for idx, ((lo, hi), seq) in enumerate(zip(ranges, seqs)):
                sub = batch[lo:hi]
                if failed is not None:
                    # A begin failure is plane-wide (the launch never
                    # reached the device): the rest of the flush fails as
                    # a monolithic dispatch would have.
                    self._inflight_batches.pop(seq, None)
                    self._fail(sub, failed)
                    continue
                if idx:
                    try:
                        await sem.acquire()
                    except BaseException as exc:
                        # Cancellation mid-flush must not strand the
                        # chunks still waiting on the window.
                        for rest in seqs[idx:]:
                            self._inflight_batches.pop(rest, None)
                        self._fail(batch[lo:], exc)
                        raise
                token = adm.breaker.batch_started() if adm is not None else 0
                t0 = time.perf_counter()
                try:
                    handle, t_begin, t_launch = await loop.run_in_executor(
                        self._dispatch_pool, _timed_call, begin,
                        requests[lo:hi],
                    )
                except Exception as exc:
                    sem.release()
                    self._inflight_batches.pop(seq, None)
                    self._fail(sub, exc)
                    if adm is not None:
                        adm.breaker.batch_finished(token, exc)
                    failed = exc
                    continue
                phases = {
                    "dispatch": t_begin - t0,
                    "host_stage": t_launch - t_begin,
                }
                t = loop.create_task(self._finish_inflight(
                    sub, handle, finish, sem, loop, t0, t_flush, batch_id,
                    phases, chunk_hits[idx], seq, token,
                ))
                self._finishers.add(t)
                t.add_done_callback(self._finishers.discard)

    async def close(self) -> None:
        self._closed = True
        if self._wakeup is not None:
            self._wakeup.set()
        if self._task is not None:
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        if self._finishers:
            await asyncio.gather(*list(self._finishers), return_exceptions=True)
        # Requests that slipped in while the last flush was off-loop would
        # otherwise await forever: decide them in one final batch.
        if self._pending:
            batch, self._pending = self._pending, []
            flush_hits = self._pending_hits
            self._pending_hits = 0
            rec = self.recorder
            if rec is not None:
                t_now = time.perf_counter()
                rec.record_flush(
                    "shutdown", flush_hits / self.max_batch_hits,
                    [t_now - t for _r, _f, t, _rid in batch],
                )
            try:
                self._resolve(
                    batch,
                    self.storage.check_many(
                        [r for r, _f, _t, _rid in batch]
                    ),
                )
            except Exception as exc:
                self._fail(batch, exc)
        self._dispatch_pool.shutdown(wait=False)
        self._collect_pool.shutdown(wait=False)


class UpdateBatcher:
    """Coalesces unconditional increments (the Kuadrant Report path /
    ``update_counter``) into vectorized ``apply_deltas`` launches: deltas
    sum per counter identity, one device call per flush instead of one
    per request."""

    def __init__(self, storage, max_batch: int = 4096,
                 max_delay: float = 0.0005):
        self.storage = storage
        self.max_batch = max_batch
        self.max_delay = max_delay
        self._pending: Dict[Counter, int] = {}
        self._waiters: List[asyncio.Future] = []
        self._wakeup: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="torch-update")
        #: PrometheusMetrics sink (``AsyncTorchStorage.set_metrics``)
        self.metrics = None
        #: DeviceStatsRecorder; None = detached
        self.recorder = None
        #: AdmissionController: feeds the breaker and lets a trip journal
        #: queued updates on the failover store; None = detached
        self.admission = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # Waiters of the flush inside _apply on the executor, so that a
        # breaker trip can settle them off a dead plane.
        self._inflight_waiters: Dict[int, list] = {}
        self._flush_seq = 0

    def _ensure_started(self) -> None:
        if self._task is None or self._task.done():
            self._wakeup = asyncio.Event()
            self._loop = asyncio.get_running_loop()
            self._task = self._loop.create_task(self._run())

    def fail_over_queued(self, apply_fn, exc=None) -> None:
        """Breaker trip: journal every queued (counter, delta) through
        ``apply_fn`` (the failover store) and settle the waiters; the
        flush already inside ``_apply`` on the dead plane settles with
        ``exc`` (its deltas may land when the card unwedges, so
        journaling them too would count them twice). Thread-safe."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        stuck_exc = exc or StorageError(
            "device plane failed over", transient=True
        )

        def _drain():
            items, waiters = self._swap()
            try:
                for counter, delta in items:
                    apply_fn(counter, delta)
            except Exception as dexc:
                self._settle(waiters, dexc)
            else:
                self._settle(waiters, None)
            for stuck in list(self._inflight_waiters.values()):
                self._settle(stuck, stuck_exc)

        loop.call_soon_threadsafe(_drain)

    async def submit(self, counter: Counter, delta: int) -> None:
        # Reject before coalescing: a negative delta inside the batch
        # would fail the whole apply and drop other requests' updates.
        require_nonnegative_delta(delta)
        self._ensure_started()
        future = asyncio.get_running_loop().create_future()
        self._pending[counter] = self._pending.get(counter, 0) + int(delta)
        self._waiters.append((future, time.perf_counter()))
        self._wakeup.set()
        await future

    def _apply(self, items: List[Tuple[Counter, int]]) -> None:
        self.storage.apply_deltas(items)

    @staticmethod
    def _settle(waiters, exc) -> None:
        for future, _t in waiters:
            if future.done():
                continue
            if exc is not None:
                future.set_exception(exc)
            else:
                future.set_result(None)

    def _record_flush(self, reason: str, n_counters: int, waiters) -> None:
        rec = self.recorder
        if rec is not None:
            t_now = time.perf_counter()
            rec.record_flush(
                reason, n_counters / self.max_batch,
                [t_now - t for _f, t in waiters],
                batcher="update",
            )

    def _swap(self):
        items = list(self._pending.items())
        waiters = self._waiters
        self._pending = {}
        self._waiters = []
        return items, waiters

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._closed:
            while not self._pending:
                self._wakeup.clear()
                if self._closed:
                    return
                try:
                    await asyncio.wait_for(self._wakeup.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    if self._closed:
                        return
            if len(self._pending) < self.max_batch:
                await asyncio.sleep(self.max_delay)
            if not self._pending:
                continue  # a failover drain emptied it during the linger
            reason = (
                "size" if len(self._pending) >= self.max_batch
                else "deadline"
            )
            items, waiters = self._swap()
            self._record_flush(reason, len(items), waiters)
            adm = self.admission
            token = adm.breaker.batch_started() if adm is not None else 0
            self._flush_seq += 1
            seq = self._flush_seq
            self._inflight_waiters[seq] = waiters
            t0 = time.perf_counter()
            try:
                await loop.run_in_executor(self._pool, self._apply, items)
            except Exception as exc:
                if adm is not None:
                    adm.breaker.batch_finished(token, exc)
                self._settle(waiters, exc)
            else:
                if adm is not None:
                    adm.breaker.batch_finished(token)
                if self.metrics is not None:
                    _observe(
                        self.metrics, len(waiters), time.perf_counter() - t0
                    )
                self._settle(waiters, None)
            finally:
                self._inflight_waiters.pop(seq, None)

    async def close(self) -> None:
        self._closed = True
        if self._wakeup is not None:
            self._wakeup.set()
        if self._task is not None:
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        if self._pending:
            items, waiters = self._swap()
            self._record_flush("shutdown", len(items), waiters)
            try:
                self._apply(items)
            except Exception as exc:
                self._settle(waiters, exc)
            else:
                self._settle(waiters, None)
        self._pool.shutdown(wait=False)


class AsyncTorchStorage(AsyncCounterStorage):
    """AsyncCounterStorage over a device storage (``TorchStorage``, by
    default, or ``TorchShardedStorage``) + MicroBatcher: the hot
    check_and_update path batches, the Report/update path batches through
    ``UpdateBatcher``; admin operations delegate inline.

    The batchers are per event loop (a MicroBatcher's queue, wakeup event
    and flush task are loop-affine), all feeding the one thread-safe
    storage behind them. The first loop to submit binds the default pair
    (``self.batcher`` / ``self.update_batcher``)."""

    supports_token_bucket = True

    def __init__(
        self,
        storage: Optional[TorchStorage] = None,
        max_batch_hits: int = 8192,
        max_delay: float = 0.0005,
        dispatch_chunk: Optional[int] = None,
        **kwargs,
    ):
        self.inner = storage or TorchStorage(**kwargs)
        self.batcher = MicroBatcher(
            self.inner, max_batch_hits, max_delay,
            dispatch_chunk=dispatch_chunk,
        )
        self.update_batcher = UpdateBatcher(self.inner, max_delay=max_delay)
        self._batcher_args = (max_batch_hits, max_delay, dispatch_chunk)
        # loop -> (MicroBatcher, UpdateBatcher)
        self._loop_batchers: dict = {}
        self._default_bound = False
        self._shards_lock = threading.Lock()
        self._metrics = None
        #: the DeviceStatsRecorder every batcher pair writes into
        #: (``set_metrics``); None = detached
        self.recorder: Optional[DeviceStatsRecorder] = None
        #: the AdmissionController (``set_admission``); None = no plane
        self.admission = None

    def _batcher_pairs(self) -> list:
        """Every live (check, update) batcher pair, the default pair
        included even before a loop binds it."""
        pairs = list(self._loop_batchers.values())
        if not any(b is self.batcher for b, _u in pairs):
            pairs.append((self.batcher, self.update_batcher))
        return pairs

    def _batchers_for_loop(self):
        loop = asyncio.get_running_loop()
        pair = self._loop_batchers.get(loop)
        if pair is not None:
            return pair
        with self._shards_lock:
            pair = self._loop_batchers.get(loop)
            if pair is None:
                # Prune pairs whose loop died; the default pair is kept
                # (close() owns it).
                for dead in [
                    l for l in self._loop_batchers if l.is_closed()
                ]:
                    mb, ub = self._loop_batchers.pop(dead)
                    if mb is not self.batcher:
                        mb._dispatch_pool.shutdown(wait=False)
                        mb._collect_pool.shutdown(wait=False)
                        ub._pool.shutdown(wait=False)
                if not self._default_bound:
                    self._default_bound = True
                    pair = (self.batcher, self.update_batcher)
                else:
                    max_batch_hits, max_delay, dispatch_chunk = (
                        self._batcher_args
                    )
                    pair = (
                        MicroBatcher(self.inner, max_batch_hits, max_delay,
                                     dispatch_chunk=dispatch_chunk),
                        UpdateBatcher(self.inner, max_delay=max_delay),
                    )
                    for batcher in pair:
                        batcher.metrics = self._metrics
                        batcher.recorder = self.recorder
                        batcher.admission = self.admission
                self._loop_batchers[loop] = pair
            return pair

    def set_admission(self, controller) -> None:
        """Put this storage under an admission controller: the check path
        consults its breaker (failing over to the host oracle when open),
        and every batcher pair feeds it batch outcomes."""
        self.admission = controller
        for mb, ub in self._batcher_pairs():
            mb.admission = controller
            ub.admission = controller
        controller.bind_storage(self)

    def fail_over_queued(self, decider, exc) -> None:
        """Breaker trip fan-out (the controller's transition listener):
        drain every loop's batcher queues off the dead plane."""
        adm = self.admission
        for mb, ub in self._batcher_pairs():
            mb.fail_over_queued(decider, exc)
            if adm is not None:
                ub.fail_over_queued(adm.failover_update_counter, exc)

    def set_metrics(self, metrics) -> None:
        """Have the batchers observe each request's device batch round
        trip (queue wait excluded) into ``datastore_device_latency``, and
        attach one device-plane recorder to every batcher pair (queue
        waits, fill ratios, flush reasons, chunk plans, phase timings,
        the slow-decision flight recorder)."""
        self._metrics = metrics
        self.recorder = DeviceStatsRecorder(metrics)
        for mb, ub in self._batcher_pairs():
            mb.metrics = metrics
            ub.metrics = metrics
            mb.recorder = self.recorder
            ub.recorder = self.recorder

    def library_stats(self) -> dict:
        """Operational metrics for the /metrics library gauges,
        aggregated across the per-loop batcher pairs."""
        flush_sizes: List[int] = []
        batcher_size = 0
        queue_depth = 0
        for mb, ub in self._batcher_pairs():
            shard_sizes, mb.flush_sizes = mb.flush_sizes, []
            flush_sizes.extend(shard_sizes)
            batcher_size += mb._pending_hits + len(ub._pending)
            queue_depth += len(mb._pending) + len(ub._pending)
        cache_size = 0
        table = getattr(self.inner, "_table", None)
        if table is not None:
            cache_size = len(table.qualified) + len(table.simple)
        else:  # sharded: per-row tables + the global region
            for t in self.inner._tables:
                cache_size += len(t.qualified) + len(t.simple)
            gtable = self.inner._gtable
            cache_size += len(gtable.qualified) + len(gtable.simple)
        stats = {
            "batcher_size": batcher_size,
            "cache_size": cache_size,
            "flush_sizes": flush_sizes,
            "queue_depth": queue_depth,
        }
        launch_stats = getattr(self.inner, "launch_stats", None)
        if callable(launch_stats):
            # sharded storage: per-variant launch tallies and the route
            # memo (the sharded_* families)
            stats.update(launch_stats())
        return stats

    def device_stats(self) -> dict:
        """Per-shard device table stats of the wrapped storage."""
        return self.inner.device_stats()

    async def check_and_update(
        self, counters: List[Counter], delta: int, load_counters: bool
    ) -> Authorization:
        if not counters:
            return Authorization.OK
        adm = self.admission
        if adm is not None and adm.use_failover():
            # Breaker open/half-open: an exact host-oracle decision, no
            # batch slot, no device access (the delta journals for the
            # recovery reconcile).
            return adm.failover_check_and_update(
                counters, delta, load_counters
            )
        batcher, _ub = self._batchers_for_loop()
        return await batcher.submit(counters, delta, load_counters)

    def set_limits_provider(self, provider) -> None:
        """Forwarded so the facade's registry reaches a replicated inner
        storage (it decodes gossiped wire keys against the limits)."""
        if hasattr(self.inner, "set_limits_provider"):
            self.inner.set_limits_provider(provider)

    async def is_within_limits(self, counter: Counter, delta: int) -> bool:
        adm = self.admission
        if adm is not None and adm.use_failover():
            return adm.failover_is_within_limits(counter, delta)
        return self.inner.is_within_limits(counter, delta)

    async def add_counter(self, limit: Limit) -> None:
        self.inner.add_counter(limit)

    async def update_counter(self, counter: Counter, delta: int) -> None:
        adm = self.admission
        if adm is not None and adm.use_failover():
            require_nonnegative_delta(delta)
            adm.failover_update_counter(counter, delta)
            return
        _mb, update_batcher = self._batchers_for_loop()
        await update_batcher.submit(counter, delta)

    async def get_counters(self, limits) -> set:
        return self.inner.get_counters(limits)

    async def delete_counters(self, limits) -> None:
        self.inner.delete_counters(limits)

    async def clear(self) -> None:
        self.inner.clear()

    async def close(self) -> None:
        cur = asyncio.get_running_loop()
        closed: set = set()
        for loop, (mb, ub) in list(self._loop_batchers.items()):
            if id(mb) in closed or loop is cur:
                continue  # current-loop / default pair closed below
            if not loop.is_closed() and loop.is_running():
                closed.add(id(mb))
                try:
                    asyncio.run_coroutine_threadsafe(
                        mb.close(), loop
                    ).result(timeout=10)
                    asyncio.run_coroutine_threadsafe(
                        ub.close(), loop
                    ).result(timeout=10)
                except Exception:
                    pass  # shard loop died mid-shutdown
        for mb, ub in self._batcher_pairs():
            if id(mb) in closed:
                continue
            try:
                await mb.close()
                await ub.close()
            except Exception:
                pass
        self.inner.close()
