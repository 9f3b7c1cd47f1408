"""Device-plane observability: batching and queue telemetry, the flight
recorder, on-demand profiler captures and the ``/debug/stats`` walk.

Counterpart of ``limitador_tpu/observability/device_plane.py``. Pieces:

* :class:`DeviceStatsRecorder`: the sink the batchers and pipelines
  write flush-level telemetry into (queue waits, fill ratios, flush
  reasons, chunk plans, per-phase timings). A batcher holds
  ``recorder = None`` until ``set_metrics`` wires one up, and every
  per-decision instrumentation site is guarded by that one
  ``is not None`` check: a detached batcher touches nothing here.
* :class:`FlightRecorder`: a bounded buffer of the slowest-N recent
  decisions (request id, namespace, batch id, per-phase timings),
  served on ``GET /debug/stats``.
* :class:`TorchProfiler`: on-demand ``torch.profiler`` captures behind
  ``POST /debug/profile`` (one capture per process; CUDA activity too
  when the serving table is on the card), exported as a Chrome trace.
* the request-id context variable, set per HTTP request and gRPC call
  by ``server/middleware.py``;
* ``collect_debug_stats``, the ``GET /debug/stats`` walk.

Per-batch phase names (``PHASES``):

* ``dispatch``: flush decision to the dispatch thread picking the batch
  up (executor queueing and loop scheduling),
* ``host_cache``: decision-plan cache lookup and cached-lane staging
  (native pipeline with the hot lane off),
* ``native_lane``: the zero-Python hot lane's one C call (native
  pipeline with the lane on),
* ``host_stage``: hit-array construction and kernel launch on the
  dispatch thread,
* ``device_sync``: the wait the collect thread already makes for the
  batch's answers and their decode (host wall clock; nothing is added
  to the path to take it),
* ``unpack``: resolving the futures,
* ``lease``: one lease-broker refresh pass (settle and grant).

The recorder also feeds the control planes from numbers it already has
in hand: the process flight recorder's ``lean`` lane (``flight_tap``,
one tap a decision), the serving model's per-launch observations
(``model``, one ingest a batch), the signal bus's EWMAs of the check
path's worst queue wait and fill ratio a flush, and the admission
plane's congestion feed (``on_queue_waits``, one call a check flush
with the flush's queue waits; the AIMD limit's estimate).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import heapq
import itertools
import os
import tempfile
import threading
import time
from contextvars import ContextVar
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from .model import model_fit_enabled, process_estimator

__all__ = [
    "PHASES",
    "FLUSH_REASONS",
    "BATCHERS",
    "FlightRecorder",
    "DeviceStatsRecorder",
    "TorchProfiler",
    "ProfilerStateError",
    "default_profile_dir",
    "current_request_id",
    "set_request_id",
    "collect_debug_stats",
]

PHASES = ("dispatch", "host_cache", "native_lane", "host_stage",
          "device_sync", "unpack", "lease")
FLUSH_REASONS = ("size", "deadline", "shutdown")
# The two queues feeding the batcher_* families: the decision path's
# MicroBatcher and the write path's UpdateBatcher, labelled apart because
# their steady states differ (the update batcher lingers to its deadline
# by design).
BATCHERS = ("check", "update")

_request_id: ContextVar[Optional[str]] = ContextVar(
    "limitador_tpu_torch_request_id", default=None
)


def current_request_id() -> Optional[str]:
    return _request_id.get()


def set_request_id(request_id: Optional[str]) -> None:
    _request_id.set(request_id)


class FlightRecorder:
    """Bounded record of the slowest recent decisions.

    A size-``capacity`` min-heap keyed by total decision duration: a new
    decision enters only by beating the current fastest resident, which
    is also the eviction order, so the buffer holds the slowest N seen
    since the last ``clear``. Thread-safe (decisions resolve on collect
    threads)."""

    def __init__(self, capacity: int = 32):
        self.capacity = max(int(capacity), 1)
        self._heap: List[tuple] = []  # (duration_s, seq, entry)
        self._seq = itertools.count()
        self._lock = threading.Lock()

    def would_admit(self, duration_s: float) -> bool:
        """Lock-free pre-check so callers skip building entry dicts for
        decisions that cannot enter (racy by design; ``offer`` checks
        again under the lock)."""
        heap = self._heap
        return len(heap) < self.capacity or duration_s > heap[0][0]

    def offer(self, duration_s: float, entry: dict) -> None:
        with self._lock:
            if len(self._heap) < self.capacity:
                heapq.heappush(
                    self._heap, (duration_s, next(self._seq), entry)
                )
            elif duration_s > self._heap[0][0]:
                heapq.heapreplace(
                    self._heap, (duration_s, next(self._seq), entry)
                )

    def snapshot(self) -> List[dict]:
        """Entries slowest first, each with a ``duration_ms`` field."""
        with self._lock:
            items = sorted(self._heap, key=lambda t: (-t[0], t[1]))
        return [
            dict(entry, duration_ms=round(duration * 1e3, 3))
            for duration, _seq, entry in items
        ]

    def clear(self) -> None:
        with self._lock:
            self._heap.clear()


class DeviceStatsRecorder:
    """Flush-level telemetry sink shared by the batchers and pipelines.

    Holds the flight recorder and the flush-reason tallies and, with a
    ``PrometheusMetrics``, observes queue waits, fill ratios, flush
    reasons, chunk plans and phase timings into their families.
    ``clock`` (``time.perf_counter`` by default) is the clock the
    batchers stamp enqueue times with; ``record_batch`` reads it for
    each decision's end-to-end duration. The serving model's ingest
    tap is armed at construction when ``model.model_fit_enabled()``
    (the server sets it from ``--model-fit`` before any recorder is
    made)."""

    def __init__(self, metrics=None, flight_capacity: int = 32,
                 clock: Callable[[], float] = time.perf_counter):
        self.metrics = metrics
        # labelled children of the families, looked up once each
        self._children: Dict[tuple, object] = {}
        self.flight = FlightRecorder(flight_capacity)
        self.flush_reasons: Dict[str, int] = dict.fromkeys(FLUSH_REASONS, 0)
        self._lock = threading.Lock()
        self._batch_ids = itertools.count(1)
        self._clock = clock
        # SLO watchdog (native_plane.SloWatchdog): fed the per-decision
        # end-to-end latencies record_batch has in hand, one lock per
        # batch. None = detached.
        self.slo = None
        # Process flight recorder (flight.FlightRecorder): every decision
        # record_batch times taps its "lean" lane (a counter bump off the
        # sampled path). None = detached.
        self.flight_tap = None
        # Signal-bus taps: EWMAs of the check path's worst queue wait and
        # fill ratio a flush, read by signals.SignalBus.
        self.signal_queue_wait_s = 0.0
        self.signal_batch_fill = 0.0
        # Admission-plane congestion feed: called with each check flush's
        # queue waits (the AIMD estimate's samples). None = detached.
        self.on_queue_waits = None
        # Serving-model estimator (model.ServingModelEstimator): one
        # ingest (a lock and a bounded append) a batch; the fit runs on
        # the usage observatory's drain thread. None = detached.
        self.model = None
        if model_fit_enabled():
            self.model = process_estimator()

    def next_batch_id(self) -> int:
        return next(self._batch_ids)

    def _child(self, family: str, *labels):
        """The labelled child of one of the metrics' families: a family's
        ``labels()`` takes a lock and validates its values on every call,
        and the served path records a few per request."""
        key = (family,) + labels
        child = self._children.get(key)
        if child is None:
            child = getattr(self.metrics, family).labels(*labels)
            self._children[key] = child
        return child

    def record_flush(
        self,
        reason: str,
        fill_ratio: float,
        queue_waits: Sequence[float],
        batcher: str = "check",
    ) -> None:
        with self._lock:
            self.flush_reasons[reason] = self.flush_reasons.get(reason, 0) + 1
        if batcher == "check":
            # racy float EWMAs by design: a torn read costs one sample of
            # smoothing, never correctness
            self.signal_queue_wait_s += 0.2 * (
                max(queue_waits, default=0.0) - self.signal_queue_wait_s
            )
            self.signal_batch_fill += 0.2 * (
                min(fill_ratio, 1.0) - self.signal_batch_fill
            )
            if self.on_queue_waits is not None:
                try:
                    self.on_queue_waits(queue_waits)
                except Exception:
                    pass  # congestion feedback must never fail a flush
        if self.metrics is None:
            return
        self._child("batcher_flushes", batcher, reason).inc()
        self._child("batcher_batch_fill_ratio", batcher).observe(
            min(fill_ratio, 1.0))
        observe = self._child("batcher_queue_wait", batcher).observe
        for wait in queue_waits:
            observe(wait)

    def record_chunks(self, chunk_hits: List[int]) -> None:
        """One flush's chunked-dispatch plan: how many launches it split
        into and each chunk's hit count (the dispatch_chunk_* families)."""
        m = self.metrics
        if m is None:
            return
        m.dispatch_chunk_splits.observe(len(chunk_hits))
        for hits in chunk_hits:
            m.dispatch_chunk_hits.observe(hits)

    def record_phases(self, phases: Dict[str, float]) -> None:
        if self.metrics is None:
            return
        for phase, seconds in phases.items():
            self._child("device_phase_latency", phase).observe(seconds)

    def record_decision(
        self,
        duration_s: float,
        request_id: Optional[str],
        namespace: Optional[str],
        batch_id: int,
        queue_wait_s: float,
        phases_ms: Optional[dict] = None,
    ) -> None:
        """Offer one decided request to the flight recorder. Callers
        gate on ``flight.would_admit`` to skip the argument marshalling
        for the fast majority (``record_batch`` does)."""
        self.flight.offer(duration_s, {
            "request_id": request_id,
            "namespace": None if namespace is None else str(namespace),
            "batch_id": batch_id,
            "queue_wait_ms": round(queue_wait_s * 1e3, 3),
            "phases_ms": phases_ms or {},
        })

    def record_batch(
        self,
        entries: Iterable[tuple],
        batch_id: int,
        t_flush: float,
        phases: Dict[str, float],
    ) -> None:
        """Flush-level fan-out for one finished batch, shared by the
        three pipelines: phase histograms, the SLO watchdog's feed, the
        process flight recorder's ``lean`` tap, flight-recorder offers
        for the decisions slow enough to enter and one serving-model
        observation. ``entries`` yields ``(t_enqueue, request_id,
        namespace)`` per decided request (namespace may be any object,
        stringified only on admission)."""
        self.record_phases(phases)
        phases_ms = self.phases_ms(phases)
        flight = self.flight
        tap = self.flight_tap
        slo = self.slo
        totals: Optional[list] = [] if slo is not None else None
        t_now = self._clock()
        n_rows = 0
        min_enq: Optional[float] = None
        for t_enq, rid, namespace in entries:
            n_rows += 1
            if min_enq is None or t_enq < min_enq:
                min_enq = t_enq
            total = t_now - t_enq
            if totals is not None:
                totals.append(total)
            if tap is not None:
                tap.tap(total, "lean", request_id=rid, namespace=namespace,
                        phases_ms=phases_ms)
            if flight.would_admit(total):
                self.record_decision(
                    total, rid, namespace, batch_id,
                    max(t_flush - t_enq, 0.0), phases_ms,
                )
        if totals:
            slo.observe_many(totals)
        model = self.model
        if model is not None and n_rows:
            # The host target is the launch-shaped host work only, as
            # the JAX recorder takes it: native_lane absorbs the loop's
            # interleaving on the submit lane, lease is a broker pass,
            # and dispatch is executor queueing, which joins the queue
            # wait instead.
            host_s = sum(
                phases.get(k, 0.0)
                for k in ("host_cache", "host_stage", "unpack")
            )
            model.ingest(
                n_rows, host_s, phases.get("device_sync", 0.0),
                max(t_flush - min_enq, 0.0) + phases.get("dispatch", 0.0),
            )

    @staticmethod
    def phases_ms(phases: Dict[str, float]) -> dict:
        return {k: round(v * 1e3, 3) for k, v in phases.items()}


# -- torch.profiler captures -------------------------------------------------


class ProfilerStateError(RuntimeError):
    """start while a capture is active / stop while idle (HTTP 409)."""


def default_profile_dir() -> str:
    """``limitador-tpu-profile`` under the process's temporary directory
    (``TMPDIR``), the JAX server's default directory name."""
    return os.path.join(tempfile.gettempdir(), "limitador-tpu-profile")


@contextlib.contextmanager
def _environ_kept():
    """Starting torch.profiler sets a default for a compiler's cache
    directory (TORCHINDUCTOR_CACHE_DIR) in os.environ; a debug capture
    leaves the server's environment as it found it."""
    before = set(os.environ)
    try:
        yield
    finally:
        for key in set(os.environ) - before:
            del os.environ[key]


# One capture per process, whichever TorchProfiler started it: the
# profiler's CUPTI and Kineto state is process-wide.
_capture_lock = threading.Lock()
_capture: Optional[dict] = None
_capture_seq = itertools.count(1)


class TorchProfiler:
    """On-demand ``torch.profiler`` capture: ``start`` opens the
    process's one ``torch.profiler.profile`` (CPU activity always, CUDA
    activity when ``cuda``), ``stop`` exports its Chrome trace into the
    capture's directory (``last_trace`` names the file). Several servers
    in one process share the one capture: a start while any is active
    raises ``ProfilerStateError``, and any of them may stop it, on the
    thread that started it (the profiler's own rule): a stop from
    another thread raises ``ProfilerStateError`` and leaves the capture
    running. With ``loop`` (the server's event loop), ``start`` and
    ``stop`` called from another thread (a flight bundle's capture, on
    the trigger thread or an executor thread) run on the loop's thread,
    where ``/debug/profile`` runs them, and block until they have: the
    first CUDA capture of a process records no kernel unless it starts
    on the thread that initialized torch, which the served binary's loop
    runs on. ``torch.profiler`` is imported in ``start`` only."""

    def __init__(self, default_dir: Optional[str] = None, cuda: bool = False,
                 loop: Optional[asyncio.AbstractEventLoop] = None):
        self.default_dir = default_dir or default_profile_dir()
        self.cuda = bool(cuda)
        self.loop = loop
        #: the Chrome trace the last ``stop`` of this profiler exported
        self.last_trace: Optional[str] = None

    def _on_loop(self, fn, *args):
        """``fn(*args)`` on the thread of ``loop`` when one is set and
        this is another thread (waiting up to a minute for it), else
        here."""
        loop = self.loop
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None  # not on a loop's thread
        if loop is None or running is loop:
            return fn(*args)
        done: concurrent.futures.Future = concurrent.futures.Future()

        def run():
            try:
                done.set_result(fn(*args))
            except BaseException as exc:
                done.set_exception(exc)

        loop.call_soon_threadsafe(run)
        return done.result(timeout=60.0)

    def start(self, trace_dir: Optional[str] = None) -> str:
        """Start a capture into ``trace_dir`` (default ``default_dir``),
        created when missing. Raises ``OSError`` when the directory
        cannot be created or written."""
        return self._on_loop(self._start, trace_dir)

    def stop(self) -> str:
        """Stop the capture and export its Chrome trace; returns the
        directory. The state clears before the profiler stops, so a
        failed export cannot wedge the endpoint in "already capturing"."""
        return self._on_loop(self._stop)

    def _start(self, trace_dir: Optional[str]) -> str:
        global _capture
        with _capture_lock:
            if _capture is not None:
                raise ProfilerStateError(
                    f"profiler already capturing to {_capture['trace_dir']}"
                )
            target = trace_dir or self.default_dir
            os.makedirs(target, exist_ok=True)
            if not os.access(target, os.W_OK | os.X_OK):
                raise PermissionError(
                    f"profile directory {target} is not writable"
                )
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
            with _environ_kept():
                prof = profile(activities=activities)
                prof.start()
            _capture = {
                "profile": prof,
                "trace_dir": target,
                "started_at": time.time(),
                "thread": threading.get_ident(),
            }
            return target

    def _stop(self) -> str:
        global _capture
        with _capture_lock:
            if _capture is None:
                raise ProfilerStateError("no profiler capture active")
            if _capture["thread"] != threading.get_ident():
                raise ProfilerStateError(
                    "the capture was started on another thread, which "
                    "stops it"
                )
            capture, _capture = _capture, None
            prof = capture["profile"]
            target = capture["trace_dir"]
            trace = os.path.join(
                target,
                f"limitador-torch-{os.getpid()}-{next(_capture_seq)}"
                ".pt.trace.json",
            )
            with _environ_kept():
                prof.stop()
                prof.export_chrome_trace(trace)
            self.last_trace = trace
            return target

    def status(self) -> dict:
        with _capture_lock:
            capture = _capture
            return {
                "active": capture is not None,
                "trace_dir": capture["trace_dir"] if capture else None,
                "started_at": capture["started_at"] if capture else None,
            }


# -- /debug/stats ------------------------------------------------------------

# The JAX package's queue names, so that dashboards read one key set.
_QUEUE_NAMES = {
    "MicroBatcher": "check_batcher",
    "UpdateBatcher": "update_batcher",
    "CompiledTorchLimiter": "compiled_pipeline",
    "NativeRlsPipeline": "native_pipeline",
}

#: attributes worth descending into when walking a limiter for
#: device-plane state (facade -> storage -> batchers -> device table;
#: "admission" reaches the admission controller hung off the storage)
_CHILD_ATTRS = (
    "storage", "counters", "batcher", "update_batcher", "inner", "_torch",
    "limiter", "admission",
)


def collect_debug_stats(*sources) -> dict:
    """Walk limiters/storages/pipelines for device-plane state and shape
    the ``GET /debug/stats`` payload: per-queue depths, per-shard table
    occupancy, flush-reason tallies, the slow-decision flight recorder,
    the decision-plan caches and, with an admission controller, its
    ``admission`` section. Everything is getattr-driven, so any
    storage topology reports what it has (an in-memory limiter reports
    empty sections)."""
    seen: set = set()
    queues: List[dict] = []
    shards: Dict[str, dict] = {}
    recorders: Dict[int, DeviceStatsRecorder] = {}
    admission: Dict[int, dict] = {}
    plan_caches: Dict[int, dict] = {}
    for source in sources:
        _walk(source, seen, queues, shards, recorders, admission,
              plan_caches)
    flush_reasons: Dict[str, int] = {}
    flights: List[dict] = []
    for recorder in recorders.values():
        for reason, count in recorder.flush_reasons.items():
            flush_reasons[reason] = flush_reasons.get(reason, 0) + count
        flights.extend(recorder.flight.snapshot())
    flights.sort(key=lambda e: -e.get("duration_ms", 0.0))
    out = {
        "queues": queues,
        "shards": list(shards.values()),
        "flush_reasons": flush_reasons,
        "flight_recorder": flights,
    }
    if admission:
        # One controller per process in practice; surface the first.
        out["admission"] = next(iter(admission.values()))
    if plan_caches:
        # Per-pipeline decision-plan cache state (native blob cache
        # and/or compiled counter cache), keyed by type name.
        out["plan_cache"] = {
            name: stats for stats in plan_caches.values()
            for name in (stats.pop("_source"),)
        }
    return out


def _walk(source, seen, queues, shards, recorders, admission,
          plan_caches) -> None:
    if source is None or id(source) in seen:
        return
    seen.add(id(source))
    debug = getattr(source, "admission_debug", None)
    if callable(debug):
        admission[id(source)] = debug()
    cache_stats = getattr(source, "plan_cache_stats", None)
    if callable(cache_stats):
        stats = cache_stats()
        if stats:
            stats = dict(stats)
            stats["_source"] = type(source).__name__
            plan_caches[id(source)] = stats
    recorder = getattr(source, "recorder", None)
    if isinstance(recorder, DeviceStatsRecorder):
        recorders[id(recorder)] = recorder
    name = type(source).__name__
    pending = getattr(source, "_pending", None)
    # Only the batchers and pipelines are queues: the serving-model
    # estimator's ingest buffer and the flight trigger's peer retries
    # (debug sources too) are not.
    if name in _QUEUE_NAMES and hasattr(pending, "__len__"):
        entry = {
            "queue": _QUEUE_NAMES[name],
            "depth": len(pending),
        }
        pending_hits = getattr(source, "_pending_hits", None)
        if pending_hits is not None:
            entry["pending_hits"] = int(pending_hits)
        queues.append(entry)
    device_stats = getattr(source, "device_stats", None)
    if callable(device_stats):
        # Keyed by shard label: a facade delegating to its inner storage
        # must not report the same table twice.
        for shard in device_stats().get("shards", ()):
            shards[str(shard.get("shard"))] = shard
    for attr in _CHILD_ATTRS:
        child = getattr(source, attr, None)
        if child is not None and not isinstance(
            child, (int, float, str, bytes, bool, dict, list, tuple, set)
        ):
            _walk(child, seen, queues, shards, recorders, admission,
                  plan_caches)
