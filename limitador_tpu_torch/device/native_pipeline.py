"""Native columnar RLS serving path.

Port counterpart of ``limitador_tpu/tpu/native_pipeline.py``
(``NativeRlsPipeline``), its single-process parts. The gRPC handler hands
this pipeline RAW serialized RateLimitRequest bytes (Python protobuf never
runs on the hot path); a micro-batch of blobs then flows

    C++ hot lane: plan-mirror lookup, columnar staging,
    begin-time response codes                      (csrc/hostpath.cc)
    -> misses: C++ parse + intern -> token columns
    -> compiled predicate masks (numpy)            (device/compiler.py)
    -> composite-key slot lookup (C++ hash map)
    -> ONE B1 launch per lane                      (begin_check_columnar)
    -> per-request OK / OVER_LIMIT blobs (prebuilt bytes)

Python objects only materialize off the fast path: slot-map misses
(allocation through the storage's key space, kept coherent with the
native keys so LRU eviction invalidates both sides), requests with
several descriptors and namespaces with non-vectorizable limits (both
take the exact per-request path), and unknown namespaces.

Serving model: ``submit`` is a plain function returning an awaitable
future; the pending queue is sharded per event loop. ``decide_many`` is
the synchronous bulk engine (raw blobs in, response blobs out). With
``attach_lease`` the quota-lease broker (``lease/broker.py``) pre-debits
token batches for hot plans, and leased rows are admitted inside the C
lane without a launch; ``drain_leased_usage`` hands their counts to the
usage observatory.

Semantics are the same exact check-all-then-update-all as everywhere
else; this module only changes how fast the batch is assembled.

No silent fallbacks: a host lane that does not build raises
``BuildError``; a hot lane asked for (``hot_lane`` True or None) that
cannot come up, and ``attach_lease`` without the lane, raise
``RuntimeError``. ``hot_lane=False`` is a real choice: the pure-Python
cached lane, byte-identical decisions.

``library_stats`` feeds the ``plan_cache_*``, ``native_lane_*`` and
``lease_*`` Prometheus families; ``plan_cache_stats``, ``lane_stats`` and
``lease_stats`` the ``/debug/stats`` sections.

Device-plane telemetry: the pipeline shares the compiled limiter's
recorder (``recorder``, set by the limiter's ``set_metrics``). Each flush
records its reason, queue waits and chunk plan; each chunk its phases
(``dispatch``, ``host_cache``, ``native_lane``, ``host_stage``,
``device_sync``, ``unpack``) inside a ``device_batch_span``, which
carries the hot begin's native trace id and splits when the native
telemetry plane sampled that begin.

With ``metrics``, the rows this pipeline decides count into
``authorized_calls``, ``authorized_hits`` and ``limited_calls`` as the
JAX pipeline counts them: the hot lane's begin-time OK aggregates and
finish aggregates (C side), the cached lane's plans, the miss lane's
namespaces (the first failing hit names the limit) and the exact path.
The CEL label map of ``--metric-labels`` is not evaluated here (its
labels stay empty for these rows, as in the JAX package).

Admission: with a controller on the compiled limiter's storage, each
chunk launch takes a breaker token; while the breaker is not closed every
raw request takes the exact per-request path, whose storage call decides
on the host failover oracle (the hot lane and the columnar begin never
run, so nothing launches on the dead plane; leases stay as they are);
and ``fail_over_queued`` (a trip) sends every queued request down that
path and fails every dispatched chunk.

The native ingress (``native/ingress.py``) enters through
``lane_code_templates`` (the (status, payload) answered for each hot-lane
outcome code) and ``_begin_batch_coded_ptrs`` (the coded begin over the
ingress's take buffers, where only miss and slow rows become Python
bytes); its collect is ``_finish_namespace``, as the submit path's.

Left out of the port for now (``ROADMAP.md``): the pod fast path
(``attach_pod``, the foreign-row lane and the bulk forwards, with the
``pod_*`` families).
"""

from __future__ import annotations

import asyncio
import contextvars
import ctypes
import logging
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.counter import Counter
from ..core.limit import Namespace
from ..observability.device_plane import current_request_id
from ..observability.tracing import device_batch_span, tracing_enabled
from ..ops import kernel as K
from ..storage.base import StorageError
from ..storage.gcra import device_eligible, emission_interval_ms
from .. import native
from .batcher import ChunkPlanner, chunk_queue_wait
from .compiler import NamespaceCompiler
from .pipeline import CompiledTorchLimiter
from .plan_cache import (
    PLAN_KERNEL,
    PLAN_OK,
    PLAN_UNKNOWN,
    DecisionPlan,
    DecisionPlanCache,
)
from .storage import TorchStorage

log = logging.getLogger("limitador_tpu_torch")

__all__ = ["NativeRlsPipeline"]


class _NsPlan:
    """Per-namespace compiled plan bound to the native interner."""

    __slots__ = ("namespace", "compiler", "limits_meta")

    def __init__(self, namespace: Namespace, compiler: NamespaceCompiler, hp):
        self.namespace = namespace
        self.compiler = compiler
        # per vectorized limit: (limit_token, max, window_s, name, limit,
        # name_token). The token is interned from the limit's stable
        # identity: compile order must NOT leak into native slot keys, or
        # a reload that reorders limits would alias counters (plans
        # rebuild, the native slot map does not). name_token feeds the hot
        # lane's limited-call aggregation (-1 = unnamed limit).
        self.limits_meta = [
            (
                hp.intern("limit\x00" + repr(cl.limit._identity)),
                cl.limit.max_value,
                cl.limit.window_seconds,
                cl.limit.name,
                cl.limit,
                hp.intern(cl.limit.name) if cl.limit.name else -1,
            )
            for cl in compiler.limits
        ]


class _SubmitShard:
    """Per-event-loop serving state: the pending queue one loop's
    handlers append to, plus that loop's flush task and in-flight
    bookkeeping. The device lane behind every shard is shared and ordered
    by the storage lock."""

    __slots__ = ("loop", "pending", "flush_task", "sem", "inflight",
                 "inflight_batches", "batch_seq")

    def __init__(self, loop, max_inflight: int):
        self.loop = loop
        #: (blob, future, t_enqueue, request id)
        self.pending: List[tuple] = []
        self.flush_task: Optional[asyncio.Task] = None
        self.sem = asyncio.Semaphore(max_inflight)
        self.inflight: set = set()
        # seq -> the pending tuples of a dispatched-but-uncollected
        # chunk, so that a breaker trip can fail them off the dead plane
        self.inflight_batches: Dict[int, list] = {}
        self.batch_seq = 0


class NativeRlsPipeline:
    """Owns the native context and decides batches of raw RLS blobs.

    ``submit(blob)`` returns a future resolving to the serialized
    RateLimitResponse bytes (await it from any serving loop).
    """

    OK_BLOB: bytes
    OVER_BLOB: bytes
    UNKNOWN_BLOB: bytes
    #: decide_many marker for rows whose counter allocation failed
    #: (transient storage error; answer UNAVAILABLE)
    STORAGE_ERROR: object

    def __init__(
        self,
        limiter: CompiledTorchLimiter,
        metrics=None,
        max_delay: float = 0.0005,
        max_batch: int = 8192,
        max_inflight: int = 2,
        plan_cache_size: int = 1 << 16,
        hot_lane: Optional[bool] = None,
        dispatch_chunk: Optional[int] = None,
    ):
        from ..server.proto import rls_pb2

        self._pb = rls_pb2
        self.OK_BLOB = rls_pb2.RateLimitResponse(
            overall_code=rls_pb2.RateLimitResponse.OK
        ).SerializeToString()
        self.OVER_BLOB = rls_pb2.RateLimitResponse(
            overall_code=rls_pb2.RateLimitResponse.OVER_LIMIT
        ).SerializeToString()
        self.UNKNOWN_BLOB = rls_pb2.RateLimitResponse(
            overall_code=rls_pb2.RateLimitResponse.UNKNOWN
        ).SerializeToString()

        self.limiter = limiter
        #: the AsyncTorchStorage whose ``admission`` gates this pipeline
        self._torch = limiter._torch
        self.storage: TorchStorage = limiter._torch.inner
        #: PrometheusMetrics the decided rows count into (None: no counts)
        self.metrics = metrics
        if metrics is not None and metrics.custom_label_names:
            log.warning(
                "--metric-labels values are not evaluated on the native "
                "columnar path; custom labels stay empty for the requests "
                "it serves (--pipeline compiled evaluates them)")
        self.max_delay = max_delay
        self.max_batch = max_batch
        #: concurrent dispatched-but-uncollected batches PER SHARD
        self.max_inflight = max_inflight
        # None = chunks auto-sized from the observed device time per
        # hit, 0 = monolithic, > 0 = fixed rows per chunk
        self.chunk_planner = ChunkPlanner(dispatch_chunk)
        self._recorder = None
        # host_cache / native_lane splits of the last begin, read by
        # _timed_begin_batch on the same dispatch thread
        self._last_host_cache = 0.0
        self._last_native_lane = 0.0

        # Raises BuildError when the host lane cannot be built.
        self.hp = native.HostPath()
        self._interner = self.hp.as_interner()
        self._tracked: Dict[str, int] = {}
        self._plans: Dict[int, Optional[_NsPlan]] = {}  # domain token -> plan
        # Hot-descriptor decision-plan cache: raw blob -> DecisionPlan.
        # Epoch-guarded (invalidate() bumps) and slot-coherent (the slot
        # table's release hook drops plans pinning a recycled slot).
        self.plan_cache: Optional[DecisionPlanCache] = (
            DecisionPlanCache(plan_cache_size) if plan_cache_size > 0
            else None
        )
        self._shards: Dict[object, _SubmitShard] = {}
        self._shards_lock = threading.Lock()
        # Dispatch serializes host phases (the C++ context and the slot
        # path are single-threaded by design); collects may overlap.
        self._dispatch_pool = ThreadPoolExecutor(
            1, thread_name_prefix="native-dispatch"
        )
        self._collect_pool = ThreadPoolExecutor(
            max(max_inflight, 2), thread_name_prefix="native-collect"
        )
        # The C++ context is single-threaded by design; overlapping
        # begins serialize here.
        self._native_lock = threading.Lock()
        #: rebuild the native context when the interner exceeds this many
        #: distinct strings (high-cardinality values must not grow RSS
        #: without bound; device counters are keyed by the Python table, so
        #: a rebuild only costs re-warming the caches).
        self.max_interned = 4 << 20
        # Eviction coherence: python slot release -> native map removal,
        # and -> plan-cache invalidation (a cached plan must never pin a
        # recycled slot).
        self.storage._table.on_native_release = self.hp.slots_remove
        if self.plan_cache is not None:
            self.storage._table.on_slot_release = (
                self.plan_cache.invalidate_slot
            )
            self.storage._table.on_clear = self.plan_cache.bump_epoch
        self._hot_lane = None
        #: quota-lease broker, attached by ``attach_lease``; None = the
        #: lease tier is off.
        self.lease_broker = None
        #: cumulative lane stats carried across interner-recycle context
        #: swaps (the mirror dies with its context).
        self._lane_stats_base: Dict[str, int] = {}
        if hot_lane is None or hot_lane:
            if self.plan_cache is None:
                raise RuntimeError(
                    "the native hot lane mirrors the decision-plan cache; "
                    "plan_cache_size must be > 0 with the hot lane on"
                )
            if not native.lane_available():
                raise RuntimeError(
                    "the native host lane library lacks the hot-lane "
                    "exports"
                )
            self._hot_lane = self.hp.hot_lane(
                self.storage._scratch, cap=max(4 * max_batch, 1 << 14),
                max_rows=max(max_batch, 1 << 12),
            )
            self.plan_cache.add_mirror(self._hot_lane)

    @property
    def recorder(self):
        """The device-plane recorder, shared with the compiled limiter
        (whose ``set_metrics`` may run after this pipeline is built).
        Memoized on first sight, so the per-request gate in ``submit``
        is one attribute read."""
        rec = self._recorder
        if rec is None:
            rec = self.limiter.recorder
            if rec is not None:
                self._recorder = rec
        return rec

    @property
    def _pending(self):
        """Aggregate pending queue across serving shards (the
        ``/debug/stats`` queue depth)."""
        out: list = []
        for shard in list(self._shards.values()):
            out.extend(shard.pending)
        return out

    # -- plan management ----------------------------------------------------

    def invalidate(self) -> None:
        """Limits changed: drop all namespace plans (rebuilt lazily) and
        orphan every cached decision plan (epoch bump)."""
        self._plans.clear()
        if self.plan_cache is not None:
            self.plan_cache.bump_epoch()

    def lane_stats(self) -> dict:
        """Cumulative native hot-lane stats (C plan mirror + staging),
        carried across interner-recycle context swaps. Serialized under
        the native lock: begins mutate the C counters with the GIL
        released, and a recycle frees the context."""
        if self._hot_lane is None:
            return {}
        with self._native_lock:
            lane = self._hot_lane
            if lane is None:
                return {}
            stats = lane.stats()
            base = self._lane_stats_base
            return {
                key: stats[key] + base.get(key, 0)
                for key in ("hits", "misses", "staged_hits", "insertions",
                            "invalidations", "overflows")
            } | {"plans": stats["plans"], "epoch": stats["epoch"]}

    def plan_cache_stats(self) -> dict:
        return self.plan_cache.stats() if self.plan_cache is not None else {}

    def library_stats(self) -> dict:
        """Metrics poll surface for the plan_cache_*, native_lane_* and
        lease_* families."""
        out = dict(self.plan_cache_stats())
        lane_stats = self.lane_stats()
        if lane_stats:
            out.update({
                "native_lane_rows": lane_stats["hits"],
                "native_lane_misses": lane_stats["misses"],
                "native_lane_staged_hits": lane_stats["staged_hits"],
                "native_lane_invalidations": lane_stats["invalidations"],
                "native_lane_overflows": lane_stats["overflows"],
                "native_lane_plans": lane_stats["plans"],
            })
        if self.lease_broker is not None:
            out.update(self.lease_broker.stats())
        return out

    def lease_stats(self) -> dict:
        """Lease-tier debug surface (/debug/stats ``lease`` section);
        empty when the tier is off."""
        broker = self.lease_broker
        if broker is None:
            return {}
        out = broker.stats()
        out["leases"] = len(broker._leases)
        return out

    @property
    def hot_lane_active(self) -> bool:
        return self._hot_lane is not None

    # -- quota leasing (lease/broker.py) -------------------------------------

    def attach_lease(self, config=None, autostart: bool = True):
        """Stand up the quota-lease tier on this pipeline: a LeaseBroker
        that grants pre-debited token batches to hot mirrored plans, so
        repeat descriptors with live tokens are admitted in the C hot
        lane with zero device work. Requires the hot lane (the C mirror
        holds the balances). Epoch bumps wake the broker through the
        plan cache's hook so reload-stranded tokens settle promptly."""
        from ..lease import LeaseBroker

        if self._hot_lane is None:
            raise RuntimeError(
                "lease tier requires the native hot lane (plan mirror)"
            )
        if not native.lease_available():
            raise RuntimeError(
                "the native host lane library lacks the lease exports"
            )
        if self.lease_broker is not None:
            return self.lease_broker
        broker = LeaseBroker(self, config)
        self.lease_broker = broker
        with self._native_lock:
            broker.attach_lane(self._hot_lane)
        self.plan_cache.on_epoch_bump = broker.poke
        if autostart:
            broker.start()
        return broker

    def drain_leased_usage(self) -> Dict[int, int]:
        """Per-SLOT counts of admissions answered from live leases since
        the last drain, for the usage observatory: leased rows never
        reach the device's hit accumulator. The C side reports per-plan
        (blob, count); each count lands on EVERY slot of the plan, the
        per-hit accounting a kernel row would have produced. A plan the
        Python cache has since evicted drops its counts (bounded by one
        drain interval)."""
        lane = self._hot_lane
        cache = self.plan_cache
        if lane is None or cache is None:
            return {}
        out: Dict[int, int] = {}
        with self._native_lock:
            if self._hot_lane is not lane:
                return {}
            drained = lane.usage_drain()
            if not drained:
                return {}
            entries = cache.entries
            for blob, count in drained:
                plan = entries.get(blob)
                if plan is None:
                    continue
                for slot in plan.slots:
                    out[slot] = out.get(slot, 0) + count
        return out

    def outstanding_lease_debit(self) -> Dict[int, int]:
        """Per-slot outstanding leased debit from the broker ledger;
        empty with the tier off."""
        broker = self.lease_broker
        if broker is None:
            return {}
        return broker.outstanding_by_slot()

    def lane_code_templates(self) -> Optional[dict]:
        """(grpc status, payload) per hot-lane outcome code, for the
        native ingress's coded respond; None with the lane off (the
        ingress then answers row by row)."""
        if self._hot_lane is None:
            return None
        return {
            native.LANE_OK: (0, self.OK_BLOB),
            native.LANE_UNKNOWN: (0, self.UNKNOWN_BLOB),
            native.LANE_OVER: (0, self.OVER_BLOB),
        }

    def _plan_for(self, domain_token: int) -> Optional[_NsPlan]:
        plan = self._plans.get(domain_token, _MISSING_PLAN)
        if plan is not _MISSING_PLAN:
            return plan
        namespace = Namespace.of(self.hp.string(domain_token))
        limits = self.limiter.get_limits(namespace)
        compiler = NamespaceCompiler(limits, interner=self._interner)
        native_ok = compiler.fully_vectorized and all(
            # Limits the storage would route to its exact host path
            # (beyond-device-cap values, non-ms-tick buckets) bypass the
            # columnar kernel: such namespaces take the exact path.
            (
                limit.max_value <= K.MAX_VALUE_CAP
                if limit.policy == "fixed_window"
                else device_eligible(
                    limit.max_value, limit.seconds,
                    K.MAX_VALUE_CAP, K.WINDOW_MS_CAP,
                )
            )
            for limit in limits
        )
        if not limits or not native_ok:
            # Exact path (or no limits -> cheap OK through an empty plan).
            plan = _NsPlan(namespace, compiler, self.hp) if not limits else None
        else:
            plan = _NsPlan(namespace, compiler, self.hp)
            for cl in compiler.limits:
                for key in cl.var_keys:
                    self._track(key)
                for m in cl.mask:
                    for key in m.keys:
                        self._track(key)
        self._plans[domain_token] = plan
        return plan

    def _track(self, key: str) -> None:
        if key not in self._tracked:
            self._tracked[key] = self.hp.track(key)

    # -- submission ----------------------------------------------------------

    def _shard_for(self, loop) -> _SubmitShard:
        shard = self._shards.get(loop)
        if shard is not None:
            return shard
        with self._shards_lock:
            shard = self._shards.get(loop)
            if shard is None:
                # Prune shards whose loop died.
                for dead in [l for l in self._shards if l.is_closed()]:
                    del self._shards[dead]
                shard = _SubmitShard(loop, self.max_inflight)
                self._shards[loop] = shard
            return shard

    def submit(self, blob: bytes) -> "asyncio.Future":
        """Enqueue one raw request on the calling loop's serving shard;
        returns the future of its response bytes. A request costs one
        future and one list append before the batch machinery takes
        over."""
        loop = asyncio.get_running_loop()
        shard = self._shards.get(loop)
        if shard is None:
            shard = self._shard_for(loop)
        future = loop.create_future()
        adm = self._torch.admission
        if adm is not None and adm.use_failover():
            # Breaker open: the exact per-request path, whose storage
            # call decides on the host failover oracle.
            _spawn_detached(self._decide_exact(blob, future))
            return future
        shard.pending.append((
            blob, future, time.perf_counter(),
            current_request_id() if self.recorder is not None else None,
        ))
        task = shard.flush_task
        if task is None or task.done():
            shard.flush_task = _spawn_detached(self._flush_soon(shard))
        if len(shard.pending) == self.max_batch:
            # == not >=: one size-flush per threshold crossing.
            _spawn_detached(self._flush(shard, "size"))
        return future

    async def _flush_soon(self, shard: _SubmitShard) -> None:
        await asyncio.sleep(self.max_delay)
        await self._flush(shard)
        if shard.pending:
            shard.flush_task = _spawn_detached(self._flush_soon(shard))

    async def _flush(
        self, shard: _SubmitShard, reason: Optional[str] = None
    ) -> None:
        batch, shard.pending = shard.pending, []
        if not batch:
            return
        loop = asyncio.get_running_loop()
        rec = self.recorder
        t_flush = time.perf_counter()
        batch_id = 0
        if rec is not None:
            batch_id = rec.next_batch_id()
            rec.record_flush(
                reason or (
                    "size" if len(batch) >= self.max_batch else "deadline"
                ),
                len(batch) / self.max_batch,
                [t_flush - t for _b, _f, t, _rid in batch],
            )
        # Two phases: the host phase (lane -> parse -> masks -> slots ->
        # kernel LAUNCH) runs on the dispatch thread and returns without
        # waiting on the device; the collect phase (download -> resolve
        # futures) runs on collect threads, so batch N+1's host phase
        # overlaps batch N's device round trip. The flush is cut into
        # chunks riding the shard's in-flight window.
        adm = self._torch.admission
        ranges = self.chunk_planner.split(
            [1] * len(batch), chunk_queue_wait(adm, batch[0][2], t_flush)
        )
        if rec is not None:
            rec.record_chunks([hi - lo for lo, hi in ranges])
        # Every chunk registers as in flight BEFORE any await, so that a
        # breaker trip can fail the chunks still waiting for the window
        # (they left shard.pending at the top of this flush).
        seqs = []
        for lo, hi in ranges:
            shard.batch_seq += 1
            shard.inflight_batches[shard.batch_seq] = batch[lo:hi]
            seqs.append(shard.batch_seq)

        def _drop_rest(idx, exc):
            """Fail (and deregister) chunk idx onward: nothing may be
            left stranded when this coroutine unwinds."""
            for (l2, h2), s2 in zip(ranges[idx:], seqs[idx:]):
                shard.inflight_batches.pop(s2, None)
                for _blob, future, _t, _rid in batch[l2:h2]:
                    if not future.done():
                        future.set_exception(exc)

        failed = None
        for ci, ((lo, hi), seq) in enumerate(zip(ranges, seqs)):
            sub = batch[lo:hi]
            if failed is not None:
                shard.inflight_batches.pop(seq, None)
                for _blob, future, _t, _rid in sub:
                    if not future.done():
                        future.set_exception(failed)
                continue
            try:
                await shard.sem.acquire()
            except BaseException as exc:
                _drop_rest(ci, exc)
                raise
            t_submit = time.perf_counter()
            token = adm.breaker.batch_started() if adm is not None else 0
            try:
                ((results, slow_rows, pendings), t_begin, t_staged,
                 t_cache, t_lane) = await loop.run_in_executor(
                    self._dispatch_pool, self._timed_begin_batch,
                    [b for b, _f, _t, _rid in sub],
                )
            except BaseException as exc:
                shard.sem.release()
                if adm is not None:
                    adm.breaker.batch_finished(token, exc)
                if not isinstance(exc, Exception):
                    _drop_rest(ci, exc)
                    raise
                shard.inflight_batches.pop(seq, None)
                for _blob, future, _t, _rid in sub:
                    if not future.done():
                        future.set_exception(exc)
                failed = exc
                continue
            # Rows the columnar path can't take: exact per-request path.
            for r in slow_rows:
                blob, future, _t, _rid = sub[r]
                _spawn_detached(self._decide_exact(blob, future))
            phases = {
                "dispatch": t_begin - t_submit,
                "host_cache": t_cache,
                "native_lane": t_lane,
                "host_stage": (t_staged - t_begin) - t_cache - t_lane,
            }
            task = loop.run_in_executor(
                self._collect_pool, self._finish_batch, sub, results,
                pendings, batch_id, t_flush, phases,
            )
            shard.inflight.add(task)

            def _collected(t, seq=seq, token=token, sub=sub):
                shard.inflight.discard(t)
                shard.inflight_batches.pop(seq, None)
                shard.sem.release()
                exc = t.exception()
                if adm is not None:
                    adm.breaker.batch_finished(token, exc)
                if exc is not None:
                    for _blob, future, _t, _rid in sub:
                        if not future.done():
                            future.set_exception(exc)

            task.add_done_callback(_collected)

    # -- the columnar fast path ----------------------------------------------

    def _recycle_context_if_needed(self) -> None:
        """Interner past the cap: swap in a fresh native context. Slot-map
        entries repopulate lazily through the Python key space. Decision
        plans survive: they pin Python-table slot indices and response
        templates, neither of which the interner owns."""
        if self.hp.interned_count() <= self.max_interned:
            return
        old = self.hp
        old_lane = self._hot_lane
        self.hp = native.HostPath()
        self._interner = self.hp.as_interner()
        self._tracked = {}
        self._plans = {}
        # The storage lock spans the swap AND the free: slot-release
        # hooks fan out to the mirror list under this same lock, so no
        # release can reach the old lane's context after hp_free.
        # In-flight pendings keep the OLD lane object; its finish pass is
        # context-free, so it survives the close.
        with self.storage._lock:
            if old_lane is not None:
                # The mirror dies with its context: fold its cumulative
                # stats into the carried base and stand up a fresh lane.
                stats = old_lane.stats()
                base = self._lane_stats_base
                for key in ("hits", "misses", "staged_hits", "insertions",
                            "invalidations", "overflows"):
                    base[key] = base.get(key, 0) + stats[key]
                self.plan_cache.remove_mirror(old_lane)
                self._hot_lane = self.hp.hot_lane(
                    self.storage._scratch, cap=old_lane.cap,
                    max_rows=old_lane.max_rows,
                )
                self.plan_cache.add_mirror(self._hot_lane)
                if self.lease_broker is not None:
                    # Leases die with the old mirror: reclaim and credit
                    # them before the context is freed, then re-arm the
                    # fresh lane's consume path.
                    self.lease_broker.on_context_swap(old_lane)
                    self.lease_broker.attach_lane(self._hot_lane)
            self.storage._table.native_keys.clear()
            self.storage._table.on_native_release = self.hp.slots_remove
            old.close()

    def decide_many(
        self, blobs: List[bytes], chunk: int = 8192, inflight: int = 8,
    ) -> List[Optional[bytes]]:
        """Synchronous bulk engine path: raw request blobs in, response
        blobs out, zero per-request asyncio. ``None`` marks rows the
        columnar path can't take (multi-descriptor requests, namespaces
        needing the exact path): feed those through ``submit``. Rows
        whose counter allocation failed come back as the
        ``STORAGE_ERROR`` sentinel. Up to ``inflight`` chunks are
        launched before the oldest is collected; admission stays exact
        because launches are ordered on the storage stream."""
        out: List[Optional[bytes]] = []
        window: deque = deque()  # (results, pendings, codes)
        lane = self._hot_lane
        # codes -> response template; LANE_MISS/LANE_KERNEL resolve via
        # ``results`` (bytes, STORAGE_ERROR, or None = slow).
        lut = np.array(
            [None, None, self.OK_BLOB, self.UNKNOWN_BLOB, self.OVER_BLOB,
             _STORAGE_ERROR],
            object,
        )

        def collect_oldest():
            results, pendings, codes = window.popleft()
            for p in pendings:
                self._finish_namespace(p, results)
            if codes is None:
                out.extend(results)
                return
            vals = lut[codes]
            low = np.nonzero(codes < native.LANE_OK)[0]
            if low.size:  # miss-lane rows answer from results
                for i in low.tolist():
                    vals[i] = results[i]
            out.extend(vals.tolist())

        for ofs in range(0, len(blobs), chunk):
            part = blobs[ofs:ofs + chunk]
            with self._native_lock:
                if lane is not None:
                    # The hot lane moves the repeat-descriptor work (plan
                    # lookup, staging, response codes) into ONE GIL-free
                    # C call.
                    results, _slow, pendings, codes = (
                        self._begin_batch_coded_locked(part, use_cache=True)
                    )
                else:
                    # Lane off: skip the plan cache; its per-row Python
                    # lookups lose to the vectorized parse lane at these
                    # chunk sizes.
                    results, _slow, pendings = self._begin_batch_locked(
                        part, use_cache=False
                    )
                    codes = None
            window.append((results, pendings, codes))
            if len(window) > max(inflight, 1):
                collect_oldest()
        while window:
            collect_oldest()
        return out

    def _begin_batch(self, blobs: List[bytes]):
        with self._native_lock:
            return self._begin_batch_locked(blobs)

    def _begin_batch_coded_ptrs(self, ptrs, lens, n: int):
        """The ingress pump's begin: the batch stays in the take buffers
        (ctypes pointer and length arrays), so that a repeat descriptor
        runs no Python per row between the pump and the launch. Returns
        (codes, results, slow_rows, pendings); the hot lane must be on
        (the pump asks ``lane_code_templates`` first)."""
        if self._hot_lane is None:
            raise RuntimeError("native hot lane is off")
        with self._native_lock:
            results, slow_rows, pendings, codes = (
                self._begin_batch_coded_locked(
                    None, True, ptrs=ptrs, lens=lens, count=n
                )
            )
        return codes, results, slow_rows, pendings

    def _timed_begin_batch(self, blobs: List[bytes]):
        """(begin result, t_start, t_end, host_cache_s, native_lane_s):
        the dispatch thread's host phase with its plan-cache and hot-lane
        splits, read right after the begin on the same thread (a
        concurrent ``decide_many`` can skew the split, never the
        results)."""
        t_start = time.perf_counter()
        out = self._begin_batch(blobs)
        return (out, t_start, time.perf_counter(), self._last_host_cache,
                self._last_native_lane)

    def _begin_batch_locked(self, blobs: List[bytes], use_cache: bool = True):
        """Host phase, bytes-resolving form: the coded begin below plus
        response bytes for the rows the hot lane decided at begin time
        (the future-resolving submit path wants ``results`` rows, not
        codes). Hot kernel rows fill at finish (``fill_results``)."""
        results, slow_rows, pendings, codes = self._begin_batch_coded_locked(
            blobs, use_cache
        )
        if codes is not None:
            ok_blob, unknown_blob = self.OK_BLOB, self.UNKNOWN_BLOB
            for r in np.nonzero(codes == native.LANE_OK)[0].tolist():
                results[r] = ok_blob
            for r in np.nonzero(codes == native.LANE_UNKNOWN)[0].tolist():
                results[r] = unknown_blob
            for pending in pendings:
                if type(pending) is _HotPending:
                    pending.staged.fill_results = True
        return results, slow_rows, pendings

    def _begin_batch_coded_locked(
        self, blobs: Optional[List[bytes]], use_cache: bool = True,
        ptrs=None, lens=None, count: Optional[int] = None,
    ):
        """Host phase: hot-lane (or plan-cache) lookup, then
        parse/group/evaluate/slots for the misses, LAUNCH kernels for
        every staged lane. Returns (results, slow_rows, pendings, codes):

        - ``codes`` is the hot lane's per-row outcome column
          (native.LANE_*; None when the lane is off). Rows the lane
          decided stay None in ``results``.
        - the miss lane fills ``results`` rows directly (bytes /
          STORAGE_ERROR); slow_rows lists exact-path rows (left None).
        - ``blobs`` is None when ``ptrs``/``lens``/``count`` address the
          batch in place (the ingress's take buffers, hot lane on): only
          miss rows become Python bytes then.

        ``use_cache=False`` (the lane-off bulk path) skips lane, lookup
        and insertion. Callers hold ``_native_lock``."""
        n = count if blobs is None else len(blobs)
        adm = self._torch.admission
        if adm is not None and adm.use_failover():
            # Breaker open: every row takes the exact path (whose storage
            # call decides on the failover oracle); the columnar path
            # would launch kernels on the dead plane.
            self._last_host_cache = 0.0
            self._last_native_lane = 0.0
            return [None] * n, list(range(n)), [], None
        self._recycle_context_if_needed()
        results: List[Optional[bytes]] = [None] * n
        pendings: list = []
        slow_rows: List[int] = []

        cache = self.plan_cache if use_cache else None
        # Epoch snapshot BEFORE any plan derivation: inserts check it, so
        # a limits bump racing this batch on another thread discards the
        # then-stale plans instead of filing them under the new epoch.
        cache_epoch = cache.epoch if cache is not None else 0
        lane = self._hot_lane if use_cache else None
        codes = None
        miss_idx: List[int] = []
        self._last_host_cache = 0.0
        self._last_native_lane = 0.0
        if lane is not None:
            # ---- lane 0: the zero-Python hot lane -----------------------
            # One GIL-free C call covers plan lookup, columnar staging
            # into the lane's buffers (padding included) and begin-time
            # response codes; the storage lock spans lookup -> launch so
            # a concurrent LRU eviction cannot recycle a plan-pinned slot
            # in between. begin_check_columnar copies the staged columns
            # before the lock is released: the next begin reuses them.
            t_lane0 = time.perf_counter()
            with self.storage._lock:
                if blobs is not None:
                    staged = lane.begin(blobs, cache_epoch)
                else:
                    staged = lane.begin_ptrs(ptrs, lens, n, cache_epoch)
                staged.fill_results = False
                if staged.k:
                    inflight = self.storage.begin_check_columnar(
                        *lane.kernel_columns(staged.H)
                    )
                    pendings.append(_HotPending(staged, lane, inflight))
            codes = staged.codes
            self._last_native_lane = time.perf_counter() - t_lane0
            if staged.ok_aggr and self.metrics is not None:
                for ns, calls, hits in lane.ok_aggr_strings(staged.ok_aggr):
                    self.metrics.incr_authorized_calls(ns, n=calls)
                    self.metrics.incr_authorized_hits(ns, hits)
            miss_mask = codes == native.LANE_MISS
            n_miss = int(miss_mask.sum())
            # The mirror IS the decision-plan cache's lookup half when
            # the lane is on: account its hit/miss traffic there too.
            cache.count(n - n_miss, n_miss)
            if n_miss == 0:
                return results, slow_rows, pendings, codes
            miss_idx = np.nonzero(miss_mask)[0].tolist()
            if blobs is None:
                # Pointer-addressed batch: only the miss rows become
                # Python bytes (the hot rows never do).
                blobs = {i: ctypes.string_at(ptrs[i], lens[i])
                         for i in miss_idx}
            return self._begin_miss_lane(
                blobs, n, miss_idx, results, slow_rows, pendings, codes,
                cache, cache_epoch, lane,
            )

        # ---- lane 1: the hot-descriptor plan cache (pure Python) --------
        t_cache0 = time.perf_counter()
        if cache is not None:
            cached_rows: List[Tuple[int, DecisionPlan]] = []
            ok_blob = self.OK_BLOB
            unknown_blob = self.UNKNOWN_BLOB
            miss_append = miss_idx.append
            hit_append = cached_rows.append
            ok_calls: Dict[str, int] = {}
            ok_hits: Dict[str, int] = {}
            metrics = self.metrics
            # The storage lock spans lookup -> launch (slot liveness).
            with self.storage._lock:
                get = cache.entries.get
                for i, blob in enumerate(blobs):
                    plan = get(blob)
                    if plan is None:
                        miss_append(i)
                    elif plan.kind == PLAN_KERNEL:
                        hit_append((i, plan))
                    elif plan.kind == PLAN_OK:
                        results[i] = ok_blob
                        ns = plan.namespace
                        if ns is not None and metrics is not None:
                            ok_calls[ns] = ok_calls.get(ns, 0) + 1
                            ok_hits[ns] = ok_hits.get(ns, 0) + plan.delta
                    else:
                        results[i] = unknown_blob
                cache.count(n - len(miss_idx), len(miss_idx))
                if cached_rows:
                    pendings.append(self._begin_cached(cached_rows))
            for ns, calls in ok_calls.items():
                metrics.incr_authorized_calls(ns, n=calls)
                metrics.incr_authorized_hits(ns, ok_hits[ns])
        else:
            miss_idx = list(range(n))
        self._last_host_cache = time.perf_counter() - t_cache0
        if not miss_idx:
            return results, slow_rows, pendings, codes
        return self._begin_miss_lane(
            blobs, n, miss_idx, results, slow_rows, pendings, codes, cache,
            cache_epoch, None,
        )

    def _begin_miss_lane(
        self, blobs, n, miss_idx, results, slow_rows, pendings, codes,
        cache, cache_epoch, lane,
    ):
        """lane 2: the miss path (parse -> masks -> slots -> launch).
        ``miss_idx`` rows of the batch are parsed, derived, launched and
        memoized (Python cache + C mirror when ``lane`` is active).
        ``blobs`` is the batch's list, or a dict holding the miss rows
        alone (a pointer-addressed batch)."""
        if isinstance(blobs, list) and len(miss_idx) == n:
            sub = blobs
        else:
            sub = [blobs[i] for i in miss_idx]
        row_map = np.asarray(miss_idx, np.int32)
        domains, hits, cols, _ndesc, extra = self.hp.parse_batch(sub)

        # Group rows by domain token (vectorized).
        unknown = domains < 0
        for r in np.nonzero(unknown)[0].tolist():
            results[miss_idx[r]] = self.UNKNOWN_BLOB
            if cache is not None:
                cache.put(sub[r], _UNKNOWN_PLAN_SINGLETON, cache_epoch)
                if lane is not None:
                    lane.plan_put(
                        sub[r], cache_epoch, native.LANE_UNKNOWN, -1, 1, 1
                    )
        slow_mask = np.logical_and(~unknown, extra > 0)
        slow_rows.extend(row_map[np.nonzero(slow_mask)[0]].tolist())
        norm_idx = np.nonzero(
            np.logical_and(~unknown, ~slow_mask)
        )[0].astype(np.int32)
        groups: List[Tuple[int, np.ndarray]] = []
        if norm_idx.size:
            toks = domains[norm_idx]
            first = int(toks[0])
            if bool((toks == first).all()):  # common case: one namespace
                groups = [(first, norm_idx)]
            else:
                order = np.argsort(toks, kind="stable")
                si, st = norm_idx[order], toks[order]
                starts = np.nonzero(
                    np.concatenate([[True], st[1:] != st[:-1]])
                )[0]
                ends = np.append(starts[1:], st.size)
                groups = [
                    (int(st[a]), si[a:b]) for a, b in zip(starts, ends)
                ]

        for token, rows in groups:
            plan = self._plan_for(token)
            if plan is None:
                # results stay None (slow)
                slow_rows.extend(row_map[rows].tolist())
                continue
            if not plan.limits_meta:
                for r in rows.tolist():
                    results[miss_idx[r]] = self.OK_BLOB
                    if cache is not None:
                        cache.put(
                            sub[r], _FREE_OK_PLAN_SINGLETON, cache_epoch
                        )
                        if lane is not None:
                            lane.plan_put(
                                sub[r], cache_epoch, native.LANE_OK, -1,
                                1, 1,
                            )
                continue
            pending = self._begin_namespace(
                plan, token, rows, hits, cols, results, sub, row_map,
                cache, cache_epoch, lane,
            )
            if pending is not None:
                pendings.append(pending)
        return results, slow_rows, pendings, codes

    def _begin_cached(self, cached_rows) -> "_CachedPending":
        """Stage and launch the plan-cache lane: rows grouped by hit
        arity so a whole group's kernel columns come from ONE
        ``np.array`` over the plans' flat int records. Kernel request ids
        follow BATCH ROW ORDER (one stable argsort restores it after the
        arity-grouped conversion): rows of this lane contending on one
        counter admit in arrival order, byte-identical to the C hot
        lane's staging. Caller holds the storage lock."""
        by_n: Dict[int, list] = {}
        for pos, pair in enumerate(cached_rows):
            by_n.setdefault(pair[1].nhits, []).append((pos, pair[1]))
        slots_p: List[np.ndarray] = []
        deltas_p: List[np.ndarray] = []
        maxes_p: List[np.ndarray] = []
        windows_p: List[np.ndarray] = []
        bucket_p: List[np.ndarray] = []
        req_p: List[np.ndarray] = []
        for nh in sorted(by_n):
            group = by_n[nh]
            k = len(group)
            rec = np.array(
                [p.record for _pos, p in group], np.int32
            ).reshape(k, nh, 4)
            slots_p.append(rec[:, :, 0].ravel())
            maxes_p.append(rec[:, :, 1].ravel())
            windows_p.append(rec[:, :, 2].ravel())
            bucket_p.append(rec[:, :, 3].ravel().astype(bool))
            deltas_p.append(np.repeat(
                np.array([p.delta_capped for _pos, p in group], np.int32),
                nh,
            ))
            req_p.append(np.repeat(
                np.array([pos for pos, _p in group], np.int32), nh
            ))
        slots = np.concatenate(slots_p)
        deltas = np.concatenate(deltas_p)
        maxes = np.concatenate(maxes_p)
        windows = np.concatenate(windows_p)
        req = np.concatenate(req_p)
        bucket = np.concatenate(bucket_p)
        if req.size and not bool((req[:-1] <= req[1:]).all()):
            # restore batch row order (kernel req_ids must be
            # nondecreasing; same-request hits stay contiguous under the
            # stable sort)
            order = np.argsort(req, kind="stable")
            slots, deltas, maxes = slots[order], deltas[order], maxes[order]
            windows, req, bucket = windows[order], req[order], bucket[order]
        nhits = slots.shape[0]
        arrays = self.storage.pad_hits(
            (slots, deltas, maxes, windows, req,
             np.zeros(nhits, bool),  # cached slots are live, never fresh
             bucket),
            nhits,
        )
        inflight = self.storage.begin_check_columnar(*arrays)
        return _CachedPending(cached_rows, inflight)

    def _finish_cached(self, pending: "_CachedPending", results) -> None:
        """Collect the plan-cache lane: fill response templates and count
        the metrics as the uncached lane does (authorized calls and hits
        per namespace; the first failing hit names the limit)."""
        admitted, hit_ok, _rem, _ttl = self.storage.finish_check_columnar(
            pending.inflight, with_remaining=False
        )
        ok_blob, over_blob = self.OK_BLOB, self.OVER_BLOB
        metrics = self.metrics
        entries = pending.entries
        admitted_l = admitted[:len(entries)].tolist()
        if metrics is None:
            for (row, _plan), ok in zip(entries, admitted_l):
                results[row] = ok_blob if ok else over_blob
            return
        ok_calls: Dict[str, int] = {}
        ok_hits: Dict[str, int] = {}
        limited: Dict[Tuple[str, Optional[str]], int] = {}
        base = 0
        for (row, plan), ok in zip(entries, admitted_l):
            if ok:
                results[row] = ok_blob
                ns = plan.namespace
                ok_calls[ns] = ok_calls.get(ns, 0) + 1
                ok_hits[ns] = ok_hits.get(ns, 0) + plan.delta
            else:
                results[row] = over_blob
                name = None
                for j in range(plan.nhits):
                    if not hit_ok[base + j]:
                        name = plan.limit_names[j]
                        break
                key = (plan.namespace, name)
                limited[key] = limited.get(key, 0) + 1
            base += plan.nhits
        for ns, calls in ok_calls.items():
            metrics.incr_authorized_calls(ns, n=calls)
            metrics.incr_authorized_hits(ns, ok_hits[ns])
        for (ns, name), count in limited.items():
            metrics.incr_limited_calls(ns, name, n=count)

    def _finish_batch(self, batch, results, pendings, batch_id: int,
                      t_flush: float, phases: dict) -> None:
        """Collect phase: block on the device results, fill the kernel-
        decided rows, resolve every settled future in ONE loop callback."""
        with device_batch_span(
            batch_id, len(batch), _native_trace_attrs(pendings)
        ) as span_phases:
            t_fin = time.perf_counter()
            for pending in pendings:
                self._finish_namespace(pending, results)
            t_done = time.perf_counter()
            phases["device_sync"] = t_done - t_fin
            self.chunk_planner.observe(phases["device_sync"], len(batch))
            # None marks slow-path rows (resolved later); UNKNOWN
            # serializes to b"" (all-default proto3), a valid response, so
            # only None is the sentinel. All futures of a shard's batch
            # live on that shard's loop.
            pairs = [
                (future, out)
                for (_blob, future, _t, _rid), out in zip(batch, results)
                if out is not None
            ]
            if pairs:
                pairs[0][0].get_loop().call_soon_threadsafe(
                    _resolve_many, pairs
                )
            phases["unpack"] = time.perf_counter() - t_done
            span_phases(phases)
            rec = self.recorder
            if rec is not None:
                rec.record_batch(
                    (
                        (t_enq, rid, None)
                        for (_blob, _future, t_enq, rid), out
                        in zip(batch, results)
                        if out is not None  # slow rows decide elsewhere
                    ),
                    batch_id, t_flush, phases,
                )

    def _begin_namespace(
        self, plan, token, rows, hits, cols, results, blobs, row_map,
        cache=None, cache_epoch=0, lane=None,
    ) -> Optional["_NsPending"]:
        """rows index into the parse arrays (the miss subset); row_map
        maps them to positions in the submitted batch, which is what
        ``results`` rows and pendings speak. ``cache`` is the decision-
        plan cache to memoize this group's rows into (None on the lane-off
        bulk path); ``lane`` additionally mirrors the plans into the C
        hot lane."""
        rows_arr = np.asarray(rows, np.int32)
        m = rows_arr.shape[0]
        grows = row_map[rows_arr]  # global (batch) row per group row
        needed = set()
        for cl in plan.compiler.limits:
            needed.update(cl.var_keys)
            for mask in cl.mask:
                needed.update(mask.keys)
        if any(k not in cols for k in needed):
            # First batch for this namespace: its keys were tracked after
            # the batch-wide parse. Re-parse just this group.
            _d, h2, cols_local, _n, _e = self.hp.parse_batch(
                [blobs[r] for r in rows]
            )
            group_cols = {k: cols_local[k] for k in needed}
            deltas_req = h2
        else:
            group_cols = {k: cols[k][rows_arr] for k in needed}
            deltas_req = hits[rows_arr]

        hit_slots: List[np.ndarray] = []
        hit_deltas: List[np.ndarray] = []
        hit_maxes: List[np.ndarray] = []
        hit_windows: List[np.ndarray] = []
        hit_req: List[np.ndarray] = []
        hit_fresh: List[np.ndarray] = []
        hit_bucket: List[np.ndarray] = []
        hit_limits: List[object] = []  # the limit of each hit_req entry
        failed_reqs: set = set()  # local idx whose allocation errored
        # per-local-row flat plan records (slot, max, win, bucket) in
        # limit compile order, grown only on the miss path
        row_recs: Dict[int, list] = {}
        row_names: Dict[int, list] = {}
        row_ntoks: Dict[int, list] = {}

        # Lookup -> (alloc misses) -> kernel under the storage lock, so a
        # concurrent LRU eviction cannot recycle a looked-up slot between
        # lookup and kernel; every slot staged is pinned until the launch,
        # so this batch's own allocations cannot recycle one either.
        with self.storage._lock, self.storage.pinning() as pinned:
            # Phase 1: evaluate + resolve slots for EVERY limit before
            # building hit arrays: a late allocation failure must void the
            # failed request's deltas on earlier limits too.
            staged = []
            for (cl, applies, var_cols), meta in zip(
                plan.compiler.evaluate_columns(group_cols, m),
                plan.limits_meta,
            ):
                limit_token, max_value, window_s, name, limit, ntok = meta
                idx = np.nonzero(applies)[0].astype(np.int32)
                if idx.size == 0:
                    continue
                k = 2 + len(var_cols)
                keys = np.empty((idx.size, k), np.int32)
                keys[:, 0] = token
                keys[:, 1] = limit_token
                for j, vc in enumerate(var_cols):
                    keys[:, 2 + j] = vc[idx]
                slots = self.hp.slots_lookup(keys)
                fresh = slots < 0
                pinned.update(slots[~fresh].tolist())
                if fresh.any():
                    self._allocate_missing(
                        limit, var_cols, idx, keys, slots, fresh, failed_reqs,
                        pinned,
                    )
                    # failed allocations leave slot -1: point them at the
                    # inert scratch cell with delta 0
                    bad = slots < 0
                    slots[bad] = self.storage._scratch
                    fresh[bad] = False
                staged.append((limit, idx, slots, fresh, max_value, window_s,
                               name, ntok))

            # Phase 2: build hit arrays with failed requests fully voided.
            for (limit, idx, slots, fresh, max_value, window_s, name,
                 ntok) in staged:
                hit_slots.append(slots.astype(np.int32))
                deltas_l = np.minimum(
                    deltas_req[idx], K.MAX_DELTA_CAP
                ).astype(np.int32)
                if failed_reqs:
                    deltas_l[np.isin(idx, list(failed_reqs))] = 0
                hit_deltas.append(deltas_l)
                hit_maxes.append(np.full(idx.size, max_value, np.int32))
                if limit.policy == "token_bucket":
                    win = emission_interval_ms(max_value, window_s)
                    is_bucket = True
                else:
                    win = min(window_s * 1000, K.WINDOW_MS_CAP)
                    is_bucket = False
                hit_windows.append(np.full(idx.size, win, np.int32))
                hit_req.append(idx)
                hit_fresh.append(fresh)
                hit_bucket.append(np.full(idx.size, is_bucket, bool))
                hit_limits.append(limit)
                if cache is not None:
                    ib = int(is_bucket)
                    mv = int(max_value)
                    slots_l = slots.tolist()
                    for pos, local in enumerate(idx.tolist()):
                        row_recs.setdefault(local, []).extend(
                            (slots_l[pos], mv, win, ib)
                        )
                        row_names.setdefault(local, []).append(name)
                        row_ntoks.setdefault(local, []).append(ntok)

            namespace = str(plan.namespace)
            if cache is not None:
                self._insert_plans(
                    cache, cache_epoch, blobs, rows_arr, deltas_req,
                    failed_reqs, row_recs, row_names, namespace, m,
                    lane, token, row_ntoks,
                )
            if not hit_slots:
                for local in range(m):
                    results[grows[local]] = self.OK_BLOB
                if self.metrics and m:
                    self.metrics.incr_authorized_calls(namespace, n=m)
                    self.metrics.incr_authorized_hits(
                        namespace, int(deltas_req.sum()))
                return None

            slots = np.concatenate(hit_slots)
            deltas = np.concatenate(hit_deltas)
            maxes = np.concatenate(hit_maxes)
            windows = np.concatenate(hit_windows)
            req = np.concatenate(hit_req)
            # where each limit's hits end in the concatenation
            limit_ends = np.cumsum([idx.size for idx in hit_req])
            fresh = np.concatenate(hit_fresh)
            bucket = np.concatenate(hit_bucket)
            # Kernel req ids must be dense in [0, H): requests without hits
            # don't participate, so compress local indices.
            order = np.argsort(req, kind="stable")
            participating, kernel_req = np.unique(
                req[order], return_inverse=True
            )
            arrays = self.storage.pad_hits(
                (slots[order], deltas[order], maxes[order], windows[order],
                 kernel_req.astype(np.int32), fresh[order], bucket[order]),
                slots.shape[0],
            )
            inflight = self.storage.begin_check_columnar(*arrays)
        return _NsPending(namespace, grows, deltas_req, failed_reqs,
                          participating, order, req[order], hit_limits,
                          limit_ends, inflight)

    def _insert_plans(
        self, cache, cache_epoch, blobs, rows_arr, deltas_req,
        failed_reqs, row_recs, row_names, namespace, m,
        lane=None, ns_token=-1, row_ntoks=None,
    ) -> None:
        """Memoize this group's miss rows: kernel plans for rows with
        resolved hits, OK plans for rows no limit applied to, into the
        Python cache and, when ``lane`` is active, the C plan mirror
        (stride-5 records: the stride-4 python record plus the limit-name
        token the hot finish aggregates limited calls by). Caller holds
        the storage lock (slot liveness)."""
        rows_l = rows_arr.tolist()
        deltas_l = deltas_req.tolist() if hasattr(
            deltas_req, "tolist") else list(deltas_req)
        for local in range(m):
            if local in failed_reqs:
                continue
            delta = int(deltas_l[local])
            recs = row_recs.get(local)
            blob = blobs[rows_l[local]]
            if recs is None:
                cache.put(blob, DecisionPlan(
                    PLAN_OK, namespace=namespace, delta=delta,
                ), cache_epoch)
                if lane is not None:
                    lane.plan_put(
                        blob, cache_epoch, native.LANE_OK, ns_token,
                        delta, min(delta, K.MAX_DELTA_CAP), ns=namespace,
                    )
            else:
                record = tuple(recs)
                cache.put(blob, DecisionPlan(
                    PLAN_KERNEL,
                    namespace=namespace,
                    delta=delta,
                    delta_capped=min(delta, K.MAX_DELTA_CAP),
                    record=record,
                    limit_names=tuple(row_names[local]),
                    slots=record[0::4],
                ), cache_epoch)
                if lane is not None:
                    ntoks = row_ntoks[local]
                    rec4 = np.asarray(recs, np.int32).reshape(-1, 4)
                    rec5 = np.empty((rec4.shape[0], 5), np.int32)
                    rec5[:, :4] = rec4
                    rec5[:, 4] = ntoks
                    lane.plan_put(
                        blob, cache_epoch, native.LANE_KERNEL, ns_token,
                        delta, min(delta, K.MAX_DELTA_CAP), rec5,
                        ns=namespace,
                        names=zip(ntoks, row_names[local]),
                    )

    def _finish_hot(self, pending: "_HotPending", results) -> None:
        """Collect the zero-Python hot lane: ONE C call turns the device
        result columns into final response codes (in place on the staged
        code column). Response bytes materialize only for the
        future-resolving submit path (``fill_results``)."""
        staged = pending.staged
        admitted, hit_ok, _rem, _ttl = self.storage.finish_check_columnar(
            pending.inflight, with_remaining=False
        )
        ok_aggr, limited = pending.lane.finish(staged, admitted, hit_ok)
        if staged.fill_results:
            ok_blob, over_blob = self.OK_BLOB, self.OVER_BLOB
            for r, a in zip(staged.rows.tolist(),
                            admitted[:staged.k].tolist()):
                results[r] = ok_blob if a else over_blob
        metrics = self.metrics
        if metrics is not None:
            for ns, calls, hits in ok_aggr:
                metrics.incr_authorized_calls(ns, n=calls)
                metrics.incr_authorized_hits(ns, hits)
            for ns, name, count in limited:
                metrics.incr_limited_calls(ns, name, n=count)

    def _finish_namespace(self, pending, results) -> None:
        """Collect one pending's device result and fill its rows (the
        miss-lane namespace pendings, the plan-cache lane and the native
        hot lane)."""
        if type(pending) is _HotPending:
            self._finish_hot(pending, results)
            return
        if type(pending) is _CachedPending:
            self._finish_cached(pending, results)
            return
        admitted, hit_ok, _rem, _ttl = self.storage.finish_check_columnar(
            pending.inflight, with_remaining=False
        )
        # Requests without hits default to admitted (no counter applied).
        rows_list = pending.rows.tolist()
        failed_reqs = pending.failed_reqs
        admitted_full = np.ones(len(rows_list), bool)
        admitted_full[pending.participating] = admitted[
            : pending.participating.size
        ]
        ok_blob, over_blob = self.OK_BLOB, self.OVER_BLOB
        for r, a in zip(rows_list, admitted_full.tolist()):
            results[r] = ok_blob if a else over_blob
        for local in failed_reqs:
            results[rows_list[local]] = _STORAGE_ERROR
        metrics = self.metrics
        if not metrics:
            return
        namespace = pending.namespace
        ok_mask = admitted_full
        if failed_reqs:
            ok_mask = admitted_full.copy()
            ok_mask[sorted(failed_reqs)] = False
        n_ok = int(ok_mask.sum())
        if n_ok:
            metrics.incr_authorized_calls(namespace, n=n_ok)
            metrics.incr_authorized_hits(
                namespace, int(pending.deltas_req[ok_mask].sum()))
        limited = ~admitted_full
        if failed_reqs:
            limited[sorted(failed_reqs)] = False
        if not limited.any():
            return
        # The first failing hit in request order names the limit. Hits
        # run in request order, each request's in its limits' order, so
        # it is each request's lowest failing position.
        req_sorted = pending.req_sorted
        h = req_sorted.size
        failing = np.nonzero(~hit_ok[:h])[0]
        first = np.full(limited.size, h, np.int64)
        np.minimum.at(first, req_sorted[failing], failing)
        first = first[limited]
        named = first < h
        counts: Dict[Optional[str], int] = {}
        if not named.all():
            counts[None] = int((~named).sum())
        which, n = np.unique(
            np.searchsorted(pending.limit_ends, pending.order[first[named]],
                            side="right"),
            return_counts=True,
        )
        for i, c in zip(which.tolist(), n.tolist()):
            name = pending.hit_limits[i].name
            counts[name] = counts.get(name, 0) + c
        for name, c in counts.items():
            metrics.incr_limited_calls(namespace, name, n=c)

    def _allocate_missing(
        self, limit, var_cols, idx, keys, slots, fresh_mask, failed_reqs,
        pinned,
    ) -> None:
        """Slot-map misses: allocate through the storage's key space (so
        LRU/eviction bookkeeping stays authoritative), pin the slot for
        this launch and mirror it into the native map. A per-counter
        StorageError fails only its own request (recorded in
        ``failed_reqs``), never the batch. Caller holds the storage
        lock."""
        var_sources = [v.source for v in limit.variables]
        storage = self.storage
        for pos in np.nonzero(fresh_mask)[0]:
            set_vars = {
                src: self.hp.string(int(var_cols[j][idx[pos]]))
                for j, src in enumerate(var_sources)
            }
            counter = Counter(limit, set_vars)
            try:
                slot, is_fresh = storage._slot_for(counter, create=True)
            except StorageError:
                failed_reqs.add(int(idx[pos]))
                continue
            pinned.add(slot)
            # The key may already live in the Python key space (counter
            # created via the per-request path, or a cold key promoted on
            # the way in): then the cell is LIVE and must not be reset by
            # the fresh flag.
            fresh_mask[pos] = is_fresh
            key = keys[pos].copy()
            self.hp.slots_insert(key, slot)
            storage._table.native_keys[slot] = key
            slots[pos] = slot

    # -- exact fallback --------------------------------------------------------

    async def _decide_exact(self, blob: bytes, future: asyncio.Future) -> None:
        from ..server.rls import _context_from_request, _hits_addend

        try:
            req = self._pb.RateLimitRequest.FromString(blob)
            if not req.domain:
                out = self.UNKNOWN_BLOB
            else:
                ctx = _context_from_request(req)
                result = await self.limiter.check_rate_limited_and_update(
                    req.domain, ctx, _hits_addend(req), False
                )
                metrics = self.metrics
                if result.limited:
                    if metrics:
                        metrics.incr_limited_calls(
                            req.domain, result.limit_name)
                    out = self.OVER_BLOB
                else:
                    if metrics:
                        metrics.incr_authorized_calls(req.domain)
                        metrics.incr_authorized_hits(
                            req.domain, _hits_addend(req))
                    out = self.OK_BLOB
            if not future.done():
                future.set_result(out)
        except Exception as exc:
            if not future.done():
                future.set_exception(exc)

    def fail_over_queued(self, decider, exc) -> None:
        """Breaker trip: queued raw requests re-route through the exact
        per-request path (which decides on the host failover oracle);
        dispatched-but-uncollected chunks fail with ``exc``. ``decider``
        is unused: the exact path already decides through the storage's
        failover branch. Thread-safe; fans out to every serving shard's
        loop."""
        for shard in list(self._shards.values()):
            loop = shard.loop
            if loop is None or loop.is_closed():
                continue

            def _drain(shard=shard):
                batch, shard.pending = shard.pending, []
                for blob, future, _t, _rid in batch:
                    if not future.done():
                        _spawn_detached(self._decide_exact(blob, future))
                for stuck in list(shard.inflight_batches.values()):
                    for _blob, future, _t, _rid in stuck:
                        if not future.done():
                            future.set_exception(exc)

            try:
                loop.call_soon_threadsafe(_drain)
            except RuntimeError:
                pass  # loop closed between the check and the call

    async def _close_shard(self, shard: _SubmitShard) -> None:
        await self._flush(shard, "shutdown")
        if shard.inflight:
            await asyncio.gather(*shard.inflight, return_exceptions=True)

    async def close(self) -> None:
        if self.lease_broker is not None:
            self.lease_broker.close()
        cur = asyncio.get_running_loop()
        for shard in list(self._shards.values()):
            if shard.loop is cur:
                await self._close_shard(shard)
            elif not shard.loop.is_closed() and shard.loop.is_running():
                try:
                    asyncio.run_coroutine_threadsafe(
                        self._close_shard(shard), shard.loop
                    ).result(timeout=10)
                except Exception:
                    pass  # shard loop died mid-shutdown: futures are gone
        self._dispatch_pool.shutdown(wait=False)
        self._collect_pool.shutdown(wait=False)


def _native_trace_attrs(pendings) -> Optional[dict]:
    """Span attributes of a 1-in-N sampled hot-lane batch: the trace id
    the C begin stamped and its native splits. None unless an exporter
    is installed and this batch was sampled."""
    if not tracing_enabled():
        return None
    for pending in pendings:
        if type(pending) is _HotPending and pending.staged.trace_id:
            return native.staged_trace_attrs(pending.staged)
    return None


def _spawn_detached(coro) -> asyncio.Task:
    """Background task in a FRESH contextvars context, so the flush loop
    and the slow-path decides it fans out are not parented under one
    arbitrary request's context."""
    loop = asyncio.get_running_loop()
    return loop.create_task(coro, context=contextvars.Context())


def _resolve_many(pairs) -> None:
    for future, out in pairs:
        if future.done():
            continue
        if out is _STORAGE_ERROR:
            future.set_exception(
                StorageError("counter allocation failed", transient=True)
            )
        else:
            future.set_result(out)


class _NsPending:
    """One namespace's launched-but-uncollected kernel: everything
    ``_finish_namespace`` needs to turn the device result into response
    blobs and metrics. ``rows`` are batch-global row indices."""

    __slots__ = (
        "namespace", "rows", "deltas_req", "failed_reqs", "participating",
        "order", "req_sorted", "hit_limits", "limit_ends", "inflight",
    )

    def __init__(self, namespace, rows, deltas_req, failed_reqs,
                 participating, order, req_sorted, hit_limits, limit_ends,
                 inflight):
        self.namespace = namespace
        self.rows = rows
        self.deltas_req = deltas_req
        self.failed_reqs = failed_reqs
        self.participating = participating
        #: kernel position -> position in the limits' concatenation
        self.order = order
        #: local request of each hit, in kernel order
        self.req_sorted = req_sorted
        self.hit_limits = hit_limits
        self.limit_ends = limit_ends
        self.inflight = inflight


class _CachedPending:
    """The plan-cache lane's launched-but-uncollected kernel: entries in
    kernel request-id order, each (batch row, DecisionPlan)."""

    __slots__ = ("entries", "inflight")

    def __init__(self, entries, inflight):
        self.entries = entries
        self.inflight = inflight


class _HotPending:
    """The native hot lane's launched-but-uncollected kernel: the staged
    geometry/code column plus the lane that staged it (pinned so a
    pending survives an interner-recycle lane swap; its finish pass is
    context-free)."""

    __slots__ = ("staged", "lane", "inflight")

    def __init__(self, staged, lane, inflight):
        self.staged = staged
        self.lane = lane
        self.inflight = inflight


class _Missing:
    pass


_MISSING_PLAN = _Missing()
_STORAGE_ERROR = _Missing()
NativeRlsPipeline.STORAGE_ERROR = _STORAGE_ERROR
#: shared trivial plans (stateless: no slots)
_UNKNOWN_PLAN_SINGLETON = DecisionPlan(PLAN_UNKNOWN)
_FREE_OK_PLAN_SINGLETON = DecisionPlan(PLAN_OK, namespace=None)
