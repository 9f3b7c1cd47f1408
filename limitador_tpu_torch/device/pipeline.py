"""Compiled pipeline: descriptor batches -> masks -> slots -> kernel.

Port counterpart of ``limitador_tpu/tpu/pipeline.py``
(``CompiledTpuLimiter`` -> ``CompiledTorchLimiter``). Instead of
interpreting CEL per request before storage, raw requests (namespace,
descriptor map, delta) queue per event loop; at flush the whole batch
evaluates through the vectorized limit compiler (``device/compiler.py``),
one columnar pass per namespace, and the resulting counters go through
the same exact kernel as the per-request path
(``TorchStorage.begin_check_many``).

``CompiledTorchLimiter`` is a drop-in ``AsyncRateLimiter``: same public
API, same semantics, same storage. Namespace compilers rebuild lazily
whenever that namespace's limits change. Two serving-path additions:

- **Counter-plan cache**: repeat (namespace, descriptor-values)
  identities skip CEL evaluation and Counter construction; the resolved
  Counter list is memoized under a limits epoch that every
  add/update/delete/reload bumps.
- **Per-loop serving shards**: the pending queue, flush task and
  in-flight window are sharded per event loop; ``submit_check`` is the
  plain-function fast lane returning the decision future.

It is also the limiter the native pipeline (``device/native_pipeline.py``)
wraps: that pipeline takes its limits registry and its exact per-request
fallback from here.

Metrics (``set_metrics``): each decided request observes its batch's
device round trip (begin to finish) into ``datastore_device_latency``;
``library_stats`` adds the CEL evaluation counts, the queue depth and the
counter-plan cache to the storage's. ``set_metrics`` also takes the
wrapped storage's device-plane recorder (one batch-id sequence and one
flight recorder per process): each flush records its reason, queue
waits and chunk plan, and each chunk its phases (``dispatch``,
``host_stage`` with the flush's columnar evaluation on the first chunk,
``device_sync``, ``unpack``) inside a ``device_batch_span``.

Admission: with a controller on the wrapped storage, each chunk launch
takes a breaker token; while the breaker is not closed every request
takes the inherited exact path, whose storage call decides on the host
failover oracle; and ``fail_over_queued`` (a trip) decides every queued
request on the oracle and fails every dispatched chunk.
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple, Union

from ..core.cel import Context
from ..core.counter import Counter
from ..core.limiter import AsyncRateLimiter, CheckResult
from ..core.limit import Limit, Namespace
from ..observability.device_plane import current_request_id
from ..observability.tracing import device_batch_span
from .batcher import (
    AsyncTorchStorage,
    ChunkPlanner,
    _observe,
    _timed_call,
    chunk_queue_wait,
)
from .compiler import NamespaceCompiler
from .plan_cache import CounterPlanCache

__all__ = ["CompiledTorchLimiter"]


class _RawPending:
    __slots__ = ("namespace", "values", "delta", "load", "future", "t_enq",
                 "rid")

    def __init__(self, namespace, values, delta, load, future, t_enq=0.0,
                 rid=None):
        self.namespace = namespace
        self.values = values
        self.delta = delta
        self.load = load
        self.future = future
        self.t_enq = t_enq
        self.rid = rid


class _LoopShard:
    """Per-event-loop serving state (pending queue + flush machinery).
    Each serving loop owns one; the compiler cache, limits registry and
    device lane behind them are shared."""

    __slots__ = ("loop", "pending", "flush_task", "sem", "inflight",
                 "inflight_pendings", "batch_seq")

    def __init__(self, loop, max_inflight: int):
        self.loop = loop
        self.pending: List[_RawPending] = []
        self.flush_task: Optional[asyncio.Task] = None
        self.sem = asyncio.Semaphore(max_inflight)
        self.inflight: set = set()
        # seq -> the _RawPendings of a dispatched-but-uncollected chunk,
        # so that a breaker trip can fail them off the dead plane
        self.inflight_pendings: Dict[int, list] = {}
        self.batch_seq = 0


def _values_of(
    ctx_or_values: Union[Context, Dict[str, str]]
) -> Optional[Dict[str, str]]:
    """Descriptor map when the context has exactly the single-descriptor
    shape the compiler handles; None routes the request to the exact
    per-request path (multi-descriptor requests, root-bound contexts)."""
    if isinstance(ctx_or_values, dict):
        return ctx_or_values
    bindings = ctx_or_values._bindings
    descriptors = bindings.get("descriptors")
    if (
        descriptors is not None
        and len(descriptors) == 1
        and len(bindings) == 1
    ):
        return descriptors[0]
    return None


class CompiledTorchLimiter(AsyncRateLimiter):
    """AsyncRateLimiter whose hot path batch-compiles limit evaluation.

    Compiled evaluation binds the request's descriptor map as
    ``descriptors[0]``, the shape the RLS serving plane uses; other
    contexts go through the inherited per-request path."""

    def __init__(
        self,
        storage: AsyncTorchStorage,
        plan_cache_size: int = 1 << 16,
        dispatch_chunk: Optional[int] = None,
    ):
        super().__init__(storage)
        # None = chunks auto-sized from the observed device time per
        # hit, 0 = monolithic, > 0 = fixed hits per chunk
        self.chunk_planner = ChunkPlanner(dispatch_chunk)
        self._metrics = None
        #: the wrapped storage's DeviceStatsRecorder (``set_metrics``);
        #: None = detached
        self.recorder = None
        # CEL evaluation counts of compilers dropped by limits changes
        self._retired_vec_evals = 0
        self._retired_fb_evals = 0
        self._torch: AsyncTorchStorage = self.storage.counters
        self._compilers: Dict[Namespace, NamespaceCompiler] = {}
        # Epoch-guarded (namespace, values) -> Counter-list memo; every
        # limits change bumps the epoch, orphaning all entries.
        self.counters_cache: Optional[CounterPlanCache] = (
            CounterPlanCache(plan_cache_size) if plan_cache_size > 0
            else None
        )
        self._shards: Dict[object, _LoopShard] = {}
        self._shards_lock = threading.Lock()
        # Serializes compiler-cache access + columnar evaluation across
        # serving shards: NamespaceCompiler's interner is a check-then-act
        # that two shard loops evaluating concurrently could double-assign,
        # aliasing two descriptor values onto one token. Only cache misses
        # pay this lock.
        self._eval_lock = threading.Lock()
        self.max_delay = self._torch.batcher.max_delay
        self.max_batch = 4096
        #: dispatched-but-uncollected batches per shard
        self.max_inflight = 2
        self._dispatch_pool = ThreadPoolExecutor(
            1, thread_name_prefix="compiled-dispatch"
        )
        self._collect_pool = ThreadPoolExecutor(
            max(self.max_inflight, 2), thread_name_prefix="compiled-collect"
        )

    @property
    def _pending(self):
        """Aggregate pending across serving shards (stats/debug only)."""
        out: list = []
        for shard in list(self._shards.values()):
            out.extend(shard.pending)
        return out

    # -- compiler cache invalidation ----------------------------------------
    #
    # Invalidation runs AFTER the registry mutation and takes _eval_lock.
    # A shard's miss evaluation holds _eval_lock from reading get_limits to
    # installing the built compiler, so any compiler built from the
    # pre-mutation registry is installed by the time the invalidate
    # acquires the lock, and gets popped here.

    def _invalidate(self, namespace: Namespace) -> None:
        with self._eval_lock:
            self._retire_compiler(self._compilers.pop(namespace, None))
            if self.counters_cache is not None:
                self.counters_cache.bump_epoch()

    def add_limit(self, limit: Limit) -> bool:
        added = super().add_limit(limit)
        self._invalidate(limit.namespace)
        return added

    def update_limit(self, limit: Limit) -> bool:
        updated = super().update_limit(limit)
        self._invalidate(limit.namespace)
        return updated

    async def delete_limit(self, limit: Limit) -> None:
        await super().delete_limit(limit)
        self._invalidate(limit.namespace)

    async def delete_limits(self, namespace) -> None:
        await super().delete_limits(namespace)
        self._invalidate(Namespace.of(namespace))

    async def configure_with(self, limits) -> None:
        await super().configure_with(limits)
        with self._eval_lock:
            for compiler in self._compilers.values():
                self._retire_compiler(compiler)
            self._compilers.clear()
            if self.counters_cache is not None:
                self.counters_cache.bump_epoch()

    # -- metrics ---------------------------------------------------------------

    def set_metrics(self, metrics) -> None:
        """Observe device batch round trips into the server's metrics; the
        wrapped storage's batchers (the per-request lane for context
        shapes the compiler does not cover) observe their own."""
        self._metrics = metrics
        self._torch.set_metrics(metrics)
        self.recorder = self._torch.recorder

    def _retire_compiler(self, compiler) -> None:
        if compiler is not None:
            self._retired_vec_evals += compiler.vectorized_evals
            self._retired_fb_evals += compiler.fallback_evals

    def plan_cache_stats(self) -> dict:
        return (
            self.counters_cache.stats()
            if self.counters_cache is not None else {}
        )

    def library_stats(self) -> dict:
        stats = self._torch.library_stats()
        vec, fb = self._retired_vec_evals, self._retired_fb_evals
        for compiler in self._compilers.values():
            vec += compiler.vectorized_evals
            fb += compiler.fallback_evals
        stats["cel_vectorized_evals"] = vec
        stats["cel_fallback_evals"] = fb
        stats["queue_depth"] = stats.get("queue_depth", 0) + len(self._pending)
        stats.update(self.plan_cache_stats())
        return stats

    def device_stats(self) -> dict:
        return self._torch.device_stats()

    def _compiler_for(self, namespace: Namespace) -> NamespaceCompiler:
        compiler = self._compilers.get(namespace)
        if compiler is None:
            compiler = NamespaceCompiler(self.get_limits(namespace))
            self._compilers[namespace] = compiler
        return compiler

    # -- the batched hot path -------------------------------------------------

    def _shard_for(self, loop) -> _LoopShard:
        shard = self._shards.get(loop)
        if shard is not None:
            return shard
        with self._shards_lock:
            shard = self._shards.get(loop)
            if shard is None:
                # Prune shards whose loop died so loop churn cannot
                # leak shard structs for the limiter's lifetime.
                for dead in [l for l in self._shards if l.is_closed()]:
                    del self._shards[dead]
                shard = _LoopShard(loop, self.max_inflight)
                self._shards[loop] = shard
            return shard

    def submit_check(
        self,
        namespace: Namespace,
        values: Dict[str, str],
        delta: int,
        load_counters: bool = False,
    ) -> "asyncio.Future":
        """Sync fast lane: enqueue one compiled-shape check on the
        calling loop's shard; returns the CheckResult future."""
        loop = asyncio.get_running_loop()
        shard = self._shards.get(loop)
        if shard is None:
            shard = self._shard_for(loop)
        future = loop.create_future()
        shard.pending.append(_RawPending(
            namespace, values, delta, load_counters, future,
            time.perf_counter(),
            current_request_id() if self.recorder is not None else None,
        ))
        task = shard.flush_task
        if task is None or task.done():
            shard.flush_task = loop.create_task(self._flush_soon(shard))
        if len(shard.pending) == self.max_batch:
            # == not >=: one size-flush per threshold crossing, not one
            # per submit past it (bursts enqueue before the loop runs).
            loop.create_task(self._flush(shard))
        return future

    async def check_rate_limited_and_update(
        self,
        namespace,
        ctx: Union[Context, Dict[str, str]],
        delta: int,
        load_counters: bool = False,
        counters=None,
    ) -> CheckResult:
        namespace = Namespace.of(namespace)
        adm = self._torch.admission
        if adm is not None and adm.use_failover():
            # Breaker open: the inherited exact path routes through the
            # storage, whose failover branch decides on the host oracle
            # (no batch slot, no device access). The compiled surface
            # also takes bare descriptor maps; the exact path needs a
            # Context.
            if isinstance(ctx, dict):
                values, ctx = ctx, Context()
                ctx.list_binding("descriptors", [values])
                counters = None  # matched against the rebuilt context
            return await super().check_rate_limited_and_update(
                namespace, ctx, delta, load_counters, counters=counters
            )
        values = _values_of(ctx)
        if values is None:
            # Context shape the compiler doesn't cover: exact inherited path.
            return await super().check_rate_limited_and_update(
                namespace, ctx, delta, load_counters, counters=counters
            )
        # The batched lane matches columnar per flush; a per-request
        # ``counters`` precompute has nothing to save there.
        return await self.submit_check(namespace, values, delta,
                                       load_counters)

    async def _flush_soon(self, shard: _LoopShard) -> None:
        await asyncio.sleep(self.max_delay)
        await self._flush(shard)
        # Requests that arrived while the flush was busy must not wait
        # for the next submission to schedule a timer.
        if shard.pending:
            shard.flush_task = asyncio.get_running_loop().create_task(
                self._flush_soon(shard)
            )

    async def _flush(
        self, shard: _LoopShard, reason: Optional[str] = None
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
                [t_flush - p.t_enq for p in batch],
            )
        live: List[Tuple[_RawPending, List[Counter]]] = []
        try:
            from .storage import _Request

            requests = self._evaluate_batch(batch)
            for p, counters in requests:
                if not counters:
                    if not p.future.done():
                        p.future.set_result(CheckResult(False, [], None))
                else:
                    live.append((p, counters))
            if not live:
                return
            reqs = [_Request(c, p.delta, p.load) for p, c in live]
            t_eval = time.perf_counter()
        except BaseException as exc:
            # Nothing may escape silently: an exception lost here would
            # strand every other submitter of this batch.
            _fail_futures(batch, exc)
            raise
        adm = self._torch.admission
        ranges = self.chunk_planner.split(
            [len(c) for _p, c in live],
            chunk_queue_wait(adm, batch[0].t_enq, t_flush),
        )
        if rec is not None:
            rec.record_chunks([
                sum(len(c) for _p, c in live[lo:hi]) for lo, hi in ranges
            ])
        # Every chunk registers as in flight BEFORE any await, so that a
        # breaker trip can fail the chunks still waiting for the window
        # (they left shard.pending at the top of this flush).
        seqs = []
        for lo, hi in ranges:
            shard.batch_seq += 1
            shard.inflight_pendings[shard.batch_seq] = [
                p for p, _c in live[lo:hi]
            ]
            seqs.append(shard.batch_seq)

        def _drop_rest(idx, exc):
            for (l2, h2), s2 in zip(ranges[idx:], seqs[idx:]):
                shard.inflight_pendings.pop(s2, None)
                _fail_futures([p for p, _c in live[l2:h2]], exc)

        failed = None
        for ci, ((lo, hi), seq) in enumerate(zip(ranges, seqs)):
            sub_live = live[lo:hi]
            if failed is not None:
                # begin failures are plane-wide: the rest of the flush
                # fails the way a monolithic dispatch would have.
                shard.inflight_pendings.pop(seq, None)
                _fail_futures([p for p, _c in sub_live], failed)
                continue
            try:
                await shard.sem.acquire()
            except BaseException as exc:
                _drop_rest(ci, exc)
                raise
            t_submit = time.perf_counter()
            token = adm.breaker.batch_started() if adm is not None else 0
            try:
                handle, t_begin, t_launch = await loop.run_in_executor(
                    self._dispatch_pool, _timed_call,
                    self._torch.inner.begin_check_many, reqs[lo:hi],
                )
            except BaseException as exc:
                shard.sem.release()
                if adm is not None:
                    adm.breaker.batch_finished(token, exc)
                if not isinstance(exc, Exception):
                    _drop_rest(ci, exc)
                    raise
                shard.inflight_pendings.pop(seq, None)
                _fail_futures([p for p, _c in sub_live], exc)
                failed = exc
                continue
            # host_stage folds the on-loop columnar evaluation (once per
            # flush, on its first chunk) in with the launch; the wait for
            # an inflight slot is backpressure, not host work.
            phases = {
                "dispatch": t_begin - t_submit,
                "host_stage": (t_launch - t_begin) + (
                    (t_eval - t_flush) if ci == 0 else 0.0
                ),
            }
            task = loop.run_in_executor(
                self._collect_pool, self._collect_batch, handle, sub_live,
                t_submit, batch_id, t_flush, phases,
            )
            shard.inflight.add(task)

            def _collected(t, seq=seq, token=token, sub_live=sub_live):
                shard.inflight.discard(t)
                shard.inflight_pendings.pop(seq, None)
                shard.sem.release()
                exc = t.exception()
                if adm is not None:
                    adm.breaker.batch_finished(token, exc)
                if exc is not None:
                    _fail_futures([p for p, _c in sub_live], exc)

            task.add_done_callback(_collected)

    def _collect_batch(self, handle, live, t0: float, batch_id: int,
                       t_flush: float, phases: dict) -> None:
        """Collect-thread phase: device transfer, decode, resolve every
        future in one loop callback per loop."""
        with device_batch_span(batch_id, len(live)) as span_phases:
            auths, t_fin, t_done = _timed_call(
                self._torch.inner.finish_check_many, handle
            )
            phases["device_sync"] = t_done - t_fin
            self.chunk_planner.observe(
                phases["device_sync"],
                sum(len(counters) for _p, counters in live),
            )
            if self._metrics is not None:
                _observe(self._metrics, len(live), t_done - t0)
            by_loop: Dict[object, list] = {}
            for (p, counters), auth in zip(live, auths):
                loaded = counters if p.load else []
                result = CheckResult(auth.limited, loaded, auth.limit_name)
                by_loop.setdefault(p.future.get_loop(), []).append(
                    (p.future, result)
                )
            for floop, pairs in by_loop.items():
                floop.call_soon_threadsafe(_settle_results, pairs)
            phases["unpack"] = time.perf_counter() - t_done
            span_phases(phases)
            rec = self.recorder
            if rec is not None:
                rec.record_batch(
                    ((p.t_enq, p.rid, p.namespace) for p, _c in live),
                    batch_id, t_flush, phases,
                )

    def _evaluate_batch(
        self, batch: List[_RawPending]
    ) -> List[Tuple[_RawPending, List[Counter]]]:
        # Counter-plan cache first: repeat (namespace, values) identities
        # reuse their resolved Counter list and skip CEL entirely. Only
        # load_counters=False traffic is cacheable (loads mutate
        # per-counter observability fields on what would be shared
        # objects).
        cache = self.counters_cache
        requests: List[Tuple[_RawPending, List[Counter]]] = []
        misses: List[Tuple[_RawPending, Optional[tuple]]] = []
        if cache is None:
            misses = [(p, None) for p in batch]
        else:
            get = cache.get
            for p in batch:
                if p.load:
                    misses.append((p, None))
                    continue
                key = (p.namespace, tuple(p.values.items()))
                counters = get(key)
                if counters is None:
                    misses.append((p, key))
                else:
                    requests.append((p, counters))
        if not misses:
            return requests

        # Group misses by namespace; one columnar evaluation each.
        by_ns: Dict[Namespace, List[int]] = {}
        for i, (p, _key) in enumerate(misses):
            by_ns.setdefault(p.namespace, []).append(i)

        # Epoch snapshot BEFORE evaluation: put discards on mismatch, so
        # a limits bump racing this batch on another thread can never
        # file a stale counter plan under the new epoch.
        epoch = cache.epoch if cache is not None else 0
        src_cache: Dict[Limit, List[str]] = {}
        with self._eval_lock:
            for namespace, idxs in by_ns.items():
                compiler = self._compiler_for(namespace)
                evaluated = compiler.evaluate(
                    [misses[i][0].values for i in idxs]
                )
                strings = compiler.interner.strings
                for i, hits in zip(idxs, evaluated):
                    counters = []
                    for limit, tokens in hits:
                        var_sources = src_cache.get(limit)
                        if var_sources is None:
                            # limit.variables is already source-sorted
                            var_sources = [
                                v.source for v in limit.variables
                            ]
                            src_cache[limit] = var_sources
                        set_vars = {
                            src: strings[tok]
                            for src, tok in zip(var_sources, tokens)
                        }
                        counters.append(Counter(limit, set_vars))
                    p, key = misses[i]
                    if key is not None and cache is not None:
                        cache.put(key, counters, epoch)
                    requests.append((p, counters))
        return requests

    def fail_over_queued(self, decider, exc) -> None:
        """Breaker trip: decide every queued request on the host through
        ``decider(counters, delta, load) -> Authorization`` and fail the
        dispatched-but-uncollected chunks with ``exc`` (their kernel may
        already have run). Thread-safe: the trip listener can fire from a
        collect thread, so each shard's drain runs on its own serving
        loop, where that shard's queue is safe to touch."""
        for shard in list(self._shards.values()):
            loop = shard.loop
            if loop is None or loop.is_closed():
                continue

            def _drain(shard=shard):
                batch, shard.pending = shard.pending, []
                if batch:
                    try:
                        evaluated = self._evaluate_batch(batch)
                    except Exception as eexc:
                        _fail_futures(batch, eexc)
                        evaluated = []
                    for p, counters in evaluated:
                        if p.future.done():
                            continue
                        try:
                            if not counters:
                                p.future.set_result(
                                    CheckResult(False, [], None)
                                )
                            else:
                                auth = decider(counters, p.delta, p.load)
                                p.future.set_result(CheckResult(
                                    auth.limited,
                                    counters if p.load else [],
                                    auth.limit_name,
                                ))
                        except Exception as dexc:
                            p.future.set_exception(dexc)
                for pendings in list(shard.inflight_pendings.values()):
                    _fail_futures(pendings, exc)

            try:
                loop.call_soon_threadsafe(_drain)
            except RuntimeError:
                pass  # loop closed between the check and the call

    async def _close_shard(self, shard: _LoopShard) -> None:
        await self._flush(shard, "shutdown")
        if shard.inflight:
            await asyncio.gather(*shard.inflight, return_exceptions=True)

    async def close(self) -> None:
        """Drain in-flight collects on every shard and release the
        worker pools."""
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
                    pass  # shard loop died mid-shutdown
        self._dispatch_pool.shutdown(wait=False)
        self._collect_pool.shutdown(wait=False)


def _settle_results(pairs) -> None:
    for future, result in pairs:
        if not future.done():
            future.set_result(result)


def _fail_futures(pendings, exc) -> None:
    """Fail every unresolved pending, routed through each future's own
    loop (set_exception is only safe from the owning loop)."""
    by_loop: Dict[object, list] = {}
    for p in pendings:
        future = p.future
        if not future.done():
            by_loop.setdefault(future.get_loop(), []).append(future)

    for floop, futures in by_loop.items():
        def _do(futures=futures):
            for future in futures:
                if not future.done():
                    future.set_exception(exc)

        floop.call_soon_threadsafe(_do)
