"""The port's micro-batcher: batching must be invisible and exact.

The cases of ``tests/test_batcher.py`` (the JAX package's batcher),
against ``AsyncTorchStorage`` over ``TorchStorage(device="cpu")``, plus a
threaded stress of the storage's begin/finish split.
"""

import asyncio
import sys
import threading

import numpy as np
import pytest

from limitador_tpu_torch import AsyncRateLimiter, Context, Limit
from limitador_tpu_torch.core.counter import Counter
from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage
from limitador_tpu_torch.device.storage import _Request
from limitador_tpu_torch.storage.base import StorageError


def _limiter(capacity=1 << 10, max_delay=0.002, **kw):
    storage = AsyncTorchStorage(
        TorchStorage(capacity=capacity, device="cpu", **kw),
        max_delay=max_delay,
    )
    return storage, AsyncRateLimiter(storage)


def test_concurrent_checks_admit_exactly_max():
    async def main():
        storage, limiter = _limiter()
        limiter.add_limit(Limit("ns", 100, 60, [], ["u"]))

        async def one():
            r = await limiter.check_rate_limited_and_update(
                "ns", Context({"u": "shared"}), 1)
            return not r.limited

        results = await asyncio.gather(*[one() for _ in range(300)])
        await storage.close()
        return sum(results)

    assert asyncio.run(main()) == 100


def test_batched_load_counters_and_names():
    async def main():
        storage, limiter = _limiter()
        limiter.add_limit(Limit("ns", 2, 60, [], ["u"], name="per-user"))
        outs = []
        for _ in range(3):
            r = await limiter.check_rate_limited_and_update(
                "ns", Context({"u": "x"}), 1, load_counters=True)
            outs.append((r.limited, r.limit_name,
                         [c.remaining for c in r.counters]))
        await storage.close()
        return outs

    assert asyncio.run(main()) == [
        (False, None, [1]), (False, None, [0]), (True, "per-user", [0])]


@pytest.mark.parametrize("max_delay", [0.0001, 0.002])
def test_multi_user_batches_stay_isolated(max_delay):
    async def main():
        storage, limiter = _limiter(1 << 12, max_delay)
        limiter.add_limit(Limit("ns", 5, 60, [], ["u"]))

        async def hammer(user, n):
            admitted = 0
            for _ in range(n):
                r = await limiter.check_rate_limited_and_update(
                    "ns", Context({"u": user}), 1)
                admitted += 0 if r.limited else 1
            return admitted

        got = await asyncio.gather(*[hammer(f"u{i}", 8) for i in range(10)])
        await storage.close()
        return got

    assert asyncio.run(main()) == [5] * 10


def test_qualified_counters_evict_gracefully_at_capacity():
    async def main():
        storage, limiter = _limiter(8, 0.001)
        limiter.add_limit(Limit("ns", 5, 60, [], ["u"]))
        for i in range(20):
            r = await limiter.check_rate_limited_and_update(
                "ns", Context({"u": str(i)}), 1)
            assert not r.limited
        await storage.close()

    asyncio.run(main())


def test_batcher_exception_reaches_every_waiter():
    """A table whose slots are all pinned by simple limits cannot host a
    qualified counter: the StorageError of the flush reaches every
    awaiting request."""

    async def main():
        storage, limiter = _limiter(2, 0.001)
        for ns in ("a", "b"):
            limiter.add_limit(Limit(ns, 5, 60))
            storage.inner.add_counter(Limit(ns, 5, 60))
        limiter.add_limit(Limit("q", 5, 60, [], ["u"]))

        async def one(i):
            try:
                await limiter.check_rate_limited_and_update(
                    "q", Context({"u": str(i)}), 1)
            except StorageError as exc:
                return exc
            return None

        results = await asyncio.gather(*[one(i) for i in range(3)])
        await storage.close()
        return results

    assert all(isinstance(r, StorageError) for r in asyncio.run(main()))


def test_update_batcher_coalesces_the_report_path():
    """Concurrent Report updates sum per counter before they reach the
    storage, and each flush is one apply_deltas call: far fewer storage
    calls than requests."""
    calls = []

    class CountingStorage(TorchStorage):
        def update_counter(self, counter, delta):
            raise AssertionError("the batcher applies through apply_deltas")

        def apply_deltas(self, items):
            calls.append(sum(delta for _c, delta in items))
            return super().apply_deltas(items)

    async def main():
        storage = AsyncTorchStorage(
            CountingStorage(capacity=1 << 10, device="cpu"), max_delay=0.005)
        limiter = AsyncRateLimiter(storage)
        limiter.add_limit(Limit("ns", 1000, 60, [], ["u"]))
        await asyncio.gather(*(
            [limiter.update_counters("ns", Context({"u": "a"}), 2)
             for _ in range(50)]
            + [limiter.update_counters("ns", Context({"u": "b"}), 1)
               for _ in range(30)]
        ))
        counts = {c.set_variables["u"]: 1000 - c.remaining
                  for c in await limiter.get_counters("ns")}
        await storage.close()
        return counts

    assert asyncio.run(main()) == {"a": 100, "b": 30}
    assert sum(calls) == 130 and len(calls) <= 10


def test_pipelined_batches_stay_exact_under_backpressure():
    async def main():
        storage, limiter = _limiter(1 << 10, 0.0001)
        limiter.add_limit(Limit("ns", 40, 60, [], ["u"]))
        admitted = 0
        for _wave in range(20):
            results = await asyncio.gather(*[
                limiter.check_rate_limited_and_update(
                    "ns", Context({"u": "p"}), 1)
                for _ in range(10)
            ])
            admitted += sum(1 for r in results if not r.limited)
        await storage.close()
        return admitted

    assert asyncio.run(main()) == 40


def test_threaded_begin_finish_interleaving_stays_exact():
    """More threads than this test needs cores, a short switch interval,
    pipelined begin/finish handles and qualified-slot eviction churn: the
    contended counter must admit exactly its max (a lost update would
    admit more)."""
    storage = TorchStorage(capacity=128, cache_size=16, device="cpu")
    limit = Limit("ns", 50, 600, [], ["u"])
    contended = [Counter(limit, {"u": "hot"})]
    admitted = []
    admitted_lock = threading.Lock()
    errors = []

    def hammer(tid):
        try:
            for i in range(25):
                churn = Counter(limit, {"u": f"t{tid}-{i}"})
                handle = storage.begin_check_many(
                    [_Request(contended, 1, False),
                     _Request([churn], 1, False)])
                auths = storage.finish_check_many(handle)
                with admitted_lock:
                    admitted.append(not auths[0].limited)
        except Exception as exc:  # reported below
            errors.append(exc)

    previous = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(previous)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(admitted) == 200 and sum(admitted) == 50


@pytest.mark.parametrize("dispatch_chunk", [None, 0, 512, 3000])
@pytest.mark.parametrize("queue_wait_s", [0.0, 0.01])
def test_chunk_planner_splits_like_jax(dispatch_chunk, queue_wait_s):
    """The port's ChunkPlanner cuts the same flushes into the same chunk
    ranges as the JAX package's, after the same device-time feedback."""
    from limitador_tpu.tpu.batcher import ChunkPlanner as JaxPlanner
    from limitador_tpu_torch.device.batcher import ChunkPlanner

    rng = np.random.default_rng(17)
    planners = (JaxPlanner(dispatch_chunk), ChunkPlanner(dispatch_chunk))
    for _round in range(6):
        sizes = rng.integers(1, 4, int(rng.integers(1, 9000))).tolist()
        got = [p.split(sizes, queue_wait_s) for p in planners]
        assert got[0] == got[1]
        flat = [i for lo, hi in got[1] for i in range(lo, hi)]
        assert flat == list(range(len(sizes)))
        device_s = float(rng.uniform(1e-5, 5e-3))
        for p in planners:
            p.observe(device_s, sum(sizes))


def _chunked_drive(make_storage, limiter_cls, context_cls, limit_cls,
                   rounds, spy=None):
    """Two one-flush rounds of 2,100 three-counter requests (6,300 hits,
    so a 3000-hit chunk still splits) over 300 users in 7 tenants and 5
    routes; returns every decision as (limited, limit name)."""
    async def main():
        storage = make_storage()
        if spy is not None:
            spy(storage)
        limiter = limiter_cls(storage)
        limiter.add_limit(limit_cls("ns", 10, 60, [], ["u"], name="user"))
        limiter.add_limit(limit_cls("ns", 400, 60, [], ["t"],
                                    name="tenant"))
        limiter.add_limit(limit_cls("ns", 600, 60, [], ["r"],
                                    name="route"))
        out = []
        for users in rounds:
            # every submit enqueues before the batcher task first runs:
            # one flush a round
            results = await asyncio.gather(*[
                limiter.check_rate_limited_and_update(
                    "ns", context_cls({"u": f"u{u}", "t": f"t{u % 7}",
                                       "r": f"r{u % 5}"}), 1)
                for u in users
            ])
            out.extend((r.limited, r.limit_name) for r in results)
        await storage.close()
        return out

    return asyncio.run(main())


@pytest.mark.parametrize("dispatch_chunk", [None, 0, 512, 3000])
def test_chunked_dispatch_is_exact_against_monolithic_and_jax(
        dispatch_chunk):
    """A MicroBatcher cutting each flush into chunks launches them in
    order and never splits a request: its decisions equal the monolithic
    flush's and the JAX MicroBatcher's with the same dispatch_chunk, and
    the chunk plan reaches the recorder (one begin a chunk)."""
    from limitador_tpu import AsyncRateLimiter as JLimiter
    from limitador_tpu import Context as JContext
    from limitador_tpu import Limit as JLimit
    from limitador_tpu.tpu.batcher import AsyncTpuStorage
    from limitador_tpu.tpu.storage import TpuStorage
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics

    import torch

    rng = np.random.default_rng(23)
    rounds = [rng.integers(0, 300, 2100).tolist() for _ in range(2)]
    begins = []
    metrics = {}

    def port_storage(chunk):
        def make():
            storage = AsyncTorchStorage(
                TorchStorage(capacity=1 << 11, device="cpu"),
                max_batch_hits=1 << 20, max_delay=0.05,
                dispatch_chunk=chunk,
            )
            if chunk == dispatch_chunk:
                metrics["m"] = PrometheusMetrics()
                storage.set_metrics(metrics["m"])
            return storage
        return make

    def spy(storage):
        begin = storage.inner.begin_check_many

        def counted(requests):
            begins.append(sum(len(r.ordered) for r in requests))
            return begin(requests)

        storage.inner.begin_check_many = counted

    # one intra-op thread: the test's CPU work stays off the cores the
    # other test workers time their own work on
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        chunked = _chunked_drive(port_storage(dispatch_chunk),
                                 AsyncRateLimiter, Context, Limit, rounds,
                                 spy)
        monolithic = _chunked_drive(port_storage(0), AsyncRateLimiter,
                                    Context, Limit, rounds)
    finally:
        torch.set_num_threads(threads)
    jax = _chunked_drive(
        lambda: AsyncTpuStorage(TpuStorage(capacity=1 << 11),
                                max_batch_hits=1 << 20, max_delay=0.05,
                                dispatch_chunk=dispatch_chunk),
        JLimiter, JContext, JLimit, rounds)
    assert chunked == monolithic == jax
    assert sum(limited for limited, _n in chunked) > 0
    assert {name for limited, name in chunked if limited} >= {
        "user", "tenant"}
    # one begin a chunk, chunks of whole requests covering the flushes
    assert sum(begins) == 2 * 6300
    if dispatch_chunk == 0:
        assert begins == [6300, 6300]
    elif dispatch_chunk in (512, 3000):
        assert len(begins) > 2 and all(b % 3 == 0 for b in begins)
    text = metrics["m"].render().decode()
    assert f"dispatch_chunk_splits_count {2.0}" in text
    assert f"dispatch_chunk_splits_sum {float(len(begins))}" in text
    assert f"dispatch_chunk_hits_count {float(len(begins))}" in text
    assert f"dispatch_chunk_hits_sum {float(sum(begins))}" in text


def test_chunk_planner_retarget_clamps_like_jax():
    from limitador_tpu.tpu.batcher import ChunkPlanner as JaxPlanner
    from limitador_tpu_torch.device.batcher import ChunkPlanner

    for target in (0.0, 0.0001, 0.001, 0.004, 0.02):
        port, jax = ChunkPlanner(), JaxPlanner()
        assert port.retarget(target) == jax.retarget(target)
        for p in (port, jax):
            p.observe(0.004, 4096)
        assert port.chunk_hits(0.0) == jax.chunk_hits(0.0)
        assert port.chunk_hits(1.0) == jax.chunk_hits(1.0)
    fixed = ChunkPlanner(dispatch_chunk=700)
    fixed.retarget(0.008)
    assert fixed.chunk_hits() == 700


def test_chunk_telemetry_reaches_the_recorder():
    from limitador_tpu_torch.observability.device_plane import (
        DeviceStatsRecorder,
    )

    class _Hist:
        def __init__(self):
            self.observed = []

        def observe(self, v):
            self.observed.append(v)

    metrics = type("Metrics", (), {})()
    for name in ("batcher_flushes", "batcher_batch_fill_ratio",
                 "batcher_queue_wait", "device_phase_latency",
                 "dispatch_chunk_hits", "dispatch_chunk_splits"):
        setattr(metrics, name, _Hist())
    DeviceStatsRecorder().record_chunks([8, 8, 4])  # no metrics: a no-op
    DeviceStatsRecorder(metrics).record_chunks([8, 8, 4])
    assert metrics.dispatch_chunk_splits.observed == [3]
    assert metrics.dispatch_chunk_hits.observed == [8, 8, 4]
