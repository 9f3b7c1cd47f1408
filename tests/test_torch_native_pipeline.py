"""The port's native columnar pipeline against the JAX package's, on the CPU.

The fuzz corpus of ``tests/test_native_lane_fuzz.py`` (copied into
``tests/torch_native_corpus.py``; every wire shape the lanes route) goes
through the JAX ``NativeRlsPipeline`` over ``TpuStorage(capacity=1<<12)``
and through the port's over ``TorchStorage(capacity=1<<12, device="cpu")``
(the kernels' plain versions), with the same frozen clock, hot lane on and
off. Tolerance: exact. Every response row is byte-identical, and the final
counters (``get_counters``) and the raw ``values``/``expiry_ms``/``hits``
arrays are equal. Also covered: a limits reload between batches (epoch),
LRU eviction on a table small enough to evict, an interner-recycle context
swap, ``decide_many`` against ``submit``, and a native pipeline started
from a JAX pipeline's state in the middle of a corpus (``convert.py``).
"""

import asyncio

import numpy as np
import pytest

from limitador_tpu import Limit as JLimit
from limitador_tpu.tpu import AsyncTpuStorage, TpuStorage
from limitador_tpu.tpu.native_pipeline import NativeRlsPipeline as JaxNative
from limitador_tpu.tpu.pipeline import CompiledTpuLimiter
from limitador_tpu_torch import Limit as TLimit
from limitador_tpu_torch import convert, native
from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage
from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
from limitador_tpu_torch.server.proto import rls_pb2

from .torch_native_corpus import (
    D,
    FROZEN_NOW,
    NAMESPACES,
    columnar_only,
    corpus,
    decide_cached,
    limits,
)
from .torch_reference import jax_reference_lane  # noqa: F401 (autouse)


def jax_pipeline(hot, capacity=1 << 12, storage=None):
    storage = storage or TpuStorage(capacity=capacity,
                                    clock=lambda: FROZEN_NOW)
    limiter = CompiledTpuLimiter(AsyncTpuStorage(storage, max_delay=0.001))
    for limit in limits(JLimit):
        limiter.add_limit(limit)
    pipeline = JaxNative(limiter, None, max_delay=0.001, hot_lane=hot)
    assert pipeline.hot_lane_active == hot
    return pipeline, limiter


def port_pipeline(hot, capacity=1 << 12, storage=None, **kwargs):
    storage = storage or TorchStorage(capacity=capacity,
                                      clock=lambda: FROZEN_NOW, device="cpu")
    limiter = CompiledTorchLimiter(AsyncTorchStorage(storage,
                                                     max_delay=0.001))
    for limit in limits(TLimit):
        limiter.add_limit(limit)
    pipeline = NativeRlsPipeline(limiter, max_delay=0.001, hot_lane=hot,
                                 **kwargs)
    assert pipeline.hot_lane_active == hot
    return pipeline, limiter


def counter_state(limiter):
    """Comparable final counter state of either package's limiter."""
    async def collect():
        out = set()
        for ns in NAMESPACES:
            for counter in await limiter.get_counters(ns):
                out.add((
                    str(counter.namespace),
                    counter.limit.name,
                    tuple(sorted((counter.set_variables or {}).items())),
                    counter.remaining,
                    round(counter.expires_in or 0.0, 3),
                ))
        return out

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(collect())
    finally:
        loop.close()


def assert_same_tables(jax_p, port_p):
    jstate, tstate = jax_p.storage._state, port_p.storage._state
    for name, j, t in zip(("values", "expiry_ms", "hits"), jstate, tstate):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


def assert_same_state(jax_pair, port_pair):
    (jp, jl), (tp, tl) = jax_pair, port_pair
    assert counter_state(jl) == counter_state(tl)
    assert_same_tables(jp, tp)


def drive_both(jp, tp, blobs, passes=2, batch=64):
    for _pass in range(passes):
        for ofs in range(0, len(blobs), batch):
            part = blobs[ofs:ofs + batch]
            assert decide_cached(jp, part) == decide_cached(tp, part), ofs


def assert_same_lane_stats(tp, jp):
    """The port's hot-lane counters equal the JAX lane's, the pod's
    foreign rows included (a single process never has one)."""
    theirs = jp.lane_stats()
    assert theirs["foreign"] == 0
    assert tp.lane_stats() == theirs


@pytest.mark.parametrize("hot", [True, False], ids=["lane-on", "lane-off"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fuzz_corpus_matches_jax(seed, hot):
    jax_pair, port_pair = jax_pipeline(hot), port_pipeline(hot)
    drive_both(jax_pair[0], port_pair[0], corpus(seed))
    assert_same_state(jax_pair, port_pair)
    if hot:
        stats = port_pair[0].lane_stats()
        assert stats["hits"] > 0 and stats["staged_hits"] > 0, stats
        assert_same_lane_stats(port_pair[0], jax_pair[0])


@pytest.mark.parametrize("hot", [True, False], ids=["lane-on", "lane-off"])
@pytest.mark.parametrize("seed", [1, 2])
def test_decide_many_matches_jax(seed, hot):
    """The bulk engine, hot lane and lane-off parse path. Each call is one
    chunk: the JAX package's decide_many is not deterministic with
    several chunks in flight on the CPU (its jit dispatch aliases the hot
    lane's staging buffers, which the next chunk's begin overwrites;
    ROADMAP Queue C)."""
    (jp, jl), (tp, tl) = jax_pipeline(hot), port_pipeline(hot)
    blobs = corpus(seed)
    for _pass in range(2):
        for ofs in range(0, len(blobs), 100):
            part = blobs[ofs:ofs + 100]
            assert tp.decide_many(part, chunk=100) == jp.decide_many(
                part, chunk=100
            )
    assert_same_state((jp, jl), (tp, tl))


@pytest.mark.parametrize("hot", [True, False], ids=["lane-on", "lane-off"])
def test_decide_many_window_does_not_change_answers(hot):
    """Four chunks in flight answer exactly as the same chunks collected
    one by one: the port copies each chunk's staged columns before the
    next begin reuses the lane's buffers."""
    (windowed, wl), (serial, sl) = port_pipeline(hot), port_pipeline(hot)
    blobs = corpus(3)
    for _pass in range(2):
        for ofs in range(0, len(blobs), 100):
            part = blobs[ofs:ofs + 100]
            one_by_one = [
                r for sub in range(0, len(part), 25)
                for r in serial.decide_many(part[sub:sub + 25], chunk=25)
            ]
            assert windowed.decide_many(part, chunk=25, inflight=4) \
                == one_by_one
    assert counter_state(wl) == counter_state(sl)
    assert_same_tables(windowed, serial)


def test_begin_check_columnar_owns_its_inputs():
    """Staging buffers overwritten right after begin (what the hot lane's
    next begin does) do not reach the launched batch."""
    rng = np.random.default_rng(11)
    H = 64
    cols = (
        rng.integers(0, 32, H).astype(np.int32),
        np.ones(H, np.int32),
        np.full(H, 3, np.int32),
        np.full(H, 60_000, np.int32),
        np.sort(rng.integers(0, H, H)).astype(np.int32),
        np.zeros(H, bool),
        np.zeros(H, bool),
    )
    results = []
    for overwrite in (False, True):
        storage = TorchStorage(capacity=64, clock=lambda: FROZEN_NOW,
                               device="cpu")
        staged = tuple(c.copy() for c in cols)
        handle = storage.begin_check_columnar(*staged)
        if overwrite:
            for c in staged:
                c[...] = 0
        results.append(storage.finish_check_columnar(handle))
        results.append(storage._state.values.numpy().copy())
    for want, got in zip(results[:2], results[2:]):
        for a, b in zip(want if isinstance(want, tuple) else (want,),
                        got if isinstance(got, tuple) else (got,)):
            np.testing.assert_array_equal(a, b)


def test_mid_flight_reload_matches_jax():
    """A limits change between batches orphans every mirrored plan: the
    next decisions follow the new limits, identically in both packages."""
    (jp, jl), (tp, tl) = jax_pipeline(True), port_pipeline(True)
    blobs = corpus(4)
    drive_both(jp, tp, blobs[:200], passes=1)
    epoch = tp.lane_stats()["epoch"]
    for limiter, Limit, pipeline in ((jl, JLimit, jp), (tl, TLimit, tp)):
        limiter.update_limit(
            Limit("api", 1, 60, [f"{D}.m == 'GET'"], [f"{D}.u"],
                  name="per-get")
        )
        pipeline.invalidate()
    drive_both(jp, tp, blobs)
    assert tp.lane_stats()["epoch"] > epoch
    assert_same_state((jp, jl), (tp, tl))


@pytest.mark.parametrize("capacity", [16, 48])
@pytest.mark.parametrize("hot", [True, False], ids=["lane-on", "lane-off"])
def test_lru_eviction_matches_jax(capacity, hot):
    """A table small enough to evict on almost every chunk: slot releases
    drop the mirrored plans and native keys of the recycled slots in both
    packages alike. One row per call: a row staged beside others can sit
    at the LRU front when another row's miss evicts, and there the JAX
    package recycles the staged slot and the port evicts another (see the
    next test), so the slot layouts part."""
    jax_pair = jax_pipeline(hot, capacity=capacity)
    port_pair = port_pipeline(hot, capacity=capacity)
    drive_both(jax_pair[0], port_pair[0], corpus(5), batch=1)
    assert_same_state(jax_pair, port_pair)
    if hot:
        assert port_pair[0].lane_stats()["invalidations"] > 0
        assert_same_lane_stats(port_pair[0], jax_pair[0])


def _post_blob(u, unknown_field=False):
    req = rls_pb2.RateLimitRequest(domain="api")
    d = req.descriptors.add()
    d.entries.add(key="m", value="POST")
    d.entries.add(key="u", value=u)
    blob = req.SerializeToString()
    # an unknown field makes a new blob (a plan miss) for the same counter
    return blob + b"\x78\x2a" if unknown_field else blob


_A, _B, _C = _post_blob("a"), _post_blob("b"), _post_blob("c")
_A2, _B2 = _post_blob("a", True), _post_blob("b", True)


@pytest.mark.parametrize("hot", [True, False], ids=["lane-on", "lane-off"])
@pytest.mark.parametrize("chunks,evicted,jax_admits", [
    # c's miss evicts: the LRU front is a, which the chunk has staged
    ([[_A], [_B], [_A2, _C]] + [[_A]] * 7 + [[_C]] * 7, "b", 16),
    # every qualified slot is staged: c cannot be seated
    ([[_A], [_B], [_A2, _B2, _C]] + [[_A]] * 6 + [[_B]] * 6, "c", 17),
], ids=["recycles-an-unstaged-slot", "fails-the-row-it-cannot-seat"])
def test_a_chunk_never_evicts_a_slot_it_has_staged(chunks, evicted,
                                                   jax_admits, hot):
    """``per-user`` (7 per 120 s) over ``TorchStorage(cache_size=2)``,
    where a chunk's miss evicts while the chunk has a slot staged that the
    C slot map found without touching the LRU. The port evicts around the
    staged slots, or fails the one row it cannot seat, and so answers
    every other row, and keeps every counter it holds, like a table that
    never evicts. The JAX package's pipeline recycles the staged slot, two
    counters share one cell in one launch, and it admits more than 7 for
    one user (ROADMAP Queue C)."""
    def small(package):
        if package == "jax":
            return jax_pipeline(hot, storage=TpuStorage(
                capacity=64, cache_size=2, clock=lambda: FROZEN_NOW))
        return port_pipeline(hot, storage=TorchStorage(
            capacity=64, cache_size=2, clock=lambda: FROZEN_NOW,
            device="cpu"))

    (rp, rl), (tp, tl), (jp, _jl) = jax_pipeline(hot), small("port"), \
        small("jax")
    want = [decide_cached(rp, chunk) for chunk in chunks]
    got = [decide_cached(tp, chunk) for chunk in chunks]
    if evicted == "c":  # the row that found every slot staged
        assert got[2][2] == "STORAGE_ERROR" and want[2][2] == tp.OK_BLOB
        got[2][2] = want[2][2]
    assert got == want
    assert counter_state(tl) == {
        c for c in counter_state(rl)
        if c[2] != (("descriptors[0].u", evicted),)}
    jax_answers = [decide_cached(jp, chunk) for chunk in chunks]
    assert sum(r == jp.OK_BLOB for chunk in jax_answers
               for r in chunk) == jax_admits
    assert sum(r == tp.OK_BLOB for chunk in want
               for r in chunk) < jax_admits


def _one_blob(u):
    req = rls_pb2.RateLimitRequest(domain="api")
    d = req.descriptors.add()
    d.entries.add(key="m", value="GET")
    d.entries.add(key="u", value=u)
    return req.SerializeToString()


def test_slot_release_invalidates_mirrored_plan_even_after_python_evict():
    """The mirror drops a plan pinning a released slot even when the
    Python cache already evicted that plan."""
    p, _ = port_pipeline(True)
    blob = _one_blob("evictee")
    assert p.decide_many([blob], chunk=8)[0] == p.OK_BLOB
    assert p.hp.plan_count() >= 1
    p.plan_cache._entries.pop(blob, None)
    plans_before = p.hp.plan_count()
    storage = p.storage
    with storage._lock:
        for slot, (key, counter) in list(storage._table.info.items()):
            storage._table.release(slot, key, counter.is_qualified())
    assert p.hp.plan_count() < plans_before
    assert p._hot_lane.stats()["invalidations"] >= 1
    assert not storage._table.native_keys


def test_clear_orphans_every_plan():
    """A wholesale table swap fires on_clear: the epoch moves and the
    next decision re-derives against the fresh table."""
    p, _ = port_pipeline(True)
    blob = _one_blob("c")
    assert p.decide_many([blob] * 4, chunk=8) == [p.OK_BLOB] * 3 + [
        p.OVER_BLOB]
    epoch = p.plan_cache.epoch
    p.storage.clear()
    assert p.plan_cache.epoch == epoch + 1
    assert p.decide_many([blob], chunk=8) == [p.OK_BLOB]


@pytest.mark.parametrize("hot", [True, False], ids=["lane-on", "lane-off"])
def test_interner_recycle_context_swap_matches_jax(hot):
    """With the interner cap tiny, every begin swaps in a fresh native
    context; decisions and state stay identical to the JAX pipeline
    doing the same."""
    (jp, jl), (tp, tl) = jax_pipeline(hot), port_pipeline(hot)
    jp.max_interned = tp.max_interned = 8
    old_hp = tp.hp
    drive_both(jp, tp, corpus(6))
    assert tp.hp is not old_hp
    assert_same_state((jp, jl), (tp, tl))
    if hot:
        assert_same_lane_stats(tp, jp)


def test_decide_many_matches_submit():
    """The bulk engine and the future-resolving serving path decide the
    same rows the same way when their batches coincide (64 blobs, one
    size-triggered flush each)."""
    blobs = columnar_only(corpus(7))
    blobs = blobs[: len(blobs) // 64 * 64]
    bulk, bulk_lim = port_pipeline(True)
    served, served_lim = port_pipeline(True, max_batch=64)
    served.max_delay = 30.0  # flush on size only

    want = []
    for _pass in range(2):
        for ofs in range(0, len(blobs), 64):
            want.extend(bulk.decide_many(blobs[ofs:ofs + 64], chunk=64))

    async def serve():
        got = []
        for _pass in range(2):
            for ofs in range(0, len(blobs), 64):
                futures = [served.submit(b) for b in blobs[ofs:ofs + 64]]
                got.extend(await asyncio.wait_for(
                    asyncio.gather(*futures), 60))
        await served.close()
        return got

    assert asyncio.run(serve()) == want
    assert None not in want
    assert counter_state(bulk_lim) == counter_state(served_lim)
    assert_same_tables(bulk, served)


def test_submit_routes_exact_path_rows():
    """Rows the columnar lanes cannot take (several descriptors, a
    non-vectorizable namespace) resolve through the exact per-request
    path, as in the JAX pipeline."""
    blobs = corpus(8, n=120)

    async def serve(pipeline):
        out = []
        for blob in blobs:
            out.append(await asyncio.wait_for(pipeline.submit(blob), 60))
        await pipeline.close()
        return out

    jp, jl = jax_pipeline(True)
    tp, tl = port_pipeline(True)
    assert asyncio.run(serve(tp)) == asyncio.run(serve(jp))
    assert counter_state(jl) == counter_state(tl)


@pytest.mark.parametrize("hot", [True, False], ids=["lane-on", "lane-off"])
def test_native_pipeline_resumes_from_jax_state(hot):
    """A JAX pipeline runs half a corpus; convert.storage_from_state hands
    its table over. The port's native pipeline then finishes the corpus
    byte-identically to a JAX pipeline finishing it from the same state.
    Both start the second half with empty plan caches: the port because
    native keys and plans re-derive, the JAX side because a fresh
    pipeline is built over its storage."""
    blobs = corpus(9)
    half = len(blobs) // 2
    jp, jl = jax_pipeline(hot)
    for ofs in range(0, half, 64):
        decide_cached(jp, blobs[ofs:min(ofs + 64, half)])
    jstorage = jp.storage
    jstorage._table.native_keys.clear()
    tstorage = convert.storage_from_state(
        jstorage._table.dump(), *(np.asarray(a) for a in jstorage._state),
        jstorage._epoch,
        clock=lambda: FROZEN_NOW, device="cpu",
    )
    jp2, jl2 = jax_pipeline(hot, storage=jstorage)
    tp, tl = port_pipeline(hot, storage=tstorage)
    drive_both(jp2, tp, blobs[half:], passes=2)
    assert counter_state(jl2) == counter_state(tl)
    assert_same_tables(jp2, tp)


def test_hot_lane_needs_the_plan_cache():
    with pytest.raises(RuntimeError, match="plan_cache_size"):
        port_pipeline(True, plan_cache_size=0)


def test_broken_host_lane_build_raises(tmp_path, monkeypatch):
    """A host lane that does not compile raises BuildError; nothing
    falls back to a pure-Python lane."""
    from limitador_tpu_torch.native import build

    broken = tmp_path / "hostpath.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(build, "SOURCE", broken)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(native.BuildError):
        port_pipeline(True)
    assert not native.available()
    assert "g++ failed" in native.build_error()


@pytest.mark.parametrize(
    "hot, gathered",
    [(True, False), (False, False), (True, True), (False, True)],
    ids=["lane-on", "lane-off", "lane-on-gathered", "lane-off-gathered"],
)
def test_rows_count_into_the_metrics_like_jax(hot, gathered):
    """authorized_calls, authorized_hits and limited_calls (with limit
    names) of the rows the pipeline decides: the hot lane's begin and
    finish aggregates (or the cached lane's plans), the miss lane's
    namespaces and the exact path, against the JAX pipeline's counts,
    two passes over one corpus. Submitted one at a time, or each pass
    at once, so that the miss lane names the limits of many rows in one
    batch."""
    from limitador_tpu.observability.metrics import (
        PrometheusMetrics as JMetrics,
    )
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics

    blobs = corpus(8, n=160)
    jm, tm = JMetrics(use_limit_name_label=True), PrometheusMetrics(True)
    jp, _jl = jax_pipeline(hot)
    tp, _tl = port_pipeline(hot)
    jp.metrics, tp.metrics = jm, tm

    async def serve(pipeline):
        out = []
        for _pass in range(2):
            if gathered:
                out.extend(await asyncio.wait_for(asyncio.gather(
                    *(pipeline.submit(blob) for blob in blobs)), 60))
                continue
            for blob in blobs:
                out.append(await asyncio.wait_for(pipeline.submit(blob), 60))
        await pipeline.close()
        return out

    assert asyncio.run(serve(tp)) == asyncio.run(serve(jp))

    def samples(metrics, family):
        return sorted(
            (tuple(sorted(s.labels.items())), s.value)
            for metric in metrics.registry.collect() if metric.name == family
            for s in metric.samples if s.name.endswith("_total"))

    for family in ("authorized_calls", "authorized_hits", "limited_calls"):
        assert samples(tm, family) == samples(jm, family), family
        assert samples(tm, family), family
