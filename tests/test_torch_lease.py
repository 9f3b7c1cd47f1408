"""The port's quota-lease tier against the JAX package's, on the CPU.

The lease corpus of ``tests/test_native_lane_fuzz.py`` (fuzz seeds 6 and 7,
``LeaseConfig(max_tokens=8, hot_threshold=2, ttl_s=30)``, brokers refreshed
by hand on a manual clock) runs through both packages' native pipelines:
the response bytes of every row, ``broker.stats()`` after every refresh and
the tables after a forced settle must be equal (tolerance: exact; the port
settles through its B4c host form's plain twin here). Then the lease
contract of ``tests/test_lease.py`` on the port alone: device usage equals
admitted plus outstanding, a settle collapses to the exact admitted count,
grants never exceed the remaining headroom, and tiny limits are never
leased.
"""

import asyncio

import numpy as np
import pytest

from limitador_tpu import Limit as JLimit
from limitador_tpu.lease import LeaseConfig as JLeaseConfig
from limitador_tpu.tpu import AsyncTpuStorage, TpuStorage
from limitador_tpu.tpu.native_pipeline import NativeRlsPipeline as JaxNative
from limitador_tpu.tpu.pipeline import CompiledTpuLimiter
from limitador_tpu_torch import Limit
from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage
from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
from limitador_tpu_torch.lease import LeaseConfig
from limitador_tpu_torch.ops import kernel as K
from limitador_tpu_torch.server.proto import rls_pb2

from .torch_native_corpus import D, FROZEN_NOW, corpus, decide_cached, limits
from .torch_reference import jax_reference_lane  # noqa: F401 (autouse)


class _Clock:
    """Mutable frozen clock shared by storage and broker."""

    def __init__(self, now=FROZEN_NOW):
        self.now = now

    def __call__(self):
        return self.now


def _jax_leased(clock, limit_set, **config):
    limiter = CompiledTpuLimiter(AsyncTpuStorage(
        TpuStorage(capacity=1 << 12, clock=clock), max_delay=0.001))
    for limit in limit_set:
        limiter.add_limit(limit)
    pipeline = JaxNative(limiter, None, max_delay=0.001, hot_lane=True)
    broker = pipeline.attach_lease(JLeaseConfig(**config), autostart=False)
    broker._clock = clock
    return pipeline, limiter, broker


def _port_leased(clock, limit_set, **config):
    limiter = CompiledTorchLimiter(AsyncTorchStorage(
        TorchStorage(capacity=1 << 12, clock=clock, device="cpu"),
        max_delay=0.001))
    for limit in limit_set:
        limiter.add_limit(limit)
    pipeline = NativeRlsPipeline(limiter, max_delay=0.001, hot_lane=True)
    broker = pipeline.attach_lease(LeaseConfig(**config), autostart=False)
    broker._clock = clock
    return pipeline, limiter, broker


def _tables_equal(jp, tp):
    for name, j, t in zip(("values", "expiry_ms", "hits"),
                          jp.storage._state, tp.storage._state):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


@pytest.mark.parametrize("seed", [6, 7])
def test_lease_corpus_matches_jax(seed):
    config = dict(max_tokens=8, hot_threshold=2, ttl_s=30.0)
    jclock, tclock = _Clock(), _Clock()
    jp, _jl, jb = _jax_leased(jclock, limits(JLimit), **config)
    tp, _tl, tb = _port_leased(tclock, limits(Limit), **config)
    K.reset_launches()
    blobs = corpus(seed)
    for _pass in range(3):
        for ofs in range(0, len(blobs), 64):
            part = blobs[ofs:ofs + 64]
            assert decide_cached(tp, part) == decide_cached(jp, part), ofs
            summary_j, summary_t = jb.refresh(), tb.refresh()
            for key in ("returns", "credited_tokens", "grants"):
                assert summary_t[key] == summary_j[key], (ofs, key)
            stats = tb.stats()
            assert stats == jb.stats(), ofs
            assert stats["lease_granted_tokens"] == (
                stats["lease_admissions"]
                + stats["lease_returned_tokens"]
                + stats["lease_outstanding_tokens"]
            ), stats
        # roll every window: headroom (and grantability) refreshes and
        # leases cross window rolls
        jclock.now += 121.0
        tclock.now += 121.0
    assert tb.stats()["lease_admissions"] > 0, "leases never engaged"
    # forced settle: a reload bump strands every live balance onto the
    # ring, one begin syncs the epoch, the expiry sweep catches the rest
    for pipeline, clock, broker in ((jp, jclock, jb), (tp, tclock, tb)):
        pipeline.invalidate()
        decide_cached(pipeline, blobs[:8])
        clock.now += 10_000.0
        broker.refresh()
    stats = tb.stats()
    assert stats == jb.stats()
    assert stats["lease_outstanding_tokens"] == 0
    assert stats["lease_granted_tokens"] == (
        stats["lease_admissions"] + stats["lease_returned_tokens"]
    ), stats
    assert stats["lease_returned_tokens"] > 0
    _tables_equal(jp, tp)


# -- the lease contract on the port alone -------------------------------------


def _blob(domain="api", u="hot", m="GET"):
    req = rls_pb2.RateLimitRequest(domain=domain)
    d = req.descriptors.add()
    d.entries.add(key="m", value=m)
    d.entries.add(key="u", value=u)
    return req.SerializeToString()


def _build(limit_set, clock=None, **lease_kwargs):
    clock = clock or _Clock()
    kwargs = dict(max_tokens=64, hot_threshold=2, ttl_s=30.0)
    kwargs.update(lease_kwargs)
    pipeline, limiter, broker = _port_leased(clock, limit_set, **kwargs)
    return pipeline, limiter, broker, clock


def _remaining(limiter, namespace="api"):
    """(limit name, sorted variable values) -> remaining."""
    async def go():
        return {
            (c.limit.name, tuple(sorted((c.set_variables or {}).values()))):
            c.remaining
            for c in await limiter.get_counters(namespace)
        }

    return asyncio.run(go())


def _drive(pipeline, blobs):
    out = pipeline.decide_many(list(blobs), chunk=len(blobs))
    assert all(r is not None for r in out)
    return sum(1 for r in out if r == pipeline.OK_BLOB)


def test_device_state_is_exact_usage_plus_outstanding():
    pipeline, limiter, broker, _clock = _build(
        [Limit("api", 1000, 60, [f"{D}.m == 'GET'"], [f"{D}.u"],
               name="per-user")],
        max_tokens=16,
    )
    rng = np.random.default_rng(7)
    users = [f"u{i}" for i in range(8)]
    blobs = {u: _blob(u=u) for u in users}
    ok_by_user = dict.fromkeys(users, 0)
    for _round in range(20):
        picks = rng.choice(len(users), size=32).tolist()
        out = pipeline.decide_many([blobs[users[i]] for i in picks],
                                   chunk=32)
        for i, r in zip(picks, out):
            if r == pipeline.OK_BLOB:
                ok_by_user[users[i]] += 1
        broker.refresh()
    assert broker.stats()["lease_admissions"] > 0, "leases never engaged"
    info = pipeline.storage._table.info
    outstanding = {}
    for slot, tokens in broker.outstanding_by_slot().items():
        values = tuple(sorted((info[slot][1].set_variables or {}).values()))
        outstanding[values] = outstanding.get(values, 0) + tokens
    remaining = _remaining(limiter)
    for u in users:
        used = 1000 - remaining[("per-user", (u,))]
        assert used == ok_by_user[u] + outstanding.get((u,), 0)


def test_settle_collapses_to_exact_oracle_state():
    pipeline, limiter, broker, clock = _build(
        [Limit("api", 1000, 60, [f"{D}.m == 'GET'"], [f"{D}.u"],
               name="per-user")],
        ttl_s=5.0,
    )
    b = _blob()
    ok = _drive(pipeline, [b] * 2)
    ok += _drive(pipeline, [b] * 2)
    broker.refresh()
    ok += _drive(pipeline, [b])  # consume one leased token
    assert broker.stats()["lease_outstanding_tokens"] > 0
    K.reset_launches()
    clock.now += 6.0  # past the ttl: the sweep revokes and credits
    broker.refresh()
    stats = broker.stats()
    assert stats["lease_outstanding_tokens"] == 0
    assert stats["lease_returned_tokens"] > 0
    assert 1000 - _remaining(limiter)[("per-user", ("hot",))] == ok
    assert stats["lease_granted_tokens"] == (
        stats["lease_admissions"] + stats["lease_returned_tokens"]
    )
    # on the CPU the credit ran the plain version: no CUDA launch, in
    # either form
    assert K.launches["credit"] == 0
    assert K.launches["credit_host"] == 0


def test_grants_never_exceed_remaining_headroom():
    pipeline, limiter, broker, _clock = _build(
        [Limit("api", 10, 60, [], [f"{D}.u"], name="small")],
        max_tokens=64, hot_threshold=2,
    )
    b = _blob(u="greedy")
    ok = _drive(pipeline, [b] * 4)
    ok += _drive(pipeline, [b] * 4)
    assert ok == 8
    broker.refresh()
    stats = broker.stats()
    # sizing caps at max_value // 2 = 5 > headroom 2 -> denied
    assert stats["lease_grants"] == 0
    assert stats["lease_grant_denials"] >= 1
    assert 10 - _remaining(limiter)[("small", ("greedy",))] == 8


def test_tiny_limits_are_never_leased():
    pipeline, _limiter, broker, _clock = _build(
        [Limit("api", 1, 60, [], [f"{D}.u"], name="one")],
        hot_threshold=1,
    )
    b = _blob(u="x")
    _drive(pipeline, [b] * 2)
    _drive(pipeline, [b] * 2)
    broker.refresh()
    stats = broker.stats()
    assert stats["lease_grants"] == 0
    assert stats["lease_grant_denials"] == 0


def test_lease_tier_needs_the_hot_lane():
    limiter = CompiledTorchLimiter(AsyncTorchStorage(
        TorchStorage(capacity=64, device="cpu")))
    pipeline = NativeRlsPipeline(limiter, hot_lane=False)
    with pytest.raises(RuntimeError, match="hot lane"):
        pipeline.attach_lease(LeaseConfig())


def test_a_failing_credit_stops_the_broker_and_reports(monkeypatch):
    """A credit that cannot run (here: the storage's credit raises, as a
    kernel that does not build or launch would) stops the refresh thread
    and reports the exception; it is not swallowed and retried."""
    pipeline, _limiter, broker, clock = _build(
        [Limit("api", 1000, 60, [f"{D}.m == 'GET'"], [f"{D}.u"],
               name="per-user")],
        ttl_s=5.0, refresh_interval_s=0.01,
    )
    b = _blob()
    _drive(pipeline, [b] * 2)
    _drive(pipeline, [b] * 2)
    broker.refresh()
    assert broker.stats()["lease_outstanding_tokens"] > 0

    def broken_credit(*_args, **_kwargs):
        raise RuntimeError("credit kernel failed to launch")

    monkeypatch.setattr(pipeline.storage, "credit_columnar", broken_credit)
    seen = []
    broker.on_error = seen.append
    clock.now += 6.0  # past the ttl: the next pass revokes and credits
    broker.start()
    thread = broker._thread
    thread.join(timeout=10.0)
    assert not thread.is_alive()
    assert isinstance(broker.error, RuntimeError)
    assert seen == [broker.error]
    broker.close()
