"""The port's usage observatory drains against the JAX package's, on the CPU.

Mixed traffic (the fuzz corpus through the native lanes with the lease
tier on, plus unconditional updates) runs through both packages over the
same frozen clock. Then ``drain_hot_slots(k)`` (B5 + B3a) and
``attribute_slots`` (of the native lane's leased counts) must return the
same records in the same order, and ``TenantUsageObservatory.top()`` the
same table. Tolerance: exact (the records' utilization is rounded the
same way in both packages).
"""

import numpy as np
import pytest

from limitador_tpu import Counter as JCounter
from limitador_tpu import Limit as JLimit
from limitador_tpu.observability.usage import (
    TenantUsageObservatory as JaxObservatory,
)
from limitador_tpu_torch import Counter, Limit
from limitador_tpu_torch.device.storage import hot_attribution
from limitador_tpu_torch.observability.usage import TenantUsageObservatory
from limitador_tpu_torch.ops import kernel as K

from .test_torch_lease import _Clock, _jax_leased, _port_leased
from .torch_native_corpus import D, corpus, decide_cached, limits
from .torch_reference import jax_reference_lane  # noqa: F401 (autouse)


def _drive(pairs, blobs, clocks, refresh=True):
    """One pass of ``blobs`` through both pipelines in 64-blob batches,
    brokers refreshed after each, then every window rolled (the corpus
    limits are tiny: headroom, and with it grantability, refreshes)."""
    for ofs in range(0, len(blobs), 64):
        part = blobs[ofs:ofs + 64]
        outs = [decide_cached(p, part) for p, _l, _b in pairs]
        assert outs[0] == outs[1]
        if refresh:
            for _p, _l, broker in pairs:
                broker.refresh()
    for clock in clocks:
        clock.now += 121.0


def _update_both(pairs, rng, n=40):
    """Unconditional updates (the Kuadrant Report role) on both storages."""
    for _ in range(n):
        u = f"user-{int(rng.integers(0, 12))}"
        delta = int(rng.integers(1, 4))
        for (p, _l, _b), (Lim, Cnt) in zip(
            pairs, ((JLimit, JCounter), (Limit, Counter))
        ):
            limit = Lim("api", 7, 120, [], [f"{D}.u"], name="per-user")
            p.storage.update_counter(Cnt(limit, {f"{D}.u": u}), delta)


@pytest.mark.parametrize("k", [1, 4, 64, 1 << 12])
def test_drain_hot_slots_matches_jax(k):
    clocks = (_Clock(), _Clock())
    config = dict(max_tokens=8, hot_threshold=2, ttl_s=30.0)
    pairs = (_jax_leased(clocks[0], limits(JLimit), **config),
             _port_leased(clocks[1], limits(Limit), **config))
    rng = np.random.default_rng(k)
    blobs = corpus(10 + k % 7)
    _drive(pairs, blobs, clocks)
    _update_both(pairs, rng)
    K.reset_launches()
    jrec = pairs[0][0].storage.drain_hot_slots(k)
    trec = pairs[1][0].storage.drain_hot_slots(k)
    assert trec == jrec
    assert 0 < len(trec) <= k
    # the column was read and reset: a second drain finds nothing
    assert pairs[1][0].storage.drain_hot_slots(k) == []
    assert pairs[0][0].storage.drain_hot_slots(k) == []
    assert not pairs[1][0].storage._state.hits.any()
    # on the CPU the drain ran the plain versions: no CUDA launch
    assert K.launches["drain_top_hits"] == 0
    # more traffic, leased admissions included, then the leased merge
    _drive(pairs, blobs, clocks)
    _drive(pairs, blobs, clocks)
    leased = [p.drain_leased_usage() for p, _l, _b in pairs]
    assert leased[0] == leased[1]
    assert leased[1], "no leased admissions to attribute"
    assert pairs[1][0].storage.attribute_slots(leased[1]) == \
        pairs[0][0].storage.attribute_slots(leased[0])
    assert pairs[1][0].storage.drain_hot_slots(k) == \
        pairs[0][0].storage.drain_hot_slots(k)


def test_drain_with_no_traffic_is_empty():
    clocks = (_Clock(), _Clock())
    pairs = (_jax_leased(clocks[0], limits(JLimit)),
             _port_leased(clocks[1], limits(Limit)))
    assert pairs[1][0].storage.drain_hot_slots(64) == []
    assert pairs[1][0].storage.drain_hot_slots(0) == []
    assert pairs[0][0].storage.drain_hot_slots(64) == []


def test_observatory_top_matches_jax():
    clocks = (_Clock(), _Clock())
    config = dict(max_tokens=8, hot_threshold=2, ttl_s=30.0)
    pairs = (_jax_leased(clocks[0], limits(JLimit), **config),
             _port_leased(clocks[1], limits(Limit), **config))
    observatories = (
        JaxObservatory(pairs[0][0].storage, pipeline=pairs[0][0], top_k=8),
        TenantUsageObservatory(pairs[1][0].storage, pipeline=pairs[1][0],
                               top_k=8),
    )
    rng = np.random.default_rng(3)
    for seed in (11, 12, 13):
        _drive(pairs, corpus(seed), clocks)
        _update_both(pairs, rng, n=10)
        merged = [obs.drain() for obs in observatories]
        assert merged[0] == merged[1]
    assert observatories[1].top() == observatories[0].top()
    assert observatories[1].top(3) == observatories[0].top(3)
    assert observatories[1].pressure() == observatories[0].pressure()
    jtop = observatories[0].top_counters()
    ttop = observatories[1].top_counters()
    assert ttop == jtop


def test_drain_hot_slots_takes_the_host_form(monkeypatch):
    """``drain_hot_slots`` drains through B5's host form (one call per
    drain, never the device-tensor ``drain_top_hits``) and returns the
    records that the device-tensor route gives on a copy of the same
    table: B5 on the hit column, then the B3a read and the attribution
    of the live slots."""
    clocks = (_Clock(), _Clock())
    config = dict(max_tokens=8, hot_threshold=2, ttl_s=30.0)
    pairs = (_jax_leased(clocks[0], limits(JLimit), **config),
             _port_leased(clocks[1], limits(Limit), **config))
    _drive(pairs, corpus(21), clocks)
    _update_both(pairs, np.random.default_rng(21))
    storage = pairs[1][0].storage
    hosted, tensors = [], []
    host_form, tensor_form = K.drain_top_hits_host, K.drain_top_hits

    def host_spy(ctx, k):
        hosted.append(k)
        return host_form(ctx, k)

    def tensor_spy(hits, k):
        tensors.append(k)
        return tensor_form(hits, k)

    monkeypatch.setattr(K, "drain_top_hits_host", host_spy)
    monkeypatch.setattr(K, "drain_top_hits", tensor_spy)
    for k in (64, 3):
        with storage._lock:
            copy = K.CounterTableState(*(t.clone() for t in storage._state))
            now_ms = storage._now_ms()
            _, counts, slots = tensor_form(copy.hits, k)
            live = counts > 0
            values, ttls = K.read_slots_plain(copy, slots[live], now_ms)
        want = []
        for slot, count, v, t in zip(slots[live].tolist(),
                                     counts[live].tolist(),
                                     values.tolist(), ttls.tolist()):
            record = {"slot": slot, "count": count}
            entry = storage._table.info.get(slot)
            if entry is not None:
                record.update(hot_attribution(entry[1], v, t))
            want.append(record)
        got = storage.drain_hot_slots(k)
        assert got == want and got
        assert hosted == [k] and tensors == []
        hosted.clear()
        _drive(pairs, corpus(22), clocks)
