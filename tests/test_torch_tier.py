"""The port's tiered storage against the JAX package's, on the CPU.

- B4d ``seed_slots`` and B4b ``rebase_epoch``: the plain versions (what a
  CPU tensor gets) against the jitted JAX programs, all three arrays.
- Every case of ``tests/test_tier.py`` as one scenario run through both
  packages by the same code: the recorded answers, then cold cells, heat,
  journal, ledgers, ``tier_stats``, slot tables and all three arrays.
- The churn fuzz of ``tests/test_tier_fuzz.py``: JAX tiered, port tiered
  and the port's ``InMemoryStorage`` on one clock, with manager rounds,
  killed rounds and the spill.
- The native pipeline over a tiered store with a small cache, hot lane on
  and off, one chunk per call. The JAX package's native pipeline counts a
  returning cold key from zero on a new slot (ROADMAP Queue C), so the
  port is held to the JAX package's single-tier pipeline over a table
  that never evicts, and the JAX fault is shown on a short input.
- Lease reclaim on demotion, the snapshot repair (held to
  ``InMemoryStorage``; the JAX run is shown losing the cold cell), the
  manager's failure contract and the server's tier options.

Tolerance: exact, except where a test says otherwise. Time-dependent
numbers (the measured cold-decide latency and the benefit priced from
it) are left out of the comparisons. Rounds run inline (``run_once``)
on a fake clock; one server test runs the manager's thread.
"""

import asyncio
import json
import os
import types

import grpc
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import limitador_tpu as J
from limitador_tpu.core.counter import Counter as JCounter
from limitador_tpu.lease import LeaseConfig as JLeaseConfig
from limitador_tpu.ops import kernel as JK
from limitador_tpu.storage.expiring_value import ExpiringValue as JEV
from limitador_tpu.storage.in_memory import InMemoryStorage as JInMemory
from limitador_tpu.tier import ColdStore as JColdStore
from limitador_tpu.tier import TieredStorage as JTiered
from limitador_tpu.tier import TierManager as JTierManager
from limitador_tpu.tpu import AsyncTpuStorage, TpuStorage
from limitador_tpu.tpu.native_pipeline import NativeRlsPipeline as JNative
from limitador_tpu.tpu.pipeline import CompiledTpuLimiter
import limitador_tpu_torch as T
from limitador_tpu_torch.core.counter import Counter as TCounter
from limitador_tpu_torch.device import AsyncTorchStorage, TorchStorage
from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
from limitador_tpu_torch.lease import LeaseConfig
from limitador_tpu_torch.ops import kernel as TK
from limitador_tpu_torch.server import __main__ as port_main
from limitador_tpu_torch.server.proto import rls_pb2
from limitador_tpu_torch.storage.base import StorageError
from limitador_tpu_torch.storage.expiring_value import ExpiringValue as TEV
from limitador_tpu_torch.tier import (
    METRIC_FAMILIES,
    ColdStore,
    TieredStorage,
    TierManager,
)

from .torch_batches import C, NEVER, SpyContext, dirty_scratch, seed_rows
from .torch_batches import table as _table
from .torch_native_corpus import FROZEN_NOW, NAMESPACES, corpus, limits
from .torch_http import flight_spool  # noqa: F401 (autouse)
from .torch_reference import jax_reference_lane  # noqa: F401 (autouse)


class FakeClock:
    def __init__(self):
        self.now = 1_700_000_000.0

    def __call__(self):
        return self.now

    def advance(self, s):
        self.now += s


def _port_tiered(**kwargs):
    return TieredStorage(device="cpu", **kwargs)


JAX = types.SimpleNamespace(
    name="jax", Limit=J.Limit, Context=J.Context, RateLimiter=J.RateLimiter,
    Counter=JCounter, ExpiringValue=JEV, InMemoryStorage=JInMemory,
    ColdStore=JColdStore, TieredStorage=JTiered, TierManager=JTierManager,
    LeaseConfig=JLeaseConfig,
)
PORT = types.SimpleNamespace(
    name="port", Limit=T.Limit, Context=T.Context, RateLimiter=T.RateLimiter,
    Counter=TCounter, ExpiringValue=TEV, InMemoryStorage=T.InMemoryStorage,
    ColdStore=ColdStore, TieredStorage=_port_tiered, TierManager=TierManager,
    LeaseConfig=LeaseConfig,
)


# -- B4d and B4b against the JAX programs --------------------------------------


def _jax_state(values, expiry, hits):
    return JK.CounterTableState(
        jnp.asarray(values), jnp.asarray(expiry), jnp.asarray(hits)
    )


def _torch_state(values, expiry, hits):
    return TK.CounterTableState(
        torch.from_numpy(values.copy()), torch.from_numpy(expiry.copy()),
        torch.from_numpy(hits.copy()),
    )


def _assert_tables(jstate, tstate):
    for name, j, t in zip(TK.CounterTableState._fields, jstate, tstate):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


@pytest.mark.parametrize("scratch", ["clean", "dirty"])
@pytest.mark.parametrize("padded", [True, False], ids=["padded", "full"])
@pytest.mark.parametrize("H", [8, 64, 1024])
def test_seed_slots_matches_jax(H, padded, scratch):
    """Real rows land verbatim with hits zeroed; the scratch row ends as
    the JAX program leaves it (value and expiry 0, hits 0 only where a
    padding row exists), also when it starts nonzero."""
    rng = np.random.default_rng(7000 + H + 3 * padded)
    now_ms = 1_000_000
    table = _table(rng, now_ms, {})
    if scratch == "dirty":
        table = dirty_scratch(table, rng)
    n_real = int(rng.integers(1, H)) if padded else H
    rows = seed_rows(rng, H, n_real, now_ms)
    jstate = JK.seed_slots(_jax_state(*table), *rows)
    tstate = TK.seed_slots(_torch_state(*table),
                           *(torch.from_numpy(a) for a in rows))
    _assert_tables(jstate, tstate)
    assert int(tstate.values[C]) == int(tstate.expiry_ms[C]) == 0
    expect_hits = 0 if padded or scratch == "clean" else int(table[2][C])
    assert int(tstate.hits[C]) == expect_hits


@pytest.mark.parametrize("scratch", ["clean", "dirty"])
@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("n", [1, 3, 8, 9])
def test_seed_slots_host_form_matches_jax(n, padded, scratch):
    """B4d's host form (the bare lists by value, ``padded`` standing for
    the JAX call's padding rows) equals ``JK.seed_slots`` on the list
    padded to the storage's bucket, or on the bare list, with a dirty
    scratch cell too."""
    rng = np.random.default_rng(7100 + 10 * n + padded)
    now_ms = 1_000_000
    table = _table(rng, now_ms, {})
    if scratch == "dirty":
        table = dirty_scratch(table, rng)
    H = max(8, 1 << (n - 1).bit_length()) if padded else n
    rows = seed_rows(rng, H, n, now_ms)
    jstate = JK.seed_slots(_jax_state(*table), *rows)
    ctx = TK.TableContext(_torch_state(*table))
    before = dict(TK.launches)
    tstate = TK.seed_slots_host(ctx, *(a[:n].copy() for a in rows), H > n)
    assert TK.launches == before  # the CPU runs the plain version
    assert tstate is ctx.state
    _assert_tables(jstate, tstate)


def _rebind_cases(tmp_path):
    """Each way a single-table storage takes a table: the constructor,
    clear(), a checkpoint loaded in place, a restore (plain and tiered)
    and the JAX-state carry-over."""
    from limitador_tpu_torch.convert import storage_from_state

    def build(cls=TorchStorage):
        return cls(capacity=64, device="cpu")

    def cleared():
        storage = build()
        old = storage._ctx
        storage.clear()
        return storage, old

    def loaded():
        storage = build()
        path = str(tmp_path / "t.ckpt")
        storage.snapshot(path)
        ctx = storage._ctx
        storage.load_snapshot(path)  # in place: the same table, bound
        assert storage._ctx is ctx
        return storage, None

    def restored(cls):
        path = str(tmp_path / f"{cls.__name__}.ckpt")
        build(cls).snapshot(path)
        return cls.restore(path, device="cpu"), None

    def converted():
        src = TpuStorage(capacity=64)
        dump = src._table.dump()
        dump["info"] = {s: (k, c.to_dict())
                        for s, (k, c) in dump["info"].items()}
        return storage_from_state(dump, *(np.asarray(a) for a in src._state),
                                  src._epoch, device="cpu"), None

    return {"init": lambda: (build(), None), "clear": cleared,
            "load_snapshot": loaded,
            "restore": lambda: restored(TorchStorage),
            "tiered_restore": lambda: restored(TieredStorage),
            "convert": converted}


@pytest.mark.parametrize("case", ["init", "clear", "load_snapshot", "restore",
                                  "tiered_restore", "convert"])
def test_every_new_table_rebinds_the_seed_context(case, tmp_path):
    """After each replacement of the table a promotion seed (B4d's host
    form through the bound context) lands in the new table, never in the
    one it replaced: the replacement bound a new context and left the old
    one on the old table."""
    storage, old = _rebind_cases(tmp_path)[case]()
    assert storage._ctx.state is storage._state
    if old is not None:
        assert old is not storage._ctx
        assert old.state is not storage._state
    with storage._lock:
        storage.seed_slot_values([3], [7], [1000])
    assert int(storage._state.values[3]) == 7
    assert int(storage._state.expiry_ms[3]) == 1000
    if old is not None:
        assert int(old.state.values[3]) == 0


@pytest.mark.parametrize("shift", [0, 1, 999_000, (1 << 31) - 1])
def test_rebase_epoch_matches_jax(shift):
    """expiry = max(expiry - shift, 0) from a device scalar, over
    expiries 0 and INT32_MAX, window ends and bucket TATs."""
    rng = np.random.default_rng(shift % 977)
    now_ms = 1_000_000
    lanes = {s: (True, 10, 250) for s in range(0, C, 7)}
    values, expiry, hits = _table(rng, now_ms, lanes)
    expiry[1:40:3] = 0
    expiry[2:40:3] = NEVER
    jstate = JK.rebase_epoch(_jax_state(values, expiry, hits),
                             jnp.int32(shift))
    tstate = TK.rebase_epoch(_torch_state(values, expiry, hits),
                             torch.tensor([shift], dtype=torch.int32))
    _assert_tables(jstate, tstate)
    assert TK.launches["rebase_epoch_device"] == 0  # CPU: the plain version


def test_seed_and_rebase_refuse_what_the_kernels_do_not_take():
    state = TK.make_table(8, "cpu")
    rows = [torch.zeros(4, dtype=torch.int32)] * 3
    assert TK.launches["seed_slots"] == 0
    TK.seed_slots(state, *rows)  # CPU: the plain version, no launch
    assert TK.launches["seed_slots"] == 0
    with pytest.raises(ValueError):
        TK.seed_slots(TK.CounterTableState(*(t.to("meta") for t in state)),
                      *rows)


# -- every case of tests/test_tier.py through both packages ---------------------


def _make(P, capacity=1 << 6, cache_size=8, **kw):
    clock = FakeClock()
    storage = P.TieredStorage(capacity=capacity, cache_size=cache_size,
                              clock=clock, **kw)
    return clock, storage, P.RateLimiter(storage)


def _limit(P, **kw):
    return P.Limit("ns", 10, 60, [], ["u"], **kw)


def _ident(counter):
    return (str(counter.namespace), counter.limit.name,
            tuple(sorted(counter.set_variables.items())))


def _counters(limiter, ns="ns"):
    return sorted(
        (c.set_variables.get("u"), c.remaining, c.expires_in)
        for c in limiter.get_counters(ns)
    )


def _cold_ident(storage, key):
    return _ident(storage._cold.cells[key][1])


def _cell_form(cell):
    if getattr(cell, "POLICY", None) == "token_bucket":
        return ("tb", cell.tat, cell.scale)
    return ("fw", cell.value_raw, cell.expiry)


def _tier_state(storage):
    """Everything the two packages must agree on, identities by counter."""
    cold = storage._cold
    info = storage._table.info
    stats = storage.tier_stats()
    for key in ("cold_decide_p50_ms", "cold_decide_p99_ms"):
        stats.pop(key)
    stats["cold"].pop("spill_path")
    return {
        "cold": [(_ident(c), _cell_form(cell))
                 for cell, c in cold.cells.values()],
        "heat": sorted((_ident(cold.cells[k][1]) if k in cold.cells
                        else None, n) for k, n in cold.hits.items()),
        "dirty": sorted(_ident(cold.cells[k][1]) for k in cold.dirty
                        if k in cold.cells),
        "promo_ledger": sorted(_ident(v[0]) for v in
                               storage._promo_ledger.values()),
        "demo_ledger": sorted(_ident(v[0]) for v in
                              storage._demo_ledger.values()),
        "stats": stats,
        "qualified": [(_ident(info[s][1]), s)
                      for s in storage._table.qualified.values()],
        "simple": sorted((_ident(info[s][1]), s)
                         for s in storage._table.simple.values()),
        "arrays": [np.asarray(a).tolist() if not torch.is_tensor(a)
                   else a.numpy().tolist() for a in storage._state],
    }


def case_eviction_demotes_the_exact_cell(P, out, tmp):
    clock, storage, limiter = _make(P, cache_size=4)
    limiter.add_limit(_limit(P))
    limiter.update_counters("ns", P.Context({"u": "victim"}), 7)
    clock.advance(10)
    for u in range(8):
        limiter.update_counters("ns", P.Context({"u": f"f{u}"}), 1)
    out.append(_counters(limiter))
    for delta in (3, 1):
        out.append(limiter.check_rate_limited_and_update(
            "ns", P.Context({"u": "victim"}), delta).limited)
    assert out[1:] == [False, True]
    return storage


def case_eviction_demotes_gcra_buckets_exactly(P, out, tmp):
    clock = FakeClock()
    bucket = P.Limit("ns", 10, 60, [], ["u"], policy="token_bucket")
    mem = P.RateLimiter(P.InMemoryStorage(10_000, clock=clock))
    storage = P.TieredStorage(capacity=1 << 6, cache_size=4, clock=clock)
    tiered = P.RateLimiter(storage)
    for limiter in (mem, tiered):
        limiter.add_limit(bucket)
        limiter.update_counters("ns", P.Context({"u": "b"}), 6)
    clock.advance(7)
    for u in range(8):
        for limiter in (tiered, mem):
            limiter.update_counters("ns", P.Context({"u": f"f{u}"}), 1)
    out.append(_counters(tiered))
    clock.advance(30)
    for delta in (5, 5, 1):
        r1 = mem.check_rate_limited_and_update(
            "ns", P.Context({"u": "b"}), delta).limited
        r2 = tiered.check_rate_limited_and_update(
            "ns", P.Context({"u": "b"}), delta).limited
        assert r1 == r2
        out.append(r2)
    return storage


def case_storage_surface_sees_cold_residents(P, out, tmp):
    clock, storage, limiter = _make(P, cache_size=4)
    limit = _limit(P)
    limiter.add_limit(limit)
    limiter.update_counters("ns", P.Context({"u": "cold"}), 9)
    for u in range(8):
        limiter.update_counters("ns", P.Context({"u": f"f{u}"}), 1)
    cold_counter = P.Counter(limit, {"u": "cold"})
    out.append(storage.is_within_limits(cold_counter, 1))
    out.append(storage.is_within_limits(cold_counter, 2))
    out.append(_counters(limiter))
    limiter.delete_limit(limit)
    out.append((len(storage._cold.cells), _counters(limiter)))
    limiter.add_limit(limit)
    limiter.update_counters("ns", P.Context({"u": "cold"}), 5)
    for u in range(8):
        limiter.update_counters("ns", P.Context({"u": f"f{u}"}), 1)
    out.append(len(storage._cold.cells))
    storage.clear()
    out.append((len(storage._cold.cells), _counters(limiter)))
    assert out[:2] == [True, False] and out[-1] == (0, [])
    return storage


def case_promotion_seeds_the_exact_cell(P, out, tmp):
    clock, storage, limiter = _make(P, cache_size=8)
    limiter.add_limit(_limit(P))
    limiter.update_counters("ns", P.Context({"u": "p"}), 6)
    clock.advance(12)
    for u in range(12):
        limiter.update_counters("ns", P.Context({"u": f"f{u}"}), 1)
    key = next(k for k, (_cell, c) in storage._cold.cells.items()
               if c.set_variables.get("u") == "p")
    out.append(len(storage.promote_begin([key])))
    out.append(storage.promote_begin([key]))
    out.append(storage.promote_finish([key]))
    out.append(storage.promote_finish([key]))
    out.append(_counters(limiter))
    for delta in (4, 1):
        out.append(limiter.check_rate_limited_and_update(
            "ns", P.Context({"u": "p"}), delta).limited)
    assert out[:4] == [1, [], 1, 0] and out[-2:] == [False, True]
    return storage


def case_demotion_two_phase_is_idempotent_and_abortable(P, out, tmp):
    clock, storage, limiter = _make(P, cache_size=8)
    limiter.add_limit(_limit(P))
    limiter.update_counters("ns", P.Context({"u": "d"}), 5)
    key = next(iter(storage._table.qualified))
    out.append(len(storage.demote_begin([key])))
    out.append(storage.demote_begin([key]))
    out.append(storage.migrate_abort())
    out.append(storage.demote_finish([key]))
    out.append(len(storage.demote_begin([key])))
    out.append(storage.demote_finish([key]))
    out.append(storage.demote_finish([key]))
    out.append(_counters(limiter))
    assert out[5] == 1 and out[-1][0][1] == 5
    return storage


def case_manager_promotes_on_heat_and_demotes_on_watermark(P, out, tmp):
    clock, storage, limiter = _make(P, cache_size=16)
    limiter.add_limit(_limit(P))
    mgr = P.TierManager(storage, interval_s=3600.0)
    for u in range(20):
        limiter.update_counters("ns", P.Context({"u": f"u{u}"}), 1)
    out.append(mgr.run_once())
    cold_key = next(iter(storage._cold.cells))
    for _ in range(5):
        storage._cold.touch(cold_key)
    out.append(mgr.run_once())
    out.append(cold_key in storage._cold.cells)
    stats = mgr.stats()
    stats.pop("last_benefit_s")
    out.append(stats)
    assert out[0]["demoted"] >= 2 and out[1]["promoted"] >= 1
    return storage


def case_demotion_watermark_wins_over_a_blanket_veto(P, out, tmp):
    clock, storage, limiter = _make(P, cache_size=16)
    limiter.add_limit(_limit(P))
    for u in range(40):
        limiter.update_counters("ns", P.Context({"u": f"u{u}"}), 1)

    class BlanketObservatory:
        def top(self, k):
            return [{"slot": s} for s in range(64)]

    mgr = P.TierManager(storage, interval_s=3600.0,
                        observatory=BlanketObservatory())
    out.append(mgr.run_once())
    cold_key = next(iter(storage._cold.cells))
    for _ in range(5):
        storage._cold.touch(cold_key)
    out.append(mgr.run_once())
    assert out[0]["demoted"] >= 2 and out[1]["promoted"] >= 1
    return storage


def case_kill_mid_migration_aborts_with_pushback(P, out, tmp):
    clock, storage, limiter = _make(P, cache_size=8)
    limiter.add_limit(_limit(P))
    for u in range(12):
        limiter.update_counters("ns", P.Context({"u": f"u{u}"}), 1)
    mgr = P.TierManager(storage, interval_s=3600.0)

    def die():
        raise RuntimeError("killed mid-migration")

    mgr.kill_hook = die
    out.append(mgr.run_once())
    out.append(mgr.stats()["aborted"])
    out.append(len(_counters(limiter)))
    mgr.kill_hook = None
    out.append(mgr.run_once())
    assert out[0] == {"aborted": True, "promoted": 0, "demoted": 0}
    return storage


def case_cold_spill_journal_writes_absolute_rows(P, out, tmp):
    spill = os.path.join(tmp, f"cold-{P.name}.jsonl")
    clock, storage, limiter = _make(P, cache_size=4, spill_path=spill)
    limiter.add_limit(_limit(P))
    limiter.update_counters("ns", P.Context({"u": "s"}), 7)
    for u in range(8):
        limiter.update_counters("ns", P.Context({"u": f"f{u}"}), 1)
    limiter.update_counters("ns", P.Context({"u": "s"}), 1)  # a cold write
    rows = storage.drain_cold_journal()
    out.append(storage.spill_cold_rows(rows))
    storage._cold.close()
    with open(spill) as f:
        lines = f.read().splitlines()
    # the same JSON lines, row for row (the drain's set order aside)
    out.append(sorted(lines))
    assert len(lines) == len(rows) > 0
    assert all({"ns", "limit", "vars", "a", "b", "ts"} <= set(json.loads(r))
               for r in lines)
    return storage


def case_tiering_debug_surface(P, out, tmp):
    clock, storage, limiter = _make(P, cache_size=4)
    limiter.add_limit(_limit(P))
    for u in range(8):
        limiter.update_counters("ns", P.Context({"u": f"u{u}"}), 1)
    mgr = P.TierManager(storage, interval_s=3600.0)
    mgr.run_once()
    debug = mgr.tiering_debug()
    assert debug["host_row_s"] > debug["device_row_s"] > 0
    for key in ("cold_decide_p50_ms", "cold_decide_p99_ms", "host_row_s",
                "last_benefit_s"):
        debug.pop(key)
    debug["cold"].pop("spill_path")
    out.append(debug)
    return storage


class _Family:
    """Records what a render hook feeds one metric family."""

    def __init__(self, name, log):
        self.name, self.log = name, log

    def labels(self, *labels):
        return _Family(f"{self.name}{list(labels)}", self.log)

    def set(self, value):
        self.log.append((self.name, "set", value))

    def inc(self, value):
        self.log.append((self.name, "inc", value))

    def observe(self, _value):
        self.log.append((self.name, "observe"))


def case_tier_metrics_poll(P, out, tmp):
    clock, storage, limiter = _make(P, cache_size=4)
    limiter.add_limit(_limit(P))
    for u in range(8):
        limiter.update_counters("ns", P.Context({"u": f"u{u}"}), 1)
    mgr = P.TierManager(storage, interval_s=3600.0)
    mgr.run_once()
    log = []
    metrics = types.SimpleNamespace(**{
        name: _Family(name, log) for name in METRIC_FAMILIES})
    mgr.poll(metrics)
    mgr.poll(metrics)  # the second render must not count a round again
    out.append([e for e in log if e[0] != "tier_decision_benefit"])
    assert ("tier_migrations['demote']", "inc", mgr.demoted) in log
    return storage


def case_cold_store_heat_drain_is_read_and_reset(P, out, tmp):
    cold = P.ColdStore()
    limit = _limit(P)
    for u, hits in (("a", 3), ("b", 7), ("c", 1)):
        key = ("ns", 60, None, (("u", u),))
        cold.seat(key, P.ExpiringValue(1, 2e9), P.Counter(limit, {"u": u}))
        for _ in range(hits):
            cold.touch(key)
    out.append(cold.drain_hot(2))
    out.append(cold.drain_hot(2))
    out.append(cold.stats())
    assert [h for _k, h in out[0]] == [7, 3] and out[1] == []
    return None


CASES = [
    case_eviction_demotes_the_exact_cell,
    case_eviction_demotes_gcra_buckets_exactly,
    case_storage_surface_sees_cold_residents,
    case_promotion_seeds_the_exact_cell,
    case_demotion_two_phase_is_idempotent_and_abortable,
    case_manager_promotes_on_heat_and_demotes_on_watermark,
    case_demotion_watermark_wins_over_a_blanket_veto,
    case_kill_mid_migration_aborts_with_pushback,
    case_cold_spill_journal_writes_absolute_rows,
    case_tiering_debug_surface,
    case_tier_metrics_poll,
    case_cold_store_heat_drain_is_read_and_reset,
]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[5:])
def test_tier_case_matches_jax(case, tmp_path):
    jout, tout = [], []
    jstorage = case(JAX, jout, str(tmp_path))
    tstorage = case(PORT, tout, str(tmp_path))
    assert tout == jout
    if tstorage is not None:
        assert _tier_state(tstorage) == _tier_state(jstorage)


# -- the churn fuzz: JAX tiered, port tiered, port in-memory ------------------


def _fuzz_limits(P):
    return [
        P.Limit("ns", 9, 60, [], ["u"], name="w9"),
        P.Limit("ns", 40, 10, [], [], name="w40"),
        P.Limit("ns", 15, 30, [], ["u"], name="b15", policy="token_bucket"),
        P.Limit("ns2", 4, 5, [], ["u"], name="w4"),
    ]


def _fuzz_triple(spill_dir=None):
    clock = FakeClock()
    mem = T.RateLimiter(T.InMemoryStorage(10_000, clock=clock))
    out = [mem]
    for P in (JAX, PORT):
        spill = (os.path.join(spill_dir, f"{P.name}.jsonl")
                 if spill_dir else None)
        out.append(P.RateLimiter(P.TieredStorage(
            capacity=1 << 6, cache_size=8, clock=clock, spill_path=spill)))
    for limiter, P in zip(out, (PORT, JAX, PORT)):
        for lim in _fuzz_limits(P):
            limiter.add_limit(lim)
    return clock, out


def _fuzz_drive(seed, steps, clock, limiters, managers, kill_every=0):
    """tests/test_tier_fuzz.py's op stream, on three limiters: the port's
    answers must equal the JAX package's exactly (limited and the limit
    named) and the oracle's limited flag; a name may differ from the
    oracle's only on a cold resident, the big-limit lane's one tolerated
    naming skew (tests/test_tier_fuzz.py)."""
    import random

    rng = random.Random(seed)
    mem, jax_l, port_l = limiters
    users = [str(i) for i in range(40)]
    rounds = 0

    def killer():
        raise RuntimeError("fuzz: die between phase A and phase B")

    for step in range(steps):
        op = rng.random()
        ns = "ns" if rng.random() < 0.8 else "ns2"
        u = rng.choice(users)
        delta = rng.choice([1, 1, 1, 2, 3])
        if op < 0.55:
            r0 = mem.check_rate_limited_and_update(
                ns, T.Context({"u": u}), delta)
            rj = jax_l.check_rate_limited_and_update(
                ns, J.Context({"u": u}), delta)
            rt = port_l.check_rate_limited_and_update(
                ns, T.Context({"u": u}), delta)
            assert (rt.limited, rt.limit_name) == (rj.limited,
                                                   rj.limit_name), step
            assert rt.limited == r0.limited, step
            if rt.limit_name != r0.limit_name:
                storage = port_l.storage.counters
                limit = next(lim for lim in _fuzz_limits(T)
                             if lim.name == rt.limit_name)
                counter = TCounter(limit, {v.source: u
                                           for v in limit.variables})
                assert storage._key_of(counter) in storage._cold.cells, step
        elif op < 0.7:
            mem.update_counters(ns, T.Context({"u": u}), delta)
            jax_l.update_counters(ns, J.Context({"u": u}), delta)
            port_l.update_counters(ns, T.Context({"u": u}), delta)
        elif op < 0.85:
            r0 = mem.is_rate_limited(ns, T.Context({"u": u}), delta)
            rj = jax_l.is_rate_limited(ns, J.Context({"u": u}), delta)
            rt = port_l.is_rate_limited(ns, T.Context({"u": u}), delta)
            assert rt.limited == rj.limited == r0.limited, step
        else:
            clock.advance(rng.choice([0.2, 1.0, 4.0, 11.0]))
        if step % 25 == 24:
            rounds += 1
            kill = bool(kill_every) and rounds % kill_every == 0
            outs = []
            for mgr in managers:
                mgr.kill_hook = killer if kill else None
                outs.append(mgr.run_once())
                mgr.kill_hook = None
            assert outs[0] == outs[1], step
            assert outs[1]["aborted"] == kill
    return rounds


def _assert_final(clock, limiters):
    mem, jax_l, port_l = limiters
    for ns in ("ns", "ns2"):
        c0 = {_ident(c): (c.remaining, c.expires_in)
              for c in mem.get_counters(ns)}
        cj = {_ident(c): (c.remaining, c.expires_in)
              for c in jax_l.get_counters(ns)}
        ct = {_ident(c): (c.remaining, c.expires_in)
              for c in port_l.get_counters(ns)}
        assert ct == cj, ns
        assert ct.keys() == c0.keys(), ns
        for k in ct:
            assert ct[k][0] == c0[k][0], (ns, k)
            # the device keeps expiries in whole ms (tests/test_tier_fuzz.py)
            assert abs(ct[k][1] - c0[k][1]) <= 0.002, (ns, k)
    assert _tier_state(port_l.storage.counters) == _tier_state(
        jax_l.storage.counters)


def _managers(clock, limiters):
    return [P.TierManager(l.storage.counters, interval_s=3600.0)
            for P, l in ((JAX, limiters[1]), (PORT, limiters[2]))]


@pytest.mark.parametrize("seed", range(4))
def test_migration_churn_matches_jax_and_the_oracle(seed):
    clock, limiters = _fuzz_triple()
    managers = _managers(clock, limiters)
    _fuzz_drive(seed, 1500, clock, limiters, managers)
    stats = limiters[2].storage.counters.tier_stats()
    assert stats["cold"]["demotions"] > 0 and stats["cold"]["decisions"] > 0
    assert stats["cold"]["promotions"] > 0
    _assert_final(clock, limiters)


@pytest.mark.parametrize("seed", range(4, 7))
def test_kill_mid_migration_matches_jax_and_the_oracle(seed):
    clock, limiters = _fuzz_triple()
    managers = _managers(clock, limiters)
    _fuzz_drive(seed, 1200, clock, limiters, managers, kill_every=3)
    assert managers[1].stats()["aborted"] > 0
    stats = limiters[2].storage.counters.tier_stats()
    assert stats["promo_ledger"] == 0 and stats["demo_ledger"] == 0
    _assert_final(clock, limiters)


def test_churn_spill_lines_match_jax(tmp_path):
    clock, limiters = _fuzz_triple(str(tmp_path))
    managers = _managers(clock, limiters)
    _fuzz_drive(99, 1000, clock, limiters, managers)
    _assert_final(clock, limiters)
    for lim in limiters[1:]:
        lim.storage.counters._cold.close()
    jlines = (tmp_path / "jax.jsonl").read_text().splitlines()
    tlines = (tmp_path / "port.jsonl").read_text().splitlines()
    assert len(tlines) > 0
    # rows of one drain come in the journal set's order; the rows of each
    # drain and their order of drains are the same
    assert sorted(tlines) == sorted(jlines)
    assert [json.loads(r)["ts"] for r in tlines] == [
        json.loads(r)["ts"] for r in jlines]


# -- the native pipeline over a tiered store ------------------------------------


def _port_native(storage, hot=True, limit_list=None):
    limiter = CompiledTorchLimiter(AsyncTorchStorage(storage,
                                                     max_delay=0.001))
    for limit in limit_list or limits(T.Limit):
        limiter.add_limit(limit)
    return NativeRlsPipeline(limiter, max_delay=0.001, hot_lane=hot), limiter


def _jax_native(storage, hot=True, limit_list=None):
    limiter = CompiledTpuLimiter(AsyncTpuStorage(storage, max_delay=0.001))
    for limit in limit_list or limits(J.Limit):
        limiter.add_limit(limit)
    return JNative(limiter, None, max_delay=0.001, hot_lane=hot), limiter


def _counter_state(limiter):
    async def collect():
        out = set()
        for ns in NAMESPACES:
            for c in await limiter.get_counters(ns):
                out.add((str(c.namespace), c.limit.name,
                         tuple(sorted((c.set_variables or {}).items())),
                         c.remaining, round(c.expires_in or 0.0, 3)))
        return out

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(collect())
    finally:
        loop.close()


@pytest.mark.parametrize("hot", [True, False], ids=["lane-on", "lane-off"])
@pytest.mark.parametrize("seed", [1, 2])
def test_native_pipeline_over_tiers_answers_like_a_table_that_never_evicts(
        seed, hot):
    """The fuzz corpus (12 users, limits of 2 to 10) through the port's
    native pipeline over ``TieredStorage(cache_size=16)``: keys churn
    between the card and the cold tier every few rows, a manager round
    runs after every fourth chunk, and every answer and the final counters
    equal the JAX package's native pipeline over a single-tier table that
    never evicts (exact admission). One chunk of 4 rows per call: a chunk
    must not hold more distinct qualified counters than the hot set, or
    its own allocations would evict slots it has staged, in either
    package (ROADMAP Queue C)."""
    clock = lambda: FROZEN_NOW  # noqa: E731
    tstorage = _port_tiered(capacity=1 << 12, cache_size=16, clock=clock)
    tp, tl = _port_native(tstorage, hot)
    jp, jl = _jax_native(TpuStorage(capacity=1 << 12, clock=clock), hot)
    mgr = TierManager(tstorage, interval_s=3600.0, batch=4)
    blobs = corpus(seed)
    for _pass in range(2):
        for ofs in range(0, len(blobs), 4):
            part = blobs[ofs:ofs + 4]
            assert tp.decide_many(part, chunk=4) == jp.decide_many(
                part, chunk=4), ofs
            if ofs % 16 == 12:
                mgr.run_once()
    assert _counter_state(tl) == _counter_state(jl)
    stats = tstorage.tier_stats()["cold"]
    assert stats["demotions"] > 0 and stats["promotions"] > 0, stats


def _api_blob(u, m="GET"):
    req = rls_pb2.RateLimitRequest(domain="api")
    d = req.descriptors.add()
    d.entries.add(key="m", value=m)
    d.entries.add(key="u", value=u)
    return req.SerializeToString()


@pytest.mark.parametrize("hot", [True, False], ids=["lane-on", "lane-off"])
def test_native_lane_promotes_a_returning_cold_key(hot):
    """A user spends 2 of 7 (per-user), goes cold, then sends 7 more:
    the exact answer admits 5. The JAX package's native pipeline admits 7
    (a new slot counts from zero beside the cold cell); the port's admits
    5, promoting the cold cell with one B4d seed on the way in."""
    clock = lambda: FROZEN_NOW  # noqa: E731
    seq = ([_api_blob("v", "POST")] * 2
           + [_api_blob(f"f{i}", "POST") for i in range(8)])
    back = [_api_blob("v", "POST")] * 7
    answers = {}
    for name, build, storage in (
        ("jax", _jax_native, JTiered(capacity=64, cache_size=4,
                                     clock=clock)),
        ("port", _port_native, _port_tiered(capacity=64, cache_size=4,
                                            clock=clock)),
    ):
        pipeline, _limiter = build(storage, hot)
        for blob in seq:
            assert pipeline.decide_many([blob]) == [pipeline.OK_BLOB]
        assert len(storage._cold.cells) >= 1
        answers[name] = sum(pipeline.decide_many([b]) == [pipeline.OK_BLOB]
                            for b in back)
        if name == "port":
            assert storage._cold.stats()["promotions"] == 1
    assert answers == {"jax": 7, "port": 5}


# -- lease reclaim on demotion ---------------------------------------------------


def _leased(P, limit_list, storage, clock):
    """A hot-lane native pipeline of package P over ``storage`` with a
    lease broker refreshed by hand on ``clock``."""
    native = _jax_native if P is JAX else _port_native
    pipeline, _limiter = native(storage, limit_list=limit_list)
    broker = pipeline.attach_lease(
        P.LeaseConfig(max_tokens=64, hot_threshold=2, ttl_s=30.0),
        autostart=False)
    broker._clock = clock
    return pipeline, broker


def test_manager_demotion_settles_leases_like_jax():
    """Two users hold leases on a 4-counter hot set; a third and fourth
    push it over the watermark, and a manager round demotes the LRU
    front: ``reclaim_slots`` revokes the leases on the demoted slots and
    credits their unconsumed tokens through B4c before the slots go, so
    the cold cells carry exactly the admitted counts. Both packages give
    the same answers, broker stats, cold cells and arrays."""
    D = "descriptors[0]"
    results = {}
    for P in (JAX, PORT):
        clock = FakeClock()
        storage = P.TieredStorage(capacity=64, cache_size=4, clock=clock)
        limit = P.Limit("api", 1000, 60, [f"{D}.m == 'GET'"], [f"{D}.u"],
                        name="per-user")
        pipeline, broker = _leased(P, [limit], storage, clock)
        log = []
        for u in ("a", "b"):
            blob = _api_blob(u)
            for _ in range(2):
                log.append(pipeline.decide_many([blob, blob], chunk=2))
        log.append(broker.refresh()["grants"])
        before = broker.stats()
        for u in ("c", "d"):
            log.append(pipeline.decide_many([_api_blob(u)]))
        mgr = P.TierManager(storage, broker=broker, interval_s=3600.0)
        log.append(mgr.run_once())
        after = broker.stats()
        results[P.name] = (log, before, after, _tier_state(storage))
        assert before["lease_outstanding_tokens"] > 0
        assert after["lease_returned_tokens"] > before[
            "lease_returned_tokens"]
        assert after["lease_granted_tokens"] == (
            after["lease_admissions"] + after["lease_returned_tokens"]
            + after["lease_outstanding_tokens"])
        # the demoted users' cold cells hold their 4 admitted hits
        spent = {c.set_variables[f"{D}.u"]: cell.value_at(clock())
                 for cell, c in storage._cold.cells.values()}
        assert spent.get("a") == 4, spent
    assert results["port"] == results["jax"]


def test_reclaim_slots_returns_tokens_through_the_credit_lane():
    D = "descriptors[0]"
    clock = FakeClock()
    storage = _port_tiered(capacity=64, clock=clock)
    pipeline, broker = _leased(
        PORT, [T.Limit("api", 1000, 60, [f"{D}.m == 'GET'"], [f"{D}.u"],
                       name="per-user")], storage, clock)
    blob = _api_blob("hot")
    pipeline.decide_many([blob] * 2, chunk=2)
    pipeline.decide_many([blob] * 2, chunk=2)
    broker.refresh()
    outstanding = broker.stats()["lease_outstanding_tokens"]
    assert outstanding > 0
    slots = [h[0] for lease in broker._leases.values() for h in lease.hits]
    assert broker.reclaim_slots(slots) == outstanding
    assert broker.stats()["lease_outstanding_tokens"] == 0
    (counter,) = [c for c in _counter_state_sync(pipeline.limiter, "api")]
    assert counter == ("per-user", 1000 - 4)
    assert broker.reclaim_slots(slots) == 0


def _counter_state_sync(limiter, ns):
    loop = asyncio.new_event_loop()
    try:
        counters = loop.run_until_complete(limiter.get_counters(ns))
    finally:
        loop.close()
    return [(c.limit.name, c.remaining) for c in counters]


# -- the snapshot repair ---------------------------------------------------------


def _victim_setup(P, storage_factory):
    """tiers over a frozen clock; u=victim spends 7 of 10 and goes cold."""
    clock = FakeClock()
    storage = storage_factory(clock)
    limiter = P.RateLimiter(storage)
    limiter.add_limit(_limit(P))
    limiter.update_counters("ns", P.Context({"u": "victim"}), 7)
    for u in range(8):
        limiter.update_counters("ns", P.Context({"u": f"f{u}"}), 1)
    return clock, storage, limiter


def _admitted(P, limiter, n):
    return sum(not limiter.check_rate_limited_and_update(
        "ns", P.Context({"u": "victim"}), 1).limited for _ in range(n))


def test_snapshot_keeps_the_cold_tier_where_the_jax_snapshot_drops_it(
        tmp_path):
    """The port's tiered checkpoint carries the cold cells and the restore
    re-arms the spill path: after a restart u=victim has 3 left, as in
    InMemoryStorage, so 3 of 4 more hits pass. The JAX package's restore
    comes back without its cold tier and admits all 4 (ROADMAP Queue
    C)."""
    # the oracle
    clock = FakeClock()
    mem = T.RateLimiter(T.InMemoryStorage(10_000, clock=clock))
    mem.add_limit(_limit(PORT))
    mem.update_counters("ns", T.Context({"u": "victim"}), 7)
    for u in range(8):
        mem.update_counters("ns", T.Context({"u": f"f{u}"}), 1)
    want_counters = _counters(mem)
    want = _admitted(PORT, mem, 4)
    assert want == 3
    # the JAX package
    jclock, jstorage, _ = _victim_setup(
        JAX, lambda c: JTiered(capacity=64, cache_size=4, clock=c))
    assert len(jstorage._cold.cells) > 0
    jstorage.snapshot(str(tmp_path / "jax.ckpt"))
    jrestored = JTiered.restore(str(tmp_path / "jax.ckpt"), clock=jclock)
    jlim = J.RateLimiter(jrestored)
    jlim.add_limit(_limit(JAX))
    assert len(jrestored._cold.cells) == 0
    assert "victim" not in [c[0] for c in _counters(jlim)]
    assert _admitted(JAX, jlim, 4) == 4
    # the port
    spill = str(tmp_path / "cold.jsonl")
    tclock, tstorage, _ = _victim_setup(
        PORT, lambda c: _port_tiered(capacity=64, cache_size=4, clock=c))
    cold_before = _tier_state(tstorage)["cold"]
    tstorage.snapshot(str(tmp_path / "port.ckpt"))
    restored = TieredStorage.restore(str(tmp_path / "port.ckpt"),
                                     clock=tclock, device="cpu",
                                     spill_path=spill)
    assert _tier_state(restored)["cold"] == cold_before
    assert restored._cold.stats()["spill_path"] == spill
    tlim = T.RateLimiter(restored)
    tlim.add_limit(_limit(PORT))
    assert _counters(tlim) == want_counters
    assert _admitted(PORT, tlim, 4) == want
    # the journal spills to the re-armed path
    assert restored.spill_cold_rows(restored.drain_cold_journal()) > 0
    restored.close()
    assert os.path.getsize(spill) > 0
    # a single-tier storage refuses the tiered checkpoint
    with pytest.raises(StorageError, match="cold-tier"):
        TorchStorage.restore(str(tmp_path / "port.ckpt"), device="cpu")


# -- the manager's failure contract ------------------------------------------------


def test_a_failed_round_aborts_its_ledgers_and_raises():
    clock, storage, limiter = _make(PORT, cache_size=8)
    limiter.add_limit(_limit(PORT))
    for u in range(12):
        limiter.update_counters("ns", T.Context({"u": f"u{u}"}), 1)

    class BrokenBroker:
        def reclaim_slots(self, slots):
            raise RuntimeError("credit kernel failed to launch")

    mgr = TierManager(storage, broker=BrokenBroker(), interval_s=3600.0)
    before = _tier_state(storage)
    with pytest.raises(RuntimeError, match="credit kernel"):
        mgr.run_once()
    after = _tier_state(storage)
    assert after["promo_ledger"] == after["demo_ledger"] == []
    assert after["qualified"] == before["qualified"]
    assert after["cold"] == before["cold"]


def test_a_failed_round_stops_the_thread_and_reports():
    clock, storage, limiter = _make(PORT, cache_size=8)
    limiter.add_limit(_limit(PORT))
    for u in range(12):
        limiter.update_counters("ns", T.Context({"u": f"u{u}"}), 1)
    seen = []
    mgr = TierManager(storage, interval_s=0.05)

    def broken(*_args):
        raise RuntimeError("seed kernel failed to launch")

    storage.promote_finish = broken
    mgr.on_error = seen.append
    mgr.start()
    for _ in range(200):
        if seen:
            break
        import time

        time.sleep(0.01)
    mgr.close()
    assert len(seen) == 1 and mgr.error is seen[0]
    assert mgr.stats()["rounds"] == 0


# -- the server's tier options ---------------------------------------------------

LIMITS_YAML = """\
- namespace: api
  max_value: 3
  seconds: 3600
  variables: ["descriptors[0].u"]
  name: per-user
"""


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_tier_options_default_off_and_read_the_environment(monkeypatch):
    for var in ("TPU_TIER_MODE", "TPU_TIER_COLD",
                "TPU_TIER_MIGRATE_INTERVAL"):
        monkeypatch.delenv(var, raising=False)
    args = port_main.build_parser().parse_args(["x.yaml"])
    assert (args.tier_mode, args.tier_cold, args.tier_migrate_interval,
            args.cache_size) == ("off", "", 2.0, None)
    storage = port_main.build_storage(
        port_main.build_parser().parse_args(["x.yaml", "--device", "cpu",
                                             "--capacity", "64"]))
    assert type(storage) is TorchStorage
    monkeypatch.setenv("TPU_TIER_MODE", "on")
    monkeypatch.setenv("TPU_TIER_COLD", "/dev/null")
    monkeypatch.setenv("TPU_TIER_MIGRATE_INTERVAL", "0.5")
    args = port_main.build_parser().parse_args(
        ["x.yaml", "--device", "cpu", "--capacity", "64",
         "--cache-size", "16"])
    assert (args.tier_mode, args.tier_cold,
            args.tier_migrate_interval) == ("on", "/dev/null", 0.5)
    storage = port_main.build_storage(args)
    assert type(storage) is TieredStorage
    assert storage._cache_size == 16
    assert storage._cold.stats()["spill_path"] == "/dev/null"


@pytest.mark.parametrize("argv", [
    ["memory", "--tier-mode", "on"],
    ["torch", "--device", "cpu", "--tier-mode", "on", "--peer",
     "127.0.0.1:9"],
    ["torch", "--device", "cpu", "--tier-mode", "on", "--listen-address",
     "127.0.0.1:0"],
])
def test_tier_mode_that_cannot_come_up_exits(tmp_path, argv):
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(LIMITS_YAML)
    assert port_main.main([str(limits_path), *argv, "--rls-host",
                           "127.0.0.1",
                           "--http-port", str(_free_port()), "--rls-port",
                           str(_free_port())]) == 2


def _tiered_checkpoint(path):
    """A tiered checkpoint with cold cells (u=victim and others)."""
    _, storage, _ = _victim_setup(
        PORT, lambda c: _port_tiered(capacity=64, cache_size=4, clock=c))
    assert len(storage._cold.cells) > 0
    storage.snapshot(str(path))
    return path.read_bytes()


@pytest.mark.parametrize("argv", [
    ["torch", "--device", "cpu", "--capacity", "64"],
    ["torch", "--device", "cpu", "--capacity", "64", "--listen-address",
     "127.0.0.1:0"],
], ids=["single-node", "replicated"])
def test_a_tiered_checkpoint_without_tiers_exits_and_stays(tmp_path, argv):
    """Restoring a checkpoint with cold cells into a table without tiers
    would drop their spent quota: the server exits 2 and leaves the file
    where it is, instead of moving it aside and starting fresh."""
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(LIMITS_YAML)
    ckpt = tmp_path / "t.ckpt"
    saved = _tiered_checkpoint(ckpt)
    assert port_main.main([str(limits_path), *argv, "--snapshot-path",
                           str(ckpt), "--rls-host", "127.0.0.1",
                           "--http-port", str(_free_port()),
                           "--rls-port", str(_free_port())]) == 2
    assert ckpt.read_bytes() == saved
    assert not (tmp_path / "t.ckpt.rejected").exists()


def test_a_device_failure_while_restoring_is_not_a_fresh_start(
        tmp_path, monkeypatch):
    """Only an unreadable file is moved aside: a failure while the
    readable checkpoint loads into the table raises out of
    ``build_storage`` and the checkpoint stays."""
    ckpt = tmp_path / "t.ckpt"
    saved = _tiered_checkpoint(ckpt)

    def fail(self, data):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(TieredStorage, "_apply_snapshot", fail)
    args = port_main.build_parser().parse_args(
        ["x.yaml", "--device", "cpu", "--capacity", "64", "--tier-mode",
         "on", "--snapshot-path", str(ckpt)])
    with pytest.raises(RuntimeError, match="launch failed"):
        port_main.build_storage(args)
    assert ckpt.read_bytes() == saved
    assert not (tmp_path / "t.ckpt.rejected").exists()


ENVOY = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"


def _rls(u):
    req = rls_pb2.RateLimitRequest(domain="api")
    req.descriptors.add().entries.add(key="u", value=u)
    return req.SerializeToString()


def test_served_tiers_answer_like_the_oracle_and_restart_from_a_snapshot(
        tmp_path):
    """A native-pipeline server with ``--tier-mode on --cache-size 4`` and
    its manager thread running answers 60 calls over 12 users like the
    memory oracle, keeps its cold cells across a restart from
    ``--snapshot-path``, and re-arms ``--tier-cold``."""
    limits_path = tmp_path / "limits.yaml"
    limits_path.write_text(LIMITS_YAML)
    ckpt, spill = tmp_path / "t.ckpt", tmp_path / "cold.jsonl"
    clock = FakeClock()
    parse = port_main.build_parser().parse_args

    def argv(port, *extra):
        return parse([str(limits_path), *extra, "--rls-host", "127.0.0.1",
                      "--http-port", str(_free_port()),
                      "--rls-port", str(port)])

    tiered = ["torch", "--device", "cpu", "--capacity", "64",
              "--pipeline", "native", "--cache-size", "4", "--tier-mode",
              "on", "--tier-migrate-interval", "0.05", "--tier-cold",
              str(spill), "--snapshot-path", str(ckpt),
              "--snapshot-period", "3600"]

    async def drive():
        ports = (_free_port(), _free_port())
        server = await port_main.start(argv(ports[0], *tiered), clock=clock)
        oracle = await port_main.start(argv(ports[1], "memory"),
                                       clock=clock)
        try:
            assert server.tier_manager is not None
            async with grpc.aio.insecure_channel(
                    f"127.0.0.1:{ports[0]}") as sc, \
                    grpc.aio.insecure_channel(
                        f"127.0.0.1:{ports[1]}") as oc:
                for i in range(60):
                    blob = _rls(f"u{(i * 7) % 12}")
                    got = await sc.unary_unary(ENVOY)(blob, timeout=30)
                    want = await oc.unary_unary(ENVOY)(blob, timeout=30)
                    assert got == want, i
                    if i % 10 == 9:
                        await asyncio.sleep(0.1)  # a few manager rounds
            storage = server.storage
            assert storage._cold.stats()["demotions"] > 0
            assert server.tier_manager.stats()["rounds"] > 0
            assert server.tier_manager.error is None
            want_counters = sorted(
                (c.set_variables["descriptors[0].u"], c.remaining)
                for c in oracle.limiter.get_counters("api"))
        finally:
            await server.stop()
            await oracle.stop()
        restarted = await port_main.start(argv(_free_port(), *tiered),
                                          clock=clock)
        try:
            storage = restarted.storage
            assert type(storage) is TieredStorage
            assert len(storage._cold.cells) > 0
            assert storage._cold.stats()["spill_path"] == str(spill)
            got = sorted(
                (c.set_variables["descriptors[0].u"], c.remaining)
                for c in await restarted.limiter.get_counters("api"))
            assert got == want_counters
        finally:
            await restarted.stop()

    asyncio.run(asyncio.wait_for(drive(), 120))


# -- B3a's host form under the tiers ------------------------------------------


@pytest.mark.parametrize("seed", [3, 4])
def test_tiers_keep_the_jax_cells_through_peeks(seed):
    """A port TieredStorage and the JAX one in lockstep: evicting
    ``check_many`` batches (each eviction peeks its victim), two-phase
    demotions of resident keys and promotions of cold ones; answers,
    arrays, cold cells, ledgers and stats equal after every call."""
    from limitador_tpu.tpu.storage import _Request as JRequest
    from limitador_tpu_torch.device.storage import _Request as TRequest

    rng = np.random.default_rng(seed)
    sides = []
    for P, request in ((JAX, JRequest), (PORT, TRequest)):
        clock, storage, limiter = _make(P, capacity=64, cache_size=12)
        limits = [_limit(P, name="w"),
                  P.Limit("ns", 5, 30, [], ["u"], name="tb",
                          policy="token_bucket")]
        for limit in limits:
            limiter.add_limit(limit)
        sides.append((P, request, clock, storage, limits))
    stores = [side[3] for side in sides]

    def same(where):
        assert _tier_state(stores[0]) == _tier_state(stores[1]), where

    demoted = promoted = 0
    for step in range(30):
        users = rng.integers(0, 40, 16).tolist()
        bucket = (rng.random(16) < 0.3).tolist()
        answers = []
        for P, request, _clock, storage, limits in sides:
            requests = [request([P.Counter(limits[int(b)], {"u": f"u{u}"})],
                                int(1 + u % 2), False)
                        for u, b in zip(users, bucket)]
            answers.append([a.limited for a in storage.check_many(requests)])
        assert answers[0] == answers[1], step
        same(step)
        if step % 5 == 4:
            for phase in ("demote", "promote"):
                got = []
                for storage in stores:
                    keys = (list(storage._table.qualified)[:3]
                            if phase == "demote"
                            else list(storage._cold.cells)[:3])
                    begin = getattr(storage, f"{phase}_begin")
                    finish = getattr(storage, f"{phase}_finish")
                    rows = begin(keys)
                    got.append((len(rows), finish(keys)))
                assert got[0] == got[1], (step, phase)
                demoted += got[1][1] if phase == "demote" else 0
                promoted += got[1][1] if phase == "promote" else 0
                same((step, phase))
        step_s = float(rng.choice([0.0, 0.5, 3.0]))
        for side in sides:
            side[2].advance(step_s)
    assert demoted and promoted
    assert stores[1]._cold.cells  # the batches evicted into the cold tier


def test_a_peek_and_a_read_are_one_b3a_launch_without_padding():
    """Through a context that emulates the C entry points: an eviction
    peeks its one victim, a demotion's first phase its keys, each in one
    call of the bare list (the JAX storage pads it to a bucket of 8);
    ``is_within_limits`` and ``get_counters`` read in one call each."""
    clock, storage, limiter = _make(PORT, cache_size=4)
    limit = _limit(PORT)
    limiter.add_limit(limit)
    spy = SpyContext(storage._state)
    storage._ctx = spy
    before = TK.launches["read_slots_host"]
    for u in range(7):
        limiter.update_counters("ns", PORT.Context({"u": f"u{u}"}), 1)
    peeks = [c for c in spy.calls if c[0] == "read"]
    assert len(peeks) >= 3 and set(peeks) == {("read", 1)}
    spy.calls.clear()
    keys = list(storage._table.qualified)[:3]
    assert len(storage.demote_begin(keys)) == 3
    assert spy.calls == [("read", 3)]
    spy.calls.clear()
    storage.is_within_limits(TCounter(limit, {"u": "u6"}), 1)
    assert spy.calls == [("read", 1)]
    counters = limiter.get_counters("ns")
    assert spy.calls[-1] == ("read", 4) and len(counters) == 7
    assert TK.launches["read_slots_host"] - before == len(peeks) + 3

