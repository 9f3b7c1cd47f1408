"""Twins of the host-memory storages for the port's comparison tests.

``HostTwin`` is the behaviour matrix's limiter (``tests/test_behavior.py``)
for the ``disk``, ``distributed`` and ``cached`` backends: every call goes
to a JAX limiter and to a port limiter over the same kind of storage, on
one clock frozen for the call; the two answers must be equal, and the JAX
one is returned for the test's own assertions. A cached pair flushes
both write-behind caches before the clock moves on, so that their
authorities stay in step. ``check_storages`` then holds the two storages'
whole state equal: the disk files' rows, the CRDT entries, the caches,
their pending batches and their authorities' cells.

``to_port`` turns a JAX-package argument into the port's; ``norm`` turns a
result of either package into plain values.
"""

from __future__ import annotations

import asyncio
import time

from limitador_tpu import AsyncRateLimiter as JAsyncRateLimiter
from limitador_tpu import Context as JContext
from limitador_tpu import Limit as JLimit
from limitador_tpu import RateLimiter as JRateLimiter
from limitador_tpu.core.counter import Counter as JCounter
from limitador_tpu.storage import keys as jkeys
from limitador_tpu_torch import AsyncRateLimiter, Context, Counter, Limit
from limitador_tpu_torch import RateLimiter
from limitador_tpu_torch.storage import keys as tkeys

BACKENDS = ("disk", "distributed", "cached")


class Clock:
    """A settable clock (seconds)."""

    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def to_port(x):
    """A JAX-package argument as the port's: limits through their dict
    form, counters by limit and variables, contexts by their bindings,
    containers element-wise."""
    if isinstance(x, JLimit):
        return Limit.from_dict(x.to_dict())
    if isinstance(x, JCounter):
        return Counter(to_port(x.limit), dict(x.set_variables))
    if isinstance(x, JContext):
        ctx = Context()
        ctx.variables = set(x.variables)
        ctx._bindings = {k: (list(map(dict, v)) if isinstance(v, list)
                             else dict(v) if isinstance(v, dict) else v)
                         for k, v in x._bindings.items()}
        return ctx
    if isinstance(x, (set, frozenset)):
        return type(x)(to_port(i) for i in x)
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(i) for i in x)
    return x


def norm(x):
    """A result of either package as plain values."""
    if isinstance(x, (set, frozenset)):
        return sorted((norm(i) for i in x), key=repr)
    if isinstance(x, (list, tuple)):
        return [norm(i) for i in x]
    if hasattr(x, "limited") and hasattr(x, "limit_name"):
        return ("result", bool(x.limited), x.limit_name,
                sorted((norm(c) for c in x.counters), key=repr))
    if hasattr(x, "set_variables"):
        return ("counter", repr(x.limit._identity), x.limit.max_value,
                x.limit.name, sorted(x.set_variables.items()), x.remaining,
                x.expires_in)
    if hasattr(x, "_identity"):
        return ("limit", repr(x._identity), x.max_value, x.name)
    if isinstance(x, (bool, int, float, str, type(None))):
        return x
    return str(x)


def disk_rows(storage):
    """Every row of a DiskStorage's table, in key order."""
    with storage._lock:
        return [(bytes(k), ns, v, e) for k, ns, v, e in storage._db.execute(
            "SELECT key, namespace, value, expiry FROM counters ORDER BY key")]


def crdt_entries(storage):
    """A CrInMemoryStorage's entries: key -> (kind, snapshot)."""
    with storage._lock:
        return {key: (type(e.value).__name__, e.value.snapshot())
                for key, e in storage._counters.items()}


def memory_cells(storage, keys_mod):
    """An InMemoryStorage's cells: key bytes -> (value, expiry), in
    LRU order for the qualified ones."""
    counter_cls = (Counter if keys_mod is tkeys else JCounter)
    with storage._lock:
        simple = {keys_mod.key_for_counter(counter_cls(limit, {})):
                  (ev.value_raw, ev.expiry)
                  for limit, ev in storage._simple.items()}
        qualified = [(keys_mod.key_for_counter(c), ev.value_raw, ev.expiry)
                     for c, ev in storage._qualified.items()]
    return simple, qualified


def cache_state(storage, keys_mod):
    """A CachedCounterStorage's whole state: its cache in insertion
    order, its pending batch, the identities it keeps, its operational
    counters and its authority's cells (an InMemoryStorage authority)."""
    cache = [(key, e.value.value_raw, e.value.expiry, e.pending,
              e.from_authority) for key, e in storage._cache.items()]
    return (cache, sorted(storage._batch.items()), sorted(storage._counters),
            sorted(storage._overshoot_baseline.items()),
            storage.counter_overshoot, storage.evicted_pending_writes,
            storage.flush_errors, storage.partitioned,
            memory_cells(storage.authority, keys_mod))


class HostTwin:
    """The behaviour tests' limiter over one of ``BACKENDS``."""

    def __init__(self, backend: str, tmp_path):
        from limitador_tpu.storage.cached import (
            CachedCounterStorage as JCached,
        )
        from limitador_tpu.storage.disk import DiskStorage as JDisk
        from limitador_tpu.storage.distributed import (
            CrInMemoryStorage as JCr,
        )
        from limitador_tpu.storage.in_memory import (
            InMemoryStorage as JMemory,
        )
        from limitador_tpu_torch.storage.cached import CachedCounterStorage
        from limitador_tpu_torch.storage.disk import DiskStorage
        from limitador_tpu_torch.storage.distributed import CrInMemoryStorage
        from limitador_tpu_torch.storage.in_memory import InMemoryStorage

        self.backend = backend
        self.t = time.time()
        clock = lambda: self.t  # noqa: E731
        self.loop = None
        if backend == "disk":
            self.jstorage = JDisk(str(tmp_path / "jax.db"), clock=clock)
            self.tstorage = DiskStorage(str(tmp_path / "port.db"),
                                        clock=clock)
        elif backend == "distributed":
            self.jstorage = JCr("test_node", clock=clock)
            self.tstorage = CrInMemoryStorage("test_node", clock=clock)
        else:
            self.loop = asyncio.new_event_loop()
            self.jstorage = JCached(JMemory(clock=clock), flush_period=0.002,
                                    clock=clock)
            self.tstorage = CachedCounterStorage(
                InMemoryStorage(clock=clock), flush_period=0.002, clock=clock)
        if self.loop is None:
            self.jlim = JRateLimiter(self.jstorage)
            self.tlim = RateLimiter(self.tstorage)
        else:
            self.jlim = JAsyncRateLimiter(self.jstorage)
            self.tlim = AsyncRateLimiter(self.tstorage)

    def _run(self, value):
        if asyncio.iscoroutine(value):
            return self.loop.run_until_complete(value)
        return value

    def __getattr__(self, name):
        jattr = getattr(self.jlim, name)
        tattr = getattr(self.tlim, name)

        def call(*args, **kwargs):
            self.t = time.time()
            got = self._run(jattr(*args, **kwargs))
            ported = self._run(tattr(*to_port(args),
                                     **{k: to_port(v)
                                        for k, v in kwargs.items()}))
            if self.loop is not None:
                self.flush()
            assert norm(got) == norm(ported), name
            return got

        return call

    def flush(self) -> None:
        self.loop.run_until_complete(self.jstorage.flush())
        self.loop.run_until_complete(self.tstorage.flush())

    def check_storages(self) -> None:
        if self.backend == "disk":
            assert disk_rows(self.jstorage) == disk_rows(self.tstorage)
        elif self.backend == "distributed":
            assert crdt_entries(self.jstorage) == crdt_entries(self.tstorage)
        else:
            assert cache_state(self.jstorage, jkeys) == cache_state(
                self.tstorage, tkeys)

    def cleanup(self) -> None:
        for storage in (self.jstorage, self.tstorage):
            self._run(storage.close())
        if self.loop is not None:
            self.loop.run_until_complete(self.loop.shutdown_default_executor())
            self.loop.close()
