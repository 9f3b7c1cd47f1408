"""The admission plane's drills, shared by ``test_torch_admission.py``
(the port against the JAX package on the CPU) and ``test_torch_gpu.py``
(a ``cuda`` table against a ``cpu`` one on the card).

It imports numpy, the standard library and nothing of either package at
its top, so that the card's machine, which has no JAX, can import it:
each drill takes its package's classes as a namespace (``port()`` builds
the port's, ``namespace("limitador_tpu")`` the JAX package's).

- ``hangable(cls)``: a device storage whose collect step can be wedged,
  the hung device-sync failure mode. ``finish_check_many`` (the batchers'
  and the compiled pipeline's) and ``finish_check_columnar`` (the native
  pipeline's) wait on a gate before their answers download.
- ``chaos``: hang the plane under load; the stall watch trips, every
  request settles (host decisions or transient errors, nothing blocks),
  the failover window enforces a fresh budget exactly on the host; after
  the plane returns the probe and the reconcile close the breaker, and
  the table's counters equal an oracle fed every admitted hit.
- ``failover_script``: a deterministic failover window (a forced trip,
  seeded checks, reports and reads on the oracle) reconciled into the
  table; its answers, journal and final counters.
"""

import asyncio
import threading
import time
import types

import numpy as np


def namespace(top):
    """``top``'s classes (``limitador_tpu_torch``, or ``limitador_tpu``
    in the CPU tests) under the names the drills use."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{top}.{name}")

    root = importlib.import_module(top)
    admission = mod("admission")
    batcher = mod("device.batcher" if top.endswith("_torch")
                  else "tpu.batcher")
    return types.SimpleNamespace(
        AsyncRateLimiter=root.AsyncRateLimiter,
        Context=root.Context,
        Limit=root.Limit,
        AdaptiveLimiter=admission.AdaptiveLimiter,
        AdmissionController=admission.AdmissionController,
        AdmissionShed=admission.AdmissionShed,
        BreakerState=admission.BreakerState,
        CircuitBreaker=admission.CircuitBreaker,
        PriorityResolver=admission.PriorityResolver,
        Counter=mod("core.counter").Counter,
        AsyncStorage=getattr(batcher, "AsyncTorchStorage", None)
        or batcher.AsyncTpuStorage,
        collect_debug_stats=mod(
            "observability.device_plane").collect_debug_stats,
        StorageError=mod("storage.base").StorageError,
        FailoverStore=mod("storage.failover").FailoverStore,
    )


def port():
    """The port's classes under the names the drills use."""
    return namespace("limitador_tpu_torch")


def hangable(base):
    class Hangable(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._gate = threading.Event()
            self._gate.set()

        def hang(self):
            self._gate.clear()

        def unhang(self):
            self._gate.set()

        def finish_check_many(self, handle):
            self._gate.wait()
            return super().finish_check_many(handle)

        def finish_check_columnar(self, *args, **kwargs):
            self._gate.wait()
            return super().finish_check_columnar(*args, **kwargs)

    return Hangable


async def wait_until(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            return False
        await asyncio.sleep(0.02)
    return True


def table_values(limiter_or_storage, limits):
    """{(namespace, limit name, variables): spent} of the table (a
    storage's ``get_counters`` takes the limits, sync or async)."""
    counters = limiter_or_storage.get_counters(set(limits))
    return {(str(c.limit.namespace), c.limit.name,
             tuple(sorted(c.set_variables.items()))):
            c.limit.max_value - c.remaining for c in counters}


async def chaos(pkg, device, stall=0.25, reset=0.2, tick=0.05, load=40,
                budget=120, failover_checks=150):
    """The acceptance drill of JAX ``tests/test_admission.py`` on
    ``device`` (a ``hangable`` storage): returns what it observed, the
    table's spent counts after the reconcile and the failover ledger."""
    bulk = pkg.Limit("bulk", 100_000, 3600, [], ["u"], name="bulk")
    tight = pkg.Limit("tight", budget, 3600, [], ["u"], name="tight")
    storage = pkg.AsyncStorage(device, max_delay=0.001)
    limiter = pkg.AsyncRateLimiter(storage)
    limiter.add_limit(bulk)
    limiter.add_limit(tight)

    async def check(ns):
        try:
            r = await limiter.check_rate_limited_and_update(
                ns, pkg.Context({"u": "shared"}), 1)
            return "over" if r.limited else "ok"
        except pkg.StorageError:
            return "error"

    out = {}
    # The first batch loads the kernels before the breaker watches it.
    out["warm"] = await check("bulk")
    adm = pkg.AdmissionController(
        mode="enforce",
        breaker=pkg.CircuitBreaker(failure_threshold=2, stall_timeout=stall,
                                   reset_timeout=reset),
        watchdog_tick=tick,
    )
    storage.set_admission(adm)
    adm.start(asyncio.get_running_loop())
    try:
        out["a"] = [await check("bulk") for _ in range(99)]
        device.hang()

        async def staggered(i):
            await asyncio.sleep(0.0 if i < 5 else 0.06 if i < 10 else 0.12)
            return await check("bulk")

        t0 = time.perf_counter()
        b = await asyncio.wait_for(
            asyncio.gather(*[staggered(i) for i in range(load)]),
            timeout=10.0)
        out["settle_s"] = time.perf_counter() - t0
        out["state_b"] = adm.breaker.state
        out["b"] = {k: b.count(k) for k in ("ok", "error", "over")}
        out["c"] = [await check("tight") for _ in range(failover_checks)]
        out["journal"] = adm.failover.journal_size()
        out["debug"] = pkg.collect_debug_stats(storage)["admission"]
        device.unhang()
        out["closed"] = await wait_until(
            lambda: adm.breaker.state == pkg.BreakerState.CLOSED)
        out["journal_after"] = adm.failover.journal_size()
        out["reconciled"] = adm.failover.reconciled_deltas
        out["spent"] = table_values(device, [bulk, tight])
        out["after"] = await check("bulk")
    finally:
        device.unhang()
        await adm.close()
        await storage.close()
    return out


def failover_script(pkg, device, seed, n_ops=300):
    """Deterministic failover window on ``device`` (a storage, not
    hung): warm it, force a trip, run seeded checks, reports and reads
    through the batched storage (all decided on the oracle), then
    reconcile into the table. Returns the answers, the journal and the
    table's spent counts."""
    rng = np.random.default_rng(seed)
    limits = [
        pkg.Limit("fa", 5, 3600, [], ["u"], name="small"),
        pkg.Limit("fa", 40, 3600, [], ["u"], name="wide"),
        pkg.Limit("fb", 12, 3600, [], ["u", "v"], name="pair"),
    ]
    users = [f"u{i}" for i in range(6)]

    async def main():
        storage = pkg.AsyncStorage(device, max_delay=0.001)
        limiter = pkg.AsyncRateLimiter(storage)
        for limit in limits:
            limiter.add_limit(limit)
        warm = await limiter.check_rate_limited_and_update(
            "fa", pkg.Context({"u": "warm"}), 1)
        adm = pkg.AdmissionController(mode="monitor")
        storage.set_admission(adm)
        adm.breaker.trip("failover script")
        answers = [warm.limited]
        try:
            for _ in range(n_ops):
                op = int(rng.integers(3))
                ns = ("fa", "fb")[int(rng.integers(2))]
                ctx = pkg.Context({"u": users[int(rng.integers(len(users)))],
                                   "v": str(int(rng.integers(2)))})
                delta = int(rng.integers(0, 4))
                if op == 0:
                    r = await limiter.check_rate_limited_and_update(
                        ns, ctx, delta, bool(rng.integers(2)))
                    answers.append(("check", r.limited, r.limit_name))
                elif op == 1:
                    await limiter.update_counters(ns, ctx, delta)
                    answers.append(("report",))
                else:
                    r = await limiter.is_rate_limited(ns, ctx, delta)
                    answers.append(("read", r.limited, r.limit_name))
            journal = sorted(
                (str(c.limit.namespace), c.limit.name,
                 tuple(sorted(c.set_variables.items())), d)
                for c, d in adm.failover._journal.items())
            applied = adm.failover.reconcile_into(device)
            ledger = (adm.failover.decisions, adm.failover.reconciled_deltas,
                      adm.failover.drained_high_water,
                      adm.failover.journal_size())
            spent = table_values(device, limits)
        finally:
            await adm.close()
            await storage.close()
        return {"answers": answers, "journal": journal, "applied": applied,
                "ledger": ledger, "spent": spent}

    return asyncio.run(main())
