"""The port's admission plane against the JAX package's, on the CPU.

Every comparison is exact, on inputs made from a seed with numpy:

- the circuit breaker: one scripted sequence of batch tokens, failures
  (transient, ``RuntimeError``, and a ``ValueError`` that must not count),
  stall checks, clock steps, probe claims and successes on a fake clock
  goes through both packages' ``CircuitBreaker``; states, transitions,
  ``last_error`` and ``open_seconds_total`` are equal step by step;
- the AIMD limiter: equal ``limit``, ``inflight`` and
  ``queue_wait_estimate`` sequences;
- the priority resolver: equal levels over namespace maps, limits-file
  annotations and descriptor entries;
- the failover store: the same checks and updates, then
  ``reconcile_into`` a JAX ``TpuStorage`` and a port
  ``TorchStorage(device="cpu")``: equal answers, journals and final
  counters, and the restore on failure (all-or-nothing and acknowledged
  chunks);
- ``AdmissionController.admit`` in monitor and enforce mode: equal shed
  reasons, counts, tickets and ``admission_debug()`` dicts;
- the chaos drill (JAX ``tests/test_admission.py``) on both packages:
  hang, stall trip, failover answers, unhang, probe, reconcile; the final
  counters equal the JAX run's and the oracle's. The port's drill also
  runs on the native pipeline and on the sharded table.

Then each of the JAX package's other admission tests has its port
counterpart (``test_port_*``). Every test runs inside
``torch_steady.steady()`` and stops the controllers, storages, servers
and executors it starts.
"""

import asyncio
import random
import socket
import threading

import grpc
import numpy as np
import pytest

from limitador_tpu_torch import AsyncRateLimiter, Context, Limit
from limitador_tpu_torch.admission import (
    METRIC_FAMILIES,
    SHED_REASONS,
    AdaptiveLimiter,
    AdmissionController,
    AdmissionShed,
    BreakerState,
    CircuitBreaker,
    PriorityResolver,
)
from limitador_tpu_torch.core.counter import Counter
from limitador_tpu_torch.device.batcher import AsyncTorchStorage
from limitador_tpu_torch.device.storage import TorchStorage
from limitador_tpu_torch.storage.base import StorageError
from limitador_tpu_torch.storage.failover import FailoverStore

from .torch_admission import (
    chaos,
    failover_script,
    hangable,
    namespace,
    port,
    table_values,
    wait_until,
)
from .torch_steady import steady

PORT = port()


JAX = namespace("limitador_tpu")


@pytest.fixture(scope="module", autouse=True)
def _grpc_aio_poller():
    """One grpc.aio channel for the module's length: grpc.aio starts its
    completion-queue poller thread with its first object and ends it some
    time after the last is gone, so a test serving gRPC would leave it
    running past its own end. Held here, the poller predates every
    test's thread count (``steady``)."""

    async def open_channel():
        return grpc.aio.insecure_channel("127.0.0.1:9")

    loop = asyncio.new_event_loop()
    channel = loop.run_until_complete(open_channel())
    try:
        yield
    finally:
        loop.run_until_complete(channel.close())
        loop.close()


@pytest.fixture(autouse=True)
def _steady(_grpc_aio_poller):
    with steady():
        yield


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


class FakeClock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, seconds):
        self.now += seconds


def _port_table(clock=None, capacity=1 << 8, cls=TorchStorage):
    kwargs = {"clock": clock} if clock is not None else {}
    return cls(capacity=capacity, device="cpu", **kwargs)


def _jax_table(clock=None, capacity=1 << 8, cls=None):
    from limitador_tpu.tpu.storage import TpuStorage

    kwargs = {"clock": clock} if clock is not None else {}
    return (cls or TpuStorage)(capacity=capacity, **kwargs)


# -- the breaker, the AIMD limiter and the resolver against the JAX ones ----

BREAKER_OPS = ("start", "finish", "finish", "fail_transient", "fail_runtime",
               "fail_value", "success", "advance", "advance", "check_stall",
               "is_open", "claim", "probe_succeeded", "trip")


def _breaker_run(pkg, seed):
    clock = FakeClock()
    breaker = pkg.CircuitBreaker(
        failure_threshold=2, stall_timeout=0.5, reset_timeout=1.0,
        warmup_stall_timeout=2.0, clock=clock)
    transitions = []
    breaker.listeners.append(transitions.append)
    rng = np.random.default_rng(seed)
    tokens = []
    steps = []
    errors = {
        "fail_transient": lambda: pkg.StorageError("boom", transient=True),
        "fail_runtime": lambda: RuntimeError(
            "CUDA error: an illegal memory access was encountered"),
        "fail_value": lambda: ValueError("negative delta"),
    }
    for _ in range(400):
        op = BREAKER_OPS[int(rng.integers(len(BREAKER_OPS)))]
        ret = None
        if op == "start":
            tokens.append(breaker.batch_started())
            ret = tokens[-1]
        elif op == "finish":
            if tokens:
                token = tokens.pop(int(rng.integers(len(tokens))))
                kind = int(rng.integers(4))
                exc = (None, errors["fail_transient"](),
                       errors["fail_runtime"](),
                       errors["fail_value"]())[kind]
                breaker.batch_finished(token, exc)
                ret = (token, kind)
        elif op in errors:
            breaker.record_failure(errors[op]())
        elif op == "success":
            breaker.record_success()
        elif op == "advance":
            clock.advance(float(rng.choice([0.1, 0.3, 0.6, 1.1, 2.5])))
        elif op == "check_stall":
            ret = breaker.check_stall()
        elif op == "is_open":
            ret = breaker.is_open()
        elif op == "claim":
            ret = breaker.try_claim_probe()
        elif op == "probe_succeeded":
            breaker.probe_succeeded()
        else:
            ret = breaker.trip("operator")
        steps.append((op, ret, breaker.state, breaker.last_error(),
                      breaker.open_seconds_total()))
    return steps, transitions


@pytest.mark.parametrize("seed", range(6))
def test_breaker_scripted_sequence_matches_the_jax_breaker(seed):
    got, got_transitions = _breaker_run(PORT, seed)
    want, want_transitions = _breaker_run(JAX, seed)
    assert got == want
    assert got_transitions == want_transitions
    # the script reaches every state, and a RuntimeError counts
    states = {s[2] for s in got}
    assert states == {"closed", "open", "half_open"}, states
    assert any((e or "").startswith("RuntimeError") for *_x, e, _t in got)


def _aimd_run(pkg, seed):
    clock = FakeClock()
    rng = np.random.default_rng(seed)
    lim = pkg.AdaptiveLimiter(
        max_inflight=int(rng.integers(16, 200)), min_limit=4,
        target_queue_wait=0.01, adjust_interval=0.1,
        backoff=float(rng.choice([0.5, 0.75])), clock=clock)
    out = []
    for _ in range(500):
        op = int(rng.integers(6))
        ret = None
        if op == 0:
            lim.observe(float(rng.choice(
                [0.0, 0.002, 0.004, 0.02, 0.3],
                p=[0.45, 0.2, 0.15, 0.12, 0.08])))
        elif op == 1:
            clock.advance(float(rng.choice([0.05, 0.2])))
        elif op == 2:
            ret = lim.try_acquire(int(rng.integers(4)))
        elif op == 3:
            lim.release(float(rng.uniform(0, 0.03))
                        if rng.integers(2) else None)
        elif op == 4 and rng.integers(8) == 0:
            ret = lim.set_ceiling(int(rng.integers(1, 300)))
        else:
            ret = lim.try_acquire(3)
        out.append((op, ret, lim.limit, lim.inflight,
                    lim.queue_wait_estimate()))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_aimd_limit_and_estimate_match_the_jax_limiter(seed):
    got, want = _aimd_run(PORT, seed), _aimd_run(JAX, seed)
    assert got == want
    assert len({step[2] for step in got}) > 3  # the limit really moved


PRIORITY_VALUES = ("low", "HIGH", " critical ", "normal", "0", "3", "7",
                   "wat", "")


@pytest.mark.parametrize("seed", range(3))
def test_priority_resolver_matches_the_jax_resolver(seed):
    rng = np.random.default_rng(seed)
    namespaces = [f"ns{i}" for i in range(6)]
    cli_pairs = [f"{ns}={rng.choice(['low', 'high', 'critical', '2'])}"
                 for ns in namespaces if rng.integers(3) == 0]
    annotations = []
    for ns in namespaces:
        for j in range(int(rng.integers(0, 3))):
            annotations.append(
                (ns, j, [None, "low", "normal", "high", "critical", "1"][
                    int(rng.integers(6))]))
    queries = []
    for _ in range(200):
        ns = namespaces[int(rng.integers(len(namespaces)))]
        kind = int(rng.integers(3))
        if kind == 0:
            values = None
        elif kind == 1:
            values = {}
        else:
            values = {"prio": PRIORITY_VALUES[
                int(rng.integers(len(PRIORITY_VALUES)))], "u": "x"}
        queries.append((ns, values))

    def levels(pkg):
        resolver = pkg.PriorityResolver(
            descriptor_key="prio",
            namespace_map=pkg.PriorityResolver.parse_namespace_map(
                cli_pairs),
            default=1)
        resolver.refresh([
            pkg.Limit(ns, 10 + j, 60, [], ["u"], name=f"l{j}",
                      **({"priority": p} if p else {}))
            for ns, j, p in annotations])
        return [resolver.resolve(ns, values) for ns, values in queries]

    got, want = levels(PORT), levels(JAX)
    assert got == want
    assert set(got) == {0, 1, 2, 3}
    for pkg in (PORT, JAX):
        for bad in ("ns", "ns=", "=high", "ns=urgent"):
            with pytest.raises(ValueError):
                pkg.PriorityResolver.parse_namespace_map([bad])


def test_the_inlined_schemas_match_the_admission_package():
    from limitador_tpu import admission as j_admission
    from limitador_tpu_torch.admission.priority import PRIORITIES
    from limitador_tpu_torch.observability import metrics, signals

    assert METRIC_FAMILIES == j_admission.METRIC_FAMILIES
    assert SHED_REASONS == j_admission.SHED_REASONS == metrics._SHED_REASONS
    assert PRIORITIES == signals._PRIORITIES == j_admission.PRIORITIES
    assert BreakerState.GAUGE == signals._BREAKER_GAUGE \
        == j_admission.BreakerState.GAUGE


# -- the failover store ------------------------------------------------------


def _failover_run(pkg, seed, table):
    clock = FakeClock(1_700_000_000.0)
    rng = np.random.default_rng(seed)
    limits = [pkg.Limit("ns", int(m), 3600, [], ["u"], name=f"m{m}")
              for m in (3, 8, 50)]
    limits.append(pkg.Limit("ns", 6, 60, [], ["u", "v"], name="pair"))
    store = pkg.FailoverStore(clock=clock)
    answers = []
    for _ in range(250):
        user = {"u": f"u{int(rng.integers(5))}", "v": str(int(rng.integers(2)))}
        picked = [limits[i] for i in sorted(set(
            rng.integers(0, len(limits), size=int(rng.integers(1, 4)))))]
        counters = [pkg.Counter.resolved_vars(limit, user)
                    for limit in picked]
        op = int(rng.integers(4))
        delta = int(rng.integers(0, 4))
        if op < 2:
            auth = store.check_and_update(counters, delta, bool(op))
            answers.append((auth.limited, auth.limit_name))
        elif op == 2:
            answers.append(store.is_within_limits(counters[0], delta))
        else:
            store.update_counter(counters[0], delta)
        clock.advance(float(rng.choice([0.0, 0.5])))
    journal = sorted((c.limit.name, tuple(sorted(c.set_variables.items())), d)
                     for c, d in store._journal.items())
    device = table(clock)
    for limit in limits:
        device.add_counter(limit)
    applied = store.reconcile_into(device)
    after = store.check_and_update(
        [pkg.Counter(limits[0], {"u": "u0"})], 3, False).limited
    return {"answers": answers, "journal": journal, "applied": applied,
            "ledger": (store.decisions, store.reconciled_deltas,
                       store.drained_high_water, store.journal_size()),
            "after": after,
            "spent": table_values(device, limits)}


@pytest.mark.parametrize("seed", range(4))
def test_failover_store_reconciles_like_the_jax_store(seed):
    got = _failover_run(PORT, seed, _port_table)
    want = _failover_run(JAX, seed, _jax_table)
    assert got == want
    # the table holds exactly the journal (an oracle of the admitted hits)
    assert got["applied"] == len(got["journal"]) > 0
    spent = {}
    for name, variables, delta in got["journal"]:
        spent[("ns", name, variables)] = delta
    assert got["spent"] == spent
    assert any(a == (True, a[1]) for a in got["answers"]
               if isinstance(a, tuple))  # some checks were limited
    assert got["after"] is False  # the oracle starts afresh


@pytest.mark.parametrize("acked", [None, 0, 2, 3])
def test_a_failed_reconcile_restores_the_unacknowledged_tail(acked):
    """A sink that raises keeps every unapplied delta: all of them for an
    all-or-nothing ``apply_deltas``, the tail past the acknowledged
    prefix for a chunked ``apply_deltas_acked``; both packages alike."""

    def go(pkg):
        store = pkg.FailoverStore()
        limit = pkg.Limit("ns", 100, 3600, [], ["u"])
        for u in ("a", "b", "c", "d"):
            store.check_and_update([pkg.Counter(limit, {"u": u})], 2, False)

        class Broken:
            def apply_deltas(self, items):
                raise pkg.StorageError("device gone again", transient=True)

        class Chunked:
            def apply_deltas_acked(self, items, ack):
                ack(acked)
                raise pkg.StorageError("died mid-replay", transient=True)

        with pytest.raises(pkg.StorageError):
            store.reconcile_into(Broken() if acked is None else Chunked())
        return (store.journal_size(), store.drained_high_water,
                store.reconciled_deltas)

    got, want = go(PORT), go(JAX)
    assert got == want
    assert got[0] == 4 - (acked or 0)


# -- the controller's admit decision ----------------------------------------


def _admit_run(pkg, mode, seed):
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    outcomes = []
    controllers = []
    for _trial in range(60):
        max_inflight = int(rng.integers(1, 12))
        lim = pkg.AdaptiveLimiter(max_inflight=max_inflight, min_limit=1,
                                  clock=clock)
        adm = pkg.AdmissionController(
            mode=mode, overload=lim,
            shed_response=("unavailable", "overlimit")[int(rng.integers(2))],
            priorities=pkg.PriorityResolver(namespace_map={"vip": 3}))
        adm.shed_floor = int(rng.choice([0, 0, 1, 2]))
        for _ in range(int(rng.integers(0, max_inflight + 1))):
            lim.try_acquire(3)
        if rng.integers(2):
            lim.observe(float(rng.choice([0.0, 0.004, 0.05])))
        tickets = []
        for _ in range(int(rng.integers(1, 6))):
            ns = ("ns", "vip")[int(rng.integers(2))]
            values = {"priority": str(int(rng.integers(4)))} \
                if rng.integers(2) else None
            deadline = [None, 0.0, 0.0005, 0.02, 10.0][int(rng.integers(5))]
            try:
                ticket = adm.admit(ns, values, deadline)
            except pkg.AdmissionShed as shed:
                outcomes.append(("shed", shed.reason, shed.priority,
                                 shed.overlimit, shed.transient,
                                 lim.inflight))
            else:
                tickets.append(ticket)
                outcomes.append(("ticket", ticket.holds_slot, lim.inflight))
        for i in rng.permutation(len(tickets)).tolist():
            tickets[i].release()
            tickets[i].release()  # idempotent
        outcomes.append(("released", lim.inflight))
        outcomes.append(adm.admission_debug())
        controllers.append(adm)
    return outcomes


@pytest.mark.parametrize("mode", ["monitor", "enforce"])
@pytest.mark.parametrize("seed", range(2))
def test_admit_matches_the_jax_controller(mode, seed):
    got, want = _admit_run(PORT, mode, seed), _admit_run(JAX, mode, seed)
    assert got == want
    reasons = {o[1] for o in got if isinstance(o, tuple) and o[0] == "shed"}
    if mode == "enforce":
        assert reasons == {"deadline", "overload", "controller"}, reasons
    sheds = [d["sheds"] for d in got if isinstance(d, dict)]
    assert any(sheds)


def test_admission_metrics_match_the_jax_controller():
    """The same sheds, trips and failover decisions write the same
    ``admission_*`` samples into each package's PrometheusMetrics."""
    from limitador_tpu.observability.metrics import (
        PrometheusMetrics as JMetrics,
    )
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics

    def go(pkg, metrics):
        clock = FakeClock()
        lim = pkg.AdaptiveLimiter(max_inflight=2, min_limit=1, clock=clock)
        adm = pkg.AdmissionController(mode="enforce", overload=lim,
                                      metrics=metrics)
        tickets = []
        for i in range(6):
            try:
                tickets.append(adm.admit("ns", {"priority": str(i % 4)},
                                         10.0 if i % 2 else None))
            except pkg.AdmissionShed:
                pass
        lim.observe(5.0)
        for deadline in (0.1, 0.2):
            with pytest.raises(pkg.AdmissionShed):
                adm.admit("ns", None, deadline)
        adm.breaker.trip("test")
        limit = pkg.Limit("ns", 3, 60, [], ["u"])
        for _ in range(4):
            adm.failover_check_and_update([pkg.Counter(limit, {"u": "a"})],
                                          1, False)
        adm.failover_is_within_limits(pkg.Counter(limit, {"u": "a"}), 1)
        adm._tick_metrics()
        for t in tickets:
            t.release()
        adm._tick_metrics()
        text = metrics.render()
        text = text.decode() if isinstance(text, bytes) else text
        return sorted(
            line for line in text.splitlines()
            if line.startswith("admission_")
            and not line.startswith("admission_failover_seconds")
            and "_created" not in line)

    got = go(PORT, PrometheusMetrics())
    want = go(JAX, JMetrics())
    assert got == want
    families = {line.split("{")[0].split(" ")[0] for line in got}
    assert {f.replace("_total", "") for f in families} >= {
        "admission_sheds", "admission_breaker_state",
        "admission_failover_decisions", "admission_inflight",
        "admission_limit", "admission_breaker_transitions"}


# -- the chaos drill ---------------------------------------------------------


def _check_chaos(out, budget=120):
    assert out["warm"] == "ok"
    assert out["a"] == ["ok"] * 99
    assert out["settle_s"] < 5.0, "requests blocked on the dead plane"
    assert out["state_b"] != "closed"
    b = out["b"]
    assert sum(b.values()) == 40 and b["over"] == 0
    assert b["error"] >= 1   # the dispatched launch riding the dead plane
    assert b["ok"] >= 1      # queued requests drained to host decisions
    assert "error" not in out["c"]
    assert out["c"].count("ok") == budget and out["c"][-1] == "over"
    assert out["journal"] == 2
    assert out["debug"]["breaker"]["state"] in ("open", "half_open")
    assert out["debug"]["failover"]["decisions"] > 0
    assert out["closed"]
    assert out["journal_after"] == 0 and out["reconciled"] == 2
    assert out["after"] == "ok"


def test_chaos_drill_ends_with_the_jax_runs_counters_and_the_oracles():
    """Hang, stall trip, failover answers, unhang, probe, reconcile, on
    both packages. bulk: 100 before the hang, plus every hit of the load
    (a failed-over request's on the oracle and then the reconcile, a
    request riding the dead launch on the table itself); tight: exactly
    the budget the failover window admitted."""
    JHang = hangable(_jax_table().__class__)
    got = run(chaos(PORT, hangable(TorchStorage)(capacity=1 << 8,
                                                 device="cpu")))
    want = run(chaos(JAX, JHang(capacity=1 << 8)))
    _check_chaos(got)
    _check_chaos(want)
    oracle = {("bulk", "bulk", (("u", "shared"),)): 140,
              ("tight", "tight", (("u", "shared"),)): 120}
    assert got["spent"] == want["spent"] == oracle
    assert set(got["debug"]) == set(want["debug"])


def test_chaos_drill_on_the_sharded_table():
    """The same drill over ``TorchShardedStorage``: the probe is one B7a
    batch, the reconcile one B7c update; the counters end at the
    oracle's."""
    from limitador_tpu_torch.device.sharded import TorchShardedStorage

    device = hangable(TorchShardedStorage)(
        n_shards=4, local_capacity=1 << 8, global_region=8, device="cpu")
    out = run(chaos(PORT, device))
    _check_chaos(out)
    assert out["spent"] == {("bulk", "bulk", (("u", "shared"),)): 140,
                            ("tight", "tight", (("u", "shared"),)): 120}


def _blob(domain, user, hits=0):
    from limitador_tpu_torch.server.proto import rls_pb2

    req = rls_pb2.RateLimitRequest(domain=domain, hits_addend=hits)
    req.descriptors.add().entries.add(key="u", value=user)
    return req.SerializeToString()


def test_chaos_drill_on_the_native_pipeline():
    """Raw requests through the native pipeline (hot lane on): the hang
    wedges its columnar collect, the trip fails the dispatched chunks
    and sends queued rows down the exact path (decided on the oracle);
    while open, submits take the exact path; the probe and the reconcile
    close the breaker and the table holds every admitted hit: 100 warm,
    20 watched, the 40 of the load (on the table or the oracle) and 10
    on the oracle."""
    from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
    from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
    from limitador_tpu_torch.server.proto import rls_pb2

    ok = rls_pb2.RateLimitResponse.OK
    over = rls_pb2.RateLimitResponse.OVER_LIMIT

    async def main():
        device = hangable(TorchStorage)(capacity=1 << 8, device="cpu")
        storage = AsyncTorchStorage(device, max_delay=0.001)
        limiter = CompiledTorchLimiter(storage)
        bulk = Limit("bulk", 100_000, 3600, [], ["descriptors[0].u"],
                     name="bulk")
        tight = Limit("tight", 120, 3600, [], ["descriptors[0].u"],
                      name="tight")
        limiter.add_limit(bulk)
        limiter.add_limit(tight)
        pipeline = NativeRlsPipeline(limiter, max_delay=0.001,
                                     hot_lane=True)

        async def call(domain):
            try:
                out = await pipeline.submit(_blob(domain, "shared"))
            except StorageError:
                return "error"
            code = rls_pb2.RateLimitResponse.FromString(out).overall_code
            return {ok: "ok", over: "over"}[code]

        for _ in range(100):  # warm: plans, the hot lane, the kernels
            assert await call("bulk") == "ok"
        adm = AdmissionController(
            mode="enforce",
            breaker=CircuitBreaker(failure_threshold=2, stall_timeout=0.25,
                                   reset_timeout=0.2),
            watchdog_tick=0.05)
        storage.set_admission(adm)
        adm.add_drainable(limiter)
        adm.add_drainable(pipeline)
        adm.start(asyncio.get_running_loop())
        try:
            # watched batches: the breaker leaves its warm-up bound
            for _ in range(20):
                assert await call("bulk") == "ok"
            device.hang()

            async def staggered(i):
                await asyncio.sleep(0.0 if i < 5 else 0.06 if i < 10
                                    else 0.12)
                return await call("bulk")

            b = await asyncio.wait_for(
                asyncio.gather(*[staggered(i) for i in range(40)]), 10.0)
            assert adm.breaker.state != BreakerState.CLOSED
            # the pipeline takes a flush off its queue before it waits
            # for the window, so the load rode launches (failed at the
            # trip) or the oracle
            assert b.count("error") >= 1 and b.count("over") == 0
            assert [await call("bulk") for _ in range(10)] == ["ok"] * 10
            c = [await call("tight") for _ in range(150)]
            assert c.count("ok") == 120 and c[-1] == "over"
            assert "error" not in c
            device.unhang()
            assert await wait_until(
                lambda: adm.breaker.state == BreakerState.CLOSED)
            assert adm.failover.reconciled_deltas == 2
            assert table_values(device, [bulk, tight]) == {
                ("bulk", "bulk", (("descriptors[0].u", "shared"),)): 170,
                ("tight", "tight", (("descriptors[0].u", "shared"),)): 120}
            assert await call("bulk") == "ok"
        finally:
            device.unhang()
            await adm.close()
            await pipeline.close()
            await limiter.close()
            await storage.close()

    run(main())


@pytest.mark.parametrize("seed", range(2))
def test_failover_script_matches_the_jax_package(seed):
    """A forced trip, then seeded checks, reports and reads through the
    batched storage (all on the oracle), reconciled into each package's
    table: equal answers, journals, ledgers and counters."""
    got = failover_script(PORT, _port_table(), seed)
    want = failover_script(JAX, _jax_table(), seed)
    assert got == want
    assert got["applied"] == len(got["journal"]) > 0


def _late_decision(pkg, table):
    """A host decision taken while the recovery reconcile's apply runs:
    where does its delta end up? Returns (journal left, table spent)."""
    gate, entered = threading.Event(), threading.Event()
    apply = table.apply_deltas

    def slow_apply(items):
        entered.set()
        gate.wait(5.0)
        return apply(items)

    table.apply_deltas = slow_apply
    limit = pkg.Limit("ns", 100, 3600, [], ["u"], name="l")

    async def main():
        storage = pkg.AsyncStorage(table, max_delay=0.001)
        limiter = pkg.AsyncRateLimiter(storage)
        limiter.add_limit(limit)

        async def check(user):
            return await limiter.check_rate_limited_and_update(
                "ns", pkg.Context({"u": user}), 1)

        await check("a")
        adm = pkg.AdmissionController(
            mode="enforce",
            breaker=pkg.CircuitBreaker(reset_timeout=0.05),
            watchdog_tick=0.02)
        storage.set_admission(adm)
        adm.start()
        try:
            adm.breaker.trip("test")
            await check("a")  # journaled
            assert await wait_until(entered.is_set)
            await check("b")  # journaled while the reconcile applies
            gate.set()
            assert await wait_until(
                lambda: adm.breaker.state == pkg.BreakerState.CLOSED)
            await asyncio.sleep(0.2)  # room for a second reconcile
            return adm.failover.journal_size(), table_values(table, [limit])
        finally:
            gate.set()
            await adm.close()
            await storage.close()

    return run(main())


def test_a_decision_taken_during_the_reconcile_reaches_the_table():
    """The JAX controller drains the journal, applies it and closes; a
    decision journaled in between waits in the journal for the next
    recovery. The port reconciles it right after closing (ROADMAP
    Queue C)."""
    got = _late_decision(PORT, _port_table())
    want = _late_decision(JAX, _jax_table())
    assert want == (1, {("ns", "l", (("u", "a"),)): 2})
    assert got == (0, {("ns", "l", (("u", "a"),)): 2,
                       ("ns", "l", (("u", "b"),)): 1})


# -- port counterparts of the JAX package's admission tests ------------------


def test_port_breaker_full_lifecycle():
    clock = FakeClock()
    b = CircuitBreaker(failure_threshold=2, stall_timeout=1.0,
                       reset_timeout=5.0, clock=clock)
    assert b.state == BreakerState.CLOSED and not b.is_open()
    b.record_failure(StorageError("boom", transient=True))
    assert b.state == BreakerState.CLOSED
    b.record_failure(StorageError("boom", transient=True))
    assert b.state == BreakerState.OPEN and b.is_open()
    clock.advance(5.1)
    assert b.is_open()  # half-open still keeps the check path host-side
    assert b.state == BreakerState.HALF_OPEN
    assert b.try_claim_probe()
    assert not b.try_claim_probe()
    b.record_failure(StorageError("still dead", transient=True))
    assert b.state == BreakerState.OPEN
    clock.advance(5.1)
    assert b.try_claim_probe()
    b.record_success()  # a late batch does not close a half-open breaker
    assert b.state == BreakerState.HALF_OPEN
    b.probe_succeeded()
    assert b.state == BreakerState.CLOSED and not b.is_open()
    assert b.open_seconds_total() == pytest.approx(10.2, abs=0.01)


def test_port_breaker_stall_trip_and_non_storage_errors_ignored():
    clock = FakeClock()
    b = CircuitBreaker(stall_timeout=0.5, clock=clock)
    b.record_success()
    for _ in range(10):
        b.record_failure(ValueError("negative delta"))
    assert b.state == BreakerState.CLOSED
    token = b.batch_started()
    clock.advance(0.2)
    assert not b.check_stall()
    clock.advance(0.4)
    assert b.check_stall()
    assert b.state == BreakerState.OPEN
    assert "stalled" in (b.last_error() or "")
    b.batch_finished(token)  # a late completion does not flip the state
    assert b.state == BreakerState.OPEN


def test_port_breaker_counts_a_cuda_fault():
    """A CUDA fault reaches the breaker as torch's RuntimeError (the
    kernel wrappers' ``check`` and torch's own errors): it counts."""
    import torch

    b = CircuitBreaker(failure_threshold=2)
    fault = getattr(torch, "AcceleratorError", RuntimeError)
    assert issubclass(fault, RuntimeError)
    b.record_failure(RuntimeError("CUDA error: unspecified launch failure"))
    b.record_failure(RuntimeError("ct_check_and_update: cudaErrorLaunch"))
    assert b.state == BreakerState.OPEN
    assert b.last_error().startswith("RuntimeError")


def test_port_breaker_warmup_grace_spares_the_first_batch():
    clock = FakeClock()
    b = CircuitBreaker(stall_timeout=0.5, warmup_stall_timeout=10.0,
                       clock=clock)
    token = b.batch_started()
    clock.advance(5.0)
    assert not b.check_stall()
    assert b.state == BreakerState.CLOSED
    b.batch_finished(token)
    b.batch_started()
    clock.advance(0.6)
    assert b.check_stall()
    assert b.state == BreakerState.OPEN
    b2 = CircuitBreaker(stall_timeout=0.5, warmup_stall_timeout=10.0,
                        clock=clock)
    b2.batch_started()
    clock.advance(10.1)
    assert b2.check_stall()


def test_port_failed_probe_rearms_the_reset_dwell():
    clock = FakeClock()
    b = CircuitBreaker(failure_threshold=1, reset_timeout=5.0, clock=clock)
    b.record_failure(StorageError("x", transient=True))
    clock.advance(5.1)
    assert b.try_claim_probe()
    b.record_failure(StorageError("still dead", transient=True))
    clock.advance(2.0)
    assert not b.try_claim_probe()
    clock.advance(3.2)
    assert b.try_claim_probe()


def test_port_stale_inflight_tokens_cleared_on_trip():
    clock = FakeClock()
    b = CircuitBreaker(stall_timeout=0.5, reset_timeout=1.0, clock=clock)
    b.record_success()
    b.batch_started()  # never finishes
    clock.advance(0.6)
    assert b.check_stall()
    clock.advance(1.1)
    assert b.try_claim_probe()
    b.probe_succeeded()
    assert b.state == BreakerState.CLOSED
    clock.advance(10.0)
    assert not b.check_stall(), "a stale pre-trip token re-tripped"
    assert b.state == BreakerState.CLOSED


def test_port_breaker_consecutive_failures_reset_by_success():
    b = CircuitBreaker(failure_threshold=3)
    b.record_failure(StorageError("x", transient=True))
    b.record_failure(StorageError("x", transient=True))
    b.record_success()
    b.record_failure(StorageError("x", transient=True))
    b.record_failure(StorageError("x", transient=True))
    assert b.state == BreakerState.CLOSED


def test_port_aimd_backs_off_and_recovers():
    clock = FakeClock()
    lim = AdaptiveLimiter(max_inflight=100, min_limit=4,
                          target_queue_wait=0.01, adjust_interval=0.1,
                          backoff=0.5, clock=clock)
    assert lim.limit == 100
    for _ in range(3):
        clock.advance(0.2)
        lim.observe(0.5)
    assert lim.limit == 12  # 100 -> 50 -> 25 -> 12
    for _ in range(50):
        clock.advance(0.2)
        lim.observe(1.0)
    assert lim.limit == 4
    for _ in range(40):
        clock.advance(0.2)
        lim.observe(0.0)
    assert lim.limit > 4
    assert lim.queue_wait_estimate() < 0.01


def test_port_priority_shares_shed_low_first():
    lim = AdaptiveLimiter(max_inflight=10, min_limit=1)
    for _ in range(6):
        assert lim.try_acquire(3)
    assert not lim.try_acquire(0)
    assert lim.try_acquire(1)
    assert lim.try_acquire(1)
    assert not lim.try_acquire(1)
    assert lim.try_acquire(2)
    assert not lim.try_acquire(2)
    assert lim.try_acquire(3)
    assert not lim.try_acquire(3)


def test_port_priority_resolver_precedence():
    r = PriorityResolver(descriptor_key="prio",
                         namespace_map={"payments": 3}, default=1)
    r.refresh([
        Limit("api", 10, 60, [], ["u"], priority="high"),
        Limit("api", 99, 3600, [], ["u"]),
        Limit("batch", 10, 60, [], [], priority="low"),
    ])
    assert r.resolve("api", {"prio": "critical"}) == 3
    assert r.resolve("api", {"prio": "0"}) == 0
    assert r.resolve("api", {"prio": "wat"}) == 2
    assert r.resolve("payments", {}) == 3
    assert r.resolve("batch", None) == 0
    assert r.resolve("elsewhere", {}) == 1


def test_port_limit_priority_annotation_roundtrip_and_identity():
    a = Limit("ns", 10, 60, [], ["u"], priority="critical")
    b = Limit("ns", 10, 60, [], ["u"])
    assert a == b and hash(a) == hash(b)
    assert a.to_dict()["priority"] == "critical"
    assert "priority" not in b.to_dict()
    assert Limit.from_dict(a.to_dict()).priority == "critical"
    with pytest.raises(ValueError):
        Limit("ns", 10, 60, priority="urgent")


def test_port_failover_journal_reconciles_into_the_table():
    store = FailoverStore()
    device = _port_table()
    limit = Limit("ns", 100, 3600, [], ["u"])
    device.add_counter(limit)
    c = Counter(limit, {"u": "a"})
    for _ in range(3):
        assert not store.check_and_update([c.key()], 1, False).limited
    assert store.check_and_update([c.key()], 98, False).limited
    assert store.journal_size() == 1
    assert store.reconcile_into(device) == 1
    assert store.journal_size() == 0
    assert device.is_within_limits(c, 97)
    assert not device.is_within_limits(c, 98)
    assert store.check_and_update([c.key()], 100, False).limited is False


def test_port_failover_reconcile_failure_restores_journal():
    store = FailoverStore()
    limit = Limit("ns", 100, 3600, [], ["u"])
    store.check_and_update([Counter(limit, {"u": "a"})], 2, False)

    class Broken:
        def apply_deltas(self, items):
            raise StorageError("device gone again", transient=True)

    with pytest.raises(StorageError):
        store.reconcile_into(Broken())
    assert store.journal_size() == 1


def test_port_shed_is_never_an_ok_and_takes_no_batch_slot():
    rng = random.Random(7)
    for _trial in range(200):
        max_inflight = rng.randint(1, 20)
        lim = AdaptiveLimiter(max_inflight=max_inflight, min_limit=1)
        adm = AdmissionController(mode="enforce", overload=lim)
        held = sum(lim.try_acquire(3)
                   for _ in range(rng.randint(0, max_inflight)))
        if rng.random() < 0.5:
            lim.observe(rng.uniform(0.0, 0.1))
        deadline = rng.choice([None, 0.0, 0.0005, 10.0])
        priority = rng.randint(0, 3)
        try:
            ticket = adm.admit("ns", {"priority": str(priority)}, deadline)
        except AdmissionShed as shed:
            assert lim.inflight == held
            assert shed.reason in ("deadline", "overload")
            assert shed.transient
        else:
            assert lim.inflight == held + 1
            ticket.release()
            ticket.release()
            assert lim.inflight == held


def test_port_enforced_shed_short_circuits_before_the_batcher():
    from limitador_tpu_torch.server.proto import rls_pb2
    from limitador_tpu_torch.server.rls import RlsService

    async def main():
        storage = AsyncTorchStorage(_port_table(), max_delay=0.001)
        limiter = AsyncRateLimiter(storage)
        limiter.add_limit(Limit("api", 100, 60, [], ["u"]))
        lim = AdaptiveLimiter(max_inflight=1, min_limit=1)
        adm = AdmissionController(mode="enforce", overload=lim,
                                  shed_response="overlimit")
        storage.set_admission(adm)
        while lim.try_acquire(3):
            pass
        service = RlsService(limiter, admission=adm)
        req = rls_pb2.RateLimitRequest(domain="api")
        req.descriptors.add().entries.add(key="u", value="x")

        class Ctx:
            def invocation_metadata(self):
                return ()

            async def abort(self, code, details=""):
                raise AssertionError("overlimit mode must not abort")

        resp = await service.should_rate_limit(req, Ctx())
        assert resp.overall_code == rls_pb2.RateLimitResponse.OVER_LIMIT
        # no batch slot was taken: the batcher never even started
        assert storage.batcher._pending == []
        assert storage.batcher._task is None
        await adm.close()
        await storage.close()

    run(main())


def test_port_deadline_doomed_requests_shed_before_admission():
    lim = AdaptiveLimiter(max_inflight=10, min_limit=1)
    adm = AdmissionController(mode="enforce", overload=lim)
    lim.observe(0.050)
    with pytest.raises(AdmissionShed) as exc:
        adm.admit("ns", None, deadline=0.010)
    assert exc.value.reason == "deadline"
    assert lim.inflight == 0
    adm.admit("ns", None, deadline=10.0).release()


def test_port_monitor_mode_counts_sheds_but_admits():
    lim = AdaptiveLimiter(max_inflight=1, min_limit=1)
    adm = AdmissionController(mode="monitor", overload=lim)
    assert lim.try_acquire(3)
    assert adm.admit("ns", None, None) is not None
    debug = adm.admission_debug()
    assert sum(n for k, n in debug["sheds"].items()
               if k.startswith("overload")) == 1
    assert debug["recent_sheds"][-1]["enforced"] is False


def test_port_compiled_pipeline_fails_over_when_breaker_open():
    from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter

    async def main():
        device = hangable(TorchStorage)(capacity=1 << 8, device="cpu")
        storage = AsyncTorchStorage(device, max_delay=0.001)
        adm = AdmissionController(
            mode="enforce",
            breaker=CircuitBreaker(stall_timeout=0.25, reset_timeout=60))
        storage.set_admission(adm)
        limiter = CompiledTorchLimiter(storage)
        adm.add_drainable(limiter)
        limiter.add_limit(Limit("api", 5, 3600, [], ["descriptors[0].u"]))
        r = await limiter.check_rate_limited_and_update("api", {"u": "a"}, 1)
        assert not r.limited
        adm.breaker.trip("test")
        device.hang()  # the compiled lane must not touch the table now
        try:
            outs = [await limiter.check_rate_limited_and_update(
                "api", {"u": "a"}, 1) for _ in range(6)]
        finally:
            device.unhang()
        assert [o.limited for o in outs] == [False] * 5 + [True]
        assert adm.failover.journal_size() == 1
        await adm.close()
        await limiter.close()
        await storage.close()

    run(main())


def test_port_compiled_pipeline_trip_fails_queued_and_dispatched_chunks():
    """A trip while the compiled lane has a wedged launch and a queue:
    the queued requests get oracle decisions, the dispatched chunk a
    transient error; nothing waits on the dead plane."""
    from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter

    async def main():
        device = hangable(TorchStorage)(capacity=1 << 8, device="cpu")
        storage = AsyncTorchStorage(device, max_delay=0.001)
        limiter = CompiledTorchLimiter(storage)
        limiter.add_limit(Limit("api", 50, 3600, [], ["descriptors[0].u"]))
        adm = AdmissionController(
            mode="enforce",
            breaker=CircuitBreaker(stall_timeout=60, reset_timeout=60))
        storage.set_admission(adm)
        adm.add_drainable(limiter)
        await limiter.check_rate_limited_and_update("api", {"u": "w"}, 1)
        limiter.max_delay = 0.3  # the queue holds what arrives next
        device.hang()
        try:
            first = asyncio.ensure_future(
                limiter.check_rate_limited_and_update("api", {"u": "a"}, 1))
            await asyncio.sleep(0.5)  # dispatched, wedged in its collect
            rest = [asyncio.ensure_future(
                limiter.check_rate_limited_and_update("api", {"u": "b"}, 1))
                for _ in range(5)]
            await asyncio.sleep(0)  # queued
            adm.breaker.trip("test")
            outs = await asyncio.wait_for(
                asyncio.gather(first, *rest, return_exceptions=True), 5.0)
        finally:
            device.unhang()
        assert isinstance(outs[0], StorageError) and outs[0].transient
        assert [o.limited for o in outs[1:]] == [False] * 5, outs
        assert adm.failover.journal_size() == 1
        assert adm.failover.decisions == 5
        await adm.close()
        await limiter.close()
        await storage.close()

    run(main())


def test_port_update_path_fails_over_and_reconciles():
    async def main():
        device = hangable(TorchStorage)(capacity=1 << 8, device="cpu")
        storage = AsyncTorchStorage(device, max_delay=0.001)
        adm = AdmissionController(mode="monitor")
        storage.set_admission(adm)
        limiter = AsyncRateLimiter(storage)
        limit = Limit("api", 100, 3600, [], ["u"])
        limiter.add_limit(limit)
        adm.breaker.trip("test")
        await limiter.update_counters("api", Context({"u": "r"}), 7)
        assert adm.failover.journal_size() == 1
        assert adm.failover.reconcile_into(device) == 1
        assert device.is_within_limits(Counter(limit, {"u": "r"}), 93)
        assert not device.is_within_limits(Counter(limit, {"u": "r"}), 94)
        await adm.close()
        await storage.close()

    run(main())


def test_port_chunked_flush_takes_a_token_per_chunk_and_a_trip_fails_all():
    """Chunked dispatch: each chunk is a launch with its own
    breaker token; a trip while the first chunk is wedged fails every
    chunk of the flush, the ones still waiting for the window too."""

    async def main():
        device = hangable(TorchStorage)(capacity=1 << 10, device="cpu")
        storage = AsyncTorchStorage(device, max_delay=0.002,
                                    dispatch_chunk=4)
        limiter = AsyncRateLimiter(storage)
        limiter.add_limit(Limit("api", 1000, 3600, [], ["u"]))
        await limiter.check_rate_limited_and_update(
            "api", Context({"u": "w"}), 1)
        adm = AdmissionController(
            mode="enforce",
            breaker=CircuitBreaker(stall_timeout=60, reset_timeout=60))
        started = []
        real_start = adm.breaker.batch_started
        adm.breaker.batch_started = lambda: started.append(1) or real_start()
        storage.set_admission(adm)
        calls = [limiter.check_rate_limited_and_update(
            "api", Context({"u": f"u{i}"}), 1) for i in range(16)]
        outs = await asyncio.gather(*calls)
        assert not any(o.limited for o in outs)
        assert len(started) >= 2  # a flush of 16 hits in chunks of 4
        started.clear()
        device.hang()
        try:
            futs = [asyncio.ensure_future(limiter.check_rate_limited_and_update(
                "api", Context({"u": f"v{i}"}), 1)) for i in range(16)]
            await asyncio.sleep(0.1)
            mb = storage.batcher
            assert len(mb._inflight_batches) >= 2
            adm.breaker.trip("test")
            outs = await asyncio.wait_for(
                asyncio.gather(*futs, return_exceptions=True), 5.0)
        finally:
            device.unhang()
        assert all(isinstance(o, StorageError) for o in outs), outs
        await asyncio.sleep(0.1)
        assert not mb._inflight_batches
        await adm.close()
        await storage.close()

    run(main())


@pytest.mark.parametrize("native", [False, True],
                         ids=["standard", "native"])
def test_port_grpc_shed_semantics_end_to_end(native):
    """Over a real socket: an overload shed answers OVER_LIMIT under
    overlimit; a deadline-doomed request (a real gRPC deadline against a
    forced queue-wait estimate) answers UNAVAILABLE by default. Neither
    ever answers OK nor reaches the table; the native handler sheds the
    same way."""
    from limitador_tpu_torch.device.native_pipeline import NativeRlsPipeline
    from limitador_tpu_torch.device.pipeline import CompiledTorchLimiter
    from limitador_tpu_torch.server.proto import rls_pb2
    from limitador_tpu_torch.server.rls import serve_rls

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    async def main():
        lim = AdaptiveLimiter(max_inflight=1, min_limit=1)
        adm = AdmissionController(mode="enforce", overload=lim,
                                  shed_response="overlimit")
        storage = AsyncTorchStorage(_port_table(), max_delay=0.001)
        storage.set_admission(adm)
        limiter = (CompiledTorchLimiter if native else AsyncRateLimiter)(
            storage)
        limiter.add_limit(Limit("api", 100, 60, [], ["descriptors[0].u"]))
        pipeline = (NativeRlsPipeline(limiter, max_delay=0.001) if native
                    else None)
        server = await serve_rls(limiter, f"127.0.0.1:{port}",
                                 native_pipeline=pipeline, admission=adm)
        channel = grpc.aio.insecure_channel(f"127.0.0.1:{port}")
        stub = channel.unary_unary(
            "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit")

        async def call(timeout):
            blob = await stub(_blob("api", "x"), timeout=timeout)
            return rls_pb2.RateLimitResponse.FromString(blob).overall_code

        try:
            assert await call(5) == rls_pb2.RateLimitResponse.OK
            while lim.try_acquire(3):
                pass
            assert await call(5) == rls_pb2.RateLimitResponse.OVER_LIMIT
            while lim.inflight:
                lim.release()
            adm.shed_overlimit = False
            lim.observe(5.0)
            with pytest.raises(grpc.RpcError) as exc:
                await call(0.5)
            assert exc.value.code() == grpc.StatusCode.UNAVAILABLE
            assert adm.admission_debug()["sheds"] == {
                "deadline:normal": 1, "overload:normal": 1}
            # one decision reached the table: the first call's
            spent = table_values(storage.inner, limiter.get_limits("api"))
            assert list(spent.values()) == [1]
        finally:
            await channel.close()
            await server.stop(grace=None)
            await adm.close()
            if pipeline is not None:
                await pipeline.close()
            if native:
                await limiter.close()
            await storage.close()

    asyncio.run(main())


def test_port_watchdog_probe_runs_on_its_own_named_thread():
    """The probe runs on a fresh ``admission-probe`` thread; one wedged
    on a dead plane does not stop the watchdog, and after the plane comes
    back a later probe closes the breaker."""

    async def main():
        device = hangable(TorchStorage)(capacity=1 << 8, device="cpu")
        storage = AsyncTorchStorage(device, max_delay=0.001)
        adm = AdmissionController(
            mode="enforce",
            breaker=CircuitBreaker(stall_timeout=0.1, reset_timeout=0.1),
            watchdog_tick=0.02)
        storage.set_admission(adm)
        adm.start()
        try:
            device.hang()
            adm.breaker.trip("test")
            assert await wait_until(lambda: any(
                t.name.startswith("admission-probe")
                for t in threading.enumerate()), 5.0)
            await asyncio.sleep(0.3)  # probes time out, the dwell re-arms
            assert adm.breaker.state != BreakerState.CLOSED
            assert adm.breaker.last_error().startswith("TimeoutError")
            device.unhang()
            assert await wait_until(
                lambda: adm.breaker.state == BreakerState.CLOSED)
        finally:
            device.unhang()
            await adm.close()
            await storage.close()

    run(main())
