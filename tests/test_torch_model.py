"""The port's serving-model fit against the JAX package's.

- Both estimators, with one injected calibration probe and one clock,
  take the same ingest stream (numpy-seeded launches over pow2 row
  buckets, then a level shift that trips the drift detector). After
  every refit their ``coefficients()``, ``signal_fields()``,
  ``drift_state``, ``capacity_debug()`` and three ``what_if`` queries are
  equal: exact for counts and states, ``rtol=1e-12`` for floats; so are
  the ``model_drift`` events on each package's event log and the
  ``model_*``/``capacity_*`` samples their ``poll`` sets.
- ``pipeline_context`` reads the port's stats names (the native
  pipeline's ``library_stats``, the sharded storage's ``launch_stats``)
  and samples what the JAX context samples from the JAX names.
- ``TierManager._row_costs`` equals the JAX one for the same estimator
  state and tier stats, and a churn drive's ``tier_migration`` events
  equal the JAX manager's.
- The recorder's ingest tap and the process wiring (``--model-fit``).

Every test runs inside ``torch_steady.steady()``.
"""

import math

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from limitador_tpu.observability import device_plane as j_device_plane
from limitador_tpu.observability import events as j_events
from limitador_tpu.observability import model as j_model
from limitador_tpu.observability.metrics import (
    PrometheusMetrics as JPrometheusMetrics,
)
from limitador_tpu.tier import TieredStorage as JTiered
from limitador_tpu.tier import TierManager as JTierManager
from limitador_tpu_torch.observability import device_plane, events, model
from limitador_tpu_torch.observability.metrics import PrometheusMetrics
from limitador_tpu_torch.tier import TieredStorage, TierManager
from tests.test_torch_tier import _fuzz_drive, _fuzz_triple
from tests.torch_steady import steady

# ground truth, seconds at calibration 1: host = H0 + HR rows + HL rows
# lease; device = D0 + DR rows
H0, HR, HL = 50e-6, 2e-6, -1e-6
D0, DR = 300e-6, 0.5e-6
ROWS = (64, 256, 1024, 2048)


class Clock:
    def __init__(self, now=100.0):
        self.now = now

    def __call__(self):
        return self.now


def assert_close(got, want, path="") -> None:
    """Equal structure; ints, strings, bools and None exact, floats
    within rtol 1e-12."""
    assert type(got) is type(want) or (
        isinstance(got, (int, float)) and isinstance(want, (int, float))
        and not isinstance(got, bool) and not isinstance(want, bool)
    ), (path, got, want)
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            assert_close(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0), (
            path, got, want)
    else:
        assert got == want, (path, got, want)


def _pair(clock, cal):
    return tuple(
        mod.ServingModelEstimator(calibration=lambda: cal[0], clock=clock)
        for mod in (model, j_model))


def _launches(rng, n, slow=1.0, lease=0.3):
    """n launches: (rows, host_s, device_s, queue_wait_s)."""
    rows = rng.choice(ROWS, n)
    eps = 1 + rng.normal(0, 0.02, n)
    host = (H0 + HR * rows + HL * rows * lease) * slow * eps
    dev = (D0 + DR * rows) * slow * eps
    wait = rng.uniform(0, 50e-6, n)
    return list(zip(rows.tolist(), host.tolist(), dev.tolist(),
                    wait.tolist()))


def _compare(port, jax):
    assert_close(port.coefficients(), jax.coefficients(), "coefficients")
    assert_close(port.signal_fields(), jax.signal_fields(), "signals")
    assert port.drift_state == jax.drift_state
    assert (port.observations, port.updates, port.dropped) == (
        jax.observations, jax.updates, jax.dropped)
    assert_close(port.capacity_debug(), jax.capacity_debug(), "capacity")
    for kw in ({"batch": 512}, {"lease_share": 0.9, "procs": 3},
               {"batch": 64, "lease_share": 0.0, "procs": 2}):
        assert_close(port.what_if(**kw), jax.what_if(**kw), f"what_if{kw}")
        assert_close(port.capacity_debug(**kw), jax.capacity_debug(**kw),
                     f"capacity{kw}")


def test_estimators_equal_jax_through_a_level_shift():
    with steady():
        clock, cal = Clock(), [10.0]
        port, jax = _pair(clock, cal)
        logs = (events.PodEventLog(clock=clock),
                j_events.PodEventLog(clock=clock))
        for est, log in zip((port, jax), logs):
            est.attach_event_log(log)
            est.attach_context(lambda: {"lease_share": 0.3,
                                        "collective_share": 0.1})
        rng = np.random.default_rng(14)
        stream = _launches(rng, 1600) + _launches(rng, 600, slow=2.5)
        states = set()
        for i, launch in enumerate(stream):
            clock.now += 0.001
            for est in (port, jax):
                est.ingest(*launch)
            if i % 40 == 39:
                clock.now += 0.01
                assert port.refit(force=True) == jax.refit(force=True)
                _compare(port, jax)
                states.add(port.drift_state)
        assert {"warmup", "ok", "drifted"} <= states
        assert port.signal_fields()["model_drift"] == 1
        assert logs[0].events_debug() == logs[1].events_debug()
        assert logs[0].counts()["model_drift"] == 1
        assert port.coefficients()["host"]["row"] > 0


def test_estimators_equal_jax_on_a_calibration_shift_and_a_full_buffer():
    with steady():
        clock, cal = Clock(), [10.0]
        port, jax = _pair(clock, cal)
        rng = np.random.default_rng(15)
        for phase, n in ((10.0, 1500), (5.0, 800)):
            cal[0] = phase
            for i, launch in enumerate(_launches(rng, n, slow=10.0 / phase)):
                clock.now += 0.0005
                for est in (port, jax):
                    est.ingest(*launch)
                if i % 50 == 49:
                    clock.now += 0.6
                    assert port.refit() == jax.refit()
                    _compare(port, jax)
        # past INGEST_CAP: the oldest drop
        for launch in _launches(rng, port.INGEST_CAP + 100):
            for est in (port, jax):
                est.ingest(*launch)
        assert port.dropped == jax.dropped == 100
        clock.now += 1.0
        assert port.refit() == jax.refit() == port.INGEST_CAP
        _compare(port, jax)


def _samples(text):
    return {
        (s.name, tuple(sorted(s.labels.items()))): s.value
        for family in text_string_to_metric_families(text)
        if family.name.startswith(("model_", "capacity_"))
        for s in family.samples
    }


def test_poll_sets_the_jax_samples_and_families_are_declared():
    with steady():
        assert model.METRIC_FAMILIES == j_model.METRIC_FAMILIES
        assert (model.MODEL_TERMS, model.MODEL_TARGETS,
                model.ATTRIBUTION_STAGES, model.DRIFT_STATES) == (
            j_model.MODEL_TERMS, j_model.MODEL_TARGETS,
            j_model.ATTRIBUTION_STAGES, j_model.DRIFT_STATES)
        clock, cal = Clock(), [4.0]
        port, jax = _pair(clock, cal)
        for i, launch in enumerate(_launches(np.random.default_rng(2), 900)):
            clock.now += 0.001
            for est in (port, jax):
                est.ingest(*launch)
            if i % 30 == 29:
                for est in (port, jax):
                    est.refit(force=True)
        metrics, j_metrics = PrometheusMetrics(), JPrometheusMetrics()
        port.poll(metrics)
        jax.poll(j_metrics)
        got = _samples(metrics.render().decode())
        want = _samples(j_metrics.render().decode())
        assert got.keys() == want.keys()
        for key in want:
            assert math.isclose(got[key], want[key], rel_tol=1e-12), key
        assert {name for name, _ in got} == set(model.METRIC_FAMILIES)


class _Stats:
    def __init__(self, **methods):
        self.__dict__.update(methods)


def test_pipeline_context_reads_the_port_names():
    """The port's context reads ``sharded_launches`` off the storage's
    ``launch_stats``, where the JAX context reads the batched storage's
    ``library_stats``; the shares it samples are the same."""
    with steady():
        state = {"leased": 0, "rows": 0, "misses": 0, "lean": 0,
                 "coupled": 0, "global": 0}

        def lane():
            return {"lease_admissions": state["leased"],
                    "native_lane_rows": state["rows"],
                    "native_lane_misses": state["misses"]}

        def launches():
            return {v: state[v] for v in ("lean", "coupled", "global")}

        port = model.pipeline_context(
            pipeline=_Stats(library_stats=lane),
            storage=_Stats(launch_stats=lambda: {
                "sharded_launches": launches()}))
        jax = j_model.pipeline_context(
            pipeline=_Stats(library_stats=lane),
            storage=_Stats(library_stats=lambda: {
                "sharded_launches": launches()}))
        rng = np.random.default_rng(5)
        shares = []
        for _ in range(12):
            for key in state:
                state[key] += int(rng.integers(0, 40))
            got, want = port(), jax()
            assert got == want
            shares.append(got)
        assert any("lease_share" in s and "collective_share" in s
                   for s in shares)
        # the context of a server without a native pipeline or sharded
        # storage samples nothing
        assert model.pipeline_context(storage=TieredStorage(
            capacity=64, cache_size=4, device="cpu"))() == {}


def test_pipeline_context_on_the_sharded_storage():
    from limitador_tpu_torch import Context, Limit, RateLimiter
    from limitador_tpu_torch.device.sharded import TorchShardedStorage

    with steady():
        storage = TorchShardedStorage(
            n_shards=1, local_capacity=256, global_namespaces=["g"],
            global_region=16, device="cpu")
        sample = model.pipeline_context(storage=storage)
        assert sample() == {}
        limiter = RateLimiter(storage)
        limiter.add_limit(Limit("g", 10, 60, [], []))
        limiter.add_limit(Limit("l", 10, 60, [], ["u"]))
        limiter.check_rate_limited_and_update("g", Context({}), 1)
        limiter.check_rate_limited_and_update("l", Context({"u": "a"}), 1)
        launched = storage.launch_stats()["sharded_launches"]
        assert sum(launched.values()) >= 2
        assert sample()["collective_share"] == (
            launched["coupled"] + launched["global"]
        ) / sum(launched.values())


class _FixedEstimator:
    def __init__(self, host_row, device_row):
        self.rows = (host_row, device_row)

    def coefficients(self):
        return {target: dict.fromkeys(model.MODEL_TERMS, 0.0) | {"row": row}
                for target, row in zip(model.MODEL_TARGETS, self.rows)}


def test_row_costs_equal_jax():
    with steady():
        port_s = TieredStorage(capacity=64, cache_size=4, device="cpu")
        jax_s = JTiered(capacity=64, cache_size=4)
        # no estimator, no cold decide yet: the priors
        assert TierManager(port_s)._row_costs() == \
            JTierManager(jax_s)._row_costs()
        # a fitted estimator of each package, fed the same launches
        clock, cal = Clock(), [2.0]
        port_e, jax_e = _pair(clock, cal)
        for i, launch in enumerate(_launches(np.random.default_rng(9), 800)):
            clock.now += 0.001
            for est in (port_e, jax_e):
                est.ingest(*launch)
            if i % 40 == 39:
                for est in (port_e, jax_e):
                    est.refit(force=True)
        got = TierManager(port_s, estimator=port_e)._row_costs()
        want = JTierManager(jax_s, estimator=jax_e)._row_costs()
        assert_close(list(got), list(want))
        coeff = port_e.coefficients()
        assert got == (coeff["host"]["row"], coeff["device"]["row"])
        assert min(got) > 0
        # rows not positive fall back, each on its own
        for rows in ((-1e-6, 3e-6), (4e-6, 0.0), (0.0, 0.0)):
            fixed = _FixedEstimator(*rows)
            assert TierManager(port_s, estimator=fixed)._row_costs() == \
                JTierManager(jax_s, estimator=fixed)._row_costs()


def test_tier_migration_events_equal_jax():
    """The churn drive of ``test_torch_tier.py`` with managers that price
    with one fitted estimator and log to each package's event log: the
    ``tier_migration`` events are equal."""
    with steady():
        clock, limiters = _fuzz_triple()
        fixed = _FixedEstimator(30e-6, 2e-6)
        logs = (j_events.PodEventLog(clock=clock),
                events.PodEventLog(clock=clock))
        managers = [
            M(limiter.storage.counters, estimator=fixed, events=log,
              interval_s=3600.0)
            for M, limiter, log in zip((JTierManager, TierManager),
                                       limiters[1:], logs)]
        _fuzz_drive(2, 600, clock, limiters, managers)
        want, got = (log.events_debug() for log in logs)
        assert got == want
        assert got["counts"]["tier_migration"] > 0
        assert {e["kind"] for e in got["events"]} == {"tier_migration"}
        assert all(e["detail"]["promoted"] + e["detail"]["demoted"] > 0
                   for e in got["events"])


def test_recorder_ingests_what_the_jax_recorder_ingests():
    with steady():
        clock = Clock()
        ests = _pair(clock, [1.0])
        t = [0.0]
        port = device_plane.DeviceStatsRecorder(clock=lambda: t[0])
        jax = j_device_plane.DeviceStatsRecorder()
        for rec, est in zip((port, jax), ests):
            rec.model = est
        rng = np.random.default_rng(21)
        for batch_id in range(30):
            n = int(rng.integers(0, 5))
            t_flush = 10.0 + batch_id
            entries = [(t_flush - float(w), None, "ns")
                       for w in rng.uniform(0, 0.003, n)]
            phases = {k: float(v) for k, v in zip(
                ("dispatch", "host_cache", "host_stage", "device_sync",
                 "unpack", "native_lane"), rng.uniform(0, 0.002, 6))}
            t[0] = t_flush + 0.004
            for rec in (port, jax):
                rec.record_batch(list(entries), batch_id, t_flush, phases)
        assert list(ests[0]._pending) == list(ests[1]._pending)
        assert 0 < len(ests[0]._pending) < 30


def test_process_wiring_and_the_switch(monkeypatch):
    monkeypatch.setenv("TPU_MODEL_FIT", "off")
    with steady():
        model._ENABLED = None
        assert not model.model_fit_enabled()
        assert device_plane.DeviceStatsRecorder().model is None
        model.set_model_fit_enabled(True)
        est = model.process_estimator()
        assert model.process_estimator() is est
        assert device_plane.DeviceStatsRecorder().model is est


@pytest.mark.parametrize("budget_ms", [0.5, 2.0, 50.0])
def test_headroom_against_the_budget_equals_jax(budget_ms):
    with steady():
        clock, cal = Clock(), [3.0]
        port, jax = (
            mod.ServingModelEstimator(budget_ms=budget_ms,
                                      calibration=lambda: cal[0],
                                      clock=clock)
            for mod in (model, j_model))
        for i, launch in enumerate(_launches(np.random.default_rng(4), 700)):
            clock.now += 0.002
            for est in (port, jax):
                est.ingest(*launch)
            if i % 35 == 34:
                for est in (port, jax):
                    est.refit(force=True)
        _compare(port, jax)
        assert port.capacity_debug()["headroom"][
            "max_decisions_per_sec"] >= 0
