"""The port's control-signal bus against the JAX package's.

- ``ControlSignals``: the same fields, defaults, ``to_dict`` and
  ``vector()`` order, the priority and phase maps included;
- a port ``SignalBus`` and a JAX one on one clock, fed the same stub
  sources (recorder, admission, pipeline, native plane, observatory, pod,
  model, controller), give equal ``snapshot().to_dict()``,
  ``timeline()`` and ``signals_debug()`` across the shed-rate window,
  and their ``poll`` sets equal ``signal_*`` samples;
- the recorder's two EWMAs (``record_flush``) equal the JAX recorder's;
- ``METRIC_FAMILIES`` equal the JAX module's and are declared.

Every test runs inside ``torch_steady.steady()``, which puts back both
packages' box-calibration caches.
"""

import numpy as np
from prometheus_client.parser import text_string_to_metric_families

from limitador_tpu.observability import device_plane as j_device_plane
from limitador_tpu.observability import signals as j_signals
from limitador_tpu.observability.metrics import (
    PrometheusMetrics as JPrometheusMetrics,
)
from limitador_tpu_torch.observability import device_plane, signals
from limitador_tpu_torch.observability.metrics import PrometheusMetrics
from tests.torch_steady import steady


class Clock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


class Stub:
    """Any source: attributes and zero-argument methods from kwargs."""

    def __init__(self, **kw):
        for name, value in kw.items():
            setattr(self, name, value)


class Admission:
    """The admission controller's shape the bus reads."""

    def __init__(self):
        import threading

        self.breaker = Stub(state="closed")
        self._shed_lock = threading.Lock()
        self._shed_counts = {}


def _sources(step):
    """Stub sources whose readings move with ``step``."""
    admission = Admission()
    admission.breaker.state = ("closed", "half_open", "open")[step % 3]
    admission._shed_counts = {
        ("queue", "low"): 10 * step, ("budget", "low"): 3 * step,
        ("queue", "high"): step * step,
    }
    recorder = Stub(signal_queue_wait_s=0.00123 * (step + 1),
                    signal_batch_fill=0.25 + 0.05 * step)
    pipeline = Stub(library_stats=lambda: {
        "lease_outstanding_tokens": 17 + step, "native_lane_rows": 5})
    plane = Stub(
        native_telemetry=lambda: {
            "hot_lookup": {"count": 3, "p99_us": 2.048 * (step + 1)},
            "hot_stage": {"count": 0},
            "hot_finish": {"count": 3, "p99_us": 0.512},
        },
        slo_status=lambda: {"burn_rate_5m": 0.5 * step,
                            "burn_rate_1h": 0.1 * step,
                            "breached": step > 2},
        device_backed=lambda: (None, True, False)[step % 3],
    )
    observatory = Stub(pressure=lambda: {"top_namespace": f"ns{step}",
                                         "near_exhaustion": step})
    pod = Stub(pod_signal_fields=lambda: {"pod_routed_share": 0.3,
                                          "peers_up": 2 + step})
    model = Stub(signal_fields=lambda: {"model_r2": 0.9,
                                        "capacity_headroom_ratio": 1.5,
                                        "model_drift": step % 2})
    controller = Stub(signal_fields=lambda: {
        "ctl_admission_ceiling": 100.0 + step, "ctl_last_reason": "idle"})
    return {"recorder": recorder, "admission": admission,
            "pipeline": pipeline, "native_plane": plane,
            "observatory": observatory, "pod": pod, "model": model,
            "controller": controller}


def _attach(bus, sources):
    for name, source in sources.items():
        getattr(bus, f"attach_{name}")(source)


def test_control_signals_schema_equals_jax():
    with steady():
        assert signals.ControlSignals.FIELDS == \
            j_signals.ControlSignals.FIELDS
        assert signals._PRIORITIES == j_signals._PRIORITIES
        assert signals._PHASES == j_signals._PHASES
        assert signals.ControlSignals().to_dict() == \
            j_signals.ControlSignals().to_dict()
        assert signals.ControlSignals().vector() == \
            j_signals.ControlSignals().vector()
        rng = np.random.default_rng(3)
        kw = {f: float(rng.uniform(0, 5)) for f in
              signals.ControlSignals.FIELDS}
        kw["shed_rate_by_priority"] = {"low": 1.5, "critical": 0.25}
        kw["native_phase_p99_us"] = {"hot_stage": 3.0, "h2i_respond": 7.0}
        kw["top_namespace"] = "t"
        kw["ctl_last_reason"] = "burn"
        port = signals.ControlSignals(**kw)
        jax = j_signals.ControlSignals(**kw)
        assert port.to_dict() == jax.to_dict()
        assert port.vector() == jax.vector()
        assert len(port.vector()) == 32


def test_bus_snapshots_equal_jax_on_stub_sources():
    with steady():
        signals._BOX_CALIBRATION = j_signals._BOX_CALIBRATION = 123.456
        clock = Clock()
        port = signals.SignalBus(timeline=4, clock=clock)
        jax = j_signals.SignalBus(timeline=4, clock=clock)
        for step, advance in enumerate((0.0, 0.2, 0.4, 0.7, 0.1, 2.0)):
            clock.now += advance
            for bus in (port, jax):
                _attach(bus, _sources(step))
            assert port.snapshot().to_dict() == jax.snapshot().to_dict()
            assert port.timeline() == jax.timeline()
            assert port.timeline(2) == jax.timeline(2)
        clock.now += 1.0
        got, want = port.signals_debug(), jax.signals_debug()
        assert got == want
        assert len(got["timeline"]) == 4
        current = got["current"]
        assert current["breaker_state"] == 2  # step 5: open
        assert any(t["shed_rate_by_priority"]["low"] > 0
                   for t in got["timeline"])
        assert current["native_phase_p99_us"]["h2i_respond"] == 0.0
        assert current["box_calibration_score"] == 123.456


def test_bus_without_sources_keeps_the_neutral_defaults():
    with steady():
        signals._BOX_CALIBRATION = j_signals._BOX_CALIBRATION = None
        clock = Clock()
        port = signals.SignalBus(clock=clock).snapshot().to_dict()
        jax = j_signals.SignalBus(clock=clock).snapshot().to_dict()
        assert port == jax
        assert port["device_backed"] == -1


def _signal_samples(text):
    return {
        (s.name, tuple(sorted(s.labels.items()))): s.value
        for family in text_string_to_metric_families(text)
        if family.name.startswith("signal_")
        for s in family.samples
    }


def test_bus_poll_sets_the_jax_samples():
    with steady():
        signals._BOX_CALIBRATION = j_signals._BOX_CALIBRATION = 9.5
        clock = Clock()
        metrics, j_metrics = PrometheusMetrics(), JPrometheusMetrics()
        port = signals.SignalBus(clock=clock)
        jax = j_signals.SignalBus(clock=clock)
        for bus in (port, jax):
            _attach(bus, _sources(4))
        assert _signal_samples(metrics.render().decode()) == \
            _signal_samples(j_metrics.render().decode())
        port.poll(metrics)
        jax.poll(j_metrics)
        got = _signal_samples(metrics.render().decode())
        assert got == _signal_samples(j_metrics.render().decode())
        assert got[("signal_box_calibration", ())] == 9.5
        assert len({name for name, _ in got}) == len(
            signals.METRIC_FAMILIES)


def test_recorder_ewmas_equal_jax():
    with steady():
        port = device_plane.DeviceStatsRecorder()
        jax = j_device_plane.DeviceStatsRecorder()
        rng = np.random.default_rng(7)
        for i in range(50):
            waits = rng.uniform(0, 0.004, int(rng.integers(0, 6))).tolist()
            fill = float(rng.uniform(0, 1.4))
            batcher = "update" if i % 7 == 3 else "check"
            for rec in (port, jax):
                rec.record_flush("size", fill, waits, batcher=batcher)
            assert port.signal_queue_wait_s == jax.signal_queue_wait_s
            assert port.signal_batch_fill == jax.signal_batch_fill
        assert port.signal_batch_fill > 0


def test_metric_families_equal_jax_and_are_declared():
    with steady():
        assert signals.METRIC_FAMILIES == j_signals.METRIC_FAMILIES
        declared = {f.name for f in text_string_to_metric_families(
            PrometheusMetrics().render().decode())}
        assert set(signals.METRIC_FAMILIES) <= declared
