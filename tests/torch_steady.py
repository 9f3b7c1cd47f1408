"""Teardown checks for the device-plane and control-plane test files.

The device plane adds process-wide state: the port's native telemetry
plane (armed in the C host lane), the one ``torch.profiler`` capture, the
tracing pipeline, the MetricsLayer and the servers' threads. The control
planes add more: the serving model's process estimator and its
``--model-fit`` switch, the signal module's box-calibration cache (each
package has its own), the signal bus's calibration thread and the flight
trigger thread. A test that leaves any of them behind changes what the
next test in the same worker sees, the JAX package's tests included.
``steady()`` wraps one test: afterwards it restores each piece to what it
was and fails the test that left the telemetry armed, a capture running,
tracing configured, the environment changed or threads alive (joined
within 10 s); the estimators, switches and caches are put back without
complaint (every server sets the switch and makes the estimator).
"""

import contextlib
import os
import threading
import time


@contextlib.contextmanager
def otel_provider_kept():
    """Put OpenTelemetry's process-global tracer provider back as it was.
    The API sets it once per process: a provider a port test installs
    (``configure_tracing``) would keep a later test in the same worker,
    the JAX package's ``tests/test_otlp.py`` among them, from installing
    its own, and that test's spans would go to the port test's closed
    collector."""
    import sys

    def state():
        trace = sys.modules.get("opentelemetry.trace")
        if trace is None:
            return None
        return trace._TRACER_PROVIDER, trace._TRACER_PROVIDER_SET_ONCE

    before = state()
    yield
    trace = sys.modules.get("opentelemetry.trace")
    if trace is None or state() == before:
        return
    if before is None or before[0] is None:
        # never set before: a fresh set-once guard (the old one is spent)
        from opentelemetry.util._once import Once

        before = (None, Once())
    trace._TRACER_PROVIDER, trace._TRACER_PROVIDER_SET_ONCE = before


def _environ() -> dict:
    # pytest itself rewrites PYTEST_CURRENT_TEST at every phase
    return {k: v for k, v in os.environ.items()
            if k != "PYTEST_CURRENT_TEST"}


def _plane_state():
    """The control planes' process-wide state, both packages'."""
    from limitador_tpu.observability import model as j_model
    from limitador_tpu.observability import signals as j_signals
    from limitador_tpu_torch.observability import model, signals

    return [(mod, name, getattr(mod, name))
            for mod in (model, j_model) for name in ("_PROCESS", "_ENABLED")
            ] + [(mod, "_BOX_CALIBRATION", mod._BOX_CALIBRATION)
                 for mod in (signals, j_signals)]


@contextlib.contextmanager
def steady():
    from limitador_tpu.observability import metrics_layer as j_layer
    from limitador_tpu_torch import native
    from limitador_tpu_torch.observability import device_plane, tracing
    from limitador_tpu_torch.observability import metrics_layer

    planes = _plane_state()
    threads = {t.ident for t in threading.enumerate()}
    environ = _environ()
    layers = (metrics_layer.installed(), j_layer.installed())
    trace_state = (tracing._trace, tracing._provider, tracing._tracer,
                   tracing._enabled, tracing.sample_rate())
    with otel_provider_kept():
        yield
    problems = []
    profiler = device_plane.TorchProfiler()
    if profiler.status()["active"]:
        try:
            profiler.stop()
        except device_plane.ProfilerStateError:
            # started on another thread, which alone can stop it
            device_plane._capture = None
        problems.append("a torch.profiler capture was left running")
    if native.tel_enabled():
        native.tel_config(False)
        problems.append("the native telemetry plane was left armed")
    # server.start installs the process-wide MetricsLayer for good, as
    # the server binary does: put back what was there.
    metrics_layer.install(layers[0])
    j_layer.install(layers[1])
    if (tracing._trace, tracing._provider, tracing._tracer,
            tracing._enabled, tracing.sample_rate()) != trace_state:
        (tracing._trace, tracing._provider, tracing._tracer,
         tracing._enabled) = trace_state[:4]
        tracing.set_sample_rate(trace_state[4])
        problems.append("tracing was left configured")
    if _environ() != environ:
        for key in set(_environ()) - set(environ):
            del os.environ[key]
        os.environ.update(environ)
        problems.append("os.environ was changed")
    deadline = time.monotonic() + 10.0
    while True:
        alive = [t for t in threading.enumerate()
                 if t.ident not in threads and t.is_alive()]
        if not alive or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    if alive:
        problems.append(f"threads left alive: {[t.name for t in alive]}")
    # after the threads: the calibration thread writes its cache
    for mod, name, value in planes:
        setattr(mod, name, value)
    assert not problems, problems
