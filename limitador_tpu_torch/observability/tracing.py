"""Tracing.

Counterpart of ``limitador_tpu/observability/tracing.py``: the
reference's span instrumentation (envoy_rls/server.rs:81-90 span
fields; OTLP install, main.rs:973-999). Spans are instrumented through
the OpenTelemetry *API*, which this module imports only inside
``configure_tracing``: every module of the port imports on a box without
``opentelemetry``, and with no ``--tracing-endpoint`` the span helpers
are shared no-ops (or feed only the MetricsLayer aggregation when one is
installed).

Departures from the JAX module (ROADMAP Queue C):
- ``configure_tracing`` always installs the vendored OTLP/HTTP+JSON
  pipeline (``otlp.py``), also where ``opentelemetry-sdk`` is installed
  (the JAX module prefers the SDK's OTLP/gRPC exporter there);
- a pipeline that cannot start raises ``TracingError`` (the server exits
  2) instead of serving on without span export.

The pod hop: ``hop_trace_metadata`` injects the origin's W3C trace
context into a peer-lane forward's gRPC metadata, and the owner opens a
``pod_peer_decide`` span linked to it (``peer_decide_span``).
"""

from __future__ import annotations

import itertools
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from typing import Optional

from .metrics_layer import installed as metrics_layer_installed
from .metrics_layer import metrics_span

__all__ = [
    "TracingError",
    "configure_tracing",
    "should_rate_limit_span",
    "datastore_span",
    "device_batch_span",
    "tracing_enabled",
    "set_sample_rate",
    "sample_rate",
    "current_trace_id",
    "adopt_traceparent",
    "hop_trace_metadata",
    "peer_decide_span",
]

# The OpenTelemetry API's trace module, the installed provider and this
# package's tracer, set by configure_tracing; span machinery runs only
# once an exporter is live (the API-only proxy tracer costs microseconds
# a request).
_trace = None
_provider = None
_tracer = None
_enabled = False

# Head sampling: at a rate < 1.0 the ROOT span (should_rate_limit) makes
# a 1-in-N decision and child spans inherit it through a contextvar.
# Rate 1.0 (the default) records every request.
_sample_rate = 1.0
_sample_stride = 1
_sample_counter = itertools.count()

#: the root span's head-sampling verdict for the current request
#: context; children (datastore spans) read it instead of re-deciding
_sampled_cv: ContextVar[bool] = ContextVar(
    "limitador_tpu_torch_trace_sampled", default=True
)

#: trace id adopted from an incoming ``traceparent`` header (server
#: middleware): exemplars correlate even without a local exporter
_adopted_trace_id: ContextVar[Optional[str]] = ContextVar(
    "limitador_tpu_torch_adopted_trace_id", default=None
)


class TracingError(RuntimeError):
    """``--tracing-endpoint`` was given and span export cannot start."""


def tracing_enabled() -> bool:
    """True once an OTLP exporter is installed (configure_tracing)."""
    return _enabled


def set_sample_rate(rate: float) -> None:
    """Set the head-sampling rate: 1.0 records every request (the
    default), 0.0 none, 0.01 one in a hundred. The MetricsLayer
    aggregation is NOT sampled: it feeds ``datastore_latency`` and must
    see every request."""
    global _sample_rate, _sample_stride
    _sample_rate = min(max(float(rate), 0.0), 1.0)
    _sample_stride = (
        1 if _sample_rate >= 1.0
        else 0 if _sample_rate <= 0.0
        else max(int(round(1.0 / _sample_rate)), 1)
    )


def sample_rate() -> float:
    return _sample_rate


def _head_decision() -> bool:
    """The root span's sampling verdict, published for children."""
    if _sample_stride == 1:
        return True
    ok = (
        _sample_stride > 0
        and next(_sample_counter) % _sample_stride == 0
    )
    _sampled_cv.set(ok)
    return ok


def _span_sampled() -> bool:
    """Child spans inherit the root's head-sampling verdict (True when
    no root made one)."""
    return _sample_stride == 1 or _sampled_cv.get()


def adopt_traceparent(header: Optional[str]) -> Optional[str]:
    """Adopt the trace id of an incoming W3C ``traceparent`` header into
    the request context (server middleware), so Prometheus exemplars
    carry the caller's trace id even when no local exporter is
    configured. Returns the adopted id."""
    if not header:
        return None
    parts = str(header).split("-")
    if len(parts) < 3 or len(parts[1]) != 32:
        return None
    trace_id = parts[1].lower()
    if trace_id.strip("0") == "":
        return None
    _adopted_trace_id.set(trace_id)
    return trace_id


def current_trace_id() -> Optional[str]:
    """The trace id of the active span (exporter configured), else the
    id adopted from the incoming traceparent, else None."""
    if _enabled:
        ctx = _trace.get_current_span().get_span_context()
        if ctx.is_valid:
            return format(ctx.trace_id, "032x")
    return _adopted_trace_id.get()


def configure_tracing(endpoint: Optional[str]) -> Optional[str]:
    """Install the vendored OTLP/HTTP+JSON pipeline (``otlp.py``) as the
    global tracer provider when an endpoint is configured, and return a
    line for the caller to log. Raises ``TracingError`` when it cannot
    start (``opentelemetry`` missing, a malformed endpoint)."""
    global _trace, _provider, _tracer, _enabled
    if not endpoint:
        return None
    try:
        from opentelemetry import trace
    except ImportError as exc:
        raise TracingError(
            f"--tracing-endpoint {endpoint}: the opentelemetry API cannot "
            f"be imported ({exc})"
        ) from exc
    from .otlp import install_vendored_pipeline

    try:
        provider = install_vendored_pipeline(endpoint)
    except ValueError as exc:
        raise TracingError(
            f"--tracing-endpoint {endpoint}: the OTLP pipeline cannot "
            f"start ({exc})"
        ) from exc
    _trace, _provider = trace, provider
    # From the provider itself: the API keeps the first global provider
    # a process installs, and spans must reach this pipeline's exporter.
    _tracer = provider.get_tracer("limitador_tpu_torch")
    _enabled = True
    return f"exporting spans via OTLP/HTTP+JSON to {endpoint}/v1/traces"


def _noop_record(*_args, **_kwargs):
    # Shared no-exporter stand-in for should_rate_limit's recorder.
    pass


_NULLCONTEXT = nullcontext()


def datastore_span(op: str):
    """Span around one storage I/O (the reference wraps backend I/O in
    info_span!("datastore")). Feeds both the OTLP exporter (when
    configured) and the MetricsLayer span-tree aggregation (when
    installed). With neither active this returns a shared nullcontext."""
    if not _enabled and metrics_layer_installed() is None:
        return _NULLCONTEXT
    return _datastore_span(op)


@contextmanager
def _datastore_span(op: str):
    with metrics_span("datastore"):
        if not _enabled or not _span_sampled():
            yield
            return
        with _tracer.start_as_current_span("datastore") as span:
            span.set_attribute("datastore.operation", op)
            yield


class _NoopRecordSpan:
    """Shared no-op stand-in for the span helpers that yield a setter:
    one object, entered any number of times, at no per-call cost."""

    def __enter__(self):
        return _noop_record

    def __exit__(self, *exc):
        return False


_NOOP_RECORD_SPAN = _NoopRecordSpan()


def _noop_record_span():
    return _NOOP_RECORD_SPAN


def device_batch_span(batch_id: int, n_requests: int, attrs=None):
    """Span around one device batch round trip, carrying the batch id
    and (through the yielded setter) the per-phase timing breakdown as
    ``batch.phase.*_ms`` attributes, so that a trace view shows where a
    slow batch spent its time. ``attrs`` adds span attributes (the
    native telemetry plane attaches ``native.trace_id`` and the native
    phase splits of a 1-in-N sampled hot-lane batch). Emitted from the
    batchers' collect phase, outside any MetricsLayer aggregate: the
    per-request datastore spans already account this wall clock. With
    no exporter it is the shared no-op."""
    if not _enabled or not _head_decision():
        return _NOOP_RECORD_SPAN
    return _device_batch_span(batch_id, n_requests, attrs)


@contextmanager
def _device_batch_span(batch_id: int, n_requests: int, attrs=None):
    with _tracer.start_as_current_span("datastore") as span:
        span.set_attribute("datastore.operation", "device_batch")
        span.set_attribute("batch.id", batch_id)
        span.set_attribute("batch.requests", n_requests)
        if attrs:
            for key, value in attrs.items():
                span.set_attribute(key, value)

        def record(phases: dict) -> None:
            for name, seconds in phases.items():
                span.set_attribute(
                    f"batch.phase.{name}_ms", round(seconds * 1e3, 3)
                )

        yield record


def should_rate_limit_span(namespace: str, hits_addend: int, carrier=None):
    """Span around one decision with the reference's attribute names
    (envoy_rls/server.rs:81-90); records limited/limit_name via the
    returned setter. Doubles as the ``should_rate_limit`` MetricsLayer
    aggregate root (main.rs:908-913). ``carrier`` (a mapping of incoming
    gRPC metadata) parents the span on the caller's W3C trace context."""
    if not _enabled and metrics_layer_installed() is None:
        return _noop_record_span()
    return _should_rate_limit_span(namespace, hits_addend, carrier)


@contextmanager
def _should_rate_limit_span(namespace, hits_addend, carrier):
    with metrics_span("should_rate_limit"):
        if not _enabled or not _head_decision():
            yield _noop_record
            return
        parent = None
        if carrier:
            from opentelemetry.propagate import extract

            # A malformed traceparent extracts to an empty context.
            parent = extract(carrier)
        with _tracer.start_as_current_span(
            "should_rate_limit", context=parent
        ) as span:
            span.set_attribute("ratelimit.namespace", namespace)
            span.set_attribute("ratelimit.hits_addend", hits_addend)

            def record(limited: bool, limit_name):
                span.set_attribute("ratelimit.limited", limited)
                if limit_name:
                    span.set_attribute("ratelimit.limit_name", limit_name)

            yield record


def hop_trace_metadata() -> list:
    """W3C trace-context key/value pairs for a pod peer hop: the
    origin's current span context, injected so that the owner host can
    link its decide span back across the hop. Empty when no exporter is
    configured."""
    if not _enabled or _tracer is None:
        return []
    from opentelemetry.propagate import inject

    carrier: dict = {}
    inject(carrier)
    return list(carrier.items())


def peer_decide_span(namespace, request_id, carrier=None):
    """Owner-side span around one forwarded decision (the remote half of
    a pod hop). ``carrier`` is the forward's gRPC metadata: when it
    carries a W3C trace context the span links to the origin's span (a
    causal reference between two hosts' traces, not a parent)."""
    if not _enabled or _tracer is None or not _head_decision():
        return _NULLCONTEXT
    return _peer_decide_span(namespace, request_id, carrier)


@contextmanager
def _peer_decide_span(namespace, request_id, carrier):
    links = []
    if carrier:
        from opentelemetry.propagate import extract

        # A malformed traceparent extracts to an invalid span context.
        remote = _trace.get_current_span(extract(carrier)).get_span_context()
        if remote.is_valid:
            links.append(_trace.Link(remote))
    with _tracer.start_as_current_span("pod_peer_decide", links=links) as span:
        span.set_attribute("ratelimit.namespace", str(namespace))
        if request_id:
            span.set_attribute("request.id", str(request_id))
        yield
