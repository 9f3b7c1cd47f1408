"""Vendored OTLP span export: a minimal OpenTelemetry SDK.

Counterpart of ``limitador_tpu/observability/otlp.py``. The reference
installs an OTLP pipeline when ``--tracing-endpoint`` is set
(limitador-server/src/main.rs:973-999: opentelemetry-otlp batch
exporter, service.name=limitador). This module implements the three SDK
pieces that pipeline needs on top of the OpenTelemetry *API*:

 * ``MiniTracerProvider`` / ``MiniTracer``: the API's abstract
   ``TracerProvider``/``Tracer`` over context-parented recording spans,
 * ``MiniSpan``: a recording span capturing name, trace/span/parent ids,
   wall-clock start/end, attributes and status,
 * ``BatchExporter``: a daemon thread draining a bounded queue and
   POSTing OTLP/HTTP **JSON** (the proto3 JSON mapping of
   ``ExportTraceServiceRequest``) to ``<endpoint>/v1/traces``.

OTLP/HTTP+JSON is a standard OTLP transport (collectors listen on
:4318). The API classes the span, tracer and provider derive from are
imported when the pipeline is first set up (``api_classes``), never when
this module is imported: every module of the port imports on a box
without ``opentelemetry``.
"""

from __future__ import annotations

import atexit
import base64
import functools
import http.client
import json
import queue
import random
import threading
import time
import urllib.parse
from types import SimpleNamespace
from typing import Optional, Sequence

__all__ = [
    "BatchExporter",
    "api_classes",
    "make_provider",
    "install_vendored_pipeline",
]

_ids = random.Random()


def _new_trace_id() -> int:
    while True:
        tid = _ids.getrandbits(128)
        if tid:
            return tid


def _new_span_id() -> int:
    while True:
        sid = _ids.getrandbits(64)
        if sid:
            return sid


def _attr_value(value) -> dict:
    """One AnyValue in the proto3 JSON mapping (common/v1/common.proto)."""
    if isinstance(value, bool):
        return {"boolValue": value}
    if isinstance(value, int):
        # proto3 JSON encodes int64 as a decimal string.
        return {"intValue": str(value)}
    if isinstance(value, float):
        return {"doubleValue": value}
    if isinstance(value, (bytes, bytearray)):
        return {"bytesValue": base64.b64encode(bytes(value)).decode()}
    if isinstance(value, (list, tuple)):
        return {"arrayValue": {"values": [_attr_value(v) for v in value]}}
    return {"stringValue": str(value)}


def _attrs_json(attrs: dict) -> list:
    return [{"key": k, "value": _attr_value(v)} for k, v in attrs.items()]


class BatchExporter:
    """Bounded-queue batch exporter (the SDK BatchSpanProcessor role).

    Spans enqueue on ``end()``; a daemon thread drains up to
    ``max_batch`` at a time and POSTs one ExportTraceServiceRequest per
    batch.  The queue drops (and counts) spans when full — export must
    never backpressure the serving path.
    """

    def __init__(
        self,
        endpoint: str,
        service_name: str = "limitador",
        max_queue: int = 4096,
        max_batch: int = 512,
        flush_interval_s: float = 2.0,
        timeout_s: float = 5.0,
    ):
        parsed = urllib.parse.urlparse(
            endpoint if "//" in endpoint else f"http://{endpoint}"
        )
        self._host = parsed.hostname or "localhost"
        self._port = parsed.port or (443 if parsed.scheme == "https" else 4318)
        self._tls = parsed.scheme == "https"
        base = parsed.path.rstrip("/")
        self._path = base + "/v1/traces" if not base.endswith("/v1/traces") \
            else base
        self._service_name = service_name
        self._timeout_s = timeout_s
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._flush_interval_s = flush_interval_s
        self.dropped = 0
        self.exported = 0
        self.export_errors = 0
        # Flush barrier: every span accepted into the queue is eventually
        # counted processed (exported or errored), under one lock so the
        # public counters are also coherent across threads.
        self._count_lock = threading.Lock()
        self._accepted = 0
        self._processed = 0
        self._wake = threading.Event()
        self._stop = False
        self._max_batch = max_batch
        self._thread = threading.Thread(
            target=self._run, name="otlp-export", daemon=True
        )
        self._thread.start()

    def enqueue(self, span):
        try:
            self._queue.put_nowait(span)
        except queue.Full:
            with self._count_lock:
                self.dropped += 1
            return
        with self._count_lock:
            self._accepted += 1
        if self._queue.qsize() >= self._max_batch:
            self._wake.set()

    def _drain(self) -> list:
        batch = []
        while len(batch) < self._max_batch:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return batch

    def _run(self):
        while not self._stop:
            self._wake.wait(self._flush_interval_s)
            self._wake.clear()
            while True:
                batch = self._drain()
                if not batch:
                    break
                self._export(batch)

    def _export(self, batch: Sequence[MiniSpan]):
        payload = json.dumps({
            "resourceSpans": [{
                "resource": {
                    "attributes": _attrs_json(
                        {"service.name": self._service_name}
                    )
                },
                "scopeSpans": [{
                    "scope": {"name": "limitador_tpu_torch"},
                    "spans": [s.to_otlp_json() for s in batch],
                }],
            }]
        }).encode()
        try:
            cls = (http.client.HTTPSConnection if self._tls
                   else http.client.HTTPConnection)
            conn = cls(self._host, self._port, timeout=self._timeout_s)
            try:
                conn.request(
                    "POST", self._path, body=payload,
                    headers={"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                resp.read()
                with self._count_lock:
                    if 200 <= resp.status < 300:
                        self.exported += len(batch)
                    else:
                        self.export_errors += 1
            finally:
                conn.close()
        except Exception:  # noqa: BLE001 - a bad response (HTTPException)
            # must not kill the export thread for the process lifetime
            with self._count_lock:
                self.export_errors += 1
        finally:
            with self._count_lock:
                self._processed += len(batch)

    def force_flush(self, timeout_s: float = 5.0) -> bool:
        """Export everything enqueued before this call (tests/shutdown).

        Waits on the processed counter, not queue emptiness: a batch that
        has been drained but is mid-POST (up to ``timeout_s`` of socket
        time) counts as unfinished until ``_export`` returns.
        """
        with self._count_lock:
            target = self._accepted
        deadline = time.monotonic() + timeout_s
        while True:
            with self._count_lock:
                if self._processed >= target:
                    return True
            if time.monotonic() >= deadline:
                return False
            self._wake.set()
            time.sleep(0.01)

    def shutdown(self):
        self.force_flush()
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=2.0)



@functools.lru_cache(maxsize=1)
def api_classes() -> SimpleNamespace:
    """``MiniSpan``, ``MiniTracer`` and ``MiniTracerProvider``, derived
    from the OpenTelemetry API's abstract classes (imported here, at the
    pipeline's first setup; raises ImportError without the API)."""
    from opentelemetry import context as otel_context
    from opentelemetry import trace as otel_trace
    from opentelemetry.trace import (
        Span,
        SpanContext,
        SpanKind,
        TraceFlags,
        Tracer,
        TracerProvider,
    )
    from opentelemetry.trace.status import Status
    from opentelemetry.util import types as otel_types

    class MiniSpan(Span):
        """A recording span (the SDK ReadableSpan role, trimmed to what the
        OTLP trace payload carries)."""

        __slots__ = (
            "name", "_context", "parent_span_id", "start_unix_nano",
            "end_unix_nano", "attributes", "_status_code", "_status_desc",
            "events", "_exporter", "_ended", "_lock", "kind", "links",
        )

        def __init__(self, name, span_context, parent_span_id, exporter,
                     kind=SpanKind.INTERNAL, links=()):
            self.name = name
            self._context = span_context
            self.parent_span_id = parent_span_id
            self.start_unix_nano = time.time_ns()
            self.end_unix_nano = None
            self.attributes = {}
            self.events = []
            self._status_code = None
            self._status_desc = None
            self._exporter = exporter
            self._ended = False
            self._lock = threading.Lock()
            self.kind = kind
            self.links = list(links or ())

        # --- abstract Span surface -------------------------------------------
        def get_span_context(self) -> SpanContext:
            return self._context

        def is_recording(self) -> bool:
            return not self._ended

        def set_attribute(self, key: str, value: otel_types.AttributeValue):
            if not self._ended:
                self.attributes[key] = value

        def set_attributes(self, attributes):
            for k, v in attributes.items():
                self.set_attribute(k, v)

        def add_event(self, name, attributes=None, timestamp=None):
            if not self._ended:
                self.events.append(
                    (name, dict(attributes or {}), timestamp or time.time_ns())
                )

        def update_name(self, name: str):
            if not self._ended:
                self.name = name

        def set_status(self, status, description=None):
            if self._ended:
                return
            if isinstance(status, Status):
                self._status_code = status.status_code
                self._status_desc = status.description
            else:
                self._status_code = status
                self._status_desc = description

        def record_exception(
            self, exception, attributes=None, timestamp=None, escaped=False
        ):
            attrs = {
                "exception.type": type(exception).__qualname__,
                "exception.message": str(exception),
            }
            attrs.update(attributes or {})
            self.add_event("exception", attrs, timestamp)

        def end(self, end_time: Optional[int] = None):
            with self._lock:
                if self._ended:
                    return
                self._ended = True
                self.end_unix_nano = end_time or time.time_ns()
            self._exporter.enqueue(self)

        # --- OTLP JSON -------------------------------------------------------
        def to_otlp_json(self) -> dict:
            ctx = self._context
            # API SpanKind is 0-based (INTERNAL=0); the proto enum reserves 0
            # for UNSPECIFIED, so the JSON mapping is value+1.
            kind = self.kind
            span = {
                "traceId": format(ctx.trace_id, "032x"),
                "spanId": format(ctx.span_id, "016x"),
                "name": self.name,
                "kind": int(kind.value if hasattr(kind, "value") else kind) + 1,
                "startTimeUnixNano": str(self.start_unix_nano),
                "endTimeUnixNano": str(self.end_unix_nano),
                "attributes": _attrs_json(self.attributes),
            }
            if self.parent_span_id:
                span["parentSpanId"] = format(self.parent_span_id, "016x")
            if self.links:
                links = []
                for link in self.links:
                    lctx = getattr(link, "context", link)
                    links.append({
                        "traceId": format(lctx.trace_id, "032x"),
                        "spanId": format(lctx.span_id, "016x"),
                        "attributes": _attrs_json(
                            dict(getattr(link, "attributes", None) or {})
                        ),
                    })
                span["links"] = links
            if self.events:
                span["events"] = [
                    {
                        "name": name,
                        "timeUnixNano": str(ts),
                        "attributes": _attrs_json(attrs),
                    }
                    for name, attrs, ts in self.events
                ]
            if self._status_code is not None:
                code = self._status_code
                span["status"] = {
                    "code": int(code.value if hasattr(code, "value") else code)
                }
                if self._status_desc:
                    span["status"]["message"] = self._status_desc
            return span

    class MiniTracer(Tracer):
        def __init__(self, exporter: BatchExporter):
            self._exporter = exporter

        def start_span(
            self,
            name: str,
            context: Optional[otel_context.Context] = None,
            kind: SpanKind = SpanKind.INTERNAL,
            attributes=None,
            links=None,
            start_time=None,
            record_exception=True,
            set_status_on_exception=True,
        ) -> Span:
            parent = otel_trace.get_current_span(context)
            parent_ctx = parent.get_span_context()
            if parent_ctx.is_valid:
                trace_id = parent_ctx.trace_id
                parent_span_id = parent_ctx.span_id
            else:
                trace_id = _new_trace_id()
                parent_span_id = None
            span_ctx = SpanContext(
                trace_id=trace_id,
                span_id=_new_span_id(),
                is_remote=False,
                trace_flags=TraceFlags(TraceFlags.SAMPLED),
            )
            span = MiniSpan(name, span_ctx, parent_span_id, self._exporter,
                            kind=kind, links=links)
            if start_time:
                span.start_unix_nano = start_time
            if attributes:
                span.set_attributes(attributes)
            return span

        def start_as_current_span(
            self,
            name: str,
            context: Optional[otel_context.Context] = None,
            kind: SpanKind = SpanKind.INTERNAL,
            attributes=None,
            links=None,
            start_time=None,
            record_exception=True,
            set_status_on_exception=True,
            end_on_exit=True,
        ):
            span = self.start_span(
                name, context=context, kind=kind, attributes=attributes,
                links=links, start_time=start_time,
            )
            return otel_trace.use_span(
                span,
                end_on_exit=end_on_exit,
                record_exception=record_exception,
                set_status_on_exception=set_status_on_exception,
            )


    class MiniTracerProvider(TracerProvider):
        def __init__(self, exporter: BatchExporter):
            self.exporter = exporter

        def get_tracer(
            self, instrumenting_module_name, *args, **kwargs
        ) -> Tracer:
            return MiniTracer(self.exporter)

        def force_flush(self, timeout_s: float = 5.0) -> bool:
            return self.exporter.force_flush(timeout_s)

        def shutdown(self):
            self.exporter.shutdown()

    return SimpleNamespace(
        MiniSpan=MiniSpan, MiniTracer=MiniTracer,
        MiniTracerProvider=MiniTracerProvider,
    )


def make_provider(exporter: BatchExporter):
    """A ``MiniTracerProvider`` over ``exporter``."""
    return api_classes().MiniTracerProvider(exporter)


def install_vendored_pipeline(endpoint: str, service_name: str = "limitador"):
    """Install the vendored provider as the global tracer provider and
    return it (main.rs:973-999 role, SDK-free). Raises ImportError
    without the OpenTelemetry API and ValueError on a malformed
    endpoint."""
    from opentelemetry import trace as otel_trace

    classes = api_classes()
    provider = classes.MiniTracerProvider(
        BatchExporter(endpoint, service_name=service_name)
    )
    otel_trace.set_tracer_provider(provider)
    # The SDK's BatchSpanProcessor flushes via atexit; match it so the
    # final flush interval of spans is not lost on a clean shutdown.
    atexit.register(provider.shutdown)
    return provider
