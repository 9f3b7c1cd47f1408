"""Envoy RLS v3 + Kuadrant RLS v1 gRPC services.

Counterpart of ``limitador_tpu/server/rls.py`` (``RlsService``,
``make_rls_handlers``, ``serve_rls``), over grpc.aio with generic method
handlers (the service surface is just method paths + message
(de)serializers). Behavioural parity points with the reference:

- empty domain -> overall_code UNKNOWN;
- descriptors bind as the ``descriptors`` list-of-maps CEL variable;
- hits_addend 0 -> 1 (the proto default is 0, the spec default 1);
- storage errors -> gRPC UNAVAILABLE, so Envoy's failure_mode_deny
  decides fail-open/closed;
- optional draft-03 ratelimit response headers;
- Kuadrant split: CheckRateLimit is read-only, Report only updates.

With a native pipeline (``device/native_pipeline.py``) and headers off,
``ShouldRateLimit`` takes RAW request bytes (identity deserializers) and
answers with the pipeline's prebuilt response blobs; the Kuadrant service
keeps the standard handlers.

Observability, as in the JAX package: ``authorized_calls``,
``authorized_hits`` and ``limited_calls`` per request (the native
pipeline counts its own rows); the ``should_rate_limit`` span, which is
the MetricsLayer aggregate root that ``datastore_latency`` reads; the
``x-request-id`` interceptor; and gRPC server reflection, served
unconditionally like the reference's.

Admission (``admission``, an ``AdmissionController``): ShouldRateLimit,
on the standard and the raw-bytes handler, asks the controller before the
request takes a batch slot, with the gRPC deadline
(``context.time_remaining()``). A shed answers UNAVAILABLE, or
OVER_LIMIT under ``--shed-response overlimit``, and never OK; the
Kuadrant methods are not gated, as in the JAX package.

The native ingress (``native/ingress.py``) serves the Kuadrant split
through ``make_native_method_handlers``: the same ``RlsService`` adapted
to raw request and response bytes, whose ``context.abort`` raises the
ingress's ``GrpcHandlerError``.

Serving shards (``--serving-shards``, ``RlsServingShard``): each extra
shard is a sync gRPC server on the same address (SO_REUSEPORT) whose
handlers bridge onto the shard's own asyncio loop, where the limiter's
per-loop batchers and pipeline shards feed the one device table.

A limiter is awaited when it is an ``AsyncRateLimiter`` or sets
``is_async_limiter`` (the pod frontend, ``server/peering.py``).
"""

from __future__ import annotations

from typing import Optional

import grpc

from ..core.cel import Context
from ..core.limiter import AsyncRateLimiter, CheckResult
from ..observability.metrics import PrometheusMetrics, bind_request_metrics
from ..observability.metrics_layer import metrics_span
from ..observability.tracing import should_rate_limit_span, tracing_enabled
from ..storage.base import StorageError
from .proto import rls_pb2

__all__ = [
    "RATE_LIMIT_HEADERS_NONE",
    "RATE_LIMIT_HEADERS_DRAFT03",
    "RlsService",
    "make_rls_handlers",
    "make_native_should_rate_limit_handler",
    "make_native_method_handlers",
    "serve_rls",
    "RlsServingShard",
]

RATE_LIMIT_HEADERS_NONE = "NONE"
RATE_LIMIT_HEADERS_DRAFT03 = "DRAFT_VERSION_03"

_ENVOY_SERVICE = "envoy.service.ratelimit.v3.RateLimitService"
_KUADRANT_SERVICE = "kuadrant.service.ratelimit.v1.RateLimitService"


def _context_from_request(req) -> Context:
    values = []
    for descriptor in req.descriptors:
        values.append({e.key: e.value for e in descriptor.entries})
    ctx = Context()
    ctx.list_binding("descriptors", values)
    return ctx


def _hits_addend(req) -> int:
    return req.hits_addend if req.hits_addend != 0 else 1


# Headerless responses carry only the overall code: pre-built singletons,
# never mutated.
_PLAIN_RESPONSES = {
    code: rls_pb2.RateLimitResponse(overall_code=code)
    for code in (
        rls_pb2.RateLimitResponse.OK,
        rls_pb2.RateLimitResponse.OVER_LIMIT,
        rls_pb2.RateLimitResponse.UNKNOWN,
    )
}
_UNKNOWN_RESPONSE = _PLAIN_RESPONSES[rls_pb2.RateLimitResponse.UNKNOWN]


def _response(code, result: Optional[CheckResult], with_headers: bool):
    if not with_headers or result is None:
        return _PLAIN_RESPONSES[code]
    resp = rls_pb2.RateLimitResponse(overall_code=code)
    for key, value in result.response_header().items():
        resp.response_headers_to_add.add(key=key, value=value)
    return resp


def _deadline(context) -> Optional[float]:
    """The call's remaining lifetime in seconds (None without one)."""
    time_remaining = getattr(context, "time_remaining", None)
    return time_remaining() if callable(time_remaining) else None


class RlsService:
    """Shared implementation behind both gRPC services."""

    def __init__(self, limiter,
                 metrics: Optional[PrometheusMetrics] = None,
                 rate_limit_headers: str = RATE_LIMIT_HEADERS_NONE,
                 admission=None):
        self.limiter = limiter
        self.metrics = metrics
        self.rate_limit_headers = rate_limit_headers
        #: AdmissionController: deadline and overload shedding before a
        #: request takes a batch slot; None = no admission plane
        self.admission = admission
        self._is_async = isinstance(limiter, AsyncRateLimiter) or bool(
            getattr(limiter, "is_async_limiter", False)
        )

    async def _check_and_update(self, namespace, ctx, delta, load):
        if self._is_async:
            return await self.limiter.check_rate_limited_and_update(
                namespace, ctx, delta, load
            )
        return self.limiter.check_rate_limited_and_update(
            namespace, ctx, delta, load
        )

    async def _is_rate_limited(self, namespace, ctx, delta):
        if self._is_async:
            return await self.limiter.is_rate_limited(namespace, ctx, delta)
        return self.limiter.is_rate_limited(namespace, ctx, delta)

    async def _update_counters(self, namespace, ctx, delta):
        if self._is_async:
            await self.limiter.update_counters(namespace, ctx, delta)
        else:
            self.limiter.update_counters(namespace, ctx, delta)

    async def _admit(self, request, context, namespace):
        """The admission gate before the storage decision. Returns a
        ticket to release when the decision resolves, or a ready
        OVER_LIMIT response when the request was shed with over-limit
        semantics; an UNAVAILABLE shed aborts the RPC (Envoy's
        failure_mode_deny then decides fail-open/closed, as for a storage
        error)."""
        from ..admission.controller import AdmissionShed

        values = None
        if request.descriptors:
            values = {
                e.key: e.value for e in request.descriptors[0].entries
            }
        try:
            return self.admission.admit(namespace, values, _deadline(context))
        except AdmissionShed as shed:
            if shed.overlimit:
                return _PLAIN_RESPONSES[
                    rls_pb2.RateLimitResponse.OVER_LIMIT
                ]
            await context.abort(
                grpc.StatusCode.UNAVAILABLE, f"Service unavailable: {shed}"
            )

    # -- Envoy ShouldRateLimit (the hot path) -----------------------------

    async def should_rate_limit(self, request, context):
        namespace = request.domain
        if not namespace:
            return _UNKNOWN_RESPONSE
        ctx = _context_from_request(request)
        hits_addend = _hits_addend(request)
        with_headers = self.rate_limit_headers != RATE_LIMIT_HEADERS_NONE
        bind_request_metrics(self.metrics)
        ticket = None
        if self.admission is not None:
            ticket = await self._admit(request, context, namespace)
            if isinstance(ticket, rls_pb2.RateLimitResponse):
                return ticket
        try:
            # W3C trace context from the gRPC metadata parents the span,
            # read only when an exporter is installed.
            carrier = None
            if tracing_enabled():
                carrier = dict(context.invocation_metadata() or ())
            with should_rate_limit_span(
                namespace, hits_addend, carrier
            ) as record:
                try:
                    result = await self._check_and_update(
                        namespace, ctx, hits_addend, with_headers
                    )
                except StorageError as exc:
                    await context.abort(
                        grpc.StatusCode.UNAVAILABLE,
                        f"Service unavailable: {exc}",
                    )
                record(result.limited, result.limit_name)
        finally:
            if ticket is not None:
                ticket.release()
        metrics = self.metrics
        if metrics:
            # evaluate the custom label map once per request
            extra = metrics.custom_labels(ctx)
        if result.limited:
            if metrics:
                metrics.incr_limited_calls(
                    namespace, result.limit_name, labels=extra
                )
            code = rls_pb2.RateLimitResponse.OVER_LIMIT
        else:
            if metrics:
                metrics.incr_authorized_calls(namespace, labels=extra)
                metrics.incr_authorized_hits(
                    namespace, hits_addend, labels=extra
                )
            code = rls_pb2.RateLimitResponse.OK
        return _response(code, result, with_headers)

    # -- Kuadrant check/report split --------------------------------------

    async def check_rate_limit(self, request, context):
        namespace = request.domain
        if not namespace:
            return _UNKNOWN_RESPONSE
        ctx = _context_from_request(request)
        try:
            # The reference checks with delta 1 regardless of hits_addend;
            # the addend applies on Report.
            result = await self._is_rate_limited(namespace, ctx, 1)
        except StorageError as exc:
            await context.abort(
                grpc.StatusCode.UNAVAILABLE, f"Service unavailable: {exc}"
            )
        if result.limited:
            if self.metrics:
                self.metrics.incr_limited_calls(
                    namespace, result.limit_name, ctx=ctx
                )
            code = rls_pb2.RateLimitResponse.OVER_LIMIT
        else:
            if self.metrics:
                self.metrics.incr_authorized_calls(namespace, ctx=ctx)
            code = rls_pb2.RateLimitResponse.OK
        with_headers = self.rate_limit_headers != RATE_LIMIT_HEADERS_NONE
        return _response(code, result, with_headers)

    async def report(self, request, context):
        namespace = request.domain
        if not namespace:
            return _UNKNOWN_RESPONSE
        ctx = _context_from_request(request)
        hits_addend = _hits_addend(request)
        try:
            await self._update_counters(namespace, ctx, hits_addend)
        except StorageError as exc:
            await context.abort(
                grpc.StatusCode.UNAVAILABLE, f"Service unavailable: {exc}"
            )
        if self.metrics:
            # Report counts hits only; CheckRateLimit counts the calls.
            self.metrics.incr_authorized_hits(namespace, hits_addend, ctx=ctx)
        return _PLAIN_RESPONSES[rls_pb2.RateLimitResponse.OK]


def make_rls_handlers(service: RlsService):
    """Generic handlers for both services (no grpc plugin codegen needed)."""
    req_des = rls_pb2.RateLimitRequest.FromString

    def resp_ser(message):
        return message.SerializeToString()

    envoy = grpc.method_handlers_generic_handler(
        _ENVOY_SERVICE,
        {
            "ShouldRateLimit": grpc.unary_unary_rpc_method_handler(
                service.should_rate_limit,
                request_deserializer=req_des,
                response_serializer=resp_ser,
            )
        },
    )
    kuadrant = grpc.method_handlers_generic_handler(
        _KUADRANT_SERVICE,
        {
            "CheckRateLimit": grpc.unary_unary_rpc_method_handler(
                service.check_rate_limit,
                request_deserializer=req_des,
                response_serializer=resp_ser,
            ),
            "Report": grpc.unary_unary_rpc_method_handler(
                service.report,
                request_deserializer=req_des,
                response_serializer=resp_ser,
            ),
        },
    )
    return [envoy, kuadrant]


def _native_should_rate_limit(native_pipeline, metrics=None,
                              admission=None):
    """The raw-bytes ShouldRateLimit coroutine shared by the aio server's
    handler and the serving shards' bridge: the admission gate, then
    ``submit`` on the calling loop's pipeline shard."""

    async def handler(blob: bytes, context) -> bytes:
        bind_request_metrics(metrics)
        ticket = None
        if admission is not None:
            from ..admission.controller import AdmissionShed

            try:
                ticket = admission.admit(None, None, _deadline(context))
            except AdmissionShed as shed:
                if shed.overlimit:
                    return native_pipeline.OVER_BLOB
                await context.abort(
                    grpc.StatusCode.UNAVAILABLE,
                    f"Service unavailable: {shed}",
                )
        try:
            # MetricsLayer aggregate for the native path: the one storage
            # wait (parse -> device -> response blob) is the request's
            # datastore time.
            with metrics_span("should_rate_limit"):
                with metrics_span("datastore"):
                    return await native_pipeline.submit(blob)
        except StorageError as exc:
            await context.abort(
                grpc.StatusCode.UNAVAILABLE, f"Service unavailable: {exc}"
            )
        finally:
            if ticket is not None:
                ticket.release()

    return handler


def make_native_should_rate_limit_handler(native_pipeline, metrics=None,
                                          admission=None):
    """ShouldRateLimit over RAW request bytes: identity (de)serializers keep
    Python protobuf off the hot path; the native pipeline parses the wire
    bytes in C++ and answers with prebuilt response blobs. Storage errors
    answer UNAVAILABLE.

    With an admission controller, deadline and overload shedding happen
    before the blob enters the pipeline; the priority is the default
    class (descriptor entries only materialize in C++ past this
    point)."""
    return grpc.method_handlers_generic_handler(
        _ENVOY_SERVICE,
        {
            "ShouldRateLimit": grpc.unary_unary_rpc_method_handler(
                _native_should_rate_limit(
                    native_pipeline, metrics, admission),
                request_deserializer=None,   # raw bytes in
                response_serializer=None,    # raw bytes out
            )
        },
    )


def make_native_method_handlers(service: RlsService):
    """The native ingress's table of methods other than ShouldRateLimit:
    the Kuadrant check/report split served through ``service`` (the
    ``RlsService`` the gRPC server uses), adapted to raw request and
    response bytes, so that the ingress is a complete single-port
    server. There is no ShouldRateLimit entry: the ingress routes that
    path to the columnar engine in C++, so such an entry could never
    fire."""
    from ..native.ingress import GrpcHandlerError

    class _ShimContext:
        """The slice of grpc.ServicerContext the handlers use."""

        @staticmethod
        async def abort(code, details=""):
            raise GrpcHandlerError(
                code.value[0], str(details).encode()[:100]
            )

        @staticmethod
        def invocation_metadata():
            return ()

    def adapt(method):
        async def handler(blob: bytes) -> bytes:
            request = rls_pb2.RateLimitRequest.FromString(blob)
            response = await method(request, _ShimContext())
            return response.SerializeToString()

        return handler

    return {
        f"/{_KUADRANT_SERVICE}/CheckRateLimit": adapt(service.check_rate_limit),
        f"/{_KUADRANT_SERVICE}/Report": adapt(service.report),
    }


async def serve_rls(
    limiter,
    address: str = "0.0.0.0:8081",
    rate_limit_headers: str = RATE_LIMIT_HEADERS_NONE,
    native_pipeline=None,
    metrics: Optional[PrometheusMetrics] = None,
    admission=None,
) -> grpc.aio.Server:
    """Start the gRPC server (returns it started; caller owns shutdown).

    With ``native_pipeline`` set, ShouldRateLimit runs the native
    columnar path, which answers without headers; the Kuadrant service
    keeps the standard handlers. With ``admission``, ShouldRateLimit
    sheds through it first. Every RPC passes the ``x-request-id``
    interceptor, and server reflection lists both services."""
    from .middleware import GrpcRequestIdInterceptor
    from .reflection import make_reflection_handler

    if (
        native_pipeline is not None
        and rate_limit_headers != RATE_LIMIT_HEADERS_NONE
    ):
        raise ValueError(
            "the native pipeline answers ShouldRateLimit without headers"
        )
    server = grpc.aio.server(interceptors=(GrpcRequestIdInterceptor(),))
    service = RlsService(limiter, metrics, rate_limit_headers, admission)
    envoy_handler, kuadrant_handler = make_rls_handlers(service)
    if native_pipeline is not None:
        envoy_handler = make_native_should_rate_limit_handler(
            native_pipeline, metrics, admission
        )
    server.add_generic_rpc_handlers((envoy_handler,))
    server.add_generic_rpc_handlers((kuadrant_handler,))
    server.add_generic_rpc_handlers(
        (make_reflection_handler((_ENVOY_SERVICE, _KUADRANT_SERVICE)),)
    )
    if server.add_insecure_port(address) == 0:
        raise RuntimeError(f"could not bind RLS gRPC server to {address}")
    await server.start()
    return server


class _ShardAbort(Exception):
    """Raised inside a bridged coroutine to carry ``context.abort`` back
    to the sync handler thread."""

    def __init__(self, code, details):
        super().__init__(code, details)
        self.code = code
        self.details = details


class _ShardContextShim:
    """The slice of the async ServicerContext the RlsService handlers
    use, over a sync context on another thread. ``abort`` raises (the
    coroutine ends); the handler thread aborts the real context, which
    is only legal there."""

    __slots__ = ("_context",)

    def __init__(self, context):
        self._context = context

    async def abort(self, code, details=""):
        raise _ShardAbort(code, details)

    def invocation_metadata(self):
        return self._context.invocation_metadata()

    def time_remaining(self):
        return self._context.time_remaining()


class RlsServingShard:
    """One extra serving shard: a sync gRPC server (its own listener on
    the same address; the kernel spreads accepted connections across
    listeners by SO_REUSEPORT) whose handlers bridge onto the shard's
    own asyncio loop, where the shared limiter's per-loop batchers and
    pipeline shards feed the one device table.

    Sync, not ``grpc.aio``: the aio completion-queue poller is one per
    process, and a second event loop racing its wakeup socket drops
    events now and then (stuck RPCs, ``BlockingIOError`` in
    ``PollerCompletionQueue._handle_events``). The sync core gives each
    shard HTTP/2 framing and protobuf handling on its own threads; only
    the decision crosses into the shard's loop.

    Construction returns once the shard listens, and raises
    ``RuntimeError`` when the address cannot be bound."""

    def __init__(
        self,
        index: int,
        limiter,
        address: str,
        metrics: Optional[PrometheusMetrics] = None,
        rate_limit_headers: str = RATE_LIMIT_HEADERS_NONE,
        native_pipeline=None,
        admission=None,
        workers: int = 16,
    ):
        import asyncio
        import threading
        from concurrent.futures import ThreadPoolExecutor

        from .reflection import make_sync_reflection_handler

        self.index = index
        self.address = address
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._run_loop, name=f"rls-shard-loop-{index}",
            daemon=True,
        )
        self._loop_thread.start()

        service = RlsService(limiter, metrics, rate_limit_headers, admission)
        self._executor = ThreadPoolExecutor(
            workers, thread_name_prefix=f"rls-shard-{index}"
        )
        self._server = grpc.server(
            self._executor, options=(("grpc.so_reuseport", 1),),
        )
        for handler in self._make_handlers(
            service, metrics, native_pipeline, admission
        ):
            self._server.add_generic_rpc_handlers((handler,))
        self._server.add_generic_rpc_handlers(
            (make_sync_reflection_handler(
                (_ENVOY_SERVICE, _KUADRANT_SERVICE)
            ),)
        )
        try:
            bound = self._server.add_insecure_port(address)
        except RuntimeError:  # newer grpc raises where older returned 0
            bound = 0
        if bound == 0:
            self.stop(grace=0.0)
            raise RuntimeError(
                f"serving shard {index} could not bind {address} "
                "(SO_REUSEPORT unavailable?)"
            )
        self._server.start()

    def _run_loop(self) -> None:
        import asyncio

        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()
        # The batchers' and pipelines' tasks of this loop end with it.
        pending = asyncio.all_tasks(self._loop)
        for task in pending:
            task.cancel()
        self._loop.run_until_complete(
            asyncio.gather(*pending, return_exceptions=True))
        self._loop.close()

    def _bridge(self, async_fn):
        """A sync handler running ``async_fn(request, shim)`` on the
        shard's loop; an abort comes back through _ShardAbort. The
        client's ``x-request-id`` (or a fresh one) is published to the
        device plane's contextvar inside the bridged coroutine (the
        handler thread's context does not cross
        ``run_coroutine_threadsafe``) and echoed, as the aio server's
        interceptor does."""
        import asyncio
        import uuid

        from ..observability.device_plane import set_request_id
        from .middleware import HEADER

        loop = self._loop

        def handler(request, context):
            metadata = dict(context.invocation_metadata() or ())
            request_id = metadata.get(HEADER) or uuid.uuid4().hex

            async def bridged():
                set_request_id(request_id)
                return await async_fn(request, _ShardContextShim(context))

            future = asyncio.run_coroutine_threadsafe(bridged(), loop)
            try:
                response = future.result()
            except _ShardAbort as abort:
                context.set_trailing_metadata(((HEADER, request_id),))
                context.abort(abort.code, abort.details)
                return
            context.send_initial_metadata(((HEADER, request_id),))
            return response

        return handler

    def _make_handlers(self, service, metrics, native_pipeline, admission):
        req_des = rls_pb2.RateLimitRequest.FromString

        def resp_ser(message):
            return message.SerializeToString()

        if (
            native_pipeline is not None
            and service.rate_limit_headers == RATE_LIMIT_HEADERS_NONE
        ):
            # The raw-bytes path: identity (de)serializers and prebuilt
            # response blobs, the handler the aio server mounts.
            should = grpc.unary_unary_rpc_method_handler(
                self._bridge(_native_should_rate_limit(
                    native_pipeline, metrics, admission)),
                request_deserializer=None,
                response_serializer=None,
            )
        else:
            should = grpc.unary_unary_rpc_method_handler(
                self._bridge(service.should_rate_limit),
                request_deserializer=req_des,
                response_serializer=resp_ser,
            )
        envoy = grpc.method_handlers_generic_handler(
            _ENVOY_SERVICE, {"ShouldRateLimit": should})
        kuadrant = grpc.method_handlers_generic_handler(
            _KUADRANT_SERVICE,
            {
                "CheckRateLimit": grpc.unary_unary_rpc_method_handler(
                    self._bridge(service.check_rate_limit),
                    request_deserializer=req_des,
                    response_serializer=resp_ser,
                ),
                "Report": grpc.unary_unary_rpc_method_handler(
                    self._bridge(service.report),
                    request_deserializer=req_des,
                    response_serializer=resp_ser,
                ),
            },
        )
        return [envoy, kuadrant]

    def stop(self, grace: float = 1.0) -> None:
        try:
            self._server.stop(grace).wait(timeout=10)
        except Exception:
            pass
        # The handler threads are the shard's own: they end with it.
        self._executor.shutdown(wait=True)
        if not self._loop.is_closed():
            self._loop.call_soon_threadsafe(self._loop.stop)
        self._loop_thread.join(timeout=10)
