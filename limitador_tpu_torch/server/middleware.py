"""Request-id propagation.

Counterpart of ``limitador_tpu/server/middleware.py``, after the
reference's RequestIdMiddleware (envoy_rls/server.rs:274-300,
http_api/server.rs:297-314): every request carries an ``x-request-id``
(the client's if present, else a fresh uuid), echoed on HTTP responses
and gRPC initial metadata so that logs and traces correlate across hops.
The id is also published to the device-plane context variable
(``observability/device_plane.py``), and an incoming W3C
``traceparent`` is adopted (``observability/tracing.py``), so that
exemplars carry the caller's ids.
"""

from __future__ import annotations

import asyncio
import uuid

import grpc
from aiohttp import web

from ..observability.device_plane import set_request_id
from ..observability.tracing import adopt_traceparent

__all__ = ["http_request_id_middleware", "GrpcRequestIdInterceptor"]

HEADER = "x-request-id"
TRACEPARENT = "traceparent"


@web.middleware
async def http_request_id_middleware(request: web.Request, handler):
    request_id = request.headers.get(HEADER) or uuid.uuid4().hex
    request["request_id"] = request_id
    set_request_id(request_id)
    adopt_traceparent(request.headers.get(TRACEPARENT))
    try:
        response = await handler(request)
    except web.HTTPException as exc:
        # Error responses (404/405/...) need the id most: stamp, re-raise.
        exc.headers[HEADER] = request_id
        raise
    response.headers[HEADER] = request_id
    return response


class GrpcRequestIdInterceptor(grpc.aio.ServerInterceptor):
    """Echo (or mint) ``x-request-id`` on every RPC's initial metadata.

    All four handler kinds are wrapped: unary-unary (the RLS hot path)
    and the streaming shapes (server reflection is stream-stream). Each
    method handler is wrapped once and reads its ids from the call's own
    metadata. A unary response sends the initial metadata while the
    handler runs, since grpc.aio sends it as an operation of its own, and
    waits for it before answering."""

    def __init__(self):
        self._wrapped: dict = {}

    async def intercept_service(self, continuation, handler_call_details):
        handler = await continuation(handler_call_details)
        if handler is None:
            return handler
        wrapped = self._wrapped.get(handler)
        if wrapped is None:
            wrapped = self._wrapped[handler] = _wrap(handler)
        return wrapped


def _prelude(context):
    """Publish the call's ids and start sending its initial metadata."""
    request_id = traceparent = None
    for key, value in context.invocation_metadata() or ():
        if key == HEADER:
            request_id = value
        elif key == TRACEPARENT:
            traceparent = value
    request_id = request_id or uuid.uuid4().hex
    # The wrapped coroutine runs in the request's context, so the
    # storages see this id for the decisions they make.
    set_request_id(request_id)
    adopt_traceparent(traceparent)
    return context.send_initial_metadata(((HEADER, request_id),))


class _Sending:
    """A unary call's servicer context while its initial metadata is
    being sent: ``abort`` waits for the send first, since grpc.aio would
    otherwise start a second set of initial metadata with the status."""

    __slots__ = ("_context", "_sent")

    def __init__(self, context, sent):
        self._context = context
        self._sent = sent

    def __getattr__(self, name):
        return getattr(self._context, name)

    async def abort(self, *args, **kwargs):
        await self._sent
        await self._context.abort(*args, **kwargs)


def _wrap(handler):
    for attr, factory, streams_out in (
        ("unary_unary", grpc.unary_unary_rpc_method_handler, False),
        ("unary_stream", grpc.unary_stream_rpc_method_handler, True),
        ("stream_unary", grpc.stream_unary_rpc_method_handler, False),
        ("stream_stream", grpc.stream_stream_rpc_method_handler, True),
    ):
        inner = getattr(handler, attr)
        if inner is None:
            continue
        if streams_out:

            async def wrapped(request, context, _inner=inner):
                await _prelude(context)
                async for response in _inner(request, context):
                    yield response

        else:

            async def wrapped(request, context, _inner=inner):
                sent = asyncio.ensure_future(_prelude(context))
                try:
                    return await _inner(request, _Sending(context, sent))
                finally:
                    await sent

        return factory(
            wrapped,
            request_deserializer=handler.request_deserializer,
            response_serializer=handler.response_serializer,
        )
    return handler
