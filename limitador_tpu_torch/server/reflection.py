"""gRPC server reflection (v1alpha), without grpcio-reflection.

Counterpart of ``limitador_tpu/server/reflection.py``. The reference
serves reflection unconditionally from vendored file descriptor sets
(upstream limitador-server/src/envoy_rls/server.rs:232-236,254-263);
the protocol is implemented here over the descriptor bytes the port's
``server/proto`` modules register in the port's own descriptor pool
(``server/proto/_pool.py``):

 * ``ReflectionResponder``: the request -> response protocol logic
   (list_services, file_by_filename, file_containing_symbol, extension
   queries);
 * ``make_reflection_handler``: the grpc.aio stream_stream handler;
 * ``make_sync_reflection_handler``: the same for the sync gRPC servers
   of the serving shards;
 * ``native_reflection_handler``: the native ingress's per-message
   handler (each stream message answers with one response).

``file_*`` responses carry each file's serialized FileDescriptorProto
plus its transitive imports (dependencies first), which lets
grpcurl-style clients rebuild the full schema from one query.
"""

from __future__ import annotations

from typing import Iterable, List

import grpc

# kuadrant_rls_pb2 registers the Kuadrant service's file (and, through
# its imports, the Envoy files) in the pool.
from .proto import kuadrant_rls_pb2, reflection_pb2  # noqa: F401
from .proto._pool import POOL

__all__ = [
    "REFLECTION_SERVICE",
    "REFLECTION_METHOD",
    "ReflectionResponder",
    "make_reflection_handler",
    "make_sync_reflection_handler",
    "native_reflection_handler",
]

REFLECTION_SERVICE = "grpc.reflection.v1alpha.ServerReflection"
REFLECTION_METHOD = f"/{REFLECTION_SERVICE}/ServerReflectionInfo"

_NOT_FOUND = 5          # grpc NOT_FOUND
_INVALID_ARGUMENT = 3   # grpc INVALID_ARGUMENT


class ReflectionResponder:
    """Answers one ServerReflectionRequest at a time (the protocol is a
    bidi stream of independent request/response pairs)."""

    def __init__(self, service_names: Iterable[str], pool=POOL):
        self._services: List[str] = sorted(
            set(service_names) | {REFLECTION_SERVICE}
        )
        self._pool = pool

    # -- internals ---------------------------------------------------------

    def _file_with_deps(self, fd) -> List[bytes]:
        """Serialized FileDescriptorProto of ``fd`` plus transitive
        imports, dependencies first (clients register in order)."""
        out: List[bytes] = []
        seen: set = set()

        def walk(f) -> None:
            if f.name in seen:
                return
            seen.add(f.name)
            for dep in f.dependencies:
                walk(dep)
            out.append(f.serialized_pb)

        walk(fd)
        return out

    def _find_file_for_symbol(self, symbol: str):
        """The pool resolves messages/services/enums but not method or
        field full names; retry enclosing scopes so "pkg.Service.Method"
        (what grpcurl sends when describing a method) lands on the
        service's file."""
        parts = symbol.split(".")
        while parts:
            try:
                return self._pool.FindFileContainingSymbol(".".join(parts))
            except KeyError:
                parts.pop()
        raise KeyError(symbol)

    # -- protocol ----------------------------------------------------------

    def answer(self, request) -> "reflection_pb2.ServerReflectionResponse":
        resp = reflection_pb2.ServerReflectionResponse(
            valid_host=request.host
        )
        resp.original_request.CopyFrom(request)
        which = request.WhichOneof("message_request")
        try:
            if which == "list_services":
                for name in self._services:
                    resp.list_services_response.service.add(name=name)
            elif which == "file_by_filename":
                fd = self._pool.FindFileByName(request.file_by_filename)
                resp.file_descriptor_response.file_descriptor_proto.extend(
                    self._file_with_deps(fd)
                )
            elif which == "file_containing_symbol":
                fd = self._find_file_for_symbol(
                    request.file_containing_symbol
                )
                resp.file_descriptor_response.file_descriptor_proto.extend(
                    self._file_with_deps(fd)
                )
            elif which == "file_containing_extension":
                ext = request.file_containing_extension
                fd = self._pool.FindExtensionByNumber(
                    self._pool.FindMessageTypeByName(ext.containing_type),
                    ext.extension_number,
                ).file
                resp.file_descriptor_response.file_descriptor_proto.extend(
                    self._file_with_deps(fd)
                )
            elif which == "all_extension_numbers_of_type":
                name = request.all_extension_numbers_of_type
                desc = self._pool.FindMessageTypeByName(name)  # raises if absent
                numbers = resp.all_extension_numbers_response
                numbers.base_type_name = name
                numbers.extension_number.extend(
                    sorted(
                        e.number
                        for e in self._pool.FindAllExtensions(desc)
                    )
                )
            else:
                resp.error_response.error_code = _INVALID_ARGUMENT
                resp.error_response.error_message = (
                    "no known message_request set"
                )
        except KeyError:
            resp.error_response.error_code = _NOT_FOUND
            resp.error_response.error_message = "symbol or file not found"
        return resp


def make_reflection_handler(service_names: Iterable[str]):
    """grpc.aio generic handler serving ServerReflectionInfo."""
    responder = ReflectionResponder(service_names)

    async def server_reflection_info(request_iterator, context):
        async for request in request_iterator:
            yield responder.answer(request)

    def serialize(message) -> bytes:
        return message.SerializeToString()

    return grpc.method_handlers_generic_handler(
        REFLECTION_SERVICE,
        {
            "ServerReflectionInfo": grpc.stream_stream_rpc_method_handler(
                server_reflection_info,
                request_deserializer=(
                    reflection_pb2.ServerReflectionRequest.FromString
                ),
                response_serializer=serialize,
            )
        },
    )


def make_sync_reflection_handler(service_names: Iterable[str]):
    """The sync-server variant (the serving shards run sync gRPC
    servers: grpc.aio's completion-queue poller is one per process and
    unsafe across event loops)."""
    responder = ReflectionResponder(service_names)

    def server_reflection_info(request_iterator, context):
        for request in request_iterator:
            yield responder.answer(request)

    def serialize(message) -> bytes:
        return message.SerializeToString()

    return grpc.method_handlers_generic_handler(
        REFLECTION_SERVICE,
        {
            "ServerReflectionInfo": grpc.stream_stream_rpc_method_handler(
                server_reflection_info,
                request_deserializer=(
                    reflection_pb2.ServerReflectionRequest.FromString
                ),
                response_serializer=serialize,
            )
        },
    )


def native_reflection_handler(service_names: Iterable[str]):
    """Per-message handler for the native ingress's bidi-stream surface:
    each stream message answers with exactly one serialized response."""
    responder = ReflectionResponder(service_names)

    async def handler(blob: bytes) -> bytes:
        request = reflection_pb2.ServerReflectionRequest.FromString(blob)
        return responder.answer(request).SerializeToString()

    return handler
