"""The port's gRPC server reflection against the JAX package's.

The port serves reflection from its own descriptor pool
(``server/proto/_pool.py``); the JAX package from protobuf's default
pool. For the Envoy RLS and Kuadrant services both must list the same
services and answer the same file descriptors (each file with its
imports, dependencies first), byte for byte, and the same errors. A live
port server answers the same over a real reflection stream.
"""

import asyncio
import socket

import grpc
import pytest

from limitador_tpu.server.proto import reflection_pb2 as j_reflection_pb2
from limitador_tpu.server.reflection import (
    ReflectionResponder as JResponder,
)
from limitador_tpu_torch.server import __main__ as port_main
from limitador_tpu_torch.server.proto import reflection_pb2
from limitador_tpu_torch.server.reflection import (
    REFLECTION_METHOD,
    ReflectionResponder,
)
from tests.torch_http import flight_spool  # noqa: F401 (autouse)

SERVICES = (
    "envoy.service.ratelimit.v3.RateLimitService",
    "kuadrant.service.ratelimit.v1.RateLimitService",
)

#: (message_request field, value) of the queries compared
QUERIES = [
    ("list_services", "*"),
    ("file_containing_symbol", SERVICES[0]),
    ("file_containing_symbol", SERVICES[1]),
    ("file_containing_symbol", SERVICES[0] + ".ShouldRateLimit"),
    ("file_containing_symbol", SERVICES[1] + ".Report"),
    ("file_containing_symbol", "envoy.service.ratelimit.v3.RateLimitRequest"),
    ("file_containing_symbol",
     "envoy.extensions.common.ratelimit.v3.RateLimitDescriptor"),
    ("file_containing_symbol", "grpc.reflection.v1alpha.ServerReflection"),
    ("file_by_filename", "envoy/service/ratelimit/v3/rls.proto"),
    ("file_by_filename", "kuadrant/service/ratelimit/v1/rls.proto"),
    ("file_by_filename", "envoy/config/core/v3/base.proto"),
    ("file_containing_symbol", "no.such.Service"),
    ("file_by_filename", "no/such.proto"),
    ("all_extension_numbers_of_type", "no.such.Message"),
]


def _pair(field, value):
    return (
        reflection_pb2.ServerReflectionRequest(host="h", **{field: value}),
        j_reflection_pb2.ServerReflectionRequest(host="h", **{field: value}),
    )


@pytest.mark.parametrize("field,value", QUERIES)
def test_answers_equal_the_jax_responder(field, value):
    port = ReflectionResponder(SERVICES)
    jax = JResponder(SERVICES)
    p_req, j_req = _pair(field, value)
    got, want = port.answer(p_req), jax.answer(j_req)
    assert got.SerializeToString() == want.SerializeToString()
    assert got.WhichOneof("message_response") in (
        "list_services_response", "file_descriptor_response",
        "error_response")


def test_lists_both_services_and_reflection():
    answer = ReflectionResponder(SERVICES).answer(
        reflection_pb2.ServerReflectionRequest(list_services="*"))
    assert [s.name for s in answer.list_services_response.service] == sorted(
        SERVICES + ("grpc.reflection.v1alpha.ServerReflection",))


def test_file_answers_carry_dependencies_first():
    from google.protobuf import descriptor_pb2

    answer = ReflectionResponder(SERVICES).answer(
        reflection_pb2.ServerReflectionRequest(
            file_containing_symbol=SERVICES[1]))
    names = []
    for blob in answer.file_descriptor_response.file_descriptor_proto:
        fd = descriptor_pb2.FileDescriptorProto.FromString(blob)
        assert all(dep in names for dep in fd.dependency), fd.name
        names.append(fd.name)
    assert names[-1] == "kuadrant/service/ratelimit/v1/rls.proto"
    assert "envoy/service/ratelimit/v3/rls.proto" in names


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _stream(tmp_path):
    limits = tmp_path / "limits.yaml"
    limits.write_text("- namespace: ns\n  max_value: 1\n  seconds: 60\n")
    rls_port = _free_port()
    server = await port_main.start(port_main.build_parser().parse_args([
        str(limits), "memory", "--http-host", "127.0.0.1",
        "--http-port", str(_free_port()), "--rls-host", "127.0.0.1",
        "--rls-port", str(rls_port), "--grpc-reflection-service",
    ]))
    try:
        async with grpc.aio.insecure_channel(
                f"127.0.0.1:{rls_port}") as chan:
            call = chan.stream_stream(
                REFLECTION_METHOD,
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=(
                    reflection_pb2.ServerReflectionResponse.FromString),
            )(iter([_pair(f, v)[0] for f, v in QUERIES]),
              metadata=(("x-request-id", "refl-1"),))
            answers = [a async for a in call]
            initial = await call.initial_metadata()
        return answers, initial
    finally:
        await server.stop()


def test_live_server_streams_the_same_answers(tmp_path):
    answers, initial = asyncio.run(_stream(tmp_path))
    jax = JResponder(SERVICES)
    assert len(answers) == len(QUERIES)
    for (field, value), got in zip(QUERIES, answers):
        want = jax.answer(_pair(field, value)[1])
        assert got.SerializeToString() == want.SerializeToString(), field
    # the request-id interceptor wraps the streaming handler too
    assert initial.get("x-request-id") == "refl-1"
