"""``--serving-shards`` on the port's server, on the CPU.

- A port server with ``--serving-shards 3`` (``torch`` storage on
  ``--device cpu``, the standard and the native pipelines) answers
  calls spread over eight channels as a memory server answers them, one
  call at a time, and the server's own per-loop state shows that more
  than one serving loop decided (the batchers' and the native pipeline's
  per-loop shards).
- One key of 3 per 60 s, hammered from 16 threads on 8 channels,
  admits exactly 3 on either pipeline.
- Kuadrant's methods and reflection are served on every shard.
- The sync reflection handler answers byte-equal to the JAX package's.
- A shard that cannot bind stops the server (ValueError, exit 2).
"""

import asyncio
import socket
import threading
from concurrent.futures import ThreadPoolExecutor

import grpc
import pytest

from limitador_tpu_torch.server import __main__ as port_main
from limitador_tpu_torch.server.proto import rls_pb2
from tests.torch_http import flight_spool  # noqa: F401 (autouse)
from tests.torch_http import free_port, port_argv

ENVOY = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
KUADRANT = "/kuadrant.service.ratelimit.v1.RateLimitService/"
REFLECTION = "/grpc.reflection.v1alpha.ServerReflection/ServerReflectionInfo"

LIMITS = """\
- namespace: api
  max_value: 5
  seconds: 60
  variables: ["descriptors[0].user"]
  name: per-user
- namespace: hot
  max_value: 3
  seconds: 60
  variables: ["descriptors[0].user"]
  name: per-user-hot
"""

SHARDS = 3
CHANNELS = 8


def _blob(domain, user):
    req = rls_pb2.RateLimitRequest(domain=domain)
    entry = req.descriptors.add().entries.add()
    entry.key, entry.value = "user", user
    return req.SerializeToString()


def _code(raw):
    return rls_pb2.RateLimitResponse.FromString(raw).overall_code


def _stubs(port, n=CHANNELS):
    # A local subchannel pool a channel: one connection each (channels of
    # one process to one target otherwise share a connection), which the
    # kernel spreads over the listeners.
    channels = [grpc.insecure_channel(
        f"127.0.0.1:{port}",
        options=(("grpc.use_local_subchannel_pool", 1),))
        for _ in range(n)]
    calls = [ch.unary_unary(ENVOY) for ch in channels]
    return channels, calls


def _serial(port, blobs):
    channels, calls = _stubs(port)
    try:
        return [_code(calls[i % CHANNELS](b, timeout=30))
                for i, b in enumerate(blobs)]
    finally:
        for ch in channels:
            ch.close()


def _hammer(port, blob, n=400, threads=16):
    channels, calls = _stubs(port)
    try:
        with ThreadPoolExecutor(threads) as pool:
            codes = list(pool.map(
                lambda i: _code(calls[i % CHANNELS](blob, timeout=30)),
                range(n)))
    finally:
        for ch in channels:
            ch.close()
    return codes


def _loops_that_decided(server):
    """Serving loops with a decided batch, from the server's own
    per-loop shards: the native pipeline's submit shards, else the
    batched storage's per-loop check batchers."""
    pipeline = server.native_pipeline
    if pipeline is not None:
        return sum(1 for shard in list(pipeline._shards.values())
                   if shard.batch_seq > 0)
    pairs = getattr(server.limiter.storage.counters, "_batcher_pairs", None)
    if pairs is None:  # a host storage decides on the calling loop
        return 0
    return sum(1 for mb, _ub in pairs() if mb._batch_seq > 0)


async def _serve(tmp_path, storage, *extra):
    limits = tmp_path / "limits.yaml"
    limits.write_text(LIMITS)
    argv = port_argv(limits, storage, free_port(), *extra)
    args = port_main.build_parser().parse_args(argv)
    return await port_main.start(args), args.rls_port


def _drive(tmp_path, storage, extra, blobs, hot):
    tmp_path.mkdir(parents=True, exist_ok=True)

    async def main():
        server, port = await _serve(tmp_path, storage, *extra)
        loop = asyncio.get_running_loop()
        try:
            serial = await loop.run_in_executor(None, _serial, port, blobs)
            hammered = await loop.run_in_executor(None, _hammer, port, hot)
            loops = _loops_that_decided(server)
            shards = len(server.serving_shards)
            threads = {t.name for t in threading.enumerate()}
        finally:
            await server.stop()
        left = {t.name for t in threading.enumerate()
                if t.name.startswith("rls-shard")}
        return serial, hammered, loops, shards, threads, left

    return asyncio.run(main())


PIPELINES = {
    "standard": ("torch", ["--serving-shards", str(SHARDS)]),
    "native": ("torch", ["--serving-shards", str(SHARDS), "--pipeline",
                         "native"]),
}


@pytest.fixture(scope="module")
def blobs():
    users = [f"u{(i * 7) % 11}" for i in range(120)]
    return [_blob("api", u) for u in users]


@pytest.fixture(scope="module")
def memory_answers(tmp_path_factory, blobs):
    tmp = tmp_path_factory.mktemp("memory")
    serial, hammered, *_ = _drive(tmp, "memory", [], blobs,
                                  _blob("hot", "h"))
    return serial, hammered


@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_serving_shards_answer_as_a_memory_server(pipeline, tmp_path,
                                                  blobs, memory_answers):
    storage, extra = PIPELINES[pipeline]
    serial, hammered, loops, shards, threads, left = _drive(
        tmp_path, storage, extra, blobs, _blob("hot", "h"))
    want_serial, want_hammered = memory_answers
    assert serial == want_serial
    ok = rls_pb2.RateLimitResponse.OK
    assert want_hammered.count(ok) == 3
    assert hammered.count(ok) == 3, hammered.count(ok)
    assert shards == SHARDS - 1
    assert {f"rls-shard-loop-{i}" for i in range(1, SHARDS)} <= threads
    assert loops > 1, loops
    assert not left  # every shard's threads stopped with the server


def test_kuadrant_and_reflection_are_served_on_every_shard(tmp_path):
    from limitador_tpu_torch.server.proto import reflection_pb2

    async def main():
        server, port = await _serve(
            tmp_path, "torch", "--serving-shards", str(SHARDS))
        loop = asyncio.get_running_loop()

        def calls():
            out = []
            channels, _ = _stubs(port)
            try:
                for i, ch in enumerate(channels):
                    check = ch.unary_unary(KUADRANT + "CheckRateLimit")
                    report = ch.unary_unary(KUADRANT + "Report")
                    blob = _blob("api", f"kuadrant-{i}")
                    out.append(_code(check(blob, timeout=30)))
                    out.append(_code(report(blob, timeout=30)))
                    stream = ch.stream_stream(REFLECTION)
                    req = reflection_pb2.ServerReflectionRequest(
                        list_services="")
                    resp, = list(stream(iter([req.SerializeToString()]),
                                        timeout=30))
                    names = [s.name for s in reflection_pb2.
                             ServerReflectionResponse.FromString(resp)
                             .list_services_response.service]
                    out.append(tuple(names))
            finally:
                for ch in channels:
                    ch.close()
            return out

        try:
            return await loop.run_in_executor(None, calls)
        finally:
            await server.stop()

    out = asyncio.run(main())
    ok = rls_pb2.RateLimitResponse.OK
    services = (
        "envoy.service.ratelimit.v3.RateLimitService",
        "grpc.reflection.v1alpha.ServerReflection",
        "kuadrant.service.ratelimit.v1.RateLimitService",
    )
    assert out == [ok, ok, services] * CHANNELS


def _reflection_answers(handler, requests):
    server = grpc.server(ThreadPoolExecutor(2))
    server.add_generic_rpc_handlers((handler,))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            stream = ch.stream_stream(REFLECTION)
            return list(stream(iter(requests), timeout=30))
    finally:
        server.stop(0).wait()


def test_sync_reflection_handler_answers_as_the_jax_handler():
    from limitador_tpu.server.reflection import (
        make_sync_reflection_handler as jax_handler,
    )

    from limitador_tpu_torch.server.proto import reflection_pb2
    from limitador_tpu_torch.server.reflection import (
        make_sync_reflection_handler,
    )

    services = ("envoy.service.ratelimit.v3.RateLimitService",
                "kuadrant.service.ratelimit.v1.RateLimitService")
    R = reflection_pb2.ServerReflectionRequest
    requests = [r.SerializeToString() for r in (
        R(list_services=""),
        R(file_containing_symbol=services[0]),
        R(file_containing_symbol=services[1] + ".CheckRateLimit"),
        R(file_by_filename="envoy/service/ratelimit/v3/rls.proto"),
        R(file_containing_symbol="no.such.Symbol"),
        R(all_extension_numbers_of_type="envoy.service.ratelimit.v3."
          "RateLimitRequest"),
        R(host="h"),
    )]
    want = _reflection_answers(jax_handler(services), requests)
    got = _reflection_answers(make_sync_reflection_handler(services),
                              requests)
    assert len(want) == len(requests)
    assert got == want


def test_a_shard_that_cannot_bind_stops_the_server(tmp_path):
    """An address held by a listener without SO_REUSEPORT: the shard
    cannot bind, the shards already up stop, and the server's start
    raises ValueError (exit 2)."""
    with socket.socket() as holder:
        holder.bind(("127.0.0.1", 0))
        holder.listen()
        port = holder.getsockname()[1]
        args = port_main.build_parser().parse_args(
            ["limits.yaml", "memory", "--serving-shards", "3",
             "--rls-host", "127.0.0.1"])
        with pytest.raises(ValueError, match="serving shard 1"):
            port_main.serve_shards(args, None, None, None, None, port)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("rls-shard-loop")]
