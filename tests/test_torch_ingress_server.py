"""The port server with ``--native-ingress``, on the CPU.

- ``port_main.start`` with ``torch --pipeline native --native-ingress``:
  Envoy's ShouldRateLimit on ``--rls-port`` is the native ingress (and
  also served by the gRPC server on ``--rls-port`` + 1), the Kuadrant
  methods answer alike on both ports, reflection lists the services on
  the ingress port, and ``/metrics`` counts the ingress's requests and
  its coded responds; the ``ingress_*`` and ``native_phase_h2i_respond``
  families carry the JAX package's names, types and help.
- Where the ingress cannot run the server stops with exit 2 and serves
  nothing (the JAX server warns and serves Python gRPC alone): without
  ``--pipeline native`` on torch storage (memory storage too), with
  rate-limit headers, and with an ingress library that does not build.
"""

import asyncio
import socket

import grpc
import pytest
from prometheus_client.parser import text_string_to_metric_families

from limitador_tpu.observability.metrics import PrometheusMetrics as JMetrics
from limitador_tpu_torch.native import build
from limitador_tpu_torch.server import __main__ as port_main
from limitador_tpu_torch.server.proto import reflection_pb2, rls_pb2

from . import torch_http as H
from .torch_steady import steady

ENVOY = "/envoy.service.ratelimit.v3.RateLimitService/ShouldRateLimit"
KUADRANT = "/kuadrant.service.ratelimit.v1.RateLimitService/"
REFLECTION = ("/grpc.reflection.v1alpha.ServerReflection/"
              "ServerReflectionInfo")
INGRESS_FAMILIES = ("ingress_connections", "ingress_requests",
                    "ingress_responses", "ingress_protocol_errors",
                    "native_phase_h2i_respond")


def free_pair() -> int:
    """A free local port whose next port is free too."""
    for _ in range(100):
        port = H.free_port()
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port + 1))
            except OSError:
                continue
        return port
    raise RuntimeError("no free pair of local ports")


def argv(tmp_path, storage, *extra):
    limits = tmp_path / "limits.yaml"
    limits.write_text(H.LIMITS)
    port = free_pair()
    return [str(limits), storage, "--device", "cpu", "--capacity", "4096",
            "--http-host", "127.0.0.1", "--http-port", str(H.free_port()),
            "--rls-host", "127.0.0.1", "--rls-port", str(port),
            "--flight-spool-dir", str(tmp_path / "flight"), *extra], port


def _request(domain, entries, hits=0) -> bytes:
    req = rls_pb2.RateLimitRequest(domain=domain, hits_addend=hits)
    d = req.descriptors.add()
    for k, v in entries.items():
        d.entries.add(key=k, value=v)
    return req.SerializeToString()


def _families(text):
    return {f.name: f for f in text_string_to_metric_families(text)}


def _drive(port):
    """Calls from a client thread: (Envoy answers on the ingress, on the
    gRPC port, Kuadrant answer pairs, reflection's services, calls sent
    to the ingress)."""
    sent = 0
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ic, \
            grpc.insecure_channel(f"127.0.0.1:{port + 1}") as gc:
        user = {"method": "GET", "user": "a"}
        envoy = [ic.unary_unary(ENVOY)(_request("api", user), timeout=15)
                 for _ in range(6)]
        sent += 6
        grpc_envoy = [gc.unary_unary(ENVOY)(
            _request("api", {"method": "GET", "user": "b"}), timeout=15)
            for _ in range(6)]
        pairs = []
        for method, hits in (("CheckRateLimit", 0), ("Report", 4),
                             ("CheckRateLimit", 0), ("Report", 1),
                             ("CheckRateLimit", 0)):
            blob = _request("api", {"method": "GET", "user": "k"}, hits)
            if method == "Report":
                ic.unary_unary(KUADRANT + method)(blob, timeout=15)
                sent += 1
                continue
            pairs.append(tuple(
                c.unary_unary(KUADRANT + method)(blob, timeout=15)
                for c in (ic, gc)))
            sent += 1
        stream = ic.stream_stream(
            REFLECTION,
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=(
                reflection_pb2.ServerReflectionResponse.FromString))
        answers = list(stream(iter([reflection_pb2.ServerReflectionRequest(
            list_services="")]), timeout=15))
        sent += 2  # the message and the half-close
        services = {s.name for a in answers
                    for s in a.list_services_response.service}
    return envoy, grpc_envoy, pairs, services, sent


def test_native_ingress_serves_the_rls_port(tmp_path):
    with steady():
        args, port = argv(tmp_path, "torch", "--pipeline", "native",
                          "--native-ingress")
        http_port = int(args[args.index("--http-port") + 1])

        async def main():
            server = await port_main.start(
                port_main.build_parser().parse_args(args))
            try:
                assert server.native_ingress is not None
                assert server.native_ingress.port == port
                loop = asyncio.get_running_loop()
                out = await loop.run_in_executor(None, _drive, port)
                import aiohttp

                async with aiohttp.ClientSession() as session:
                    async with session.get(
                            f"http://127.0.0.1:{http_port}/metrics") as r:
                        text = (await r.read()).decode()
                    async with session.get(
                            f"http://127.0.0.1:{http_port}/debug/stats") as r:
                        stats = await r.json()
                return out, text, stats
            finally:
                await server.stop()

        (envoy, grpc_envoy, pairs, services, sent), text, stats = \
            asyncio.run(main())
    ok = rls_pb2.RateLimitResponse(
        overall_code=rls_pb2.RateLimitResponse.OK).SerializeToString()
    over = rls_pb2.RateLimitResponse(
        overall_code=rls_pb2.RateLimitResponse.OVER_LIMIT
    ).SerializeToString()
    assert envoy == grpc_envoy == [ok] * 5 + [over]
    assert all(a == b for a, b in pairs)
    assert [rls_pb2.RateLimitResponse.FromString(a).overall_code
            for a, _ in pairs] == [rls_pb2.RateLimitResponse.OK] * 2 + [
                rls_pb2.RateLimitResponse.OVER_LIMIT]
    assert services == {
        "envoy.service.ratelimit.v3.RateLimitService",
        "kuadrant.service.ratelimit.v1.RateLimitService",
        "grpc.reflection.v1alpha.ServerReflection"}
    families = _families(text)

    def total(name):
        return sum(s.value for s in families[name].samples
                   if s.name in (name, name + "_total"))

    assert total("ingress_requests") == sent
    assert total("ingress_responses") == sent
    assert total("ingress_connections") == 1
    assert total("ingress_protocol_errors") == 0
    respond = [s.value for s in families["native_phase_h2i_respond"].samples
               if s.name == "native_phase_h2i_respond_count"]
    assert respond and respond[0] > 0
    assert stats["native_telemetry"]["h2i_respond"]["count"] > 0
    assert stats["native_build"]["h2ingress"]["loaded"] is True


def test_ingress_families_are_the_jax_packages(tmp_path):
    from limitador_tpu_torch.observability.metrics import PrometheusMetrics

    def described(metrics):
        return {m.name: (m.type, m.documentation)
                for m in metrics.registry.collect()
                if m.name in INGRESS_FAMILIES}

    port = described(PrometheusMetrics())
    assert set(port) == set(INGRESS_FAMILIES)
    assert port == described(JMetrics())


def _refused(args):
    """``start`` raises and ``main`` exits 2; nothing listens on either
    port afterwards."""
    parsed = port_main.build_parser().parse_args(args)
    port = parsed.rls_port
    with pytest.raises((ValueError, build.BuildError)):
        asyncio.run(port_main.start(parsed))
    assert port_main.main(args) == 2
    for p in (port, port + 1):
        with socket.socket() as s:
            s.settimeout(2)
            assert s.connect_ex(("127.0.0.1", p)) != 0, p


@pytest.mark.parametrize("storage, extra", [
    ("torch", ()),
    ("torch", ("--pipeline", "compiled")),
    ("memory", ()),
    ("torch", ("--pipeline", "native", "--rate-limit-headers",
               "DRAFT_VERSION_03")),
], ids=["standard", "compiled", "memory", "headers"])
def test_unmet_native_ingress_exits_2(tmp_path, storage, extra):
    with steady():
        args, _port = argv(tmp_path, storage, "--native-ingress", *extra)
        _refused(args)


def test_native_ingress_that_does_not_build_exits_2(tmp_path, monkeypatch):
    broken = tmp_path / "h2ingress.cc"
    broken.write_text("not C++\n")
    monkeypatch.setattr(build, "INGRESS_SOURCES",
                        (broken, build.INGRESS_SOURCES[1]))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_ingress_lib", None)
    monkeypatch.setattr(build, "_ingress_error", None)
    with steady():
        args, _port = argv(tmp_path, "torch", "--pipeline", "native",
                           "--native-ingress")
        _refused(args)
    assert "g++ failed" in build.build_status()["h2ingress"]["build_error"]
